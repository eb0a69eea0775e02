"""The port's C RLE codec (samrs_tpu_torch/native) against the numpy codecs
of the port and of the JAX package and against the JAX package's C codec:
equal bytes on random and edge masks, batches that decode back to their
masks, the output bound, and a failed build that raises; the port's
vectorised decoder against the JAX package's.
"""

import numpy as np
import pytest

from samrs_tpu.data.rle import _decode_counts as jax_decode_counts
from samrs_tpu.data.rle import rle_encode as jax_rle_encode
from samrs_tpu.native.build import native_rle_encode_batch as jax_native_rle_encode_batch
from samrs_tpu_torch.data.rle import _decode_counts, rle_decode, rle_encode, rle_encode_batch
from samrs_tpu_torch.native import build


def _as_bytes(c):
    return c.encode("ascii") if isinstance(c, str) else bytes(c)


def _edge_masks():
    """name -> (N, H, W) bool masks."""
    rng = np.random.default_rng(7)
    out = {f"random{h}x{w}": rng.random((3, h, w)) > p
           for (h, w), p in (((13, 17), 0.6), ((64, 64), 0.5), ((100, 3), 0.3), ((37, 53), 0.9))}
    out["empty"] = np.zeros((2, 9, 11), bool)
    out["full"] = np.ones((2, 9, 11), bool)
    out["one_row"] = rng.random((3, 1, 40)) > 0.5
    out["one_column"] = rng.random((3, 40, 1)) > 0.5
    out["1x1"] = np.array([[[False]], [[True]]])
    out["width_not_8"] = rng.random((3, 19, 13)) > 0.5
    big = np.zeros((1, 2000, 2000), bool)
    big[0, :, 1000:] = True  # two runs of 2e6 pixels: five characters each
    out["2000x2000"] = big
    return out


EDGE = _edge_masks()


@pytest.mark.parametrize("case", sorted(EDGE))
def test_c_codec_matches_numpy_and_jax(case):
    masks = EDGE[case]
    got = build.native_rle_encode_batch(masks)
    jax_native = jax_native_rle_encode_batch(masks.astype(np.uint8))
    assert jax_native is not None  # the JAX package's build of its own copy
    assert len(got) == len(masks)
    for m, g, jn in zip(masks, got, jax_native):
        want = _as_bytes(rle_encode(m)["counts"])
        assert g == want
        assert g == _as_bytes(jax_rle_encode(m.astype(np.uint8))["counts"])
        assert g == jn
        assert len(g) <= build.encoded_bound(*m.shape)
    if case == "2000x2000":
        assert len(got[0]) == 10 and sum((c - 48) & 0x20 > 0 for c in got[0]) == 8


@pytest.mark.parametrize("case", sorted(EDGE))
def test_vectorised_decoder_matches_jax(case):
    """The port's decoder (all characters at once) against the JAX package's
    character loop: the same counts, negative deltas and five-character
    varints included, and the masks back."""
    for m in EDGE[case]:
        counts = rle_encode(m)["counts"]
        assert _decode_counts(counts).tolist() == jax_decode_counts(counts)
        np.testing.assert_array_equal(rle_decode({"size": list(m.shape), "counts": counts}), m)


@pytest.mark.parametrize("dtype", [bool, np.uint8])
def test_batch_records_decode_to_their_masks(dtype):
    masks = (np.random.default_rng(3).random((5, 21, 30)) > 0.5).astype(dtype)
    records = rle_encode_batch(masks)
    assert [r["size"] for r in records] == [[21, 30]] * 5
    for m, r in zip(masks, records):
        np.testing.assert_array_equal(rle_decode(r), m.astype(np.uint8))


def test_checkerboard_stays_within_the_bound():
    """The most runs a mask can have: one a pixel."""
    h, w = 61, 47
    board = (np.indices((h, w)).sum(0) % 2).astype(bool)
    (got,) = build.native_rle_encode_batch(board[None])
    assert got == _as_bytes(rle_encode(board)["counts"])
    assert h * w <= len(got) <= build.encoded_bound(h, w)


def test_failed_build_raises(monkeypatch, tmp_path):
    """No compiler on the list builds: the codec raises (no None, no
    fallback to the numpy codec)."""
    monkeypatch.setattr(build, "COMPILERS", ("samrs-no-such-compiler",))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_lib", None)
    with pytest.raises(RuntimeError, match="cannot build the C RLE codec"):
        build.rle_library()
    with pytest.raises(RuntimeError, match="cannot build the C RLE codec"):
        rle_encode_batch(np.ones((1, 4, 4), bool))
    assert not list((tmp_path / "_build").glob("*.so"))
