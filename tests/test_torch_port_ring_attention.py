"""The port's ring attention (samrs_tpu_torch/kernels/ring_attention.py) in
one process, against the JAX oracles on the CPU in fp32.

The ranks are played in turn: ``ring_chunks`` is replaced by one that
yields the other ranks' chunks of the whole K / V in the ring's order
(this rank's, then rank - 1's, ...), so the tile maxima, the chunk merge
and the bias columns run exactly as on a rank.  Two real gloo ranks (the
transport, ``sp_attention``, ``sp_flash_attention_relpos`` and the
sequence-parallel SAM encoder) are in test_torch_port_ddp.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.flash_attention import attention_relpos_xla
from samrs_tpu_torch.core.mesh import DataMesh
from samrs_tpu_torch.kernels import flash_attention, ring_attention
from samrs_tpu_torch.sam.image_encoder import Block, ImageEncoderViT
from test_ring_attention import _oracle

ATOL = 2e-5  # JAX's own bound for the ring against full attention (tests/test_ring_attention.py)


def _rel_l2(got, want):
    return float(np.linalg.norm(np.asarray(got, np.float64) - np.asarray(want, np.float64))
                 / np.linalg.norm(np.asarray(want, np.float64)))


def _inputs(seed, B, N, d, H=None, W=None):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, N, d)).astype(np.float32) for _ in range(3))
    bias = (rng.standard_normal((B, N, N)) * 0.5).astype(np.float32)
    Rh = Rw = None
    if H is not None:
        Rh = (rng.standard_normal((H, H, d)) * 0.1).astype(np.float32)
        Rw = (rng.standard_normal((W, W, d)) * 0.1).astype(np.float32)
    return q, k, v, bias, Rh, Rw


def _rel_rows(q, Rh, Rw, H, W):
    B, N, d = q.shape
    rq = q.reshape(B, H, W, d)
    return (np.einsum("bhwc,hkc->bhwk", rq, Rh).reshape(B, N, H),
            np.einsum("bhwc,wkc->bhwk", rq, Rw).reshape(B, N, W))


def _play_ring(monkeypatch, world, k, v, fn):
    """fn(mesh, rows) of every rank in turn, its chunks of the whole k / v
    coming round as they would; the outputs concatenated in rank order."""
    def chunks(t, mesh):
        whole = k if t.dim() == 3 else torch.stack([k, v])
        parts = whole.chunk(world, dim=-2)
        assert torch.equal(t, parts[mesh.rank])  # the caller passes its own chunk
        for step in range(world):
            src = (mesh.rank - step) % world
            yield src, parts[src]

    monkeypatch.setattr(ring_attention, "ring_chunks", chunks)
    n = k.shape[-2] // world
    return torch.cat([fn(DataMesh(r, world), slice(r * n, (r + 1) * n)) for r in range(world)], 1)


@pytest.mark.parametrize("world", [1, 2, 4])
@pytest.mark.parametrize("bias", [None, "rows", "relpos"])
def test_ring_matches_full_attention(monkeypatch, world, bias):
    """Every rank's chunk merge over a 16 x 24 grid (384 keys: K2's 128-key
    tiles straddle the chunks at 2 and 4 ranks) against JAX's full-softmax
    oracle, with no bias, a dense bias's rows, and SAM's decomposed rel-pos
    bias gathered per chunk (against ``attention_relpos_xla``)."""
    H, W, d = 16, 24, 16
    q, k, v, b, Rh, Rw = _inputs(world, 2, H * W, d, H, W)
    scale = d ** -0.5
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    if bias == "relpos":
        rel_h, rel_w = _rel_rows(q, Rh, Rw, H, W)
        want = attention_relpos_xla(*map(jnp.asarray, (q, k, v, rel_h, rel_w)), scale)
        th, tw = map(torch.from_numpy, (rel_h, rel_w))
        fn = lambda mesh, rows: ring_attention.ring_attention_relpos(
            tq[:, rows], tk[:, rows], tv[:, rows], th[:, rows], tw[:, rows], W, mesh, scale)
    else:
        want = _oracle(*map(jnp.asarray, (q, k, v)), scale,
                       None if bias is None else jnp.asarray(b))
        tb = torch.from_numpy(b)
        fn = lambda mesh, rows: ring_attention.ring_attention(
            tq[:, rows], tk[:, rows], tv[:, rows], mesh, scale,
            None if bias is None else tb[:, rows])
    got = _play_ring(monkeypatch, world, tk, tv, fn)
    assert got.dtype == torch.float32 and got.shape == (2, H * W, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("world", [2, 4])
def test_bf16_probabilities_round_as_k2(monkeypatch, world):
    """bf16 q / k / v (the card's dtype): the ring's probabilities round to
    bf16 relative to the running maximum after each 128-key tile in key
    order, as K2's plain version (``online_softmax_v``) rounds them, whatever
    order a rank meets the chunks in: equal up to fp32 summation order and
    the odd probability whose bf16 rounding that order flips (1.3e-7 here;
    the bound leaves room for a few flips).  The exact softmax of the same
    inputs lies ~1.2e-3 away, and so does a ring that rounds against each
    chunk's own running maximum (7.5e-4 / 9.9e-4 at 2 / 4 ranks): K2 on the
    card rounds as its plain version does, so only the first keeps the
    sequence-parallel encoder as close to the one-card one as K2's own
    summation order."""
    H, W, d = 16, 32, 64
    q, k, v, _, Rh, Rw = _inputs(10 + world, 4, H * W, d, H, W)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tRh, tRw = torch.from_numpy(Rh), torch.from_numpy(Rw)
    scale = d ** -0.5
    got = _play_ring(monkeypatch, world, tk, tv, lambda mesh, rows: ring_attention.relpos_ring(
        tq[:, rows], tk[:, rows], tv[:, rows], tRh, tRw, (H, W), scale, mesh))
    # K2's plain arithmetic (flash_attention.attention_qkv_relpos_plain) before its output cast
    rel_h, rel_w = flash_attention._rel_rows(tq[:, None], tRh, tRw, (H, W))
    s = (tq.float() @ tk.float().transpose(-1, -2)) * scale
    s = (s.reshape(4, H * W, H, W) + rel_h[:, 0, ..., None] + rel_w[:, 0, :, None, :])
    s = s.reshape(4, H * W, H * W)
    want = flash_attention.online_softmax_v(s, tv, torch.bfloat16)
    exact = s.softmax(-1) @ tv.float()
    d_k2, d_exact = _rel_l2(got, want), _rel_l2(got, exact)
    assert d_k2 <= 1e-4, d_k2
    assert d_exact >= 5e-4, d_exact


def test_relpos_columns_gather_the_rows_and_columns():
    """Chunks that start and end inside a grid row: rel_h at cols // W and
    rel_w at cols % W equal the dense (N, N) bias's columns."""
    rng = np.random.default_rng(3)
    H, W = 5, 7
    rel_h = torch.from_numpy(rng.standard_normal((2, 9, H)).astype(np.float32))
    rel_w = torch.from_numpy(rng.standard_normal((2, 9, W)).astype(np.float32))
    dense = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(2, 9, H * W)
    for start, n in ((0, 35), (3, 6), (12, 11), (29, 6)):
        h, w = ring_attention.relpos_columns(rel_h, rel_w, W, start, n)
        assert h.shape == w.shape == (2, 9, n)
        torch.testing.assert_close(h + w, dense[..., start:start + n], rtol=0, atol=0)


@pytest.mark.parametrize("start,n", [(0, 256), (0, 100), (96, 64), (200, 300), (384, 128)])
def test_key_tiles_place_every_key_once(start, n):
    """``_tiled`` puts key start + j at tile (start + j) // 128 and lane
    (start + j) % 128 of the tiles ``_tiles`` names, -inf elsewhere."""
    first, lead, count = ring_attention._tiles(start, n)
    s = torch.arange(n, dtype=torch.float32)[None] + 1.0
    t = ring_attention._tiled(s, lead, count)
    assert t.shape == (1, count, 128)
    keys = torch.arange(start, start + n)
    assert torch.equal(t[0, keys // 128 - first, keys % 128], s[0])
    assert int(torch.isfinite(t).sum()) == n
    assert first * 128 <= start and (first + count) * 128 >= start + n
    assert (first + count - 1) * 128 < start + n


def test_refusals():
    """The ranks must divide the token rows (JAX asserts it); a rank's q must
    hold its rows; windowed blocks take no sequence mesh; the ring has no
    backward."""
    mesh = DataMesh(0, 3)
    q = torch.zeros(1, 32, 16)
    R = torch.zeros(8, 8, 16)
    with pytest.raises(ValueError, match="must divide among the 3 ranks"):
        ring_attention.sp_flash_attention_relpos(q, q, q, R, R[:4, :4], (8, 4), 0.25, mesh)
    with pytest.raises(ValueError, match="expected 16 tokens"):
        ring_attention.relpos_ring(q, q, q, R, R[:4, :4], (8, 4), 0.25, DataMesh(0, 2))
    with pytest.raises(ValueError, match="global blocks only"):
        Block(32, 2, 4.0, 4, (8, 8), sp_mesh=DataMesh(0, 2))
    g = torch.zeros(1, 8, 16, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        ring_attention.ring_attention(g, g, g, None, 0.25)
    with torch.no_grad():
        assert ring_attention.ring_attention(g, g, g, None, 0.25).shape == (1, 8, 16)


def test_transport_follows_the_backend():
    """CUDA tensors under gloo (ranks sharing a card) go through the host;
    over NCCL and on the CPU they move as they are."""
    cuda = torch.device("cuda", 0)
    assert ring_attention.transport(DataMesh(0, 2, cuda, "gloo"), cuda) == "through the host"
    assert ring_attention.transport(DataMesh(0, 2, cuda, "nccl"), cuda) == "device to device"
    assert ring_attention.transport(DataMesh(0, 2, backend="gloo"), "cpu") == "device to device"
    assert ring_attention.transport(None, cuda) == "device to device"


def test_one_rank_sp_encoder_equals_the_encoder():
    """A sequence mesh of one rank: the global block's slab is the whole
    grid, the ring one chunk; the encoder's output equals the one without
    a mesh (K12's plain version there) within JAX's ring bound."""
    kw = dict(img_size=128, patch_size=16, embed_dim=32, depth=2, num_heads=2, out_chans=16,
              window_size=4, global_attn_indexes=(1,))
    enc = ImageEncoderViT(**kw)
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    sp = ImageEncoderViT(**kw, sp_mesh=DataMesh())
    sp.load_state_dict(enc.state_dict())
    assert sp.blocks[1].sp_mesh is not None and sp.blocks[0].sp_mesh is None
    x = torch.randn(2, 128, 128, 3, generator=gen)
    with torch.no_grad():
        want, got = enc(x), sp(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
