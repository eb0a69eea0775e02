"""K6 (the mask decoder's upscaling tail) and K7 (the full-resolution
postprocess) of the PyTorch port against the JAX package, on the CPU.

K6: the plain version (Abramowitz-Stegun GELU, as csrc/upscale.cu computes
it) against ``upscale_hyper_xla`` and the Pallas kernel in interpret mode at
the decoder's widths (256 -> 64 -> 32), in fp32 and with bf16 products; the
erf against the JAX kernels' ``_erf``; the wrapper's per-version weight
cache and its one launch a call (``_build`` faked); and a numpy model of the
kernel's logit staging and 16-byte stores.  K7: a numpy model of
csrc/amg_post.cu's tiling (a cluster of 8 blocks a mask, the input rows of a
band of output rows in one copy, four columns' bits a lane paired into
bytes and staged with the band's 16-byte phase, stored as words, the stats
reduced per warp, per block and across the cluster) against ``amg_postprocess(interpret=True)`` at the
generator's geometries.  Inputs are made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.amg_post import amg_postprocess as jax_amg_postprocess
from samrs_tpu.kernels.fused_mlp import _erf as jax_erf
from samrs_tpu.kernels.fused_upscale import fused_upscale_hyper, upscale_hyper_xla
from samrs_tpu_torch.kernels import _build, amg_post, fused_upscale

C, C1, C2 = 256, 64, 32  # the decoder's widths: transformer, conv1 and conv2 channels


def _k6_inputs(rng, B, G, M, bf16_exact=False):
    """src (B, G, G, C), flax-layout kernels (2, 2, in, out), vectors, hyper
    (B, M, C2); with `bf16_exact` every value is a bf16 number."""
    def f(*s, std=1.0, shift=0.0):
        a = (rng.normal(size=s) * std + shift).astype(np.float32)
        return torch.from_numpy(a).bfloat16().float().numpy() if bf16_exact else a
    return (f(B, G, G, C), f(2, 2, C, C1, std=C ** -0.5), f(C1, std=0.1), f(C1, std=0.1, shift=1.0),
            f(C1, std=0.1), f(2, 2, C1, C2, std=C1 ** -0.5), f(C2, std=0.1), f(B, M, C2))


def _to_torch_conv(k):
    """A flax ConvTranspose kernel (2, 2, in, out) in torch's (in, out, kh,
    kw) layout, flipped as the weight bridge gives it."""
    return torch.from_numpy(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))


def _k6_port(args, dtype):
    src, k1, b1, lns, lnb, k2, b2, hyper = args
    t = torch.from_numpy
    return fused_upscale.upscale_hyper(t(src), _to_torch_conv(k1), t(b1), t(lns), t(lnb),
                                       _to_torch_conv(k2), t(b2), t(hyper), dtype=dtype)


@pytest.mark.parametrize("reference", ["oracle", "interpret"])
@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("G", [8, 12])
def test_k6_plain_matches_jax_fp32(G, M, reference):
    """fp32: the plain version against the XLA composition (exact erf) and
    the Pallas kernel (its own erf) within 1e-5; only summation order and
    the erf's 1.5e-7 differ."""
    args = _k6_inputs(np.random.default_rng(100 * G + M), 2, G, M)
    jargs = [jnp.asarray(a) for a in args]
    if reference == "oracle":
        want = upscale_hyper_xla(*jargs, jnp.float32)
    else:
        want = fused_upscale_hyper(*jargs, dtype=jnp.float32, interpret=True)
    got = _k6_port(args, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, M, 4 * G, 4 * G)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("M", [1, 3])
@pytest.mark.parametrize("G", [8, 12])
def test_k6_plain_bf16_matches_pallas_bf16(G, M):
    """bf16 products (the kernel's mode) against the Pallas kernel in bf16 on
    bf16 inputs: the Pallas kernel also rounds GELU2's output and the
    hypernetwork vector to bf16 for its dot, which the port keeps in fp32,
    so they agree to bf16 rounding (relative L2 <= 1e-2, the smoke's kernel
    bound) and not to fp32's."""
    args = _k6_inputs(np.random.default_rng(7 * G + M), 2, G, M, bf16_exact=True)
    want = np.asarray(fused_upscale_hyper(*[jnp.asarray(a) for a in args], dtype=jnp.bfloat16,
                                          interpret=True))
    got = _k6_port(args, torch.bfloat16).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


def test_erf_as_matches_jax_erf():
    """The port's Abramowitz-Stegun erf equals the JAX kernels' ``_erf`` to
    1e-7 in fp32.  In float64 the formula keeps its 1.5e-7 bound to the
    exact erf; in fp32 the rounding of 1 - poly * exp near 1 (ulp 1.2e-7)
    adds a few ulps, so fp32 stays within 5e-7, and GELU = x (1 + erf) / 2
    within |x| / 2 times that."""
    y = np.linspace(-6.0, 6.0, 24001, dtype=np.float32)
    got = fused_upscale.erf_as(torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_erf(jnp.asarray(y))), atol=1e-7, rtol=0)
    exact = torch.erf(torch.from_numpy(y).double())
    assert float((fused_upscale.erf_as(torch.from_numpy(y).double()) - exact).abs().max()) <= 1.5e-7
    assert np.abs(got - exact.numpy()).max() <= 5e-7
    g = fused_upscale.gelu_as(torch.from_numpy(y)).double()
    ref = torch.nn.functional.gelu(torch.from_numpy(y).double())
    assert float((g - ref).abs().max()) <= 0.5 * 6.0 * 5e-7 + 1e-6


def test_k6_weights_converted_once_per_version(monkeypatch):
    """The wrapper converts each conv weight to the kernel's tap-major bf16
    matrix (row (2i + j) * out + d) once per version, reuses it while the
    version counter stands, converts again after an in-place ``copy_``, and
    launches exactly once a call."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "ptr", lambda t: t)
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    rng = np.random.default_rng(3)
    src, k1, b1, lns, lnb, k2, b2, hyper = _k6_inputs(rng, 1, 8, 2)
    w1, w2 = _to_torch_conv(k1), _to_torch_conv(k2)
    t = torch.from_numpy
    run = lambda: fused_upscale.upscale_hyper_cuda(t(src).bfloat16(), w1, t(b1), t(lns), t(lnb), w2,
                                                   t(b2), t(hyper))
    before = fused_upscale.launches
    run()
    run()
    assert [c[0] for c in calls] == ["samrs_upscale_hyper"] * 2
    assert fused_upscale.launches == before + 2
    w1r, w2r = calls[0][1][1], calls[0][1][5]
    assert calls[1][1][1] is w1r and calls[1][1][5] is w2r
    assert w1r.dtype == torch.bfloat16 and tuple(w1r.shape) == (4 * C1, C)
    want = w1.permute(2, 3, 1, 0).reshape(4 * C1, C).bfloat16()
    assert torch.equal(w1r, want)
    i, j, d, c = 1, 0, 5, 17  # row (2i + j) * C1 + d, column c is w1[c, d, i, j]
    assert w1r[(2 * i + j) * C1 + d, c] == w1[c, d, i, j].bfloat16()
    assert torch.equal(w2r, w2.permute(2, 3, 1, 0).reshape(4 * C2, C1).bfloat16())
    with torch.no_grad():
        w1.copy_(w1 * 2.0)
    run()
    assert calls[2][1][1] is not w1r and calls[2][1][5] is w2r
    assert torch.equal(calls[2][1][1], w1.permute(2, 3, 1, 0).reshape(4 * C1, C).bfloat16())
    assert fused_upscale.launches == before + 3


def _k6_staged_stores(logits, h, w):
    """csrc/upscale.cu's output path on logits (B, M, P, 4 conv1 taps (i, j),
    4 sub-taps (k, l)): warpgroup 2i + j leaves lane t of a quad with sub-tap
    t = (k, l) and writes O_i[((m * 2 + k) * 64 + r) * 4 + 2 j + l], O_i
    shared by the pair of warpgroups 2i, 2i + 1; the pair then stores
    16-byte chunk c of O_i at out row 4y + 2i + k, columns 4x .. 4x + 3."""
    B, M, P = logits.shape[:3]
    out = np.full((B, M, 4 * h, 4 * w), np.nan, np.float32)
    for tile in range(B * P // 64):
        b, p0 = divmod(tile * 64, P)
        for pair in range(2):
            O = np.full(M * 2 * 64 * 4, np.nan, np.float32)
            for jt in range(2):
                for m in range(M):
                    for r in range(64):
                        for t in range(4):  # lane t of the quad holds sub-tap (t >> 1, t & 1)
                            O[((m * 2 + (t >> 1)) * 64 + r) * 4 + 2 * jt + (t & 1)] = \
                                logits[b, m, p0 + r, 2 * pair + jt, t]
            for c in range(M * 2 * 64):
                r, kr, m = c % 64, (c // 64) & 1, c // 128
                y, x = divmod(p0 + r, w)
                row = out[b, m, 4 * y + 2 * pair + kr]
                assert np.isnan(row[4 * x:4 * x + 4]).all(), "a chunk written twice"
                row[4 * x:4 * x + 4] = O[4 * c:4 * c + 4]
    return out


@pytest.mark.parametrize("G", [8, 24])
def test_k6_staged_stores_model_places_every_logit(G):
    """The kernel's staging and 16-byte stores put every logit where the
    plain version's (b, m, h, w, i, j, k, l) -> (4h + 2i + k, 4w + 2j + l)
    permutation does, each output float once, on grids whose rows a 64-pixel
    tile splits (24 x 24, as 48 x 48) or not (8 x 8)."""
    rng = np.random.default_rng(G)
    B, M = 2, 3
    logits = rng.normal(size=(B, M, G * G, 4, 4)).astype(np.float32)
    want = logits.reshape(B, M, G, G, 2, 2, 2, 2).transpose(0, 1, 2, 4, 6, 3, 5, 7)
    want = want.reshape(B, M, 4 * G, 4 * G)
    np.testing.assert_array_equal(_k6_staged_stores(logits, G, G), want)


# --- K7 ---------------------------------------------------------------------

BANDS, WARPS, STAGE_BYTES = 8, 16, 32768  # csrc/amg_post.cu


def _row_bytes(on_bits, Wp):
    """A row's threshold bits (Wo,) as the kernel stages them: lane l of a
    128-column step takes columns c0 = base + 4l .. c0 + 3 into a half byte
    (column c0 in bit 3), and the even lane of each pair writes byte c0 / 8
    = its half byte << 4 | its neighbour's.  Returns the staged bytes and
    the half bytes (per group of 4 columns)."""
    Wo = on_bits.shape[0]
    n4 = -(-Wo // 128) * 32  # half bytes of every lane of every step
    bits = np.zeros(n4 * 4, np.uint32)
    bits[:Wo] = on_bits
    nib = (bits.reshape(n4, 4) << np.array([3, 2, 1, 0], np.uint32)).sum(1)
    byte = (nib[0::2] << 4 | nib[1::2]).astype(np.uint8)  # even lanes, with lane + 1's half
    even_c0 = np.arange(0, n4 * 4, 8)
    keep = even_c0 < Wo
    out = np.full(Wp, 0x77, np.uint8)
    out[even_c0[keep] // 8] = byte[keep]
    return out, nib


def k7_model(low, g, img_size, inp, orig, mt, off):
    """csrc/amg_post.cu in numpy: (hi, lo, boxes, packed) of low (M, g, g)."""
    M = low.shape[0]
    Ho, Wo = orig
    y0, wy = amg_post._band(g, img_size, inp[0], Ho)
    x0, wx = amg_post._band(g, img_size, inp[1], Wo)
    max_rows = amg_post._band_rows(g, img_size, inp[0], Ho)
    R, Wp = -(-Ho // BANDS), -(-Wo // 8)
    RC = min(max(STAGE_BYTES // Wp, 1), R)
    packed = np.full(M * Ho * Wp, 0x5A, np.uint8)  # every byte must be written
    stats = np.zeros((M, 6), np.int64)
    big = np.iinfo(np.int32).max
    for m in range(M):
        blocks = []
        for band in range(BANDS):
            r0 = min(Ho, band * R)
            nr = min(Ho, r0 + R) - r0
            ws = np.array([[0, 0, big, big, -1, -1]] * WARPS, np.int64)
            if nr:
                iy0 = int(y0[r0])
                nrows = int(y0[r0 + nr - 1]) + 4 - iy0
                assert nrows <= max_rows
                Ls = low[m, iy0:iy0 + nrows].astype(np.float64)  # the band's one copy
            for c0r in range(0, nr, RC):
                cr = min(RC, nr - c0r)
                gs = (m * Ho + r0 + c0r) * Wp
                stage = np.full(16 + RC * Wp, 0xA5, np.uint8)
                phase = gs % 16
                for rr in range(c0r, c0r + cr):
                    warp = (rr - c0r) % WARPS
                    r = r0 + rr
                    rows = Ls[y0[r] - iy0:y0[r] - iy0 + 4]
                    V = wy[r].astype(np.float64) @ rows
                    v = (V[x0[:, None] + np.arange(4)] * wx).sum(1)
                    row, nib = _row_bytes(v > mt, Wp)
                    stage[phase + (rr - c0r) * Wp:phase + (rr - c0r + 1) * Wp] = row
                    s = ws[warp]
                    s[0] += int((v > mt + off).sum())
                    s[1] += int((v > mt - off).sum())
                    if nib.any():  # a lane's extremes: c0 + clz(nib) - 28 and c0 + 4 - ffs(nib)
                        c0 = 4 * np.flatnonzero(nib)
                        lead = np.array([f"{int(x):032b}".index("1") for x in nib[nib > 0]])
                        ffs = np.array([32 - f"{int(x):032b}".rindex("1") for x in nib[nib > 0]])
                        s[2], s[4] = min(s[2], (c0 + lead - 28).min()), max(s[4], (c0 + 4 - ffs).max())
                        s[3], s[5] = min(s[3], r), max(s[5], r)
                n = cr * Wp
                head = min(n, (16 - gs % 16) % 16)
                words = (n - head) // 16
                assert (gs + head) % 16 == 0 and (phase + head) % 16 == 0  # 16-byte stores
                packed[gs:gs + n] = stage[phase:phase + n]
                assert head + 16 * words <= n
            blocks.append([ws[:, 0].sum(), ws[:, 1].sum(), ws[:, 2].min(), ws[:, 3].min(),
                           ws[:, 4].max(), ws[:, 5].max()])
        b = np.array(blocks)
        fin = [b[:, 0].sum(), b[:, 1].sum(), b[:, 2].min(), b[:, 3].min(), b[:, 4].max(), b[:, 5].max()]
        if fin[5] < 0:
            fin[2:] = [0, 0, 0, 0]
        stats[m] = fin
    return (stats[:, 0].astype(np.int32), stats[:, 1].astype(np.int32),
            stats[:, 2:].astype(np.int32), packed.reshape(M, Ho, Wp))


K7_GEOMETRIES = {  # g, image_size, input size, original size
    "dior_800": (256, 1024, (1024, 1024), (800, 800)),
    "dota_1024": (256, 1024, (1024, 1024), (1024, 1024)),
    "fair1m_1000": (256, 1024, (1024, 1024), (1000, 1000)),
    "main_768x1024": (256, 1024, (768, 1024), (768, 1024)),
    "size512_800": (128, 512, (512, 512), (800, 800)),
    "size256_800": (64, 256, (256, 256), (800, 800)),
    "wo61": (16, 64, (48, 64), (37, 61)),
    "wo150": (32, 128, (128, 96), (200, 150)),
}


def _k7_masks(rng, g):
    """Two random masks, an empty one, a full one and one whose logits are
    over the threshold in one low-res column only."""
    col = np.full((g, g), -8.0, np.float32)
    col[:, g // 3] = 8.0
    return np.stack([rng.normal(size=(g, g)) * 3.0, rng.normal(size=(g, g)) * 3.0 - 2.0,
                     np.full((g, g), -6.0), np.full((g, g), 6.0), col]).astype(np.float32)


@pytest.mark.parametrize("geometry", sorted(K7_GEOMETRIES))
def test_k7_tiling_model_equals_pallas_interpret(geometry):
    """The model of the kernel's tiling gives hi, lo, boxes and the packed
    bytes of the Pallas kernel in interpret mode.  The model sums in float64
    and the Pallas kernel in fp32, so a pixel whose logit lies within 1e-4 of
    a threshold may fall either way (the smoke's rule for the kernel): the
    bits must agree everywhere else and hi / lo within those pixels' counts;
    with none near, all four outputs must be equal."""
    g, img, inp, orig = K7_GEOMETRIES[geometry]
    low = _k7_masks(np.random.default_rng(g + orig[1]), g)
    mt, off = 0.0, 1.0
    hi, lo, boxes, packed = k7_model(low, g, img, inp, orig, mt, off)
    want = jax_amg_postprocess(jnp.asarray(low), inp, orig, img, mt, off, interpret=True)
    w_hi, w_lo, w_boxes = (np.asarray(a) for a in want[:3])
    w_packed = np.asarray(want[3]).astype(np.uint8)
    wy = amg_post._composed_axis(g, img, inp[0], orig[0]).astype(np.float64)
    wx = amg_post._composed_axis(g, img, inp[1], orig[1]).astype(np.float64)
    logits = wy @ low.astype(np.float64) @ wx.T
    near = lambda thr: np.abs(logits - thr) < 1e-4
    bits = np.unpackbits(packed, axis=-1)[..., :orig[1]].astype(bool)
    w_bits = np.unpackbits(w_packed, axis=-1)[..., :orig[1]].astype(bool)
    assert not (bits != w_bits)[~near(mt)].any()
    assert (np.abs(hi - w_hi) <= near(mt + off).sum((1, 2))).all()
    assert (np.abs(lo - w_lo) <= near(mt - off).sum((1, 2))).all()
    if not (near(mt) | near(mt + off) | near(mt - off)).any():
        np.testing.assert_array_equal(packed, w_packed)
        np.testing.assert_array_equal(hi, w_hi)
        np.testing.assert_array_equal(lo, w_lo)
        np.testing.assert_array_equal(boxes, w_boxes)
    # the model's own boxes are its bits' tight boxes, zeros when empty
    own = amg_post._boxes_from_masks(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(boxes, own)
    assert (boxes[2] == 0).all() and (hi[2], lo[2]) == (0, 0)  # the empty mask
    assert hi[3] == lo[3] == orig[0] * orig[1]  # the full mask
    np.testing.assert_array_equal(boxes[3], [0, 0, orig[1] - 1, orig[0] - 1])


@pytest.mark.parametrize("geometry", sorted(K7_GEOMETRIES))
def test_k7_band_rows_cover_every_band(geometry):
    """``_band_rows`` is the most input rows any band of ceil(H / 8) output
    rows reads, every row's 4 taps lie in its band's copy, and the staged
    chunk of rows fits the kernel's staging buffer."""
    g, img, inp, orig = K7_GEOMETRIES[geometry]
    y0, _ = amg_post._band(g, img, inp[0], orig[0])
    rows = amg_post._band_rows(g, img, inp[0], orig[0])
    R = -(-orig[0] // BANDS)
    extents = []
    for r0 in range(0, orig[0], R):
        band = y0[r0:r0 + R]
        assert (band >= band[0]).all() and (band + 4 <= band[-1] + 4).all()
        extents.append(int(band[-1]) + 4 - int(band[0]))
    assert rows == max(extents) and 4 <= rows <= g
    assert min(max(STAGE_BYTES // -(-orig[1] // 8), 1), R) * -(-orig[1] // 8) <= STAGE_BYTES


K7_WIDE = {  # original sizes whose column tables outgrow a block's shared memory
    "wide_7000": (256, 1024, (1024, 1024), (7000, 7000)),
    "wide_8000": (256, 1024, (1024, 1024), (8000, 8000)),
    "dota_v2_20000": (256, 1024, (1024, 1024), (20000, 20000)),
}


@pytest.mark.parametrize("geometry", sorted(K7_GEOMETRIES) + sorted(K7_WIDE)
                         + ["strip_1000x8000"])
def test_k7_smem_layout_fits_every_width(geometry):
    """One block of the kernel fits shared memory at every width: the
    generator's geometries (and a 1000x8000 strip) keep the row and column
    tables there, wider scenes read them from global memory, and the block
    then needs the same ~86 KB whatever the width."""
    g, img, inp, orig = {**K7_GEOMETRIES, **K7_WIDE,
                         "strip_1000x8000": (256, 1024, (128, 1024), (1000, 8000))}[geometry]
    rows = amg_post._band_rows(g, img, inp[0], orig[0])
    total, tables = amg_post._smem_layout(g, orig[0], orig[1], rows)
    assert total <= amg_post.SMEM_MAX
    assert tables == (geometry not in K7_WIDE)
    # the tables take 20 bytes a column and 20 a band row beside the rest
    R, Wo4 = -(-orig[0] // BANDS), -(-orig[1] // 4) * 4
    base, _ = amg_post._smem_layout(g, 8, 8, rows)
    if tables:
        assert total >= 20 * (Wo4 + R)
    else:
        assert total + 20 * (Wo4 + R) > amg_post.SMEM_MAX and total < base + 16 + STAGE_BYTES
