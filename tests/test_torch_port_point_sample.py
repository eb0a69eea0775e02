"""K9's coordinate entry (``bilinear_gather.point_sample_coords``, the
Mask2Former point losses' sampler) against the JAX package on the CPU, and
CPU models of its Hopper kernel (csrc/point_sample.cu): the [0, 1] -> pixel
arithmetic it does in registers, its work split over blocks, bands and
threads, and the shape dispatch of ``point_sample_plan``.

The plain version is held against JAX ``point_sample_pallas`` in interpret
mode (fed ``2c - 1``, as JAX ``mask2former.point_sample`` feeds it on the
TPU) and against JAX ``mask2former.point_sample`` itself (its CPU route,
``sampling.grid_sample``), forward and dimg, at the suite's tolerance: fp32
on both sides, only the summation order differs (1e-4 relative L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.bilinear_gather import point_sample_pallas
from samrs_tpu.seg.decoders import mask2former as jm2f
from samrs_tpu_torch.kernels import _build, bilinear_gather as bg
from samrs_tpu_torch.seg.decoders import mask2former as m2f

TOL = 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _coords(rng, N, K):
    """xy in [0, 1] and off the map, with points exactly at 0 and at 1."""
    c = rng.uniform(-0.2, 1.2, (N, K, 2)).astype(np.float32)
    c[:, :8] = np.array([[0, 0], [1, 1], [0, 1], [1, 0], [0.5, 0], [1, 0.5], [-0.3, 0.5],
                         [0.5, 1.3]], np.float32)
    return c


def _eager_glue(coords: torch.Tensor, H: int, W: int):
    """The caller's arithmetic before the coordinate entry existed
    (mask2former.point_sample): the points the kernel must reproduce."""
    g = 2.0 * coords.float() - 1.0
    return ((g[..., 0] + 1.0) * W - 1.0) * 0.5, ((g[..., 1] + 1.0) * H - 1.0) * 0.5


def _port(img, coords, dout):
    t_img = torch.from_numpy(img).requires_grad_()
    out = bg.point_sample_coords(t_img, torch.from_numpy(coords))
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), t_img.grad.numpy()


@pytest.mark.parametrize("N,H,W,K", [(3, 7, 9, 200), (2, 16, 16, 513), (2, 56, 56, 300)])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "mask2former"])
def test_coordinate_entry_matches_jax(N, H, W, K, oracle):
    """Forward and dimg of the coordinate entry's plain version (the CPU
    route) against the Pallas sampler in interpret mode at 2c - 1 and against
    JAX mask2former.point_sample; K not a multiple of 128."""
    rng = np.random.default_rng(N * 1000 + K)
    img = rng.normal(size=(N, H, W)).astype(np.float32)
    coords = _coords(rng, N, K)
    dout = rng.normal(size=(N, K)).astype(np.float32)
    if oracle == "pallas_interpret":
        fn = lambda m: point_sample_pallas(m, 2.0 * jnp.asarray(coords) - 1.0, interpret=True)
    else:
        fn = lambda m: jm2f.point_sample(m, jnp.asarray(coords))
    want, vjp = jax.vjp(fn, jnp.asarray(img))
    (want_dimg,) = vjp(jnp.asarray(dout))
    got, got_dimg = _port(img, coords, dout)
    assert got.shape == (N, K) and got_dimg.shape == (N, H, W)
    assert _rel_l2(got, want) <= TOL
    assert _rel_l2(got_dimg, want_dimg) <= TOL


def test_coordinate_entry_equals_the_old_glue_route():
    """The entry's plain version is the old caller's route bit for bit
    (glue, then point_sample_plain), forward and both gradients; and
    mask2former.point_sample takes it on either path on the CPU."""
    rng = np.random.default_rng(7)
    img = torch.from_numpy(rng.normal(size=(3, 9, 11)).astype(np.float32))
    coords = torch.from_numpy(_coords(rng, 3, 77))
    dout = torch.from_numpy(rng.normal(size=(3, 77)).astype(np.float32))
    runs = []
    for route in ("old", "entry", "m2f", "m2f_plain"):
        i, c = img.clone().requires_grad_(), coords.clone().requires_grad_()
        if route == "old":
            out = bg.point_sample_plain(i, *_eager_glue(c, 9, 11))
        elif route == "entry":
            out = bg.point_sample_coords(i, c)
        else:
            out = m2f.point_sample(i, c, plain=route == "m2f_plain")
        out.backward(dout)
        runs.append([out.detach().numpy(), i.grad.numpy(), c.grad.numpy()])
    for run in runs[1:]:
        for g, w in zip(run, runs[0]):
            np.testing.assert_array_equal(g, w)


def _kernel_to_pixel(c: np.ndarray, size: int) -> np.ndarray:
    """csrc/point_sample.cu ``to_pixel``: fma(c, 2, -1), + 1, * size, then
    fma(v, 0.5, -0.5), each fma exact in float64 and rounded once to float32."""
    f32, f64 = np.float32, np.float64
    g = (c.astype(f64) * 2 - 1).astype(f32)
    v = (g + f32(1)) * f32(size)
    return (v.astype(f64) * 0.5 - 0.5).astype(f32)


def _kernel_to_coord_grad(d: np.ndarray, size: int) -> np.ndarray:
    f32 = np.float32
    return ((d * f32(0.5)) * f32(size)) * f32(2)


@pytest.mark.parametrize("H,W", [(56, 56), (7, 9), (256, 256), (1, 3)])
def test_in_register_coordinates_equal_the_eager_glue(H, W):
    """The kernel's [0, 1] -> pixel arithmetic gives the eager glue's fx, fy
    bit for bit (the uncertainty top-k keeps points by the values they give):
    uniform draws as the loss draws them, 0, 1, off the map and float32's
    extremes of [0, 1)."""
    rng = np.random.default_rng(H * W)
    c = rng.random((4, 5000, 2), dtype=np.float32)
    c[0, :6] = np.array([[0, 0], [1, 1], [-0.25, 1.5], [np.nextafter(np.float32(1), 0), 1e-8],
                         [1e-30, 0.5], [0.5, 3.0]], np.float32)
    fx, fy = _eager_glue(torch.from_numpy(c), H, W)
    np.testing.assert_array_equal(_kernel_to_pixel(c[..., 0], W), fx.numpy())
    np.testing.assert_array_equal(_kernel_to_pixel(c[..., 1], H), fy.numpy())
    np.testing.assert_array_equal(bg.pixel_coords(torch.from_numpy(c), H, W)[0].numpy(), fx.numpy())
    # dcoords: autograd's chain through the glue, which the kernel repeats for dfx, dfy
    t = torch.from_numpy(c).requires_grad_()
    d = torch.from_numpy(rng.normal(size=(4, 5000, 2)).astype(np.float32))
    fx, fy = _eager_glue(t, H, W)
    (fx * d[..., 0] + fy * d[..., 1]).sum().backward()
    np.testing.assert_array_equal(_kernel_to_coord_grad(d.numpy()[..., 0], W), t.grad.numpy()[..., 0])
    np.testing.assert_array_equal(_kernel_to_coord_grad(d.numpy()[..., 1], H), t.grad.numpy()[..., 1])


# --------------------------------------------- dimg's fixed-point partial ----

M = np.float32(12582912.0)  # 1.5 2^23


def _fixed_for(S: float, K: int):
    """csrc/point_sample.cu ``fixed_for``: (sh, lob)."""
    lob = min(22, 32 - int(K).bit_length())
    e = int(np.frexp(np.float32(S))[1]) if 0 < S < np.inf else 0
    return max(-126, min(127, 21 - e)), lob


def _split(v: np.ndarray, sh: int, lob: int):
    """``Fixed::split`` in float32 (each fma exact in float64, rounded once)."""
    f32, f64 = np.float32, np.float64
    x = v.astype(f64) * 2.0 ** sh  # exact
    xr = (x + f64(M)).astype(f32)
    hi = xr.view(np.int32) - M.view(np.int32)
    rem = (x - (xr - M).astype(f64)).astype(f32)
    lo = (rem.astype(f64) * 2.0 ** lob + f64(M)).astype(f32).view(np.int32) - M.view(np.int32)
    return hi.astype(np.int64), lo.astype(np.int64)


@pytest.mark.parametrize("K,scale", [(12544, 1.0), (12544, 3e-7), (37632, 40.0), (3, 1e-30)])
def test_fixed_point_dimg_rounds_the_sum_once(K, scale):
    """The backward's fixed-point partial (two int32 words a pixel, native
    integer atomics) sums a mask's contributions r * w to within its
    resolution of the exact sum and rounds that once to fp32: every pixel
    within half an fp32 ulp (plus the resolution S 2^-(21 + lob)) of the
    exact sum, each word inside int32, and the sum independent of the order
    of the adds (no run-to-run variation).  The resolution bounds each add's
    rounding, so a pixel's bound counts the adds into that pixel."""
    rng = np.random.default_rng(K)
    H = W = 56
    r = (rng.normal(size=K) * scale).astype(np.float32)
    r[:3] *= 50  # a few large gradients
    fx, fy = (rng.random(K) * W - 0.5).astype(np.float32), (rng.random(K) * H - 0.5).astype(np.float32)
    x0, y0 = np.floor(fx), np.floor(fy)
    wx, wy = (fx - x0).astype(np.float32), (fy - y0).astype(np.float32)
    ax, ay = np.float32(1) - wx, np.float32(1) - wy
    pix, val = [], []
    for dy, dx, w in ((0, 0, ax * ay), (0, 1, wx * ay), (1, 0, ax * wy), (1, 1, wx * wy)):
        x, y = x0.astype(int) + dx, y0.astype(int) + dy
        ok = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        pix.append((y * W + x)[ok])
        val.append((r * w.astype(np.float32)).astype(np.float32)[ok])
    pix, val = np.concatenate(pix), np.concatenate(val)
    S = float(np.abs(r).sum(dtype=np.float32))
    sh, lob = _fixed_for(S, K)
    hi, lo = _split(val, sh, lob)
    got = []
    for order in (np.arange(len(pix)), rng.permutation(len(pix))):
        hs = np.bincount(pix[order], hi[order], H * W).astype(np.int64)
        ls = np.bincount(pix[order], lo[order], H * W).astype(np.int64)
        assert np.abs(hs).max() < 2 ** 31 and np.abs(ls).max() < 2 ** 31
        got.append(np.float32((hs * 2.0 ** lob + ls) * 2.0 ** -(sh + lob)))
    np.testing.assert_array_equal(got[0], got[1])
    exact = np.bincount(pix, val.astype(np.float64), H * W)
    resolution = np.bincount(pix, minlength=H * W) * S * 2.0 ** -(21 + lob)
    ulp = np.spacing(np.abs(exact).astype(np.float32)).astype(np.float64)
    assert (np.abs(got[0] - exact) <= ulp / 2 + resolution).all()


def test_fixed_point_words_hold_the_worst_pixel():
    """All K points on one pixel with the largest |dout|: the hi and lo
    words stay inside int32 (the bounds ``fixed_for`` sets sh and lob by)."""
    for K in (1, 3, 12544, 37632, 1 << 20):
        r = np.full(K, -3.75, np.float32)
        sh, lob = _fixed_for(float(np.abs(r).sum(dtype=np.float32)), K)
        hi, lo = _split(r, sh, lob)
        assert abs(int(hi.sum())) < 2 ** 31 and abs(int(lo.sum())) < 2 ** 31
        assert np.float32((hi.sum() * 2.0 ** lob + lo.sum()) * 2.0 ** -(sh + lob)) == np.float32(-3.75 * K)


# ------------------------------------------------- the kernel's work split ----

VEC = bg.PS_VEC


def _block_points(K: int, blocks: int, b: int):
    """csrc/point_sample.cu ``block_points``: the points [k0, k1) of a mask
    that block `b` of its `blocks` takes, equal shares in multiples of 4."""
    share = -(-K // blocks)
    chunk = -(-share // VEC) * VEC
    k0 = min(K, b * chunk)
    return k0, min(K, k0 + chunk)


def _band_rows(H: int, form: int, blocks: int) -> int:
    """Rows of dimg's partial each block of a mask holds: H but in the BANDS form."""
    return -(-H // blocks) if form == bg.PS_BANDS else H


def _band(H: int, blocks: int, b: int):
    """csrc/point_sample.cu ``point_sample_bwd_kernel``: block b's rows [r0, r1)."""
    rows = -(-H // blocks)
    r0 = min(H, b * rows)
    return r0, min(H, r0 + rows)


def _span(f0: int, f1: int):
    """csrc/point_sample.cu ``Span``: (the groups' flat starts, the single points)."""
    v0 = min(-(-f0 // VEC) * VEC, f1)
    v1 = max(f1 // VEC * VEC, v0)
    return np.arange(v0, v1, VEC), list(range(f0, v0)) + list(range(v1, f1))


def _visits(N: int, K: int, form: int, blocks: int, grad):
    """Every (flat point, block, thread) the kernel takes in the form's work
    split.  SMEM: the forward's `blocks` blocks a mask take ``block_points``
    shares, the backward's one block all of them; BANDS: every block of a mask
    takes all of its points; groups of VEC points round robin over the
    threads, the single points one a thread.  GLOBAL: one point a thread."""
    threads = bg.PS_THREADS[form]
    if form == bg.PS_GLOBAL:
        f = np.arange(N * K)
        return f, f // threads, f % threads
    points, block_of, thread_of = [], [], []
    for n in range(N):
        for b in range(blocks):
            share = form == bg.PS_SMEM and grad is None
            k0, k1 = _block_points(K, blocks, b) if share else (0, K)
            starts, singles = _span(n * K + k0, n * K + k1)
            assert (starts % VEC == 0).all()  # 16-byte coordinate loads and output stores
            j = np.arange(len(starts))
            points.append(np.concatenate([starts + q for q in range(VEC)]
                                         + [np.asarray(singles, np.int64)]))
            thread_of.append(np.concatenate([j % threads] * VEC + [np.arange(len(singles)) % threads]))
            block_of.append(np.full(len(points[-1]), n * blocks + b))
    return np.concatenate(points), np.concatenate(block_of), np.concatenate(thread_of)


def _past_reach(grad, elem_bytes: int = 4) -> int:
    """The smallest square side that the shared-memory forms do not take
    (GLOBAL form) in the forward (grad None) or a backward form."""
    side = 7
    while bg.point_sample_plan(1, side, side, 4, elem_bytes, grad)[0] != bg.PS_GLOBAL:
        side += 1
    return side


def _arrays(grad, elem_bytes: int = 4):
    """What a shared-memory form holds: the map (forward), dimg's fixed-point
    partial (two int32 words a pixel) and, with the coordinate gradient, the map."""
    return [elem_bytes] if grad is None else [4, 4] + ([elem_bytes] if grad else [])


@pytest.mark.parametrize("K", [1, 3, 12544, 37632])
@pytest.mark.parametrize("side", [7, 56, 256, "past"])
@pytest.mark.parametrize("grad", [None, False, True])
def test_work_split_covers_every_point_once_and_every_pixel_has_one_owner(K, side, grad):
    side = _past_reach(grad) if side == "past" else side
    N = 3
    form, blocks = bg.point_sample_plan(N, side, side, K, 4, grad)
    # the dispatch: the form the shared memory takes, and no smaller one
    fits = lambda rows: bg._ps_smem_bytes(rows, side, _arrays(grad)) <= bg.PS_SMEM_BUDGET
    if form == bg.PS_GLOBAL:
        assert not fits(side) and (grad is not False or not fits(-(-side // bg.PS_MAX_BLOCKS)))
    else:
        assert fits(_band_rows(side, form, blocks))
        assert form == bg.PS_SMEM or (grad is False and not fits(-(-side // (blocks // 2))))
    if K > 12544 and form == bg.PS_GLOBAL:
        return  # one point a thread: the model is the identity (the smaller K cover it)
    pts, blk, thr = _visits(N, K, form, blocks, grad)
    assert (thr < bg.PS_THREADS[form]).all()
    if form != bg.PS_GLOBAL:
        assert (blk // blocks == pts // K).all(), "a block took another mask's point"
    visits = blocks if form == bg.PS_BANDS else 1  # BANDS: each block of the mask, once
    assert np.array_equal(np.sort(pts), np.repeat(np.arange(N * K), visits)), \
        "a point taken twice by a block, or never"
    assert len(np.unique(pts * (N * blocks) + blk)) == len(pts)
    if grad is None or form != bg.PS_BANDS:
        return
    # BANDS: every row of dimg held, and every corner on the map added, by exactly one block
    held = np.zeros(side, int)
    for b in range(blocks):
        r0, r1 = _band(side, blocks, b)
        held[r0:r1] += 1
    assert (held == 1).all()
    # corner rows of points over the map, off it, and on the bands' first and last rows
    fy = np.random.default_rng(K + side).uniform(-3, side + 2, K).astype(np.float32)
    if K >= 4:
        fy[:4] = np.array([-1.5, -0.5, side - 1.5, side - 0.5], np.float32)
    y0 = np.floor(fy).astype(np.int64)
    for y in (y0, y0 + 1):
        on = (y >= 0) & (y < side)
        adders = sum(((y >= r0) & (y < r1)).astype(int)
                     for r0, r1 in (_band(side, blocks, b) for b in range(blocks)))
        assert (adders[on] == 1).all() and (adders[~on] == 0).all()


def test_dispatch_picks_the_forms_of_the_paths_shapes():
    plan = bg.point_sample_plan
    # the FAST head's point loss and candidates: one block a mask, the map in shared memory
    assert plan(6500, 56, 56, 12544, 4) == (bg.PS_SMEM, 1)
    assert plan(6500, 56, 56, 37632, 4) == (bg.PS_SMEM, 1)
    assert plan(6500, 56, 56, 12544, 4, False) == (bg.PS_SMEM, 1)
    assert plan(6500, 56, 56, 12544, 4, True) == (bg.PS_SMEM, 1)
    # few masks: the forward shares a mask's points over blocks, the backward never
    assert plan(40, 56, 56, 12544, 4) == (bg.PS_SMEM, 6)
    assert plan(40, 56, 56, 12544, 4, False) == (bg.PS_SMEM, 1)
    # 256^2: 256 KB of fp32 fits no block (device memory); dimg's two words over 4 bands; the
    # coordinate gradient's map and dimg in device memory; bf16 fits a block
    assert plan(300, 256, 256, 12544, 4) == (bg.PS_GLOBAL, 1)
    assert plan(300, 256, 256, 12544, 4, False) == (bg.PS_BANDS, 4)
    assert plan(300, 256, 256, 12544, 4, True) == (bg.PS_GLOBAL, 1)
    assert plan(300, 256, 256, 12544, 2) == (bg.PS_SMEM, 2)
    for grad, below in ((None, (bg.PS_SMEM, 1)), (False, (bg.PS_BANDS, 8)), (True, (bg.PS_SMEM, 1))):
        side = _past_reach(grad)
        assert plan(2, side - 1, side - 1, 9, 4, grad) == below
        assert plan(2, side, side, 9, 4, grad) == (bg.PS_GLOBAL, 1)


# ------------------------------------------------------------ the wrappers ----


def _fake_build(monkeypatch, calls):
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "ptr", lambda t: None if t is None else tuple(t.shape))
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(bg, "_sms", lambda device: 132)
    monkeypatch.setattr(bg, "ps_fwd_launches", 0)
    monkeypatch.setattr(bg, "ps_bwd_launches", 0)


def _no_plain(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a kernel call was rerouted to the plain version")

    for name in ("point_sample_plain_fwd", "point_sample_plain_bwd", "point_sample_coords_plain"):
        monkeypatch.setattr(bg, name, refuse)


def test_wrappers_pass_the_plan_and_count_one_launch(monkeypatch):
    calls = []
    _fake_build(monkeypatch, calls)
    _no_plain(monkeypatch)
    img, xy = torch.zeros(300, 256, 256), torch.zeros(300, 64, 2)
    dout = torch.zeros(300, 64)
    out = bg.point_sample_coords_fwd_cuda(img, xy)
    dimg, dxy = bg.point_sample_coords_bwd_cuda(img, xy, dout)
    _, dxy2 = bg.point_sample_coords_bwd_cuda(img, xy, dout, True)
    assert out.shape == (300, 64) and dimg.shape == (300, 256, 256) and dxy is None
    assert dxy2.shape == (300, 64, 2)
    (n1, a1), (n2, a2), (n3, a3) = calls
    assert n1 == "samrs_point_sample_fwd" and a1[-2:] == (bg.PS_GLOBAL, 1) and a1[-3] == 1
    assert n2 == "samrs_point_sample_bwd" and a2[-2:] == (bg.PS_BANDS, 4) and a2[5] is None
    assert a3[-2:] == (bg.PS_GLOBAL, 1) and a3[5] == (300, 64, 2) and a3[6] is None
    calls.clear()
    fx = torch.zeros(6500, 12544)
    bg.point_sample_fwd_cuda(torch.zeros(6500, 56, 56), fx, fx)
    bg.point_sample_bwd_cuda(torch.zeros(6500, 56, 56), fx, fx, fx, False)
    assert [a[-5:] for _, a in calls] == [(12544, 0, 0, bg.PS_SMEM, 1)] * 2
    assert (bg.ps_fwd_launches, bg.ps_bwd_launches) == (2, 3)


def test_global_form_zeroes_dimg_and_the_others_leave_it_to_the_kernel(monkeypatch):
    calls, allocs = [], []
    _fake_build(monkeypatch, calls)
    for name in ("zeros", "empty"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _r=real, _n=name, **k: (
            allocs.append((_n, a)), _r(*a, **k))[1])
    past = _past_reach(False)
    for H, grad, alloc in ((56, False, "empty"), (256, False, "empty"), (past, False, "zeros"),
                           (56, True, "empty"), (256, True, "zeros")):
        allocs.clear()
        img = torch.zeros(1).expand(1, H, H)
        dxy = torch.zeros(1, 8, 2) if grad else None
        bg._ps_bwd(img, torch.zeros(1, 8, 2), None, torch.zeros(1, 8), 8, dxy, None)
        dimg_alloc = [n for n, a in allocs if a[1:] == (H, H)]
        assert dimg_alloc == [alloc]


@pytest.mark.parametrize("shape", [(1, 50000, 50000), (1, 1, 1 << 22), (1, 3, 0)])
def test_wrappers_raise_on_what_no_form_takes(monkeypatch, shape):
    """No form takes a map past 2^31 pixels, a side of 2^22 or an empty one:
    the wrappers raise, launch nothing and never fall back to the plain
    version."""
    calls = []
    _fake_build(monkeypatch, calls)
    _no_plain(monkeypatch)
    img = torch.zeros(1).expand(*shape) if 0 not in shape else torch.zeros(shape)
    xy, f = torch.zeros(1, 8, 2), torch.zeros(1, 8)
    for call in (lambda: bg.point_sample_coords_fwd_cuda(img, xy),
                 lambda: bg.point_sample_coords_bwd_cuda(img, xy, f),
                 lambda: bg.point_sample_fwd_cuda(img, f, f),
                 lambda: bg.point_sample_bwd_cuda(img, f, f, f)):
        with pytest.raises(ValueError, match="no K9 form"):
            call()
    assert calls == [] and (bg.ps_fwd_launches, bg.ps_bwd_launches) == (0, 0)


def test_coordinate_entry_checks_its_inputs(monkeypatch):
    calls = []
    _fake_build(monkeypatch, calls)
    img = torch.zeros(2, 5, 5)
    with pytest.raises(ValueError, match=r"coords \(N, K, 2\)"):
        bg.point_sample_coords_fwd_cuda(img, torch.zeros(2, 7, 3))
    with pytest.raises(ValueError, match="the kernel takes"):
        bg.point_sample_coords_fwd_cuda(img.half(), torch.zeros(2, 7, 2))
    with pytest.raises(ValueError, match="16-byte aligned"):
        bg.point_sample_coords_fwd_cuda(img, torch.zeros(2 * 7 * 2 + 1)[1:].reshape(2, 7, 2))
    assert calls == []


def test_coordinate_entry_on_cpu_builds_nothing_and_counts_nothing(monkeypatch):
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(bg, "ps_fwd_launches", 0)
    monkeypatch.setattr(bg, "ps_bwd_launches", 0)
    rng = np.random.default_rng(9)
    img = rng.normal(size=(2, 6, 7)).astype(np.float32)
    _port(img, _coords(rng, 2, 13), rng.normal(size=(2, 13)).astype(np.float32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        bg.point_sample_coords_fwd_cuda(torch.from_numpy(img), torch.zeros(2, 13, 2))
    assert (bg.ps_fwd_launches, bg.ps_bwd_launches) == (0, 0)
