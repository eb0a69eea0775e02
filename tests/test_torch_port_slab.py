"""K8-slab (``sample_weighted(..., row_slab=h)``: the DCNv3 / MSDeformAttn row-slab gather)
against the JAX package on the CPU, and CPU models of its Hopper kernels
(csrc/bilinear_slab.cu): the forward's work split into items and the backward's lanes, each
item's band (its taps' active slabs under the JAX predicate) and whether it fits a stage,
the shared memory a launch asks for (``slab_plan``), and the wrappers' refusals.

The plain version (the slab mode's CPU route) is held against JAX ``sample_weighted(...,
interpret=True, row_slab=7)`` at the suite's tolerance: fp32 on both sides, only the
summation order differs (1e-4 relative L2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.bilinear_gather import sample_weighted as jax_sample_weighted
from samrs_tpu_torch.kernels import _build, bilinear_gather as bg

TOL = 1e-4
HS = 7  # the slab height of the InternImage runs (SAMRS_BILINEAR_SLAB=7)


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _far(fy, H: int, W: int, taps, p0: int = 0):
    """The `taps` of every query moved H/2 rows into the other half of the map (down from the
    top half, up from the bottom one), as chip_smoke.slab_case's "dcn_far"."""
    row = (p0 + np.arange(fy.shape[1])) // W
    fy[:, :, taps] += np.where(row < H // 2, H // 2, -(H // 2))[None, :, None]
    return fy


def _dcn_coords(rng, BG, H, W, p0=0, P=None):
    """DCNv3's 3x3 base grid (taps column-major) of the output pixels p0 .. p0 + P, plus
    offsets of up to 1.5 px: InternImage's sampling."""
    bx, by = bg._dcnv3_base_grid(H, W, 3, 3, 1, 1, 1, 1, 1, 1)
    P = H * W if P is None else P
    bx, by = bx[p0:p0 + P], by[p0:p0 + P]
    u = lambda: (rng.random((BG, P, 9)) * 3 - 1.5).astype(np.float32)
    return (bx[None] + u()).astype(np.float32), (by[None] + u()).astype(np.float32)


# ------------------------------------------------------- against the JAX package ----


@pytest.mark.parametrize("H,BG,far", [(56, 1, False), (28, 1, True), (14, 1, False),
                                      (7, 2, False)])
def test_slab_sample_weighted_matches_pallas_interpret(H, BG, far):
    """``sample_weighted(row_slab=7)`` against JAX ``sample_weighted(interpret=True,
    row_slab=7)`` on InternImage's four map sizes: DCNv3 coordinates of up to 64 output
    pixels from the map's middle row (one JAX query block), on 28^2 with tap 8 of every
    query moved half the map away; the forward and the gradients in xg, fx, fy and mask."""
    rng = np.random.default_rng(H + 100 * far)
    Gc, W = 4, H
    P = min(H * W, 64)
    p0 = min((H // 2) * W, H * W - P)
    fx, fy = _dcn_coords(rng, BG, H, W, p0, P)
    if far:
        fy = _far(fy, H, W, [8], p0)
    mask = rng.random((BG, P, 9)).astype(np.float32)
    xg = rng.normal(size=(BG, H, W * Gc)).astype(np.float32)
    dout = rng.normal(size=(BG, P, Gc)).astype(np.float32)

    @jax.jit
    def jax_both(*a):
        out, vjp = jax.vjp(lambda *b: jax_sample_weighted(*b, Gc, interpret=True, row_slab=HS),
                           *a[:4])
        return (out,) + tuple(vjp(a[4]))

    want = [np.asarray(w) for w in jax_both(*map(jnp.asarray, (xg, fx, fy, mask, dout)))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (xg, fx, fy, mask)]
    got = bg.sample_weighted(*ts, Gc, row_slab=HS)
    got.backward(torch.from_numpy(dout))
    got = [got.detach().numpy()] + [t.grad.numpy() for t in ts]
    for name, g, w in zip(("out", "dxg", "dfx", "dfy", "dmask"), got, want):
        assert _rel_l2(g, w) <= TOL, (name, _rel_l2(g, w))


# ------------------------------------------- the kernels' work split and bands ----

B = 65  # images of the FAST head (chip_smoke.TRAIN_BATCH[2])
# chip_smoke.k8_slab_phase's cases: key, BG, H, W, Gc, P, K, element bytes, coords, Hs
SMOKE_CASES = [(f"ii_l{lvl}", B * G, 56 >> lvl, 56 >> lvl, 16, (56 >> lvl) ** 2, 9, 4, "dcn", HS)
               for lvl, G in enumerate((4, 8, 16, 32))]
SMOKE_CASES += [("ii_l0_bf16", B * 4, 56, 56, 16, 56 * 56, 9, 2, "dcn", HS),
                ("msda_l28", B * 8, 28, 28, 32, 1029, 4, 4, "window", HS),
                ("scatter", 64, 64, 64, 16, 1000, 4, 4, "window", 8),
                ("wide", 4, 8, 1024, 16, 2000, 4, 4, "window", 2),
                ("gc6_bf16", 8, 16, 20, 6, 300, 3, 2, "window", 4),
                ("dcn_far", 64, 112, 112, 8, 112 * 112, 9, 4, "dcn_far", HS),
                ("dcn_gc5", 16, 14, 14, 5, 14 * 14, 9, 4, "dcn", HS)]
CASE_IDS = [c[0] for c in SMOKE_CASES]


def _items(plan, BG, P):
    return [(bg_, p0, min(plan["L"], P - p0)) for bg_ in range(BG)
            for p0 in range(0, P, plan["L"])]


@pytest.mark.parametrize("case", SMOKE_CASES, ids=CASE_IDS)
def test_work_split_evaluates_every_query_and_output_once(case):
    """The forward's items (runs of L queries of one map) partition every map's queries, so
    each (query, tap) is evaluated by one item; within an item the threads take each (query,
    channel vector) once (flat-4 at odd Gc: each group of four outputs belongs to the item
    that holds its first query, so every output is written once).  The backward (dense K8's
    kernel) gives each query a group of tpg lanes inside one warp, whose channel vectors
    cover Gc."""
    _, BG, H, W, Gc, P, K, esz, _, Hs = case
    plan = bg.slab_plan(BG, H, W, P, K, Gc, Hs, esz)
    items = _items(plan, BG, P)
    assert len(items) == plan["items"] == BG * plan["nitem"]
    queries = np.zeros(BG * P, np.int64)
    for bg_, p0, nq in items:
        queries[bg_ * P + p0:bg_ * P + p0 + nq] += 1
    assert (queries == 1).all()
    if Gc % 2 and Gc >= 3:  # flat-4
        groups = np.zeros(-(-BG * P * Gc // 4), np.int64)
        for bg_, p0, nq in items:
            q0 = bg_ * P + p0
            groups[-(-q0 * Gc // 4):-(-(q0 + nq) * Gc // 4)] += 1
        assert (groups == 1).all()
    else:
        V = 4 if Gc % 4 == 0 else 2 if Gc % 2 == 0 else 1
        n = Gc // V
        outs = np.zeros(BG * P * Gc, np.int64)
        for bg_, p0, nq in items:
            e = np.arange(nq * n)
            q = bg_ * P + p0 + e // n
            for j in range(V):
                np.add.at(outs, q * Gc + (e % n) * V + j, 1)
        assert (outs == 1).all()
    V = 4 if Gc % 4 == 0 else 1
    l = min(5, int(np.ceil(np.log2(Gc // V)))) if Gc // V > 1 else 0
    tpg, threads = 1 << l, 256
    assert 32 % tpg == 0 and tpg * -(-(Gc // V) // tpg) >= Gc // V
    gid = np.arange(-(-(BG * P << l) // threads) * threads)
    lanes = np.bincount((gid >> l)[(gid >> l) < BG * P], minlength=BG * P)
    assert (lanes == tpg).all()


def _smoke_coords(rng, key, BG, H, W, P, K, coords):
    """fy of a smoke case, drawn as chip_smoke.slab_case draws it."""
    if coords.startswith("dcn"):
        fy = _dcn_coords(rng, BG, H, W)[1]
        return _far(fy, H, W, [7, 8]) if coords == "dcn_far" else fy
    return (rng.random((BG, P, K)) * (H + 2.0) - 1.5).astype(np.float32)


def _active_slabs(fy, H: int, Hs: int):
    """JAX's predicate in fp32 (samrs_tpu/kernels/bilinear_gather.py:70-74) over an item's
    fy (nq, K): the slabs whose rows [s*Hs, s*Hs+Hs-1] meet some tap's [min fy - 1, max fy +
    1]."""
    lo, hi, one = fy.min(0), fy.max(0), np.float32(1)
    top = (np.arange(H // Hs) * Hs).astype(np.float32)[:, None]
    return ((top <= hi + one) & (top + np.float32(Hs - 1) >= lo - one)).any(1)


def _band_elements(active, Hs: int, W: int, Gc: int) -> int:
    """The stage elements the runs of `active` slabs take, each run with 8 for its phase."""
    runs = np.count_nonzero(np.diff(np.concatenate([[0], active.astype(np.int8)])) == 1)
    return int(active.sum()) * Hs * W * Gc + 8 * runs


@pytest.mark.parametrize("case", SMOKE_CASES, ids=CASE_IDS)
def test_bands_hold_the_staged_taps_and_fit_the_launch(case):
    """Each item's band at the smoke's shapes (the first maps of each; the plan at the full
    BG): its active slabs (JAX's predicate, tap by tap) hold both rows of every corner on
    the map, so any tap may be staged; the two stages and two metas fit the shared memory
    the launch asks for, and that the card's.  Every DCNv3 and MSDeformAttn band fits a
    stage whole; the scattered 64^2 and the 1024-wide maps' bands do not; in the off-band
    case the band of taps 0-6 fits and the whole band does not (the chip counts which taps
    the kernel staged: chip_smoke.k8_slab_phase)."""
    key, BG, H, W, Gc, P, K, esz, coords, Hs = case
    rng = np.random.default_rng(len(key))
    n = min(BG, 4)
    fy = _smoke_coords(rng, key, n, H, W, P, K, coords)
    y0 = np.clip(np.floor(fy), -2, H).astype(np.int64)
    plan = bg.slab_plan(BG, H, W, P, K, Gc, Hs, esz)
    assert plan["cap"] % 8 == 0
    assert plan["smem"] == 32 + 8 * plan["meta"] + 2 * esz * plan["cap"]
    assert plan["smem"] <= bg.SLAB_BUDGET
    for bg_, p0, nq in _items(plan, n, P):
        f = fy[bg_, p0:p0 + nq]
        active = _active_slabs(f, H, Hs)
        for y in (y0[bg_, p0:p0 + nq], y0[bg_, p0:p0 + nq] + 1):  # the corners' rows on the map
            assert active[np.clip(y, 0, H - 1) // Hs][(y >= 0) & (y < H)].all()
        fits = _band_elements(active, Hs, W, Gc) <= plan["cap"]
        if key in ("scatter", "wide"):
            assert not fits
        elif key == "dcn_far":
            assert not fits
            assert _band_elements(_active_slabs(f[:, :7], H, Hs), Hs, W, Gc) <= plan["cap"]
        else:
            assert fits


@pytest.mark.parametrize("case", SMOKE_CASES, ids=CASE_IDS)
def test_plan_item_spans_its_slabs_and_one_either_side(case):
    """``slab_plan``: the whole map in one stage where it fits (one item a map); else an
    item's L queries are whole rows of whole slabs (at a query a pixel; or every query, where
    there are fewer), and those slabs plus one on either side fit a stage, so that taps
    reaching one slab beyond still stage."""
    _, BG, H, W, Gc, P, K, esz, _, Hs = case
    plan = bg.slab_plan(BG, H, W, P, K, Gc, Hs, esz)
    slab_el = Hs * W * Gc
    if plan["L"] == P and plan["nitem"] == 1 and plan["cap"] >= H * W * Gc + 8:
        return
    assert plan["cap"] % (slab_el + 8) == 0
    slabs = plan["cap"] // (slab_el + 8)
    assert plan["L"] == P or plan["L"] % (Hs * W) == 0
    assert -(-plan["L"] // (Hs * W)) + 2 <= slabs or (slabs < 3 and plan["L"] <= Hs * W)


def test_plan_refuses_what_no_plan_takes():
    """A slab that does not divide H, more than SLAB_MAX_K taps, flat indices past 31 bits,
    and a map whose metadata fills the block raise."""
    for args in ((4, 56, 56, 3136, 9, 16, 5), (4, 56, 56, 3136, bg.SLAB_MAX_K + 1, 16, 7),
                 (1 << 16, 56, 56, 3136, 9, 16, 7), (1, 1 << 16, 64, 100, 4, 16, 1)):
        with pytest.raises(ValueError, match="no K8-slab plan"):
            bg.slab_plan(*args, 4)


# ------------------------------------------------------------- the wrappers ----


def _fake_build(monkeypatch, calls):
    def no_build():
        raise AssertionError("the wrapper built the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "ptr", lambda t: None if t is None else tuple(t.shape))
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(bg, "slab_fwd_launches", 0)
    monkeypatch.setattr(bg, "slab_bwd_launches", 0)

    def refuse(*a, **k):
        raise AssertionError("a kernel call was rerouted")

    for name in ("sample_weighted_plain", "sample_weighted_fwd_cuda", "sample_weighted_bwd_cuda"):
        monkeypatch.setattr(bg, name, refuse)


def _inputs(BG, H, W, Gc, P, K):
    z = torch.zeros(1)
    return (z.expand(BG, H, W * Gc), z.expand(BG, P, K), z.expand(BG, P, K), z.expand(BG, P, K),
            z.expand(BG, P, Gc))


def test_wrappers_pass_the_shape_and_count_one_launch(monkeypatch):
    calls = []
    _fake_build(monkeypatch, calls)
    xg, fx, fy, mask, dout = _inputs(260, 56, 56, 16, 3136, 9)
    out = bg.sample_weighted_slab_fwd_cuda(xg, fx, fy, mask, 16, 7)
    dxg, dfx, dfy, dmask = bg.sample_weighted_slab_bwd_cuda(xg, fx, fy, mask, dout, 16, 7)
    assert out.shape == (260, 3136, 16) and dxg.shape == (260, 56, 896)
    assert dfx.shape == dfy.shape == dmask.shape == (260, 3136, 9)
    (n1, a1), (n2, a2) = calls
    assert n1 == "samrs_bilinear_slab_fwd" and a1[5:] == (260, 56, 56, 3136, 9, 16, 7, 0)
    assert n2 == "samrs_bilinear_slab_bwd" and a2[9:] == (260, 56, 56, 3136, 9, 16, 7, 0)
    assert (bg.slab_fwd_launches, bg.slab_bwd_launches) == (1, 1)


def test_route_count_passes_the_shape_and_counts_no_launch(monkeypatch):
    """The forward's counting build (a measurement of which taps read the band) takes the
    forward's arguments and a device counter, and is not counted as a launch of the path."""
    calls = []
    _fake_build(monkeypatch, calls)
    xg, fx, fy, mask, _ = _inputs(260, 56, 56, 16, 3136, 9)
    out, band, device = bg.sample_weighted_slab_routes_cuda(xg, fx, fy, mask, 16, 7)
    assert out.shape == (260, 3136, 16) and (band, device) == (0, 0)
    ((name, args),) = calls
    assert name == "samrs_bilinear_slab_fwd_count"
    assert args[5:13] == (260, 56, 56, 3136, 9, 16, 7, 0) and args[13] == (2,)
    assert (bg.slab_fwd_launches, bg.slab_bwd_launches) == (0, 0)


@pytest.mark.parametrize("shape", [(4, 56, 56, 16, 3136, 9, 5), (2, 28, 28, 32, 1029, 33, 7),
                                   (1 << 16, 56, 56, 16, 3136, 9, 7)])
def test_wrappers_refuse_what_no_plan_takes_before_building(monkeypatch, shape):
    """A slab that does not divide H, more than SLAB_MAX_K taps, flat indices past 31 bits:
    the wrappers raise before anything is built or launched, and never reroute to dense K8
    or the plain version."""
    calls = []
    _fake_build(monkeypatch, calls)
    BG, H, W, Gc, P, K, Hs = shape
    xg, fx, fy, mask, dout = _inputs(BG, H, W, Gc, P, K)
    with pytest.raises(ValueError, match="no K8-slab plan"):
        bg.sample_weighted_slab_fwd_cuda(xg, fx, fy, mask, Gc, Hs)
    with pytest.raises(ValueError, match="no K8-slab plan"):
        bg.sample_weighted_slab_bwd_cuda(xg, fx, fy, mask, dout, Gc, Hs)
    with pytest.raises(ValueError, match="no K8-slab plan"):
        bg.sample_weighted_slab_routes_cuda(xg, fx, fy, mask, Gc, Hs)
    assert calls == [] and (bg.slab_fwd_launches, bg.slab_bwd_launches) == (0, 0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing(monkeypatch):
    """On CPU tensors the slab mode runs the plain version: nothing is built, no launch is
    counted, and its result equals ``sample_weighted_plain`` bit for bit."""
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_build)
    monkeypatch.setattr(bg, "slab_fwd_launches", 0)
    monkeypatch.setattr(bg, "slab_bwd_launches", 0)
    rng = np.random.default_rng(3)
    fx, fy = (torch.from_numpy(a) for a in _dcn_coords(rng, 2, 14, 14))
    xg = torch.from_numpy(rng.normal(size=(2, 14, 14 * 4)).astype(np.float32))
    mask = torch.from_numpy(rng.random((2, 196, 9)).astype(np.float32))
    xg.requires_grad_()
    out = bg.sample_weighted(xg, fx, fy, mask, 4, row_slab=HS)
    out.sum().backward()
    assert torch.equal(out.detach(), bg.sample_weighted_plain(xg.detach(), fx, fy, mask, 4))
    assert xg.grad is not None
    assert (bg.slab_fwd_launches, bg.slab_bwd_launches) == (0, 0)
