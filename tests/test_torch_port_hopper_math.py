"""CPU models of the arithmetic of two of the port's Hopper kernels, held
against the plain versions and the JAX package, in fp32.

K11 (csrc/fused_mlp.cu) computes the fp32 MLP on tf32 tensor cores with
split operands: each fp32 value a is hi + lo, hi rounded to tf32 (10
mantissa bits, to nearest, ties away from zero: cvt.rna.tf32.f32), lo = a -
hi read by the tensor core with its low 13 bits dropped, and each 8-deep
k-step adds lo.B_hi + hi.B_lo + hi.B_hi into a partial sum that is added
to the running fp32 sum every 32-deep stage.  The tensor core adds each
8-deep product to its accumulator and rounds toward zero, which biases a
long chain; the partial sums keep each chain 12 adds long.  The model below
does that arithmetic in torch on the CPU (each wgmma's sum formed in
float64, then truncated to fp32); it lands within K11's 1e-5 of
``fused_mlp_plain`` and of JAX ``mlp_xla``, where a one-pass TF32 product
and a single accumulator over all of K do not.  The wrapper's choice
between the fused form (the hidden on chip, C 64 / 96 / 128) and the two
launches is a pure function, tested at every width.

K8's backward (csrc/bilinear_gather.cu) adds each lane's channel vector to a
corner of dX with one vector reduction and skips corners of weight 0; the
model of that scatter (and of its dfx / dfy / dmask) equals the autograd of
``sample_weighted_plain`` and the Pallas backward in interpret mode at the
DCNv3 (K 9), MSDeformAttn (K 4) and RVSA (K 1) shapes, and
``bwd_reduction_counts`` (a model of the count the kernel issues, which
chip_smoke.py reads on the card) is at least 4x below a per-channel
scatter.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from samrs_tpu.kernels.bilinear_gather import sample_weighted as jax_sample_weighted
from samrs_tpu.kernels.fused_mlp import mlp_xla
from samrs_tpu_torch.kernels import _build, bilinear_gather, fused_mlp

K11_RTOL = 1e-5  # chip_smoke.py's K10_K11_RTOL: K11 against its fp32 plain version


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------ K11 ----


def _tf32_rna(a: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to tf32, to nearest with ties away from zero (adding half
    of the dropped field to the sign-magnitude bits carries away from 0)."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(a: torch.Tensor) -> torch.Tensor:
    """fp32 read as tf32 by the tensor core: the low 13 bits dropped."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 -> fp32, rounded toward zero."""
    f = x.to(torch.float32)
    return torch.where(f.double().abs() > x.abs(), torch.nextafter(f, torch.zeros_like(f)), f)


@contextlib.contextmanager
def _one_thread():
    """torch on one intra-op thread: the models below run thousands of small
    ops in series, which under the suite's parallel workers wait on eight
    OpenMP threads each (~100x slower).  The arithmetic is the same: their
    matmuls are 8 deep, and no op splits a sum across threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _split_mm(a, b, stage=32):
    """a (T, K) @ b (N, K)^T as K11 computes it: split operands, three tf32
    products an 8-deep step (one wgmma each), small terms first.  Each
    wgmma adds its 8 products to the accumulator and rounds toward zero, as
    the tensor core does (the sum formed exactly in float64, then
    truncated).  A partial sum per `stage`-deep stage is then added to the
    running sum in fp32 (to nearest); stage=None keeps one accumulator over
    all of K."""
    with _one_thread():
        return _split_mm_serial(a, b, stage)


def _split_mm_serial(a, b, stage):
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    K = a.shape[1]
    stage = stage or K
    acc = None
    for k0 in range(0, K, stage):
        part = torch.zeros(a.shape[0], b.shape[0], dtype=torch.float32)
        for k1 in range(k0, k0 + stage, 8):
            s = slice(k1, k1 + 8)
            for x, y in ((al, bh), (ah, bl), (ah, bh)):
                part = _round_toward_zero(part.double() + x[:, s] @ y[:, s].T)
        acc = part if acc is None else acc + part
    return acc


def _one_pass_mm(a, b):
    return _tf32_rna(a) @ _tf32_rna(b).T


def k11_model(x, w1, b1, w2, b2, mm=_split_mm):
    """K11's forward with the products of `mm`: lin1 + bias, exact GELU in
    fp32, lin2 + bias."""
    return mm(F.gelu(mm(x, w1) + b1), w2) + b2


def _one_accumulator_mm(a, b):
    return _split_mm(a, b, stage=None)


def _k11_inputs(T, C, seed):
    rng = np.random.default_rng(seed)
    M = 4 * C
    x = rng.normal(size=(T, C)).astype(np.float32)
    w1 = (rng.normal(size=(M, C)) * C ** -0.5).astype(np.float32)
    b1 = (rng.normal(size=M) * 0.1).astype(np.float32)
    w2 = (rng.normal(size=(C, M)) * M ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=C) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("C", [64, 96, 128, 256, 512, 768])
def test_k11_split_tf32_model_within_k11_bound(C):
    """At the InternImage-T widths, Swin-T's first (C 96: three 32-deep
    stages of lin1) and vit_b's: the split-TF32 model within
    1e-5 of the fp32 plain version and of JAX's ``mlp_xla``; one-pass TF32
    outside it, so the bound tells the two apart."""
    args = _k11_inputs(24, C, C)
    x, w1, b1, w2, b2 = map(torch.from_numpy, args)
    plain = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2)
    want_jax = np.asarray(mlp_xla(args[0], args[1].T, args[2], args[3].T, args[4], jnp.float32))
    split = k11_model(x, w1, b1, w2, b2)
    one_pass = k11_model(x, w1, b1, w2, b2, mm=_one_pass_mm)
    assert _rel_l2(split, plain) <= K11_RTOL, _rel_l2(split, plain)
    assert _rel_l2(split, want_jax) <= K11_RTOL, _rel_l2(split, want_jax)
    assert _rel_l2(one_pass, plain) > K11_RTOL, _rel_l2(one_pass, plain)


def test_k11_tensor_core_rounding_model():
    """At vit_b's width (K 768 and 3072): with the tensor core's
    round-toward-zero adds, one accumulator over all of K lands outside
    1e-5 of the plain version (the kernel's first version, 2.6e-5 on the
    card); a partial sum per 32-deep stage lands within it."""
    x, w1, b1, w2, b2 = map(torch.from_numpy, _k11_inputs(24, 768, 768))
    plain = fused_mlp.fused_mlp_plain(x, w1, b1, w2, b2)
    staged = k11_model(x, w1, b1, w2, b2)
    single = k11_model(x, w1, b1, w2, b2, mm=_one_accumulator_mm)
    assert _rel_l2(staged, plain) <= K11_RTOL, _rel_l2(staged, plain)
    assert _rel_l2(single, plain) > K11_RTOL, _rel_l2(single, plain)


def test_round_toward_zero():
    x = torch.tensor([1.0 + 2.0 ** -30, -(1.0 + 2.0 ** -30), 1.0 - 2.0 ** -40, 3.0, 0.0],
                     dtype=torch.float64)
    assert _round_toward_zero(x).tolist() == [1.0, -1.0, 1.0 - 2.0 ** -24, 3.0, 0.0]


@pytest.mark.parametrize("C,on_chip", [(64, True), (96, True), (128, True), (192, False),
                                       (256, False), (512, False), (768, False), (1024, False),
                                       (1280, False)])
def test_k11_form_choice(C, on_chip):
    """The fused form (the hidden in registers) at C 64 / 96 / 128, the two
    launches with the hidden in device memory from C 192 (Swin-T's second
    stage)."""
    assert fused_mlp.hidden_on_chip(C) is on_chip


@pytest.mark.parametrize("C", [64, 96, 768])
def test_k11_wrapper_passes_the_form(monkeypatch, C):
    """The wrapper asks the C entry for the form ``hidden_on_chip`` picks,
    with a hidden scratch only for the two launches; forcing the fused form
    at C 768 is refused before any launch."""
    calls = []
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "ptr", lambda t: None if t is None else tuple(t.shape))
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))
    monkeypatch.setattr(fused_mlp, "_tf32_halves", lambda w: (w, w))
    T, M = 8, 4 * C
    x, w1, b1 = torch.zeros(T, C), torch.zeros(M, C), torch.zeros(M)
    w2, b2 = torch.zeros(C, M), torch.zeros(C)
    fused_mlp.fused_mlp_cuda(x, w1, b1, w2, b2)
    name, args = calls[-1]
    on_chip = C <= 128
    assert name == "samrs_fused_mlp" and args[-4:] == (T, C, M, int(on_chip))
    assert args[7] == (None if on_chip else (T, M))
    if not on_chip:
        with pytest.raises(ValueError, match="fused form"):
            fused_mlp.fused_mlp_cuda(x, w1, b1, w2, b2, on_chip=True)
        assert len(calls) == 1


def test_tf32_split_plain_matches_model():
    w = torch.from_numpy(np.random.default_rng(5).normal(size=(64, 32)).astype(np.float32))
    hi, lo = fused_mlp.tf32_split_plain(w)
    assert torch.equal(hi, _tf32_rna(w)) and torch.equal(hi + lo, w)


def test_tf32_rounding_model():
    """hi keeps 10 mantissa bits rounded to nearest, ties away from zero; hi +
    lo is the value exactly; the tensor core's view of lo drops 13 bits."""
    one = 1.0
    ulp = 2.0 ** -10
    a = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4, one + 3 * ulp / 4, 3.0,
                      -1e-30], dtype=torch.float32)
    hi = _tf32_rna(a)
    assert hi.tolist()[:5] == [one + ulp, -(one + ulp), one, one + ulp, 3.0]
    x = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(np.float32))
    h = _tf32_rna(x)
    assert torch.equal(h + (x - h), x)
    assert not (h.view(torch.int32) & 0x1FFF).any()
    assert float(((x - h).abs() / x.abs()).max()) <= 2.0 ** -11
    lo = _tf32_trunc(x - h)
    assert float(((x - h - lo).abs() / x.abs()).max()) <= 2.0 ** -22


def test_k11_cuda_wrapper_checks_shape_before_device():
    """C must be one the kernel instantiates (64 / 96 / 128 on chip, or a
    multiple of 64) and M a multiple of 64 (the kernel's tiles): C 80 and M
    96 are refused; a CPU tensor of a good shape is refused as a CPU
    tensor."""
    with pytest.raises(ValueError, match="K11 takes C in"):
        fused_mlp.fused_mlp_cuda(torch.zeros(4, 80), torch.zeros(320, 80), torch.zeros(320),
                                 torch.zeros(80, 320), torch.zeros(80))
    with pytest.raises(ValueError, match="K11 takes C in"):
        fused_mlp.fused_mlp_cuda(torch.zeros(4, 64), torch.zeros(96, 64), torch.zeros(96),
                                 torch.zeros(64, 96), torch.zeros(64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused_mlp.fused_mlp_cuda(torch.zeros(4, 1024), torch.zeros(4096, 1024),
                                 torch.zeros(4096), torch.zeros(1024, 4096), torch.zeros(1024))


def test_k11_weight_halves_follow_the_version_counter(monkeypatch):
    """The tf32 halves of a weight are split once per version: a second
    forward reuses them, an in-place update (an optimizer step) splits
    again, and a new tensor with equal values gets its own."""
    calls = []

    def fake_launch(name, w, hi, lo, n):  # the split kernel's arithmetic, on the CPU
        assert name == "samrs_tf32_split"
        calls.append(n)
        src = tensors[w]
        h = _tf32_rna(src.reshape(-1))
        tensors[hi].view(-1).copy_(h)
        tensors[lo].view(-1).copy_(src.reshape(-1) - h)

    tensors = {}

    def fake_ptr(t):
        tensors[id(t)] = t
        return id(t)

    monkeypatch.setattr(_build, "launch", fake_launch)
    monkeypatch.setattr(_build, "ptr", fake_ptr)
    w = torch.nn.Parameter(torch.randn(128, 64))
    hi, lo = fused_mlp._tf32_halves(w)
    assert torch.equal(hi + lo, w.detach()) and not (hi.view(torch.int32) & 0x1FFF).any()
    assert fused_mlp._tf32_halves(w)[0] is hi and len(calls) == 1
    with torch.no_grad():
        w.add_(1.0)
    hi2, lo2 = fused_mlp._tf32_halves(w)
    assert len(calls) == 2 and torch.equal(hi2 + lo2, w.detach())
    w_copy = torch.nn.Parameter(w.detach().clone())
    fused_mlp._tf32_halves(w_copy)
    assert len(calls) == 3


# ------------------------------------------------------------- K8 ----


def k8_bwd_model(xg, fx, fy, mask, dout, Gc):
    """K8's backward as the kernel computes it: per tap and corner on the map
    with a nonzero weight, the vector g * w (g = mask * dout) added to that
    corner of dX (index_add_, so each corner's sum is formed in one pass);
    dfx, dfy and dmask from the four corners' values.  xg (BG, H, W*Gc)."""
    BG, H, WGc = xg.shape
    W = WGc // Gc
    _, P, K = fx.shape
    img = xg.float().reshape(BG * H * W, Gc)
    base = (torch.arange(BG) * (H * W))[:, None, None]
    wx, wy, corners = bilinear_gather._corners(fx, fy, H, W)
    ax, ay = 1 - wx, 1 - wy
    r = dout[:, :, None, :].expand(BG, P, K, Gc)
    g = mask[..., None] * r
    dx = torch.zeros(BG * H * W, Gc)
    vals = []
    for (idx, valid), w in zip(corners, (ax * ay, wx * ay, ax * wy, wx * wy)):
        flat = (base + idx).reshape(-1)
        v = img[flat].reshape(BG, P, K, Gc) * valid[..., None]
        vals.append(v)
        keep = (valid & (w != 0) & (mask != 0)).reshape(-1)
        dx.index_add_(0, flat[keep], (g * w[..., None]).reshape(-1, Gc)[keep])
    v00, v01, v10, v11 = vals
    top = v00 * ax[..., None] + v01 * wx[..., None]
    bot = v10 * ax[..., None] + v11 * wx[..., None]
    dmask = (r * (top * ay[..., None] + bot * wy[..., None])).sum(-1)
    dfx = (g * ((v01 - v00) * ay[..., None] + (v11 - v10) * wy[..., None])).sum(-1)
    dfy = (g * (bot - top)).sum(-1)
    return dx.reshape(BG, H, WGc), dfx, dfy, dmask


def _k8_case(kind, seed):
    """(xg, fx, fy, mask, dout, Gc) at a small version of one K8 caller:
    DCNv3 (the 3x3 base grid with offsets, or with none: every tap on a
    pixel), MSDeformAttn (4 taps anywhere, some off the map) or RVSA's
    grid sample (one tap, ones mask), with clamped taps far off the map and
    taps on the last row and column."""
    rng = np.random.default_rng(seed)
    BG, H, W = 3, 7, 9
    if kind.startswith("dcnv3"):
        Gc, K, P = 8, 9, H * W
        bx, by = bilinear_gather._dcnv3_base_grid(H, W, 3, 3, 1, 1, 1, 1, 1, 1)
        off = 0.0 if kind == "dcnv3_zero" else rng.uniform(-1.5, 1.5, (BG, P, K))
        fx = np.broadcast_to(bx + off, (BG, P, K))
        fy = np.broadcast_to(by + off * 0.7, (BG, P, K))
    elif kind == "msda":
        Gc, K, P = 4, 4, 45
        fx = rng.uniform(-1.5, W + 0.5, (BG, P, K))
        fy = rng.uniform(-1.5, H + 0.5, (BG, P, K))
    else:  # rvsa
        Gc, K, P = 12, 1, 50
        fx = rng.uniform(-1.2, W + 0.2, (BG, P, K))
        fy = rng.uniform(-1.2, H + 0.2, (BG, P, K))
    fx, fy = np.array(fx, np.float32), np.array(fy, np.float32)
    fx[0, 0, 0], fy[0, 0, 0] = -40.0, 3.0          # clamped far left
    fx[0, 1, 0], fy[0, 1, 0] = W - 1.0, H - 1.0    # the last pixel exactly
    fx[1, 2, 0], fy[1, 2, 0] = W - 0.25, 2.5       # straddles the last column
    fx[2, 3, 0], fy[2, 3, 0] = 4.0, H + 30.0       # clamped far below
    mask = (np.ones((BG, P, K)) if kind == "rvsa" else rng.uniform(0.1, 1.0, (BG, P, K)))
    mask = mask.astype(np.float32)
    if kind != "rvsa":
        mask[1, 0, 0] = 0.0                          # a tap of weight 0: no reduction
    xg = rng.normal(size=(BG, H, W * Gc)).astype(np.float32)
    dout = rng.normal(size=(BG, P, Gc)).astype(np.float32)
    return xg, fx, fy, mask, dout, Gc


CASES = ["dcnv3", "dcnv3_zero", "msda", "rvsa"]


def bwd_vector_width(Gc: int) -> int:
    """Channels one lane of K8's backward adds to a corner of dX with one
    reduction, by csrc/bilinear_gather.cu's samrs_bilinear_bwd: 4 (16
    bytes) where Gc % 4 == 0, else 1."""
    return 4 if Gc % 4 == 0 else 1


def bwd_reduction_counts(fx, fy, mask, H: int, W: int, Gc: int):
    """(reductions K8's backward issues for these taps, per-channel
    reductions of the same scatter): the kernel adds one channel vector of
    ``bwd_vector_width(Gc)`` values per corner that lies on the map with a
    nonzero weight (mask and bilinear weight both nonzero); a per-channel
    scatter adds each of the Gc channels of every corner on the map."""
    wx, wy, corners = bilinear_gather._corners(fx, fy, H, W)
    factors = [(1 - wx, 1 - wy), (wx, 1 - wy), (1 - wx, wy), (wx, wy)]
    kernel = per_channel = 0
    for (_, valid), (a, b) in zip(corners, factors):
        kernel += int((valid & (a * b != 0) & (mask != 0)).sum())
        per_channel += int(valid.sum())
    return kernel * (Gc // bwd_vector_width(Gc)), per_channel * Gc


@pytest.mark.parametrize("kind", CASES)
def test_k8_bwd_model_equals_plain_autograd(kind):
    xg, fx, fy, mask, dout, Gc = _k8_case(kind, 1)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (xg, fx, fy, mask)]
    out = bilinear_gather.sample_weighted_plain(*leaves, Gc)
    want = torch.autograd.grad(out, leaves, torch.from_numpy(dout))
    got = k8_bwd_model(*map(torch.from_numpy, (xg, fx, fy, mask, dout)), Gc)
    for name, g, w in zip(("dxg", "dfx", "dfy", "dmask"), got, want):
        assert g.shape == w.shape, name
        assert _rel_l2(g, w) <= 1e-6, (name, _rel_l2(g, w))


@pytest.mark.parametrize("kind", CASES)
def test_k8_bwd_model_equals_pallas_interpret(kind):
    xg, fx, fy, mask, dout, Gc = _k8_case(kind, 2)
    f = lambda *a: jax_sample_weighted(*a, Gc, interpret=True)
    _, vjp = jax.vjp(f, *map(jnp.asarray, (xg, fx, fy, mask)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(dout))]
    got = k8_bwd_model(*map(torch.from_numpy, (xg, fx, fy, mask, dout)), Gc)
    for name, g, w in zip(("dxg", "dfx", "dfy", "dmask"), got, want):
        assert _rel_l2(g.numpy(), w) <= 1e-6, (name, _rel_l2(g.numpy(), w))


@pytest.mark.parametrize("Gc,width", [(16, 4), (32, 4), (128, 4), (6, 1), (37, 1)])
def test_k8_bwd_vector_width(Gc, width):
    assert bwd_vector_width(Gc) == width


@pytest.mark.parametrize("kind", CASES)
def test_k8_bwd_reduction_counts(kind):
    """The kernel's reductions: one per channel vector and corner on the map
    of nonzero weight; at least 4x fewer than a per-channel scatter where Gc
    % 4 == 0, 16x fewer where every tap lies on a pixel with a nonzero mask
    (one corner of weight 1, three of weight 0)."""
    xg, fx, fy, mask, dout, Gc = _k8_case(kind, 3)
    H, W = xg.shape[1], xg.shape[2] // Gc
    t = lambda a: torch.from_numpy(a)
    kernel, per_channel = bwd_reduction_counts(t(fx), t(fy), t(mask), H, W, Gc)
    wx, wy, corners = bilinear_gather._corners(t(fx), t(fy), H, W)
    weights = ((1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy)
    nonzero = sum(int((v & (w != 0) & (t(mask) != 0)).sum()) for (_, v), w in zip(corners, weights))
    assert kernel == nonzero * Gc // bwd_vector_width(Gc)
    assert per_channel == sum(int(v.sum()) for _, v in corners) * Gc
    assert per_channel >= 4 * kernel
    if kind == "dcnv3_zero":
        on_map = sum(int(v.sum()) for _, v in corners)
        assert kernel * 4 == nonzero * Gc and nonzero < on_map / 2
