"""CPU models of two of the port's Hopper kernels, held against the plain
versions and the JAX package, in fp32.

K10 (csrc/plain_attention.cu) is a flash-attention forward on split-TF32
wgmma: each fp32 operand is hi + lo (hi rounded to tf32, to nearest with
ties away from zero; lo read by the tensor core with its low 13 bits
dropped), every 8-deep step adds lo.B_hi + hi.B_lo + hi.B_hi, and each
wgmma's add into its accumulator rounds toward zero.  Each 32-deep part of
Q.K^T and each 64-key tile's P.V go into a fresh partial sum, added to the
fp32 running sums (round to nearest); the online softmax runs over 64-key
tiles.  The model below does that arithmetic with K11's rounding helpers
(tests/test_torch_port_hopper_math.py) and lands within K10's 1e-5 of
``full_attention_plain`` and of JAX ``attention_plain_xla``; one
accumulator over all keys does not.

K8's forward (csrc/bilinear_gather.cu) gives each thread one element of the
flat (query, channel vector) space, V channels wide, found from the element
index by a multiply-high division, and loads a query's taps together; at
odd Gc from 3 up a thread takes four consecutive outputs (flat-4).  The
model of that mapping covers every output element once, its division equals
floor division over the launch's range, and its gather, rounded op by op in
the plain order, equals ``sample_weighted_plain`` bit for bit and the
Pallas forward in interpret mode.  The wrappers check shapes before the
device and count their launches.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from samrs_tpu.kernels.bilinear_gather import sample_weighted as jax_sample_weighted
from samrs_tpu.kernels.flash_attention import attention_plain_xla
from samrs_tpu_torch.kernels import _build, bilinear_gather, flash_attention
from test_torch_port_hopper_math import _round_toward_zero, _split_mm, _tf32_rna, _tf32_trunc

K10_RTOL = 1e-5  # chip_smoke.py's K10_K11_RTOL: K10 against its fp32 plain version
KEY_TILE = 64  # keys a tile of K10's kernel (csrc/plain_attention.cu PA_BK)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ------------------------------------------------------------ K10 ----


def _mm_into(acc, a, b):
    """acc + a @ b^T, continuing acc's tensor-core chain: split operands,
    three tf32 products an 8-deep step, each wgmma's add rounded toward
    zero (one accumulator, no fresh partial sums)."""
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_trunc(a - ah), _tf32_trunc(b - bh)
    ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
    for k1 in range(0, a.shape[1], 8):
        s = slice(k1, k1 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _round_toward_zero(acc.double() + x[:, s] @ y[:, s].T)
    return acc


def k10_model(q, k, v, scale, fresh=True):
    """K10's forward, head by head: q * scale rounded in fp32, then over
    64-key tiles S = Q.K^T (a fresh partial sum per 32-deep part, or with
    `fresh` False one accumulator over all of d), the online softmax in fp32
    (running max, exp, row sum, the output rescaled), and P.V of the tile
    into a fresh partial sum added to the output in fp32 (with `fresh` False
    the rescaled output is the tensor core's accumulator, carried over all
    keys).  Keys past N are absent (the kernel's are -inf, with zero V).
    q (BH, Nq, d), k and v (BH, N, d)."""
    BH, Nq, d = q.shape
    out = torch.empty(BH, Nq, d)
    for b in range(BH):
        qs = q[b] * scale
        m = torch.full((Nq,), float("-inf"))
        l = torch.zeros(Nq)
        o = torch.zeros(Nq, d)
        for k0 in range(0, k.shape[1], KEY_TILE):
            kt, vt = k[b, k0:k0 + KEY_TILE], v[b, k0:k0 + KEY_TILE]
            s = _split_mm(qs, kt, stage=32 if fresh else None)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[:, None])
            l = l * alpha + p.sum(-1)
            m = m_new
            o = o * alpha[:, None]
            vT = vt.T.contiguous()
            o = o + _split_mm(p, vT, stage=KEY_TILE) if fresh else _mm_into(o, p, vT)
        out[b] = o / l[:, None]
    return out


QUERIES = 128  # query rows of the model: one block of the kernel (each row's arithmetic is its own)


def _k10_inputs(N, d, seed):
    """q of QUERIES rows, k and v of N keys (one head)."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(1, n, d)).astype(np.float32) for n in (QUERIES, N, N)]


@pytest.mark.parametrize("N,d", [(196, 64), (1024, 64), (196, 80), (1024, 80)])
def test_k10_split_tf32_model_within_bound(N, d):
    """At the RVSA FAST head's 224^2 (196 keys: a 4-key tail tile) and vit_b
    512^2 (1024), heads of 64 and of 80 (vit_h_rvsa), a block's 128 queries:
    the model within 1e-5 of the plain version and of the JAX oracle."""
    arrays = _k10_inputs(N, d, N + d)
    q, k, v = map(torch.from_numpy, arrays)
    scale = d ** -0.5
    got = k10_model(q, k, v, scale)
    plain = flash_attention.full_attention_plain(q, k, v, scale)
    want_jax = np.asarray(attention_plain_xla(*map(jnp.asarray, arrays), scale))
    assert _rel_l2(got, plain) <= K10_RTOL, _rel_l2(got, plain)
    assert _rel_l2(got, want_jax) <= K10_RTOL, _rel_l2(got, want_jax)


def test_k10_tensor_core_rounding_model():
    """At iSAID's finetune grid (896^2: N 3136 keys; a block's 128 queries),
    one accumulator over all keys (the tensor core's round-toward-zero adds,
    24 a key tile, carried over 49 tiles) lands outside 1e-5 of the plain
    version; fresh partial sums per 32-deep part and per key tile land
    within it."""
    q, k, v = map(torch.from_numpy, _k10_inputs(3136, 64, 7))
    plain = flash_attention.full_attention_plain(q, k, v, 0.125)
    fresh = k10_model(q, k, v, 0.125)
    single = k10_model(q, k, v, 0.125, fresh=False)
    assert _rel_l2(fresh, plain) <= K10_RTOL, _rel_l2(fresh, plain)
    assert _rel_l2(single, plain) > K10_RTOL, _rel_l2(single, plain)


def _fake_build(monkeypatch, calls):
    monkeypatch.setattr(_build, "require_cuda", lambda *a, **k: None)
    monkeypatch.setattr(_build, "ptr", lambda t: None if t is None else tuple(t.shape))
    monkeypatch.setattr(_build, "launch", lambda name, *args: calls.append((name, args)))


def test_k10_wrapper_checks_shapes_before_the_device():
    t = torch.zeros(2, 8, 72)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention.full_attention_cuda(t, t, t, 0.125)
    t = torch.zeros(2, 8)
    with pytest.raises(ValueError, match=r"\(BH, N, d\)"):
        flash_attention.full_attention_cuda(t, t, t, 0.125)
    t = torch.zeros(65536, 1, 64)
    with pytest.raises(ValueError, match="65535"):
        flash_attention.full_attention_cuda(t, t, t, 0.125)
    t = torch.zeros(2, 8, 64)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention.full_attention_cuda(t, t, t, 0.125)


class _ScratchQuery:
    """The library's ``samrs_plain_attention_scratch_bytes``, recorded."""

    def __init__(self):
        self.asked = []

    def samrs_plain_attention_scratch_bytes(self, BH, N, d):
        self.asked.append((BH, N, d))
        return 1000 + BH + N + d


def test_k10_wrapper_launch_and_count(monkeypatch):
    """One launch of the C entry a call (the pre-pass and the kernel), with
    a scratch of the size the C side gives for (BH, N, d);
    ``full_launches`` moves by one."""
    calls, lib = [], _ScratchQuery()
    _fake_build(monkeypatch, calls)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(flash_attention, "full_launches", 0)
    q = torch.zeros(3, 70, 80)
    out = flash_attention.full_attention_cuda(q, q, q, 0.25)
    assert out.shape == q.shape and flash_attention.full_launches == 1
    assert lib.asked == [(3, 70, 80)]
    (name, args), = calls
    assert name == "samrs_plain_attention"
    assert args[3] == (1153,) and args[4] == 1153
    assert args[6:] == (3, 70, 80, 0.25)


# ------------------------------------------------------- K8 forward ----


def fwd_vector_width(Gc):
    """Channels a vector (csrc/bilinear_gather.cu ``samrs_bilinear_fwd``)."""
    return 4 if Gc % 4 == 0 else 2 if Gc % 2 == 0 else 1


def fwd_form(Gc):
    """The kernel's form (``launch_fwd``): flat-4 at odd Gc from 3 up, else
    one channel vector a thread (at Gc 1 one output)."""
    return "flat4" if fwd_vector_width(Gc) == 1 and Gc >= 3 else "vector"


def make_fastdiv(d):
    """(mul, shift) of the kernel's ``make_fastdiv``."""
    shift = 0
    while (1 << shift) < d:
        shift += 1
    return ((1 << 32) * ((1 << shift) - d)) // d + 1, shift


def fast_div(n, f):
    """The kernel's ``fast_div`` on uint64 numpy arrays: (umulhi(n, mul) + n) >> shift."""
    mul, shift = f
    n = np.asarray(n, np.uint64)
    return ((n * np.uint64(mul)) >> np.uint64(32)) + n >> np.uint64(shift)


def fwd_lane_map(BG, P, Gc):
    """Per thread of the launch: the query and channel of each output it
    writes and whether it writes it, each (threads, outputs a thread)."""
    outs = BG * P * Gc
    if fwd_form(Gc) == "flat4":  # outputs 4e .. 4e + 3, in one or two queries
        f0 = 4 * np.arange(-(-outs // 4), dtype=np.uint64)
        qa = fast_div(f0, make_fastdiv(Gc)).astype(np.int64)
        c = (f0.astype(np.int64) - qa * Gc)[:, None] + np.arange(4)
        q = qa[:, None] + (c >= Gc)
        return q, c - Gc * (c >= Gc), f0.astype(np.int64)[:, None] + np.arange(4) < outs
    V = fwd_vector_width(Gc)
    n = Gc // V
    e = np.arange(BG * P * n, dtype=np.uint64)
    q = fast_div(e, make_fastdiv(n))
    cv = (e - q * np.uint64(n)).astype(np.int64)
    q = np.repeat(q.astype(np.int64)[:, None], V, 1)
    return q, cv[:, None] * V + np.arange(V), np.ones(q.shape, bool)


def k8_fwd_model(xg, fx, fy, mask, Gc):
    """K8's forward as its threads compute it: each output a thread writes
    (``fwd_lane_map``), over the taps in order, rounded op by op in the plain
    order (corners 00, 01, 10, 11, then the weighted tap added to a sum that
    starts at 0), in numpy fp32."""
    BG, H, WGc = xg.shape
    W = WGc // Gc
    _, P, K = fx.shape
    q, c, ok_out = (a.ravel() for a in fwd_lane_map(BG, P, Gc))
    q, c = q[ok_out], c[ok_out]
    bg = q // P
    img = xg.reshape(BG, H * W, Gc)
    fxf, fyf, mf = (a.reshape(BG * P, K) for a in (fx, fy, mask))
    acc = np.zeros(q.shape, np.float32)
    for k in range(K):
        x, y = fxf[q, k], fyf[q, k]
        x0, y0 = np.floor(x), np.floor(y)
        wx, wy = x - x0, y - y0
        x0 = np.clip(x0, -2, W).astype(np.int64)
        y0 = np.clip(y0, -2, H).astype(np.int64)
        s = None
        for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                          (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
            xi, yi = x0 + dx, y0 + dy
            ok = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            pix = np.clip(yi, 0, H - 1) * W + np.clip(xi, 0, W - 1)
            val = np.where(ok, img[bg, pix, c], np.float32(0))
            term = val * np.where(ok, w, np.float32(0)).astype(np.float32)
            s = term if s is None else s + term
        acc = acc + mf[q, k] * s
    out = np.zeros((BG * P, Gc), np.float32)
    out[q, c] = acc
    return out.reshape(BG, P, Gc)


def _fwd_inputs(Gc, K, seed, BG=2, H=5, W=6, P=23):
    rng = np.random.default_rng(seed)
    xg = rng.normal(size=(BG, H, W * Gc)).astype(np.float32)
    fx = rng.uniform(-2.5, W + 1.5, (BG, P, K)).astype(np.float32)
    fy = rng.uniform(-2.5, H + 1.5, (BG, P, K)).astype(np.float32)
    fx[:, ::5] = np.round(fx[:, ::5])  # some taps on exact pixels (three corners of weight 0)
    mask = rng.uniform(0.2, 1.0, (BG, P, K)).astype(np.float32)
    return xg, fx, fy, mask


GCS = (1, 16, 32, 37, 64, 100, 128)


@pytest.mark.parametrize("K", [1, 4, 9])
@pytest.mark.parametrize("Gc", GCS)
def test_k8_fwd_lane_map_covers_each_output_once(Gc, K):
    """Every (query, channel) of the (BG, P, Gc) output is written by exactly
    one thread, through the multiply-high division; neighbouring lanes write
    neighbouring outputs; every query's K taps are read, none past the end."""
    BG, P = 3, 1029
    q, c, ok = fwd_lane_map(BG, P, Gc)
    flat = (q * Gc + c)[ok]
    hits = np.bincount(flat, minlength=BG * P * Gc)
    assert hits.shape == (BG * P * Gc,) and np.all(hits == 1)
    assert np.array_equal(flat, np.arange(BG * P * Gc))  # thread-major order: coalesced
    assert np.all((c >= 0) & (c < Gc))
    taps = (q[ok][:, None] * K + np.arange(K)).ravel()
    assert np.array_equal(np.unique(taps), np.arange(BG * P * K))


@pytest.mark.parametrize("n", [1, 2, 3, 25, 37, 196, 1029, 12544, (1 << 31) - 1])
def test_k8_fwd_fast_div_in_range(n):
    """The division is exact for every dividend below 2^31 (checked at the
    edges of each quotient and at random)."""
    f = make_fastdiv(n)
    rng = np.random.default_rng(n)
    x = np.concatenate([rng.integers(0, 1 << 31, 4096), [0, n - 1, n, n + 1, (1 << 31) - 1],
                        (np.arange(1, 64) * n - 1), np.arange(1, 64) * n])
    x = x[(x >= 0) & (x < 1 << 31)].astype(np.uint64)
    assert np.array_equal(fast_div(x, f), x // np.uint64(n))


@pytest.mark.parametrize("K", [1, 4, 9])
@pytest.mark.parametrize("Gc", GCS)
def test_k8_fwd_model_equals_plain_bits(Gc, K):
    xg, fx, fy, mask = _fwd_inputs(Gc, K, Gc * 10 + K)
    got = k8_fwd_model(xg, fx, fy, mask, Gc)
    want = bilinear_gather.sample_weighted_plain(*map(torch.from_numpy, (xg, fx, fy, mask)),
                                                 Gc).numpy()
    assert np.array_equal(got, want), np.abs(got - want).max()


@pytest.mark.parametrize("Gc,K", [(37, 1), (100, 1), (32, 4), (16, 9)])
def test_k8_fwd_model_equals_pallas_interpret(Gc, K):
    """At the shared samples' Gc (37, 100; one tap), MSDeformAttn's (32, 4
    points) and DCNv3's (16, 9 taps): the Pallas forward's hat matmuls round
    elsewhere, so rel-L2 1e-6."""
    xg, fx, fy, mask = _fwd_inputs(Gc, K, Gc + K)
    got = k8_fwd_model(xg, fx, fy, mask, Gc)
    want = np.asarray(jax_sample_weighted(*map(jnp.asarray, (xg, fx, fy, mask)), Gc,
                                          interpret=True))
    assert _rel_l2(got, want) <= 1e-6, _rel_l2(got, want)


def test_k8_fwd_wrapper_checks_shapes_before_the_device():
    xg = torch.zeros(2, 5, 6 * 16)
    fx = torch.zeros(3, 7, 9)
    with pytest.raises(ValueError, match="fx: expected"):
        bilinear_gather.sample_weighted_fwd_cuda(xg, fx, fx, fx, 16)
    with pytest.raises(ValueError, match="xg: expected"):
        bilinear_gather.sample_weighted_fwd_cuda(xg, fx[:2], fx[:2], fx[:2], 7)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bilinear_gather.sample_weighted_fwd_cuda(xg, fx[:2], fx[:2], fx[:2], 16)


def test_k8_fwd_wrapper_launch_count_and_alignment(monkeypatch):
    """One launch with the map's (BG, H, W, P, K, Gc) a call, counted; an
    address off 16 bytes is refused by the launcher and copied by
    ``sample_weighted``."""
    calls = []
    _fake_build(monkeypatch, calls)
    monkeypatch.setattr(bilinear_gather, "fwd_launches", 0)
    xg, fx = torch.zeros(2, 5, 6 * 37), torch.zeros(2, 11, 4)
    out = bilinear_gather.sample_weighted_fwd_cuda(xg, fx, fx, fx, 37)
    assert out.shape == (2, 11, 37) and bilinear_gather.fwd_launches == 1
    (name, args), = calls
    assert name == "samrs_bilinear_fwd" and args[5:] == (2, 5, 6, 11, 4, 37, 0)
    shifted = torch.zeros(2 * 11 * 4 + 1)[1:].reshape(2, 11, 4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bilinear_gather.sample_weighted_fwd_cuda(xg, shifted, fx, fx, 37)
    assert bilinear_gather.fwd_launches == 1
    copied = bilinear_gather._aligned(shifted)
    assert copied.data_ptr() % 16 == 0 and torch.equal(copied, shifted)
    assert bilinear_gather._aligned(fx) is fx
