"""PyTorch port kernels (samrs_tpu_torch.kernels) vs the JAX package, on CPU.

Each kernel module's wrapper takes its plain PyTorch version for a CPU
tensor; here that version is held, in fp32 at atol = rtol = 1e-4, against
both the JAX oracle and the JAX Pallas kernel run in interpret mode (K7's
counts, boxes and bits must be equal to the interpreted kernel's).  The
inputs are made with numpy from a seed and handed to both sides; weights go
to the port in torch's layouts ((out, in) for linears, (in, out, kh, kw) for
transposed convolutions).  The CUDA kernels themselves run only on the card
(chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from samrs_tpu.kernels.amg_post import amg_postprocess as jax_amg_postprocess
from samrs_tpu.kernels.flash_attention import attention_qkv_relpos_xla, flash_attention_qkv_relpos
from samrs_tpu.kernels.fused_mlp import fused_ln_mlp_residual, ln_mlp_residual_xla
from samrs_tpu.kernels.fused_twoway import i2t_update, i2t_update_xla, t2i_kv_proj, t2i_kv_proj_xla
from samrs_tpu.kernels.fused_upscale import fused_upscale_hyper, upscale_hyper_xla
from samrs_tpu.kernels.fused_window_layer import (window_layer_attention,
                                                 window_layer_attention_residual, window_layer_xla)
from samrs_tpu_torch.kernels import (_build, amg_post, flash_attention, fused_mlp, fused_twoway,
                                     fused_upscale, fused_window_layer, gemm)

TOL = 1e-4  # fp32 on both sides; only summation order differs


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    """State fp32 for the port's matmuls and convs (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _k1_case(rng, residual=False):
    """Window layer with a map that pads (6 % 4 != 0) and a nonzero qkv bias;
    residual=True adds the residual stream in the projection, as the JAX
    package's ``window_layer_attention_residual`` does."""
    B, H, W, C, nH, ws = 2, 6, 6, 32, 2, 4
    hd = C // nH
    f = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)
    xn, Wqkv, bqkv = f(B, H, W, C), f(C, 3 * C, std=0.2), f(3 * C, std=0.5)
    Wproj, bproj = f(C, C, std=0.2), f(C, std=0.1)
    Rh, Rw = f(ws, ws, hd, std=0.2), f(ws, ws, hd, std=0.2)
    sc = f(B, H, W, C)
    static = (ws, hd ** -0.5, nH)
    jax_args = [jnp.asarray(a) for a in (xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw)]
    t = torch.from_numpy
    port_args = (t(xn), t(Wqkv.T.copy()), t(bqkv), t(Wproj.T.copy()), t(bproj), t(Rh), t(Rw))
    if residual:
        oracle = lambda: jnp.asarray(sc) + window_layer_xla(*jax_args, *static, dtype=jnp.float32)
        interp = lambda: window_layer_attention_residual(jnp.asarray(sc), *jax_args, *static,
                                                         dtype=jnp.float32, interpret=True)
        port = lambda: fused_window_layer.window_layer_attention(*port_args, *static,
                                                                 residual=t(sc))
        return oracle, interp, port
    oracle = lambda: window_layer_xla(*jax_args, *static, dtype=jnp.float32)
    interp = lambda: window_layer_attention(*jax_args, *static, dtype=jnp.float32,
                                            interpret=True, variant="ijb")
    port = lambda: fused_window_layer.window_layer_attention(*port_args, *static)
    return oracle, interp, port


def _k2_case(rng):
    """Global attention at N = 256 (the Pallas kernel's query tile is 128)."""
    B, H, W, C, nH = 1, 16, 16, 32, 2
    hd = C // nH
    qkv = rng.normal(size=(B, H * W, 3 * C)).astype(np.float32)
    Rh = (rng.normal(size=(H, H, hd)) * 0.2).astype(np.float32)
    Rw = (rng.normal(size=(W, W, hd)) * 0.2).astype(np.float32)
    static = ((H, W), hd ** -0.5, nH)
    jax_args = [jnp.asarray(a) for a in (qkv, Rh, Rw)]
    oracle = lambda: attention_qkv_relpos_xla(*jax_args, *static)
    interp = lambda: flash_attention_qkv_relpos(*jax_args, *static, interpret=True, variant="m")
    t = torch.from_numpy
    port = lambda: flash_attention.attention_qkv_relpos(t(qkv), t(Rh), t(Rw), *static)
    return oracle, interp, port


def _k3_case(rng):
    """LayerNorm + MLP + residual on 256 tokens."""
    T, C, M = 256, 32, 128
    f = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)
    x, g, b = f(T, C), 1.0 + f(C, std=0.1), f(C, std=0.1)
    w1, b1, w2, b2 = f(C, M, std=0.2), f(M, std=0.1), f(M, C, std=0.1), f(C, std=0.1)
    jax_args = [jnp.asarray(a) for a in (x, g, b, w1, b1, w2, b2)]
    oracle = lambda: ln_mlp_residual_xla(*jax_args, jnp.float32, eps=1e-6)
    interp = lambda: fused_ln_mlp_residual(*jax_args, dtype=jnp.float32, eps=1e-6, interpret=True)
    t = torch.from_numpy
    port = lambda: fused_mlp.ln_mlp_residual(t(x), t(g), t(b), t(w1.T.copy()), t(b1),
                                             t(w2.T.copy()), t(b2), 1e-6, dtype=torch.float32)
    return oracle, interp, port


B, N, C, CI, NH = 2, 256, 64, 32, 4  # decoder cases: 2 prompts, a 16x16 image side


def _k4_case(rng):
    """t2i K/V projection of the image side."""
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    keys, pe, Wk, bk, Wv, bv = f(B, N, C), f(N, C), f(C, CI), f(CI), f(C, CI), f(CI)
    jax_args = [jnp.asarray(a) for a in (keys, pe, Wk, bk, Wv, bv)]
    oracle = lambda: t2i_kv_proj_xla(*jax_args, jnp.float32)
    interp = lambda: t2i_kv_proj(*jax_args, dtype=jnp.float32, interpret=True)
    t = torch.from_numpy
    port = lambda: fused_twoway.t2i_kv_proj(t(keys), t(pe), t(Wk.T.copy()), t(bk),
                                            t(Wv.T.copy()), t(bv), dtype=torch.float32)
    return oracle, interp, port


def _k5_case(rng, shared, nt=7, slots=16):
    """i2t update with `nt` of `slots` token slots live (a box decode fills 7
    of 16); shared=True hands batch-1 keys to a 2-prompt token batch (layer 0
    of a box decode)."""
    f = lambda *s: (rng.normal(size=s) * 0.5).astype(np.float32)
    keys = f(1 if shared else B, N, C)
    tok_k = np.pad(f(B, nt, CI), ((0, 0), (0, slots - nt), (0, 0)))
    tok_v = np.pad(f(B, nt, CI), ((0, 0), (0, slots - nt), (0, 0)))
    mask_bias = np.where(np.arange(slots) < nt, 0.0, -1e9).astype(np.float32)
    Wq, bq, Wo, bo = f(C, CI), f(CI), f(CI, C), f(C)
    g4, b4 = (1.0 + 0.2 * f(C)).astype(np.float32), f(C)
    Wk, bk, Wv, bv = f(C, CI), f(CI), f(C, CI), f(CI)
    args = (keys, f(N, C), tok_k, tok_v, mask_bias, Wq, bq, Wo, bo, g4, b4, Wk, bk, Wv, bv)
    jax_args = [jnp.asarray(a) for a in args]
    oracle = lambda: i2t_update_xla(*jax_args, NH, jnp.float32)
    interp = lambda: i2t_update(*jax_args, NH, dtype=jnp.float32, interpret=True)
    t = lambda a: torch.from_numpy(a.T.copy() if a.ndim == 2 and a.shape in ((C, CI), (CI, C))
                                   else a)
    port = lambda: fused_twoway.i2t_update(*[t(a) for a in args], NH, dtype=torch.float32)
    return oracle, interp, port


def _k6_case(rng, M):
    """Upscaling tail + hypernetwork dot for M requested tokens; the port
    takes the transposed-convolution weights in torch's layout, which the
    weight bridge gives it (flax kernel flipped, (in, out, kh, kw))."""
    Bu, h, w, Cu, C1, C2 = 2, 8, 8, 32, 8, 4
    f = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)
    src, k1, b1 = f(Bu, h, w, Cu), f(2, 2, Cu, C1, std=0.2), f(C1, std=0.1)
    lns, lnb = (1.0 + f(C1, std=0.1)).astype(np.float32), f(C1, std=0.1)
    k2, b2, hyper = f(2, 2, C1, C2, std=0.3), f(C2, std=0.1), f(Bu, M, C2)
    jax_args = [jnp.asarray(a) for a in (src, k1, b1, lns, lnb, k2, b2, hyper)]
    oracle = lambda: upscale_hyper_xla(*jax_args, jnp.float32)
    interp = lambda: fused_upscale_hyper(*jax_args, dtype=jnp.float32, interpret=True)
    t = torch.from_numpy
    to_torch = lambda k: t(np.ascontiguousarray(k[::-1, ::-1].transpose(2, 3, 0, 1)))
    port = lambda: fused_upscale.upscale_hyper(t(src), to_torch(k1), t(b1), t(lns), t(lnb),
                                               to_torch(k2), t(b2), t(hyper), dtype=torch.float32)
    return oracle, interp, port


CASES = {"K1": _k1_case, "K1-residual": lambda rng: _k1_case(rng, residual=True),
         "K2": _k2_case, "K3": _k3_case, "K4": _k4_case,
         "K5-per-prompt": lambda rng: _k5_case(rng, shared=False),
         "K5-shared": lambda rng: _k5_case(rng, shared=True),
         "K5-32-slots": lambda rng: _k5_case(rng, shared=True, nt=21, slots=32),
         "K6-M1": lambda rng: _k6_case(rng, 1), "K6-M3": lambda rng: _k6_case(rng, 3)}


@pytest.mark.parametrize("reference", ["oracle", "interpret"])
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_plain_port_matches_jax(kernel, reference):
    oracle, interp, port = CASES[kernel](np.random.default_rng(sorted(CASES).index(kernel)))
    want = oracle() if reference == "oracle" else interp()
    got = port()
    wants = want if isinstance(want, (tuple, list)) else (want,)
    gots = got if isinstance(got, tuple) else (got,)
    assert len(gots) == len(wants)
    for g, w in zip(gots, wants):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


def test_online_softmax_follows_the_kernel_loop():
    """The plain attention's probabilities: equal to a key-tile by key-tile
    run of the kernels' online softmax (csrc/warp_attention.cuh: running max,
    P rounded to bf16, row sums of the rounded values, rescaled), and in fp32
    to the exact softmax."""
    rng = np.random.default_rng(12)
    s = torch.from_numpy((rng.normal(size=(3, 150)) * 3).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(150, 8)).astype(np.float32)).bfloat16().float()
    m = torch.full((3, 1), float("-inf"))
    den, o = torch.zeros(3, 1), torch.zeros(3, 8)
    for k0 in range(0, 150, 64):
        tile = s[:, k0:k0 + 64]
        m_new = torch.maximum(m, tile.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(tile - m_new).bfloat16().float()
        den, o, m = den * alpha + p.sum(-1, keepdim=True), o * alpha + p @ v[k0:k0 + 64], m_new
    got = flash_attention.online_softmax_v(s, v, torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), (o / den).numpy(), rtol=1e-5, atol=1e-6)
    exact = flash_attention.online_softmax_v(s, v, torch.float32)
    np.testing.assert_allclose(exact.numpy(), (s.softmax(-1) @ v).numpy(), rtol=1e-5, atol=1e-6)


def test_linear_plain_rounds_once():
    """The GEMM's plain version rounds once, after bias, GELU and residual in
    fp32, as the kernel's epilogue does."""
    rng = np.random.default_rng(13)
    f = lambda *sh: torch.from_numpy(rng.normal(size=sh).astype(np.float32))
    x, w, b, r = f(5, 64).bfloat16(), f(16, 64), f(16), f(5, 16).bfloat16()
    want = torch.nn.functional.gelu(x.double() @ w.bfloat16().double().T + b.double())
    want = (want + r.double()).bfloat16()
    got = gemm.linear_plain(x, w, b, gelu=True, residual=r)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want.float().numpy())


K7_CASES = {  # the shape cases of tests/test_amg_post.py: (g, img_size, input, original)
    "square": (16, 64, (64, 64), (64, 64)),
    "resized": (16, 64, (48, 64), (37, 50)),
    "upscaled": (32, 128, (128, 96), (200, 150)),
}


def _k7_inputs(case):
    if case == "empty-full":
        low = np.stack([np.full((16, 16), -5.0), np.full((16, 16), 5.0)]).astype(np.float32)
        return low, 64, (64, 64), (60, 61)
    g, img_size, inp, orig = K7_CASES[case]
    return (np.random.default_rng(0).standard_normal((5, g, g)) * 2.0).astype(np.float32), \
        img_size, inp, orig


@pytest.mark.parametrize("case", sorted(K7_CASES) + ["empty-full"])
def test_amg_post_plain_equals_interpret(case):
    """K7's plain version: hi, lo, boxes and packed bits equal to the JAX
    Pallas kernel run in interpret mode."""
    low, img_size, inp, orig = _k7_inputs(case)
    want = jax_amg_postprocess(jnp.asarray(low), inp, orig, img_size, 0.0, 1.0, interpret=True)
    got = amg_post.amg_postprocess(torch.from_numpy(low), inp, orig, img_size, 0.0, 1.0)
    hi, lo, boxes, packed = got
    assert hi.dtype == lo.dtype == boxes.dtype == torch.int32 and packed.dtype == torch.uint8
    np.testing.assert_array_equal(hi.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(boxes.numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want[3]).astype(np.uint8))


@pytest.mark.parametrize("case", sorted(K7_CASES))
def test_amg_post_band_matches_composed_matrix(case):
    """The (start, 4 weights) bands the CUDA kernel reads rebuild the
    composed resample matrices exactly."""
    g, img_size, inp, orig = K7_CASES[case]
    for n_in, n_out in zip(inp, orig):
        dense = amg_post._composed_axis(g, img_size, n_in, n_out)
        start, w = amg_post._band(g, img_size, n_in, n_out)
        rebuilt = np.zeros_like(dense)
        np.put_along_axis(rebuilt, start[:, None] + np.arange(amg_post.TAPS), w, 1)
        np.testing.assert_array_equal(rebuilt, dense)


def test_cpu_wrappers_never_build_or_count(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: no build is
    attempted and the launch counters stay 0."""
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_build)
    for mod, name in COUNTERS.values():
        monkeypatch.setattr(mod, name, 0)
    rng = np.random.default_rng(7)
    for case in CASES.values():
        case(rng)[2]()
    for case in K7_CASES:
        low, img_size, inp, orig = _k7_inputs(case)
        amg_post.amg_postprocess(torch.from_numpy(low), inp, orig, img_size, 0.0, 1.0)
    assert {k: getattr(mod, name) for k, (mod, name) in COUNTERS.items()} == dict.fromkeys(COUNTERS, 0)
    assert _build._lib is None


COUNTERS = {  # kernel -> (module, launch counter)
    "K1": (fused_window_layer, "launches"), "K2": (flash_attention, "launches"),
    "K3": (fused_mlp, "launches"), "K4": (fused_twoway, "kv_launches"),
    "K5": (fused_twoway, "i2t_launches"), "K6": (fused_upscale, "launches"),
    "K7": (amg_post, "launches"),
}

CUDA_ENTRIES = {  # the kernel launchers, called with a CPU tensor
    "K1": lambda x: fused_window_layer.window_layer_cuda(x, *[None] * 6, 4, 1.0, 2),
    "K2": lambda x: flash_attention.attention_qkv_relpos_cuda(x, None, None, (4, 4), 1.0, 2),
    "K3": lambda x: fused_mlp.ln_mlp_residual_cuda(x, *[None] * 6),
    "K4": lambda x: fused_twoway.t2i_kv_proj_cuda(x.float(), *[None] * 5),
    "K5": lambda x: fused_twoway.i2t_update_cuda(x.float(), *[None] * 14, 8),
    "K6": lambda x: fused_upscale.upscale_hyper_cuda(x, *[None] * 7),
    "K7": lambda x: amg_post.amg_postprocess_cuda(x.float(), (64, 64), (64, 64), 64, 0.0, 1.0),
}


@pytest.mark.parametrize("kernel", sorted(CUDA_ENTRIES))
def test_cuda_entry_points_refuse_cpu_tensors(kernel):
    mod, name = COUNTERS[kernel]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        CUDA_ENTRIES[kernel](torch.zeros(16, 64, dtype=torch.bfloat16))
    assert getattr(mod, name) == 0


def test_build_raises_clearly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        _build.library()
