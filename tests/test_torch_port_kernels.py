"""PyTorch port kernels (samrs_tpu_torch.kernels) vs the JAX package, on CPU.

Each kernel module's wrapper takes its plain PyTorch version for a CPU
tensor; here that version is held, in fp32 at atol = rtol = 1e-4, against
both the JAX oracle and the JAX Pallas kernel run in interpret mode.  The
inputs are made with numpy from a seed and handed to both sides; weights go
to the port in torch's (out, in) layout.  The CUDA kernels themselves run
only on the card (chip_smoke.py).
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from samrs_tpu.kernels.flash_attention import attention_qkv_relpos_xla, flash_attention_qkv_relpos
from samrs_tpu.kernels.fused_mlp import fused_ln_mlp_residual, ln_mlp_residual_xla
from samrs_tpu.kernels.fused_window_layer import window_layer_attention, window_layer_xla
from samrs_tpu_torch.kernels import _build, flash_attention, fused_mlp, fused_window_layer

TOL = 1e-4  # fp32 on both sides; only summation order differs


@pytest.fixture(autouse=True)
def _fp32_matmuls():
    """State fp32 for the port's matmuls and convs (TF32 off)."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _k1_case(rng):
    """Window layer with a map that pads (6 % 4 != 0) and a nonzero qkv bias."""
    B, H, W, C, nH, ws = 2, 6, 6, 32, 2, 4
    hd = C // nH
    f = lambda *s, std=1.0: (rng.normal(size=s) * std).astype(np.float32)
    xn, Wqkv, bqkv = f(B, H, W, C), f(C, 3 * C, std=0.2), f(3 * C, std=0.5)
    Wproj, bproj = f(C, C, std=0.2), f(C, std=0.1)
    Rh, Rw = f(ws, ws, hd, std=0.2), f(ws, ws, hd, std=0.2)
    static = (ws, hd ** -0.5, nH)
    jax_args = [jnp.asarray(a) for a in (xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw)]
    oracle = lambda: window_layer_xla(*jax_args, *static, dtype=jnp.float32)
    interp = lambda: window_layer_attention(*jax_args, *static, dtype=jnp.float32,
                                            interpret=True, variant="ijb")
    t = torch.from_numpy
    port = lambda: fused_window_layer.window_layer_attention(
        t(xn), t(Wqkv.T.copy()), t(bqkv), t(Wproj.T.copy()), t(bproj), t(Rh), t(Rw), *static)
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
                                             t(w2.T.copy()), t(b2), 1e-6)
    return oracle, interp, port


CASES = {"K1": _k1_case, "K2": _k2_case, "K3": _k3_case}


@pytest.mark.parametrize("reference", ["oracle", "interpret"])
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_plain_port_matches_jax(kernel, reference):
    oracle, interp, port = CASES[kernel](np.random.default_rng(sorted(CASES).index(kernel)))
    want = np.asarray(oracle() if reference == "oracle" else interp())
    got = port()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_cpu_wrappers_never_build_or_count(monkeypatch):
    """On CPU tensors the wrappers run their plain versions: no build is
    attempted and the launch counters stay 0."""
    def no_build():
        raise AssertionError("a CPU call tried to build the CUDA kernels")

    monkeypatch.setattr(_build, "library", no_build)
    mods = (fused_window_layer, flash_attention, fused_mlp)
    for m in mods:
        monkeypatch.setattr(m, "launches", 0)
    rng = np.random.default_rng(7)
    for case in CASES.values():
        case(rng)[2]()
    assert [m.launches for m in mods] == [0, 0, 0]
    assert _build._lib is None


CUDA_ENTRIES = {  # the kernel launchers, called with a CPU tensor
    "K1": (fused_window_layer,
           lambda x: fused_window_layer.window_layer_cuda(x, *[None] * 6, 4, 1.0, 2)),
    "K2": (flash_attention,
           lambda x: flash_attention.attention_qkv_relpos_cuda(x, None, None, (4, 4), 1.0, 2)),
    "K3": (fused_mlp, lambda x: fused_mlp.ln_mlp_residual_cuda(x, *[None] * 6)),
}


@pytest.mark.parametrize("kernel", sorted(CUDA_ENTRIES))
def test_cuda_entry_points_refuse_cpu_tensors(kernel):
    mod, launch = CUDA_ENTRIES[kernel]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        launch(torch.zeros(16, 64, dtype=torch.bfloat16))
    assert mod.launches == 0


def test_build_raises_clearly_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only refusal")
    with pytest.raises(RuntimeError, match="need a CUDA device"):
        _build.library()
