"""K3: the encoder's MLP sublayer, ``x + lin2(gelu(lin1(LN(x))))``.

Replaces samrs_tpu/kernels/fused_mlp.py::fused_ln_mlp_residual (Pallas call
``_ln_fused_pallas``).  On a CUDA tensor the wrapper launches three
hand-written kernels from csrc/gemm.cu: the fp32-statistics LayerNorm, the
lin1 GEMM with a bias + exact-erf GELU epilogue, and the lin2 GEMM with a
bias + residual epilogue that writes the encoder's fp32 residual stream (the
matmul operands are bf16).  Bound on the H100: tensor-core flops
(4*T*C*M); the hidden activation (T x M bf16) still makes one round trip
through device memory.  On a CPU tensor it runs the plain version.

Weights use torch's ``nn.Linear`` layout: w1 (M, C), w2 (C, M).
"""

from __future__ import annotations

import torch

from samrs_tpu_torch.kernels import _build, gemm

launches = 0  # CUDA launches of this kernel (one per wrapper call)


def ln_mlp_residual_plain(x, g_ln, b_ln, w1, b1, w2, b2, eps: float = 1e-6,
                          dtype=torch.float32):
    """Plain PyTorch version, following the JAX oracle ``ln_mlp_residual_xla``:
    fp32 LayerNorm statistics (var = E[x^2] - E[x]^2), normed map cast to
    `dtype`, Dense -> exact GELU -> Dense, residual; the output has x's
    dtype.  Each Dense rounds once, after its GELU or residual, as the kernel
    does."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mu * mu
    xn = (xf - mu) * torch.rsqrt(var + eps) * g_ln.float() + b_ln.float()
    h = gemm.linear_plain(xn.to(dtype), w1, b1, gelu=True)
    return gemm.linear_plain(h, w2, b2, residual=x)


def ln_mlp_residual_cuda(x, g_ln, b_ln, w1, b1, w2, b2, eps: float = 1e-6):
    """The hand-written kernels on the fp32 CUDA residual stream ``x (T, C)``,
    with bf16 products -> fp32."""
    global launches
    _build.require_cuda("x", x, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x: expected (T, C), got {tuple(x.shape)}")
    C = x.shape[1]
    M = w1.shape[0]
    if tuple(w1.shape) != (M, C) or tuple(w2.shape) != (C, M):
        raise ValueError(f"w1/w2: expected ({M}, {C}) / ({C}, {M}), "
                         f"got {tuple(w1.shape)} / {tuple(w2.shape)}")
    xn = gemm.layernorm(x, g_ln, b_ln, eps)
    h = gemm.linear(xn, w1, b1, gelu=True)
    out = gemm.linear(h, w2, b2, residual=x)
    launches += 1
    return out


def ln_mlp_residual(x, g_ln, b_ln, w1, b1, w2, b2, eps: float = 1e-6, dtype=torch.bfloat16):
    """``x + MLP(LN(x))`` for ``x (..., C)``: the kernel for a CUDA tensor
    (bf16 products), the plain version with products in `dtype` for a CPU
    tensor."""
    if not x.is_cuda:
        return ln_mlp_residual_plain(x, g_ln, b_ln, w1, b1, w2, b2, eps, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the MLP kernel computes in bfloat16, got dtype {dtype}")
    C = x.shape[-1]
    out = ln_mlp_residual_cuda(x.reshape(-1, C), g_ln, b_ln, w1, b1, w2, b2, eps)
    return out.reshape(x.shape)
