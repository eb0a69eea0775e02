"""K3: the encoder's MLP sublayer, ``x + lin2(gelu(lin1(LN(x))))``; and
K11, the seg ViTs' MLP ``fc2(gelu(fc1(x)))`` in fp32 (at the end of this
module).

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
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# K11: the MLP ``gelu_erf(x W1^T + b1) W2^T + b2`` in fp32 (the seg ViTs).
#
# Replaces samrs_tpu/kernels/fused_mlp.py::fused_mlp (Pallas call
# ``_fused_pallas``, :105).  On a CUDA tensor the forward launches the
# hand-written kernel of csrc/fused_mlp.cu: the hidden activations stay on
# chip and GELU (exact erf) runs once per element; fp32 on the CUDA cores,
# bound by fp32 operations (4 T C M).  The backward recomputes the hidden
# layer with plain PyTorch and takes the VJP there (cuBLAS), as the JAX
# package's ``_bwd`` recomputes with its XLA oracle; it launches no kernel.
# On a CPU tensor it runs the plain version.  Weights in nn.Linear's layout:
# w1 (M, C), w2 (C, M).
# ---------------------------------------------------------------------------

mlp_launches = 0  # CUDA launches of K11 (one per forward)

_MLP_WIDTHS = (768, 1024, 1280)  # instantiated in csrc/fused_mlp.cu
_MLP_CHUNK = 128  # the kernel's hidden chunk; M must be a multiple


def fused_mlp_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version, JAX's ``mlp_xla`` in fp32 (nn.Linear -> exact
    GELU -> nn.Linear).  x (..., C) -> (..., C)."""
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


def fused_mlp_cuda(x, w1, b1, w2, b2):
    """The K11 kernel on a contiguous fp32 CUDA ``x (T, C)``."""
    global mlp_launches
    if x.dim() != 2:
        raise ValueError(f"x: expected (T, C), got {tuple(x.shape)}")
    T, C = x.shape
    M = w1.shape[0]
    if C not in _MLP_WIDTHS or M % _MLP_CHUNK:
        raise ValueError(f"K11 supports C in {_MLP_WIDTHS} and M % {_MLP_CHUNK} == 0, "
                         f"got C={C}, M={M}")
    _build.require_cuda("x", x, torch.float32)
    for name, t, shape in (("w1", w1, (M, C)), ("b1", b1, (M,)), ("w2", w2, (C, M)),
                           ("b2", b2, (C,))):
        _build.require_cuda(name, t, torch.float32, shape)
    out = torch.empty_like(x)
    p = _build.ptr
    _build.launch("samrs_fused_mlp", p(x), p(w1), p(b1), p(w2), p(b2), p(out), T, C, M)
    mlp_launches += 1
    return out


class _FusedMLP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2)
        return fused_mlp_cuda(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        x, w1, b1, w2 = ctx.saved_tensors
        leaves = [t.detach().requires_grad_() for t in (x, w1, b1)]
        with torch.enable_grad():
            a = F.gelu(F.linear(*leaves))  # the hidden layer, recomputed
        da = g @ w2
        dw2 = g.t() @ a.detach()
        db2 = g.sum(0)
        dx, dw1, db1 = torch.autograd.grad(a, leaves, da)
        return dx, dw1, db1, dw2, db2


def fused_mlp(x, w1, b1, w2, b2):
    """K11 (JAX ``fused_mlp`` in fp32): x (..., C) -> (..., C).  The kernel
    for a CUDA tensor (backward: the plain version's VJP, the hidden layer
    recomputed), the plain version for a CPU tensor."""
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, b1, w2, b2)
    C = x.shape[-1]
    out = _FusedMLP.apply(x.float().reshape(-1, C).contiguous(), w1.contiguous(), b1.contiguous(),
                          w2.contiguous(), b2.contiguous())
    return out.reshape(x.shape)
