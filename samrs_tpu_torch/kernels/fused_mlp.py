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

``fused_tail_ln_mlp_residual`` is K3's tail mode (``tail_impl="fused"``;
samrs_tpu/kernels/fused_mlp.py::fused_tail_ln_mlp_residual, Pallas call
``_tail_pallas`` :413): the windowed sublayer's crop and attention residual
move into K3's LayerNorm prologue, which reads the valid (H, W) region of
the padded attention map in place and writes the summed stream that the
lin2 epilogue adds back; the GEMMs are K3's.

Weights use torch's ``nn.Linear`` layout: w1 (M, C), w2 (C, M).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from samrs_tpu_torch.kernels import _build, gemm

launches = 0  # CUDA launches of this kernel (one per wrapper call)
tail_launches = 0  # CUDA launches of the tail mode (one per wrapper call)


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


def fused_tail_ln_mlp_residual_plain(att_p, sc, g_ln, b_ln, w1, b1, w2, b2, eps: float = 1e-6,
                                     dtype=torch.float32):
    """Plain version, following the JAX oracle ``tail_ln_mlp_residual_xla``:
    ``x = sc + att_p[:, :H, :W]`` in sc's dtype, then ``x + MLP(LN(x))``
    as ``ln_mlp_residual_plain``.  att_p (B, Hp, Wp, C), sc (B, H, W, C)."""
    B, H, W, C = sc.shape
    x = sc + att_p[:, :H, :W].to(sc.dtype)
    return ln_mlp_residual_plain(x, g_ln, b_ln, w1, b1, w2, b2, eps, dtype)


def fused_tail_ln_mlp_residual_cuda(att_p, sc, g_ln, b_ln, w1, b1, w2, b2, eps: float = 1e-6):
    """The tail mode on the card: bf16 ``att_p (B, Hp, Wp, C)``, the fp32
    residual stream ``sc (B, H, W, C)`` -> fp32 ``(B, H, W, C)``."""
    global tail_launches
    _build.require_cuda("sc", sc, torch.float32)
    _build.require_cuda("att_p", att_p, torch.bfloat16)
    if sc.dim() != 4 or att_p.dim() != 4:
        raise ValueError(f"att_p / sc: expected (B, Hp, Wp, C) / (B, H, W, C), got "
                         f"{tuple(att_p.shape)} / {tuple(sc.shape)}")
    B, H, W, C = sc.shape
    _, Hp, Wp, _ = att_p.shape
    if att_p.shape[0] != B or att_p.shape[3] != C or Hp < H or Wp < W or C % 8:
        raise ValueError(f"att_p {tuple(att_p.shape)} does not cover sc {tuple(sc.shape)} "
                         f"(or C % 8 != 0)")
    M = w1.shape[0]
    if tuple(w1.shape) != (M, C) or tuple(w2.shape) != (C, M):
        raise ValueError(f"w1/w2: expected ({M}, {C}) / ({C}, {M})")
    g = g_ln.to(device=sc.device, dtype=torch.float32).contiguous()
    b = b_ln.to(device=sc.device, dtype=torch.float32).contiguous()
    xs = torch.empty_like(sc)
    xn = torch.empty(B, H, W, C, device=sc.device, dtype=torch.bfloat16)
    _build.launch("samrs_layernorm_tail", _build.ptr(sc), _build.ptr(att_p), _build.ptr(g),
                  _build.ptr(b), _build.ptr(xs), _build.ptr(xn), B, H, W, Hp, Wp, C, float(eps))
    h = gemm.linear(xn.reshape(-1, C), w1, b1, gelu=True)
    out = gemm.linear(h, w2, b2, residual=xs.reshape(-1, C))
    tail_launches += 1
    return out.reshape(B, H, W, C)


def fused_tail_ln_mlp_residual(att_p, sc, g_ln, b_ln, w1, b1, w2, b2, eps: float = 1e-6,
                               dtype=torch.bfloat16):
    """``x + MLP(LN(x))`` with ``x = sc + att_p[:, :H, :W]``: the kernel for
    a CUDA tensor (bf16 products), the plain version with products in
    `dtype` for a CPU tensor."""
    if not sc.is_cuda:
        return fused_tail_ln_mlp_residual_plain(att_p, sc, g_ln, b_ln, w1, b1, w2, b2, eps, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the MLP kernel computes in bfloat16, got dtype {dtype}")
    return fused_tail_ln_mlp_residual_cuda(att_p, sc.contiguous(), g_ln, b_ln, w1, b1, w2, b2,
                                           eps)


# ---------------------------------------------------------------------------
# K11: the MLP ``gelu_erf(x W1^T + b1) W2^T + b2`` in fp32 (the seg ViTs and
# InternImage).
#
# Replaces samrs_tpu/kernels/fused_mlp.py::fused_mlp (Pallas call
# ``_fused_pallas``, :105).  On a CUDA tensor the forward runs the
# hand-written kernels of csrc/fused_mlp.cu on the tensor cores with
# split-TF32 operands (each fp32 operand as a tf32 hi plus a tf32 lo, three
# tf32 products a step into fp32 accumulators): at C 64 / 96 / 128 one kernel
# that keeps the hidden on chip, else lin1 with a bias + exact GELU epilogue into
# an fp32 hidden scratch, then lin2 with a bias epilogue
# (``hidden_on_chip`` picks); bound by the tensor work, 3 x 4 T C M
# operations at 495 TFLOP/s.  The weights' tf32 halves are split by a small
# kernel once per weight version (``_tf32_halves``).  The backward
# recomputes the hidden layer with plain PyTorch and takes the VJP there
# (cuBLAS), as the JAX package's ``_bwd`` recomputes with its XLA oracle;
# it launches no kernel.  On a CPU tensor it runs the plain version.
# Weights in nn.Linear's layout: w1 (M, C), w2 (C, M).
# ---------------------------------------------------------------------------

mlp_launches = 0    # calls of K11's forward on the card (each launches one or two kernels)
split_launches = 0  # launches of the tf32 split of a weight (one per weight version)

_MLP_MULTIPLE = 64  # M, and C in the two-launch form, are multiples of this
_ON_CHIP_WIDTHS = (64, 96, 128)  # the fused form's instantiations (csrc/fused_mlp.cu)

_halves = WeakTensorKeyDictionary()  # weight -> (its version, tf32 hi, tf32 lo)


def fused_mlp_plain(x, w1, b1, w2, b2):
    """Plain PyTorch version, JAX's ``mlp_xla`` in fp32 (nn.Linear -> exact
    GELU -> nn.Linear).  x (..., C) -> (..., C)."""
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


def hidden_on_chip(C: int) -> bool:
    """Whether K11 at width C runs the fused form, with the hidden kept in
    registers (C 64 / 96 / 128), or the two launches with the hidden in
    device memory (C a multiple of 64 from 192)."""
    return C in _ON_CHIP_WIDTHS


def tf32_split_plain(w):
    """The tf32 halves of fp32 `w` in plain PyTorch: hi = w rounded to tf32
    (10 mantissa bits, to nearest, ties away from zero), lo = w - hi."""
    hi = ((w.contiguous().view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)
    return hi, w - hi


def tf32_split_cuda(w):
    """The split kernel on a contiguous fp32 CUDA tensor (the wrapper's
    callers have checked its device): (hi, lo)."""
    global split_launches
    if w.dtype != torch.float32 or not w.is_contiguous():
        raise ValueError(f"w: expected a contiguous fp32 tensor, got {w.dtype}")
    hi, lo = torch.empty_like(w), torch.empty_like(w)
    _build.launch("samrs_tf32_split", _build.ptr(w), _build.ptr(hi), _build.ptr(lo), w.numel())
    split_launches += 1
    return hi, lo


def _tf32_halves(w):
    """The tf32 halves (hi, lo) of an fp32 CUDA weight, w = hi + lo, split
    by the kernel once per version of `w` (its version counter moves with
    every in-place update, such as an optimizer step)."""
    hit = _halves.get(w)
    if hit is not None and hit[0] == w._version:
        return hit[1], hit[2]
    hi, lo = tf32_split_cuda(w.detach().contiguous())
    _halves[w] = (w._version, hi, lo)
    return hi, lo


def fused_mlp_cuda(x, w1, b1, w2, b2, on_chip=None):
    """The K11 kernels on a contiguous fp32 CUDA ``x (T, C)``; `on_chip`
    (default ``hidden_on_chip(C)``) picks the fused form, which takes C 64,
    96 and 128 only; the two launches take C a multiple of 64.  Both take M
    a multiple of 64."""
    global mlp_launches
    if x.dim() != 2:
        raise ValueError(f"x: expected (T, C), got {tuple(x.shape)}")
    T, C = x.shape
    M = w1.shape[0]
    if on_chip and not hidden_on_chip(C):
        raise ValueError(f"K11's fused form takes C in {_ON_CHIP_WIDTHS}, got C={C}")
    on_chip = hidden_on_chip(C) if on_chip is None else on_chip
    if M % _MLP_MULTIPLE or not (on_chip or C % _MLP_MULTIPLE == 0):
        raise ValueError(f"K11 takes C in {_ON_CHIP_WIDTHS} or a multiple of {_MLP_MULTIPLE} "
                         f"and M a multiple of {_MLP_MULTIPLE}, got C={C}, M={M}")
    _build.require_cuda("x", x, torch.float32)
    for name, t, shape in (("w1", w1, (M, C)), ("b1", b1, (M,)), ("w2", w2, (C, M)),
                           ("b2", b2, (C,))):
        _build.require_cuda(name, t, torch.float32, shape)
    if x.data_ptr() % 16:
        raise ValueError("x: the kernel's TMA needs a 16-byte aligned base")
    w1h, w1l = _tf32_halves(w1)
    w2h, w2l = _tf32_halves(w2)
    hidden = None if on_chip else torch.empty(T, M, device=x.device, dtype=torch.float32)
    out = torch.empty_like(x)
    p = _build.ptr
    _build.launch("samrs_fused_mlp", p(x), p(w1h), p(w1l), p(b1), p(w2h), p(w2l), p(b2),
                  p(hidden), p(out), T, C, M, int(on_chip))
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
    """K11 (JAX ``fused_mlp`` in fp32): x (..., C) -> (..., C).  The kernels
    for a CUDA tensor (backward: the plain version's VJP, the hidden layer
    recomputed), the plain version for a CPU tensor.  The kernels take the
    parameters as they are (fp32, contiguous: a model's nn.Linear weights)."""
    if not x.is_cuda:
        return fused_mlp_plain(x, w1, b1, w2, b2)
    C = x.shape[-1]
    out = _FusedMLP.apply(x.float().reshape(-1, C).contiguous(), w1, b1, w2, b2)
    return out.reshape(x.shape)
