"""Launchers for the dense pieces shared by K1 and K3 (csrc/gemm.cu): a bf16
GEMM with bias / exact-GELU epilogues and bf16 output, or with the encoder's
fp32 residual stream added and fp32 output, and the fp32-statistics
LayerNorm of that stream.  CUDA tensors only; the callers own the CPU path.
``linear_plain`` is the GEMM's plain version, rounded where it rounds.

The GEMM is a warp-specialised wgmma kernel fed by TMA (csrc/hopper.cuh):
its operands must meet the TMA's rules, which ``check_gemm_layout`` states
and the wrapper enforces (it raises; there is no other route)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakTensorKeyDictionary

from samrs_tpu_torch.kernels import _build


launches = 0  # CUDA launches of the GEMM (one per ``linear`` call on the card)

GEMM_BK = 64  # depth of a stage of csrc/gemm.cu: K must be a multiple
TMA_ALIGN = 16  # bytes: a TMA base address and row stride are multiples


def check_gemm_layout(T: int, K: int, N: int, pointers=()) -> None:
    """Raise ValueError unless csrc/gemm.cu takes ``x (T, K) @ w (N, K)^T``:
    K a multiple of GEMM_BK (so each bf16 row stride is a multiple of 16
    bytes), N a multiple of 8 (paired epilogue stores), and every pointer
    (x, w, the bias, the residual; device addresses as ints) 16-byte
    aligned."""
    if T <= 0 or K <= 0 or N <= 0:
        raise ValueError(f"GEMM needs positive sizes, got T={T}, K={K}, N={N}")
    if K % GEMM_BK or N % 8:
        raise ValueError(f"GEMM needs K % {GEMM_BK} == 0 and N % 8 == 0, got K={K}, N={N}")
    for p in pointers:
        if p is not None and p % TMA_ALIGN:
            raise ValueError(f"GEMM operands must be {TMA_ALIGN}-byte aligned (TMA), "
                             f"got address {p:#x}")


_copies = WeakTensorKeyDictionary()  # tensor -> {(dtype, layout): (its version, copy on the card)}


def _cached_copy(t: torch.Tensor, device: torch.device, dtype: torch.dtype,
                 layout=None) -> torch.Tensor:
    """`t` (rearranged by `layout`, a function of the tensor, if given) as a
    contiguous `dtype` tensor on `device`.  A tensor in another dtype, place
    or layout keeps its converted copy while it lives and its version counter
    (bumped by every in-place change) stands still, so a model's fp32
    parameters are converted once and not on every call."""
    if layout is None and t.dtype == dtype and t.device == device and t.is_contiguous():
        return t
    per = _copies.get(t)
    if per is None:
        per = _copies[t] = {}
    hit = per.get((dtype, layout))
    if hit is not None and hit[0] == t._version and hit[1].device == device:
        return hit[1]
    src = t.detach() if layout is None else layout(t.detach())
    copy = src.to(device=device, dtype=dtype).contiguous()
    per[(dtype, layout)] = (t._version, copy)
    return copy


def _bf16_weight(weight: torch.Tensor, device: torch.device) -> torch.Tensor:
    """`weight` as a contiguous bf16 tensor on `device`, converted once per
    version (``_cached_copy``)."""
    return _cached_copy(weight, device, torch.bfloat16)


def linear_plain(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
                 gelu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of ``linear`` with the kernel's numerics: products of x
    and the weight rounded to x's dtype, fp32 accumulation, bias, exact GELU
    and residual added in fp32, one rounding at the end to the residual's
    dtype (x's without one)."""
    dt = x.dtype
    y = F.linear(x.float(), weight.to(dt).float())
    if bias is not None:
        y = y + bias.float()
    if gelu:
        y = F.gelu(y)
    if residual is not None:
        return (y + residual.float()).to(residual.dtype)
    return y.to(dt)


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
           gelu: bool = False, residual: Optional[torch.Tensor] = None) -> torch.Tensor:
    """bf16 ``x (T, K) @ weight (N, K)^T + bias`` [-> gelu] [+ residual (T, N)].

    `weight` and `bias` are parameters in any float dtype; they are cast to
    bf16 / fp32 for the kernel (the weight's bf16 copy is kept:
    ``_bf16_weight``).  The epilogue adds in fp32 and rounds once
    to bf16; with an fp32 `residual` the output is fp32."""
    global launches
    _build.require_cuda("x", x, torch.bfloat16)
    if x.dim() != 2:
        raise ValueError(f"x: expected (T, K), got {tuple(x.shape)}")
    T, K = x.shape
    N = weight.shape[0]
    if tuple(weight.shape) != (N, K):
        raise ValueError(f"weight: expected ({N}, {K}), got {tuple(weight.shape)}")
    w = _bf16_weight(weight, x.device)
    b = None if bias is None else bias.to(device=x.device, dtype=torch.float32).contiguous()
    if b is not None and tuple(b.shape) != (N,):
        raise ValueError(f"bias: expected ({N},), got {tuple(b.shape)}")
    if residual is not None:
        _build.require_cuda("residual", residual, torch.float32, (T, N))
    check_gemm_layout(T, K, N, (_build.ptr(x), _build.ptr(w), _build.ptr(b),
                                _build.ptr(residual)))
    out = torch.empty(T, N, device=x.device,
                      dtype=torch.bfloat16 if residual is None else torch.float32)
    _build.launch("samrs_gemm_bf16", _build.ptr(x), _build.ptr(w), _build.ptr(b),
                  _build.ptr(residual), _build.ptr(out), T, N, K, int(gelu))
    launches += 1
    return out


def layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    """Row LayerNorm of fp32 ``x (T, C)`` -> bf16."""
    _build.require_cuda("x", x, torch.float32)
    if x.dim() != 2:
        raise ValueError(f"x: expected (T, C), got {tuple(x.shape)}")
    T, C = x.shape
    if C % 8:
        raise ValueError(f"LayerNorm kernel needs C % 8 == 0, got {C}")
    g = gamma.to(device=x.device, dtype=torch.float32).contiguous()
    b = beta.to(device=x.device, dtype=torch.float32).contiguous()
    if tuple(g.shape) != (C,) or tuple(b.shape) != (C,):
        raise ValueError(f"gamma/beta: expected ({C},)")
    out = torch.empty(T, C, device=x.device, dtype=torch.bfloat16)
    _build.launch("samrs_layernorm", _build.ptr(x), _build.ptr(g), _build.ptr(b),
                  _build.ptr(out), T, C, float(eps))
    return out
