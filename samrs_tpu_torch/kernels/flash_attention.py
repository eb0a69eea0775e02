"""K2: global attention of the encoder with the decomposed rel-pos bias,
heads read in place from the raw ``(B, N, 3C)`` qkv tensor, in the four
modes of the JAX package's ``global_attn_impl``; ``flash_attention_relpos``,
the same attention on split heads over K12 (window_attention.py); and K10,
plain softmax attention in fp32 for the seg ViTs' full-attention blocks (at
the end of this module).

K2 replaces samrs_tpu/kernels/flash_attention.py::flash_attention_qkv_relpos
(Pallas calls ``_qkv_flash_m_pallas`` :343 for variant "m",
``_qkv_flash_pallas`` :239 for "split" and "exp2", ``_qkv_flash_aug_pallas``
:454 for "aug").  On a CUDA tensor the wrapper launches two hand-written
kernels of csrc/flash_attention.cu: one computes the per-query rel-pos rows
``rel_h = q.Rh[x_q]^T`` and ``rel_w = q.Rw[y_q]^T`` in fp32 from the q
columns read in place (outside the attention, as the JAX package computes
them outside its pallas_call), then the flash kernel (wgmma fed by TMA,
csrc/hopper.cuh; ``check_qkv_layout`` states what it takes).
The modes round where their twins round: "m" and "split" add the fp32 rows;
"exp2" takes the softmax in base 2 with log2 e folded into the scale and the
tables; "aug" rounds ``q * scale`` and the rows to the compute dtype before
they meet.  Any grid (a key tile may straddle grid rows) and any N (ragged
tiles are masked).  Bound on the H100: tensor-core flops plus the softmax on
the CUDA cores; the N x N logits never reach device memory.  On a CPU tensor
it runs the plain version.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from samrs_tpu_torch.kernels import _build, window_attention

launches = 0  # CUDA launches of this kernel (one per wrapper call)

_HEAD_DIMS = (64, 80)  # instantiated in csrc/flash_attention.cu
_TILE = 64  # key tile of the warp-level kernel K12 (csrc/warp_attention.cuh)
K2_KEY_TILE = 128  # key tile of K2's kernel: its online softmax rounds per tile of this
K1_KEY_TILE = 208  # K1's window kernel: one softmax over a window's 196 keys (padded to 208)
MAX_TOKENS = 1 << 22  # the kernel splits keys into grid (row, column) by a float reciprocal
VARIANTS = ("m", "split", "exp2", "aug")  # the JAX package's global_attn_impl values
_MODE = {"m": 0, "split": 0, "exp2": 1, "aug": 2}  # the kernel's softmax / rounding mode
LOG2E = 1.4426950408889634


def _rel_rows(q: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor, hw: Tuple[int, int]):
    """q (B, nH, N, hd) -> fp32 rel_h (B, nH, N, H), rel_w (B, nH, N, W)."""
    H, W = hw
    B, nH, N, hd = q.shape
    rq = q.float().reshape(B, nH, H, W, hd)
    rel_h = torch.einsum("bnxyd,xkd->bnxyk", rq, Rh.float()).reshape(B, nH, N, H)
    rel_w = torch.einsum("bnxyd,ykd->bnxyk", rq, Rw.float()).reshape(B, nH, N, W)
    return rel_h, rel_w


def online_softmax_v(s: torch.Tensor, v: torch.Tensor, dtype: torch.dtype,
                     tile: int = _TILE, base2: bool = False) -> torch.Tensor:
    """``softmax(s) @ v`` in fp32, rounded as the kernels' online softmax
    rounds it (csrc/warp_attention.cuh): keys in tiles of `tile`, each
    tile's probabilities exp(s - running max) rounded to `dtype` (the P of
    the P.V product), row sum of the rounded values, rescaled to the final
    max.  For fp32 this is the exact softmax.  With `base2` the logits are in
    units of log2 e and the powers are of 2.  s (..., n), v (..., n, d)."""
    n = s.shape[-1]
    exp = torch.exp2 if base2 else torch.exp
    st = F.pad(s, (0, (-n) % tile), value=float("-inf")).unflatten(-1, (-1, tile))
    m = st.amax(-1).cummax(-1).values                     # running max after each tile
    p = exp(st - m[..., None]).to(dtype).float()
    rescale = exp(m - m[..., -1:])
    denom = (p.sum(-1) * rescale).sum(-1, keepdim=True)
    p = (p * rescale[..., None]).flatten(-2)[..., :n]
    return (p @ v.float()) / denom


def check_qkv_layout(B: int, N: int, C3: int, num_heads: int, hw: Tuple[int, int],
                     pointer: int = 0) -> int:
    """Raise ValueError unless K2's kernel takes a ``qkv (B, N, C3)`` bf16
    tensor of `num_heads` heads on the grid `hw` at device address `pointer`;
    returns the head dim.  The kernel reads qkv through TMA tensor maps: the
    base 16-byte aligned and each row (3C bf16) a multiple of 16 bytes; heads
    of 64 or 80 (csrc/flash_attention.cu's instantiations); N = H * W, under
    2^22 tokens."""
    H, W = hw
    C = C3 // 3
    hd = C // num_heads if num_heads > 0 else 0
    if B <= 0 or 3 * C != C3 or hd * num_heads != C or hd not in _HEAD_DIMS:
        raise ValueError(f"flash kernel supports head_dim in {_HEAD_DIMS}, got 3C={C3}, "
                         f"heads={num_heads}")
    if N != H * W or not 0 < N < MAX_TOKENS:
        raise ValueError(f"flash kernel needs N = H*W < {MAX_TOKENS}, got N={N}, hw={hw}")
    if (C3 * 2) % 16 or pointer % 16:
        raise ValueError(f"flash kernel reads qkv by TMA: needs a 16-byte aligned base and rows "
                         f"of a multiple of 16 bytes, got 3C={C3}, address {pointer:#x}")
    return hd


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown global attention variant {variant!r}; have {VARIANTS}")


def _mode_tables(Rh, Rw, scale: float, variant: str, dtype: torch.dtype):
    """The rel-pos tables and scales of one mode, as its twin rounds them:
    (table for rel_h, table for rel_w, whether the rel rows round to `dtype`,
    scale of q before the product (None: not rounded), scale of the
    product)."""
    if variant == "exp2":
        return Rh * LOG2E, Rw * LOG2E, False, None, scale * LOG2E
    if variant == "aug":
        return Rh.to(dtype), Rw.to(dtype), True, scale, 1.0
    return Rh, Rw, False, None, scale


def _mode_inputs(q, Rh, Rw, hw, scale: float, variant: str, dtype: torch.dtype):
    """The rel rows and the scales of one mode, rounded where its twin rounds:
    (rel_h, rel_w, scale of q before the product (None: not rounded), scale
    of the product)."""
    Th, Tw, round_rows, q_scale, s_scale = _mode_tables(Rh, Rw, scale, variant, dtype)
    rel_h, rel_w = _rel_rows(q, Th, Tw, hw)
    if round_rows:
        rel_h, rel_w = rel_h.to(dtype).float(), rel_w.to(dtype).float()
    return rel_h, rel_w, q_scale, s_scale


def attention_qkv_relpos_plain(qkv, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int,
                               variant: str = "m"):
    """Plain PyTorch version, following the JAX oracle
    ``attention_qkv_relpos_xla``: fp32 logits and softmax, output in qkv's
    dtype; the probabilities are rounded as the kernel rounds them
    (``online_softmax_v``), and each mode rounds as the kernel's does.
    qkv (B, N, 3C) -> (B, N, C)."""
    _check_variant(variant)
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    dt = qkv.dtype
    q, k, v = qkv.reshape(B, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4).unbind(0)
    rel_h, rel_w, q_scale, s_scale = _mode_inputs(q, Rh, Rw, hw, scale, variant, dt)
    qf = q.float() if q_scale is None else (q.float() * q_scale).to(dt).float()
    s = (qf @ k.float().transpose(-1, -2)) * s_scale          # (B, nH, N, N)
    s = s.reshape(B, num_heads, N, H, W) + rel_h[..., :, None] + rel_w[..., None, :]
    out = online_softmax_v(s.reshape(B, num_heads, N, N), v, dt, tile=K2_KEY_TILE,
                           base2=variant == "exp2")
    return out.permute(0, 2, 1, 3).reshape(B, N, C).to(dt)


def attention_qkv_relpos_cuda(qkv, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int,
                              variant: str = "m"):
    """The hand-written kernels on a bf16 CUDA ``qkv (B, N, 3C)``: the fp32
    rel-pos rows from the q columns read in place (``samrs_relpos_rows``),
    then the flash kernel."""
    global launches
    _check_variant(variant)
    _build.require_cuda("qkv", qkv, torch.bfloat16)
    if qkv.dim() != 3:
        raise ValueError(f"qkv: expected (B, N, 3C), got {tuple(qkv.shape)}")
    H, W = hw
    B, N, C3 = qkv.shape
    C = C3 // 3
    hd = check_qkv_layout(B, N, C3, num_heads, hw, _build.ptr(qkv))
    if tuple(Rh.shape) != (H, H, hd) or tuple(Rw.shape) != (W, W, hd):
        raise ValueError(f"Rh/Rw: expected ({H}, {H}, {hd}) / ({W}, {W}, {hd})")
    Th, Tw, round_rows, q_scale, s_scale = _mode_tables(Rh, Rw, scale, variant, torch.bfloat16)
    Th, Tw = (t.to(device=qkv.device, dtype=torch.float32).contiguous() for t in (Th, Tw))
    rel_h = torch.empty(B, num_heads, N, H, device=qkv.device, dtype=torch.float32)
    rel_w = torch.empty(B, num_heads, N, W, device=qkv.device, dtype=torch.float32)
    _build.launch("samrs_relpos_rows", _build.ptr(qkv), _build.ptr(Th), _build.ptr(Tw),
                  _build.ptr(rel_h), _build.ptr(rel_w), B, N, C, num_heads, hd, H, W,
                  int(round_rows))
    out = torch.empty(B, N, C, device=qkv.device, dtype=torch.bfloat16)
    _build.launch("samrs_flash_attention_relpos", _build.ptr(qkv), _build.ptr(rel_h),
                  _build.ptr(rel_w), _build.ptr(out), B, N, C, num_heads, hd, H, W,
                  float(s_scale if q_scale is None else q_scale), _MODE[variant])
    launches += 1
    return out


def attention_qkv_relpos(qkv, Rh, Rw, hw: Tuple[int, int], scale: float, num_heads: int,
                         variant: str = "m"):
    """K2 on ``qkv (B, N, 3C)`` -> ``(B, N, C)`` in the mode `variant` (the
    JAX package's ``global_attn_impl``): the kernel for a CUDA tensor, the
    plain version for a CPU tensor."""
    if not qkv.is_cuda:
        return attention_qkv_relpos_plain(qkv, Rh, Rw, hw, scale, num_heads, variant)
    return attention_qkv_relpos_cuda(qkv, Rh, Rw, hw, scale, num_heads, variant)


def flash_attention_relpos(q, k, v, Rh, Rw, hw: Tuple[int, int], scale: float) -> torch.Tensor:
    """JAX ``flash_attention_relpos``: attention with the decomposed rel-pos
    bias over an (H, W) grid on split heads, q, k, v (B', N, d), the
    gathered Rh (H, H, d) / Rw (W, W, d) -> (B', N, d) fp32; K12's
    query-tiled launch on the card (the whole-window one for N <= 256)."""
    rel_h, rel_w = window_attention.rel_rows(q, Rh, Rw, hw)
    return window_attention.split_attention(q, k, v, rel_h, rel_w, scale)


def flash_attention_relpos_plain(q, k, v, Rh, Rw, hw: Tuple[int, int], scale: float):
    """``flash_attention_relpos`` with K12's plain version on any device."""
    rel_h, rel_w = window_attention.rel_rows(q, Rh, Rw, hw)
    return window_attention.split_attention_plain(q, k, v, rel_h, rel_w, scale)


# ---------------------------------------------------------------------------
# K10: plain softmax attention, fp32 (the seg ViTs' full-attention blocks).
#
# Replaces samrs_tpu/kernels/flash_attention.py::flash_attention_plain
# (Pallas call ``_plain_fwd_pallas``, :618).  On a CUDA tensor the forward
# launches the hand-written kernels of csrc/plain_attention.cu: a pre-pass
# that splits K and V^T into their tf32 halves (one 64-key stage image a
# tile, into a scratch the wrapper allocates at the size the C side's
# samrs_plain_attention_scratch_bytes gives), then a flash-attention
# kernel on split-TF32 wgmma (fp32-accurate: three tf32 products an fp32
# product, a fresh partial sum per 32-deep part of Q.K^T and per key tile of
# P.V), bound by those tensor-core operations, 3 x 4 N^2 d per head; the
# backward recomputes with ``full_attention_plain`` under autograd, as the
# JAX package's ``_plain_bwd`` recomputes with its XLA oracle, and launches
# no kernel.  On a CPU tensor it runs the plain version.
# ---------------------------------------------------------------------------

full_launches = 0  # CUDA launches of K10 (one per forward: its split pre-pass and its kernel)

_FULL_HEAD_DIMS = (64, 80)  # instantiated in csrc/plain_attention.cu


def full_attention_plain(q, k, v, scale: float):
    """Plain PyTorch version, JAX's ``attention_plain_xla``:
    ``softmax((q * scale) @ k^T) @ v`` in fp32.  q, k, v (BH, N, d) -> (BH, N, d)."""
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    return s.softmax(-1) @ v.float()


def full_attention_cuda(q, k, v, scale: float):
    """The K10 kernels on contiguous fp32 CUDA ``q, k, v (BH, N, d)``, d 64
    or 80, BH <= 65535 (the grid's second dimension)."""
    global full_launches
    if q.dim() != 3:
        raise ValueError(f"q: expected (BH, N, d), got {tuple(q.shape)}")
    BH, N, d = q.shape
    if d not in _FULL_HEAD_DIMS:
        raise ValueError(f"K10 supports head_dim in {_FULL_HEAD_DIMS}, got {d}")
    if not 0 < BH <= 65535:
        raise ValueError(f"K10 takes 1 to 65535 heads (BH), got {BH}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(name, t, torch.float32, q.shape)
    if q.data_ptr() % 8:
        raise ValueError("q: K10 reads q as 8-byte pairs and needs an 8-byte aligned address")
    out = torch.empty_like(q)
    nbytes = _build.library().samrs_plain_attention_scratch_bytes(BH, N, d)
    scratch = torch.empty(nbytes, device=q.device, dtype=torch.uint8)
    _build.launch("samrs_plain_attention", _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(scratch), scratch.numel(), _build.ptr(out), BH, N, d, float(scale))
    full_launches += 1
    return out


class _FullAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return full_attention_cuda(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            out = full_attention_plain(*leaves, ctx.scale)
        return (*torch.autograd.grad(out, leaves, g), None)


def full_attention(q, k, v, scale: float):
    """K10 (JAX ``flash_attention_plain``): q, k, v (BH, N, d) -> (BH, N, d)
    fp32.  The kernel for a CUDA tensor (backward: the plain version's VJP,
    recomputed), the plain version for a CPU tensor."""
    if not q.is_cuda:
        return full_attention_plain(q, k, v, scale)
    return _FullAttention.apply(q.float().contiguous(), k.float().contiguous(),
                                v.float().contiguous(), float(scale))
