"""K12: attention with the decomposed rel-pos bias on split heads, the layout
of the reference SAM: ``q, k, v (B', N, d)`` with ``B' = images x windows x
heads``, fp32 rel rows ``rel_h (B', N, kh)`` / ``rel_w (B', N, kw)``, and
``softmax(q.k^T * scale + rel_h[:, :, k // kw] + rel_w[:, :, k % kw]) v``
in fp32.

Replaces samrs_tpu/kernels/window_attention.py::window_attention_relpos
(Pallas call ``_window_attention_pallas``, :83: the windowed layers of
``window_attn_impl="pallas"`` and the global layers of a grid under 2048
tokens) and, through ``flash_attention.flash_attention_relpos``,
flash_attention.py's ``_flash_attention_fwd_pallas`` (:105).  On a CUDA
tensor the wrappers launch hand-written kernels that share the pipelines of
K1 and K2 (TMA-fed wgmma, csrc/hopper.cuh), in one of two forms
(``split_form``):

* the window form (N <= 196, kh + kw <= 32: a 14 x 14 window, any global
  grid of up to 196 tokens), K1's persistent kernel of
  csrc/window_attention.cu: one exact softmax over an item's keys
  (``K1_KEY_TILE``), the next row of B' landing by TMA while this one is
  multiplied; bound on the H100 by device-memory bytes;
* the query-tiled form (every other grid: the 64 x 64 globals, the grids of
  image_size 512 and 256), K2's kernel of csrc/flash_attention.cu: 128
  queries a block, 128-key tiles through a two-stage TMA ring, an online
  softmax rounded per key tile (``K2_KEY_TILE``); bound by tensor-core
  operations at the globals.

``window_attention_relpos`` makes the rel rows on the card from bf16 q read
in place (K1's rel kernel on 14 x 14 windows, K2's elsewhere), so q is never
copied to fp32.  On a CPU tensor every wrapper runs the plain version.
``window_attention_xla`` is the torch composition of the JAX oracle, which
``window_attn_impl="xla"`` selects for its windowed layers.
"""

from __future__ import annotations

from typing import Tuple

import torch

from samrs_tpu_torch.kernels import _build, flash_attention, fused_window_layer, gemm

launches = 0  # CUDA launches of K12 (one per attention call; its rel rows ride with it)

_HEAD_DIMS = (64, 80)  # instantiated in csrc/window_attention.cu and flash_attention.cu
WINDOW_MAX = 196  # the window form's largest N (K1's box of 14 x 14 tokens)
WINDOW_REL_MAX = 32  # ... and largest kh + kw (a tile's rel rows in shared memory)
MAX_ROWS = 65535  # rows of B' the query-tiled form and the rel-row kernel take (a grid dimension)


def split_form(N: int, kh: int, kw: int) -> str:
    """The form the kernels take for an (kh, kw) grid of N tokens: "window"
    or "tiled"."""
    return "window" if N <= WINDOW_MAX and kh + kw <= WINDOW_REL_MAX else "tiled"


def key_tile(N: int, kh: int, kw: int) -> int:
    """Keys whose probabilities share one running max in the kernel's
    softmax (the plain version rounds as it does)."""
    return (flash_attention.K1_KEY_TILE if split_form(N, kh, kw) == "window"
            else flash_attention.K2_KEY_TILE)


def rel_rows(q: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor, hw: Tuple[int, int]):
    """q (B', N, d) -> fp32 rel_h (B', N, kh), rel_w (B', N, kw): the
    per-query products with the gathered (kh, kh, d) / (kw, kw, d) tables."""
    kh, kw = hw
    B, N, d = q.shape
    rq = q.float().reshape(B, kh, kw, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, Rh.float()).reshape(B, N, kh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, Rw.float()).reshape(B, N, kw)
    return rel_h, rel_w


def _logits(q, k, rel_h, rel_w, scale: float) -> torch.Tensor:
    B, N, _ = q.shape
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    s = (q.float() * scale) @ k.float().transpose(-1, -2)
    s = s.reshape(B, N, kh, kw) + rel_h.float()[..., :, None] + rel_w.float()[..., None, :]
    return s.reshape(B, N, N)


def window_attention_xla(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The JAX oracle ``window_attention_xla`` as torch ops: fp32 logits and
    softmax, the probabilities in v's dtype for the product -> fp32."""
    p = _logits(q, k, rel_h, rel_w, scale).softmax(-1)
    return p.to(v.dtype).float() @ v.float()


def split_attention_plain(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """K12's plain version: fp32 logits, the probabilities rounded as the
    kernel's form rounds them (``online_softmax_v`` over ``key_tile`` keys:
    one softmax over the window, or 128-key tiles) -> fp32."""
    N = q.shape[1]
    tile = key_tile(N, rel_h.shape[-1], rel_w.shape[-1])
    return flash_attention.online_softmax_v(_logits(q, k, rel_h, rel_w, scale), v, v.dtype,
                                            tile=tile)


def check_split_layout(B: int, N: int, d: int, kh: int, kw: int, pointers=()) -> str:
    """Raise ValueError unless the kernels take split heads ``(B, N, d)`` on
    a (kh, kw) grid with q, k, v at the device addresses `pointers`; returns
    the form.  Heads of 64 or 80 (a 128-byte swizzled TMA box, plus a 32-byte
    one for the last 16 columns of 80); N = kh * kw, under 2^22 tokens (the
    keys' grid rows come from a float reciprocal); 16-byte aligned bases
    (TMA); at most 65535 rows of B' in the query-tiled form."""
    if d not in _HEAD_DIMS:
        raise ValueError(f"K12 supports head_dim in {_HEAD_DIMS}, got {d}")
    if kh <= 0 or kw <= 0 or kh * kw != N or not 0 < N < flash_attention.MAX_TOKENS:
        raise ValueError(f"rel-pos grid {kh}x{kw} != {N} tokens (or N >= "
                         f"{flash_attention.MAX_TOKENS})")
    form = split_form(N, kh, kw)
    if B <= 0 or (form == "tiled" and B > MAX_ROWS):
        raise ValueError(f"K12's {form} form takes 1 to {MAX_ROWS} rows of B', got {B}")
    for p in pointers:
        if p % gemm.TMA_ALIGN:
            raise ValueError(f"K12 reads q, k, v by TMA: needs {gemm.TMA_ALIGN}-byte aligned "
                             f"bases, got address {p:#x}")
    return form


def split_attention_cuda(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """The K12 kernel on bf16 CUDA ``q, k, v (B', N, d)`` and fp32 rel rows
    -> fp32 ``(B', N, d)``, in the form ``split_form`` gives."""
    global launches
    _build.require_cuda("q", q, torch.bfloat16)
    if q.dim() != 3:
        raise ValueError(f"q: expected (B', N, d), got {tuple(q.shape)}")
    B, N, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require_cuda(name, t, torch.bfloat16, (B, N, d))
    kh, kw = rel_h.shape[-1], rel_w.shape[-1]
    form = check_split_layout(B, N, d, kh, kw, (_build.ptr(q), _build.ptr(k), _build.ptr(v)))
    _build.require_cuda("rel_h", rel_h, torch.float32, (B, N, kh))
    _build.require_cuda("rel_w", rel_w, torch.float32, (B, N, kw))
    out = torch.empty(B, N, d, device=q.device, dtype=torch.float32)
    _build.launch(f"samrs_split_attention_{form}", _build.ptr(q), _build.ptr(k), _build.ptr(v),
                  _build.ptr(rel_h), _build.ptr(rel_w), _build.ptr(out), B, N, d, kh, kw,
                  float(scale))
    launches += 1
    return out


def split_attention(q, k, v, rel_h, rel_w, scale: float) -> torch.Tensor:
    """K12: the kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if not q.is_cuda:
        return split_attention_plain(q, k, v, rel_h, rel_w, scale)
    return split_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                                rel_h.contiguous(), rel_w.contiguous(), scale)


def rel_rows_cuda(q: torch.Tensor, Rh: torch.Tensor, Rw: torch.Tensor, hw: Tuple[int, int]):
    """``rel_rows`` by a kernel on bf16 CUDA ``q (B', N, d)``, read in place:
    K1's rel kernel on 14 x 14 windows (csrc/window_attention.cu), K2's on
    any other grid (csrc/flash_attention.cu); each output an fp32 dot product
    over d in increasing order."""
    _build.require_cuda("q", q, torch.bfloat16)
    if q.dim() != 3:
        raise ValueError(f"q: expected (B', N, d), got {tuple(q.shape)}")
    kh, kw = hw
    B, N, d = q.shape
    check_split_layout(B, N, d, kh, kw, (_build.ptr(q),))
    window = (kh, kw) == (fused_window_layer.WINDOW, fused_window_layer.WINDOW)
    if not window and B > MAX_ROWS:
        raise ValueError(f"K12's rel rows off 14 x 14 windows take 1 to {MAX_ROWS} rows of B', "
                         f"got {B}")
    if tuple(Rh.shape) != (kh, kh, d) or tuple(Rw.shape) != (kw, kw, d):
        raise ValueError(f"Rh/Rw: expected ({kh}, {kh}, {d}) / ({kw}, {kw}, {d})")
    th, tw = (fused_window_layer._fp32_table(t, q.device) for t in (Rh, Rw))
    rel_h = torch.empty(B, N, kh, device=q.device, dtype=torch.float32)
    rel_w = torch.empty(B, N, kw, device=q.device, dtype=torch.float32)
    p = _build.ptr
    if window:
        _build.launch("samrs_split_window_rel", p(q), p(th), p(tw), p(rel_h), p(rel_w), B, d)
    else:
        _build.launch("samrs_split_relpos_rows", p(q), p(th), p(tw), p(rel_h), p(rel_w), B, N, d,
                      kh, kw)
    return rel_h, rel_w


def window_attention_relpos(q, k, v, Rh, Rw, hw: Tuple[int, int], scale: float,
                            force_xla: bool = False) -> torch.Tensor:
    """JAX ``window_attention_relpos``: attention over (kh, kw) token grids,
    q, k, v (B', N, d) with N = kh * kw, the gathered tables Rh (kh, kh, d)
    / Rw (kw, kw, d) -> (B', N, d) fp32.  On the card the rel-row kernel and
    K12; on the CPU K12's plain version; with `force_xla` the torch
    composition of the JAX oracle."""
    if force_xla:
        return window_attention_xla(q, k, v, *rel_rows(q, Rh, Rw, hw), scale)
    if not q.is_cuda:
        return split_attention_plain(q, k, v, *rel_rows(q, Rh, Rw, hw), scale)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    return split_attention_cuda(q, k, v, *rel_rows_cuda(q, Rh, Rw, hw), scale)


def window_attention_relpos_plain(q, k, v, Rh, Rw, hw: Tuple[int, int], scale: float,
                                  force_xla: bool = False) -> torch.Tensor:
    """``window_attention_relpos`` with K12's plain version on any device."""
    rel_h, rel_w = rel_rows(q, Rh, Rw, hw)
    attend = window_attention_xla if force_xla else split_attention_plain
    return attend(q, k, v, rel_h, rel_w, scale)
