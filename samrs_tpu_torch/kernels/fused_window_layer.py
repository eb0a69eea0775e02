"""K1: a whole windowed attention layer of the encoder: zero-pad the normed
map to a multiple of the window, qkv projection, per window and head
``softmax(q.k^T * scale + q.Rh[x_q, x_k] + q.Rw[y_q, y_k]) v``, output
projection, crop; with ``residual`` the projection's epilogue also adds the
residual stream (fp32 on the card) and writes it.

Replaces samrs_tpu/kernels/fused_window_layer.py::window_layer_attention
(variant "ijb", Pallas call ``_pallas``).  On a CUDA tensor the wrapper runs
three hand-written kernels: the qkv GEMM on the unpadded tokens
(csrc/gemm.cu), the window attention (csrc/window_attention.cu: the fp32
rel-pos rows of every window token, then a persistent wgmma kernel fed by
TMA that gives the map-pad tokens the qkv bias, exactly what the zero-padded
map gives them, and takes one softmax over each window's 196 keys), and the
proj GEMM.  Bound on the H100: the two GEMMs are tensor-core bound, the
attention device-memory bound (see the .cu note); ``check_window_layout``
states what the attention kernel takes.  On a CPU tensor it runs the plain
version, which has the same three stages.

The TPU kernel family's modes (the JAX package's ``variant``) take the same
three stages: None / "slab" (``block``, ``block_slab``; the rel producer is
the attention kernel's own) and "qkv_out" (``blockq``, Pallas call
``_pallas_q`` :305; the qkv GEMM sits outside the attention here anyway)
launch the attention in plain window order, "ijb" / "slab_ijb"
(``block_ijb``, ``block_sg``) batch innermost, "row" (``block_row``,
``_pallas_row`` :568) one block per window row;
``window_layer_attention_residual`` (``block2``, ``_pallas2`` :457) adds
the residual in the projection's epilogue.  ``return_padded`` returns the
uncropped ``(B, Hp, Wp, C)`` map without the residual, for the fused
sublayer tail (fused_mlp.fused_tail_ln_mlp_residual).

Weights use torch's ``nn.Linear`` layout: Wqkv (3C, C), Wproj (C, C).
``Rh``/``Rw`` are the gathered ``(ws, ws, head_dim)`` tables of ``get_rel_pos``.
"""

from __future__ import annotations

import torch

from samrs_tpu_torch.kernels import _build, flash_attention, gemm
from samrs_tpu_torch.nn.layers import window_partition, window_unpartition

launches = 0  # CUDA launches of this kernel (one per wrapper call)

_HEAD_DIMS = (64, 80)  # instantiated in csrc/window_attention.cu
WINDOW = 14  # SAM's window, the kernel's compile-time size
# the JAX package's variants -> the attention kernel's window order
_ORDERS = {None: "plain", "slab": "plain", "qkv_out": "plain", "ijb": "ijb",
          "slab_ijb": "ijb", "row": "row"}
_ORDER_CODE = {"plain": 0, "ijb": 1, "row": 2}
_LAYOUT_CODE = {"map": 0, "windows": 1}
REL_TERMS = 2 * WINDOW  # fp32 rel-pos terms a window token gets (the kernel's scratch rows)


def _padded_hw(H: int, W: int, ws: int):
    return -(-H // ws) * ws, -(-W // ws) * ws


def window_attention_plain(qkv, bqkv, Rh, Rw, ws: int, scale: float, num_heads: int,
                           padded: bool = False):
    """The attention stage on the ``(B, H, W, 3C)`` qkv map, in its dtype:
    the map's pad tokens carry the qkv bias (what the zero-padded normed map
    gives them), attention in fp32 with the probabilities rounded as the
    kernel rounds them (one softmax over the window's keys, ``K1_KEY_TILE``)
    -> ``(B, H, W, C)`` (the padded ``(B, Hp, Wp, C)`` with `padded`)."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    dt = qkv.dtype
    nH, hd = num_heads, C // num_heads
    Hp, Wp = _padded_hw(H, W, ws)
    if (Hp, Wp) != (H, W):
        fill = torch.zeros(C3, dtype=dt, device=qkv.device) if bqkv is None else bqkv.to(dt)
        full = fill.expand(B, Hp, Wp, C3).clone()
        full[:, :H, :W] = qkv
        qkv = full
    wins, _ = window_partition(qkv, ws)
    n = ws * ws
    q, k, v = wins.reshape(-1, n, 3, nH, hd).permute(2, 0, 3, 1, 4).float().unbind(0)
    s = (q * scale) @ k.transpose(-1, -2)                      # (nW, nH, n, n)
    rq = q.reshape(-1, nH, ws, ws, hd)
    rel_h = torch.einsum("wnxyd,xud->wnxyu", rq, Rh.float())
    rel_w = torch.einsum("wnxyd,yvd->wnxyv", rq, Rw.float())
    s = s.reshape(-1, nH, ws, ws, ws, ws) + rel_h[..., :, None] + rel_w[..., None, :]
    o = flash_attention.online_softmax_v(s.reshape(-1, nH, n, n), v, dt,
                                         tile=flash_attention.K1_KEY_TILE)
    o = o.to(dt).permute(0, 2, 1, 3).reshape(-1, ws, ws, C)
    return window_unpartition(o, ws, (Hp, Wp), (Hp, Wp) if padded else (H, W))


def _check_layer_args(variant, residual, return_padded) -> str:
    if variant not in _ORDERS:
        raise ValueError(f"unknown window layer variant {variant!r}; have {list(_ORDERS)}")
    if return_padded and (residual is not None or variant in ("row", "qkv_out")):
        raise ValueError("return_padded takes no residual and is not offered for the "
                         "'row' / 'qkv_out' variants (as in the JAX package)")
    return _ORDERS[variant]


def window_layer_plain(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int, scale: float,
                       num_heads: int, residual=None, variant=None, return_padded: bool = False):
    """Plain PyTorch version in xn's dtype, following the JAX oracle
    ``window_layer_xla``; with `residual`, ``residual + layer`` in the
    residual's dtype; with `return_padded` the uncropped map (the pad
    tokens' rows are those of their bias-filled queries).  It rounds where
    the kernels round: each projection once after its fp32 bias (and
    residual), the probabilities as the online softmax does.  Every
    `variant` is the same function."""
    _check_layer_args(variant, residual, return_padded)
    B, H, W, C = xn.shape
    qkv = gemm.linear_plain(xn.reshape(-1, C), Wqkv, bqkv).reshape(B, H, W, 3 * C)
    o = window_attention_plain(qkv, bqkv, Rh, Rw, ws, scale, num_heads, padded=return_padded)
    res = None if residual is None else residual.reshape(-1, C)
    return gemm.linear_plain(o.reshape(-1, C), Wproj, bproj,
                             residual=res).reshape(B, *o.shape[1:3], C)


def check_window_layout(B: int, H: int, W: int, C3: int, num_heads: int, ws: int,
                        layout: str = "map", pointer: int = 0) -> int:
    """Raise ValueError unless the window kernel takes a bf16 qkv map
    ``(B, H, W, C3)`` of `num_heads` heads at device address `pointer`;
    returns the head dim.  The kernel reads Q, K and V through a 4-d TMA
    tensor map with a box of one 14 x 14 window: the base 16-byte aligned
    and each token's row (3C bf16) a multiple of 16 bytes; the window 14;
    heads of 64 or 80 (a 128-byte swizzled box, plus a 32-byte one for the
    last 16 columns of 80); partitioned windows are 14 x 14 tokens."""
    C = C3 // 3
    hd = C // num_heads if num_heads > 0 else 0
    if B <= 0 or H <= 0 or W <= 0 or 3 * C != C3 or hd * num_heads != C or hd not in _HEAD_DIMS:
        raise ValueError(f"window kernel supports head_dim in {_HEAD_DIMS}, got 3C={C3}, "
                         f"heads={num_heads}, map ({B}, {H}, {W})")
    if ws != WINDOW:
        raise ValueError(f"window kernel is built for window {WINDOW}, got {ws}")
    if layout not in _LAYOUT_CODE:
        raise ValueError(f"window kernel layout must be one of {list(_LAYOUT_CODE)}, "
                         f"got {layout!r}")
    if layout == "windows" and (H, W) != (ws, ws):
        raise ValueError(f"window kernel: partitioned windows must be ({ws}, {ws}) tokens, "
                         f"got ({H}, {W})")
    if (C3 * 2) % gemm.TMA_ALIGN or pointer % gemm.TMA_ALIGN:
        raise ValueError(f"window kernel reads qkv by TMA: needs a 16-byte aligned base and rows "
                         f"of a multiple of 16 bytes, got 3C={C3}, address {pointer:#x}")
    return hd


_smem_limits = {}  # device index -> shared memory a block may opt into


def _fp32_table(table: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A rel-pos table as the kernel reads it: contiguous fp32 on `device`
    (16-byte aligned: the kernel reads it in 16-byte loads), converted once
    per version (``gemm._cached_copy``)."""
    out = gemm._cached_copy(table, device, torch.float32)
    return out if out.data_ptr() % gemm.TMA_ALIGN == 0 else out.clone()


def _smem_limit(device: torch.device) -> int:
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _smem_limits:
        _smem_limits[index] = torch.cuda.get_device_properties(index).shared_memory_per_block_optin
    return _smem_limits[index]


def window_attention_cuda(qkv, bqkv, Rh, Rw, ws: int, scale: float, num_heads: int,
                          order: str = "plain", layout: str = "map", padded: bool = False):
    """The attention stage's kernels on a bf16 CUDA qkv map ``(B, H, W, 3C)``
    -> ``(B, H, W, C)`` bf16 (``(B, Hp, Wp, C)`` with `padded`).  `order`:
    "plain", "ijb" or "row"; `layout` "windows" says that the map is
    partitioned windows ``(B * nW, ws, ws, 3C)``."""
    _build.require_cuda("qkv", qkv, torch.bfloat16)
    if qkv.dim() != 4:
        raise ValueError(f"qkv: expected (B, H, W, 3C), got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    hd = check_window_layout(B, H, W, C3, num_heads, ws, layout, _build.ptr(qkv))
    if tuple(Rh.shape) != (ws, ws, hd) or tuple(Rw.shape) != (ws, ws, hd):
        raise ValueError(f"Rh/Rw: expected ({ws}, {ws}, {hd})")
    rh, rw = _fp32_table(Rh, qkv.device), _fp32_table(Rw, qkv.device)
    lib = _build.library()
    smem, limit = lib.samrs_window_attention_smem(hd), _smem_limit(qkv.device)
    if smem > limit:
        raise ValueError(f"window kernel at head_dim {hd} needs {smem} B of shared memory, "
                         f"the device allows {limit}")
    Hp, Wp = _padded_hw(H, W, ws)
    Ho, Wo = (Hp, Wp) if padded else (H, W)
    bias = None if bqkv is None else gemm._bf16_weight(bqkv, qkv.device)
    rel = torch.empty(B * num_heads * (Hp // ws) * (Wp // ws) * ws * ws * REL_TERMS,
                      device=qkv.device, dtype=torch.float32)
    attn = torch.empty(B, Ho, Wo, C, device=qkv.device, dtype=torch.bfloat16)
    _build.launch("samrs_window_attention", _build.ptr(qkv), _build.ptr(bias), _build.ptr(rh),
                  _build.ptr(rw), _build.ptr(rel), _build.ptr(attn), B, H, W, Ho, Wo, C,
                  num_heads, hd, ws, _LAYOUT_CODE[layout], _ORDER_CODE[order], float(scale))
    return attn


def window_layer_cuda(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int, scale: float,
                      num_heads: int, residual=None, variant=None, return_padded: bool = False):
    """The hand-written kernels on a bf16 CUDA map ``xn (B, H, W, C)`` -> bf16;
    with an fp32 `residual` the proj GEMM adds it and writes fp32; with
    `return_padded` the attention and the proj GEMM cover the padded map."""
    global launches
    order = _check_layer_args(variant, residual, return_padded)
    _build.require_cuda("xn", xn, torch.bfloat16)
    if xn.dim() != 4:
        raise ValueError(f"xn: expected (B, H, W, C), got {tuple(xn.shape)}")
    B, H, W, C = xn.shape
    qkv = gemm.linear(xn.reshape(-1, C), Wqkv, bqkv).reshape(B, H, W, 3 * C)
    attn = window_attention_cuda(qkv, bqkv, Rh, Rw, ws, scale, num_heads, order=order,
                                 padded=return_padded)
    res = None if residual is None else residual.reshape(-1, C)
    out = gemm.linear(attn.reshape(-1, C), Wproj, bproj,
                      residual=res).reshape(B, *attn.shape[1:3], C)
    launches += 1
    return out


def window_layer_attention(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int, scale: float,
                           num_heads: int, residual=None, variant=None,
                           return_padded: bool = False):
    """K1 on ``xn (B, H, W, C)`` -> ``(B, H, W, C)`` (plus `residual` if
    given; the padded ``(B, Hp, Wp, C)`` with `return_padded`) in the mode
    `variant`: the kernels for a CUDA tensor, the plain version for a CPU
    tensor."""
    args = (xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws, scale, num_heads)
    if not xn.is_cuda:
        return window_layer_plain(*args, residual=residual, variant=variant,
                                  return_padded=return_padded)
    return window_layer_cuda(*args, residual=residual, variant=variant,
                             return_padded=return_padded)


def window_layer_attention_residual(sc, xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int,
                                    scale: float, num_heads: int):
    """JAX ``window_layer_attention_residual`` (``block2``): ``sc`` + K1 on
    ``xn``, the residual added in the projection's epilogue (the residual
    stream's dtype out)."""
    return window_layer_attention(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws, scale, num_heads,
                                  residual=sc)
