"""K1: a whole windowed attention layer of the encoder: zero-pad the normed
map to a multiple of the window, qkv projection, per window and head
``softmax(q.k^T * scale + q.Rh[x_q, x_k] + q.Rw[y_q, y_k]) v``, output
projection, crop; with ``residual`` the projection's epilogue also adds the
residual stream (fp32 on the card) and writes it.

Replaces samrs_tpu/kernels/fused_window_layer.py::window_layer_attention
(variant "ijb", Pallas call ``_pallas``).  On a CUDA tensor the wrapper runs
three hand-written kernels: the qkv GEMM on the unpadded tokens
(csrc/gemm.cu), the window attention (csrc/window_attention.cu), which
synthesises the map-pad tokens from the qkv bias, exactly what the zero-padded
map gives them, and masks the tile padding 196 -> 208, and the proj GEMM.
Bound on the H100: the two GEMMs are tensor-core bound; the attention is
bounded by shared-memory capacity per window (see the .cu note).  On a CPU
tensor it runs the plain version, which has the same three stages.

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


def _padded_hw(H: int, W: int, ws: int):
    return -(-H // ws) * ws, -(-W // ws) * ws


def window_attention_plain(qkv, bqkv, Rh, Rw, ws: int, scale: float, num_heads: int,
                           padded: bool = False):
    """The attention stage on the ``(B, H, W, 3C)`` qkv map, in its dtype:
    the map's pad tokens carry the qkv bias (what the zero-padded normed map
    gives them), attention in fp32 with the probabilities rounded as the
    kernel's online softmax rounds them -> ``(B, H, W, C)`` (the padded
    ``(B, Hp, Wp, C)`` with `padded`)."""
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
    o = flash_attention.online_softmax_v(s.reshape(-1, nH, n, n), v, dt)
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


def window_attention_cuda(qkv, bqkv, Rh, Rw, ws: int, scale: float, num_heads: int,
                          order: str = "plain", layout: str = "map", padded: bool = False):
    """The attention stage's kernel on a bf16 CUDA qkv map ``(B, H, W, 3C)``
    -> ``(B, H, W, C)`` bf16 (``(B, Hp, Wp, C)`` with `padded`).  `order`:
    "plain", "ijb" or "row"; `layout` "windows" says that the map is
    partitioned windows ``(B * nW, ws, ws, 3C)``."""
    _build.require_cuda("qkv", qkv, torch.bfloat16)
    if qkv.dim() != 4:
        raise ValueError(f"qkv: expected (B, H, W, 3C), got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if 3 * C != C3 or hd * num_heads != C or hd not in _HEAD_DIMS:
        raise ValueError(f"window kernel supports head_dim in {_HEAD_DIMS}, got C={C}, heads={num_heads}")
    if ws != WINDOW:
        raise ValueError(f"window kernel is built for window {WINDOW}, got {ws}")
    if tuple(Rh.shape) != (ws, ws, hd) or tuple(Rw.shape) != (ws, ws, hd):
        raise ValueError(f"Rh/Rw: expected ({ws}, {ws}, {hd})")
    # (x_q, x_k, d) -> (x_q, d, x_k): a half-warp reads one table row coalesced
    rh = Rh.to(device=qkv.device, dtype=torch.float32).transpose(1, 2).contiguous()
    rw = Rw.to(device=qkv.device, dtype=torch.float32).transpose(1, 2).contiguous()
    lib = _build.library()
    smem = lib.samrs_window_attention_smem(hd)
    limit = torch.cuda.get_device_properties(qkv.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"window kernel at head_dim {hd} needs {smem} B of shared memory, "
                         f"the device allows {limit}")
    if layout == "windows" and (H, W) != (ws, ws):
        raise ValueError(f"partitioned windows must be ({ws}, {ws}) tokens, got ({H}, {W})")
    Ho, Wo = _padded_hw(H, W, ws) if padded else (H, W)
    bias = None if bqkv is None else bqkv.to(device=qkv.device, dtype=torch.bfloat16).contiguous()
    attn = torch.empty(B, Ho, Wo, C, device=qkv.device, dtype=torch.bfloat16)
    _build.launch("samrs_window_attention", _build.ptr(qkv), _build.ptr(bias), _build.ptr(rh),
                  _build.ptr(rw), _build.ptr(attn), B, H, W, Ho, Wo, C, num_heads, hd, ws,
                  _LAYOUT_CODE[layout], _ORDER_CODE[order], float(scale))
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
