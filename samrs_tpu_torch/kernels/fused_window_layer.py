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

Weights use torch's ``nn.Linear`` layout: Wqkv (3C, C), Wproj (C, C).
``Rh``/``Rw`` are the gathered ``(ws, ws, head_dim)`` tables of ``get_rel_pos``.
"""

from __future__ import annotations

import torch

from samrs_tpu_torch.kernels import _build, flash_attention, gemm
from samrs_tpu_torch.nn.layers import window_partition, window_unpartition

launches = 0  # CUDA launches of this kernel (one per wrapper call)

_HEAD_DIMS = (64, 80)  # instantiated in csrc/window_attention.cu
_WINDOW = 14  # SAM's window, the kernel's compile-time size


def window_attention_plain(qkv, bqkv, Rh, Rw, ws: int, scale: float, num_heads: int):
    """The attention stage on the ``(B, H, W, 3C)`` qkv map, in its dtype:
    the map's pad tokens carry the qkv bias (what the zero-padded normed map
    gives them), attention in fp32 with the probabilities rounded as the
    kernel's online softmax rounds them -> ``(B, H, W, C)``."""
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    dt = qkv.dtype
    nH, hd = num_heads, C // num_heads
    Hp, Wp = -(-H // ws) * ws, -(-W // ws) * ws
    if (Hp, Wp) != (H, W):
        fill = torch.zeros(C3, dtype=dt, device=qkv.device) if bqkv is None else bqkv.to(dt)
        padded = fill.expand(B, Hp, Wp, C3).clone()
        padded[:, :H, :W] = qkv
        qkv = padded
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
    return window_unpartition(o, ws, (Hp, Wp), (H, W))


def window_layer_plain(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int, scale: float,
                       num_heads: int, residual=None):
    """Plain PyTorch version in xn's dtype, following the JAX oracle
    ``window_layer_xla``; with `residual`, ``residual + layer`` in the
    residual's dtype.  It rounds where the kernels round: each projection
    once after its fp32 bias (and residual), the probabilities as the online
    softmax does."""
    B, H, W, C = xn.shape
    qkv = gemm.linear_plain(xn.reshape(-1, C), Wqkv, bqkv).reshape(B, H, W, 3 * C)
    o = window_attention_plain(qkv, bqkv, Rh, Rw, ws, scale, num_heads)
    res = None if residual is None else residual.reshape(-1, C)
    return gemm.linear_plain(o.reshape(-1, C), Wproj, bproj, residual=res).reshape(B, H, W, C)


def window_attention_cuda(qkv, bqkv, Rh, Rw, ws: int, scale: float, num_heads: int):
    """The attention stage's kernel on a bf16 CUDA qkv map ``(B, H, W, 3C)``
    -> ``(B, H, W, C)`` bf16."""
    _build.require_cuda("qkv", qkv, torch.bfloat16)
    if qkv.dim() != 4:
        raise ValueError(f"qkv: expected (B, H, W, 3C), got {tuple(qkv.shape)}")
    B, H, W, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    if 3 * C != C3 or hd * num_heads != C or hd not in _HEAD_DIMS:
        raise ValueError(f"window kernel supports head_dim in {_HEAD_DIMS}, got C={C}, heads={num_heads}")
    if ws != _WINDOW:
        raise ValueError(f"window kernel is built for window {_WINDOW}, got {ws}")
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
    bias = None if bqkv is None else bqkv.to(device=qkv.device, dtype=torch.bfloat16).contiguous()
    attn = torch.empty(B, H, W, C, device=qkv.device, dtype=torch.bfloat16)
    _build.launch("samrs_window_attention", _build.ptr(qkv), _build.ptr(bias), _build.ptr(rh),
                  _build.ptr(rw), _build.ptr(attn), B, H, W, C, num_heads, hd, ws, float(scale))
    return attn


def window_layer_cuda(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int, scale: float,
                      num_heads: int, residual=None):
    """The hand-written kernels on a bf16 CUDA map ``xn (B, H, W, C)`` -> bf16;
    with an fp32 `residual` the proj GEMM adds it and writes fp32."""
    global launches
    _build.require_cuda("xn", xn, torch.bfloat16)
    if xn.dim() != 4:
        raise ValueError(f"xn: expected (B, H, W, C), got {tuple(xn.shape)}")
    B, H, W, C = xn.shape
    qkv = gemm.linear(xn.reshape(-1, C), Wqkv, bqkv).reshape(B, H, W, 3 * C)
    attn = window_attention_cuda(qkv, bqkv, Rh, Rw, ws, scale, num_heads)
    res = None if residual is None else residual.reshape(-1, C)
    out = gemm.linear(attn.reshape(-1, C), Wproj, bproj, residual=res).reshape(B, H, W, C)
    launches += 1
    return out


def window_layer_attention(xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws: int, scale: float,
                           num_heads: int, residual=None):
    """K1 on ``xn (B, H, W, C)`` -> ``(B, H, W, C)`` (plus `residual` if
    given): the kernels for a CUDA tensor, the plain version for a CPU
    tensor."""
    args = (xn, Wqkv, bqkv, Wproj, bproj, Rh, Rw, ws, scale, num_heads)
    if not xn.is_cuda:
        return window_layer_plain(*args, residual=residual)
    return window_layer_cuda(*args, residual=residual)
