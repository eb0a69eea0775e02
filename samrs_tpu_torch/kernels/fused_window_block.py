"""K1's attention stage on the raw qkv map (``window_attn_impl="fused2"``):
windows read straight from the unpartitioned ``(B, H, W, 3C)`` qkv map, the
output written back unpartitioned, pad tokens filled from the qkv bias.

Replaces samrs_tpu/kernels/fused_window_block.py::
window_attention_partition_free (Pallas call ``_pallas``, :246).  K1's
attention kernel (csrc/window_attention.cu) computes exactly this function
(its qkv and proj GEMMs are separate launches), so on a CUDA tensor the
wrapper launches that kernel alone, in plain window order; on a CPU tensor
it runs its plain version.
"""

from __future__ import annotations

from samrs_tpu_torch.kernels import fused_window_layer

launches = 0  # CUDA launches of this mode (one per wrapper call)


def window_attention_partition_free_plain(qkv_raw, Rh, Rw, ws: int, scale: float,
                                          num_heads: int, pad_fill=None):
    """Plain version: ``qkv_raw (B, H, W, 3C)``, pad tokens filled with
    `pad_fill` (the qkv bias row; zero if None) -> ``(B, H, W, C)`` in
    qkv's dtype."""
    return fused_window_layer.window_attention_plain(qkv_raw, pad_fill, Rh, Rw, ws, scale,
                                                     num_heads)


def window_attention_partition_free(qkv_raw, Rh, Rw, ws: int, scale: float, num_heads: int,
                                    pad_fill=None):
    """JAX ``window_attention_partition_free``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    global launches
    if not qkv_raw.is_cuda:
        return window_attention_partition_free_plain(qkv_raw, Rh, Rw, ws, scale, num_heads,
                                                     pad_fill)
    out = fused_window_layer.window_attention_cuda(qkv_raw, pad_fill, Rh, Rw, ws, scale,
                                                   num_heads)
    launches += 1
    return out
