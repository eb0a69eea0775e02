"""K4 and K5: the image side of the two-way transformer decode.

K4 ``t2i_kv_proj`` replaces samrs_tpu/kernels/fused_twoway.py::t2i_kv_proj
(Pallas call ``_t2i_kv_pallas``): one pass over the batch-1 keys emitting
the token->image attention's K = (keys + pe) Wk^T + bk and V = keys Wv^T + bv.

K5 ``i2t_update`` replaces ::i2t_update (Pallas call ``_i2t_pallas``): one
pass per two-way layer fusing the q-projection of keys + pe, 8-head
attention over the padded token slots (a multiple of 16; pad slots carry a
-1e9 bias), the out-projection, residual, norm4 LayerNorm and the next
attention's K/V projections.  With batch-1 keys and B prompts (layer 0 of a
box decode) the keys are shared and read once per row tile.

On a CUDA tensor both launch the hand-written kernels of csrc/twoway.cu
(bf16 operands, fp32 accumulation; bound by device-memory bytes, see the
source): their projections run on wgmma, their weights arrive by TMA
(``check_kv_layout`` and ``check_i2t_layout`` state what they take).  The
wrappers keep one bf16 copy of each weight and one fp32 copy of each vector
per parameter version (``gemm._cached_copy``).  On a CPU tensor they run the plain versions.
Weights use torch's ``nn.Linear`` layout (out, in).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from samrs_tpu_torch.kernels import _build, gemm

NT = 16  # token slots per block (box prompts fill 7: iou + 4 mask tokens + 2 corners)
ROW_TILE = 64  # image rows of a K5 tile: N must be a multiple
KV_ROW_TILE = 32  # image rows of a K4 block (128 blocks at N 4096): N must be a multiple
KV_MAX_TILES = 65535  # K4's row tiles of an image (a grid dimension)
C_KERNEL, CI_KERNEL, HEADS_KERNEL = 256, 128, 8  # widths csrc/twoway.cu is built for

kv_launches = 0   # CUDA launches of K4 (one per wrapper call)
i2t_launches = 0  # CUDA launches of K5 (one per wrapper call)


def _dot(a, w, dtype):
    """a @ w^T with both operands rounded to `dtype` and fp32 accumulation
    (the JAX oracle's ``_dot`` with preferred_element_type=float32)."""
    return F.linear(a.to(dtype).float(), w.to(dtype).float())


def t2i_kv_proj_plain(keys, key_pe, Wk, bk, Wv, bv, dtype=torch.float32):
    """Plain version, following ``t2i_kv_proj_xla``.  keys (B, N, C) fp32,
    key_pe (N, C) -> (k, v) each (B, N, Ci) in `dtype`."""
    k = _dot(keys + key_pe, Wk, dtype) + bk.float()
    v = _dot(keys, Wv, dtype) + bv.float()
    return k.to(dtype), v.to(dtype)


def i2t_update_plain(keys, key_pe, tok_k, tok_v, mask_bias, Wq, bq, Wout, bout, g4, b4,
                     Wk_n, bk_n, Wv_n, bv_n, num_heads, dtype=torch.float32, eps=1e-5,
                     out_dtype=torch.float32):
    """Plain version, following ``i2t_update_xla``.

    keys (1 or B, N, C) fp32; tok_k / tok_v (B, S, Ci) padded token K/V;
    mask_bias (S,) additive logit bias.  Returns (keys2 (B, N, C) in
    out_dtype, k_next, v_next (B, N, Ci) in `dtype`).  The attention and the
    LayerNorm statistics are fp32; the LayerNorm variance is two-pass."""
    B, S, Ci = tok_k.shape
    keys = keys.expand(B, -1, -1)
    N = keys.shape[1]
    hd = Ci // num_heads
    q = _dot(keys + key_pe, Wq, dtype) + bq.float()
    qh = q.reshape(B, N, num_heads, hd).transpose(1, 2)
    kh = tok_k.float().reshape(B, S, num_heads, hd).transpose(1, 2)
    vh = tok_v.float().reshape(B, S, num_heads, hd).transpose(1, 2)
    s = qh @ kh.transpose(-1, -2) / hd ** 0.5 + mask_bias.float()
    o = (s.softmax(-1) @ vh).transpose(1, 2).reshape(B, N, Ci)
    res = keys + _dot(o, Wout, dtype) + bout.float()
    mu = res.mean(-1, keepdim=True)
    var = ((res - mu) ** 2).mean(-1, keepdim=True)
    keys2 = (res - mu) / torch.sqrt(var + eps) * g4.float() + b4.float()
    k_n = _dot(keys2 + key_pe, Wk_n, dtype) + bk_n.float()
    v_n = _dot(keys2, Wv_n, dtype) + bv_n.float()
    return keys2.to(out_dtype), k_n.to(dtype), v_n.to(dtype)


def check_i2t_layout(B: int, N: int, C: int, S: int, num_heads: int, keys_batch: int,
                     pointers=()) -> None:
    """Raise ValueError unless K5 takes ``keys (keys_batch, N, C)`` with
    ``(B, S, Ci)`` token K / V of `num_heads` heads: the widths it is built
    for (C 256, Ci 128, 8 heads), N a multiple of the 64-row tile, S a
    positive multiple of the 16-slot block, keys of batch 1 or B, and every
    pointer (the four bf16 weights, which arrive by TMA, and the fp32
    tensors; device addresses as ints) 16-byte aligned."""
    if C != C_KERNEL or num_heads != HEADS_KERNEL:
        raise ValueError(f"the i2t kernel is built for C={C_KERNEL} and {HEADS_KERNEL} heads, "
                         f"got C={C}, heads={num_heads}")
    if B <= 0 or N <= 0 or N % ROW_TILE:
        raise ValueError(f"the i2t kernel needs N % {ROW_TILE} == 0, got N={N} (B={B})")
    if S <= 0 or S % NT:
        raise ValueError(f"token slots must be a positive multiple of {NT}, got {S}")
    if keys_batch not in (1, B):
        raise ValueError(f"keys batch {keys_batch} is neither 1 nor the token batch {B}")
    for p in pointers:
        if p is not None and p % gemm.TMA_ALIGN:
            raise ValueError(f"the i2t kernel's operands must be {gemm.TMA_ALIGN}-byte aligned "
                             f"(TMA), got address {p:#x}")


def _weight(w, shape, device):
    if tuple(w.shape) != shape:
        raise ValueError(f"weight: expected {shape}, got {tuple(w.shape)}")
    return gemm._bf16_weight(w, device)


def _vec(v, n, device):
    if tuple(v.shape) != (n,):
        raise ValueError(f"bias / scale: expected ({n},), got {tuple(v.shape)}")
    return gemm._cached_copy(v, device, torch.float32)


def _check_image_side(keys, key_pe, tile=ROW_TILE):
    _build.require_cuda("keys", keys, torch.float32)
    if keys.dim() != 3 or keys.shape[2] != C_KERNEL or keys.shape[1] % tile:
        raise ValueError(f"keys: expected (B, N, {C_KERNEL}) with N % {tile} == 0, "
                         f"got {tuple(keys.shape)}")
    _build.require_cuda("key_pe", key_pe, torch.float32, (keys.shape[1], C_KERNEL))


def check_kv_layout(B: int, N: int, pointers=()) -> None:
    """Raise ValueError unless K4 takes ``keys (B, N, 256)``: N a positive
    multiple of its 32-row block (at most 65535 blocks an image), and every
    pointer (the two bf16 weights, which arrive by TMA, the keys and pe,
    read in 16-byte loads; device addresses as ints) 16-byte aligned."""
    if B <= 0 or N <= 0 or N % KV_ROW_TILE or N // KV_ROW_TILE > KV_MAX_TILES:
        raise ValueError(f"the K/V kernel needs N a positive multiple of {KV_ROW_TILE} (at most "
                         f"{KV_MAX_TILES} tiles), got N={N} (B={B})")
    for p in pointers:
        if p is not None and p % gemm.TMA_ALIGN:
            raise ValueError(f"the K/V kernel's operands must be {gemm.TMA_ALIGN}-byte aligned, "
                             f"got address {p:#x}")


def t2i_kv_proj_cuda(keys, key_pe, Wk, bk, Wv, bv):
    """K4 on CUDA fp32 ``keys (B, N, 256)`` -> bf16 (k, v) each (B, N, 128)."""
    global kv_launches
    _check_image_side(keys, key_pe, KV_ROW_TILE)
    B, N, C = keys.shape
    dev = keys.device
    wk, wv = _weight(Wk, (CI_KERNEL, C), dev), _weight(Wv, (CI_KERNEL, C), dev)
    bk_, bv_ = _vec(bk, CI_KERNEL, dev), _vec(bv, CI_KERNEL, dev)
    p = _build.ptr
    check_kv_layout(B, N, (p(wk), p(wv), p(keys), p(key_pe)))
    k = torch.empty(B, N, CI_KERNEL, device=dev, dtype=torch.bfloat16)
    v = torch.empty_like(k)
    _build.launch("samrs_t2i_kv", p(keys), p(key_pe), p(wk), p(bk_), p(wv), p(bv_), p(k), p(v),
                  B, N)
    kv_launches += 1
    return k, v


def i2t_update_cuda(keys, key_pe, tok_k, tok_v, mask_bias, Wq, bq, Wout, bout, g4, b4,
                    Wk_n, bk_n, Wv_n, bv_n, num_heads, eps=1e-5, out_dtype=torch.float32):
    """K5 on CUDA: keys (1 or B, N, 256) fp32, tok_k / tok_v (B, S, 128), S a
    multiple of 16 -> (keys2 (B, N, 256) in out_dtype (fp32 or bf16), k_next,
    v_next bf16)."""
    global i2t_launches
    _check_image_side(keys, key_pe)
    B, S = tok_k.shape[:2]
    _, N, C = keys.shape
    _build.require_cuda("tok_k", tok_k, torch.float32, (B, S, CI_KERNEL))
    _build.require_cuda("tok_v", tok_v, torch.float32, (B, S, CI_KERNEL))
    _build.require_cuda("mask_bias", mask_bias, torch.float32, (S,))
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    dev = keys.device
    wq, wo = _weight(Wq, (CI_KERNEL, C), dev), _weight(Wout, (C, CI_KERNEL), dev)
    wk, wv = _weight(Wk_n, (CI_KERNEL, C), dev), _weight(Wv_n, (CI_KERNEL, C), dev)
    bq_, bo_ = _vec(bq, CI_KERNEL, dev), _vec(bout, C, dev)
    g4_, b4_ = _vec(g4, C, dev), _vec(b4, C, dev)
    bk_, bv_ = _vec(bk_n, CI_KERNEL, dev), _vec(bv_n, CI_KERNEL, dev)
    p = _build.ptr
    check_i2t_layout(B, N, C, S, num_heads, keys.shape[0],
                     (p(wq), p(wo), p(wk), p(wv), p(keys), p(key_pe), p(tok_k), p(tok_v)))
    keys2 = torch.empty(B, N, C, device=dev, dtype=out_dtype)
    k = torch.empty(B, N, CI_KERNEL, device=dev, dtype=torch.bfloat16)
    v = torch.empty_like(k)
    shared = int(keys.shape[0] == 1 and B > 1)
    _build.launch("samrs_i2t_update", p(keys), p(key_pe), p(tok_k), p(tok_v), p(mask_bias),
                  p(wq), p(bq_), p(wo), p(bo_), p(g4_), p(b4_), p(wk), p(bk_), p(wv), p(bv_),
                  p(keys2), p(k), p(v), B, N, S, shared, int(out_dtype == torch.bfloat16),
                  float((CI_KERNEL // num_heads) ** -0.5), float(eps))
    i2t_launches += 1
    return keys2, k, v


def t2i_kv_proj(keys, key_pe, Wk, bk, Wv, bv, dtype=torch.bfloat16):
    """K4: the kernel for a CUDA tensor (bf16 operands and outputs), the plain
    version in `dtype` for a CPU tensor."""
    if not keys.is_cuda:
        return t2i_kv_proj_plain(keys, key_pe, Wk, bk, Wv, bv, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the K/V kernel computes in bfloat16, got dtype {dtype}")
    return t2i_kv_proj_cuda(keys, key_pe, Wk, bk, Wv, bv)


def i2t_update(keys, key_pe, tok_k, tok_v, mask_bias, Wq, bq, Wout, bout, g4, b4,
               Wk_n, bk_n, Wv_n, bv_n, num_heads, dtype=torch.bfloat16, eps=1e-5,
               out_dtype=torch.float32):
    """K5: the kernel for a CUDA tensor (bf16 operands), the plain version in
    `dtype` for a CPU tensor."""
    args = (keys, key_pe, tok_k, tok_v, mask_bias, Wq, bq, Wout, bout, g4, b4,
            Wk_n, bk_n, Wv_n, bv_n, num_heads)
    if not keys.is_cuda:
        return i2t_update_plain(*args, dtype=dtype, eps=eps, out_dtype=out_dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the i2t kernel computes in bfloat16, got dtype {dtype}")
    return i2t_update_cuda(*args, eps=eps, out_dtype=out_dtype)
