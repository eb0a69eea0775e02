"""K6: the mask decoder's upscaling tail, fused with the hypernetwork dot.

Replaces samrs_tpu/kernels/fused_upscale.py::fused_upscale_hyper (Pallas call
``_fused_pallas``): ConvTranspose2d(2, 2) -> LayerNorm2d (eps 1e-6) -> exact
GELU -> ConvTranspose2d(2, 2) -> exact GELU -> dot with the hypernetwork
vector of each requested mask token, giving (B, M, 4h, 4w) fp32 logits.

On a CUDA tensor the wrapper launches the hand-written kernel of
csrc/upscale.cu (bf16 operands of the two products, fp32 accumulation and
statistics, the hypernetwork dot in fp32; tensor cores and device-memory
bytes about level, see the source).  On a CPU tensor
it runs the plain version.  Weights stay in ``nn.ConvTranspose2d``'s layout
(in, out, kh, kw): ``out[2h+i, 2w+j, d] = sum_c x[h, w, c] W[c, d, i, j] +
b[d]``, no kernel flip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from samrs_tpu_torch.kernels import _build

launches = 0  # CUDA launches of this kernel (one per wrapper call)

LN_EPS = 1e-6
_TILE = 32   # source pixels per tile of the kernel
_MAX_M = 4   # mask tokens the kernel takes per call


def upscale_hyper_plain(src, w1, b1, ln_w, ln_b, w2, b2, hyper, dtype=torch.float32):
    """Plain version with the kernel's numerics: the two convolution products
    on operands rounded to `dtype` with fp32 accumulation; LayerNorm2d
    (two-pass, fp32), GELU and the hypernetwork dot in fp32.  src (B, h, w,
    C), hyper (B, M, C2) -> (B, M, 4h, 4w) fp32."""
    B, h, w, _ = src.shape
    M = hyper.shape[1]
    rd = lambda t: t.to(dtype).float()
    up = torch.einsum("bhwc,cdij->bhwijd", rd(src), rd(w1)) + b1.float()
    mu = up.mean(-1, keepdim=True)
    var = ((up - mu) ** 2).mean(-1, keepdim=True)
    up = F.gelu((up - mu) * torch.rsqrt(var + LN_EPS) * ln_w.float() + ln_b.float())
    up = torch.einsum("bhwijd,dekl->bhwijkle", rd(up), rd(w2)) + b2.float()
    up = F.gelu(up)
    masks = torch.einsum("bme,bhwijkle->bmhwijkl", hyper.float(), up)
    # (b, m, h, w, i, j, k, l) -> (b, m, 4h + 2i + k, 4w + 2j + l)
    return masks.permute(0, 1, 2, 4, 6, 3, 5, 7).reshape(B, M, 4 * h, 4 * w)


def upscale_hyper_cuda(src, w1, b1, ln_w, ln_b, w2, b2, hyper):
    """The hand-written kernel on a bf16 CUDA ``src (B, h, w, C)``."""
    global launches
    _build.require_cuda("src", src, torch.bfloat16)
    if src.dim() != 4:
        raise ValueError(f"src: expected (B, h, w, C), got {tuple(src.shape)}")
    B, h, w, C = src.shape
    C1, C2 = w1.shape[1], w2.shape[1]
    M = hyper.shape[1]
    if (C, C1, C2) != (256, 64, 32):
        raise ValueError(f"the upscale kernel is built for C 256 -> 64 -> 32, got {C} -> {C1} -> {C2}")
    if tuple(w1.shape) != (C, C1, 2, 2) or tuple(w2.shape) != (C1, C2, 2, 2):
        raise ValueError(f"w1/w2: expected ({C}, {C1}, 2, 2) / ({C1}, {C2}, 2, 2)")
    if (h * w) % _TILE or not 1 <= M <= _MAX_M or tuple(hyper.shape) != (B, M, C2):
        raise ValueError(f"upscale kernel needs h*w % {_TILE} == 0 and hyper (B, 1..{_MAX_M}, {C2}), "
                         f"got hw=({h}, {w}), hyper {tuple(hyper.shape)}")
    dev = src.device
    bf = dict(device=dev, dtype=torch.bfloat16)
    f32 = dict(device=dev, dtype=torch.float32)
    # rows (2i + j) * C1 + d and (2k + l) * C2 + e, columns the input channel
    w1r = w1.permute(2, 3, 1, 0).reshape(4 * C1, C).to(**bf).contiguous()
    w2r = w2.permute(2, 3, 1, 0).reshape(4 * C2, C1).to(**bf).contiguous()
    vecs = [t.to(**f32).contiguous() for t in (b1, ln_w, ln_b, b2)]
    hy = hyper.to(**f32).contiguous()
    out = torch.empty(B, M, 4 * h, 4 * w, **f32)
    p = _build.ptr
    _build.launch("samrs_upscale_hyper", p(src), p(w1r), p(vecs[0]), p(vecs[1]), p(vecs[2]),
                  p(w2r), p(vecs[3]), p(hy), p(out), B, h, w, M, LN_EPS)
    launches += 1
    return out


def upscale_hyper(src, w1, b1, ln_w, ln_b, w2, b2, hyper, dtype=torch.bfloat16):
    """K6: the kernel for a CUDA tensor (bf16 operands), the plain version in
    `dtype` for a CPU tensor."""
    if not src.is_cuda:
        return upscale_hyper_plain(src, w1, b1, ln_w, ln_b, w2, b2, hyper, dtype)
    if dtype != torch.bfloat16:
        raise ValueError(f"the upscale kernel computes in bfloat16, got dtype {dtype}")
    return upscale_hyper_cuda(src, w1, b1, ln_w, ln_b, w2, b2, hyper)
