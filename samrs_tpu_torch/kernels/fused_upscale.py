"""K6: the mask decoder's upscaling tail, fused with the hypernetwork dot.

Replaces samrs_tpu/kernels/fused_upscale.py::fused_upscale_hyper (Pallas call
``_fused_pallas``): ConvTranspose2d(2, 2) -> LayerNorm2d (eps 1e-6) -> GELU
-> ConvTranspose2d(2, 2) -> GELU -> dot with the hypernetwork vector of each
requested mask token, giving (B, M, 4h, 4w) fp32 logits.  GELU's erf is the
TPU kernel's own, Abramowitz-Stegun 7.1.26 over exp (max abs error 1.5e-7;
``samrs_tpu/kernels/fused_mlp.py::_erf``), in the kernel and in the plain
version alike.

On a CUDA tensor the wrapper launches the hand-written kernel of
csrc/upscale.cu (both products on wgmma fed by TMA, bf16 operands with fp32
accumulation; LayerNorm, GELU and the hypernetwork dot in fp32 on the
registers; see the source); it converts the two weights to the kernel's
tap-major bf16 layout once per weight version (``gemm._cached_copy``) and
launches nothing else.  On a CPU tensor it runs the plain version.  Weights
stay in ``nn.ConvTranspose2d``'s layout (in, out, kh, kw): ``out[2h+i,
2w+j, d] = sum_c x[h, w, c] W[c, d, i, j] + b[d]``, no kernel flip.
"""

from __future__ import annotations

import torch

from samrs_tpu_torch.kernels import _build, gemm

launches = 0  # CUDA launches of this kernel (one per wrapper call)

LN_EPS = 1e-6
_TILE = 64   # source pixels per tile of the kernel
_MAX_M = 4   # mask tokens the kernel takes per call


def erf_as(y):
    """Abramowitz-Stegun 7.1.26 erf, max abs error 1.5e-7; a copy of
    samrs_tpu/kernels/fused_mlp.py::_erf, with its operations in the same
    order (so the same bits) but in place on two intermediates."""
    t = y.abs().mul_(0.3275911).add_(1.0).reciprocal_()
    poly = t * 1.061405429
    for c in (-1.453152027, 1.421413741, -0.284496736, 0.254829592):  # Horner
        poly.add_(c).mul_(t)
    return poly.mul_(torch.mul(y, y).neg_().exp_()).neg_().add_(1.0).mul_(torch.sign(y))


def gelu_as(x):
    """GELU over ``erf_as``: 0.5 x (1 + erf(x / sqrt 2))."""
    return erf_as(x * 0.7071067811865476).add_(1.0).mul_(x).mul_(0.5)


def _tap_major(w: torch.Tensor) -> torch.Tensor:
    """A ConvTranspose2d weight (in, out, 2, 2) as the kernel's (4 out, in)
    matrix, row (2i + j) * out + d."""
    return w.permute(2, 3, 1, 0).reshape(4 * w.shape[1], w.shape[0])


def upscale_hyper_plain(src, w1, b1, ln_w, ln_b, w2, b2, hyper, dtype=torch.float32):
    """Plain version with the kernel's numerics: the two convolution products
    on operands rounded to `dtype` with fp32 accumulation; LayerNorm2d
    (two-pass, fp32), GELU (``gelu_as``) and the hypernetwork dot in fp32.
    src (B, h, w, C), hyper (B, M, C2) -> (B, M, 4h, 4w) fp32."""
    B, h, w, _ = src.shape
    M = hyper.shape[1]
    rd = lambda t: t.to(dtype).float()
    up = torch.einsum("bhwc,cdij->bhwijd", rd(src), rd(w1)) + b1.float()
    mu = up.mean(-1, keepdim=True)
    var = ((up - mu) ** 2).mean(-1, keepdim=True)
    up = gelu_as((up - mu) * torch.rsqrt(var + LN_EPS) * ln_w.float() + ln_b.float())
    up = torch.einsum("bhwijd,dekl->bhwijkle", rd(up), rd(w2)) + b2.float()
    up = gelu_as(up)
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
    # rows (2i + j) * C1 + d and (2k + l) * C2 + e, columns the input channel, converted once
    # per weight version
    w1r, w2r = (gemm._cached_copy(t, dev, torch.bfloat16, _tap_major) for t in (w1, w2))
    vecs = [gemm._cached_copy(t, dev, torch.float32) for t in (b1, ln_w, ln_b, b2)]
    hy = hyper.to(device=dev, dtype=torch.float32).contiguous()
    out = torch.empty(B, M, 4 * h, 4 * w, device=dev, dtype=torch.float32)
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
