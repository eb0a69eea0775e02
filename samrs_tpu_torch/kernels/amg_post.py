"""K7: full-resolution mask postprocess of a chunk of low-res logits.

Replaces samrs_tpu/kernels/amg_post.py::amg_postprocess: the bilinear
postprocess chain (g -> img_size, crop to the resized input, -> original
size; torch ``align_corners=False`` semantics) composed into one banded
matrix per axis, then threshold, hi/lo stability counts, the tight box and
np.packbits-order bit rows.  Returns (hi (M,) int32, lo (M,) int32, boxes
(M, 4) int32 inclusive xyxy, zeros when empty, packed (M, H, ceil(W/8))
uint8).

On a CUDA tensor the wrapper launches the hand-written kernel of
csrc/amg_post.cu (a cluster of 8 blocks a mask, each a band of output rows
whose input rows arrive by one bulk copy; the row and column tables in
shared memory where they fit, else read from global memory (an original
width above ~6000 at g 256); banded sums in fp32; the final stats reduced
across the cluster): one allocation and one launch a call.  On
a CPU tensor it runs the plain version, two dense fp32 matmuls as the TPU
kernel's oracle does.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from samrs_tpu_torch.kernels import _build

launches = 0  # CUDA launches of this kernel (one per wrapper call)

TAPS = 4  # band width per axis that csrc/amg_post.cu takes
BANDS = 8  # blocks of the kernel's cluster for one mask, each ceil(H / BANDS) output rows
WARPS = 16  # warps of a block
STAGE_BYTES = 32768  # packed-bit staging of one chunk of a band's rows
SMEM_MAX = 232448  # an H100 block's dynamic shared memory
_BIT_WEIGHTS = (128, 64, 32, 16, 8, 4, 2, 1)  # np.packbits order


@functools.lru_cache(maxsize=None)
def _axis_matrix(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) fp32 bilinear resample matrix, half-pixel centres,
    edge-clipped (torch align_corners=False, antialias=False); a copy of
    samrs_tpu/nn/interpolate.py::_axis_matrix."""
    scale = in_size / out_size
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * scale - 0.5
    src = np.clip(src, 0.0, in_size - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    w = (src - lo).astype(np.float32)
    m = np.zeros((out_size, in_size), np.float32)
    np.add.at(m, (np.arange(out_size), lo), 1.0 - w)
    np.add.at(m, (np.arange(out_size), hi), w)
    return m


@functools.lru_cache(maxsize=None)
def _composed_axis(g: int, img_size: int, inp: int, out: int) -> np.ndarray:
    """(out, g) fp32: resize g -> img_size, crop [:inp], resize inp -> out,
    composed in float64 (a copy of samrs_tpu/kernels/amg_post.py's).  For
    inp == out == img_size the second stage is the identity."""
    a = _axis_matrix(g, img_size)[:inp]
    if inp == out and img_size == inp:
        return np.ascontiguousarray(a)
    b = _axis_matrix(inp, out)
    return (b.astype(np.float64) @ a.astype(np.float64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _band(g: int, img_size: int, inp: int, out: int) -> Tuple[np.ndarray, np.ndarray]:
    """The composed matrix as (start (out,) int32, weights (out, TAPS) fp32):
    row r is weights[r] on inputs start[r] .. start[r] + TAPS - 1."""
    m = _composed_axis(g, img_size, inp, out)
    nz = m != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), g - 1 - nz[:, ::-1].argmax(1), 0)
    if (last - first).max(initial=0) >= TAPS:
        raise ValueError(f"postprocess band wider than {TAPS} taps for g={g}, "
                         f"img_size={img_size}, {inp} -> {out}")
    start = np.minimum(first, g - TAPS)
    cols = start[:, None] + np.arange(TAPS)
    return start.astype(np.int32), np.take_along_axis(m, cols, 1).astype(np.float32)


@functools.lru_cache(maxsize=64)  # image sizes vary across a DOTA or FAIR1M run
def _device_band(g: int, img_size: int, inp: int, out: int, device: torch.device):
    """``_band`` as device tensors, uploaded once per shape and device."""
    return tuple(torch.from_numpy(a).to(device) for a in _band(g, img_size, inp, out))


@functools.lru_cache(maxsize=None)
def _band_rows(g: int, img_size: int, inp: int, out: int) -> int:
    """The most input rows that one of the kernel's BANDS bands of
    ceil(out / BANDS) output rows reads: the rows it brings into shared
    memory with one copy (the bands' starts never decrease)."""
    start, _ = _band(g, img_size, inp, out)
    if (np.diff(start) < 0).any():
        raise ValueError(f"postprocess band starts decrease for g={g}, img_size={img_size}, "
                         f"{inp} -> {out}")
    R = -(-out // BANDS)
    return max(int(start[min(r0 + R, out) - 1]) + TAPS - int(start[r0]) for r0 in range(0, out, R))


@functools.lru_cache(maxsize=None)
def _smem_layout(g: int, Ho: int, Wo: int, max_rows: int) -> Tuple[int, bool]:
    """(shared-memory bytes of one block, row and column tables in shared
    memory) for csrc/amg_post.cu's PostLayout, which this mirrors: the tables
    (20 bytes a column, 20 a band row) move to global memory when the block
    would outgrow SMEM_MAX with them."""
    up = lambda x, n: -(-x // n) * n
    R, Wp = -(-Ho // BANDS), -(-Wo // 8)
    RC = min(max(STAGE_BYTES // Wp, 1), R)
    total = 0
    for tables in (True, False):
        Wo4, Rt = (up(Wo, 4), R) if tables else (0, 0)
        L = up(16 + WARPS * 6 * 4 + 6 * 4, 128)
        V = up(L + max_rows * g * 4, 16)
        x = up(V + WARPS * g * 4, 16)
        y = up(up(x + Wo4 * 4, 16) + Wo4 * 16, 16)
        P = up(up(y + Rt * 4, 16) + Rt * 16, 16)
        total = up(P + 16 + RC * Wp, 16)
        if total <= SMEM_MAX:
            return total, tables
    return total, False


def packbits2d(m: torch.Tensor) -> torch.Tensor:
    """(..., W) bool -> (..., ceil(W/8)) uint8 in np.packbits bit order."""
    W = m.shape[-1]
    pad = (-W) % 8
    if pad:
        m = torch.nn.functional.pad(m, (0, pad))
    bits = m.reshape(*m.shape[:-1], (W + pad) // 8, 8).to(torch.int32)
    weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int32, device=m.device)
    return (bits * weights).sum(-1).to(torch.uint8)


def _boxes_from_masks(mb: torch.Tensor) -> torch.Tensor:
    """(M, H, W) bool -> (M, 4) int32 inclusive xyxy, zeros when empty."""
    M, H, W = mb.shape
    ys, xs = mb.any(-1), mb.any(-2)
    top = ys.int().argmax(-1)
    bot = H - 1 - ys.flip(-1).int().argmax(-1)
    left = xs.int().argmax(-1)
    right = W - 1 - xs.flip(-1).int().argmax(-1)
    boxes = torch.stack([left, top, right, bot], -1).to(torch.int32)
    return torch.where(ys.any(-1)[:, None], boxes, torch.zeros_like(boxes))


def amg_postprocess_plain(lowres, input_size, original_size, img_size: int,
                          mask_threshold: float, offset: float):
    """Plain version: the composed resample as two dense fp32 matmuls (as the
    TPU kernel's HIGHEST-precision ones), then the statistics in torch."""
    M, g, _ = lowres.shape
    Ho, Wo = int(original_size[0]), int(original_size[1])
    dev = lowres.device
    wy = torch.from_numpy(_composed_axis(g, img_size, int(input_size[0]), Ho)).to(dev)
    wx = torch.from_numpy(_composed_axis(g, img_size, int(input_size[1]), Wo)).to(dev)
    out = (wy @ lowres.float()) @ wx.T
    hi = (out > mask_threshold + offset).sum((-1, -2), dtype=torch.int32)
    lo = (out > mask_threshold - offset).sum((-1, -2), dtype=torch.int32)
    mb = out > mask_threshold
    return hi, lo, _boxes_from_masks(mb), packbits2d(mb)


def amg_postprocess_cuda(lowres, input_size, original_size, img_size: int,
                         mask_threshold: float, offset: float):
    """The hand-written kernel on a CUDA fp32 ``lowres (M, g, g)``."""
    global launches
    _build.require_cuda("lowres", lowres, torch.float32)
    if lowres.dim() != 3 or lowres.shape[1] != lowres.shape[2]:
        raise ValueError(f"lowres: expected (M, g, g), got {tuple(lowres.shape)}")
    M, g, _ = lowres.shape
    if g % 4:
        raise ValueError(f"lowres: the kernel takes g % 4 == 0 (16-byte rows), got g={g}")
    Ho, Wo = int(original_size[0]), int(original_size[1])
    inp = (int(input_size[0]), int(input_size[1]))
    dev = lowres.device
    y0, wy = _device_band(g, img_size, inp[0], Ho, dev)
    x0, wx = _device_band(g, img_size, inp[1], Wo, dev)
    rows = _band_rows(g, img_size, inp[0], Ho)
    if _smem_layout(g, Ho, Wo, rows)[0] > SMEM_MAX:
        raise ValueError(f"postprocess to {Ho}x{Wo} from g={g} outgrows a block's shared memory")
    # one allocation: the packed bits, then (16-byte aligned) the (M, 6) int32 stats
    n_bits = M * Ho * ((Wo + 7) // 8)
    n_pad = -(-n_bits // 16) * 16
    buf = torch.empty(n_pad + M * 6 * 4, device=dev, dtype=torch.uint8)
    packed = buf[:n_bits].view(M, Ho, (Wo + 7) // 8)
    stats = buf[n_pad:].view(torch.int32).view(M, 6)
    p = _build.ptr
    _build.launch("samrs_amg_post", p(lowres), p(y0), p(wy), p(x0), p(wx), p(packed), p(stats),
                  M, g, Ho, Wo, rows, float(mask_threshold), float(offset))
    launches += 1
    return stats[:, 0], stats[:, 1], stats[:, 2:6], packed


def amg_postprocess(lowres, input_size, original_size, img_size: int,
                    mask_threshold: float, offset: float):
    """K7 on ``lowres (M, g, g)``: the kernel for a CUDA tensor, the plain
    version for a CPU tensor."""
    if not lowres.is_cuda:
        return amg_postprocess_plain(lowres, input_size, original_size, img_size,
                                     mask_threshold, offset)
    return amg_postprocess_cuda(lowres, input_size, original_size, img_size,
                                mask_threshold, offset)
