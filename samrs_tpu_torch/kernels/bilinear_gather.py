"""K8: weighted bilinear gather over absolute pixel coordinates, forward and
backward (the sampling core of RVSA's K/V windows, of MSDeformAttn and of
Mask2Former's shared point sample; later of DCNv3), and K9: the per-mask
single-channel point sample of Mask2Former's point losses.

    out[bg, p, :] = sum_k mask[bg, p, k] * bilinear(xg[bg], fy[bg, p, k], fx[bg, p, k])

with zero padding outside the map.  Replaces
samrs_tpu/kernels/bilinear_gather.py::_make_sampler: its forward
``pallas_call`` (``fwd_call``, :386) and its backward (``bwd_call``, :467),
which returns dX, dfx, dfy and dmask.

On a CUDA tensor ``sample_weighted`` is a ``torch.autograd.Function`` whose
forward and backward launch the hand-written kernels of
csrc/bilinear_gather.cu (the direct four-corner gather, one thread a (query,
channel vector) of the flat output with a query's taps loaded together; dX
by 16-byte vector reductions that skip zero-weight corners, so its
summation order varies from run to run at fp32 rounding).  Both are bound by
device-memory bytes.  On a CPU tensor it runs
``sample_weighted_plain``, the floor-based gather whose autograd gives the
same one-sided coordinate derivative as the TPU kernel's ``_dhat``: at an
integer coordinate the tap at t in [0, 1) has slope -1, the tap at
t in [-1, 0) slope +1, and the tap at t = 1 none.

K9 (``point_sample`` on pixel coordinates, ``point_sample_coords`` on
[0, 1] points as Mask2Former's point losses pass them;
csrc/point_sample.cu) replaces
samrs_tpu/kernels/bilinear_gather.py::_make_point_sampler: its forward
``pallas_call`` (:762) and its backward (:786), which returns dimg, dfx and
dfy.  Each of the N maps is sampled at its own K points; the coordinate
entry turns its points into pixels in the kernel (``pixel_coords`` is the
same arithmetic in PyTorch).  ``point_sample_plan`` picks the kernel's form
from the shape.  Its plain version ``point_sample_plain`` is an autograd
Function of plain PyTorch that keeps only the map and the coordinates for
its backward, as the kernel's does (an autograd graph of the gather would
keep four int64 indices and four weights a point: ~5 GB a call at the FAST
head's 6500 masks x 12544 points).

K8's row-slab form (``row_slab`` > 0; csrc/bilinear_slab.cu) replaces the
slab kernels of the same ``_make_sampler``: ``_fwd_kernel_slab`` (launched
by ``fwd_call``, :386, when ``slab > 0``) and ``bwd_call_slab`` (:419).  It
computes K8's function with the map rows a run of queries touches held on
chip: its forward's work item is a run of consecutive queries of one map
(``slab_plan`` gives its length), whose band is the union of the Hs-row slabs
that its taps touch under the JAX predicate (slab rows [s*Hs, s*Hs+Hs-1]
against [min fy - 1, max fy + 1], tap by tap).  The forward gathers as dense
K8 does, from the band staged by bulk copies (bit-equal to dense K8); taps
whose rows the band does not hold read device memory
(``sample_weighted_slab_routes_cuda`` counts both routes on the card).  Its
backward is dense K8's backward kernel, on the shapes the forward takes.
``row_slab`` follows the JAX package: ``None`` in ``dcnv3`` and
``ms_deform_attn`` means ``_auto_slab(H)`` (dense unless
``SAMRS_BILINEAR_SLAB`` names a height that divides H), 0 dense, and a
height that does not divide H dense, per call and per level.  On a CPU
tensor the slab mode runs the plain version: the function is the same.

``ms_deform_attn`` is JAX ``ms_deform_attn_pallas`` (one K8 launch a level);
``ms_deform_attn_hybrid`` JAX's per-level split of it (levels of at least
``min_rows_xla`` rows on the plain version, or on dense K8 for
``big_impl="ghb"``; the others on K8), which ``SAMRS_MSDA_IMPL=hybrid``
selects in the MSDeformAttn module.

``dcnv3`` is JAX ``dcnv3_pallas`` (DCNv3 over K8, InternImage's sampling
core) on absolute coordinates ``fx = px - 0.5 + offset``: the base grid
``_dcnv3_base_grid`` with the taps column-major (``k = iw * kh + ih``).
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from samrs_tpu_torch.kernels import _build

fwd_launches = 0  # CUDA launches of K8's forward kernel
bwd_launches = 0  # CUDA launches of K8's backward kernel
ps_fwd_launches = 0  # CUDA launches of K9's forward kernel
ps_bwd_launches = 0  # CUDA launches of K9's backward kernel
slab_fwd_launches = 0  # CUDA launches of K8's row-slab forward kernel
slab_bwd_launches = 0  # CUDA launches of K8's row-slab backward kernel

_DTYPES = (torch.float32, torch.bfloat16)


def _corners(fx, fy, H: int, W: int):
    """Per tap: the fractional offsets (wx, wy) and, for each of the four
    corners (00, 01, 10, 11), its flat pixel index (clamped into the map)
    and whether it lies on the map."""
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx, wy = fx - x0, fy - y0
    # clamp before the integer cast; a clamped corner is off the map either way
    x0i = x0.clamp(-2, W).long()
    y0i = y0.clamp(-2, H).long()
    out = []
    for dy in (0, 1):
        for dx in (0, 1):
            xi, yi = x0i + dx, y0i + dy
            valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
            out.append((yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1), valid))
    return wx, wy, out


def _corner_weights(fx, fy, H: int, W: int):
    """Per tap: the flat pixel index (clamped into the map) and the bilinear
    weight (0 off the map) of each of the four corners."""
    wx, wy, corners = _corners(fx, fy, H, W)
    factors = [(1 - wx, 1 - wy), (wx, 1 - wy), (1 - wx, wy), (wx, wy)]
    return [(idx, wxc * wyc * valid) for (idx, valid), (wxc, wyc) in zip(corners, factors)]


def sample_weighted_plain(xg, fx, fy, mask, group_channels: int):
    """Plain PyTorch version: the four-corner gather of JAX's
    ``_gather_chunk`` in fp32, differentiable by autograd (``floor`` has a
    zero derivative, so d/dfx is the one-sided slope).  xg (BG, H, W*Gc) fp32
    or bf16; fx, fy, mask (BG, P, K) fp32 -> (BG, P, Gc) fp32.  Rounded as
    the kernels round: each tap's corners summed in the order 00, 01, 10, 11,
    then the taps' weighted sums added one after the other (so on the card
    the forward is bit-equal to K8's)."""
    BG, H, WGc = xg.shape
    Gc = group_channels
    W = WGc // Gc
    _, P, K = fx.shape
    img = xg.float().reshape(BG * H * W, Gc)
    base = (torch.arange(BG, device=xg.device) * (H * W))[:, None, None]
    samp = 0.0
    for idx, w in _corner_weights(fx, fy, H, W):
        vals = img[(base + idx).reshape(-1)].reshape(BG, P, K, Gc)
        samp = samp + vals * w[..., None]
    out = samp[:, :, 0] * mask[:, :, 0, None]
    for k in range(1, K):
        out = out + samp[:, :, k] * mask[:, :, k, None]
    return out


def _check(xg, fx, fy, mask, Gc: int):
    if xg.dim() != 3 or xg.shape[2] % Gc:
        raise ValueError(f"xg: expected (BG, H, W*{Gc}), got {tuple(xg.shape)}")
    BG = xg.shape[0]
    if fx.dim() != 3 or fx.shape[0] != BG:
        raise ValueError(f"fx: expected (BG={BG}, P, K), got {tuple(fx.shape)}")
    if xg.dtype not in _DTYPES:
        raise ValueError(f"xg: the kernel takes {_DTYPES}, got {xg.dtype}")
    for name, t in (("xg", xg), ("fx", fx), ("fy", fy), ("mask", mask)):
        _build.require_cuda(name, t, xg.dtype if name == "xg" else torch.float32,
                            xg.shape if name == "xg" else fx.shape)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy of it where its address is not 16-byte aligned (K8's
    forward reads the map's channels and a query's four taps as 16-byte
    vectors)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc: int):
    """The forward kernel: (BG, P, Gc) fp32.  The inputs' addresses must be
    16-byte aligned (``sample_weighted`` copies them where they are not)."""
    global fwd_launches
    _check(xg, fx, fy, mask, Gc)
    for name, t in (("xg", xg), ("fx", fx), ("fy", fy), ("mask", mask)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K8's forward needs a 16-byte aligned address")
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    out = torch.empty(BG, P, Gc, device=xg.device, dtype=torch.float32)
    p = _build.ptr
    _build.launch("samrs_bilinear_fwd", p(xg), p(fx), p(fy), p(mask), p(out),
                  BG, H, WGc // Gc, P, K, Gc, int(xg.dtype == torch.bfloat16))
    fwd_launches += 1
    return out


def sample_weighted_bwd_cuda(xg, fx, fy, mask, dout, Gc: int, reductions=None):
    """The backward kernel: (dxg in xg's dtype, dfx, dfy, dmask fp32).  dX
    accumulates with 16-byte vector reductions (scalar where Gc % 4 != 0)
    that skip zero-weight corners, into a zeroed fp32 buffer, so its
    summation order varies from run to run.  `reductions`, a one-element
    int64 CUDA tensor, gets the count of reductions the launch issued
    added to it (the training paths pass none)."""
    global bwd_launches
    _check(xg, fx, fy, mask, Gc)
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    _build.require_cuda("dout", dout, torch.float32, (BG, P, Gc))
    if reductions is not None:
        _build.require_cuda("reductions", reductions, torch.int64, (1,))
    dxg = torch.zeros(BG, H, WGc, device=xg.device, dtype=torch.float32)
    dfx, dfy, dmask = (torch.empty_like(fx) for _ in range(3))
    p = _build.ptr
    _build.launch("samrs_bilinear_bwd", p(xg), p(fx), p(fy), p(mask), p(dout), p(dxg), p(dfx),
                  p(dfy), p(dmask), p(reductions), BG, H, WGc // Gc, P, K, Gc,
                  int(xg.dtype == torch.bfloat16))
    bwd_launches += 1
    return dxg.to(xg.dtype), dfx, dfy, dmask


class _SampleWeighted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, fx, fy, mask, Gc):
        ctx.save_for_backward(xg, fx, fy, mask)
        ctx.Gc = Gc
        return sample_weighted_fwd_cuda(xg, fx, fy, mask, Gc)

    @staticmethod
    def backward(ctx, dout):
        xg, fx, fy, mask = ctx.saved_tensors
        dxg, dfx, dfy, dmask = sample_weighted_bwd_cuda(xg, fx, fy, mask,
                                                        dout.float().contiguous(), ctx.Gc)
        return dxg, dfx, dfy, dmask, None


# K8-slab's forward launch (csrc/bilinear_slab.cu's item_plan; the C entries refuse the same
# shapes)
SLAB_BUDGET = 227 * 1024     # dynamic shared memory a block can use on an H100 (bytes)
SLAB_MAX_K = 32              # taps: a band is at most K runs of slabs


@functools.lru_cache(maxsize=256)
def slab_plan(BG: int, H: int, W: int, P: int, K: int, Gc: int, Hs: int,
              elem_bytes: int) -> dict:
    """K8-slab's forward plan for a launch on BG (H, W*Gc) maps of
    `elem_bytes` (4 fp32, 2 bf16) at P queries of K taps, slab height Hs.
    Each of two stages of map rows holds ``cap`` elements (a multiple of 8):
    the whole map where it fits (one item a map), else as many slabs as fit
    (each with 8 elements for its run's phase), and an item's ``L`` queries
    span the output rows of all but two of them (one slab where fewer than
    three fit), so that its taps may reach one slab beyond either side.
    Beside them, four mbarriers and two metas of ``meta`` ints (the producer
    warp plans the next item while the others gather this one).  ``smem``:
    the dynamic shared memory the launch asks for.  Raises where no plan
    takes the shape (the backward too): Hs not dividing H, K over
    SLAB_MAX_K, flat indices past 31 bits, metadata that fills the block."""
    if min(BG, H, W, P, K, Gc, Hs) < 1 or H % Hs or K > SLAB_MAX_K:
        raise ValueError(f"no K8-slab plan takes BG {BG}, {H}x{W}, P {P}, K {K}, Gc {Gc}, "
                         f"slab {Hs}: the slab must divide H, K <= {SLAB_MAX_K}")
    lim, BP = 2 ** 31, BG * P
    if BP * K >= lim or BP * Gc + 4 >= lim or H * W * Gc >= lim:
        raise ValueError(f"no K8-slab plan takes BG {BG}, {H}x{W}, P {P}, K {K}, Gc {Gc}: "
                         f"its flat indices pass 31 bits")
    nslab = H // Hs
    meta = (2 * K + 1 + 3 * K + nslab + H + 3) // 4 * 4
    fixed = 32 + 8 * meta  # four mbarriers, two metas
    if fixed + 1024 > SLAB_BUDGET:
        raise ValueError(f"no K8-slab plan takes {H} rows of {nslab} slabs: their metadata "
                         f"fills the block's shared memory")
    per = 2 * elem_bytes  # bytes an element: two stages
    slab_el = Hs * W * Gc
    whole = nslab * slab_el + 8
    cmax = (SLAB_BUDGET - fixed) // per // 8 * 8
    L, cap = P, -(-whole // 8) * 8
    if whole > cmax:
        C = cmax // (slab_el + 8)
        L, cap = (C - 2 if C >= 3 else 1) * Hs * W, C * (slab_el + 8)
    L = min(L, P)
    nitem = -(-P // L)
    return dict(L=L, nitem=nitem, items=BG * nitem, cap=cap, meta=meta, smem=fixed + per * cap)


def _check_slab(xg, fx, Gc: int, Hs: int):
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    slab_plan(BG, H, WGc // Gc, P, K, Gc, Hs, xg.element_size())


def sample_weighted_slab_fwd_cuda(xg, fx, fy, mask, Gc: int, Hs: int):
    """The row-slab forward kernel (slab height Hs, a divisor of H): (BG, P,
    Gc) fp32, bit-equal to ``sample_weighted_fwd_cuda``.  Raises where no
    plan takes the shape (``slab_plan``); never reroutes."""
    global slab_fwd_launches
    _check(xg, fx, fy, mask, Gc)
    _check_slab(xg, fx, Gc, Hs)
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    out = torch.empty(BG, P, Gc, device=xg.device, dtype=torch.float32)
    p = _build.ptr
    _build.launch("samrs_bilinear_slab_fwd", p(xg), p(fx), p(fy), p(mask), p(out),
                  BG, H, WGc // Gc, P, K, Gc, Hs, int(xg.dtype == torch.bfloat16))
    slab_fwd_launches += 1
    return out


def sample_weighted_slab_bwd_cuda(xg, fx, fy, mask, dout, Gc: int, Hs: int):
    """The row-slab backward (dense K8's backward kernel, on the shapes the
    forward takes): (dxg in xg's dtype, dfx, dfy, dmask fp32).  dX is added
    by reductions into a zeroed fp32 buffer, so its summation order varies
    from run to run.  Raises where no plan takes the shape."""
    global slab_bwd_launches
    _check(xg, fx, fy, mask, Gc)
    _check_slab(xg, fx, Gc, Hs)
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    _build.require_cuda("dout", dout, torch.float32, (BG, P, Gc))
    dxg = torch.zeros(BG, H, WGc, device=xg.device, dtype=torch.float32)
    dfx, dfy, dmask = (torch.empty_like(fx) for _ in range(3))
    p = _build.ptr
    _build.launch("samrs_bilinear_slab_bwd", p(xg), p(fx), p(fy), p(mask), p(dout), p(dxg),
                  p(dfx), p(dfy), p(dmask), BG, H, WGc // Gc, P, K, Gc, Hs,
                  int(xg.dtype == torch.bfloat16))
    slab_bwd_launches += 1
    return dxg.to(xg.dtype), dfx, dfy, dmask


def sample_weighted_slab_routes_cuda(xg, fx, fy, mask, Gc: int, Hs: int):
    """The row-slab forward kernel built to count its taps by route (a
    measurement, not counted in ``slab_fwd_launches``): (out, the (query,
    tap) pairs whose corners it read from the staged band, those it read from
    device memory), each pair counted once."""
    _check(xg, fx, fy, mask, Gc)
    _check_slab(xg, fx, Gc, Hs)
    BG, H, WGc = xg.shape
    _, P, K = fx.shape
    out = torch.empty(BG, P, Gc, device=xg.device, dtype=torch.float32)
    routes = torch.zeros(2, device=xg.device, dtype=torch.int64)
    p = _build.ptr
    _build.launch("samrs_bilinear_slab_fwd_count", p(xg), p(fx), p(fy), p(mask), p(out),
                  BG, H, WGc // Gc, P, K, Gc, Hs, int(xg.dtype == torch.bfloat16), p(routes))
    band, device = routes.tolist()
    return out, band, device


class _SampleWeightedSlab(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xg, fx, fy, mask, Gc, Hs):
        ctx.save_for_backward(xg, fx, fy, mask)
        ctx.Gc, ctx.Hs = Gc, Hs
        return sample_weighted_slab_fwd_cuda(xg, fx, fy, mask, Gc, Hs)

    @staticmethod
    def backward(ctx, dout):
        xg, fx, fy, mask = ctx.saved_tensors
        dxg, dfx, dfy, dmask = sample_weighted_slab_bwd_cuda(
            xg, fx, fy, mask, _aligned(dout.float().contiguous()), ctx.Gc, ctx.Hs)
        return dxg, dfx, dfy, dmask, None, None


def _auto_slab(H: int) -> int:
    """Row-slab height of ``row_slab=None`` (JAX ``_auto_slab``): 0 (dense)
    unless ``SAMRS_BILINEAR_SLAB`` names a height; that height where it
    divides H, else 0; ``=0`` is dense."""
    env = os.environ.get("SAMRS_BILINEAR_SLAB")
    if env is not None:
        s = int(env)
        return s if s > 0 and H % s == 0 else 0
    return 0


def sample_weighted(xg, fx, fy, mask, group_channels: int, row_slab: int = 0):
    """K8 (JAX ``sample_weighted``): xg (BG, H, W*Gc) fp32 or bf16; fx, fy,
    mask (BG, P, K) fp32 absolute pixel coordinates and tap weights ->
    (BG, P, Gc) fp32.  ``row_slab`` > 0 that divides H selects the row-slab
    kernels, any other value the dense ones.  The kernels for a CUDA tensor,
    the plain version for a CPU tensor."""
    if row_slab > 0 and xg.shape[1] % row_slab != 0:
        row_slab = 0
    if not xg.is_cuda:
        return sample_weighted_plain(xg, fx, fy, mask, group_channels)
    args = (*(_aligned(t) for t in (xg.contiguous(), fx.float().contiguous(),
                                     fy.float().contiguous(), mask.float().contiguous())),
            int(group_channels))
    if row_slab > 0:
        return _SampleWeightedSlab.apply(*args, int(row_slab))
    return _SampleWeighted.apply(*args)


def _plain_sampler(*args):
    """``sample_weighted_plain`` on any device, under activation checkpointing
    while autograd records: its graph would keep the four corners' gathered
    values and indices a tap, where the kernels keep only their inputs."""
    if not torch.is_grad_enabled():
        return sample_weighted_plain(*args)
    return checkpoint(sample_weighted_plain, *args, use_reentrant=False)


# ---------------------------------------------------------------- DCNv3 ----


def _dcnv3_base_grid(Ho: int, Wo: int, kernel_h: int, kernel_w: int, stride_h: int,
                     stride_w: int, pad_h: int, pad_w: int, dilation_h: int,
                     dilation_w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(P, K) fp32 base sampling coordinates (x, y) in source pixels with the
    half-pixel shift applied (fx = px - 0.5); taps column-major, k = iw *
    kh + ih (JAX ``_dcnv3_base_grid``, dcnv3_func.py:142-160)."""
    ref_y = np.arange(Ho) * stride_h - pad_h + (dilation_h * (kernel_h - 1)) // 2 + 0.5
    ref_x = np.arange(Wo) * stride_w - pad_w + (dilation_w * (kernel_w - 1)) // 2 + 0.5
    ky = np.arange(kernel_h) * dilation_h - (dilation_h * (kernel_h - 1)) // 2
    kx = np.arange(kernel_w) * dilation_w - (dilation_w * (kernel_w - 1)) // 2
    tap_y = np.broadcast_to(ky[None, :], (kernel_w, kernel_h)).reshape(-1)
    tap_x = np.broadcast_to(kx[:, None], (kernel_w, kernel_h)).reshape(-1)
    by = ref_y[:, None, None] + tap_y[None, None, :]
    bx = ref_x[None, :, None] + tap_x[None, None, :]
    base_y = np.broadcast_to(by, (Ho, Wo, len(tap_y))).reshape(Ho * Wo, -1)
    base_x = np.broadcast_to(bx, (Ho, Wo, len(tap_x))).reshape(Ho * Wo, -1)
    return (base_x - 0.5).astype(np.float32), (base_y - 0.5).astype(np.float32)


def dcnv3(x, offset, mask, kernel_h: int, kernel_w: int, stride_h: int = 1, stride_w: int = 1,
          pad_h: int = 1, pad_w: int = 1, dilation_h: int = 1, dilation_w: int = 1,
          groups: int = 1, group_channels: int = 16, offset_scale: float = 1.0,
          row_slab: Optional[int] = None, plain: bool = False):
    """DCNv3 core over K8 (JAX ``dcnv3_pallas``), NHWC: x (B, H, W, G*Gc)
    fp32 or bf16; offset (B, Ho, Wo, G*K*2) and mask (B, Ho, Wo, G*K) ->
    (B, Ho, Wo, G*Gc) fp32.  One ``sample_weighted`` on the (B*G, H, W*Gc)
    map with the taps' absolute coordinates; ``row_slab`` None is
    ``_auto_slab(H)``, 0 dense, h > 0 the slab kernels where h divides H.
    ``plain=True`` runs the plain version on any device, under activation
    checkpointing."""
    B, H, W, _ = x.shape
    _, Ho, Wo, _ = offset.shape
    G, Gc, K = groups, group_channels, kernel_h * kernel_w
    P = Ho * Wo
    xg = x.reshape(B, H, W, G, Gc).permute(0, 3, 1, 2, 4).reshape(B * G, H, W * Gc)
    off = offset.float().reshape(B, P, G, K, 2).permute(0, 2, 1, 3, 4).reshape(B * G, P, K, 2)
    m = mask.float().reshape(B, P, G, K).permute(0, 2, 1, 3).reshape(B * G, P, K)
    bx, by = _dcnv3_base_grid(Ho, Wo, kernel_h, kernel_w, stride_h, stride_w, pad_h, pad_w,
                              dilation_h, dilation_w)
    fx = torch.from_numpy(bx).to(x.device) + off[..., 0] * offset_scale
    fy = torch.from_numpy(by).to(x.device) + off[..., 1] * offset_scale
    if plain:
        out = _plain_sampler(xg, fx, fy, m, Gc)
    else:
        slab = _auto_slab(H) if row_slab is None else row_slab
        out = sample_weighted(xg, fx, fy, m, Gc, row_slab=slab)
    out = out.reshape(B, G, Ho, Wo, Gc).permute(0, 2, 3, 1, 4)
    return out.reshape(B, Ho, Wo, G * Gc)


def grid_sample(img, grid, align_corners: bool = False, plain: bool = False):
    """torch-compatible bilinear grid sample with zero padding, NHWC (JAX
    ``grid_sample_pallas``): img (B, H, W, C), grid (B, Ho, Wo, 2) normalized
    to [-1, 1] -> (B, Ho, Wo, C) fp32.  One tap with a ones mask through
    ``sample_weighted``; ``plain=True`` runs the plain version on any device
    (the comparison path on the card)."""
    B, H, W, C = img.shape
    _, Ho, Wo, _ = grid.shape
    P = Ho * Wo
    gx = grid[..., 0].reshape(B, P, 1).float()
    gy = grid[..., 1].reshape(B, P, 1).float()
    if align_corners:
        fx = (gx + 1.0) * 0.5 * (W - 1)
        fy = (gy + 1.0) * 0.5 * (H - 1)
    else:
        fx = ((gx + 1.0) * W - 1.0) * 0.5
        fy = ((gy + 1.0) * H - 1.0) * 0.5
    xg = img.reshape(B, H, W * C)
    ones = torch.ones(B, P, 1, device=img.device, dtype=torch.float32)
    sampler = sample_weighted_plain if plain else sample_weighted
    return sampler(xg, fx, fy, ones, C).reshape(B, Ho, Wo, C)


def ms_deform_attn(value, spatial_shapes, sampling_locations, attention_weights,
                   plain: bool = False, row_slab: Optional[int] = None):
    """Multi-scale deformable attention over K8 (JAX ``ms_deform_attn_pallas``):
    value (B, S, nH, D) with S = sum(h * w) over ``spatial_shapes``;
    sampling_locations (B, Q, nH, L, P, 2) in [0, 1]; attention_weights (B, Q,
    nH, L, P) -> (B, Q, nH * D) fp32.  One ``sample_weighted`` a level on the
    (B * nH, h, w * D) map, with the attention weights as the taps' weights
    (K = P) and fx = x * w - 0.5 (align_corners=False).  ``plain=True`` runs
    the plain version on any device, under activation checkpointing: its
    autograd graph would keep the sampled corners, (B * nH, Q, P, D) fp32
    each (~2 GB a level for the pixel decoder's 94 images), where the
    kernel keeps only its inputs.  ``row_slab`` as in ``dcnv3``, per level
    (None: ``_auto_slab`` of the level's height)."""
    B, S, nH, D = value.shape
    _, Q, _, L, P, _ = sampling_locations.shape

    def sampler(*args, h):
        if plain:
            return _plain_sampler(*args)
        slab = _auto_slab(h) if row_slab is None else row_slab
        return sample_weighted(*args, row_slab=slab)

    values = value.split([h * w for h, w in spatial_shapes], dim=1)
    out = None
    for lvl, (h, w) in enumerate(spatial_shapes):
        xg = values[lvl].reshape(B, h, w, nH, D).permute(0, 3, 1, 2, 4).reshape(B * nH, h, w * D)
        loc = sampling_locations[:, :, :, lvl].transpose(1, 2).reshape(B * nH, Q, P, 2).float()
        wts = attention_weights[:, :, :, lvl].transpose(1, 2).reshape(B * nH, Q, P).float()
        o = sampler(xg, loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5, wts, D, h=h)
        out = o if out is None else out + o
    return out.reshape(B, nH, Q, D).transpose(1, 2).reshape(B, Q, nH * D)


def ms_deform_attn_hybrid(value, spatial_shapes, sampling_locations, attention_weights,
                          min_rows_xla: int = 128, big_impl: str = "xla"):
    """Multi-scale deformable attention split per level (JAX
    ``ms_deform_attn_hybrid``, samrs_tpu/kernels/bilinear_gather.py:888-935):
    the sum over levels of ``ms_deform_attn`` on each level alone.  A level of
    at least `min_rows_xla` rows takes dense K8 (``row_slab=0``) for
    ``big_impl="ghb"`` and the plain version otherwise (the JAX function's
    XLA gather); the smaller levels take K8 as ``_auto_slab`` chooses.  Same
    arguments and (B, Q, nH * D) fp32 result as ``ms_deform_attn``."""
    bounds = np.cumsum([0] + [h * w for h, w in spatial_shapes])
    out = None
    for i, (h, w) in enumerate(spatial_shapes):
        args = (value[:, bounds[i]:bounds[i + 1]], [(h, w)],
                sampling_locations[:, :, :, i:i + 1], attention_weights[:, :, :, i:i + 1])
        if h < min_rows_xla:
            o = ms_deform_attn(*args)
        elif big_impl == "ghb":
            o = ms_deform_attn(*args, row_slab=0)
        else:
            o = ms_deform_attn(*args, plain=True)
        out = o if out is None else out + o
    return out


# ---------------------------------------------------------------- K9 ----

_PS_POINTS = 1 << 24  # points of one pass of the plain version (bounds its int64 indices)

# K9's forms (csrc/point_sample.cu), which point_sample_plan picks from the shape.  The C
# side's plan_ok is the authority on what a form takes (the entries refuse any other);
# these constants and _ps_smem_bytes are the model of it that the plan picks by.
PS_SMEM, PS_BANDS, PS_GLOBAL = 0, 1, 2
PS_SMEM_BUDGET = 227 * 1024  # dynamic shared memory a block can use on an H100 (bytes)
PS_MAX_BLOCKS = 8            # blocks a mask: a forward's split, or the BANDS form's bands
PS_VEC = 4                   # consecutive points a thread takes at once
PS_THREADS = {PS_SMEM: 512, PS_BANDS: 1024, PS_GLOBAL: 256}
PS_SPLIT_BLOCKS = 4          # forward blocks an SM below which a mask's points are split
PS_MAX_SIDE = 1 << 22        # H, W below this: exact float pixel coordinates
_I32 = 2 ** 31 - 1


def _ps_smem_bytes(rows: int, W: int, arrays) -> int:
    """Dynamic shared memory of a block that holds `rows` rows of the map in
    each of `arrays` (their element sizes): a 144-byte header (the mbarrier,
    32 floats of scratch), then each array at its device address's
    16-byte phase (up to 15 bytes in), in a multiple of 16 bytes
    (a model of csrc/point_sample.cu's ``smem_bytes``)."""
    return 144 + sum(-(-rows * W * e // 16) * 16 + 16 for e in arrays)


@functools.lru_cache(maxsize=256)
def point_sample_plan(N: int, H: int, W: int, K: int, elem_bytes: int, grad=None,
                      sms: int = 132):
    """K9's form for a call on N (H, W) maps of `elem_bytes` (4 fp32, 2 bf16)
    at K points each: (form, blocks).  ``grad`` None is the forward, False
    the backward of dimg alone (the path's), True the backward with the
    coordinate gradient; ``sms`` the card's SM count.

    PS_SMEM: a block holds the whole map in shared memory (the backward:
    dimg's fixed-point partial, and the map when ``grad``).  The forward takes
    `blocks` blocks a mask, each with its own copy of the map and an equal
    share of the points, where N alone would give the card fewer than
    PS_SPLIT_BLOCKS blocks an SM; the backward takes one block a mask, which
    owns the mask's whole dimg.  PS_BANDS (the backward of dimg alone): the
    fewest `blocks` (2, 4 or 8) a mask whose bands of ceil(H / blocks) rows of
    dimg's partial fit a block; every block reads all of the mask's points and
    adds only into its own band.  PS_GLOBAL (blocks 1) for every other shape:
    corners read from device memory, dimg added there by atomics.  Raises
    where no form takes the shape: the wrapper never reroutes."""
    if min(N, H, W, K) < 1 or H * W > _I32 or K > _I32 or max(H, W) >= PS_MAX_SIDE:
        raise ValueError(f"point_sample: no K9 form takes N {N}, {H}x{W}, K {K}")
    # the forward holds the map; the backward dimg's fixed-point partial (two int32 words a
    # pixel) and, for the coordinate gradient, the map
    arrays = [elem_bytes] if grad is None else [4, 4] + ([elem_bytes] if grad else [])
    bands = (1, 2, 4, 8) if grad is False else (1,)
    plan = (PS_GLOBAL, 1)
    for blocks in bands:
        if _ps_smem_bytes(-(-H // blocks), W, arrays) <= PS_SMEM_BUDGET:
            plan = (PS_SMEM, 1) if blocks == 1 else (PS_BANDS, blocks)
            break
    if plan[0] == PS_SMEM and grad is None:
        want = -(-PS_SPLIT_BLOCKS * sms // N)
        plan = (PS_SMEM, max(1, min(PS_MAX_BLOCKS, want, K // (PS_THREADS[PS_SMEM] * PS_VEC))))
    if N > _I32 // plan[1]:
        raise ValueError(f"point_sample: no K9 form takes N {N} ({plan[1]} blocks a mask)")
    return plan


def pixel_coords(coords, H: int, W: int):
    """(fx, fy): absolute pixel coordinates of (..., 2) xy points in [0, 1]
    (align_corners=False) through the JAX package's [-1, 1] grid,
    ``((2c - 1 + 1) * size - 1) * 0.5`` with each operation rounded on its
    own: K9's coordinate entry does the same in registers, so its points
    are these bit for bit."""
    g = 2.0 * coords.float() - 1.0
    return ((g[..., 0] + 1.0) * W - 1.0) * 0.5, ((g[..., 1] + 1.0) * H - 1.0) * 0.5


def point_sample_plain_fwd(img, fx, fy):
    """K9's plain forward: img (N, H, W) fp32 or bf16; fx, fy (N, K) fp32
    absolute pixel coordinates -> (N, K) fp32; the four-corner gather of
    ``sample_weighted_plain``, summed in the kernel's order, in row slices."""
    N, H, W = img.shape
    flat = img.float().reshape(N, H * W)
    out = torch.empty(fx.shape, device=img.device, dtype=torch.float32)
    step = max(1, _PS_POINTS // fx.shape[1])
    for s in range(0, N, step):
        rows = slice(s, s + step)
        acc = 0.0
        for idx, w in _corner_weights(fx[rows], fy[rows], H, W):
            acc = acc + flat[rows].gather(1, idx) * w
        out[rows] = acc
    return out


def point_sample_plain_bwd(img, fx, fy, dout, coords_grad: bool = True):
    """K9's plain backward: (dimg in img's dtype, dfx, dfy), the last two
    None unless ``coords_grad``; the floor formula's one-sided coordinate
    derivative, dimg by ``scatter_add_``."""
    N, H, W = img.shape
    flat = img.float().reshape(N, H * W)
    dimg = torch.zeros(N, H * W, device=img.device, dtype=torch.float32)
    dfx = torch.empty_like(fx) if coords_grad else None
    dfy = torch.empty_like(fy) if coords_grad else None
    step = max(1, _PS_POINTS // fx.shape[1])
    for s in range(0, N, step):
        rows = slice(s, s + step)
        r = dout[rows]
        wx, wy, corners = _corners(fx[rows], fy[rows], H, W)
        ax, ay = 1 - wx, 1 - wy
        for (idx, valid), w in zip(corners, (ax * ay, wx * ay, ax * wy, wx * wy)):
            dimg[rows].scatter_add_(1, idx, r * w * valid)
        if coords_grad:
            v00, v01, v10, v11 = (flat[rows].gather(1, idx) * valid for idx, valid in corners)
            dfx[rows] = r * ((v01 - v00) * ay + (v11 - v10) * wy)
            dfy[rows] = r * ((v10 * ax + v11 * wx) - (v00 * ax + v01 * wx))
    return dimg.reshape(N, H, W).to(img.dtype), dfx, dfy


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(device) -> int:
    return _sm_count(device.index if device.index is not None else torch.cuda.current_device())


def _ps_plan(img, K: int, grad):
    N, H, W = img.shape
    return point_sample_plan(N, H, W, K, img.element_size(), grad, _sms(img.device))


def _ps_check_img(img):
    if img.dim() != 3:
        raise ValueError(f"point_sample: expected img (N, H, W), got {tuple(img.shape)}")
    if img.dtype not in _DTYPES:
        raise ValueError(f"img: the kernel takes {_DTYPES}, got {img.dtype}")
    _build.require_cuda("img", img, img.dtype)


def _ps_aligned16(**tensors):
    for name, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: K9 reads it as 16-byte vectors: needs a 16-byte aligned "
                             f"address")


def _ps_check(img, fx, fy):
    if img.dim() != 3 or fx.dim() != 2 or fx.shape[0] != img.shape[0]:
        raise ValueError(f"point_sample: expected img (N, H, W) and fx, fy (N, K), got "
                         f"{tuple(img.shape)} and {tuple(fx.shape)}")
    _ps_check_img(img)
    _build.require_cuda("fx", fx, torch.float32)
    _build.require_cuda("fy", fy, torch.float32, fx.shape)
    _ps_aligned16(fx=fx, fy=fy)


def _ps_check_coords(img, coords):
    if (img.dim() != 3 or coords.dim() != 3 or coords.shape[0] != img.shape[0]
            or coords.shape[2] != 2):
        raise ValueError(f"point_sample_coords: expected img (N, H, W) and coords (N, K, 2), "
                         f"got {tuple(img.shape)} and {tuple(coords.shape)}")
    _ps_check_img(img)
    _build.require_cuda("coords", coords, torch.float32)
    _ps_aligned16(coords=coords)


def _ps_fwd(img, a, b, K: int):
    """One forward launch: a, b = fx, fy, or coords and None."""
    global ps_fwd_launches
    N, H, W = img.shape
    plan = _ps_plan(img, K, None)
    out = torch.empty(N, K, device=img.device, dtype=torch.float32)
    p = _build.ptr
    _build.launch("samrs_point_sample_fwd", p(img), p(a), p(b), p(out), N, H, W, K,
                  int(img.dtype == torch.bfloat16), int(b is None), *plan)
    ps_fwd_launches += 1
    return out


def _ps_bwd(img, a, b, dout, K: int, ga, gb):
    """One backward launch into ga, gb (the coordinate gradients, or None):
    dimg (N, H, W) fp32, written whole by the kernel (zeroed first only for
    the device-memory form, whose atomics add into it)."""
    global ps_bwd_launches
    _build.require_cuda("dout", dout, torch.float32, (img.shape[0], K))
    _ps_aligned16(dout=dout)
    N, H, W = img.shape
    plan = _ps_plan(img, K, ga is not None)
    alloc = torch.zeros if plan[0] == PS_GLOBAL else torch.empty
    dimg = alloc(N, H, W, device=img.device, dtype=torch.float32)
    p = _build.ptr
    _build.launch("samrs_point_sample_bwd", p(img), p(a), p(b), p(dout), p(dimg), p(ga), p(gb),
                  N, H, W, K, int(img.dtype == torch.bfloat16), int(b is None), *plan)
    ps_bwd_launches += 1
    return dimg


def point_sample_fwd_cuda(img, fx, fy):
    """K9's forward kernel on pixel coordinates: (N, K) fp32."""
    _ps_check(img, fx, fy)
    return _ps_fwd(img, fx, fy, fx.shape[1])


def point_sample_bwd_cuda(img, fx, fy, dout, coords_grad: bool = True):
    """K9's backward kernel on pixel coordinates: (dimg in img's dtype, dfx,
    dfy); dfx and dfy are None (and not computed) unless ``coords_grad``."""
    _ps_check(img, fx, fy)
    dfx = torch.empty_like(fx) if coords_grad else None
    dfy = torch.empty_like(fy) if coords_grad else None
    dimg = _ps_bwd(img, fx, fy, dout, fx.shape[1], dfx, dfy)
    return dimg.to(img.dtype), dfx, dfy


def point_sample_coords_fwd_cuda(img, coords):
    """K9's forward kernel on (N, K, 2) xy points in [0, 1]: (N, K) fp32."""
    _ps_check_coords(img, coords)
    return _ps_fwd(img, coords, None, coords.shape[1])


def point_sample_coords_bwd_cuda(img, coords, dout, coords_grad: bool = False):
    """K9's backward kernel on [0, 1] points: (dimg in img's dtype, dcoords
    (N, K, 2) or None unless ``coords_grad``)."""
    _ps_check_coords(img, coords)
    dcoords = torch.empty_like(coords) if coords_grad else None
    dimg = _ps_bwd(img, coords, None, dout, coords.shape[1], dcoords, None)
    return dimg.to(img.dtype), dcoords


class _PointSample(torch.autograd.Function):
    """K9 or its plain version; keeps img, fx and fy for the backward."""

    @staticmethod
    def forward(ctx, img, fx, fy, plain: bool):
        ctx.save_for_backward(img, fx, fy)
        ctx.plain = plain
        return (point_sample_plain_fwd if plain else point_sample_fwd_cuda)(img, fx, fy)

    @staticmethod
    def backward(ctx, dout):
        img, fx, fy = ctx.saved_tensors
        bwd = point_sample_plain_bwd if ctx.plain else point_sample_bwd_cuda
        coords_grad = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        dimg, dfx, dfy = bwd(img, fx, fy, _aligned(dout.float().contiguous()), coords_grad)
        return dimg, dfx, dfy, None


class _PointSampleCoords(torch.autograd.Function):
    """K9's coordinate entry on the card; keeps img and coords for the
    backward, which computes dcoords only where they need a gradient."""

    @staticmethod
    def forward(ctx, img, coords):
        ctx.save_for_backward(img, coords)
        return point_sample_coords_fwd_cuda(img, coords)

    @staticmethod
    def backward(ctx, dout):
        img, coords = ctx.saved_tensors
        return point_sample_coords_bwd_cuda(img, coords, _aligned(dout.float().contiguous()),
                                            ctx.needs_input_grad[1])


def _ps_args(img, fx, fy):
    return img.contiguous(), _aligned(fx.float().contiguous()), _aligned(fy.float().contiguous())


def point_sample_plain(img, fx, fy):
    """K9's plain version on any device: img (N, H, W) fp32 or bf16; fx, fy
    (N, K) absolute pixel coordinates -> (N, K) fp32, differentiable."""
    return _PointSample.apply(*_ps_args(img, fx, fy), True)


def point_sample(img, fx, fy):
    """K9 (JAX ``point_sample_pallas`` after its [-1, 1] -> pixel step): the
    kernels for a CUDA tensor, the plain version for a CPU tensor."""
    if not img.is_cuda:
        return point_sample_plain(img, fx, fy)
    return _PointSample.apply(*_ps_args(img, fx, fy), False)


def point_sample_coords_plain(img, coords):
    """The coordinate entry's plain version on any device: ``pixel_coords``
    (the caller's eager glue), then ``point_sample_plain``."""
    return point_sample_plain(img, *pixel_coords(coords, img.shape[1], img.shape[2]))


def point_sample_coords(img, coords):
    """K9's coordinate entry (JAX ``mask2former.point_sample`` on its Pallas
    route): img (N, H, W) fp32 or bf16 sampled at its own (N, K, 2) xy
    points in [0, 1] (mmcv's ``point_sample``, align_corners=False) ->
    (N, K) fp32.  A CUDA tensor takes the kernels, which turn the points
    into pixel coordinates in registers (one launch a call, none of the
    glue's elementwise passes); a CPU tensor takes the plain version."""
    if not img.is_cuda:
        return point_sample_coords_plain(img, coords)
    return _PointSampleCoords.apply(img.contiguous(), _aligned(coords.float().contiguous()))
