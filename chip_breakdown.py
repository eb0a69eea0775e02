#!/usr/bin/env python3
"""Where the time of the port's Hopper kernels goes, on one CUDA card, by
timing variants of their sources with one stage switched off.

    python3 chip_breakdown.py --csrc DIR [--what PART ...]

DIR is a ``samrs_tpu_torch/csrc``: this tree's, or for ``split_attention``
and ``t2i_kv`` also that of a tree before K12 and K4 were redesigned for
Hopper (unpack it with ``git archive`` into a directory that ``.gitignore``
lists).  The script copies a kernel's source into variants
in which a stage is switched off at run time (a condition the compiler
cannot fold: the work is skipped, the rest of the code stays), builds each
with nvcc for sm_90a, and times each at the paths' shapes.  The differences
between variants are the stages' shares; a stage that overlaps another
shows less than it costs alone.  The full variant's registers and spills
(ptxas) are printed.  It checks nothing and prints one JSON line of ms per
variant.  ``--what`` may be given more than once; the default runs every
part.

``--what attention``: K1's attention stage (csrc/window_attention.cu) and
K5 (csrc/twoway.cu) at the main path's shapes (ViT-H: one 64 x 64 x 3840
qkv map, 16 heads of 80; the decoder at bucket 64: 64 prompts x 4096 rows,
16 token slots), through the wrappers with the variant's library swapped in,
torch.profiler's device time per kernel: K1 in the fused2 and ijb orders,
on partitioned windows and on a 70 x 70 map (no window pads), with
``loads_only``, ``no_s``, ``no_bias`` or ``no_pv``; K5 per-prompt and
shared with ``no_attention`` or ``no_projections``; the full variant also by
the wall time of 20 back-to-back calls (the wrappers' host work included).

``--what mlp_gather``: K11 (csrc/fused_mlp.cu) through its wrapper, with its
products, its second and third tf32 passes (``one_pass_tf32``), its split,
its GELU or its stores switched off, at vit_b 512^2 batch 8 (T 8192, C 768,
M 3072) and InternImage-T level 0 (T 203840, C 64, M 256; the fused form the
wrapper picks there and the two launches); K8's backward
(csrc/bilinear_gather.cu) by direct calls, with its dX reductions, its
corner loads or its dfx / dfy / dmask shuffles switched off, at InternImage-T
level 0 (BG 260, 56^2, Gc 16, 9 taps of a 3x3 ring with offsets up to 1.5
px; also with zero offsets), the MSDeformAttn level (BG 520, 28^2, Gc 32,
1029 queries, 4 taps) and the RVSA shape (BG 780, 14^2, Gc 128, one tap);
20 back-to-back launches between CUDA events, median of 5.  ``--what
rates`` times this card's reduction rates at K8's level-0 access pattern
(the taps above, every valid corner of every tap, Gc 16): scalar
``red.global.add.f32``, the 16-byte ``red.global.add.v4.f32``, fp32
``atomicAdd`` into a block's shared-memory copy of one map, and plain
read-modify-write of that copy by the warp that owns a row (taps binned by
corner row beforehand), each in ops and elements per second.

``--what decoder_tail``: K6 (csrc/upscale.cu) and K7 (csrc/amg_post.cu) by
direct calls of their C entry points.  K6 at bucket 64 and bucket 256 (64 /
256 prompts of a 64 x 64 map, one mask token): ``no_conv1`` (the conv1
products), ``no_ln_gelu1`` (LayerNorm2d and the first GELU: conv1's sums go
to conv2 as they are), ``no_conv2`` (the conv2 products), ``no_gelu2`` (the
second GELU), ``no_hyper`` (the hypernetwork dots and their shuffles and
staging, GELU2's values still computed) and ``no_stores`` (the logits'
global stores, their computation kept).  K7 on 32 masks (g 256, input
1024^2) to 800 x 800 with ``no_vertical`` (the vertical banded sums),
``no_horizontal`` (the horizontal ones), ``no_bits`` (the threshold bytes
not staged), ``no_stats`` (the cluster's stats reduction),
``no_packed_stores`` (the staged bits' 16-byte global stores), ``no_rows``
(every row's sums, bits and stats: what is left is the launch, the copies,
the staging and the cluster's reductions) and ``no_copies`` (the bulk copy
of the input rows, and the tables' loads from device memory: zeros stand
in).  Each variant's device time comes from torch.profiler (20 calls); the
full K7 also gives the wall time of 20 back-to-back calls of
``amg_postprocess_cuda`` with its library swapped in (the wrapper's host
work and glue launches included; the wrapper of the profiled tree,
``DIR/../kernels/amg_post.py``), with the device time of everything that
call launches.

``--what gather_fwd`` profiles K8's forward (csrc/bilinear_gather.cu) by
direct calls of ``samrs_bilinear_fwd`` (20 back-to-back launches between
CUDA events, median of 5) at the smoke's K8 shapes: ``rvsa`` (BG 780, 14^2,
Gc 128, P 196, K 1), ``msda_l28`` (BG 520, 28^2, Gc 32, P 1029, K 4),
``shared_masks`` / ``shared_gt`` (BG 65, 56^2, Gc 100 / 37, P 12544, K 1)
and InternImage-T's ``ii_l0`` .. ``ii_l3`` (BG 260 .. 2080, 56^2 .. 7^2, Gc
16, K 9), with the inputs of ``chip_smoke.k8_case``.  Variants:
``no_coords`` (the taps are not loaded: each query's taps sit at (q mod W +
0.25, (q / W) mod H + 0.25) with weight 1, computed from its index q, so the
corner reads stay as local as RVSA's and InternImage's grids but not as
scattered as the shared samples'), ``no_corners`` (no corner loads: zeros
stand in, the arithmetic stays) and ``no_stores`` (the output stores
skipped, the sums kept alive).  ``--what plain_attention`` profiles K10
(csrc/plain_attention.cu) at vit_b 512^2 batch 8 (BH 96, N 1024, d 64) and
at the RVSA FAST head's 224^2 (BH 780, N 196, d 64), by torch.profiler's
device time per kernel over 20 calls: ``no_qk`` (no Q.K^T products),
``no_softmax`` (no running max, exponentials, row sums or rescaling: the
logits go to P.V as they are) and ``no_pv`` (no P.V products); on the
split-TF32 redesign also ``no_split`` (the K / V^T split pre-pass not
launched: the main kernel reads the scratch as it is) and ``split_only``
(the pre-pass alone).

``--what point_sample`` profiles K9 (csrc/point_sample.cu) by direct calls
of its C entries (20 back-to-back launches between CUDA events, median of
5) at the Mask2Former point loss's shapes: the FAST head (N 6500 masks of
56^2, K 12544), its 37632 uncertainty candidates (forward only) and a 256^2
map (N 300, K 12544), the backward both in the path's form (dimg only) and
with the coordinate gradient, on the inputs of ``chip_smoke.k9_case``; at
256^2 also the backward of dimg alone in the device-memory (GLOBAL) form
beside the banded one (``bwd_global``) and on 8 bands (``bwd_bands8``).
Variants: ``no_coords`` (the coordinates are not loaded: each point's are
hashed from its index, uniform over the map as the loss draws them),
``no_corners`` (no corner reads: zeros stand in), ``no_stores`` (the
per-point outputs and dimg's write-out skipped, their values kept),
``no_atomics`` (dimg's per-corner adds skipped) and ``no_staging`` (the
image not copied into shared memory), on the coordinate entry in the form
``bilinear_gather.point_sample_plan`` picks, and prints the count of each
atomic / reduction opcode in the full variant's SASS (cuobjdump).  The
variants also include ``float_dimg``
(dimg's shared partial in fp32, added by ``atomicAdd``, instead of fixed
point) and its SMEM form at other points a thread / threads a block /
blocks an SM (``fwd_v4_t512_b2`` ...).

``--what split_attention`` profiles K12 at one ViT-H image's four shapes
(16 heads of 80): the windows of ``window_attn_impl=pallas`` (B' 400, 14 x
14), the globals of ``window_attn_impl=xla`` (B' 16, 64 x 64) and the global
grids of image_size 512 and 256 (32^2, 16^2), 20 back-to-back launches
between CUDA events (median of 5) and torch.profiler's device time of the
full variant, with ``no_kv_loads`` (K and V not loaded), ``no_products``
(neither Q.K^T nor P.V), ``no_softmax`` (no exponentials: the logits go to
P.V as they are), ``no_bias`` (the rel-pos terms not added) and
``no_stores``; and, by device time, the glue the wrapper ran before the
redesign (the plain ``rel_rows``: q in fp32 and two einsums) and, on the
redesign, the path's ``window_attention_relpos`` (the rel-row kernel and
the attention) and, at the windows, K2's rel-row kernel beside K1's.
Before the redesign it takes csrc/split_attention.cu (the warp-level
kernels, with csrc/warp_attention.cuh inlined) by direct calls;
on the redesign the window form (csrc/window_attention.cu) or the
query-tiled form (csrc/flash_attention.cu) through the wrapper, each shape
in the form ``window_attention.split_form`` gives.  ``--what t2i_kv``
profiles K4 (csrc/twoway.cu) at the main path's 4096 rows by direct calls,
with ``no_tile_loads`` (zeros for the keys and pe), ``no_weight_loads``,
``no_products`` and ``no_stores`` (before the redesign also
``no_second_weight``: Wv not loaded).  The two source sets are told apart by
whether csrc/split_attention.cu exists.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
from pathlib import Path

import torch

from chip_smoke import device_ms
from samrs_tpu_torch.kernels import _build

PARTS = ("attention", "mlp_gather", "rates", "decoder_tail", "gather_fwd", "plain_attention",
         "point_sample", "split_attention", "t2i_kv")
OFF = "(samrs_prof_off != 0)"  # false at run time; the compiler cannot fold it
GUARD = "__device__ int samrs_prof_off;  // 0: the stages it guards are skipped\n"

# variant -> the (old, new) substitutions made in its source
# the Hopper K1 attention stage and K5 (window_wgmma_kernel, i2t_wgmma_kernel)
K1_VARIANTS = {
    "full": [],
    "loads_only": [("for (int u = lo; u < hi; ++u) {",
                    f"for (int u = lo; u < ({OFF} ? hi : lo); ++u) {{")],
    "no_s": [("for (int kk = 0; kk < 4; ++kk) wgmma_ss_n200(",
              f"for (int kk = 0; kk < ({OFF} ? 4 : 0); ++kk) wgmma_ss_n200(")],
    "no_bias": [("v = fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[WIN + kc - kx * WIN]);",
                 f"v = {OFF} ? fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[WIN + kc - kx * WIN])"
                 " : sacc[4 * j + e] * scale;")],
    "no_pv": [("for (int kk = 0; kk < NPV / 16; ++kk) {",
               f"for (int kk = 0; kk < ({OFF} ? NPV / 16 : 0); ++kk) {{")],
}
K5_VARIANTS = {
    "full": [],
    "no_attention": [("for (int sb = 0; sb < nslot / NTOK; ++sb) {",
                      f"for (int sb = 0; sb < ({OFF} ? nslot / NTOK : 0); ++sb) {{")],
    "no_projections": [("    if constexpr (NW == 128) wgmma_rs_n128(acc, af[kk], db, kk != 0);\n"
                        "    else wgmma_rs_n64(acc, af[kk], db, kk != 0);",
                        f"    if constexpr (NW == 128) {{ if {OFF} "
                        "wgmma_rs_n128(acc, af[kk], db, kk != 0); }\n"
                        f"    else {{ if {OFF} wgmma_rs_n64(acc, af[kk], db, kk != 0); }}")],
}

# the split-TF32 wgmma K11 and the vector-reduction K8 backward; the producer's TMA ring
# stays on in every K11 variant
K11_VARIANTS = {
    "full": [],
    "no_products": [("for (int k = 0; k < 2; ++k) {  // small terms first",
                     f"for (int k = 0; k < ({OFF} ? 2 : 0); ++k) {{  // small terms first")],
    "one_pass_tf32": [("wgmma_tf32<BN>(part, lo[k], dbh + 2 * ks, ks != 0);\n"
                       "    wgmma_tf32<BN>(part, hi[k], dbl + 2 * ks, 1);",
                       f"if {OFF} {{ wgmma_tf32<BN>(part, lo[k], dbh + 2 * ks, ks != 0);\n"
                       "    wgmma_tf32<BN>(part, hi[k], dbl + 2 * ks, 1); }")],
    "no_split": [("hi[k][e] = tf32_rna(a);",
                  f"hi[k][e] = {OFF} ? tf32_rna(a) : __float_as_uint(a);")],
    "no_gelu": [("v0 = gelu_erf(v0);\n            v1 = gelu_erf(v1);",
                 f"if {OFF} {{ v0 = gelu_erf(v0);\n            v1 = gelu_erf(v1); }}")],
    "no_stores": [("if (row < T)\n", f"if (row < T && {OFF})\n")],
}
K8B_CORNER_LOADS = [(f"load_corner<T, V>(img, t.v{c}, t.i{c}, Gc, c, v{c});",
                     f"load_corner<T, V>(img, t.v{c} && {OFF}, t.i{c}, Gc, c, v{c});")
                    for c in ("00", "01", "10", "11")]
K8B_VARIANTS = {
    "full": [],
    "no_dx_reductions": [("if (!valid || w == 0.f) return 0;",
                          f"if (!valid || w == 0.f || !{OFF}) return 0;")],
    "no_corner_loads": K8B_CORNER_LOADS,
    "no_shuffles": [("for (int s = tpg >> 1; s > 0; s >>= 1) {",
                     f"for (int s = ({OFF} ? tpg >> 1 : 0); s > 0; s >>= 1) {{")],
}

# the wgmma K6 fed by TMA and the cluster-per-mask K7
K6_VARIANTS = {
    "full": [],
    "no_conv1": [("    wgmma_ss_n64(d1, da, db, kk != 0);", f"    if {OFF} wgmma_ss_n64(d1, da, db, kk != 0);")],
    "no_ln_gelu1": [("v = gelu_half(fmaf((v - mean) * rstd, plw[d], plb[d]));", "v = fmaf(v, plw[d], plb[d]);")],
    "no_conv2": [("wgmma_rs_n128(d2, a2[kk],", f"if {OFF} wgmma_rs_n128(d2, a2[kk],")],
    "no_gelu2": [("d2[4 * j + e] = gelu_half(fmaf(0.5f, d2[4 * j + e], pb2[8 * (j % 4) + 2 * t + (e & 1)]));",
                  "d2[4 * j + e] = fmaf(0.5f, d2[4 * j + e], pb2[8 * (j % 4) + 2 * t + (e & 1)]);")],
    "no_hyper": [("#pragma unroll 1\n      for (int m = 0; m < M; ++m) {",
                  "      fence_regs(d2);  // GELU2's values stay computed\n#pragma unroll 1\n"
                  f"      for (int m = 0; m < ({OFF} ? M : 0); ++m) {{")],
    "no_stores": [("*reinterpret_cast<float4*>(out + ", f"if {OFF} *reinterpret_cast<float4*>(out + ")],
}
K7_VARIANTS = {
    "full": [],
    "no_vertical": [("for (int j = lane; j < g / 4; j += 32) {",
                     f"for (int j = lane; j < ({OFF} ? g / 4 : 0); j += 32) {{")],
    "no_horizontal": [("const float v = wt[0][q] * vc[0] + wt[1][q] * vc[1] + wt[2][q] * vc[2] + wt[3][q] * vc[3];",
                       "const float v = wt[0][q];")],
    "no_bits": [("if (!(lane & 1) && c0 < Wo) prow[c0 / 8]", f"if (!(lane & 1) && c0 < Wo && {OFF}) prow[c0 / 8]")],
    "no_stats": [("if (tid < 6) {  // field tid over the warps",
                  f"if (tid < 6 && {OFF}) {{  // field tid over the warps"),
                 ("if (band == 0 && tid < 6) {\n    int v = bs[tid];",
                  f"if (band == 0 && tid < 6 && {OFF}) {{\n    int v = bs[tid];")],
    "no_packed_stores": [("for (int i = tid; i < words; i += THREADS)",
                          f"for (int i = tid; i < ({OFF} ? words : 0); i += THREADS)")],
    "no_rows": [("for (int rr = c0r + warp; rr < c0r + cr; rr += WARPS) {",
                 f"for (int rr = c0r + warp; rr < ({OFF} ? c0r + cr : 0); rr += WARPS) {{")],
    "no_copies": [("    mbar_expect_tx(bar, (unsigned)(nrows * g * 4));\n"
                   "    bulk_load(Ls, low + ((size_t)m * g + iy0) * g, (unsigned)(nrows * g * 4), bar);",
                   f"    if {OFF} {{\n      mbar_expect_tx(bar, (unsigned)(nrows * g * 4));\n"
                   "      bulk_load(Ls, low + ((size_t)m * g + iy0) * g, (unsigned)(nrows * g * 4), bar);\n"
                   "    } else {\n      mbar_arrive(bar);\n    }"),
                  ("      xs[c] = c < Wo ? x0[c] : 0;\n"
                   "      const float4 q = c < Wo ? reinterpret_cast<const float4*>(wx)[c] : make_float4(0.f, 0.f, 0.f, 0.f);",
                   f"      xs[c] = c < Wo && {OFF} ? x0[c] : 0;\n"
                   f"      const float4 q = c < Wo && {OFF} ? reinterpret_cast<const float4*>(wx)[c] : "
                   "make_float4(0.f, 0.f, 0.f, 0.f);"),
                  ("      ys[r] = y0[r0 + r] - iy0;\n      wys[r] = reinterpret_cast<const float4*>(wy)[r0 + r];",
                   f"      ys[r] = 0;\n      wys[r] = {OFF} ? reinterpret_cast<const float4*>(wy)[r0 + r] : "
                   "make_float4(0.f, 0.f, 0.f, 0.f);")],
}


# the Hopper redesigns of K8's forward (flat-mapped) and K10 (split-TF32 wgmma)
K8F_VARIANTS = {
    "full": [],
    "no_coords": [("    const I i0 = q * KT;\n    if constexpr (KT == 4) {",
                   "    const I i0 = q * KT;\n"
                   f"    if (!{OFF}) {{\n"
                   "      for (int k = 0; k < KT; ++k)\n"
                   "        tx[k] = 0.25f + (float)(q % W), ty[k] = 0.25f + (float)((q / W) % H), tm[k] = 1.f;\n"
                   "    } else if constexpr (KT == 4) {"),
                  ("const Tap t = make_tap(fx[i], fy[i], H, W);\n      const float m = mask[i];",
                   f"const Tap t = {OFF} ? make_tap(fx[i], fy[i], H, W)\n"
                   "          : make_tap(0.25f + (float)(q % W), 0.25f + (float)((q / W) % H), H, W);\n"
                   f"      const float m = {OFF} ? mask[i] : 1.f;")],
    "no_corners": [(f"  load_corner<T, V>(img, t.v{c}, t.i{c}, Gc, c, v[{i}]);",
                    f"  load_corner<T, V>(img, t.v{c} && {OFF}, t.i{c}, Gc, c, v[{i}]);")
                   for i, c in enumerate(("00", "01", "10", "11"))],
    "no_stores": [("  store_out(o + c, acc);\n",
                   "  for (int e = 0; e < V; ++e) asm volatile(\"\" ::\"f\"(acc[e]));  // kept\n"
                   f"  if {OFF} store_out(o + c, acc);\n"),
                  ("  if (n == 4) {\n    store_out(out + f0, acc);",
                   "  for (int e = 0; e < 4; ++e) asm volatile(\"\" ::\"f\"(acc[e]));  // kept\n"
                   f"  if (!{OFF}) {{\n  }} else if (n == 4) {{\n    store_out(out + f0, acc);")],
}
K10_VARIANTS = {
    "full": [],
    "no_qk": [("    if (ks < D / 8) {  // small terms first",
               f"    if (ks < D / 8 && {OFF}) {{  // small terms first")],
    "no_softmax": [("    for (int h = 0; h < 2; ++h) {\n      float mx = neg_inf();",
                    f"    for (int h = 0; h < ({OFF} ? 2 : 0); ++h) {{\n      float mx = neg_inf();")],
    "no_pv": [("      wgmma_pv<D>(pv, pl[jj], dvh, jj != 0);\n      wgmma_pv<D>(pv, ph[jj], dvl, 1);\n"
               "      wgmma_pv<D>(pv, ph[jj], dvh, 1);",
               f"      if {OFF} {{\n      wgmma_pv<D>(pv, pl[jj], dvh, jj != 0);\n"
               "      wgmma_pv<D>(pv, ph[jj], dvl, 1);\n      wgmma_pv<D>(pv, ph[jj], dvh, 1); }")],
    "no_split": [("  kv_split_kernel<D><<<", "  if (0) kv_split_kernel<D><<<")],
    "split_only": [("  plain_attention_kernel<D><<<", "  if (0) plain_attention_kernel<D><<<")],
}


# K12's Hopper forms: the window form (K1's pipeline, csrc/window_attention.cu) and the
# query-tiled form (K2's, csrc/flash_attention.cu); the switched-off stages are those of the
# split-head paths where the pipelines part (the loads, the bias, the stores), else shared
_EX2 = "ex2(fmaf(sacc[4 * j + 2 * half{}], kLog2e, mb[half]))"
_NO_EXP = [(_EX2.format(x), f"({OFF} ? {_EX2.format(x)} : sacc[4 * j + 2 * half{x}])")
           for x in ("", " + 1")]
SAW_VARIANTS = {
    "full": [],
    "no_kv_loads": [("          mbar_expect_tx(&full[s], 3 * nbox * (128 + (S::TAIL ? 32 : 0)));\n"
                     "#pragma unroll\n          for (int part = 0; part < 3; ++part) {",
                     f"          mbar_expect_tx(&full[s], ({OFF} ? 3 : 1) * nbox * (128 + (S::TAIL ? 32 : 0)));\n"
                     f"#pragma unroll\n          for (int part = 0; part < ({OFF} ? 3 : 1); ++part) {{")],
    "no_products": [("for (int kk = 0; kk < 4; ++kk) wgmma_ss_n200(",
                     f"for (int kk = 0; kk < ({OFF} ? 4 : 0); ++kk) wgmma_ss_n200("),
                    ("for (int kk = 0; kk < NPV / 16; ++kk) {",
                     f"for (int kk = 0; kk < ({OFF} ? NPV / 16 : 0); ++kk) {{")],
    "no_softmax": _NO_EXP,
    "no_bias": [("v = fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[GH + kc - kx * GW]);",
                 f"v = {OFF} ? fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[GH + kc - kx * GW])"
                 " : sacc[4 * j + e] * scale;")],
    "no_stores": [("          if (lr >= rows) continue;", f"          if (lr >= rows || !{OFF}) continue;")],
}
SAT_VARIANTS = {
    "full": [],
    "no_kv_loads": [("        load_head_tile<HD>(Ks(s), &maps.main[1], &maps.tail[1], &full_k[s], col(1), tile * BKT, b);\n"
                     "        load_head_tile<HD>(Vs(s), &maps.main[2], &maps.tail[2], &full_v[s], col(2), tile * BKT, b);",
                     f"        if ({OFF}) {{\n"
                     "        load_head_tile<HD>(Ks(s), &maps.main[1], &maps.tail[1], &full_k[s], col(1), tile * BKT, b);\n"
                     "        load_head_tile<HD>(Vs(s), &maps.main[2], &maps.tail[2], &full_v[s], col(2), tile * BKT, b);\n"
                     "        } else {\n          mbar_arrive(&full_k[s]);\n          mbar_arrive(&full_v[s]);\n        }")],
    "no_products": [("for (int kk = 0; kk < 4; ++kk) wgmma_s_tile(",
                     f"for (int kk = 0; kk < ({OFF} ? 4 : 0); ++kk) wgmma_s_tile("),
                    ("    for (int kk = 0; kk < BKT / 16; ++kk) {",
                     f"    for (int kk = 0; kk < ({OFF} ? BKT / 16 : 0); ++kk) {{")],
    "no_softmax": _NO_EXP + [("      alpha[half] = ex2((m[half] - m_new) * kLog2e);",
                              f"      alpha[half] = {OFF} ? ex2((m[half] - m_new) * kLog2e) : 1.f;")],
    "no_bias": [("            v = fmaf(sacc[4 * j + e], s_scale, rh[half][r] + rw[half][key - r * KW]);",
                 f"            v = {OFF} ? fmaf(sacc[4 * j + e], s_scale, rh[half][r] + rw[half][key - r * KW])"
                 " : sacc[4 * j + e] * s_scale;"),
                ("                                 bh[half][j / JW] + wreg[half][2 * (j % JW) + (e & 1)]);",
                 f"                                 {OFF} ? bh[half][j / JW] + wreg[half][2 * (j % JW) + (e & 1)]"
                 " : 0.f);")],
    "no_stores": [("    if (r >= N) continue;\n    const float inv = 1.f / l[half];\n    if constexpr (SPLIT) {",
                   f"    if (r >= N) continue;\n    const float inv = 1.f / l[half];\n    if constexpr (SPLIT) {{\n"
                   f"      if (!{OFF}) continue;")],
}
# K4's Hopper form (32-row blocks, both weights by TMA, wgmma)
KV_VARIANTS = {
    "full": [],
    "no_tile_loads": [("    xv[k] = *reinterpret_cast<const float4*>(x + (size_t)i * 4);\n"
                       "    pv[k] = *reinterpret_cast<const float4*>(p + (size_t)i * 4);",
                       f"    xv[k] = {OFF} ? *reinterpret_cast<const float4*>(x + (size_t)i * 4) : make_float4(0.f, 0.f, 0.f, 0.f);\n"
                       f"    pv[k] = {OFF} ? *reinterpret_cast<const float4*>(p + (size_t)i * 4) : make_float4(0.f, 0.f, 0.f, 0.f);")],
    "no_weight_loads": [("    mbar_expect_tx(wbar, 2 * WB_BYTES);\n    for (int kc = 0; kc < C / 64; ++kc) {",
                         f"    mbar_expect_tx(wbar, {OFF} ? 2 * WB_BYTES : 0);\n"
                         f"    for (int kc = 0; kc < ({OFF} ? C / 64 : 0); ++kc) {{")],
    "no_products": K5_VARIANTS["no_projections"],
    "no_stores": [("  if (wi * 16 >= KV_ROWS) return;", f"  if (wi * 16 >= KV_ROWS || !{OFF}) return;")],
}


# K12 and K4 before their Hopper redesign (csrc/split_attention.cu: warp-level mma.sync kernels
# built from csrc/warp_attention.cuh, inlined into the variant so that its stages can be
# switched off; csrc/twoway.cu's t2i_kv_kernel: cp.async weights, mma.sync from shared memory);
# the next PR deletes these two sets
SA_PARENT_VARIANTS = {
    "full": [],
    "no_kv_loads": [("    cp_async16(Ks + r * LD + c * 8, kb + src, r < N);\n"
                     "    cp_async16(Vs + r * LD + c * 8, vb + src, r < N);",
                     f"    cp_async16(Ks + r * LD + c * 8, kb + src, r < N && {OFF});\n"
                     f"    cp_async16(Vs + r * LD + c * 8, vb + src, r < N && {OFF});"),
                    ("    load_tile_rows_async<HD>(Ks[stage], kb, k0, N, HD, 0, LD);\n"
                     "    load_tile_rows_async<HD>(Vs[stage], vb, k0, N, HD, 0, LD);",
                     f"    if ({OFF}) {{\n"
                     "    load_tile_rows_async<HD>(Ks[stage], kb, k0, N, HD, 0, LD);\n"
                     "    load_tile_rows_async<HD>(Vs[stage], vb, k0, N, HD, 0, LD); }")],
    "no_products": [("        mma_16816(s[2 * kb], qa[kk], b[0], b[1]);\n"
                     "        mma_16816(s[2 * kb + 1], qa[kk], b[2], b[3]);",
                     f"        if ({OFF}) {{ mma_16816(s[2 * kb], qa[kk], b[0], b[1]);\n"
                     "        mma_16816(s[2 * kb + 1], qa[kk], b[2], b[3]); }"),
                    ("        mma_16816(st.o[2 * dp], pa[kb], b[0], b[1]);\n"
                     "        mma_16816(st.o[2 * dp + 1], pa[kb], b[2], b[3]);",
                     f"        if ({OFF}) {{ mma_16816(st.o[2 * dp], pa[kb], b[0], b[1]);\n"
                     "        mma_16816(st.o[2 * dp + 1], pa[kb], b[2], b[3]); }")],
    "no_softmax": [("    alpha[half] = softmax_exp<EXP2>(st.m[half] - m_new);",
                    f"    alpha[half] = {OFF} ? softmax_exp<EXP2>(st.m[half] - m_new) : 1.f;"),
                   ("          const __nv_bfloat162 p =\n"
                    "              __floats2bfloat162_rn(softmax_exp<EXP2>(s[j][2 * half] - st.m[half]),\n"
                    "                                    softmax_exp<EXP2>(s[j][2 * half + 1] - st.m[half]));",
                    f"          const __nv_bfloat162 p = !{OFF} ? __floats2bfloat162_rn(s[j][2 * half], "
                    "s[j][2 * half + 1]) :\n"
                    "              __floats2bfloat162_rn(softmax_exp<EXP2>(s[j][2 * half] - st.m[half]),\n"
                    "                                    softmax_exp<EXP2>(s[j][2 * half + 1] - st.m[half]));")],
    "no_bias": [("        const float v = s[j][e] * scale + bias(half, j * 8 + 2 * t + (e & 1));",
                 f"        const float v = {OFF} ? s[j][e] * scale + bias(half, j * 8 + 2 * t + (e & 1))"
                 " : s[j][e] * scale;")],
    "no_stores": [("    if (r >= n) continue;\n    const float inv = 1.f / st.l[half];",
                   f"    if (r >= n || !{OFF}) continue;\n    const float inv = 1.f / st.l[half];")],
}
SA_PARENT_SIGNATURES = {"samrs_split_attention": ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 +
                                                  [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
                                                  ctypes.c_int)}
KV_PARENT_VARIANTS = {
    "full": [],
    "no_tile_loads": [("    v[k] = *reinterpret_cast<const float4*>(x + (size_t)r * C + c);",
                       f"    v[k] = {OFF} ? *reinterpret_cast<const float4*>(x + (size_t)r * C + c)"
                       " : make_float4(0.f, 0.f, 0.f, 0.f);"),
                      ("      q[k] = *reinterpret_cast<const float4*>(p + (size_t)r * C + c);",
                       f"      q[k] = {OFF} ? *reinterpret_cast<const float4*>(p + (size_t)r * C + c)"
                       " : make_float4(0.f, 0.f, 0.f, 0.f);")],
    "no_weight_loads": [("  load_rows_async<THREADS>(Ws, LDW256, Wk, CI, C);",
                         f"  if ({OFF}) load_rows_async<THREADS>(Ws, LDW256, Wk, CI, C);"),
                        ("  load_rows_async<THREADS>(Ws, LDW256, Wv, CI, C);",
                         f"  if ({OFF}) load_rows_async<THREADS>(Ws, LDW256, Wv, CI, C);")],
    "no_second_weight": [("  load_rows_async<THREADS>(Ws, LDW256, Wv, CI, C);",
                          f"  if ({OFF}) load_rows_async<THREADS>(Ws, LDW256, Wv, CI, C);")],
    "no_products": [("  warp_gemm<8, C>(acc, As + wr * 16 * LDA, LDA, Ws + wc * 64 * LDW256, LDW256);",
                     f"  if ({OFF}) warp_gemm<8, C>(acc, As + wr * 16 * LDA, LDA, Ws + wc * 64 * LDW256,"
                     " LDW256);")],
    "no_stores": [("    const float b0 = bias[n], b1 = bias[n + 1];",
                   f"    if (!{OFF}) continue;\n    const float b0 = bias[n], b1 = bias[n + 1];")],
}


# its Hopper redesign (the coordinates read by the kernel; SMEM / BANDS / GLOBAL forms), and
# its SMEM form's points a thread / threads a block / blocks an SM (registers) in the forward
# (fwd_*) and the backward of dimg alone (bwd_*; its points a thread also in the backward with
# the coordinate gradient): "v<points>_t<threads>_b<blocks>"
_PS_SHAPE = ("constexpr int FWD_VEC = 4, SMEM_FWD_THREADS = 512, SMEM_FWD_BLOCKS = 3;\n"
             "constexpr int BWD_VEC = 2, SMEM_BWD_THREADS = 256, SMEM_BWD_BLOCKS = 6;")


def _ps_shape(fwd=(4, 512, 3), bwd=(2, 256, 6)):
    return [(_PS_SHAPE, "constexpr int FWD_VEC = %d, SMEM_FWD_THREADS = %d, SMEM_FWD_BLOCKS = %d;\n"
             "constexpr int BWD_VEC = %d, SMEM_BWD_THREADS = %d, SMEM_BWD_BLOCKS = %d;"
             % (*fwd, *bwd))]


PS_VARIANTS = {
    "full": [],
    "no_coords": [("    if constexpr (COORDS) {\n      load_stream<2 * V>(a + 2 * f, r);",
                   f"    if (!{OFF}) {{  // hashed points, uniform over the map\n"
                   "      for (int e = 0; e < 2 * V; ++e) {\n"
                   "        const float u = (float)(((unsigned)(2 * f + e) * 2654435761u) >> 8) "
                   "* 5.9604645e-8f;\n"
                   "        r[e] = COORDS ? u : u * ((e & 1) ? H : W) - 0.5f;\n      }\n"
                   "      return;\n    }\n"
                   "    if constexpr (COORDS) {\n      load_stream<2 * V>(a + 2 * f, r);")],
    "no_corners": [("    if (!valid) return 0.f;", f"    if (!valid || !{OFF}) return 0.f;")],
    "no_stores": [("    store_stream<V>(out + f, o);",
                   "    for (int q = 0; q < V; ++q) asm volatile(\"\" ::\"f\"(o[q]));  // kept\n"
                   f"    if {OFF} store_stream<V>(out + f, o);"),
                  ("    if constexpr (GRAD) grads.template store<V>(f, gxy);",
                   "    if constexpr (GRAD) {\n"
                   "      for (int e = 0; e < 2 * V; ++e) asm volatile(\"\" ::\"f\"(gxy[e]));  // kept\n"
                   f"      if {OFF} grads.template store<V>(f, gxy);\n"
                   "    }"),
                  ("  write_band(dgb, shi, slo, nel, to);",
                   f"  if {OFF} write_band(dgb, shi, slo, nel, to);")],
    "no_atomics": [("      if (h) atomicAdd(hi + (i - i0), h);\n      if (l) atomicAdd(lo + (i - i0), l);",
                    f"      if (h && {OFF}) atomicAdd(hi + (i - i0), h);\n"
                    f"      if (l && {OFF}) atomicAdd(lo + (i - i0), l);"),
                   ("      if (v != 0.f) atomicAdd(p + i, v);",
                    f"      if (v != 0.f && {OFF}) atomicAdd(p + i, v);")],
    # dimg's partial in fp32 (shared atomicAdd: a CAS loop) instead of fixed point
    "float_dimg": [("      if (h) atomicAdd(hi + (i - i0), h);\n      if (l) atomicAdd(lo + (i - i0), l);",
                    "      atomicAdd(reinterpret_cast<float*>(hi) + (i - i0), v);"),
                   ("  write_band(dgb, shi, slo, nel, to);",
                    "  for (int e = threadIdx.x; e < nel; e += THREADS)\n"
                    "    dgb[e] = reinterpret_cast<const float*>(shi)[e];")],
    "no_staging": [("    mbar_expect_tx(bar, bytes);\n    if (bytes) bulk_load(s + h, g + h, bytes, bar);",
                    f"    mbar_expect_tx(bar, {OFF} ? bytes : 0u);\n"
                    f"    if (bytes && {OFF}) bulk_load(s + h, g + h, bytes, bar);")],
    "fwd_v4_t512_b2": _ps_shape(fwd=(4, 512, 2)),
    "fwd_v2_t256_b6": _ps_shape(fwd=(2, 256, 6)),
    "bwd_v1_t256_b8": _ps_shape(bwd=(1, 256, 8)),
    "bwd_v4_t512_b3": _ps_shape(bwd=(4, 512, 3)),
}


# The reduction-rate micro-benchmark (--what rates): four ways to add g * w of every valid
# corner of every tap into a (BG, H, W, Gc) fp32 map, Gc 16.  Each group of 4 lanes owns one
# query and 4 channels; the owner kernel takes a row-binned entry list (entry = 2 * tap + dy).
RATES_CU = r"""
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct Corners { int x0, y0; float wx, wy; };

__device__ __forceinline__ Corners corners(float fx, float fy) {
  Corners c;
  const float x0f = floorf(fx), y0f = floorf(fy);
  c.wx = fx - x0f; c.wy = fy - y0f;
  c.x0 = (int)fminf(fmaxf(x0f, -2.f), 4096.f);
  c.y0 = (int)fminf(fmaxf(y0f, -2.f), 4096.f);
  return c;
}

__device__ __forceinline__ float cw(const Corners& c, int dy, int dx) {
  return (dx ? c.wx : 1.f - c.wx) * (dy ? c.wy : 1.f - c.wy);
}

// MODE 0: scalar red.global.add.f32 per channel; 1: red.global.add.v4.f32 per 4 channels
template <int MODE>
__global__ void __launch_bounds__(256) red_global(const float* fx, const float* fy,
                                                  const float* mask, const float* dout, float* dx,
                                                  int BG, int H, int W, int P, int K) {
  constexpr int GC = 16;
  const long long gid = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long q = gid >> 2;
  const int c = (int)(gid & 3) * 4;
  if (q >= (long long)BG * P) return;
  const int bg = (int)(q / P);
  const float4 r = *reinterpret_cast<const float4*>(dout + q * GC + c);
  float* map = dx + (size_t)bg * H * W * GC;
  for (int k = 0; k < K; ++k) {
    const size_t i = (size_t)q * K + k;
    const Corners t = corners(fx[i], fy[i]);
    const float m = mask[i];
    for (int dy = 0; dy < 2; ++dy)
      for (int dxx = 0; dxx < 2; ++dxx) {
        const int x = t.x0 + dxx, y = t.y0 + dy;
        if (x < 0 || x >= W || y < 0 || y >= H) continue;
        const float w = m * cw(t, dy, dxx);
        float* d = map + ((size_t)y * W + x) * GC + c;
        if (MODE == 0) {
          atomicAdd(d, r.x * w); atomicAdd(d + 1, r.y * w);
          atomicAdd(d + 2, r.z * w); atomicAdd(d + 3, r.w * w);
        } else {
          atomicAdd(reinterpret_cast<float4*>(d), make_float4(r.x * w, r.y * w, r.z * w, r.w * w));
        }
      }
  }
}

// one block per bg: the map in shared memory, fp32 atomicAdd per channel, one plain store a value
__global__ void __launch_bounds__(1024) red_shared_atomic(const float* fx, const float* fy,
                                                          const float* mask, const float* dout,
                                                          float* dx, int H, int W, int P, int K) {
  constexpr int GC = 16;
  extern __shared__ float smap[];
  const int bg = blockIdx.x, n = H * W * GC;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smap[i] = 0.f;
  __syncthreads();
  for (int g = threadIdx.x; g < P * 4; g += blockDim.x) {
    const int p = g >> 2, c = (g & 3) * 4;
    const size_t q = (size_t)bg * P + p;
    const float4 r = *reinterpret_cast<const float4*>(dout + q * GC + c);
    for (int k = 0; k < K; ++k) {
      const size_t i = q * K + k;
      const Corners t = corners(fx[i], fy[i]);
      const float m = mask[i];
      for (int dy = 0; dy < 2; ++dy)
        for (int dxx = 0; dxx < 2; ++dxx) {
          const int x = t.x0 + dxx, y = t.y0 + dy;
          if (x < 0 || x >= W || y < 0 || y >= H) continue;
          const float w = m * cw(t, dy, dxx);
          float* d = smap + (y * W + x) * GC + c;
          atomicAdd(d, r.x * w); atomicAdd(d + 1, r.y * w);
          atomicAdd(d + 2, r.z * w); atomicAdd(d + 3, r.w * w);
        }
    }
  }
  __syncthreads();
  float* out = dx + (size_t)bg * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = smap[i];
}

// one block per bg, the map in shared memory; warp w owns rows w, w + 32, ...; its lanes cover
// the two corners (x0, x0 + 1) x 16 channels of one binned entry and add with plain loads and
// stores (no other warp touches the row)
__global__ void __launch_bounds__(1024) red_shared_owner(const float* fx, const float* fy,
                                                         const float* mask, const float* dout,
                                                         const int* entries, const int* row_start,
                                                         float* dx, int H, int W, int P, int K) {
  constexpr int GC = 16;
  extern __shared__ float smap[];
  const int bg = blockIdx.x, n = H * W * GC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < n; i += blockDim.x) smap[i] = 0.f;
  __syncthreads();
  const int dxx = lane >> 4, ch = lane & 15;
  for (int y = warp; y < H; y += blockDim.x >> 5) {
    const int b = row_start[bg * H + y], e = row_start[bg * H + y + 1];
    float* row = smap + y * W * GC;
    for (int j = b; j < e; ++j) {
      const int ent = entries[j];
      const int tap = ent >> 1, dy = ent & 1;
      const Corners t = corners(fx[tap], fy[tap]);
      const int x = t.x0 + dxx;
      const float g = mask[tap] * dout[(size_t)(tap / K) * GC + ch];
      if (x >= 0 && x < W) row[x * GC + ch] += g * cw(t, dy, dxx);
      __syncwarp();  // the next entry's corners may be this one's
    }
  }
  __syncthreads();
  float* out = dx + (size_t)bg * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = smap[i];
}

}  // namespace

extern "C" {
int rates_global(const void* fx, const void* fy, const void* mask, const void* dout, void* dx,
                 int BG, int H, int W, int P, int K, int vec, void* stream) {
  const long long threads = (long long)BG * P * 4;
  const unsigned blocks = (unsigned)((threads + 255) / 256);
  cudaStream_t s = (cudaStream_t)stream;
  const float *a = (const float*)fx, *b = (const float*)fy, *m = (const float*)mask,
              *r = (const float*)dout;
  if (vec) red_global<1><<<blocks, 256, 0, s>>>(a, b, m, r, (float*)dx, BG, H, W, P, K);
  else red_global<0><<<blocks, 256, 0, s>>>(a, b, m, r, (float*)dx, BG, H, W, P, K);
  return cudaGetLastError();
}

int rates_shared(const void* fx, const void* fy, const void* mask, const void* dout,
                 const void* entries, const void* row_start, void* dx, int BG, int H, int W, int P,
                 int K, int owner, void* stream) {
  const int smem = H * W * 16 * 4;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaFuncSetAttribute(owner ? (const void*)red_shared_owner
                                             : (const void*)red_shared_atomic,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (owner)
    red_shared_owner<<<BG, 1024, smem, s>>>((const float*)fx, (const float*)fy,
                                            (const float*)mask, (const float*)dout,
                                            (const int*)entries, (const int*)row_start,
                                            (float*)dx, H, W, P, K);
  else
    red_shared_atomic<<<BG, 1024, smem, s>>>((const float*)fx, (const float*)fy,
                                             (const float*)mask, (const float*)dout, (float*)dx,
                                             H, W, P, K);
  return cudaGetLastError();
}
}
"""

def variant_source(src: Path, subs, dst: Path, inline=()) -> None:
    """`src` with the substitutions `subs` (each old text must be there) and
    the run-time guard of the switched-off stages, written to `dst`; the
    headers named in `inline` are copied in place of their includes first,
    so that the substitutions reach them too."""
    text = src.read_text()
    for header in inline:
        body = (src.parent / header).read_text().replace("#pragma once\n", "", 1)
        text = text.replace(f'#include "{header}"\n', body, 1)
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{src.name}: '{old}' not found: not the kernel this script profiles")
        text = text.replace(old, new)
    marker = "namespace samrs {\n"
    if subs and marker not in text:
        raise SystemExit(f"{src.name}: no namespace samrs to put the guard in")
    dst.write_text(text.replace(marker, marker + GUARD, 1) if subs else text)


def build(csrc: Path, out: Path, specs, rates: bool = False):
    """Builds every variant of `specs` ((kernel, source file, variants[,
    headers to inline])) into its own shared library, and the rate
    micro-benchmark if `rates`; returns {(kernel, variant): CDLL} and the
    nvcc logs under the same keys."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    jobs = []
    for kernel, fname, variants, *inline in specs:
        for name, subs in variants.items():
            d = out / f"{kernel}_{name}"
            shutil.copytree(csrc, d)
            variant_source(csrc / fname, subs, d / fname, *inline)
            lib = d / "lib.so"
            jobs.append(((kernel, name), lib, [_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                                               "-o", str(lib), str(d / fname)]))
    if rates:
        src = out / "rates.cu"
        src.write_text(RATES_CU)
        jobs.append((("rates", "all"), out / "rates.so", [_build._nvcc(), *_build.NVCC_FLAGS,
                                                          "-shared", "-o", str(out / "rates.so"),
                                                          str(src)]))
    procs = [(key, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                         text=True)) for key, lib, cmd in jobs]
    libs, logs = {}, {}
    for key, lib, p in procs:
        logs[key] = log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        libs[key] = lib = ctypes.CDLL(str(lib))
        for name, (argtypes, restype) in _build._SIGNATURES.items():
            if hasattr(lib, name):
                getattr(lib, name).argtypes, getattr(lib, name).restype = argtypes, restype
    return libs, logs


def print_registers(logs, keys) -> None:
    """The ptxas lines (registers, spills, shared memory) of each kernel in
    the logs of `keys`."""
    for key in keys:
        lines = logs[key].splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "_kernel" in line:
                print("\n".join(x.strip() for x in lines[i:i + 4]), flush=True)


def loop_ms(fn, n: int = 20, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def call(lib, name: str, *args, signatures=None) -> None:
    """C entry `name` of `lib` on the current stream (`signatures`: those of
    a parent tree's sources where they differ from this tree's)."""
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = (signatures or _build._SIGNATURES)[name]
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def wrapper_cases():
    """The main path's K1 attention stage and K5 calls through the wrappers."""
    from samrs_tpu_torch.kernels import (fused_attention, fused_twoway, fused_window_block,
                                         fused_window_layer)

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    C, nH, hd, G, ws = 1280, 16, 80, 64, 14
    qkv, bqkv = rn(1, G, G, 3 * C).bfloat16(), rn(3 * C, std=0.5)
    Rh, Rw = rn(ws, ws, hd, std=0.1), rn(ws, ws, hd, std=0.1)
    qkv_win = rn(25, ws * ws, 3 * C).bfloat16()  # the 25 windows of the padded map, partitioned
    qkv70 = rn(1, 70, 70, 3 * C).bfloat16()  # the same windows on a map that needs no pad
    Bp, N, D, Ci, S = 64, G * G, 256, 128, 16
    keysB, keys1, pe = rn(Bp, N, D), rn(1, N, D), rn(N, D)
    tok = (rn(Bp, S, Ci), rn(Bp, S, Ci), torch.where(torch.arange(S, device="cuda") < 7, 0.0, -1e9))
    w = (rn(Ci, D, std=D ** -0.5), rn(Ci), rn(D, Ci, std=Ci ** -0.5), rn(D), 1 + rn(D, std=0.1),
         rn(D), rn(Ci, D, std=D ** -0.5), rn(Ci), rn(Ci, D, std=D ** -0.5), rn(Ci), 8)
    cases = {
        "K1 fused2": lambda: fused_window_block.window_attention_partition_free(
            qkv, Rh, Rw, ws, hd ** -0.5, nH, pad_fill=bqkv),
        "K1 ijb stage": lambda: fused_window_layer.window_attention_cuda(
            qkv, bqkv, Rh, Rw, ws, hd ** -0.5, nH, order="ijb"),
        "K1 fused windows": lambda: fused_attention.attention_qkv_fused(
            qkv_win, Rh, Rw, (ws, ws), hd ** -0.5, nH),
        "K1 fused2 70x70": lambda: fused_window_block.window_attention_partition_free(
            qkv70, Rh, Rw, ws, hd ** -0.5, nH, pad_fill=bqkv),
        "K5 per-prompt": lambda: fused_twoway.i2t_update(keysB, pe, *tok, *w,
                                                         out_dtype=torch.bfloat16),
        "K5 shared": lambda: fused_twoway.i2t_update(keys1, pe, *tok, *w),
    }
    return cases


def attention_part(libs, logs):
    """K1's attention stage and K5 with one stage switched off, through the
    wrappers' calls with each variant's library swapped in; {case: ms}."""
    results = {}
    for case, fn in wrapper_cases().items():
        kernel = case.split()[0]
        for (k, name), lib in libs.items():
            if k != kernel:
                continue
            _build._lib = lib
            results[f"{case} {name}"] = device_ms(fn)
            if name == "full":  # and the whole call, host work included
                results[f"{case} {name}"]["wall"] = loop_ms(fn)
            print(f"{case} {name}: " + ", ".join(f"{a} {b:.4f}" for a, b in
                                                results[f"{case} {name}"].items()), flush=True)
    _build._lib = None
    print_registers(logs, [("K1", "full"), ("K5", "full")])
    return results


def dcn_level0(gen, BG: int = 260, H: int = 56, Gc: int = 16, offsets: bool = True):
    """InternImage-T level 0 at the FAST head: xg (BG, H, H*Gc), fx, fy, mask
    (BG, H*H, 9) on a 3x3 ring with offsets up to 1.5 px (none: every tap
    on a pixel, as at initialisation), dout (BG, H*H, Gc)."""
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    P, K = H * H, 9
    bx, by = bg._dcnv3_base_grid(H, H, 3, 3, 1, 1, 1, 1, 1, 1)
    u = lambda: (torch.rand(BG, P, K, generator=gen, device="cuda") * 3 - 1.5 if offsets
                 else torch.zeros(BG, P, K, device="cuda"))
    fx = (torch.from_numpy(bx).cuda() + u()).contiguous()
    fy = (torch.from_numpy(by).cuda() + u()).contiguous()
    mask = torch.rand(BG, P, K, generator=gen, device="cuda")
    xg = torch.randn(BG, H, H * Gc, generator=gen, device="cuda")
    dout = torch.randn(BG, P, Gc, generator=gen, device="cuda")
    return xg, fx, fy, mask, dout


def mlp_gather_part(libs, logs):
    """K11 and K8's backward with one stage switched off: K11 through its
    wrapper with the variant's library swapped in, K8's backward by direct
    calls; {case: ms}."""
    from samrs_tpu_torch.kernels import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr
    results = {}
    for label, T, C, on_chip in (("vit_b_512", 8192, 768, False),
                                 ("internimage_l0", 203840, 64, True),
                                 ("internimage_l0_two_launch", 203840, 64, False)):
        M = 4 * C
        x, w1, b1 = rn(T, C), rn(M, C, std=C ** -0.5), rn(M, std=0.1)
        w2, b2 = rn(C, M, std=M ** -0.5), rn(C, std=0.1)
        for name in K11_VARIANTS:
            _build._lib = libs[("K11", name)]
            fm._halves.clear()  # split by this variant's library
            ms = loop_ms(lambda: fm.fused_mlp_cuda(x, w1, b1, w2, b2, on_chip=on_chip))
            results[f"K11 {label} {name}"] = ms
            print(f"K11 {label} {name}: {ms:.4f} ms", flush=True)
        del x, w1, b1, w2, b2
    _build._lib = None
    cases = {"internimage_l0": dcn_level0(gen)}
    cases["internimage_l0_zero"] = dcn_level0(gen, offsets=False)
    BGm, Hm, Gm, Pm, Km = 520, 28, 32, 1029, 4  # the MSDeformAttn level
    cases["msda_l28"] = (rn(BGm, Hm, Hm * Gm),
                         torch.rand(BGm, Pm, Km, generator=gen, device="cuda") * (Hm + 2) - 1.5,
                         torch.rand(BGm, Pm, Km, generator=gen, device="cuda") * (Hm + 2) - 1.5,
                         torch.rand(BGm, Pm, Km, generator=gen, device="cuda"), rn(BGm, Pm, Gm))
    BGr = 780  # RVSA: 65 images x 12 heads, K and V in one launch
    cases["rvsa"] = (rn(BGr, 14, 14 * 128),
                     torch.rand(BGr, 196, 1, generator=gen, device="cuda") * 16 - 1.5,
                     torch.rand(BGr, 196, 1, generator=gen, device="cuda") * 16 - 1.5,
                     torch.ones(BGr, 196, 1, device="cuda"), rn(BGr, 196, 128))
    for label, (xg, fx, fy, mask, dout) in cases.items():
        BG, H, WGc = xg.shape
        _, P, K = fx.shape
        Gc = dout.shape[2]
        dxg = torch.zeros_like(xg)
        dfx, dfy, dmask = (torch.empty_like(fx) for _ in range(3))
        for name in K8B_VARIANTS:
            lib = libs[("K8b", name)]
            results[f"K8b {label} {name}"] = ms = loop_ms(lambda: call(
                lib, "samrs_bilinear_bwd", p(xg), p(fx.contiguous()), p(fy.contiguous()),
                p(mask.contiguous()), p(dout), p(dxg), p(dfx), p(dfy), p(dmask), None,
                BG, H, WGc // Gc, P, K, Gc, 0))
            print(f"K8b {label} {name}: {ms:.4f} ms", flush=True)
        results[f"K8b {label} dxg memset"] = ms = loop_ms(dxg.zero_)
        print(f"K8b {label} dxg memset: {ms:.4f} ms", flush=True)
    print_registers(logs, [("K11", "full"), ("K8b", "full")])
    return results


def tree_module(csrc: Path, name: str):
    """The kernel wrapper module `name` of the tree whose csrc is `csrc`
    (imported under another name; it uses this tree's ``_build``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(f"profiled_{name}",
                                                  csrc.parent / "kernels" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decoder_tail_part(csrc: Path, libs, logs):
    """K6 and K7 with one stage switched off, by direct calls, and K7's full
    variant through the profiled tree's own wrapper; {case: ms}."""
    from samrs_tpu_torch.kernels import amg_post
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr
    results = {}
    D, C1, C2, G = 256, 64, 32, 64
    w1 = rn(4 * C1, D, std=D ** -0.5).bfloat16()  # rows (2i + j) * 64 + d, columns the channel
    w2 = rn(4 * C2, C1, std=C1 ** -0.5).bfloat16()
    b1, lnw, lnb, b2 = rn(C1, std=0.1), 1 + rn(C1, std=0.1), rn(C1, std=0.1), rn(C2, std=0.1)
    for B in (64, 256):
        src = rn(B, G, G, D).bfloat16()
        hyper = rn(B, 1, C2)
        out = torch.empty(B, 1, 4 * G, 4 * G, device="cuda")
        for name, lib in sorted((k[1], v) for k, v in libs.items() if k[0] == "K6"):
            fn = lambda: call(lib, "samrs_upscale_hyper", p(src), p(w1), p(b1), p(lnw), p(lnb),
                              p(w2), p(b2), p(hyper), p(out), B, G, G, 1, 1e-6)
            r = results[f"K6 bucket{B} {name}"] = device_ms(fn)
            if name == "full":
                r["loop"] = loop_ms(fn)
            print(f"K6 bucket{B} {name}: " + ", ".join(f"{a} {b:.4f}" for a, b in r.items()),
                  flush=True)
        del src, out
    M, g, img, inp, orig = 32, 256, 1024, (1024, 1024), (800, 800)
    low = rn(M, g, g, std=4.0)
    y0, wy = (torch.from_numpy(a).cuda() for a in amg_post._band(g, img, inp[0], orig[0]))
    x0, wx = (torch.from_numpy(a).cuda() for a in amg_post._band(g, img, inp[1], orig[1]))
    packed = torch.empty(M, orig[0], (orig[1] + 7) // 8, device="cuda", dtype=torch.uint8)
    stats = torch.zeros(M, 6, device="cuda", dtype=torch.int32)
    rows = amg_post._band_rows(g, img, inp[0], orig[0])
    for name, lib in sorted((k[1], v) for k, v in libs.items() if k[0] == "K7"):
        fn = lambda: call(lib, "samrs_amg_post", p(low), p(y0), p(wy), p(x0), p(wx), p(packed),
                          p(stats), M, g, orig[0], orig[1], rows, 0.0, 1.0)
        r = results[f"K7 800x800 {name}"] = device_ms(fn)
        if name == "full":  # and through the wrapper: host work and glue launches included
            _build._lib = lib
            wrapper = tree_module(csrc, "amg_post")
            wrap = lambda: wrapper.amg_postprocess_cuda(low, inp, orig, img, 0.0, 1.0)
            r["wrapper_loop"] = loop_ms(wrap)
            r.update({f"wrapper {k}": v for k, v in device_ms(wrap).items()})
            _build._lib = None
        print(f"K7 800x800 {name}: " + ", ".join(f"{a} {b:.4f}" for a, b in r.items()),
              flush=True)
    print_registers(logs, [("K6", "full"), ("K7", "full")])
    return results


def gather_fwd_cases():
    """K8's forward at the smoke's shapes: (key, BG, H = W, Gc, P, K, coords)."""
    from chip_smoke import II_GC, II_GROUPS, M2F_POINTS, TRAIN_BATCH
    B = TRAIN_BATCH[2]
    cases = [("rvsa", B * 12, 14, 128, 196, 1, "window"),
             ("msda_l28", B * 8, 28, 32, 1029, 4, "window"),
             ("shared_masks", B, 56, 100, M2F_POINTS, 1, "window"),
             ("shared_gt", B, 56, 37, M2F_POINTS, 1, "window")]
    return cases + [(f"ii_l{lvl}", B * G, 56 >> lvl, II_GC, (56 >> lvl) ** 2, 9, "dcn")
                    for lvl, G in enumerate(II_GROUPS)]


def gather_fwd_part(libs, logs):
    """K8's forward with one stage switched off, by direct calls; {case: ms}."""
    from chip_smoke import k8_case
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = _build.ptr
    results = {}
    for key, BG, H, Gc, P, K, coords in gather_fwd_cases():
        xg, fx, fy, mask, _ = k8_case(gen, BG, H, H, Gc, P, K, torch.float32, coords)
        out = torch.empty(BG, P, Gc, device="cuda")
        for name, lib in sorted((k[1], v) for k, v in libs.items() if k[0] == "K8f"):
            results[f"K8f {key} {name}"] = ms = loop_ms(lambda: call(
                lib, "samrs_bilinear_fwd", p(xg), p(fx), p(fy), p(mask), p(out), BG, H, H, P, K,
                Gc, 0))
            print(f"K8f {key} {name}: {ms:.4f} ms", flush=True)
        del xg, fx, fy, mask, out
    print_registers(logs, [("K8f", "full")])
    return results


def plain_attention_part(libs, logs):
    """K10 with one stage switched off, by direct calls; {case: {kernel: ms}}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    p = _build.ptr
    results = {}
    for key, BH, N in (("vit_b_512", 96, 1024), ("rvsa_224", 780, 196)):
        d = 64
        q, k, v = (torch.randn(BH, N, d, generator=gen, device="cuda") for _ in range(3))
        out = torch.empty_like(q)
        nbytes = libs[("K10", "full")].samrs_plain_attention_scratch_bytes(BH, N, d)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
        for name, lib in sorted((key_[1], lib_) for key_, lib_ in libs.items()
                                if key_[0] == "K10"):
            fn = lambda: call(lib, "samrs_plain_attention", p(q), p(k), p(v), p(scratch),
                              scratch.numel(), p(out), BH, N, d, d ** -0.5)
            r = results[f"K10 {key} {name}"] = device_ms(fn)
            if name == "full":
                r["loop"] = loop_ms(fn)
            print(f"K10 {key} {name}: " + ", ".join(f"{a} {b:.4f}" for a, b in r.items()),
                  flush=True)
        del q, k, v, out, scratch
    print_registers(logs, [("K10", "full")])
    return results


# K9's shapes: (key, N masks, H = W, K points); the candidates have no backward
PS_CASES = (("fast", 6500, 56, 12544), ("candidates", 6500, 56, 3 * 12544),
            ("map256", 300, 256, 12544))


def sass_ops(lib: Path, word: str):
    """{kernel: {opcode: count}} of the atomic and reduction instructions in
    the SASS of `lib`'s kernels whose name holds `word` (cuobjdump)."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(lib)], check=True, capture_output=True,
                          text=True).stdout
    out = {}
    for part in text.split("Function : ")[1:]:
        name = part.split("\n", 1)[0].strip()
        if word in name:
            ops = {}
            for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Z0-9_]+)*)", part):
                ops[op] = ops.get(op, 0) + 1
            out[name[:120]] = ops
    return out


def point_sample_part(libs):
    """K9 with one stage switched off, by direct calls of its coordinate
    entry in the form ``point_sample_plan`` picks; {case: ms}."""
    from chip_smoke import k9_case
    from samrs_tpu_torch.kernels import bilinear_gather as bg

    gen = torch.Generator(device="cuda").manual_seed(0)
    p = _build.ptr
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for key, N, H, K in PS_CASES:
        img, _, _, xy, dout = k9_case(gen, N, H, H, K, "loss")
        out = torch.empty(N, K, device="cuda")
        dimg = torch.zeros(N, H, H, device="cuda")
        dxy = torch.empty_like(xy)
        forms = [("fwd", None)] + ([] if key == "candidates" else [("bwd", False),
                                                                   ("bwd_grad", True)])
        if key == "map256":  # beside the plan's: the device-memory form, more bands
            forms += [("bwd_global", False), ("bwd_bands8", False)]
        for label, grad in forms:
            if label.endswith("_global"):
                plan = (bg.PS_GLOBAL, 1)
            elif "_bands" in label:
                plan = (bg.PS_BANDS, int(label[-1]))
            else:
                plan = bg.point_sample_plan(N, H, H, K, 4, grad, sms)
            for name, lib in sorted((k[1], v) for k, v in libs.items() if k[0] == "K9"):
                if grad is None:
                    fn = lambda: call(lib, "samrs_point_sample_fwd", p(img), p(xy), None, p(out),
                                      N, H, H, K, 0, 1, *plan)
                else:
                    fn = lambda: call(lib, "samrs_point_sample_bwd", p(img), p(xy), None, p(dout),
                                      p(dimg), p(dxy) if grad else None, None, N, H, H, K, 0, 1,
                                      *plan)
                results[f"K9 {key} {label} {name}"] = ms = loop_ms(fn)
                print(f"K9 {key} {label} (N {N}, {H}x{H}, K {K}, form {plan[0]} x{plan[1]}) "
                      f"{name}: {ms:.4f} ms", flush=True)
        results[f"K9 {key} dimg memset"] = ms = loop_ms(dimg.zero_)
        print(f"K9 {key} dimg memset ({dimg.numel() * 4 / 1e6:.1f} MB): {ms:.4f} ms", flush=True)
        del img, xy, dout, out, dimg, dxy
        torch.cuda.empty_cache()
    lib = _build.BUILD_DIR / "breakdown" / "K9_full" / "lib.so"
    for kernel, ops in sass_ops(lib, "point_sample").items():
        print(f"SASS {kernel}: {ops}", flush=True)
    return results


# K12's shapes at one ViT-H image (16 heads of 80): (key, B', kh = kw): the windows of
# window_attn_impl=pallas, the globals of window_attn_impl=xla, the global grids of
# image_size 512 and 256
SA_CASES = (("windows", 400, 14), ("globals", 16, 64), ("grid32", 16, 32), ("grid16", 16, 16))


def split_attention_part(csrc: Path, libs, logs):
    """K12 with one stage switched off at its four shapes, 20 back-to-back
    launches (CUDA events, median of 5) and torch.profiler's device time of
    the full variant; and the glue its wrapper runs around it: the plain rel
    rows (q's fp32 copy and two einsums), by device time; {case: ms}."""
    from samrs_tpu_torch.kernels import window_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr
    parent = is_parent_split(csrc)
    d = 80
    results = {}
    for key, B, g in SA_CASES:
        N = g * g
        kernel = "K12" if parent else {"window": "K12w", "tiled": "K12t"}[
            window_attention.split_form(N, g, g)]
        q, k, v = (rn(B, N, d).bfloat16() for _ in range(3))
        rh, rw = rn(B, N, g, std=0.5), rn(B, N, g, std=0.5)
        Rh, Rw = rn(g, g, d, std=0.1), rn(g, g, d, std=0.1)
        out = torch.empty(B, N, d, device="cuda")
        for name, lib in sorted((k_[1], v_) for k_, v_ in libs.items() if k_[0] == kernel):
            if parent:
                fn = lambda: call(lib, "samrs_split_attention", p(q), p(k), p(v), p(rh), p(rw),
                                  p(out), B, N, d, g, g, d ** -0.5, int(N <= 256),
                                  signatures=SA_PARENT_SIGNATURES)
            else:
                _build._lib = lib
                fn = lambda: window_attention.split_attention_cuda(q, k, v, rh, rw, d ** -0.5)
            results[f"K12 {key} {name}"] = r = {"loop": loop_ms(fn)}
            if name == "full":
                r.update(device_ms(fn))
            print(f"K12 {key} (B' {B}, N {N}) {name}: " + ", ".join(
                f"{a} {b:.4f}" for a, b in r.items()), flush=True)
        _build._lib = None
        glue = lambda: window_attention.rel_rows(q, Rh, Rw, (g, g))
        results[f"K12 {key} glue rel_rows"] = r = device_ms(glue)
        r["loop"] = loop_ms(glue)
        print(f"K12 {key} glue (plain rel rows: q in fp32, two einsums): " + ", ".join(
            f"{a} {b:.4f}" for a, b in r.items()), flush=True)
        if not parent:  # the path's call: the rel-row kernel and the attention
            _build._lib = libs[(kernel, "full")]
            path = lambda: window_attention.window_attention_relpos(q, k, v, Rh, Rw, (g, g),
                                                                    d ** -0.5)
            results[f"K12 {key} window_attention_relpos"] = r = device_ms(path)
            r["loop"] = loop_ms(path)
            _build._lib = None
            print(f"K12 {key} window_attention_relpos: " + ", ".join(
                f"{a} {b:.4f}" for a, b in r.items()), flush=True)
            if key == "windows":  # beside K1's rel kernel: K2's, which takes any other grid
                out_h, out_w = torch.empty_like(rh), torch.empty_like(rw)
                other = lambda: call(libs[("K12t", "full")], "samrs_split_relpos_rows", p(q),
                                     p(Rh), p(Rw), p(out_h), p(out_w), B, N, d, g, g)
                results[f"K12 {key} rel rows by relpos_rows_kernel"] = r = device_ms(other)
                print(f"K12 {key} rel rows by relpos_rows_kernel: " + ", ".join(
                    f"{a} {b:.4f}" for a, b in r.items()), flush=True)
        del q, k, v, rh, rw, out
        torch.cuda.empty_cache()
    print_registers(logs, [("K12", "full")] if parent else [("K12w", "full"), ("K12t", "full")])
    return results


def is_parent_split(csrc: Path) -> bool:
    """Whether `csrc` holds K12 and K4 from before their Hopper redesign."""
    return (csrc / "split_attention.cu").exists()


def t2i_kv_part(libs, logs):
    """K4 with one stage switched off at the main path's shape (batch-1
    keys, 4096 rows), by direct calls: 20 back-to-back launches (CUDA
    events, median of 5) and torch.profiler's device time; {case: ms}."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr
    N, D, Ci = 4096, 256, 128
    keys, pe = rn(1, N, D), rn(N, D)
    wk, wv = rn(Ci, D, std=D ** -0.5).bfloat16(), rn(Ci, D, std=D ** -0.5).bfloat16()
    bk, bv = rn(Ci, std=0.1), rn(Ci, std=0.1)
    kout = torch.empty(1, N, Ci, device="cuda", dtype=torch.bfloat16)
    vout = torch.empty_like(kout)
    results = {}
    for name, lib in sorted((k[1], v) for k, v in libs.items() if k[0] == "K4"):
        fn = lambda: call(lib, "samrs_t2i_kv", p(keys), p(pe), p(wk), p(bk), p(wv), p(bv),
                          p(kout), p(vout), 1, N)
        results[f"K4 {name}"] = r = {"loop": loop_ms(fn)}
        r.update(device_ms(fn))
        print(f"K4 (N {N}) {name}: " + ", ".join(f"{a} {b:.4f}" for a, b in r.items()),
              flush=True)
    print_registers(logs, [("K4", "full")])
    return results


def rates_part(lib):
    """The card's reduction rates at K8's level-0 access pattern; {case: ms}
    and, per case, G ops/s and G elements/s."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    _, fx, fy, mask, dout = dcn_level0(gen)
    BG, P, K = fx.shape
    H = W = 56
    Gc = dout.shape[2]
    # corners on the map per tap, and the taps binned by (bg, corner row) for the owner kernel
    x0, y0 = torch.floor(fx).long(), torch.floor(fy).long()
    on = lambda v, n: (v >= 0) & (v < n)
    valid = sum((on(x0 + dx, W) & on(y0 + dy, H)).sum() for dx in (0, 1) for dy in (0, 1))
    nonzero = sum(((on(x0 + dx, W) & on(y0 + dy, H)) & (
        ((fx - x0) if dx else (1 - (fx - x0))) * ((fy - y0) if dy else (1 - (fy - y0))) != 0))
        .sum() for dx in (0, 1) for dy in (0, 1))
    valid, nonzero = int(valid), int(nonzero)
    tap = torch.arange(BG * P * K, device="cuda").reshape(BG, P, K)
    bgi = torch.arange(BG, device="cuda").reshape(BG, 1, 1).expand(BG, P, K)
    keys, ents = [], []
    for dy in (0, 1):
        ok = on(y0 + dy, H) & (on(x0, W) | on(x0 + 1, W))
        keys.append((bgi * H + y0 + dy)[ok])
        ents.append((2 * tap + dy)[ok])
    keys, ents = torch.cat(keys), torch.cat(ents)
    order = torch.sort(keys, stable=True).indices
    entries = ents[order].int().contiguous()
    row_start = torch.zeros(BG * H + 1, dtype=torch.long, device="cuda")
    row_start[1:] = torch.bincount(keys, minlength=BG * H).cumsum(0)
    row_start = row_start.int().contiguous()
    dx = torch.zeros(BG, H, W, Gc, device="cuda")
    stream = lambda: torch.cuda.current_stream().cuda_stream
    p = _build.ptr
    V, I = ctypes.c_void_p, ctypes.c_int
    lib.rates_global.argtypes = [V] * 5 + [I] * 6 + [V]
    lib.rates_shared.argtypes = [V] * 7 + [I] * 6 + [V]

    def run(fn, *args):
        code = fn(*args, stream())
        if code != 0:
            raise RuntimeError(f"rate kernel: CUDA error {code}")

    elems = valid * Gc
    cases = {
        "red.global.add.f32": (lambda: run(lib.rates_global, p(fx), p(fy), p(mask), p(dout),
                                           p(dx), BG, H, W, P, K, 0), elems, elems),
        "red.global.add.v4.f32": (lambda: run(lib.rates_global, p(fx), p(fy), p(mask), p(dout),
                                              p(dx), BG, H, W, P, K, 1), elems // 4, elems),
        "shared atomicAdd f32": (lambda: run(lib.rates_shared, p(fx), p(fy), p(mask), p(dout),
                                             None, None, p(dx), BG, H, W, P, K, 0), elems, elems),
        "shared owner-warp RMW": (lambda: run(lib.rates_shared, p(fx), p(fy), p(mask), p(dout),
                                              p(entries), p(row_start), p(dx), BG, H, W, P, K, 1),
                                  elems, elems),
    }
    results = {"taps": BG * P * K, "valid_corners": valid, "nonzero_corners": nonzero,
               "row_entries": int(entries.numel())}
    print(f"rates at K8 level 0 (BG {BG}, {H}x{W}, Gc {Gc}, K {K}): {BG * P * K} taps, "
          f"{valid} valid corners ({nonzero} of nonzero weight), {entries.numel()} row entries",
          flush=True)
    for name, (fn, ops, n_el) in cases.items():
        ms = loop_ms(fn)
        results[name] = dict(ms=ms, g_ops_per_s=ops / ms / 1e6, g_elements_per_s=n_el / ms / 1e6)
        print(f"rate {name}: {ms:.4f} ms, {ops / ms / 1e6:.1f} G ops/s, "
              f"{n_el / ms / 1e6:.1f} G elements/s", flush=True)
    results["dx memset"] = loop_ms(dx.zero_)
    print(f"rate dx memset (52 MB): {results['dx memset']:.4f} ms", flush=True)
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the csrc directory of the tree whose kernels are profiled")
    ap.add_argument("--what", action="append",
                    choices=PARTS, help="the parts to run (default: all)")
    args = ap.parse_args()
    what = args.what or list(PARTS)
    if not torch.cuda.is_available():
        raise SystemExit("chip_breakdown.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    csrc = args.csrc.resolve()
    specs = []
    if "attention" in what:
        specs += [("K1", "window_attention.cu", K1_VARIANTS), ("K5", "twoway.cu", K5_VARIANTS)]
    if "mlp_gather" in what:
        specs += [("K11", "fused_mlp.cu", K11_VARIANTS), ("K8b", "bilinear_gather.cu", K8B_VARIANTS)]
    if "decoder_tail" in what:
        specs += [("K6", "upscale.cu", K6_VARIANTS), ("K7", "amg_post.cu", K7_VARIANTS)]
    if "gather_fwd" in what:
        specs.append(("K8f", "bilinear_gather.cu", K8F_VARIANTS))
    if "plain_attention" in what:
        specs.append(("K10", "plain_attention.cu", K10_VARIANTS))
    if "point_sample" in what:
        specs.append(("K9", "point_sample.cu", PS_VARIANTS))
    if "split_attention" in what and is_parent_split(csrc):
        specs.append(("K12", "split_attention.cu", SA_PARENT_VARIANTS, ("warp_attention.cuh",)))
    elif "split_attention" in what:
        specs += [("K12w", "window_attention.cu", SAW_VARIANTS),
                  ("K12t", "flash_attention.cu", SAT_VARIANTS)]
    if "t2i_kv" in what:
        specs.append(("K4", "twoway.cu",
                      KV_PARENT_VARIANTS if is_parent_split(csrc) else KV_VARIANTS))
    libs, logs = build(csrc, _build.BUILD_DIR / "breakdown", specs, rates="rates" in what)
    results = {}
    if "attention" in what:
        results.update(attention_part(libs, logs))
    if "mlp_gather" in what:
        results.update(mlp_gather_part(libs, logs))
    if "rates" in what:
        results["rates"] = rates_part(libs[("rates", "all")])
    if "decoder_tail" in what:
        results.update(decoder_tail_part(csrc, libs, logs))
    if "gather_fwd" in what:
        results.update(gather_fwd_part(libs, logs))
    if "plain_attention" in what:
        results.update(plain_attention_part(libs, logs))
    if "point_sample" in what:
        results.update(point_sample_part(libs))
        print_registers(logs, [("K9", "full")])
    if "split_attention" in what:
        results.update(split_attention_part(csrc, libs, logs))
    if "t2i_kv" in what:
        results.update(t2i_kv_part(libs, logs))
    print(json.dumps({"device": smi, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
