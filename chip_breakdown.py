#!/usr/bin/env python3
"""Where the time of K1's attention stage and of K5 goes, on one CUDA card,
by timing variants of their sources with one stage switched off.

    python3 chip_breakdown.py --csrc DIR

DIR is a ``samrs_tpu_torch/csrc``: this tree's (the wgmma K1 attention
stage and K5) or that of a tree before their Hopper redesign (the
one-block-per-(window, head, image) mma.sync K1 and the
one-block-per-64-row-tile cp.async K5; unpack it with ``git archive`` into a
directory that ``.gitignore`` lists).  The script copies
window_attention.cu and twoway.cu into variants in which a stage is switched
off at run time (a condition the compiler cannot fold: the work is skipped,
the rest of the code stays), builds each with nvcc for sm_90a, and times
each at the main path's shapes (ViT-H: one 64 x 64 x 3840 qkv map, 16 heads
of 80; the decoder at bucket 64: 64 prompts x 4096 rows, 16 token slots):
the old kernels by direct calls, 20 back-to-back launches between CUDA
events, median of 5; the new ones through the wrappers with the variant's
library swapped in, torch.profiler's device time per kernel.  The
differences between variants are the stages' shares; a stage that overlaps
another shows less than it costs alone.  The new kernels are timed at K1's
attention stage in the fused2 and ijb orders, on partitioned windows and on
a 70 x 70 map (no window pads), and at K5 per-prompt and shared; the full
variant also by the wall time of 20 back-to-back calls (the wrappers' host
work included), and its registers and spills (ptxas) are printed.  It
checks nothing and prints one JSON line of ms per variant.

``--what mlp_gather`` profiles K11 (csrc/fused_mlp.cu) and K8's backward
(csrc/bilinear_gather.cu) the same way, by direct calls of their C entry
points: K11 with its lin1 products, its GELU, its lin2 products or its
weight staging switched off, at vit_b 512^2 batch 8 (T 8192, C 768, M
3072) and InternImage-T level 0 (T 203840, C 64, M 256; on the
redesigned sources in both forms, the fused one the wrapper picks there and
the two launches, with the variants' stages switched off in both where their
code is shared); K8's backward with
its dX reductions, its corner loads or its dfx / dfy / dmask shuffles
switched off, at InternImage-T level 0 (BG 260, 56^2, Gc 16, 9 taps of a 3x3
ring with offsets up to 1.5 px), the MSDeformAttn level (BG 520, 28^2, Gc
32, 1029 queries, 4 taps) and the RVSA shape (BG 780, 14^2, Gc 128, one
tap).  Only the sources of the first versions (the CUDA-core K11 and the
per-channel atomic K8 backward) have these stages.  ``--what rates`` times
this card's reduction rates at K8's level-0 access pattern (the taps above,
every valid corner of every tap, Gc 16): scalar ``red.global.add.f32``, the
16-byte ``red.global.add.v4.f32``, fp32 ``atomicAdd`` into a block's
shared-memory copy of one map, and plain read-modify-write of that copy by
the warp that owns a row (taps binned by corner row beforehand), each in
ops and elements per second.  ``--what`` may be given more than once; the
default runs all three parts.
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

from samrs_tpu_torch.kernels import _build

OFF = "(samrs_prof_off != 0)"  # false at run time; the compiler cannot fold it
GUARD = "__device__ int samrs_prof_off;  // 0: the stages it guards are skipped\n"

# variant -> the (old, new) substitutions made in its source
K1_VARIANTS = {
    "full": [],
    "no_rel": [("if (t < NT) {", f"if (t < NT && {OFF}) {{")],
    "no_products": [("for (int k0 = 0; k0 < L.np; k0 += 64) {",
                     f"for (int k0 = 0; k0 < ({OFF} ? L.np : 0); k0 += 64) {{")],
    "loads_stores": [("if (t < NT) {", f"if (t < NT && {OFF}) {{"),
                     ("for (int k0 = 0; k0 < L.np; k0 += 64) {",
                      f"for (int k0 = 0; k0 < ({OFF} ? L.np : 0); k0 += 64) {{")],
}
K5_ATTN = ("for (int sb = 0; sb < nslot / NTOK; ++sb) {",
           f"for (int sb = 0; sb < ({OFF} ? nslot / NTOK : 0); ++sb) {{")
K5_PROJ = ("warp_gemm<", f"if {OFF} warp_gemm<")
K5_WLOAD = ("load_rows_async<THREADS>(Ws,", f"if {OFF} load_rows_async<THREADS>(Ws,")
K5_VARIANTS = {
    "full": [],
    "no_attention": [K5_ATTN],
    "no_products": [K5_PROJ],
    "no_weight_loads": [K5_WLOAD],
    "tile_io_and_layernorm": [K5_ATTN, K5_PROJ, K5_WLOAD],
}


# the same for the Hopper kernels (window_wgmma_kernel, i2t_wgmma_kernel)
K1_NEW_VARIANTS = {
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
K5_NEW_VARIANTS = {
    "full": [],
    "no_attention": [K5_ATTN],
    "no_projections": [("    if constexpr (NW == 128) wgmma_rs_n128(acc, af[kk], db, kk != 0);\n"
                        "    else wgmma_rs_n64(acc, af[kk], db, kk != 0);",
                        f"    if constexpr (NW == 128) {{ if {OFF} "
                        "wgmma_rs_n128(acc, af[kk], db, kk != 0); }\n"
                        f"    else {{ if {OFF} wgmma_rs_n64(acc, af[kk], db, kk != 0); }}")],
}


# K11's first version (the 32-token CUDA-core kernel) and K8's per-channel atomic backward
K11_VARIANTS = {
    "full": [],
    "no_lin1": [("for (int cc = 0; cc < FM_KC; ++cc) {",
                 f"for (int cc = 0; cc < ({OFF} ? FM_KC : 0); ++cc) {{")],
    "no_gelu": [(f"g.{c} = gelu_erf(h[{i}][j] + bias);",
                 f"g.{c} = {OFF} ? gelu_erf(h[{i}][j] + bias) : h[{i}][j] + bias;")
                for i, c in enumerate("xyzw")],
    "no_lin2": [("for (int mm = 0; mm < FM_MC; ++mm) {",
                 f"for (int mm = 0; mm < ({OFF} ? FM_MC : 0); ++mm) {{")],
    "no_weight_staging": [
        ("for (int i = tid; i < FM_MK * FM_KC / 4; i += FM_THREADS) {",
         f"for (int i = tid; i < ({OFF} ? FM_MK * FM_KC / 4 : 0); i += FM_THREADS) {{"),
        ("for (int i = tid; i < C * FM_MC / 4; i += FM_THREADS) {",
         f"for (int i = tid; i < ({OFF} ? C * FM_MC / 4 : 0); i += FM_THREADS) {{")],
}
K8B_VARIANTS = {
    "full": [],
    "no_dx_reductions": [("  if (!valid) return;\n  float* d = dimg",
                          f"  if (!valid || !{OFF}) return;\n  float* d = dimg")],
    "no_corner_loads": [(f"load_corner<T, V>(img, t.v{c}, t.i{c}, Gc, c, v{c});",
                         f"load_corner<T, V>(img, t.v{c} && {OFF}, t.i{c}, Gc, c, v{c});")
                        for c in ("00", "01", "10", "11")],
    "no_shuffles": [("for (int s = tpg >> 1; s > 0; s >>= 1) {",
                     f"for (int s = ({OFF} ? tpg >> 1 : 0); s > 0; s >>= 1) {{")],
}

# The reduction-rate micro-benchmark (--what rates): four ways to add g * w of every valid
# corner of every tap into a (BG, H, W, Gc) fp32 map, Gc 16.  Each group of 4 lanes owns one
# query and 4 channels; the owner kernel takes a row-binned entry list (entry = 2 * tap + dy).
# the same for their Hopper redesigns (the split-TF32 wgmma K11, the vector-reduction K8
# backward); the producer's TMA ring stays on in every K11 variant
K11_NEW_VARIANTS = {
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
K8B_NEW_VARIANTS = {
    "full": [],
    "no_dx_reductions": [("if (!valid || w == 0.f) return 0;",
                          f"if (!valid || w == 0.f || !{OFF}) return 0;")],
    "no_corner_loads": K8B_VARIANTS["no_corner_loads"],
    "no_shuffles": K8B_VARIANTS["no_shuffles"],
}


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

def variant_source(src: Path, subs, dst: Path) -> None:
    text = src.read_text()
    for old, new in subs:
        if old not in text:
            raise SystemExit(f"{src.name}: '{old}' not found: not the kernel this script profiles")
        text = text.replace(old, new)
    marker = "namespace samrs {\nnamespace {\n"
    if subs and marker not in text:
        raise SystemExit(f"{src.name}: no anonymous namespace to put the guard in")
    dst.write_text(text.replace(marker, marker + GUARD, 1) if subs else text)


def is_redesigned_mlp(csrc: Path) -> bool:
    """Whether `csrc` holds the split-TF32 K11 and the vector-reduction K8
    backward (else their first versions)."""
    return "mlp_tf32x3_kernel" in (csrc / "fused_mlp.cu").read_text()


def is_hopper(csrc: Path) -> bool:
    """Whether `csrc` holds the wgmma K1 / K5 (else the mma.sync / cp.async ones)."""
    return "window_wgmma_kernel" in (csrc / "window_attention.cu").read_text()


def build(csrc: Path, out: Path, specs, rates: bool = False):
    """Builds every variant of `specs` ((kernel, source file, variants)) into
    its own shared library, and the rate micro-benchmark if `rates`; returns
    {(kernel, variant): CDLL} and the nvcc logs under the same keys."""
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    jobs = []
    for kernel, fname, variants in specs:
        for name, subs in variants.items():
            d = out / f"{kernel}_{name}"
            shutil.copytree(csrc, d)
            variant_source(csrc / fname, subs, d / fname)
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


# C entries whose signature changed since the first versions this script profiles
_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_SIGNATURES = {"samrs_fused_mlp": ([_P] * 6 + [_I] * 3 + [_P], _I),
                  "samrs_bilinear_bwd": ([_P] * 9 + [_I] * 7 + [_P], _I)}


def call(lib, name: str, *args, old: bool = False) -> None:
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = (OLD_SIGNATURES if old else _build._SIGNATURES)[name]
    code = fn(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def device_ms(fn, n: int = 20):
    """torch.profiler's device time per call of each kernel `fn` launches."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.self_device_time_total > 0:
            m = re.search(r"\w+_kernel(<\d+>)?", e.key)
            out[m.group(0) if m else e.key[:48]] = e.self_device_time_total / 1e3 / n
    return out


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


def attention_part(csrc: Path, libs, logs):
    """K1's attention stage and K5 with one stage switched off; {case: ms}."""
    if is_hopper(csrc):  # the wrappers' calls, each variant's library swapped in
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
    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr

    # K1's attention stage: one ViT-H image, 64 x 64 map, 16 heads of 80 (pads to 70 x 70)
    C, nH, hd, G, ws = 1280, 16, 80, 64, 14
    qkv, bqkv = rn(1, G, G, 3 * C).bfloat16(), rn(3 * C, std=0.5).bfloat16()
    rh, rw = rn(ws, hd, ws, std=0.1), rn(ws, hd, ws, std=0.1)
    out = torch.empty(1, G, G, C, device="cuda", dtype=torch.bfloat16)
    results = {}
    for order, label in ((1, "ijb"), (0, "plain")):
        for name in K1_VARIANTS:
            lib = libs[("K1", name)]
            results[f"K1 {label} {name}"] = loop_ms(lambda: call(
                lib, "samrs_window_attention", p(qkv), p(bqkv), p(rh), p(rw), p(out), 1, G, G, G,
                G, C, nH, hd, ws, 0, order, hd ** -0.5))

    # K5 at bucket 64: per-prompt keys with a bf16 keys2 (layer 1) and shared keys (layer 0)
    Bp, N, D, Ci, S = 64, G * G, 256, 128, 16
    keysB, keys1, pe = rn(Bp, N, D), rn(1, N, D), rn(N, D)
    tok_k, tok_v = rn(Bp, S, Ci), rn(Bp, S, Ci)
    mask = torch.where(torch.arange(S, device="cuda") < 7, 0.0, -1e9)
    wq, wo, wk, wv = (rn(Ci, D, std=D ** -0.5).bfloat16(), rn(D, Ci, std=Ci ** -0.5).bfloat16(),
                      rn(Ci, D, std=D ** -0.5).bfloat16(), rn(Ci, D, std=D ** -0.5).bfloat16())
    bq, bo, g4, b4, bk, bv = rn(Ci), rn(D), 1 + rn(D, std=0.1), rn(D), rn(Ci), rn(Ci)
    k_out = torch.empty(Bp, N, Ci, device="cuda", dtype=torch.bfloat16)
    v_out = torch.empty_like(k_out)
    for label, keys, out_bf16 in (("per-prompt", keysB, 1), ("shared", keys1, 0)):
        keys2 = torch.empty(Bp, N, D, device="cuda",
                            dtype=torch.bfloat16 if out_bf16 else torch.float32)
        for name in K5_VARIANTS:
            lib = libs[("K5", name)]
            results[f"K5 {label} {name}"] = loop_ms(lambda: call(
                lib, "samrs_i2t_update", p(keys), p(pe), p(tok_k), p(tok_v), p(mask), p(wq),
                p(bq), p(wo), p(bo), p(g4), p(b4), p(wk), p(bk), p(wv), p(bv), p(keys2),
                p(k_out), p(v_out), Bp, N, S, int(keys.shape[0] == 1), out_bf16, 0.25, 1e-5))
    for k, v in results.items():
        print(f"{k}: {v:.4f} ms", flush=True)
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


def mlp_gather_part(libs, logs, new: bool):
    """K11 and K8's backward with one stage switched off: the first versions
    by direct calls, the redesigns (`new`) through their wrappers with the
    variant's library swapped in; {case: ms}."""
    from samrs_tpu_torch.kernels import fused_mlp as fm

    gen = torch.Generator(device="cuda").manual_seed(0)
    rn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device="cuda") * std
    p = _build.ptr
    results = {}
    for label, T, C, on_chip in (("vit_b_512", 8192, 768, False),
                                 ("internimage_l0", 203840, 64, True),
                                 ("internimage_l0_two_launch", 203840, 64, False)):
        if label.endswith("two_launch") and not new:
            continue
        M = 4 * C
        x, w1, b1 = rn(T, C), rn(M, C, std=C ** -0.5), rn(M, std=0.1)
        w2, b2, out = rn(C, M, std=M ** -0.5), rn(C, std=0.1), torch.empty(T, C, device="cuda")
        for name in (K11_NEW_VARIANTS if new else K11_VARIANTS):
            lib = libs[("K11", name)]
            if new:
                _build._lib = lib
                fm._halves.clear()  # split by this variant's library
                ms = loop_ms(lambda: fm.fused_mlp_cuda(x, w1, b1, w2, b2, on_chip=on_chip))
            else:
                ms = loop_ms(lambda: call(lib, "samrs_fused_mlp", p(x), p(w1), p(b1), p(w2),
                                          p(b2), p(out), T, C, M, old=True))
            results[f"K11 {label} {name}"] = ms
            print(f"K11 {label} {name}: {ms:.4f} ms", flush=True)
        del x, w1, b1, w2, b2, out
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
        for name in (K8B_NEW_VARIANTS if new else K8B_VARIANTS):
            lib = libs[("K8b", name)]
            results[f"K8b {label} {name}"] = ms = loop_ms(lambda: call(
                lib, "samrs_bilinear_bwd", p(xg), p(fx.contiguous()), p(fy.contiguous()),
                p(mask.contiguous()), p(dout), p(dxg), p(dfx), p(dfy), p(dmask),
                *([] if not new else [None]), BG, H, WGc // Gc, P, K, Gc, 0, old=not new))
            print(f"K8b {label} {name}: {ms:.4f} ms", flush=True)
        results[f"K8b {label} dxg memset"] = ms = loop_ms(dxg.zero_)
        print(f"K8b {label} dxg memset: {ms:.4f} ms", flush=True)
    print_registers(logs, [("K11", "full"), ("K8b", "full")])
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
    ap.add_argument("--what", action="append", choices=("attention", "mlp_gather", "rates"),
                    help="the parts to run (default: all)")
    args = ap.parse_args()
    what = args.what or ["attention", "mlp_gather", "rates"]
    if not torch.cuda.is_available():
        raise SystemExit("chip_breakdown.py: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    csrc = args.csrc.resolve()
    specs = []
    if "attention" in what:
        new = is_hopper(csrc)
        specs += [("K1", "window_attention.cu", K1_NEW_VARIANTS if new else K1_VARIANTS),
                  ("K5", "twoway.cu", K5_NEW_VARIANTS if new else K5_VARIANTS)]
    if "mlp_gather" in what:
        new = is_redesigned_mlp(csrc)
        specs += [("K11", "fused_mlp.cu", K11_NEW_VARIANTS if new else K11_VARIANTS),
                  ("K8b", "bilinear_gather.cu", K8B_NEW_VARIANTS if new else K8B_VARIANTS)]
    libs, logs = build(csrc, _build.BUILD_DIR / "breakdown", specs, rates="rates" in what)
    results = {}
    if "attention" in what:
        results.update(attention_part(csrc, libs, logs))
    if "mlp_gather" in what:
        results.update(mlp_gather_part(libs, logs, is_redesigned_mlp(csrc)))
    if "rates" in what:
        results["rates"] = rates_part(libs[("rates", "all")])
    print(json.dumps({"device": smi, "ms": results}), flush=True)


if __name__ == "__main__":
    main()
