// K8's row-slab form: the weighted bilinear gather of bilinear_gather.cu,
// forward and backward, over the row slabs of the map that a block of
// queries touches.
//
//   out[bg, p, :] = sum_k mask[bg, p, k] * bilinear(xg[bg], fy[bg, p, k], fx[bg, p, k])
//
// xg (BG, H, W, Gc) fp32 or bf16, channels contiguous; fx, fy, mask (BG, P, K)
// fp32; zero padding outside the map; Hs (the slab height) divides H.
//
// Replaces samrs_tpu/kernels/bilinear_gather.py::_make_sampler's slab
// kernels: _fwd_kernel_slab (launched by fwd_call's pallas_call, :386, when
// slab > 0) and bwd_call_slab's pallas_call (:419, _bwd_kernel_slab).  On the
// TPU each query block's hat matmul runs only over the Hs-row slabs that the
// block's rows [min fy - 1, max fy + 1] touch (the predicate of :189, :233,
// :250), which saves matrix-unit row reductions.  Here the saving is shared
// memory: one block of 256 threads takes one bg and 128 raster-contiguous
// queries (JAX's _block_size; the tail block's missing queries count as
// copies of the last one, as _pad_p(edge=True) pads them, so they do not
// widen the band), computes each tap's band with the JAX predicate, and
// stages only the active slabs of xg in shared memory with cp.async.  No halo
// row is needed: the predicate's +-1 puts both corner rows of every tap that
// touches the map in an active slab of that tap.
//
//   Plan 1: the union of all taps' active slabs fits the block's shared
//           memory (every InternImage-T and MSDeformAttn shape at 224^2):
//           stage it once, then each (query, channel vector) walks its taps
//           as bilinear_gather.cu does, reading the corners from shared memory.
//   Plan 2: it does not fit: tap by tap, the tap's active rows are staged in
//           chunks of RC rows plus a one-row halo (and W in tiles of WT
//           columns plus a one-column halo when two rows do not fit); each
//           (query, tap) is evaluated in the one chunk and tile that hold its
//           floor corner, and added to the output in device memory, which
//           only its own thread touches.
//
// Either way every tap's sum is formed in K8's order and rounding (corners
// 00, 01, 10, 11, then acc += m * s, each product and sum rounded on its own)
// and the taps are added in order k, so the forward is bit-equal to K8's
// dense forward.
//
// Backward: dfx, dfy and dmask are owned per (query, tap) (a group of lanes
// reduces over the channels with shuffles, in bilinear_gather.cu's order, so
// they equal the dense kernel's); dX of the staged rows accumulates in a
// fp32 shared-memory tile (shared atomics) and is added to device memory
// once per block (or per cell in plan 2), one atomicAdd per nonzero element.
// Neighbouring blocks' bands overlap, so the global adds stay atomic and dX's
// summation order varies from run to run at fp32 rounding.  Both kernels are
// bound by device-memory bytes; this first version puts correctness first
// (one or two blocks an SM: up to 112 KB of shared memory each).
#include "bilinear_tap.cuh"

namespace samrs {
namespace {

constexpr int SL_THREADS = 256;
constexpr int SL_WARPS = SL_THREADS / 32;
constexpr int SL_PB = 128;                     // queries per block
constexpr size_t SL_BUDGET = 112 * 1024;       // shared memory of one block, at most

// per-block metadata in front of the staged data: per-warp and per-tap
// minima / maxima of fy, each slab's place in the staged union (-1: not
// staged) and the count of staged slabs
__host__ __device__ inline size_t slab_meta_bytes(int K, int nslab) {
  return align_up(static_cast<size_t>(2 * SL_WARPS * K + 2 * K + nslab + 4) * 4, 16);
}

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// JAX's predicate: slab rows [s*Hs, s*Hs+Hs-1] against the tap's support [lo-1, hi+1]
__device__ __forceinline__ bool slab_active(int s, int Hs, float lo, float hi) {
  const float top = static_cast<float>(s * Hs);
  return top <= hi + 1.0f && top + static_cast<float>(Hs) - 1.0f >= lo - 1.0f;
}

struct Meta {
  float *wlo, *whi, *lo, *hi;
  int *slot, *misc;
};

__device__ __forceinline__ Meta carve_meta(unsigned char* smem, int K, int nslab) {
  Meta m;
  m.wlo = reinterpret_cast<float*>(smem);
  m.whi = m.wlo + SL_WARPS * K;
  m.lo = m.whi + SL_WARPS * K;
  m.hi = m.lo + K;
  m.slot = reinterpret_cast<int*>(m.hi + K);
  m.misc = m.slot + nslab;
  return m;
}

// Each tap's [lo, hi] over the block's queries, and the union of the taps'
// active slabs (slot[s] its place in the staged union, misc[0] their count).
__device__ void block_band(const float* __restrict__ fy, int bg, int p0, int P, int K, int H,
                           int Hs, const Meta& m) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nslab = H / Hs;
  for (int k = 0; k < K; ++k) {
    float a = pos_inf(), b = -pos_inf();
    if (tid < SL_PB) {
      const int p = min(p0 + tid, P - 1);  // the tail repeats the last query
      a = b = fy[(static_cast<size_t>(bg) * P + p) * K + k];
    }
    for (int s = 16; s > 0; s >>= 1) {
      a = fminf(a, __shfl_xor_sync(0xffffffffu, a, s));
      b = fmaxf(b, __shfl_xor_sync(0xffffffffu, b, s));
    }
    if (lane == 0) {
      m.wlo[warp * K + k] = a;
      m.whi[warp * K + k] = b;
    }
  }
  __syncthreads();
  for (int k = tid; k < K; k += SL_THREADS) {
    float a = pos_inf(), b = -pos_inf();
    for (int w = 0; w < SL_WARPS; ++w) {
      a = fminf(a, m.wlo[w * K + k]);
      b = fmaxf(b, m.whi[w * K + k]);
    }
    m.lo[k] = a;
    m.hi[k] = b;
  }
  __syncthreads();
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < nslab; ++s) {
      bool on = false;
      for (int k = 0; k < K && !on; ++k) on = slab_active(s, Hs, m.lo[k], m.hi[k]);
      m.slot[s] = on ? n++ : -1;
    }
    m.misc[0] = n;
  }
  __syncthreads();
}

// Rows [ra, rb) of tap k's active slabs (a contiguous run; ra == rb: none).
__device__ __forceinline__ void tap_rows(const Meta& m, int k, int nslab, int Hs, int& ra,
                                         int& rb) {
  int a = -1, b = -1;
  for (int s = 0; s < nslab; ++s) {
    if (slab_active(s, Hs, m.lo[k], m.hi[k])) {
      if (a < 0) a = s;
      b = s;
    }
  }
  ra = a < 0 ? 0 : a * Hs;
  rb = a < 0 ? 0 : (b + 1) * Hs;
}

// dst[i] = src[i] for i < n, all threads of the block; cp.async in 16-byte
// pieces where `vec` (n * sizeof(T) a multiple of 16, both ends aligned).
// The caller commits, waits and synchronises.
template <typename T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int n, bool vec) {
  if (vec) {
    const int nv = n * static_cast<int>(sizeof(T)) / 16;
    for (int i = threadIdx.x; i < nv; i += SL_THREADS)
      cp_async16(reinterpret_cast<char*>(dst) + 16 * i, reinterpret_cast<const char*>(src) + 16 * i,
                 true);
  } else {
    for (int i = threadIdx.x; i < n; i += SL_THREADS) dst[i] = src[i];
  }
}

__device__ __forceinline__ void copy_done(bool vec) {
  if (vec) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

__device__ __forceinline__ void ld(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void ld(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void ld(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void ld(const bf16* p, float (&v)[1]) { v[0] = __bfloat162float(*p); }

// One corner's V channels from the staged rows: row `r` and column `x` of
// the staged array (row stride `ld_row` elements), or zeros off the map.
template <typename T, int V>
__device__ __forceinline__ void corner(const T* data, bool valid, int r, int x, int ld_row, int Gc,
                                       int c, float (&v)[V]) {
  if (valid) {
    ld(data + static_cast<size_t>(r) * ld_row + x * Gc + c, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
}

// The tap's sum in K8's order and rounding (bilinear_gather.cu:96-102).
template <int V>
__device__ __forceinline__ void tap_sum(const Tap& t, const float (&v00)[V], const float (&v01)[V],
                                        const float (&v10)[V], const float (&v11)[V],
                                        float (&s)[V]) {
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float u = __fmul_rn(v00[j], t.w00);
    u = __fadd_rn(u, __fmul_rn(v01[j], t.w01));
    u = __fadd_rn(u, __fmul_rn(v10[j], t.w10));
    s[j] = __fadd_rn(u, __fmul_rn(v11[j], t.w11));
  }
}

// Geometry of plan 2's cells: RC rows (+1 halo) by WT columns (+1 halo),
// `bytes` per element, in `cap` bytes.
__device__ __forceinline__ void cell_shape(size_t cap, int W, int Gc, size_t bytes, int& RC,
                                           int& WT) {
  const size_t row = static_cast<size_t>(W) * Gc * bytes;
  if (2 * row <= cap) {
    WT = W;
    RC = static_cast<int>(cap / row) - 1;
  } else {
    RC = 1;
    WT = static_cast<int>(cap / (2 * static_cast<size_t>(Gc) * bytes)) - 1;
  }
}

// The chunk and tile that own a tap: those holding its floor corner, clamped
// into the tap's rows [ra, rb) and the map's columns.
__device__ __forceinline__ bool owns(const Tap& t, int ra, int rb, int RC, int nchunks, int WT,
                                     int W, int ch, int tl) {
  const int oy = min(max(t.y0, ra), max(ra, rb - 1));
  const int ox = min(max(t.x0, 0), W - 1);
  return min((oy - ra) / RC, nchunks - 1) == ch && ox / WT == tl;
}

template <typename T, int V>
__global__ void __launch_bounds__(SL_THREADS)
slab_fwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                const float* __restrict__ fy, const float* __restrict__ mask,
                float* __restrict__ out, int H, int W, int P, int K, int Gc, int Hs,
                int tpg_log2, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char sl_smem[];
  const int nblk = (P + SL_PB - 1) / SL_PB;
  const int bg = blockIdx.x / nblk, p0 = (blockIdx.x % nblk) * SL_PB;
  const int nslab = H / Hs, WGc = W * Gc;
  const Meta meta = carve_meta(sl_smem, K, nslab);
  const size_t meta_b = slab_meta_bytes(K, nslab);
  T* data = reinterpret_cast<T*>(sl_smem + meta_b);
  const size_t cap = static_cast<size_t>(smem_bytes) - meta_b;
  block_band(fy, bg, p0, P, K, H, Hs, meta);

  const T* img = xg + static_cast<size_t>(bg) * H * WGc;
  const int tpg = 1 << tpg_log2, group = threadIdx.x >> tpg_log2, lane = threadIdx.x & (tpg - 1);
  const int ngroups = SL_THREADS >> tpg_log2, nvec = Gc / V;
  const int nact = meta.misc[0];

  if (static_cast<size_t>(nact) * Hs * WGc * sizeof(T) <= cap) {  // plan 1
    const bool vec = (WGc * sizeof(T)) % 16 == 0 && aligned16(img);
    for (int s = 0; s < nslab; ++s)
      if (meta.slot[s] >= 0)
        copy_span(data + static_cast<size_t>(meta.slot[s]) * Hs * WGc,
                  img + static_cast<size_t>(s) * Hs * WGc, Hs * WGc, vec);
    copy_done(vec);
    const int* slot = meta.slot;
    auto srow = [&](int y) { return slot[y / Hs] * Hs + y % Hs; };
    for (int qi = group; qi < SL_PB && p0 + qi < P; qi += ngroups) {
      const size_t q = static_cast<size_t>(bg) * P + p0 + qi;
      for (int cv = lane; cv < nvec; cv += tpg) {
        const int c = cv * V;
        float acc[V];
#pragma unroll
        for (int j = 0; j < V; ++j) acc[j] = 0.f;
        for (int k = 0; k < K; ++k) {
          const size_t i = q * K + k;
          const Tap t = make_tap(fx[i], fy[i], H, W);
          const float m = mask[i];
          float v00[V], v01[V], v10[V], v11[V], s[V];
          corner<T, V>(data, t.v00, t.v00 ? srow(t.cy0) : 0, t.cx0, WGc, Gc, c, v00);
          corner<T, V>(data, t.v01, t.v01 ? srow(t.cy0) : 0, t.cx1, WGc, Gc, c, v01);
          corner<T, V>(data, t.v10, t.v10 ? srow(t.cy1) : 0, t.cx0, WGc, Gc, c, v10);
          corner<T, V>(data, t.v11, t.v11 ? srow(t.cy1) : 0, t.cx1, WGc, Gc, c, v11);
          tap_sum<V>(t, v00, v01, v10, v11, s);
#pragma unroll
          for (int j = 0; j < V; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(m, s[j]));
        }
        float* o = out + q * Gc + c;
#pragma unroll
        for (int j = 0; j < V; ++j) o[j] = acc[j];
      }
    }
    return;
  }

  // plan 2: tap by tap, cell by cell, accumulating in `out`
  for (int qi = group; qi < SL_PB && p0 + qi < P; qi += ngroups) {
    const size_t q = static_cast<size_t>(bg) * P + p0 + qi;
    for (int cv = lane; cv < nvec; cv += tpg)
#pragma unroll
      for (int j = 0; j < V; ++j) out[q * Gc + cv * V + j] = 0.f;
  }
  int RC, WT;
  cell_shape(cap, W, Gc, sizeof(T), RC, WT);
  const bool vec = (Gc * sizeof(T)) % 16 == 0 && aligned16(img);
  const int ntiles = (W + WT - 1) / WT;
  for (int k = 0; k < K; ++k) {
    int ra, rb;
    tap_rows(meta, k, nslab, Hs, ra, rb);
    const int nchunks = ra < rb ? (rb - ra + RC - 1) / RC : 1;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int cs = ra + ch * RC, ce = ra < rb ? min(cs + RC + 1, H) : cs;
      for (int tl = 0; tl < ntiles; ++tl) {
        const int ts = tl * WT, te = min(ts + WT + 1, W), ncols = te - ts;
        __syncthreads();  // the previous cell is no longer read
        for (int r = cs; r < ce; ++r)
          copy_span(data + static_cast<size_t>(r - cs) * ncols * Gc,
                    img + (static_cast<size_t>(r) * W + ts) * Gc, ncols * Gc, vec);
        copy_done(vec);
        for (int qi = group; qi < SL_PB && p0 + qi < P; qi += ngroups) {
          const size_t q = static_cast<size_t>(bg) * P + p0 + qi;
          const size_t i = q * K + k;
          const Tap t = make_tap(fx[i], fy[i], H, W);
          if (!owns(t, ra, rb, RC, nchunks, WT, W, ch, tl)) continue;
          const float m = mask[i];
          const int ld_row = ncols * Gc;
          for (int cv = lane; cv < nvec; cv += tpg) {
            const int c = cv * V;
            float v00[V], v01[V], v10[V], v11[V], s[V];
            corner<T, V>(data, t.v00, t.cy0 - cs, t.cx0 - ts, ld_row, Gc, c, v00);
            corner<T, V>(data, t.v01, t.cy0 - cs, t.cx1 - ts, ld_row, Gc, c, v01);
            corner<T, V>(data, t.v10, t.cy1 - cs, t.cx0 - ts, ld_row, Gc, c, v10);
            corner<T, V>(data, t.v11, t.cy1 - cs, t.cx1 - ts, ld_row, Gc, c, v11);
            tap_sum<V>(t, v00, v01, v10, v11, s);
            float* o = out + q * Gc + c;
#pragma unroll
            for (int j = 0; j < V; ++j) o[j] = __fadd_rn(o[j], __fmul_rn(m, s[j]));
          }
        }
      }
    }
  }
}

// One (query, tap) of the backward for the lanes of a group: the partial
// dfx / dfy / dmask sums over this lane's channels, and g * w of each valid
// corner added to the fp32 dX tile (shared atomics).  `row(y)` and `col(x)`
// place a map row / column in the staged arrays (row stride ld_row).
template <typename T, int V, typename RowFn, typename ColFn>
__device__ __forceinline__ void bwd_tap(const T* data, float* dacc, int ld_row, const Tap& t,
                                        float m, const float* r_row, int Gc, int lane, int tpg,
                                        RowFn row, ColFn col, float& gx, float& gy, float& gm) {
  const float ax = 1.f - t.wx, ay = 1.f - t.wy;
  const int nvec = Gc / V;
  const int r0 = t.v00 || t.v01 ? row(t.cy0) : 0, r1 = t.v10 || t.v11 ? row(t.cy1) : 0;
  const int c0 = col(t.cx0), c1 = col(t.cx1);
  for (int cv = lane; cv < nvec; cv += tpg) {
    const int c = cv * V;
    float r[V], v00[V], v01[V], v10[V], v11[V], g[V];
    ld(r_row + c, r);
    corner<T, V>(data, t.v00, r0, c0, ld_row, Gc, c, v00);
    corner<T, V>(data, t.v01, r0, c1, ld_row, Gc, c, v01);
    corner<T, V>(data, t.v10, r1, c0, ld_row, Gc, c, v10);
    corner<T, V>(data, t.v11, r1, c1, ld_row, Gc, c, v11);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float top = v00[j] * ax + v01[j] * t.wx;
      const float bot = v10[j] * ax + v11[j] * t.wx;
      gm += r[j] * (top * ay + bot * t.wy);
      g[j] = m * r[j];
      gx += g[j] * ((v01[j] - v00[j]) * ay + (v11[j] - v10[j]) * t.wy);
      gy += g[j] * (bot - top);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (t.v00) atomicAdd(dacc + static_cast<size_t>(r0) * ld_row + c0 * Gc + c + j, g[j] * t.w00);
      if (t.v01) atomicAdd(dacc + static_cast<size_t>(r0) * ld_row + c1 * Gc + c + j, g[j] * t.w01);
      if (t.v10) atomicAdd(dacc + static_cast<size_t>(r1) * ld_row + c0 * Gc + c + j, g[j] * t.w10);
      if (t.v11) atomicAdd(dacc + static_cast<size_t>(r1) * ld_row + c1 * Gc + c + j, g[j] * t.w11);
    }
  }
}

__device__ __forceinline__ void group_reduce(unsigned gmask, int tpg, float& gx, float& gy,
                                             float& gm) {
  for (int s = tpg >> 1; s > 0; s >>= 1) {
    gx += __shfl_xor_sync(gmask, gx, s);
    gy += __shfl_xor_sync(gmask, gy, s);
    gm += __shfl_xor_sync(gmask, gm, s);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(SL_THREADS)
slab_bwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                const float* __restrict__ fy, const float* __restrict__ mask,
                const float* __restrict__ dout, float* __restrict__ dxg,
                float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dmask,
                int H, int W, int P, int K, int Gc, int Hs, int tpg_log2, int smem_bytes) {
  extern __shared__ __align__(16) unsigned char sl_smem[];
  const int nblk = (P + SL_PB - 1) / SL_PB;
  const int bg = blockIdx.x / nblk, p0 = (blockIdx.x % nblk) * SL_PB;
  const int nslab = H / Hs, WGc = W * Gc;
  const Meta meta = carve_meta(sl_smem, K, nslab);
  const size_t meta_b = slab_meta_bytes(K, nslab);
  unsigned char* base = sl_smem + meta_b;
  const size_t cap = static_cast<size_t>(smem_bytes) - meta_b;
  block_band(fy, bg, p0, P, K, H, Hs, meta);

  const size_t img_off = static_cast<size_t>(bg) * H * WGc;
  const T* img = xg + img_off;
  float* dimg = dxg + img_off;
  const int tpg = 1 << tpg_log2, group = threadIdx.x >> tpg_log2, lane = threadIdx.x & (tpg - 1);
  const int ngroups = SL_THREADS >> tpg_log2;
  const unsigned gmask = tpg == 32 ? 0xffffffffu
                                   : ((1u << tpg) - 1u) << ((threadIdx.x & 31) & ~(tpg - 1));
  const int nact = meta.misc[0];
  const size_t n1 = static_cast<size_t>(nact) * Hs * WGc;

  if (align_up(n1 * sizeof(T), 16) + n1 * 4 <= cap) {  // plan 1
    T* data = reinterpret_cast<T*>(base);
    float* dacc = reinterpret_cast<float*>(base + align_up(n1 * sizeof(T), 16));
    const bool vec = (WGc * sizeof(T)) % 16 == 0 && aligned16(img);
    for (int s = 0; s < nslab; ++s)
      if (meta.slot[s] >= 0)
        copy_span(data + static_cast<size_t>(meta.slot[s]) * Hs * WGc,
                  img + static_cast<size_t>(s) * Hs * WGc, Hs * WGc, vec);
    for (size_t e = threadIdx.x; e < n1; e += SL_THREADS) dacc[e] = 0.f;
    copy_done(vec);
    const int* slot = meta.slot;
    auto row = [&](int y) { return slot[y / Hs] * Hs + y % Hs; };
    auto col = [](int x) { return x; };
    for (int qi = group; qi < SL_PB; qi += ngroups) {
      const bool active = p0 + qi < P;  // the same for every lane of the group
      const size_t q = static_cast<size_t>(bg) * P + (active ? p0 + qi : 0);
      for (int k = 0; k < K; ++k) {
        const size_t i = q * K + k;
        float gx = 0.f, gy = 0.f, gm = 0.f;
        if (active) {
          const Tap t = make_tap(fx[i], fy[i], H, W);
          bwd_tap<T, V>(data, dacc, WGc, t, mask[i], dout + q * Gc, Gc, lane, tpg, row, col, gx,
                        gy, gm);
        }
        group_reduce(gmask, tpg, gx, gy, gm);
        if (active && lane == 0) {
          dfx[i] = gx;
          dfy[i] = gy;
          dmask[i] = gm;
        }
      }
    }
    __syncthreads();
    for (int s = 0; s < nslab; ++s) {
      if (meta.slot[s] < 0) continue;
      const float* src = dacc + static_cast<size_t>(meta.slot[s]) * Hs * WGc;
      float* dst = dimg + static_cast<size_t>(s) * Hs * WGc;
      for (int e = threadIdx.x; e < Hs * WGc; e += SL_THREADS)
        if (src[e] != 0.f) atomicAdd(dst + e, src[e]);
    }
    return;
  }

  // plan 2: tap by tap, cell by cell, each cell's dX tile flushed after it
  int RC, WT;
  cell_shape(cap - 16, W, Gc, sizeof(T) + 4, RC, WT);
  const bool vec = (Gc * sizeof(T)) % 16 == 0 && aligned16(img);
  const int ntiles = (W + WT - 1) / WT;
  for (int k = 0; k < K; ++k) {
    int ra, rb;
    tap_rows(meta, k, nslab, Hs, ra, rb);
    const int nchunks = ra < rb ? (rb - ra + RC - 1) / RC : 1;
    for (int ch = 0; ch < nchunks; ++ch) {
      const int cs = ra + ch * RC, ce = ra < rb ? min(cs + RC + 1, H) : cs;
      for (int tl = 0; tl < ntiles; ++tl) {
        const int ts = tl * WT, te = min(ts + WT + 1, W), ncols = te - ts;
        const int ld_row = ncols * Gc;
        const size_t n2 = static_cast<size_t>(ce - cs) * ld_row;
        T* data = reinterpret_cast<T*>(base);
        float* dacc = reinterpret_cast<float*>(base + align_up(n2 * sizeof(T), 16));
        __syncthreads();  // the previous cell is flushed
        for (int r = cs; r < ce; ++r)
          copy_span(data + static_cast<size_t>(r - cs) * ld_row,
                    img + (static_cast<size_t>(r) * W + ts) * Gc, ld_row, vec);
        for (size_t e = threadIdx.x; e < n2; e += SL_THREADS) dacc[e] = 0.f;
        copy_done(vec);
        auto row = [&](int y) { return y - cs; };
        auto col = [&](int x) { return x - ts; };
        for (int qi = group; qi < SL_PB; qi += ngroups) {
          if (p0 + qi >= P) continue;  // the same for every lane of the group
          const size_t q = static_cast<size_t>(bg) * P + p0 + qi;
          const size_t i = q * K + k;
          const Tap t = make_tap(fx[i], fy[i], H, W);
          if (!owns(t, ra, rb, RC, nchunks, WT, W, ch, tl)) continue;
          float gx = 0.f, gy = 0.f, gm = 0.f;
          bwd_tap<T, V>(data, dacc, ld_row, t, mask[i], dout + q * Gc, Gc, lane, tpg, row, col, gx,
                        gy, gm);
          group_reduce(gmask, tpg, gx, gy, gm);
          if (lane == 0) {
            dfx[i] = gx;
            dfy[i] = gy;
            dmask[i] = gm;
          }
        }
        __syncthreads();
        for (size_t e = threadIdx.x; e < n2; e += SL_THREADS) {
          if (dacc[e] == 0.f) continue;
          const int r = static_cast<int>(e / ld_row), rem = static_cast<int>(e % ld_row);
          atomicAdd(dimg + static_cast<size_t>(cs + r) * WGc + static_cast<size_t>(ts) * Gc + rem,
                    dacc[e]);
        }
      }
    }
  }
}

int slab_tpg_log2(int nvec) {
  int l = 0;
  while ((1 << l) < nvec && l < 5) ++l;
  return l;
}

template <typename T, int V, bool BWD>
int launch_slab(const void* xg, const void* fx, const void* fy, const void* mask, const void* dout,
                void* out, void* dfx, void* dfy, void* dmask, int BG, int H, int W, int P, int K,
                int Gc, int Hs, cudaStream_t stream) {
  const int nslab = H / Hs;
  const int l = slab_tpg_log2(Gc / V);
  const size_t meta = slab_meta_bytes(K, nslab);
  const size_t n = static_cast<size_t>(H) * W * Gc;
  // the whole map staged (plan 1 always fits), or the budget
  const size_t full = meta + (BWD ? align_up(n * sizeof(T), 16) + n * 4 : n * sizeof(T));
  const size_t smem = full < SL_BUDGET ? full : SL_BUDGET;
  // plan 2's least cell, two rows of two pixels (+ alignment in the backward)
  const size_t least = meta + 4 * static_cast<size_t>(Gc) * (BWD ? sizeof(T) + 4 : sizeof(T)) +
                       (BWD ? 16 : 0);
  if (smem < full && least > smem) return cudaErrorInvalidValue;
  const long long nblk = (P + SL_PB - 1) / SL_PB;
  const long long blocks = nblk * BG;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (BWD) {
    cudaError_t err = cudaFuncSetAttribute(slab_bwd_kernel<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    slab_bwd_kernel<T, V><<<static_cast<unsigned>(blocks), SL_THREADS, smem, stream>>>(
        static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
        static_cast<const float*>(mask), static_cast<const float*>(dout), static_cast<float*>(out),
        static_cast<float*>(dfx), static_cast<float*>(dfy), static_cast<float*>(dmask), H, W, P, K,
        Gc, Hs, l, static_cast<int>(smem));
  } else {
    cudaError_t err = cudaFuncSetAttribute(slab_fwd_kernel<T, V>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    slab_fwd_kernel<T, V><<<static_cast<unsigned>(blocks), SL_THREADS, smem, stream>>>(
        static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
        static_cast<const float*>(mask), static_cast<float*>(out), H, W, P, K, Gc, Hs, l,
        static_cast<int>(smem));
  }
  return cudaGetLastError();
}

template <bool BWD>
int dispatch_slab(const void* xg, const void* fx, const void* fy, const void* mask,
                  const void* dout, void* out, void* dfx, void* dfy, void* dmask, int BG, int H,
                  int W, int P, int K, int Gc, int Hs, int is_bf16, void* stream) {
  if (BG <= 0 || H <= 0 || W <= 0 || P <= 0 || K <= 0 || Gc <= 0 || Hs <= 0 || H % Hs)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Gc % 4 == 0)
    return is_bf16 ? launch_slab<bf16, 4, BWD>(xg, fx, fy, mask, dout, out, dfx, dfy, dmask, BG,
                                               H, W, P, K, Gc, Hs, s)
                   : launch_slab<float, 4, BWD>(xg, fx, fy, mask, dout, out, dfx, dfy, dmask, BG,
                                                H, W, P, K, Gc, Hs, s);
  return is_bf16 ? launch_slab<bf16, 1, BWD>(xg, fx, fy, mask, dout, out, dfx, dfy, dmask, BG, H,
                                             W, P, K, Gc, Hs, s)
                 : launch_slab<float, 1, BWD>(xg, fx, fy, mask, dout, out, dfx, dfy, dmask, BG,
                                              H, W, P, K, Gc, Hs, s);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K8 row-slab forward.  xg (BG, H, W, Gc) fp32 (is_bf16 = 0) or bf16
// (is_bf16 = 1); fx, fy, mask (BG, P, K) fp32; out (BG, P, Gc) fp32; Hs
// divides H.  All contiguous.
int samrs_bilinear_slab_fwd(const void* xg, const void* fx, const void* fy, const void* mask,
                            void* out, int BG, int H, int W, int P, int K, int Gc, int Hs,
                            int is_bf16, void* stream) {
  return samrs::dispatch_slab<false>(xg, fx, fy, mask, nullptr, out, nullptr, nullptr, nullptr,
                                     BG, H, W, P, K, Gc, Hs, is_bf16, stream);
}

// K8 row-slab backward.  dout (BG, P, Gc) fp32; dxg (BG, H, W, Gc) fp32,
// zeroed by the caller and accumulated with atomics; dfx, dfy, dmask (BG, P,
// K) fp32.
int samrs_bilinear_slab_bwd(const void* xg, const void* fx, const void* fy, const void* mask,
                            const void* dout, void* dxg, void* dfx, void* dfy, void* dmask, int BG,
                            int H, int W, int P, int K, int Gc, int Hs, int is_bf16,
                            void* stream) {
  return samrs::dispatch_slab<true>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, BG, H, W, P, K,
                                    Gc, Hs, is_bf16, stream);
}

}  // extern "C"
