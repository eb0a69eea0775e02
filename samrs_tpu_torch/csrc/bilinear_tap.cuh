// K8's per-thread gather, shared by dense K8 (bilinear_gather.cu) and K8-slab
// (bilinear_slab.cu): one bilinear tap at absolute pixel coordinates (fx, fy) with zero
// padding (the four corners' clamped pixel indices, validity and weights, taken exactly as
// the plain version takes them: samrs_tpu_torch/kernels/bilinear_gather.py::_corners), the
// forward of one thread (a (query, channel vector), or four consecutive outputs: flat-4), and
// the backward kernel (a group of lanes a query), which both run.  Where the forward reads a
// tap's corners is a template parameter: device memory (dense K8), or K8-slab's band of map
// rows in shared memory, with device memory for a tap whose rows the band does not hold.  K9
// (point_sample.cu) takes the corners the same way without the clamped indices (``corners``).
#pragma once

#include "common.cuh"

namespace samrs {

struct Tap {
  int i00, i01, i10, i11;        // pixel index y * W + x (clamped into the map)
  int cx0, cx1, cy0, cy1;        // the corners' columns and rows, clamped into the map
  int x0, y0;                    // floor(fx), floor(fy), clamped into [-2, W] / [-2, H]
  float w00, w01, w10, w11;      // bilinear weights, 0 for a corner off the map
  float wx, wy;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Tap make_tap(float fx, float fy, int H, int W) {
  Tap t;
  const float x0f = floorf(fx), y0f = floorf(fy);
  t.wx = fx - x0f;
  t.wy = fy - y0f;
  // clamp before the int conversion; a clamped corner is off the map either way
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), static_cast<float>(W)));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), static_cast<float>(H)));
  const int x1 = x0 + 1, y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  t.v00 = vy0 && vx0; t.v01 = vy0 && vx1; t.v10 = vy1 && vx0; t.v11 = vy1 && vx1;
  const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
  const int cy0 = min(max(y0, 0), H - 1), cy1 = min(max(y1, 0), H - 1);
  t.cx0 = cx0; t.cx1 = cx1; t.cy0 = cy0; t.cy1 = cy1;
  t.x0 = x0; t.y0 = y0;
  t.i00 = cy0 * W + cx0; t.i01 = cy0 * W + cx1; t.i10 = cy1 * W + cx0; t.i11 = cy1 * W + cx1;
  const float ax = 1.f - t.wx, ay = 1.f - t.wy;
  t.w00 = t.v00 ? ax * ay : 0.f;
  t.w01 = t.v01 ? t.wx * ay : 0.f;
  t.w10 = t.v10 ? ax * t.wy : 0.f;
  t.w11 = t.v11 ? t.wx * t.wy : 0.f;
  return t;
}

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[2]) {
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(p);
  v[0] = __low2float(a); v[1] = __high2float(a);
}
__device__ __forceinline__ void load_vec(const float* p, float (&v)[1]) { v[0] = *p; }
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[1]) { v[0] = __bfloat162float(*p); }

template <typename T, int V>
__device__ __forceinline__ void load_corner(const T* img, bool valid, int pix, int Gc, int c,
                                            float (&v)[V]) {
  if (valid) {
    load_vec(img + static_cast<size_t>(pix) * Gc + c, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
}

// V output values with the streaming (evict-first) store policy.
__device__ __forceinline__ void store_out(float* o, const float (&a)[4]) {
  __stcs(reinterpret_cast<float4*>(o), make_float4(a[0], a[1], a[2], a[3]));
}
__device__ __forceinline__ void store_out(float* o, const float (&a)[2]) {
  __stcs(reinterpret_cast<float2*>(o), make_float2(a[0], a[1]));
}
__device__ __forceinline__ void store_out(float* o, const float (&a)[1]) { __stcs(o, a[0]); }

// n / d for n < 2^31 by a multiply-high and a shift, d fixed at launch
// (the magic-number division of PyTorch's IntDivider).
struct FastDiv {
  unsigned mul, shift;
};

inline FastDiv make_fastdiv(unsigned d) {
  unsigned shift = 0;
  while ((1ull << shift) < d) ++shift;
  const uint64_t one = 1;
  return {static_cast<unsigned>(((one << 32) * ((one << shift) - d)) / d + 1), shift};
}

__device__ __forceinline__ unsigned fast_div(unsigned n, FastDiv f) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

// The four corners' V channels from c of one tap (zeros off the map).
template <typename T, int V>
__device__ __forceinline__ void load_corners(const T* img, const Tap& t, int Gc, int c,
                                             float (&v)[4][V]) {
  load_corner<T, V>(img, t.v00, t.i00, Gc, c, v[0]);
  load_corner<T, V>(img, t.v01, t.i01, Gc, c, v[1]);
  load_corner<T, V>(img, t.v10, t.i10, Gc, c, v[2]);
  load_corner<T, V>(img, t.v11, t.i11, Gc, c, v[3]);
}

// ---------------------------------------------------------------------------
// Where a tap's corners are read.
// ---------------------------------------------------------------------------

// Dense K8: the query's map in device memory.
template <typename T>
struct MapCorners {
  const T* img;
  template <int V>
  __device__ __forceinline__ void load(const Tap& t, int Gc, int c, float (&v)[4][V]) const {
    load_corners<T, V>(img, t, Gc, c, v);
  }
};

// K8-slab: where a tap's two corner rows (clamped into the map) sit on chip.  One staged run
// holds rows [y0, y0 + n): a map element at flat index i of the map (pixel * Gc + channel) of
// such a row is element shift + i on chip.  Several runs: rowoff[y] is row y's element offset
// on chip, -1 where it is not there.
struct Rows {
  const int* rowoff;  // several runs; null: one run, or none (n 0)
  int y0, n, shift;
  // the chip's element offset of flat index i0 of row cy0 and of i1 of row cy1, or false
  // where either row is not on chip
  __device__ __forceinline__ bool at(int cy0, int cy1, int WGc, int& s0, int& s1) const {
    if (rowoff == nullptr) {
      s0 = s1 = shift;
      return static_cast<unsigned>(cy0 - y0) < static_cast<unsigned>(n) &&
             static_cast<unsigned>(cy1 - y0) < static_cast<unsigned>(n);
    }
    const int r0 = rowoff[cy0], r1 = rowoff[cy1];
    s0 = r0 - cy0 * WGc;
    s1 = r1 - cy1 * WGc;
    return r0 >= 0 && r1 >= 0;
  }
};

template <typename T, int V>
__device__ __forceinline__ void load_at(const T* band, bool valid, int i, float (&v)[V]) {
  if (valid) {
    load_vec(band + i, v);
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = 0.f;
  }
}

// K8-slab: a tap whose two corner rows are both on chip reads its corners from the band
// (shared memory), any other tap from the map in device memory (img).  COUNT (a measurement
// build): each (query, tap) is counted once, at channel 0, by the route it took: tally[0]
// from the band, tally[1] from device memory.
template <typename T, bool COUNT = false>
struct BandCorners {
  const T* img;
  const T* band;
  Rows rows;
  int WGc;
  unsigned* tally;
  template <int V>
  __device__ __forceinline__ void load(const Tap& t, int Gc, int c, float (&v)[4][V]) const {
    int s0, s1;
    const bool on = rows.at(t.cy0, t.cy1, WGc, s0, s1);
    if constexpr (COUNT) {
      if (c == 0) ++tally[on ? 0 : 1];
    }
    if (on) {
      load_at<T, V>(band, t.v00, s0 + t.i00 * Gc + c, v[0]);
      load_at<T, V>(band, t.v01, s0 + t.i01 * Gc + c, v[1]);
      load_at<T, V>(band, t.v10, s1 + t.i10 * Gc + c, v[2]);
      load_at<T, V>(band, t.v11, s1 + t.i11 * Gc + c, v[3]);
    } else {
      load_corners<T, V>(img, t, Gc, c, v);
    }
  }
};

// The corner source of the map of bg (the flat-4 form's two queries may lie in two maps).
template <typename T>
struct MapFamily {
  const T* xg;
  size_t map;  // H * W * Gc
  __device__ __forceinline__ MapCorners<T> at(unsigned bg) const { return {xg + bg * map}; }
};

template <typename T, bool COUNT = false>
struct BandFamily {
  const T* xg;
  size_t map;
  const T* band;
  Rows rows;
  int WGc;
  unsigned bg;  // the map the band holds rows of
  unsigned* tally;
  __device__ __forceinline__ BandCorners<T, COUNT> at(unsigned b) const {
    return {xg + b * map, band, b == bg ? rows : Rows{nullptr, 0, 0, 0}, WGc, tally};
  }
};

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

// Forms of the forward: per channel vector, and flat-4 (odd Gc >= 3).
enum FwdForm { kVector = 0, kFlat4 = 1 };

// acc += m (v00 w00 + v01 w01 + v10 w10 + v11 w11) for one tap, rounded op
// by op (no fused multiply-add), in the plain version's order.
template <int V>
__device__ __forceinline__ void add_tap(float (&acc)[V], const float (&v)[4][V], const Tap& t,
                                        float m) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float s = __fmul_rn(v[0][e], t.w00);
    s = __fadd_rn(s, __fmul_rn(v[1][e], t.w01));
    s = __fadd_rn(s, __fmul_rn(v[2][e], t.w10));
    s = __fadd_rn(s, __fmul_rn(v[3][e], t.w11));
    acc[e] = __fadd_rn(acc[e], __fmul_rn(m, s));
  }
}

template <int V, class Src>
__device__ __forceinline__ void gather_tap(float (&acc)[V], const Src& src, float x, float y,
                                           float m, int H, int W, int Gc, int c) {
  const Tap t = make_tap(x, y, H, W);
  float v[4][V];
  src.template load<V>(t, Gc, c, v);
  add_tap<V>(acc, v, t, m);
}

// A query's KT taps (fx, fy, mask), loaded together (one 16-byte load of each at KT 4).
template <int KT>
struct Taps {
  float x[KT], y[KT], m[KT];
};

template <int KT, typename I>
__device__ __forceinline__ void load_taps(Taps<KT>& tp, const float* __restrict__ fx,
                                          const float* __restrict__ fy,
                                          const float* __restrict__ mask, I q) {
  const I i0 = q * KT;
  if constexpr (KT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(fx + i0);
    const float4 b = *reinterpret_cast<const float4*>(fy + i0);
    const float4 w = *reinterpret_cast<const float4*>(mask + i0);
    tp.x[0] = a.x, tp.x[1] = a.y, tp.x[2] = a.z, tp.x[3] = a.w;
    tp.y[0] = b.x, tp.y[1] = b.y, tp.y[2] = b.z, tp.y[3] = b.w;
    tp.m[0] = w.x, tp.m[1] = w.y, tp.m[2] = w.z, tp.m[3] = w.w;
  } else {
#pragma unroll
    for (int k = 0; k < KT; ++k) tp.x[k] = fx[i0 + k], tp.y[k] = fy[i0 + k], tp.m[k] = mask[i0 + k];
  }
}

// The gather of loaded taps for channels c .. c + V - 1 into o + c.
template <int V, int KT, class Src>
__device__ __forceinline__ void gather_taps(const Src& src, const Taps<KT>& tp,
                                            float* __restrict__ o, int c, int H, int W, int Gc) {
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
#pragma unroll
  for (int k = 0; k < KT; ++k) gather_tap<V>(acc, src, tp.x[k], tp.y[k], tp.m[k], H, W, Gc, c);
  store_out(o + c, acc);
}

// The forward of one thread of the per-vector form: query q, channels c ..
// c + V - 1, over KT taps (the path's K) loaded together, or K of a runtime
// loop where KT is 0; corners from `src` (MapCorners or BandCorners of q's
// map).  I is the index type (int where every flat index fits 31 bits, long
// long else).
template <int V, int KT, typename I, class Src>
__device__ __forceinline__ void gather_vector(const Src& src,
                                              const float* __restrict__ fx,
                                              const float* __restrict__ fy,
                                              const float* __restrict__ mask,
                                              float* __restrict__ o, I q, int c, int H, int W,
                                              int K, int Gc) {
  if constexpr (KT == 0) {
    float acc[V];
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = 0.f;
    for (int k = 0; k < K; ++k) {
      const I i = q * K + k;
      gather_tap<V>(acc, src, fx[i], fy[i], mask[i], H, W, Gc, c);
    }
    store_out(o + c, acc);
  } else {
    Taps<KT> tp;
    load_taps<KT>(tp, fx, fy, mask, q);
    gather_taps<V, KT>(src, tp, o, c, H, W, Gc);
  }
}

// The flat-4 form (odd Gc >= 3, scalar channels): a thread takes the outputs
// 4e .. 4e + 3 of the flat (BG, P, Gc) output -- one 16-byte store -- which
// lie in at most two queries, and does each query's tap arithmetic once for
// its channels among them; corners from `maps.at(bg)` of each query's map.
template <typename T, int KT, class Family>
__device__ __forceinline__ void gather_flat4(const Family& maps,
                                             const float* __restrict__ fx,
                                             const float* __restrict__ fy,
                                             const float* __restrict__ mask,
                                             float* __restrict__ out, int f0, int total_out,
                                             FastDiv by_gc, FastDiv by_p, int H, int W,
                                             int Gc) {
  const int qa = static_cast<int>(fast_div(f0, by_gc));
  const int ca = f0 - qa * Gc;
  const int n = min(4, total_out - f0);  // outputs of this thread
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int part = 0; part < 2; ++part) {
    // part 0: query qa, channels ca .. ; part 1: query qa + 1, channels 0 ..
    const int q = qa + part;
    const int lo = part == 0 ? 0 : Gc - ca;   // outputs of this part: [lo, hi)
    const int hi = part == 0 ? min(n, Gc - ca) : n;
    if (lo >= hi) continue;
    const auto src = maps.at(fast_div(q, by_p));
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int i = q * KT + k;
      const Tap t = make_tap(fx[i], fy[i], H, W);
      const float m = mask[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= lo && e < hi) {
          float v[4][1], a[1] = {acc[e]};
          src.template load<1>(t, Gc, ca + e - (part == 0 ? 0 : Gc), v);
          add_tap<1>(a, v, t, m);
          acc[e] = a[0];
        }
      }
    }
  }
  if (n == 4) {
    store_out(out + f0, acc);
  } else {
    for (int e = 0; e < n; ++e) __stcs(out + f0 + e, acc[e]);
  }
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// One reduction of the channel vector g * w into dX at a corner (16 bytes
// at once where V is 4), none for a corner off the map or of weight 0;
// returns the count of reductions issued.
template <int V>
__device__ __forceinline__ unsigned scatter(float* dimg, bool valid, int pix, int Gc, int c,
                                            float w, const float (&g)[V]) {
  if (!valid || w == 0.f) return 0;
  float* d = dimg + static_cast<size_t>(pix) * Gc + c;
  if constexpr (V == 4) {
    atomicAdd(reinterpret_cast<float4*>(d), make_float4(g[0] * w, g[1] * w, g[2] * w, g[3] * w));
  } else {
    atomicAdd(d, g[0] * w);
  }
  return 1;
}

template <int V>
__device__ __forceinline__ unsigned scatter_corners(float* dimg, const Tap& t, int Gc, int c,
                                                    const float (&g)[V]) {
  unsigned n = scatter<V>(dimg, t.v00, t.i00, Gc, c, t.w00, g);
  n += scatter<V>(dimg, t.v01, t.i01, Gc, c, t.w01, g);
  n += scatter<V>(dimg, t.v10, t.i10, Gc, c, t.w10, g);
  n += scatter<V>(dimg, t.v11, t.i11, Gc, c, t.w11, g);
  return n;
}

// log2 of the lanes of a query's group in the backward: min(32, pow2ceil(Gc / V)).
inline int tpg_log2_for(int nvec) {
  int l = 0;
  while ((1 << l) < nvec && l < 5) ++l;
  return l;
}

constexpr int K8_BWD_THREADS = 256;

// K8's backward (dense K8's, and K8-slab's): a group of tpg = 2^tpg_log2 lanes a query, V
// channels a lane; for each tap, its corners from the query's map in device memory, dfx, dfy
// and dmask reduced over the group's channels (shuffles; lane 0 stores them) and dX reduced
// into device memory (scatter).  ONE: the group's lanes cover Gc in one pass (Gc / V <= the
// group size), so a lane loads its dout vector once for all the query's taps.  Where `nred`
// is not null, the reductions the launch issues are added to *nred (a measurement of the
// scatter; null on the training paths).
template <typename T, int V, bool ONE>
__global__ void __launch_bounds__(K8_BWD_THREADS)
bilinear_bwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                    const float* __restrict__ fy, const float* __restrict__ mask,
                    const float* __restrict__ dout, float* __restrict__ dxg,
                    float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dmask,
                    unsigned long long* __restrict__ nred, int BG, int H, int W, int P, int K,
                    int Gc, int tpg_log2) {
  const long long gid = static_cast<long long>(blockIdx.x) * K8_BWD_THREADS + threadIdx.x;
  const long long q = gid >> tpg_log2;
  unsigned issued = 0;
  const int tpg = 1 << tpg_log2;
  const int lane = static_cast<int>(gid & (tpg - 1));
  // every lane of a group takes part in the shuffles, so none returns early
  const bool active = q < static_cast<long long>(BG) * P;
  const int bg = active ? static_cast<int>(q / P) : 0;
  const size_t img_off = static_cast<size_t>(bg) * H * W * Gc;
  const T* img = xg + img_off;
  float* dimg = dxg + img_off;
  const int nvec = Gc / V;
  const float* drow = dout + static_cast<size_t>(active ? q : 0) * Gc;
  float r1[V];
  if (ONE && active && lane < nvec) load_vec(drow + lane * V, r1);
  for (int k = 0; k < K; ++k) {
    const size_t i = static_cast<size_t>(active ? q : 0) * K + k;
    float tx = 0.f, ty = 0.f, tm = 0.f;
    if (active && lane == 0) tx = fx[i], ty = fy[i], tm = mask[i];
    tx = __shfl_sync(0xffffffffu, tx, 0, tpg);
    ty = __shfl_sync(0xffffffffu, ty, 0, tpg);
    tm = __shfl_sync(0xffffffffu, tm, 0, tpg);
    float gx = 0.f, gy = 0.f, gm = 0.f;
    if (active) {
      const Tap t = make_tap(tx, ty, H, W);
      const float m = tm;
      const float ax = 1.f - t.wx, ay = 1.f - t.wy;
      for (int cv = lane; cv < nvec; cv += tpg) {
        const int c = cv * V;
        float r[V], v[4][V], g[V];
        if constexpr (ONE) {
#pragma unroll
          for (int j = 0; j < V; ++j) r[j] = r1[j];
        } else {
          load_vec(drow + c, r);
        }
        load_corners<T, V>(img, t, Gc, c, v);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float top = v[0][j] * ax + v[1][j] * t.wx;
          const float bot = v[2][j] * ax + v[3][j] * t.wx;
          gm += r[j] * (top * ay + bot * t.wy);
          g[j] = m * r[j];
          gx += g[j] * ((v[1][j] - v[0][j]) * ay + (v[3][j] - v[2][j]) * t.wy);
          gy += g[j] * (bot - top);
        }
        if (m != 0.f) issued += scatter_corners<V>(dimg, t, Gc, c, g);
      }
    }
    for (int s = tpg >> 1; s > 0; s >>= 1) {
      gx += __shfl_xor_sync(0xffffffffu, gx, s);
      gy += __shfl_xor_sync(0xffffffffu, gy, s);
      gm += __shfl_xor_sync(0xffffffffu, gm, s);
    }
    if (active && lane == 0) {
      dfx[i] = gx;
      dfy[i] = gy;
      dmask[i] = gm;
    }
  }
  if (nred != nullptr) {
    const unsigned warp_total = __reduce_add_sync(0xffffffffu, issued);
    if ((threadIdx.x & 31) == 0) atomicAdd(nred, static_cast<unsigned long long>(warp_total));
  }
}

// The backward's launch: V = 4 where Gc % 4 == 0, else 1.
template <typename T>
int launch_bilinear_bwd(const void* xg, const void* fx, const void* fy, const void* mask,
                        const void* dout, void* dxg, void* dfx, void* dfy, void* dmask, void* nred,
                        int BG, int H, int W, int P, int K, int Gc, cudaStream_t stream) {
  const int V = Gc % 4 == 0 ? 4 : 1;
  const int l = tpg_log2_for(Gc / V);
  const long long threads = (static_cast<long long>(BG) * P) << l;
  const long long blocks = (threads + K8_BWD_THREADS - 1) / K8_BWD_THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool one = Gc / V <= (1 << l);
  auto kernel = V == 4 ? (one ? bilinear_bwd_kernel<T, 4, true> : bilinear_bwd_kernel<T, 4, false>)
                       : (one ? bilinear_bwd_kernel<T, 1, true> : bilinear_bwd_kernel<T, 1, false>);
  kernel<<<static_cast<unsigned>(blocks), K8_BWD_THREADS, 0, stream>>>(
      static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(mask), static_cast<const float*>(dout),
      static_cast<float*>(dxg), static_cast<float*>(dfx), static_cast<float*>(dfy),
      static_cast<float*>(dmask), static_cast<unsigned long long*>(nred), BG, H, W, P, K, Gc,
      l);
  return cudaGetLastError();
}

}  // namespace samrs
