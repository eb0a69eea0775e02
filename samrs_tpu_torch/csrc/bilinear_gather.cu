// K8: weighted bilinear gather over absolute pixel coordinates, forward and
// backward.
//
//   out[bg, p, :] = sum_k mask[bg, p, k] * bilinear(xg[bg], fy[bg, p, k], fx[bg, p, k])
//
// xg (BG, H, W, Gc) fp32 or bf16, channels contiguous; fx, fy, mask (BG, P, K)
// fp32; zero padding outside the map; out (BG, P, Gc) fp32.
//
// Replaces samrs_tpu/kernels/bilinear_gather.py::_make_sampler (fwd_call's
// pallas_call and bwd_call's).  The TPU kernels turned the gather into "hat"
// matmuls on the matrix unit (a (P, H) row-weight matrix times the map, an E2
// 0/1 expansion matmul over the lane // Gc layout, transposed hat matmuls for
// dX).  Those are TPU layout devices; here it is the direct gather of the
// reference's CUDA im2col.  No tensor-core work: both kernels are bound by
// device-memory bytes (at the RVSA shape, BG 780, 14x14, Gc 128, K 1: 158 MB
// forward, 238 MB backward).
//
// Forward.  The first version gave each query a group of TPG = min(32,
// pow2ceil(Gc / V)) lanes and walked its taps in a loop of runtime length:
// at Gc 100 that left 7 of 32 lanes idle, at Gc 37 (scalar loads) the group
// looped twice with 5 lanes busy the second time, and every tap waited for
// memory twice (its fx / fy / mask, then its corners) -- 18 round trips a
// query at InternImage's 9 taps; it reached 12-37% of its bytes bound.  Here
// a thread takes one element of the flat (query, channel vector) space, V
// channels wide (V = 4: 16-byte fp32 loads and stores where Gc % 4 == 0; V
// = 2 where Gc % 2 == 0; else 1), so consecutive lanes cover consecutive
// output bytes whatever Gc is, and no lane is idle but in the grid's last
// warp.  The query and channel come from the element index by a
// multiply-high division (FastDiv, fixed at launch), with 32-bit indices
// wherever the sizes allow (a 64-bit form takes the rest: the first
// version's 64-bit division per thread cost more than the taps' loads).  The taps' count is
// a template parameter at the path's K (1, 4, 9): a query's K taps are
// loaded together up front (one 16-byte load each of fx, fy, mask at K 4),
// then gathered one after the other (issuing the corner loads of several
// taps before summing them measured slower: PERF.md, Findings).  At odd Gc (the gt masks'
// 37) a thread takes four consecutive outputs of the flat output instead
// (flat-4: one 16-byte store, scalar loads), which lie in at most two
// queries where Gc >= 3, and does each query's tap arithmetic once for them
// (Gc 1 keeps one output a thread).  At DCNv3's
// 9 taps the tap arithmetic (floor, clamps, weights: ~50 instructions a
// tap, repeated by each of a query's 4 lanes at Gc 16) bounds the kernel
// more than its loads or stores; two ways to share it measured slower
// (PERF.md, Findings).  The output is written with the streaming (evict-first) policy, so
// that the maps, which the queries of a bg re-read, keep L2; consecutive
// blocks take consecutive queries, so one bg's map is read by neighbouring
// blocks while it is in L2.  The shared samples of Mask2Former and the MSDA
// levels scatter their points over the map, so their corner reads come from
// L2, 4 Gc-wide rows a tap: L2 bandwidth, not device memory, bounds them.
//
// The forward rounds each product and sum on its own, in the order of the
// plain PyTorch version (sample_weighted_plain), so the two agree bit for
// bit.  This matters in training: RVSA's grid starts within an ulp of the
// pixel centres, and a contracted multiply-add that moves the sampled K/V
// by 1e-7 reaches the decoder's BatchNorms, whose channels' means dwarf their
// spread at initialisation, and comes out ~1e3 times larger in the gradients.
//
// Backward (replaces bwd_call's pallas_call, body _bwd_kernel): a group of
// TPG lanes a query, V channels a lane (4 where Gc % 4 == 0, else 1), as in
// the forward's first version; dfx, dfy and
// dmask reduce over the channels within the lane group (shuffles); dX is a
// scatter into a zeroed fp32 buffer (the caller casts it to bf16 when xg is
// bf16).  On the TPU each bg's whole dX map stays in VMEM across the
// sequential query-block axis; the card has no such axis, and the first
// version here, one scalar fp32 atomicAdd per channel, corner and tap, ran
// at ~150 G atomics/s, 6.5-31x its bytes bound (89% of the time in the
// reductions at InternImage level 0).  This card's rates at that access
// pattern (chip_breakdown.py --what rates; NVIDIA H100 80GB HBM3 at 700 W):
// 165 G ops/s for scalar red.global.add.f32, 167 G ops/s (667 G values/s)
// for the 16-byte red.global.add.v4.f32, 306 G values/s for shared-memory
// fp32 atomics and 258 G values/s for a warp owning a row of a
// shared-memory map (taps binned by row).  So each lane adds its channel
// vector to a corner with one vector reduction (v4, where Gc % 4 == 0), and
// skips a corner whose weight m * w is 0 (every corner but one of a tap on
// an exact pixel, as InternImage's taps are at initialisation): at most
// Gc / 4 reductions a corner where the first version issued Gc.  Each tap's
// fx, fy and mask are loaded by one lane of its group and shuffled to the
// others, and a query's dout is loaded once for all its taps (Gc <= 4 x
// 32).  The reductions' order is not deterministic: dX differs from run to
// run by fp32 rounding (~1e-7 relative).  The coordinate derivative is the
// one-sided one of the floor formula, exactly JAX's _dhat: at an integer
// coordinate the tap at t in [0, 1) has slope -1, the tap at t in [-1, 0)
// slope +1 and the tap at t = 1 none.
#include "bilinear_tap.cuh"

namespace samrs {
namespace {

constexpr int THREADS = 256;

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

FastDiv make_fastdiv(unsigned d) {
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

template <typename T, int V>
__device__ __forceinline__ void gather_tap(float (&acc)[V], const T* img, float x, float y,
                                           float m, int H, int W, int Gc, int c) {
  const Tap t = make_tap(x, y, H, W);
  float v[4][V];
  load_corners<T, V>(img, t, Gc, c, v);
  add_tap<V>(acc, v, t, m);
}

// The forward of one thread of the per-vector form: query q, channels c ..
// c + V - 1, over KT taps (the path's K) loaded together, or K of a runtime
// loop where KT is 0.  I is the index type (int where every flat index fits
// 31 bits, long long else).
template <typename T, int V, int KT, typename I>
__device__ __forceinline__ void gather_vector(const T* __restrict__ img,
                                              const float* __restrict__ fx,
                                              const float* __restrict__ fy,
                                              const float* __restrict__ mask,
                                              float* __restrict__ o, I q, int c, int H, int W,
                                              int K, int Gc) {
  float acc[V];
#pragma unroll
  for (int e = 0; e < V; ++e) acc[e] = 0.f;
  if constexpr (KT == 0) {
    for (int k = 0; k < K; ++k) {
      const I i = q * K + k;
      gather_tap<T, V>(acc, img, fx[i], fy[i], mask[i], H, W, Gc, c);
    }
  } else {
    float tx[KT], ty[KT], tm[KT];
    const I i0 = q * KT;
    if constexpr (KT == 4) {
      const float4 a = *reinterpret_cast<const float4*>(fx + i0);
      const float4 b = *reinterpret_cast<const float4*>(fy + i0);
      const float4 w = *reinterpret_cast<const float4*>(mask + i0);
      tx[0] = a.x, tx[1] = a.y, tx[2] = a.z, tx[3] = a.w;
      ty[0] = b.x, ty[1] = b.y, ty[2] = b.z, ty[3] = b.w;
      tm[0] = w.x, tm[1] = w.y, tm[2] = w.z, tm[3] = w.w;
    } else {
#pragma unroll
      for (int k = 0; k < KT; ++k) tx[k] = fx[i0 + k], ty[k] = fy[i0 + k], tm[k] = mask[i0 + k];
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) gather_tap<T, V>(acc, img, tx[k], ty[k], tm[k], H, W, Gc, c);
  }
  store_out(o + c, acc);
}

// The flat-4 form (odd Gc >= 3, scalar channels): a thread takes the outputs
// 4e .. 4e + 3 of the flat (BG, P, Gc) output -- one 16-byte store -- which
// lie in at most two queries, and does each query's tap arithmetic once for
// its channels among them.
template <typename T, int KT>
__device__ __forceinline__ void gather_flat4(const T* __restrict__ img0,
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
    const T* img = img0 + static_cast<size_t>(fast_div(q, by_p)) * (H * W * Gc);
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int i = q * KT + k;
      const Tap t = make_tap(fx[i], fy[i], H, W);
      const float m = mask[i];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (e >= lo && e < hi) {
          float v[4][1], a[1] = {acc[e]};
          load_corners<T, 1>(img, t, Gc, ca + e - (part == 0 ? 0 : Gc), v);
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

// Forms of the forward (see the note): per channel vector, and flat-4 (odd Gc >= 3).
enum FwdForm { kVector = 0, kFlat4 = 1 };

// One thread per element e of `total`: a (query, channel vector) of the flat
// space (query q = e / n, n = Gc / V vectors a query, vector e mod n; bg = q
// / P), or for the flat-4 form four consecutive of the n outputs (by_n then
// divides by Gc).  WIDE: 64-bit indices and plain divisions (the per-vector
// form only).
template <typename T, int V, int KT, int FORM, bool WIDE>
__global__ void __launch_bounds__(THREADS)
bilinear_fwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                    const float* __restrict__ fy, const float* __restrict__ mask,
                    float* __restrict__ out, int H, int W, int P, int K, int Gc, int n,
                    long long total, FastDiv by_n, FastDiv by_p) {
  if constexpr (WIDE) {
    const long long e = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
    if (e >= total) return;
    const long long q = e / n;
    const int c = static_cast<int>(e - q * n) * V;
    const T* img = xg + static_cast<size_t>(q / P) * H * W * Gc;
    gather_vector<T, V, KT, long long>(img, fx, fy, mask, out + q * Gc, q, c, H, W, K, Gc);
  } else if constexpr (FORM == kFlat4) {
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    gather_flat4<T, KT>(xg, fx, fy, mask, out, 4 * e, n, by_n, by_p, H, W, Gc);
  } else {
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    const int q = static_cast<int>(fast_div(e, by_n));
    const int c = (e - q * n) * V;
    const T* img = xg + static_cast<size_t>(fast_div(q, by_p)) * (H * W * Gc);
    gather_vector<T, V, KT, int>(img, fx, fy, mask, out + q * Gc, q, c, H, W, K, Gc);
  }
}

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

// ONE: the group's lanes cover Gc in one pass (Gc / V <= the group size), so
// a lane loads its dout vector once for all the query's taps.  Where `nred`
// is not null, the reductions the launch issues are added to *nred (a
// measurement of the scatter; null on the training paths).
template <typename T, int V, bool ONE>
__global__ void __launch_bounds__(THREADS)
bilinear_bwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                    const float* __restrict__ fy, const float* __restrict__ mask,
                    const float* __restrict__ dout, float* __restrict__ dxg,
                    float* __restrict__ dfx, float* __restrict__ dfy, float* __restrict__ dmask,
                    unsigned long long* __restrict__ nred, int BG, int H, int W, int P, int K,
                    int Gc, int tpg_log2) {
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
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
        float r[V], v00[V], v01[V], v10[V], v11[V], g[V];
        if constexpr (ONE) {
#pragma unroll
          for (int j = 0; j < V; ++j) r[j] = r1[j];
        } else {
          load_vec(drow + c, r);
        }
        load_corner<T, V>(img, t.v00, t.i00, Gc, c, v00);
        load_corner<T, V>(img, t.v01, t.i01, Gc, c, v01);
        load_corner<T, V>(img, t.v10, t.i10, Gc, c, v10);
        load_corner<T, V>(img, t.v11, t.i11, Gc, c, v11);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float top = v00[j] * ax + v01[j] * t.wx;
          const float bot = v10[j] * ax + v11[j] * t.wx;
          gm += r[j] * (top * ay + bot * t.wy);
          g[j] = m * r[j];
          gx += g[j] * ((v01[j] - v00[j]) * ay + (v11[j] - v10[j]) * t.wy);
          gy += g[j] * (bot - top);
        }
        if (m != 0.f) {
          issued += scatter<V>(dimg, t.v00, t.i00, Gc, c, t.w00, g);
          issued += scatter<V>(dimg, t.v01, t.i01, Gc, c, t.w01, g);
          issued += scatter<V>(dimg, t.v10, t.i10, Gc, c, t.w10, g);
          issued += scatter<V>(dimg, t.v11, t.i11, Gc, c, t.w11, g);
        }
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

int tpg_log2_for(int nvec) {
  int l = 0;
  while ((1 << l) < nvec && l < 5) ++l;
  return l;
}

template <typename T, int V, int KT, int FORM, bool WIDE>
int launch_fwd_k(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
                 int BG, int H, int W, int P, int K, int Gc, cudaStream_t stream) {
  const long long outs = static_cast<long long>(BG) * P * Gc;
  // threads: (query, vector) elements, or (outputs + 3) / 4 for the flat-4 form
  const int n = FORM == kFlat4 ? static_cast<int>(outs) : Gc / V;
  const long long total = FORM == kFlat4 ? (outs + 3) / 4 : static_cast<long long>(BG) * P * n;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bilinear_fwd_kernel<T, V, KT, FORM, WIDE><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(mask), static_cast<float*>(out), H, W, P, K, Gc, n, total,
      make_fastdiv(static_cast<unsigned>(FORM == kFlat4 ? Gc : n)),
      make_fastdiv(static_cast<unsigned>(P)));
  return cudaGetLastError();
}

template <typename T, int V, int F>
int launch_fwd_taps(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
                    int BG, int H, int W, int P, int K, int Gc, cudaStream_t stream) {
  switch (K) {
    case 1: return launch_fwd_k<T, V, 1, F, false>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, stream);
    case 4: return launch_fwd_k<T, V, 4, F, false>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, stream);
    case 9: return launch_fwd_k<T, V, 9, F, false>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, stream);
    default:
      return launch_fwd_k<T, V, 0, kVector, false>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc,
                                                   stream);
  }
}

// 32-bit indices where the flat element, tap, output and in-map indices all
// stay below 2^31 (the division's range); the unrolled taps at the paths' K;
// the flat-4 form at odd Gc from 3 up (its four outputs then lie in at most
// two queries; Gc 1 takes one output a thread).
template <typename T, int V>
int launch_fwd(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
               int BG, int H, int W, int P, int K, int Gc, cudaStream_t stream) {
  const long long lim = 1LL << 31;
  const long long BP = static_cast<long long>(BG) * P;
  const bool narrow = BP * K < lim && BP * Gc + 4 < lim && static_cast<long long>(H) * W * Gc < lim;
  if (!narrow)
    return launch_fwd_k<T, V, 0, kVector, true>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc,
                                                stream);
  if constexpr (V == 1) {
    if (Gc >= 3)
      return launch_fwd_taps<T, V, kFlat4>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, stream);
  }
  return launch_fwd_taps<T, V, kVector>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, stream);
}

template <typename T, int V>
int launch_bwd(const void* xg, const void* fx, const void* fy, const void* mask, const void* dout,
               void* dxg, void* dfx, void* dfy, void* dmask, void* nred, int BG, int H, int W,
               int P, int K, int Gc, cudaStream_t stream) {
  const int l = tpg_log2_for(Gc / V);
  const long long threads = (static_cast<long long>(BG) * P) << l;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  auto kernel = Gc / V <= (1 << l) ? bilinear_bwd_kernel<T, V, true>
                                    : bilinear_bwd_kernel<T, V, false>;
  kernel<<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(mask), static_cast<const float*>(dout),
      static_cast<float*>(dxg), static_cast<float*>(dfx), static_cast<float*>(dfy),
      static_cast<float*>(dmask), static_cast<unsigned long long*>(nred), BG, H, W, P, K, Gc,
      l);
  return cudaGetLastError();
}

bool bad_shape(int BG, int H, int W, int P, int K, int Gc) {
  return BG <= 0 || H <= 0 || W <= 0 || P <= 0 || K <= 0 || Gc <= 0;
}

}  // namespace
}  // namespace samrs

extern "C" {

// K8 forward.  xg (BG, H, W, Gc) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// fx, fy, mask (BG, P, K) fp32; out (BG, P, Gc) fp32.  All contiguous, with
// 16-byte aligned bases (torch's allocations).
int samrs_bilinear_fwd(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
                       int BG, int H, int W, int P, int K, int Gc, int is_bf16, void* stream) {
  using namespace samrs;
  if (bad_shape(BG, H, W, P, K, Gc)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Gc % 4 == 0)
    return is_bf16 ? launch_fwd<bf16, 4>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s)
                   : launch_fwd<float, 4>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s);
  if (Gc % 2 == 0)
    return is_bf16 ? launch_fwd<bf16, 2>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s)
                   : launch_fwd<float, 2>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s);
  return is_bf16 ? launch_fwd<bf16, 1>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s)
                 : launch_fwd<float, 1>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s);
}

// K8 backward.  dout (BG, P, Gc) fp32; dxg (BG, H, W, Gc) fp32, zeroed by the
// caller and accumulated with reductions (16-byte where Gc % 4 == 0, else
// scalar); dfx, dfy, dmask (BG, P, K) fp32; nred null, or a uint64 on the
// card to which the count of dX reductions issued is added.
int samrs_bilinear_bwd(const void* xg, const void* fx, const void* fy, const void* mask,
                       const void* dout, void* dxg, void* dfx, void* dfy, void* dmask, void* nred,
                       int BG, int H, int W, int P, int K, int Gc, int is_bf16, void* stream) {
  using namespace samrs;
  if (bad_shape(BG, H, W, P, K, Gc)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Gc % 4 == 0)
    return is_bf16 ? launch_bwd<bf16, 4>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, nred, BG,
                                         H, W, P, K, Gc, s)
                   : launch_bwd<float, 4>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, nred, BG,
                                          H, W, P, K, Gc, s);
  return is_bf16 ? launch_bwd<bf16, 1>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, nred, BG, H,
                                       W, P, K, Gc, s)
                 : launch_bwd<float, 1>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, nred, BG, H,
                                        W, P, K, Gc, s);
}

}  // extern "C"
