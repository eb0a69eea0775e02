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
// reference's CUDA im2col.  Per tap a thread takes the floor, the weights and
// the validity of the four corners and reads V contiguous channels of each
// corner (16 B for fp32, 8 B for bf16); a group of TPG = min(32, pow2ceil(Gc/V))
// neighbouring lanes covers the Gc channels of one (bg, p), so each corner is
// one coalesced read of Gc contiguous values.  No tensor-core work: both
// kernels are bound by device-memory bytes (at the RVSA shape, BG 780, 14x14,
// Gc 128, K 1: 158 MB forward, 238 MB backward).
//
// The forward rounds each product and sum on its own, in the order of the
// plain PyTorch version (sample_weighted_plain), so at one tap the two agree
// bit for bit.  This matters in training: RVSA's grid starts within an ulp of
// the pixel centres, and a contracted multiply-add that moves the sampled K/V
// by 1e-7 reaches the decoder's BatchNorms, whose channels' means dwarf their
// spread at initialisation, and comes out ~1e3 times larger in the gradients.
//
// Backward (replaces bwd_call's pallas_call, body _bwd_kernel): dfx, dfy and
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

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
bilinear_fwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                    const float* __restrict__ fy, const float* __restrict__ mask,
                    float* __restrict__ out, int BG, int H, int W, int P, int K, int Gc,
                    int tpg_log2) {
  const long long gid = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  const long long q = gid >> tpg_log2;  // (bg, p)
  const int lane = static_cast<int>(gid & ((1 << tpg_log2) - 1));
  if (q >= static_cast<long long>(BG) * P) return;
  const int bg = static_cast<int>(q / P);
  const T* img = xg + static_cast<size_t>(bg) * H * W * Gc;
  const int nvec = Gc / V;
  for (int cv = lane; cv < nvec; cv += 1 << tpg_log2) {
    const int c = cv * V;
    float acc[V];
#pragma unroll
    for (int j = 0; j < V; ++j) acc[j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const size_t i = static_cast<size_t>(q) * K + k;
      const Tap t = make_tap(fx[i], fy[i], H, W);
      const float m = mask[i];
      float v00[V], v01[V], v10[V], v11[V];
      load_corner<T, V>(img, t.v00, t.i00, Gc, c, v00);
      load_corner<T, V>(img, t.v01, t.i01, Gc, c, v01);
      load_corner<T, V>(img, t.v10, t.i10, Gc, c, v10);
      load_corner<T, V>(img, t.v11, t.i11, Gc, c, v11);
      // rounded op by op (no fused multiply-add), in the plain version's order
#pragma unroll
      for (int j = 0; j < V; ++j) {
        float s = __fmul_rn(v00[j], t.w00);
        s = __fadd_rn(s, __fmul_rn(v01[j], t.w01));
        s = __fadd_rn(s, __fmul_rn(v10[j], t.w10));
        s = __fadd_rn(s, __fmul_rn(v11[j], t.w11));
        acc[j] = __fadd_rn(acc[j], __fmul_rn(m, s));
      }
    }
    float* o = out + static_cast<size_t>(q) * Gc + c;
#pragma unroll
    for (int j = 0; j < V; ++j) o[j] = acc[j];
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

template <typename T, int V>
int launch_fwd(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
               int BG, int H, int W, int P, int K, int Gc, cudaStream_t stream) {
  const int l = tpg_log2_for(Gc / V);
  const long long threads = (static_cast<long long>(BG) * P) << l;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  bilinear_fwd_kernel<T, V><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(mask), static_cast<float*>(out), BG, H, W, P, K, Gc, l);
  return cudaGetLastError();
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
// fx, fy, mask (BG, P, K) fp32; out (BG, P, Gc) fp32.  All contiguous.
int samrs_bilinear_fwd(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
                       int BG, int H, int W, int P, int K, int Gc, int is_bf16, void* stream) {
  using namespace samrs;
  if (bad_shape(BG, H, W, P, K, Gc)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Gc % 4 == 0)
    return is_bf16 ? launch_fwd<bf16, 4>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s)
                   : launch_fwd<float, 4>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, s);
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
