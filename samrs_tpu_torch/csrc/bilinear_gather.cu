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
//
// The per-thread code (the tap, a thread's gather) and the backward kernel
// are in bilinear_tap.cuh, shared with K8-slab (bilinear_slab.cu); here the
// forward reads its corners from device memory (MapCorners).
#include "bilinear_tap.cuh"

namespace samrs {
namespace {

constexpr int THREADS = 256;

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
    const MapCorners<T> src{xg + static_cast<size_t>(q / P) * H * W * Gc};
    gather_vector<V, KT, long long>(src, fx, fy, mask, out + q * Gc, q, c, H, W, K, Gc);
  } else if constexpr (FORM == kFlat4) {
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    const MapFamily<T> maps{xg, static_cast<size_t>(H) * W * Gc};
    gather_flat4<T, KT>(maps, fx, fy, mask, out, 4 * e, n, by_n, by_p, H, W, Gc);
  } else {
    const int e = blockIdx.x * THREADS + threadIdx.x;
    if (e >= total) return;
    const int q = static_cast<int>(fast_div(e, by_n));
    const int c = (e - q * n) * V;
    const MapCorners<T> src{xg + static_cast<size_t>(fast_div(q, by_p)) * (H * W * Gc)};
    gather_vector<V, KT, int>(src, fx, fy, mask, out + q * Gc, q, c, H, W, K, Gc);
  }
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
  return is_bf16 ? launch_bilinear_bwd<bf16>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, nred,
                                             BG, H, W, P, K, Gc, s)
                 : launch_bilinear_bwd<float>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask, nred,
                                              BG, H, W, P, K, Gc, s);
}

}  // extern "C"
