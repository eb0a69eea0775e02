// K12: attention with the decomposed relative-position bias on split heads:
// q, k, v as (B', N, d) bf16 (B' = images x windows x heads, the layout copy
// of the reference SAM), fp32 rel rows rel_h (B', N, kh) and rel_w
// (B', N, kw) computed outside, and
//   out = softmax(q.k^T * scale + rel_h[q, k / kw] + rel_w[q, k % kw]) v
// in fp32 (B', N, d).
//
// Replaces samrs_tpu/kernels/window_attention.py::_window_attention_pallas
// (the windowed layers of window_attn_impl="pallas", and the global layers
// of a grid under 2048 tokens) and flash_attention.py::
// _flash_attention_fwd_pallas (the global layers of the layout-copy path,
// N >= 2048).  The TPU kernels fold the bias into an augmented-K matmul with
// one-hot expansions and keep whole windows / 128-query tiles in VMEM.  Here
// the bias is added per key in registers (split into grid row and column
// per key, so a key tile may straddle grid rows and any (kh, kw) works; a
// tile that lies in one row takes the row term once), with
// an online softmax in fp32 (warp_attention.cuh), in one of two launches:
//   * whole window (N <= 256: a 14x14 window, a 16x16 grid): one block per
//     B' row holds all of K and V in shared memory (73 KB at N 196, d 80)
//     and its four warps take 16-query stripes in turn;
//   * query tiles (N up to 4096): one block per (64 queries, B' row), keys
//     streamed in 64-row tiles through two cp.async stages
//     (flash_key_loop, shared with K2), so the N x N logits never reach
//     device memory.
// Bound on the H100: the windows (one ViT-H image: B' 400, N 196, d 80) move
// ~72 MB for ~4.9 GFLOP, so bytes; the globals (B' 16, N 4096) are tensor-
// core work (~86 GFLOP), as K2's.
#include "warp_attention.cuh"

namespace samrs {
namespace {

constexpr int SA_WARPS = 4;
constexpr int SA_WHOLE_MAX = 256;  // the whole-window launch's largest N

__host__ __device__ constexpr int sa_ld(int hd) { return hd + 8; }  // 16-byte rows, conflict-free ldmatrix
__host__ __device__ constexpr size_t sa_rows_bytes(int rows, int hd) {
  return align_up((size_t)rows * sa_ld(hd) * 2, 128);
}
// whole window: K and V of all keys, then one 16-row Q stripe per warp
__host__ __device__ constexpr size_t sa_whole_smem(int np, int hd) {
  return 2 * sa_rows_bytes(np, hd) + SA_WARPS * sa_rows_bytes(16, hd);
}
// query tiles: Q + 2 x (K, V)
__host__ __device__ constexpr size_t sa_tiled_smem(int hd) { return 5 * sa_rows_bytes(64, hd); }

// Writes this lane's two rows of the normalised output, fp32.
template <int HD>
__device__ __forceinline__ void store_rows_fp32(const WarpAttnState<HD>& st, float* __restrict__ out,
                                                int row0, int n) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= n) continue;
    const float inv = 1.f / st.l[half];
    float* orow = out + (size_t)r * HD + 2 * t;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<float2*>(orow + c * 8) =
          make_float2(st.o[c][2 * half] * inv, st.o[c][2 * half + 1] * inv);
  }
}

template <int HD>
__global__ void __launch_bounds__(SA_WARPS * 32)
split_whole_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w, float* __restrict__ out, int N, int KH,
                   int KW, float scale) {
  constexpr int LD = sa_ld(HD), CH = HD / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  const int np = (N + 15) / 16 * 16;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + sa_rows_bytes(np, HD));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  bf16* Qs = reinterpret_cast<bf16*>(smem + 2 * sa_rows_bytes(np, HD) + warp * sa_rows_bytes(16, HD));
  const size_t b = blockIdx.x;
  const bf16* qb = q + b * N * HD;
  const bf16* kb = k + b * N * HD;
  const bf16* vb = v + b * N * HD;
  const float* rhb = rel_h + b * N * KH;
  const float* rwb = rel_w + b * N * KW;

  for (int idx = threadIdx.x; idx < np * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    const size_t src = (size_t)(r < N ? r : N - 1) * HD + c * 8;
    cp_async16(Ks + r * LD + c * 8, kb + src, r < N);
    cp_async16(Vs + r * LD + c * 8, vb + src, r < N);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  for (int s = warp; s < np / 16; s += SA_WARPS) {
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH, c = idx % CH, row = s * 16 + r;
      cp_async16(Qs + r * LD + c * 8, qb + (size_t)(row < N ? row : N - 1) * HD + c * 8, row < N);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    uint32_t qa[HD / 16][4];
    load_q_frags<HD>(qa, Qs, LD);
    const RelBias rel = lane_rel_bias(rhb, rwb, s * 16, N, KH, KW);
    WarpAttnState<HD> st;
    st.init();
    for (int k0 = 0; k0 < np; k0 += 64) {
      const int nkb = (np - k0) / 16 < 4 ? (np - k0) / 16 : 4;
      attend_keys<HD, 4>(st, qa, Ks + k0 * LD, Vs + k0 * LD, LD, nkb, scale,
                         [&](int half, int key) {
                           const int kk = k0 + key;  // keys past N are tile padding
                           return kk < N ? rel(half, kk) : neg_inf();
                         });
    }
    store_rows_fp32<HD>(st, out + b * N * HD, s * 16, N);
    __syncwarp();  // Qs is rewritten by the next stripe
  }
}

template <int HD, bool ROW_TILES>
__global__ void __launch_bounds__(SA_WARPS * 32)
split_tiled_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w, float* __restrict__ out, int N, int KH,
                   int KW, float scale) {
  constexpr int LD = sa_ld(HD);
  constexpr size_t TILE = sa_rows_bytes(64, HD);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* const Ks[2] = {reinterpret_cast<bf16*>(smem + TILE), reinterpret_cast<bf16*>(smem + 3 * TILE)};
  bf16* const Vs[2] = {reinterpret_cast<bf16*>(smem + 2 * TILE), reinterpret_cast<bf16*>(smem + 4 * TILE)};
  const int warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * 64;
  const size_t b = blockIdx.y;
  const bf16* kb = k + b * N * HD;
  const bf16* vb = v + b * N * HD;

  auto load_kv = [&](int stage, int k0) {
    load_tile_rows_async<HD>(Ks[stage], kb, k0, N, HD, 0, LD);
    load_tile_rows_async<HD>(Vs[stage], vb, k0, N, HD, 0, LD);
  };
  load_tile_rows_async<HD>(Qs, q + b * N * HD, q0, N, HD, 0, LD);
  load_kv(0, 0);
  cp_async_commit();

  const RelBias rel = lane_rel_bias(rel_h + b * N * KH, rel_w + b * N * KW, q0 + warp * 16, N,
                                    KH, KW);
  WarpAttnState<HD> st;
  st.init();
  flash_key_loop<HD>(st, Qs, Ks, Vs, LD, N, scale, load_kv, [](bf16*) {},
                     [&](int k0) {
                       if constexpr (ROW_TILES) return rel.row_tile(k0);
                       else return rel.any_tile(k0);
                     });
  store_rows_fp32<HD>(st, out + b * N * HD, q0 + warp * 16, N);
}

template <int HD>
int launch_split(const void* q, const void* k, const void* v, const void* rel_h, const void* rel_w,
                 void* out, int B, int N, int kh, int kw, float scale, int whole,
                 cudaStream_t stream) {
  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* rh = static_cast<const float*>(rel_h);
  const auto* rw = static_cast<const float*>(rel_w);
  auto* op = static_cast<float*>(out);
  cudaError_t err;
  if (whole) {
    const int smem = (int)sa_whole_smem((N + 15) / 16 * 16, HD);
    err = cudaFuncSetAttribute(split_whole_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    split_whole_kernel<HD><<<B, SA_WARPS * 32, smem, stream>>>(qp, kp, vp, rh, rw, op, N, kh, kw, scale);
  } else {
    constexpr int smem = (int)sa_tiled_smem(HD);
    auto kernel = kw % 64 == 0 ? split_tiled_kernel<HD, true> : split_tiled_kernel<HD, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    dim3 grid((N + 63) / 64, B);
    kernel<<<grid, SA_WARPS * 32, smem, stream>>>(qp, kp, vp, rh, rw, op, N, kh, kw, scale);
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace samrs

extern "C" {

// q, k, v (B', N, head_dim) bf16, rel_h (B', N, kh) and rel_w (B', N, kw)
// fp32 with N = kh * kw -> out (B', N, head_dim) fp32.  whole != 0 takes the
// whole-window launch (N <= 256), else the query-tiled one.
int samrs_split_attention(const void* q, const void* k, const void* v, const void* rel_h,
                          const void* rel_w, void* out, int B, int N, int head_dim, int kh,
                          int kw, float scale, int whole, void* stream) {
  using namespace samrs;
  if (B <= 0 || N <= 0 || kh <= 0 || kw <= 0 || kh * kw != N || (whole && N > SA_WHOLE_MAX))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return launch_split<80>(q, k, v, rel_h, rel_w, out, B, N, kh, kw, scale, whole, st);
  if (head_dim == 64) return launch_split<64>(q, k, v, rel_h, rel_w, out, B, N, kh, kw, scale, whole, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
