// K2: global attention with the decomposed relative-position bias, heads
// read in place from the raw (B, N, 3C) qkv tensor.
//
// Replaces samrs_tpu/kernels/flash_attention.py::_qkv_m_kernel, which keeps
// all of one image's K/V resident in VMEM and takes the softmax in one pass,
// with the rel-pos bias riding a one-hot matmul and the row sum riding a
// ones lane of v.  Bound on the H100: tensor-core flops and the exp/softmax
// work on the CUDA cores (ViT-H: 16 heads x 4096^2 x 80 x 4 = 86 GFLOP per
// layer against 31 MB of qkv), and the 4096 x 4096 logits per head must
// never reach device memory.  So this is a flash kernel:
//   * one block per (64-query tile, head, image); four warps, 16 rows each;
//   * a loop over 64-key tiles of K and V, double-buffered in shared memory
//     with cp.async so the next tile loads while this one multiplies;
//   * logits, probabilities and the output accumulate in registers
//     (warp_attention.cuh), with an online softmax in fp32;
//   * the bias s += rel_h[q, k / W] + rel_w[q, k % W] is added per tile from
//     the fp32 rel_h / rel_w rows computed outside (as the JAX package does).
#include "warp_attention.cuh"

namespace samrs {
namespace {

constexpr int FA_BQ = 64;
constexpr int FA_BK = 64;
constexpr int FA_WARPS = 4;

__host__ __device__ constexpr int fa_ld(int hd) { return hd + 8; }  // 16-byte rows, conflict-free ldmatrix
__host__ __device__ constexpr size_t fa_tile_bytes(int hd) { return align_up((size_t)FA_BQ * fa_ld(hd) * 2, 128); }
__host__ __device__ constexpr size_t fa_smem(int hd) { return 5 * fa_tile_bytes(hd); }  // Q + 2 x (K, V)

// Starts the copy of rows [row0, row0 + 64) of one head slice
// (`col` = part*C + h*HD) into shared memory.
template <int HD>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* __restrict__ base, int row0,
                                                int col, int C3) {
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < FA_BQ * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    cp_async16(dst + r * fa_ld(HD) + c * 8, base + (size_t)(row0 + r) * C3 + col + c * 8, true);
  }
}

template <int HD>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_relpos_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, bf16* __restrict__ out,
                    int N, int C, int KH, int KW, float scale) {
  constexpr int LD = fa_ld(HD);
  constexpr size_t TILE = fa_tile_bytes(HD);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  // stage st: K at kv(st, 0), V at kv(st, 1)
  auto kv = [&](int st, int part) {
    return reinterpret_cast<bf16*>(smem + (1 + 2 * st + part) * TILE);
  };
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int nH = gridDim.y, C3 = 3 * C;
  const bf16* base = qkv + (size_t)b * N * C3;

  load_rows_async<HD>(Qs, base, q0, h * HD, C3);
  load_rows_async<HD>(kv(0, 0), base, 0, C + h * HD, C3);
  load_rows_async<HD>(kv(0, 1), base, 0, 2 * C + h * HD, C3);
  cp_async_commit();

  // this lane's rows: g and g + 8 of the warp's 16
  const int g = lane >> 2;
  const size_t row0 = ((size_t)b * nH + h) * N + q0 + warp * 16 + g;
  const float* rh[2] = {rel_h + row0 * KH, rel_h + (row0 + 8) * KH};
  const float* rw[2] = {rel_w + row0 * KW, rel_w + (row0 + 8) * KW};

  WarpAttnState<HD> st;
  st.init();
  uint32_t qa[HD / 16][4];

  const int ntiles = N / FA_BK;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * FA_BK, stage = tile & 1;
    // prefetch the next tile into the other stage (free since the barrier
    // that ended the previous iteration), then wait for this one
    if (tile + 1 < ntiles) {
      load_rows_async<HD>(kv(stage ^ 1, 0), base, k0 + FA_BK, C + h * HD, C3);
      load_rows_async<HD>(kv(stage ^ 1, 1), base, k0 + FA_BK, 2 * C + h * HD, C3);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile == 0) load_q_frags<HD>(qa, Qs + warp * 16 * LD, LD);

    // a 64-key tile lies in one key row of the grid (KW % 64 == 0)
    const float bh[2] = {rh[0][k0 / KW], rh[1][k0 / KW]};
    const float* bw[2] = {rw[0] + k0 % KW, rw[1] + k0 % KW};
    attend_keys<HD, FA_BK / 16>(st, qa, kv(stage, 0), kv(stage, 1), LD, FA_BK / 16, scale,
                                [&](int half, int key) { return bh[half] + bw[half][key]; });
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const float inv = 1.f / st.l[half];
    bf16* orow = out + ((size_t)b * N + q0 + warp * 16 + g + 8 * half) * C + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(st.o[n][2 * half] * inv, st.o[n][2 * half + 1] * inv);
  }
}

template <int HD>
int launch_flash(const void* qkv, const void* rel_h, const void* rel_w, void* out, int B, int N,
                 int C, int num_heads, int kh, int kw, float scale, cudaStream_t stream) {
  constexpr int smem = (int)fa_smem(HD);
  cudaError_t err = cudaFuncSetAttribute(flash_relpos_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid(N / FA_BQ, num_heads, B);
  flash_relpos_kernel<HD><<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<bf16*>(out), N, C, kh, kw, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace samrs

extern "C" {

// qkv (B, N, 3C) bf16; rel_h (B, nH, N, kh) and rel_w (B, nH, N, kw) fp32
// with N = kh * kw and kw a multiple of 64 -> out (B, N, C) bf16.
int samrs_flash_attention_relpos(const void* qkv, const void* rel_h, const void* rel_w, void* out,
                                 int B, int N, int C, int num_heads, int head_dim, int kh, int kw,
                                 float scale, void* stream) {
  using namespace samrs;
  if (B <= 0 || N <= 0 || kw % FA_BK != 0 || kh * kw != N || num_heads * head_dim != C)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return launch_flash<80>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  if (head_dim == 64) return launch_flash<64>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
