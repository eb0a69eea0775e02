// K2: global attention with the decomposed relative-position bias, heads
// read in place from the raw (B, N, 3C) qkv tensor.
//
// Replaces samrs_tpu/kernels/flash_attention.py::_qkv_m_kernel (variant
// "m"), _qkv_flash_kernel ("split", and "exp2" with exp2=True) and
// _qkv_aug_kernel ("aug"), which keep all of one image's K/V resident in
// VMEM and take the softmax in one pass, with the rel-pos bias riding one-hot
// matmuls and the row sum riding a ones lane of v.  Bound on the H100:
// tensor-core flops and the exp/softmax work on the CUDA cores (ViT-H: 16
// heads x 4096^2 x 80 x 4 = 86 GFLOP per layer against 31 MB of qkv), and
// the 4096 x 4096 logits per head must never reach device memory.  So this
// is a flash kernel:
//   * one block per (64-query tile, head, image); four warps, 16 rows each;
//   * a loop over 64-key tiles of K and V, double-buffered in shared memory
//     with cp.async so the next tile loads while this one multiplies
//     (flash_key_loop in warp_attention.cuh, shared with K12);
//   * logits, probabilities and the output accumulate in registers, with an
//     online softmax in fp32;
//   * the bias s += rel_h[q, k / kw] + rel_w[q, k % kw] is added from the
//     fp32 rel_h / rel_w rows computed outside (as the JAX package does):
//     where kw % 64 == 0 a key tile lies in one grid row and the row term is
//     one register a tile; elsewhere (e.g. a 48 x 48 grid) a tile straddles
//     rows and each key is split into (row, column) on its own, and N need
//     not be a multiple of 64 (the ragged tiles are masked).
// The modes differ only where their TPU twins round: "m" and "split" are
// this function; "exp2" takes the softmax in base 2 (the wrapper folds log2 e
// into the scale and the rel rows); "aug" rounds q * scale to bf16 before
// the q.k product (here, in shared memory) and adds rel rows that the
// wrapper rounded to bf16.
#include "warp_attention.cuh"

namespace samrs {
namespace {

constexpr int FA_BQ = 64;
constexpr int FA_WARPS = 4;

enum FlashMode { kFlashNatural = 0, kFlashExp2 = 1, kFlashAug = 2 };

__host__ __device__ constexpr int fa_ld(int hd) { return hd + 8; }  // 16-byte rows, conflict-free ldmatrix
__host__ __device__ constexpr size_t fa_tile_bytes(int hd) { return align_up((size_t)FA_BQ * fa_ld(hd) * 2, 128); }
__host__ __device__ constexpr size_t fa_smem(int hd) { return 5 * fa_tile_bytes(hd); }  // Q + 2 x (K, V)

template <int HD, int MODE, bool ROW_TILES>
__global__ void __launch_bounds__(FA_WARPS * 32)
flash_relpos_kernel(const bf16* __restrict__ qkv, const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w, bf16* __restrict__ out,
                    int N, int C, int KH, int KW, float scale) {
  constexpr int LD = fa_ld(HD);
  constexpr size_t TILE = fa_tile_bytes(HD);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* const Ks[2] = {reinterpret_cast<bf16*>(smem + TILE), reinterpret_cast<bf16*>(smem + 3 * TILE)};
  bf16* const Vs[2] = {reinterpret_cast<bf16*>(smem + 2 * TILE), reinterpret_cast<bf16*>(smem + 4 * TILE)};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q0 = blockIdx.x * FA_BQ, h = blockIdx.y, b = blockIdx.z;
  const int nH = gridDim.y, C3 = 3 * C;
  const bf16* base = qkv + (size_t)b * N * C3;

  auto load_kv = [&](int stage, int k0) {
    load_tile_rows_async<HD>(Ks[stage], base, k0, N, C3, C + h * HD, LD);
    load_tile_rows_async<HD>(Vs[stage], base, k0, N, C3, 2 * C + h * HD, LD);
  };
  load_tile_rows_async<HD>(Qs, base, q0, N, C3, h * HD, LD);
  load_kv(0, 0);
  cp_async_commit();

  const size_t head0 = ((size_t)b * nH + h) * N;
  const RelBias rel = lane_rel_bias(rel_h + head0 * KH, rel_w + head0 * KW, q0 + warp * 16, N,
                                    KH, KW);

  WarpAttnState<HD> st;
  st.init();
  flash_key_loop<HD, MODE == kFlashExp2>(
      st, Qs, Ks, Vs, LD, N, MODE == kFlashAug ? 1.f : scale,
      load_kv,
      [&](bf16* Qw) {  // aug: q * scale rounded to bf16 before the product
        if (MODE == kFlashAug)
          for (int i = lane; i < 16 * HD; i += 32) {
            bf16& e = Qw[(i / HD) * LD + i % HD];
            e = __float2bfloat16_rn(__bfloat162float(e) * scale);
          }
      },
      [&](int k0) {
        if constexpr (ROW_TILES) return rel.row_tile(k0);
        else return rel.any_tile(k0);
      });

  const int g = lane >> 2, t = lane & 3, r0 = q0 + warp * 16 + g;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (r0 + 8 * half >= N) continue;
    const float inv = 1.f / st.l[half];
    bf16* orow = out + ((size_t)b * N + r0 + 8 * half) * C + h * HD + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
          __floats2bfloat162_rn(st.o[n][2 * half] * inv, st.o[n][2 * half + 1] * inv);
  }
}

template <int HD, int MODE, bool ROW_TILES>
int launch_flash_tiles(const void* qkv, const void* rel_h, const void* rel_w, void* out, int B,
                       int N, int C, int num_heads, int kh, int kw, float scale,
                       cudaStream_t stream) {
  constexpr int smem = (int)fa_smem(HD);
  auto kernel = flash_relpos_kernel<HD, MODE, ROW_TILES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + FA_BQ - 1) / FA_BQ, num_heads, B);
  kernel<<<grid, FA_WARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<bf16*>(out), N, C, kh, kw, scale);
  return cudaGetLastError();
}

template <int HD, int MODE>
int launch_flash(const void* qkv, const void* rel_h, const void* rel_w, void* out, int B, int N,
                 int C, int num_heads, int kh, int kw, float scale, cudaStream_t stream) {
  if (kw % FA_BQ == 0)
    return launch_flash_tiles<HD, MODE, true>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw,
                                              scale, stream);
  return launch_flash_tiles<HD, MODE, false>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw,
                                             scale, stream);
}

template <int HD>
int launch_flash_mode(int mode, const void* qkv, const void* rel_h, const void* rel_w, void* out,
                      int B, int N, int C, int num_heads, int kh, int kw, float scale,
                      cudaStream_t st) {
  if (mode == kFlashNatural)
    return launch_flash<HD, kFlashNatural>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  if (mode == kFlashExp2)
    return launch_flash<HD, kFlashExp2>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  if (mode == kFlashAug)
    return launch_flash<HD, kFlashAug>(qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace samrs

extern "C" {

// qkv (B, N, 3C) bf16; rel_h (B, nH, N, kh) and rel_w (B, nH, N, kw) fp32
// with N = kh * kw -> out (B, N, C) bf16.  mode: 0 natural softmax ("m",
// "split"), 1 base 2 ("exp2": log2 e already in scale and the rel rows),
// 2 "aug" (q * scale rounded to bf16 before the product).
int samrs_flash_attention_relpos(const void* qkv, const void* rel_h, const void* rel_w, void* out,
                                 int B, int N, int C, int num_heads, int head_dim, int kh, int kw,
                                 float scale, int mode, void* stream) {
  using namespace samrs;
  if (B <= 0 || N <= 0 || kh <= 0 || kw <= 0 || kh * kw != N || num_heads * head_dim != C)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80)
    return launch_flash_mode<80>(mode, qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  if (head_dim == 64)
    return launch_flash_mode<64>(mode, qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
