// Dense layers of the encoder kernels K1 and K3: a bf16 GEMM with fused
// bias / exact-GELU epilogues and bf16 output, or with the encoder's fp32
// residual stream added and fp32 output, and the fp32-statistics LayerNorm
// of the fp32 stream that opens the MLP sublayer.
//
// Replaces the matrix products inside the TPU kernels
//   samrs_tpu/kernels/fused_mlp.py::_ln_kernel (LN + lin1 + gelu + lin2 + residual)
//   samrs_tpu/kernels/fused_mlp.py::_tail_kernel (tail_impl="fused": the same
//     after crop + attention residual, which the tail LayerNorm reads in place)
//   samrs_tpu/kernels/fused_window_layer.py::_kernel (its qkv and proj matmuls)
// Bound on the H100: tensor-core throughput (ViT-H: 2*T*C*4C flops per
// linear against T*C bf16 bytes, far above the ~295 flop/byte ridge), which
// only wgmma reaches.  The design (hopper.cuh's plumbing): a persistent grid
// of one 384-thread block per SM walks the 128 x BN output tiles; a producer
// warp keeps a 3-6 stage ring of 64-deep A / B tiles in flight with TMA
// (128-byte swizzle, zero fill past the ragged edges), brings each tile's
// bias and fp32 residual into shared memory while its products run, and
// gives its registers to two consumer warpgroups, each multiplying 64 rows x
// BN with wgmma m64nBNk16 straight from shared memory.  The epilogue adds
// bias / GELU / residual from the accumulator registers into a swizzled
// shared-memory tile that one thread stores with TMA, so each activation
// makes one trip through device memory and no global load or scattered
// store stalls it.  BN is chosen per call (256 / 160 for a bf16 output, 160
// / 128 with the fp32 residual tile) for the fewest idle SMs in the last
// wave (N = 1280 at 128 x 256 is 1.2 waves of 132 SMs; at 128 x 160, 1.9).
// Measured (chip_smoke.py's GEMM phase, H100 80GB HBM3 at a 700 W limit):
// ~600 TFLOP/s at the ViT-H qkv shape against cuBLAS's ~660 (the old
// mma.sync / cp.async design: ~220).  The epilogue runs after each tile's
// products, with the tensor cores idle; it is what keeps the GELU (lin1) and
// fp32-residual (lin2, proj) shapes further from cuBLAS's plain product (a
// ping-pong schedule, one warpgroup's epilogue under the other's products
// on 128 x 128 tiles, was slower at every shape).  The MLP hidden
// activation (T x 4C bf16) still goes through device memory.
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int GM_BM = 128;       // rows of an output tile (two consumer warpgroups of 64)
constexpr int GM_BK = 64;        // depth of a stage: 128 bytes of bf16, one swizzle row
constexpr int GM_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int GM_SMEM_MAX = 232448;

// Shared memory of a block: the ring of A / B stages, then the tile's
// epilogue buffers -- its bias slice, and the output tile the TMA stores:
// with an fp32 residual the residual tile itself (BN / 32 boxes of 128 rows
// x 32 fp32, 128-byte swizzled), which the epilogue overwrites with the
// output; else bf16 boxes of 64 rows x 32 (64-byte swizzle), BN / 32 per
// warpgroup -- then the barriers; as many stages as fit (at most 6).
template <int BN, bool RES>
struct GemmTile {
  static constexpr int A_BYTES = GM_BM * GM_BK * 2;
  static constexpr int B_BYTES = BN * GM_BK * 2;  // a multiple of the 1024-byte swizzle atom
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BIAS_BYTES = 1024;
  static constexpr int RES_BYTES = GM_BM * BN * (RES ? 4 : 2);  // residual / output tile
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT =
      (GM_SMEM_MAX - 1024 - BIAS_BYTES - RES_BYTES - BAR_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static constexpr int EPI = STAGES * STAGE_BYTES;  // offset of the bias slice
  static constexpr int SMEM = 1024 + EPI + BIAS_BYTES + RES_BYTES + BAR_BYTES;
  static_assert(STAGES >= 3 && BN <= 256 && BN % 32 == 0, "tile");
};

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&acc)[BN / 2], uint64_t da, uint64_t db,
                                           int scale_d) {
  if constexpr (BN == 256) wgmma_ss_n256(acc, da, db, scale_d);
  else if constexpr (BN == 160) wgmma_ss_n160(acc, da, db, scale_d);
  else wgmma_ss_n128(acc, da, db, scale_d);
}

// C[M,N] = A[M,K] . B[N,K]^T (+ bias[N]) (-> gelu) (+ residual[M,N]).
// A, B bf16 row-major (K-major, wgmma's native form) behind the tensor maps
// tmA (box 64 x 128) and tmB (box 64 x BN); bias fp32; C bf16 (OutT = bf16,
// no residual) or fp32 with an fp32 residual behind tmR (box 32 x 128),
// written through tmC (box 32 x 64).  The epilogue adds in fp32 and rounds
// once.  Requires K % 64 == 0 and N % 8 == 0 (checked by the host entry);
// ragged M and N tiles load zeros and the TMA clips their stores.  The
// producer brings each tile's bias and residual into shared memory while
// the tile's products run; each consumer warpgroup writes its 64 rows into
// shared memory and one thread stores them with TMA, so the epilogue waits
// on no global load and issues no scattered store.
template <int BN, class OutT>
__global__ void __launch_bounds__(GM_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmB,
                  const __grid_constant__ CUtensorMap tmR, const __grid_constant__ CUtensorMap tmC,
                  const float* __restrict__ bias, int M, int N, int K, int gelu) {
  constexpr bool RES = sizeof(OutT) == 4;
  using G = GemmTile<BN, RES>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));  // the swizzle atoms need 1024-byte alignment
  float* bias_s = reinterpret_cast<float*>(smem + G::EPI);
  unsigned char* res_s = smem + G::EPI + G::BIAS_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(res_s + G::RES_BYTES);
  uint64_t* empty = full + G::STAGES;
  uint64_t* epi_full = empty + G::STAGES;
  uint64_t* epi_empty = epi_full + 1;
  const int wg = threadIdx.x >> 7;
  const int tiles_m = (M + GM_BM - 1) / GM_BM;
  const int tiles = tiles_m * ((N + BN - 1) / BN);
  const int KT = K / GM_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; the TMA bytes complete it
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(epi_full, 1);
    mbar_init(epi_empty, 2);  // each warpgroup's storing thread, once its store has read the tile
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tmA);
      tma_prefetch_map(&tmB);
      tma_prefetch_map(&tmC);
      if constexpr (RES) tma_prefetch_map(&tmR);
      const int epi_kb = (KT < G::STAGES ? KT : G::STAGES) - 1;
      int stage = 0;
      unsigned phase = 0, epi_phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * GM_BM, n0 = (tile / tiles_m) * BN;
        for (int kb = 0; kb < KT; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * G::STAGE_BYTES;
          mbar_expect_tx(&full[stage], G::STAGE_BYTES);
          tma_load_2d(st, &tmA, &full[stage], kb * GM_BK, m0);
          tma_load_2d(st + G::A_BYTES, &tmB, &full[stage], kb * GM_BK, n0);
          if (++stage == G::STAGES) stage = 0, phase ^= 1;
          if (kb == epi_kb) {  // the tile's first stages are queued: now its epilogue inputs
            mbar_wait(epi_empty, epi_phase ^ 1);
            const int nb = N - n0 < BN ? N - n0 : BN;
            mbar_expect_tx(epi_full, (bias ? nb * 4 : 0) + (RES ? G::RES_BYTES : 0));
            if (bias) bulk_load(bias_s, bias + n0, nb * 4, epi_full);
            if constexpr (RES) {
#pragma unroll
              for (int bx = 0; bx < BN / 32; ++bx)
                tma_load_2d(res_s + bx * GM_BM * 128, &tmR, epi_full, n0 + 32 * bx, m0);
            }
            epi_phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup c multiplies rows 64c .. 64c + 63 of each tile
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    unsigned phase = 0, epi_phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * GM_BM, n0 = (tile / tiles_m) * BN;
      int prev = 0;
      for (int kb = 0; kb < KT; ++kb) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * G::STAGE_BYTES;
        const uint64_t da = wgmma_desc(st + c * 64 * 128, kSwizzle128B, 16, 1024);
        const uint64_t db = wgmma_desc(st + G::A_BYTES, kSwizzle128B, 16, 1024);
        fence_regs(acc);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < GM_BK / 16; ++k)
          wgmma_tile<BN>(acc, da + 2 * k, db + 2 * k, (kb | k) != 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous stage's products are done: release it
        fence_regs(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        __syncwarp();
        prev = stage;
        if (++stage == G::STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(&empty[prev]);
      __syncwarp();

      mbar_wait(epi_full, epi_phase);
      epi_phase ^= 1;
      named_barrier_sync(1 + c, 128);  // this warpgroup's last store has read its tile
      const int g = lane >> 2, t = lane & 3;
      // bf16 out: this warpgroup's boxes; fp32: its 64 rows of the residual boxes
      unsigned char* out_s = res_s + (RES ? c * 64 * 128 : c * 64 * BN * 2);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cn = j * 8 + 2 * t, cc = cn & 31;
        const float2 bv = bias ? *reinterpret_cast<const float2*>(bias_s + cn) : make_float2(0.f, 0.f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = warp * 16 + g + 8 * half;  // row of the warpgroup's 64
          float v0 = acc[4 * j + 2 * half] + bv.x, v1 = acc[4 * j + 2 * half + 1] + bv.y;
          if (gelu) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          if constexpr (RES) {  // box cn / 32, 16-byte chunk cc / 4 swizzled by the row
            float2* p = reinterpret_cast<float2*>(out_s + (cn >> 5) * GM_BM * 128 + r * 128 +
                                                  (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4);
            const float2 rv = *p;
            *p = make_float2(v0 + rv.x, v1 + rv.y);
          } else {  // box cn / 32 of 64 rows x 64 bytes, chunk cc / 8 swizzled by (r / 2) % 4
            store2(reinterpret_cast<bf16*>(out_s + (cn >> 5) * 64 * 64 + r * 64 +
                                           (((cc >> 3) ^ ((r >> 1) & 3)) << 4) + (cc & 7) * 2),
                   v0, v1);
          }
        }
      }
      fence_proxy_async();
      named_barrier_sync(1 + c, 128);
      if ((threadIdx.x & 127) == 0) {
#pragma unroll
        for (int bx = 0; bx < BN / 32; ++bx)
          tma_store_2d(&tmC, out_s + bx * (RES ? GM_BM * 128 : 64 * 64), n0 + 32 * bx, m0 + 64 * c);
        bulk_commit();
        bulk_wait_read();
        mbar_arrive(epi_empty);
      }
      __syncwarp();
    }
  }
  if ((threadIdx.x & 127) == 0) bulk_wait_all();  // this thread's stores are written
}

template <int BN, class OutT>
int launch_gemm(const void* A, const void* B, const void* bias, const void* residual, void* C,
                int M, int N, int K, int gelu, cudaStream_t stream) {
  using G = GemmTile<BN, sizeof(OutT) == 4>;
  CUtensorMap tmA, tmB, tmR, tmC;
  const uint64_t dimsA[2] = {(uint64_t)K, (uint64_t)M}, dimsB[2] = {(uint64_t)K, (uint64_t)N};
  const uint64_t stride[1] = {(uint64_t)K * 2};
  const uint32_t boxA[2] = {GM_BK, GM_BM}, boxB[2] = {GM_BK, BN};
  int err = make_tensor_map(&tmA, A, 2, dimsA, stride, boxA, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0) err = make_tensor_map(&tmB, B, 2, dimsB, stride, boxB, CU_TENSOR_MAP_SWIZZLE_128B);
  tmR = tmA;
  if (err == 0 && residual) {
    const uint64_t dimsR[2] = {(uint64_t)N, (uint64_t)M}, strideR[1] = {(uint64_t)N * 4};
    const uint32_t boxR[2] = {32, GM_BM};
    err = make_tensor_map(&tmR, residual, 2, dimsR, strideR, boxR, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  }
  if (err == 0) {  // the output, stored in boxes of 64 rows x 32 columns
    const bool f32 = sizeof(OutT) == 4;
    const uint64_t dimsC[2] = {(uint64_t)N, (uint64_t)M}, strideC[1] = {(uint64_t)N * sizeof(OutT)};
    const uint32_t boxC[2] = {32, 64};
    err = make_tensor_map(&tmC, C, 2, dimsC, strideC, boxC,
                          f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                          f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  }
  if (err != 0) return err;
  auto kernel = gemm_wgmma_kernel<BN, OutT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + GM_BM - 1) / GM_BM) * ((N + BN - 1) / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, GM_THREADS, G::SMEM, stream>>>(tmA, tmB, tmR, tmC, static_cast<const float*>(bias),
                                                M, N, K, gelu);
  return cudaGetLastError();
}

// The tile width of the N side: of the two candidates (256 and 160 for a
// bf16 output; 160 and 128 with the fp32 residual tile in shared memory),
// the one whose waves of tiles over the SMs take the least time (a wave's
// time grows with the width), the wider on a tie.
int pick_bn(int M, int N, int wide, int narrow) {
  const int sms = sm_count(), tiles_m = (M + GM_BM - 1) / GM_BM;
  auto cost = [&](int bn) {
    const long tiles = (long)tiles_m * ((N + bn - 1) / bn);
    return (tiles + sms - 1) / sms * bn;
  };
  return cost(narrow) < cost(wide) ? narrow : wide;
}

int launch_gemm_any(const void* A, const void* B, const void* bias, const void* residual, void* C,
                    int M, int N, int K, int gelu, cudaStream_t stream) {
  if (residual) {
    if (pick_bn(M, N, 160, 128) == 128)
      return launch_gemm<128, float>(A, B, bias, residual, C, M, N, K, gelu, stream);
    return launch_gemm<160, float>(A, B, bias, residual, C, M, N, K, gelu, stream);
  }
  if (pick_bn(M, N, 256, 160) == 160)
    return launch_gemm<160, bf16>(A, B, bias, nullptr, C, M, N, K, gelu, stream);
  return launch_gemm<256, bf16>(A, B, bias, nullptr, C, M, N, K, gelu, stream);
}

// Eight consecutive values of a row.
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p), b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// One warp per fp32 row: mean and E[x^2] - mean^2 variance (the JAX oracle's
// form), normalised output rounded to bf16.  Requires C % 8 == 0.
__global__ void __launch_bounds__(256)
layernorm_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
                 const float* __restrict__ beta, bf16* __restrict__ y, int rows, int C,
                 float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* xr = x + (size_t)row * C;
  float s = 0.f, sq = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    load8(xr + c, f);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += f[e];
      sq += f[e] * f[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mu = s / C;
  const float var = fmaxf(sq / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  bf16* yr = y + (size_t)row * C;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    load8(xr + c, f);
    uint4 ov;
    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f0 = (f[2 * e] - mu) * rstd * gamma[c + 2 * e] + beta[c + 2 * e];
      const float f1 = (f[2 * e + 1] - mu) * rstd * gamma[c + 2 * e + 1] + beta[c + 2 * e + 1];
      ob[e] = __floats2bfloat162_rn(f0, f1);
    }
    store16(yr + c, ov);
  }
}

// The sublayer tail's prologue (tail_impl="fused"): one warp per token of
// the (B, H, W) map; x = sc + att, with att read in place from the padded
// (B, Hp, Wp, C) bf16 attention map (the crop is in the addressing), is
// written to xs (the residual of the lin2 epilogue) and normalised as
// layernorm_kernel does.  Requires C % 8 == 0.
__global__ void __launch_bounds__(256)
layernorm_tail_kernel(const float* __restrict__ sc, const bf16* __restrict__ att,
                      const float* __restrict__ gamma, const float* __restrict__ beta,
                      float* __restrict__ xs, bf16* __restrict__ y, int rows, int H, int W,
                      int Hp, int Wp, int C, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const int b = row / (H * W), x = row / W % H, col = row % W;
  const float* sr = sc + (size_t)row * C;
  const bf16* ar = att + (((size_t)b * Hp + x) * Wp + col) * C;
  float* xr = xs + (size_t)row * C;
  float s = 0.f, sq = 0.f;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    load8(sr + c, f);
    const uint4 av = load16(ar + c);
    const __nv_bfloat162* ab = reinterpret_cast<const __nv_bfloat162*>(&av);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] += __bfloat162float(ab[e].x);
      f[2 * e + 1] += __bfloat162float(ab[e].y);
    }
    *reinterpret_cast<float4*>(xr + c) = make_float4(f[0], f[1], f[2], f[3]);
    *reinterpret_cast<float4*>(xr + c + 4) = make_float4(f[4], f[5], f[6], f[7]);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      s += f[e];
      sq += f[e] * f[e];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    sq += __shfl_xor_sync(0xffffffffu, sq, o);
  }
  const float mu = s / C;
  const float var = fmaxf(sq / C - mu * mu, 0.f);
  const float rstd = rsqrtf(var + eps);
  bf16* yr = y + (size_t)row * C;
  for (int c = lane * 8; c < C; c += 256) {
    float f[8];
    load8(xr + c, f);  // this lane's own writes above
    uint4 ov;
    __nv_bfloat162* ob = reinterpret_cast<__nv_bfloat162*>(&ov);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float f0 = (f[2 * e] - mu) * rstd * gamma[c + 2 * e] + beta[c + 2 * e];
      const float f1 = (f[2 * e + 1] - mu) * rstd * gamma[c + 2 * e + 1] + beta[c + 2 * e + 1];
      ob[e] = __floats2bfloat162_rn(f0, f1);
    }
    store16(yr + c, ov);
  }
}

}  // namespace
}  // namespace samrs

extern "C" {

const char* samrs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// C = A . B^T (+ bias) (-> gelu); A, B bf16; C bf16, or with an fp32
// residual C = residual + ... in fp32.
int samrs_gemm_bf16(const void* A, const void* B, const void* bias, const void* residual,
                    void* C, int M, int N, int K, int gelu, void* stream) {
  using namespace samrs;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0 || K % GM_BK != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return launch_gemm_any(A, B, bias, residual, C, M, N, K, gelu, st);
}

// Row LayerNorm of fp32 x -> bf16 y.
int samrs_layernorm(const void* x, const void* gamma, const void* beta, void* y, int rows, int C,
                    float eps, void* stream) {
  using namespace samrs;
  if (rows <= 0 || C <= 0 || C % 8 != 0) return cudaErrorInvalidValue;
  layernorm_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<bf16*>(y), rows, C, eps);
  return cudaGetLastError();
}

// The tail prologue: xs = sc + att[:, :H, :W] (fp32) and its LayerNorm
// -> bf16 y; sc (B, H, W, C) fp32, att (B, Hp, Wp, C) bf16.
int samrs_layernorm_tail(const void* sc, const void* att, const void* gamma, const void* beta,
                         void* xs, void* y, int B, int H, int W, int Hp, int Wp, int C, float eps,
                         void* stream) {
  using namespace samrs;
  if (B <= 0 || H <= 0 || W <= 0 || Hp < H || Wp < W || C <= 0 || C % 8 != 0)
    return cudaErrorInvalidValue;
  const int rows = B * H * W;
  layernorm_tail_kernel<<<(rows + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(sc), static_cast<const bf16*>(att),
      static_cast<const float*>(gamma), static_cast<const float*>(beta), static_cast<float*>(xs),
      static_cast<bf16*>(y), rows, H, W, Hp, Wp, C, eps);
  return cudaGetLastError();
}

}  // extern "C"
