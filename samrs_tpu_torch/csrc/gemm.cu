// Dense layers of the encoder kernels K1 and K3: a bf16 GEMM with fused
// bias / exact-GELU epilogues and bf16 output, or with the encoder's fp32
// residual stream added and fp32 output, and the fp32-statistics LayerNorm
// of the fp32 stream that opens the MLP sublayer.
//
// Replaces the matrix products inside the TPU kernels
//   samrs_tpu/kernels/fused_mlp.py::_ln_kernel (LN + lin1 + gelu + lin2 + residual)
//   samrs_tpu/kernels/fused_window_layer.py::_kernel (its qkv and proj matmuls)
// Bound on the H100: tensor-core throughput (ViT-H: 2*T*C*4C flops per
// linear against T*C bf16 bytes, far above the ~295 flop/byte ridge).  The
// design feeds mma.sync from a 128x128x64 block tile with a three-stage
// cp.async ring (two tiles in flight while one multiplies), and applies
// every elementwise step in the epilogue so each activation makes one trip
// through device memory.  Measured on an H100 80GB HBM3 at a 700 W power
// limit: ~220 TFLOP/s at the ViT-H MLP shapes against ~400 for cuBLAS
// (wgmma), which is where a later wgmma/TMA version starts.  The MLP hidden activation (T x 4C bf16) still goes
// through device memory; keeping it on chip is later work.
#include "common.cuh"

namespace samrs {
namespace {

// Block tile BM x BN x BK, warp tile WM x WN, STAGES-deep cp.async ring.
template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct GemmCfg {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int WARPS_N = BN / WN;
  static constexpr int THREADS = 32 * (BM / WM) * WARPS_N;
  static constexpr int LDT = BK + 8;  // smem row stride (bf16): conflict-free fragment loads
  static constexpr int A_ELEMS = BM * LDT, STAGE_ELEMS = (BM + BN) * LDT;
  static constexpr int SMEM = STAGES * STAGE_ELEMS * (int)sizeof(bf16);
};

// Issues the cp.async loads of the A and B tiles at column k0 into `stage`.
template <class G>
__device__ __forceinline__ void load_tiles(bf16* stage, const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int M, int N, int K,
                                           int m0, int n0, int k0) {
  constexpr int CPR = G::BK / 8;  // 16-byte chunks per tile row
  for (int c = threadIdx.x; c < (G::BM + G::BN) * CPR; c += G::THREADS) {
    const int row = c / CPR, col = (c % CPR) * 8;
    if (row < G::BM) {
      const int gm = m0 + row;
      cp_async16(stage + row * G::LDT + col, A + (size_t)(gm < M ? gm : 0) * K + k0 + col, gm < M);
    } else {
      const int gn = n0 + row - G::BM;
      cp_async16(stage + row * G::LDT + col, B + (size_t)(gn < N ? gn : 0) * K + k0 + col, gn < N);
    }
  }
}

// C[M,N] = A[M,K] . B[N,K]^T (+ bias[N]) (-> gelu) (+ residual[M,N]).
// A, B bf16 row-major; bias fp32; C bf16 (OutT = bf16, no residual) or fp32
// with an fp32 residual.  The epilogue adds in fp32 and rounds once.
// Requires K % BK == 0 and
// N % 8 == 0 (checked by the host entry); ragged M and N tiles are masked.
// Each warp multiplies a WM x WN tile with ldmatrix + mma.sync fragments
// and applies the epilogue straight from its accumulator registers.
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

template <class G, class OutT>
__global__ void __launch_bounds__(G::THREADS)
gemm_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                 const float* __restrict__ bias, const float* __restrict__ residual,
                 OutT* __restrict__ C, int M, int N, int K, int gelu) {
  constexpr int FM = G::WM / 16, FN = G::WN / 8;  // m16 rows x n8 columns per warp
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / G::WARPS_N, wn = warp % G::WARPS_N;
  const int m0 = blockIdx.y * G::BM, n0 = blockIdx.x * G::BN;

  float acc[FM][FN][4];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int KT = K / G::BK;
#pragma unroll
  for (int st = 0; st < G::STAGES - 1; ++st) {
    if (st < KT) load_tiles<G>(smem + st * G::STAGE_ELEMS, A, B, M, N, K, m0, n0, st * G::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<G::STAGES - 2>();
    __syncthreads();
    const int pf = kt + G::STAGES - 1;
    if (pf < KT)
      load_tiles<G>(smem + (pf % G::STAGES) * G::STAGE_ELEMS, A, B, M, N, K, m0, n0, pf * G::BK);
    cp_async_commit();
    const bf16* As = smem + (kt % G::STAGES) * G::STAGE_ELEMS + (wm * G::WM) * G::LDT;
    const bf16* Bs = smem + (kt % G::STAGES) * G::STAGE_ELEMS + G::A_ELEMS + (wn * G::WN) * G::LDT;
#pragma unroll
    for (int kk = 0; kk < G::BK; kk += 16) {
      uint32_t a[FM][4], b[FN / 2][4];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        ldmatrix_x4(a[i], As + (i * 16 + (lane & 15)) * G::LDT + kk + ((lane >> 4) << 3));
#pragma unroll
      for (int jp = 0; jp < FN / 2; ++jp)
        ldmatrix_x4(b[jp], Bs + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * G::LDT + kk +
                               (((lane >> 3) & 1) << 3));
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int jp = 0; jp < FN / 2; ++jp) {
          mma_16816(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
          mma_16816(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
        }
    }
  }

  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < FM; ++i) {
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      const int gn = n0 + wn * G::WN + j * 8 + 2 * t;
      if (gn >= N) continue;
      const float b0 = bias ? bias[gn] : 0.f, b1 = bias ? bias[gn + 1] : 0.f;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int gm = m0 + wm * G::WM + i * 16 + g + 8 * half;
        if (gm >= M) continue;
        float v0 = acc[i][j][2 * half] + b0, v1 = acc[i][j][2 * half + 1] + b1;
        if (gelu) {
          v0 = gelu_erf(v0);
          v1 = gelu_erf(v1);
        }
        if (residual) {
          const float2 rv = *reinterpret_cast<const float2*>(residual + (size_t)gm * N + gn);
          v0 += rv.x;
          v1 += rv.y;
        }
        store2(C + (size_t)gm * N + gn, v0, v1);
      }
    }
  }
}

template <class G, class OutT>
int launch_gemm(const void* A, const void* B, const void* bias, const void* residual, void* C,
                int M, int N, int K, int gelu, cudaStream_t stream) {
  if (K % G::BK != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(gemm_bf16_kernel<G, OutT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + G::BN - 1) / G::BN, (M + G::BM - 1) / G::BM);
  gemm_bf16_kernel<G, OutT><<<grid, G::THREADS, G::SMEM, stream>>>(
      static_cast<const bf16*>(A), static_cast<const bf16*>(B), static_cast<const float*>(bias),
      static_cast<const float*>(residual), static_cast<OutT*>(C), M, N, K, gelu);
  return cudaGetLastError();
}

using GemmMain = GemmCfg<128, 128, 64, 64, 32, 3>;  // 110 KB of shared memory

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
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (residual) return launch_gemm<GemmMain, float>(A, B, bias, residual, C, M, N, K, gelu, st);
  return launch_gemm<GemmMain, bf16>(A, B, bias, nullptr, C, M, N, K, gelu, st);
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

}  // extern "C"
