// K11: the transformer MLP in one kernel, fp32 on the CUDA cores.
//
//   out = gelu_erf(x . W1^T + b1) . W2^T + b2
//
// x (T, C), out (T, C); W1 (M, C), b1 (M), W2 (C, M), b2 (C) in nn.Linear's
// layout; all fp32 and contiguous.  C in {768, 1024, 1280} (the vit_b / l / h
// widths) or {64, 128, 256, 512} (InternImage-T's four levels), M a multiple
// of 128, any T.
//
// Replaces samrs_tpu/kernels/fused_mlp.py::_fused_pallas (its pallas_call,
// body _kernel), the forward of fused_mlp that every seg-ViT MLP block calls.
// As on the TPU, the hidden activations never reach device memory and GELU
// is evaluated once per element; the TPU's sequential hidden-chunk grid axis
// becomes a loop inside the block.  One block of 256 threads owns 32 tokens
// and the whole (32, C) output tile, which stays in registers (C / 8 floats
// a thread) across the loop over hidden chunks of 128:
//
//   h = x_tile . W1[chunk]^T + b1[chunk]       (x and W1 staged in 32-wide
//                                               slices of C through shared memory)
//   g = gelu_erf(h)                             (erff: the exact GELU of the
//                                               oracle and F.gelu; the TPU kernel's
//                                               Abramowitz-Stegun erf is a Mosaic
//                                               workaround and is not copied)
//   acc += g . W2[:, chunk]^T                   (g kept in shared memory, W2
//                                               staged 16 hidden units at a time)
//
// and stores acc + b2 once.  Warp w owns tokens 4w .. 4w + 3; lane l owns
// hidden units l + 32 j of a chunk and output channels l + 32 j, so operand
// tiles are read as one 16-byte load per warp (x, g) and 32 consecutive words
// (W1, W2).  Bound on the H100: fp32 operations, 4 T C M (at vit_b 512^2,
// batch 8: T 8192, C 768, M 3072, 77.3 GFLOP -> 1.15 ms at 67 TFLOP/s); W1
// and W2 are read once per block, from L2 after the first.  No double
// buffering and no tensor cores in this first version.
#include "common.cuh"

namespace samrs {
namespace {

constexpr int FM_BT = 32;        // tokens per block
constexpr int FM_THREADS = 256;  // 8 warps, 4 tokens each
constexpr int FM_MK = 128;       // hidden units per chunk
constexpr int FM_KC = 32;        // input channels per x / W1 stage
constexpr int FM_MC = 16;        // hidden units per W2 stage
constexpr int FM_LDT = FM_BT + 4;  // row stride of the token-minor tiles (16-byte rows)

__host__ __device__ constexpr int fm_smem_floats(int C) {
  return FM_KC * FM_LDT            // xs[c][t]
         + FM_KC * (FM_MK + 1)     // w1s[c][m]
         + FM_MK * FM_LDT          // gT[m][t]
         + FM_MC * (C + 1);        // w2s[m][c]
}

template <int C>
__global__ void __launch_bounds__(FM_THREADS, 1) fused_mlp_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ out, int T,
    int M) {
  constexpr int NC = C / 32;  // output channels per thread
  extern __shared__ __align__(16) float fm_smem[];
  float* xs = fm_smem;                     // [FM_KC][FM_LDT]
  float* w1s = xs + FM_KC * FM_LDT;        // [FM_KC][FM_MK + 1]
  float* gT = w1s + FM_KC * (FM_MK + 1);   // [FM_MK][FM_LDT]
  float* w2s = gT + FM_MK * FM_LDT;        // [FM_MC][C + 1]
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int t0 = blockIdx.x * FM_BT;

  float acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;

  for (int m0 = 0; m0 < M; m0 += FM_MK) {
    float h[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[i][j] = 0.f;

    for (int c0 = 0; c0 < C; c0 += FM_KC) {
      __syncthreads();  // the previous slice (and chunk's gT / w2s) is no longer read
      {  // x slice: 32 tokens x 32 channels, one float4 per thread
        const int t = tid / 8, q = tid % 8;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t0 + t < T) val = *reinterpret_cast<const float4*>(x + (size_t)(t0 + t) * C + c0 + 4 * q);
        xs[(4 * q + 0) * FM_LDT + t] = val.x;
        xs[(4 * q + 1) * FM_LDT + t] = val.y;
        xs[(4 * q + 2) * FM_LDT + t] = val.z;
        xs[(4 * q + 3) * FM_LDT + t] = val.w;
      }
      for (int i = tid; i < FM_MK * FM_KC / 4; i += FM_THREADS) {  // W1 slice: 128 x 32
        const int m = i / 8, q = i % 8;
        const float4 val = *reinterpret_cast<const float4*>(w1 + (size_t)(m0 + m) * C + c0 + 4 * q);
        w1s[(4 * q + 0) * (FM_MK + 1) + m] = val.x;
        w1s[(4 * q + 1) * (FM_MK + 1) + m] = val.y;
        w1s[(4 * q + 2) * (FM_MK + 1) + m] = val.z;
        w1s[(4 * q + 3) * (FM_MK + 1) + m] = val.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int cc = 0; cc < FM_KC; ++cc) {
        const float4 a = *reinterpret_cast<const float4*>(xs + cc * FM_LDT + warp * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = w1s[cc * (FM_MK + 1) + lane + 32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) h[i][j] = fmaf(av[i], b, h[i][j]);
        }
      }
    }

    // bias + GELU once per element; g goes to shared memory, token-minor
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float bias = b1[m0 + lane + 32 * j];
      float4 g;
      g.x = gelu_erf(h[0][j] + bias);
      g.y = gelu_erf(h[1][j] + bias);
      g.z = gelu_erf(h[2][j] + bias);
      g.w = gelu_erf(h[3][j] + bias);
      *reinterpret_cast<float4*>(gT + (lane + 32 * j) * FM_LDT + warp * 4) = g;
    }

    for (int ms = 0; ms < FM_MK; ms += FM_MC) {
      __syncthreads();  // gT written; the previous W2 stage is no longer read
      for (int i = tid; i < C * FM_MC / 4; i += FM_THREADS) {  // W2 stage: C x 16
        const int c = i / (FM_MC / 4), q = i % (FM_MC / 4);
        const float4 val = *reinterpret_cast<const float4*>(w2 + (size_t)c * M + m0 + ms + 4 * q);
        w2s[(4 * q + 0) * (C + 1) + c] = val.x;
        w2s[(4 * q + 1) * (C + 1) + c] = val.y;
        w2s[(4 * q + 2) * (C + 1) + c] = val.z;
        w2s[(4 * q + 3) * (C + 1) + c] = val.w;
      }
      __syncthreads();
#pragma unroll 2
      for (int mm = 0; mm < FM_MC; ++mm) {
        const float4 a = *reinterpret_cast<const float4*>(gT + (ms + mm) * FM_LDT + warp * 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float* brow = w2s + mm * (C + 1) + lane;
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          const float b = brow[32 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(av[i], b, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + warp * 4 + i;
    if (t >= T) continue;
    float* orow = out + (size_t)t * C;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[lane + 32 * j] = acc[i][j] + b2[lane + 32 * j];
  }
}

template <int C>
int launch_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                     void* out, int T, int M, cudaStream_t stream) {
  constexpr int smem = fm_smem_floats(C) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_mlp_kernel<C><<<(T + FM_BT - 1) / FM_BT, FM_THREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), static_cast<float*>(out), T, M);
  return cudaGetLastError();
}

}  // namespace
}  // namespace samrs

extern "C" {

// x (T, C), w1 (M, C), b1 (M), w2 (C, M), b2 (C) -> out (T, C); fp32, contiguous.
int samrs_fused_mlp(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                    void* out, int T, int C, int M, void* stream) {
  using namespace samrs;
  if (T <= 0 || M <= 0 || M % FM_MK != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 64) return launch_fused_mlp<64>(x, w1, b1, w2, b2, out, T, M, st);
  if (C == 128) return launch_fused_mlp<128>(x, w1, b1, w2, b2, out, T, M, st);
  if (C == 256) return launch_fused_mlp<256>(x, w1, b1, w2, b2, out, T, M, st);
  if (C == 512) return launch_fused_mlp<512>(x, w1, b1, w2, b2, out, T, M, st);
  if (C == 768) return launch_fused_mlp<768>(x, w1, b1, w2, b2, out, T, M, st);
  if (C == 1024) return launch_fused_mlp<1024>(x, w1, b1, w2, b2, out, T, M, st);
  if (C == 1280) return launch_fused_mlp<1280>(x, w1, b1, w2, b2, out, T, M, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
