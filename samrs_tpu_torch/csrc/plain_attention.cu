// K10: plain softmax attention in fp32 on the CUDA cores (no bias).
//
//   out[bh] = softmax((q[bh] * scale) . k[bh]^T) . v[bh]
//
// q, k, v, out (BH, N, D) fp32, contiguous; D in {64, 80}; any N.
//
// Replaces samrs_tpu/kernels/flash_attention.py::_plain_fwd_pallas (its
// pallas_call, body _flash_kernel), the forward of flash_attention_plain that
// the seg ViTs' full-attention blocks call.  The TPU kernel keeps all N keys
// of a head in VMEM and sums the softmax rows with a ones lane appended to V
// (a matrix-unit trick); neither carries over.  Here one block of 256 threads
// takes 64 queries of one (batch, head) and streams the keys and values
// through shared memory in tiles of 64, with an online softmax: per query
// row, the running max and row sum live in registers, the probabilities of a
// tile are summed in registers, and the output accumulator is rescaled when
// the max moves.  The N x N logits never reach device memory.  Keys past N
// get -inf; query rows past N are computed on zeros and not stored.
//
// Thread (ty, tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3, key
// columns tx + 16 j of each tile (j < 4) and output columns tx + 16 c
// (c < D / 16).  Operands sit transposed in shared memory, so a thread reads
// its four rows as one 16-byte load that its half-warp shares, and the
// strided columns keep the 16 lanes of a half-warp on distinct banks.
//
// Bound on the H100: fp32 operations, 4 N^2 D per head (at vit_b 512^2,
// batch 8: BH 96, N 1024, D 64, 25.8 GFLOP -> 0.385 ms at 67 TFLOP/s); the
// bytes (4 N D floats per head) are a tenth of that.  This first version has
// no double buffering and no tensor cores: the products are exact fp32, as
// the seg path (fp32, TF32 off) needs.
#include "common.cuh"

namespace samrs {
namespace {

constexpr int PA_BQ = 64;         // queries per block
constexpr int PA_BK = 64;         // keys per tile
constexpr int PA_THREADS = 256;   // 16 x 16
constexpr int PA_LD = PA_BQ + 4;  // row stride of the transposed tiles (16-byte rows)

template <int D>
struct PaSmem {
  float qT[D][PA_LD];        // q * scale, transposed: qT[d][row]
  float kT[D][PA_LD];        // kT[d][key]
  float v[PA_BK][D];         // v[key][d]
  float pT[PA_BK][PA_LD];    // this tile's probabilities, transposed: pT[key][row]
};

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(PA_THREADS) plain_attention_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int N, float scale) {
  constexpr int DC = D / 16;  // output columns per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PaSmem<D>& sm = *reinterpret_cast<PaSmem<D>*>(smem_raw);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * PA_BQ;
  const size_t base = (size_t)blockIdx.y * N * D;

  for (int i = tid; i < PA_BQ * D; i += PA_THREADS) {
    const int r = i / D, d = i % D;
    sm.qT[d][r] = (q0 + r < N) ? q[base + (size_t)(q0 + r) * D + d] * scale : 0.f;
  }

  float m[4], l[4], o[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) o[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < N; k0 += PA_BK) {
    __syncthreads();  // the previous tile's kT, v and pT are no longer read
    for (int i = tid; i < PA_BK * D; i += PA_THREADS) {
      const int c = i / D, d = i % D;
      const bool ok = k0 + c < N;
      const size_t g = base + (size_t)(k0 + c) * D + d;
      sm.kT[d][c] = ok ? k[g] : 0.f;
      sm.v[c][d] = ok ? v[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&sm.qT[d][ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = sm.kT[d][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = fmaf(av[i], b, s[i][j]);
      }
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (k0 + tx + 16 * j >= N) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i][j] = neg_inf();
      }
    }

    // online softmax; every tile holds at least one valid key, so m_new is finite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        ps += s[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&sm.pT[tx + 16 * j][ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    const int kn = min(PA_BK, N - k0);
#pragma unroll 4
    for (int kk = 0; kk < kn; ++kk) {
      const float4 p = *reinterpret_cast<const float4*>(&sm.pT[kk][ty * 4]);
      const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float b = sm.v[kk][tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pv[i], b, o[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= N) continue;
    const float inv = 1.f / l[i];
    float* orow = out + base + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = o[i][c] * inv;
  }
}

template <int D>
int launch_plain_attention(const void* q, const void* k, const void* v, void* out, int BH, int N,
                           float scale, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(PaSmem<D>);
  cudaError_t err = cudaFuncSetAttribute(plain_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + PA_BQ - 1) / PA_BQ, BH);
  plain_attention_kernel<D><<<grid, PA_THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), N, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace samrs

extern "C" {

// q, k, v, out (BH, N, head_dim) fp32, contiguous; head_dim 64 or 80.
int samrs_plain_attention(const void* q, const void* k, const void* v, void* out, int BH, int N,
                          int head_dim, float scale, void* stream) {
  using namespace samrs;
  if (BH <= 0 || BH > 65535 || N <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_plain_attention<64>(q, k, v, out, BH, N, scale, st);
  if (head_dim == 80) return launch_plain_attention<80>(q, k, v, out, BH, N, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
