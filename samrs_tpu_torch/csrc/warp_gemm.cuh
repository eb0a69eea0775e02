// Shared-memory GEMM pieces of the decoder kernel K4 (and the warp
// reductions K5 and K6 use): a warp multiplies a 16-row bf16 tile held in shared
// memory by a bf16 weight matrix held in shared memory, with fp32
// accumulators left in registers in the mma.sync C-fragment layout (see
// common.cuh) for the caller's epilogue.
#pragma once

#include "common.cuh"

namespace samrs {

// Asynchronously copies a row-major (rows x cols) bf16 matrix into shared
// memory with row stride `ld` elements.  cols % 8 == 0; every thread of the
// block takes part; the caller commits and waits.
template <int NTHREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, int ld, const bf16* __restrict__ src,
                                                int rows, int cols) {
  const int cpr = cols / 8;
  for (int c = threadIdx.x; c < rows * cpr; c += NTHREADS) {
    const int r = c / cpr, k = (c % cpr) * 8;
    cp_async16(dst + r * ld + k, src + (size_t)r * cols + k, true);
  }
}

// acc[j] (+)= A[16 x K] . W[8*NT x K]^T restricted to output columns
// 8j..8j+7.  `a` points at the tile's first row (row stride lda), `w` at the
// first weight row (row stride ldw); both in shared memory, both strides
// multiples of 8 elements.  Thread (g = lane/4, t = lane%4) ends up holding
// C[g][8j+2t..+1] in acc[j][0..1] and C[g+8][8j+2t..+1] in acc[j][2..3].
template <int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&acc)[NT][4], const bf16* a, int lda,
                                          const bf16* w, int ldw) {
  static_assert(NT % 2 == 0 && K % 16 == 0, "warp_gemm tile");
  const int lane = threadIdx.x & 31;
#pragma unroll 4
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    ldmatrix_x4(af, a + (lane & 15) * lda + kk + ((lane >> 4) << 3));
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      uint32_t bfr[4];
      ldmatrix_x4(bfr, w + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldw + kk +
                           (((lane >> 3) & 1) << 3));
      mma_16816(acc[2 * jp], af, bfr[0], bfr[1]);
      mma_16816(acc[2 * jp + 1], af, bfr[2], bfr[3]);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum over the four lanes of a quad (the lanes sharing one C-fragment row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

}  // namespace samrs
