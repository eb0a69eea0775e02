// Shared helpers for the port's hand-written Hopper kernels.
//
// The mma.sync m16n8k16 fragment layouts below are those of the wgmma
// accumulators and register operands of hopper.cuh's kernels.  Host
// entry points are plain C functions (loaded with ctypes); each launches on
// the caller's stream and returns cudaGetLastError() so the Python wrapper
// can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace samrs {

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) {
  return (x + a - 1) / a * a;
}

// 16-byte copy global -> shared that completes asynchronously; with
// pred == false the destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint4 load16(const bf16* p) {
  return *reinterpret_cast<const uint4*>(p);
}

__device__ __forceinline__ void store16(bf16* p, uint4 v) { *reinterpret_cast<uint4*>(p) = v; }

// mma.sync m16n8k16 (bf16 in, fp32 accumulate) fragment layout, with
// g = lane / 4 and t = lane % 4:
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..2t+9], a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..2t+9][g]
//   C (16x8):             c0, c1 = C[g][2t..2t+1], c2, c3 = C[g+8][2t..2t+1]
// ldmatrix.x4 gives lane L row L/4, columns 2(L%4)..+1 of each addressed 8x8
// matrix.

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices; lane L supplies the row address of matrix L / 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(static_cast<int>(0xff800000u)); }

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

// Exact erf GELU, as torch.nn.GELU() and the JAX oracle compute it.
__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

}  // namespace samrs
