// K7: full-resolution mask postprocess.  Bilinear resize of each low-res mask
// (g -> img_size, crop to the resized input, -> original size, composed into
// one banded map per axis), threshold, hi/lo stability counts, tight box and
// np.packbits-order bit rows, without the full-resolution logits ever
// reaching device memory.
//
// Replaces samrs_tpu/kernels/amg_post.py::amg_postprocess.  Per 32-mask chunk
// to 800x800 it reads 8.4 MB of fp32 logits and writes 2.6 MB of bits, so it
// is bound by device-memory bytes (~3.3 us on an H100) and in practice by
// launch overhead.  The TPU kernel spent two dense "hat" matmuls and a 0/1
// pack matmul on its matrix unit; here each output pixel is a short banded
// sum (at most 4 taps per axis after composition, kept as a start index and
// 4 weights per output row and column, zero-weighted past the band).  Warp w
// of a block owns output row r of mask m: it resamples the 4 input rows of
// r's band into a row of g values in shared memory, then walks the output
// columns 32 at a time; a ballot gives the 32 threshold bits (4 packed bytes,
// MSB first) and the counts, and per-warp box extremes go to device memory
// with atomicMin/atomicMax at the end.  fp32 on the CUDA cores throughout (the
// TPU kernel ran its matmuls at Precision.HIGHEST).
#include <climits>

#include "common.cuh"

namespace samrs {
namespace {

constexpr int WARPS = 8;
constexpr int TAPS = 4;  // band width per axis; weights past the band are 0

// stats (M, 6) int32 = [hi, lo, xmin, ymin, xmax, ymax], preset by the caller
// to [0, 0, INT_MAX, INT_MAX, -1, -1].
__global__ void __launch_bounds__(WARPS * 32)
amg_post_kernel(const float* __restrict__ low, const int* __restrict__ y0,
                const float* __restrict__ wy, const int* __restrict__ x0,
                const float* __restrict__ wx, unsigned char* __restrict__ packed,
                int* __restrict__ stats, int g, int Ho, int Wo, float mt, float off) {
  extern __shared__ float rows[];  // WARPS x g
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m = blockIdx.x, r = blockIdx.y * WARPS + warp;
  if (r >= Ho) return;
  float* row = rows + warp * g;
  const float* L = low + (size_t)m * g * g + (size_t)y0[r] * g;
  float w[TAPS];
#pragma unroll
  for (int a = 0; a < TAPS; ++a) w[a] = wy[r * TAPS + a];
  for (int j = lane; j < g; j += 32) {
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < TAPS; ++a) acc += w[a] * L[(size_t)a * g + j];
    row[j] = acc;
  }
  __syncwarp();

  const int Wp = (Wo + 7) / 8;
  unsigned char* prow = packed + ((size_t)m * Ho + r) * Wp;
  int hi = 0, lo = 0, xmin = INT_MAX, xmax = -1;
  for (int c0 = 0; c0 < Wo; c0 += 32) {
    const int c = c0 + lane;
    float v = 0.f;
    if (c < Wo) {
      const float* row_c = row + x0[c];
#pragma unroll
      for (int b = 0; b < TAPS; ++b) v += wx[c * TAPS + b] * row_c[b];
    }
    const bool in = c < Wo;
    const unsigned on = __ballot_sync(0xffffffffu, in && v > mt);
    hi += __popc(__ballot_sync(0xffffffffu, in && v > mt + off));
    lo += __popc(__ballot_sync(0xffffffffu, in && v > mt - off));
    if (on) {
      xmin = min(xmin, c0 + __ffs(on) - 1);
      xmax = max(xmax, c0 + 31 - __clz(on));
    }
    const unsigned rev = __brev(on);  // bit 31 = column c0, as np.packbits' MSB
    const int byte = c0 / 8 + lane;
    if (lane < 4 && byte < Wp) prow[byte] = static_cast<unsigned char>(rev >> (24 - 8 * lane));
  }
  if (lane == 0) {
    int* st = stats + m * 6;
    if (hi) atomicAdd(st, hi);
    if (lo) atomicAdd(st + 1, lo);
    if (xmax >= 0) {
      atomicMin(st + 2, xmin);
      atomicMin(st + 3, r);
      atomicMax(st + 4, xmax);
      atomicMax(st + 5, r);
    }
  }
}

}  // namespace
}  // namespace samrs

extern "C" {

// K7: low (M, g, g) fp32; per output row r: y0[r] and wy[r, 0..4) (input
// rows y0[r]..y0[r]+3 with those weights), per output column c: x0[c] and
// wx[c, 0..4); every band lies inside [0, g).  Writes packed (M, Ho, ceil(Wo/8)) uint8
// and accumulates stats (M, 6) int32 (see amg_post_kernel).
int samrs_amg_post(const void* low, const void* y0, const void* wy, const void* x0,
                   const void* wx, void* packed, void* stats, int M, int g, int Ho, int Wo,
                   float mt, float off, void* stream) {
  using namespace samrs;
  if (M <= 0 || g < TAPS || Ho <= 0 || Wo <= 0)
    return cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * g * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  amg_post_kernel<<<dim3(M, (Ho + WARPS - 1) / WARPS), WARPS * 32, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(low), static_cast<const int*>(y0), static_cast<const float*>(wy),
      static_cast<const int*>(x0), static_cast<const float*>(wx),
      static_cast<unsigned char*>(packed), static_cast<int*>(stats), g, Ho, Wo, mt, off);
  return cudaGetLastError();
}

}  // extern "C"
