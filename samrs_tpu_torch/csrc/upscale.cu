// K6: SAM mask decoder tail.  Two stride-2 2x2 transposed convolutions with
// LayerNorm2d and exact GELUs between, then the hypernetwork dot of each
// requested mask token, straight to the (B, M, 4h, 4w) fp32 mask logits.
//
// Replaces samrs_tpu/kernels/fused_upscale.py::_fused_pallas.  Per source
// pixel the chain is 2 * (256*256 + 4*64*128 + 16*32*M) flops against 512
// bytes of bf16 input and 64*M bytes of output: at bucket 64 about 52 GFLOP
// and 151 MB, so tensor cores and device memory are about level.  Nothing but
// the input tile and the output logits touches device memory.
//
// A stride-2 2x2 transposed convolution writes each input pixel to its own
// 2x2 output patch, so both convolutions are plain products per source pixel
// (PyTorch's ConvTranspose2d layout (in, out, kh, kw): out[2h+i, 2w+j, d] =
// sum_c x[h, w, c] W[c, d, i, j] + b[d], no kernel flip).  A persistent block
// keeps both weights in shared memory (W1 as 4 taps x 64 channels = 256 rows,
// W2 as 4 sub-taps x 32 channels = 128 rows) and walks 32-pixel tiles, with
// the next tile's load in flight while it computes the current one.  Warp w
// owns 16 pixels and conv1 tap s = w / 2: its mma.sync product gives the 64
// channels of (pixel, tap) across a quad of lanes, where LayerNorm and GELU
// run on the registers; the bf16 result is the warp's private A operand of the
// second product, whose 4 sub-taps x 32 channels are dotted in fp32 with each
// token's fp32 hypernetwork vector after GELU and summed across the quad (no
// bf16 rounding just before the mask threshold: no tensor-core product
// follows).  Pixel order of the output is (b, m, 4h + 2i + k, 4w + 2j + l).
#include "warp_gemm.cuh"

namespace samrs {
namespace {

constexpr int C = 256, C1 = 64, C2 = 32;
constexpr int TILE = 32;  // source pixels per tile
constexpr int THREADS = 256;
constexpr int MAX_M = 4;
constexpr int LDW1 = C + 8, LDW2 = C1 + 8, LDA = C + 8, LDG = C1 + 8;
constexpr int W1_BYTES = 4 * C1 * LDW1 * 2;   // 256 rows
constexpr int W2_BYTES = 4 * C2 * LDW2 * 2;   // 128 rows
constexpr int A_BYTES = TILE * LDA * 2;
constexpr int G_BYTES = 4 * TILE * LDG * 2;   // (tap, pixel) rows
constexpr int P_BYTES = (3 * C1 + C2) * 4;
constexpr int SMEM = W1_BYTES + W2_BYTES + 2 * A_BYTES + G_BYTES + P_BYTES;
static_assert(W1_BYTES % 128 == 0 && W2_BYTES % 128 == 0 && A_BYTES % 128 == 0 &&
              G_BYTES % 128 == 0, "smem carve");
static_assert(SMEM <= 232448, "K6 shared memory");

__global__ void __launch_bounds__(THREADS, 1)
upscale_hyper_kernel(const bf16* __restrict__ src, const bf16* __restrict__ W1,
                     const float* __restrict__ b1, const float* __restrict__ lnw,
                     const float* __restrict__ lnb, const bf16* __restrict__ W2,
                     const float* __restrict__ b2, const float* __restrict__ hyper,
                     float* __restrict__ out, int B, int h, int w, int M, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* W1s = reinterpret_cast<bf16*>(smem);
  bf16* W2s = reinterpret_cast<bf16*>(smem + W1_BYTES);
  bf16* As = reinterpret_cast<bf16*>(smem + W1_BYTES + W2_BYTES);  // two tile buffers
  bf16* Gs = reinterpret_cast<bf16*>(smem + W1_BYTES + W2_BYTES + 2 * A_BYTES);
  float* pb1 = reinterpret_cast<float*>(smem + W1_BYTES + W2_BYTES + 2 * A_BYTES + G_BYTES);
  float* plw = pb1 + C1;
  float* plb = plw + C1;
  float* pb2 = plb + C1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int half = warp & 1, s = warp >> 1;  // pixels 16*half.., conv1 tap s = 2i + j
  const int P = h * w, tiles_per_b = P / TILE, ntiles = B * tiles_per_b;

  load_rows_async<THREADS>(W1s, LDW1, W1, 4 * C1, C);
  load_rows_async<THREADS>(W2s, LDW2, W2, 4 * C2, C1);
  for (int i = tid; i < C1; i += THREADS) pb1[i] = b1[i], plw[i] = lnw[i], plb[i] = lnb[i];
  for (int i = tid; i < C2; i += THREADS) pb2[i] = b2[i];
  cp_async_commit();
  if (blockIdx.x < ntiles) {
    const int tb = blockIdx.x / tiles_per_b, tp = (blockIdx.x % tiles_per_b) * TILE;
    load_rows_async<THREADS>(As, LDA, src + ((size_t)tb * P + tp) * C, TILE, C);
  }
  cp_async_commit();

  int buf = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, buf ^= 1) {
    const int next = tile + gridDim.x;
    if (next < ntiles) {
      const int nb = next / tiles_per_b, np = (next % tiles_per_b) * TILE;
      load_rows_async<THREADS>(As + (buf ^ 1) * TILE * LDA, LDA, src + ((size_t)nb * P + np) * C,
                               TILE, C);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int b = tile / tiles_per_b, p0 = (tile % tiles_per_b) * TILE;
    bf16* G = Gs + (s * TILE + half * 16) * LDG;  // this warp's 16 (tap s, pixel) rows

    // conv1 tap s: 16 pixels x 64 channels, then LayerNorm2d + GELU on the registers
    {
      float acc[8][4];
      zero_acc(acc);
      warp_gemm<8, C>(acc, As + buf * TILE * LDA + half * 16 * LDA, LDA, W1s + s * C1 * LDW1, LDW1);
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        float v[16], sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = j * 8 + 2 * t;
          v[2 * j] = acc[j][2 * rs] + pb1[d];
          v[2 * j + 1] = acc[j][2 * rs + 1] + pb1[d + 1];
          sum += v[2 * j] + v[2 * j + 1];
        }
        const float mean = quad_sum(sum) * (1.f / C1);
        float sq = 0.f;
#pragma unroll
        for (int e = 0; e < 16; ++e) sq += (v[e] - mean) * (v[e] - mean);
        const float rstd = rsqrtf(quad_sum(sq) * (1.f / C1) + eps);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = j * 8 + 2 * t;
          const float y0 = gelu_erf((v[2 * j] - mean) * rstd * plw[d] + plb[d]);
          const float y1 = gelu_erf((v[2 * j + 1] - mean) * rstd * plw[d + 1] + plb[d + 1]);
          *reinterpret_cast<__nv_bfloat162*>(G + (g + 8 * rs) * LDG + d) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
    __syncwarp();

    // conv2: (pixel, tap s) x (4 sub-taps x 32 channels), GELU, hypernetwork dots
    float acc[16][4];
    zero_acc(acc);
    warp_gemm<16, C1>(acc, G, LDG, W2s, LDW2);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int e = (j & 3) * 8 + 2 * t;
      acc[j][0] = gelu_erf(acc[j][0] + pb2[e]);
      acc[j][1] = gelu_erf(acc[j][1] + pb2[e + 1]);
      acc[j][2] = gelu_erf(acc[j][2] + pb2[e]);
      acc[j][3] = gelu_erf(acc[j][3] + pb2[e + 1]);
    }
    const int ci = s >> 1, cj = s & 1, sk = t >> 1, sl = t & 1;  // lane t writes sub-tap t
    for (int m = 0; m < M; ++m) {
      const float* hy = hyper + ((size_t)b * M + m) * C2;
      float hv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        hv[2 * q] = hy[q * 8 + 2 * t];
        hv[2 * q + 1] = hy[q * 8 + 2 * t + 1];
      }
#pragma unroll
      for (int rs = 0; rs < 2; ++rs) {
        float part[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            a += acc[4 * u + q][2 * rs] * hv[2 * q] + acc[4 * u + q][2 * rs + 1] * hv[2 * q + 1];
          part[u] = quad_sum(a);
        }
        const float val = t == 0 ? part[0] : t == 1 ? part[1] : t == 2 ? part[2] : part[3];
        const int pix = p0 + half * 16 + g + 8 * rs, y = pix / w, x = pix % w;
        out[(((size_t)b * M + m) * 4 * h + 4 * y + 2 * ci + sk) * (4 * w) + 4 * x + 2 * cj + sl] = val;
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();
}

}  // namespace
}  // namespace samrs

extern "C" {

// K6: src (B, h, w, 256) bf16; W1 (256, 256) bf16, row (2i + j) * 64 + d,
// column c; b1, lnw, lnb (64) fp32; W2 (128, 64) bf16, row (2k + l) * 32 + e,
// column d; b2 (32) fp32; hyper (B, M, 32) fp32 -> out (B, M, 4h, 4w) fp32.
int samrs_upscale_hyper(const void* src, const void* W1, const void* b1, const void* lnw,
                        const void* lnb, const void* W2, const void* b2, const void* hyper,
                        void* out, int B, int h, int w, int M, float eps, void* stream) {
  using namespace samrs;
  if (B <= 0 || h <= 0 || w <= 0 || (h * w) % TILE != 0 || M < 1 || M > MAX_M)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(upscale_hyper_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
  if (err != cudaSuccess) return err;
  const int ntiles = B * (h * w / TILE);
  const int grid = ntiles < sms ? ntiles : sms;
  upscale_hyper_kernel<<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(W1), static_cast<const float*>(b1),
      static_cast<const float*>(lnw), static_cast<const float*>(lnb), static_cast<const bf16*>(W2),
      static_cast<const float*>(b2), static_cast<const float*>(hyper), static_cast<float*>(out), B,
      h, w, M, eps);
  return cudaGetLastError();
}

}  // extern "C"
