// K6: SAM mask decoder tail.  Two stride-2 2x2 transposed convolutions with
// LayerNorm2d and GELUs between, then the hypernetwork dot of each
// requested mask token, straight to the (B, M, 4h, 4w) fp32 mask logits.
//
// Replaces samrs_tpu/kernels/fused_upscale.py::_fused_pallas.  A stride-2
// 2x2 transposed convolution writes each input pixel to its own 2x2 output
// patch, so both convolutions are plain products per source pixel
// (PyTorch's ConvTranspose2d layout (in, out, kh, kw): out[2h+i, 2w+j, d] =
// sum_c x[h, w, c] W[c, d, i, j] + b[d], no kernel flip).  Per source pixel
// the chain is 2 * (256*256 + 4*64*128 + 16*32*M) flops on the tensor cores
// (about 52 GFLOP at bucket 64, 0.053 ms at 989 TFLOP/s) against 512 bytes of
// bf16 input and 64*M bytes of output (151 MB, 0.045 ms), and 768 GELUs on
// the CUDA cores (256 after conv1, 512 after conv2: 201 M at bucket 64).
// The GELUs, the LayerNorm and the dot are the larger share: a GELU over
// the TPU kernel's erf takes two special-function ops, and an SM does 16 of
// those a cycle, so 768 GELUs a pixel need ~96 cycles against ~48 of
// tensor-core time (201 M GELUs at bucket 64: 0.096 ms at 1.98 GHz).  The
// design overlaps the two and keeps every byte but the input tile and the
// logits out of device memory.
//
// One persistent block an SM of four warpgroups:
//   * W1 (256 x 256 bf16, 128 KB: rows (2i + j) * 64 + d) and W2 (128 x 64,
//     16 KB: rows (2k + l) * 32 + e) arrive once by TMA and stay resident;
//   * 64-pixel x 256-channel tiles of src (rows of (B*h*w, 256), four
//     64-channel boxes, 128-byte swizzle) arrive by TMA through a ring of two
//     stages;
//   * every warpgroup takes every tile, warpgroup 2i + j its conv1 tap
//     (i, j): conv1 as wgmma m64n64k16 from shared memory (16 k-steps), the
//     bias, a two-pass fp32 LayerNorm over the tap's 64 channels (quad
//     shuffles) and GELU on the accumulator registers, then the bf16 result
//     as conv2's register A operand (the m16n8k16 A fragments are the C
//     fragments' pairs: no shared-memory round trip), conv2 as wgmma
//     m64n128k16 over the 4 sub-taps x 32 channels, bias and GELU on the
//     registers, and the fp32 dot with each token's hypernetwork vector
//     (quad shuffles that leave lane t with sub-tap t);
//   * a warpgroup releases the tile after its conv1 product, and the last
//     warp through it issues the load of the tile two ahead into the stage,
//     so the next tile lands while the block finishes; one warpgroup's
//     CUDA-core work overlaps the others' products, and 16 warps (no
//     producer warp, which would leave 96 registers a thread instead of 128)
//     hide the latency of the GELUs' special-function ops;
//   * logits are staged per tile in shared memory as 16-byte runs (the four
//     columns 4x .. 4x+3 of one output row, two from each warpgroup of a
//     pair) and leave as coalesced 16-byte stores: a warp writes 512
//     contiguous bytes of an output row.
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int C = 256, C1 = 64, C2 = 32;
constexpr int TILE = 64;        // source pixels per tile (wgmma's M)
constexpr int MAX_M = 4;        // mask tokens a call takes
constexpr int CONSUMERS = 4;    // warpgroups; warpgroup 2i + j takes conv1 tap (i, j)
constexpr int THREADS = CONSUMERS * 128;  // no producer warp: 4 warps a scheduler, 128 registers
constexpr int STAGES = 2;
constexpr int W1_BYTES = 4 * C1 * C * 2;        // four boxes of 64 channels x 256 rows
constexpr int W2_BYTES = 4 * C2 * C1 * 2;       // one box of 64 channels x 128 rows
constexpr int SRC_BYTES = TILE * C * 2;         // four boxes of 64 channels x 64 pixels
constexpr int OUT_M_FLOATS = 2 * TILE * 4;      // a warpgroup pair's logits of one token: 2 rows x 4
constexpr int PAR_FLOATS = 3 * C1 + C2;

constexpr size_t smem_bytes(int M) {
  return 1024 + W1_BYTES + W2_BYTES + STAGES * SRC_BYTES + CONSUMERS / 2 * M * OUT_M_FLOATS * 4 +
         PAR_FLOATS * 4 + (1 + 2 * STAGES) * 8 + STAGES * 4;
}
static_assert(smem_bytes(MAX_M) <= 232448, "K6 shared memory");

// GELU over the TPU kernel's erf, Abramowitz-Stegun 7.1.26 (max abs error
// 1.5e-7; samrs_tpu/kernels/fused_mlp.py::_erf), with y = x / sqrt 2 and
// h = x / 2:
//   erf(y) = sign(y) (1 - t P(t) exp(-y^2)),  t = 1 / (1 + p |y|),
//   GELU(x) = h + |h| (1 - t P(t) exp(-2 h^2)).
// Two special-function ops (rcp.approx.ftz, ex2.approx.ftz: one MUFU
// instruction each, without the non-ftz forms' denormal fix-ups) and ten
// FMA-pipe ops, where erff takes about 25.
__device__ __forceinline__ float rcp_ftz(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
__device__ __forceinline__ float ex2_ftz(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}
// GELU(x) from h = x / 2, the bias and LayerNorm's affine folded in by the caller.
__device__ __forceinline__ float gelu_half(float h) {
  const float t = rcp_ftz(fmaf(2.f * 0.3275911f * 0.70710678118654752f, fabsf(h), 1.f));
  const float q = fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                           -0.284496736f),
                       0.254829592f);
  const float e = ex2_ftz(h * (h * (-2.f * 1.4426950408889634f)));  // exp(-x^2 / 2)
  return fmaf(fabsf(h), fmaf(-t * q, e, 1.f), h);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Given p[u] (u = 0..3) in each lane of a quad, returns in lane t the quad's
// sum of p[t]: three shuffles instead of a full sum per value.
__device__ __forceinline__ float quad_reduce_scatter(const float (&p)[4], int t) {
  const bool b0 = t & 1, b1 = t & 2;
  float k0 = b0 ? p[1] : p[0], k1 = b0 ? p[3] : p[2];  // kept: u = b0, b0 + 2
  const float s0 = b0 ? p[0] : p[1], s1 = b0 ? p[2] : p[3];
  k0 += __shfl_xor_sync(0xffffffffu, s0, 1);
  k1 += __shfl_xor_sync(0xffffffffu, s1, 1);
  const float k = b1 ? k1 : k0, s = b1 ? k0 : k1;  // kept: u = b0 + 2 * b1 = t
  return k + __shfl_xor_sync(0xffffffffu, s, 2);
}

// conv1 of tap `tap` (rows tap * 64 .. of W1) on the tile at A: 16 wgmma
// m64n64k16 from shared memory, committed as one group.
__device__ __forceinline__ void issue_conv1(float (&d1)[32], const unsigned char* A,
                                            const unsigned char* W1s, int tap) {
  fence_regs(d1);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C / 16; ++kk) {
    const uint64_t da = wgmma_desc(A + (kk / 4) * TILE * 128, kSwizzle128B, 16, 1024) + 2 * (kk % 4);
    const uint64_t db =
        wgmma_desc(W1s + (kk / 4) * 4 * C1 * 128 + tap * C1 * 128, kSwizzle128B, 16, 1024) +
        2 * (kk % 4);
    wgmma_ss_n64(d1, da, db, kk != 0);
  }
  wgmma_commit();
}

__global__ void __launch_bounds__(THREADS, 1)
upscale_wgmma_kernel(const __grid_constant__ CUtensorMap msrc,
                     const __grid_constant__ CUtensorMap mw1,
                     const __grid_constant__ CUtensorMap mw2, const float* __restrict__ b1,
                     const float* __restrict__ lnw, const float* __restrict__ lnb,
                     const float* __restrict__ b2, const float* __restrict__ hyper,
                     float* __restrict__ out, int h, int w, int M, int ntiles, float eps) {
  extern __shared__ unsigned char smem_raw[];
  // aligned by offsetting the shared array itself, so that the compiler keeps every pointer
  // below in the shared space (LDS / STS rather than generic loads and stores)
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* W1s = smem;
  unsigned char* W2s = W1s + W1_BYTES;
  unsigned char* Ss = W2s + W2_BYTES;
  float* Os = reinterpret_cast<float*>(Ss + STAGES * SRC_BYTES);  // per warpgroup [m][k][pixel][4]
  float* pb1 = Os + CONSUMERS / 2 * M * OUT_M_FLOATS;
  float* plw = pb1 + C1;
  float* plb = plw + C1;
  float* pb2 = plb + C1;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(pb2 + C2);
  uint64_t* full = wbar + 1;
  uint64_t* empty = full + STAGES;
  int* done = reinterpret_cast<int*>(empty + STAGES);  // warps through a stage's conv1

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles_per_b = h * w / TILE;
  // tile k of this block goes to stage k % STAGES; its load is issued by thread 0 for the
  // first STAGES tiles, then by the last warp through the conv1 of the tile before it in the
  // stage (a producer warp would put a fifth warp on one of the SM's four register files)
  auto load_tile = [&](int k) {
    const int tile = blockIdx.x + k * gridDim.x, s = k % STAGES;
    mbar_expect_tx(&full[s], SRC_BYTES);
    for (int kc = 0; kc < C / 64; ++kc)
      tma_load_2d(Ss + s * SRC_BYTES + kc * TILE * 128, &msrc, &full[s], kc * 64, tile * TILE);
  };
  if (tid == 0) {
    mbar_init(wbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);
      done[s] = 0;
    }
    mbar_fence_init();
    tma_prefetch_map(&msrc);
    mbar_expect_tx(wbar, W1_BYTES + W2_BYTES);
    for (int kc = 0; kc < C / 64; ++kc) tma_load_2d(W1s + kc * 4 * C1 * 128, &mw1, wbar, kc * 64, 0);
    tma_load_2d(W2s, &mw2, wbar, 0, 0);
    for (int k = 0; k < STAGES && blockIdx.x + k * (int)gridDim.x < ntiles; ++k) load_tile(k);
  }
  // the bias of conv2 and LayerNorm's affine, halved: the GELU works on x / 2
  for (int i = tid; i < C1; i += THREADS)
    pb1[i] = b1[i], plw[i] = 0.5f * lnw[i], plb[i] = 0.5f * lnb[i];
  for (int i = tid; i < C2; i += THREADS) pb2[i] = 0.5f * b2[i];
  __syncthreads();

  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;
  const int pair = wg >> 1, ptid = tid & 255;  // warpgroups 2i and 2i + 1 share output rows
  float* O = Os + pair * M * OUT_M_FLOATS;
  float d1[32], d2[64];  // conv1's and conv2's accumulators
#pragma unroll
  for (int e = 0; e < 32; ++e) d1[e] = 0.f;
#pragma unroll
  for (int e = 0; e < 64; ++e) d2[e] = 0.f;
  mbar_wait(wbar, 0);
  int k = 0;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x, ++k) {
    const int s = k % STAGES;
    const int b = tile / tiles_per_b, p0 = (tile % tiles_per_b) * TILE;
    // the first token's hypernetwork values of this quad's channels 8q + 2t + {0, 1}, loaded
    // now so that their latency hides behind the products
    const float* hyb = hyper + (size_t)b * M * C2 + 2 * t;
    float2 hv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) hv[q] = *reinterpret_cast<const float2*>(hyb + 8 * q);
    mbar_wait(&full[s], (k / STAGES) & 1);
    {
      const int jt = wg & 1;  // conv1 tap (i, j) = (pair, jt)
      issue_conv1(d1, Ss + s * SRC_BYTES, W1s, wg);
      wgmma_wait<0>();
      fence_regs(d1);
      if (lane == 0) {  // this warp no longer reads the tile; the last one refills the stage
        mbar_arrive(&empty[s]);
        if (atomicAdd(&done[s], 1) == CONSUMERS * 4 - 1) {
          done[s] = 0;
          mbar_wait(&empty[s], (k / STAGES) & 1);
          if (tile + STAGES * (int)gridDim.x < ntiles) load_tile(k + STAGES);
        }
      }

      // bias, LayerNorm2d over the tap's 64 channels (rows g and g + 8), GELU
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& v = d1[4 * j + 2 * hf + c];
            v += pb1[8 * j + 2 * t + c];
            sum += v;
          }
        const float mean = quad_sum(sum) * (1.f / C1);
        float sq = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float dv = d1[4 * j + 2 * hf + c] - mean;
            sq += dv * dv;
          }
        const float rstd = rsqrtf(quad_sum(sq) * (1.f / C1) + eps);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int d = 8 * j + 2 * t + c;
            float& v = d1[4 * j + 2 * hf + c];
            v = gelu_half(fmaf((v - mean) * rstd, plw[d], plb[d]));
          }
      }
      // conv2's A operand: the m16n8k16 A fragments of 16-channel slices
      uint32_t a2[C1 / 16][4];
#pragma unroll
      for (int kk = 0; kk < C1 / 16; ++kk) {
        a2[kk][0] = pack_bf16(d1[8 * kk + 0], d1[8 * kk + 1]);
        a2[kk][1] = pack_bf16(d1[8 * kk + 2], d1[8 * kk + 3]);
        a2[kk][2] = pack_bf16(d1[8 * kk + 4], d1[8 * kk + 5]);
        a2[kk][3] = pack_bf16(d1[8 * kk + 6], d1[8 * kk + 7]);
      }

      // conv2: 64 pixels x (4 sub-taps x 32 channels)
      fence_regs(d2);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C1 / 16; ++kk)
        wgmma_rs_n128(d2, a2[kk], wgmma_desc(W2s, kSwizzle128B, 16, 1024) + 2 * kk, kk != 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(d2);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          d2[4 * j + e] = gelu_half(fmaf(0.5f, d2[4 * j + e], pb2[8 * (j % 4) + 2 * t + (e & 1)]));

      // hypernetwork dots: column 8j + 2t + c is sub-tap u = j / 4, channel 8 (j % 4) + 2t + c
#pragma unroll 1
      for (int m = 0; m < M; ++m) {
        float2 hn[4];  // the next token's, loaded while this one's dots run
        if (m + 1 < M) {
#pragma unroll
          for (int q = 0; q < 4; ++q) hn[q] = *reinterpret_cast<const float2*>(hyb + (m + 1) * C2 + 8 * q);
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float part[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float a = 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q)
              a += d2[4 * (4 * u + q) + 2 * hf] * hv[q].x + d2[4 * (4 * u + q) + 2 * hf + 1] * hv[q].y;
            part[u] = a;
          }
          const float val = quad_reduce_scatter(part, t);  // sub-tap (k, l) = (t >> 1, t & 1)
          const int r = 16 * wi + g + 8 * hf;
          O[((m * 2 + (t >> 1)) * TILE + r) * 4 + 2 * jt + (t & 1)] = val;
        }
        if (m + 1 < M) {
#pragma unroll
          for (int q = 0; q < 4; ++q) hv[q] = hn[q];
        }
      }
    }

    // the tile's logits of output rows 4y + 2 pair + {0, 1}, 16 bytes a pixel and row
    named_barrier_sync(1 + pair, 256);
#pragma unroll 1
    for (int c = ptid; c < M * 2 * TILE; c += 256) {
      const int r = c % TILE, kr = (c / TILE) & 1, m = c / (2 * TILE);
      const int p = p0 + r, y = p / w, x = p - y * w;
      const float4 v = *reinterpret_cast<const float4*>(O + c * 4);
      *reinterpret_cast<float4*>(out + (((size_t)b * M + m) * 4 * h + 4 * y + 2 * pair + kr) * (4 * w) +
                                 4 * x) = v;
    }
    named_barrier_sync(1 + pair, 256);  // O is read out
  }
}

// A row-major (rows x cols) bf16 matrix as a TMA map with boxes of 64 columns x `box_rows`.
int rows_map(CUtensorMap* map, const void* base, uint64_t rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, rows}, stride[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_tensor_map(map, base, 2, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K6: src (B, h, w, 256) bf16; W1 (256, 256) bf16, row (2i + j) * 64 + d,
// column c; b1, lnw, lnb (64) fp32; W2 (128, 64) bf16, row (2k + l) * 32 + e,
// column d; b2 (32) fp32; hyper (B, M, 32) fp32 -> out (B, M, 4h, 4w) fp32.
// h * w % 64 == 0, 1 <= M <= 4; src, W1 and W2 16-byte aligned (TMA).
int samrs_upscale_hyper(const void* src, const void* W1, const void* b1, const void* lnw,
                        const void* lnb, const void* W2, const void* b2, const void* hyper,
                        void* out, int B, int h, int w, int M, float eps, void* stream) {
  using namespace samrs;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(W1) |
                            reinterpret_cast<uintptr_t>(W2);
  if (B <= 0 || h <= 0 || w <= 0 || (h * w) % TILE != 0 || M < 1 || M > MAX_M || aligned % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap msrc, mw1, mw2;
  int e = rows_map(&msrc, src, (uint64_t)B * h * w, C, TILE);
  if (e == 0) e = rows_map(&mw1, W1, 4 * C1, C, 4 * C1);
  if (e == 0) e = rows_map(&mw2, W2, 4 * C2, C1, 4 * C2);
  if (e != 0) return e;
  const size_t smem = smem_bytes(M);
  cudaError_t err = cudaFuncSetAttribute(upscale_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ntiles = B * (h * w / TILE);
  const int grid = ntiles < sm_count() ? ntiles : sm_count();
  upscale_wgmma_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      msrc, mw1, mw2, static_cast<const float*>(b1), static_cast<const float*>(lnw),
      static_cast<const float*>(lnb), static_cast<const float*>(b2),
      static_cast<const float*>(hyper), static_cast<float*>(out), h, w, M, ntiles, eps);
  return cudaGetLastError();
}

}  // extern "C"
