// K4 and K5: the image side of SAM's two-way transformer decode.
//
// Replace samrs_tpu/kernels/fused_twoway.py::_t2i_kv_pallas (K4) and
// ::_i2t_pallas (K5).  At a prompt bucket B the image side is a
// (B, 4096, 256) fp32 stream; every step is a few hundred flops per element
// against 4-8 bytes, far below the H100's ~295 flop/byte ridge, so both
// kernels are bound by device-memory bytes.  The design keeps everything
// between the stream's one read and its writes on chip:
//
//   K4  one pass over the batch-1 keys: K = (keys + pe) Wk^T + bk and
//       V = keys Wv^T + bv, written in bf16.
//   K5  one pass per two-way layer over a 64-row tile: q-projection of
//       bf16(keys + pe), 8-head attention over the padded token slots in
//       fp32 registers (blocks of 16 slots with an online softmax; a box
//       decode fills one block, many point prompts more), out-projection,
//       residual, two-pass LayerNorm (norm4), and the next layer's K/V
//       projections of the normed keys.
//
// The four 128x256 / 256x128 bf16 weights (64 KB each) do not fit in a
// block's 227 KB of shared memory together with the tile, so they are staged
// one after another through a single buffer with cp.async, each load issued
// before the work that precedes its use.  Projections run on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate) from shared memory.  In the
// shared-keys mode (layer 0, batch-1 keys, B prompts) the grid's fastest
// index is the prompt, so the blocks of one row tile read the same 64 KB of
// keys and pe from L2.  Each block reads its keys tile once from device
// memory and once more (the LayerNorm residual) while it is still in L2.
#include "warp_gemm.cuh"

namespace samrs {
namespace {

constexpr int C = 256;     // transformer width
constexpr int CI = 128;    // attention internal width (downsample rate 2)
constexpr int NH = 8;      // heads
constexpr int HD = CI / NH;
constexpr int NTOK = 16;   // token slots per block of the attention
constexpr int ROWS = 64;   // image rows per block
constexpr int THREADS = 256;
constexpr int PAIRS = ROWS * NH / THREADS;  // (row, head) pairs per thread
static_assert(PAIRS * THREADS == ROWS * NH, "attention pairs");

constexpr int LDW256 = C + 8;    // smem row stride of a (CI x C) weight
constexpr int LDW128 = CI + 8;   // of the (C x CI) out-projection weight
constexpr int LDA = C + 8;       // of the bf16 activation tile
constexpr int LDQ = CI + 4;      // of the fp32 q tile
constexpr int LDF = C + 8;       // of the fp32 residual / keys2 tile
constexpr int HS = NTOK * HD + 4;  // per-head stride of the token K/V (conflict-free float4)

constexpr int W_BYTES = (CI * LDW256 > C * LDW128 ? CI * LDW256 : C * LDW128) * 2;
constexpr int A_BYTES = ROWS * LDA * 2;
constexpr int F_BYTES = ROWS * LDF * 4;
constexpr int T_BYTES = (2 * NH * HS + NTOK) * 4;
constexpr int KV_SMEM = W_BYTES + A_BYTES;
constexpr int I2T_SMEM = W_BYTES + A_BYTES + F_BYTES + T_BYTES;
static_assert(W_BYTES % 128 == 0 && A_BYTES % 128 == 0 && F_BYTES % 128 == 0, "smem carve");
static_assert(I2T_SMEM <= 232448, "K5 shared memory");

// As[r][c] = bf16(x[r][c] + p[r][c]) (p may be null) for the 64 x 256 tile;
// x and p are fp32 rows of C in device memory.
__device__ __forceinline__ void stage_tile(bf16* As, const float* __restrict__ x,
                                           const float* __restrict__ p) {
  for (int i = threadIdx.x; i < ROWS * C / 4; i += THREADS) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    float4 v = *reinterpret_cast<const float4*>(x + (size_t)r * C + c);
    if (p != nullptr) {
      const float4 q = *reinterpret_cast<const float4*>(p + (size_t)r * C + c);
      v.x += q.x, v.y += q.y, v.z += q.z, v.w += q.w;
    }
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + c);
    d[0] = __floats2bfloat162_rn(v.x, v.y);
    d[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// Token K (pre-scaled) and V of slot block sb for prompt b, laid out per head
// (stride HS) for conflict-free float4 reads, and the block's mask bias.
__device__ __forceinline__ void stage_tokens(float* tk, float* tv, float* mb,
                                             const float* __restrict__ tok_k,
                                             const float* __restrict__ tok_v,
                                             const float* __restrict__ mask_bias, int b, int sb,
                                             int nslot, float scale) {
  const size_t base = ((size_t)b * nslot + sb * NTOK) * CI;
  for (int i = threadIdx.x; i < NTOK * CI; i += THREADS) {
    const int j = i / CI, c = i % CI, o = (c / HD) * HS + j * HD + c % HD;
    tk[o] = tok_k[base + i] * scale;
    tv[o] = tok_v[base + i];
  }
  if (threadIdx.x < NTOK) mb[threadIdx.x] = mask_bias[sb * NTOK + threadIdx.x];
}

// out[r][n] = bf16(As[r] . Ws[n] + bias[n]) for the 64 x CI tile, Ws a
// (CI x C) weight in shared memory; out is the tile's first row (stride CI).
// Warp w multiplies rows 16*(w%4).. by the columns 64*(w/4)..
__device__ __forceinline__ void project_store(const bf16* As, const bf16* Ws,
                                              const float* __restrict__ bias,
                                              bf16* __restrict__ out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr = warp & 3, wc = warp >> 2, g = lane >> 2, t = lane & 3;
  float acc[8][4];
  zero_acc(acc);
  warp_gemm<8, C>(acc, As + wr * 16 * LDA, LDA, Ws + wc * 64 * LDW256, LDW256);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = wc * 64 + j * 8 + 2 * t, r = wr * 16 + g;
    const float b0 = bias[n], b1 = bias[n + 1];
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * CI + n) =
        __floats2bfloat162_rn(acc[j][0] + b0, acc[j][1] + b1);
    *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r + 8) * CI + n) =
        __floats2bfloat162_rn(acc[j][2] + b0, acc[j][3] + b1);
  }
}

// K4.  Grid (B, N / ROWS).
__global__ void __launch_bounds__(THREADS)
t2i_kv_kernel(const float* __restrict__ keys, const float* __restrict__ pe,
              const bf16* __restrict__ Wk, const float* __restrict__ bk,
              const bf16* __restrict__ Wv, const float* __restrict__ bv,
              bf16* __restrict__ kout, bf16* __restrict__ vout, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* As = reinterpret_cast<bf16*>(smem + W_BYTES);
  const int r0 = blockIdx.y * ROWS;
  const size_t row = (size_t)blockIdx.x * N + r0;
  const float* x = keys + row * C;

  load_rows_async<THREADS>(Ws, LDW256, Wk, CI, C);
  cp_async_commit();
  stage_tile(As, x, pe + (size_t)r0 * C);
  cp_async_wait<0>();
  __syncthreads();
  project_store(As, Ws, bk, kout + row * CI);
  __syncthreads();
  load_rows_async<THREADS>(Ws, LDW256, Wv, CI, C);
  cp_async_commit();
  stage_tile(As, x, nullptr);
  cp_async_wait<0>();
  __syncthreads();
  project_store(As, Ws, bv, vout + row * CI);
}

// K5.  Grid (B, N / ROWS); blockIdx.x is the prompt.  With `shared` the keys
// have batch 1 and every prompt reads row tile blockIdx.y of it.  The token
// K/V have `nslot` slots, a multiple of NTOK.
__global__ void __launch_bounds__(THREADS)
i2t_update_kernel(const float* __restrict__ keys, const float* __restrict__ pe,
                  const float* __restrict__ tok_k, const float* __restrict__ tok_v,
                  const float* __restrict__ mask_bias,
                  const bf16* __restrict__ Wq, const float* __restrict__ bq,
                  const bf16* __restrict__ Wo, const float* __restrict__ bo,
                  const float* __restrict__ g4, const float* __restrict__ b4,
                  const bf16* __restrict__ Wk, const float* __restrict__ bk,
                  const bf16* __restrict__ Wv, const float* __restrict__ bv,
                  void* __restrict__ keys2, bf16* __restrict__ kout, bf16* __restrict__ vout,
                  int N, int nslot, int shared, int out_bf16, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);
  bf16* As = reinterpret_cast<bf16*>(smem + W_BYTES);
  float* Fs = reinterpret_cast<float*>(smem + W_BYTES + A_BYTES);
  float* tk = reinterpret_cast<float*>(smem + W_BYTES + A_BYTES + F_BYTES);
  float* tv = tk + NH * HS;
  float* mb = tv + NH * HS;

  const int b = blockIdx.x, r0 = blockIdx.y * ROWS;
  const float* x = keys + ((size_t)(shared ? 0 : b) * N + r0) * C;
  const float* p = pe + (size_t)r0 * C;
  const size_t orow = (size_t)b * N + r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2, g = lane >> 2, t = lane & 3;

  // 1. q = bf16(keys + pe) . Wq^T + bq -> Fs (64 x CI fp32, stride LDQ)
  load_rows_async<THREADS>(Ws, LDW256, Wq, CI, C);
  cp_async_commit();
  stage_tokens(tk, tv, mb, tok_k, tok_v, mask_bias, b, 0, nslot, scale);
  stage_tile(As, x, p);
  cp_async_wait<0>();
  __syncthreads();
  {
    float acc[8][4];
    zero_acc(acc);
    warp_gemm<8, C>(acc, As + wr * 16 * LDA, LDA, Ws + wc * 64 * LDW256, LDW256);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = wc * 64 + j * 8 + 2 * t, r = wr * 16 + g;
      Fs[r * LDQ + n] = acc[j][0] + bq[n];
      Fs[r * LDQ + n + 1] = acc[j][1] + bq[n + 1];
      Fs[(r + 8) * LDQ + n] = acc[j][2] + bq[n];
      Fs[(r + 8) * LDQ + n + 1] = acc[j][3] + bq[n + 1];
    }
  }
  __syncthreads();

  // 2. image -> token attention per (row, head) in fp32, online over the slot
  // blocks -> bf16 o in As (64 x CI)
  load_rows_async<THREADS>(Ws, LDW128, Wo, C, CI);
  cp_async_commit();
  float o[PAIRS][HD], mrun[PAIRS], den[PAIRS];
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    mrun[i] = neg_inf(), den[i] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; ++d) o[i][d] = 0.f;
  }
  for (int sb = 0; sb < nslot / NTOK; ++sb) {
    if (sb > 0) {
      __syncthreads();  // every thread is done with the previous block's tokens
      stage_tokens(tk, tv, mb, tok_k, tok_v, mask_bias, b, sb, nslot, scale);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int pr = tid + i * THREADS, r = pr / NH, h = pr % NH;
      float q[HD];
#pragma unroll
      for (int d = 0; d < HD; d += 4) {
        const float4 v = *reinterpret_cast<const float4*>(Fs + r * LDQ + h * HD + d);
        q[d] = v.x, q[d + 1] = v.y, q[d + 2] = v.z, q[d + 3] = v.w;
      }
      const float* kh = tk + h * HS;
      const float* vh = tv + h * HS;
      float s[NTOK], m = mrun[i];
#pragma unroll
      for (int j = 0; j < NTOK; ++j) {
        float a = 0.f;
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(kh + j * HD + d);
          a += q[d] * k4.x + q[d + 1] * k4.y + q[d + 2] * k4.z + q[d + 3] * k4.w;
        }
        s[j] = a + mb[j];
        m = fmaxf(m, s[j]);
      }
      const float alpha = expf(mrun[i] - m);  // 0 before the first block
      mrun[i] = m;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < NTOK; ++j) {
        s[j] = expf(s[j] - m);
        sum += s[j];
      }
      den[i] = den[i] * alpha + sum;
#pragma unroll
      for (int d = 0; d < HD; ++d) o[i][d] *= alpha;
#pragma unroll
      for (int j = 0; j < NTOK; ++j) {
#pragma unroll
        for (int d = 0; d < HD; d += 4) {
          const float4 v4 = *reinterpret_cast<const float4*>(vh + j * HD + d);
          o[i][d] += s[j] * v4.x, o[i][d + 1] += s[j] * v4.y;
          o[i][d + 2] += s[j] * v4.z, o[i][d + 3] += s[j] * v4.w;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < PAIRS; ++i) {
    const int pr = tid + i * THREADS, r = pr / NH, h = pr % NH;
    const float inv = 1.f / den[i];
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + h * HD);
#pragma unroll
    for (int d = 0; d < HD; d += 2)
      dst[d / 2] = __floats2bfloat162_rn(o[i][d] * inv, o[i][d + 1] * inv);
  }
  cp_async_wait<0>();
  __syncthreads();

  // 3. out-projection + bias -> Fs (64 x C fp32, stride LDF)
  {
    float acc[16][4];
    zero_acc(acc);
    warp_gemm<16, CI>(acc, As + wr * 16 * LDA, LDA, Ws + wc * 128 * LDW128, LDW128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = wc * 128 + j * 8 + 2 * t, r = wr * 16 + g;
      const float b0 = bo[n], b1 = bo[n + 1];
      *reinterpret_cast<float2*>(Fs + r * LDF + n) = make_float2(acc[j][0] + b0, acc[j][1] + b1);
      *reinterpret_cast<float2*>(Fs + (r + 8) * LDF + n) =
          make_float2(acc[j][2] + b0, acc[j][3] + b1);
    }
  }
  __syncthreads();

  // 4. residual + two-pass LayerNorm -> keys2 (device memory and Fs), As = bf16(keys2 + pe)
  load_rows_async<THREADS>(Ws, LDW256, Wk, CI, C);
  cp_async_commit();
  for (int rr = 0; rr < ROWS / 8; ++rr) {
    const int r = warp * (ROWS / 8) + rr;
    float v[8];
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int c = hlf * (C / 2) + lane * 4;
      const float4 xr = *reinterpret_cast<const float4*>(x + (size_t)r * C + c);
      const float4 fr = *reinterpret_cast<const float4*>(Fs + r * LDF + c);
      v[4 * hlf] = xr.x + fr.x, v[4 * hlf + 1] = xr.y + fr.y;
      v[4 * hlf + 2] = xr.z + fr.z, v[4 * hlf + 3] = xr.w + fr.w;
    }
    float sum = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += v[e];
    const float mean = warp_sum(sum) * (1.f / C);
    float sq = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) sq += (v[e] - mean) * (v[e] - mean);
    const float rstd = rsqrtf(warp_sum(sq) * (1.f / C) + eps);
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int c = hlf * (C / 2) + lane * 4;
      float y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) y[e] = (v[4 * hlf + e] - mean) * rstd * g4[c + e] + b4[c + e];
      const size_t o = (orow + r) * C + c;
      if (out_bf16) {
        __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(keys2) + o);
        d[0] = __floats2bfloat162_rn(y[0], y[1]);
        d[1] = __floats2bfloat162_rn(y[2], y[3]);
      } else {
        *reinterpret_cast<float4*>(static_cast<float*>(keys2) + o) = make_float4(y[0], y[1], y[2], y[3]);
      }
      *reinterpret_cast<float4*>(Fs + r * LDF + c) = make_float4(y[0], y[1], y[2], y[3]);
      const float4 pr = *reinterpret_cast<const float4*>(p + (size_t)r * C + c);
      __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + c);
      a[0] = __floats2bfloat162_rn(y[0] + pr.x, y[1] + pr.y);
      a[1] = __floats2bfloat162_rn(y[2] + pr.z, y[3] + pr.w);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // 5. the next attention's K = bf16(keys2 + pe) Wk^T + bk and V = bf16(keys2) Wv^T + bv
  project_store(As, Ws, bk, kout + orow * CI);
  __syncthreads();
  load_rows_async<THREADS>(Ws, LDW256, Wv, CI, C);
  cp_async_commit();
  for (int i = tid; i < ROWS * C / 4; i += THREADS) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const float4 y = *reinterpret_cast<const float4*>(Fs + r * LDF + c);
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + c);
    a[0] = __floats2bfloat162_rn(y.x, y.y);
    a[1] = __floats2bfloat162_rn(y.z, y.w);
  }
  cp_async_wait<0>();
  __syncthreads();
  project_store(As, Ws, bv, vout + orow * CI);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K4: keys (B, N, 256) fp32, pe (N, 256) fp32, Wk/Wv (128, 256) bf16,
// bk/bv (128) fp32 -> kout/vout (B, N, 128) bf16.  N % 64 == 0.
int samrs_t2i_kv(const void* keys, const void* pe, const void* Wk, const void* bk,
                 const void* Wv, const void* bv, void* kout, void* vout, int B, int N,
                 void* stream) {
  using namespace samrs;
  if (B <= 0 || N <= 0 || N % ROWS != 0) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(t2i_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         KV_SMEM);
  if (err != cudaSuccess) return err;
  t2i_kv_kernel<<<dim3(B, N / ROWS), THREADS, KV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const float*>(pe), static_cast<const bf16*>(Wk),
      static_cast<const float*>(bk), static_cast<const bf16*>(Wv), static_cast<const float*>(bv),
      static_cast<bf16*>(kout), static_cast<bf16*>(vout), N);
  return cudaGetLastError();
}

// K5: keys (1 if shared else B, N, 256) fp32, pe (N, 256) fp32, tok_k/tok_v
// (B, nslot, 128) fp32, mask_bias (nslot) fp32 (nslot a multiple of 16),
// Wq (128, 256), Wo (256, 128), Wk/Wv (128, 256) bf16 with fp32 biases,
// norm4 g4/b4 (256) fp32 ->
// keys2 (B, N, 256) fp32 (bf16 if out_bf16), kout/vout (B, N, 128) bf16.
int samrs_i2t_update(const void* keys, const void* pe, const void* tok_k, const void* tok_v,
                     const void* mask_bias, const void* Wq, const void* bq, const void* Wo,
                     const void* bo, const void* g4, const void* b4, const void* Wk,
                     const void* bk, const void* Wv, const void* bv, void* keys2, void* kout,
                     void* vout, int B, int N, int nslot, int shared, int out_bf16, float scale,
                     float eps, void* stream) {
  using namespace samrs;
  if (B <= 0 || N <= 0 || N % ROWS != 0 || nslot <= 0 || nslot % NTOK != 0)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      i2t_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, I2T_SMEM);
  if (err != cudaSuccess) return err;
  i2t_update_kernel<<<dim3(B, N / ROWS), THREADS, I2T_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const float*>(pe),
      static_cast<const float*>(tok_k), static_cast<const float*>(tok_v),
      static_cast<const float*>(mask_bias), static_cast<const bf16*>(Wq),
      static_cast<const float*>(bq), static_cast<const bf16*>(Wo), static_cast<const float*>(bo),
      static_cast<const float*>(g4), static_cast<const float*>(b4), static_cast<const bf16*>(Wk),
      static_cast<const float*>(bk), static_cast<const bf16*>(Wv), static_cast<const float*>(bv),
      keys2, static_cast<bf16*>(kout), static_cast<bf16*>(vout), N, nslot, shared, out_bf16,
      scale, eps);
  return cudaGetLastError();
}

}  // extern "C"
