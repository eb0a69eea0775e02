// K4 and K5: the image side of SAM's two-way transformer decode.
//
// Replace samrs_tpu/kernels/fused_twoway.py::_t2i_kv_pallas (K4) and
// ::_i2t_pallas (K5).  At a prompt bucket B the image side is a
// (B, 4096, 256) fp32 stream; every step is a few hundred flops per element
// against 4-8 bytes, far below the H100's ~295 flop/byte ridge, so both
// kernels are bound by device-memory bytes.  Both keep everything between
// the stream's one read and its writes on chip:
//
//   K4  one pass over the batch-1 keys: K = (keys + pe) Wk^T + bk and
//       V = keys Wv^T + bv, written in bf16.
//   K5  one pass per two-way layer over 64-row tiles: q-projection of
//       bf16(keys + pe), 8-head attention over the padded token slots in
//       fp32 (blocks of 16 slots with an online softmax; a box decode fills
//       one block, many point prompts more), out-projection, residual,
//       two-pass LayerNorm (norm4), and the next layer's K/V projections of
//       the normed keys.
//
// K5 on Hopper (hopper.cuh).  The cp.async kernel it replaces streamed its
// four weights through one buffer with cp.async, multiplied on mma.sync,
// staged its tiles with synchronous loads issued one after another and
// ended every stage in a full wait; its tile loads, LayerNorm and stores
// alone took three times the bytes bound, its projections a quarter of its
// time (chip_breakdown.py).  Here, one 64-row tile per block of two
// warpgroups:
//   * the weights arrive by TMA (boxes of 64 k-columns, 128-byte swizzle)
//     into one 64 KB buffer, each issued as soon as the previous projection
//     has read the buffer, so Wo lands during the attention, Wk during the
//     LayerNorm and Wv while the V operand is built.  All four (256 KB) do
//     not fit beside the tiles in 227 KB.  Of the cuts weighed (a 2-block
//     cluster multicasting each weight, 128-row tiles, two resident and two
//     streamed) the persistent forms, tried first, were slower than the
//     kernel this replaces: two warpgroups on a tile each had to take every
//     streamed chunk in step, and a tile's dependent loads were exposed on
//     four warps instead of eight.  So were two blocks an SM (16 KB chunks
//     through a ring, the LayerNorm in registers): at 128 registers a
//     thread they spilled;
//   * the projections run on wgmma m64nNk16 with A from registers (the
//     m16n8k16 fragments, read from the bf16 tile with ldmatrix): each
//     warpgroup takes half of the output columns of all 64 rows, B read
//     from the swizzled weight boxes;
//   * every thread issues all of its tile loads before it uses one (the
//     keys and pe tile, the LayerNorm's rows), so a block's loads are in
//     flight together;
//   * the attention over the token slots stays fp32 on the CUDA cores, as
//     the plain version computes it: each thread takes two (row, head)
//     pairs, online over blocks of 16 slots.
//
// K4 on Hopper.  The kernel it replaces ran 64 blocks on 132 SMs, loaded Wk
// by cp.async, waited, multiplied on mma.sync, loaded Wv into the same
// buffer, waited again, and read its keys tile twice: 0.0107 ms of device
// time against a 0.0032 bound (ViT-H, 4096 rows, H100; chip_breakdown.py).
// Here:
//   * 32-row tiles (128 blocks at 4096 rows), one block an SM;
//   * both weights (2 x 64 KB) by TMA when the block starts, landing while
//     the tile is read;
//   * the tile's keys and pe read once, every load issued before the first
//     conversion, giving bf16(keys + pe) and bf16(keys) in shared memory;
//   * warpgroup 0 projects K, warpgroup 1 V, each on wgmma m64n128 with A
//     from registers (project_wg, shared with K5; warps 2-3 of a warpgroup
//     repeat rows 0-31 and store nothing).
#include "hopper.cuh"

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

constexpr int KV_ROWS = 32;      // image rows of a K4 block
constexpr int LDA = C + 8;       // smem row stride of the bf16 activation tile
constexpr int LDQ = CI + 4;      // of the fp32 q tile
constexpr int LDF = C + 8;       // of the fp32 residual / keys2 tile
constexpr int HS = NTOK * HD + 4;  // per-head stride of the token K/V (conflict-free float4)

constexpr int A_BYTES = ROWS * LDA * 2;
constexpr int F_BYTES = ROWS * LDF * 4;
constexpr int T_BYTES = (2 * NH * HS + NTOK) * 4;
constexpr int WB_BYTES = C * CI * 2;       // one weight in 64-column boxes
constexpr int KV_A_BYTES = KV_ROWS * LDA * 2;
constexpr int KV_SMEM = 1024 + 2 * WB_BYTES + 2 * KV_A_BYTES + 64;
constexpr int I2T_SMEM = 1024 + WB_BYTES + A_BYTES + F_BYTES + T_BYTES + 64;
static_assert(A_BYTES % 128 == 0 && F_BYTES % 128 == 0 && KV_A_BYTES % 128 == 0, "smem carve");
static_assert(KV_SMEM <= 232448, "K4 shared memory");
static_assert(I2T_SMEM <= 232448, "K5 shared memory");

// As[r][c] = bf16(x[r][c] + p[r][c]) for the 64 x 256 tile; x and p are fp32
// rows of C in device memory.  A thread issues all of its loads before it
// converts one.
__device__ __forceinline__ void stage_tile(bf16* As, const float* __restrict__ x,
                                           const float* __restrict__ p) {
  constexpr int PER = ROWS * C / 4 / THREADS;
  float4 v[PER], q[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, r = i / (C / 4), c = (i % (C / 4)) * 4;
    v[k] = *reinterpret_cast<const float4*>(x + (size_t)r * C + c);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, r = i / (C / 4), c = (i % (C / 4)) * 4;
    q[k] = *reinterpret_cast<const float4*>(p + (size_t)r * C + c);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) v[k].x += q[k].x, v[k].y += q[k].y, v[k].z += q[k].z, v[k].w += q[k].w;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = threadIdx.x + k * THREADS, r = i / (C / 4), c = (i % (C / 4)) * 4;
    __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + c);
    d[0] = __floats2bfloat162_rn(v[k].x, v[k].y);
    d[1] = __floats2bfloat162_rn(v[k].z, v[k].w);
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

// ---------------------------------------------------------------------------
// K5: one 64-row tile per block, wgmma with A from registers, weights by TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// acc = rows 0..63 of As[:, 0:K] times this warpgroup's NW output rows of the
// weight in `W` (boxes of 64 k-columns x `box_rows` rows, 128-byte swizzle),
// starting at row n0: wgmma m64nNWk16, A fragments from As with ldmatrix,
// all loaded before the first product (a product reads its A registers
// after it is issued).  An A tile of AROWS < 64 rows is read again by the
// warps past its rows, whose sums the caller drops.
template <int NW, int K, int AROWS = 64>
__device__ __forceinline__ void project_wg(float (&acc)[NW / 2], const bf16* As,
                                           const unsigned char* W, int box_rows, int n0) {
  const int wi = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int ar = (wi % (AROWS / 16)) * 16;  // the warp's first row of A
  uint32_t af[K / 16][4];
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    ldmatrix_x4(af[kk], As + (ar + (lane & 15)) * LDA + kk * 16 + ((lane >> 4) << 3));
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db =
        wgmma_desc(W + (kk / 4) * box_rows * 128 + n0 * 128, kSwizzle128B, 16, 1024) + 2 * (kk % 4);
    if constexpr (NW == 128) wgmma_rs_n128(acc, af[kk], db, kk != 0);
    else wgmma_rs_n64(acc, af[kk], db, kk != 0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
}

// K4.  Grid (B, N / KV_ROWS).  Warpgroup 0 writes K = bf16(keys + pe) Wk^T +
// bk, warpgroup 1 V = bf16(keys) Wv^T + bv, for the block's 32 rows; mk / mv
// are the (CI x C) weights with boxes of 64 k-columns x 128 rows.
__global__ void __launch_bounds__(THREADS, 1)
t2i_kv_kernel(const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
              const float* __restrict__ keys, const float* __restrict__ pe,
              const float* __restrict__ bk, const float* __restrict__ bv, bf16* __restrict__ kout,
              bf16* __restrict__ vout, int N) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Wks = smem;  // Wk, then Wv: 4 boxes of 64 k-columns each
  unsigned char* Wvs = smem + WB_BYTES;
  bf16* Akp = reinterpret_cast<bf16*>(smem + 2 * WB_BYTES);  // bf16(keys + pe)
  bf16* Ak = reinterpret_cast<bf16*>(smem + 2 * WB_BYTES + KV_A_BYTES);  // bf16(keys)
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + 2 * WB_BYTES + 2 * KV_A_BYTES);
  const int b = blockIdx.x, r0 = blockIdx.y * KV_ROWS;
  const size_t row = (size_t)b * N + r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;

  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_fence_init();
    tma_prefetch_map(&mk);
    tma_prefetch_map(&mv);
    mbar_expect_tx(wbar, 2 * WB_BYTES);
    for (int kc = 0; kc < C / 64; ++kc) {
      tma_load_2d(Wks + kc * CI * 128, &mk, wbar, kc * 64, 0);
      tma_load_2d(Wvs + kc * CI * 128, &mv, wbar, kc * 64, 0);
    }
  }
  // the tile's keys and pe, read once: every load issued before the first conversion
  constexpr int PER = KV_ROWS * C / 4 / THREADS;
  const float* x = keys + row * C;
  const float* p = pe + (size_t)r0 * C;
  float4 xv[PER], pv[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    xv[k] = *reinterpret_cast<const float4*>(x + (size_t)i * 4);
    pv[k] = *reinterpret_cast<const float4*>(p + (size_t)i * 4);
  }
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS, r = i / (C / 4), c = (i % (C / 4)) * 4;
    __nv_bfloat162* dk = reinterpret_cast<__nv_bfloat162*>(Ak + r * LDA + c);
    dk[0] = __floats2bfloat162_rn(xv[k].x, xv[k].y);
    dk[1] = __floats2bfloat162_rn(xv[k].z, xv[k].w);
    __nv_bfloat162* dkp = reinterpret_cast<__nv_bfloat162*>(Akp + r * LDA + c);
    dkp[0] = __floats2bfloat162_rn(xv[k].x + pv[k].x, xv[k].y + pv[k].y);
    dkp[1] = __floats2bfloat162_rn(xv[k].z + pv[k].z, xv[k].w + pv[k].w);
  }
  __syncthreads();  // the tiles are written (and the barrier initialised)
  mbar_wait(wbar, 0);

  float acc[CI / 2];
  project_wg<CI, C, KV_ROWS>(acc, wg == 0 ? Akp : Ak, wg == 0 ? Wks : Wvs, CI, 0);
  if (wi * 16 >= KV_ROWS) return;  // rows past the tile
  const float* bias = wg == 0 ? bk : bv;
  bf16* dst = (wg == 0 ? kout : vout) + (row + wi * 16 + g) * CI + 2 * t;
#pragma unroll
  for (int j = 0; j < CI / 8; ++j) {
    const float2 bb = ld2(bias + j * 8 + 2 * t);
    *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
        __floats2bfloat162_rn(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
    *reinterpret_cast<__nv_bfloat162*>(dst + 8 * CI + j * 8) =
        __floats2bfloat162_rn(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
  }
}

// K5.  Grid (B, N / ROWS); blockIdx.x is the prompt, so in the shared-keys
// mode (batch-1 keys, layer 0) consecutive blocks read the same row tile of
// the keys and pe from L2.  The token K/V have `nslot` slots, a multiple of
// NTOK.  Warpgroup w computes output columns [w N / 2, (w + 1) N / 2) of
// every projection.
__global__ void __launch_bounds__(THREADS, 1)
i2t_wgmma_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mo,
                 const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 const float* __restrict__ keys, const float* __restrict__ pe,
                 const float* __restrict__ tok_k, const float* __restrict__ tok_v,
                 const float* __restrict__ mask_bias, const float* __restrict__ bq,
                 const float* __restrict__ bo, const float* __restrict__ g4,
                 const float* __restrict__ b4, const float* __restrict__ bk,
                 const float* __restrict__ bv, void* __restrict__ keys2, bf16* __restrict__ kout,
                 bf16* __restrict__ vout, int N, int nslot, int shared, int out_bf16, float scale,
                 float eps) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Wb = smem;  // the weight in use, boxes of 64 k-columns
  bf16* As = reinterpret_cast<bf16*>(smem + WB_BYTES);
  float* Fs = reinterpret_cast<float*>(smem + WB_BYTES + A_BYTES);
  float* tk = reinterpret_cast<float*>(smem + WB_BYTES + A_BYTES + F_BYTES);
  float* tv = tk + NH * HS;
  float* mb = tv + NH * HS;
  uint64_t* wbar = reinterpret_cast<uint64_t*>(smem + WB_BYTES + A_BYTES + F_BYTES + T_BYTES);

  const int b = blockIdx.x, r0 = blockIdx.y * ROWS;
  const float* x = keys + ((size_t)(shared ? 0 : b) * N + r0) * C;
  const float* p = pe + (size_t)r0 * C;
  const size_t orow = (size_t)b * N + r0;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wg = warp >> 2, wi = warp & 3, g = lane >> 2, t = lane & 3;

  // the weight buffer: load L (Wq, Wo, Wk, Wv) completes phase L & 1 of wbar
  auto load_weight = [&](const CUtensorMap* map, int rows) {
    mbar_expect_tx(wbar, WB_BYTES);  // Wq (128 x 256) and Wo (256 x 128) are 64 KB alike
    for (int kc = 0; kc < (rows == CI ? C : CI) / 64; ++kc)
      tma_load_2d(Wb + kc * rows * 128, map, wbar, kc * 64, 0);
  };
  if (tid == 0) {
    mbar_init(wbar, 1);
    mbar_fence_init();
    tma_prefetch_map(&mq);
    tma_prefetch_map(&mo);
    tma_prefetch_map(&mk);
    tma_prefetch_map(&mv);
    load_weight(&mq, CI);
  }
  stage_tokens(tk, tv, mb, tok_k, tok_v, mask_bias, b, 0, nslot, scale);
  stage_tile(As, x, p);
  __syncthreads();

  // 1. q = bf16(keys + pe) . Wq^T + bq -> Fs (64 x CI fp32, stride LDQ)
  mbar_wait(wbar, 0);
  {
    float acc[CI / 4];
    project_wg<CI / 2, C>(acc, As, Wb, CI, wg * CI / 2);
#pragma unroll
    for (int j = 0; j < CI / 16; ++j) {
      const int n = wg * CI / 2 + j * 8 + 2 * t, r = wi * 16 + g;
      const float2 bb = ld2(bq + n);
      *reinterpret_cast<float2*>(Fs + r * LDQ + n) = make_float2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      *reinterpret_cast<float2*>(Fs + (r + 8) * LDQ + n) =
          make_float2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    }
  }
  __syncthreads();  // Wq is read out; q is in Fs
  if (tid == 0) load_weight(&mo, C);  // Wo lands during the attention

  // 2. image -> token attention per (row, head) in fp32, online over the slot
  // blocks -> bf16 o in As (64 x CI)
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
  __syncthreads();

  // 3. out-projection + bias -> Fs (64 x C fp32, stride LDF)
  mbar_wait(wbar, 1);
  {
    float acc[C / 4];
    project_wg<C / 2, CI>(acc, As, Wb, C, wg * C / 2);
#pragma unroll
    for (int j = 0; j < C / 16; ++j) {
      const int n = wg * C / 2 + j * 8 + 2 * t, r = wi * 16 + g;
      const float2 bb = ld2(bo + n);
      *reinterpret_cast<float2*>(Fs + r * LDF + n) = make_float2(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      *reinterpret_cast<float2*>(Fs + (r + 8) * LDF + n) =
          make_float2(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    }
  }
  __syncthreads();  // Wo is read out
  if (tid == 0) load_weight(&mk, CI);  // Wk lands during the LayerNorm

  // 4. residual + two-pass LayerNorm -> keys2 (device memory and Fs), As = bf16(keys2 + pe);
  // warp w takes rows 8w .. 8w + 7, lane the columns 4 lane + {0..3} and 128 + 4 lane + {0..3}
  {
    float4 xr[ROWS / 8][2], pr[ROWS / 8][2];
#pragma unroll
    for (int rr = 0; rr < ROWS / 8; ++rr)
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const size_t off = (size_t)(warp * (ROWS / 8) + rr) * C + hlf * (C / 2) + lane * 4;
        xr[rr][hlf] = *reinterpret_cast<const float4*>(x + off);
        pr[rr][hlf] = *reinterpret_cast<const float4*>(p + off);
      }
#pragma unroll
    for (int rr = 0; rr < ROWS / 8; ++rr) {
      const int r = warp * (ROWS / 8) + rr;
      float v[8];
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int c = hlf * (C / 2) + lane * 4;
        const float4 fr = *reinterpret_cast<const float4*>(Fs + r * LDF + c);
        v[4 * hlf] = fr.x + xr[rr][hlf].x, v[4 * hlf + 1] = fr.y + xr[rr][hlf].y;
        v[4 * hlf + 2] = fr.z + xr[rr][hlf].z, v[4 * hlf + 3] = fr.w + xr[rr][hlf].w;
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
        const float4 gg = *reinterpret_cast<const float4*>(g4 + c);
        const float4 bb = *reinterpret_cast<const float4*>(b4 + c);
        float y[4];
        y[0] = (v[4 * hlf] - mean) * rstd * gg.x + bb.x;
        y[1] = (v[4 * hlf + 1] - mean) * rstd * gg.y + bb.y;
        y[2] = (v[4 * hlf + 2] - mean) * rstd * gg.z + bb.z;
        y[3] = (v[4 * hlf + 3] - mean) * rstd * gg.w + bb.w;
        const size_t o2 = (orow + r) * C + c;
        if (out_bf16) {
          __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(keys2) + o2);
          d[0] = __floats2bfloat162_rn(y[0], y[1]);
          d[1] = __floats2bfloat162_rn(y[2], y[3]);
        } else {
          *reinterpret_cast<float4*>(static_cast<float*>(keys2) + o2) =
              make_float4(y[0], y[1], y[2], y[3]);
        }
        *reinterpret_cast<float4*>(Fs + r * LDF + c) = make_float4(y[0], y[1], y[2], y[3]);
        __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + c);
        a[0] = __floats2bfloat162_rn(y[0] + pr[rr][hlf].x, y[1] + pr[rr][hlf].y);
        a[1] = __floats2bfloat162_rn(y[2] + pr[rr][hlf].z, y[3] + pr[rr][hlf].w);
      }
    }
  }
  __syncthreads();

  // 5. the next attention's K = bf16(keys2 + pe) Wk^T + bk and V = bf16(keys2) Wv^T + bv
  auto project_out = [&](const float* __restrict__ bias, bf16* __restrict__ dst) {
    float acc[CI / 4];
    project_wg<CI / 2, C>(acc, As, Wb, CI, wg * CI / 2);
#pragma unroll
    for (int j = 0; j < CI / 16; ++j) {
      const int n = wg * CI / 2 + j * 8 + 2 * t, r = wi * 16 + g;
      const float2 bb = ld2(bias + n);
      *reinterpret_cast<__nv_bfloat162*>(dst + (orow + r) * CI + n) =
          __floats2bfloat162_rn(acc[4 * j] + bb.x, acc[4 * j + 1] + bb.y);
      *reinterpret_cast<__nv_bfloat162*>(dst + (orow + r + 8) * CI + n) =
          __floats2bfloat162_rn(acc[4 * j + 2] + bb.x, acc[4 * j + 3] + bb.y);
    }
  };
  mbar_wait(wbar, 0);
  project_out(bk, kout);
  __syncthreads();  // Wk and the K operand are read out
  if (tid == 0) load_weight(&mv, CI);  // Wv lands while the V operand is built
#pragma unroll 4
  for (int i = tid; i < ROWS * C / 4; i += THREADS) {
    const int r = i / (C / 4), c = (i % (C / 4)) * 4;
    const float4 y = *reinterpret_cast<const float4*>(Fs + r * LDF + c);
    __nv_bfloat162* a = reinterpret_cast<__nv_bfloat162*>(As + r * LDA + c);
    a[0] = __floats2bfloat162_rn(y.x, y.y);
    a[1] = __floats2bfloat162_rn(y.z, y.w);
  }
  __syncthreads();
  mbar_wait(wbar, 1);
  project_out(bv, vout);
}

// A weight (rows x cols bf16, row-major) as a TMA map with boxes of 64 columns x `box_rows`.
int weight_map(CUtensorMap* map, const void* w, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows}, stride[1] = {(uint64_t)cols * 2};
  const uint32_t box[2] = {64, (uint32_t)box_rows};
  return make_tensor_map(map, w, 2, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K4: keys (B, N, 256) fp32, pe (N, 256) fp32, Wk/Wv (128, 256) bf16
// (16-byte aligned: TMA), bk/bv (128) fp32 -> kout/vout (B, N, 128) bf16.
// N % 32 == 0.
int samrs_t2i_kv(const void* keys, const void* pe, const void* Wk, const void* bk,
                 const void* Wv, const void* bv, void* kout, void* vout, int B, int N,
                 void* stream) {
  using namespace samrs;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(Wk) | reinterpret_cast<uintptr_t>(Wv) |
                            reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(pe);
  if (B <= 0 || N <= 0 || N % KV_ROWS != 0 || N / KV_ROWS > 65535 || aligned % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap mk, mv;
  int e = weight_map(&mk, Wk, CI, C, CI);
  if (e == 0) e = weight_map(&mv, Wv, CI, C, CI);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(t2i_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         KV_SMEM);
  if (err != cudaSuccess) return err;
  t2i_kv_kernel<<<dim3(B, N / KV_ROWS), THREADS, KV_SMEM, static_cast<cudaStream_t>(stream)>>>(
      mk, mv, static_cast<const float*>(keys), static_cast<const float*>(pe),
      static_cast<const float*>(bk), static_cast<const float*>(bv), static_cast<bf16*>(kout),
      static_cast<bf16*>(vout), N);
  return cudaGetLastError();
}

// K5: keys (1 if shared else B, N, 256) fp32, pe (N, 256) fp32, tok_k/tok_v
// (B, nslot, 128) fp32, mask_bias (nslot) fp32 (nslot a multiple of 16),
// Wq (128, 256), Wo (256, 128), Wk/Wv (128, 256) bf16 with fp32 biases,
// norm4 g4/b4 (256) fp32 ->
// keys2 (B, N, 256) fp32 (bf16 if out_bf16), kout/vout (B, N, 128) bf16.
// N % 64 == 0; the weights 16-byte aligned (TMA).
int samrs_i2t_update(const void* keys, const void* pe, const void* tok_k, const void* tok_v,
                     const void* mask_bias, const void* Wq, const void* bq, const void* Wo,
                     const void* bo, const void* g4, const void* b4, const void* Wk,
                     const void* bk, const void* Wv, const void* bv, void* keys2, void* kout,
                     void* vout, int B, int N, int nslot, int shared, int out_bf16, float scale,
                     float eps, void* stream) {
  using namespace samrs;
  const uintptr_t aligned = reinterpret_cast<uintptr_t>(Wq) | reinterpret_cast<uintptr_t>(Wo) |
                            reinterpret_cast<uintptr_t>(Wk) | reinterpret_cast<uintptr_t>(Wv);
  if (B <= 0 || N <= 0 || N % ROWS != 0 || nslot <= 0 || nslot % NTOK != 0 || aligned % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap mq, mo, mk, mv;
  int e = weight_map(&mq, Wq, CI, C, CI);
  if (e == 0) e = weight_map(&mo, Wo, C, CI, C);
  if (e == 0) e = weight_map(&mk, Wk, CI, C, CI);
  if (e == 0) e = weight_map(&mv, Wv, CI, C, CI);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      i2t_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, I2T_SMEM);
  if (err != cudaSuccess) return err;
  i2t_wgmma_kernel<<<dim3(B, N / ROWS), THREADS, I2T_SMEM, static_cast<cudaStream_t>(stream)>>>(
      mq, mo, mk, mv, static_cast<const float*>(keys), static_cast<const float*>(pe),
      static_cast<const float*>(tok_k), static_cast<const float*>(tok_v),
      static_cast<const float*>(mask_bias), static_cast<const float*>(bq),
      static_cast<const float*>(bo), static_cast<const float*>(g4), static_cast<const float*>(b4),
      static_cast<const float*>(bk), static_cast<const float*>(bv), keys2,
      static_cast<bf16*>(kout), static_cast<bf16*>(vout), N, nslot, shared, out_bf16, scale, eps);
  return cudaGetLastError();
}

}  // extern "C"
