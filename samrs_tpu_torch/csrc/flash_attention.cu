// K2: global attention with the decomposed relative-position bias, heads
// read in place from the raw (B, N, 3C) qkv tensor.
//
// Replaces samrs_tpu/kernels/flash_attention.py::_qkv_m_kernel (variant
// "m"), _qkv_flash_kernel ("split", and "exp2" with exp2=True) and
// _qkv_aug_kernel ("aug"), which keep all of one image's K/V resident in
// VMEM and take the softmax in one pass, with the rel-pos bias riding one-hot
// matmuls and the row sum riding a ones lane of v.  Bound on the H100:
// tensor-core flops (ViT-H: 16 heads x 4096^2 x 80 x 4 = 86 GFLOP per layer
// against 31 MB of qkv) and, close behind, the softmax on the CUDA cores and
// the MUFU exp units (268 M exps a layer, with only 320 tensor-core flops
// per logit at head_dim 80); the 4096 x 4096 logits per head must never
// reach device memory.  The design, FA3's on Hopper (hopper.cuh's plumbing):
//   * one 384-thread block per (128-query tile, head, image): a producer
//     warp and two consumer warpgroups of 64 query rows each;
//   * the producer loads Q once and K / V tiles of 128 keys through a
//     two-stage TMA ring (separate "full" barriers for K and V, so Q.K^T
//     starts while V is in flight) from a 3-d tensor map over qkv, so a head
//     is a column offset and keys past N (per image) read zeros.  A head of
//     64 is one 128-byte-swizzled box; a head of 80 is that box plus a
//     16-wide, 32-byte-swizzled one (80 bf16 = 160 bytes fits no swizzle
//     atom), each with its own wgmma descriptors;
//   * S = Q.K^T by wgmma m64n128k16 with both operands in shared memory;
//     the online softmax in fp32 on the accumulator registers; P rounded to
//     bf16 once and fed from registers (the accumulator's m16n8 fragments
//     are the A operand's) to wgmma m64n64k16 (+ m64n16k16) against V read
//     transposed (MN-major) from shared memory;
//   * the bias s += rel_h[q, k / kw] + rel_w[q, k % kw] from the fp32
//     rel_h / rel_w rows computed outside (as the JAX package does): on a
//     grid 64 (or 48) wide a key tile is two grid rows, 128 (or 96) keys,
//     and each thread's key columns are the same in every tile, so its rel_w
//     values stay in registers and the row term is one load a row and grid
//     row, issued before the tile's Q.K^T; any other grid splits each key
//     into (row, column) by a float reciprocal (no integer division) and
//     reads both terms from the rel rows in global memory (L1-cached).
// Measured (chip_smoke.py, H100 80GB HBM3 at a 700 W limit): at ViT-H's
// 64 x 64 grid the wrapper (rel rows + this kernel) takes ~0.37 ms against
// ~0.58 for SDPA with the bias as a mask (the mma.sync design: 1.18); the
// softmax's ALU and MUFU work runs beside the products of each warpgroup
// without a ping-pong schedule, so the kernel sits ~3x above its tensor
// bound.
// The modes differ only where their TPU twins round: "m" and "split" are
// this function; "exp2" takes the softmax in base 2 (the wrapper folds log2 e
// into the scale and the rel rows); "aug" rounds q * scale to bf16 before
// the q.k product (in shared memory) and adds rel rows that the wrapper
// rounded to bf16.  The running sum l adds the bf16-rounded probabilities
// that P.V consumes (flash_attention.online_softmax_v is the plain form).
//
// K12's query-tiled form is this kernel on split heads (SPLIT): q, k and v
// (B', N, d), each behind its own 3-d map (d, N, B'), so that keys past N
// read zeros as they do here; the natural softmax over 128-key tiles; the
// given fp32 rel rows (B', N, kh) / (B', N, kw), held in registers also on
// grids 32 and 16 wide (a key tile of four or eight whole grid rows: the
// global path's per-key loads took a third of the 32 x 32 grid's time);
// fp32 rows out.  It replaces
// samrs_tpu/kernels/flash_attention.py::_flash_attention_fwd_pallas (the
// globals of window_attn_impl="xla") and window_attention.py::
// _window_attention_pallas on the grids the window form of
// csrc/window_attention.cu does not take (the global grids of image_size
// 512 and 256).  Its rel rows come from relpos_rows_kernel with one head a
// row of B' (samrs_split_relpos_rows), reading bf16 q in place.
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int FW_BQ = 128;       // queries of a block (two consumer warpgroups of 64)
constexpr int FW_BK = 128;       // rows of a K / V tile in shared memory (keys of a tile: 128 or 96)
constexpr int FW_STAGES = 2;
constexpr int FW_THREADS = 384;  // producer warpgroup + two consumer warpgroups

enum FlashMode { kFlashNatural = 0, kFlashExp2 = 1, kFlashAug = 2 };

// A 128-row operand tile of one head: 128 rows x 64 columns (128 bytes a
// row, 128-byte swizzle, 16 KB), then for head_dim 80 the last 16 columns
// (32 bytes a row, 32-byte swizzle, 4 KB).  Each is loaded as two boxes of
// 64 rows.
template <int HD>
struct FlashTile {
  static constexpr int MAIN = FW_BK * 128;
  static constexpr int TAIL = HD == 80 ? FW_BK * 32 : 0;
  static constexpr int BYTES = MAIN + TAIL;  // a multiple of 1024
  // Q, then K and V of each stage, then the barriers
  static constexpr int SMEM = 1024 + (1 + 2 * FW_STAGES) * BYTES + (1 + 3 * FW_STAGES) * 8;
};

// 2^x on the MUFU unit (flushes subnormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Loads rows [row0, row0 + 128) of the head's columns [col, col + HD) of
// image b into a FlashTile at `dst`, completing on `bar`.
template <int HD>
__device__ __forceinline__ void load_head_tile(unsigned char* dst, const CUtensorMap* main_map,
                                               const CUtensorMap* tail_map, uint64_t* bar, int col,
                                               int row0, int b) {
  mbar_expect_tx(bar, FlashTile<HD>::BYTES);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    tma_load_3d(dst + h * 64 * 128, main_map, bar, col, row0 + 64 * h, b);
    if constexpr (HD == 80)
      tma_load_3d(dst + FlashTile<HD>::MAIN + h * 64 * 32, tail_map, bar, col + 64, row0 + 64 * h, b);
  }
}

// S (64 x n, fp32) (+)= Q (smem) . K (smem)^T over n = 128 or 96 keys.
template <int R>
__device__ __forceinline__ void wgmma_s_tile(float (&d)[R], uint64_t da, uint64_t db, int scale_d) {
  if constexpr (R == 64) wgmma_ss_n128(d, da, db, scale_d);
  else wgmma_ss_n96(d, da, db, scale_d);
}

// Where the bias terms come from: registers, for grids 64 or 48 wide (key
// tiles of two grid rows: 128 or 96 keys) and, in K12's form, 32 or 16 wide
// (four or eight grid rows of a 128-key tile); global memory for any other
// grid.
enum RelSource { kRelKw64 = 0, kRelKw48 = 1, kRelGlobal = 2, kRelKw32 = 3, kRelKw16 = 4 };

// The operands' 3-d tensor maps, Q, K, V in turn: `main` a box of 64 x 64 x 1
// (128-byte swizzle), `tail` one of 16 x 64 x 1 (32-byte swizzle; unused for
// head_dim 64).  K2 gives the raw qkv map (3C, N, B) three times and reads
// head h at columns h HD, C + h HD, 2C + h HD; K12 gives one map (HD, N, B')
// of each split-head operand, read at column 0.
struct QkvMaps {
  CUtensorMap main[3];
  CUtensorMap tail[3];
};

// K2 (SPLIT false): qkv (B, N, 3C) bf16; rel_h (B, nH, N, KH), rel_w (B, nH,
// N, KW) fp32; out (B, N, C) bf16; grid (N / 128, nH, B).  K12 (SPLIT true):
// q, k, v (B', N, HD) bf16; rel_h (B', N, KH), rel_w (B', N, KW) fp32; out
// (B', N, HD) fp32; grid (N / 128, 1, B').
template <int HD, bool EXP2, int REL, bool SPLIT>
__global__ void __launch_bounds__(FW_THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ QkvMaps maps, const float* __restrict__ rel_h,
                   const float* __restrict__ rel_w, void* __restrict__ out, int N, int C, int KH,
                   int KW, float scale, int aug) {
  using T = FlashTile<HD>;
  constexpr int KWA = REL == kRelKw64 ? 64 : REL == kRelKw48 ? 48 : REL == kRelKw32 ? 32
                      : REL == kRelKw16 ? 16 : 0;  // a grid width in registers
  constexpr int BKT = KWA == 48 ? 96 : FW_BK;  // keys of a tile (the smem tile holds FW_BK rows)
  constexpr int RPT = KWA > 0 ? BKT / KWA : 1;  // grid rows of a key tile
  constexpr int NJ = BKT / 8;                  // 8-key column blocks of a tile
  constexpr int JW = KWA / 8;                  // ... of a grid row
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* Qs = smem;
  auto Ks = [&](int s) { return smem + (1 + 2 * s) * T::BYTES; };
  auto Vs = [&](int s) { return smem + (2 + 2 * s) * T::BYTES; };
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + (1 + 2 * FW_STAGES) * T::BYTES);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + FW_STAGES;
  uint64_t* empty = full_v + FW_STAGES;
  const int q0 = blockIdx.x * FW_BQ, h = blockIdx.y, b = blockIdx.z;
  const int nH = gridDim.y;
  auto col = [&](int part) { return SPLIT ? 0 : part * C + h * HD; };  // the head's first column
  const int ntiles = (N + BKT - 1) / BKT;
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < FW_STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int part = 0; part < (SPLIT ? 3 : 1); ++part) {
        tma_prefetch_map(&maps.main[part]);
        if constexpr (HD == 80) tma_prefetch_map(&maps.tail[part]);
      }
      load_head_tile<HD>(Qs, &maps.main[0], &maps.tail[0], bar_q, col(0), q0, b);
      for (int tile = 0; tile < ntiles; ++tile) {
        const int s = tile % FW_STAGES;
        mbar_wait(&empty[s], ((tile / FW_STAGES) & 1) ^ 1);
        load_head_tile<HD>(Ks(s), &maps.main[1], &maps.tail[1], &full_k[s], col(1), tile * BKT, b);
        load_head_tile<HD>(Vs(s), &maps.main[2], &maps.tail[2], &full_v[s], col(2), tile * BKT, b);
      }
    }
    return;
  }

  // consumers: warpgroup c owns query rows q0 + 64c .. q0 + 64c + 63
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  unsigned char* Qm = Qs + c * 64 * 128;           // this warpgroup's rows, 64 columns
  unsigned char* Qt = Qs + T::MAIN + c * 64 * 32;  // and the last 16 (head_dim 80)

  mbar_wait(bar_q, 0);
  if (aug) {  // q * scale rounded to bf16 before the product (elementwise: swizzle-blind)
    auto scale_rows = [&](unsigned char* rows, int bytes) {
      for (int i = threadIdx.x & 127; i < bytes / 16; i += 128) {
        uint4* p = reinterpret_cast<uint4*>(rows) + i;
        uint4 v = *p;
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          e[k] = __floats2bfloat162_rn(__bfloat162float(e[k].x) * scale,
                                       __bfloat162float(e[k].y) * scale);
        *p = v;
      }
    };
    scale_rows(Qm, 64 * 128);
    if constexpr (HD == 80) scale_rows(Qt, 64 * 32);
    fence_proxy_async();
    named_barrier_sync(1 + c, 128);
  }
  const float s_scale = aug ? 1.f : scale;

  // this thread's two query rows (clamped: a ragged tile's rows are never stored)
  const float* rh[2];
  const float* rw[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + c * 64 + warp * 16 + g + 8 * half;
    const size_t row = ((size_t)b * nH + h) * N + (r < N ? r : N - 1);
    rh[half] = rel_h + row * KH;
    rw[half] = rel_w + row * KW;
  }
  // a grid KWA wide: key column 8j + 2t + e of a tile sits in the tile's grid
  // row j / JW at column 8(j % JW) + 2t + e, the same in every tile
  constexpr bool ALIGNED = KWA > 0;
  float wreg[2][ALIGNED ? 2 * JW : 1];
  if constexpr (ALIGNED) {
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int jj = 0; jj < JW; ++jj) {
        const float2 w2 = *reinterpret_cast<const float2*>(rw[half] + 8 * jj + 2 * t);
        wreg[half][2 * jj] = w2.x;
        wreg[half][2 * jj + 1] = w2.y;
      }
  }
  const float inv_kw = 1.f / KW;

  float o[32], ot[HD == 80 ? 8 : 1];  // output: columns 0-63, and 64-79
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (HD == 80 ? 8 : 1); ++i) ot[i] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};
  float sacc[BKT / 2];
#pragma unroll
  for (int i = 0; i < BKT / 2; ++i) sacc[i] = 0.f;

  const uint64_t dq = wgmma_desc(Qm, kSwizzle128B, 16, 1024);
  const uint64_t dqt = wgmma_desc(Qt, kSwizzle32B, 16, 256);

  for (int tile = 0; tile < ntiles; ++tile) {
    const int s = tile % FW_STAGES, k0 = tile * BKT;
    const unsigned parity = (tile / FW_STAGES) & 1;
    // aligned grids: the tile's RPT grid rows' terms, loaded while Q.K^T runs
    float bh[2][RPT];
    if constexpr (ALIGNED) {
      const int r0 = RPT * tile;
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) bh[half][rr] = r0 + rr < KH ? rh[half][r0 + rr] : 0.f;
    }

    // S = Q K^T
    mbar_wait(&full_k[s], parity);
    {
      const uint64_t dk = wgmma_desc(Ks(s), kSwizzle128B, 16, 1024);
      fence_regs(sacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_s_tile(sacc, dq + 2 * kk, dk + 2 * kk, kk != 0);
      if constexpr (HD == 80)
        wgmma_s_tile(sacc, dqt, wgmma_desc(Ks(s) + T::MAIN, kSwizzle32B, 16, 256), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
    }

    // logits: s * scale + bias, keys >= N masked; row max over the tile
    const int live = N - k0;
    float mx[2] = {neg_inf(), neg_inf()};
    if constexpr (ALIGNED) {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          sacc[4 * j + e] = fmaf(sacc[4 * j + e], s_scale,
                                 bh[half][j / JW] + wreg[half][2 * (j % JW) + (e & 1)]);
        }
      if (live < BKT)  // a ragged last tile: mask the keys past N
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (8 * j + 2 * t + (e & 1) >= live) sacc[4 * j + e] = neg_inf();
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sacc[4 * j + e]);
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int half = e >> 1;
          const int kc = 8 * j + 2 * t + (e & 1);
          float v = neg_inf();
          if (kc < live) {
            const int key = k0 + kc;
            const int r = __float2int_rz((key + 0.5f) * inv_kw);
            v = fmaf(sacc[4 * j + e], s_scale, rh[half][r] + rw[half][key - r * KW]);
          }
          sacc[4 * j + e] = v;
          mx[half] = fmaxf(mx[half], v);
        }
    }
    // exp(v - m) = 2^(v log2 e - m log2 e): one FMA and one MUFU op a logit
    // (base 2: the logits are already in units of log2 e)
    constexpr float kLog2e = EXP2 ? 1.f : 1.4426950408889634f;
    float alpha[2], mb[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(m[half], mx[half]);
      alpha[half] = ex2((m[half] - m_new) * kLog2e);  // 0 while m was -inf
      m[half] = m_new;
      mb[half] = -m_new * kLog2e;
    }

    // P = exp(s - m) rounded to bf16 once, packed as the A fragments of P.V;
    // the row sum adds the rounded values
    uint32_t pa[BKT / 16][4];
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const __nv_bfloat162 p =
            __floats2bfloat162_rn(ex2(fmaf(sacc[4 * j + 2 * half], kLog2e, mb[half])),
                                  ex2(fmaf(sacc[4 * j + 2 * half + 1], kLog2e, mb[half])));
        sum[half] += __bfloat162float(p.x) + __bfloat162float(p.y);
        pa[j >> 1][2 * (j & 1) + half] = *reinterpret_cast<const uint32_t*>(&p);
      }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
      sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
      l[half] = l[half] * alpha[half] + sum[half];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
    if constexpr (HD == 80)
#pragma unroll
      for (int i = 0; i < 8; ++i) ot[i] *= alpha[(i >> 1) & 1];

    // O += P V, V read transposed (MN-major) from shared memory: 8-key
    // groups 1024 (256) bytes apart; one atom along the head's columns, so
    // the atom stride is never used (given the same value)
    mbar_wait(&full_v[s], parity);
    fence_regs(o);
    if constexpr (HD == 80) fence_regs(ot);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKT / 16; ++kk) {
      wgmma_rs_n64_tb(o, pa[kk], wgmma_desc(Vs(s) + kk * 16 * 128, kSwizzle128B, 1024, 1024), 1);
      if constexpr (HD == 80)
        wgmma_rs_n16_tb(ot, pa[kk], wgmma_desc(Vs(s) + T::MAIN + kk * 16 * 32, kSwizzle32B, 256, 256),
                        1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    if constexpr (HD == 80) fence_regs(ot);
    if (lane == 0) mbar_arrive(&empty[s]);
    __syncwarp();
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = q0 + c * 64 + warp * 16 + g + 8 * half;
    if (r >= N) continue;
    const float inv = 1.f / l[half];
    if constexpr (SPLIT) {  // fp32 rows of HD
      float* orow = static_cast<float*>(out) + ((size_t)b * N + r) * HD + 2 * t;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      if constexpr (HD == 80)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          *reinterpret_cast<float2*>(orow + 64 + 8 * j) =
              make_float2(ot[4 * j + 2 * half] * inv, ot[4 * j + 2 * half + 1] * inv);
      continue;
    }
    bf16* orow = static_cast<bf16*>(out) + ((size_t)b * N + r) * C + h * HD + 2 * t;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
    if constexpr (HD == 80)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 + 8 * j) =
            __floats2bfloat162_rn(ot[4 * j + 2 * half] * inv, ot[4 * j + 2 * half + 1] * inv);
  }
}

template <int HD, bool EXP2, int REL, bool SPLIT>
int launch_flash(const QkvMaps& maps, const void* rel_h, const void* rel_w, void* out, int B, int N,
                 int C, int num_heads, int kh, int kw, float scale, int aug, cudaStream_t stream) {
  constexpr int smem = FlashTile<HD>::SMEM;
  auto kernel = flash_wgmma_kernel<HD, EXP2, REL, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((N + FW_BQ - 1) / FW_BQ, num_heads, B);
  kernel<<<grid, FW_THREADS, smem, stream>>>(maps, static_cast<const float*>(rel_h),
                                             static_cast<const float*>(rel_w), out, N, C, kh, kw,
                                             scale, aug);
  return cudaGetLastError();
}

// Where a grid's bias terms come from (flash_wgmma_kernel's REL); the
// narrower grids in registers only in K12's form (`split`).
inline int rel_source(int kw, bool split = false) {
  if (kw == 64) return kRelKw64;
  if (kw == 48) return kRelKw48;
  if (split && kw == 32) return kRelKw32;
  if (split && kw == 16) return kRelKw16;
  return kRelGlobal;
}

// The 3-d maps (width, N, B) of the bf16 operands q, k and v (rows of `width`
// elements, 16-byte aligned bases and rows): a 64-column box with the
// 128-byte swizzle, and for a head of 80 a 16-column one with the 32-byte
// swizzle.  Rows past N read zeros.
template <int HD>
int operand_maps(QkvMaps* maps, const void* q, const void* k, const void* v, int width, int N,
                 int B) {
  const void* base[3] = {q, k, v};
  const uint64_t dims[3] = {(uint64_t)width, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)width * 2, (uint64_t)N * width * 2};
  const uint32_t box_main[3] = {64, 64, 1}, box_tail[3] = {16, 64, 1};
  for (int i = 0; i < 3; ++i) {
    int err = make_tensor_map(&maps->main[i], base[i], 3, dims, strides, box_main,
                              CU_TENSOR_MAP_SWIZZLE_128B);
    if (err == 0 && HD == 80)
      err = make_tensor_map(&maps->tail[i], base[i], 3, dims, strides, box_tail,
                            CU_TENSOR_MAP_SWIZZLE_32B);
    else
      maps->tail[i] = maps->main[i];
    if (err != 0) return err;
  }
  return 0;
}

template <int HD>
int launch_flash_mode(int mode, const void* qkv, const void* rel_h, const void* rel_w, void* out,
                      int B, int N, int C, int num_heads, int kh, int kw, float scale,
                      cudaStream_t st) {
  if (mode != kFlashNatural && mode != kFlashExp2 && mode != kFlashAug) return cudaErrorInvalidValue;
  QkvMaps maps;
  const int err = operand_maps<HD>(&maps, qkv, qkv, qkv, 3 * C, N, B);
  if (err != 0) return err;
  const int aug = mode == kFlashAug;
  const int rel = rel_source(kw);
#define SAMRS_FLASH(E, R)                                                                        \
  return launch_flash<HD, E, R, false>(maps, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, \
                                       aug, st)
#define SAMRS_FLASH_REL(E)                       \
  if (rel == kRelKw64) SAMRS_FLASH(E, kRelKw64); \
  if (rel == kRelKw48) SAMRS_FLASH(E, kRelKw48); \
  SAMRS_FLASH(E, kRelGlobal)
  if (mode == kFlashExp2) {
    SAMRS_FLASH_REL(true);
  }
  SAMRS_FLASH_REL(false);
#undef SAMRS_FLASH_REL
#undef SAMRS_FLASH
}

// K12's query-tiled form: split-head q, k, v (B', N, HD) through K2's
// pipeline (natural softmax, fp32 rows out).
template <int HD>
int launch_split_tiled(const void* q, const void* k, const void* v, const void* rel_h,
                       const void* rel_w, void* out, int B, int N, int kh, int kw, float scale,
                       cudaStream_t st) {
  QkvMaps maps;
  const int err = operand_maps<HD>(&maps, q, k, v, HD, N, B);
  if (err != 0) return err;
  switch (rel_source(kw, true)) {
#define SAMRS_SPLIT(R)                                                                     \
  case R:                                                                                  \
    return launch_flash<HD, false, R, true>(maps, rel_h, rel_w, out, B, N, HD, 1, kh, kw, \
                                            scale, 0, st)
    SAMRS_SPLIT(kRelKw64);
    SAMRS_SPLIT(kRelKw48);
    SAMRS_SPLIT(kRelKw32);
    SAMRS_SPLIT(kRelKw16);
#undef SAMRS_SPLIT
    default:
      return launch_flash<HD, false, kRelGlobal, true>(maps, rel_h, rel_w, out, B, N, HD, 1, kh,
                                                       kw, scale, 0, st);
  }
}

// The decomposed rel-pos rows K2 adds, in fp32 from the raw qkv (the q
// columns of head h, read in place; rows `ld` = 3C elements apart), and
// K12's from split-head q (B', N, hd) (one head, rows `ld` = hd apart):
//   rel_h[b, h, x * kw + y, k] = sum_d q[b, x * kw + y, h, d] * Th[x, k, d]
//   rel_w[b, h, x * kw + y, k] = sum_d q[b, x * kw + y, h, d] * Tw[y, k, d]
// Block i < kh takes grid row x = i against Th[x], block kh + y grid column
// y against Tw[y]: the queries sharing one table.  Tiles of 64 queries x 64
// table rows through shared memory (16-byte reads along d), 4 x 4 outputs a
// thread, the dot products in increasing d.  round_out rounds each output to bf16 (the
// "aug" mode).  Bound by fp32 operations (ViT-H: 0.67 G multiply-adds a
// layer); it replaces the einsums the JAX package runs outside its kernel.
__global__ void __launch_bounds__(256)
relpos_rows_kernel(const bf16* __restrict__ qkv, const float* __restrict__ Th,
                   const float* __restrict__ Tw, float* __restrict__ rel_h,
                   float* __restrict__ rel_w, int N, int ld, int hd, int kh, int kw,
                   int round_out) {
  constexpr int LD = 84;  // head dims up to 80; 84-float rows: conflict-free 16-byte reads
  __shared__ __align__(16) float qs[64][LD];
  __shared__ __align__(16) float ts[64][LD];
  const int h = blockIdx.y, b = blockIdx.z, nH = gridDim.y;
  const bool row = blockIdx.x < kh;
  const int sel = row ? blockIdx.x : blockIdx.x - kh;  // the grid row x or column y
  const int nq = row ? kw : kh, K = row ? kh : kw;
  const float* table = (row ? Th : Tw) + (size_t)sel * K * hd;
  float* out = (row ? rel_h : rel_w) + ((size_t)b * nH + h) * N * K;
  const bf16* qbase = qkv + (size_t)b * N * ld + h * hd;
  // this thread's outputs: queries tq + 16 i, table rows tk + 16 j (i, j < 4)
  const int tq = threadIdx.x >> 4, tk = threadIdx.x & 15;
  const int hp = hd / 2, h4 = hd / 4;
  for (int q0 = 0; q0 < nq; q0 += 64) {
    __syncthreads();
    for (int i = threadIdx.x; i < 64 * hp; i += 256) {
      const int qi = i / hp, d = 2 * (i - qi * hp), qq = q0 + qi;
      const int n = row ? sel * kw + qq : qq * kw + sel;
      const float2 v = qq < nq ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                                     qbase + (size_t)n * ld + d))
                               : make_float2(0.f, 0.f);
      qs[qi][d] = v.x;
      qs[qi][d + 1] = v.y;
    }
    for (int k0 = 0; k0 < K; k0 += 64) {
      __syncthreads();
      for (int i = threadIdx.x; i < 64 * h4; i += 256) {
        const int ki = i / h4, d = 4 * (i - ki * h4);
        *reinterpret_cast<float4*>(&ts[ki][d]) =
            k0 + ki < K ? *reinterpret_cast<const float4*>(table + (size_t)(k0 + ki) * hd + d)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
      }
      __syncthreads();
      float acc[4][4] = {};
      for (int d = 0; d < hd; d += 4) {
        float4 a[4], w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          a[i] = *reinterpret_cast<const float4*>(&qs[tq + 16 * i][d]);
          w[i] = *reinterpret_cast<const float4*>(&ts[tk + 16 * i][d]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {  // increasing d
            float s = acc[i][j];
            s = fmaf(a[i].x, w[j].x, s);
            s = fmaf(a[i].y, w[j].y, s);
            s = fmaf(a[i].z, w[j].z, s);
            acc[i][j] = fmaf(a[i].w, w[j].w, s);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qq = q0 + tq + 16 * i;
        if (qq >= nq) continue;
        const int n = row ? sel * kw + qq : qq * kw + sel;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int k = k0 + tk + 16 * j;
          if (k >= K) continue;
          float v = acc[i][j];
          if (round_out) v = __bfloat162float(__float2bfloat16_rn(v));
          out[(size_t)n * K + k] = v;
        }
      }
    }
  }
}

}  // namespace
}  // namespace samrs

extern "C" {

// qkv (B, N, 3C) bf16; rel_h (B, nH, N, kh) and rel_w (B, nH, N, kw) fp32
// with N = kh * kw -> out (B, N, C) bf16.  mode: 0 natural softmax ("m",
// "split"), 1 base 2 ("exp2": log2 e already in scale and the rel rows),
// 2 "aug" (q * scale rounded to bf16 before the product).  qkv must be
// 16-byte aligned and 3C a multiple of 8 (the TMA's rules).
int samrs_flash_attention_relpos(const void* qkv, const void* rel_h, const void* rel_w, void* out,
                                 int B, int N, int C, int num_heads, int head_dim, int kh, int kw,
                                 float scale, int mode, void* stream) {
  using namespace samrs;
  if (B <= 0 || N <= 0 || kh <= 0 || kw <= 0 || kh * kw != N || num_heads * head_dim != C ||
      (3 * C) % 8 != 0 || reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80)
    return launch_flash_mode<80>(mode, qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  if (head_dim == 64)
    return launch_flash_mode<64>(mode, qkv, rel_h, rel_w, out, B, N, C, num_heads, kh, kw, scale, st);
  return cudaErrorInvalidValue;
}

// qkv (B, N, 3C) bf16 with N = kh * kw; Th (kh, kh, hd), Tw (kw, kw, hd)
// fp32 -> rel_h (B, nH, N, kh), rel_w (B, nH, N, kw) fp32 (rounded to bf16
// values with round_out).  head_dim <= 80.
int samrs_relpos_rows(const void* qkv, const void* Th, const void* Tw, void* rel_h, void* rel_w,
                      int B, int N, int C, int num_heads, int head_dim, int kh, int kw,
                      int round_out, void* stream) {
  using namespace samrs;
  if (B <= 0 || kh <= 0 || kw <= 0 || kh * kw != N || num_heads * head_dim != C ||
      head_dim > 80 || head_dim % 4 != 0 || head_dim <= 0)
    return cudaErrorInvalidValue;
  dim3 grid(kh + kw, num_heads, B);
  relpos_rows_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(qkv), static_cast<const float*>(Th), static_cast<const float*>(Tw),
      static_cast<float*>(rel_h), static_cast<float*>(rel_w), N, 3 * C, head_dim, kh, kw,
      round_out);
  return cudaGetLastError();
}

// K12's query-tiled form: q, k, v (B', N, head_dim) bf16 (16-byte aligned
// bases), rel_h (B', N, kh) and rel_w (B', N, kw) fp32 with N = kh * kw ->
// out (B', N, head_dim) fp32.  head_dim 64 or 80; B' <= 65535 (the grid's
// third dimension); N < 2^22 (keys split into grid row and column by a
// float reciprocal).
int samrs_split_attention_tiled(const void* q, const void* k, const void* v, const void* rel_h,
                                const void* rel_w, void* out, int B, int N, int head_dim, int kh,
                                int kw, float scale, void* stream) {
  using namespace samrs;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (B <= 0 || B > 65535 || N <= 0 || N >= (1 << 22) || kh <= 0 || kw <= 0 || kh * kw != N ||
      bases % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return launch_split_tiled<80>(q, k, v, rel_h, rel_w, out, B, N, kh, kw, scale, st);
  if (head_dim == 64) return launch_split_tiled<64>(q, k, v, rel_h, rel_w, out, B, N, kh, kw, scale, st);
  return cudaErrorInvalidValue;
}

// K12's rel rows on any grid: split-head q (B', N, head_dim) bf16 with
// N = kh * kw, Th (kh, kh, head_dim), Tw (kw, kw, head_dim) fp32 (16-byte
// aligned) -> rel_h (B', N, kh), rel_w (B', N, kw) fp32; relpos_rows_kernel
// with one head a row of B'.  head_dim 64 or 80; B' <= 65535.
int samrs_split_relpos_rows(const void* q, const void* Th, const void* Tw, void* rel_h,
                            void* rel_w, int B, int N, int head_dim, int kh, int kw,
                            void* stream) {
  using namespace samrs;
  const uintptr_t tables = reinterpret_cast<uintptr_t>(Th) | reinterpret_cast<uintptr_t>(Tw);
  if (B <= 0 || B > 65535 || kh <= 0 || kw <= 0 || kh * kw != N ||
      (head_dim != 64 && head_dim != 80) || reinterpret_cast<uintptr_t>(q) % 4 != 0 ||
      tables % 16 != 0)
    return cudaErrorInvalidValue;
  relpos_rows_kernel<<<dim3(kh + kw, 1, B), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(Th), static_cast<const float*>(Tw),
      static_cast<float*>(rel_h), static_cast<float*>(rel_w), N, head_dim, head_dim, kh, kw, 0);
  return cudaGetLastError();
}

}  // extern "C"
