// K11: the transformer MLP in fp32 on the tensor cores, with split-TF32
// operands ("3xTF32").
//
//   out = gelu_erf(x . W1^T + b1) . W2^T + b2
//
// x (T, C), out (T, C); W1 (M, C), b1 (M), W2 (C, M), b2 (C) in nn.Linear's
// layout; all fp32 and contiguous.  C 96 (Swin-T's first stage) or a
// multiple of 64 (the vit_b / l / h widths 768 / 1024 / 1280, InternImage-T's
// and ViTAEv2-S's 64 / 128 / 256 / 512, Swin-T's 192 / 384 / 768), M a
// multiple of 64, any T.
//
// Replaces samrs_tpu/kernels/fused_mlp.py::_fused_pallas (its pallas_call,
// body _kernel), the forward of fused_mlp that every seg-ViT and InternImage
// MLP block calls.
//
// Arithmetic.  fp32 FFMA on the CUDA cores peaks at 67 TFLOP/s; a one-pass
// TF32 product keeps 11 bits of each operand and falls outside the 1e-5 the
// port holds K11 to (tests/test_torch_port_hopper_math.py models both).
// Each operand is split as a = hi + lo, hi = a rounded to tf32 (cvt.rna),
// lo = a - hi (which the tensor core reads as tf32, dropping its low 13
// bits), and each 8-deep k-step adds lo.B_hi + hi.B_lo + hi.B_hi (small
// terms first; the lo.lo term is below fp32's rounding): three tf32 wgmmas
// for one fp32 product, at up to 495 / 3 = 165 TFLOP/s.  The tensor core
// adds into its fp32 accumulator rounding toward zero, which biases a long
// chain: with one accumulator over all of K the output landed 2.6e-5 from
// the fp32 plain version at vit_b (K 768 and 3072).  So each 32-deep
// stage's 12 wgmmas go into a fresh partial sum, added to the running sum
// in fp32 registers (round to nearest) once the stage is done (1.2e-6).
// The weights' halves come from tf32_split_kernel, once per weight version
// (the wrapper keeps them); the activations are split in registers, right
// before the wgmmas, and fed as the register A operand.  GELU is the exact
// erf form, once per hidden element, as in the TPU kernel's oracle and
// F.gelu.
//
// Structure.  At C 64 / 96 / 128 (InternImage-T's and ViTAEv2-S's levels 0
// and 1, Swin-T's stage 0) one persistent kernel, mlp_fused_kernel, keeps
// the hidden on chip, as the TPU kernel does: a block takes a 128-token
// tile of x into shared memory once and walks the hidden in 64-column
// chunks; each chunk's lin1 (K = C) goes into registers, gets its bias and
// GELU there, and is moved by quad shuffles from the accumulator layout into
// the register A fragments of lin2 (K = the chunk's 64 columns), whose
// products add into the 64 x C output accumulator (wgmma m64nCk8; tf32 takes
// any N that is a multiple of 8, so C 96 is three 32-deep stages of lin1 and
// an m64n96k8 lin2).  Per thread that is C / 2 output registers, C / 2 for the
// stage's partial sum (lin1 uses 32 of them), 32 for the hidden chunk and
// 16 for the split fragments.  A block of two consumer warpgroups and a
// producer warp (288 threads) puts three warps on one of the SM's four
// register files, which caps a thread at 168 registers; two other forms
// measured slower on the card (NVIDIA H100 80GB HBM3 at 700 W): splitting
// a stage's second half while its first half's wgmmas run (more spills),
// and 256 threads with thread 0 feeding the ring (255 registers, but warp
// 0 waits for the others at every stage).  The producer warp streams each
// chunk's W1 rows and W2 columns (hi and lo) through a ring of 32-deep
// stages with TMA; the token tile has its own
// buffer, freed after the last chunk's lin1.  The additions are those of
// the two-launch form below in the same order (per 32-deep stage partial
// sums, added in k order), so the two forms give equal bits.
//
// At C >= 256 the output tile does not fit beside the hidden: a 64-row
// output tile at C 768-1280 is 384-640 fp32 registers a thread of one
// warpgroup, at C 256 / 512 128 / 256, with a partial sum of the same size
// beside it.  There K11 is two launches of one persistent GEMM,
// mlp_tf32x3_kernel: lin1 (A = x, B = W1, bias + GELU epilogue) writes the
// fp32 hidden (T, M) to device memory, lin2 (A = hidden, B = W2, bias
// epilogue) reads it back (vit_b 512^2: 201 MB, ~0.06 ms at 3.35 TB/s).
// Both products are K-major as they stand (x and W1 along C, the hidden and
// W2 along M), which tf32 wgmma requires, so nothing is transposed.  One
// block of 384 threads an SM: a producer warp keeps a ring of 32-deep
// stages in flight with TMA (the A tile, 128 rows x 32 fp32, and the B
// tile's hi and lo halves, BN rows x 32 fp32, all with the 128-byte
// swizzle), and gives its registers to two consumer warpgroups, each
// multiplying 64 rows x BN (BN 128 or 64, whichever leaves fewer idle SMs
// in the last wave) with wgmma m64nBNk8.  A consumer takes a stage in two
// halves: it loads the A fragments of two 8-deep slices from shared memory,
// splits them, issues their six wgmmas and waits for them (the A registers
// must not change while a wgmma reads them; halves keep the running sum,
// the partial sum and the fragments within 168 registers), then frees the
// stage and adds the partial sum; the two warpgroups' waits interleave on
// the tensor cores.  The epilogue adds the bias (and GELU) to the
// accumulators and stores fp32 pairs straight to device memory while the
// producer already loads the next tile.  At vit_b the kernel without its
// products still took 0.458 of 0.731 ms: the ring's re-reads of A and of
// B's two halves from L2 (3.5 GB a call) bound it before the tensor cores
// (chip_breakdown.py --what mlp_gather; NVIDIA H100 80GB HBM3 at 700 W, as
// every time here).  The caller picks the form (fused_mlp.hidden_on_chip).
//
// Bound on the H100: the split-TF32 tensor work, 3 x 4 T C M operations at
// 495 TFLOP/s (vit_b 512^2, batch 8: T 8192, C 768, M 3072: 0.469 ms;
// each InternImage-T level at the FAST head: 0.081 ms); the fp32 CUDA-core
// bound of the same function is 4 T C M at 67 TFLOP/s (1.154 ms at vit_b).
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int MT_BM = 128;       // rows of an output tile (two consumer warpgroups of 64)
constexpr int MT_BK = 32;        // depth of a stage: 32 fp32 (128 bytes), one swizzle row
constexpr int MT_THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int MT_SMEM_MAX = 232448;
constexpr int FU_HN = 64;        // hidden columns of a chunk of the fused form
constexpr int FU_THREADS = 288;  // fused form: two consumer warpgroups, then the producer warp

// Shared memory of a block: the ring of stages (A, B hi, B lo), then the
// barriers; as many stages as fit, at most 8.
template <int BN>
struct Tf32Tile {
  static constexpr int A_BYTES = MT_BM * MT_BK * 4;
  static constexpr int B_BYTES = BN * MT_BK * 4;  // one half; a multiple of the 1024-byte atom
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT = (MT_SMEM_MAX - 1024 - BAR_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(STAGES >= 3 && (BN == 64 || BN == 128), "tile");
};

// Shared memory of a fused-form block: the token tile (C / 32 slabs of 128
// rows x 32 fp32), the ring of stages (a B tile's hi half, then its lo half
// HALF bytes on: a chunk's W1 rows, FU_HN x 32, or its W2 columns, C x 32),
// then the barriers.
template <int C>
struct FusedTile {
  static constexpr int X_SLAB = MT_BM * MT_BK * 4;
  static constexpr int X_BYTES = C / MT_BK * X_SLAB;
  static constexpr int W1_HALF = FU_HN * MT_BK * 4;
  static constexpr int W2_HALF = C * MT_BK * 4;
  static constexpr int HALF = W1_HALF > W2_HALF ? W1_HALF : W2_HALF;
  static constexpr int STAGE_BYTES = 2 * HALF;
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT = (MT_SMEM_MAX - 1024 - X_BYTES - BAR_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 8 ? FIT : 8;
  static constexpr int SMEM = 1024 + X_BYTES + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(STAGES >= 3 && (C == 64 || C == 96 || C == 128), "tile");
};

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&acc)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t db, int scale_d) {
  if constexpr (BN == 128) wgmma_rs_tf32_n128(acc, a, db, scale_d);
  else if constexpr (BN == 96) wgmma_rs_tf32_n96(acc, a, db, scale_d);
  else wgmma_rs_tf32_n64(acc, a, db, scale_d);
}

// Keeps the split A fragments in their registers until the wgmmas reading
// them are known to be done (call after the wait).
__device__ __forceinline__ void keep_regs(uint32_t (&r)[2][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// The split A fragments of the 8-deep slices 2h and 2h + 1 of a 32-deep
// stage, for this thread's rows r0 and r0 + 8, read from a tile of 32 fp32
// a row with the 128-byte swizzle ((row r, column cc) at r * 128 + ((cc / 4)
// ^ (r % 8)) * 16 + (cc % 4) * 4).
__device__ __forceinline__ void split_a_smem(const unsigned char* st, int r0, int t, int h,
                                             uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + (e & 1) * 8, cc = 16 * h + 8 * k + t + (e >> 1) * 4;
      const float a = *reinterpret_cast<const float*>(
          st + r * 128 + (((cc >> 2) ^ (r & 7)) << 4) + (cc & 3) * 4);
      hi[k][e] = tf32_rna(a);
      lo[k][e] = __float_as_uint(a - __uint_as_float(hi[k][e]));
    }
  }
}

// The split A fragments of the 8-deep slices s and s + 1 of a 64 x 64
// block held in the accumulator layout (v[4j + 0 / 1]: row g, columns 8j +
// 2t, + 1; v[4j + 2 / 3]: row g + 8): lane t of a quad takes columns t and
// t + 4 of a slice from lanes t / 2 and 2 + t / 2 of its quad.  s must be
// known once the caller's loops are unrolled (v stays in registers).
__device__ __forceinline__ void split_a_regs(const float (&v)[32], int s, int lane,
                                             uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
  const int t = lane & 3, quad = lane & ~3;
  const int src[2] = {quad | (t >> 1), quad | (2 + (t >> 1))};
#pragma unroll
  for (int k = 0; k < 2; ++k) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * (s + k) + 2 * (e & 1);
      const float even = __shfl_sync(0xffffffffu, v[i], src[e >> 1]);
      const float odd = __shfl_sync(0xffffffffu, v[i + 1], src[e >> 1]);
      const float a = (t & 1) ? odd : even;
      hi[k][e] = tf32_rna(a);
      lo[k][e] = __float_as_uint(a - __uint_as_float(hi[k][e]));
    }
  }
}

// The six wgmmas of the slices 2h and 2h + 1 of a stage into its partial
// sum `part` (the stage's first product overwrites it), then the wait: the
// A registers are reused once those wgmmas are done.
template <int BN>
__device__ __forceinline__ void mma_split(float (&part)[BN / 2], uint32_t (&hi)[2][4],
                                          uint32_t (&lo)[2][4], uint64_t dbh, uint64_t dbl,
                                          int h) {
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // small terms first
    const int ks = 2 * h + k;
    wgmma_tf32<BN>(part, lo[k], dbh + 2 * ks, ks != 0);
    wgmma_tf32<BN>(part, hi[k], dbl + 2 * ks, 1);
    wgmma_tf32<BN>(part, hi[k], dbh + 2 * ks, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
  keep_regs(hi);
  keep_regs(lo);
}

// out[T, N] = A[T, K] . B[N, K]^T + bias[N] (-> gelu), fp32, with B given
// as its tf32 halves (B = hi + lo) behind tmBh / tmBl (box 32 x BN) and A
// behind tmA (box 32 x 128).  Requires K % 32 == 0 and N % BN == 0 (checked
// by the host entry); a ragged last row tile loads zeros and its stores are
// masked.
template <int BN, bool GELU>
__global__ void __launch_bounds__(MT_THREADS, 1)
mlp_tf32x3_kernel(const __grid_constant__ CUtensorMap tmA, const __grid_constant__ CUtensorMap tmBh,
                  const __grid_constant__ CUtensorMap tmBl, const float* __restrict__ bias,
                  float* __restrict__ out, int T, int N, int K) {
  using G = Tf32Tile<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));  // the swizzle atoms need 1024-byte alignment
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  const int wg = threadIdx.x >> 7;
  const int tiles_m = (T + MT_BM - 1) / MT_BM;
  const int tiles = tiles_m * (N / BN);
  const int KT = K / MT_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; the TMA bytes complete it
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&tmA);
      tma_prefetch_map(&tmBh);
      tma_prefetch_map(&tmBl);
      int stage = 0;
      unsigned phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = (tile % tiles_m) * MT_BM, n0 = (tile / tiles_m) * BN;
        for (int kb = 0; kb < KT; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = smem + stage * G::STAGE_BYTES;
          mbar_expect_tx(&full[stage], G::STAGE_BYTES);
          tma_load_2d(st, &tmA, &full[stage], kb * MT_BK, m0);
          tma_load_2d(st + G::A_BYTES, &tmBh, &full[stage], kb * MT_BK, n0);
          tma_load_2d(st + G::A_BYTES + G::B_BYTES, &tmBl, &full[stage], kb * MT_BK, n0);
          if (++stage == G::STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {  // consumers: warpgroup c multiplies rows 64c .. 64c + 63 of each tile
    setmaxnreg_inc<232>();
    const int c = wg - 1;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = c * 64 + warp * 16 + g;  // this thread's A rows r0 and r0 + 8 of the tile
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    unsigned phase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = (tile % tiles_m) * MT_BM, n0 = (tile / tiles_m) * BN;
      for (int kb = 0; kb < KT; ++kb) {
        mbar_wait(&full[stage], phase);
        const unsigned char* st = smem + stage * G::STAGE_BYTES;
        const uint64_t dbh = wgmma_desc_f32(st + G::A_BYTES);
        const uint64_t dbl = wgmma_desc_f32(st + G::A_BYTES + G::B_BYTES);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          uint32_t hi[2][4], lo[2][4];
          split_a_smem(st, r0, t, h, hi, lo);
          mma_split<BN>(part, hi, lo, dbh, dbl, h);
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        __syncwarp();
        if (++stage == G::STAGES) stage = 0, phase ^= 1;
        // the tensor core adds into its accumulator rounding toward zero; a
        // chain of 12 such adds a stage, then one round-to-nearest fp32 add
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = kb == 0 ? part[i] : acc[i] + part[i];
      }

      // epilogue: bias (+ GELU), fp32 pairs straight to device memory
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + j * 8 + 2 * t;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + r0 + 8 * half;
          float v0 = acc[4 * j + 2 * half] + bv.x, v1 = acc[4 * j + 2 * half + 1] + bv.y;
          if constexpr (GELU) {
            v0 = gelu_erf(v0);
            v1 = gelu_erf(v1);
          }
          if (row < T)
            *reinterpret_cast<float2*>(out + (size_t)row * N + col) = make_float2(v0, v1);
        }
      }
    }
  }
}

// out = gelu(x . W1^T + b1) . W2^T + b2 with the hidden on chip, for C 64 /
// 96 / 128: tmX (box 32 x 128 over x (T, C)), tmW1h / tmW1l (box 32 x FU_HN over
// W1 (M, C)), tmW2h / tmW2l (box 32 x C over W2 (C, M)); M % FU_HN == 0.
// A ragged last token tile loads zeros and its stores are masked.
template <int C>
__global__ void __launch_bounds__(FU_THREADS, 1)
mlp_fused_kernel(const __grid_constant__ CUtensorMap tmX,
                 const __grid_constant__ CUtensorMap tmW1h,
                 const __grid_constant__ CUtensorMap tmW1l,
                 const __grid_constant__ CUtensorMap tmW2h,
                 const __grid_constant__ CUtensorMap tmW2l,
                 const float* __restrict__ b1, const float* __restrict__ b2,
                 float* __restrict__ out, int T, int M) {
  using G = FusedTile<C>;
  constexpr int KC = C / MT_BK;      // lin1 stages of a chunk
  constexpr int KH = FU_HN / MT_BK;  // lin2 stages of a chunk
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));
  unsigned char* xs = smem;
  unsigned char* ring = smem + G::X_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + G::STAGES * G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  uint64_t* x_full = empty + G::STAGES;
  uint64_t* x_empty = x_full + 1;
  const int tiles = (T + MT_BM - 1) / MT_BM;
  const int chunks = M / FU_HN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init(x_full, 1);
    mbar_init(x_empty, 8);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // producer warp
    if (threadIdx.x == 256) {
      tma_prefetch_map(&tmX);
      tma_prefetch_map(&tmW1h);
      tma_prefetch_map(&tmW1l);
      tma_prefetch_map(&tmW2h);
      tma_prefetch_map(&tmW2l);
      int stage = 0;
      unsigned phase = 0, xphase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        mbar_wait(x_empty, xphase ^ 1);
        mbar_expect_tx(x_full, G::X_BYTES);
#pragma unroll
        for (int s = 0; s < KC; ++s)
          tma_load_2d(xs + s * G::X_SLAB, &tmX, x_full, s * MT_BK, tile * MT_BM);
        xphase ^= 1;
        for (int j = 0; j < chunks; ++j) {
          for (int kb = 0; kb < KC + KH; ++kb) {
            mbar_wait(&empty[stage], phase ^ 1);
            unsigned char* st = ring + stage * G::STAGE_BYTES;
            if (kb < KC) {  // W1 rows of the chunk, columns of the stage
              mbar_expect_tx(&full[stage], 2 * G::W1_HALF);
              tma_load_2d(st, &tmW1h, &full[stage], kb * MT_BK, j * FU_HN);
              tma_load_2d(st + G::HALF, &tmW1l, &full[stage], kb * MT_BK, j * FU_HN);
            } else {  // all of W2's rows, the chunk's columns of the stage
              const int k0 = j * FU_HN + (kb - KC) * MT_BK;
              mbar_expect_tx(&full[stage], 2 * G::W2_HALF);
              tma_load_2d(st, &tmW2h, &full[stage], k0, 0);
              tma_load_2d(st + G::HALF, &tmW2l, &full[stage], k0, 0);
            }
            if (++stage == G::STAGES) stage = 0, phase ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup c takes rows 64c .. 64c + 63 of each tile
    const int c = threadIdx.x >> 7;
    const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = c * 64 + warp * 16 + g;
    float acc[C / 2], part[C / 2], hid[FU_HN / 2];
    float (&part1)[FU_HN / 2] = *reinterpret_cast<float (*)[FU_HN / 2]>(part);
#pragma unroll
    for (int i = 0; i < C / 2; ++i) acc[i] = 0.f;
    int stage = 0;
    unsigned phase = 0, xphase = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int m0 = tile * MT_BM;
      mbar_wait(x_full, xphase);
      xphase ^= 1;
      for (int j = 0; j < chunks; ++j) {
        // lin1: the chunk's 64 hidden columns over K = C
#pragma unroll
        for (int kb = 0; kb < KC; ++kb) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * G::STAGE_BYTES;
          const uint64_t dbh = wgmma_desc_f32(st), dbl = wgmma_desc_f32(st + G::HALF);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t hi[2][4], lo[2][4];
            split_a_smem(xs + kb * G::X_SLAB, r0, t, h, hi, lo);
            mma_split<FU_HN>(part1, hi, lo, dbh, dbl, h);
          }
          if (lane == 0) mbar_arrive(&empty[stage]);
          __syncwarp();
          if (++stage == G::STAGES) stage = 0, phase ^= 1;
#pragma unroll
          for (int i = 0; i < FU_HN / 2; ++i) hid[i] = kb == 0 ? part1[i] : hid[i] + part1[i];
        }
        if (j == chunks - 1) {  // the token tile is read for the last time
          if (lane == 0) mbar_arrive(x_empty);
          __syncwarp();
        }
#pragma unroll
        for (int jj = 0; jj < FU_HN / 8; ++jj) {
          const float2 bv = __ldg(reinterpret_cast<const float2*>(b1 + j * FU_HN + jj * 8 + 2 * t));
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            hid[4 * jj + 2 * half] = gelu_erf(hid[4 * jj + 2 * half] + bv.x);
            hid[4 * jj + 2 * half + 1] = gelu_erf(hid[4 * jj + 2 * half + 1] + bv.y);
          }
        }
        // lin2: the output over K = the chunk's hidden columns
#pragma unroll
        for (int kb = 0; kb < KH; ++kb) {
          mbar_wait(&full[stage], phase);
          const unsigned char* st = ring + stage * G::STAGE_BYTES;
          const uint64_t dbh = wgmma_desc_f32(st), dbl = wgmma_desc_f32(st + G::HALF);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t hi[2][4], lo[2][4];
            split_a_regs(hid, 4 * kb + 2 * h, lane, hi, lo);
            mma_split<C>(part, hi, lo, dbh, dbl, h);
          }
          if (lane == 0) mbar_arrive(&empty[stage]);
          __syncwarp();
          if (++stage == G::STAGES) stage = 0, phase ^= 1;
          const bool first = j == 0 && kb == 0;
#pragma unroll
          for (int i = 0; i < C / 2; ++i) acc[i] = first ? part[i] : acc[i] + part[i];
        }
      }

      // epilogue: bias, fp32 pairs straight to device memory
#pragma unroll
      for (int jj = 0; jj < C / 8; ++jj) {
        const int col = jj * 8 + 2 * t;
        const float2 bv = __ldg(reinterpret_cast<const float2*>(b2 + col));
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = m0 + r0 + 8 * half;
          if (row < T)
            *reinterpret_cast<float2*>(out + (size_t)row * C + col) =
                make_float2(acc[4 * jj + 2 * half] + bv.x, acc[4 * jj + 2 * half + 1] + bv.y);
        }
      }
    }
  }
}

// The tile width of the N side: of 128 and 64, the one whose waves of tiles
// over the SMs take the least time (a wave's time grows with the width), the
// wider on a tie; 64 where 128 does not divide N.
int pick_bn(int T, int N) {
  if (N % 128) return 64;
  const int sms = sm_count(), tiles_m = (T + MT_BM - 1) / MT_BM;
  auto cost = [&](int bn) {
    const long tiles = (long)tiles_m * (N / bn);
    return (tiles + sms - 1) / sms * bn;
  };
  return cost(64) < cost(128) ? 64 : 128;
}

// A 2-d fp32 tensor map of a (rows, cols) row-major tensor, box (32, box_rows),
// 128-byte swizzle.
int f32_map(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  const uint64_t dims[2] = {(uint64_t)cols, (uint64_t)rows};
  const uint64_t stride[1] = {(uint64_t)cols * 4};
  const uint32_t box[2] = {MT_BK, (uint32_t)box_rows};
  return make_tensor_map(map, base, 2, dims, stride, box, CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <int BN, bool GELU>
int launch_tf32x3(const void* A, const void* Bh, const void* Bl, const void* bias, void* out, int T,
                  int N, int K, cudaStream_t stream) {
  using G = Tf32Tile<BN>;
  CUtensorMap tmA, tmBh, tmBl;
  int err = f32_map(&tmA, A, T, K, MT_BM);
  if (err == 0) err = f32_map(&tmBh, Bh, N, K, BN);
  if (err == 0) err = f32_map(&tmBl, Bl, N, K, BN);
  if (err != 0) return err;
  auto kernel = mlp_tf32x3_kernel<BN, GELU>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((T + MT_BM - 1) / MT_BM) * (N / BN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, MT_THREADS, G::SMEM, stream>>>(tmA, tmBh, tmBl, static_cast<const float*>(bias),
                                                static_cast<float*>(out), T, N, K);
  return cudaGetLastError();
}

template <bool GELU>
int launch_linear(const void* A, const void* Bh, const void* Bl, const void* bias, void* out, int T,
                  int N, int K, cudaStream_t stream) {
  if (pick_bn(T, N) == 64) return launch_tf32x3<64, GELU>(A, Bh, Bl, bias, out, T, N, K, stream);
  return launch_tf32x3<128, GELU>(A, Bh, Bl, bias, out, T, N, K, stream);
}

template <int C>
int launch_fused(const void* x, const void* w1h, const void* w1l, const void* b1, const void* w2h,
                 const void* w2l, const void* b2, void* out, int T, int M, cudaStream_t stream) {
  using G = FusedTile<C>;
  CUtensorMap tmX, tmW1h, tmW1l, tmW2h, tmW2l;
  int err = f32_map(&tmX, x, T, C, MT_BM);
  if (err == 0) err = f32_map(&tmW1h, w1h, M, C, FU_HN);
  if (err == 0) err = f32_map(&tmW1l, w1l, M, C, FU_HN);
  if (err == 0) err = f32_map(&tmW2h, w2h, C, M, C);
  if (err == 0) err = f32_map(&tmW2l, w2l, C, M, C);
  if (err != 0) return err;
  auto kernel = mlp_fused_kernel<C>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = (T + MT_BM - 1) / MT_BM;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  kernel<<<grid, FU_THREADS, G::SMEM, stream>>>(
      tmX, tmW1h, tmW1l, tmW2h, tmW2l, static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<float*>(out), T, M);
  return cudaGetLastError();
}

// hi = w rounded to tf32, lo = w - hi; four values a thread and step.
__global__ void __launch_bounds__(256)
tf32_split_kernel(const float4* __restrict__ w, float4* __restrict__ hi, float4* __restrict__ lo,
                  long long n4) {
  for (long long i = (long long)blockIdx.x * 256 + threadIdx.x; i < n4;
       i += (long long)gridDim.x * 256) {
    const float4 v = w[i];
    const float4 h = make_float4(__uint_as_float(tf32_rna(v.x)), __uint_as_float(tf32_rna(v.y)),
                                 __uint_as_float(tf32_rna(v.z)), __uint_as_float(tf32_rna(v.w)));
    hi[i] = h;
    lo[i] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
  }
}

}  // namespace
}  // namespace samrs

extern "C" {

// The tf32 halves of an fp32 tensor of n values (n % 4 == 0, 16-byte
// aligned): hi = tf32_rna(w), lo = w - hi.
int samrs_tf32_split(const void* w, void* hi, void* lo, long long n, void* stream) {
  using namespace samrs;
  if (n <= 0 || n % 4 != 0) return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  long long blocks = (n4 + 255) / 256;
  if (blocks > 4 * sm_count()) blocks = 4 * sm_count();
  tf32_split_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(w), static_cast<float4*>(hi), static_cast<float4*>(lo), n4);
  return cudaGetLastError();
}

// out = gelu(x . W1^T + b1) . W2^T + b2: x (T, C), W1 (M, C) as its halves
// w1h / w1l, b1 (M), W2 (C, M) as w2h / w2l, b2 (C), out (T, C); fp32,
// contiguous, 16-byte aligned; M a multiple of 64.  on_chip = 1 (C 64, 96
// or 128): one launch of the fused form, `hidden` unused; on_chip = 0 (C a
// multiple of 64): two launches, lin1 + GELU into the (T, M) scratch
// `hidden`, lin2 into out.
int samrs_fused_mlp(const void* x, const void* w1h, const void* w1l, const void* b1,
                    const void* w2h, const void* w2l, const void* b2, void* hidden, void* out,
                    int T, int C, int M, int on_chip, void* stream) {
  using namespace samrs;
  if (T <= 0 || C <= 0 || M <= 0 || M % 64 != 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (on_chip) {
    if (C == 64) return launch_fused<64>(x, w1h, w1l, b1, w2h, w2l, b2, out, T, M, st);
    if (C == 96) return launch_fused<96>(x, w1h, w1l, b1, w2h, w2l, b2, out, T, M, st);
    if (C == 128) return launch_fused<128>(x, w1h, w1l, b1, w2h, w2l, b2, out, T, M, st);
    return cudaErrorInvalidValue;
  }
  if (C % 64 != 0) return cudaErrorInvalidValue;
  int err = launch_linear<true>(x, w1h, w1l, b1, hidden, T, M, C, st);
  if (err != 0) return err;
  return launch_linear<false>(hidden, w2h, w2l, b2, out, T, C, M, st);
}

}  // extern "C"
