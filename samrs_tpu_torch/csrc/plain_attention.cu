// K10: plain softmax attention in fp32 (no bias), on the tensor cores with
// split-TF32 operands.
//
//   out[bh] = softmax((q[bh] * scale) . k[bh]^T) . v[bh]
//
// q, k, v, out (BH, N, D) fp32, contiguous; D in {64, 80}; any N.
//
// Replaces samrs_tpu/kernels/flash_attention.py::_plain_fwd_pallas (its
// pallas_call, body _flash_kernel), the forward of flash_attention_plain that
// the seg ViTs' full-attention blocks call.  The TPU kernel keeps all N keys
// of a head in VMEM and sums the softmax rows with a ones lane appended to V
// (a matrix-unit trick); neither carries over.
//
// Bound on the H100.  4 N^2 D operations a head (vit_b 512^2, batch 8: BH
// 96, N 1024, D 64, 25.8 GFLOP): 0.385 ms as fp32 on the CUDA cores at 67
// TFLOP/s, where the first version (a 16 x 16 thread grid a 64-query block,
// fp32 FMAs, no double buffering) took 0.95-0.99 ms.  A one-pass TF32
// product keeps 11 bits of each operand, too few for the 1e-5 the port holds
// K10 to; so, as in K11 (csrc/fused_mlp.cu), each fp32 operand is split as a
// = hi + lo (hi = cvt.rna.tf32, lo = a - hi, read by the tensor core with its
// low 13 bits dropped) and each 8-deep step adds lo.B_hi + hi.B_lo + hi.B_hi
// (small terms first): three tf32 wgmmas for one fp32 product, 3 x 4 N^2 D
// operations at 495 TFLOP/s (0.156 ms at vit_b).  The tensor core adds into
// its accumulator rounding toward zero, so each 32-deep part of Q.K^T and
// each 64-key tile's P.V go into a fresh partial sum, added to the fp32
// running sums on the CUDA cores (one accumulator over all keys drifts past
// 1e-5: tests/test_torch_port_gather_attention.py models both).
//
// tf32 wgmma takes no transposed operand, and P.V contracts over keys, so V
// must reach shared memory K-major (V^T).  A pre-pass, kv_split_kernel,
// writes for every 64-key tile of a head one contiguous stage image: K's hi
// and lo halves (64 keys x D, in 32-wide slabs) and V^T's (D x 64 keys, in
// two 32-key slabs), each slab laid out as the TMA's 128-byte swizzle would
// lay it (row r, 16-byte chunk j at r * 128 + (j ^ r % 8) * 16), zeros past
// N and past D.  Within every 8-deep group the contraction index is
// permuted (logical t <-> physical 2t, logical t + 4 <-> physical 2t + 1):
// the register A fragment of a thread (rows g, g + 8; logical columns t, t +
// 4) is then physical columns 2t, 2t + 1 -- one 8-byte load of q, and
// exactly the two columns a wgmma accumulator hands the thread, so the
// probabilities become P.V's A operand in place, with no shuffles.  The
// split runs once per head; splitting inside the attention kernel would
// repeat it for every 128-query block (8 times a head at N 1024) on the CUDA
// cores the softmax already keeps busy.
//
// plain_attention_kernel: one block of two warpgroups (64 query rows each)
// per 128 queries of a head, blocks of a head adjacent in the grid (its K
// and V stay in L2).  Thread 0 loads the first stages with bulk copies
// (cp.async.bulk, the TMA engine) into a ring of 2-3 stages guarded by
// mbarriers; the last warp through a stage's P.V refills it (no producer
// warp: its registers go to the consumers, 255 a thread; 253 used at D 64,
// 255 and 160 bytes of spills at D 80).  Each warpgroup
// keeps its q * scale split in registers (the A operand of S = Q.K^T,
// m64n64k8), takes the online softmax on S's accumulators in fp32 (running
// max and row sum per row, expf, the output rescaled when the max moves),
// splits P in registers and runs P.V (m64nDk8) into a fresh partial sum.
// The two warpgroups' softmax and products interleave on the SM as they
// fall (taking turns by named barriers, as FA3 does, measured 2-4% slower:
// PERF.md, Findings).  Keys past
// N get -inf; query rows past N are computed on zeros and not stored.
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int PA_BQ = 128;       // queries a block: two consumer warpgroups of 64
constexpr int PA_BK = 64;        // keys a tile
constexpr int PA_THREADS = 256;
constexpr int PA_SMEM_MAX = 232448;

// One stage: K hi, K lo (DS slabs of 64 keys x 32 fp32), V^T hi, V^T lo (two
// slabs of D rows x 32 keys); the ring holds as many as fit, at most 4.
template <int D>
struct PaTile {
  static constexpr int DS = (D + 31) / 32;
  static constexpr int K_SLAB = PA_BK * 128;
  static constexpr int K_BYTES = DS * K_SLAB;
  static constexpr int V_SLAB = D * 128;
  static constexpr int V_BYTES = 2 * V_SLAB;
  static constexpr int STAGE_BYTES = 2 * K_BYTES + 2 * V_BYTES;
  static constexpr int BAR_BYTES = 256;
  static constexpr int FIT = (PA_SMEM_MAX - 1024 - BAR_BYTES) / STAGE_BYTES;
  static constexpr int STAGES = FIT < 4 ? FIT : 4;
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + BAR_BYTES;
  static_assert(STAGES >= 2 && D % 16 == 0, "tile");
};

// physical index of logical column l of an 8-deep group
__device__ __forceinline__ int perm8(int l) { return l < 4 ? 2 * l : 2 * (l - 4) + 1; }

// byte offset of (row r, logical column l < 32) in a slab of 32 fp32 a row
// with the 128-byte swizzle
__device__ __forceinline__ int swz(int r, int l) {
  return r * 128 + ((((l >> 2) ^ (r & 7))) << 4) + (l & 3) * 4;
}

__device__ __forceinline__ void split_store(unsigned char* hi, unsigned char* lo, int off,
                                            float a) {
  const uint32_t h = tf32_rna(a);
  *reinterpret_cast<uint32_t*>(hi + off) = h;
  *reinterpret_cast<float*>(lo + off) = a - __uint_as_float(h);
}

// The stage image of key tile blockIdx.x of head blockIdx.y (see the note).
template <int D>
__global__ void __launch_bounds__(256)
kv_split_kernel(const float* __restrict__ k, const float* __restrict__ v,
                unsigned char* __restrict__ kvs, int N, int ntiles) {
  using G = PaTile<D>;
  __shared__ float ks[PA_BK][D + 1], vs[PA_BK][D + 1];
  const int tile = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x;
  const int key0 = tile * PA_BK;
  const size_t base = ((size_t)bh * N + key0) * D;
  for (int i = tid; i < PA_BK * D; i += 256) {
    const int r = i / D, d = i % D;
    const bool ok = key0 + r < N;
    ks[r][d] = ok ? k[base + i] : 0.f;
    vs[r][d] = ok ? v[base + i] : 0.f;
  }
  __syncthreads();
  unsigned char* st = kvs + ((size_t)bh * ntiles + tile) * G::STAGE_BYTES;
  // K: row = key, logical column l of slab s = head dim 32 s + 8 (l / 8) + perm8(l % 8)
  for (int i = tid; i < PA_BK * G::DS * 32; i += 256) {
    const int r = i / (G::DS * 32), L = i % (G::DS * 32), s = L / 32, l = L % 32;
    const int d = 32 * s + (l & ~7) + perm8(l & 7);
    split_store(st + s * G::K_SLAB, st + G::K_BYTES + s * G::K_SLAB, swz(r, l),
                d < D ? ks[r][d] : 0.f);
  }
  // V^T: row = head dim, logical column l of slab s = key 32 s + 8 (l / 8) + perm8(l % 8)
  unsigned char* vh = st + 2 * G::K_BYTES;
  for (int i = tid; i < D * PA_BK; i += 256) {
    const int r = i / PA_BK, L = i % PA_BK, s = L / 32, l = L % 32;
    const int key = 32 * s + (l & ~7) + perm8(l & 7);
    split_store(vh + s * G::V_SLAB, vh + G::V_BYTES + s * G::V_SLAB, swz(r, l), vs[key][r]);
  }
}

__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = __float_as_uint(a - __uint_as_float(hi));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (D == 80) wgmma_rs_tf32_n80(d, a, db, scale_d);
  else wgmma_rs_tf32_n64(d, a, db, scale_d);
}

// The 32-deep part p of S = Q.K^T (k-steps 4p .. min(4p + 4, D / 8)) into
// `part`, overwritten by its first product.
template <int D>
__device__ __forceinline__ void issue_qk(float (&part)[32], uint32_t (&qh)[D / 8][4],
                                         uint32_t (&ql)[D / 8][4], const unsigned char* st,
                                         int p) {
  using G = PaTile<D>;
  const uint64_t dkh = wgmma_desc_f32(st + p * G::K_SLAB);
  const uint64_t dkl = wgmma_desc_f32(st + G::K_BYTES + p * G::K_SLAB);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int ks = 4 * p + kk;
    if (ks < D / 8) {  // small terms first
      wgmma_rs_tf32_n64(part, ql[ks], dkh + 2 * kk, kk != 0);
      wgmma_rs_tf32_n64(part, qh[ks], dkl + 2 * kk, 1);
      wgmma_rs_tf32_n64(part, qh[ks], dkh + 2 * kk, 1);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(PA_THREADS, 1)
plain_attention_kernel(const float* __restrict__ q, const unsigned char* __restrict__ kvs,
                       float* __restrict__ out, int N, int ntiles, float scale) {
  using G = PaTile<D>;
  constexpr int KS = D / 8;  // k-steps of Q.K^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));  // the swizzle atoms need 1024-byte alignment
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::STAGES * G::STAGE_BYTES);
  uint64_t* empty = full + G::STAGES;
  int* done = reinterpret_cast<int*>(empty + G::STAGES);  // warps through a stage's P.V
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const unsigned char* src = kvs + (size_t)bh * ntiles * G::STAGE_BYTES;
  auto load_stage = [&](int j) {
    const int s = j % G::STAGES;
    mbar_expect_tx(&full[s], G::STAGE_BYTES);
    // K hi / lo, V^T hi / lo: four bulk copies
#pragma unroll
    for (int part = 0; part < 4; ++part) {
      const int off = part < 2 ? part * G::K_BYTES : 2 * G::K_BYTES + (part - 2) * G::V_BYTES;
      const int bytes = part < 2 ? G::K_BYTES : G::V_BYTES;
      bulk_load(smem + s * G::STAGE_BYTES + off, src + (size_t)j * G::STAGE_BYTES + off, bytes,
                &full[s]);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < G::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
      done[s] = 0;
    }
    mbar_fence_init();
    for (int j = 0; j < G::STAGES && j < ntiles; ++j) load_stage(j);
  }

  // this thread's A fragments of q * scale, split: rows r0 and r0 + 8 of the
  // block's 128, logical columns t, t + 4 of each 8-deep step = physical 2t, 2t + 1
  const int r0 = blockIdx.x * PA_BQ + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  uint32_t qh[KS][4], ql[KS][4];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    const float* qrow = q + ((size_t)bh * N + (row < N ? row : 0)) * D + 2 * t;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      float2 x = *reinterpret_cast<const float2*>(qrow + 8 * kk);
      if (row >= N) x = make_float2(0.f, 0.f);
      split_tf32(x.x * scale, qh[kk][half], ql[kk][half]);
      split_tf32(x.y * scale, qh[kk][2 + half], ql[kk][2 + half]);
    }
  }
  __syncthreads();  // the barriers are initialised

  float o[D / 2], m_run[2], l_run[2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  m_run[0] = m_run[1] = neg_inf();
  l_run[0] = l_run[1] = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    const int s = j % G::STAGES;
    const unsigned parity = (j / G::STAGES) & 1;
    const unsigned char* st = smem + s * G::STAGE_BYTES;
    mbar_wait(&full[s], parity);

    // S = Q.K^T: a fresh partial sum per 32-deep part, added in fp32
    float sacc[32], part[32];
    fence_regs(sacc);
    fence_regs(part);
    wgmma_fence();
    issue_qk<D>(sacc, qh, ql, st, 0);
    issue_qk<D>(part, qh, ql, st, 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 32; ++i) sacc[i] += part[i];
    if constexpr (G::DS == 3) {
      wgmma_fence();
      issue_qk<D>(part, qh, ql, st, 2);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < 32; ++i) sacc[i] += part[i];
    }

    // keys past N (the last tile): -inf
    if (j == ntiles - 1 && N % PA_BK != 0) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int key = j * PA_BK + 8 * (i >> 2) + 2 * t + (i & 1);
        if (key >= N) sacc[i] = neg_inf();
      }
    }

    // online softmax on the accumulators: sacc[4 jj + 2 h + c] is row g + 8 h, key 8 jj + 2 t + c
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = neg_inf();
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) mx = fmaxf(mx, fmaxf(sacc[4 * jj + 2 * h], sacc[4 * jj + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);  // finite: every tile has a key below N
      const float alpha = expf(m_run[h] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = sacc[4 * jj + 2 * h + c];
          x = expf(x - m_new);
          sum += x;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l_run[h] = l_run[h] * alpha + sum;
      m_run[h] = m_new;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        o[4 * jj + 2 * h] *= alpha;
        o[4 * jj + 2 * h + 1] *= alpha;
      }
    }

    // P.V into a fresh partial sum: key step jj's A fragment is this thread's
    // accumulator pairs (logical t, t + 4 = keys 2t, 2t + 1 of the step)
    uint32_t ph[8][4], pl[8][4];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      split_tf32(sacc[4 * jj], ph[jj][0], pl[jj][0]);
      split_tf32(sacc[4 * jj + 2], ph[jj][1], pl[jj][1]);
      split_tf32(sacc[4 * jj + 1], ph[jj][2], pl[jj][2]);
      split_tf32(sacc[4 * jj + 3], ph[jj][3], pl[jj][3]);
    }
    float pv[D / 2];
    fence_regs(pv);
    wgmma_fence();
    const unsigned char* vt = st + 2 * G::K_BYTES;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {  // small terms first
      const uint64_t dvh = wgmma_desc_f32(vt + (jj >> 2) * G::V_SLAB) + 2 * (jj & 3);
      const uint64_t dvl = wgmma_desc_f32(vt + G::V_BYTES + (jj >> 2) * G::V_SLAB) + 2 * (jj & 3);
      wgmma_pv<D>(pv, pl[jj], dvh, jj != 0);
      wgmma_pv<D>(pv, ph[jj], dvl, 1);
      wgmma_pv<D>(pv, ph[jj], dvh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(ph[jj][e]), "+r"(pl[jj][e])::"memory");
    if (lane == 0) {  // this warp no longer reads the stage; the last one refills it
      mbar_arrive(&empty[s]);
      if (atomicAdd(&done[s], 1) == 7) {
        done[s] = 0;
        mbar_wait(&empty[s], parity);
        if (j + G::STAGES < ntiles) load_stage(j + G::STAGES);
      }
    }
    __syncwarp();
    // the tensor core's sum of the tile, added in fp32 (to nearest)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] += pv[i];
  }

  // epilogue: o / l, fp32 pairs straight to device memory
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 8 * h;
    if (row >= N) continue;
    const float inv = 1.f / l_run[h];
    float* orow = out + ((size_t)bh * N + row) * D + 2 * t;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<float2*>(orow + 8 * jj) =
          make_float2(o[4 * jj + 2 * h] * inv, o[4 * jj + 2 * h + 1] * inv);
  }
}

template <int D>
int launch_plain_attention(const void* q, const void* k, const void* v, void* kvs, void* out,
                           int BH, int N, float scale, cudaStream_t stream) {
  using G = PaTile<D>;
  const int ntiles = (N + PA_BK - 1) / PA_BK;
  kv_split_kernel<D><<<dim3(ntiles, BH), 256, 0, stream>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<unsigned char*>(kvs), N, ntiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(plain_attention_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return err;
  plain_attention_kernel<D><<<dim3((N + PA_BQ - 1) / PA_BQ, BH), PA_THREADS, G::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const unsigned char*>(kvs),
      static_cast<float*>(out), N, ntiles, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace samrs

extern "C" {

// Bytes of samrs_plain_attention's K / V^T scratch: one stage image
// (PaTile::STAGE_BYTES) for each 64-key tile of each head; -1 for a head_dim
// other than 64 or 80.  The wrapper allocates what this returns.
long long samrs_plain_attention_scratch_bytes(int BH, int N, int head_dim) {
  using namespace samrs;
  const long long tiles = (long long)BH * ((N + PA_BK - 1) / PA_BK);
  if (head_dim == 64) return tiles * PaTile<64>::STAGE_BYTES;
  if (head_dim == 80) return tiles * PaTile<80>::STAGE_BYTES;
  return -1;
}

// q, k, v, out (BH, N, head_dim) fp32, contiguous; head_dim 64 or 80.
// kv_split: scratch of kv_bytes, 16-byte aligned, at least
// samrs_plain_attention_scratch_bytes.  Two launches: the K / V^T split,
// then the attention.
int samrs_plain_attention(const void* q, const void* k, const void* v, void* kv_split,
                          long long kv_bytes, void* out, int BH, int N, int head_dim, float scale,
                          void* stream) {
  using namespace samrs;
  if (BH <= 0 || BH > 65535 || N <= 0) return cudaErrorInvalidValue;
  const long long need = samrs_plain_attention_scratch_bytes(BH, N, head_dim);
  if (need < 0 || kv_bytes < need) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) return launch_plain_attention<64>(q, k, v, kv_split, out, BH, N, scale, st);
  return launch_plain_attention<80>(q, k, v, kv_split, out, BH, N, scale, st);
}

}  // extern "C"
