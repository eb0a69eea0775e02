// K1's attention stage: 14x14-window attention with the decomposed
// relative-position bias, read straight from the unpadded (B, H, W, 3C) qkv
// map.
//
// Replaces the attention of samrs_tpu/kernels/fused_window_layer.py::_kernel
// (its qkv and proj matmuls are the GEMM of gemm.cu), of
// fused_window_block.py::_kernel ("fused2") and of fused_attention.py's
// kernel on partitioned windows ("fused").  The TPU kernel pads the map 64
// -> 70 and lets the pad tokens attend unmasked with k = v = qkv bias; it
// folds the rel-pos terms into an augmented-K matmul with one-hot
// expansions.  Bound on the H100: device-memory bytes (a ViT-H layer reads
// ~38 MB of q / k / v and writes ~10 MB against ~7 GFLOP of tensor work,
// 196-row windows padded to 256 queries), so the design keeps the tensor
// cores and the loads busy at once, with the hardware that Hopper adds
// (hopper.cuh):
//   * two launches: the rel-pos rows of every window token (fp32 dot
//     products of q with the gathered tables, 28 a token: 14 row terms, 14
//     column terms; the plain version's arithmetic) into a scratch buffer,
//     then the attention.  The rel terms were ~60% of the time of the
//     mma.sync kernel this replaces (chip_breakdown.py): there each query
//     read the fp32 tables from global memory one d at a time.  Here each
//     thread takes a 7 x 7 block of (tokens sharing a table) x (table
//     rows), the sums in registers, so that 14 loads feed 196 FMAs;
//   * the attention is persistent (a producer warpgroup that gives its
//     registers to two consumer warpgroups): one block per SM walks a contiguous
//     range of (window, head, image) x 64-row query tiles, so the last wave
//     is at most one tile longer than the others (one block per window and
//     head ran 400 blocks on 264 slots: 1.52 waves);
//   * a producer warp loads a window's Q, K and V (196 tokens each) with
//     TMA from a 4-d tensor map over the qkv map (box 14 x 14 tokens x one
//     head slice: 64 columns with the 128-byte swizzle, and for a head of
//     80 the last 16 with the 32-byte swizzle) into a two-stage ring, so the
//     next window lands while this one is multiplied.  The map's tokens
//     past H / W read zeros; they carry the qkv bias (what the zero-padded
//     normed map gives them), so the consumers patch those rows in shared
//     memory from bqkv and fence the async proxy before wgmma reads them;
//   * two consumer warpgroups take the range's 64-row tiles in turn:
//     S = Q.K^T over the window's 196 keys in one wgmma m64n200k16 chain
//     from shared memory, the bias rel_h[q, k / 14] + rel_w[q, k % 14] and
//     one exact softmax per row in fp32 registers (the whole window fits:
//     keys 196..199 masked), P rounded to bf16 once and fed from registers
//     to wgmma against V read transposed; V's rows 196..207 (the last
//     16-key step) are zero once at the start and never written by the TMA.
//     The fourth tile holds 4 live queries: the tensor cores are not the
//     bound.
//
// The modes of the TPU kernel family map onto arguments: the window order
// is the order of the work items -- plain (images outermost, their windows
// in row order, heads fastest, so that a block's consecutive items read
// neighbouring column slices of the same token rows: "block",
// "block_slab"; one window row at a time, "block_row", walks the same
// sequence), batch innermost ("block_ijb", "block_sg": images fastest, then
// heads, then windows); the
// layout is the unpartitioned map whose windows may pad, or partitioned
// windows (B * nW, 14, 14, 3C), which is the map layout with one window per
// image; and the output map may be the padded (Hp, Wp) one (return_padded),
// where the pad tokens' queries are written too.
//
// K12's window form is the same two launches on split heads (SPLIT): q, k,
// v (B', N, d) with N = kh * kw <= 196 and kh + kw <= 32, an item a row of
// B' (one window and head), each operand behind its own 3-d map (d, N, B')
// with a box of N rows (the stage's V rows past N stay zero); no pad tokens,
// so nothing is patched; the rel rows are given, rel_h (B', N, kh) and rel_w
// (B', N, kw) fp32, and parked per tile as in K1; the keys past N masked;
// fp32 rows out.  It replaces samrs_tpu/kernels/window_attention.py::
// _window_attention_pallas on the windows of window_attn_impl="pallas" and
// the global grids of up to 196 tokens.  Its rel rows on 14 x 14 windows
// come from window_rel_kernel reading bf16 q in place (samrs_split_window_rel;
// other grids take csrc/flash_attention.cu's relpos_rows_kernel).
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int WIN = 14;           // SAM's window; the only instantiated size
constexpr int NT = WIN * WIN;     // 196 tokens of a window
constexpr int NKEY = 200;         // columns of S (n200): keys 196..199 are masked
constexpr int NPV = 208;          // depth of P.V: 13 steps of 16 keys, V's rows 196.. zero
constexpr int QTILES = 4;         // 64-row query tiles of a window (the last: 4 queries)
constexpr int NREL = 2 * WIN;     // rel terms of a token: 14 row terms, then 14 column terms
constexpr int SPLIT_REL_MAX = 32; // K12's window form: kh + kw rel terms a token at most
constexpr int WA_THREADS = 384;   // producer warpgroup + two consumer warpgroups
constexpr int REL_THREADS = 224;  // two windows at a time, 112 threads each

__host__ __device__ constexpr int align1k(int x) { return (x + 1023) / 1024 * 1024; }

// One stage of the ring: Q, K, V of a window, each a 196-row box of 64
// columns (128-byte swizzle, 1024-aligned) and for a head of 80 a box of the
// last 16 (32-byte swizzle); V's region runs to row 208.  The fourth Q tile
// reads rows 196..255 past the Q box: other data of the stage, rows that are
// never stored.
template <int HD>
struct WinStage {
  static constexpr bool TAIL = HD == 80;
  static constexpr int MAIN = NT * 128;
  static constexpr int TAILB = TAIL ? NT * 32 : 0;
  static constexpr int QM = 0, QT = MAIN;
  static constexpr int KM = align1k(QT + TAILB), KT = KM + MAIN;
  static constexpr int VM = align1k(KT + TAILB), VT = VM + NPV * 128;
  static constexpr int BYTES = align1k(VT + (TAIL ? NPV * 32 : 0));
  static constexpr int TX = 3 * (MAIN + TAILB);   // bytes the TMA delivers for a window
  static constexpr int REL_BYTES = 64 * SPLIT_REL_MAX * 4;  // a consumer's tile of rel rows
  static constexpr int SMEM = 1024 + 2 * BYTES + 2 * REL_BYTES + 64;
  static_assert(SMEM <= 232448, "K1 shared memory");
  static_assert(NKEY % 8 == 0 && NKEY >= NT && NPV % 16 == 0 && NPV >= NKEY, "key padding");

  static __device__ __forceinline__ int main_off(int part) {
    return part == 0 ? QM : part == 1 ? KM : VM;
  }
  static __device__ __forceinline__ int tail_off(int part) {
    return part == 0 ? QT : part == 1 ? KT : VT;
  }
};

enum WinOrder { kOrderPlain = 0, kOrderIJB = 1, kOrderRow = 2 };

struct WinItem {
  int b, h, x0, y0, rel;  // image, head, the window's first token, its index in the rel buffer
};

// Work item i in the given order; `rel` is its window's index in the rel
// buffer (images, then heads, then windows).
__device__ __forceinline__ WinItem win_item(int i, int order, int B, int nH, int nww, int nW) {
  int b, h, w;
  if (order == kOrderIJB) {
    b = i % B, h = (i / B) % nH, w = i / (B * nH);
  } else {
    h = i % nH, w = (i / nH) % nW, b = i / (nH * nW);
  }
  return {b, h, (w / nww) * WIN, (w % nww) * WIN, (b * nH + h) * nW + w};
}

// rel[item][t][u] = q_t . Rh[t / 14][u], rel[item][t][14 + u] = q_t . Rw[t % 14][u]
// for the 196 tokens t of each window (items: images, then heads, then
// windows), in fp32 with the products added in increasing d; q_t is the
// token's q head slice, the qkv bias for map-pad tokens (zero without one).  For one table and one
// window row or column a the 14 tokens sharing it times the 14 table rows
// (a, u) is a 14 x 14 x HD product: four threads take 7 x 7 blocks of it,
// the window's q from shared memory (bf16), the table rows through L1 (the
// tables are the same for every window), 49 sums in registers (14 loads
// feed 196 FMAs).  A block takes two windows at a time, 112 threads each;
// two blocks share an SM.  SPLIT (K12): an item is a row of split-head q
// (B', 196, HD) (B items, nH = nW = 1), and the rows leave as rel_h (B',
// 196, 14) into `rel` and rel_w (B', 196, 14) into `rel_w`.
template <int HD, bool SPLIT>
__global__ void __launch_bounds__(REL_THREADS, 2)
window_rel_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
                  const float* __restrict__ Rh, const float* __restrict__ Rw,
                  float* __restrict__ rel, float* __restrict__ rel_w, int B, int H, int W, int C,
                  int nH, int nww, int nW) {
  constexpr int LDQ = HD + 8;  // bf16 q rows (elements; 16-byte aligned)
  constexpr int CH = HD / 8;
  extern __shared__ __align__(16) unsigned char rel_smem[];
  bf16* qs = reinterpret_cast<bf16*>(rel_smem);  // [2 windows][196][LDQ]
  const int slot = threadIdx.x / 112, lt = threadIdx.x % 112;
  const int T = lt / 56, r = lt % 56, a = r / 4, qb = (r >> 1) & 1, ub = r & 1;
  const float* trow = (T == 0 ? Rh : Rw) + (size_t)(a * WIN + ub * 7) * HD;  // rows (a, 7 ub + k)
  bf16* q_own = qs + slot * NT * LDQ;
  const int items = B * nH * nW;
  for (int base = 2 * blockIdx.x; base < items; base += 2 * gridDim.x) {
    const int item = base + slot;
    const bool live = item < items;
    __syncthreads();  // the previous windows' rows are read out
    if (live && SPLIT) {
      const bf16* qi = qkv + (size_t)item * NT * HD;
      for (int idx = lt; idx < NT * CH; idx += 112) {
        const int tok = idx / CH, ch = idx % CH;
        cp_async16(q_own + tok * LDQ + ch * 8, qi + tok * HD + ch * 8, true);
      }
    } else if (live) {
      const int w = item % nW, h = (item / nW) % nH, b = item / (nW * nH);
      const int x0 = (w / nww) * WIN, y0 = (w % nww) * WIN;
      for (int idx = lt; idx < NT * CH; idx += 112) {  // asynchronous; a pad without bias reads 0
        const int tok = idx / CH, ch = idx % CH, x = x0 + tok / WIN, y = y0 + tok % WIN;
        const bool in = x < H && y < W;
        const bf16* src = in ? qkv + (((size_t)b * H + x) * W + y) * 3 * C + h * HD + ch * 8
                             : bqkv + h * HD + ch * 8;
        const bool read = in || bqkv != nullptr;
        cp_async16(q_own + tok * LDQ + ch * 8, read ? src : qkv, read);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // T 0: queries x = a (tokens 14 a + y), T 1: queries y = a (tokens 14 x + a); y or x = 7 qb + i
    int tok[7];
#pragma unroll
    for (int i = 0; i < 7; ++i) tok[i] = T == 0 ? a * WIN + qb * 7 + i : (qb * 7 + i) * WIN + a;
    float acc[7][7];
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int k = 0; k < 7; ++k) acc[i][k] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 tv[7];
#pragma unroll
      for (int k = 0; k < 7; ++k) tv[k] = __ldg(reinterpret_cast<const float4*>(trow + k * HD + d));
#pragma unroll
      for (int i = 0; i < 7; ++i) {
        const uint2 raw = *reinterpret_cast<const uint2*>(q_own + tok[i] * LDQ + d);
        const float2 q01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 q23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          float s = acc[i][k];
          s = fmaf(q01.x, tv[k].x, s);
          s = fmaf(q01.y, tv[k].y, s);
          s = fmaf(q23.x, tv[k].z, s);
          acc[i][k] = fmaf(q23.y, tv[k].w, s);
        }
      }
    }
    // the window's rel rows, gathered in its q buffer, leave in 16-byte stores
    __syncthreads();  // both windows' q is read out (their threads share the barrier)
    float* rs = reinterpret_cast<float*>(q_own);  // K1: [token][28]; SPLIT: [T][token][14]
#pragma unroll
    for (int i = 0; i < 7; ++i)
#pragma unroll
      for (int k = 0; k < 7; ++k)
        rs[SPLIT ? (T * NT + tok[i]) * WIN + ub * 7 + k : tok[i] * NREL + T * WIN + ub * 7 + k] =
            acc[i][k];
    __syncthreads();
    if (live && SPLIT) {  // the item's rel_h rows, then its rel_w rows
      constexpr int PLANE = NT * WIN / 4;
      float4* oh = reinterpret_cast<float4*>(rel) + (size_t)item * PLANE;
      float4* ow = reinterpret_cast<float4*>(rel_w) + (size_t)item * PLANE;
      for (int i = lt; i < 2 * PLANE; i += 112)
        (i < PLANE ? oh[i] : ow[i - PLANE]) = reinterpret_cast<const float4*>(rs)[i];
    } else if (live) {
      float4* out = reinterpret_cast<float4*>(rel + (size_t)item * NT * NREL);
      for (int i = lt; i < NT * NREL / 4; i += 112) out[i] = reinterpret_cast<const float4*>(rs)[i];
    }
  }
}

template <int HD>
constexpr int rel_smem_bytes() {
  return 2 * NT * (HD + 8) * 2;
}

// 2^x on the MUFU unit (flushes subnormal results to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The operands' tensor maps (main: 64 columns, 128-byte swizzle; tail: the
// last 16 columns of a head of 80, 32-byte swizzle).  K1: the qkv map (B, H,
// W, 3C) in main[0] / tail[0], box 64 (16) x 14 x 14 x 1, a head a column
// offset.  K12: q, k, v (B', N, HD) in turn, box 64 (16) x N x 1.
struct WinMaps {
  CUtensorMap main[3];
  CUtensorMap tail[3];
};

// The work of a launch.  K1: B, H, W, the output map Ho x Wo, C, nH and the
// window grid (nww windows a row, nW in all) of the qkv map, the item order;
// K12: B = B' items of N = H * W tokens (kh = H, kw = W).  Every item has
// `qtiles` 64-row query tiles, its operands boxes of `nbox` rows.
struct WinGeom {
  int B, H, W, Ho, Wo, C, nH, nww, nW, order;
  int items, qtiles, nbox;
};

// The attention.  K1 (SPLIT false): Q, K, V of a window from the qkv map,
// rel from window_rel_kernel, out (B, Ho, Wo, C) bf16.  K12 (SPLIT true): a
// row of B' from q, k, v, rel = rel_h (B', N, kh) and rel_w (B', N, kw), out
// (B', N, HD) fp32; KG > 0 fixes the grid at KG x KG when compiled (the
// windows), 0 reads it from `geo`.
template <int HD, bool SPLIT, int KG = 0>
__global__ void __launch_bounds__(WA_THREADS, 1)
window_wgmma_kernel(const __grid_constant__ WinMaps maps, const bf16* __restrict__ bqkv,
                    const float* __restrict__ rel, const float* __restrict__ rel_w,
                    void* __restrict__ out, const WinGeom geo, float scale) {
  using S = WinStage<HD>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(align_up(
      reinterpret_cast<size_t>(smem_raw), 1024));  // the swizzle atoms need 1024-byte alignment
  float* rel_s = reinterpret_cast<float*>(smem + 2 * S::BYTES);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * S::BYTES + 2 * S::REL_BYTES);
  uint64_t* empty = full + 2;
  const int B = geo.B, H = geo.H, W = geo.W, Ho = geo.Ho, Wo = geo.Wo, C = geo.C, nH = geo.nH;
  const int nww = geo.nww, nW = geo.nW;
  const int order = geo.order, QT = geo.qtiles, nbox = geo.nbox;
  const int GH = KG ? KG : H, GW = KG ? KG : W;  // K12's grid (kh, kw)
  const int ntok = SPLIT ? GH * GW : NT;    // tokens (keys) of an item
  const int nrel = SPLIT ? GH + GW : NREL;  // rel terms of a token
  const int units = geo.items * QT;
  const int u0 = (int)((long long)units * blockIdx.x / gridDim.x);
  const int u1 = (int)((long long)units * (blockIdx.x + 1) / gridDim.x);
  const int wg = threadIdx.x >> 7;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx; the TMA bytes complete it
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_fence_init();
  }
  // V's rows nbox..207 of both stages (K1: 196..): zero for P.V's last steps
  // (0 x stale data could be NaN); the TMA never writes them
  const int vz = NPV - nbox;
  for (int i = threadIdx.x; i < 2 * vz * 8; i += WA_THREADS)
    reinterpret_cast<uint4*>(smem + (i / (vz * 8)) * S::BYTES + S::VM +
                             nbox * 128)[i % (vz * 8)] = make_uint4(0u, 0u, 0u, 0u);
  if constexpr (S::TAIL)
    for (int i = threadIdx.x; i < 2 * vz * 2; i += WA_THREADS)
      reinterpret_cast<uint4*>(smem + (i / (vz * 2)) * S::BYTES + S::VT +
                               nbox * 32)[i % (vz * 2)] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  __syncthreads();
  if (u0 >= u1) return;
  const int i_first = u0 / QT, i_last = (u1 - 1) / QT;

  if (wg == 0) {  // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int part = 0; part < (SPLIT ? 3 : 1); ++part) {
        tma_prefetch_map(&maps.main[part]);
        if constexpr (S::TAIL) tma_prefetch_map(&maps.tail[part]);
      }
      for (int i = i_first, n = 0; i <= i_last; ++i, ++n) {
        const int s = n & 1;
        mbar_wait(&empty[s], ((n >> 1) & 1) ^ 1);
        unsigned char* st = smem + s * S::BYTES;
        if constexpr (SPLIT) {  // rows [0, N) of item i of q, k and v
          mbar_expect_tx(&full[s], 3 * nbox * (128 + (S::TAIL ? 32 : 0)));
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            tma_load_3d(st + S::main_off(part), &maps.main[part], &full[s], 0, 0, i);
            if constexpr (S::TAIL)
              tma_load_3d(st + S::tail_off(part), &maps.tail[part], &full[s], 64, 0, i);
          }
          continue;
        }
        const WinItem it = win_item(i, order, B, nH, nww, nW);
        mbar_expect_tx(&full[s], S::TX);
#pragma unroll
        for (int part = 0; part < 3; ++part) {
          const int col = part * C + it.h * HD;
          tma_load_4d(st + S::main_off(part), &maps.main[0], &full[s], col, it.y0, it.x0, it.b);
          if constexpr (S::TAIL)
            tma_load_4d(st + S::tail_off(part), &maps.tail[0], &full[s], col + 64, it.y0, it.x0,
                        it.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c takes every other tile of the block's range
  setmaxnreg_inc<232>();
  const int c = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float* rs = rel_s + c * 64 * SPLIT_REL_MAX;
  constexpr float kLog2e = 1.4426950408889634f;
  const float inv_kw = 1.f / GW;  // K12 off KG: a key's grid row by a float reciprocal
  float sacc[NKEY / 2], o[32], ot[S::TAIL ? 8 : 1];
#pragma unroll
  for (int i = 0; i < NKEY / 2; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (S::TAIL ? 8 : 1); ++i) ot[i] = 0.f;

  for (int i = i_first, n = 0; i <= i_last; ++i, ++n) {
    const int s = n & 1;
    unsigned char* st = smem + s * S::BYTES;
    const WinItem it = SPLIT ? WinItem{i, 0, 0, 0, i} : win_item(i, order, B, nH, nww, nW);
    mbar_wait(&full[s], (n >> 1) & 1);
    if (!SPLIT && bqkv != nullptr && (it.x0 + WIN > H || it.y0 + WIN > W)) {
      // map-pad tokens: the TMA read zeros, the zero-padded map gives them the
      // bias.  Thread (phase, chunk) loads one 16-byte chunk of the head's q /
      // k / v bias once and writes it into that chunk of every pad row
      constexpr int CH = HD / 8;         // chunks of a row: 8 in the main box, then the tail's
      constexpr int PH = 128 / (3 * CH);  // token phases
      if (tid < PH * 3 * CH) {
        const int rem = tid % (3 * CH), part = rem / CH, ch = rem % CH;
        const int nx = H - it.x0 < WIN ? H - it.x0 : WIN, ny = W - it.y0 < WIN ? W - it.y0 : WIN;
        const uint4 v = load16(bqkv + part * C + it.h * HD + ch * 8);
        for (int tok = tid / (3 * CH); tok < NT; tok += PH) {
          const int xl = tok / WIN;
          if (xl < nx && tok - xl * WIN < ny) continue;
          unsigned char* dst =
              ch < 8 ? st + S::main_off(part) + tok * 128 + ((ch ^ (tok & 7)) << 4)
                     : st + S::tail_off(part) + tok * 32 + (((ch - 8) ^ ((tok >> 2) & 1)) << 4);
          *reinterpret_cast<uint4*>(dst) = v;
        }
      }
      fence_proxy_async();
      named_barrier_sync(1 + c, 128);
    }
    const int lo = u0 > i * QT ? u0 : i * QT;
    const int hi = u1 < (i + 1) * QT ? u1 : (i + 1) * QT;
    for (int u = lo; u < hi; ++u) {
      if (((u - u0) & 1) != c) continue;
      const int tq = u - i * QT, r0 = tq * 64;
      const int rows = ntok - r0 < 64 ? ntok - r0 : 64;
      // this tile's rel rows: loaded now, parked in shared memory while S runs
      // (K1: rows of 28 from its scratch in 16-byte loads; K12: the rel_h and
      // rel_w terms of a row side by side, rows of kh + kw <= 32)
      const int n4 = rows * NREL / 4, nsp = rows * nrel;
      float4 rv[4];
      if constexpr (SPLIT) {
        const float* rhg = rel + ((size_t)i * ntok + r0) * GH;
        const float* rwg = rel_w + ((size_t)i * ntok + r0) * GW;
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int idx = tid + 128 * k, r = idx / nrel, cc = idx - r * nrel;
          reinterpret_cast<float*>(rv)[k] =
              idx >= nsp ? 0.f : cc < GH ? __ldg(rhg + r * GH + cc) : __ldg(rwg + r * GW + cc - GH);
        }
      } else {
        const float4* relg =
            reinterpret_cast<const float4*>(rel + ((size_t)it.rel * NT + r0) * NREL);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int idx = tid + 128 * k;
          rv[k] = idx < n4 ? __ldg(relg + idx) : make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }

      // S = Q K^T (keys 0..199)
      fence_regs(sacc);
      wgmma_fence();
      {
        const uint64_t dq = wgmma_desc(st + S::QM + r0 * 128, kSwizzle128B, 16, 1024);
        const uint64_t dk = wgmma_desc(st + S::KM, kSwizzle128B, 16, 1024);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss_n200(sacc, dq + 2 * kk, dk + 2 * kk, kk != 0);
        if constexpr (S::TAIL)
          wgmma_ss_n200(sacc, wgmma_desc(st + S::QT + r0 * 32, kSwizzle32B, 16, 256),
                        wgmma_desc(st + S::KT, kSwizzle32B, 16, 256), 1);
      }
      wgmma_commit();
      named_barrier_sync(1 + c, 128);  // the previous tile's bias reads are done
      if constexpr (SPLIT) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          const int idx = tid + 128 * k;
          if (idx < nsp) rs[idx] = reinterpret_cast<const float*>(rv)[k];
        }
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int idx = tid + 128 * k;
          if (idx < n4) reinterpret_cast<float4*>(rs)[idx] = rv[k];
        }
      }
      named_barrier_sync(1 + c, 128);
      wgmma_wait<0>();
      fence_regs(sacc);

      // logits s * scale + rel_h[q, k / kw] + rel_w[q, k % kw]; keys >= N masked (K1: 196, kw 14).
      // A warp whose 16 rows are all past the window (the last tile's warps
      // 1..3) only feeds zeros to the warpgroup's P.V
      uint32_t pa[NPV / 16][4];
      float l[2] = {1.f, 1.f};
      if (warp * 16 < rows) {
        float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
        for (int j = 0; j < NKEY / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int half = e >> 1, kc = 8 * j + 2 * t + (e & 1);
            const float* rrow = rs + (warp * 16 + g + 8 * half) * nrel;
            float v = neg_inf();
            if constexpr (SPLIT) {
              if (kc < ntok) {
                int kx;
                if constexpr (KG > 0) kx = kc / KG;
                else kx = __float2int_rz((kc + 0.5f) * inv_kw);
                v = fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[GH + kc - kx * GW]);
              }
            } else if (8 * j + 8 <= NT || kc < NT) {
              const int kx = kc / WIN;
              v = fmaf(sacc[4 * j + e], scale, rrow[kx] + rrow[WIN + kc - kx * WIN]);
            }
            sacc[4 * j + e] = v;
            mx[half] = fmaxf(mx[half], v);
          }
        float mb[2];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
          mb[half] = -mx[half] * kLog2e;
        }
        // P = exp(s - max) rounded to bf16 once, packed as the A fragments of P.V;
        // the row sum adds the rounded values
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int j = 0; j < NKEY / 8; ++j)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const __nv_bfloat162 p =
                __floats2bfloat162_rn(ex2(fmaf(sacc[4 * j + 2 * half], kLog2e, mb[half])),
                                      ex2(fmaf(sacc[4 * j + 2 * half + 1], kLog2e, mb[half])));
            sum[half] += __bfloat162float(p.x) + __bfloat162float(p.y);
            pa[j >> 1][2 * (j & 1) + half] = *reinterpret_cast<const uint32_t*>(&p);
          }
        if constexpr (NKEY / 8 < 2 * (NPV / 16)) {  // the last step's keys 200..207
          pa[NPV / 16 - 1][2] = 0u;
          pa[NPV / 16 - 1][3] = 0u;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
          l[half] = sum[half];
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < NPV / 16; ++kk) pa[kk][0] = pa[kk][1] = pa[kk][2] = pa[kk][3] = 0u;
      }

      // O = P V, V read transposed (MN-major): 8-key groups 1024 (256) bytes apart
      fence_regs(o);
      if constexpr (S::TAIL) fence_regs(ot);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NPV / 16; ++kk) {
        wgmma_rs_n64_tb(o, pa[kk], wgmma_desc(st + S::VM + kk * 16 * 128, kSwizzle128B, 1024, 1024),
                        kk != 0);
        if constexpr (S::TAIL)
          wgmma_rs_n16_tb(ot, pa[kk], wgmma_desc(st + S::VT + kk * 16 * 32, kSwizzle32B, 256, 256),
                          kk != 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      if constexpr (S::TAIL) fence_regs(ot);

#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int lr = warp * 16 + g + 8 * half, tok = r0 + lr;
        if constexpr (SPLIT) {  // fp32 rows of HD
          if (lr >= rows) continue;
          const float inv = 1.f / l[half];
          float* orow = static_cast<float*>(out) + ((size_t)i * ntok + tok) * HD + 2 * t;
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
            *reinterpret_cast<float2*>(orow + 8 * jj) =
                make_float2(o[4 * jj + 2 * half] * inv, o[4 * jj + 2 * half + 1] * inv);
          if constexpr (S::TAIL)
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
              *reinterpret_cast<float2*>(orow + 64 + 8 * jj) =
                  make_float2(ot[4 * jj + 2 * half] * inv, ot[4 * jj + 2 * half + 1] * inv);
          continue;
        }
        const int x = it.x0 + tok / WIN, y = it.y0 + tok % WIN;
        if (lr >= rows || x >= Ho || y >= Wo) continue;
        const float inv = 1.f / l[half];
        bf16* orow = static_cast<bf16*>(out) + (((size_t)it.b * Ho + x) * Wo + y) * C + it.h * HD +
                     2 * t;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj) =
              __floats2bfloat162_rn(o[4 * jj + 2 * half] * inv, o[4 * jj + 2 * half + 1] * inv);
        if constexpr (S::TAIL)
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
            *reinterpret_cast<__nv_bfloat162*>(orow + 64 + 8 * jj) = __floats2bfloat162_rn(
                ot[4 * jj + 2 * half] * inv, ot[4 * jj + 2 * half + 1] * inv);
      }
    }
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp's products on the stage are done
    __syncwarp();
  }
}

// window_rel_kernel over `items` items (two a block, two blocks an SM at most).
template <int HD, bool SPLIT>
cudaError_t launch_window_rel(const bf16* q, const bf16* bias, const void* Rh, const void* Rw,
                              void* rel, void* rel_w, int items, int B, int H, int W, int C,
                              int num_heads, int nww, int nW, cudaStream_t stream) {
  constexpr int rel_smem = rel_smem_bytes<HD>();
  auto rk = window_rel_kernel<HD, SPLIT>;
  cudaError_t err = cudaFuncSetAttribute(rk, cudaFuncAttributeMaxDynamicSharedMemorySize, rel_smem);
  if (err != cudaSuccess) return err;
  const int pairs = (items + 1) / 2;
  rk<<<pairs < 2 * sm_count() ? pairs : 2 * sm_count(), REL_THREADS, rel_smem, stream>>>(
      q, bias, static_cast<const float*>(Rh), static_cast<const float*>(Rw),
      static_cast<float*>(rel), static_cast<float*>(rel_w), B, H, W, C, num_heads, nww, nW);
  return cudaGetLastError();
}

// The persistent attention kernel: one block an SM at most over the
// launch's items x query tiles.
template <int HD, bool SPLIT, int KG = 0>
int launch_window_attention(const WinMaps& maps, const bf16* bias, const void* rel,
                            const float* rel_w, void* out, const WinGeom& geo, float scale,
                            cudaStream_t stream) {
  using S = WinStage<HD>;
  auto kernel = window_wgmma_kernel<HD, SPLIT, KG>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
  if (err != cudaSuccess) return err;
  const int units = geo.items * geo.qtiles;
  kernel<<<units < sm_count() ? units : sm_count(), WA_THREADS, S::SMEM, stream>>>(
      maps, bias, static_cast<const float*>(rel), rel_w, out, geo, scale);
  return cudaGetLastError();
}

template <int HD>
int launch_window(const void* qkv, const void* bqkv, const void* Rh, const void* Rw, void* rel,
                  void* out, int B, int H, int W, int Ho, int Wo, int C, int num_heads, int order,
                  float scale, cudaStream_t stream) {
  using S = WinStage<HD>;
  const int nwh = (H + WIN - 1) / WIN, nww = (W + WIN - 1) / WIN, nW = nwh * nww;
  const int items = B * num_heads * nW;
  const bf16* q = static_cast<const bf16*>(qkv);
  const bf16* bias = static_cast<const bf16*>(bqkv);

  cudaError_t err = launch_window_rel<HD, false>(q, bias, Rh, Rw, rel, nullptr, items, B, H, W, C,
                                                 num_heads, nww, nW, stream);
  if (err != cudaSuccess) return err;

  WinMaps maps;
  const uint64_t dims[4] = {(uint64_t)3 * C, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)3 * C * 2, (uint64_t)W * 3 * C * 2,
                               (uint64_t)H * W * 3 * C * 2};
  const uint32_t box_main[4] = {64, WIN, WIN, 1}, box_tail[4] = {16, WIN, WIN, 1};
  int e = make_tensor_map(&maps.main[0], qkv, 4, dims, strides, box_main,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != 0) return e;
  maps.tail[0] = maps.main[0];
  if (S::TAIL)
    e = make_tensor_map(&maps.tail[0], qkv, 4, dims, strides, box_tail, CU_TENSOR_MAP_SWIZZLE_32B);
  if (e != 0) return e;
  const WinGeom geo{B, H, W, Ho, Wo, C, num_heads, nww, nW, order, items, QTILES, NT};
  return launch_window_attention<HD, false>(maps, bias, rel, nullptr, out, geo, scale, stream);
}

// K12's window form: q, k, v (B, N, HD) behind 3-d maps with a box of N rows.
template <int HD>
int launch_split_window(const void* q, const void* k, const void* v, const void* rel_h,
                        const void* rel_w, void* out, int B, int N, int kh, int kw, float scale,
                        cudaStream_t stream) {
  WinMaps maps;
  const void* base[3] = {q, k, v};
  const uint64_t dims[3] = {(uint64_t)HD, (uint64_t)N, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)HD * 2, (uint64_t)N * HD * 2};
  const uint32_t box_main[3] = {64, (uint32_t)N, 1}, box_tail[3] = {16, (uint32_t)N, 1};
  for (int i = 0; i < 3; ++i) {
    int e = make_tensor_map(&maps.main[i], base[i], 3, dims, strides, box_main,
                            CU_TENSOR_MAP_SWIZZLE_128B);
    maps.tail[i] = maps.main[i];
    if (e == 0 && WinStage<HD>::TAIL)
      e = make_tensor_map(&maps.tail[i], base[i], 3, dims, strides, box_tail,
                          CU_TENSOR_MAP_SWIZZLE_32B);
    if (e != 0) return e;
  }
  const WinGeom geo{B, kh, kw, 0, 0, HD, 1, 1, 1, kOrderPlain, B, (N + 63) / 64, N};
  const float* rh = static_cast<const float*>(rel_h);
  const float* rw = static_cast<const float*>(rel_w);
  if (kh == WIN && kw == WIN)  // the windows: the grid fixed when compiled
    return launch_window_attention<HD, true, WIN>(maps, nullptr, rh, rw, out, geo, scale, stream);
  return launch_window_attention<HD, true>(maps, nullptr, rh, rw, out, geo, scale, stream);
}

}  // namespace
}  // namespace samrs

extern "C" {

// Shared-memory bytes the attention kernel needs at (head_dim, window 14);
// the wrapper checks it against the device limit before launching.
long long samrs_window_attention_smem(int head_dim) {
  if (head_dim == 80) return samrs::WinStage<80>::SMEM;
  if (head_dim == 64) return samrs::WinStage<64>::SMEM;
  return -1;
}

// qkv (B, H, W, 3C) bf16 (16-byte aligned base, 3C % 8 == 0), bqkv (3C,)
// bf16 or NULL, Rh/Rw (14, 14, head_dim) fp32 (the gathered (x_q, x_k, d)
// tables), rel a scratch of B * num_heads * nW * 196 * 28 fp32 (nW windows
// of 14 x 14 covering the map) -> out (B, Ho, Wo, C) bf16, the attention
// output before the projection: (Ho, Wo) = (H, W), or the padded map
// (multiples of 14 covering it).  layout 0: an unpartitioned map; 1:
// partitioned windows, H = W = 14.  order 0: plain, 1: batch innermost, 2:
// one window row at a time (the plain sequence).
int samrs_window_attention(const void* qkv, const void* bqkv, const void* Rh, const void* Rw,
                           void* rel, void* out, int B, int H, int W, int Ho, int Wo, int C,
                           int num_heads, int head_dim, int ws, int layout, int order, float scale,
                           void* stream) {
  using namespace samrs;
  const int Hp = (H + WIN - 1) / WIN * WIN, Wp = (W + WIN - 1) / WIN * WIN;
  if (B <= 0 || H <= 0 || W <= 0 || ws != WIN || num_heads * head_dim != C ||
      !((Ho == H && Wo == W) || (Ho == Hp && Wo == Wp)) || order < 0 || order > 2 ||
      (layout == 1 && (H != WIN || W != WIN)) || layout < 0 || layout > 1 || (3 * C) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(qkv) % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80)
    return launch_window<80>(qkv, bqkv, Rh, Rw, rel, out, B, H, W, Ho, Wo, C, num_heads, order,
                             scale, st);
  if (head_dim == 64)
    return launch_window<64>(qkv, bqkv, Rh, Rw, rel, out, B, H, W, Ho, Wo, C, num_heads, order,
                             scale, st);
  return cudaErrorInvalidValue;
}

// K12's window form: q, k, v (B', N, head_dim) bf16 (16-byte aligned
// bases), rel_h (B', N, kh) and rel_w (B', N, kw) fp32 with N = kh * kw <= 196
// and kh + kw <= 32 -> out (B', N, head_dim) fp32.  head_dim 64 or 80.
int samrs_split_attention_window(const void* q, const void* k, const void* v, const void* rel_h,
                                 const void* rel_w, void* out, int B, int N, int head_dim, int kh,
                                 int kw, float scale, void* stream) {
  using namespace samrs;
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
  if (B <= 0 || N <= 0 || N > NT || kh <= 0 || kw <= 0 || kh * kw != N ||
      kh + kw > SPLIT_REL_MAX || bases % 16 != 0)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return launch_split_window<80>(q, k, v, rel_h, rel_w, out, B, N, kh, kw, scale, st);
  if (head_dim == 64) return launch_split_window<64>(q, k, v, rel_h, rel_w, out, B, N, kh, kw, scale, st);
  return cudaErrorInvalidValue;
}

// K12's rel rows on 14 x 14 windows: split-head q (B', 196, head_dim) bf16,
// Rh / Rw (14, 14, head_dim) fp32 -> rel_h (B', 196, 14), rel_w (B', 196,
// 14) fp32; window_rel_kernel with an item a row of B'.  Every pointer
// 16-byte aligned; head_dim 64 or 80.
int samrs_split_window_rel(const void* q, const void* Rh, const void* Rw, void* rel_h,
                           void* rel_w, int B, int head_dim, void* stream) {
  using namespace samrs;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(Rh) |
                         reinterpret_cast<uintptr_t>(Rw) | reinterpret_cast<uintptr_t>(rel_h) |
                         reinterpret_cast<uintptr_t>(rel_w);
  if (B <= 0 || ptrs % 16 != 0) return cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80)
    return launch_window_rel<80, true>(qp, nullptr, Rh, Rw, rel_h, rel_w, B, B, WIN, WIN, 80, 1, 1,
                                       1, st);
  if (head_dim == 64)
    return launch_window_rel<64, true>(qp, nullptr, Rh, Rw, rel_h, rel_w, B, B, WIN, WIN, 64, 1, 1,
                                       1, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
