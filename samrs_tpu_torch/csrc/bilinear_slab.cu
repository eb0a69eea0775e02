// K8-slab: K8's weighted bilinear gather (bilinear_gather.cu), forward and backward, with
// the row slabs of the map that a run of queries touches held on chip.
//
//   out[bg, p, :] = sum_k mask[bg, p, k] * bilinear(xg[bg], fy[bg, p, k], fx[bg, p, k])
//
// xg (BG, H, W, Gc) fp32 or bf16, channels contiguous; fx, fy, mask (BG, P, K) fp32; zero
// padding outside the map; Hs (the slab height) divides H.
//
// Replaces samrs_tpu/kernels/bilinear_gather.py::_make_sampler's slab kernels:
// _fwd_kernel_slab (launched by fwd_call's pallas_call, :386, when slab > 0) and
// bwd_call_slab's pallas_call (:419, _bwd_kernel_slab).  On the TPU each 128-query block's
// hat matmul runs only over the Hs-row slabs that its rows [min fy - 1, max fy + 1] touch,
// tap by tap (the predicate of :189, :233, :250), which saves matrix-unit row reductions.
// The predicate skips only slabs whose hat weights are all zero, so the function is dense
// K8's whatever the block; the 128-query block and the edge padding shape the TPU's work,
// not the result.
//
// Here the work item is a run of L consecutive queries of one map, L chosen at launch from
// the shape (item_plan: at a query a pixel, L spans the output rows of all but two of the
// slabs a stage holds, so that the item's taps reaching a slab beyond either side still fit;
// the whole map where it fits one stage).  An item's band is the union of its taps' active
// slabs under the JAX predicate, from one pass over the item's fy (every tap's extremes kept
// in registers, then one redux a tap).  Each contiguous run of active slabs is one contiguous
// span of the map, staged by one bulk copy (cp.async.bulk on an mbarrier) at its address's
// 16-byte phase (the few elements before and after the 16-byte boundaries by the threads).
// Where the runs do not all fit, whole runs are staged in order of the number of taps whose
// support meets them.  A tap whose two corner rows are both staged reads its corners on chip
// (one run: at an offset from the map's own flat index, no table); any other tap (offsets
// that reach far, a band over the budget, the flat-4 form's second query in the next map)
// reads device memory in the same pass, as dense K8 does.
//
// The forward is persistent: one block of 512 threads an SM, its last warp the producer, which
// plans item j + 1 (the pass, the band, the placement, the bulk copies) into the second of two
// metas and stages while the other 15 warps gather item j; an mbarrier pair a meta hands it
// over (full: planned and landed; empty: gathered).  The gather is dense K8's (bilinear_tap.cuh:
// a thread a (query, channel vector), flat-4 at odd Gc, the taps' count a template parameter
// at the paths' K, a query's taps loaded together; here the next element's taps load while
// this one is gathered), with the band as its corner source.  Each tap's sum keeps K8's corner
// order and rounding and the taps add in order k, so the forward is bit-equal to dense K8's
// (and to sample_weighted_plain).  A build with COUNT counts each (query, tap) by the route it
// took (samrs_bilinear_slab_fwd_count: a measurement, not the paths' launch).
//
// The backward is dense K8's kernel (bilinear_tap.cuh: a group of lanes a query, corners from
// device memory, dX by 16-byte red.global.add.v4.f32 of nonzero vectors), launched on the
// shapes the forward's plan takes.  A band's dX summed on chip (a fixed-point partial on
// native integer shared atomics, one 16-byte flush an item) was built and measured no faster
// than every tap reduced into device memory, and slower at the MSDA level: a value costs a
// split and two shared atomics where one device reduction takes four values (PERF.md,
// Findings).  dX is added, not stored: the wrapper zeroes it, and its summation order varies
// from run to run at fp32 rounding.
//
// Bound: device-memory bytes, as dense K8; the forward stays bound, as dense K8's, by the
// per-tap arithmetic (make_tap, repeated by every lane of a query): PERF.md, Findings.
#include <climits>

#include "bilinear_tap.cuh"
#include "hopper.cuh"

namespace samrs {
namespace {

constexpr int SL_THREADS = 512;
constexpr int SL_WARPS = SL_THREADS / 32;   // the last plans the items, the others gather
constexpr int SL_CONSUMERS = SL_THREADS - 32;
constexpr int SL_BUDGET = 227 * 1024;  // dynamic shared memory a block can use on sm_90
constexpr int SL_MAX_K = 32;           // taps: a band is at most K runs of slabs

// The launch's plan (item_plan) and shape.
struct SlabArgs {
  int H, W, P, K, Gc, Hs, nslab;
  int L;      // queries an item
  int nitem;  // items a map, ceil(P / L)
  int items;  // BG * nitem
  int cap;    // elements each of the two stages of map rows holds (a multiple of 8)
  int meta;   // ints of an item's metadata (meta_ints)
  int n;      // forward: Gc / V vectors a query; flat-4: the flat output's length
  FastDiv by_n, by_p;
};

// An item's metadata in shared memory: per tap the extremes of fy (lohi, as order_key ints),
// the staged runs (runs[0] their count; then per run its first element in the map, its
// elements and its element offset on chip), per slab its element offset on chip (-1: not
// staged; a flag before place_runs) and per map row its element offset on chip (-1); a
// multiple of 16 bytes.
inline int meta_ints(int K, int H, int nslab) {
  return (2 * K + 1 + 3 * K + nslab + H + 3) / 4 * 4;
}

struct Meta {
  int *lohi, *runs, *slab, *rowoff;
  __device__ Meta(int* base, int K, int nslab)
      : lohi(base), runs(base + 2 * K), slab(runs + 1 + 3 * K), rowoff(slab + nslab) {}
};

struct Item {
  int bg, p0, nq;
  int q0;  // flat query index bg * P + p0
};

__device__ __forceinline__ Item item_at(int i, const SlabArgs& a) {
  const int bg = i / a.nitem, p0 = (i - bg * a.nitem) * a.L;
  return {bg, p0, min(a.L, a.P - p0), bg * a.P + p0};
}

// Order-preserving int of a float (NaN above +inf), and back.
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i >= 0 ? i : i ^ 0x7fffffff;
}
__device__ __forceinline__ float from_key(int k) { return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff); }

// JAX's predicate: map rows [top, bottom] against a tap's support [lo - 1, hi + 1].
__device__ __forceinline__ bool rows_active(int top, int bottom, float lo, float hi) {
  return static_cast<float>(top) <= hi + 1.f && static_cast<float>(bottom) >= lo - 1.f;
}

// The producer warp's pass over the item's queries [q0, q0 + nq): every tap's extremes of fy
// (kept in registers, then one redux a tap) into m.lohi.
template <int KT>
__device__ __forceinline__ void item_pass(const float* __restrict__ fy, int q0, int nq, int K,
                                          int lane, const Meta& m) {
  if constexpr (KT > 0) {
    int lo[KT], hi[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k) lo[k] = INT_MAX, hi[k] = INT_MIN;
#pragma unroll 4
    for (int j = lane; j < nq; j += 32) {
      const float* row = fy + static_cast<size_t>(q0 + j) * KT;
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int v = order_key(__ldg(row + k));
        lo[k] = min(lo[k], v);
        hi[k] = max(hi[k], v);
      }
    }
#pragma unroll
    for (int k = 0; k < KT; ++k) {
      const int a = __reduce_min_sync(0xffffffffu, lo[k]), b = __reduce_max_sync(0xffffffffu, hi[k]);
      if (lane == 0) m.lohi[2 * k] = a, m.lohi[2 * k + 1] = b;
    }
  } else {
    for (int k = 0; k < K; ++k) {
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < nq; j += 32) {
        const int v = order_key(__ldg(fy + static_cast<size_t>(q0 + j) * K + k));
        lo = min(lo, v);
        hi = max(hi, v);
      }
      lo = __reduce_min_sync(0xffffffffu, lo);
      hi = __reduce_max_sync(0xffffffffu, hi);
      if (lane == 0) m.lohi[2 * k] = lo, m.lohi[2 * k + 1] = hi;
    }
  }
}

// m.slab[s] = 1 where slab s is active for some tap (threads tid of nth).
__device__ __forceinline__ void mark_slabs(const Meta& m, int K, int nslab, int Hs, int tid,
                                           int nth) {
  for (int s = tid; s < nslab; s += nth) {
    bool on = false;
    for (int k = 0; k < K && !on; ++k)
      on = rows_active(s * Hs, s * Hs + Hs - 1, from_key(m.lohi[2 * k]), from_key(m.lohi[2 * k + 1]));
    m.slab[s] = on;
  }
}

// Thread 0: the runs of active slabs (m.slab's flags) and the ones the chip holds, in `cap`
// elements: all of them in slab order where they fit, else whole runs
// in order of the count of taps whose support meets them (most first, then the lower), each
// where it still fits.  A run starts at an element offset congruent mod 8 to its element index
// f in the maps (f0: the map's first), so that a 16-byte boundary of the map (fp32 or bf16)
// falls on one of the stage.  Writes m.runs and turns m.slab into the slabs' offsets.
__device__ void place_runs(const Meta& m, int K, int nslab, int Hs, int WGc, long long f0,
                           int cap) {
  int ra[SL_MAX_K], rb[SL_MAX_K], order[SL_MAX_K], R = 0;
  for (int s = 0; s < nslab; ++s) {
    if (!m.slab[s]) continue;
    if (R == 0 || rb[R - 1] != s - 1) {
      if (R == SL_MAX_K) break;  // more runs than taps cannot happen; the rest reads device memory
      ra[R++] = s;
    }
    rb[R - 1] = s;
  }
  const int slab_el = Hs * WGc;
  auto phase = [&](int r) { return static_cast<int>((f0 + static_cast<long long>(ra[r]) * slab_el) & 7); };
  auto size = [&](int r) { return static_cast<long long>(rb[r] - ra[r] + 1) * slab_el; };
  long long cur = 0;
  for (int r = 0; r < R; ++r) {
    order[r] = r;
    cur = static_cast<long long>(align_up(cur, 8)) + phase(r) + size(r);
  }
  if (cur > cap) {
    int taps[SL_MAX_K];
    for (int r = 0; r < R; ++r) {
      taps[r] = 0;
      for (int k = 0; k < K; ++k)
        taps[r] += rows_active(ra[r] * Hs, rb[r] * Hs + Hs - 1, from_key(m.lohi[2 * k]),
                               from_key(m.lohi[2 * k + 1]));
    }
    for (int r = 1; r < R; ++r)  // insertion sort, stable: most taps first
      for (int j = r; j > 0 && taps[order[j]] > taps[order[j - 1]]; --j) {
        const int t = order[j];
        order[j] = order[j - 1];
        order[j - 1] = t;
      }
  }
  for (int s = 0; s < nslab; ++s) m.slab[s] = -1;
  int placed = 0;
  cur = 0;
  for (int j = 0; j < R; ++j) {
    const int r = order[j];
    const long long off = static_cast<long long>(align_up(cur, 8)) + phase(r);
    if (off + size(r) > cap) continue;
    cur = off + size(r);
    m.runs[1 + 3 * placed] = ra[r] * slab_el;
    m.runs[2 + 3 * placed] = static_cast<int>(size(r));
    m.runs[3 + 3 * placed] = static_cast<int>(off);
    for (int s = ra[r]; s <= rb[r]; ++s) m.slab[s] = static_cast<int>(off) + (s - ra[r]) * slab_el;
    ++placed;
  }
  m.runs[0] = placed;
}

// Thread 0: the bulk copies of the placed runs' aligned middles from the map `img` to the
// stage `st`, completing on bar.
template <typename T>
__device__ void issue_copies(const Meta& m, const T* img, T* st, uint64_t* bar) {
  unsigned total = 0;
  for (int j = 0; j < m.runs[0]; ++j) {
    int h, t;
    split16(img + m.runs[1 + 3 * j], m.runs[2 + 3 * j], h, t);
    total += static_cast<unsigned>((t - h) * sizeof(T));
  }
  mbar_expect_tx(bar, total);
  for (int j = 0; j < m.runs[0]; ++j) {
    const T* g = img + m.runs[1 + 3 * j];
    int h, t;
    split16(g, m.runs[2 + 3 * j], h, t);
    if (t > h) bulk_load(st + m.runs[3 + 3 * j] + h, g + h, static_cast<unsigned>((t - h) * sizeof(T)), bar);
  }
}

// The runs' elements before and after their 16-byte boundaries (threads tid of nth).
template <typename T>
__device__ __forceinline__ void copy_ends(const Meta& m, const T* img, T* st, int tid, int nth) {
  for (int j = 0; j < m.runs[0]; ++j) {
    const T* g = img + m.runs[1 + 3 * j];
    T* s = st + m.runs[3 + 3 * j];
    const int n = m.runs[2 + 3 * j];
    int h, t;
    split16(g, n, h, t);
    for (int e = tid; e < h + n - t; e += nth) {
      const int f = e < h ? e : t + (e - h);  // the head, then the tail
      s[f] = g[f];
    }
  }
}

// Where the rows of the item's map sit on chip: one run by arithmetic (its first map element
// m.runs[1] is element m.runs[3] on chip), several by m.rowoff.
__device__ __forceinline__ Rows rows_of(const Meta& m, int WGc) {
  if (m.runs[0] == 1) return {nullptr, m.runs[1] / WGc, m.runs[2] / WGc, m.runs[3] - m.runs[1]};
  return {m.runs[0] > 1 ? m.rowoff : nullptr, 0, 0, 0};
}

// m.rowoff from the slabs' offsets (threads tid of nth).
__device__ __forceinline__ void fill_rowoff(const Meta& m, int H, int Hs, int WGc, int tid,
                                            int nth) {
  for (int y = tid; y < H; y += nth) {
    const int s = y / Hs, o = m.slab[s];
    m.rowoff[y] = o < 0 ? -1 : o + (y - s * Hs) * WGc;
  }
}

// The producer warp plans item `it` into meta m: the pass, the active slabs, lane 0's
// placement in a.cap elements, the rows' offsets and the runs' ends copied to the stage `st`.
// Ends with a __syncwarp: lane 0 then arrives on the item's barrier with the runs' bulk
// copies, releasing every lane's writes to the consumers.
template <typename T, int KT>
__device__ void plan_item(const Item& it, const SlabArgs& a, const Meta& m, const T* img,
                          const float* fy, T* st, int lane) {
  const int WGc = a.W * a.Gc;
  item_pass<KT>(fy, it.q0, it.nq, a.K, lane, m);
  __syncwarp();
  mark_slabs(m, a.K, a.nslab, a.Hs, lane, 32);
  __syncwarp();
  if (lane == 0)
    place_runs(m, a.K, a.nslab, a.Hs, WGc, static_cast<long long>(it.bg) * a.H * WGc, a.cap);
  __syncwarp();
  fill_rowoff(m, a.H, a.Hs, WGc, lane, 32);
  copy_ends(m, img, st, lane, 32);
  __syncwarp();
}

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

template <typename T, int V, int KT, int FORM, bool COUNT>
__device__ __forceinline__ void gather_item(const Item& it, const SlabArgs& a,
                                            const T* __restrict__ xg,
                                            const float* __restrict__ fx,
                                            const float* __restrict__ fy,
                                            const float* __restrict__ mask,
                                            float* __restrict__ out, const T* st,
                                            const Rows& rows, unsigned* tally, int tid, int nth) {
  const size_t map = static_cast<size_t>(a.H) * a.W * a.Gc;
  if constexpr (FORM == kFlat4) {
    // group g (outputs 4g .. 4g + 3) belongs to the item that holds query floor(4g / Gc)
    const BandFamily<T, COUNT> maps{xg, map, st, rows, a.W * a.Gc,
                                    static_cast<unsigned>(it.bg), tally};
    const int g0 = (it.q0 * a.Gc + 3) / 4, g1 = ((it.q0 + it.nq) * a.Gc + 3) / 4;
    for (int g = g0 + tid; g < g1; g += nth)
      gather_flat4<T, KT>(maps, fx, fy, mask, out, 4 * g, a.n, a.by_n, a.by_p, a.H, a.W, a.Gc);
  } else {
    const BandCorners<T, COUNT> src{xg + it.bg * map, st, rows, a.W * a.Gc, tally};
    const int ne = it.nq * a.n;
    auto query = [&](int e) { return it.q0 + static_cast<int>(fast_div(e, a.by_n)); };
    if constexpr (KT == 0) {
      for (int e = tid; e < ne; e += nth) {
        const int q = query(e), c = (e - (q - it.q0) * a.n) * V;
        gather_vector<V, KT, int>(src, fx, fy, mask, out + static_cast<size_t>(q) * a.Gc, q, c,
                                  a.H, a.W, a.K, a.Gc);
      }
    } else {  // the next element's taps load while this one is gathered
      int e = tid;
      Taps<KT> cur, nxt;
      if (e < ne) load_taps<KT>(cur, fx, fy, mask, query(e));
      for (; e < ne; e += nth) {
        const int q = query(e), c = (e - (q - it.q0) * a.n) * V;
        if (e + nth < ne) load_taps<KT>(nxt, fx, fy, mask, query(e + nth));
        gather_taps<V, KT>(src, cur, out + static_cast<size_t>(q) * a.Gc, c, a.H, a.W, a.Gc);
        cur = nxt;
      }
    }
  }
}

// Shared memory: four mbarriers (32 bytes: full and empty of two stages), two metas, two
// stages of a.cap elements.  The last warp plans item j + 1 (its band by bulk copies) while
// the others gather item j.  COUNT: routes[0] / routes[1] += the taps read from the band /
// from device memory.
template <typename T, int V, int KT, int FORM, bool COUNT>
__global__ void __launch_bounds__(SL_THREADS, 1)
slab_fwd_kernel(const T* __restrict__ xg, const float* __restrict__ fx,
                const float* __restrict__ fy, const float* __restrict__ mask,
                float* __restrict__ out, const SlabArgs a, unsigned long long* routes) {
  extern __shared__ __align__(16) unsigned char sl_smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(sl_smem);
  uint64_t* empty = full + 2;
  int* mb = reinterpret_cast<int*>(sl_smem + 32);
  auto meta = [&](int s) { return Meta(mb + s * a.meta, a.K, a.nslab); };
  auto stage = [&](int s) { return reinterpret_cast<T*>(sl_smem + 32 + 8 * a.meta) + s * a.cap; };
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], SL_WARPS - 1);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const size_t map = static_cast<size_t>(a.H) * a.W * a.Gc;
  if (warp == SL_WARPS - 1) {  // the producer
    int j = 0;
    for (int i = blockIdx.x; i < a.items; i += gridDim.x, ++j) {
      const int s = j & 1;
      if (j >= 2) mbar_wait(&empty[s], ((j - 2) >> 1) & 1);  // item j - 2 is gathered
      const Item it = item_at(i, a);
      const T* img = xg + it.bg * map;
      plan_item<T, KT>(it, a, meta(s), img, fy, stage(s), lane);
      if (lane == 0) issue_copies(meta(s), img, stage(s), &full[s]);
    }
    return;
  }
  unsigned tally[2] = {0, 0};
  int j = 0;
  for (int i = blockIdx.x; i < a.items; i += gridDim.x, ++j) {
    const int s = j & 1;
    mbar_wait(&full[s], (j >> 1) & 1);
    gather_item<T, V, KT, FORM, COUNT>(item_at(i, a), a, xg, fx, fy, mask, out, stage(s),
                                       rows_of(meta(s), a.W * a.Gc), tally, threadIdx.x,
                                       SL_CONSUMERS);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }
  if constexpr (COUNT) {
    atomicAdd(routes, static_cast<unsigned long long>(tally[0]));
    atomicAdd(routes + 1, static_cast<unsigned long long>(tally[1]));
  }
}

// ---------------------------------------------------------------------------
// Launch.
// ---------------------------------------------------------------------------

// The plan of a launch (the wrapper's samrs_tpu_torch/kernels/bilinear_gather.py::slab_plan
// refuses the same shapes): false where none takes the shape.  `cap` elements a stage: the
// whole map where it fits (one item a map), else as many slabs as fit (8 elements each for
// the run's phase), and an item spans the output rows of all but two of them (one slab where
// fewer than three fit).  Two stages of map rows.
bool item_plan(int BG, int H, int W, int P, int K, int Gc, int Hs, int esz, SlabArgs& a,
               int& smem) {
  if (BG <= 0 || H <= 0 || W <= 0 || P <= 0 || K <= 0 || Gc <= 0 || Hs <= 0 || H % Hs ||
      K > SL_MAX_K)
    return false;
  const long long lim = 1LL << 31, BP = static_cast<long long>(BG) * P;
  if (BP * K >= lim || BP * Gc + 4 >= lim || static_cast<long long>(H) * W * Gc >= lim)
    return false;
  a.H = H, a.W = W, a.P = P, a.K = K, a.Gc = Gc, a.Hs = Hs, a.nslab = H / Hs;
  a.meta = meta_ints(K, H, a.nslab);
  const long long fixed = 32 + 8LL * a.meta;  // four mbarriers, two metas
  if (fixed + 1024 > SL_BUDGET) return false;
  const long long slab_el = static_cast<long long>(Hs) * W * Gc, whole = a.nslab * slab_el + 8;
  const int per = 2 * esz;  // bytes an element: two stages
  const long long cmax = (SL_BUDGET - fixed) / per / 8 * 8;
  long long L = P, cap = align_up(whole, 8);
  if (whole > cmax) {
    const long long C = cmax / (slab_el + 8);
    L = (C >= 3 ? C - 2 : 1) * Hs * W;
    cap = C * (slab_el + 8);
  }
  a.L = static_cast<int>(L < P ? L : P);
  a.nitem = (P + a.L - 1) / a.L;
  a.items = static_cast<int>(BG * static_cast<long long>(a.nitem));
  a.cap = static_cast<int>(cap);
  smem = static_cast<int>(fixed + cap * per);
  return true;
}

template <typename K>
int grid_for(K kernel, int smem, int items, int& grid) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, SL_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorInvalidConfiguration;
  grid = min(items, occ * sm_count());
  return cudaSuccess;
}

template <typename T, int V, int KT, int FORM, bool COUNT>
int launch_fwd_k(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
                 SlabArgs a, int smem, void* routes, cudaStream_t stream) {
  auto kernel = slab_fwd_kernel<T, V, KT, FORM, COUNT>;
  int grid = 0;
  const int err = grid_for(kernel, smem, a.items, grid);
  if (err != cudaSuccess) return err;
  kernel<<<grid, SL_THREADS, smem, stream>>>(
      static_cast<const T*>(xg), static_cast<const float*>(fx), static_cast<const float*>(fy),
      static_cast<const float*>(mask), static_cast<float*>(out), a,
      static_cast<unsigned long long*>(routes));
  return cudaGetLastError();
}

template <typename T, int V, int FORM>
int launch_fwd_taps(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
                    SlabArgs a, int smem, void* routes, cudaStream_t stream) {
  if (routes != nullptr) {  // the measurement build
    switch (a.K) {
      case 4: return launch_fwd_k<T, V, 4, FORM, true>(xg, fx, fy, mask, out, a, smem, routes, stream);
      case 9: return launch_fwd_k<T, V, 9, FORM, true>(xg, fx, fy, mask, out, a, smem, routes, stream);
      default: return launch_fwd_k<T, V, 0, FORM, true>(xg, fx, fy, mask, out, a, smem, routes, stream);
    }
  }
  switch (a.K) {
    case 4: return launch_fwd_k<T, V, 4, FORM, false>(xg, fx, fy, mask, out, a, smem, routes, stream);
    case 9: return launch_fwd_k<T, V, 9, FORM, false>(xg, fx, fy, mask, out, a, smem, routes, stream);
    default: return launch_fwd_k<T, V, 0, FORM, false>(xg, fx, fy, mask, out, a, smem, routes, stream);
  }
}

// dense K8's forms: V = 4 / 2 / 1 by Gc, flat-4 at odd Gc >= 3
template <typename T>
int launch_fwd(const void* xg, const void* fx, const void* fy, const void* mask, void* out,
               int BG, int H, int W, int P, int K, int Gc, int Hs, void* routes,
               cudaStream_t stream) {
  SlabArgs a;
  int smem = 0;
  if (!item_plan(BG, H, W, P, K, Gc, Hs, sizeof(T), a, smem)) return cudaErrorInvalidValue;
  a.by_p = make_fastdiv(static_cast<unsigned>(P));
  if (Gc % 2 && Gc >= 3) {
    a.n = BG * P * Gc;
    a.by_n = make_fastdiv(static_cast<unsigned>(Gc));
    return launch_fwd_taps<T, 1, kFlat4>(xg, fx, fy, mask, out, a, smem, routes, stream);
  }
  const int V = Gc % 4 == 0 ? 4 : Gc % 2 == 0 ? 2 : 1;
  a.n = Gc / V;
  a.by_n = make_fastdiv(static_cast<unsigned>(a.n));
  if (V == 4) return launch_fwd_taps<T, 4, kVector>(xg, fx, fy, mask, out, a, smem, routes, stream);
  if (V == 2) return launch_fwd_taps<T, 2, kVector>(xg, fx, fy, mask, out, a, smem, routes, stream);
  return launch_fwd_taps<T, 1, kVector>(xg, fx, fy, mask, out, a, smem, routes, stream);
}

int slab_fwd(const void* xg, const void* fx, const void* fy, const void* mask, void* out, int BG,
             int H, int W, int P, int K, int Gc, int Hs, int is_bf16, void* routes,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch_fwd<bf16>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, Hs, routes, s)
                 : launch_fwd<float>(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, Hs, routes, s);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K8 row-slab forward.  xg (BG, H, W, Gc) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); fx, fy,
// mask (BG, P, K) fp32; out (BG, P, Gc) fp32; Hs divides H.  All contiguous, with 16-byte
// aligned bases (torch's allocations).  cudaErrorInvalidValue where no plan takes the shape.
int samrs_bilinear_slab_fwd(const void* xg, const void* fx, const void* fy, const void* mask,
                            void* out, int BG, int H, int W, int P, int K, int Gc, int Hs,
                            int is_bf16, void* stream) {
  return samrs::slab_fwd(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, Hs, is_bf16, nullptr,
                         stream);
}

// The row-slab forward built to count its taps by route (a measurement): as
// samrs_bilinear_slab_fwd, and routes (two uint64 on the card) += the (query, tap) pairs whose
// corners were read from the band and from device memory.
int samrs_bilinear_slab_fwd_count(const void* xg, const void* fx, const void* fy,
                                  const void* mask, void* out, int BG, int H, int W, int P, int K,
                                  int Gc, int Hs, int is_bf16, void* routes, void* stream) {
  if (routes == nullptr) return cudaErrorInvalidValue;
  return samrs::slab_fwd(xg, fx, fy, mask, out, BG, H, W, P, K, Gc, Hs, is_bf16, routes,
                         stream);
}

// K8 row-slab backward: dense K8's backward kernel on the shapes the forward's plan takes.
// dout (BG, P, Gc) fp32; dxg (BG, H, W, Gc) fp32, zeroed by the caller and accumulated with
// reductions; dfx, dfy, dmask (BG, P, K) fp32.
int samrs_bilinear_slab_bwd(const void* xg, const void* fx, const void* fy, const void* mask,
                            const void* dout, void* dxg, void* dfx, void* dfy, void* dmask, int BG,
                            int H, int W, int P, int K, int Gc, int Hs, int is_bf16,
                            void* stream) {
  samrs::SlabArgs a;
  int smem = 0;
  if (!samrs::item_plan(BG, H, W, P, K, Gc, Hs, is_bf16 ? 2 : 4, a, smem))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? samrs::launch_bilinear_bwd<samrs::bf16>(xg, fx, fy, mask, dout, dxg, dfx, dfy,
                                                          dmask, nullptr, BG, H, W, P, K, Gc, s)
                 : samrs::launch_bilinear_bwd<float>(xg, fx, fy, mask, dout, dxg, dfx, dfy, dmask,
                                                     nullptr, BG, H, W, P, K, Gc, s);
}

}  // extern "C"
