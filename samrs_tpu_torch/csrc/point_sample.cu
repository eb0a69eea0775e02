// K9: per-mask single-channel bilinear point sample, forward and backward.
//
//   out[n, k] = bilinear(img[n], fy[n, k], fx[n, k])
//
// img (N, H, W) fp32 or bf16, zero padding off the map, out (N, K) fp32.  Two entries share
// every kernel through the coordinate loader (a template parameter).  The coordinate entry
// takes coords (N, K, 2), xy in [0, 1] (mmcv's point_sample, align_corners=False), and turns
// a point into pixel coordinates in registers, f = ((2c - 1 + 1) * size - 1) * 0.5, each
// operation rounded on its own in the order of the eager glue it replaces
// (bilinear_gather.pixel_coords), so its points are the glue's bit for bit.  The pixel
// entry takes fx, fy (N, K) as they are.  The Mask2Former point losses call the coordinate
// entry on the N = B x 100 mask logits and their matched targets at K 12544 points each
// (37632 for the uncertainty candidates), on 56 x 56 maps at 224^2.
//
// Replaces samrs_tpu/kernels/bilinear_gather.py::_make_point_sampler (the forward
// pallas_call :762 and the backward :786), and in the coordinate entry the [0, 1] -> pixel
// arithmetic that XLA fuses into that sampler's inputs (samrs_tpu/seg/decoders/
// mask2former.py:421; samrs_tpu/kernels/bilinear_gather.py:824-838).  The TPU kernels put
// the points in lanes and gathered through "hat" matmuls on the matrix unit; here it is the
// direct four-corner gather.
//
// Bound: device bytes.  Forward: the map once and 12 bytes a point (8 of coordinates, 4 of
// output).  The path's backward (dimg only): dimg once and 12 bytes a point (coordinates,
// dout).  With the coordinate gradient: the map and dimg once and 20 bytes a point.  Forms
// (bilinear_gather.point_sample_plan picks one from the shape; plan_ok below is the
// authority on what a form takes, and the entries refuse a form that does not take the
// shape):
//
//   SMEM: the map fits a block's shared memory (12.5 KB at 56 x 56).  One bulk async copy
//     (cp.async.bulk, completing on an mbarrier) stages it while the threads load their
//     first coordinates; each thread takes VEC = 4 consecutive points at once (two 16-byte
//     coordinate loads, one 16-byte streaming store) and loads its next group before it
//     computes this one.  The forward splits a mask's points over `blocks` blocks, each with
//     its own copy of the map, only where the masks alone are too few to fill the card.
//     The backward takes one block a mask, which owns the mask's whole dimg partial in
//     shared memory (fixed point, see Fixed: native integer atomics) and writes it once with
//     16-byte stores: dimg needs no memset and no device atomics.  It stages the map only
//     for the coordinate gradient.
//   BANDS: the backward of dimg alone where one block cannot hold dimg's partial: `blocks`
//     (2, 4 or 8) blocks a mask, block r owning rows [r R, r R + R), R = ceil(H / blocks),
//     of it.  Every block reads all of the mask's points (from L2 after the first) and adds
//     the corners that lie in its own band, so no add crosses to another block (256 x 256:
//     4 blocks of 128 KB).
//   GLOBAL: every other shape (the forward past one block's map, the backward with the
//     coordinate gradient past one block's).  One point a thread, corners from device
//     memory, dimg by device atomics into a zeroed buffer.  (At 256 x 256 a thread-block
//     cluster holding the map in distributed shared memory was no faster in the forward.)
//
// Every shared copy sits at its device address's 16-byte phase, so that the bulk copy and
// the 16-byte stores see aligned addresses on both sides for any N, H, W; the few elements
// before the first and after the last 16-byte boundary go element by element.
//
// The forward rounds each product and sum on its own, in the plain version's order
// (point_sample_plain), so the two agree bit for bit: the uncertainty sampling keeps the
// top-k of the candidates' |logit|, and a 1-ulp difference would change which points it
// keeps.  The coordinate derivative is the one-sided one of the floor formula, exactly JAX's
// _dhat (see K8).  dimg's fixed-point sums do not depend on the order of the adds; the GLOBAL
// form's fp32 atomics make its summation order vary from run to run.
#include "common.cuh"
#include "hopper.cuh"

namespace samrs {
namespace {

enum Form { SMEM = 0, BANDS = 1, GLOBAL = 2 };
constexpr int VEC = 4;                     // a block's share of a mask's points: a multiple of this
constexpr int SMEM_BUDGET = 227 * 1024;    // shared memory a block can use on sm_90
constexpr int SMEM_DEFAULT = 48 * 1024;    // above this a kernel needs the opt-in
constexpr int MAX_BLOCKS = 8;  // blocks a mask: a forward's split, or bands (each reads every point)
constexpr int MAX_SIDE = 1 << 22;          // H, W: exact float pixel coordinates
// Shared memory: [0, 8) the mbarrier, [16, 144) 32 floats of scratch, then the arrays
// (bilinear_gather._ps_smem_bytes).
constexpr int HEADER = 144;

// Consecutive points a thread takes at once, threads a block and blocks an SM the registers
// are sized for, in the SMEM form's forward, backward and backward with the coordinate
// gradient (the best of chip_breakdown.py's fwd_* / bwd_* variants; the forward's threads are
// bilinear_gather.PS_THREADS); the BANDS form runs 1024 threads (one block an SM), GLOBAL 256.
constexpr int FWD_VEC = 4, SMEM_FWD_THREADS = 512, SMEM_FWD_BLOCKS = 3;
constexpr int BWD_VEC = 2, SMEM_BWD_THREADS = 256, SMEM_BWD_BLOCKS = 6;
constexpr int SMEM_GRAD_THREADS = 512, SMEM_GRAD_BLOCKS = 3;
constexpr int BANDS_THREADS = 1024, GLOBAL_THREADS = 256;
#define PS_BWD_THREADS(FORM, GRAD) \
  ((FORM) == BANDS ? BANDS_THREADS : (GRAD) ? SMEM_GRAD_THREADS : SMEM_BWD_THREADS)
#define PS_BWD_MIN_BLOCKS(FORM, GRAD) \
  ((FORM) == BANDS ? 1 : (GRAD) ? SMEM_GRAD_BLOCKS : SMEM_BWD_BLOCKS)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// A [0, 1] coordinate -> absolute pixel coordinate (align_corners=False) through the JAX
// package's [-1, 1] grid, rounded as the eager glue rounds it: g = 2c - 1 (2c is exact, so
// one fma rounds as the glue's subtraction), ((g + 1) * size - 1) * 0.5 (the halving is
// exact, so fma(v, 0.5, -0.5) rounds as the glue's subtraction).
__device__ __forceinline__ float to_pixel(float c, float size) {
  const float g = __fmaf_rn(c, 2.f, -1.f);
  return __fmaf_rn(__fmul_rn(__fadd_rn(g, 1.f), size), 0.5f, -0.5f);
}

// dL/dc from dL/df for f = to_pixel(c): autograd's chain through the same glue, in its order.
__device__ __forceinline__ float to_coord_grad(float d, float size) {
  return __fmul_rn(__fmul_rn(__fmul_rn(d, 0.5f), size), 2.f);
}

// ---------------------------------------------------------------------------
// The pieces every form shares.
// ---------------------------------------------------------------------------

// NF consecutive floats (1, 2, 4 or 8), 4 NF-byte aligned up to 16, as streaming loads
// (read once; LAST = false: read again soon, so cached) and stores (not read again by this
// kernel).
template <typename V>
__device__ __forceinline__ V load_one(const V* p, bool last) {
  return last ? __ldcs(p) : __ldg(p);
}

template <int NF, bool LAST = true>
__device__ __forceinline__ void load_stream(const float* p, float (&r)[NF]) {
  if constexpr (NF == 1) {
    r[0] = load_one(p, LAST);
  } else if constexpr (NF == 2) {
    const float2 v = load_one(reinterpret_cast<const float2*>(p), LAST);
    r[0] = v.x;
    r[1] = v.y;
  } else {
#pragma unroll
    for (int q = 0; q < NF / 4; ++q) {
      const float4 v = load_one(reinterpret_cast<const float4*>(p) + q, LAST);
      r[4 * q] = v.x; r[4 * q + 1] = v.y; r[4 * q + 2] = v.z; r[4 * q + 3] = v.w;
    }
  }
}

template <int NF>
__device__ __forceinline__ void store_stream(float* p, const float (&v)[NF]) {
  if constexpr (NF == 1) {
    __stcs(p, v[0]);
  } else if constexpr (NF == 2) {
    __stcs(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int q = 0; q < NF / 4; ++q)
      __stcs(reinterpret_cast<float4*>(p) + q,
             make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]));
  }
}

// The points of one call: coords (N, K, 2) in [0, 1] (COORDS) or fx, fy (N, K) in pixels.
// A group of V points is loaded as it lies in memory into r (x, y interleaved: one 8-byte
// load a point, 16 bytes for two) and converted point by point when it is used.
template <bool COORDS>
struct Points {
  const float* a;  // coords, or fx
  const float* b;  // fy; null with COORDS
  float W, H;

  // V points from flat index f, a multiple of V
  template <int V>
  __device__ __forceinline__ void load(size_t f, float (&r)[2 * V]) const {
    if constexpr (COORDS) {
      load_stream<2 * V>(a + 2 * f, r);
    } else {
      float x[V], y[V];
      load_stream<V>(a + f, x);
      load_stream<V>(b + f, y);
#pragma unroll
      for (int q = 0; q < V; ++q) {
        r[2 * q] = x[q];
        r[2 * q + 1] = y[q];
      }
    }
  }
  __device__ __forceinline__ float fx(float v) const { return COORDS ? to_pixel(v, W) : v; }
  __device__ __forceinline__ float fy(float v) const { return COORDS ? to_pixel(v, H) : v; }
};

// The coordinate gradients: dcoords (N, K, 2) (COORDS) or dfx, dfy (N, K); g holds a group's
// dL/dfx, dL/dfy interleaved.
template <bool COORDS>
struct CoordGrads {
  float* a;  // dcoords, or dfx
  float* b;  // dfy; null with COORDS
  float W, H;

  template <int V>
  __device__ __forceinline__ void store(size_t f, const float (&g)[2 * V]) const {
    if constexpr (COORDS) {
      float d[2 * V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        d[2 * q] = to_coord_grad(g[2 * q], W);
        d[2 * q + 1] = to_coord_grad(g[2 * q + 1], H);
      }
      store_stream<2 * V>(a + 2 * f, d);
    } else {
      float x[V], y[V];
#pragma unroll
      for (int q = 0; q < V; ++q) {
        x[q] = g[2 * q];
        y[q] = g[2 * q + 1];
      }
      store_stream<V>(a + f, x);
      store_stream<V>(b + f, y);
    }
  }
};

// A mask's map: read one corner (0 off the map).
template <typename T, int FORM>
struct Image {
  const T* p;  // SMEM: the staged map; GLOBAL: the mask's map
  __device__ __forceinline__ float at(bool valid, int i) const {
    if (!valid) return 0.f;
    if constexpr (FORM == SMEM) {
      return to_float(p[i]);
    } else {
      return to_float(__ldg(p + i));
    }
  }
};

// dimg's partial in shared memory (SMEM, BANDS) is fixed point, two int32 words a pixel
// added by native integer atomics: a shared-memory fp32 atomicAdd is a compare-and-swap loop
// on sm_90 (ATOMS.CAST.SPIN: a read and a CAS a value).  A contribution v becomes x = v 2^sh,
// hi = rint(x) and lo = rint((x - hi) 2^lob).  sh is set from S = sum |dout| over the mask's
// points, so that every pixel's sum stays below 2^21 in hi units (|sum v| <= S), and lob
// (<= 22) so that K lo words stay below 2^31.  The pixel's value (hi + lo 2^-lob) 2^-sh is
// rounded once to fp32; its resolution, S 2^-(21 + lob), is ~2^-39 S at K 12544, far below
// fp32's own rounding of the sum.  Both roundings to an integer use the 1.5 2^23 trick
// (|x| < 2^22): full-rate fp32 adds, no conversion instructions.
struct Fixed {
  float to_x;   // 2^sh
  float to_lo;  // 2^lob
  __device__ __forceinline__ void split(float v, int& hi, int& lo) const {
    constexpr float M = 12582912.f;  // 1.5 2^23
    // x = v 2^sh is exact (a power of two, |x| < 2^21), so each fma rounds once, as a plain add
    const float xr = __fmaf_rn(v, to_x, M);
    hi = __float_as_int(xr) - __float_as_int(M);
    const float rem = __fmaf_rn(v, to_x, -__fsub_rn(xr, M));  // x - rint(x), exact
    lo = __float_as_int(__fmaf_rn(rem, to_lo, M)) - __float_as_int(M);
  }
};

__device__ __forceinline__ float exp2f_int(int k) {  // 2^k, -126 <= k <= 127
  return __int_as_float((k + 127) << 23);
}

// The fixed point of a mask whose points' |dout| sum to S (K points a mask).
__device__ __forceinline__ Fixed fixed_for(float S, int K, int& sh, int& lob) {
  lob = min(22, __clz(K));  // K < 2^(32 - lob): K lo words of at most 2^(lob - 1) fit 2^31
  int e = 0;
  if (S > 0.f && S <= 3.402823466e38f) frexpf(S, &e);  // S < 2^e
  sh = max(-126, min(127, 21 - e));
  return Fixed{exp2f_int(sh), exp2f_int(lob)};
}

// A mask's dimg: add into one pixel (row y).  In the BANDS form every block sees every point
// of the mask and adds only into its own band, rows [r0, r1) (so no add crosses to another
// block).
template <int FORM>
struct Dimg {
  float* p;   // GLOBAL: the mask's dimg in device memory
  int* hi;    // SMEM, BANDS: the block's partial (its band's, from row r0)
  int* lo;
  int i0;     // the band's first pixel, r0 W
  int r0, r1;
  Fixed fixed;
  __device__ __forceinline__ void add(int y, int i, float v) const {
    if constexpr (FORM == GLOBAL) {
      if (v != 0.f) atomicAdd(p + i, v);
    } else {
      if (FORM == BANDS && (y < r0 || y >= r1)) return;
      int h, l;
      fixed.split(v, h, l);
      if (h) atomicAdd(hi + (i - i0), h);
      if (l) atomicAdd(lo + (i - i0), l);
    }
  }
};

// One point's four corners, as bilinear_tap.cuh's make_tap takes them (the floor, the weights
// in the plain version's rounding, which corners lie on the map) without the clamped
// indices: a corner off the map is never read or added to here, so the indices need no
// clamp and the weights no select (a term of an off-map corner is 0 * w, as make_tap's
// value 0 * weight 0).
struct Corners {
  int i00, y0;                // y0 * W + x0 (wrapping; used where a corner is on the map), y0
  float wx, wy, w00, w01, w10, w11;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Corners corners(float fx, float fy, int H, int W) {
  Corners c;
  const float x0f = floorf(fx), y0f = floorf(fy);
  c.wx = fx - x0f;
  c.wy = fy - y0f;
  const int x0 = __float2int_rz(x0f), y0 = __float2int_rz(y0f);  // saturating
  const bool vx0 = static_cast<unsigned>(x0) < static_cast<unsigned>(W);
  const bool vx1 = static_cast<unsigned>(x0) + 1u < static_cast<unsigned>(W);
  const bool vy0 = static_cast<unsigned>(y0) < static_cast<unsigned>(H);
  const bool vy1 = static_cast<unsigned>(y0) + 1u < static_cast<unsigned>(H);
  c.v00 = vy0 && vx0; c.v01 = vy0 && vx1; c.v10 = vy1 && vx0; c.v11 = vy1 && vx1;
  c.y0 = y0;
  c.i00 = static_cast<int>(static_cast<unsigned>(y0) * static_cast<unsigned>(W) +
                           static_cast<unsigned>(x0));
  const float ax = 1.f - c.wx, ay = 1.f - c.wy;
  c.w00 = ax * ay;
  c.w01 = c.wx * ay;
  c.w10 = ax * c.wy;
  c.w11 = c.wx * c.wy;
  return c;
}

template <class Img>
__device__ __forceinline__ float sample(const Img& im, float fx, float fy, int H, int W) {
  const Corners c = corners(fx, fy, H, W);
  const float v00 = im.at(c.v00, c.i00), v01 = im.at(c.v01, c.i00 + 1);
  const float v10 = im.at(c.v10, c.i00 + W), v11 = im.at(c.v11, c.i00 + W + 1);
  // rounded op by op (no fused multiply-add), in the plain version's order
  float s = __fmul_rn(v00, c.w00);
  s = __fadd_rn(s, __fmul_rn(v01, c.w01));
  s = __fadd_rn(s, __fmul_rn(v10, c.w10));
  return __fadd_rn(s, __fmul_rn(v11, c.w11));
}

// One point of the backward: its dimg adds (corners on the map) and, with GRAD, its dL/dfx,
// dL/dfy, rounded op by op as point_sample_plain_bwd rounds them.
template <bool GRAD, class Img, class Acc>
__device__ __forceinline__ void scatter(const Img& im, const Acc& acc, float fx, float fy,
                                        float r, int H, int W, float& gx, float& gy) {
  const Corners c = corners(fx, fy, H, W);
  if constexpr (GRAD) {
    const float v00 = im.at(c.v00, c.i00), v01 = im.at(c.v01, c.i00 + 1);
    const float v10 = im.at(c.v10, c.i00 + W), v11 = im.at(c.v11, c.i00 + W + 1);
    const float ax = 1.f - c.wx, ay = 1.f - c.wy;
    gx = __fmul_rn(r, __fadd_rn(__fmul_rn(__fsub_rn(v01, v00), ay),
                                __fmul_rn(__fsub_rn(v11, v10), c.wy)));
    gy = __fmul_rn(r, __fsub_rn(__fadd_rn(__fmul_rn(v10, ax), __fmul_rn(v11, c.wx)),
                                __fadd_rn(__fmul_rn(v00, ax), __fmul_rn(v01, c.wx))));
  }
  if (c.v00) acc.add(c.y0, c.i00, __fmul_rn(r, c.w00));
  if (c.v01) acc.add(c.y0, c.i00 + 1, __fmul_rn(r, c.w01));
  if (c.v10) acc.add(c.y0 + 1, c.i00 + W, __fmul_rn(r, c.w10));
  if (c.v11) acc.add(c.y0 + 1, c.i00 + W + 1, __fmul_rn(r, c.w11));
}

// Copies n elements from device memory g into s (at g's 16-byte phase): thread 0 issues one
// bulk copy of the aligned middle, completing on bar (an empty middle arrives with no
// bytes); the threads copy the head and the tail.  Every thread then __syncthreads() and
// waits on bar.
template <typename T>
__device__ __forceinline__ void stage(T* s, const T* g, int n, uint64_t* bar) {
  int h, t;
  split16(g, n, h, t);
  for (int e = threadIdx.x; e < h; e += blockDim.x) s[e] = g[e];
  for (int e = t + static_cast<int>(threadIdx.x); e < n; e += blockDim.x) s[e] = g[e];
  if (threadIdx.x == 0) {
    const unsigned bytes = static_cast<unsigned>((t - h) * sizeof(T));
    mbar_expect_tx(bar, bytes);
    if (bytes) bulk_load(s + h, g + h, bytes, bar);
  }
}

// Writes the n pixels of a fixed-point partial (hi, lo in shared memory at g's 16-byte phase)
// to device memory g as fp32, (hi 2^lob + lo) 2^-(sh + lob) rounded once (exact in double
// before that: |hi| < 2^22, lob <= 22); NaN where dout was not finite.  16-byte stores of the
// aligned middle, the head and the tail element by element.
struct FixedOut {
  double unit;   // 2^lob
  double scale;  // 2^-(sh + lob)
  bool finite;
  __device__ __forceinline__ float operator()(int h, int l) const {
    return finite ? __double2float_rn(fma(static_cast<double>(h), unit, static_cast<double>(l)) * scale)
                  : __int_as_float(0x7fc00000);
  }
};

__device__ __forceinline__ void write_band(float* g, const int* hi, const int* lo, int n,
                                           const FixedOut& to) {
  int h, t;
  split16(g, n, h, t);
  for (int e = h + 4 * static_cast<int>(threadIdx.x); e < t; e += 4 * blockDim.x) {
    const int4 a = *reinterpret_cast<const int4*>(hi + e), b = *reinterpret_cast<const int4*>(lo + e);
    *reinterpret_cast<float4*>(g + e) = make_float4(to(a.x, b.x), to(a.y, b.y), to(a.z, b.z), to(a.w, b.w));
  }
  for (int e = threadIdx.x; e < h; e += blockDim.x) g[e] = to(hi[e], lo[e]);
  for (int e = t + static_cast<int>(threadIdx.x); e < n; e += blockDim.x) g[e] = to(hi[e], lo[e]);
}

// The block's sum of v, the same in every thread (a fixed order); scratch: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < static_cast<int>(blockDim.x / 32); ++w) s += scratch[w];
  return s;
}

// The points [k0, k1) of a mask that block b of its `blocks` takes: equal shares in multiples
// of VEC (modelled in tests/test_torch_port_point_sample.py).
__device__ __forceinline__ void block_points(int K, int blocks, int b, int& k0, int& k1) {
  const long long share = (static_cast<long long>(K) + blocks - 1) / blocks;
  const long long chunk = (share + VEC - 1) / VEC * VEC;
  k0 = static_cast<int>(min(static_cast<long long>(K), b * chunk));
  k1 = static_cast<int>(min(static_cast<long long>(K), k0 + chunk));
}

// A block's flat points [f0, f1): groups of V from the first multiple of V (thread t takes
// groups t, t + THREADS, ...), and the fewer than V before it and after the last group,
// one point a thread.
template <int V>
struct Span {
  size_t f0, v0, v1, f1;
  __device__ __forceinline__ Span(size_t a, size_t b) : f0(a), f1(b) {
    const size_t up = (a + V - 1) / V * V, down = b / V * V;
    v0 = up < b ? up : b;
    v1 = down > v0 ? down : v0;
  }
  __device__ __forceinline__ int groups() const { return static_cast<int>((v1 - v0) / V); }
  __device__ __forceinline__ int singles() const { return static_cast<int>((v0 - f0) + (f1 - v1)); }
  __device__ __forceinline__ size_t single(int j) const {
    return j < static_cast<int>(v0 - f0) ? f0 + j : v1 + (j - (v0 - f0));
  }
};

// ---------------------------------------------------------------------------
// SMEM and BANDS forms: the map (SMEM) or dimg's partial (SMEM, BANDS) in shared memory.
// ---------------------------------------------------------------------------

// SMEM: `blocks` blocks a mask, each with its own copy of the map and a share of the points.
template <typename T, bool COORDS>
__global__ void __launch_bounds__(SMEM_FWD_THREADS, SMEM_FWD_BLOCKS)
point_sample_fwd_kernel(const T* __restrict__ img, const Points<COORDS> pts,
                        float* __restrict__ out, int H, int W, int K, int blocks) {
  constexpr int THREADS = SMEM_FWD_THREADS, V = FWD_VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int n = blockIdx.x / blocks, b = blockIdx.x % blocks;
  const T* g = img + static_cast<size_t>(n) * H * W;
  T* s = reinterpret_cast<T*>(smem + HEADER + (reinterpret_cast<uintptr_t>(g) & 15));
  const Image<T, SMEM> im{s};
  if (threadIdx.x == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  stage(s, g, H * W, bar);

  int k0, k1;
  block_points(K, blocks, b, k0, k1);
  const Span<V> sp(static_cast<size_t>(n) * K + k0, static_cast<size_t>(n) * K + k1);
  const int ng = sp.groups();
  int j = threadIdx.x;
  float cur[2 * V], nxt[2 * V];
  if (j < ng) pts.template load<V>(sp.v0 + static_cast<size_t>(j) * V, cur);  // under the copy
  __syncthreads();  // the head and tail the threads staged
  mbar_wait(bar, 0);

  for (; j < ng; j += THREADS) {
    const bool more = j + THREADS < ng;
    if (more) pts.template load<V>(sp.v0 + static_cast<size_t>(j + THREADS) * V, nxt);
    const size_t f = sp.v0 + static_cast<size_t>(j) * V;
    float o[V];
#pragma unroll
    for (int q = 0; q < V; ++q) o[q] = sample(im, pts.fx(cur[2 * q]), pts.fy(cur[2 * q + 1]), H, W);
    store_stream<V>(out + f, o);
    if (more) {
#pragma unroll
      for (int q = 0; q < 2 * V; ++q) cur[q] = nxt[q];
    }
  }
  for (int t = threadIdx.x; t < sp.singles(); t += THREADS) {
    const size_t f = sp.single(t);
    float c[2];
    pts.template load<1>(f, c);
    float o[1] = {sample(im, pts.fx(c[0]), pts.fy(c[1]), H, W)};
    store_stream<1>(out + f, o);
  }
}

// dimg (N, H, W) fp32 is written whole (every pixel of every mask, once); with GRAD (SMEM
// only) the coordinate gradients of every point too.  SMEM: blocks = 1, one band of H rows.
template <typename T, bool COORDS, int FORM, bool GRAD>
__global__ void __launch_bounds__(PS_BWD_THREADS(FORM, GRAD), PS_BWD_MIN_BLOCKS(FORM, GRAD))
point_sample_bwd_kernel(const T* __restrict__ img, const Points<COORDS> pts,
                        const float* __restrict__ dout, float* __restrict__ dimg,
                        const CoordGrads<COORDS> grads, int H, int W, int K, int blocks) {
  static_assert(FORM == SMEM || !GRAD, "the BANDS form computes dimg alone");
  constexpr int THREADS = PS_BWD_THREADS(FORM, GRAD), V = BWD_VEC;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  const int n = blockIdx.x / blocks, b = blockIdx.x % blocks;
  // this block's band, rows [r0, r1): all of them in the SMEM form.  The SMEM backward is held
  // to 40 registers, and ptxas fits it without spills only with the band known at compile
  // time for dimg alone and read at run time with the coordinate gradient (a spill cost
  // 5-10% at the FAST head)
  constexpr bool WHOLE = FORM == SMEM && !GRAD;
  const int rows = WHOLE ? H : (H + blocks - 1) / blocks;
  const int r0 = WHOLE ? 0 : min(H, b * rows);
  const int r1 = WHOLE ? H : min(H, r0 + rows);
  const int nel = (r1 - r0) * W;
  float* dgb = dimg + (static_cast<size_t>(n) * H + r0) * W;  // this block's rows of dimg
  const uint32_t region = static_cast<uint32_t>(align_up(rows * W * sizeof(int), 16)) + 16;
  const uint32_t band_phase = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(dgb) & 15);
  int* shi = reinterpret_cast<int*>(smem + HEADER + band_phase);
  int* slo = reinterpret_cast<int*>(smem + HEADER + region + band_phase);
  float* scratch = reinterpret_cast<float*>(smem + 16);
  const T* g = img + static_cast<size_t>(n) * H * W;
  T* s = reinterpret_cast<T*>(smem + HEADER + 2 * region + (reinterpret_cast<uintptr_t>(g) & 15));
  const Image<T, SMEM> im{s};
  if constexpr (GRAD) {
    if (threadIdx.x == 0) {
      mbar_init(bar, 1);
      mbar_fence_init();
    }
    __syncthreads();
    stage(s, g, H * W, bar);
  }
  for (int e = threadIdx.x; e < nel; e += THREADS) shi[e] = slo[e] = 0;

  // the block takes all of the mask's points (BANDS: adding only into its own band)
  const Span<V> sp(static_cast<size_t>(n) * K, static_cast<size_t>(n) * K + K);
  const int ng = sp.groups();
  // the fixed point's scale: sum |dout| over the mask's points, the same in every block
  float part = 0.f;
#pragma unroll 4
  for (int jj = threadIdx.x; jj < ng; jj += THREADS) {
    float rv[V];
    load_stream<V, false>(dout + sp.v0 + static_cast<size_t>(jj) * V, rv);  // read again below
#pragma unroll
    for (int e = 0; e < V; ++e) part += fabsf(rv[e]);
  }
  for (int t = threadIdx.x; t < sp.singles(); t += THREADS) part += fabsf(__ldg(dout + sp.single(t)));
  const float S = block_sum(part, scratch);

  int j = threadIdx.x;
  float cur[2 * V], nxt[2 * V], r[V], rn[V];
  if (j < ng) {
    pts.template load<V>(sp.v0 + static_cast<size_t>(j) * V, cur);
    load_stream<V>(dout + sp.v0 + static_cast<size_t>(j) * V, r);
  }
  __syncthreads();  // dimg's partial zeroed, the map's head and tail staged
  if constexpr (GRAD) mbar_wait(bar, 0);
  int sh, lob;
  const Fixed fixed = fixed_for(S, K, sh, lob);
  const Dimg<FORM> acc{nullptr, shi, slo, r0 * W, r0, r1, fixed};

  for (; j < ng; j += THREADS) {
    const bool more = j + THREADS < ng;
    if (more) {
      pts.template load<V>(sp.v0 + static_cast<size_t>(j + THREADS) * V, nxt);
      load_stream<V>(dout + sp.v0 + static_cast<size_t>(j + THREADS) * V, rn);
    }
    const size_t f = sp.v0 + static_cast<size_t>(j) * V;
    float gxy[2 * V];
#pragma unroll
    for (int q = 0; q < V; ++q)
      scatter<GRAD>(im, acc, pts.fx(cur[2 * q]), pts.fy(cur[2 * q + 1]), r[q], H, W, gxy[2 * q],
                    gxy[2 * q + 1]);
    if constexpr (GRAD) grads.template store<V>(f, gxy);
    if (more) {
#pragma unroll
      for (int q = 0; q < 2 * V; ++q) cur[q] = nxt[q];
#pragma unroll
      for (int q = 0; q < V; ++q) r[q] = rn[q];
    }
  }
  for (int t = threadIdx.x; t < sp.singles(); t += THREADS) {
    const size_t f = sp.single(t);
    float c[2], rv[1], gxy[2];
    pts.template load<1>(f, c);
    load_stream<1>(dout + f, rv);
    scatter<GRAD>(im, acc, pts.fx(c[0]), pts.fy(c[1]), rv[0], H, W, gxy[0], gxy[1]);
    if constexpr (GRAD) grads.template store<1>(f, gxy);
  }
  __syncthreads();
  const FixedOut to{static_cast<double>(exp2f_int(lob)),
                    __longlong_as_double(static_cast<long long>(1023 - sh - lob) << 52),
                    S <= 3.402823466e38f};
  write_band(dgb, shi, slo, nel, to);
}

// ---------------------------------------------------------------------------
// GLOBAL form: one point a thread, the map and dimg in device memory.
// ---------------------------------------------------------------------------

template <typename T, bool COORDS>
__global__ void __launch_bounds__(GLOBAL_THREADS)
point_sample_fwd_global_kernel(const T* __restrict__ img, const Points<COORDS> pts,
                               float* __restrict__ out, int H, int W, int K, size_t total) {
  const size_t HW = static_cast<size_t>(H) * W;
  for (size_t f = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; f < total;
       f += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const Image<T, GLOBAL> im{img + f / K * HW};
    float c[2], o[1];
    pts.template load<1>(f, c);
    o[0] = sample(im, pts.fx(c[0]), pts.fy(c[1]), H, W);
    store_stream<1>(out + f, o);
  }
}

// dimg zeroed by the caller.
template <typename T, bool COORDS, bool GRAD>
__global__ void __launch_bounds__(GLOBAL_THREADS)
point_sample_bwd_global_kernel(const T* __restrict__ img, const Points<COORDS> pts,
                               const float* __restrict__ dout, float* __restrict__ dimg,
                               const CoordGrads<COORDS> grads, int H, int W, int K,
                               size_t total) {
  const size_t HW = static_cast<size_t>(H) * W;
  for (size_t f = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; f < total;
       f += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t n = f / K;
    const Image<T, GLOBAL> im{img + n * HW};
    const Dimg<GLOBAL> acc{dimg + n * HW, nullptr, nullptr, 0, 0, 0, {}};
    float c[2], rv[1], gxy[2];
    pts.template load<1>(f, c);
    load_stream<1>(dout + f, rv);
    scatter<GRAD>(im, acc, pts.fx(c[0]), pts.fy(c[1]), rv[0], H, W, gxy[0], gxy[1]);
    if constexpr (GRAD) grads.template store<1>(f, gxy);
  }
}

// ---------------------------------------------------------------------------
// Host.
// ---------------------------------------------------------------------------

// Dynamic shared memory of a block holding `rows` rows of each array (element sizes e0 and,
// unless 0, e1, e2): the header, then each array at its 16-byte phase in a 16-byte multiple
// (bilinear_gather._ps_smem_bytes models it).
size_t smem_bytes(int rows, int W, int e0, int e1 = 0, int e2 = 0) {
  const auto region = [&](int e) {
    return e ? align_up(static_cast<size_t>(rows) * W * e, 16) + 16 : 0;
  };
  return HEADER + region(e0) + region(e1) + region(e2);
}

// Whether (form, blocks) takes the shape: the one authority on what a form takes
// (bilinear_gather.point_sample_plan picks by a model of it).  The forward holds the map
// (img_bytes an element), the backward dimg's partial (two int32 words a pixel) and, with the
// coordinate gradient, the map.
bool plan_ok(int N, int H, int W, int K, int form, int blocks, int img_bytes, bool backward,
             bool grad) {
  if (N <= 0 || H <= 0 || W <= 0 || K <= 0 || H >= MAX_SIDE || W >= MAX_SIDE ||
      static_cast<long long>(H) * W > 0x7fffffffLL)
    return false;
  if (form == GLOBAL) return blocks == 1;
  if (blocks < 1 || blocks > MAX_BLOCKS || static_cast<long long>(N) * blocks > 0x7fffffffLL)
    return false;
  const auto fits = [&](int rows) {
    return (backward ? smem_bytes(rows, W, sizeof(int), sizeof(int), grad ? img_bytes : 0)
                     : smem_bytes(rows, W, img_bytes)) <= SMEM_BUDGET;
  };
  if (form == SMEM) return (!backward || blocks == 1) && fits(H);
  if (form == BANDS)
    return backward && !grad && (blocks == 2 || blocks == 4 || blocks == 8) &&
           fits((H + blocks - 1) / blocks);
  return false;
}

// Launches `kernel` on `grid` blocks of `threads` with `smem` bytes of dynamic shared memory
// (opting in above 48 KB).
template <typename... Params, typename... Args>
int launch(void (*kernel)(Params...), unsigned grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// One thread a point (a grid-stride loop past 2^31 - 1 blocks).
unsigned global_grid(size_t total) {
  const size_t want = (total + GLOBAL_THREADS - 1) / GLOBAL_THREADS;
  return static_cast<unsigned>(want < 0x7fffffffu ? want : 0x7fffffffu);
}

template <typename T, bool COORDS>
int fwd(const void* img, const void* a, const void* b, void* out, int N, int H, int W, int K,
        int form, int blocks, cudaStream_t s) {
  if (!plan_ok(N, H, W, K, form, blocks, sizeof(T), false, false)) return cudaErrorInvalidValue;
  const T* im = static_cast<const T*>(img);
  const Points<COORDS> pts{static_cast<const float*>(a), static_cast<const float*>(b),
                           static_cast<float>(W), static_cast<float>(H)};
  float* o = static_cast<float*>(out);
  if (form == GLOBAL) {
    const size_t total = static_cast<size_t>(N) * K;
    return launch(point_sample_fwd_global_kernel<T, COORDS>, global_grid(total), GLOBAL_THREADS,
                  0, s, im, pts, o, H, W, K, total);
  }
  return launch(point_sample_fwd_kernel<T, COORDS>, static_cast<unsigned>(N * blocks),
                SMEM_FWD_THREADS, smem_bytes(H, W, sizeof(T)), s, im, pts, o, H, W, K, blocks);
}

template <typename T, bool COORDS, bool GRAD>
int bwd(const void* img, const void* a, const void* b, const void* dout, void* dimg, void* ga,
        void* gb, int N, int H, int W, int K, int form, int blocks, cudaStream_t s) {
  if (!plan_ok(N, H, W, K, form, blocks, sizeof(T), true, GRAD)) return cudaErrorInvalidValue;
  const T* im = static_cast<const T*>(img);
  const Points<COORDS> pts{static_cast<const float*>(a), static_cast<const float*>(b),
                           static_cast<float>(W), static_cast<float>(H)};
  const CoordGrads<COORDS> grads{static_cast<float*>(ga), static_cast<float*>(gb),
                                 static_cast<float>(W), static_cast<float>(H)};
  const float* r = static_cast<const float*>(dout);
  float* d = static_cast<float*>(dimg);
  if (form == GLOBAL) {
    const size_t total = static_cast<size_t>(N) * K;
    return launch(point_sample_bwd_global_kernel<T, COORDS, GRAD>, global_grid(total),
                  GLOBAL_THREADS, 0, s, im, pts, r, d, grads, H, W, K, total);
  }
  const size_t smem = smem_bytes((H + blocks - 1) / blocks, W, sizeof(int), sizeof(int),
                                 GRAD ? sizeof(T) : 0);
  const unsigned grid = static_cast<unsigned>(N * blocks);
  if constexpr (GRAD) {
    return launch(point_sample_bwd_kernel<T, COORDS, SMEM, true>, grid, SMEM_GRAD_THREADS, smem,
                  s, im, pts, r, d, grads, H, W, K, blocks);
  } else {
    if (form == SMEM)
      return launch(point_sample_bwd_kernel<T, COORDS, SMEM, false>, grid, SMEM_BWD_THREADS,
                    smem, s, im, pts, r, d, grads, H, W, K, blocks);
    return launch(point_sample_bwd_kernel<T, COORDS, BANDS, false>, grid, BANDS_THREADS, smem, s,
                  im, pts, r, d, grads, H, W, K, blocks);
  }
}

template <typename T, bool COORDS>
int bwd_grad(const void* img, const void* a, const void* b, const void* dout, void* dimg,
             void* ga, void* gb, int N, int H, int W, int K, int form, int blocks,
             cudaStream_t s) {
  return ga != nullptr
             ? bwd<T, COORDS, true>(img, a, b, dout, dimg, ga, gb, N, H, W, K, form, blocks, s)
             : bwd<T, COORDS, false>(img, a, b, dout, dimg, ga, gb, N, H, W, K, form, blocks, s);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K9 forward.  img (N, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); coords = 1: a holds
// (N, K, 2) xy in [0, 1] and b is null; coords = 0: a, b hold fx, fy (N, K) in pixels; out
// (N, K) fp32.  All contiguous; a, b 16-byte aligned.  (form, blocks): the form and its
// blocks a mask, from bilinear_gather.point_sample_plan; a form that does not take the
// shape is refused (cudaErrorInvalidValue).
int samrs_point_sample_fwd(const void* img, const void* a, const void* b, void* out, int N,
                           int H, int W, int K, int is_bf16, int coords, int form, int blocks,
                           void* stream) {
  using namespace samrs;
  if (a == nullptr || (coords ? b != nullptr : b == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coords)
    return is_bf16 ? fwd<bf16, true>(img, a, b, out, N, H, W, K, form, blocks, s)
                   : fwd<float, true>(img, a, b, out, N, H, W, K, form, blocks, s);
  return is_bf16 ? fwd<bf16, false>(img, a, b, out, N, H, W, K, form, blocks, s)
                 : fwd<float, false>(img, a, b, out, N, H, W, K, form, blocks, s);
}

// K9 backward.  dout (N, K) fp32, 16-byte aligned; dimg (N, H, W) fp32, written whole
// (zeroed by the caller for the GLOBAL form only).  The coordinate gradient, or nulls when
// it is not asked for: dcoords (N, K, 2) in ga with gb null (coords = 1), dfx, dfy in ga, gb
// (coords = 0).  The image is read only for the coordinate gradient.
int samrs_point_sample_bwd(const void* img, const void* a, const void* b, const void* dout,
                           void* dimg, void* ga, void* gb, int N, int H, int W, int K,
                           int is_bf16, int coords, int form, int blocks, void* stream) {
  using namespace samrs;
  if (a == nullptr || (coords ? b != nullptr : b == nullptr)) return cudaErrorInvalidValue;
  if (coords ? gb != nullptr : (ga == nullptr) != (gb == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (coords)
    return is_bf16
               ? bwd_grad<bf16, true>(img, a, b, dout, dimg, ga, gb, N, H, W, K, form, blocks, s)
               : bwd_grad<float, true>(img, a, b, dout, dimg, ga, gb, N, H, W, K, form, blocks, s);
  return is_bf16
             ? bwd_grad<bf16, false>(img, a, b, dout, dimg, ga, gb, N, H, W, K, form, blocks, s)
             : bwd_grad<float, false>(img, a, b, dout, dimg, ga, gb, N, H, W, K, form, blocks, s);
}

}  // extern "C"
