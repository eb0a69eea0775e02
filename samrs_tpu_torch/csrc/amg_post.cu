// K7: full-resolution mask postprocess.  Bilinear resize of each low-res mask
// (g -> img_size, crop to the resized input, -> original size, composed into
// one banded map per axis), threshold, hi/lo stability counts, tight box and
// np.packbits-order bit rows, without the full-resolution logits ever
// reaching device memory.
//
// Replaces samrs_tpu/kernels/amg_post.py::amg_postprocess.  Per 32-mask chunk
// to 800x800 it reads 8.4 MB of fp32 logits and writes 2.6 MB of bits, so it
// is bound by device-memory bytes (~3.3 us on an H100).  The TPU kernel spent
// two dense "hat" matmuls and a 0/1 pack matmul on its matrix unit; here each
// output pixel is a short banded sum (at most 4 taps per axis after
// composition, kept as a start index and 4 weights per output row and
// column, zero-weighted past the band), in fp32 on the CUDA cores (the TPU
// kernel ran its matmuls at Precision.HIGHEST).
//
// A cluster of BANDS blocks owns one mask, each block a band of
// ceil(Ho / BANDS) output rows:
//   * the input rows the band reads are contiguous in the mask: one bulk
//     copy (cp.async.bulk) brings them into shared memory once, while the
//     block copies the column table (x0, wx) and its rows' (y0, wy) beside
//     them; where the tables would outgrow shared memory (20 bytes a column:
//     an original width above ~6000 at g 256) they are read from global
//     memory instead, so every width runs;
//   * warp w takes the band's rows w, w + 16, ...: the vertical sum of its 4
//     input rows into a row of g values in shared memory (4 columns a lane,
//     16-byte loads), then the horizontal sums with 4 consecutive columns a
//     lane, which give half a packed byte (MSB first); a shuffle pairs the
//     halves, and the byte is staged in shared memory in the band's global
//     byte order; each lane keeps its hi / lo counts and box extremes, summed
//     over the warp at the end;
//   * the staged bytes leave as 16-byte stores (single bytes only at the two
//     ends, which a neighbouring band's row may share), in chunks of rows
//     when a band's bits outgrow the staging buffer;
//   * the block reduces its warps' stats in shared memory, and block 0 of
//     the cluster reduces the blocks' through distributed shared memory and
//     writes the mask's final stats, an empty mask's box as zeros.
// So a call is one launch and needs no preset: the Python wrapper allocates
// the outputs and nothing else.
#include <climits>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace samrs {
namespace {

namespace cg = cooperative_groups;

constexpr int TAPS = 4;      // band width per axis; weights past the band are 0
constexpr int BANDS = 8;     // blocks of a mask's cluster
constexpr int WARPS = 16;
constexpr int THREADS = WARPS * 32;
constexpr int STAGE_BYTES = 32768;  // packed-bit staging of one chunk of rows
constexpr int SMEM_MAX = 232448;    // an H100 block's dynamic shared memory

// The shared-memory carve of a block, the same on the host and the device
// (mirrored by kernels/amg_post.py::_smem_layout).  `tables`: the row and
// column tables fit beside the rest; otherwise they stay in global memory.
struct PostLayout {
  int R, Wp, RC;  // band rows, packed bytes a row, rows a staged chunk
  bool tables;
  size_t ws, bs, L, V, x, wx, y, wy, P, total;
  __host__ __device__ PostLayout(int g, int Ho, int Wo, int max_rows) {
    R = (Ho + BANDS - 1) / BANDS;
    Wp = (Wo + 7) / 8;
    RC = STAGE_BYTES / Wp;
    RC = RC < 1 ? 1 : RC > R ? R : RC;
    carve(g, Wo, max_rows, true);
    if (total > SMEM_MAX) carve(g, Wo, max_rows, false);
  }
  __host__ __device__ void carve(int g, int Wo, int max_rows, bool with_tables) {
    tables = with_tables;
    const size_t Wo4 = with_tables ? (Wo + 3) / 4 * 4 : 0;  // the column tables, zero-padded
    const size_t Rt = with_tables ? R : 0;
    ws = 16;                                    // the warps' stats: WARPS x 6 int
    bs = ws + WARPS * 6 * 4;                    // the block's: 6 int
    L = align_up(bs + 6 * 4, 128);              // input rows: max_rows x g fp32
    V = align_up(L + (size_t)max_rows * g * 4, 16);  // one row of g values a warp
    x = align_up(V + (size_t)WARPS * g * 4, 16);     // x0: Wo4 int
    wx = align_up(x + Wo4 * 4, 16);                  // wx: 4 x Wo4 fp32, tap-major
    y = align_up(wx + Wo4 * 16, 16);                 // the band's y0 - first input row: R int
    wy = align_up(y + Rt * 4, 16);                   // the band's wy: R x 4 fp32
    P = align_up(wy + Rt * 16, 16);                  // 16 + RC x Wp bytes
    total = align_up(P + 16 + (size_t)RC * Wp, 16);
  }
};

// stats (M, 6) int32 = [hi, lo, xmin, ymin, xmax, ymax], a box of zeros for an
// empty mask.  Grid (BANDS, M).
__global__ void __cluster_dims__(BANDS, 1, 1) __launch_bounds__(THREADS, 2)
amg_post_kernel(const float* __restrict__ low, const int* __restrict__ y0,
                const float* __restrict__ wy, const int* __restrict__ x0,
                const float* __restrict__ wx, unsigned char* __restrict__ packed,
                int* __restrict__ stats, int g, int Ho, int Wo, int max_rows, float mt,
                float off) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const PostLayout lay(g, Ho, Wo, max_rows);
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int* ws = reinterpret_cast<int*>(smem + lay.ws);
  int* bs = reinterpret_cast<int*>(smem + lay.bs);
  float* Ls = reinterpret_cast<float*>(smem + lay.L);
  int* xs = reinterpret_cast<int*>(smem + lay.x);
  float* wxs = reinterpret_cast<float*>(smem + lay.wx);  // tap b of column c at b * Wo4 + c
  int* ys = reinterpret_cast<int*>(smem + lay.y);
  float4* wys = reinterpret_cast<float4*>(smem + lay.wy);

  const int band = (int)cluster.block_rank(), m = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int R = lay.R, Wp = lay.Wp;
  const int r0 = min(Ho, band * R), nr = min(Ho, r0 + R) - r0;
  const int iy0 = nr > 0 ? y0[r0] : 0;
  const int nrows = nr > 0 ? y0[r0 + nr - 1] + TAPS - iy0 : 0;
  if (nrows > max_rows) __trap();  // the host's band extent is wrong: fail the launch
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0 && nr > 0) {
    mbar_expect_tx(bar, (unsigned)(nrows * g * 4));
    bulk_load(Ls, low + ((size_t)m * g + iy0) * g, (unsigned)(nrows * g * 4), bar);
  }
  const int Wo4 = (Wo + 3) / 4 * 4;
  if (lay.tables) {
    for (int c = tid; c < Wo4; c += THREADS) {
      xs[c] = c < Wo ? x0[c] : 0;
      const float4 q = c < Wo ? reinterpret_cast<const float4*>(wx)[c] : make_float4(0.f, 0.f, 0.f, 0.f);
      wxs[c] = q.x, wxs[Wo4 + c] = q.y, wxs[2 * Wo4 + c] = q.z, wxs[3 * Wo4 + c] = q.w;
    }
    for (int r = tid; r < nr; r += THREADS) {
      ys[r] = y0[r0 + r] - iy0;
      wys[r] = reinterpret_cast<const float4*>(wy)[r0 + r];
    }
  }
  __syncthreads();
  if (nr > 0) mbar_wait(bar, 0);

  float* V = reinterpret_cast<float*>(smem + lay.V) + warp * g;
  int hi = 0, lo = 0, xmin = INT_MAX, xmax = -1, ymin = INT_MAX, ymax = -1;  // this lane's
  for (int c0r = 0; c0r < nr; c0r += lay.RC) {  // chunks of rows staged together
    const int cr = min(lay.RC, nr - c0r);
    const size_t gs = ((size_t)m * Ho + r0 + c0r) * Wp;  // the chunk's first byte in `packed`
    unsigned char* Ps = smem + lay.P + gs % 16;           // staged with the same 16-byte phase
    for (int rr = c0r + warp; rr < c0r + cr; rr += WARPS) {
      // vertical: V = the 4 weighted input rows, 4 columns a lane at a time
      const int yr = lay.tables ? ys[rr] : y0[r0 + rr] - iy0;
      const float4* L = reinterpret_cast<const float4*>(Ls + (size_t)yr * g);
      const float4 w = lay.tables ? wys[rr] : reinterpret_cast<const float4*>(wy)[r0 + rr];
      for (int j = lane; j < g / 4; j += 32) {
        const float4 a = L[j], b = L[g / 4 + j], c = L[g / 2 + j], d = L[3 * g / 4 + j];
        reinterpret_cast<float4*>(V)[j] =
            make_float4(w.x * a.x + w.y * b.x + w.z * c.x + w.w * d.x,
                        w.x * a.y + w.y * b.y + w.z * c.y + w.w * d.y,
                        w.x * a.z + w.y * b.z + w.z * c.z + w.w * d.z,
                        w.x * a.w + w.y * b.w + w.z * c.w + w.w * d.w);
      }
      __syncwarp();
      // horizontal: lane l takes columns base + 4l .. base + 4l + 3, a half byte of bits
      unsigned char* prow = Ps + (size_t)(rr - c0r) * Wp;
      bool any = false;
      for (int base = 0; base < Wo; base += 128) {
        const int c0 = base + 4 * lane;
        unsigned nib = 0;
        if (c0 < Wo) {
          int xo[4];
          float wt[4][4];  // [tap][column]: 16-byte loads at consecutive addresses across lanes
          if (lay.tables) {
            const int4 xq = *reinterpret_cast<const int4*>(xs + c0);
            xo[0] = xq.x, xo[1] = xq.y, xo[2] = xq.z, xo[3] = xq.w;
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              const float4 w4 = *reinterpret_cast<const float4*>(wxs + b * Wo4 + c0);
              wt[b][0] = w4.x, wt[b][1] = w4.y, wt[b][2] = w4.z, wt[b][3] = w4.w;
            }
          } else {
            // from global memory, a column's 4 taps one 16-byte load; past Wo the last
            // column stands in (its bits are masked below)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int c = min(c0 + q, Wo - 1);
              xo[q] = x0[c];
              const float4 w4 = reinterpret_cast<const float4*>(wx)[c];
              wt[0][q] = w4.x, wt[1][q] = w4.y, wt[2][q] = w4.z, wt[3][q] = w4.w;
            }
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float* vc = V + xo[q];
            const float v = wt[0][q] * vc[0] + wt[1][q] * vc[1] + wt[2][q] * vc[2] + wt[3][q] * vc[3];
            const bool in = c0 + q < Wo;
            nib |= (unsigned)(in && v > mt) << (3 - q);  // column c0 in the high bit, as np.packbits
            hi += in && v > mt + off;
            lo += in && v > mt - off;
          }
        }
        const unsigned other = __shfl_xor_sync(0xffffffffu, nib, 1);
        if (!(lane & 1) && c0 < Wo) prow[c0 / 8] = static_cast<unsigned char>(nib << 4 | other);
        if (nib) {
          xmin = min(xmin, c0 + __clz(nib) - 28);
          xmax = max(xmax, c0 + 4 - __ffs(nib));
          any = true;
        }
      }
      if (any) ymin = min(ymin, r0 + rr), ymax = max(ymax, r0 + rr);
      __syncwarp();  // V is read out
    }
    __syncthreads();
    // the chunk's bytes [gs, gs + n): single bytes up to a 16-byte boundary, 16-byte words, the rest
    const int n = cr * Wp, head = min(n, (int)((16 - gs % 16) % 16));
    const int words = (n - head) / 16, tail0 = head + 16 * words;
    for (int i = tid; i < head; i += THREADS) packed[gs + i] = Ps[i];
    for (int i = tid; i < words; i += THREADS)
      *reinterpret_cast<uint4*>(packed + gs + head + 16 * i) =
          *reinterpret_cast<const uint4*>(Ps + head + 16 * i);
    for (int i = tail0 + tid; i < n; i += THREADS) packed[gs + i] = Ps[i];
    __syncthreads();  // the staging buffer is read out
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {  // over the warp's lanes
    hi += __shfl_xor_sync(0xffffffffu, hi, o);
    lo += __shfl_xor_sync(0xffffffffu, lo, o);
    xmin = min(xmin, __shfl_xor_sync(0xffffffffu, xmin, o));
    ymin = min(ymin, __shfl_xor_sync(0xffffffffu, ymin, o));
    xmax = max(xmax, __shfl_xor_sync(0xffffffffu, xmax, o));
    ymax = max(ymax, __shfl_xor_sync(0xffffffffu, ymax, o));
  }
  if (lane == 0) {
    int* o = ws + warp * 6;
    o[0] = hi, o[1] = lo, o[2] = xmin, o[3] = ymin, o[4] = xmax, o[5] = ymax;
  }
  __syncthreads();
  if (tid < 6) {  // field tid over the warps
    int v = ws[tid];
    for (int q = 1; q < WARPS; ++q) {
      const int u = ws[q * 6 + tid];
      v = tid < 2 ? v + u : tid < 4 ? min(v, u) : max(v, u);
    }
    bs[tid] = v;
  }
  cluster.sync();  // every block's stats are in its shared memory
  if (band == 0 && tid < 6) {
    int v = bs[tid];
    for (int q = 1; q < BANDS; ++q) {
      const int u = *cluster.map_shared_rank(bs + tid, q);
      v = tid < 2 ? v + u : tid < 4 ? min(v, u) : max(v, u);
    }
    bs[tid] = v;  // block 0's own fields only: the others are read before this sync
  }
  cluster.sync();  // the other blocks' shared memory stays until block 0 has read it
  if (band == 0 && tid < 6) {
    const bool empty = bs[5] < 0;  // no row holds a pixel over the threshold
    stats[m * 6 + tid] = tid < 2 || !empty ? bs[tid] : 0;
  }
}

}  // namespace
}  // namespace samrs

extern "C" {

// K7: low (M, g, g) fp32, g % 4 == 0; per output row r: y0[r] and wy[r, 0..4)
// (input rows y0[r]..y0[r]+3 with those weights), per output column c: x0[c]
// and wx[c, 0..4); every band lies inside [0, g).  max_rows: the most input
// rows one of the kernel's bands of ceil(Ho / 8) output rows reads
// (y0[last] + 4 - y0[first]).  Writes packed (M, Ho, ceil(Wo/8)) uint8 and the
// final stats (M, 6) int32 (see amg_post_kernel).
int samrs_amg_post(const void* low, const void* y0, const void* wy, const void* x0,
                   const void* wx, void* packed, void* stats, int M, int g, int Ho, int Wo,
                   int max_rows, float mt, float off, void* stream) {
  using namespace samrs;
  if (M <= 0 || g < TAPS || g % 4 != 0 || Ho <= 0 || Wo <= 0 || max_rows < TAPS ||
      max_rows > g || reinterpret_cast<uintptr_t>(low) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wx) % 16 != 0 || reinterpret_cast<uintptr_t>(wy) % 16 != 0)
    return cudaErrorInvalidValue;
  const PostLayout lay(g, Ho, Wo, max_rows);
  if (lay.total > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(amg_post_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)lay.total);
  if (err != cudaSuccess) return err;
  amg_post_kernel<<<dim3(BANDS, M), THREADS, lay.total, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(low), static_cast<const int*>(y0), static_cast<const float*>(wy),
      static_cast<const int*>(x0), static_cast<const float*>(wx),
      static_cast<unsigned char*>(packed), static_cast<int*>(stats), g, Ho, Wo, max_rows, mt, off);
  return cudaGetLastError();
}

}  // extern "C"
