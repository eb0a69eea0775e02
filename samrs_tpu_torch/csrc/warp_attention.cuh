// Warp-level attention building blocks shared by K1 (window attention), K2
// (global flash attention from the raw qkv) and K12 (split-head attention):
// one warp owns 16 query rows and streams key blocks through the tensor cores
// with the logits kept in registers; `flash_key_loop` streams a whole key
// sequence through two shared-memory stages for the query-tiled kernels.
//
// With the mma.sync fragment layouts of common.cuh, a row of the logits lives
// in the four lanes of a quad, so row reductions are two xor-shuffles, and
// the C fragments of two adjacent 8-key tiles are exactly the A fragment of
// P for the P.V product (no shared memory).
#pragma once

#include "common.cuh"

namespace samrs {

// A fragments of 16 rows x HD columns of a row-major bf16 tile (row stride
// `ld` elements, 16-byte aligned rows).
template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[HD / 16][4], const bf16* q, int ld) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) ldmatrix_x4(qa[kk], q + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
}

// Running state of one warp's 16 rows: this lane holds rows g and g + 8.
template <int HD>
struct WarpAttnState {
  float o[HD / 8][4];  // output accumulators, C-fragment layout per 8 dims
  float m[2];          // running max (rows g, g+8)
  float l[2];          // running sum of the bf16-rounded probabilities

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    m[0] = m[1] = neg_inf();
    l[0] = l[1] = 0.f;
  }
};

// exp(x), or 2^x for a softmax taken in base 2 (logits in units of log2 e).
template <bool EXP2>
__device__ __forceinline__ float softmax_exp(float x) {
  return EXP2 ? exp2f(x) : __expf(x);
}

// One online-softmax step over `nkb` (<= MAXKB) blocks of 16 keys whose K and
// V rows start at Ks / Vs (row-major [key][d], stride `ld`).  `bias(half,
// key)` returns the additive logit bias of row g + 8*half at key index `key`
// (relative to Ks), or -inf to mask the key; logits are s*scale + bias, and
// with EXP2 the softmax is taken in base 2.
template <int HD, int MAXKB, bool EXP2 = false, class Bias>
__device__ __forceinline__ void attend_keys(WarpAttnState<HD>& st, const uint32_t (&qa)[HD / 16][4],
                                            const bf16* Ks, const bf16* Vs, int ld, int nkb,
                                            float scale, Bias bias) {
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float s[2 * MAXKB][4];

  // S = Q K^T: K is [key][d], i.e. B stored [n][k] -> plain ldmatrix
#pragma unroll
  for (int kb = 0; kb < MAXKB; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[2 * kb][e] = s[2 * kb + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (kb * 16 + (lane & 7) + ((lane >> 4) << 3)) * ld + kk * 16 +
                           (((lane >> 3) & 1) << 3));
        mma_16816(s[2 * kb], qa[kk], b[0], b[1]);
        mma_16816(s[2 * kb + 1], qa[kk], b[2], b[3]);
      }
    }
  }

  // scale, bias, row max over this block of keys
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int j = 0; j < 2 * MAXKB; ++j) {
    if (j < 2 * nkb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const float v = s[j][e] * scale + bias(half, j * 8 + 2 * t + (e & 1));
        s[j][e] = v;
        mx[half] = fmaxf(mx[half], v);
      }
    }
  }
  float alpha[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
    const float m_new = fmaxf(st.m[half], mx[half]);
    alpha[half] = softmax_exp<EXP2>(st.m[half] - m_new);  // 0 while m was -inf
    st.m[half] = m_new;
  }

  // P = exp(s - m), rounded to bf16 once; the row sum uses the rounded values
  float sum[2] = {0.f, 0.f};
  uint32_t pa[MAXKB][4];
#pragma unroll
  for (int kb = 0; kb < MAXKB; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kb + jj;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const __nv_bfloat162 p =
              __floats2bfloat162_rn(softmax_exp<EXP2>(s[j][2 * half] - st.m[half]),
                                    softmax_exp<EXP2>(s[j][2 * half + 1] - st.m[half]));
          sum[half] += __bfloat162float(p.x) + __bfloat162float(p.y);
          pa[kb][2 * jj + half] = *reinterpret_cast<const uint32_t*>(&p);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
    sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
    st.l[half] = st.l[half] * alpha[half] + sum[half];
  }
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    st.o[n][0] *= alpha[0];
    st.o[n][1] *= alpha[0];
    st.o[n][2] *= alpha[1];
    st.o[n][3] *= alpha[1];
  }

  // O += P V: V is [key][d], i.e. B stored [k][n] -> ldmatrix.trans
#pragma unroll
  for (int kb = 0; kb < MAXKB; ++kb) {
    if (kb < nkb) {
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + (kb * 16 + (lane & 15)) * ld + dp * 16 + ((lane >> 4) << 3));
        mma_16816(st.o[2 * dp], pa[kb], b[0], b[1]);
        mma_16816(st.o[2 * dp + 1], pa[kb], b[2], b[3]);
      }
    }
  }
}

// The decomposed rel-pos bias rel_h[r][key / kw] + rel_w[r][key % kw] of a
// lane's two query rows r (fp32 rows of kh and kw values).  The key's grid
// row comes from a float reciprocal, not an integer division: exact while
// kh * kw < 2^22 (the product's error stays below 0.5 / kw).
struct RelBias {
  const float* h[2];
  const float* w[2];
  int kw;
  float inv_kw;

  __device__ __forceinline__ float operator()(int half, int key) const {
    const int r = __float2int_rz((key + 0.5f) * inv_kw);
    return h[half][r] + w[half][key - r * kw];
  }
  // keys k0 + [0, 64) anywhere on the grid
  __device__ __forceinline__ auto any_tile(int k0) const {
    const RelBias self = *this;
    return [self, k0](int half, int key) { return self(half, k0 + key); };
  }
  // keys k0 + [0, 64) in one grid row (kw % 64 == 0): the row term is one
  // register a tile
  __device__ __forceinline__ auto row_tile(int k0) const {
    const int r = k0 / kw;
    const float bh0 = h[0][r], bh1 = h[1][r];
    const float* w0 = w[0] + (k0 - r * kw);
    const float* w1 = w[1] + (k0 - r * kw);
    return [=](int half, int key) { return half ? bh1 + w1[key] : bh0 + w0[key]; };
  }
};

// RelBias of this lane's rows g and g + 8 of the 16 starting at `row0` of a
// (n, kh) / (n, kw) pair of row-major rel tables (rows clamped to n - 1: a
// ragged last tile's rows are never written).
__device__ __forceinline__ RelBias lane_rel_bias(const float* rel_h, const float* rel_w, int row0,
                                                 int n, int kh, int kw) {
  const int g = (threadIdx.x & 31) >> 2;
  RelBias b;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    const size_t rc = r < n ? r : n - 1;
    b.h[half] = rel_h + rc * kh;
    b.w[half] = rel_w + rc * kw;
  }
  b.kw = kw;
  b.inv_kw = 1.f / kw;
  return b;
}

// Query-tiled flash loop of K2 and K12: the block's 64 query rows (16 per
// warp) attend to keys [0, n) in tiles of 64, double-buffered in shared
// memory.  The caller has started (and committed, as one cp.async group) the
// copies of its Q tile to Qs and of key tile 0 to stage 0.
// `load_kv(stage, k0)` starts the copies of keys [k0, k0 + 64) into
// `Ks[stage]` / `Vs[stage]` (zero-filled past n); `prep_q(Qw)` may rewrite
// the warp's 16 Q rows in place before they are read (every warp's copies
// have landed then); `tile_bias(k0)` returns the logit bias of the tile's
// keys as a function of (half, key - k0) (keys >= n are masked here).  Ends
// with a barrier.
template <int HD, bool EXP2 = false, class LoadKV, class PrepQ, class TileBias>
__device__ __forceinline__ void flash_key_loop(WarpAttnState<HD>& st, bf16* Qs, bf16* const (&Ks)[2],
                                               bf16* const (&Vs)[2], int ld, int n, float scale,
                                               LoadKV load_kv, PrepQ prep_q, TileBias tile_bias) {
  const int warp = threadIdx.x >> 5;
  bf16* Qw = Qs + warp * 16 * ld;
  uint32_t qa[HD / 16][4];
  const int ntiles = (n + 63) / 64;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * 64, stage = tile & 1;
    // prefetch the next tile into the other stage (free since the barrier
    // that ended the previous iteration), then wait for this one
    if (tile + 1 < ntiles) {
      load_kv(stage ^ 1, k0 + 64);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (tile == 0) {
      prep_q(Qw);
      __syncwarp();
      load_q_frags<HD>(qa, Qw, ld);
    }
    const int live = n - k0 < 64 ? n - k0 : 64;
    const auto bias = tile_bias(k0);
    attend_keys<HD, 4, EXP2>(st, qa, Ks[stage], Vs[stage], ld, (live + 15) / 16, scale,
                             [&](int half, int key) {
                               return key < live ? bias(half, key) : neg_inf();
                             });
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
}

// Starts the 16-byte copies of rows [row0, row0 + 64) of a row-major bf16
// matrix (row stride `stride` elements, columns [col, col + HD)) into a
// shared tile of row stride `ld`; rows >= n are zero-filled.
template <int HD>
__device__ __forceinline__ void load_tile_rows_async(bf16* dst, const bf16* __restrict__ src,
                                                     int row0, int n, size_t stride, int col,
                                                     int ld) {
  constexpr int CH = HD / 8;
  for (int idx = threadIdx.x; idx < 64 * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH, row = row0 + r;
    cp_async16(dst + r * ld + c * 8, src + (size_t)(row < n ? row : n - 1) * stride + col + c * 8,
               row < n);
  }
}

}  // namespace samrs
