// Warp-level attention building block shared by K1 (window attention) and K2
// (global flash attention): one warp owns 16 query rows and streams key
// blocks through the tensor cores with the logits kept in registers.
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

// One online-softmax step over `nkb` (<= MAXKB) blocks of 16 keys whose K and
// V rows start at Ks / Vs (row-major [key][d], stride `ld`).  `bias(half,
// key)` returns the additive logit bias of row g + 8*half at key index `key`
// (relative to Ks), or -inf to mask the key; logits are s*scale + bias.
template <int HD, int MAXKB, class Bias>
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
    alpha[half] = __expf(st.m[half] - m_new);  // 0 while m was -inf
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
          const __nv_bfloat162 p = __floats2bfloat162_rn(__expf(s[j][2 * half] - st.m[half]),
                                                         __expf(s[j][2 * half + 1] - st.m[half]));
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

}  // namespace samrs
