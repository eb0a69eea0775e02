// K1 core: 14x14-window attention with the decomposed relative-position bias,
// read straight from the unpadded (B, H, W, 3C) qkv map.
//
// Replaces samrs_tpu/kernels/fused_window_layer.py::_kernel (the attention
// part; its qkv and proj matmuls are the GEMM of gemm.cu).  The TPU kernel
// pads the map 64 -> 70 and lets the pad tokens attend unmasked with
// k = v = qkv bias; it folds the rel-pos terms into an augmented-K matmul
// with one-hot expansions.  Here:
//   * one block per (window, head, image); the qkv GEMM runs on the 4096
//     real tokens only, and a window's tokens that fall outside the map are
//     filled in shared memory from the qkv bias, which is exactly what the
//     zero-padded map would have produced;
//   * the 196 tokens are padded to 208 (13 tensor-core tiles); those 12 tile
//     rows are zero keys, masked out of the softmax, and their queries are
//     never written;
//   * rel_h / rel_w (14 + 14 dot products of length head_dim per query) are
//     computed from q in fp32 on the CUDA cores, as the oracle does; the
//     tables arrive as (x, d, u) so the 14 lanes of a half-warp read 56
//     contiguous bytes per step.
// Bound on the H100: neither bytes nor tensor-core flops (a ViT-H layer is
// ~5 GFLOP of attention against ~30 MB of qkv); latency and shared-memory
// capacity are: K and V of a window take 73 KB at head_dim 80, so loads are
// cp.async copies the warps do not wait on one by one, and the logits stay
// in registers (warp_attention.cuh) so that two blocks fit per SM.  Each
// warp owns 16 query rows at a time and streams the window's keys in blocks
// of 64 with an online softmax.
#include "warp_attention.cuh"

namespace samrs {
namespace {

constexpr int WIN_WARPS = 4;
constexpr int WIN_WS = 14;  // SAM's window; the only instantiated size

struct WinLayout {
  int ldq, np;
  size_t k_off, v_off, warp_off, warp_bytes, q_off, rel_off, total;
};

// K and V of the window, then per warp: its 16 query rows and their fp32
// rel-pos terms.
__host__ __device__ constexpr WinLayout win_layout(int hd, int ws) {
  WinLayout L{};
  const int nt = ws * ws;
  L.ldq = hd + 8;  // 16-byte rows, conflict-free ldmatrix
  L.np = (nt + 15) / 16 * 16;
  L.k_off = 0;
  L.v_off = align_up((size_t)L.np * L.ldq * 2, 128);
  L.warp_off = L.v_off + align_up((size_t)L.np * L.ldq * 2, 128);
  L.q_off = 0;
  L.rel_off = align_up((size_t)16 * L.ldq * 2, 128);
  L.warp_bytes = L.rel_off + align_up((size_t)16 * 2 * ws * 4, 128);
  L.total = L.warp_off + WIN_WARPS * L.warp_bytes;
  return L;
}

// Starts the 16-byte copy of token t's q, k or v head slice (`part` = 0, 1,
// 2) into shared memory: from the map, from the bias for map-pad tokens,
// zero-filled for the tile-pad rows t >= WS*WS (and map-pad without bias).
template <int HD, int WS>
__device__ __forceinline__ void token_chunk_async(bf16* dst, const bf16* __restrict__ base,
                                                  const bf16* __restrict__ bqkv, int t, int chunk,
                                                  int part, int wi, int wj, int H, int W, int C,
                                                  int h) {
  const bf16* src = base;
  bool valid = false;
  if (t < WS * WS) {
    const int x = wi * WS + t / WS, y = wj * WS + t % WS;
    const int off = part * C + h * HD + chunk * 8;
    if (x < H && y < W) {
      src = base + ((size_t)x * W + y) * 3 * C + off;
      valid = true;
    } else if (bqkv) {
      src = bqkv + off;
      valid = true;
    }
  }
  cp_async16(dst, src, valid);
}

template <int HD, int WS>
__global__ void __launch_bounds__(WIN_WARPS * 32)
window_attention_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ bqkv,
                        const float* __restrict__ RhT, const float* __restrict__ RwT,
                        bf16* __restrict__ out, int H, int W, int C, int nww, float scale) {
  constexpr int CH = HD / 8;  // 16-byte chunks per head row
  constexpr WinLayout L = win_layout(HD, WS);
  constexpr int NT = WS * WS;
  constexpr int NSTRIPES = L.np / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k_off);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned char* wbase = smem + L.warp_off + warp * L.warp_bytes;
  bf16* Qs = reinterpret_cast<bf16*>(wbase + L.q_off);
  float* rel = reinterpret_cast<float*>(wbase + L.rel_off);

  const int wi = blockIdx.x / nww, wj = blockIdx.x % nww;
  const int h = blockIdx.y, b = blockIdx.z;
  const bf16* base = qkv + (size_t)b * H * W * 3 * C;

  for (int idx = threadIdx.x; idx < L.np * CH; idx += blockDim.x) {
    const int t = idx / CH, c = idx % CH;
    token_chunk_async<HD, WS>(Ks + t * L.ldq + c * 8, base, bqkv, t, c, 1, wi, wj, H, W, C, h);
    token_chunk_async<HD, WS>(Vs + t * L.ldq + c * 8, base, bqkv, t, c, 2, wi, wj, H, W, C, h);
  }
  cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  for (int s = warp; s < NSTRIPES; s += WIN_WARPS) {
    // this warp's 16 query rows (the first stripe's copy overlaps K/V's)
    for (int idx = lane; idx < 16 * CH; idx += 32) {
      const int r = idx / CH, c = idx % CH;
      token_chunk_async<HD, WS>(Qs + r * L.ldq + c * 8, base, bqkv, s * 16 + r, c, 0, wi, wj,
                                H, W, C, h);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();

    // rel[r][u] = q_r . Rh[x_r, u], rel[r][WS + u] = q_r . Rw[y_r, u]  (fp32);
    // a half-warp takes one row, lane u one table column
    {
      const int u = lane & 15;
      for (int r = lane >> 4; r < 16; r += 2) {
        const int t = s * 16 + r;
        if (u < WS) {
          float ah = 0.f, aw = 0.f;
          if (t < NT) {
            const bf16* q = Qs + r * L.ldq;
            const float* rh = RhT + (size_t)(t / WS) * HD * WS + u;
            const float* rw = RwT + (size_t)(t % WS) * HD * WS + u;
#pragma unroll 8
            for (int d = 0; d < HD; ++d) {
              const float qd = __bfloat162float(q[d]);
              ah += qd * rh[d * WS];
              aw += qd * rw[d * WS];
            }
          }
          rel[r * 2 * WS + u] = ah;
          rel[r * 2 * WS + WS + u] = aw;
        }
      }
    }
    if (s == warp) __syncthreads();  // K/V landed (every warp has >= 1 stripe)
    __syncwarp();

    uint32_t qa[HD / 16][4];
    load_q_frags<HD>(qa, Qs, L.ldq);
    WarpAttnState<HD> st;
    st.init();
    const float* relr[2] = {rel + g * 2 * WS, rel + (g + 8) * 2 * WS};
#pragma unroll
    for (int k0 = 0; k0 < L.np; k0 += 64) {
      const int nkb = (L.np - k0) / 16 < 4 ? (L.np - k0) / 16 : 4;
      attend_keys<HD, 4>(st, qa, Ks + k0 * L.ldq, Vs + k0 * L.ldq, L.ldq, nkb, scale,
                         [&](int half, int key) {
                           const int kk = k0 + key;  // keys past the window are tile padding
                           return kk < NT ? relr[half][kk / WS] + relr[half][WS + kk % WS]
                                          : neg_inf();
                         });
    }

#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int t = s * 16 + g + 8 * half;
      const int x = wi * WS + t / WS, y = wj * WS + t % WS;
      if (t < NT && x < H && y < W) {
        const float inv = 1.f / st.l[half];
        bf16* orow = out + (((size_t)b * H + x) * W + y) * C + h * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < HD / 8; ++n)
          *reinterpret_cast<__nv_bfloat162*>(orow + n * 8) =
              __floats2bfloat162_rn(st.o[n][2 * half] * inv, st.o[n][2 * half + 1] * inv);
      }
    }
    __syncwarp();  // Qs and rel are rewritten by the next stripe
  }
}

template <int HD>
int launch_window(const void* qkv, const void* bqkv, const void* RhT, const void* RwT, void* out,
                  int B, int H, int W, int C, int num_heads, float scale, cudaStream_t stream) {
  constexpr WinLayout L = win_layout(HD, WIN_WS);
  static_assert((L.np / 16) >= WIN_WARPS, "every warp needs a query stripe");
  auto kernel = window_attention_kernel<HD, WIN_WS>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L.total);
  if (err != cudaSuccess) return err;
  const int nwh = (H + WIN_WS - 1) / WIN_WS, nww = (W + WIN_WS - 1) / WIN_WS;
  dim3 grid(nwh * nww, num_heads, B);
  kernel<<<grid, WIN_WARPS * 32, L.total, stream>>>(
      static_cast<const bf16*>(qkv), static_cast<const bf16*>(bqkv), static_cast<const float*>(RhT),
      static_cast<const float*>(RwT), static_cast<bf16*>(out), H, W, C, nww, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace samrs

extern "C" {

// Shared-memory bytes the kernel needs at (head_dim, window 14); the wrapper
// checks it against the device limit before launching.
long long samrs_window_attention_smem(int head_dim) {
  return (long long)samrs::win_layout(head_dim, samrs::WIN_WS).total;
}

// qkv (B, H, W, 3C) bf16, bqkv (3C,) bf16 or NULL, RhT/RwT (14, head_dim, 14)
// fp32 (the gathered (x_q, x_k, d) tables with the last two axes swapped)
// -> out (B, H, W, C) bf16, the attention output before the projection.
int samrs_window_attention(const void* qkv, const void* bqkv, const void* RhT, const void* RwT,
                           void* out, int B, int H, int W, int C, int num_heads, int head_dim,
                           int ws, float scale, void* stream) {
  using namespace samrs;
  if (B <= 0 || H <= 0 || W <= 0 || ws != WIN_WS || num_heads * head_dim != C)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (head_dim == 80) return launch_window<80>(qkv, bqkv, RhT, RwT, out, B, H, W, C, num_heads, scale, st);
  if (head_dim == 64) return launch_window<64>(qkv, bqkv, RhT, RwT, out, B, H, W, C, num_heads, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
