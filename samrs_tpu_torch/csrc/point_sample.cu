// K9: per-mask single-channel bilinear point sample, forward and backward.
//
//   out[n, k] = bilinear(img[n], fy[n, k], fx[n, k])
//
// img (N, H, W) fp32 or bf16; fx, fy (N, K) fp32 absolute pixel coordinates
// (align_corners=False: fx = x * W - 0.5 for x in [0, 1]); zero padding off the
// map; out (N, K) fp32.  The Mask2Former point losses call it on the N = B x 100
// mask logits and their matched targets, K 12544 points each (37632 for the
// uncertainty candidates).
//
// Replaces samrs_tpu/kernels/bilinear_gather.py::_make_point_sampler (the
// forward pallas_call :762 and the backward :786).  The TPU kernels put the
// points in lanes and gathered through "hat" matmuls on the matrix unit (a
// (H, Kb) row-weight matrix times the transposed map), because a C = 1 channel
// axis in K8's channels-in-lanes layout pads 128x.  Here it is the direct
// four-corner gather, and K8 with Gc = 1 would be the wrong shape too (a
// 32-lane group per single channel): one block takes one mask and a chunk of up
// to PTS_PER_BLOCK of its points, one thread one point at a time.
//
// Shared-memory path (the mask fits: 12.5 KB at 56x56): the block stages the
// mask in shared memory once and every corner read hits it; the backward also
// keeps a shared dimg partial that the threads accumulate with shared-memory
// atomics, and that goes to device memory once per block (a plain store when
// the mask has one chunk, else an atomicAdd per pixel).  Global path (a mask
// above the shared-memory budget, e.g. 256x256 = 256 KB): corner reads from
// device memory and dimg by device atomics.  Both kernels are bound by device
// bytes (the coordinates and the output: 12 bytes a point forward, 20 backward).
//
// The forward rounds each product and sum on its own, in the plain version's
// order (point_sample_plain), so the two agree bit for bit; the uncertainty
// sampling keeps the top-k of the candidates' |logit|, and a 1-ulp difference
// would change which points it keeps.  The coordinate derivative is the
// one-sided one of the floor formula, exactly JAX's _dhat (see K8).  dimg's
// atomics make its fp32 summation order vary from run to run.
#include "bilinear_tap.cuh"

namespace samrs {
namespace {

constexpr int PS_THREADS = 256;
constexpr int PTS_PER_BLOCK = 8192;          // points of one mask one block takes
constexpr int SMEM_BUDGET = 227 * 1024;      // shared memory a block can use on sm_90
constexpr int SMEM_DEFAULT = 48 * 1024;      // above this a kernel needs the opt-in

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

// The image of one mask: staged in shared memory or read from device memory.
template <typename T, bool SMEM>
struct MaskImage {
  const T* g;
  const float* s;
  __device__ __forceinline__ float operator()(bool valid, int pix) const {
    if (!valid) return 0.f;
    return SMEM ? s[pix] : to_float(g[pix]);
  }
};

template <typename T>
__device__ __forceinline__ void stage(float* s, const T* g, int HW) {
  for (int i = threadIdx.x; i < HW; i += PS_THREADS) s[i] = to_float(g[i]);
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(PS_THREADS)
point_sample_fwd_kernel(const T* __restrict__ img, const float* __restrict__ fx,
                        const float* __restrict__ fy, float* __restrict__ out, int H, int W,
                        int K, int nchunks) {
  extern __shared__ float s_img[];
  const int n = blockIdx.x / nchunks;
  const int k0 = (blockIdx.x % nchunks) * PTS_PER_BLOCK;
  const int k1 = min(K, k0 + PTS_PER_BLOCK);
  const T* g = img + static_cast<size_t>(n) * H * W;
  if (SMEM) {
    stage(s_img, g, H * W);
    __syncthreads();
  }
  const MaskImage<T, SMEM> at{g, s_img};
  for (int k = k0 + threadIdx.x; k < k1; k += PS_THREADS) {
    const size_t i = static_cast<size_t>(n) * K + k;
    const Tap t = make_tap(fx[i], fy[i], H, W);
    // rounded op by op (no fused multiply-add), in the plain version's order
    float s = __fmul_rn(at(t.v00, t.i00), t.w00);
    s = __fadd_rn(s, __fmul_rn(at(t.v01, t.i01), t.w01));
    s = __fadd_rn(s, __fmul_rn(at(t.v10, t.i10), t.w10));
    s = __fadd_rn(s, __fmul_rn(at(t.v11, t.i11), t.w11));
    out[i] = s;
  }
}

// dimg: the mask's (H, W) fp32 gradient in device memory, zeroed by the caller;
// dfx, dfy may be null (no coordinate gradient asked for).
template <typename T, bool SMEM>
__global__ void __launch_bounds__(PS_THREADS)
point_sample_bwd_kernel(const T* __restrict__ img, const float* __restrict__ fx,
                        const float* __restrict__ fy, const float* __restrict__ dout,
                        float* __restrict__ dimg, float* __restrict__ dfx,
                        float* __restrict__ dfy, int H, int W, int K, int nchunks) {
  extern __shared__ float smem[];
  float* s_img = smem;
  float* s_d = smem + H * W;
  const int HW = H * W;
  const int n = blockIdx.x / nchunks;
  const int k0 = (blockIdx.x % nchunks) * PTS_PER_BLOCK;
  const int k1 = min(K, k0 + PTS_PER_BLOCK);
  const T* g = img + static_cast<size_t>(n) * HW;
  float* d_img = dimg + static_cast<size_t>(n) * HW;
  if (SMEM) {
    stage(s_img, g, HW);
    for (int i = threadIdx.x; i < HW; i += PS_THREADS) s_d[i] = 0.f;
    __syncthreads();
  }
  float* d = SMEM ? s_d : d_img;  // atomics into shared or device memory
  const MaskImage<T, SMEM> at{g, s_img};
  for (int k = k0 + threadIdx.x; k < k1; k += PS_THREADS) {
    const size_t i = static_cast<size_t>(n) * K + k;
    const Tap t = make_tap(fx[i], fy[i], H, W);
    const float r = dout[i];
    if (dfx != nullptr) {
      const float v00 = at(t.v00, t.i00), v01 = at(t.v01, t.i01);
      const float v10 = at(t.v10, t.i10), v11 = at(t.v11, t.i11);
      const float ax = 1.f - t.wx, ay = 1.f - t.wy;
      const float top = v00 * ax + v01 * t.wx;
      const float bot = v10 * ax + v11 * t.wx;
      dfx[i] = r * ((v01 - v00) * ay + (v11 - v10) * t.wy);
      dfy[i] = r * (bot - top);
    }
    if (t.v00) atomicAdd(d + t.i00, r * t.w00);
    if (t.v01) atomicAdd(d + t.i01, r * t.w01);
    if (t.v10) atomicAdd(d + t.i10, r * t.w10);
    if (t.v11) atomicAdd(d + t.i11, r * t.w11);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < HW; i += PS_THREADS) {
      if (nchunks == 1) {
        d_img[i] = s_d[i];
      } else if (s_d[i] != 0.f) {
        atomicAdd(d_img + i, s_d[i]);
      }
    }
  }
}

bool bad_shape(int N, int H, int W, int K) { return N <= 0 || H <= 0 || W <= 0 || K <= 0; }

// Launch `kernel` on N * ceil(K / PTS_PER_BLOCK) blocks with `smem` bytes of
// dynamic shared memory (opting in above 48 KB).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int N, int K, size_t smem, cudaStream_t stream, Args... args) {
  const long long nchunks = (K + PTS_PER_BLOCK - 1) / PTS_PER_BLOCK;
  const long long blocks = static_cast<long long>(N) * nchunks;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<static_cast<unsigned>(blocks), PS_THREADS, smem, stream>>>(
      args..., static_cast<int>(nchunks));
  return cudaGetLastError();
}

template <typename T>
int fwd(const void* img, const void* fx, const void* fy, void* out, int N, int H, int W, int K,
        cudaStream_t s) {
  const size_t smem = static_cast<size_t>(H) * W * sizeof(float);
  const T* im = static_cast<const T*>(img);
  const float* x = static_cast<const float*>(fx);
  const float* y = static_cast<const float*>(fy);
  float* o = static_cast<float*>(out);
  if (smem <= SMEM_BUDGET)
    return launch(point_sample_fwd_kernel<T, true>, N, K, smem, s, im, x, y, o, H, W, K);
  return launch(point_sample_fwd_kernel<T, false>, N, K, 0, s, im, x, y, o, H, W, K);
}

template <typename T>
int bwd(const void* img, const void* fx, const void* fy, const void* dout, void* dimg, void* dfx,
        void* dfy, int N, int H, int W, int K, cudaStream_t s) {
  const size_t smem = 2 * static_cast<size_t>(H) * W * sizeof(float);
  const T* im = static_cast<const T*>(img);
  const float* x = static_cast<const float*>(fx);
  const float* y = static_cast<const float*>(fy);
  const float* r = static_cast<const float*>(dout);
  float* di = static_cast<float*>(dimg);
  float* dx = static_cast<float*>(dfx);
  float* dy = static_cast<float*>(dfy);
  if (smem <= SMEM_BUDGET)
    return launch(point_sample_bwd_kernel<T, true>, N, K, smem, s, im, x, y, r, di, dx, dy, H, W,
                  K);
  return launch(point_sample_bwd_kernel<T, false>, N, K, 0, s, im, x, y, r, di, dx, dy, H, W, K);
}

}  // namespace
}  // namespace samrs

extern "C" {

// K9 forward.  img (N, H, W) fp32 (is_bf16 = 0) or bf16 (is_bf16 = 1); fx, fy
// (N, K) fp32; out (N, K) fp32.  All contiguous.
int samrs_point_sample_fwd(const void* img, const void* fx, const void* fy, void* out, int N,
                           int H, int W, int K, int is_bf16, void* stream) {
  using namespace samrs;
  if (bad_shape(N, H, W, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<bf16>(img, fx, fy, out, N, H, W, K, s)
                 : fwd<float>(img, fx, fy, out, N, H, W, K, s);
}

// K9 backward.  dout (N, K) fp32; dimg (N, H, W) fp32, zeroed by the caller;
// dfx, dfy (N, K) fp32, or both null when no coordinate gradient is needed.
int samrs_point_sample_bwd(const void* img, const void* fx, const void* fy, const void* dout,
                           void* dimg, void* dfx, void* dfy, int N, int H, int W, int K,
                           int is_bf16, void* stream) {
  using namespace samrs;
  if (bad_shape(N, H, W, K) || (dfx == nullptr) != (dfy == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<bf16>(img, fx, fy, dout, dimg, dfx, dfy, N, H, W, K, s)
                 : bwd<float>(img, fx, fy, dout, dimg, dfx, dfy, N, H, W, K, s);
}

}  // extern "C"
