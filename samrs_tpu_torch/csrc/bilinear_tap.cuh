// One bilinear tap at absolute pixel coordinates (fx, fy) with zero padding:
// the four corners' clamped pixel indices, validity and weights.  Shared by
// K8 (bilinear_gather.cu, bilinear_slab.cu), so that both take the floor, the
// weights and the validity exactly as their plain versions do
// (samrs_tpu_torch/kernels/bilinear_gather.py::_corners); K9 (point_sample.cu)
// takes them the same way without the clamped indices (``corners``).
#pragma once

#include "common.cuh"

namespace samrs {

struct Tap {
  int i00, i01, i10, i11;        // pixel index y * W + x (clamped into the map)
  int cx0, cx1, cy0, cy1;        // the corners' columns and rows, clamped into the map
  int x0, y0;                    // floor(fx), floor(fy), clamped into [-2, W] / [-2, H]
  float w00, w01, w10, w11;      // bilinear weights, 0 for a corner off the map
  float wx, wy;
  bool v00, v01, v10, v11;
};

__device__ __forceinline__ Tap make_tap(float fx, float fy, int H, int W) {
  Tap t;
  const float x0f = floorf(fx), y0f = floorf(fy);
  t.wx = fx - x0f;
  t.wy = fy - y0f;
  // clamp before the int conversion; a clamped corner is off the map either way
  const int x0 = static_cast<int>(fminf(fmaxf(x0f, -2.f), static_cast<float>(W)));
  const int y0 = static_cast<int>(fminf(fmaxf(y0f, -2.f), static_cast<float>(H)));
  const int x1 = x0 + 1, y1 = y0 + 1;
  const bool vx0 = x0 >= 0 && x0 < W, vx1 = x1 >= 0 && x1 < W;
  const bool vy0 = y0 >= 0 && y0 < H, vy1 = y1 >= 0 && y1 < H;
  t.v00 = vy0 && vx0; t.v01 = vy0 && vx1; t.v10 = vy1 && vx0; t.v11 = vy1 && vx1;
  const int cx0 = min(max(x0, 0), W - 1), cx1 = min(max(x1, 0), W - 1);
  const int cy0 = min(max(y0, 0), H - 1), cy1 = min(max(y1, 0), H - 1);
  t.cx0 = cx0; t.cx1 = cx1; t.cy0 = cy0; t.cy1 = cy1;
  t.x0 = x0; t.y0 = y0;
  t.i00 = cy0 * W + cx0; t.i01 = cy0 * W + cx1; t.i10 = cy1 * W + cx0; t.i11 = cy1 * W + cx1;
  const float ax = 1.f - t.wx, ay = 1.f - t.wy;
  t.w00 = t.v00 ? ax * ay : 0.f;
  t.w01 = t.v01 ? t.wx * ay : 0.f;
  t.w10 = t.v10 ? ax * t.wy : 0.f;
  t.w11 = t.v11 ? t.wx * t.wy : 0.f;
  return t;
}

}  // namespace samrs
