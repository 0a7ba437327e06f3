// The four taps and two weights of one edge-clamped bilinear sample, shared
// by the sampler's forward (bilinear_sample.cu) and backward
// (bilinear_sample_bwd.cu) kernels.
//
// Follows catgen/nn/spatial_transformer.py, bilinear_sample, and
// _weights_rows of catgen/kernels/pallas_bilinear_v4.py: the pixel
// coordinate is clipped to [0, size-1] and the first tap is floor()
// clipped to [0, size-2], so the weight reaches 1.0 at the far edge; a
// one-pixel axis (size 1) keeps tap 0 and weight 0. in_y / in_x are 1
// where the unclipped coordinate lies in [0, size-1], edges included (the
// TPU kernel's masks; the derivative of the clip there is 1), else 0.

#pragma once

#include <stdint.h>

struct Taps {
  int64_t p00, p01, p10, p11;  // pixel indices y*w + x of the four taps
  float wy, wx;
  float in_y, in_x;
};

__device__ __forceinline__ Taps make_taps(float yn, float xn, int h, int w) {
  const float fy_raw = (yn + 1.0f) * 0.5f * (float)(h - 1);
  const float fx_raw = (xn + 1.0f) * 0.5f * (float)(w - 1);
  const float fy = fminf(fmaxf(fy_raw, 0.0f), (float)(h - 1));
  const float fx = fminf(fmaxf(fx_raw, 0.0f), (float)(w - 1));
  const int y0 = h > 1 ? min(max((int)floorf(fy), 0), h - 2) : 0;
  const int x0 = w > 1 ? min(max((int)floorf(fx), 0), w - 2) : 0;
  const int y1 = min(y0 + 1, h - 1);
  const int x1 = min(x0 + 1, w - 1);
  Taps t;
  t.p00 = (int64_t)y0 * w + x0;
  t.p01 = (int64_t)y0 * w + x1;
  t.p10 = (int64_t)y1 * w + x0;
  t.p11 = (int64_t)y1 * w + x1;
  t.wy = fy - (float)y0;
  t.wx = fx - (float)x0;
  t.in_y = (fy_raw >= 0.0f && fy_raw <= (float)(h - 1)) ? 1.0f : 0.0f;
  t.in_x = (fx_raw >= 0.0f && fx_raw <= (float)(w - 1)) ? 1.0f : 0.0f;
  return t;
}
