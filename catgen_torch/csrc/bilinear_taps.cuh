// The four taps and two weights of one edge-clamped bilinear sample, and the
// two layouts of its coordinates, shared by the sampler's forward
// (bilinear_sample.cu) and backward (bilinear_sample_bwd.cu) kernels and by
// the fused ST-conv kernel (st_conv.cu).
//
// Follows catgen/nn/spatial_transformer.py, bilinear_sample, and
// _weights_rows of catgen/kernels/pallas_bilinear_v4.py: the pixel
// coordinate is clipped to [0, size-1] and the first tap is floor()
// clipped to [0, size-2], so the weight reaches 1.0 at the far edge; a
// one-pixel axis (size 1) keeps tap 0 and weight 0. in_y / in_x are 1
// where the unclipped coordinate lies in [0, size-1], edges included (the
// TPU kernel's masks; the derivative of the clip there is 1), else 0.

#pragma once

#include <cuda_runtime.h>
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

// The lerp of one channel's four tap values: x first, then y, each
// product rounded on its own (the library is built with --fmad=false), as
// the plain version does.
__device__ __forceinline__ float lerp_values(float v00, float v01, float v10,
                                             float v11, const Taps& t) {
  const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
  const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
  return top * (1.0f - t.wy) + bot * t.wy;
}

// The same, reading the taps of one channel from global memory.
__device__ __forceinline__ float lerp_taps(const float* __restrict__ base,
                                           const Taps& t, int c) {
  return lerp_values(__ldg(base + t.p00 * c), __ldg(base + t.p01 * c),
                     __ldg(base + t.p10 * c), __ldg(base + t.p11 * c), t);
}

// Where the normalized (y, x) coordinate of output pixel `pi` of sample
// `ni` lies, for `p` output pixels per sample, and where its gradient goes.
// Rows: (n, 2, p), a row of y then a row of x (the v4 kernel's layout).
struct RowsLayout {
  __device__ static float2 load(const float* __restrict__ crd, int ni,
                                int pi, int p) {
    const float* cr = crd + (int64_t)ni * 2 * p;
    return make_float2(__ldg(cr + pi), __ldg(cr + p + pi));
  }
  __device__ static void store(float* __restrict__ d, int ni, int pi, int p,
                               float dy, float dx) {
    float* o = d + (int64_t)ni * 2 * p;
    o[pi] = dy;
    o[p + pi] = dx;
  }
  // pixels pi..pi+3 as two 16-byte loads: crd 16-byte aligned, p and pi
  // multiples of 4
  __device__ static void load4(const float* __restrict__ crd, int ni, int pi,
                               int p, float4& y, float4& x) {
    const float* cr = crd + (int64_t)ni * 2 * p;
    y = __ldg(reinterpret_cast<const float4*>(cr + pi));
    x = __ldg(reinterpret_cast<const float4*>(cr + p + pi));
  }
};

// Grid: (n, p, 2), one (y, x) pair per pixel (the layout of catgen's
// affine_grid and of its v1-v3 kernels); one 8-byte load and store each.
// The wrapper checks that the array is 8-byte aligned.
struct GridLayout {
  __device__ static float2 load(const float* __restrict__ crd, int ni,
                                int pi, int p) {
    return __ldg(reinterpret_cast<const float2*>(crd) + (int64_t)ni * p + pi);
  }
  __device__ static void store(float* __restrict__ d, int ni, int pi, int p,
                               float dy, float dx) {
    reinterpret_cast<float2*>(d)[(int64_t)ni * p + pi] = make_float2(dy, dx);
  }
  // pixels pi..pi+3 as two 16-byte loads of (y, x) pairs, the same
  // alignment as RowsLayout::load4
  __device__ static void load4(const float* __restrict__ crd, int ni, int pi,
                               int p, float4& y, float4& x) {
    const float4* cr =
        reinterpret_cast<const float4*>(crd + 2 * ((int64_t)ni * p + pi));
    const float4 a = __ldg(cr), b = __ldg(cr + 1);
    y = make_float4(a.x, a.z, b.x, b.z);
    x = make_float4(a.y, a.w, b.y, b.w);
  }
};

// Which kernel a sampler shape takes, forward (bilinear_sample.cu) and
// d_coords (bilinear_sample_bwd.cu) alike, decided by (h, w, c) alone so
// that every run of one shape takes the same kernel:
//   * kPerPixel for C < 32 (the input transformer's C = 3);
//   * kStaged for C % 4 == 0 whose image (h w C floats) fits one block's
//     opt-in shared memory (64 KB at the branch shape 16x16x64): the
//     sample's image is staged there once per block and read as float4;
//   * kPerWarp otherwise (odd C, a 32x32x64 image of 256 KB): one warp
//     (d_coords) or one thread (forward) per channel group, from global
//     memory.
// A launcher also needs 16-byte aligned arrays for kStaged, and takes
// kPerWarp where they are not. The forward alone has a fourth kernel for
// C < 32, kPerQuad (bilinear_sample.cu, forward_kind); d_coords keeps
// kPerPixel there.
enum SamplerKind { kPerPixel = 0, kPerWarp = 1, kStaged = 2, kPerQuad = 3 };

static inline int64_t staged_smem_bytes(int h, int w, int c) {
  return (int64_t)h * w * c * (int64_t)sizeof(float);
}

// The current card's opt-in shared memory per block, in bytes; a negative
// cudaError_t if it could not be read
static inline int optin_smem() {
  int device = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  return err == cudaSuccess ? optin : -(int)err;
}

// kPerPixel, kPerWarp or kStaged; a negative cudaError_t if the card's
// shared memory could not be read
static inline int sampler_kind(int h, int w, int c) {
  if (c < 32) return kPerPixel;
  if (c % 4 != 0) return kPerWarp;
  const int optin = optin_smem();
  if (optin < 0) return optin;
  return staged_smem_bytes(h, w, c) <= optin ? kStaged : kPerWarp;
}
