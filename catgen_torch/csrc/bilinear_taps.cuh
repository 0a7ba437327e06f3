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
//
// Element types: float, or __nv_bfloat16 for catgen's bf16 compute dtype.
// A bf16 value is read exactly into f32 (its bits moved up 16), every
// weight, lerp and sum is f32, and a bf16 result is rounded once, to
// nearest even, as it is stored (__float2bfloat16_rn): the plain PyTorch
// version's upcast, f32 arithmetic and one .to(torch.bfloat16). The
// coordinates come in the image's type, so bf16 coordinates are bf16
// values, and d_coords leaves in that type too.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// One value of the element type, read into f32 (through the read-only
// cache) or written from f32 (rounded to nearest even for bf16).
__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}
__device__ __forceinline__ float tof(float v) { return v; }
__device__ __forceinline__ float tof(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void stf(float* p, float v) { *p = v; }
__device__ __forceinline__ void stf(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// 16 bytes of the element type: N values, unpacked into f32 or packed from
// f32 (element 0 in the lowest bytes).
template <class T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void unpack(const uint4& v, float* out) {
    out[0] = __uint_as_float(v.x);
    out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z);
    out[3] = __uint_as_float(v.w);
  }
  __device__ static uint4 pack(const float* in) {
    return make_uint4(__float_as_uint(in[0]), __float_as_uint(in[1]),
                      __float_as_uint(in[2]), __float_as_uint(in[3]));
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void unpack(const uint4& v, float* out) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t bits(float x) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
  }
  __device__ static uint4 pack(const float* in) {
    return make_uint4(bits(in[0]) | bits(in[1]) << 16,
                      bits(in[2]) | bits(in[3]) << 16,
                      bits(in[4]) | bits(in[5]) << 16,
                      bits(in[6]) | bits(in[7]) << 16);
  }
};

// 4 bf16 values (8 bytes, element 0 in the lowest bytes) read into f32
__device__ __forceinline__ void unpack4(const uint2& v, float* out) {
  out[0] = __uint_as_float(v.x << 16);
  out[1] = __uint_as_float(v.x & 0xffff0000u);
  out[2] = __uint_as_float(v.y << 16);
  out[3] = __uint_as_float(v.y & 0xffff0000u);
}

// 4 f32 values rounded once to bf16 (nearest even) and packed into 8 bytes
__device__ __forceinline__ uint2 pack4(const float* in) {
  return make_uint2(Vec<__nv_bfloat16>::bits(in[0]) |
                        Vec<__nv_bfloat16>::bits(in[1]) << 16,
                    Vec<__nv_bfloat16>::bits(in[2]) |
                        Vec<__nv_bfloat16>::bits(in[3]) << 16);
}

// Copies `chunks` 16-byte vectors from global `src` to shared `dst` with
// the block's threads (cp.async; the caller commits and waits).
__device__ __forceinline__ void stage_async(uint4* dst, const uint4* src,
                                            int chunks) {
  for (int k = threadIdx.x; k < chunks; k += blockDim.x) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (uint32_t)__cvta_generic_to_shared(dst + k)),
                 "l"(src + k));
  }
}

// A staged bf16 image of C < 32 channels, widened in shared memory to
// groups of 4 channels (8 bytes a group, zeros past c), so that a tap of
// C <= 4 channels is one 8-byte read: the per-quad forward
// (bilinear_sample.cu) and d_coords (bilinear_sample_bwd.cu) kernels read
// their taps from it. Bytes of the widened copy of an (h, w, c) image:
static inline int64_t wide_bytes(int h, int w, int c) {
  return (int64_t)h * w * ((c + 3) / 4) * 8;
}

// Widens the sample's image `raw` (hw pixels of c bf16 values, as it
// lies) into `wide` with the block's threads; the caller syncs before (raw
// staged) and after.
__device__ __forceinline__ void widen4(uint2* __restrict__ wide,
                                       const unsigned short* __restrict__ raw,
                                       int hw, int c) {
  const int cg = (c + 3) / 4;
  for (int pix = threadIdx.x; pix < hw; pix += blockDim.x) {
    for (int k = 0; k < cg; ++k) {
      uint32_t v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ch = 4 * k + i;
        v[i] = ch < c ? raw[pix * c + ch] : 0u;
      }
      wide[pix * cg + k] = make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
    }
  }
}

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
template <class T>
__device__ __forceinline__ float lerp_taps(const T* __restrict__ base,
                                           const Taps& t, int c) {
  return lerp_values(ldf(base + t.p00 * c), ldf(base + t.p01 * c),
                     ldf(base + t.p10 * c), ldf(base + t.p11 * c), t);
}

// Where the normalized (y, x) coordinate of output pixel `pi` of sample
// `ni` lies, for `p` output pixels per sample, and where its gradient goes,
// in the element type T.
// Rows: (n, 2, p), a row of y then a row of x (the v4 kernel's layout).
struct RowsLayout {
  template <class T>
  __device__ static float2 load(const T* __restrict__ crd, int ni, int pi,
                                int p) {
    const T* cr = crd + (int64_t)ni * 2 * p;
    return make_float2(ldf(cr + pi), ldf(cr + p + pi));
  }
  template <class T>
  __device__ static void store(T* __restrict__ d, int ni, int pi, int p,
                               float dy, float dx) {
    T* o = d + (int64_t)ni * 2 * p;
    stf(o + pi, dy);
    stf(o + p + pi, dx);
  }
  // pixels pi .. pi + Vec<T>::N - 1 as two 16-byte loads: crd 16-byte
  // aligned, p and pi multiples of Vec<T>::N
  template <class T>
  __device__ static void loadv(const T* __restrict__ crd, int ni, int pi,
                               int p, float* y, float* x) {
    const T* cr = crd + (int64_t)ni * 2 * p;
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(cr + pi)), y);
    Vec<T>::unpack(__ldg(reinterpret_cast<const uint4*>(cr + p + pi)), x);
  }
  // bf16 pixels pi .. pi + 3 as two 8-byte loads: crd 16-byte aligned, p
  // and pi multiples of 4
  __device__ static void load4(const __nv_bfloat16* __restrict__ crd,
                               int ni, int pi, int p, float* y, float* x) {
    const __nv_bfloat16* cr = crd + (int64_t)ni * 2 * p;
    unpack4(__ldg(reinterpret_cast<const uint2*>(cr + pi)), y);
    unpack4(__ldg(reinterpret_cast<const uint2*>(cr + p + pi)), x);
  }
  // the gradients of bf16 pixels pi .. pi + 3, each rounded once, as two
  // 8-byte stores (4 dy, then 4 dx); the alignment of load4
  __device__ static void store4(__nv_bfloat16* __restrict__ d, int ni,
                                int pi, int p, const float* dy,
                                const float* dx) {
    __nv_bfloat16* o = d + (int64_t)ni * 2 * p;
    *reinterpret_cast<uint2*>(o + pi) = pack4(dy);
    *reinterpret_cast<uint2*>(o + p + pi) = pack4(dx);
  }
};

// Grid: (n, p, 2), one (y, x) pair per pixel (the layout of catgen's
// affine_grid and of its v1-v3 kernels); one load and store of the pair
// each (8 bytes in f32, 4 in bf16). The wrapper checks that the array is
// aligned to a pair.
struct GridLayout {
  template <class T>
  __device__ static float2 load(const T* __restrict__ crd, int ni, int pi,
                                int p) {
    const T* c = crd + 2 * ((int64_t)ni * p + pi);
    if constexpr (sizeof(T) == 4) {
      return __ldg(reinterpret_cast<const float2*>(c));
    } else {
      const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(c));
      return make_float2(__uint_as_float(v << 16),
                         __uint_as_float(v & 0xffff0000u));
    }
  }
  template <class T>
  __device__ static void store(T* __restrict__ d, int ni, int pi, int p,
                               float dy, float dx) {
    T* o = d + 2 * ((int64_t)ni * p + pi);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float2*>(o) = make_float2(dy, dx);
    } else {
      stf(o, dy);
      stf(o + 1, dx);
    }
  }
  // pixels pi .. pi + Vec<T>::N - 1 as two 16-byte loads of (y, x) pairs,
  // the same alignment as RowsLayout::loadv
  template <class T>
  __device__ static void loadv(const T* __restrict__ crd, int ni, int pi,
                               int p, float* y, float* x) {
    constexpr int N = Vec<T>::N;
    const uint4* cr =
        reinterpret_cast<const uint4*>(crd + 2 * ((int64_t)ni * p + pi));
    float v[2 * N];
    Vec<T>::unpack(__ldg(cr), v);
    Vec<T>::unpack(__ldg(cr + 1), v + N);
#pragma unroll
    for (int j = 0; j < N; ++j) {
      y[j] = v[2 * j];
      x[j] = v[2 * j + 1];
    }
  }
  // bf16 pixels pi .. pi + 3 as one 16-byte load of (y, x) pairs, the
  // same alignment as RowsLayout::load4
  __device__ static void load4(const __nv_bfloat16* __restrict__ crd,
                               int ni, int pi, int p, float* y, float* x) {
    float v[8];
    Vec<__nv_bfloat16>::unpack(__ldg(reinterpret_cast<const uint4*>(
        crd + 2 * ((int64_t)ni * p + pi))), v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = v[2 * j];
      x[j] = v[2 * j + 1];
    }
  }
  // the gradients of bf16 pixels pi .. pi + 3 as one 16-byte store of 4
  // (dy, dx) pairs, each rounded once; the alignment of load4
  __device__ static void store4(__nv_bfloat16* __restrict__ d, int ni,
                                int pi, int p, const float* dy,
                                const float* dx) {
    float v[8];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = dy[j];
      v[2 * j + 1] = dx[j];
    }
    *reinterpret_cast<uint4*>(d + 2 * ((int64_t)ni * p + pi)) =
        Vec<__nv_bfloat16>::pack(v);
  }
};

// Which kernel a sampler shape of C >= 32 takes, forward
// (bilinear_sample.cu) and d_coords (bilinear_sample_bwd.cu) alike, decided
// by (h, w, C) and the element size alone so that every run of one shape
// takes the same kernel:
//   * kPerPixel for C < 32 (the input transformer's C = 3), where each
//     launcher has a rule of its own (below);
//   * kStaged where a pixel's C values fill whole 16-byte vectors (C % 4
//     == 0 in f32, C % 8 == 0 in bf16) and the image (h w C values) fits
//     one block's opt-in shared memory (64 KB at the branch shape 16x16x64
//     in f32, 32 KB in bf16): the sample's image is staged there once per
//     block and read 16 bytes at a time;
//   * kPerWarp otherwise (other C, a 32x32x64 image of 256 KB): one warp
//     (d_coords) or one thread (forward) per channel group, from global
//     memory.
// A launcher also needs 16-byte aligned arrays for kStaged, and takes
// kPerWarp where they are not. For C < 32 both have a fourth kernel,
// kPerQuad, chosen by a rule of each launcher's (bilinear_sample.cu,
// forward_shape_kind: f32 and bf16; bilinear_sample_bwd.cu,
// dcoords_shape_kind: bf16 alone), and kPerPixel where it does not apply.
enum SamplerKind { kPerPixel = 0, kPerWarp = 1, kStaged = 2, kPerQuad = 3 };

static inline int64_t staged_smem_bytes(int h, int w, int c, int elem) {
  return (int64_t)h * w * c * elem;
}

// Whether a pointer is 16-byte aligned (a null pointer is)
static inline bool aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15u) == 0;
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

// kPerPixel, kPerWarp or kStaged for elements of `elem` bytes (4 or 2); a
// negative cudaError_t if the card's shared memory could not be read
static inline int sampler_kind(int h, int w, int c, int elem) {
  if (c < 32) return kPerPixel;
  if ((int64_t)c * elem % 16 != 0) return kPerWarp;
  const int optin = optin_smem();
  if (optin < 0) return optin;
  return staged_smem_bytes(h, w, c, elem) <= optin ? kStaged : kPerWarp;
}
