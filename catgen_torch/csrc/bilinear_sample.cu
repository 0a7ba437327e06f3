// Edge-clamped bilinear sampling of an NHWC image at normalized (y, x)
// coordinates: the forward of the spatial transformers' sampler.
//
// Replaces the TPU kernel catgen/kernels/pallas_bilinear_v4.py,
// bilinear_sample_rows -> _forward: both its separable body (_fwd_kernel,
// taken for H*W > 256, the 32x32x3 input transformer) and its dense body
// (_dense_fwd_kernel_mxu / _dense_fwd_kernel, H*W <= 256, the three branch
// transformers on 16x16x64 with their grids stacked to 48x16). On the TPU
// those are two matrix-unit formulations of one operation; on Hopper the
// operation is a gather, and one kernel serves both shapes.
//
// The same kernel, instantiated for the (N, Ho, Wo, 2) grid layout of the
// coordinates (GridLayout, bilinear_taps.cuh), replaces the TPU kernels of
// the three earlier generations: catgen/kernels/pallas_bilinear.py,
// _forward (v1, a dense one-hot matrix times the image),
// pallas_bilinear_v2.py, _forward (v2, separable A img B^T) and
// pallas_bilinear_v3.py, _forward (v3, v2 batched over the block). They
// compute one function and differ only in how they fed the TPU's matrix
// unit; a gather reads the four taps directly. The rows instantiation (v4)
// is the code it was before the layouts were templated.
//
// What bounds it: memory traffic. Per output pixel it reads two
// coordinates and four taps of C floats and writes C floats, with three
// lerps per value, far below the arithmetic the card can do per byte. At
// the branch shape (640 samples of 16x16x64 at 768 points) that is 42 MB
// of images and 126 MB of output, 0.0513 ms at 3.35 TB/s; each image
// value is a tap of ~12 outputs. At the input ST (640 samples of 32x32x3
// at 1024 points) it is 7.9 MB of images, 5.2 MB of coordinates and 7.9
// MB of output, 0.0063 ms; each value is a tap of ~4 outputs. Four
// kernels, chosen by shape and alignment alone (forward_kind), the same
// way on every run:
//   * staged (sample_per_pixel_staged), for C % 4 == 0, C >= 32, an image
//     that fits one block's opt-in shared memory and 16-byte aligned
//     arrays: one block per sample and range of output pixels copies the
//     sample's image into shared memory once (16-byte cp.async), so the
//     ~12 reads of each value come from there, not from L2 again. 16
//     lanes serve one output pixel, each lane a float4 of channels (one
//     pixel per half-warp and step at C = 64, looping for larger C): the
//     coordinates and taps are computed once per pixel, not per value,
//     and the output leaves as coalesced float4 streaming stores (it is
//     not read again here). The ranges per sample are the fewest whose
//     blocks fill the card's waves to 90% (staged_per_sample): at the
//     branch shape 3 blocks of 256 pixels, so each image is staged 3
//     times, from L2 after the first;
//   * per quad (sample_per_quad_staged), for C < 32 (the 32x32x3 input)
//     whose image fits one block's shared memory, h w C % 4 == 0 and
//     16-byte aligned image, coordinates and output: one block per sample
//     copies the sample's image (12 KB at 32x32x3) into shared memory with
//     16-byte cp.async while each thread's first coordinates are already
//     in flight, so the two reads from device memory overlap. A thread
//     takes a quad of 4 neighbouring output pixels: their coordinates
//     come as two float4 loads (rows: 4 y, then 4 x; grid: 4 (y, x)
//     pairs), their 12 taps of C values from shared memory, and their 4 C
//     outputs leave as C aligned float4 streaming stores. Where p % 4 != 0
//     the quads are not aligned, and each thread loads and stores pixel by
//     pixel instead (the same values);
//   * per value (sample_per_value), for other C >= 32 (odd channel
//     counts, a 32x32x64 image of 256 KB): one thread per output value
//     (n, p, c), c fastest, so a warp reads neighbouring channels of one
//     tap (coalesced) and shares the pixel's coordinates;
//   * per pixel (sample_per_pixel), for the other C < 32 (an image too
//     large for shared memory, h w C % 4 != 0, unaligned arrays): one
//     thread per output pixel, looping over its C channels.
// All four compute each value with lerp_values's multiplies and adds in
// the same order, so they give the same bits.
//
// Arithmetic is f32 and follows catgen/nn/spatial_transformer.py,
// bilinear_sample (and _weights_rows of the TPU kernel): clip the pixel
// coordinate to [0, size-1], first tap floor() clipped to [0, size-2], so
// the weight reaches 1.0 at the far edge. It does not reproduce the TPU
// kernel's bf16 operand rounding. The library is built with --fmad=false
// so that the lerps round as the plain PyTorch version's separate
// multiplies and adds do. No atomics: each output value is written by
// exactly one thread, so the result is deterministic.
//
// Every kernel is instantiated for float and for __nv_bfloat16 (catgen's
// bf16 compute dtype: image, coordinates and output in bf16; v4 takes bf16
// operands, accumulates in f32 and writes the image's dtype,
// pallas_bilinear_v4.py:831,858). A bf16 kernel reads its values exactly
// into f32, computes as the f32 kernel does and rounds each output once
// (bilinear_taps.cuh), so it gives the bits of the plain version's upcast,
// f32 lerps and .to(torch.bfloat16). The conditions that count in floats
// count in bytes: a 16-byte vector holds 4 f32 or 8 bf16 values, so the
// staged kernel needs C % 8 == 0 in bf16, stages half the bytes (32 KB at
// the branch shape) and gives 8 lanes, not 16, to a pixel at C = 64. The
// per-quad forward has a bf16 kernel of its own (sample_per_quad_bf16):
// 4 output pixels a thread as in f32, so that all 256 threads of a block
// work at P = 1024, with the image widened in shared memory to 8-byte
// groups of 4 channels (one read a tap at C = 3) and each round's output
// gathered in shared memory, so that it leaves as whole 16-byte vectors.
// In bf16 the bound halves: 21 MB of images and 63 MB of output at the
// branch shape; 3.9 + 2.6 + 3.9 MB at the input ST.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

// img (n, h, w, c), coordinates in layout L, out (n, p, c); all contiguous,
// of element type T.
template <class L, class T>
__global__ void sample_per_value(const T* __restrict__ img,
                                 const T* __restrict__ crd,
                                 T* __restrict__ out, int n, int h, int w,
                                 int c, int p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * p * c) return;
  const int ch = (int)(i % c);
  const int64_t pix = i / c;
  const int pi = (int)(pix % p);
  const int ni = (int)(pix / p);
  const float2 yx = L::load(crd, ni, pi, p);
  const Taps t = make_taps(yx.x, yx.y, h, w);
  stf(out + i, lerp_taps(img + (int64_t)ni * h * w * c + ch, t, c));
}

template <class L, class T>
__global__ void sample_per_pixel(const T* __restrict__ img,
                                 const T* __restrict__ crd,
                                 T* __restrict__ out, int n, int h, int w,
                                 int c, int p) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)n * p) return;
  const int pi = (int)(pix % p);
  const int ni = (int)(pix / p);
  const float2 yx = L::load(crd, ni, pi, p);
  const Taps t = make_taps(yx.x, yx.y, h, w);
  const T* base = img + (int64_t)ni * h * w * c;
  T* o = out + pix * c;
  for (int ch = 0; ch < c; ++ch) stf(o + ch, lerp_taps(base + ch, t, c));
}

constexpr int kStagedThreads = 256;

// Lanes that serve one output pixel in the staged kernels: one 16-byte
// vector each at C = 64 (16 in f32, 8 in bf16).
template <class T>
constexpr int kStagedLanes = 64 / Vec<T>::N;

// Grid: n * per_sample blocks, the blocks of one sample adjacent; block
// (ni, part) covers output pixels [part * span, (part + 1) * span) of
// sample ni. img and out 16-byte aligned, c a multiple of Vec<T>::N,
// p * c < 2^31; dynamic shared memory h*w*c values of T.
template <class L, class T>
__global__ void __launch_bounds__(kStagedThreads)
sample_per_pixel_staged(const T* __restrict__ img, const T* __restrict__ crd,
                        T* __restrict__ out, int h, int w, int c, int p,
                        int per_sample, int span) {
  constexpr int N = Vec<T>::N, LP = kStagedLanes<T>;
  extern __shared__ uint4 simg[];    // the sample's image, (h w, c / N)
  const int ni = blockIdx.x / per_sample;
  const int p0 = (blockIdx.x - ni * per_sample) * span;
  const int p1 = min(p0 + span, p);
  const int cv = c / N, chunks = h * w * cv;
  stage_async(simg, reinterpret_cast<const uint4*>(img) + (int64_t)ni * chunks,
              chunks);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  uint4* dst = reinterpret_cast<uint4*>(out) + (int64_t)ni * p * cv;
  const int l = threadIdx.x % LP, groups = blockDim.x / LP;
  for (int pi = p0 + threadIdx.x / LP; pi < p1; pi += groups) {
    const float2 yx = L::load(crd, ni, pi, p);
    const Taps t = make_taps(yx.x, yx.y, h, w);
    const int o00 = (int)t.p00 * cv, o01 = (int)t.p01 * cv;
    const int o10 = (int)t.p10 * cv, o11 = (int)t.p11 * cv;
    for (int k = l; k < cv; k += LP) {
      float a[N], b[N], e[N], f[N], r[N];
      Vec<T>::unpack(simg[o00 + k], a);
      Vec<T>::unpack(simg[o01 + k], b);
      Vec<T>::unpack(simg[o10 + k], e);
      Vec<T>::unpack(simg[o11 + k], f);
#pragma unroll
      for (int j = 0; j < N; ++j) r[j] = lerp_values(a[j], b[j], e[j], f[j], t);
      __stcs(dst + pi * cv + k, Vec<T>::pack(r));
    }
  }
}

constexpr int kQuadThreads = 256;
constexpr int kQuadPixels = 4;     // output pixels a thread
// output pixels a block of the bf16 per-quad kernel takes per round
constexpr int kQuadRound = kQuadThreads * kQuadPixels;

// Sets value j (< Vec<T>::N) of the 16-byte vector v of f32 values to x;
// a chain of selects on j, so that v stays in registers.
template <class T>
__device__ __forceinline__ void put(uint4& v, int j, float x) {
  static_assert(sizeof(T) == 4, "the f32 per-quad kernel's");
  const uint32_t bits = __float_as_uint(x), mask = 0xffffffffu;
  const int word = j;
  if (word == 0) v.x = (v.x & ~mask) | bits;
  else if (word == 1) v.y = (v.y & ~mask) | bits;
  else if (word == 2) v.z = (v.z & ~mask) | bits;
  else v.w = (v.w & ~mask) | bits;
}

// f32 per quad. Grid n, one block per sample; thread t takes the quads of
// G = Vec<T>::N = 4 neighbouring output pixels [G q, G q + G) for q = t,
// t + blockDim.x, .... img, crd and out 16-byte aligned, h*w*c values a
// whole number of 16-byte vectors, c < 32, p * c < 2^31; dynamic shared
// memory h*w*c values of T (float; bf16 takes sample_per_quad_bf16).
template <class L, class T>
__global__ void __launch_bounds__(kQuadThreads)
sample_per_quad_staged(const T* __restrict__ img, const T* __restrict__ crd,
                       T* __restrict__ out, int h, int w, int c, int p) {
  constexpr int G = Vec<T>::N;
  extern __shared__ uint4 simg4[];   // the sample's image, (h w c)
  const T* simg = reinterpret_cast<const T*>(simg4);
  const int ni = blockIdx.x;
  const int chunks = h * w * c / G;
  stage_async(simg4, reinterpret_cast<const uint4*>(img) + (int64_t)ni * chunks,
              chunks);
  asm volatile("cp.async.commit_group;\n" ::);
  // p % G == 0: every group is whole and 16-byte aligned in crd and out
  const bool vec = p % G == 0;
  int q = threadIdx.x;
  float ys[G] = {}, xs[G] = {};
  if (vec && G * q < p) L::loadv(crd, ni, G * q, p, ys, xs);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  T* o = out + (int64_t)ni * p * c;
  for (; G * q < p; q += blockDim.x) {
    uint4* dst = reinterpret_cast<uint4*>(o + G * q * c);
    uint4 buf = {};
    int fill = 0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int pi = G * q + j;
      if (pi >= p) break;
      float yn = ys[j], xn = xs[j];
      if (!vec) {
        const float2 yx = L::load(crd, ni, pi, p);
        yn = yx.x;
        xn = yx.y;
      }
      const Taps t = make_taps(yn, xn, h, w);
      const T* a = simg + (int)t.p00 * c;
      const T* b = simg + (int)t.p01 * c;
      const T* e = simg + (int)t.p10 * c;
      const T* f = simg + (int)t.p11 * c;
      for (int ch = 0; ch < c; ++ch) {
        const float v = lerp_values(tof(a[ch]), tof(b[ch]), tof(e[ch]),
                                    tof(f[ch]), t);
        if (!vec) {
          stf(o + pi * c + ch, v);
          continue;
        }
        put<T>(buf, fill, v);
        if (++fill == G) {
          __stcs(dst++, buf);
          fill = 0;
        }
      }
    }
    const int next = q + blockDim.x;
    if (vec && G * next < p) L::loadv(crd, ni, G * next, p, ys, xs);
  }
}

// Shared memory of the bf16 per-quad kernel at (h, w, c): one region that
// holds first the sample's image as it lies (16-byte cp.async) and then a
// round's output, and the image widened to whole groups of 4 channels
// (bilinear_taps.cuh, widen4).
static inline int64_t quad_bf16_region(int h, int w, int c) {
  const int64_t raw = (int64_t)h * w * c * 2;
  const int64_t round = (int64_t)kQuadRound * c * 2;
  return ((raw > round ? raw : round) + 15) / 16 * 16;
}
static inline int64_t quad_bf16_smem_bytes(int h, int w, int c) {
  return quad_bf16_region(h, w, c) + wide_bytes(h, w, c);
}

// bf16 per quad: the f32 kernel's quads (4 output pixels a thread, so
// that every thread of a 256-thread block works at P = 1024), with the
// 16-byte vector of 8 bf16 values kept apart from a thread's work. The
// sample's image is staged as it lies, then widened in shared memory to
// 4-channel groups, so that a tap of C <= 4 channels is one 8-byte read;
// the coordinates of a quad come as 8-byte loads (rows: 4 y, then 4 x) or
// one 16-byte load (grid: 4 (y, x) pairs); each value is rounded once
// into a round's output tile in shared memory, which leaves as coalesced
// 16-byte streaming stores (2-byte stores where the round's part of out
// is not whole 16-byte vectors). Where p % 4 != 0 each thread loads its
// coordinates pixel by pixel (the same values). Grid n, one block per
// sample; img, crd and out 16-byte aligned, h*w*c values a whole number
// of 16-byte vectors, c < 32, p * c < 2^31; `region` is
// quad_bf16_region(h, w, c), the dynamic shared memory
// quad_bf16_smem_bytes(h, w, c).
template <class L>
__global__ void __launch_bounds__(kQuadThreads)
sample_per_quad_bf16(const __nv_bfloat16* __restrict__ img,
                     const __nv_bfloat16* __restrict__ crd,
                     __nv_bfloat16* __restrict__ out, int h, int w, int c,
                     int p, int region) {
  constexpr int G = kQuadPixels;
  extern __shared__ uint4 smem4[];
  // the region: the sample's image (h w c values), then a round's output
  unsigned short* part = reinterpret_cast<unsigned short*>(smem4);
  // the widened image, (h w, cg) groups of 4 channels
  uint2* wide = reinterpret_cast<uint2*>(
      reinterpret_cast<uint8_t*>(smem4) + region);
  const int ni = blockIdx.x, tid = threadIdx.x;
  const int hw = h * w, cg = (c + 3) / 4;
  const int chunks = hw * c / 8;
  stage_async(smem4, reinterpret_cast<const uint4*>(img) + (int64_t)ni * chunks,
              chunks);
  asm volatile("cp.async.commit_group;\n" ::);
  const bool vec = p % G == 0;
  float ys[G] = {}, xs[G] = {};
  if (vec && G * tid < p) L::load4(crd, ni, G * tid, p, ys, xs);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  widen4(wide, part, hw, c);
  __syncthreads();

  unsigned short* o = reinterpret_cast<unsigned short*>(out) +
                      (int64_t)ni * p * c;
  for (int r0 = 0; r0 < p; r0 += kQuadRound) {
    const int q = r0 / G + tid;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int pi = G * q + j;
      if (pi >= p) break;
      float yn = ys[j], xn = xs[j];
      if (!vec) {
        const float2 yx = L::load(crd, ni, pi, p);
        yn = yx.x;
        xn = yx.y;
      }
      const Taps t = make_taps(yn, xn, h, w);
      unsigned short* dst = part + (pi - r0) * c;
      for (int k = 0; k < cg; ++k) {
        float a[4], b[4], e[4], f[4];
        unpack4(wide[(int)t.p00 * cg + k], a);
        unpack4(wide[(int)t.p01 * cg + k], b);
        unpack4(wide[(int)t.p10 * cg + k], e);
        unpack4(wide[(int)t.p11 * cg + k], f);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (4 * k + i < c) {
            dst[4 * k + i] = (unsigned short)Vec<__nv_bfloat16>::bits(
                lerp_values(a[i], b[i], e[i], f[i], t));
          }
        }
      }
    }
    const int next = q + blockDim.x;
    if (vec && G * next < p) L::load4(crd, ni, G * next, p, ys, xs);
    __syncthreads();                // the round's output is in `part`
    const int count = min(kQuadRound, p - r0) * c;
    unsigned short* base = o + (int64_t)r0 * c;
    if (((uintptr_t)base & 15u) == 0 && count % 8 == 0) {
      const uint4* src = reinterpret_cast<const uint4*>(part);
      uint4* dst = reinterpret_cast<uint4*>(base);
      for (int k = tid; k < count / 8; k += blockDim.x) __stcs(dst + k, src[k]);
    } else {
      for (int k = tid; k < count; k += blockDim.x) base[k] = part[k];
    }
    __syncthreads();                // `part` is free for the next round
  }
}

// Ranges per sample of the staged kernel: the fewest whose n * per_sample
// blocks fill their waves (blocks resident per SM x SMs) to 90% or more,
// else the fullest, with at least 32 output pixels per range. Depends on
// the shape and the card alone.
template <class L, class T>
cudaError_t staged_per_sample(int n, int p, int smem, int& best) {
  int device = 0, sms = 0, resident = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident, sample_per_pixel_staged<L, T>, kStagedThreads, smem);
  }
  if (err != cudaSuccess) return err;
  const int64_t slots = (int64_t)(resident > 0 ? resident : 1) * sms;
  const int most = p / 32 > 1 ? p / 32 : 1;
  best = 1;
  double best_fill = -1.0;
  for (int s = 1; s <= most; ++s) {
    const int64_t blocks = (int64_t)n * s;
    const double fill =
        (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill >= 0.9) {
      best = s;
      return cudaSuccess;
    }
    if (fill > best_fill) {
      best_fill = fill;
      best = s;
    }
  }
  return cudaSuccess;
}

// The forward's kind at (h, w, c) for elements of `elem` bytes with
// 16-byte aligned arrays: for C >= 32 sampler_kind's (shared with
// d_coords); for C < 32 kPerQuad where the image fits one block's opt-in
// shared memory (in bf16 with its widened copy and a round's output,
// quad_bf16_smem_bytes) and h w C values fill whole 16-byte vectors (each
// sample's image starts on 16 bytes), else kPerPixel. A negative
// cudaError_t if the card's shared memory could not be read.
int forward_shape_kind(int h, int w, int c, int elem) {
  if (c >= 32) return sampler_kind(h, w, c, elem);
  if ((int64_t)h * w * c * elem % 16 != 0) return kPerPixel;
  const int optin = optin_smem();
  if (optin < 0) return optin;
  const int64_t bytes = elem == 2 ? quad_bf16_smem_bytes(h, w, c)
                                  : staged_smem_bytes(h, w, c, elem);
  return bytes <= optin ? kPerQuad : kPerPixel;
}

// The kind (h, w, c) takes with these arrays: forward_shape_kind, then
// kPerWarp (one thread per value) in place of kStaged for an unaligned
// image or output, kPerPixel in place of kPerQuad for an unaligned image,
// coordinates or output, and either for p * c past 32 bits.
template <class T>
int forward_kind(const T* img, const T* crd, const T* out, int h, int w,
                 int c, int p) {
  const int kind = forward_shape_kind(h, w, c, (int)sizeof(T));
  const bool fits = aligned16(img) && aligned16(out) &&
                    (int64_t)p * c < ((int64_t)1 << 31);
  if (kind == kStaged && !fits) return kPerWarp;
  if (kind == kPerQuad && !(fits && aligned16(crd))) {
    return kPerPixel;
  }
  return kind;
}

template <class L, class T>
int launch_sample(const T* img, const T* crd, T* out, int n, int h, int w,
                  int c, int p, void* stream) {
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kind = forward_kind(img, crd, out, h, w, c, p);
  if (kind < 0) return -kind;
  if (kind == kPerQuad) {
    if ((int64_t)n * p == 0) return 0;
    if constexpr (sizeof(T) == 2) {
      const int smem = (int)quad_bf16_smem_bytes(h, w, c);
      const cudaError_t err = cudaFuncSetAttribute(
          sample_per_quad_bf16<L>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      sample_per_quad_bf16<L><<<(unsigned)n, kQuadThreads, smem, s>>>(
          img, crd, out, h, w, c, p, (int)quad_bf16_region(h, w, c));
    } else {
      const int smem = (int)staged_smem_bytes(h, w, c, (int)sizeof(T));
      const cudaError_t err = cudaFuncSetAttribute(
          sample_per_quad_staged<L, T>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      sample_per_quad_staged<L, T><<<(unsigned)n, kQuadThreads, smem, s>>>(
          img, crd, out, h, w, c, p);
    }
  } else if (kind == kStaged) {
    if ((int64_t)n * p == 0) return 0;
    const int smem = (int)staged_smem_bytes(h, w, c, (int)sizeof(T));
    cudaError_t err = cudaFuncSetAttribute(
        sample_per_pixel_staged<L, T>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    int per_sample = 1;
    if (err == cudaSuccess) {
      err = staged_per_sample<L, T>(n, p, smem, per_sample);
    }
    if (err != cudaSuccess) return (int)err;
    const int span = (p + per_sample - 1) / per_sample;
    sample_per_pixel_staged<L, T><<<(unsigned)((int64_t)n * per_sample),
                                    kStagedThreads, smem, s>>>(
        img, crd, out, h, w, c, p, per_sample, span);
  } else if (kind == kPerWarp) {
    const int64_t total = (int64_t)n * p * c;
    if (total == 0) return 0;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    sample_per_value<L, T><<<blocks, threads, 0, s>>>(img, crd, out, n, h, w,
                                                      c, p);
  } else {
    const int64_t total = (int64_t)n * p;
    if (total == 0) return 0;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    sample_per_pixel<L, T><<<blocks, threads, 0, s>>>(img, crd, out, n, h, w,
                                                      c, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The launchers launch on `stream` and return cudaGetLastError() as an int
// (0 = the launch was accepted). They do not synchronise and allocate
// nothing. The _f32 forms take float image, coordinates and output, the
// _bf16 forms __nv_bfloat16 ones.

// Which forward kernel (h, w, c) takes for elements of `elem` bytes (4:
// f32, 2: bf16) with 16-byte aligned arrays: 0 per pixel, 1 per value, 2
// staged, 3 per quad; a negative cudaError_t on failure.
extern "C" int catgen_bilinear_forward_kind(int h, int w, int c, int elem) {
  return forward_shape_kind(h, w, c, elem);
}

// crd: (n, 2, p) coordinate rows.
extern "C" int catgen_bilinear_sample_rows_f32(const float* img,
                                               const float* crd, float* out,
                                               int n, int h, int w, int c,
                                               int p, void* stream) {
  return launch_sample<RowsLayout>(img, crd, out, n, h, w, c, p, stream);
}

extern "C" int catgen_bilinear_sample_rows_bf16(const __nv_bfloat16* img,
                                                const __nv_bfloat16* crd,
                                                __nv_bfloat16* out, int n,
                                                int h, int w, int c, int p,
                                                void* stream) {
  return launch_sample<RowsLayout>(img, crd, out, n, h, w, c, p, stream);
}

// crd: (n, p, 2) coordinate grid, aligned to a (y, x) pair.
extern "C" int catgen_bilinear_sample_grid_f32(const float* img,
                                               const float* crd, float* out,
                                               int n, int h, int w, int c,
                                               int p, void* stream) {
  return launch_sample<GridLayout>(img, crd, out, n, h, w, c, p, stream);
}

extern "C" int catgen_bilinear_sample_grid_bf16(const __nv_bfloat16* img,
                                                const __nv_bfloat16* crd,
                                                __nv_bfloat16* out, int n,
                                                int h, int w, int c, int p,
                                                void* stream) {
  return launch_sample<GridLayout>(img, crd, out, n, h, w, c, p, stream);
}
