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
// lerps per value, far below the arithmetic the card can do per byte.
// This first version is the simple one:
//   * C >= 32: one thread per output value (n, p, c), c fastest, so the
//     threads of a warp read neighbouring channels of one tap (coalesced)
//     and share that pixel's coordinates (one broadcast load);
//   * C < 32 (the 32x32x3 input): one thread per output pixel, looping
//     over its C channels.
// Taps that neighbouring output pixels share are re-read through L1/L2;
// reusing them from shared memory, and vectorised loads, are later work.
//
// Arithmetic is f32 and follows catgen/nn/spatial_transformer.py,
// bilinear_sample (and _weights_rows of the TPU kernel): clip the pixel
// coordinate to [0, size-1], first tap floor() clipped to [0, size-2], so
// the weight reaches 1.0 at the far edge. It does not reproduce the TPU
// kernel's bf16 operand rounding. The library is built with --fmad=false
// so that the lerps round as the plain PyTorch version's separate
// multiplies and adds do. No atomics: each output value is written by
// exactly one thread, so the result is deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

// img (n, h, w, c), coordinates in layout L, out (n, p, c); all contiguous
// f32.
template <class L>
__global__ void sample_per_value(const float* __restrict__ img,
                                 const float* __restrict__ crd,
                                 float* __restrict__ out, int n, int h, int w,
                                 int c, int p) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (int64_t)n * p * c) return;
  const int ch = (int)(i % c);
  const int64_t pix = i / c;
  const int pi = (int)(pix % p);
  const int ni = (int)(pix / p);
  const float2 yx = L::load(crd, ni, pi, p);
  const Taps t = make_taps(yx.x, yx.y, h, w);
  out[i] = lerp_taps(img + (int64_t)ni * h * w * c + ch, t, c);
}

template <class L>
__global__ void sample_per_pixel(const float* __restrict__ img,
                                 const float* __restrict__ crd,
                                 float* __restrict__ out, int n, int h, int w,
                                 int c, int p) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)n * p) return;
  const int pi = (int)(pix % p);
  const int ni = (int)(pix / p);
  const float2 yx = L::load(crd, ni, pi, p);
  const Taps t = make_taps(yx.x, yx.y, h, w);
  const float* base = img + (int64_t)ni * h * w * c;
  float* o = out + pix * c;
  for (int ch = 0; ch < c; ++ch) o[ch] = lerp_taps(base + ch, t, c);
}

template <class L>
int launch_sample(const float* img, const float* crd, float* out, int n,
                  int h, int w, int c, int p, void* stream) {
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c >= 32) {
    const int64_t total = (int64_t)n * p * c;
    if (total == 0) return 0;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    sample_per_value<L><<<blocks, threads, 0, s>>>(img, crd, out, n, h, w, c,
                                                   p);
  } else {
    const int64_t total = (int64_t)n * p;
    if (total == 0) return 0;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    sample_per_pixel<L><<<blocks, threads, 0, s>>>(img, crd, out, n, h, w, c,
                                                   p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() as an int (0 = the
// launch was accepted). They do not synchronise and allocate nothing.

// crd: (n, 2, p) coordinate rows.
extern "C" int catgen_bilinear_sample_rows_f32(const float* img,
                                               const float* crd, float* out,
                                               int n, int h, int w, int c,
                                               int p, void* stream) {
  return launch_sample<RowsLayout>(img, crd, out, n, h, w, c, p, stream);
}

// crd: (n, p, 2) coordinate grid, 8-byte aligned.
extern "C" int catgen_bilinear_sample_grid_f32(const float* img,
                                               const float* crd, float* out,
                                               int n, int h, int w, int c,
                                               int p, void* stream) {
  return launch_sample<GridLayout>(img, crd, out, n, h, w, c, p, stream);
}
