// D's input prefix in one pass: the affine spatial transformer's bilinear
// sample of the image, a 3x3 'same' convolution of the sampled image, its
// bias and a PReLU, for NHWC f32 or bf16 images.
//
// Replaces the TPU kernel catgen/kernels/pallas_st_conv.py, _forward ->
// _st_conv_kernel: the affine grid built from theta inside the kernel, v4
// sampling over the pixel tile and a halo of one image row above and below,
// the 3x3 conv as nine shifted taps of the sampled tile with x-edge masks,
// bias and PReLU. It returns the output, and, where autograd will need
// them, the sampled image (samp) and the pre-activation (z) that the
// backward reads (catgen_torch/kernels/st_conv.py; the backward itself is
// the sampler's backward kernels and plain torch ops, as catgen's is XLA
// around the v4 sampler VJP). Without a gradient to take (the sampling
// path) samp and z are not written: that halves the bytes.
//
// What bounds it: memory traffic. At D32_st3's shape (32x32x3 -> 64
// channels) a sample reads 12 KB of image and writes 256 KB of output (and
// 256 KB of z, 12 KB of samp with a gradient); the 27-deep conv does 54
// flops per output value, a few per byte. The design keeps everything but
// those bytes on chip:
//   * one block per (sample, band of up to 8 output rows); its threads
//     sample band + 2 rows (the halo) into shared memory, zero outside the
//     image and in one column either side, so the conv's zero padding
//     applies to the sampled image (a tap off the 32x32 grid reads 0, not
//     a border-clamped sample) and the inner loop has no edge tests;
//   * for the conv, threadIdx.x is the output channel (contiguous stores)
//     and threadIdx.y walks segments of 4 pixels of a row: a thread keeps
//     its channel's 9*C weights in registers (C <= 4; a template
//     parameter) and reads each sampled value of its 3x6 window once for
//     the 4 outputs (broadcast reads: a warp's threads share the window);
//   * K = 9*C = 27 is too shallow for tensor cores: f32 fmaf on CUDA
//     cores, well under the card's f32 rate at this byte count.
// The halo rows are sampled by both neighbouring blocks (a quarter more
// sampling work at band 8); no block writes what another writes, so there
// are no atomics and repeats are bit-identical.
//
// The f32 instantiation computes in f32 throughout; it does not copy the
// TPU's bf16 roundings (the sampled tile and the weights) or its bf16 z.
// The bf16 one (catgen's bf16 compute dtype) does, as the TPU kernel: the
// image is read exactly into f32, each sample is the f32 lerp rounded
// once to bf16 (into the tile and samp), the weights come rounded to bf16
// (the wrapper rounds them), bias and alpha stay f32, z is the f32 sum of
// the exact bf16 x bf16 products plus the bias, stored rounded to bf16,
// and the output is the PReLU of the f32 z, rounded once. The coordinates
// are f32 in both, from theta, as the TPU kernel's: from the same (3, P)
// base rows as the plain version (st_conv.py::prefix_rows), t0*gy + t1*gx
// + t2, each product rounded (--fmad=false) and added left to right, so
// the samples are the plain version's bits. The lerps round as the plain
// version's do (lerp_taps); the conv's 27-term sums run in another order
// than cuDNN's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

constexpr int kSeg = 4;          // output pixels of a row per thread
constexpr int kMaxBand = 8;      // output rows per block
constexpr int kThreads = 256;
constexpr int64_t kSmemLimit = 48 * 1024;

// CT: the channel count C when it is 1..4 (weights in registers), else 0
// (any C, weights read through the read-only cache). T: the element type
// of img, kmat, out, samp and z (float or __nv_bfloat16).
// img (n, h, w, c); theta (n, 2, 3), rows (y, x); base (3, h*w) rows
// [gy; gx; 1]; kmat (9*c, f), row (ky*3 + kx)*c + ci; bias (f); alpha
// (alpha_n), alpha_n 1 or f; out, z (n, h*w, f); samp (n, h*w, c); samp
// and z may be null.
template <int CT, class T>
__global__ void __launch_bounds__(kThreads)
st_conv_prelu_kernel(const T* __restrict__ img,
                     const float* __restrict__ theta,
                     const float* __restrict__ base,
                     const T* __restrict__ kmat,
                     const float* __restrict__ bias,
                     const float* __restrict__ alpha, int alpha_n,
                     T* __restrict__ out, T* __restrict__ samp,
                     T* __restrict__ z, int h, int w, int c_rt, int f,
                     int band, int nbands) {
  extern __shared__ float tile[];
  const int c = CT > 0 ? CT : c_rt;
  const int ni = blockIdx.x / nbands;
  const int y0 = (blockIdx.x % nbands) * band;  // first output row
  const int p = h * w;
  const int nseg = (w + kSeg - 1) / kSeg;
  const int cols = nseg * kSeg + 2;             // tile columns, x = col - 1
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;

  // 1. sample rows y0-1 .. y0+band into the tile (zero off the image)
  const float* th = theta + (int64_t)ni * 6;
  const float t00 = __ldg(th + 0), t01 = __ldg(th + 1), t02 = __ldg(th + 2);
  const float t10 = __ldg(th + 3), t11 = __ldg(th + 4), t12 = __ldg(th + 5);
  const T* im = img + (int64_t)ni * p * c;
  for (int i = tid; i < (band + 2) * cols; i += nthreads) {
    const int y = y0 - 1 + i / cols;
    const int x = i % cols - 1;
    float* dst = tile + (int64_t)i * c;
    if (y < 0 || y >= h || x < 0 || x >= w) {
      for (int ch = 0; ch < c; ++ch) dst[ch] = 0.0f;
      continue;
    }
    const int pi = y * w + x;
    const float gy = __ldg(base + pi), gx = __ldg(base + p + pi);
    const Taps t = make_taps(t00 * gy + t01 * gx + t02,
                             t10 * gy + t11 * gx + t12, h, w);
    const bool own = samp != nullptr && y >= y0 && y < y0 + band;
    T* s = own ? samp + ((int64_t)ni * p + pi) * c : nullptr;
    for (int ch = 0; ch < c; ++ch) {
      float v = lerp_taps(im + ch, t, c);
      // the bf16 tile holds the sample rounded once (read back exactly)
      if constexpr (sizeof(T) == 2) {
        v = __bfloat162float(__float2bfloat16_rn(v));
      }
      dst[ch] = v;
      if (own) stf(s + ch, v);     // exact: v is already of type T
    }
  }
  __syncthreads();

  // 2. the conv, bias and PReLU: channel fi of kSeg pixels per step
  for (int fi = threadIdx.x; fi < f; fi += blockDim.x) {
    float wr[CT > 0 ? 9 * CT : 1];
    if constexpr (CT > 0) {
#pragma unroll
      for (int k = 0; k < 9 * CT; ++k) wr[k] = ldf(kmat + (int64_t)k * f + fi);
    }
    const float b = __ldg(bias + fi);
    const float a = __ldg(alpha + (alpha_n == 1 ? 0 : fi));
    for (int seg = threadIdx.y; seg < band * nseg; seg += blockDim.y) {
      const int r = seg / nseg;                 // output row y0 + r
      const int x0 = (seg % nseg) * kSeg;
      if (y0 + r >= h) break;                   // rows only grow with seg
      float acc[kSeg];
#pragma unroll
      for (int j = 0; j < kSeg; ++j) acc[j] = 0.0f;
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // tile row r + ky holds image row y0 + r + ky - 1; tile column
        // x0 + col holds image column x0 + col - 1
        const float* row = tile + ((int64_t)(r + ky) * cols + x0) * c;
#pragma unroll
        for (int col = 0; col < kSeg + 2; ++col) {
#pragma unroll
          for (int ci = 0; ci < c; ++ci) {
            const float v = row[col * c + ci];
#pragma unroll
            for (int j = 0; j < kSeg; ++j) {
              const int kx = col - j;
              if (kx < 0 || kx > 2) continue;
              const int k = (ky * 3 + kx) * c + ci;
              float wk;
              if constexpr (CT > 0) {
                wk = wr[k];
              } else {
                wk = ldf(kmat + (int64_t)k * f + fi);
              }
              acc[j] = fmaf(v, wk, acc[j]);
            }
          }
        }
      }
      const int64_t o = ((int64_t)ni * p + (int64_t)(y0 + r) * w + x0) * f + fi;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        if (x0 + j >= w) break;
        const float zv = acc[j] + b;
        stf(out + o + (int64_t)j * f, zv >= 0.0f ? zv : a * zv);
        if (z != nullptr) stf(z + o + (int64_t)j * f, zv);
      }
    }
  }
}

template <int CT, class T>
int launch(const T* img, const float* theta, const float* base,
           const T* kmat, const float* bias, const float* alpha,
           int alpha_n, T* out, T* samp, T* z, int n, int h,
           int w, int c, int f, void* stream) {
  const int cols = (w + kSeg - 1) / kSeg * kSeg + 2;
  int band = h < kMaxBand ? h : kMaxBand;
  while (band > 1 && (int64_t)(band + 2) * cols * c * 4 > kSmemLimit) --band;
  const int64_t smem = (int64_t)(band + 2) * cols * c * 4;
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  const int nbands = (h + band - 1) / band;
  const int64_t blocks = (int64_t)n * nbands;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int bx = f < 64 ? f : 64;
  const dim3 threads((unsigned)bx, (unsigned)(kThreads / bx));
  st_conv_prelu_kernel<CT, T><<<(unsigned)blocks, threads, (size_t)smem,
                                static_cast<cudaStream_t>(stream)>>>(
      img, theta, base, kmat, bias, alpha, alpha_n, out, samp, z, h, w, c, f,
      band, nbands);
  return (int)cudaGetLastError();
}

template <class T>
int launch_c(const T* img, const float* theta, const float* base,
             const T* kmat, const float* bias, const float* alpha,
             int alpha_n, T* out, T* samp, T* z, int n, int h, int w, int c,
             int f, void* stream) {
  if ((int64_t)n * h * w * f == 0) return 0;
  switch (c) {
    case 1:
      return launch<1>(img, theta, base, kmat, bias, alpha, alpha_n, out,
                       samp, z, n, h, w, c, f, stream);
    case 2:
      return launch<2>(img, theta, base, kmat, bias, alpha, alpha_n, out,
                       samp, z, n, h, w, c, f, stream);
    case 3:
      return launch<3>(img, theta, base, kmat, bias, alpha, alpha_n, out,
                       samp, z, n, h, w, c, f, stream);
    case 4:
      return launch<4>(img, theta, base, kmat, bias, alpha, alpha_n, out,
                       samp, z, n, h, w, c, f, stream);
    default:
      return launch<0>(img, theta, base, kmat, bias, alpha, alpha_n, out,
                       samp, z, n, h, w, c, f, stream);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() as an int (0 = the
// launch was accepted; cudaErrorInvalidValue if a band's tile would not
// fit in 48 KB of shared memory). Does not synchronise and allocates
// nothing; all arrays are contiguous; samp and z may be null. The f32
// entry takes f32 arrays; the bf16 one a bf16 img, kmat, out, samp and z,
// with theta, base, bias and alpha f32.
extern "C" int catgen_st_conv_prelu_f32(const float* img, const float* theta,
                                        const float* base, const float* kmat,
                                        const float* bias, const float* alpha,
                                        int alpha_n, float* out, float* samp,
                                        float* z, int n, int h, int w, int c,
                                        int f, void* stream) {
  return launch_c(img, theta, base, kmat, bias, alpha, alpha_n, out, samp, z,
                  n, h, w, c, f, stream);
}

extern "C" int catgen_st_conv_prelu_bf16(
    const __nv_bfloat16* img, const float* theta, const float* base,
    const __nv_bfloat16* kmat, const float* bias, const float* alpha,
    int alpha_n, __nv_bfloat16* out, __nv_bfloat16* samp, __nv_bfloat16* z,
    int n, int h, int w, int c, int f, void* stream) {
  return launch_c(img, theta, base, kmat, bias, alpha, alpha_n, out, samp, z,
                  n, h, w, c, f, stream);
}
