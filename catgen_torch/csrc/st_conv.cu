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
//     f32 fmaf on the CUDA cores.
// The halo rows are sampled by both neighbouring blocks (a quarter more
// sampling work at band 8); no block writes what another writes, so there
// are no atomics and repeats are bit-identical. This kernel
// (st_conv_prelu_kernel) serves the f32 shapes that st_conv_f32_tiled
// (below) does not take, and the bf16 shapes that st_conv_bf16_mma does
// not take.
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

// The f32 prefix, tiled (st_conv_f32_tiled), for C = 1..4, F a multiple
// of 4, h w C a multiple of 4 and 16-byte aligned image and outputs
// (st_conv.py::f32_kind; D32_st3's prefix at both batches). The kernel
// above at D32_st3's sampling shape (256 samples, out alone: 70 MB, 0.021
// ms at 3.35 TB/s) runs at 41% of that bound, for two faults this design
// removes:
//   * its conv issues a shared-memory load for every 2 FMAs (one output
//     channel a thread, a 3 x 6 x C window per 4 pixels): 7.1 M warp
//     loads, ~0.03 ms of the SM's shared pipe, above the byte bound. Here
//     a thread makes 4 output channels of 4 pixels: the 27 float4 weights
//     of its channels (at C = 3) stay in registers, and each sampled value
//     read from the tile feeds 4 x (up to 3) FMAs, 4 times fewer loads for
//     the same 27 f32 FMAs per output (~0.015 ms on the CUDA cores). A
//     warp's 32 threads are 16 channel groups of 2 neighbouring 4-pixel
//     segments (at F = 64), so a load reads 2 addresses in 2 banks;
//   * its bands sample a halo row above and below (a third more sampling
//     at band 8). Here one block per sample stages the image in shared
//     memory with 16-byte cp.async and samples each pixel once into a
//     zero-bordered (h + 2) x (4 ceil(w / 4) + 2) tile, as the bf16
//     kernel below does.
// Each output keeps the kernel above's sum: 27 fmaf in k = (ky 3 + kx) C +
// ci order from 0, then the bias and the PReLU, so z and out are its bits;
// the samples are its bits too (make_taps and lerp_values on the same f32
// coordinates, from an exact copy of the image). Out and z leave as 16-byte
// vectors of 4 channels of a pixel (a warp stores whole 256-byte runs),
// samp from a compact copy in shared memory as 16-byte vectors. 6 warps a
// block: the weights take 108 of a thread's 168 registers at C = 3, so 2
// blocks (12 warps) fit an SM (1 at C = 4); at N=256 that ran faster than
// 4 warps a block, 3 an SM (8 warps on most SMs: 2 samples each). No
// atomics; repeats are bit-identical.

namespace sttile {

constexpr int kWarps = 6;
constexpr int kTileThreads = kWarps * 32;
constexpr int kChannels = 4;     // output channels per thread (a float4)

__host__ __device__ inline int tile_w(int w) {
  return (w + kSeg - 1) / kSeg * kSeg + 2;
}
__host__ __device__ inline int64_t image_bytes(int h, int w, int c) {
  return ((int64_t)h * w * c * 4 + 15) / 16 * 16;
}
// the sample's image, samp's compact copy, the bordered tile
__host__ __device__ inline int64_t smem_bytes(int h, int w, int c) {
  return 2 * image_bytes(h, w, c) + (int64_t)(h + 2) * tile_w(w) * c * 4;
}

}  // namespace sttile

// img (n, h, w, C), out, z (n, h w, f), samp (n, h w, C), all f32 and
// 16-byte aligned; theta, base, kmat, bias, alpha as st_conv_prelu_kernel's.
// One block per sample; dynamic shared memory sttile::smem_bytes(h, w, C).
template <int C>
__global__ void __launch_bounds__(sttile::kTileThreads, C < 4 ? 2 : 1)
st_conv_f32_tiled(const float* __restrict__ img,
                  const float* __restrict__ theta,
                  const float* __restrict__ base,
                  const float* __restrict__ kmat,
                  const float* __restrict__ bias,
                  const float* __restrict__ alpha, int alpha_n,
                  float* __restrict__ out, float* __restrict__ samp,
                  float* __restrict__ z, int h, int w, int f) {
  using namespace sttile;
  extern __shared__ __align__(16) float sm[];
  const int ni = blockIdx.x, tid = threadIdx.x;
  const int p = h * w, tw = tile_w(w), chunks = p * C / 4;
  const int ib = (int)(image_bytes(h, w, C) / 4);
  float* simg = sm;                 // the sample's image
  float* scomp = sm + ib;           // samp, compact
  float* tile = sm + 2 * ib;        // (h + 2) x tw, image pixel (y, x) at
                                    // (y + 1, x + 1)

  // 1. the sample's image, 16-byte copies; the tile's border, zeros (the
  // conv's padding, and the columns past w of a ragged last segment)
  stage_async(reinterpret_cast<uint4*>(simg),
              reinterpret_cast<const uint4*>(img) + (int64_t)ni * chunks,
              chunks);
  asm volatile("cp.async.commit_group;\n" ::);
  const float* th = theta + (int64_t)ni * 6;
  const float t00 = __ldg(th + 0), t01 = __ldg(th + 1), t02 = __ldg(th + 2);
  const float t10 = __ldg(th + 3), t11 = __ldg(th + 4), t12 = __ldg(th + 5);
  const int side = tw - w;          // column 0 and the columns past w
  for (int i = tid; i < 2 * tw + h * side; i += kTileThreads) {
    int yb, xb;
    if (i < 2 * tw) {
      yb = i < tw ? 0 : h + 1;
      xb = i < tw ? i : i - tw;
    } else {
      const int r = i - 2 * tw, k = r % side;
      yb = 1 + r / side;
      xb = k == 0 ? 0 : w + k;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) tile[(yb * tw + xb) * C + ch] = 0.0f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 2. each pixel sampled once (st_conv_prelu_kernel's arithmetic)
  for (int pi = tid; pi < p; pi += kTileThreads) {
    const int y = pi / w, x = pi - (pi / w) * w;
    const float gy = __ldg(base + pi), gx = __ldg(base + p + pi);
    const Taps t = make_taps(t00 * gy + t01 * gx + t02,
                             t10 * gy + t11 * gx + t12, h, w);
    const int o00 = (int)t.p00 * C, o01 = (int)t.p01 * C;
    const int o10 = (int)t.p10 * C, o11 = (int)t.p11 * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float v = lerp_values(simg[o00 + ch], simg[o01 + ch],
                                  simg[o10 + ch], simg[o11 + ch], t);
      tile[((y + 1) * tw + x + 1) * C + ch] = v;
      scomp[pi * C + ch] = v;
    }
  }
  __syncthreads();
  if (samp != nullptr) {
    float4* dst = reinterpret_cast<float4*>(samp) + (int64_t)ni * chunks;
    const float4* cs = reinterpret_cast<const float4*>(scomp);
    for (int k = tid; k < chunks; k += kTileThreads) __stcs(dst + k, cs[k]);
  }

  // 3. the conv, bias and PReLU: a thread takes channel group cl (4
  // channels) of segments sl, sl + sn, ... (4 pixels of a row each)
  const int f4 = f / kChannels;
  const int cn = f4 < 32 ? f4 : 32, sn = kTileThreads / cn;
  const int cl = tid % cn, sl = tid / cn;
  if (sl >= sn) return;
  const int nseg = (w + kSeg - 1) / kSeg, segs = h * nseg;
  for (int cgi = cl; cgi < f4; cgi += cn) {
    const int f0 = kChannels * cgi;
    float4 wr[9 * C];
#pragma unroll
    for (int k = 0; k < 9 * C; ++k) {
      const float* wk = kmat + (int64_t)k * f + f0;
      wr[k] = make_float4(__ldg(wk), __ldg(wk + 1), __ldg(wk + 2),
                          __ldg(wk + 3));
    }
    const float4 b = make_float4(__ldg(bias + f0), __ldg(bias + f0 + 1),
                                 __ldg(bias + f0 + 2), __ldg(bias + f0 + 3));
    const float* al = alpha + (alpha_n == 1 ? 0 : f0);
    const int as = alpha_n == 1 ? 0 : 1;
    const float4 a = make_float4(__ldg(al), __ldg(al + as),
                                 __ldg(al + 2 * as), __ldg(al + 3 * as));
    for (int seg = sl; seg < segs; seg += sn) {
      const int r = seg / nseg;                // output row r
      const int x0 = (seg - r * nseg) * kSeg;
      float4 acc[kSeg];
#pragma unroll
      for (int j = 0; j < kSeg; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        // tile row r + ky holds image row r + ky - 1; tile column x0 + col
        // image column x0 + col - 1
        const float* row = tile + ((r + ky) * tw + x0) * C;
#pragma unroll
        for (int col = 0; col < kSeg + 2; ++col) {
#pragma unroll
          for (int ci = 0; ci < C; ++ci) {
            const float v = row[col * C + ci];
#pragma unroll
            for (int j = 0; j < kSeg; ++j) {
              const int kx = col - j;
              if (kx < 0 || kx > 2) continue;
              const float4 wk = wr[(ky * 3 + kx) * C + ci];
              acc[j].x = fmaf(v, wk.x, acc[j].x);
              acc[j].y = fmaf(v, wk.y, acc[j].y);
              acc[j].z = fmaf(v, wk.z, acc[j].z);
              acc[j].w = fmaf(v, wk.w, acc[j].w);
            }
          }
        }
      }
      const int64_t o = ((int64_t)ni * p + (int64_t)r * w + x0) * f + f0;
#pragma unroll
      for (int j = 0; j < kSeg; ++j) {
        if (x0 + j >= w) break;
        const float4 zv = make_float4(acc[j].x + b.x, acc[j].y + b.y,
                                      acc[j].z + b.z, acc[j].w + b.w);
        const float4 ov = make_float4(zv.x >= 0.0f ? zv.x : a.x * zv.x,
                                      zv.y >= 0.0f ? zv.y : a.y * zv.y,
                                      zv.z >= 0.0f ? zv.z : a.z * zv.z,
                                      zv.w >= 0.0f ? zv.w : a.w * zv.w);
        __stcs(reinterpret_cast<float4*>(out + o + (int64_t)j * f), ov);
        if (z != nullptr) {
          __stcs(reinterpret_cast<float4*>(z + o + (int64_t)j * f), zv);
        }
      }
    }
  }
}

// The bf16 prefix on the tensor cores (st_conv_bf16_mma), for C = 1..4,
// F a multiple of 8, h w C a multiple of 8 and 16-byte aligned arrays
// (st_conv.py::bf16_kind). It has the same inputs and roundings as the
// bf16 instantiation above, and the TPU kernel's arithmetic: the conv is a
// (pixels x 9C) by (9C x F) product of bf16 values with f32 sums, which
// pallas_st_conv.py runs as nine bf16 dot_generals on the MXU. The design,
// against the byte bound (a sample reads 6 KB of image and writes 128 KB
// of out, and of z, at D32_st3's 32x32x3 -> 64):
//   * one block per sample (4 warps; 16 for a batch under 4 samples an
//     SM: mma_warps). Its image is staged in shared memory
//     with 16-byte cp.async and each pixel is sampled once, into a
//     zero-bordered (h+2) x (w+2) tile: no halo row is sampled twice, and
//     the conv's zero padding is the border. The samples keep the bits of
//     the kernel above (make_taps and lerp_values in f32 from the same
//     coordinates, rounded once to bf16); samp leaves from a compact copy
//     as 16-byte stores;
//   * the conv on mma.sync.m16n8k16 (bf16 products, exact; f32 sums), K =
//     9C padded with zeros to a multiple of 16 (27 -> 32). A warp takes 16
//     pixels at a time: each thread's A fragments come from the tile at
//     offsets fixed per thread (its contraction indices decoded once to
//     tap and channel); B, the K x F weight matrix in catgen's (ky, kx, ci)
//     row order, is packed in fragment order in shared memory by the block
//     itself, from the f32 weights, each rounded once to bf16 (the layout
//     and bits of st_conv.py::pack_weights; packing on the host took two
//     device ops a call, more host time than the kernel's at N=256). The
//     27-term sums run in the tensor core's order, not the kernel above's,
//     so z and out agree with the plain version to a rounding, not bit for
//     bit;
//   * z = sum + bias and out = PReLU(z) in f32, each rounded once to bf16,
//     gathered per warp in shared memory (rows padded to spread the banks)
//     and stored as whole 16-byte vectors: 8 output channels of a pixel.
// No atomics; every value is written by one thread: repeats are
// bit-identical.

namespace stmma {

constexpr int kGroup = 8;        // n-tiles (8 output channels) per store
constexpr int kRowBytes = kGroup * 16 + 16;   // a staged pixel, padded
constexpr int kStage = 16 * kRowBytes;        // a warp's 16 pixels
// warps a block: 4, or 16 where the batch leaves the SMs under 4 samples
// each (the sampling path's 256 on 132 SMs): a warp's work is a chain of
// dependent steps, so a small batch needs more of them
constexpr int kFewWarps = 4, kManyWarps = 16;

__host__ __device__ constexpr int k_tiles(int c) { return (9 * c + 15) / 16; }

__host__ __device__ inline int64_t round16(int64_t b) {
  return (b + 15) / 16 * 16;
}

// shared memory of a block of `warps` warps: the image and samp's compact
// copy, which the warps' staging of out and z takes over once the tile is
// sampled; the bordered tile; the packed weights
__host__ __device__ inline int64_t union_bytes(int h, int w, int c,
                                               int warps) {
  const int64_t sampling = 2 * (int64_t)h * w * c * 2;
  const int64_t staging = (int64_t)warps * 2 * kStage;
  return sampling > staging ? sampling : staging;
}
__host__ __device__ inline int64_t tile_bytes(int h, int w, int c) {
  return round16((int64_t)(h + 2) * (w + 2) * c * 2);
}
__host__ __device__ inline int64_t weight_bytes(int c, int f) {
  return (int64_t)f * k_tiles(c) * 32;   // f/8 n-tiles x 32 lanes x 8 KT B
}
__host__ __device__ inline int64_t smem_bytes(int h, int w, int c, int f,
                                              int warps) {
  return union_bytes(h, w, c, warps) + tile_bytes(h, w, c) +
         weight_bytes(c, f);
}

}  // namespace stmma

// d += A * B, one m16n8k16 bf16 product with f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

__device__ __forceinline__ uint32_t bf16_bits_rn(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// img (n, h, w, C), out, z (n, h w, f), samp (n, h w, C), all bf16 and
// 16-byte aligned; kmat the f32 weights (9 C, f), row (ky 3 + kx) C + ci;
// theta, base, bias, alpha as st_conv_prelu_kernel's. One block of W
// warps per sample.
template <int C, int W>
__global__ void __launch_bounds__(W * 32)
st_conv_bf16_mma(const __nv_bfloat16* __restrict__ img,
                 const float* __restrict__ theta,
                 const float* __restrict__ base,
                 const float* __restrict__ kmat,
                 const float* __restrict__ bias,
                 const float* __restrict__ alpha, int alpha_n,
                 __nv_bfloat16* __restrict__ out,
                 __nv_bfloat16* __restrict__ samp,
                 __nv_bfloat16* __restrict__ z, int h, int w, int f) {
  using namespace stmma;
  constexpr int KT = k_tiles(C), kThreads = W * 32;
  extern __shared__ __align__(16) uint8_t smem[];
  const int ub = (int)union_bytes(h, w, C, W), tb = (int)tile_bytes(h, w, C);
  unsigned short* simg = reinterpret_cast<unsigned short*>(smem);
  const int ni = blockIdx.x, tid = threadIdx.x;
  const int p = h * w, tw = w + 2, chunks = p * C / 8;
  unsigned short* scomp = simg + p * C;           // samp, compact
  unsigned short* tile = reinterpret_cast<unsigned short*>(smem + ub);
  uint2* wsm = reinterpret_cast<uint2*>(smem + ub + tb);

  // 1. the sample's image, 16-byte copies; the weights in fragment order
  // (st_conv.py::pack_weights): the pair of registers of lane 4 g + t of
  // n-tile nt for k-tile kt holds rows 16 kt + 8 r + 2 t + j (r, j = 0, 1)
  // of column 8 nt + g, each rounded once to bf16, zeros past 9 C
  stage_async(reinterpret_cast<uint4*>(simg),
              reinterpret_cast<const uint4*>(img) + (int64_t)ni * chunks,
              chunks);
  asm volatile("cp.async.commit_group;\n" ::);
  for (int i = tid; i < (f / 8) * 32 * KT; i += kThreads) {
    const int kt = i % KT, lane = (i / KT) % 32, nt = i / (KT * 32);
    const int col = 8 * nt + (lane >> 2), row0 = 16 * kt + 2 * (lane & 3);
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = row0 + 8 * (q >> 1) + (q & 1);
      v[q] = row < 9 * C
                 ? bf16_bits_rn(__ldg(kmat + (int64_t)row * f + col))
                 : 0u;
    }
    wsm[i] = make_uint2(v[0] | v[1] << 16, v[2] | v[3] << 16);
  }
  const float* th = theta + (int64_t)ni * 6;
  const float t00 = __ldg(th + 0), t01 = __ldg(th + 1), t02 = __ldg(th + 2);
  const float t10 = __ldg(th + 3), t11 = __ldg(th + 4), t12 = __ldg(th + 5);
  // the tile's border is the conv's zero padding
  for (int i = tid; i < 2 * tw + 2 * h; i += kThreads) {
    int yb, xb;
    if (i < 2 * tw) {
      yb = i < tw ? 0 : h + 1;
      xb = i < tw ? i : i - tw;
    } else {
      yb = 1 + (i - 2 * tw) / 2;
      xb = ((i - 2 * tw) & 1) ? w + 1 : 0;
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) tile[(yb * tw + xb) * C + ch] = 0;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // 2. each pixel sampled once, rounded once to bf16
  for (int pi = tid; pi < p; pi += kThreads) {
    const int y = pi / w, x = pi - (pi / w) * w;
    const float gy = __ldg(base + pi), gx = __ldg(base + p + pi);
    const Taps t = make_taps(t00 * gy + t01 * gx + t02,
                             t10 * gy + t11 * gx + t12, h, w);
    const int o00 = (int)t.p00 * C, o01 = (int)t.p01 * C;
    const int o10 = (int)t.p10 * C, o11 = (int)t.p11 * C;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) {
      const float v = lerp_values(
          __uint_as_float((uint32_t)simg[o00 + ch] << 16),
          __uint_as_float((uint32_t)simg[o01 + ch] << 16),
          __uint_as_float((uint32_t)simg[o10 + ch] << 16),
          __uint_as_float((uint32_t)simg[o11 + ch] << 16), t);
      const unsigned short bits = (unsigned short)bf16_bits_rn(v);
      tile[((y + 1) * tw + x + 1) * C + ch] = bits;
      scomp[pi * C + ch] = bits;
    }
  }
  __syncthreads();
  if (samp != nullptr) {
    uint4* dst = reinterpret_cast<uint4*>(samp) + (int64_t)ni * chunks;
    const uint4* cs = reinterpret_cast<const uint4*>(scomp);
    for (int k = tid; k < chunks; k += kThreads) {
      __stcs(dst + k, cs[k]);
    }
  }
  __syncthreads();                  // the staging takes the image's room

  // 3. the conv: this thread's contraction indices k = 16 kt + 2 tig +
  // (j & 1) + 8 (j >> 1) as offsets from a pixel's window corner in the
  // tile (-1: the zero padding of K)
  const int lane = tid & 31, warp = tid >> 5, gid = lane >> 2, tig = lane & 3;
  int off[KT][4];
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 16 * kt + 2 * tig + (j & 1) + 8 * (j >> 1);
      const int tap = k / C, ci = k - (k / C) * C;
      off[kt][j] = k < 9 * C ? ((tap / 3) * tw + tap % 3) * C + ci : -1;
    }
  }
  uint8_t* st_out = smem + warp * 2 * kStage;
  uint8_t* st_z = st_out + kStage;
  const int mtiles = (p + 15) / 16, ntiles = f / 8;
  const float* al = alpha_n == 1 ? alpha : nullptr;
  for (int ng = 0; ng < ntiles; ng += kGroup) {
    const int ntg = min(kGroup, ntiles - ng);
    for (int mt = warp; mt < mtiles; mt += W) {
      const int m0 = mt * 16;
      // rows gid and gid + 8 of the 16 pixels: their windows' corners
      const int r0 = min(m0 + gid, p - 1), r1 = min(m0 + gid + 8, p - 1);
      const int c0 = ((r0 / w) * tw + r0 % w) * C;
      const int c1 = ((r1 / w) * tw + r1 % w) * C;
      auto pair = [&](int corner, int oa, int ob) -> uint32_t {
        const uint32_t lo = oa >= 0 ? tile[corner + oa] : 0u;
        const uint32_t hi = ob >= 0 ? tile[corner + ob] : 0u;
        return lo | hi << 16;
      };
      uint32_t a[KT][4];
#pragma unroll
      for (int kt = 0; kt < KT; ++kt) {
        a[kt][0] = pair(c0, off[kt][0], off[kt][1]);
        a[kt][1] = pair(c1, off[kt][0], off[kt][1]);
        a[kt][2] = pair(c0, off[kt][2], off[kt][3]);
        a[kt][3] = pair(c1, off[kt][2], off[kt][3]);
      }
      for (int j = 0; j < ntg; ++j) {
        const int nt = ng + j;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          mma_bf16(acc, a[kt], wsm[(nt * 32 + lane) * KT + kt]);
        }
        const int n = nt * 8 + 2 * tig;
        const float b0 = __ldg(bias + n), b1 = __ldg(bias + n + 1);
        const float a0 = __ldg(al != nullptr ? al : alpha + n);
        const float a1 = __ldg(al != nullptr ? al : alpha + n + 1);
        const float zv[4] = {acc[0] + b0, acc[1] + b1, acc[2] + b0,
                             acc[3] + b1};
        float ov[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float sl = (q & 1) ? a1 : a0;
          ov[q] = zv[q] >= 0.0f ? zv[q] : sl * zv[q];
        }
        const int at = gid * kRowBytes + j * 16 + tig * 4;
        *reinterpret_cast<uint32_t*>(st_out + at) =
            bf16_bits_rn(ov[0]) | bf16_bits_rn(ov[1]) << 16;
        *reinterpret_cast<uint32_t*>(st_out + at + 8 * kRowBytes) =
            bf16_bits_rn(ov[2]) | bf16_bits_rn(ov[3]) << 16;
        if (z != nullptr) {
          *reinterpret_cast<uint32_t*>(st_z + at) =
              bf16_bits_rn(zv[0]) | bf16_bits_rn(zv[1]) << 16;
          *reinterpret_cast<uint32_t*>(st_z + at + 8 * kRowBytes) =
              bf16_bits_rn(zv[2]) | bf16_bits_rn(zv[3]) << 16;
        }
      }
      __syncwarp();
      // the 16 pixels' channels 8 ng .. as 16-byte vectors
      for (int i = lane; i < 16 * ntg; i += 32) {
        const int r = i / ntg, ch = i - (i / ntg) * ntg;
        if (m0 + r >= p) continue;
        const int64_t o = ((int64_t)ni * p + m0 + r) * f + (ng + ch) * 8;
        const int at = r * kRowBytes + ch * 16;
        __stcs(reinterpret_cast<uint4*>(out + o),
               *reinterpret_cast<const uint4*>(st_out + at));
        if (z != nullptr) {
          __stcs(reinterpret_cast<uint4*>(z + o),
                 *reinterpret_cast<const uint4*>(st_z + at));
        }
      }
      __syncwarp();
    }
  }
}

// The warps a block takes for a batch of n on this card: kManyWarps where
// n is under 4 samples an SM, else kFewWarps (0 if the card could not be
// read)
static inline int mma_warps(int n) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess) {
    return 0;
  }
  return n < 4 * sms ? stmma::kManyWarps : stmma::kFewWarps;
}

template <int C, int W>
int launch_mma(const __nv_bfloat16* img, const float* theta,
               const float* base, const float* kmat,
               const float* bias, const float* alpha, int alpha_n,
               __nv_bfloat16* out, __nv_bfloat16* samp, __nv_bfloat16* z,
               int n, int h, int w, int f, void* stream) {
  const int64_t smem = stmma::smem_bytes(h, w, C, f, W);
  const cudaError_t err = cudaFuncSetAttribute(
      st_conv_bf16_mma<C, W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  st_conv_bf16_mma<C, W><<<(unsigned)n, W * 32, (size_t)smem,
                           static_cast<cudaStream_t>(stream)>>>(
      img, theta, base, kmat, bias, alpha, alpha_n, out, samp, z, h, w, f);
  return (int)cudaGetLastError();
}

template <int C>
int launch_mma(const __nv_bfloat16* img, const float* theta,
               const float* base, const float* kmat,
               const float* bias, const float* alpha, int alpha_n,
               __nv_bfloat16* out, __nv_bfloat16* samp, __nv_bfloat16* z,
               int n, int h, int w, int f, int warps, void* stream) {
  return warps == stmma::kManyWarps
             ? launch_mma<C, stmma::kManyWarps>(img, theta, base, kmat, bias,
                                                alpha, alpha_n, out, samp, z,
                                                n, h, w, f, stream)
             : launch_mma<C, stmma::kFewWarps>(img, theta, base, kmat, bias,
                                               alpha, alpha_n, out, samp, z,
                                               n, h, w, f, stream);
}

// Whether the f32 prefix at this shape and with these arrays takes
// st_conv_f32_tiled (the rule of st_conv.py::f32_kind): C = 1..4, F a
// multiple of 4, h w C a multiple of 4 (each sample's image whole 16-byte
// vectors), 16-byte aligned image and outputs, a block within the card's
// opt-in shared memory, h w F within 32 bits.
static bool tiled_f32(const float* img, const float* out, const float* samp,
                      const float* z, int h, int w, int c, int f) {
  int device = 0, optin = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return false;
  }
  return c >= 1 && c <= 4 && f > 0 && f % 4 == 0 &&
         (int64_t)h * w * c % 4 == 0 &&
         (int64_t)h * w * f < ((int64_t)1 << 31) &&
         sttile::smem_bytes(h, w, c) <= optin && aligned16(img) &&
         aligned16(out) && aligned16(samp) && aligned16(z);
}

template <int C>
int launch_tiled(const float* img, const float* theta, const float* base,
                 const float* kmat, const float* bias, const float* alpha,
                 int alpha_n, float* out, float* samp, float* z, int n, int h,
                 int w, int f, void* stream) {
  const int64_t smem = sttile::smem_bytes(h, w, C);
  const cudaError_t err = cudaFuncSetAttribute(
      st_conv_f32_tiled<C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  st_conv_f32_tiled<C><<<(unsigned)n, sttile::kTileThreads, (size_t)smem,
                         static_cast<cudaStream_t>(stream)>>>(
      img, theta, base, kmat, bias, alpha, alpha_n, out, samp, z, h, w, f);
  return (int)cudaGetLastError();
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
// entry takes f32 arrays and picks st_conv_f32_tiled where tiled_f32 holds,
// else st_conv_prelu_kernel (the same bits); the bf16 one a bf16 img, kmat,
// out, samp and z, with theta, base, bias and alpha f32.
extern "C" int catgen_st_conv_prelu_f32(const float* img, const float* theta,
                                        const float* base, const float* kmat,
                                        const float* bias, const float* alpha,
                                        int alpha_n, float* out, float* samp,
                                        float* z, int n, int h, int w, int c,
                                        int f, void* stream) {
  if ((int64_t)n * h * w * f == 0) return 0;
  if (!tiled_f32(img, out, samp, z, h, w, c, f)) {
    return launch_c(img, theta, base, kmat, bias, alpha, alpha_n, out, samp,
                    z, n, h, w, c, f, stream);
  }
  switch (c) {
    case 1:
      return launch_tiled<1>(img, theta, base, kmat, bias, alpha, alpha_n,
                             out, samp, z, n, h, w, f, stream);
    case 2:
      return launch_tiled<2>(img, theta, base, kmat, bias, alpha, alpha_n,
                             out, samp, z, n, h, w, f, stream);
    case 3:
      return launch_tiled<3>(img, theta, base, kmat, bias, alpha, alpha_n,
                             out, samp, z, n, h, w, f, stream);
    default:
      return launch_tiled<4>(img, theta, base, kmat, bias, alpha, alpha_n,
                             out, samp, z, n, h, w, f, stream);
  }
}

// The bf16 entry's kmat is the bf16 (9*c, f) matrix for
// st_conv_prelu_kernel (tensor_cores = 0), or with tensor_cores = 1 the
// f32 one for st_conv_bf16_mma, which packs and rounds it itself; the
// wrapper picks by shape and alignment (st_conv.py::bf16_kind), and a
// shape or array that st_conv_bf16_mma does not take is refused with
// tensor_cores = 1.
extern "C" int catgen_st_conv_prelu_bf16(
    const __nv_bfloat16* img, const float* theta, const float* base,
    const void* kmat, const float* bias, const float* alpha, int alpha_n,
    __nv_bfloat16* out, __nv_bfloat16* samp, __nv_bfloat16* z, int n, int h,
    int w, int c, int f, int tensor_cores, void* stream) {
  if (!tensor_cores) {
    return launch_c(img, theta, base,
                    static_cast<const __nv_bfloat16*>(kmat), bias, alpha,
                    alpha_n, out, samp, z, n, h, w, c, f, stream);
  }
  const float* kf = static_cast<const float*>(kmat);
  if ((int64_t)n * h * w * f == 0) return 0;
  int device = 0, optin = 0;
  const int warps = mma_warps(n);
  if (warps == 0 || cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return (int)cudaErrorInvalidValue;
  }
  if (c < 1 || c > 4 || f % 8 != 0 || (int64_t)h * w * c % 8 != 0 ||
      (int64_t)h * w * f >= ((int64_t)1 << 31) ||
      stmma::smem_bytes(h, w, c, f, warps) > optin || !aligned16(img) ||
      !aligned16(out) || !aligned16(samp) || !aligned16(z)) {
    return (int)cudaErrorInvalidValue;
  }
  switch (c) {
    case 1:
      return launch_mma<1>(img, theta, base, kf, bias, alpha, alpha_n, out,
                           samp, z, n, h, w, f, warps, stream);
    case 2:
      return launch_mma<2>(img, theta, base, kf, bias, alpha, alpha_n, out,
                           samp, z, n, h, w, f, warps, stream);
    case 3:
      return launch_mma<3>(img, theta, base, kf, bias, alpha, alpha_n, out,
                           samp, z, n, h, w, f, warps, stream);
    default:
      return launch_mma<4>(img, theta, base, kf, bias, alpha, alpha_n, out,
                           samp, z, n, h, w, f, warps, stream);
  }
}
