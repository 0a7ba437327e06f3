// Shared pieces of the upsample-conv kernels (upsample_conv.cu, forward;
// upsample_conv_bwd.cu, dX and dCK): the CUDA-core tile shape and its
// register-blocked product, the loaders' input transform and cotangent
// fold, the tensor-core pieces of the 3xTF32 kernels, and the
// fixed-order sums that make every reduction deterministic without
// atomics.
//
// dX is an implicit GEMM in f32 on the CUDA cores: a block of kThreads
// threads owns a kBM x kBN tile of its output, walks the contraction in
// steps of kBK, gathers each step's A (kBK x kBM) and B (kBK x kBN)
// slices into shared memory, and each thread accumulates a 4x4 block of
// the tile in registers with fmaf (the library is built with
// --fmad=false, which would otherwise split every multiply-add in two).
// The forward and dCK run 3xTF32 on the tensor cores (their sources say
// how).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The kernel and host helpers are static: each source that includes this
// gets its own copy, so the linked library holds no duplicate symbols.
namespace upconv {

constexpr int kBM = 64;        // tile rows (output pixels, or dCK's channels)
constexpr int kBN = 64;        // tile columns (output channels)
constexpr int kBK = 16;        // contraction step
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kPad = 4;        // row padding; keeps rows 16-byte aligned

// Shapes of one upsample-conv: x (n, h, w, cin) -> y (n, 2h, 2w, cout),
// collapsed taps kh x kw per parity; umin_h[d] / umin_w[e] is the offset
// of tap 0 of output parity (d, e) relative to the output pixel's source
// pixel (catgen's _collapse_matrix u_min).
struct Geometry {
  int n, h, w, cin, cout, kh, kw;
  int umin_h[2], umin_w[2];
};

// The previous stage's BatchNorm affine and PReLU, per input channel.
struct Transform {
  const float* scale;
  const float* shift;
  const float* alpha;
};

// BatchNorm-statistics cotangents folded into the output cotangent:
// g = gy + gs[0][co] + 2 y gs[1][co] (gs is (2, cout)).
struct Fold {
  const float* y;
  const float* gs;
  int cout;
};

struct __align__(16) Tiles {
  float a[kBK][kBM + kPad];
  float b[kBK][kBN + kPad];
};

// The cotangent at flat index idx (channel co), with the stats fold in
// the plain version's order: (gy + gs1) + (2 y) gs2.
template <bool kFold>
__device__ __forceinline__ float load_g(const float* g, const Fold& f,
                                        int64_t idx, int co) {
  const float v = __ldg(g + idx);
  if (!kFold) return v;
  const float t = (2.0f * __ldg(f.y + idx)) * __ldg(f.gs + f.cout + co);
  return (v + __ldg(f.gs + co)) + t;
}

// acc[i][j] += sum_k a[k][4 ty + i] * b[k][4 tx + j]
__device__ __forceinline__ void mma_tile(const Tiles& s, float (&acc)[4][4],
                                         int ty, int tx) {
#pragma unroll
  for (int k = 0; k < kBK; ++k) {
    const float4 a = *reinterpret_cast<const float4*>(&s.a[k][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&s.b[k][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// Column sums of a tile: thread (ty, tx) holds v[j] for columns 4 tx + j;
// the 16 rows of threads are added in order and thread t < valid writes
// column t to dst[t]. Every thread of the block must call it.
__device__ __forceinline__ void block_column_sum(float (&red)[16][kBN],
                                                 const float (&v)[4], int ty,
                                                 int tx, float* dst,
                                                 int valid) {
#pragma unroll
  for (int j = 0; j < 4; ++j) red[ty][tx * 4 + j] = v[j];
  __syncthreads();
  const int t = threadIdx.x;
  if (t < kBN && t < valid) {
    float s = 0.0f;
    for (int y = 0; y < 16; ++y) s += red[y][t];
    dst[t] = s;
  }
  __syncthreads();
}

// out[c] = sum over rows r of in[r * cols + c], in a fixed order: thread
// (x, y) adds rows y, y + blockDim.y, ... in turn, then row 0 of threads
// adds the blockDim.y partial sums in turn. Same inputs, same bits.
static __global__ void sum_rows(const float* __restrict__ in,
                                float* __restrict__ out, int rows,
                                int64_t cols) {
  __shared__ float part[32][33];
  const int64_t c = (int64_t)blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (c < cols) {
    for (int r = threadIdx.y; r < rows; r += blockDim.y)
      s += in[(int64_t)r * cols + c];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && c < cols) {
    float t = 0.0f;
    for (int y = 0; y < (int)blockDim.y; ++y) t += part[y][threadIdx.x];
    out[c] = t;
  }
}

static inline cudaError_t launch_sum_rows(const float* in, float* out,
                                          int rows, int64_t cols,
                                          cudaStream_t s) {
  if (rows <= 0 || cols <= 0) return cudaSuccess;
  const dim3 block(32, rows < 32 ? rows : 32);
  const dim3 grid((unsigned)((cols + 31) / 32));
  sum_rows<<<grid, block, 0, s>>>(in, out, rows, cols);
  return cudaGetLastError();
}

// Pieces of the 3xTF32 kernels (the forward and dCK): cp.async copies
// into shared memory, and the split of an f32 value into TF32 hi and lo.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// src_bytes < size zero-fills the rest (0: the whole chunk)
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a rounded to TF32 (10 mantissa bits) to nearest, ties away from zero:
// cvt.rna.tf32.f32's result for every value but a NaN, in two integer
// operations (the conversion runs on a slower pipe)
__device__ __forceinline__ uint32_t rna_tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// hi = rna(a), lo = rna(a - hi), both TF32 bit patterns
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi,
                                          uint32_t& lo) {
  hi = rna_tf32(a);
  lo = rna_tf32(a - __uint_as_float(hi));
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

static inline Geometry make_geometry(int n, int h, int w, int cin, int cout,
                                     int kh, int kw, int uh0, int uh1,
                                     int uw0, int uw1) {
  Geometry g;
  g.n = n; g.h = h; g.w = w; g.cin = cin; g.cout = cout; g.kh = kh;
  g.kw = kw;
  g.umin_h[0] = uh0; g.umin_h[1] = uh1;
  g.umin_w[0] = uw0; g.umin_w[1] = uw1;
  return g;
}

}  // namespace upconv
