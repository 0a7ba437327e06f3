// The ladder block's two elementwise passes in bf16, each run once per
// element ahead of the upsample-conv kernels (upsample_conv.cu,
// upsample_conv_bwd.cu), so that those kernels read their operands as
// they lie:
//   * the input transform, xn = bf16(prelu(x * scale + shift, alpha)) over
//     (n, h, w, cin), in f32 with one rounding: the block forward's
//     prologue and the operand of the block's dCK;
//   * the cotangent fold, gf = bf16((gy + gs1) + (2 y) gs2) over (n, 2h,
//     2w, cout), in f32 in the plain version's order with one rounding,
//     and dbias, the per-channel sum of the unrounded f32 fold: the block
//     dCK's operand and the block's dbias.
//
// Replaces the prologue of catgen/kernels/pallas_upsample_conv.py's
// upsample2_conv_block_fused (_make_kernel with in_transform) and the fold
// of pallas_upsample_conv_bwd.py's fused_block_backward
// (_fused_block_bwd_kernel: xn rounded to x's dtype, g32 folded in f32,
// dbias from the unrounded g32, g rounded once). catgen pads xn with
// zeros, so the halo is 0 and not the transform of 0: the passes write no
// halo, and the conv kernels' zero-filled copies give it.
//
// What bounds them: bytes. Each element is read and written once (the
// fold reads gy and y): at G32up-c's stages at batch 640, 21-168 MB for
// the transform and 126-503 MB for the fold, at 3.35 TB/s. The design
// against that: 16-byte loads and stores (8 bf16 values) where the
// channel count is a multiple of 8 and the arrays are aligned (2-byte
// accesses otherwise, kVec = false); each thread owns one 8-channel
// column of the rows and keeps its channel constants in registers; the
// rows of a block follow each other, so a warp reads contiguous bytes.
//
// dbias is deterministic without atomics: each thread sums its column
// over its rows in order, the block adds its threads' sums row group by
// row group in a fixed order into one partial row, and sum_rows adds the
// blocks' rows in order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_conv_tile.cuh"

namespace {

using namespace upconv;

namespace prep {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 8 * 132;   // 8 blocks of 256 threads per SM

// The block shape and grid of a pass over `rows` rows of `c` channels:
// blockDim.x threads across the 8-channel columns (at most 32), the rest
// of the block's 256 down the rows; gridDim.x column blocks, and enough
// row blocks to give the card ~8 blocks per SM.
struct Plan {
  dim3 block, grid;
  int rows_per_block;
};

inline Plan plan(int rows, int c) {
  const int cols = (int)ceil_div(c, 8);
  const int bx = cols < 32 ? cols : 32;
  const int by = kThreads / bx;
  const int col_blocks = (int)ceil_div(cols, bx);
  int row_blocks = (int)ceil_div(kTargetBlocks, col_blocks);
  const int most = (int)ceil_div(rows, by);
  row_blocks = row_blocks > most ? most : row_blocks;
  row_blocks = row_blocks < 1 ? 1 : row_blocks;
  Plan p;
  p.block = dim3(bx, by);
  p.grid = dim3(col_blocks, row_blocks);
  p.rows_per_block = (int)ceil_div(rows, row_blocks);
  return p;
}

// 8 values at `off` (channels c0 .. c0+7): one 16-byte load, or 2-byte
// loads of the channels below c (0 past it)
template <bool kVec>
__device__ __forceinline__ void load8(const bf16* __restrict__ a, int64_t off,
                                      int c0, int c, float (&v)[8]) {
  if (kVec) {
    unpack8(__ldg(reinterpret_cast<const uint4*>(a + off)), v);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = c0 + q < c ? ldf(a + off + q) : 0.0f;
  }
}

// 8 values rounded once to bf16 at `off` (channels c0 .. c0+7 below c)
template <bool kVec>
__device__ __forceinline__ void store8(bf16* __restrict__ a, int64_t off,
                                       int c0, int c, const float (&v)[8]) {
  if (kVec) {
    *reinterpret_cast<uint4*>(a + off) = pack8(v);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (c0 + q < c) store_one(a + off + q, v[q]);
    }
  }
}

}  // namespace prep

// x, xn (rows, cin) bf16; the transform's constants (cin) bf16. Thread
// (tx, ty) of block (bx, by) owns channels 8 (bx blockDim.x + tx) .. +7
// of rows by * rows_per_block + ty, + blockDim.y, ...
template <bool kVec>
__global__ void __launch_bounds__(prep::kThreads)
upsample_conv_transform_bf16(const bf16* __restrict__ x, TransformT<bf16> tr,
                             bf16* __restrict__ xn, int rows, int cin,
                             int rows_per_block) {
  const int c0 = 8 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (c0 >= cin) return;
  float sc[8], sh[8], al[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const bool ok = c0 + q < cin;
    sc[q] = ok ? ldf(tr.scale + c0 + q) : 0.0f;
    sh[q] = ok ? ldf(tr.shift + c0 + q) : 0.0f;
    al[q] = ok ? ldf(tr.alpha + c0 + q) : 0.0f;
  }
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
    const int64_t off = (int64_t)r * cin + c0;
    float v[8];
    prep::load8<kVec>(x, off, c0, cin, v);
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      // prelu(x * scale + shift) in f32, as the plain version's
      const float xt = v[q] * sc[q] + sh[q];
      v[q] = xt >= 0.0f ? xt : al[q] * xt;
    }
    prep::store8<kVec>(xn, off, c0, cin, v);
  }
}

// gy, y, gf (rows, cout) bf16; gs (2, cout) f32; partial (gridDim.y,
// cout) f32 receives each row block's column sums of the f32 fold. The
// thread layout is the transform's; shared memory holds the block's
// (blockDim.y, 8 blockDim.x) thread sums.
template <bool kVec>
__global__ void __launch_bounds__(prep::kThreads)
upsample_conv_fold_bf16(const bf16* __restrict__ gy,
                        const bf16* __restrict__ y,
                        const float* __restrict__ gs, bf16* __restrict__ gf,
                        float* __restrict__ partial, int rows, int cout,
                        int rows_per_block) {
  __shared__ float red[prep::kThreads * 8];
  const int c0 = 8 * (blockIdx.x * blockDim.x + threadIdx.x);
  const bool live = c0 < cout;
  float s1[8], s2[8], db[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const bool ok = live && c0 + q < cout;
    s1[q] = ok ? __ldg(gs + c0 + q) : 0.0f;
    s2[q] = ok ? __ldg(gs + cout + c0 + q) : 0.0f;
    db[q] = 0.0f;
  }
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(r0 + rows_per_block, rows);
  if (live) {
    for (int r = r0 + threadIdx.y; r < r1; r += blockDim.y) {
      const int64_t off = (int64_t)r * cout + c0;
      float g[8], yv[8];
      prep::load8<kVec>(gy, off, c0, cout, g);
      prep::load8<kVec>(y, off, c0, cout, yv);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        // (gy + gs1) + (2 y) gs2, in the plain version's order
        const float tk = (2.0f * yv[q]) * s2[q];
        g[q] = (g[q] + s1[q]) + tk;
        db[q] += g[q];
      }
      prep::store8<kVec>(gf, off, c0, cout, g);
    }
  }
  // the block's partial row: thread (tx, 0) adds the row groups' sums of
  // its 8 columns in order
  const int width = 8 * blockDim.x;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    red[threadIdx.y * width + 8 * threadIdx.x + q] = db[q];
  }
  __syncthreads();
  if (threadIdx.y == 0 && live) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (c0 + q >= cout) break;
      float s = 0.0f;
      for (int ty = 0; ty < (int)blockDim.y; ++ty) {
        s += red[ty * width + 8 * threadIdx.x + q];
      }
      partial[(int64_t)blockIdx.y * cout + c0 + q] = s;
    }
  }
}

// 16-byte accesses where every row starts 16-byte aligned
bool vec_rows(int c, const void* a, const void* b, const void* d) {
  return c % 8 == 0 && aligned16(a) && aligned16(b) && aligned16(d);
}

}  // namespace

// Rows of per-block partial sums the fold writes for rows x c values:
// the wrapper sizes its scratch (partial) from it.
extern "C" int catgen_upsample_conv_fold_rows(int rows, int c) {
  if (rows <= 0 || c <= 0) return 0;
  return (int)prep::plan(rows, c).grid.y;
}

// The input transform: x and xn (rows, cin), tscale, tshift, talpha
// (cin), all bf16. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (0 = accepted).
extern "C" int catgen_upsample_conv_transform_bf16(
    const bf16* x, const bf16* tscale, const bf16* tshift,
    const bf16* talpha, bf16* xn, int rows, int cin, void* stream) {
  if (rows <= 0 || cin <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TransformT<bf16> tr = {tscale, tshift, talpha};
  const prep::Plan p = prep::plan(rows, cin);
  if (vec_rows(cin, x, xn, nullptr)) {
    upsample_conv_transform_bf16<true><<<p.grid, p.block, 0, s>>>(
        x, tr, xn, rows, cin, p.rows_per_block);
  } else {
    upsample_conv_transform_bf16<false><<<p.grid, p.block, 0, s>>>(
        x, tr, xn, rows, cin, p.rows_per_block);
  }
  return (int)cudaGetLastError();
}

// The cotangent fold: gy, y and gf (rows, cout) bf16, gs (2, cout) f32;
// partial holds (catgen_upsample_conv_fold_rows, cout) floats of scratch
// and dbias (cout) f32 receives the sum of the f32 fold over the rows (0
// for no rows).
extern "C" int catgen_upsample_conv_fold_bf16(
    const bf16* gy, const bf16* y, const float* gs, bf16* gf, float* partial,
    float* dbias, int rows, int cout, void* stream) {
  if (cout <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) {
    return (int)cudaMemsetAsync(dbias, 0, sizeof(float) * cout, s);
  }
  const prep::Plan p = prep::plan(rows, cout);
  if (vec_rows(cout, gy, y, gf)) {
    upsample_conv_fold_bf16<true><<<p.grid, p.block, 0, s>>>(
        gy, y, gs, gf, partial, rows, cout, p.rows_per_block);
  } else {
    upsample_conv_fold_bf16<false><<<p.grid, p.block, 0, s>>>(
        gy, y, gs, gf, partial, rows, cout, p.rows_per_block);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_rows(partial, dbias, (int)p.grid.y, cout, s);
}
