// Nearest-2x upsample + k x k 'same' conv as four collapsed parity convs in
// one pass, with the optional pieces of both TPU forms:
//   * an input transform prelu(x * scale + shift, alpha), the previous
//     ladder stage's BatchNorm affine and PReLU, applied as x is loaded;
//     a halo element outside the image is 0, not the transform of 0, as
//     the unfused BN -> PReLU -> upsample -> zero-padded conv gives;
//   * bias, and a PReLU epilogue (one slope or one per output channel);
//   * per-channel [sum y, sum y^2] for the next BatchNorm;
//   * the output written already interleaved to (n, 2h, 2w, cout).
//
// Replaces the TPU kernels catgen/kernels/pallas_upsample_conv.py,
// upsample2_conv_fused (_make_kernel with bias and PReLU) and
// upsample2_conv_block_fused (_make_kernel with in_transform and
// with_stats). The weight collapse into the 4-parity stack stays in the
// PyTorch wrapper, as catgen keeps it outside its pallas_call.
//
// out[n, 2i+d, 2j+e, co] = bias[co] + sum_{u, v, c}
//     xn[n, i + umin_h[d] + u, j + umin_w[e] + v, c] * ck[d, e, u, v, c, co]
// is, for each parity, a GEMM of (n h w pixels) x (kh kw cin) by
// (kh kw cin) x (cout), whose A operand is gathered from x on the fly
// (implicit GEMM). Grid: (pixel tiles, cout tiles, 4 parities).
//
// What bounds it: f32 arithmetic. G32up-c's three stages at batch 640 are
// 43 / 86 / 193 GMAC against ~0.3 GB of traffic, far above the card's
// f32 balance point, and TF32 is off (the port equals the f32 reference),
// so the tensor cores are out and the limit is the CUDA cores' f32 FMA
// rate. The design keeps the FMA units fed: each thread holds a 4 x 4
// register block and reads its operands as float4 from shared memory, 16
// multiply-adds per 8 shared loads. Not yet done: double-buffered tiles
// (cp.async) and larger register blocks, which a later change can add.
//
// The statistics are deterministic without atomics: each block writes the
// column sums of its tile to its own row of a scratch array, and a second
// kernel adds the rows in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_conv_tile.cuh"

namespace {

using namespace upconv;

// x (n, h, w, cin); wst (4, kh, kw, cin, cout); y (n, 2h, 2w, cout);
// partial (4 * gridDim.x, 2, cout) when kStats.
template <bool kTransform, bool kStats>
__global__ void __launch_bounds__(kThreads)
upsample_conv_fwd(const float* __restrict__ x, const float* __restrict__ wst,
                  const float* __restrict__ bias,
                  const float* __restrict__ prelu, int prelu_n, Transform tr,
                  float* __restrict__ y, float* __restrict__ partial,
                  Geometry g) {
  __shared__ Tiles s;
  __shared__ float red[16][kBN];
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int p = blockIdx.z, d = p >> 1, e = p & 1;
  const int64_t hw = (int64_t)g.h * g.w, m_total = (int64_t)g.n * hw;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: one pixel, four consecutive channels
  const int lm = t >> 2, lc = (t & 3) * 4;
  const int64_t am = m0 + lm;
  const bool a_row = am < m_total;
  int an = 0, ai = 0, aj = 0;
  if (a_row) {
    an = (int)(am / hw);
    const int r = (int)(am - (int64_t)an * hw);
    ai = r / g.w;
    aj = r - ai * g.w;
  }
  // B loader: one contraction row, four consecutive output channels
  const int bk = t >> 4, bn = (t & 15) * 4;

  float acc[4][4] = {};
  for (int u = 0; u < g.kh; ++u) {
    for (int v = 0; v < g.kw; ++v) {
      const int si = ai + g.umin_h[d] + u, sj = aj + g.umin_w[e] + v;
      const bool inb = a_row && si >= 0 && si < g.h && sj >= 0 && sj < g.w;
      const int64_t xoff =
          inb ? (((int64_t)an * g.h + si) * g.w + sj) * g.cin : 0;
      const float* wtap =
          wst + (((int64_t)p * g.kh + u) * g.kw + v) * g.cin * g.cout;
      for (int c0 = 0; c0 < g.cin; c0 += kBK) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int c = c0 + lc + q;
          s.a[lc + q][lm] = (inb && c < g.cin)
                                ? load_x<kTransform>(x + xoff + c, tr, c)
                                : 0.0f;
        }
        const int c = c0 + bk;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int co = n0 + bn + q;
          s.b[bk][bn + q] = (c < g.cin && co < g.cout)
                                ? __ldg(wtap + (int64_t)c * g.cout + co)
                                : 0.0f;
        }
        __syncthreads();
        mma_tile(s, acc, ty, tx);
        __syncthreads();
      }
    }
  }

  float s1[4] = {0.0f, 0.0f, 0.0f, 0.0f}, s2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
    const int nn = (int)(m / hw);
    const int r = (int)(m - (int64_t)nn * hw);
    const int oi = r / g.w, oj = r - oi * g.w;
    float* out = y + (((int64_t)nn * 2 * g.h + 2 * oi + d) * 2 * g.w +
                      2 * oj + e) * g.cout;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= g.cout) continue;
      float val = acc[i][j];
      if (bias != nullptr) val += __ldg(bias + co);
      if (prelu != nullptr) {
        const float a = __ldg(prelu + (prelu_n == 1 ? 0 : co));
        val = val >= 0.0f ? val : a * val;
      }
      out[co] = val;
      if (kStats) {
        s1[j] += val;
        s2[j] += val * val;
      }
    }
  }
  if (kStats) {
    const int64_t row = (int64_t)p * gridDim.x + blockIdx.x;
    float* dst = partial + row * 2 * g.cout + n0;
    block_column_sum(red, s1, ty, tx, dst, g.cout - n0);
    block_column_sum(red, s2, ty, tx, dst + g.cout, g.cout - n0);
  }
}

template <bool kTransform, bool kStats>
cudaError_t launch_fwd(const float* x, const float* wst, const float* bias,
                       const float* prelu, int prelu_n, Transform tr,
                       float* y, float* partial, const Geometry& g,
                       cudaStream_t s) {
  const dim3 grid((unsigned)ceil_div((int64_t)g.n * g.h * g.w, kBM),
                  (unsigned)ceil_div(g.cout, kBN), 4);
  upsample_conv_fwd<kTransform, kStats><<<grid, kThreads, 0, s>>>(
      x, wst, bias, prelu, prelu_n, tr, y, partial, g);
  return cudaGetLastError();
}

}  // namespace

// Rows of per-block partial sums the kernels of this family write for an
// input of n x h x w pixels, per parity: one per tile of pixels.
extern "C" int catgen_upsample_conv_partial_rows(int n, int h, int w) {
  return (int)ceil_div((int64_t)n * h * w, kBM);
}

// The forward. x (n, h, w, cin) and wst (4, kh, kw, cin, cout), the
// collapsed parity kernels, are required; bias (cout), prelu (prelu_n
// slopes: 1 or cout) and the input transform tscale / tshift / talpha
// (cin each) may be null. With stats non-null, partial holds
// (4 * partial_rows, 2, cout) floats of scratch and stats receives
// [sum y, sum y^2] as (2, cout). Launches on `stream`, allocates nothing,
// returns cudaGetLastError() (0 = accepted).
extern "C" int catgen_upsample_conv_fwd_f32(
    const float* x, const float* wst, const float* bias, const float* prelu,
    int prelu_n, const float* tscale, const float* tshift,
    const float* talpha, float* y, float* partial, float* stats, int n,
    int h, int w, int cin, int cout, int kh, int kw, int uh0, int uh1,
    int uw0, int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)n * h * w == 0 || cout == 0) return 0;
  const Geometry g =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const Transform tr = {tscale, tshift, talpha};
  const bool with_stats = stats != nullptr;
  cudaError_t err;
  if (tscale != nullptr) {
    err = with_stats
              ? launch_fwd<true, true>(x, wst, bias, prelu, prelu_n, tr, y,
                                       partial, g, s)
              : launch_fwd<true, false>(x, wst, bias, prelu, prelu_n, tr, y,
                                        partial, g, s);
  } else {
    err = with_stats
              ? launch_fwd<false, true>(x, wst, bias, prelu, prelu_n, tr, y,
                                        partial, g, s)
              : launch_fwd<false, false>(x, wst, bias, prelu, prelu_n, tr, y,
                                         partial, g, s);
  }
  if (err != cudaSuccess || !with_stats) return (int)err;
  const int rows = 4 * catgen_upsample_conv_partial_rows(n, h, w);
  return (int)launch_sum_rows(partial, stats, rows, 2 * (int64_t)cout, s);
}
