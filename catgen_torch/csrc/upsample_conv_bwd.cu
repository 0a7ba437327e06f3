// Backward of the upsample-conv (upsample_conv.cu): the gradient with
// respect to the input (dX) and to the collapsed parity kernels (dCK), for
// both TPU forms.
//
// Replaces the TPU kernels of catgen/kernels/pallas_upsample_conv_bwd.py:
//   * upsample2_conv_backward: _dx_kernel (dX) and _dw_kernel (dCK);
//   * fused_block_backward: _fused_block_bwd_kernel, here as the same two
//     kernels with flags: the cotangent fold g = gy + gs1 + 2 y gs2 on
//     load, the input transform recomputed from x (dCK reads xn, zero
//     outside the image), the transform's backward in dX's epilogue (dx,
//     and per-channel dscale, dshift, dalpha), and dbias from dCK's pass.
// The dCK -> dW chain through the collapse matrices, and the per-layer
// form's dbias (a sum of g), stay in the PyTorch wrapper, as catgen keeps
// them outside its pallas_calls.
//
// dX[n, q, r, c] = sum_{d, e, u, v, co} ck[d, e, u, v, c, co] *
//     g[n, 2 (q - umin_h[d] - u) + d, 2 (r - umin_w[e] - v) + e, co]
// (terms whose source pixel lies outside the image drop out): an implicit
// GEMM of (n h w pixels) x (4 kh kw cout) by (4 kh kw cout) x (cin), the
// forward's shape with cin and cout swapped; the wrapper hands it the
// kernel stack transposed, (4, kh, kw, cout, cin).
//
// dCK[d, e, u, v, c, co] = sum_{n, i, j}
//     xn[n, i + umin_h[d] + u, j + umin_w[e] + v, c] * g[n, 2i+d, 2j+e, co]
// is, per parity and tap, a (cin) x (n h w) by (n h w) x (cout) GEMM
// whose contraction runs over every pixel of the batch (163840 at G's
// last stage at batch 640). The TPU walked the batch in order and added
// into one revisited block; here the pixels are cut into `splits` ranges
// that run in parallel, each block writes its own partial dCK, and a
// second kernel adds the splits in a fixed order. No atomics anywhere, so
// two calls on the same inputs give the same bits.
//
// What bounds them: f32 arithmetic, as the forward (each is one forward's
// MACs); the same 64 x 64 tiles and 4 x 4 register blocks.

#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_conv_tile.cuh"

namespace {

using namespace upconv;

// g (n, 2h, 2w, cout) (+ fold); wt (4, kh, kw, cout, cin); dx (n, h, w,
// cin). With kTransform: x (n, h, w, cin), tr, and partial (gridDim.x, 3,
// cin) receives each block's [dscale, dshift, dalpha] column sums.
template <bool kFold, bool kTransform>
__global__ void __launch_bounds__(kThreads)
upsample_conv_dx(const float* __restrict__ g, Fold fold,
                 const float* __restrict__ wt, const float* __restrict__ x,
                 Transform tr, float* __restrict__ dx,
                 float* __restrict__ partial, Geometry gm) {
  __shared__ Tiles s;
  __shared__ float red[16][kBN];
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int64_t hw = (int64_t)gm.h * gm.w, m_total = (int64_t)gm.n * hw;
  const int64_t m0 = (int64_t)blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  const int lm = t >> 2, lc = (t & 3) * 4;
  const int64_t am = m0 + lm;
  const bool a_row = am < m_total;
  int an = 0, ai = 0, aj = 0;
  if (a_row) {
    an = (int)(am / hw);
    const int r = (int)(am - (int64_t)an * hw);
    ai = r / gm.w;
    aj = r - ai * gm.w;
  }
  const int bk = t >> 4, bn = (t & 15) * 4;

  float acc[4][4] = {};
  for (int p = 0; p < 4; ++p) {
    const int d = p >> 1, e = p & 1;
    for (int u = 0; u < gm.kh; ++u) {
      for (int v = 0; v < gm.kw; ++v) {
        const int si = ai - gm.umin_h[d] - u, sj = aj - gm.umin_w[e] - v;
        const bool inb =
            a_row && si >= 0 && si < gm.h && sj >= 0 && sj < gm.w;
        const int64_t goff =
            inb ? (((int64_t)an * 2 * gm.h + 2 * si + d) * 2 * gm.w +
                   2 * sj + e) * gm.cout
                : 0;
        const float* wtap =
            wt + (((int64_t)p * gm.kh + u) * gm.kw + v) * gm.cout * gm.cin;
        for (int k0 = 0; k0 < gm.cout; k0 += kBK) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int co = k0 + lc + q;
            s.a[lc + q][lm] = (inb && co < gm.cout)
                                  ? load_g<kFold>(g, fold, goff + co, co)
                                  : 0.0f;
          }
          const int co = k0 + bk;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int c = n0 + bn + q;
            s.b[bk][bn + q] = (co < gm.cout && c < gm.cin)
                                  ? __ldg(wtap + (int64_t)co * gm.cin + c)
                                  : 0.0f;
          }
          __syncthreads();
          mma_tile(s, acc, ty, tx);
          __syncthreads();
        }
      }
    }
  }

  float dsc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, dsh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float dal[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx * 4 + j;
      if (c >= gm.cin) continue;
      const int64_t idx = m * gm.cin + c;
      const float dxn = acc[i][j];
      if (!kTransform) {
        dx[idx] = dxn;
        continue;
      }
      // the transform's backward, as the plain version's autograd:
      // xt = x * scale + shift; xn = xt >= 0 ? xt : alpha * xt
      const float xv = __ldg(x + idx);
      const float sc = __ldg(tr.scale + c);
      const float xt = xv * sc + __ldg(tr.shift + c);
      const bool pos = xt >= 0.0f;
      const float dxt = pos ? dxn : dxn * __ldg(tr.alpha + c);
      dx[idx] = dxt * sc;
      dsc[j] += dxt * xv;
      dsh[j] += dxt;
      dal[j] += pos ? 0.0f : dxn * xt;
    }
  }
  if (kTransform) {
    float* dst = partial + (int64_t)blockIdx.x * 3 * gm.cin + n0;
    block_column_sum(red, dsc, ty, tx, dst, gm.cin - n0);
    block_column_sum(red, dsh, ty, tx, dst + gm.cin, gm.cin - n0);
    block_column_sum(red, dal, ty, tx, dst + 2 * gm.cin, gm.cin - n0);
  }
}

// x (n, h, w, cin) (+ transform); g (n, 2h, 2w, cout) (+ fold). Grid:
// (cout tiles, kh kw x cin tiles, 4 parities x splits); split sp covers
// pixels [sp * chunk, (sp + 1) * chunk). partial (splits, 4, kh, kw, cin,
// cout). With kFold, the blocks of cin tile 0 at tap 0 also write the
// column sums of g over their pixels to db_partial (splits * 4, cout).
template <bool kFold, bool kTransform>
__global__ void __launch_bounds__(kThreads)
upsample_conv_dck(const float* __restrict__ x, Transform tr,
                  const float* __restrict__ g, Fold fold,
                  float* __restrict__ partial,
                  float* __restrict__ db_partial, Geometry gm,
                  int64_t chunk) {
  __shared__ Tiles s;
  __shared__ float red[16][kBN];
  const int t = threadIdx.x, ty = t >> 4, tx = t & 15;
  const int p = blockIdx.z & 3, sp = blockIdx.z >> 2;
  const int d = p >> 1, e = p & 1;
  const int ctiles = (int)ceil_div(gm.cin, kBM);
  const int tap = blockIdx.y / ctiles;
  const int c0 = (blockIdx.y - tap * ctiles) * kBM;
  const int u = tap / gm.kw, v = tap - u * gm.kw;
  const int n0 = blockIdx.x * kBN;
  const int64_t hw = (int64_t)gm.h * gm.w, m_total = (int64_t)gm.n * hw;
  const int64_t kb0 = (int64_t)sp * chunk;
  const int64_t kb1 = kb0 + chunk < m_total ? kb0 + chunk : m_total;
  const bool bias_block = kFold && blockIdx.y == 0;

  // both loaders: one pixel of the step, four consecutive channels
  const int lk = t >> 4, l4 = (t & 15) * 4;
  float acc[4][4] = {};
  float db[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t kb = kb0; kb < kb1; kb += kBK) {
    const int64_t m = kb + lk;
    const bool valid = m < kb1;
    int nn = 0, i = 0, j = 0;
    if (valid) {
      nn = (int)(m / hw);
      const int r = (int)(m - (int64_t)nn * hw);
      i = r / gm.w;
      j = r - i * gm.w;
    }
    const int si = i + gm.umin_h[d] + u, sj = j + gm.umin_w[e] + v;
    const bool inb = valid && si >= 0 && si < gm.h && sj >= 0 && sj < gm.w;
    const int64_t xoff =
        inb ? (((int64_t)nn * gm.h + si) * gm.w + sj) * gm.cin : 0;
    const int64_t goff =
        valid ? (((int64_t)nn * 2 * gm.h + 2 * i + d) * 2 * gm.w + 2 * j +
                 e) * gm.cout
              : 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = c0 + l4 + q;
      s.a[lk][l4 + q] = (inb && c < gm.cin)
                            ? load_x<kTransform>(x + xoff + c, tr, c)
                            : 0.0f;
      const int co = n0 + l4 + q;
      const float gv =
          (valid && co < gm.cout) ? load_g<kFold>(g, fold, goff + co, co)
                                  : 0.0f;
      s.b[lk][l4 + q] = gv;
      if (bias_block) db[q] += gv;
    }
    __syncthreads();
    mma_tile(s, acc, ty, tx);
    __syncthreads();
  }

  float* out = partial +
               ((((int64_t)sp * 4 + p) * gm.kh + u) * gm.kw + v) * gm.cin *
                   gm.cout;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = c0 + ty * 4 + i;
    if (c >= gm.cin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co < gm.cout) out[(int64_t)c * gm.cout + co] = acc[i][j];
    }
  }
  if (bias_block) {
    // thread (lk, l4 / 4) holds column sums over pixel rows lk of each
    // step: the loader's layout is block_column_sum's (ty, tx)
    block_column_sum(red, db, ty, tx,
                     db_partial + ((int64_t)sp * 4 + p) * gm.cout + n0,
                     gm.cout - n0);
  }
}

template <bool kFold, bool kTransform>
cudaError_t launch_dx(const float* g, Fold fold, const float* wt,
                      const float* x, Transform tr, float* dx, float* partial,
                      const Geometry& gm, cudaStream_t s) {
  const dim3 grid((unsigned)ceil_div((int64_t)gm.n * gm.h * gm.w, kBM),
                  (unsigned)ceil_div(gm.cin, kBN));
  upsample_conv_dx<kFold, kTransform><<<grid, kThreads, 0, s>>>(
      g, fold, wt, x, tr, dx, partial, gm);
  return cudaGetLastError();
}

template <bool kFold, bool kTransform>
cudaError_t launch_dck(const float* x, Transform tr, const float* g,
                       Fold fold, float* partial, float* db_partial,
                       const Geometry& gm, int splits, int64_t chunk,
                       cudaStream_t s) {
  const dim3 grid((unsigned)ceil_div(gm.cout, kBN),
                  (unsigned)(gm.kh * gm.kw * ceil_div(gm.cin, kBM)),
                  (unsigned)(4 * splits));
  upsample_conv_dck<kFold, kTransform><<<grid, kThreads, 0, s>>>(
      x, tr, g, fold, partial, db_partial, gm, chunk);
  return cudaGetLastError();
}

int64_t dck_chunk(int64_t pixels, int splits) {
  return ceil_div(ceil_div(pixels, splits), kBK) * kBK;
}

}  // namespace

// How many pixel ranges the dCK kernel cuts the batch into: enough blocks
// to give each of the card's multiprocessors about eight, at least 512
// pixels per range. The wrapper sizes the scratch from it.
extern "C" int catgen_upsample_conv_dck_splits(int n, int h, int w, int cin,
                                               int cout, int kh, int kw) {
  const int64_t pixels = (int64_t)n * h * w;
  const int64_t tiles =
      ceil_div(cout, kBN) * (int64_t)kh * kw * ceil_div(cin, kBM) * 4;
  int64_t splits = ceil_div(132 * 8, tiles);
  const int64_t most = pixels / 512 > 1 ? pixels / 512 : 1;
  if (splits > most) splits = most;
  return (int)(splits < 1 ? 1 : splits);
}

// dX. g (n, 2h, 2w, cout) and wt (4, kh, kw, cout, cin) are required.
// With y and gs (2, cout) non-null, g is folded with the stats
// cotangents. With x non-null, dx is the gradient through the input
// transform tscale / tshift / talpha (cin each), partial holds
// (partial_rows, 3, cin) floats of scratch and dtr receives [dscale,
// dshift, dalpha] as (3, cin); else dx is the gradient of the conv's
// input. Launches on `stream`; returns cudaGetLastError().
extern "C" int catgen_upsample_conv_dx_f32(
    const float* g, const float* y, const float* gs, const float* wt,
    const float* x, const float* tscale, const float* tshift,
    const float* talpha, float* dx, float* partial, float* dtr, int n, int h,
    int w, int cin, int cout, int kh, int kw, int uh0, int uh1, int uw0,
    int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)n * h * w == 0 || cin == 0) return 0;
  const Geometry gm =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const Fold fold = {y, gs, cout};
  const Transform tr = {tscale, tshift, talpha};
  const bool f = y != nullptr, tf = x != nullptr;
  cudaError_t err;
  if (f && tf) {
    err = launch_dx<true, true>(g, fold, wt, x, tr, dx, partial, gm, s);
  } else if (f) {
    err = launch_dx<true, false>(g, fold, wt, x, tr, dx, partial, gm, s);
  } else if (tf) {
    err = launch_dx<false, true>(g, fold, wt, x, tr, dx, partial, gm, s);
  } else {
    err = launch_dx<false, false>(g, fold, wt, x, tr, dx, partial, gm, s);
  }
  if (err != cudaSuccess || !tf) return (int)err;
  const int rows = (int)ceil_div((int64_t)n * h * w, kBM);
  return (int)launch_sum_rows(partial, dtr, rows, 3 * (int64_t)cin, s);
}

// dCK. x (n, h, w, cin) and g (n, 2h, 2w, cout) are required; tscale /
// tshift / talpha non-null recompute xn from x; y and gs non-null fold g
// and then also write dbias (cout) through db_partial (splits * 4, cout)
// of scratch. partial holds (splits, 4, kh, kw, cin, cout) floats of
// scratch, splits from catgen_upsample_conv_dck_splits; dck receives (4,
// kh, kw, cin, cout). Launches on `stream`; returns cudaGetLastError().
extern "C" int catgen_upsample_conv_dck_f32(
    const float* x, const float* tscale, const float* tshift,
    const float* talpha, const float* g, const float* y, const float* gs,
    float* partial, float* dck, float* db_partial, float* dbias, int n,
    int h, int w, int cin, int cout, int kh, int kw, int uh0, int uh1,
    int uw0, int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 0 || cout == 0) return 0;
  const Geometry gm =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const Fold fold = {y, gs, cout};
  const Transform tr = {tscale, tshift, talpha};
  const int splits = catgen_upsample_conv_dck_splits(n, h, w, cin, cout, kh,
                                                     kw);
  const int64_t chunk = dck_chunk((int64_t)n * h * w, splits);
  const bool f = y != nullptr, tf = tscale != nullptr;
  cudaError_t err;
  if (f && tf) {
    err = launch_dck<true, true>(x, tr, g, fold, partial, db_partial, gm,
                                 splits, chunk, s);
  } else if (f) {
    err = launch_dck<true, false>(x, tr, g, fold, partial, db_partial, gm,
                                  splits, chunk, s);
  } else if (tf) {
    err = launch_dck<false, true>(x, tr, g, fold, partial, db_partial, gm,
                                  splits, chunk, s);
  } else {
    err = launch_dck<false, false>(x, tr, g, fold, partial, db_partial, gm,
                                   splits, chunk, s);
  }
  if (err != cudaSuccess) return (int)err;
  err = launch_sum_rows(partial, dck, splits,
                        (int64_t)4 * kh * kw * cin * cout, s);
  if (err != cudaSuccess || !f) return (int)err;
  return (int)launch_sum_rows(db_partial, dbias, splits * 4, cout, s);
}
