// Nearest-2x upsample + k x k 'same' conv as four collapsed parity convs in
// one pass, with the optional pieces of both TPU forms:
//   * an input transform prelu(x * scale + shift, alpha), the previous
//     ladder stage's BatchNorm affine and PReLU, applied as x is staged
//     (f32; in bf16 it runs first as its own pass, upsample_conv_prep.cu);
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
// (implicit GEMM). x is NHWC, so A is already contiguous along the
// contraction (cin within one tap).
//
// What bounds it: multiply-adds. G32up-c's three stages at batch 640 are
// 43 / 86 / 193 GMAC against ~0.3 GB of traffic, far above the card's
// balance point. f32 on the CUDA cores gives 67 TFLOP/s (the CUDA-core
// version of this kernel reached 14-23, cuDNN's f32 ~29); the tensor
// cores run TF32 at 495, so the kernel runs 3xTF32 as dCK does
// (upsample_conv_bwd.cu): each f32 operand becomes hi = rna(a) and lo =
// rna(a - hi) in TF32, and lo*hi + hi*lo + hi*hi is summed by the tensor
// cores with f32 accumulators, a bound of 3 * 2 * MACs / 495e12 s. They
// add into their accumulators with truncation, which biases a long sum,
// so each 32-deep step starts fresh accumulators and the steps are added
// in f32, rounding to nearest.
//
// The design, against that bound:
//   * wgmma (m64n128k8, TF32): each of the block's two warpgroups owns 64
//     pixels x 128 output channels of its 128 x 128 tile, and the tensor
//     cores read both operands from shared memory, asynchronously: the
//     products of step k run while the threads prepare step k+1. (mma.sync
//     needs every fragment loaded through registers and measured slower
//     here: 16.74 against 12.81 ms for G32up-c's three stages.)
//   * A step is one tap and 32 input channels: A, 128 pixels x 32
//     channels of x gathered with the tap's offset, and B, the matching
//     32 x 128 slice of the parity stack. Both are K-major, one 128-byte
//     row per pixel or output channel, in wgmma's 128-byte swizzle. x is
//     NHWC, so a 16-byte copy of 4 channels lands A in place; B's copies
//     hold 4 output channels each and land in a raw tile. 16-byte
//     cp.async copies, zero-filled for rows outside the image; the
//     copies of step k+2 are in flight during step k. Channel counts that
//     are not multiples of 4, or unaligned arrays, take 4-byte copies per
//     element (kVec = false), in the same kernel.
//   * The split happens once per staged element: when a step's copies
//     land, the thread that copied an element applies the input
//     transform and the halo mask (0 outside the image, after the
//     transform), splits it and stores hi in place and lo beside it; for
//     B, the thread holds 4 channels x 4 output channels and stores them
//     transposed. Rounding to TF32 is two integer operations
//     (rna_tf32): the conversion instruction runs on a slower pipe.
//   * Shared memory: A hi x 3 (one in flight, one being split, one being
//     multiplied), A lo, B hi, B lo and B raw x 2: 176 KB, one block of 8
//     warps per SM (64 accumulators and 64 step sums a thread). One
//     __syncthreads per step. G32up-c's stages give 1280 / 2560 / 5120
//     blocks: 97-99% full waves of 132. The blocks of one pixel tile (4
//     parities x cout tiles) are adjacent in launch order, so its x stays
//     in L2.
// What is left: the split pass and the step sums do not overlap the next
// step's products (one accumulator set fits the registers); a producer
// warpgroup with setmaxnreg, and a second accumulator set for the
// consumers, would.
//
// The statistics are deterministic without atomics: each block writes the
// column sums of its tile to its own row of a scratch array (a fixed
// butterfly over the rows of a warp, then the two row-warps in order),
// and a second kernel adds the rows in a fixed order. No atomics
// anywhere: two calls on the same inputs give the same bits.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_conv_tile.cuh"

namespace {

using namespace upconv;

namespace fwd {

constexpr int kTileM = kTilePixels;   // output pixels of one parity per block
constexpr int kTileN = 128;     // output channels per block
constexpr int kStep = 32;       // contraction per stage: 32 channels, 1 tap
constexpr int kThreads = 256;   // 2 warpgroups, 64 rows of the tile each
constexpr int kTile = kTileM * kStep * 4;     // bytes of one A or B tile
static_assert(kTileM == kTileN, "one tile size for A and B");
static_assert(kStep * 4 == 128, "a tile row is one 128-byte swizzle row");
// Shared memory, in tiles of kTile bytes, 1024-aligned: A (hi, and the
// raw copy it replaces) x 3 stages, A lo x 2, B hi x 2, B lo x 2, B's raw
// copy x 2
constexpr int kAHi = 0, kALo = 3, kBHi = 5, kBLo = 7, kBRaw = 9;
constexpr int kSmemBytes = 11 * kTile + 1024;   // + room to align
static_assert(kSmemBytes <= 232448, "over the H100's opt-in shared memory");

}  // namespace fwd

// The forward's epilogue, for both element types T: bias, PReLU, the
// interleaved store (rounded once to T), the column sums of the unrounded
// values. Thread (g, t) of warp w of warpgroup wg holds rows 16 w + g and
// 16 w + g + 8 of the warpgroup's 64, columns 2t, 2t+1 of each 8-column
// group: sum[4 j + 2 half + q]. The statistics are deterministic without
// atomics: the 8 rows g of a warp in a fixed butterfly, then the 8 warps
// in order, one row of partial sums per block (`smem`, the free A tiles,
// holds the warps' sums). `tid` counts the 256 threads that hold the tile;
// with `named` they meet at named barrier 1 (the warp-specialised kernel's
// producer warpgroup takes no part), else at __syncthreads.
template <bool kStats, class T>
__device__ __forceinline__ void fwd_epilogue(
    const float (&sum)[64], const T* __restrict__ bias,
    const T* __restrict__ prelu, int prelu_n, T* __restrict__ y,
    float* __restrict__ partial, uint8_t* smem, const Geometry& g, int p,
    int co0, int64_t m0, int mtile, int tid, bool named) {
  constexpr int kTileN = fwd::kTileN, kThreads = fwd::kThreads;
  const int wg = tid >> 7;
  const int hw = g.h * g.w;
  const int64_t m_total = (int64_t)g.n * hw;
  const int m_tiles = (int)ceil_div(m_total, fwd::kTileM);
  const int d = p >> 1, e = p & 1;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int wrow = wg * 64 + ((tid >> 5) & 3) * 16;
  float s1[16][2] = {}, s2[16][2] = {};
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int64_t m = m0 + wrow + gid + 8 * hf;
    if (m >= m_total) continue;
    const int nn = (int)(m / hw);
    const int rem = (int)(m - (int64_t)nn * hw);
    const int oi = rem / g.w, oj = rem - oi * g.w;
    T* out = y + (((int64_t)nn * 2 * g.h + 2 * oi + d) * 2 * g.w + 2 * oj +
                  e) * g.cout;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = co0 + 8 * j + 2 * tig;
      float val[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        float v = sum[4 * j + 2 * hf + q];
        if (co + q < g.cout) {
          if (bias != nullptr) v += ldf(bias + co + q);
          if (prelu != nullptr) {
            const float a = ldf(prelu + (prelu_n == 1 ? 0 : co + q));
            v = v >= 0.0f ? v : a * v;
          }
          if (kStats) {
            s1[j][q] += v;
            s2[j][q] += v * v;
          }
        }
        val[q] = v;
      }
      if (co + 1 < g.cout && (g.cout & 1) == 0) {
        store_pair(out + co, val[0], val[1]);
      } else if (co < g.cout) {
        store_one(out + co, val[0]);
        if (co + 1 < g.cout) store_one(out + co + 1, val[1]);
      }
    }
  }
  if (kStats) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[j][q] += __shfl_xor_sync(0xffffffffu, s1[j][q], off);
          s2[j][q] += __shfl_xor_sync(0xffffffffu, s2[j][q], off);
        }
      }
    }
    float* red = reinterpret_cast<float*>(smem);   // (8 warps, 2, 128)
    const int warp = tid >> 5;
    if (gid == 0) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int col = 8 * j + 2 * tig + q;
          red[(warp * 2 + 0) * kTileN + col] = s1[j][q];
          red[(warp * 2 + 1) * kTileN + col] = s2[j][q];
        }
      }
    }
    if (named) {
      named_barrier(1, kThreads);
    } else {
      __syncthreads();
    }
    if (tid < kTileN && co0 + tid < g.cout) {
      float t1 = 0.0f, t2 = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) {
        t1 += red[(w * 2 + 0) * kTileN + tid];
        t2 += red[(w * 2 + 1) * kTileN + tid];
      }
      float* dst = partial + ((int64_t)p * m_tiles + mtile) * 2 * g.cout;
      dst[co0 + tid] = t1;
      dst[g.cout + co0 + tid] = t2;
    }
  }
}

// x (n, h, w, cin); wst (4, kh, kw, cin, cout); y (n, 2h, 2w, cout);
// partial (4 * m_tiles, 2, cout) when kStats. Blocks in order parity,
// cout tile, pixel tile (fastest to slowest).
template <bool kTransform, bool kStats, bool kVec>
__global__ void __launch_bounds__(fwd::kThreads, 1)
upsample_conv_fwd(const float* __restrict__ x, const float* __restrict__ wst,
                  const float* __restrict__ bias,
                  const float* __restrict__ prelu, int prelu_n, Transform tr,
                  float* __restrict__ y, float* __restrict__ partial,
                  Geometry g) {
  using namespace fwd;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start at the first 1024-byte boundary (the swizzle's period)
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);
  auto tile = [&](int t) { return smem + t * kTile; };

  const int tid = threadIdx.x;
  const int co_tiles = (int)ceil_div(g.cout, kTileN);
  int b = blockIdx.x;
  const int p = b & 3;
  b >>= 2;
  const int co0 = (b % co_tiles) * kTileN;
  const int mtile = b / co_tiles;
  const int d = p >> 1, e = p & 1;
  const int hw = g.h * g.w;
  const int64_t m_total = (int64_t)g.n * hw;
  const int64_t m0 = (int64_t)mtile * kTileM;
  const int csteps = (g.cin + kStep - 1) / kStep;
  const int steps = g.kh * g.kw * csteps;

  // A loader: rows 32 r + (tid >> 3), chunk tid & 7 (channels 4 (tid & 7)
  // .. +3) of each stage, copied into place in the A tile; the rows'
  // pixels are decoded once
  const int acq = tid & 7, arow = tid >> 3;
  int apix[4], ai[4], aj[4];
  uint32_t avalid = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t m = m0 + 32 * r + arow;
    const bool ok = m < m_total;
    const int nn = ok ? (int)(m / hw) : 0;
    const int rem = ok ? (int)(m - (int64_t)nn * hw) : 0;
    ai[r] = rem / g.w;
    aj[r] = rem - ai[r] * g.w;
    apix[r] = ok ? (int)m : 0;      // (nn h + i) w + j
    avalid |= (uint32_t)ok << r;
  }
  // B loader: contraction rows 4 (tid & 7) + r (chunk tid & 7 of the
  // K-major B tile), output channels co0 + 4 (tid >> 3) .. +3, into B's
  // raw tile; the split transposes them
  const int bc = tid & 7, bnq = tid >> 3;
  const int bco = co0 + 4 * bnq;

  uint32_t masks = 0;               // per A slot: 4 halo bits of A rows
  int ld_u = 0, ld_v = 0, ld_cs = 0;   // the next stage to load

  auto load_stage = [&](int kt) {
    float* a_dst = reinterpret_cast<float*>(tile(kAHi + kt % 3));
    float* b_dst = reinterpret_cast<float*>(tile(kBRaw + (kt & 1)));
    const int c0 = ld_cs * kStep;
    const int du = g.umin_h[d] + ld_u, dv = g.umin_w[e] + ld_v;
    uint32_t bits = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int si = ai[r] + du, sj = aj[r] + dv;
      const bool inb = ((avalid >> r) & 1u) && si >= 0 && si < g.h &&
                       sj >= 0 && sj < g.w;
      const int c = c0 + 4 * acq;
      const float* src =
          x + ((int64_t)apix[r] + du * g.w + dv) * g.cin + c;
      copy4<kVec>(a_dst + chunk_at(32 * r + arow, acq) / 4, src, x,
                  inb && (!kVec || c < g.cin), c, g.cin);
      bits |= (uint32_t)inb << r;
    }
    const float* wtap =
        wst + (((int64_t)p * g.kh + ld_u) * g.kw + ld_v) * g.cin * g.cout;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k = c0 + 4 * bc + r;
      const float* src = wtap + (int64_t)k * g.cout + bco;
      copy4<kVec>(b_dst + 4 * (r * kThreads + tid), src, wst,
                  k < g.cin && (!kVec || bco < g.cout), bco, g.cout);
    }
    const int slot = kt % 3;
    masks = (masks & ~(0xfu << (4 * slot))) | (bits << (4 * slot));
    if (++ld_cs == csteps) {
      ld_cs = 0;
      if (++ld_v == g.kw) {
        ld_v = 0;
        ++ld_u;
      }
    }
  };

  // stage kt's own chunks, once they have landed (the channel constants
  // are read while the copies finish): A's transform and halo in place,
  // then hi in place and lo beside it; B transposed to K-major hi and lo
  // tiles. Then visible to wgmma. Stage kt + 1's copies may still be in
  // flight.
  auto split_stage = [&](int kt) {
    uint8_t* a_hi = tile(kAHi + kt % 3);
    uint8_t* a_lo = tile(kALo + (kt & 1));
    const uint32_t bits = masks >> (4 * (kt % 3));
    const int c = (kt % csteps) * kStep + 4 * acq;
    float sc[4], sh[4], al[4];
    if (kTransform) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = c + q < g.cin;
        sc[q] = ok ? __ldg(tr.scale + c + q) : 0.0f;
        sh[q] = ok ? __ldg(tr.shift + c + q) : 0.0f;
        al[q] = ok ? __ldg(tr.alpha + c + q) : 0.0f;
      }
    }
    cp_async_wait<1>();             // this thread's copies of stage kt
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t off = chunk_at(32 * r + arow, acq);
      const float4 c4 = *reinterpret_cast<const float4*>(a_hi + off);
      float v[4] = {c4.x, c4.y, c4.z, c4.w};
      if (kTransform) {
        const bool inb = (bits >> r) & 1u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // prelu(x * scale + shift), rounded as the plain version's
          const float xt = v[q] * sc[q] + sh[q];
          v[q] = inb ? (xt >= 0.0f ? xt : al[q] * xt) : 0.0f;
        }
      }
      uint4 lo;
      *reinterpret_cast<uint4*>(a_hi + off) = split4(v, lo);
      *reinterpret_cast<uint4*>(a_lo + off) = lo;
    }
    const float4* b_raw =
        reinterpret_cast<const float4*>(tile(kBRaw + (kt & 1)));
    float bv[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 c4 = b_raw[r * kThreads + tid];
      bv[r][0] = c4.x;
      bv[r][1] = c4.y;
      bv[r][2] = c4.z;
      bv[r][3] = c4.w;
    }
    uint8_t* b_hi = tile(kBHi + (kt & 1));
    uint8_t* b_lo = tile(kBLo + (kt & 1));
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v[4] = {bv[0][q], bv[1][q], bv[2][q], bv[3][q]};
      uint4 lo;
      const uint4 hi = split4(v, lo);
      const uint32_t off = chunk_at(4 * bnq + q, bc);
      *reinterpret_cast<uint4*>(b_hi + off) = hi;
      *reinterpret_cast<uint4*>(b_lo + off) = lo;
    }
    fence_async_shared();
  };

  // warpgroup wg owns rows 64 wg .. +63 of the tile. acc holds one step's
  // 32 channels; sum adds the steps in f32.
  const int wg = tid >> 7;
  float acc[64], sum[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) sum[k] = 0.0f;

  // stages 0 and 1 in flight, stage 0 split; then per step: the copies
  // of stage kt + 2, the products of stage kt started (asynchronous), the
  // split of stage kt + 1 beside them, the wait for the products and
  // their sum, one barrier
  if (steps > 0) load_stage(0);
  cp_async_commit();
  if (steps > 1) load_stage(1);
  cp_async_commit();
  if (steps > 0) split_stage(0);
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    if (kt + 2 < steps) load_stage(kt + 2);
    cp_async_commit();
    const uint32_t a_hi = sbase + (kAHi + kt % 3) * kTile + wg * 64 * 128;
    const uint32_t a_lo = sbase + (kALo + (kt & 1)) * kTile + wg * 64 * 128;
    const uint32_t b_hi = sbase + (kBHi + (kt & 1)) * kTile;
    const uint32_t b_lo = sbase + (kBLo + (kt & 1)) * kTile;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {   // 8 channels each, 32 bytes a row
      wgmma_tf32(acc, tile_desc(a_lo + 32 * s), tile_desc(b_hi + 32 * s),
                 s == 0);
      wgmma_tf32(acc, tile_desc(a_hi + 32 * s), tile_desc(b_lo + 32 * s),
                 false);
      wgmma_tf32(acc, tile_desc(a_hi + 32 * s), tile_desc(b_hi + 32 * s),
                 false);
    }
    wgmma_commit();
    if (kt + 1 < steps) split_stage(kt + 1);
    wgmma_wait(acc);
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc[k];
    __syncthreads();                // stage kt + 1 split; kt's tiles free
  }
  cp_async_wait<0>();

  fwd_epilogue<kStats>(sum, bias, prelu, prelu_n, y, partial, smem, g, p,
                       co0, m0, mtile, threadIdx.x, false);
}

template <bool kTransform, bool kStats, bool kVec>
cudaError_t launch_fwd(const float* x, const float* wst, const float* bias,
                       const float* prelu, int prelu_n, Transform tr,
                       float* y, float* partial, const Geometry& g,
                       cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_fwd<kTransform, kStats, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, fwd::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = 4 * ceil_div(g.cout, fwd::kTileN) *
                         ceil_div((int64_t)g.n * g.h * g.w, fwd::kTileM);
  upsample_conv_fwd<kTransform, kStats, kVec>
      <<<(unsigned)blocks, fwd::kThreads, fwd::kSmemBytes, s>>>(
          x, wst, bias, prelu, prelu_n, tr, y, partial, g);
  return cudaGetLastError();
}

template <bool kTransform, bool kStats>
cudaError_t launch_fwd(bool vec, const float* x, const float* wst,
                       const float* bias, const float* prelu, int prelu_n,
                       Transform tr, float* y, float* partial,
                       const Geometry& g, cudaStream_t s) {
  return vec ? launch_fwd<kTransform, kStats, true>(
                   x, wst, bias, prelu, prelu_n, tr, y, partial, g, s)
             : launch_fwd<kTransform, kStats, false>(
                   x, wst, bias, prelu, prelu_n, tr, y, partial, g, s);
}

// The bf16 forward (catgen's bf16 compute dtype), the same design with
// one bf16 product in place of the 3xTF32 split:
//   * wgmma m64n128k16 bf16 with f32 accumulators; a step is one tap and
//     64 input channels, so a 128-byte swizzled row holds a step's
//     contraction as the f32 kernel's 32 channels do, and the 4 products of
//     a step advance 32 bytes a row as its k8 TF32 products do.
//   * Both operands land in place: A (x, NHWC) as in f32, and B from the
//     transposed parity stack (4, kh, kw, cout, cin) that the wrapper
//     makes, K-major as it lies. No split and no transposing pass. The
//     block's input transform is not applied here: its pass
//     (upsample_conv_prep.cu) writes xn once per element, rounded once as
//     catgen rounds the transformed block to x's dtype, and this kernel
//     reads xn as x, its zero-filled copies giving the halo's 0. (Applied
//     to each staged chunk, the transform would run once per parity, tap
//     and cout tile, 32-64 times per element, between a step's products.)
//   * Fresh accumulators each 64-deep step, the steps added in f32 (the
//     tensor cores' truncating adds, as in f32); bias and PReLU in f32 on
//     the sums, the statistics from the unrounded f32 values, y rounded
//     once (__float2bfloat16_rn). Bound: 2 * MACs / 989e12 s.
//   * Shared memory: A x 3 and B x 3 stages of 16 KB: 97 KB. 16-byte
//     copies need cin % 8 == 0 and cout % 8 == 0 and aligned arrays; other
//     shapes take 2-byte loads through registers (kVec = false).

namespace fwd16 {

constexpr int kTileM = kTilePixels;   // output pixels of one parity per block
constexpr int kTileN = 128;     // output channels per block
constexpr int kStep = 64;       // contraction per stage: 64 channels, 1 tap
constexpr int kThreads = 256;   // 2 warpgroups, 64 rows of the tile each
constexpr int kTile = kTileM * kStep * 2;     // bytes of one A or B tile
static_assert(kTileM == kTileN, "one tile size for A and B");
static_assert(kStep * 2 == 128, "a tile row is one 128-byte swizzle row");
constexpr int kA = 0, kB = 3;   // tiles: A x 3 stages, B x 3 stages
constexpr int kSmemBytes = 6 * kTile + 1024;    // + room to align
static_assert(kSmemBytes <= 232448, "over the H100's opt-in shared memory");
static_assert(kTileM == fwd::kTileM && kTileN == fwd::kTileN &&
              kThreads == fwd::kThreads, "fwd_epilogue's tile");

}  // namespace fwd16

// x (n, h, w, cin); wstt (4, kh, kw, cout, cin); y (n, 2h, 2w, cout), all
// bf16, as bias and prelu; partial (4 * m_tiles, 2, cout) f32 when
// kStats. Blocks in order parity, cout tile, pixel tile (fastest to
// slowest).
template <bool kStats, bool kVec>
__global__ void __launch_bounds__(fwd16::kThreads, 1)
upsample_conv_fwd_bf16(const bf16* __restrict__ x,
                       const bf16* __restrict__ wstt,
                       const bf16* __restrict__ bias,
                       const bf16* __restrict__ prelu, int prelu_n,
                       bf16* __restrict__ y, float* __restrict__ partial,
                       Geometry g) {
  using namespace fwd16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start at the first 1024-byte boundary (the swizzle's period)
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);
  auto tile = [&](int t) { return smem + t * kTile; };

  const int tid = threadIdx.x;
  const int co_tiles = (int)ceil_div(g.cout, kTileN);
  int b = blockIdx.x;
  const int p = b & 3;
  b >>= 2;
  const int co0 = (b % co_tiles) * kTileN;
  const int mtile = b / co_tiles;
  const int d = p >> 1, e = p & 1;
  const int hw = g.h * g.w;
  const int64_t m_total = (int64_t)g.n * hw;
  const int64_t m0 = (int64_t)mtile * kTileM;
  const int csteps = (g.cin + kStep - 1) / kStep;
  const int steps = g.kh * g.kw * csteps;

  // loaders: rows 32 r + (tid >> 3), chunk tid & 7 (channels 8 (tid & 7)
  // .. +7 of the step) of A (pixels) and of B (output channels)
  const int acq = tid & 7, arow = tid >> 3;
  int apix[4], ai[4], aj[4];
  uint32_t avalid = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int64_t m = m0 + 32 * r + arow;
    const bool ok = m < m_total;
    const int nn = ok ? (int)(m / hw) : 0;
    const int rem = ok ? (int)(m - (int64_t)nn * hw) : 0;
    ai[r] = rem / g.w;
    aj[r] = rem - ai[r] * g.w;
    apix[r] = ok ? (int)m : 0;      // (nn h + i) w + j
    avalid |= (uint32_t)ok << r;
  }

  int ld_u = 0, ld_v = 0, ld_cs = 0;   // the next stage to load

  auto load_stage = [&](int kt) {
    const int slot = kt % 3;
    bf16* a_dst = reinterpret_cast<bf16*>(tile(kA + slot));
    bf16* b_dst = reinterpret_cast<bf16*>(tile(kB + slot));
    const int c = ld_cs * kStep + 8 * acq;
    const int du = g.umin_h[d] + ld_u, dv = g.umin_w[e] + ld_v;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int si = ai[r] + du, sj = aj[r] + dv;
      const bool inb = ((avalid >> r) & 1u) && si >= 0 && si < g.h &&
                       sj >= 0 && sj < g.w;
      const bf16* src = x + ((int64_t)apix[r] + du * g.w + dv) * g.cin + c;
      copy8<kVec>(a_dst + chunk_at(32 * r + arow, acq) / 2, src, x,
                  inb && (!kVec || c < g.cin), c, g.cin);
    }
    const bf16* wtap =
        wstt + (((int64_t)p * g.kh + ld_u) * g.kw + ld_v) * g.cout * g.cin;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int co = co0 + 32 * r + arow;
      copy8<kVec>(b_dst + chunk_at(32 * r + arow, acq) / 2,
                  wtap + (int64_t)co * g.cin + c, wstt,
                  co < g.cout && (!kVec || c < g.cin), c, g.cin);
    }
    if (++ld_cs == csteps) {
      ld_cs = 0;
      if (++ld_v == g.kw) {
        ld_v = 0;
        ++ld_u;
      }
    }
  };

  // stage kt's own chunks, once they have landed, made visible to wgmma.
  // Stage kt + 1's copies may still be in flight.
  auto prepare_stage = [&]() {
    cp_async_wait<1>();             // this thread's copies of stage kt
    fence_async_shared();
  };

  // warpgroup wg owns rows 64 wg .. +63 of the tile. acc holds one step's
  // 64 channels; sum adds the steps in f32.
  const int wg = tid >> 7;
  float acc[64], sum[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) sum[k] = 0.0f;

  if (steps > 0) load_stage(0);
  cp_async_commit();
  if (steps > 1) load_stage(1);
  cp_async_commit();
  if (steps > 0) prepare_stage();
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    if (kt + 2 < steps) load_stage(kt + 2);
    cp_async_commit();
    const uint32_t a = sbase + (kA + kt % 3) * kTile + wg * 64 * 128;
    const uint32_t bt = sbase + (kB + kt % 3) * kTile;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s) {   // 16 channels each, 32 bytes a row
      wgmma_bf16(acc, tile_desc(a + 32 * s), tile_desc(bt + 32 * s), s == 0);
    }
    wgmma_commit();
    if (kt + 1 < steps) prepare_stage();
    wgmma_wait(acc);
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc[k];
    __syncthreads();                // stage kt + 1 ready; kt's tiles free
  }
  cp_async_wait<0>();

  fwd_epilogue<kStats>(sum, bias, prelu, prelu_n, y, partial, smem, g, p,
                       co0, m0, mtile, threadIdx.x, false);
}

template <bool kStats, bool kVec>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* wstt,
                            const bf16* bias, const bf16* prelu, int prelu_n,
                            bf16* y, float* partial, const Geometry& g,
                            cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_fwd_bf16<kStats, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, fwd16::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = 4 * ceil_div(g.cout, fwd16::kTileN) *
                         ceil_div((int64_t)g.n * g.h * g.w, fwd16::kTileM);
  upsample_conv_fwd_bf16<kStats, kVec>
      <<<(unsigned)blocks, fwd16::kThreads, fwd16::kSmemBytes, s>>>(
          x, wstt, bias, prelu, prelu_n, y, partial, g);
  return cudaGetLastError();
}

template <bool kStats>
cudaError_t launch_fwd_bf16(bool vec, const bf16* x, const bf16* wstt,
                            const bf16* bias, const bf16* prelu, int prelu_n,
                            bf16* y, float* partial, const Geometry& g,
                            cudaStream_t s) {
  return vec ? launch_fwd_bf16<kStats, true>(x, wstt, bias, prelu, prelu_n,
                                             y, partial, g, s)
             : launch_fwd_bf16<kStats, false>(x, wstt, bias, prelu, prelu_n,
                                              y, partial, g, s);
}

// The bf16 forward, warp-specialised (upsample_conv_fwd_bf16_tma), for
// the shapes whose 128-pixel tiles are boxes of x: the same blocks, steps,
// products and epilogue as upsample_conv_fwd_bf16, so y and the
// statistics keep its bits, with a main loop that keeps the tensor cores
// fed:
//   * one producer thread issues every copy: per step one TMA box of x
//     (a 4-D map over (cin, w, h, n), box (64, w_b, h_b, n_b) = the tile's
//     128 pixels in its row order, the tap's offset in the coordinates; the
//     zeros TMA reads past an edge, negative coordinates included, are the
//     conv's zero halo) and one of the transposed parity stack (a 2-D map
//     over (4 kh kw cout, cin), box (64, 128)), both in the 128-byte swizzle
//     that tile_desc describes. No consumer thread computes an address or
//     tests a halo;
//   * a ring of kStages stages (32 KB each) with a full and an empty
//     mbarrier per stage: a stage is refilled as soon as both consumer
//     warpgroups have retired its products, so copies run up to kStages - 2
//     steps ahead;
//   * two consumer warpgroups (setmaxnreg: 232 registers each, the
//     producer's warpgroup 40), each 64 pixels x 128 output channels, take
//     the steps in pairs on two accumulator banks: both steps' products
//     are queued before the first's are added into sum, so the second's run
//     under that sum; both banks are retired before the loop turns (a bank
//     in flight across the back edge made ptxas serialise every wgmma,
//     upsample_conv_bwd.cu's bf16 dX). The two warpgroups run apart,
//     meeting only at the empty barriers, so one's sums run under the
//     other's products;
//   * fresh accumulators every 64-deep step, added into sum in step order
//     (tap u, tap v, channel step): the one-bank kernel's bits.
// What is left: with one block per SM (the ring and the registers fill
// it) its prologue and epilogue run alone, and a variant without the
// epilogue and the step sums ran markedly faster. Tried and slower: y
// staged in shared memory for 16-byte stores; clusters of two blocks that
// share x's or the weights' box by TMA multicast (24 KB a step from L2 in
// place of 32), so L2 does not bound it; one warpgroup a step behind the
// other (a divergent path before the products: ptxas serialised every
// wgmma, C7520).
// The maps are encoded on the host per call (cuTensorMapEncodeTiled, found
// through the runtime's driver entry point, so the library links against
// the runtime alone) and passed as __grid_constant__ parameters.

namespace fwdt {

constexpr int kStages = 6;                 // ring depth
constexpr int kTile = fwd16::kTile;        // 16 KB: A or B of one step
constexpr int kStageBytes = 2 * kTile;
constexpr int kThreads = 384;              // producer + 2 consumer warpgroups
constexpr int kConsumerWarps = 8;
constexpr int kRing = kStages * kStageBytes;
// ring, full and empty barriers, + room to align
constexpr int kSmemBytes = kRing + 2 * kStages * 8 + 1024;
static_assert(kSmemBytes <= 232448, "over the H100's opt-in shared memory");
static_assert(fwd::kThreads / 32 * 2 * fwd::kTileN * 4 <= kRing,
              "fwd_epilogue's sums fit the ring");

}  // namespace fwdt

// One step's products for consumer warpgroup cwg into fresh accumulators
// d, from ring stage `stage` (A, then B): 4 wgmma of 16 channels (32 bytes
// a row), one commit group.
__device__ __forceinline__ void fwd16_products(float (&d)[64], uint32_t stage,
                                               int cwg) {
  const uint32_t a = stage + cwg * 64 * 128, bt = stage + fwdt::kTile;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma_bf16(d, tile_desc(a + 32 * s), tile_desc(bt + 32 * s), s == 0);
  }
  wgmma_commit();
}

// xmap over x (n, h, w, cin) and wmap over wstt (4, kh, kw, cout, cin) as
// above; y, partial and the blocks' order as upsample_conv_fwd_bf16's.
template <bool kStats>
__global__ void __launch_bounds__(fwdt::kThreads, 1)
upsample_conv_fwd_bf16_tma(const __grid_constant__ CUtensorMap xmap,
                           const __grid_constant__ CUtensorMap wmap,
                           const bf16* __restrict__ bias,
                           const bf16* __restrict__ prelu, int prelu_n,
                           bf16* __restrict__ y, float* __restrict__ partial,
                           Geometry g) {
  using namespace fwdt;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the stages start at the first 1024-byte boundary (the swizzle's period)
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kRing);
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x;
  const int co_tiles = (int)ceil_div(g.cout, fwd16::kTileN);
  int b = blockIdx.x;
  const int p = b & 3;
  b >>= 2;
  const int co0 = (b % co_tiles) * fwd16::kTileN;
  const int mtile = b / co_tiles;
  const int hw = g.h * g.w;
  const int64_t m0 = (int64_t)mtile * fwd16::kTileM;
  const int steps = g.kh * g.kw * (g.cin / fwd16::kStep);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumerWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {                  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (tid == 0) {
      // the tile's first pixel: sample n0, row i0, column j0 (a box)
      const int n0 = (int)(m0 / hw);
      const int rem = (int)(m0 - (int64_t)n0 * hw);
      const int i0 = rem / g.w, j0 = rem - (rem / g.w) * g.w;
      const int d = p >> 1, e = p & 1;
      const int csteps = g.cin / fwd16::kStep;
      int u = 0, v = 0, cs = 0;
      for (int kt = 0; kt < steps; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(empty + s, ((kt / kStages) - 1) & 1);
        uint8_t* stage = smem + s * kStageBytes;
        mbar_expect_tx(full + s, kStageBytes);
        tma_load_4d(stage, &xmap, full + s, cs * fwd16::kStep,
                    j0 + g.umin_w[e] + v, i0 + g.umin_h[d] + u, n0);
        tma_load_2d(stage + kTile, &wmap, full + s, cs * fwd16::kStep,
                    ((p * g.kh + u) * g.kw + v) * g.cout + co0);
        if (++cs == csteps) {
          cs = 0;
          if (++v == g.kw) {
            v = 0;
            ++u;
          }
        }
      }
    }
    return;
  }

  setmaxnreg_inc<232>();
  const int ctid = tid - 128, cwg = ctid >> 7;
  const bool signals = (ctid & 31) == 0;   // one arrival per consumer warp
  float acc0[64], acc1[64], sum[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) sum[k] = 0.0f;

  int kt = 0;
#pragma unroll 1
  for (; kt + 1 < steps; kt += 2) {
    const int s0 = kt % kStages, s1 = (kt + 1) % kStages;
    mbar_wait(full + s0, (kt / kStages) & 1);
    wgmma_fence();
    fwd16_products(acc0, sbase + s0 * kStageBytes, cwg);
    mbar_wait(full + s1, ((kt + 1) / kStages) & 1);
    fwd16_products(acc1, sbase + s1 * kStageBytes, cwg);
    wgmma_wait<1>(acc0);            // step kt's products
    if (signals) mbar_arrive(empty + s0);
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc0[k];
    wgmma_wait<0>(acc1);            // step kt + 1's
    if (signals) mbar_arrive(empty + s1);
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc1[k];
  }
  if (kt < steps) {                 // an odd step count's last step
    const int s0 = kt % kStages;
    mbar_wait(full + s0, (kt / kStages) & 1);
    wgmma_fence();
    fwd16_products(acc0, sbase + s0 * kStageBytes, cwg);
    wgmma_wait<0>(acc0);
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc0[k];
  }
  named_barrier(1, 2 * 128);        // both warpgroups are done with the ring

  fwd_epilogue<kStats>(sum, bias, prelu, prelu_n, y, partial, smem, g, p,
                       co0, m0, mtile, ctid, true);
}

// cuTensorMapEncodeTiled, reached through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault);
    q = cudaDriverEntryPointSuccess;
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess &&
        p != nullptr) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A bf16 tensor map of `rank` dims (innermost first, sizes in elements,
// strides of dims 1.. in bytes) with the 128-byte swizzle and zero fill
static bool encode_bf16(CUtensorMap* map, const void* base, int rank,
                        const cuuint64_t* dims, const cuuint64_t* strides,
                        const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank,
            const_cast<void*>(base), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool kStats>
cudaError_t launch_fwd_bf16_tma(const bf16* x, const bf16* wstt,
                                const bf16* bias, const bf16* prelu,
                                int prelu_n, bf16* y, float* partial,
                                const Geometry& g, int box_w, int box_h,
                                int box_n, cudaStream_t s) {
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)g.cin, (cuuint64_t)g.w,
                               (cuuint64_t)g.h, (cuuint64_t)g.n};
  const cuuint64_t xstrides[3] = {
      (cuuint64_t)g.cin * 2, (cuuint64_t)g.w * g.cin * 2,
      (cuuint64_t)g.h * g.w * g.cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)fwd16::kStep, (cuuint32_t)box_w,
                              (cuuint32_t)box_h, (cuuint32_t)box_n};
  const cuuint64_t wdims[2] = {(cuuint64_t)g.cin,
                               (cuuint64_t)4 * g.kh * g.kw * g.cout};
  const cuuint64_t wstrides[1] = {(cuuint64_t)g.cin * 2};
  const cuuint32_t wbox[2] = {(cuuint32_t)fwd16::kStep,
                              (cuuint32_t)fwd16::kTileN};
  if (!encode_bf16(&xmap, x, 4, xdims, xstrides, xbox) ||
      !encode_bf16(&wmap, wstt, 2, wdims, wstrides, wbox)) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_fwd_bf16_tma<kStats>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, fwdt::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = 4 * ceil_div(g.cout, fwd16::kTileN) *
                         ceil_div((int64_t)g.n * g.h * g.w, fwd16::kTileM);
  upsample_conv_fwd_bf16_tma<kStats>
      <<<(unsigned)blocks, fwdt::kThreads, fwdt::kSmemBytes, s>>>(
          xmap, wmap, bias, prelu, prelu_n, y, partial, g);
  return cudaGetLastError();
}

// A box (w_b, h_b, n_b) of x that holds a 128-pixel tile in its row
// order: the rule of fused_upsample_conv.py::fwd_bf16_box, which the
// launcher checks the caller's box against
static bool tma_box_ok(const Geometry& g, int bw, int bh, int bn) {
  const int hw = g.h * g.w;
  if (g.cin % fwd16::kStep != 0 || bw * bh * bn != fwd16::kTileM) {
    return false;
  }
  if (bh == 1 && bn == 1) return g.w % bw == 0;           // within a row
  if (bn == 1) return bw == g.w && hw % fwd16::kTileM == 0;   // rows
  return bw == g.w && bh == g.h;                           // whole images
}

}  // namespace

// Rows of per-block partial sums the forward (per parity) and dX write for
// an input of n x h x w pixels: one per tile of kTilePixels pixels.
extern "C" int catgen_upsample_conv_partial_rows(int n, int h, int w) {
  return (int)ceil_div((int64_t)n * h * w, kTilePixels);
}

// The forward. x (n, h, w, cin) and wst (4, kh, kw, cin, cout), the
// collapsed parity kernels, are required; bias (cout), prelu (prelu_n
// slopes: 1 or cout) and the input transform tscale / tshift / talpha
// (cin each) may be null. With stats non-null, partial holds
// (4 * partial_rows, 2, cout) floats of scratch and stats receives
// [sum y, sum y^2] as (2, cout). Pixel indices are 32-bit: n * h * w must
// stay below 2^31. Launches on `stream`, allocates nothing, returns
// cudaGetLastError() (0 = accepted).
extern "C" int catgen_upsample_conv_fwd_f32(
    const float* x, const float* wst, const float* bias, const float* prelu,
    int prelu_n, const float* tscale, const float* tshift,
    const float* talpha, float* y, float* partial, float* stats, int n,
    int h, int w, int cin, int cout, int kh, int kw, int uh0, int uh1,
    int uw0, int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout == 0) return 0;
  if ((int64_t)n * h * w == 0) {    // no pixels: sums of nothing
    return stats == nullptr ? 0
                            : (int)cudaMemsetAsync(
                                  stats, 0, sizeof(float) * 2 * cout, s);
  }
  if ((int64_t)n * h * w >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const Transform tr = {tscale, tshift, talpha};
  const bool with_stats = stats != nullptr;
  // 16-byte copies where every row of x and wst starts 16-byte aligned
  const bool vec = cin % 4 == 0 && cout % 4 == 0 && aligned16(x) &&
                   aligned16(wst);
  cudaError_t err;
  if (tscale != nullptr) {
    err = with_stats
              ? launch_fwd<true, true>(vec, x, wst, bias, prelu, prelu_n, tr,
                                       y, partial, g, s)
              : launch_fwd<true, false>(vec, x, wst, bias, prelu, prelu_n,
                                        tr, y, partial, g, s);
  } else {
    err = with_stats
              ? launch_fwd<false, true>(vec, x, wst, bias, prelu, prelu_n, tr,
                                        y, partial, g, s)
              : launch_fwd<false, false>(vec, x, wst, bias, prelu, prelu_n,
                                         tr, y, partial, g, s);
  }
  if (err != cudaSuccess || !with_stats) return (int)err;
  const int rows = 4 * catgen_upsample_conv_partial_rows(n, h, w);
  return (int)launch_sum_rows(partial, stats, rows, 2 * (int64_t)cout, s);
}

// The bf16 forward: the f32 entry's arguments but the input transform
// (the block's runs first as its own pass, upsample_conv_prep.cu), with
// bf16 x, bias, prelu and y, and wstt (4, kh, kw, cout, cin), the parity
// stack transposed; partial and stats stay f32. (box_w, box_h, box_n):
// the box of x that the warp-specialised kernel loads a tile as
// (fused_upsample_conv.py::fwd_bf16_box, from the shape and x's
// alignment), or (0, 0, 0) for upsample_conv_fwd_bf16; a box that does not
// hold a tile, or an unaligned x or wstt with one, is refused.
extern "C" int catgen_upsample_conv_fwd_bf16(
    const bf16* x, const bf16* wstt, const bf16* bias, const bf16* prelu,
    int prelu_n, bf16* y, float* partial, float* stats, int n, int h, int w,
    int cin, int cout, int kh, int kw, int uh0, int uh1, int uw0, int uw1,
    int box_w, int box_h, int box_n, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cout == 0) return 0;
  if ((int64_t)n * h * w == 0) {    // no pixels: sums of nothing
    return stats == nullptr ? 0
                            : (int)cudaMemsetAsync(
                                  stats, 0, sizeof(float) * 2 * cout, s);
  }
  if ((int64_t)n * h * w >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry g =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const bool with_stats = stats != nullptr;
  cudaError_t err;
  if (box_w != 0) {
    if (!tma_box_ok(g, box_w, box_h, box_n) || x == nullptr ||
        !aligned16(x) || !aligned16(wstt)) {
      return (int)cudaErrorInvalidValue;
    }
    err = with_stats
              ? launch_fwd_bf16_tma<true>(x, wstt, bias, prelu, prelu_n, y,
                                          partial, g, box_w, box_h, box_n, s)
              : launch_fwd_bf16_tma<false>(x, wstt, bias, prelu, prelu_n, y,
                                           partial, g, box_w, box_h, box_n,
                                           s);
  } else {
    // 16-byte copies where every row of x and wstt starts 16-byte aligned
    const bool vec = cin % 8 == 0 && cout % 8 == 0 && aligned16(x) &&
                     aligned16(wstt);
    err = with_stats ? launch_fwd_bf16<true>(vec, x, wstt, bias, prelu,
                                             prelu_n, y, partial, g, s)
                     : launch_fwd_bf16<false>(vec, x, wstt, bias, prelu,
                                              prelu_n, y, partial, g, s);
  }
  if (err != cudaSuccess || !with_stats) return (int)err;
  const int rows = 4 * catgen_upsample_conv_partial_rows(n, h, w);
  return (int)launch_sum_rows(partial, stats, rows, 2 * (int64_t)cout, s);
}
