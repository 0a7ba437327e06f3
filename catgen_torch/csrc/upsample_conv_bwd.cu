// Backward of the upsample-conv (upsample_conv.cu): the gradient with
// respect to the input (dX) and to the collapsed parity kernels (dCK), for
// both TPU forms.
//
// Replaces the TPU kernels of catgen/kernels/pallas_upsample_conv_bwd.py:
//   * upsample2_conv_backward: _dx_kernel (dX) and _dw_kernel (dCK);
//   * fused_block_backward: _fused_block_bwd_kernel, here as the same two
//     kernels with flags: in f32 the cotangent fold g = gy + gs1 + 2 y gs2
//     on load, the input transform recomputed from x (dCK reads xn, zero
//     outside the image), the transform's backward in dX's epilogue (dx,
//     and per-channel dscale, dshift, dalpha), and dbias from dCK's pass.
//     In bf16 the fold (with dbias) runs once per element in
//     upsample_conv_prep.cu and both kernels read its output, as catgen
//     folds g once for both products; dCK reads the transform pass's xn
//     too, and dX keeps the transform's backward in its epilogue.
// The dCK -> dW chain through the collapse matrices, and the per-layer
// form's dbias (a sum of g), stay in the PyTorch wrapper, as catgen keeps
// them outside its pallas_calls.
//
// dX[n, q, r, c] = sum_{d, e, u, v, co} ck[d, e, u, v, c, co] *
//     g[n, 2 (q - umin_h[d] - u) + d, 2 (r - umin_w[e] - v) + e, co]
// (terms whose source pixel lies outside the image drop out): an implicit
// GEMM of (n h w pixels) x (4 kh kw cout) by (4 kh kw cout) x (cin), the
// forward's shape with cin and cout swapped.
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
// dX (upsample_conv_dx below) replaces _dx_kernel and the dX part of
// _fused_block_bwd_kernel. What bounds it: multiply-adds, the forward's
// (43 / 86 / 193 GMAC at G32up-c's stages at batch 640). It is the
// forward's 3xTF32 wgmma design (upsample_conv.cu), and what differs:
//   * A step is one (parity, tap) pair and 32 output channels: A, the 128
//     pixels' g at their source pixels (n, 2 (q - umin_h[d] - u) + d,
//     2 (r - umin_w[e] - v) + e), 128 contiguous bytes of NHWC g each, and
//     B, the matching 32 output channels of 128 input-channel rows of the
//     parity stack (4, kh, kw, cin, cout), whose rows hold cout
//     contiguously: B is K-major as it lies, so both operands' 16-byte
//     copies land in place and no transposing pass is needed (the forward
//     stores its B transposed). A source pixel outside the image is a
//     zero-filled copy.
//   * With the fold, y is staged in a tile of its own beside g, and the
//     split computes (gy + gs1) + (2 y) gs2, in the plain version's order,
//     and masks the halo after it: 0 outside the image, not the fold of 0
//     (gs1 makes that nonzero).
//   * The epilogue writes dx from the step sums (NHWC, cin contiguous);
//     with the transform it reads x at its pixels and writes the
//     transform's backward, and the column sums of dscale, dshift and
//     dalpha go as the forward's statistics: a fixed butterfly over the
//     rows of each warp, the 8 warps in order, one partial row per block,
//     added by sum_rows.
//   * Shared memory: A hi x 3, A lo x 2, B hi x 3, B lo x 2, and y x 2
//     with the fold: 160 KB or 192 KB, one block of 8 warps per SM. Blocks
//     are ordered cin tile, pixel tile (fastest to slowest), so the tiles
//     of one pixel tile share its g in L2. G32up-c's stages give 320 /
//     1280 / 2560 blocks (stage 1 fills 2.4 waves of 132: 81%).
//
// dCK (upsample_conv_dck below) replaces _dw_kernel and the dCK part of
// _fused_block_bwd_kernel. The TPU kernel holds a block of x in VMEM and
// slices it for every parity and tap against one plane of g, so each
// byte comes from HBM once. Here one block owns one (parity, tap, 128 cin
// x 128 cout) tile and one pixel range; the blocks that share a range run
// in the same wave (the grid's fastest index is the tap, then the cout
// and cin tiles), so the taps' and tiles' re-reads of x and g hit L2.
//
// What bounds dCK: multiply-adds. f32 on the CUDA cores gives 67 TFLOP/s,
// and cuDNN's f32 wgrad comes within ~88% of that. The tensor cores run
// TF32 at 495 TFLOP/s, but TF32 keeps 10 mantissa bits (one TF32 product
// misses the 1e-4 bound on dW), so the kernel runs 3xTF32: each f32
// operand is split in registers into hi = rna(a) and lo = rna(a - hi),
// TF32 rounded to nearest (rna_tf32, upsample_conv_tile.cuh), and
// lo*hi + hi*lo + hi*hi (CUTLASS's order) is
// accumulated in f32 by mma.sync.m16n8k8 TF32: three tensor-core products
// per f32 product, a bound of 3 * 2 * MACs / 495e12 s. lo*lo and the
// rounding of lo leave ~2^-22 of each product. The tensor cores add into
// their accumulators with truncation, whose bias grows with the length
// of the sum, so each 32-pixel step starts fresh accumulators and the
// steps are added in f32, rounding to nearest.
//
// The design, against that bound:
//   * mma.sync, where each thread loads its own fragment elements from
//     shared memory, so the split (and the transform and fold) happen
//     wherever the data is, whatever its layout. wgmma reads TF32
//     operands K-major from shared memory, and the contraction here runs
//     over pixels while x and g are pixel-major: each stage would need a
//     transposing, swizzled conversion pass first. That is the next step
//     if this kernel stays above cuDNN.
//   * a ring of kStages stages in dynamic shared memory, filled by 16-byte
//     cp.async copies that zero-fill rows outside the image or the range;
//     the product of one 32-pixel step overlaps the copies of the next
//     three, with one __syncthreads per step. Channel counts that are not
//     multiples of 4, or unaligned arrays, take 4-byte copies per element
//     (kVec = false), in the same kernel.
//   * each thread copies four consecutive pixel rows of one 4-channel
//     column of each tile; the rows' (n, i, j) advance by increments (no
//     division in the loop) and address by 32-bit pixel indices.
//   * the input transform and the cotangent fold run once per staged
//     element, by the thread that copied it, as soon as its copies land,
//     with the channel constants in registers. The rows' masks go with
//     them: a halo pixel is 0 after the transform (prelu(shift) is not 0)
//     and a row past the range folds to 0.
//   * 8 warps of 64 x 32 (4 x 4 fragments of m16n8); the block's partial
//     is stored once; splits, partials and sum_rows keep it deterministic,
//     and the fold's bias sums go the same way (db_partial).

#include <cuda_runtime.h>
#include <stdint.h>

#include "upsample_conv_tile.cuh"

namespace {

using namespace upconv;

namespace dxk {

constexpr int kTileM = kTilePixels;   // input pixels per block
constexpr int kTileN = 128;     // input channels per block
constexpr int kStep = 32;       // contraction per stage: 32 output channels
constexpr int kThreads = 256;   // 2 warpgroups, 64 rows of the tile each
constexpr int kTile = kTileM * kStep * 4;     // bytes of one A or B tile
static_assert(kTileM == kTileN, "one loader layout for A and B");
static_assert(kStep * 4 == 128, "a tile row is one 128-byte swizzle row");
// Shared memory, in tiles of kTile bytes, 1024-aligned: A hi (and the raw
// g it replaces) x 3 stages, A lo x 2, B hi (and its raw copy) x 3, B lo
// x 2, and with the fold y's raw copy x 2
constexpr int kAHi = 0, kALo = 3, kBHi = 5, kBLo = 8, kY = 10;
__host__ __device__ constexpr int smem_bytes(bool fold) {
  return (fold ? 12 : 10) * kTile + 1024;     // + room to align
}
static_assert(smem_bytes(true) <= 232448,
              "over the H100's opt-in shared memory");

}  // namespace dxk

// dX's epilogue, for both element types T: dx from the step sums, and
// with the transform its backward and the column sums of dscale, dshift
// and dalpha. Thread (g, t) of warp w of warpgroup wg holds rows 16 w + g
// and 16 w + g + 8 of the warpgroup's 64, columns 2t, 2t+1 of each
// 8-column group: sum[4 j + 2 half + q]. The sums go as the forward's
// statistics: the 8 rows of a warp in a fixed butterfly, the 8 warps in
// order, one partial row per block (`smem`, the free A tiles, holds the
// warps' sums: (8 warps, 3, 128)).
template <bool kTransform, class T>
__device__ __forceinline__ void dx_epilogue(
    const float (&sum)[64], const T* __restrict__ x, TransformT<T> tr,
    T* __restrict__ dx, float* __restrict__ partial, uint8_t* smem,
    const Geometry& gm, int c0, int m0, int mtile) {
  constexpr int kTileN = dxk::kTileN, kThreads = dxk::kThreads;
  const int tid = threadIdx.x, wg = tid >> 7;
  const int m_total = gm.n * gm.h * gm.w;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const int warp = tid >> 5;
  const int wrow = wg * 64 + (warp & 3) * 16;
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = c0 + 8 * j + 2 * tig;
    float sc[2], sh[2], al[2];
    float dsc[2] = {0.0f, 0.0f}, dsh[2] = {0.0f, 0.0f}, dal[2] = {0.0f, 0.0f};
    if (kTransform) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const bool ok = c + q < gm.cin;
        sc[q] = ok ? ldf(tr.scale + c + q) : 0.0f;
        sh[q] = ok ? ldf(tr.shift + c + q) : 0.0f;
        al[q] = ok ? ldf(tr.alpha + c + q) : 0.0f;
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int m = m0 + wrow + gid + 8 * hf;
      if (m >= m_total) continue;
      const int64_t idx = (int64_t)m * gm.cin + c;
      float val[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const float dxn = sum[4 * j + 2 * hf + q];
        val[q] = dxn;
        if (kTransform && c + q < gm.cin) {
          // the transform's backward, as the plain version's:
          // xt = x * scale + shift; xn = xt >= 0 ? xt : alpha * xt
          const float xv = ldf(x + idx + q);
          const float xt = xv * sc[q] + sh[q];
          const bool pos = xt >= 0.0f;
          const float dxt = pos ? dxn : dxn * al[q];
          val[q] = dxt * sc[q];
          dsc[q] += dxt * xv;
          dsh[q] += dxt;
          dal[q] += pos ? 0.0f : dxn * xt;
        }
      }
      if (c + 1 < gm.cin && (gm.cin & 1) == 0) {
        store_pair(dx + idx, val[0], val[1]);
      } else if (c < gm.cin) {
        store_one(dx + idx, val[0]);
        if (c + 1 < gm.cin) store_one(dx + idx + 1, val[1]);
      }
    }
    if (kTransform) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          dsc[q] += __shfl_xor_sync(0xffffffffu, dsc[q], off);
          dsh[q] += __shfl_xor_sync(0xffffffffu, dsh[q], off);
          dal[q] += __shfl_xor_sync(0xffffffffu, dal[q], off);
        }
        if (gid == 0) {
          const int col = 8 * j + 2 * tig + q;
          red[(warp * 3 + 0) * kTileN + col] = dsc[q];
          red[(warp * 3 + 1) * kTileN + col] = dsh[q];
          red[(warp * 3 + 2) * kTileN + col] = dal[q];
        }
      }
    }
  }
  if (kTransform) {
    __syncthreads();
    if (tid < kTileN && c0 + tid < gm.cin) {
      float* dst = partial + (int64_t)mtile * 3 * gm.cin + c0 + tid;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float t = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) {
          t += red[(w * 3 + k) * kTileN + tid];
        }
        dst[k * gm.cin] = t;
      }
    }
  }
}

// g (n, 2h, 2w, cout) (+ fold, y the same); wst (4, kh, kw, cin, cout);
// dx (n, h, w, cin). With kTransform: x (n, h, w, cin), tr, and partial
// (m_tiles, 3, cin) receives each block's [dscale, dshift, dalpha] column
// sums. Blocks in order cin tile, pixel tile (fastest to slowest).
template <bool kFold, bool kTransform, bool kVec>
__global__ void __launch_bounds__(dxk::kThreads, 1)
upsample_conv_dx(const float* __restrict__ g, Fold fold,
                 const float* __restrict__ wst, const float* __restrict__ x,
                 Transform tr, float* __restrict__ dx,
                 float* __restrict__ partial, Geometry gm) {
  using namespace dxk;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start at the first 1024-byte boundary (the swizzle's period)
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);
  auto tile = [&](int t) { return smem + t * kTile; };

  const int tid = threadIdx.x;
  const int ci_tiles = (int)ceil_div(gm.cin, kTileN);
  const int c0 = (blockIdx.x % ci_tiles) * kTileN;
  const int mtile = blockIdx.x / ci_tiles;
  const int hw = gm.h * gm.w;
  const int m_total = gm.n * hw;          // the launcher checks < 2^31
  const int m0 = mtile * kTileM;
  const int csteps = (gm.cout + kStep - 1) / kStep;
  const int steps = 4 * gm.kh * gm.kw * csteps;

  // loaders: rows 32 r + (tid >> 3), chunk tid & 7 (output channels
  // 4 (tid & 7) .. +3 of the step) of A and of B; A's rows' pixels are
  // decoded once, as g's pixel index of (n, 0, 0) and (q, r)
  const int acq = tid & 7, arow = tid >> 3;
  int gbase[4], ai[4], aj[4];
  uint32_t avalid = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 32 * r + arow;
    const bool ok = m < m_total;
    const int nn = ok ? m / hw : 0;
    const int rem = ok ? m - nn * hw : 0;
    ai[r] = rem / gm.w;
    aj[r] = rem - ai[r] * gm.w;
    gbase[r] = nn * 4 * hw;
    avalid |= (uint32_t)ok << r;
  }

  uint32_t masks = 0;               // per A slot: 4 halo bits of A rows
  int ld_p = 0, ld_u = 0, ld_v = 0, ld_cs = 0;   // the next stage to load

  auto load_stage = [&](int kt) {
    const int slot = kt % 3;
    float* a_dst = reinterpret_cast<float*>(tile(kAHi + slot));
    float* b_dst = reinterpret_cast<float*>(tile(kBHi + slot));
    float* y_dst = reinterpret_cast<float*>(tile(kY + (kt & 1)));
    const int d = ld_p >> 1, e = ld_p & 1;
    const int co = ld_cs * kStep + 4 * acq;
    const int oh = gm.umin_h[d] + ld_u, ow = gm.umin_w[e] + ld_v;
    uint32_t bits = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int si = ai[r] - oh, sj = aj[r] - ow;
      const bool inb = ((avalid >> r) & 1u) && si >= 0 && si < gm.h &&
                       sj >= 0 && sj < gm.w;
      const int gpix = gbase[r] + (2 * si + d) * 2 * gm.w + 2 * sj + e;
      const int64_t off = (int64_t)gpix * gm.cout + co;
      const bool ok = inb && (!kVec || co < gm.cout);
      const uint32_t at = chunk_at(32 * r + arow, acq) / 4;
      copy4<kVec>(a_dst + at, g + off, g, ok, co, gm.cout);
      if (kFold) copy4<kVec>(y_dst + at, fold.y + off, fold.y, ok, co, gm.cout);
      bits |= (uint32_t)inb << r;
    }
    const float* wtap =
        wst + (((int64_t)ld_p * gm.kh + ld_u) * gm.kw + ld_v) * gm.cin *
                  gm.cout;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + 32 * r + arow;
      copy4<kVec>(b_dst + chunk_at(32 * r + arow, acq) / 4,
                  wtap + (int64_t)c * gm.cout + co, wst,
                  c < gm.cin && (!kVec || co < gm.cout), co, gm.cout);
    }
    masks = (masks & ~(0xfu << (4 * slot))) | (bits << (4 * slot));
    if (++ld_cs == csteps) {
      ld_cs = 0;
      if (++ld_v == gm.kw) {
        ld_v = 0;
        if (++ld_u == gm.kh) {
          ld_u = 0;
          ++ld_p;
        }
      }
    }
  };

  // stage kt's own chunks, once they have landed (the fold's constants are
  // read while the copies finish): A's fold and halo mask in place, then
  // each of A and B split, hi in place and lo beside it. Then visible to
  // wgmma. Stage kt + 1's copies may still be in flight.
  auto split_stage = [&](int kt) {
    const int slot = kt % 3;
    uint8_t* a_hi = tile(kAHi + slot);
    uint8_t* a_lo = tile(kALo + (kt & 1));
    uint8_t* b_hi = tile(kBHi + slot);
    uint8_t* b_lo = tile(kBLo + (kt & 1));
    const uint8_t* ys = tile(kY + (kt & 1));
    const uint32_t bits = masks >> (4 * slot);
    const int co = (kt % csteps) * kStep + 4 * acq;
    float s1[4], s2[4];
    if (kFold) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool ok = co + q < gm.cout;
        s1[q] = ok ? __ldg(fold.gs + co + q) : 0.0f;
        s2[q] = ok ? __ldg(fold.gs + gm.cout + co + q) : 0.0f;
      }
    }
    cp_async_wait<1>();             // this thread's copies of stage kt
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t off = chunk_at(32 * r + arow, acq);
      const float4 c4 = *reinterpret_cast<const float4*>(a_hi + off);
      float v[4] = {c4.x, c4.y, c4.z, c4.w};
      if (kFold) {
        const float4 y4 = *reinterpret_cast<const float4*>(ys + off);
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
        const bool inb = (bits >> r) & 1u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          // (gy + gs1) + (2 y) gs2, in the plain version's order; 0 in
          // the halo after the fold
          const float t = (2.0f * yv[q]) * s2[q];
          v[q] = inb ? (v[q] + s1[q]) + t : 0.0f;
        }
      }
      uint4 lo;
      *reinterpret_cast<uint4*>(a_hi + off) = split4(v, lo);
      *reinterpret_cast<uint4*>(a_lo + off) = lo;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint32_t off = chunk_at(32 * r + arow, acq);
      const float4 c4 = *reinterpret_cast<const float4*>(b_hi + off);
      const float v[4] = {c4.x, c4.y, c4.z, c4.w};
      uint4 lo;
      *reinterpret_cast<uint4*>(b_hi + off) = split4(v, lo);
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

  // the forward's pipeline: stages 0 and 1 in flight, stage 0 split; then
  // per step the copies of stage kt + 2, the products of stage kt
  // (asynchronous), the split of stage kt + 1 beside them, the wait and
  // the step's sum, one barrier
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
    const uint32_t b_hi = sbase + (kBHi + kt % 3) * kTile;
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

  dx_epilogue<kTransform>(sum, x, tr, dx, partial, smem, gm, c0, m0, mtile);
}

namespace dck {

constexpr int kTileCin = 128;    // tile rows: input channels
constexpr int kTileCout = 128;   // tile columns: output channels
constexpr int kStep = 32;        // pixels per stage
constexpr int kStages = 4;       // cp.async ring depth
constexpr int kDckThreads = 256; // 8 warps: 2 (cin) x 4 (cout), 64 x 32 each
constexpr int kLd = kTileCin + 8;  // row stride in floats; 136 = 8 (mod 32
                                   // banks): conflict-free fragment loads
constexpr int kRows = 4;         // pixel rows each thread copies per stage
static_assert(kTileCin == kTileCout, "one loader layout serves x and g");
static_assert(kStep * kTileCin / 4 == kDckThreads * kRows, "loaders");
static_assert(kStages * 8 <= 32, "row masks of all stages in one word");

__host__ __device__ constexpr int stage_floats(bool fold) {
  return (fold ? 3 : 2) * kStep * kLd;   // x, g (and the fold's y) tiles
}

// Dynamic shared memory: the ring, then the tile's channel constants
// (scale, shift, alpha of cin; gs1, gs2 of cout)
__host__ __device__ constexpr int smem_floats(bool fold) {
  return kStages * stage_floats(fold) + 5 * kTileCin;
}

// d += a * b: one m16n8k8 TF32 product, f32 accumulators (not volatile:
// the compiler may interleave the products with the loads)
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a * b: the same product into fresh accumulators
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%11,%12,%13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f), "f"(0.0f), "f"(0.0f), "f"(0.0f));
}

// A pixel (n, i, j) of the (n, h, w) grid, and a step of s pixels split as
// s = dn h w + di w + dj with di < h, dj < w, so one carry per axis.
struct Pix {
  int n, i, j;
};
struct Step {
  int dn, di, dj;
};

__device__ __forceinline__ Step make_step(int s, int h, int w) {
  const int hw = h * w;
  const int r = s % hw;
  return {s / hw, r / w, r % w};
}

__device__ __forceinline__ void advance(Pix& p, const Step& s, int h, int w) {
  p.j += s.dj;
  if (p.j >= w) { p.j -= w; ++p.i; }
  p.i += s.di;
  if (p.i >= h) { p.i -= h; ++p.n; }
  p.n += s.dn;
}

}  // namespace dck

// x (n, h, w, cin) (+ transform); g (n, 2h, 2w, cout) (+ fold, y the
// same). One block per (tap, cout tile, cin tile, parity, split), in that
// order from fastest to slowest in blockIdx.x; split sp covers pixels
// [sp * chunk, (sp + 1) * chunk). partial (splits, 4, kh, kw, cin, cout).
// With kFold, the blocks of cin tile 0 at tap 0 also write the column
// sums of the folded g over their pixels to db_partial (splits * 4,
// cout). Dynamic shared memory: smem_floats(kFold) floats.
template <bool kFold, bool kTransform, bool kVec>
__global__ void __launch_bounds__(dck::kDckThreads, 1)
upsample_conv_dck(const float* __restrict__ x, Transform tr,
                  const float* __restrict__ g, Fold fold,
                  float* __restrict__ partial,
                  float* __restrict__ db_partial, Geometry gm, int chunk) {
  using namespace dck;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int taps = gm.kh * gm.kw;
  const int co_tiles = (int)ceil_div(gm.cout, kTileCout);
  const int ci_tiles = (int)ceil_div(gm.cin, kTileCin);
  int b = blockIdx.x;
  const int tap = b % taps;
  b /= taps;
  const int co0 = (b % co_tiles) * kTileCout;
  b /= co_tiles;
  const int ci_tile = b % ci_tiles;
  const int ci0 = ci_tile * kTileCin;
  b /= ci_tiles;
  const int p = b & 3, sp = b >> 2;
  const int d = p >> 1, e = p & 1;
  const int u = tap / gm.kw, v = tap - u * gm.kw;
  const int sh = gm.umin_h[d] + u, sw = gm.umin_w[e] + v;
  const int pixels = gm.n * gm.h * gm.w;
  const int kb0 = sp * chunk;
  const int kb1 = min(kb0 + chunk, pixels);
  const int steps = kb1 > kb0 ? (kb1 - kb0 + kStep - 1) / kStep : 0;
  const bool bias_block = kFold && tap == 0 && ci_tile == 0;
  constexpr bool kFix = kTransform || kFold;   // a pass over staged data

  // the loader's share: rows rg*4 .. rg*4+3 of every stage, channels
  // 4q .. 4q+3 of both tiles (a warp copies 512 contiguous bytes a row)
  const int q = t & 31, rg = t >> 5;
  const int cx = ci0 + 4 * q, cg = co0 + 4 * q;
  Step one = {}, stride = {};
  Pix next = {};                    // row rg*4 of the next stage to load
  if (steps > 0) {                  // (an empty image has no h w to divide)
    const int m = kb0 + rg * kRows, hw = gm.h * gm.w;
    one = make_step(1, gm.h, gm.w);
    stride = make_step(kStep, gm.h, gm.w);
    next.n = m / hw;
    next.i = (m - next.n * hw) / gm.w;
    next.j = m - next.n * hw - next.i * gm.w;
  }
  uint32_t masks = 0;               // per stage: 4 x-row bits, 4 g-row bits

  // the tile's per-channel constants, in shared memory (registers go to
  // the accumulators); 0 past the last channel
  float* consts = smem + kStages * stage_floats(kFold);
  if (kFix && t < kTileCin) {
    const bool okx = kTransform && ci0 + t < gm.cin;
    consts[t] = okx ? __ldg(tr.scale + ci0 + t) : 0.0f;
    consts[kTileCin + t] = okx ? __ldg(tr.shift + ci0 + t) : 0.0f;
    consts[2 * kTileCin + t] = okx ? __ldg(tr.alpha + ci0 + t) : 0.0f;
    const bool okg = kFold && co0 + t < gm.cout;
    consts[3 * kTileCin + t] = okg ? __ldg(fold.gs + co0 + t) : 0.0f;
    consts[4 * kTileCin + t] =
        okg ? __ldg(fold.gs + gm.cout + co0 + t) : 0.0f;
  }
  if (kFix) __syncthreads();
  float db[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  auto load_stage = [&](int kt) {
    const int slot = kt % kStages;
    float* sx = smem + slot * stage_floats(kFold);
    float* sg = sx + kStep * kLd;
    Pix pr = next;
    int m = kb0 + kt * kStep + rg * kRows;
    uint32_t bits = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = rg * kRows + r;
      const bool valid = m < kb1;
      const int si = pr.i + sh, sj = pr.j + sw;
      const bool inb = valid && si >= 0 && si < gm.h && sj >= 0 && sj < gm.w;
      const int xpix = (pr.n * gm.h + si) * gm.w + sj;
      const int gpix =
          (pr.n * 2 * gm.h + 2 * pr.i + d) * 2 * gm.w + 2 * pr.j + e;
      copy4<kVec>(sx + row * kLd + 4 * q, x + (int64_t)xpix * gm.cin + cx, x,
                  inb && (!kVec || cx < gm.cin), cx, gm.cin);
      const int64_t goff = (int64_t)gpix * gm.cout + cg;
      const bool gok = valid && (!kVec || cg < gm.cout);
      copy4<kVec>(sg + row * kLd + 4 * q, g + goff, g, gok, cg, gm.cout);
      if (kFold) {
        copy4<kVec>(sg + kStep * kLd + row * kLd + 4 * q, fold.y + goff,
                    fold.y, gok, cg, gm.cout);
      }
      bits |= ((uint32_t)inb << r) | ((uint32_t)valid << (kRows + r));
      advance(pr, one, gm.h, gm.w);
      ++m;
    }
    masks = (masks & ~(0xffu << (8 * slot))) | (bits << (8 * slot));
    advance(next, stride, gm.h, gm.w);
  };

  // the transform of x and the fold of g on this thread's own chunks of
  // stage kt, once its copies have landed
  auto fix_stage = [&](int kt) {
    const int slot = kt % kStages;
    float* sx = smem + slot * stage_floats(kFold);
    float* sg = sx + kStep * kLd;
    const uint32_t bits = masks >> (8 * slot);
    const float4* c4 = reinterpret_cast<const float4*>(consts) + q;
    const int n4 = kTileCin / 4;
    const float4 sc4 = c4[0], sh4 = c4[n4], al4 = c4[2 * n4];
    const float4 s14 = c4[3 * n4], s24 = c4[4 * n4];
    const float tsc[4] = {sc4.x, sc4.y, sc4.z, sc4.w};
    const float tsh[4] = {sh4.x, sh4.y, sh4.z, sh4.w};
    const float tal[4] = {al4.x, al4.y, al4.z, al4.w};
    const float fs1[4] = {s14.x, s14.y, s14.z, s14.w};
    const float fs2[4] = {s24.x, s24.y, s24.z, s24.w};
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = rg * kRows + r;
      if (kTransform) {
        float4* px = reinterpret_cast<float4*>(sx + row * kLd + 4 * q);
        float xv[4] = {px->x, px->y, px->z, px->w};
        const bool inb = (bits >> r) & 1u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // prelu(x * scale + shift), rounded as the plain version's
          const float xt = xv[k] * tsc[k] + tsh[k];
          xv[k] = inb ? (xt >= 0.0f ? xt : tal[k] * xt) : 0.0f;
        }
        *px = make_float4(xv[0], xv[1], xv[2], xv[3]);
      }
      if (kFold) {
        float4* pg = reinterpret_cast<float4*>(sg + row * kLd + 4 * q);
        const float4 y4 =
            *reinterpret_cast<const float4*>(sg + (kStep + row) * kLd + 4 * q);
        float gv[4] = {pg->x, pg->y, pg->z, pg->w};
        const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
        const bool valid = (bits >> (kRows + r)) & 1u;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // (gy + gs1) + (2 y) gs2, in the plain version's order
          const float tk = (2.0f * yv[k]) * fs2[k];
          gv[k] = valid ? (gv[k] + fs1[k]) + tk : 0.0f;
          if (bias_block) db[k] += gv[k];
        }
        *pg = make_float4(gv[0], gv[1], gv[2], gv[3]);
      }
    }
  };

  // the warp's 64 x 32 share of the tile: 4 x 4 m16n8 fragments. The
  // tensor cores add into acc with truncation, which biases a long sum;
  // so acc holds one step's 32 pixels, and sum adds the steps in f32
  // with round-to-nearest.
  const int warp = t >> 5, lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;
  float acc[4][4][4], sum[4][4][4] = {};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of stage kt
    if (kFix) fix_stage(kt);
    __syncthreads();                // everyone's stage kt; stage kt-1 free
    if (kt + kStages - 1 < steps) load_stage(kt + kStages - 1);
    cp_async_commit();
    const float* sx = smem + (kt % kStages) * stage_floats(kFold);
    const float* sg = sx + kStep * kLd;
#pragma unroll
    for (int k0 = 0; k0 < kStep; k0 += 8) {
      const float* x0 = sx + (k0 + tig) * kLd + wm + gid;
      const float* x1 = x0 + 4 * kLd;
      const float* g0 = sg + (k0 + tig) * kLd + wn + gid;
      const float* g1 = g0 + 4 * kLd;
      uint32_t ah[4][4], al[4][4], bh[4][2], bl[4][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        split_tf32(x0[mt * 16], ah[mt][0], al[mt][0]);
        split_tf32(x0[mt * 16 + 8], ah[mt][1], al[mt][1]);
        split_tf32(x1[mt * 16], ah[mt][2], al[mt][2]);
        split_tf32(x1[mt * 16 + 8], ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(g0[nt * 8], bh[nt][0], bl[nt][0]);
        split_tf32(g1[nt * 8], bh[nt][1], bl[nt][1]);
      }
      // three passes over the 16 fragments (lo*hi, hi*lo, hi*hi), so that
      // 16 independent products separate two into one accumulator
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (k0 == 0) {
            mma_tf32_first(acc[mt][nt], al[mt], bh[nt]);
          } else {
            mma_tf32(acc[mt][nt], al[mt], bh[nt]);
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int k = 0; k < 4; ++k) sum[mt][nt][k] += acc[mt][nt][k];
      }
    }
  }
  cp_async_wait<0>();

  float* out = partial + ((((int64_t)sp * 4 + p) * gm.kh + u) * gm.kw + v) *
                             gm.cin * gm.cout;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c = ci0 + wm + mt * 16 + gid + 8 * half;
      if (c >= gm.cin) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int co = co0 + wn + nt * 8 + 2 * tig;
        float* o = out + (int64_t)c * gm.cout + co;
        if (co < gm.cout) o[0] = sum[mt][nt][2 * half];
        if (co + 1 < gm.cout) o[1] = sum[mt][nt][2 * half + 1];
      }
    }
  }
  if (bias_block) {
    // thread (rg, q) holds column sums over its rows of every stage; the 8
    // row groups are added in order
    __syncthreads();                // the ring is free: reuse it
    float* red = smem;              // (8, kTileCout)
#pragma unroll
    for (int k = 0; k < 4; ++k) red[rg * kTileCout + 4 * q + k] = db[k];
    __syncthreads();
    if (t < kTileCout && co0 + t < gm.cout) {
      float s = 0.0f;
      for (int r = 0; r < kDckThreads / 32; ++r) s += red[r * kTileCout + t];
      db_partial[((int64_t)sp * 4 + p) * gm.cout + co0 + t] = s;
    }
  }
}

// The bf16 dX (catgen's bf16 compute dtype): the f32 dX's tiles and
// epilogue with one bf16 wgmma product (m64n128k16) in place of the
// 3xTF32 split, as the bf16 forward (upsample_conv.cu). It reads g as it
// lies: the per-layer cotangent, or on the block route the folded
// cotangent gf that upsample_conv_prep.cu writes once per element (catgen
// folds g and rounds it to x's dtype before both products, as that pass
// does; a zero-filled halo copy is the 0 the fold masks in). So the main
// loop only copies and multiplies:
//   * a step is one (parity, tap) pair and 64 output channels, one
//     128-byte swizzled row of A (g at the source pixels) and of B (the
//     parity stack's cin rows, cout contiguous); both land in place by
//     16-byte cp.async (2-byte loads for kVec = false);
//   * a ring of kStages stages of 32 KB, taken two steps at a time: the
//     copies of the next two pairs are in flight while a pair's products
//     run, one barrier a pair;
//   * fresh accumulators each 64-deep step, in two banks: both steps of a
//     pair are queued on the tensor cores before the first one's products
//     are added into sum (wgmma.wait_group 1), so the second one's run
//     under that sum and under the next copies. The steps are added in
//     f32 in step order: the bits of a one-bank loop;
//   * the epilogue writes dx rounded once, and with the transform its
//     backward in f32 from the bf16 x and constants, the column sums of
//     dscale, dshift and dalpha f32 as in f32.
// What bounds it: 2 * MACs / 989e12 s on the tensor cores, while each
// step reads 32 KB of tiles (from L2, mostly) for 1M MACs.

namespace dxk16 {

constexpr int kTileM = kTilePixels;   // input pixels per block
constexpr int kTileN = 128;     // input channels per block
constexpr int kStep = 64;       // contraction per stage: 64 output channels
constexpr int kThreads = 256;   // 2 warpgroups, 64 rows of the tile each
constexpr int kStages = 6;      // ring depth: 2 pairs of steps in flight
constexpr int kTile = kTileM * kStep * 2;     // bytes of one A or B tile
constexpr int kRing = kStages * 2 * kTile;   // bytes of the ring
constexpr int kSmemBytes = kRing + 1024;      // + room to align
static_assert(kTileM == kTileN, "one loader layout for A and B");
static_assert(kStep * 2 == 128, "a tile row is one 128-byte swizzle row");
static_assert(kStages % 2 == 0 && kStages >= 4,
              "a pair in the tensor cores, whole pairs loading");
static_assert(kSmemBytes <= 232448, "over the H100's opt-in shared memory");
static_assert(kTileM == dxk::kTileM && kTileN == dxk::kTileN &&
              kThreads == dxk::kThreads, "dx_epilogue's tile");
static_assert(kThreads / 32 * 3 * kTileN * 4 <= kRing,
              "dx_epilogue's sums fit the ring");

}  // namespace dxk16

// One step's products for warpgroup wg into fresh accumulators d, from
// the ring slot at `slot` (A, then B): 4 wgmma of 16 output channels (32
// bytes a row), one commit group.
__device__ __forceinline__ void dx16_products(float (&d)[64], uint32_t slot,
                                              int wg) {
  const uint32_t a = slot + wg * 64 * 128, bt = slot + dxk16::kTile;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    wgmma_bf16(d, tile_desc(a + 32 * s), tile_desc(bt + 32 * s), s == 0);
  }
  wgmma_commit();
}

// g (n, 2h, 2w, cout); wst (4, kh, kw, cin, cout); dx (n, h, w, cin), all
// bf16, as x and the transform; partial (m_tiles, 3, cin) f32 with
// kTransform. Blocks in order cin tile, pixel tile.
template <bool kTransform, bool kVec>
__global__ void __launch_bounds__(dxk16::kThreads, 1)
upsample_conv_dx_bf16(const bf16* __restrict__ g,
                      const bf16* __restrict__ wst,
                      const bf16* __restrict__ x, TransformT<bf16> tr,
                      bf16* __restrict__ dx, float* __restrict__ partial,
                      Geometry gm) {
  using namespace dxk16;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);

  const int tid = threadIdx.x;
  const int ci_tiles = (int)ceil_div(gm.cin, kTileN);
  const int c0 = (blockIdx.x % ci_tiles) * kTileN;
  const int mtile = blockIdx.x / ci_tiles;
  const int hw = gm.h * gm.w;
  const int m_total = gm.n * hw;          // the launcher checks < 2^31
  const int m0 = mtile * kTileM;
  const int csteps = (gm.cout + kStep - 1) / kStep;
  const int steps = 4 * gm.kh * gm.kw * csteps;

  // loaders: rows 32 r + (tid >> 3), chunk tid & 7 (output channels
  // 8 (tid & 7) .. +7 of the step) of A and of B
  const int acq = tid & 7, arow = tid >> 3;
  int gbase[4], ai[4], aj[4];
  uint32_t avalid = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 32 * r + arow;
    const bool ok = m < m_total;
    const int nn = ok ? m / hw : 0;
    const int rem = ok ? m - nn * hw : 0;
    ai[r] = rem / gm.w;
    aj[r] = rem - ai[r] * gm.w;
    gbase[r] = nn * 4 * hw;
    avalid |= (uint32_t)ok << r;
  }

  int ld_p = 0, ld_u = 0, ld_v = 0, ld_cs = 0;   // the next step to load

  // copies the next step's A and B tiles into ring slot `slot`
  auto load_stage = [&](int slot) {
    bf16* a_dst = reinterpret_cast<bf16*>(smem + 2 * slot * kTile);
    bf16* b_dst = a_dst + kTile / 2;
    const int d = ld_p >> 1, e = ld_p & 1;
    const int co = ld_cs * kStep + 8 * acq;
    const int oh = gm.umin_h[d] + ld_u, ow = gm.umin_w[e] + ld_v;
    const bool co_ok = !kVec || co < gm.cout;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int si = ai[r] - oh, sj = aj[r] - ow;
      const bool inb = ((avalid >> r) & 1u) && si >= 0 && si < gm.h &&
                       sj >= 0 && sj < gm.w;
      const int gpix = gbase[r] + (2 * si + d) * 2 * gm.w + 2 * sj + e;
      copy8<kVec>(a_dst + chunk_at(32 * r + arow, acq) / 2,
                  g + (int64_t)gpix * gm.cout + co, g, inb && co_ok, co,
                  gm.cout);
    }
    const bf16* wtap =
        wst + (((int64_t)ld_p * gm.kh + ld_u) * gm.kw + ld_v) * gm.cin *
                  gm.cout;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int c = c0 + 32 * r + arow;
      copy8<kVec>(b_dst + chunk_at(32 * r + arow, acq) / 2,
                  wtap + (int64_t)c * gm.cout + co, wst,
                  c < gm.cin && co_ok, co, gm.cout);
    }
    if (++ld_cs == csteps) {
      ld_cs = 0;
      if (++ld_v == gm.kw) {
        ld_v = 0;
        if (++ld_u == gm.kh) {
          ld_u = 0;
          ++ld_p;
        }
      }
    }
  };

  const int wg = tid >> 7;
  float acc0[64], acc1[64], sum[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) sum[k] = 0.0f;

#pragma unroll
  for (int s = 0; s < kStages - 2; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  // two steps at a time (steps is a multiple of 4, the parities): both
  // steps' products queued, step kt's added into sum while step kt + 1's
  // run; every product group is retired within its pair
#pragma unroll 1
  for (int kt = 0; kt < steps; kt += 2) {
    cp_async_wait<kStages - 4>();   // this thread's copies of kt, kt + 1
    fence_async_shared();
    __syncthreads();                // every copy of the pair has landed,
                                    // and the pair before is done
    wgmma_fence();
    dx16_products(acc0, sbase + 2 * (kt % kStages) * kTile, wg);
    dx16_products(acc1, sbase + 2 * ((kt + 1) % kStages) * kTile, wg);
    // steps kt + kStages - 2 and kt + kStages - 1 into the slots the pair
    // before has left
#pragma unroll
    for (int j = kStages - 2; j < kStages; ++j) {
      if (kt + j < steps) load_stage((kt + j) % kStages);
      cp_async_commit();
    }
    wgmma_wait<1>(acc0);            // step kt's products
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc0[k];
    wgmma_wait<0>(acc1);            // step kt + 1's
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc1[k];
  }
  cp_async_wait<0>();
  __syncthreads();                  // both warpgroups are done with the ring

  dx_epilogue<kTransform>(sum, x, tr, dx, partial, smem, gm, c0, m0, mtile);
}

// The bf16 dCK (catgen's bf16 compute dtype): the f32 dCK's blocks, pixel
// ranges and fixed-order sums, on bf16 wgmma (m64n128k16, f32
// accumulators). It reads its operands as they lie: x and g on the
// per-layer route, and on the block route the transformed input xn and
// the folded cotangent gf, which the passes of upsample_conv_prep.cu
// write once per element (catgen's kernel rounds xn and g to x's dtype
// before its products, as those passes do). The design, against the bound
// 2 * MACs / 989e12 s:
//   * wgmma takes 16-bit operands MN-major ("transposed") from shared
//     memory, so the pixel-major tiles feed it as they land, with no
//     transposing pass: A is x's tile (M = 128 input channels contiguous
//     per pixel), B is g's (N = 128 output channels contiguous per
//     pixel), K runs over the pixels. Each tile is two columns of 64
//     channels (128 bytes) by kStep pixel rows, in wgmma's 128-byte
//     swizzle: 8 pixel rows make one 1024-byte swizzle atom, the atoms
//     follow each other down K, and the second 64 channels lie kHalf
//     bytes on (the descriptor's MN stride).
//   * Each of the two warpgroups owns 64 input channels x 128 output
//     channels: 8 wgmma a stage of 128 pixels into fresh accumulators,
//     and the stages are added in f32 (the tensor cores' truncating
//     adds, as in f32 above).
//   * A ring of 3 stages (x and g tiles, 64 KB a stage) filled by
//     16-byte cp.async copies that zero-fill halo rows of x, rows past
//     the range in both, and channels past the last; the copies of
//     stages kt + 1 and kt + 2 are in flight while stage kt's products
//     run, and a stage's copies are issued while the products of the
//     stage before run. One barrier a stage. Channel counts that are not
//     multiples of 8, or unaligned arrays, take 2-byte loads through
//     registers (kVec = false), in the same kernel.

namespace dck16 {

constexpr int kTileCin = 128;    // M: input channels, 64 per warpgroup
constexpr int kTileCout = 128;   // N: output channels
constexpr int kStep = 128;       // K: pixels per stage
constexpr int kStages = 3;       // cp.async ring depth
constexpr int kThreads = 256;    // 2 warpgroups
constexpr int kRows = kStep * 16 / kThreads;   // pixel rows a thread copies
constexpr int kHalf = kStep * 128;   // bytes of 64 channels x kStep pixels
constexpr int kTile = 2 * kHalf;     // bytes of an x or a g tile
constexpr int kSmemBytes = kStages * 2 * kTile + 1024;   // + room to align
static_assert(kTileCin == kTileCout, "one loader layout serves x and g");
static_assert(kStep % 16 == 0 && kRows * kThreads == kStep * 16, "loaders");
static_assert(kSmemBytes <= 232448, "over the H100's opt-in shared memory");

}  // namespace dck16

// x (n, h, w, cin); g (n, 2h, 2w, cout), both bf16. One block per (tap,
// cout tile, cin tile, parity, split), in that order from fastest to
// slowest in blockIdx.x (the f32 dCK's); split sp covers pixels [sp *
// chunk, (sp + 1) * chunk). partial (splits, 4, kh, kw, cin, cout) f32.
template <bool kVec>
__global__ void __launch_bounds__(dck16::kThreads, 1)
upsample_conv_dck_bf16(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       float* __restrict__ partial, Geometry gm, int chunk) {
  using namespace dck16;
  using dck::Pix;
  using dck::Step;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // the tiles start at the first 1024-byte boundary (the swizzle's period)
  const uint32_t raw_addr = smem_addr(smem_raw);
  uint8_t* smem = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  const uint32_t sbase = smem_addr(smem);
  const int t = threadIdx.x;
  const int taps = gm.kh * gm.kw;
  const int co_tiles = (int)ceil_div(gm.cout, kTileCout);
  const int ci_tiles = (int)ceil_div(gm.cin, kTileCin);
  int b = blockIdx.x;
  const int tap = b % taps;
  b /= taps;
  const int co0 = (b % co_tiles) * kTileCout;
  b /= co_tiles;
  const int ci0 = (b % ci_tiles) * kTileCin;
  b /= ci_tiles;
  const int p = b & 3, sp = b >> 2;
  const int d = p >> 1, e = p & 1;
  const int u = tap / gm.kw, v = tap - u * gm.kw;
  const int sh = gm.umin_h[d] + u, sw = gm.umin_w[e] + v;
  const int pixels = gm.n * gm.h * gm.w;
  const int kb0 = sp * chunk;
  const int kb1 = min(kb0 + chunk, pixels);
  const int steps = kb1 > kb0 ? (kb1 - kb0 + kStep - 1) / kStep : 0;

  // the loader's share: pixel rows rg*kRows .. +kRows-1 of every stage,
  // channels 8q .. 8q+7 of both tiles (16 threads copy a pixel's 256
  // bytes), which land in column q >> 3, chunk q & 7 of the tiles
  const int q = t & 15, rg = t >> 4;
  const int cx = ci0 + 8 * q, cg = co0 + 8 * q;
  const uint32_t col = (q >> 3) * kHalf;
  Step one = {}, stride = {};
  Pix next = {};                    // row rg*kRows of the next stage to load
  if (steps > 0) {                  // (an empty image has no h w to divide)
    const int m = kb0 + rg * kRows, hw = gm.h * gm.w;
    one = dck::make_step(1, gm.h, gm.w);
    stride = dck::make_step(kStep, gm.h, gm.w);
    next.n = m / hw;
    next.i = (m - next.n * hw) / gm.w;
    next.j = m - next.n * hw - next.i * gm.w;
  }

  auto load_stage = [&](int kt) {
    uint8_t* sx = smem + (kt % kStages) * 2 * kTile;
    uint8_t* sg = sx + kTile;
    Pix pr = next;
    int m = kb0 + kt * kStep + rg * kRows;
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = rg * kRows + r;
      const bool valid = m < kb1;
      const int si = pr.i + sh, sj = pr.j + sw;
      const bool inb = valid && si >= 0 && si < gm.h && sj >= 0 && sj < gm.w;
      const int xpix = (pr.n * gm.h + si) * gm.w + sj;
      const int gpix =
          (pr.n * 2 * gm.h + 2 * pr.i + d) * 2 * gm.w + 2 * pr.j + e;
      const uint32_t off = col + chunk_at(row, q & 7);
      copy8<kVec>(reinterpret_cast<bf16*>(sx + off),
                  x + (int64_t)xpix * gm.cin + cx, x,
                  inb && (!kVec || cx < gm.cin), cx, gm.cin);
      copy8<kVec>(reinterpret_cast<bf16*>(sg + off),
                  g + (int64_t)gpix * gm.cout + cg, g,
                  valid && (!kVec || cg < gm.cout), cg, gm.cout);
      dck::advance(pr, one, gm.h, gm.w);
      ++m;
    }
    dck::advance(next, stride, gm.h, gm.w);
  };

  // warpgroup wg owns input channels 64 wg .. +63 of the tile (x's
  // column wg). acc holds one stage's 128 pixels; sum adds the stages in
  // f32.
  const int wg = t >> 7;
  float acc[64], sum[64];
#pragma unroll
  for (int k = 0; k < 64; ++k) sum[k] = 0.0f;

  // stages 0 .. kStages-2 in flight, stage 0 landed; then per stage: its
  // products started (asynchronous), the copies of stage kt + kStages - 1
  // issued beside them into the slot stage kt - 1 freed, the wait for the
  // products and their sum, the wait for this thread's copies of stage
  // kt + 1, one barrier
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load_stage(s);
    cp_async_commit();
  }
  cp_async_wait<kStages - 2>();
  fence_async_shared();
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    const uint32_t sx = sbase + (kt % kStages) * 2 * kTile;
    const uint32_t sg = sx + kTile;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kStep / 16; ++s) {   // 16 pixels: 2 swizzle atoms
      wgmma_bf16_mn(acc, mn_desc(sx + wg * kHalf + 2048 * s, kHalf),
                    mn_desc(sg + 2048 * s, kHalf), s == 0);
    }
    wgmma_commit();
    if (kt + kStages - 1 < steps) load_stage(kt + kStages - 1);
    cp_async_commit();
    wgmma_wait(acc);
#pragma unroll
    for (int k = 0; k < 64; ++k) sum[k] += acc[k];
    cp_async_wait<kStages - 2>();   // this thread's copies of stage kt + 1
    fence_async_shared();           // visible to wgmma (the async proxy)
    __syncthreads();                // stage kt + 1 landed; kt's slot free
  }
  cp_async_wait<0>();

  // thread (g, t) of warp w of warpgroup wg holds rows 16 w + g and
  // 16 w + g + 8 of the warpgroup's 64 input channels, output channels
  // 8 j + 2 t, +1: sum[4 j + 2 half + q]
  float* out = partial + ((((int64_t)sp * 4 + p) * gm.kh + u) * gm.kw + v) *
                             gm.cin * gm.cout;
  const int lane = t & 31, gid = lane >> 2, tig = lane & 3;
  const int c_row = ci0 + wg * 64 + ((t >> 5) & 3) * 16 + gid;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int c = c_row + 8 * hf;
    if (c >= gm.cin) continue;
    float* o = out + (int64_t)c * gm.cout;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = co0 + 8 * j + 2 * tig;
      const float a = sum[4 * j + 2 * hf], a1 = sum[4 * j + 2 * hf + 1];
      if (co + 1 < gm.cout && (gm.cout & 1) == 0) {
        store_pair(o + co, a, a1);
      } else {
        if (co < gm.cout) o[co] = a;
        if (co + 1 < gm.cout) o[co + 1] = a1;
      }
    }
  }
}

template <bool kFold, bool kTransform, bool kVec>
cudaError_t launch_dx(const float* g, Fold fold, const float* wst,
                      const float* x, Transform tr, float* dx, float* partial,
                      const Geometry& gm, cudaStream_t s) {
  const int smem = dxk::smem_bytes(kFold);
  const cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_dx<kFold, kTransform, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = ceil_div(gm.cin, dxk::kTileN) *
                         ceil_div((int64_t)gm.n * gm.h * gm.w, dxk::kTileM);
  upsample_conv_dx<kFold, kTransform, kVec>
      <<<(unsigned)blocks, dxk::kThreads, smem, s>>>(g, fold, wst, x, tr, dx,
                                                     partial, gm);
  return cudaGetLastError();
}

template <bool kFold, bool kTransform>
cudaError_t launch_dx(bool vec, const float* g, Fold fold, const float* wst,
                      const float* x, Transform tr, float* dx, float* partial,
                      const Geometry& gm, cudaStream_t s) {
  return vec ? launch_dx<kFold, kTransform, true>(g, fold, wst, x, tr, dx,
                                                  partial, gm, s)
             : launch_dx<kFold, kTransform, false>(g, fold, wst, x, tr, dx,
                                                   partial, gm, s);
}

template <bool kFold, bool kTransform, bool kVec>
cudaError_t launch_dck(const float* x, Transform tr, const float* g,
                       Fold fold, float* partial, float* db_partial,
                       const Geometry& gm, int splits, int chunk,
                       cudaStream_t s) {
  const int smem = dck::smem_floats(kFold) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_dck<kFold, kTransform, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)gm.kh * gm.kw *
                         ceil_div(gm.cout, dck::kTileCout) *
                         ceil_div(gm.cin, dck::kTileCin) * 4 * splits;
  upsample_conv_dck<kFold, kTransform, kVec>
      <<<(unsigned)blocks, dck::kDckThreads, smem, s>>>(x, tr, g, fold, partial,
                                                     db_partial, gm, chunk);
  return cudaGetLastError();
}

template <bool kFold, bool kTransform>
cudaError_t launch_dck(bool vec, const float* x, Transform tr, const float* g,
                       Fold fold, float* partial, float* db_partial,
                       const Geometry& gm, int splits, int chunk,
                       cudaStream_t s) {
  return vec ? launch_dck<kFold, kTransform, true>(
                   x, tr, g, fold, partial, db_partial, gm, splits, chunk, s)
             : launch_dck<kFold, kTransform, false>(
                   x, tr, g, fold, partial, db_partial, gm, splits, chunk, s);
}

template <bool kTransform, bool kVec>
cudaError_t launch_dx_bf16(const bf16* g, const bf16* wst, const bf16* x,
                           TransformT<bf16> tr, bf16* dx, float* partial,
                           const Geometry& gm, cudaStream_t s) {
  const cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_dx_bf16<kTransform, kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dxk16::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = ceil_div(gm.cin, dxk16::kTileN) *
                         ceil_div((int64_t)gm.n * gm.h * gm.w, dxk16::kTileM);
  upsample_conv_dx_bf16<kTransform, kVec>
      <<<(unsigned)blocks, dxk16::kThreads, dxk16::kSmemBytes, s>>>(
          g, wst, x, tr, dx, partial, gm);
  return cudaGetLastError();
}

template <bool kTransform>
cudaError_t launch_dx_bf16(bool vec, const bf16* g, const bf16* wst,
                           const bf16* x, TransformT<bf16> tr, bf16* dx,
                           float* partial, const Geometry& gm,
                           cudaStream_t s) {
  return vec ? launch_dx_bf16<kTransform, true>(g, wst, x, tr, dx, partial,
                                                gm, s)
             : launch_dx_bf16<kTransform, false>(g, wst, x, tr, dx, partial,
                                                 gm, s);
}

template <bool kVec>
cudaError_t launch_dck_bf16(const bf16* x, const bf16* g, float* partial,
                            const Geometry& gm, int splits, int chunk,
                            cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      upsample_conv_dck_bf16<kVec>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dck16::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int64_t blocks = (int64_t)gm.kh * gm.kw *
                         ceil_div(gm.cout, dck16::kTileCout) *
                         ceil_div(gm.cin, dck16::kTileCin) * 4 * splits;
  upsample_conv_dck_bf16<kVec>
      <<<(unsigned)blocks, dck16::kThreads, dck16::kSmemBytes, s>>>(
          x, g, partial, gm, chunk);
  return cudaGetLastError();
}

// dX of an empty batch or input: dx is empty, and with the transform
// (dtr non-null; an empty x may have a null pointer) its sums dtr (3,
// cin) are 0
int empty_dx(float* dtr, int cin, cudaStream_t s) {
  if (dtr == nullptr || cin <= 0) return 0;
  return (int)cudaMemsetAsync(dtr, 0, sizeof(float) * 3 * (size_t)cin, s);
}

// a split's pixel range: an equal share, rounded up to whole stages
int dck_chunk(int64_t pixels, int splits, int step) {
  return (int)(ceil_div(ceil_div(pixels, splits), step) * step);
}

}  // namespace

// How many pixel ranges the dCK kernel cuts the batch into. One block of
// dCK's fills an SM (its registers), so the blocks run in waves of 132
// (the H100's SMs): the fewest splits whose blocks fill their waves to
// 95% or more, else the fullest waves, with at least 256 pixels
// (8 steps) per range and at most 64 ranges. The wrapper sizes the
// scratch from it.
extern "C" int catgen_upsample_conv_dck_splits(int n, int h, int w, int cin,
                                               int cout, int kh, int kw) {
  const int64_t pixels = (int64_t)n * h * w;
  const int64_t tiles = ceil_div(cout, dck::kTileCout) * (int64_t)kh * kw *
                        ceil_div(cin, dck::kTileCin) * 4;
  const int64_t slots = 132;
  int64_t most = pixels / 256;
  most = most < 1 ? 1 : (most > 64 ? 64 : most);
  int best = 1;
  double best_fill = -1.0;
  for (int64_t s = 1; s <= most; ++s) {
    const int64_t blocks = tiles * s;
    const double fill =
        (double)blocks / (double)(ceil_div(blocks, slots) * slots);
    if (fill >= 0.95) return (int)s;
    if (fill > best_fill) {
      best_fill = fill;
      best = (int)s;
    }
  }
  return best;
}

// dX. g (n, 2h, 2w, cout) and wst (4, kh, kw, cin, cout), the parity
// stack as the forward takes it, are required. With y and gs (2, cout)
// non-null, g is folded with the stats cotangents. With x non-null, dx is
// the gradient through the input transform tscale / tshift / talpha (cin
// each), partial holds (catgen_upsample_conv_partial_rows, 3, cin) floats
// of scratch and dtr
// receives [dscale, dshift, dalpha] as (3, cin); else dx is the gradient
// of the conv's input. Pixel indices are 32-bit: n * 2h * 2w must stay
// below 2^31. Launches on `stream`; returns cudaGetLastError().
extern "C" int catgen_upsample_conv_dx_f32(
    const float* g, const float* y, const float* gs, const float* wst,
    const float* x, const float* tscale, const float* tshift,
    const float* talpha, float* dx, float* partial, float* dtr, int n, int h,
    int w, int cin, int cout, int kh, int kw, int uh0, int uh1, int uw0,
    int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)n * h * w == 0 || cin == 0) return empty_dx(dtr, cin, s);
  if ((int64_t)n * 4 * h * w >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry gm =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const Fold fold = {y, gs, cout};
  const Transform tr = {tscale, tshift, talpha};
  const bool f = y != nullptr, tf = x != nullptr;
  // 16-byte copies where every row of g, y and wst starts 16-byte aligned
  const bool vec = cin % 4 == 0 && cout % 4 == 0 && aligned16(g) &&
                   aligned16(y) && aligned16(wst);
  cudaError_t err;
  if (f && tf) {
    err = launch_dx<true, true>(vec, g, fold, wst, x, tr, dx, partial, gm, s);
  } else if (f) {
    err = launch_dx<true, false>(vec, g, fold, wst, x, tr, dx, partial, gm,
                                 s);
  } else if (tf) {
    err = launch_dx<false, true>(vec, g, fold, wst, x, tr, dx, partial, gm,
                                 s);
  } else {
    err = launch_dx<false, false>(vec, g, fold, wst, x, tr, dx, partial, gm,
                                  s);
  }
  if (err != cudaSuccess || !tf) return (int)err;
  return (int)launch_sum_rows(partial, dtr,
                              (int)ceil_div((int64_t)n * h * w, dxk::kTileM),
                              3 * (int64_t)cin, s);
}

// dCK. x (n, h, w, cin) and g (n, 2h, 2w, cout) are required; tscale /
// tshift / talpha non-null recompute xn from x; y and gs non-null fold g
// and then also write dbias (cout) through db_partial (splits * 4, cout)
// of scratch. partial holds (splits, 4, kh, kw, cin, cout) floats of
// scratch, splits from catgen_upsample_conv_dck_splits; dck receives (4,
// kh, kw, cin, cout). Pixel indices are 32-bit: n * 2h * 2w must stay
// below 2^31. Launches on `stream`; returns cudaGetLastError().
extern "C" int catgen_upsample_conv_dck_f32(
    const float* x, const float* tscale, const float* tshift,
    const float* talpha, const float* g, const float* y, const float* gs,
    float* partial, float* dck, float* db_partial, float* dbias, int n,
    int h, int w, int cin, int cout, int kh, int kw, int uh0, int uh1,
    int uw0, int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 0 || cout == 0) return 0;
  if ((int64_t)n * 4 * h * w >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry gm =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const Fold fold = {y, gs, cout};
  const Transform tr = {tscale, tshift, talpha};
  const int splits = catgen_upsample_conv_dck_splits(n, h, w, cin, cout, kh,
                                                     kw);
  const int chunk = dck_chunk((int64_t)n * h * w, splits, dck::kStep);
  const bool f = y != nullptr, tf = tscale != nullptr;
  // 16-byte copies where every row of x, g and y starts 16-byte aligned
  const bool vec = cin % 4 == 0 && cout % 4 == 0 && aligned16(x) &&
                   aligned16(g) && aligned16(y);
  cudaError_t err;
  if (f && tf) {
    err = launch_dck<true, true>(vec, x, tr, g, fold, partial, db_partial,
                                 gm, splits, chunk, s);
  } else if (f) {
    err = launch_dck<true, false>(vec, x, tr, g, fold, partial, db_partial,
                                  gm, splits, chunk, s);
  } else if (tf) {
    err = launch_dck<false, true>(vec, x, tr, g, fold, partial, db_partial,
                                  gm, splits, chunk, s);
  } else {
    err = launch_dck<false, false>(vec, x, tr, g, fold, partial, db_partial,
                                   gm, splits, chunk, s);
  }
  if (err != cudaSuccess) return (int)err;
  err = launch_sum_rows(partial, dck, splits,
                        (int64_t)4 * kh * kw * cin * cout, s);
  if (err != cudaSuccess || !f) return (int)err;
  return (int)launch_sum_rows(db_partial, dbias, splits * 4, cout, s);
}

// The bf16 dX: the f32 entry's arguments with bf16 g, wst, x, the
// transform and dx; partial and dtr stay f32. It takes no fold: on the
// block route g is the folded cotangent that catgen_upsample_conv_fold_bf16
// writes, and a non-null y or gs is refused (cudaErrorInvalidValue).
extern "C" int catgen_upsample_conv_dx_bf16(
    const bf16* g, const bf16* y, const float* gs, const bf16* wst,
    const bf16* x, const bf16* tscale, const bf16* tshift,
    const bf16* talpha, bf16* dx, float* partial, float* dtr, int n, int h,
    int w, int cin, int cout, int kh, int kw, int uh0, int uh1, int uw0,
    int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (y != nullptr || gs != nullptr) return (int)cudaErrorInvalidValue;
  if ((int64_t)n * h * w == 0 || cin == 0) return empty_dx(dtr, cin, s);
  if ((int64_t)n * 4 * h * w >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry gm =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const TransformT<bf16> tr = {tscale, tshift, talpha};
  const bool tf = x != nullptr;
  // 16-byte copies where every row of g and wst starts 16-byte aligned
  const bool vec = cin % 8 == 0 && cout % 8 == 0 && aligned16(g) &&
                   aligned16(wst);
  const cudaError_t err =
      tf ? launch_dx_bf16<true>(vec, g, wst, x, tr, dx, partial, gm, s)
         : launch_dx_bf16<false>(vec, g, wst, x, tr, dx, partial, gm, s);
  if (err != cudaSuccess || !tf) return (int)err;
  return (int)launch_sum_rows(partial, dtr,
                              (int)ceil_div((int64_t)n * h * w, dxk16::kTileM),
                              3 * (int64_t)cin, s);
}

// The bf16 dCK of x (n, h, w, cin) and g (n, 2h, 2w, cout), both bf16:
// on the block route the caller passes the transformed input and the
// folded cotangent (upsample_conv_prep.cu), and writes dbias there.
// partial holds (splits, 4, kh, kw, cin, cout) floats of scratch; dck
// receives (4, kh, kw, cin, cout) f32. Pixel indices are 32-bit: n * 2h *
// 2w must stay below 2^31. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int catgen_upsample_conv_dck_bf16(
    const bf16* x, const bf16* g, float* partial, float* dck, int n, int h,
    int w, int cin, int cout, int kh, int kw, int uh0, int uh1, int uw0,
    int uw1, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 0 || cout == 0) return 0;
  if ((int64_t)n * 4 * h * w >= ((int64_t)1 << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  const Geometry gm =
      make_geometry(n, h, w, cin, cout, kh, kw, uh0, uh1, uw0, uw1);
  const int splits = catgen_upsample_conv_dck_splits(n, h, w, cin, cout, kh,
                                                     kw);
  const int chunk = dck_chunk((int64_t)n * h * w, splits, dck16::kStep);
  // 16-byte copies where every row of x and g starts 16-byte aligned
  const bool vec = cin % 8 == 0 && cout % 8 == 0 && aligned16(x) &&
                   aligned16(g);
  cudaError_t err =
      vec ? launch_dck_bf16<true>(x, g, partial, gm, splits, chunk, s)
          : launch_dck_bf16<false>(x, g, partial, gm, splits, chunk, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_sum_rows(partial, dck, splits,
                              (int64_t)4 * kh * kw * cin * cout, s);
}
