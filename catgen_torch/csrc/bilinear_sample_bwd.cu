// Backward of the edge-clamped bilinear sampler (bilinear_sample.cu): the
// gradients with respect to the image (d_img) and to the normalized (y; x)
// coordinate rows (d_coords), given the gradient g of the sampled output.
//
// Replaces the TPU kernel catgen/kernels/pallas_bilinear_v4.py, _bwd: the
// separable bodies (_bwd_kernel, _bwd_kernel_dimg, _bwd_kernel_dcrd,
// _bwd_kernel_res_dimg) and the dense ones (_dense_bwd_kernel,
// _dense_bwd_kernel_mxu{,_dimg,_dcrd}, _dense_bwd_kernel_res_dimg). On the
// TPU those are matrix-unit formulations (one-hot weight masks contracted
// against the image and g); on Hopper both are one gather per output pixel,
// and one pair of kernels serves both shapes, as the forward does. The two
// gradients are two kernels, so that a caller that needs no d_img launches
// none (the D-phase input transformer samples data; catgen reaches the
// same by CATGEN_V4_SPLIT_BWD and dead-code elimination).
//
// Instantiated for the (N, Ho, Wo, 2) grid layout of the coordinates
// (GridLayout, bilinear_taps.cuh), the same kernels replace the backward
// TPU kernels of the three earlier generations: catgen/kernels/
// pallas_bilinear.py, _backward (v1), pallas_bilinear_v2.py, _bwd (v2) and
// pallas_bilinear_v3.py, _bwd (v3). Their masks are inclusive too, so the
// derivative on the edge itself is 1, as below. d_coords is then written
// as one (dy, dx) pair per pixel.
//
// d_coords[n, 0, p] = in_y * 0.5 (h-1) * sum_c g[p,c] (bot - top)
// d_coords[n, 1, p] = in_x * 0.5 (w-1) * sum_c g[p,c] ((1-wy)(v01-v00)
//                                                     + wy (v11-v10))
// (top, bot: the x-lerps of the forward; v.. the four taps). The TPU kernels
// (_bwd_kernel_dcrd, _dense_bwd_kernel_mxu_dcrd) contract one-hot weight
// masks against the image on the matrix unit; here it is a gather, bound
// by bytes: each output pixel reads its coordinates and C values of g, and
// its four taps of C values come from the sample's image. Four kernels,
// chosen by shape alone (dcoords_shape_kind; for C >= 32 sampler_kind,
// bilinear_taps.cuh, which the forward shares), the same way on every run:
//   * staged, for C % 4 == 0, C >= 32 and an image that fits one block's
//     opt-in shared memory (h w C 4 bytes: 64 KB at 16x16x64): one block
//     per sample and range of at most 256 output pixels stages the
//     sample's image in shared memory once (16-byte cp.async), so the 4
//     taps of every pixel are read there, not gathered again from L2 (at
//     the branch shape each image value is a tap of 12 outputs). g streams
//     in as float4, 16 lanes per pixel (two pixels per warp and step), and
//     the 16 partial sums meet in 4 butterfly rounds: a fixed order.
//     Arrays that are not 16-byte aligned take the per-warp kernel;
//   * per warp, for other C >= 32 (odd channel counts, a 32x32x64 image
//     of 256 KB): lanes take channels lane, lane+32, ..., gathered from
//     global memory, and meet in a butterfly of warp shuffles;
//   * per quad (dcoords_per_quad_bf16), for bf16 at C < 32 (the input ST
//     at C = 3) where h w C values fill whole 16-byte vectors, the image
//     and its widened copy fit one block's opt-in shared memory and img,
//     g, the coordinates and d_coords are 16-byte aligned: the design of
//     the bf16 per-quad forward (bilinear_sample.cu, sample_per_quad_bf16)
//     against what bounds the per-pixel kernel in bf16, the count of
//     2-byte memory instructions (19 a pixel at C = 3 for ~20 bytes). One
//     block per sample stages the image with 16-byte cp.async and widens
//     it in shared memory to 4-channel groups (a tap is one 8-byte read);
//     a thread takes 4 neighbouring output pixels: their coordinates as
//     two 8-byte loads (rows) or one 16-byte load (grid), their g as C
//     8-byte loads, their d_coords as two 8-byte stores (rows: 4 dy, 4 dx)
//     or one 16-byte store (grid: 4 (dy, dx) pairs). Each pixel's sums are
//     the per-pixel kernel's, channel by channel, rounded once: the same
//     bits. Where p % 4 != 0 it loads and stores pixel by pixel;
//   * per pixel, for the other C < 32 (all of f32: at 58% of its byte
//     bound it was left alone), summing its channels in order.
//
// d_img[n, tap, c] += g[p,c] * weight(tap, p) over the output pixels p.
// Many output pixels reach one input pixel, at positions only the
// coordinates decide, so this is a scatter. It is made deterministic, with
// no atomics on floats (the original Torch sampler was pinned to the CPU
// for its non-determinism; catgen pins same-seed steps bit-identical).
// Three kernels, chosen by shape alone (dimg_kind), the same way on every
// run:
//   * per sample, for C < 32 whose h w C slab fits four times in a block's
//     opt-in shared memory (the input ST, 32x32x3: 12 KB): one block per
//     sample, of up to 8 warps, each owning a private slab of d_img in
//     shared memory and the output pixels of every warps-th chunk of 32,
//     one lane per pixel. For each of the 4 taps in turn, the lanes that
//     hit the same input pixel (__match_any_sync on its index: a zoomed-in
//     transform sends several outputs to one tap) are summed in lane
//     order by shuffles, and the lowest of them adds the sum into the
//     slab; __syncwarp orders the rounds. Then the slabs are added in warp
//     order and written with coalesced stores. Every sum has one order,
//     fixed by the shape: lanes within a round, rounds and chunks within a
//     slab, slabs by warp. The work is 1024 pixels a sample spread over
//     256 lanes;
//   * gather (dimg_gather), otherwise (the branch shape, 16x16x64, every
//     C >= 32 and images too large for four slabs) where its block fits
//     the card's shared memory (32 bytes per input pixel and 28 per output
//     pixel of a pass: every image up to 79x79): the scatter turned into
//     a gather. One block of 8 warps per sample, in passes of up to 1024
//     output pixels (one pass at the branch shape's 768):
//       1. bucket: each entry (output pixel pi, tap k) belongs to the bin
//          of the input pixel it reaches. Each warp takes a contiguous
//          range of the pass's pixels, a lane per pixel: it reads the
//          pixel's coordinates once, keeps its weights (wy, wx) and its
//          packed taps in shared memory, and counts its 4 entries per bin
//          with shared-memory integer atomics (exact in any order). A
//          block scan over (bin, warp) gives each warp its run in each
//          bin, and each warp then places its entries in order, 32 a
//          round, the lanes that hit one bin (__match_any_sync) in lane
//          order. So every bin lists its entries in (pi, k) order on every
//          run, with no sort. At the branch shape: 12 KB of entries, 9 KB
//          of weights and taps, 8 KB of cursors;
//       2. gather: a warp per input pixel, its lanes over channels (a
//          float2 each at even C: one 256-byte row of g per entry at C =
//          64) sums the bin's entries in order in registers and writes its
//          d_img row once, coalesced. The g rows of 8 entries are fetched
//          at once, so that a warp keeps 8 loads in flight: the kernel is
//          bound by their latency. A warp takes the next bin when it is
//          done with one (a shared-memory counter), so that a zoomed
//          transform's few large bins do not all fall to one warp; which
//          warp sums a bin does not change the sum. The next pass goes on
//          from the sum.
//     So d_img[n, q, c] = sum over the entries (pi, k) of bin q, in
//     increasing pi, then k, each added in turn to the running f32 sum,
//     starting from 0, of (g[n, pi, c] * wy') * wx', where wy' is 1 - wy
//     for k < 2 and wy otherwise, and wx' is 1 - wx for even k and wx
//     otherwise. No slab of d_img, no scatter, no atomics on floats; g is
//     read once per tap (4 times), through L1.
//   * per channel, for the rest (a few channels on more than 79x79
//     pixels, 128x128x1 say): one block per (sample, slab of up to 32 channels)
//     keeps that slab in shared memory, and each thread owns one channel
//     column of it, walking the output pixels in order; no two threads
//     touch one address. h*w*min(C, 32)*4 bytes of shared memory.
// What bounds d_img: bytes at the branch shape (126 MB of g, 42 MB of
// d_img, 4 MB of coordinates: 0.0513 ms at 3.35 TB/s), but each g row is
// read 4 times, from L1 or L2, and every entry costs a few shared-memory
// reads; latency at the input ST (0.0063 ms of traffic at batch 640),
// where the per-sample kernel runs a P / (32 warps)-long chain per warp,
// in rounds of match, shuffle and shared-memory add.
//
// Arithmetic is f32 and rounds each tap's product as the plain PyTorch
// version's autograd does (built with --fmad=false); the sums over C and
// over output pixels run in another order, so the results agree to f32
// rounding, not bit for bit.
//
// Every kernel is instantiated for float and for __nv_bfloat16 (catgen's
// bf16 compute dtype: image, coordinates, g, d_img and d_coords in bf16).
// A bf16 kernel reads its values exactly into f32 and does the f32
// kernel's arithmetic; d_img is summed in f32 whatever the input type (v4
// sums it in f32 and casts once, pallas_bilinear_v4.py:1031), in shared
// memory or registers of the f32 size, and rounded once, to nearest even,
// where it is stored; d_coords too is an f32 sum rounded once into the
// coordinates' type (:1032). So a bf16 result is the f32 kernel's sum
// rounded once, and differs from the plain version's (its f32 autograd
// rounded once) only where the two f32 sums round to neighbouring bf16
// values. The staged d_coords kernel gives 8 lanes of 16 bytes (8 values)
// to a pixel at C = 64 in bf16, where f32 gives 16 lanes of 4 values; the
// gather's lanes load channel pairs (8 bytes in f32, 4 in bf16). Where a
// gather d_img takes more than one pass over the output pixels (more than
// 1024 per sample), the running f32 sums between passes go to a scratch
// array the wrapper allocates, not to the bf16 output.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bilinear_taps.cuh"

namespace {

struct TapGrad {
  float dy, dx;  // d out / d wy and d out / d wx for one channel
};

template <class T>
__device__ __forceinline__ TapGrad tap_grad(const T* __restrict__ base,
                                            const Taps& t, int c) {
  const float v00 = ldf(base + t.p00 * c);
  const float v01 = ldf(base + t.p01 * c);
  const float v10 = ldf(base + t.p10 * c);
  const float v11 = ldf(base + t.p11 * c);
  const float top = v00 * (1.0f - t.wx) + v01 * t.wx;
  const float bot = v10 * (1.0f - t.wx) + v11 * t.wx;
  TapGrad r;
  r.dy = bot - top;
  r.dx = (1.0f - t.wy) * (v01 - v00) + t.wy * (v11 - v10);
  return r;
}

template <class L, class T>
__device__ __forceinline__ void store_dcoords(T* __restrict__ dcrd,
                                              const Taps& t, float sy,
                                              float sx, int h, int w, int p,
                                              int ni, int pi) {
  L::store(dcrd, ni, pi, p, sy * t.in_y * (0.5f * (float)(h - 1)),
           sx * t.in_x * (0.5f * (float)(w - 1)));
}

// img (n, h, w, c), coordinates and dcrd in layout L, g (n, p, c).
template <class L, class T>
__global__ void dcoords_per_warp(const T* __restrict__ img,
                                 const T* __restrict__ crd,
                                 const T* __restrict__ g,
                                 T* __restrict__ dcrd, int n, int h, int w,
                                 int c, int p) {
  const int64_t pix = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (pix >= (int64_t)n * p) return;  // warp-uniform: whole warps leave
  const int pi = (int)(pix % p);
  const int ni = (int)(pix / p);
  const float2 yx = L::load(crd, ni, pi, p);
  const Taps t = make_taps(yx.x, yx.y, h, w);
  const T* base = img + (int64_t)ni * h * w * c;
  const T* gp = g + pix * c;
  float sy = 0.0f, sx = 0.0f;
  for (int ch = lane; ch < c; ch += 32) {
    const TapGrad r = tap_grad(base + ch, t, c);
    const float gv = ldf(gp + ch);
    sy += gv * r.dy;
    sx += gv * r.dx;
  }
  for (int off = 16; off > 0; off >>= 1) {
    sy += __shfl_xor_sync(0xffffffffu, sy, off);
    sx += __shfl_xor_sync(0xffffffffu, sx, off);
  }
  if (lane == 0) store_dcoords<L>(dcrd, t, sy, sx, h, w, p, ni, pi);
}

template <class L, class T>
__global__ void dcoords_per_pixel(const T* __restrict__ img,
                                  const T* __restrict__ crd,
                                  const T* __restrict__ g,
                                  T* __restrict__ dcrd, int n, int h, int w,
                                  int c, int p) {
  const int64_t pix = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (int64_t)n * p) return;
  const int pi = (int)(pix % p);
  const int ni = (int)(pix / p);
  const float2 yx = L::load(crd, ni, pi, p);
  const Taps t = make_taps(yx.x, yx.y, h, w);
  const T* base = img + (int64_t)ni * h * w * c;
  const T* gp = g + pix * c;
  float sy = 0.0f, sx = 0.0f;
  for (int ch = 0; ch < c; ++ch) {
    const TapGrad r = tap_grad(base + ch, t, c);
    const float gv = ldf(gp + ch);
    sy += gv * r.dy;
    sx += gv * r.dx;
  }
  store_dcoords<L>(dcrd, t, sy, sx, h, w, p, ni, pi);
}

constexpr int kStagedThreads = 512;  // 16 warps
constexpr int kStagedPixels = 256;   // most output pixels per block

// Lanes that serve one output pixel: one 16-byte vector each at C = 64
// (16 in f32, two pixels per warp and step; 8 in bf16, four)
template <class T>
constexpr int kStagedLanes = 64 / Vec<T>::N;

// Grid: n * per_sample blocks, the blocks of one sample adjacent; block
// (ni, part) covers output pixels [part * span, (part + 1) * span) of
// sample ni. img and g 16-byte aligned, c a multiple of Vec<T>::N; dynamic
// shared memory h*w*c values of T.
template <class L, class T>
__global__ void __launch_bounds__(kStagedThreads)
dcoords_staged(const T* __restrict__ img, const T* __restrict__ crd,
               const T* __restrict__ g, T* __restrict__ dcrd, int h, int w,
               int c, int p, int per_sample, int span) {
  constexpr int N = Vec<T>::N, LP = kStagedLanes<T>, PW = 32 / LP;
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

  // every lane of a warp runs every step, so the shuffles see all lanes
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l = lane % LP;
  const int warps = blockDim.x >> 5;
  for (int base = p0 + PW * warp; base < p1; base += PW * warps) {
    const int pi = base + lane / LP;
    const bool active = pi < p1;
    float sy = 0.0f, sx = 0.0f;
    Taps t = {};
    if (active) {
      const float2 yx = L::load(crd, ni, pi, p);
      t = make_taps(yx.x, yx.y, h, w);
      const uint4* gp =
          reinterpret_cast<const uint4*>(g) + ((int64_t)ni * p + pi) * cv;
      const int o00 = (int)t.p00 * cv, o01 = (int)t.p01 * cv;
      const int o10 = (int)t.p10 * cv, o11 = (int)t.p11 * cv;
      for (int k = l; k < cv; k += LP) {
        float gs[N], v00[N], v01[N], v10[N], v11[N];
        Vec<T>::unpack(__ldg(gp + k), gs);
        Vec<T>::unpack(simg[o00 + k], v00);
        Vec<T>::unpack(simg[o01 + k], v01);
        Vec<T>::unpack(simg[o10 + k], v10);
        Vec<T>::unpack(simg[o11 + k], v11);
#pragma unroll
        for (int j = 0; j < N; ++j) {
          // tap_grad's arithmetic, channel by channel
          const float top = v00[j] * (1.0f - t.wx) + v01[j] * t.wx;
          const float bot = v10[j] * (1.0f - t.wx) + v11[j] * t.wx;
          const float dy = bot - top;
          const float dx =
              (1.0f - t.wy) * (v01[j] - v00[j]) + t.wy * (v11[j] - v10[j]);
          sy += gs[j] * dy;
          sx += gs[j] * dx;
        }
      }
    }
    for (int off = LP / 2; off > 0; off >>= 1) {   // within the pixel's lanes
      sy += __shfl_xor_sync(0xffffffffu, sy, off);
      sx += __shfl_xor_sync(0xffffffffu, sx, off);
    }
    if (active && l == 0) store_dcoords<L>(dcrd, t, sy, sx, h, w, p, ni, pi);
  }
}

constexpr int kQuadThreads = 256;
constexpr int kQuadPixels = 4;     // output pixels a thread

// Shared memory of the per-quad kernel at (h, w, c): the sample's image as
// it lies (16-byte cp.async; `raw` bytes, rounded to 16) and its widened
// copy.
static inline int64_t quad_raw_bytes(int h, int w, int c) {
  return ((int64_t)h * w * c * 2 + 15) / 16 * 16;
}
static inline int64_t quad_smem_bytes(int h, int w, int c) {
  return quad_raw_bytes(h, w, c) + wide_bytes(h, w, c);
}

// bf16 per quad. Grid n, one block per sample; thread t takes the quads of
// 4 neighbouring output pixels [4 q, 4 q + 4) for q = t, t + blockDim.x,
// .... CT: c when it is 1..4 (the quad's g in registers, unpacked at
// indices fixed at compile time), else 0 (any c < 32; g read value by
// value). img, crd, g and dcrd 16-byte aligned, h w c values a whole
// number of 16-byte vectors, c < 32; `raw` is quad_raw_bytes(h, w, c), the
// dynamic shared memory quad_smem_bytes(h, w, c).
template <class L, int CT>
__global__ void __launch_bounds__(kQuadThreads)
dcoords_per_quad_bf16(const __nv_bfloat16* __restrict__ img,
                      const __nv_bfloat16* __restrict__ crd,
                      const __nv_bfloat16* __restrict__ g,
                      __nv_bfloat16* __restrict__ dcrd, int h, int w,
                      int c_rt, int p, int raw) {
  constexpr int G = kQuadPixels;
  const int c = CT > 0 ? CT : c_rt;
  extern __shared__ uint4 smem4[];
  const unsigned short* part = reinterpret_cast<const unsigned short*>(smem4);
  // the widened image, (h w, cg) groups of 4 channels
  uint2* wide =
      reinterpret_cast<uint2*>(reinterpret_cast<uint8_t*>(smem4) + raw);
  const int ni = blockIdx.x, tid = threadIdx.x;
  const int hw = h * w, cg = (c + 3) / 4;
  const int chunks = hw * c / 8;
  stage_async(smem4, reinterpret_cast<const uint4*>(img) + (int64_t)ni * chunks,
              chunks);
  asm volatile("cp.async.commit_group;\n" ::);
  // p % 4 == 0: every quad's coordinates, g and d_coords are whole
  // aligned vectors
  const bool vec = p % G == 0;
  const __nv_bfloat16* gs = g + (int64_t)ni * p * c;
  // the first quad's coordinates and g are in flight during the staging
  float ys[G] = {}, xs[G] = {};
  uint2 gq[CT > 0 ? CT : 1];
  auto load_quad = [&](int q) {
    L::load4(crd, ni, G * q, p, ys, xs);
    if constexpr (CT > 0) {
      const uint2* gv = reinterpret_cast<const uint2*>(gs + G * q * CT);
#pragma unroll
      for (int i = 0; i < CT; ++i) gq[i] = __ldg(gv + i);
    }
  };
  if (vec && G * tid < p) load_quad(tid);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  widen4(wide, part, hw, c);
  __syncthreads();

  for (int q = tid; G * q < p; q += blockDim.x) {
    float gv[CT > 0 ? G * CT : 1];
    if constexpr (CT > 0) {
#pragma unroll
      for (int i = 0; i < CT; ++i) unpack4(gq[i], gv + 4 * i);
    }
    float dy[G], dx[G];
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
      // tap_grad's arithmetic, channels 0 .. c-1 in order
      float sy = 0.0f, sx = 0.0f;
      for (int k = 0; k < cg; ++k) {
        float v00[4], v01[4], v10[4], v11[4];
        unpack4(wide[(int)t.p00 * cg + k], v00);
        unpack4(wide[(int)t.p01 * cg + k], v01);
        unpack4(wide[(int)t.p10 * cg + k], v10);
        unpack4(wide[(int)t.p11 * cg + k], v11);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ch = 4 * k + i;
          if (ch >= c) break;
          float gc;
          if constexpr (CT > 0) {
            gc = vec ? gv[j * CT + i] : ldf(gs + pi * CT + i);
          } else {
            gc = ldf(gs + pi * c + ch);
          }
          const float top = v00[i] * (1.0f - t.wx) + v01[i] * t.wx;
          const float bot = v10[i] * (1.0f - t.wx) + v11[i] * t.wx;
          const float ry = bot - top;
          const float rx =
              (1.0f - t.wy) * (v01[i] - v00[i]) + t.wy * (v11[i] - v10[i]);
          sy += gc * ry;
          sx += gc * rx;
        }
      }
      // store_dcoords' scaling
      dy[j] = sy * t.in_y * (0.5f * (float)(h - 1));
      dx[j] = sx * t.in_x * (0.5f * (float)(w - 1));
      if (!vec) L::store(dcrd, ni, pi, p, dy[j], dx[j]);
    }
    if (vec) {
      L::store4(dcrd, ni, G * q, p, dy, dx);
      const int next = q + blockDim.x;
      if (G * next < p) load_quad(next);
    }
  }
}

// The d_coords kernel (h, w, c) takes for elements of `elem` bytes with
// 16-byte aligned arrays: for C >= 32 sampler_kind's (shared with the
// forward); for C < 32 in bf16 kPerQuad where h w C values fill whole
// 16-byte vectors (each sample's image starts on 16 bytes) and the image
// with its widened copy fits one block's opt-in shared memory
// (quad_smem_bytes), else kPerPixel (and kPerPixel for every f32 C < 32).
// A negative cudaError_t if the card's shared memory could not be read.
int dcoords_shape_kind(int h, int w, int c, int elem) {
  if (c >= 32) return sampler_kind(h, w, c, elem);
  if (elem != 2 || (int64_t)h * w * c * elem % 16 != 0) return kPerPixel;
  const int optin = optin_smem();
  if (optin < 0) return optin;
  return quad_smem_bytes(h, w, c) <= optin ? kPerQuad : kPerPixel;
}

template <class L>
int launch_quad(const __nv_bfloat16* img, const __nv_bfloat16* crd,
                 const __nv_bfloat16* g, __nv_bfloat16* dcrd, int n, int h,
                 int w, int c, int p, int smem, cudaStream_t s) {
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*,
                 const __nv_bfloat16*, __nv_bfloat16*, int, int, int, int,
                 int) = c == 1   ? dcoords_per_quad_bf16<L, 1>
                        : c == 2 ? dcoords_per_quad_bf16<L, 2>
                        : c == 3 ? dcoords_per_quad_bf16<L, 3>
                        : c == 4 ? dcoords_per_quad_bf16<L, 4>
                                 : dcoords_per_quad_bf16<L, 0>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)n, kQuadThreads, (size_t)smem, s>>>(
      img, crd, g, dcrd, h, w, c, p, (int)quad_raw_bytes(h, w, c));
  return 0;
}

template <class L, class T>
int launch_dcoords(const T* img, const T* crd, const T* g, T* dcrd, int n,
                   int h, int w, int c, int p, void* stream) {
  const int threads = 256;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t pixels = (int64_t)n * p;
  if (pixels == 0) return 0;
  int kind = dcoords_shape_kind(h, w, c, (int)sizeof(T));
  if (kind < 0) return -kind;
  const bool aligned = aligned16(img) && aligned16(g);
  if (kind == kStaged && !aligned) kind = kPerWarp;
  if (kind == kPerQuad &&
      !(aligned && aligned16(crd) && aligned16(dcrd) &&
        (int64_t)p * c < ((int64_t)1 << 31))) {
    kind = kPerPixel;
  }
  if (kind == kPerQuad) {
    if constexpr (sizeof(T) == 2) {
      const int err = launch_quad<L>(img, crd, g, dcrd, n, h, w, c, p,
                                     (int)quad_smem_bytes(h, w, c), s);
      if (err != 0) return err;
    }
  } else if (kind == kStaged) {
    const int smem = (int)staged_smem_bytes(h, w, c, (int)sizeof(T));
    const cudaError_t err = cudaFuncSetAttribute(
        dcoords_staged<L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
    const int per_sample = (p + kStagedPixels - 1) / kStagedPixels;
    const int span = (p + per_sample - 1) / per_sample;
    dcoords_staged<L, T><<<(unsigned)((int64_t)n * per_sample),
                           kStagedThreads, smem, s>>>(
        img, crd, g, dcrd, h, w, c, p, per_sample, span);
  } else if (kind == kPerWarp) {
    const unsigned blocks = (unsigned)((pixels * 32 + threads - 1) / threads);
    dcoords_per_warp<L, T><<<blocks, threads, 0, s>>>(img, crd, g, dcrd, n, h,
                                                      w, c, p);
  } else {
    const unsigned blocks = (unsigned)((pixels + threads - 1) / threads);
    dcoords_per_pixel<L, T><<<blocks, threads, 0, s>>>(img, crd, g, dcrd, n,
                                                       h, w, c, p);
  }
  return (int)cudaGetLastError();
}

constexpr int kSampleWarps = 8;   // most warps (slabs) of a per-sample block
constexpr int kSampleMinSlabs = 4;

// Grid n, 32 * warps threads; dynamic shared memory warps * h*w*c floats
// (f32 sums whatever T is). dimg (n, h, w, c).
template <class L, class T>
__global__ void dimg_per_sample(const T* __restrict__ crd,
                                const T* __restrict__ g,
                                T* __restrict__ dimg, int h, int w, int c,
                                int p) {
  extern __shared__ float slabs[];
  const int ni = blockIdx.x;
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vals = h * w * c;
  for (int i = threadIdx.x; i < warps * vals; i += blockDim.x) slabs[i] = 0.0f;
  __syncthreads();
  float* slab = slabs + warp * vals;
  const T* gs = g + (int64_t)ni * p * c;
  for (int base = 32 * warp; base < p; base += 32 * warps) {
    const int pi = base + lane;
    const bool active = pi < p;
    Taps t = {};
    if (active) {
      const float2 yx = L::load(crd, ni, pi, p);
      t = make_taps(yx.x, yx.y, h, w);
    }
    const T* gp = gs + (int64_t)pi * c;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int64_t tap = k == 0 ? t.p00 : k == 1 ? t.p01 : k == 2 ? t.p10
                                                                   : t.p11;
      // the lanes that add into this tap; an idle lane matches none
      const unsigned peers =
          __match_any_sync(0xffffffffu, active ? (int)tap : -1 - lane);
      const bool leader = active && lane == __ffs(peers) - 1;
      for (int ch = 0; ch < c; ++ch) {
        float v = 0.0f;
        if (active) {
          // the weight's rounding of the plain version's autograd
          const float gv = ldf(gp + ch);
          const float gy = (k < 2) ? gv * (1.0f - t.wy) : gv * t.wy;
          v = (k & 1) ? gy * t.wx : gy * (1.0f - t.wx);
        }
        // the group's values in lane order, the lowest lane first
        float s = 0.0f;
        unsigned rest = peers;
        while (__any_sync(0xffffffffu, rest != 0u)) {
          const int src = rest ? __ffs(rest) - 1 : lane;
          const float o = __shfl_sync(0xffffffffu, v, src);
          if (rest) {
            s += o;
            rest &= rest - 1u;
          }
        }
        if (leader) slab[tap * c + ch] += s;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  T* out = dimg + (int64_t)ni * vals;
  for (int i = threadIdx.x; i < vals; i += blockDim.x) {
    float s = 0.0f;
    for (int k = 0; k < warps; ++k) s += slabs[k * vals + i];
    stf(out + i, s);
  }
}

constexpr int kGatherThreads = 256;  // 8 warps
constexpr int kGatherWarps = kGatherThreads / 32;
constexpr int kGatherPixels = 1024;  // most output pixels per pass
constexpr int kGatherBatch = 8;      // entries whose g rows are in flight

// The shared memory of a gather block whose passes take `pixels` output
// pixels of an image of `hw` pixels, in bytes: each pixel's (wy, wx) and
// packed taps, one cursor per (input pixel, warp), 4 entries per pixel,
// the warps' sums of the scan and the bin counter.
static inline int64_t gather_smem_bytes(int64_t hw, int64_t pixels) {
  return pixels * (int64_t)(sizeof(float2) + sizeof(int)) +
         (hw * kGatherWarps + 4 * pixels + kGatherWarps + 1) *
             (int64_t)sizeof(int);
}

// In-place exclusive prefix sum of a[0, m) by the whole block (every
// thread calls it); wsum holds one int per warp.
__device__ void block_exclusive_scan(int* a, int m, int* wsum) {
  const int per = (m + blockDim.x - 1) / blockDim.x;
  const int b = min((int)threadIdx.x * per, m), e = min(b + per, m);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int own = 0;
  for (int i = b; i < e; ++i) own += a[i];
  int incl = own;
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int warps = blockDim.x >> 5;
    int v = lane < warps ? wsum[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += u;
    }
    if (lane < warps) wsum[lane] = v;
  }
  __syncthreads();
  int run = (warp > 0 ? wsum[warp - 1] : 0) + incl - own;
  for (int i = b; i < e; ++i) {
    const int x = a[i];
    a[i] = run;
    run += x;
  }
}

// Input pixel of tap k of a pixel whose taps are packed as p00 << 2 |
// (y1 - y0) << 1 | (x1 - x0), for an image w pixels wide.
__device__ __forceinline__ int tap_pixel(int code, int k, int w) {
  return (code >> 2) + (k & code & 1) + ((k >> 1) & (code >> 1) & 1) * w;
}

// V channels of a g row, from `gp`, in f32 (V == 2: one load of the pair)
template <int V>
__device__ __forceinline__ void load_g(const float* __restrict__ gp,
                                       float (&gv)[V]) {
  if constexpr (V == 2) {
    const float2 v2 = __ldg(reinterpret_cast<const float2*>(gp));
    gv[0] = v2.x;
    gv[1] = v2.y;
  } else {
    gv[0] = __ldg(gp);
  }
}

template <int V>
__device__ __forceinline__ void load_g(const __nv_bfloat16* __restrict__ gp,
                                       float (&gv)[V]) {
  if constexpr (V == 2) {
    const uint32_t v2 = __ldg(reinterpret_cast<const unsigned int*>(gp));
    gv[0] = __uint_as_float(v2 << 16);
    gv[1] = __uint_as_float(v2 & 0xffff0000u);
  } else {
    gv[0] = ldf(gp);
  }
}

// Writes V sums from f32 to `o` (V == 2: one store of the pair)
template <int V>
__device__ __forceinline__ void store_sums(float* o, const float (&acc)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<float2*>(o) = make_float2(acc[0], acc[1]);
  } else {
    o[0] = acc[0];
  }
}

template <int V>
__device__ __forceinline__ void store_sums(__nv_bfloat16* o,
                                           const float (&acc)[V]) {
  if constexpr (V == 2) {
    *reinterpret_cast<uint32_t*>(o) =
        Vec<__nv_bfloat16>::bits(acc[0]) |
        Vec<__nv_bfloat16>::bits(acc[1]) << 16;
  } else {
    stf(o, acc[0]);
  }
}

// Adds entry e's term to the sums, with the weight's rounding of the
// plain version's autograd: (g * wy') * wx'.
template <int V>
__device__ __forceinline__ void add_entry(float (&acc)[V],
                                          const float (&gv)[V], int e,
                                          const float2* wts) {
  const float2 wt = wts[e >> 2];
  const float a = (e & 2) ? wt.x : 1.0f - wt.x;
  const float b = (e & 1) ? wt.y : 1.0f - wt.y;
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] += (gv[v] * a) * b;
}

// Grid n, kGatherThreads threads; dynamic shared memory
// gather_smem_bytes(h w, pixels). Each pass takes up to `pixels` output
// pixels [p0, p0 + np) of the sample; an entry e = 4 (pi - p0) + k stands
// for tap k of output pixel pi. V channels per lane and load: 2 (a pair)
// for even c with g and dimg aligned to a pair, else 1. dimg (n, h, w, c).
// `part` (n, h, w, c) f32 holds the running sums between passes: for f32
// it is dimg itself (so neither pointer is __restrict__); for bf16 a
// scratch array, needed only where p > pixels (null otherwise). The last
// pass writes dimg.
template <class L, class T, int V>
__global__ void __launch_bounds__(kGatherThreads)
dimg_gather(const T* __restrict__ crd, const T* __restrict__ g, T* dimg,
            float* part, int h, int w, int c, int p, int pixels) {
  extern __shared__ float2 wts[];                    // each pixel's (wy, wx)
  int* code = reinterpret_cast<int*>(wts + pixels);  // its taps, packed
  const int hw = h * w;
  int* cur = code + pixels;               // (input pixel, warp)
  int* ent = cur + hw * kGatherWarps;     // entries, bin by bin
  int* wsum = ent + 4 * pixels;
  int* next = wsum + kGatherWarps;        // the next bin to sum
  const int ni = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* gs = g + (int64_t)ni * p * c;
  T* out = dimg + (int64_t)ni * hw * c;
  float* run_sums = part ? part + (int64_t)ni * hw * c : nullptr;
  // at least one pass, so that p == 0 writes zeros
  for (int p0 = 0; p0 == 0 || p0 < p; p0 += pixels) {
    const int np = min(pixels, p - p0);
    const bool last = p0 + pixels >= p;
    // the warp's pixels [pa, pb): a contiguous range of the pass's
    const int span = (np + kGatherWarps - 1) / kGatherWarps;
    const int pa = min(warp * span, np), pb = min(pa + span, np);
    for (int i = threadIdx.x; i < hw * kGatherWarps; i += blockDim.x) {
      cur[i] = 0;
    }
    if (threadIdx.x == 0) *next = 0;
    __syncthreads();
    // 1. each pixel's taps and weights, and the entries of each (input
    //    pixel, warp): integer atomics count exactly in any order
    for (int i = pa + lane; i < pb; i += 32) {
      const float2 yx = L::load(crd, ni, p0 + i, p);
      const Taps t = make_taps(yx.x, yx.y, h, w);
      const int packed = (int)t.p00 << 2 | (t.p10 != t.p00) << 1 |
                         (int)(t.p01 - t.p00);
      code[i] = packed;
      wts[i] = make_float2(t.wy, t.wx);
      for (int k = 0; k < 4; ++k) {
        atomicAdd(&cur[tap_pixel(packed, k, w) * kGatherWarps + warp], 1);
      }
    }
    __syncthreads();
    // 2. where each run starts: input pixel-major, then warp
    block_exclusive_scan(cur, hw * kGatherWarps, wsum);
    __syncthreads();
    // 3. each warp places its entries in order, 32 a round: the lanes that
    //    hit one input pixel take consecutive slots in lane order
    for (int base = 4 * pa; base < 4 * pb; base += 32) {
      const int e = base + lane;
      const bool active = e < 4 * pb;
      // an idle lane matches none
      const int bin = active ? tap_pixel(code[e >> 2], e & 3, w) : -1 - lane;
      const unsigned peers = __match_any_sync(0xffffffffu, bin);
      int* run = &cur[(active ? bin : 0) * kGatherWarps + warp];
      if (active) ent[*run + __popc(peers & ((1u << lane) - 1u))] = e;
      __syncwarp();
      if (active && lane == __ffs(peers) - 1) *run += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // cur[q W + k] now ends the run of (q, k), so bin q is [the end of
    // (q - 1, W - 1), the end of (q, W - 1)).
    // 4. a warp per input pixel, the next one whenever it is done (bins
    //    differ in size; which warp sums a bin does not change its sum),
    //    its lanes over channels: each sum runs over the bin's entries in
    //    order, on from the last pass's sum; the g rows of kGatherBatch
    //    entries are fetched at once
    for (;;) {
      int qi = 0;
      if (lane == 0) qi = atomicAdd(next, 1);
      qi = __shfl_sync(0xffffffffu, qi, 0);
      if (qi >= hw) break;
      const int j0 = qi > 0 ? cur[qi * kGatherWarps - 1] : 0;
      const int j1 = cur[qi * kGatherWarps + kGatherWarps - 1];
      for (int c0 = 0; c0 < c; c0 += 32 * V) {
        const int ch = c0 + V * lane;
        if (ch >= c) continue;
        const int64_t at = (int64_t)qi * c + ch;
        float acc[V];
#pragma unroll
        for (int v = 0; v < V; ++v) acc[v] = p0 > 0 ? run_sums[at + v] : 0.0f;
        int j = j0;
        for (; j + kGatherBatch <= j1; j += kGatherBatch) {
          int en[kGatherBatch];
          float gv[kGatherBatch][V];
#pragma unroll
          for (int u = 0; u < kGatherBatch; ++u) {
            en[u] = ent[j + u];
            load_g<V>(gs + (int64_t)(p0 + (en[u] >> 2)) * c + ch, gv[u]);
          }
#pragma unroll
          for (int u = 0; u < kGatherBatch; ++u) {
            add_entry<V>(acc, gv[u], en[u], wts);
          }
        }
        for (; j < j1; ++j) {
          float gv[V];
          const int en = ent[j];
          load_g<V>(gs + (int64_t)(p0 + (en >> 2)) * c + ch, gv);
          add_entry<V>(acc, gv, en, wts);
        }
        if (last) {
          store_sums<V>(out + at, acc);
        } else {
          store_sums<V>(run_sums + at, acc);
        }
      }
    }
    __syncthreads();  // the next pass reuses the shared memory
  }
}

constexpr int kSlab = 32;  // channels per d_img block

// Grid (n, ceil(c / kSlab)), kSlab threads; dynamic shared memory
// h*w*cs floats, cs = the slab's width. dimg (n, h, w, c).
template <class L, class T>
__global__ void dimg_per_channel(const T* __restrict__ crd,
                                 const T* __restrict__ g,
                                 T* __restrict__ dimg, int n, int h, int w,
                                 int c, int p) {
  extern __shared__ float acc[];
  const int ni = blockIdx.x;
  const int c0 = blockIdx.y * kSlab;
  const int cs = min(kSlab, c - c0);
  const int lane = threadIdx.x;
  if (lane >= cs) return;  // no barrier below: each thread owns a column
  const int hw = h * w;
  for (int i = 0; i < hw; ++i) acc[i * cs + lane] = 0.0f;
  const T* gp = g + (int64_t)ni * p * c + c0 + lane;
#pragma unroll 4
  for (int pi = 0; pi < p; ++pi) {
    const float2 yx = L::load(crd, ni, pi, p);
    const Taps t = make_taps(yx.x, yx.y, h, w);
    const float gv = ldf(gp + (int64_t)pi * c);
    const float top = gv * (1.0f - t.wy);
    const float bot = gv * t.wy;
    acc[t.p00 * cs + lane] += top * (1.0f - t.wx);
    acc[t.p01 * cs + lane] += top * t.wx;
    acc[t.p10 * cs + lane] += bot * (1.0f - t.wx);
    acc[t.p11 * cs + lane] += bot * t.wx;
  }
  T* out = dimg + (int64_t)ni * hw * c + c0 + lane;
  for (int i = 0; i < hw; ++i) stf(out + (int64_t)i * c, acc[i * cs + lane]);
}

enum DimgKind { kDimgPerChannel = 0, kDimgPerSample = 1, kDimgGather = 2 };

// Slabs (warps) of a per-sample block at (h, w, c): as many as fit, up to
// kSampleWarps; 0 where the shape takes another kernel (c >= 32, or fewer
// than kSampleMinSlabs fit); a negative cudaError_t on failure. The slabs
// hold f32 sums for every element type.
int dimg_sample_warps(int h, int w, int c) {
  if (c >= 32) return 0;
  const int optin = optin_smem();
  if (optin < 0) return optin;
  const int64_t slab = (int64_t)h * w * c * (int64_t)sizeof(float);
  if (slab == 0) return kSampleWarps;
  const int64_t fit = optin / slab;
  if (fit < kSampleMinSlabs) return 0;
  return fit < kSampleWarps ? (int)fit : kSampleWarps;
}

// The d_img kernel (h, w, c) takes: per sample where four slabs fit, else
// gather where its block (at a full pass) fits the card's shared memory,
// else per channel (a few channels on more than 79x79 pixels); a negative
// cudaError_t on failure. Every kernel sums in f32 in shared memory or
// registers whatever the element type, so the choice is the same for f32
// and bf16.
int dimg_kind(int h, int w, int c) {
  const int warps = dimg_sample_warps(h, w, c);
  if (warps != 0) return warps < 0 ? warps : kDimgPerSample;
  const int optin = optin_smem();
  if (optin < 0) return optin;
  return gather_smem_bytes((int64_t)h * w, kGatherPixels) <= optin
             ? kDimgGather
             : kDimgPerChannel;
}

// The shared memory of the d_img block (h, w, c) takes, in bytes (the
// gather kernel's at a full pass), or a negative cudaError_t
int64_t dimg_smem_bytes(int h, int w, int c) {
  const int kind = dimg_kind(h, w, c);
  if (kind < 0) return kind;
  const int64_t hw = (int64_t)h * w;
  if (kind == kDimgGather) return gather_smem_bytes(hw, kGatherPixels);
  const int64_t cs = kind == kDimgPerSample
                         ? (int64_t)dimg_sample_warps(h, w, c) * c
                         : (c < kSlab ? c : kSlab);
  return hw * cs * (int64_t)sizeof(float);
}

// `part`: f32 (n, h, w, c) for the gather's running sums between passes;
// for f32 it may be null (dimg serves), for bf16 it must be given where
// the gather takes more than one pass (p > kGatherPixels).
template <class L, class T>
int launch_dimg(const T* crd, const T* g, T* dimg, float* part, int n, int h,
                int w, int c, int p, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((int64_t)n * h * w * c == 0) return 0;
  const int kind = dimg_kind(h, w, c);
  if (kind < 0) return -kind;
  const int64_t smem = dimg_smem_bytes(h, w, c);
  const int optin = optin_smem();
  if (optin < 0) return -optin;
  if (smem > optin) return (int)cudaErrorInvalidValue;
  if (kind == kDimgPerSample) {
    const cudaError_t err = cudaFuncSetAttribute(
        dimg_per_sample<L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    dimg_per_sample<L, T><<<(unsigned)n, 32 * dimg_sample_warps(h, w, c),
                            (size_t)smem, s>>>(crd, g, dimg, h, w, c, p);
  } else if (kind == kDimgGather) {
    if constexpr (sizeof(T) == 4) {
      if (part == nullptr) part = reinterpret_cast<float*>(dimg);
    }
    if (p > kGatherPixels && part == nullptr) {
      return (int)cudaErrorInvalidValue;
    }
    const int pixels = p < 1 ? 1 : (p < kGatherPixels ? p : kGatherPixels);
    const int bytes = (int)gather_smem_bytes((int64_t)h * w, pixels);
    const uintptr_t pair = 2 * sizeof(T) - 1;
    const bool pairs = c % 2 == 0 && ((uintptr_t)g & pair) == 0 &&
                       ((uintptr_t)dimg & pair) == 0 &&
                       ((uintptr_t)part & 7u) == 0;
    void (*kernel)(const T*, const T*, T*, float*, int, int, int, int, int) =
        pairs ? dimg_gather<L, T, 2> : dimg_gather<L, T, 1>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)n, kGatherThreads, (size_t)bytes, s>>>(
        crd, g, dimg, part, h, w, c, p, pixels);
  } else {
    const cudaError_t err = cudaFuncSetAttribute(
        dimg_per_channel<L, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)n, (unsigned)((c + kSlab - 1) / kSlab));
    dimg_per_channel<L, T><<<grid, kSlab, (size_t)smem, s>>>(crd, g, dimg, n,
                                                             h, w, c, p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The entry points launch on `stream` and return cudaGetLastError() as an
// int (0 = the launch was accepted). They do not synchronise and allocate
// nothing; all arrays are contiguous, of float (_f32) or __nv_bfloat16
// (_bf16), coordinates, g, d_img and d_coords alike. The _rows_ forms take
// (n, 2, p) coordinate rows; the _grid_ forms an (n, p, 2) grid, aligned
// to a (y, x) pair.

extern "C" int catgen_bilinear_dcoords_f32(const float* img, const float* crd,
                                           const float* g, float* dcrd, int n,
                                           int h, int w, int c, int p,
                                           void* stream) {
  return launch_dcoords<RowsLayout>(img, crd, g, dcrd, n, h, w, c, p, stream);
}

extern "C" int catgen_bilinear_dcoords_bf16(
    const __nv_bfloat16* img, const __nv_bfloat16* crd,
    const __nv_bfloat16* g, __nv_bfloat16* dcrd, int n, int h, int w, int c,
    int p, void* stream) {
  return launch_dcoords<RowsLayout>(img, crd, g, dcrd, n, h, w, c, p, stream);
}

extern "C" int catgen_bilinear_grid_dcoords_f32(const float* img,
                                                const float* crd,
                                                const float* g, float* dcrd,
                                                int n, int h, int w, int c,
                                                int p, void* stream) {
  return launch_dcoords<GridLayout>(img, crd, g, dcrd, n, h, w, c, p, stream);
}

extern "C" int catgen_bilinear_grid_dcoords_bf16(
    const __nv_bfloat16* img, const __nv_bfloat16* crd,
    const __nv_bfloat16* g, __nv_bfloat16* dcrd, int n, int h, int w, int c,
    int p, void* stream) {
  return launch_dcoords<GridLayout>(img, crd, g, dcrd, n, h, w, c, p, stream);
}

// Which d_coords kernel (h, w, c) takes for elements of `elem` bytes (4:
// f32, 2: bf16) with 16-byte aligned arrays: 0 per pixel, 1 per warp, 2
// staged, 3 per quad; a negative cudaError_t on failure.
extern "C" int catgen_bilinear_dcoords_kind(int h, int w, int c, int elem) {
  return dcoords_shape_kind(h, w, c, elem);
}

// The shared memory one d_img block of (h, w, c) needs, in bytes (a
// negative cudaError_t if the card's shared memory could not be read);
// the same for both element types (f32 sums).
extern "C" int64_t catgen_bilinear_dimg_smem_bytes(int h, int w, int c) {
  return dimg_smem_bytes(h, w, c);
}

// Which d_img kernel (h, w, c) takes: 0 per channel, 1 per sample, 2
// gather; a negative cudaError_t on failure. The same for both element
// sizes (f32 sums).
extern "C" int catgen_bilinear_dimg_kind(int h, int w, int c, int elem) {
  (void)elem;
  return dimg_kind(h, w, c);
}

// Output pixels per pass of the gather d_img kernel: a bf16 d_img of more
// output pixels per sample needs the f32 scratch `part`.
extern "C" int catgen_bilinear_dimg_gather_pixels() { return kGatherPixels; }

extern "C" int catgen_bilinear_dimg_f32(const float* crd, const float* g,
                                        float* dimg, int n, int h, int w,
                                        int c, int p, void* stream) {
  return launch_dimg<RowsLayout>(crd, g, dimg, (float*)nullptr, n, h, w, c,
                                 p, stream);
}

extern "C" int catgen_bilinear_dimg_bf16(const __nv_bfloat16* crd,
                                         const __nv_bfloat16* g,
                                         __nv_bfloat16* dimg, float* part,
                                         int n, int h, int w, int c, int p,
                                         void* stream) {
  return launch_dimg<RowsLayout>(crd, g, dimg, part, n, h, w, c, p, stream);
}

extern "C" int catgen_bilinear_grid_dimg_f32(const float* crd, const float* g,
                                             float* dimg, int n, int h, int w,
                                             int c, int p, void* stream) {
  return launch_dimg<GridLayout>(crd, g, dimg, (float*)nullptr, n, h, w, c,
                                 p, stream);
}

extern "C" int catgen_bilinear_grid_dimg_bf16(const __nv_bfloat16* crd,
                                              const __nv_bfloat16* g,
                                              __nv_bfloat16* dimg,
                                              float* part, int n, int h,
                                              int w, int c, int p,
                                              void* stream) {
  return launch_dimg<GridLayout>(crd, g, dimg, part, n, h, w, c, p, stream);
}
