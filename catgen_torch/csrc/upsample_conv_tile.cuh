// Shared pieces of the upsample-conv kernels (upsample_conv.cu, forward;
// upsample_conv_bwd.cu, dX and dCK; upsample_conv_prep.cu, the bf16
// block's elementwise passes), which run 3xTF32 on the tensor cores in f32
// and one bf16 product in bf16: the geometry, the input transform and
// cotangent fold, cp.async copies, the split of an f32 value into TF32 hi
// and lo, bf16 packing, the wgmma pieces (K-major for the forward and dX,
// MN-major for the bf16 dCK; their sources say how), mbarriers and TMA
// loads (the warp-specialised bf16 forward), and the fixed-order
// sums that make every reduction deterministic without atomics.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The kernel and host helpers are static: each source that includes this
// gets its own copy, so the linked library holds no duplicate symbols.
namespace upconv {

// Pixels per block of the wgmma kernels (the forward and dX): each block
// writes one row of partial column sums per tile of kTilePixels pixels.
constexpr int kTilePixels = 128;

// Shapes of one upsample-conv: x (n, h, w, cin) -> y (n, 2h, 2w, cout),
// collapsed taps kh x kw per parity; umin_h[d] / umin_w[e] is the offset
// of tap 0 of output parity (d, e) relative to the output pixel's source
// pixel (catgen's _collapse_matrix u_min).
struct Geometry {
  int n, h, w, cin, cout, kh, kw;
  int umin_h[2], umin_w[2];
};

using bf16 = __nv_bfloat16;

// The previous stage's BatchNorm affine and PReLU, per input channel, in
// the kernel's element type T.
template <class T>
struct TransformT {
  const T* scale;
  const T* shift;
  const T* alpha;
};
using Transform = TransformT<float>;

// BatchNorm-statistics cotangents folded into the f32 kernels' output
// cotangent: g = gy + gs[0][co] + 2 y gs[1][co] (gs is (2, cout)). The
// bf16 block folds in a pass of its own (upsample_conv_prep.cu).
struct Fold {
  const float* y;
  const float* gs;
  int cout;
};

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

// Pieces of the 3xTF32 kernels: cp.async copies into shared memory, and
// the split of an f32 value into TF32 hi and lo.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// src_bytes < size zero-fills the rest (0: the whole chunk)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
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

// Pieces of the wgmma kernels (the forward and dX): tiles of 128-byte
// rows (32 TF32 values, the contraction of one step) in wgmma's 128-byte
// swizzle, and the products.

// Byte offset of 16-byte chunk c (channels 4c .. 4c+3) of row r in a
// tile: rows of 128 bytes, chunks XOR-swizzled by the row (wgmma's
// 128-byte swizzle, so its operand reads and the split's stores hit 8
// different bank groups per 8 chunks)
__device__ __forceinline__ uint32_t chunk_at(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// wgmma's shared-memory matrix descriptor of a K-major tile in the
// 128-byte swizzle: start address, 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t tile_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (+)= A * B over one 8-deep step: 64 rows x 128 columns, f32
// accumulators (64 a thread), A and B TF32 in shared memory; accumulate
// into d unless `fresh`
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da,
                                           uint64_t db, bool fresh) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"((int)fresh));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until at most N of this warpgroup's product groups are pending
// (N = 0: all done); d, whose group is done then, may be read after it
template <int N = 0>
__device__ __forceinline__ void wgmma_wait(float (&d)[64]) {
  asm volatile("wgmma.wait_group.sync.aligned %64;\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
               : "n"(N)
               : "memory");
}

// makes this thread's st.shared visible to wgmma's (async proxy) reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint4 split4(const float (&v)[4], uint4& lo) {
  uint4 hi;
  split_tf32(v[0], hi.x, lo.x);
  split_tf32(v[1], hi.y, lo.y);
  split_tf32(v[2], hi.z, lo.z);
  split_tf32(v[3], hi.w, lo.w);
  return hi;
}

// Copies one chunk: 4 floats (16 bytes, or 4 single floats), zero where
// !ok (or, per element, past `count` of the element's index c); `base`
// stands in for the source of a zero-fill, which reads nothing
template <bool kVec>
__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      const float* base, bool ok, int c,
                                      int count) {
  if (kVec) {
    cp_async16(dst, ok ? src : base, ok ? 16 : 0);
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const bool okq = ok && c + q < count;
      cp_async4(dst + q, okq ? src + q : base, okq ? 4 : 0);
    }
  }
}

// Pieces of the bf16 kernels: 16 bytes hold 8 bf16 values (element 0 in
// the lowest bytes); a bf16 value is read exactly into f32 (its bits moved
// up 16) and an f32 one rounded to it once, to nearest even.

__device__ __forceinline__ float ldf(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldf(const bf16* p) {
  return __uint_as_float(
      (uint32_t)__ldg(reinterpret_cast<const unsigned short*>(p)) << 16);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// two values rounded to bf16, packed: a in the low half
__device__ __forceinline__ uint32_t pack2(float a, float b) {
  return bf16_bits(a) | bf16_bits(b) << 16;
}

// One or two neighbouring values stored in the element type (bf16 rounded
// once); a pair needs an address aligned to the pair
__device__ __forceinline__ void store_one(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_one(bf16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2(a, b);
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&out)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  return make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]), pack2(v[4], v[5]),
                    pack2(v[6], v[7]));
}

// Copies one chunk of 8 bf16 values (16 bytes) into shared memory, zero
// where !ok (or, per element, past `count` of the element's index c): a
// 16-byte cp.async, or (kVec false: odd channel counts, unaligned arrays)
// 2-byte loads through registers and one 16-byte store; `base` stands in
// for the source of a zero-fill, which reads nothing
template <bool kVec>
__device__ __forceinline__ void copy8(bf16* dst, const bf16* src,
                                      const bf16* base, bool ok, int c,
                                      int count) {
  if (kVec) {
    cp_async16(dst, ok ? src : base, ok ? 16 : 0);
  } else {
    const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t lo = ok && c + 2 * q < count ? __ldg(s + 2 * q) : 0u;
      const uint32_t hi =
          ok && c + 2 * q + 1 < count ? __ldg(s + 2 * q + 1) : 0u;
      w[q] = lo | hi << 16;
    }
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// d (+)= A * B over one 16-deep step: 64 rows x 128 columns, f32
// accumulators (64 a thread), A and B bf16, K-major in shared memory in
// the 128-byte swizzle (as wgmma_tf32's, 32 bytes a row a step);
// accumulate into d unless `fresh`
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da,
                                           uint64_t db, bool fresh) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"((int)fresh));
}

// wgmma's shared-memory matrix descriptor of an MN-major ("transposed")
// 16-bit tile in the 128-byte swizzle (the bf16 dCK's): rows of 64 M or N
// values (128 bytes) along K, 8 K rows to a 1024-byte swizzle atom, the
// atoms of K 1024 bytes apart (the stride byte offset) and the next 64 M
// or N values `mn_stride` bytes on (the leading byte offset)
__device__ __forceinline__ uint64_t mn_desc(uint32_t saddr,
                                           uint32_t mn_stride) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((mn_stride >> 4) & 0x3FFF) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma_bf16 with both operands MN-major (mn_desc): A M-major, B
// N-major, each read transposed
__device__ __forceinline__ void wgmma_bf16_mn(float (&d)[64], uint64_t da,
                                              uint64_t db, bool fresh) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"((int)fresh));
}

// Pieces of the warp-specialised bf16 forward (upsample_conv.cu): mbarriers
// in shared memory, TMA tile loads that complete on them, and the register
// split between the producer and the consumer warpgroups.

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count));
}

// makes the barriers' initialisation visible to the TMA unit (the async
// proxy) before any copy completes on them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of copies to complete on the barrier
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// waits until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// TMA: the box of `map` at the coordinates (innermost first) into shared
// memory at dst, completing `bar`'s expected bytes; coordinates past either
// end of a dimension read zeros
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const void* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// the warpgroup's registers per thread lowered or raised to N (every warp
// of the warpgroup executes it)
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a barrier of the `threads` threads that use barrier `id` (1-15; 0 is
// __syncthreads's)
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__host__ __device__ __forceinline__ int64_t ceil_div(int64_t a, int64_t b) {
  return (a + b - 1) / b;
}

// null, or 16-byte aligned: every row of an array whose row length is a
// multiple of 16 bytes (4 floats, 8 bf16) can take 16-byte copies
static inline bool aligned16(const void* p) {
  return p == nullptr || ((uintptr_t)p & 15u) == 0;
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
