// PTX building blocks of the port's register-resident tensor-core kernels
// (attention.cu's flash attention, attention_bwd.cu's backward,
// packed_conv.cu's bf16 implicit GEMM, mlp.cu's forwards and backward):
// cp.async staging, ldmatrix, mma.sync in bf16 and in TF32 (with the hi /
// lo splits of the bf16 and 3xTF32 products), and Hopper's mbarriers, TMA
// loads (tiled and im2col) and stores, and wgmma in bf16 and TF32 with its
// shared-memory matrix descriptors and its 128-byte-swizzle tile layout
// (am_at, which is also TMA's 128-byte swizzle), A from shared memory or
// registers. sm_90a only (wgmma).
//
// Shared-memory tiles here are rows of 16-byte chunks, swizzled: logical
// chunk c of row r is stored at chunk c ^ (r & 7). Eight consecutive rows
// read at one logical chunk then fall in eight different 16-byte bank
// groups (ldmatrix without conflicts), and a tile whose rows are 128 bytes
// long and whose base is 1024-byte aligned is exactly wgmma's 128-byte
// swizzle layout.
#pragma once

#include <cuda.h>  // CUtensorMap; the driver's encoder is fetched at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <array>
#include <mutex>

namespace keep {
namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of logical 16-byte chunk c of row r in a swizzled tile whose
// rows are row_bytes long
__device__ __forceinline__ uint32_t swz(int r, int c, int row_bytes) {
  return (uint32_t)(r * row_bytes + ((c ^ (r & 7)) << 4));
}

// 16 (or 8) bytes global -> shared, bypassing registers; the bytes past
// src_bytes (0 for a cell outside the input) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// the same, kept in L1 too: a neighbouring tap's copy re-reads these bytes
__device__ __forceinline__ void cp_async16_l1(uint32_t dst, const void* src,
                                              int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async8(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8 x 8 b16 matrices; thread i names row i % 8 of matrix i / 8
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d (16 x 8 f32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as two packed bf16 pairs, hi = (x0, x1) rounded and lo = the
// remainders rounded: hi + lo carries 16 mantissa bits of each value
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  const float2 h = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&hi));
  lo = pack_bf16(x0 - h.x, x1 - h.y);
}

// d (16 x 8 f32) += a (16 x 8 tf32, row) . b (8 x 8 tf32, col). Operands
// are f32 bit patterns; the tensor core reads their top 19 bits (sign,
// exponent, 10 mantissa bits) and ignores the rest
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with a zero accumulator: d = a . b. Neither is volatile, so
// ptxas may interleave independent chains
__device__ __forceinline__ void mma_tf32_0(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// x (f32 bits) = hi + lo: hi x rounded to TF32 (11 significant bits, to
// nearest: a carry into bit 12, then the mask), lo = x - hi, exact in f32
// (the tensor core then drops lo's own low bits: < 2^-22 of x). In
// attention_bwd.cu on the H100, cvt.rna.tf32 (the same rounding) took
// 1.2-1.5x this form's time and a split on the FP32 pipe (Veltkamp's)
// 1.1-1.2x; the truncating mask alone leaves a bias that fails the gate
// (tools/torch_attention_bwd_variants.py)
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (x + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// the inits, visible to the async proxy (TMA) and the other threads' waits
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival that also expects `bytes` of TMA transactions this phase
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// a warpgroup's registers a thread, raised or lowered to N (a multiple of
// 8): a producer warpgroup hands its registers to the consumers
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// a box of a 3-D tensor map (coordinates innermost first) into shared
// memory at dst; its bytes complete a transaction on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const void* map,
                                            int c0, int c1, int c2,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

// a box of shared memory at src into a 3-D tensor map's box (coordinates
// innermost first; what falls outside the tensor is not written), as a
// bulk group of this thread: commit, then wait for the groups' reads of
// shared memory (the source may be overwritten) or for their completion
__device__ __forceinline__ void tma_store_3d(const void* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(map),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// BM pixels x 64 channels of an NHWC input by an im2col tensor map
// (tma_map_im2col_bf16): from pixel (w, h) of image n of the map's
// bounding box on, in raster order across rows and images, each pixel's
// channels c .. c + 63 read at (w + ow, h + oh); reads outside the input
// are zeros
__device__ __forceinline__ void tma_load_im2col_4d(uint32_t dst,
                                                   const void* map, int c,
                                                   int w, int h, int n,
                                                   uint16_t ow, uint16_t oh,
                                                   uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.im2col.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6], {%7, %8};\n" ::
          "r"(dst),
      "l"(map), "r"(c), "r"(w), "r"(h), "r"(n), "r"(bar), "h"(ow), "h"(oh)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Matrix descriptor of a 128-byte-swizzled operand in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (128-byte swizzle) in bits 62-63. A K-major tile of 128-byte rows
// takes lbo 16 (unused) and sbo 1024 (the next 8-row group); an MN-major
// one takes lbo = the bytes between 64-wide MN blocks and sbo 1024 (the next
// 8 K-rows).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)1 << 62);
}

// byte offset of 16-byte chunk c of row r of a bf16 tile of `rows` rows in
// wgmma's 128-byte-swizzle layout: 64-column (128-byte) blocks of rows x
// 128 B, chunk c & 7 of a row at (c & 7) ^ (r & 7)
__device__ __forceinline__ uint32_t am_at(int r, int c, int rows) {
  return (uint32_t)((c >> 3) * rows * 128 + r * 128 +
                    (((c & 7) ^ (r & 7)) << 4));
}

// wgmma descriptors of such a tile (1024-byte aligned) at shared address
// tile: K-major, rows r0 .. (a multiple of 8) of k step s (columns 16 s
// ..); MN-major, k-rows 16 s .. from column block b on
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int rows, int r0,
                                           int s) {
  return desc_sw128(tile + (s >> 2) * rows * 128 + r0 * 128 + (s & 3) * 32,
                    16, 1024);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int rows, int b,
                                            int s) {
  return desc_sw128(tile + b * rows * 128 + s * 16 * 128, rows * 128, 1024);
}

// desc_k's k step s of a K-major tile of `rows` rows (r0 = 0), from the
// tile's descriptor d = desc_k(tile, rows, 0, 0): the start address field
// (bytes / 16, its low 14 bits; shared addresses stay below 2^18) moved
// on, in an asm volatile so that the compiler computes it where it is used
// instead of hoisting every k step's descriptor into registers
__device__ __forceinline__ uint64_t desc_k_at(uint64_t d, int rows, int s) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n"
               : "=l"(r)
               : "l"(d), "l"((uint64_t)((s >> 2) * rows * 8 + (s & 3) * 2)));
  return r;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy writes (cp.async, st.shared) -> later async-proxy reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int A, int B>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define KEEP_F8(i)                                                       \
  "+f"(d[i + 0]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x N f32, the warpgroup's fragment) += A (64 x 16 bf16, K-major,
// descriptor da) . B (16 x N bf16, MN-major, descriptor db); scale_d 0
// starts d from zero
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "
        "1, 0, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
        "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
        "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
        "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
        "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
        "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
        "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
        "%127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56), KEEP_F8(64), KEEP_F8(72),
          KEEP_F8(80), KEEP_F8(88), KEEP_F8(96), KEEP_F8(104), KEEP_F8(112),
          KEEP_F8(120)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// d (64 x N f32) += A (64 x 16 bf16, descriptor da) . B (16 x N bf16,
// descriptor db), both in shared memory: TA / TB 0 for a K-major operand
// (stored row by row of M or N), 1 for an MN-major one (stored k-row by
// k-row)
template <int N, int TA, int TB>
struct WgSS;

template <>
struct WgSS<32, 0, 0> {
  static __device__ __forceinline__ void mma(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
        "%17, p, 1, 1, 0, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgSS<64, 0, 0> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

template <>
struct WgSS<64, 1, 1> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgSS<128, 1, 1> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
        "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
        "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 1, "
        "1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32), KEEP_F8(40), KEEP_F8(48), KEEP_F8(56)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct WgSS<128, 0, 0> {
  static __device__ __forceinline__ void mma(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56)
        : "l"(da), "l"(db), "r"(scale_d));
  }
};

// d (64 x N f32) += A (64 x 16 bf16 in registers: each warp's 16 rows as
// mma.sync m16n8k16's A fragment, which is also the layout of a wgmma
// accumulator's 16 rows packed to bf16 pairs) . B (16 x N bf16, descriptor
// db; TB 0 K-major, 1 MN-major). A's registers must stay as they are until
// the group is waited for.
template <int N, int TB>
struct WgRS;

template <>
struct WgRS<64, 0> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgRS<128, 0> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
        "1, 1, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgRS<128, 1> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
        "1, 1, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgRS<256, 1> {
  static __device__ __forceinline__ void mma(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d = 1) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, "
        "%83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
        " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
        "%119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129,"
        " %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56), KEEP_F8(64), KEEP_F8(72),
          KEEP_F8(80), KEEP_F8(88), KEEP_F8(96), KEEP_F8(104), KEEP_F8(112),
          KEEP_F8(120)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

// d (64 x N f32) += A (64 x 8 tf32 in registers) . B (8 x N tf32, K-major,
// descriptor db): the TF32 products of the 3xTF32 forwards. A's fragment
// is mma.sync m16n8k8's per warp: (g, t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4), g = lane / 4, t = lane % 4. The tensor core reads each operand's
// top 19 bits: a register that holds x's bits + 0x1000 (tf32_hi_bits) is
// read as x rounded to TF32. A's registers must stay as they are until the
// group is waited for.
template <int N>
struct WgTf32;

template <>
struct WgTf32<16> {
  static __device__ __forceinline__ void mma(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : KEEP_F8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgTf32<32> {
  static __device__ __forceinline__ void mma(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, "
        "%17, %18, %19}, %20, p, 1, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgTf32<64> {
  static __device__ __forceinline__ void mma(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

template <>
struct WgTf32<128> {
  static __device__ __forceinline__ void mma(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17,"
        " %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, "
        "%31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
        "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
        "%57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, "
        "1, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32),
          KEEP_F8(40), KEEP_F8(48), KEEP_F8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
};

#undef KEEP_F8

// 3xTF32 operands of the forwards. x's bits + 0x1000: the tensor core reads
// it as hi, x rounded to TF32 as split_tf32 rounds it
__device__ __forceinline__ uint32_t tf32_hi_bits(uint32_t x) {
  return x + 0x1000u;
}
// lo = x - hi from the hi_bits form (x = h - 0x1000)
__device__ __forceinline__ uint32_t tf32_lo_of_hi(uint32_t h) {
  return __float_as_uint(__uint_as_float(h - 0x1000u) -
                         __uint_as_float(h & 0xffffe000u));
}
// four values split in place: a 16-byte chunk of a tile, hi out, lo in x
__device__ __forceinline__ void split_tf32_4(uint4& x, uint4& hi) {
  split_tf32(x.x, hi.x, x.x);
  split_tf32(x.y, hi.y, x.y);
  split_tf32(x.z, hi.z, x.z);
  split_tf32(x.w, hi.w, x.w);
}
// the sums of a 3xTF32 product (the tensor core's adds truncate): a
// group's products from zero into part, added to sum in f32 once it has
// landed (sum is assigned at the first)
template <int N>
__device__ __forceinline__ void f_add(float (&sum)[N], const float (&part)[N],
                                      bool first) {
#pragma unroll
  for (int i = 0; i < N; ++i) sum[i] = first ? part[i] : sum[i] + part[i];
}
// a barrier of the `threads` threads from warp `first` on (id > 0; 0 is
// __syncthreads')
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}


// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

using EncodeIm2col = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const int*, const int*,
                                  cuuint32_t, cuuint32_t, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// a CUDA entry point (its 12.0 form) fetched through the runtime (the
// library links only the runtime), or null
inline void* entry_point(const char* name) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
  if (cudaGetDriverEntryPointByVersion(name, &p, 12000, cudaEnableDefault,
                                       &res) != cudaSuccess ||
      res != cudaDriverEntryPointSuccess)
    p = nullptr;
#else
  if (cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &res) !=
          cudaSuccess ||
      res != cudaDriverEntryPointSuccess)
    p = nullptr;
#endif
  return p;
}

// cuTensorMapEncodeTiled / cuTensorMapEncodeIm2col, or null
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn =
      reinterpret_cast<EncodeTiled>(entry_point("cuTensorMapEncodeTiled"));
  return fn;
}
inline EncodeIm2col encode_im2col() {
  static const EncodeIm2col fn =
      reinterpret_cast<EncodeIm2col>(entry_point("cuTensorMapEncodeIm2col"));
  return fn;
}

// Binds the current device's primary context to the calling thread. A
// thread whose first CUDA call is an encode has none, and the encode then
// fails (CUDA_ERROR_INVALID_CONTEXT): autograd's device thread, when the
// caching allocator serves a backward's tensors without a runtime call. A
// cudaError_t value.
inline int bind_context() {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err == 0) err = (int)cudaSetDevice(dev);
  return err;
}

// A tensor map of a contiguous (batch, rows, d) array of 2-byte (bf16) or
// 4-byte (f32) elements, d a multiple of 16 bytes, for TMA boxes of 128
// bytes (64 bf16 or 32 f32 columns) x box_rows rows x 1 in the 128-byte
// swizzle: each box lands as box_rows rows of 128 bytes, an am_at column
// block; rows past `rows` and columns past d are zero-filled (and not
// written by a store). Returns a cudaError_t value.
inline int tma_map(CUtensorMap* map, const void* base, int esize, int d,
                   int rows, int batch, int box_rows, long long ld = 0) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (const int err = bind_context()) return err;
  if (ld == 0) ld = d;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)ld * esize,
                                 (cuuint64_t)ld * rows * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), (cuuint32_t)box_rows,
                             1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         3, const_cast<void*>(base), dims, strides, box, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
inline int tma_map_bf16(CUtensorMap* map, const void* base, int d, int rows,
                        int batch, int box_rows) {
  return tma_map(map, base, 2, d, rows, batch, box_rows);
}
// (ld: the elements between rows, d if 0)
inline int tma_map_f32(CUtensorMap* map, const void* base, int d, int rows,
                       int batch, int box_rows, long long ld = 0) {
  return tma_map(map, base, 4, d, rows, batch, box_rows, ld);
}

// An im2col tensor map of a contiguous NHWC input (n, hi, wi, c) of 2-byte
// (bf16) or 4-byte (f32) elements, c a multiple of 16 bytes, for
// tma_load_im2col_4d: boxes of `pixels` pixels x 128 bytes of channels (64
// bf16 or 32 f32; the 128-byte swizzle: each box lands as `pixels` K-major
// rows of an am_at column block; channels past c read as zeros). A pixel
// (w, h) of the box traversal runs over lo_w .. wi - 1 + hi_w and lo_h ..
// hi - 1 + hi_h of each image (the corners of the bounding box, relative to
// the input's first and last pixel). Returns a cudaError_t value.
inline int tma_map_im2col(CUtensorMap* map, const void* base, int esize,
                          int n, int hi, int wi, int c, int pixels, int lo_w,
                          int lo_h, int hi_w, int hi_h) {
  const EncodeIm2col fn = encode_im2col();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  if (const int err = bind_context()) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)c, (cuuint64_t)wi, (cuuint64_t)hi,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {(cuuint64_t)c * esize,
                                 (cuuint64_t)c * wi * esize,
                                 (cuuint64_t)c * wi * hi * esize};
  const int lower[2] = {lo_w, lo_h}, upper[2] = {hi_w, hi_h};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r =
      fn(map, esize == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
         4, const_cast<void*>(base), dims, strides, lower, upper,
         (cuuint32_t)(128 / esize), (cuuint32_t)pixels, estr,
         CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
inline int tma_map_im2col_bf16(CUtensorMap* map, const void* base, int n,
                               int hi, int wi, int c, int pixels, int lo_w,
                               int lo_h, int hi_w, int hi_h) {
  return tma_map_im2col(map, base, 2, n, hi, wi, c, pixels, lo_w, lo_h, hi_w,
                        hi_h);
}
inline int tma_map_im2col_f32(CUtensorMap* map, const void* base, int n,
                              int hi, int wi, int c, int pixels, int lo_w,
                              int lo_h, int hi_w, int hi_h) {
  return tma_map_im2col(map, base, 4, n, hi, wi, c, pixels, lo_w, lo_h, hi_w,
                        hi_h);
}

constexpr int kMaxDevices = 64;  // a launcher's per-device statics

// The host's caches of a launcher have internal linkage (an anonymous
// namespace: each source that includes this file has its own): a static of
// an inline or template function is one symbol for every library that
// defines it, so two builds of one source loaded in one process (the
// tools' --root and variants) would share them.
namespace {

// The tensor maps of recent launches by what they encode (an address, a
// geometry, a box): a call that repeats one (the same weights, or an
// activation or scratch the allocator hands out at the same address)
// encodes nothing (an encode validates the whole map on the host, at every
// launch otherwise; tools/torch_k6_check.py --host). Any number of host
// threads.
template <int kSlots>
class TmaMapCache {
 public:
  using Key = std::array<long long, 8>;
  // the map for key, encoded by encode(map) on a miss; a cudaError_t value
  template <typename Encode>
  int get(const Key& key, CUtensorMap* map, Encode encode) {
    std::lock_guard<std::mutex> lock(mu_);
    for (int i = 0; i < kSlots; ++i)
      if (used_[i] && keys_[i] == key) {
        *map = maps_[i];
        return 0;
      }
    const int err = encode(map);
    if (err == 0) {
      keys_[next_] = key;
      maps_[next_] = *map;
      used_[next_] = true;
      next_ = (next_ + 1) % kSlots;
    }
    return err;
  }

 private:
  std::mutex mu_;
  Key keys_[kSlots];
  CUtensorMap maps_[kSlots];
  bool used_[kSlots] = {};
  int next_ = 0;
};

// the source's cache of kSlots maps
template <int kSlots = 64>
inline TmaMapCache<kSlots>& tma_maps() {
  static TmaMapCache<kSlots> cache;
  return cache;
}

}  // namespace

}  // namespace sm90
}  // namespace keep
