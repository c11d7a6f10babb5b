// PTX building blocks of the port's register-resident tensor-core kernels
// (attention.cu's bf16 flash attention, attention_bwd.cu's backward,
// packed_conv.cu's bf16 implicit GEMM, mlp.cu's bf16 forward and its
// backward): cp.async staging, ldmatrix, mma.sync in bf16 and in TF32
// (with the hi / lo splits of the bf16 and 3xTF32 products), and Hopper's
// mbarriers, TMA loads and wgmma with its shared-memory matrix descriptors
// and its 128-byte-swizzle tile layout (am_at, which is also TMA's 128-byte
// swizzle), A from shared memory or registers. sm_90a only (wgmma).
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
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
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
// descriptor da) . B (16 x N bf16, MN-major, descriptor db)
template <int N>
struct Wgmma;

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void mma(float (&d)[32], uint64_t da,
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
        "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24)
        : "l"(da), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<256> {
  static __device__ __forceinline__ void mma(float (&d)[128], uint64_t da,
                                             uint64_t db) {
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
        : "l"(da), "l"(db), "r"(1));
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
                                             uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {%0, %1, %2, "
        "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, "
        "%17, p, 1, 1, 0, 0;\n}\n"
        : KEEP_F8(0), KEEP_F8(8)
        : "l"(da), "l"(db), "r"(1));
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

#undef KEEP_F8


// ---------------------------------------------------------------------------
// host: TMA tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (the library
// links only the runtime), or null
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &res) != cudaSuccess ||
        res != cudaDriverEntryPointSuccess)
      p = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A tensor map of a contiguous (batch, rows, d) bf16 array (d a multiple of
// 64) for TMA boxes of 64 columns x box_rows rows x 1 in the 128-byte
// swizzle: each box lands as box_rows rows of 128 bytes, an am_at column
// block; rows past `rows` are zero-filled. Returns a cudaError_t value.
inline int tma_map_bf16(CUtensorMap* map, const void* base, int d, int rows,
                        int batch, int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)d * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
         dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace keep
