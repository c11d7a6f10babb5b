// PTX building blocks of the port's register-resident tensor-core kernels
// (attention.cu's bf16 flash attention, attention_bwd.cu's backward,
// packed_conv.cu's bf16 implicit GEMM, mlp.cu's backward): cp.async
// staging, ldmatrix, mma.sync in bf16 and in TF32 (with the hi / lo splits
// of the bf16 and 3xTF32 products), and Hopper's wgmma with its
// shared-memory matrix descriptors, A from shared memory or registers.
// sm_90a only (wgmma).
//
// Shared-memory tiles here are rows of 16-byte chunks, swizzled: logical
// chunk c of row r is stored at chunk c ^ (r & 7). Eight consecutive rows
// read at one logical chunk then fall in eight different 16-byte bank
// groups (ldmatrix without conflicts), and a tile whose rows are 128 bytes
// long and whose base is 1024-byte aligned is exactly wgmma's 128-byte
// swizzle layout.
#pragma once

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

// d (64 x 256 f32) += A (64 x 16 bf16 in registers: each warp's 16 rows as
// mma.sync m16n8k16's A fragment) . B (16 x 256 bf16, MN-major, descriptor
// db). A's registers must stay as they are until the group is waited for.
__device__ __forceinline__ void wgmma_rs_256(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {%0, %1, %2, "
      "%3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, "
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, "
      "%69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, "
      "%95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, "
      "%107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : KEEP_F8(0), KEEP_F8(8), KEEP_F8(16), KEEP_F8(24), KEEP_F8(32), KEEP_F8(40), KEEP_F8(48), KEEP_F8(56), KEEP_F8(64), KEEP_F8(72), KEEP_F8(80), KEEP_F8(88), KEEP_F8(96), KEEP_F8(104), KEEP_F8(112), KEEP_F8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef KEEP_F8

}  // namespace sm90
}  // namespace keep
