// Shared pieces of the port's kernels: 64-row block GEMMs out of shared
// memory into an f32 shared-memory tile, for bf16 (tensor cores through
// WMMA, bf16 in, f32 accumulate) and for f32 (plain FMA on the CUDA cores).
//
// Every kernel that includes this file runs 128 threads (4 warps) per block
// and works on 64-row tiles: warp w owns rows 16w..16w+15 in the WMMA form;
// in the FMA form thread t owns rows 4*(t/8)..+3 and columns t%8 + 8*j.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace keep {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;
constexpr int kRows = 64;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16(x);
}

// Row padding (elements) of a shared-memory tile: keeps WMMA pointers
// 32-byte aligned and staggers rows across banks.
template <typename T> struct Pad { static constexpr int v = 8; };
template <> struct Pad<float> { static constexpr int v = 4; };

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// C[64 x N] (+)= A[64 x K] @ B, all in shared memory. B is [K][N] row-major,
// or [N][K] (each output column's K values contiguous) when BT is true.
template <int N, int K, bool BT, bool ACC>
__device__ __forceinline__ void block_gemm(const bf16* A, int lda,
                                           const bf16* B, int ldb, float* C,
                                           int ldc) {
  using namespace nvcuda;
  static_assert(N % 16 == 0 && K % 16 == 0, "WMMA tiles are 16 wide");
  constexpr int NF = N / 16;
  const int warp = threadIdx.x / 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
  float* Cw = C + warp * 16 * ldc;
#pragma unroll
  for (int n = 0; n < NF; ++n) {
    if (ACC)
      wmma::load_matrix_sync(acc[n], Cw + n * 16, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc[n], 0.0f);
  }
  const bf16* Aw = A + warp * 16 * lda;
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Aw + k, lda);
#pragma unroll
    for (int n = 0; n < NF; ++n) {
      if constexpr (BT) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + n * 16 * ldb + k, ldb);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      } else {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + k * ldb + n * 16, ldb);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NF; ++n)
    wmma::store_matrix_sync(Cw + n * 16, acc[n], ldc, wmma::mem_row_major);
}

template <int N, int K, bool BT, bool ACC>
__device__ __forceinline__ void block_gemm(const float* A, int lda,
                                           const float* B, int ldb, float* C,
                                           int ldc) {
  static_assert(N % 8 == 0, "8 column groups");
  constexpr int NC = N / 8;
  const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
  float acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c)
      acc[r][c] = ACC ? C[(tr * 4 + r) * ldc + tc + 8 * c] : 0.0f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[4], b[NC];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(tr * 4 + r) * lda + k];
#pragma unroll
    for (int c = 0; c < NC; ++c)
      b[c] = BT ? B[(tc + 8 * c) * ldb + k] : B[k * ldb + tc + 8 * c];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) C[(tr * 4 + r) * ldc + tc + 8 * c] = acc[r][c];
}

// Copy rows [r0, r0 + nrows) x [0, cols) of a row-major global matrix with
// row stride gld into a shared tile with row stride sld; rows at or past
// `limit` are zero-filled.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int sld, const T* src,
                                          size_t gld, int r0, int nrows,
                                          int cols, int limit) {
  for (int i = threadIdx.x; i < nrows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    dst[r * sld + c] =
        (r0 + r < limit) ? src[(size_t)(r0 + r) * gld + c] : from_f<T>(0.0f);
  }
}

}  // namespace keep
