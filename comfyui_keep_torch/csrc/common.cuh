// Shared pieces of the port's kernels: bf16 / f32 conversions, log2(e),
// and a 64-row f32 block GEMM out of shared memory into an f32
// shared-memory tile (plain FMA on the CUDA cores), with the tile loader
// it reads from.
//
// The block GEMM and load_tile run 128 threads (4 warps) per block on
// 64-row tiles: thread t owns rows 4*(t/8)..+3 and columns t%8 + 8*j.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
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

// Row padding (elements) of an f32 shared-memory tile: keeps rows 16-byte
// aligned and staggers them across banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int v = 4; };

__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) & ~size_t(127);
}

// C[64 x N] (+)= A[64 x K] @ B, all f32 in shared memory. B is [K][N]
// row-major, or [N][K] (each output column's K values contiguous) when BT
// is true.
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
