// Nearest-codebook search for Hopper (sm_90a):
//   idx[t] = argmin_n ( e2[n] - 2 z[t] . e[n] ),  e2[n] = ||e[n]||^2 in f32
// with the products accumulated in f32 and ties going to the lowest index
// (jnp.argmin's rule). ||z[t]||^2 is the same for every n and is left out.
//
// Replaces comfyui_keep_tpu/ops/pallas_kernels.py: vq_nearest_indices_pallas
// (_vq_kernel). On its path (KEEP stage-II training, the GT codes of every
// step) T = B * frames * 256 = 4096 tokens, C = 256, N = 1024.
//
// What bounds it on the H100: 2 T N C = 2.15 GFLOP against ~2.6 MB of
// inputs, ~800 flop/byte, so the arithmetic bounds it: 32 us in f32 on the
// CUDA cores, 2.2 us in bf16 on the tensor cores. The (T, N) distance matrix
// (16 MB f32) never reaches device memory.
//
// What the design does about it: one block of 128 threads owns a tile of 64
// tokens, held whole in shared memory (C <= 512). It walks the codebook in
// tiles of 64 codes, each staged in shared memory 128 channels at a time;
// the 64 x 64 tile of dot products accumulates in registers (WMMA fragments,
// bf16 in and f32 out, for bf16; FMA for f32) across the channel chunks,
// then goes through an f32 shared tile to the argmin epilogue. Each token's
// two threads keep a running (min, argmin) over their halves of every tile
// in registers, and one warp shuffle merges them at the end. Work spreads
// over only T / 64 blocks (64 at the path's shape, of 132 SMs) and nothing
// is pipelined; splitting the codebook across blocks, TMA staging and
// wgmma are left for the work that makes the kernel fast.
#include <math.h>

#include "common.cuh"

namespace keep {

constexpr int kCodes = 64;    // codebook rows per tile
constexpr int kChunk = 128;   // channels of a codebook tile staged at once
constexpr int kMaxC = 512;
constexpr int kLdS = kCodes + 4;  // f32 dot-product tile row stride

template <typename T> struct VqAcc;

// bf16: warp w owns tokens 16w..16w+15 against all 64 codes (4 fragments)
template <> struct VqAcc<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[kCodes / 16];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int n = 0; n < kCodes / 16; ++n)
      nvcuda::wmma::fill_fragment(acc[n], 0.0f);
  }

  // acc += Z[:, k0:k0+kc] . E[:, 0:kc]^T (E holds each code's channels
  // contiguously, i.e. B = E^T in column-major form)
  __device__ __forceinline__ void mma(const bf16* Zs, int ldz, const bf16* Es,
                                      int lde, int k0, int kc) {
    using namespace nvcuda;
    const bf16* Aw = Zs + (threadIdx.x / 32) * 16 * ldz + k0;
    for (int k = 0; k < kc; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::load_matrix_sync(a, Aw + k, ldz);
#pragma unroll
      for (int n = 0; n < kCodes / 16; ++n) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(b, Es + n * 16 * lde + k, lde);
        wmma::mma_sync(acc[n], a, b, acc[n]);
      }
    }
  }

  __device__ __forceinline__ void store(float* S) {
    float* Sw = S + (threadIdx.x / 32) * 16 * kLdS;
#pragma unroll
    for (int n = 0; n < kCodes / 16; ++n)
      nvcuda::wmma::store_matrix_sync(Sw + n * 16, acc[n], kLdS,
                                      nvcuda::wmma::mem_row_major);
  }
};

// f32: thread t owns tokens 4*(t/8)..+3 against codes t%8 + 8j, j < 8
template <> struct VqAcc<float> {
  float acc[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.0f;
  }

  __device__ __forceinline__ void mma(const float* Zs, int ldz,
                                      const float* Es, int lde, int k0,
                                      int kc) {
    const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
    const float* Zt = Zs + tr * 4 * ldz + k0;
    const float* Et = Es + tc * lde;
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = Zt[r * ldz + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Et[8 * j * lde + k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
  }

  __device__ __forceinline__ void store(float* S) {
    const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) S[(tr * 4 + r) * kLdS + tc + 8 * j] = acc[r][j];
  }
};

template <typename T>
struct VqSmem {
  int ldz, lde;
  size_t es, s, e2, bytes;
  __host__ __device__ explicit VqSmem(int C)
      : ldz(C + Pad<T>::v), lde(kChunk + Pad<T>::v) {
    es = align128(sizeof(T) * kRows * ldz);
    s = es + align128(sizeof(T) * kCodes * lde);
    e2 = s + align128(sizeof(float) * kRows * kLdS);
    bytes = e2 + align128(sizeof(float) * kCodes);
  }
};

// z: (n_tok, C); e: (n_codes, C), both of T; e2: (n_codes,) f32;
// idx: (n_tok,) int32. n_codes % 64 == 0, C % 16 == 0, C <= 512.
// Grid ceil(n_tok / 64), 128 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    vq_nearest_kernel(const T* __restrict__ z, const T* __restrict__ e,
                      const float* __restrict__ e2, int* __restrict__ idx,
                      int n_tok, int n_codes, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  const VqSmem<T> L(C);
  T* Zs = reinterpret_cast<T*>(smem);
  T* Es = reinterpret_cast<T*>(smem + L.es);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* E2s = reinterpret_cast<float*>(smem + L.e2);

  const int tid = threadIdx.x;
  const int t0 = blockIdx.x * kRows;
  load_tile(Zs, L.ldz, z, C, t0, kRows, C, n_tok);  // ragged rows are zeros

  const int row = tid >> 1, half = tid & 1;  // epilogue: token, code half
  float best = INFINITY;
  int best_i = 0;
  VqAcc<T> acc;
  for (int n0 = 0; n0 < n_codes; n0 += kCodes) {
    acc.zero();
    for (int k0 = 0; k0 < C; k0 += kChunk) {
      const int kc = min(kChunk, C - k0);
      __syncthreads();  // the previous chunk's and tile's reads are done
      for (int i = tid; i < kCodes * kc; i += kThreads) {
        const int r = i / kc, c = i % kc;
        Es[r * L.lde + c] = e[(size_t)(n0 + r) * C + k0 + c];
      }
      if (k0 == 0 && tid < kCodes) E2s[tid] = e2[n0 + tid];
      __syncthreads();
      acc.mma(Zs, L.ldz, Es, L.lde, k0, kc);
    }
    acc.store(S);
    __syncthreads();
    // codes in ascending order and a strict '<': the lowest index wins ties
    const float* Sr = S + row * kLdS + half * (kCodes / 2);
    const float* E2h = E2s + half * (kCodes / 2);
#pragma unroll 8
    for (int c = 0; c < kCodes / 2; ++c) {
      const float d = fmaf(-2.0f, Sr[c], E2h[c]);  // == e2 - 2 s (2 s exact)
      if (d < best) {
        best = d;
        best_i = n0 + half * (kCodes / 2) + c;
      }
    }
  }
  const float ob = __shfl_xor_sync(0xffffffffu, best, 1);
  const int oi = __shfl_xor_sync(0xffffffffu, best_i, 1);
  if (ob < best || (ob == best && oi < best_i)) best_i = oi;
  if (half == 0 && t0 + row < n_tok) idx[t0 + row] = best_i;
}

template <typename T>
int launch_vq(const void* z, const void* e, const void* e2, void* idx,
              int n_tok, int n_codes, int C, cudaStream_t stream) {
  const VqSmem<T> L(C);
  cudaError_t err = cudaFuncSetAttribute(
      vq_nearest_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (n_tok + kRows - 1) / kRows;
  vq_nearest_kernel<T><<<blocks, kThreads, L.bytes, stream>>>(
      static_cast<const T*>(z), static_cast<const T*>(e),
      static_cast<const float*>(e2), static_cast<int*>(idx), n_tok, n_codes,
      C);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16 (z and e). Returns a cudaError_t value
// (0 = ok). N must be a multiple of 64, C a multiple of 16 in [16, 512].
extern "C" int keep_vq_nearest(const void* z, const void* e, const void* e2,
                               void* idx, int T, int N, int C, int dtype,
                               void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || N < kCodes || N % kCodes != 0 || C < 16 || C % 16 != 0 ||
      C > kMaxC)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_vq<bf16>(z, e, e2, idx, T, N, C, st);
  if (dtype == 0) return launch_vq<float>(z, e, e2, idx, T, N, C, st);
  return (int)cudaErrorInvalidValue;
}
