// Fused bias + scaled leaky ReLU for Hopper (sm_90a):
//   out = where(h >= 0, h, h * slope) * scale,  h = x + b[c]
// over x of shape (N, C, *spatial), the bias on dim 1, h in f32 and one
// rounding to x's dtype at the end.
//
// Replaces comfyui_keep_tpu/ops/pallas_kernels.py: fused_bias_lrelu_pallas
// (_flr_kernel). On its path (StyleGAN2's activations, the twin of
// ops/native.py fused_leaky_relu) x runs from (B, 512) in the mapping MLP to
// (4, 32, 1024, 1024) at the last 1024x1024 style conv.
//
// What bounds it on the H100: memory. It reads x once and writes out once,
// two flops and a compare per element: at (4, 32, 1024, 1024) that is 268 MB
// (bf16) or 537 MB (f32), 0.160 / 0.320 ms at 3.35 TB/s.
//
// What the design does about it: a grid-stride elementwise pass, each thread
// moving 16 bytes per access (4 f32 or 8 bf16 values) wherever the spatial
// size is a multiple of that width and both pointers are 16-byte aligned, so
// that one vector never straddles two channels and every access is one
// 128-bit load or store; one division per vector finds its channel. Other
// shapes (the (N, C) activations of the linear layers) take the scalar form.
// The arithmetic uses the _rn intrinsics, which the compiler never contracts,
// so the f32 result is bitwise the plain version's.
#include "common.cuh"

namespace keep {

constexpr int kActThreads = 256;

__device__ __forceinline__ float lrelu(float x, float b, float slope,
                                       float scale) {
  const float h = __fadd_rn(x, b);
  return __fmul_rn(h >= 0.0f ? h : __fmul_rn(h, slope), scale);
}

template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int n = 4;
  using type = float4;
};
template <> struct Vec<bf16> {
  static constexpr int n = 8;
  using type = uint4;
};

// x, out: n_vec vectors of Vec<T>::n elements; every vector lies in one
// channel (inner % Vec<T>::n == 0).
template <typename T, typename I>
__global__ void __launch_bounds__(kActThreads)
    fused_act_vec_kernel(const T* __restrict__ x, const float* __restrict__ b,
                         T* __restrict__ out, I n_vec, I inner, int C,
                         float slope, float scale) {
  constexpr int VW = Vec<T>::n;
  using V = typename Vec<T>::type;
  const V* xv = reinterpret_cast<const V*>(x);
  V* ov = reinterpret_cast<V*>(out);
  const I stride = (I)gridDim.x * kActThreads;
  for (I i = (I)blockIdx.x * kActThreads + threadIdx.x; i < n_vec;
       i += stride) {
    const float bc = b[(int)((i * VW / inner) % (I)C)];
    V v = xv[i];
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < VW; ++k) e[k] = from_f<T>(lrelu(to_f(e[k]), bc, slope,
                                                        scale));
    ov[i] = v;
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kActThreads)
    fused_act_kernel(const T* __restrict__ x, const float* __restrict__ b,
                     T* __restrict__ out, I n, I inner, int C, float slope,
                     float scale) {
  const I stride = (I)gridDim.x * kActThreads;
  for (I i = (I)blockIdx.x * kActThreads + threadIdx.x; i < n; i += stride)
    out[i] = from_f<T>(lrelu(to_f(x[i]), b[(int)((i / inner) % (I)C)], slope,
                             scale));
}

template <typename T, typename I>
int launch_act(const void* x, const float* b, void* out, I n, I inner, int C,
               float slope, float scale, cudaStream_t stream) {
  constexpr int VW = Vec<T>::n;
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const bool vec = inner % VW == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const I work = vec ? n / VW : n;
  // enough blocks for every SM to hold a full complement of threads; the
  // grid-stride loop takes the rest
  const I cap = (I)132 * (2048 / kActThreads) * 4;
  const I want = (work + kActThreads - 1) / kActThreads;
  const unsigned blocks = (unsigned)(want < cap ? want : cap);
  if (vec)
    fused_act_vec_kernel<T, I><<<blocks, kActThreads, 0, stream>>>(
        xt, b, ot, work, inner, C, slope, scale);
  else
    fused_act_kernel<T, I><<<blocks, kActThreads, 0, stream>>>(
        xt, b, ot, work, inner, C, slope, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_index(const void* x, const float* b, void* out, long long n,
                   long long inner, int C, float slope, float scale,
                   cudaStream_t stream) {
  if (n < (1LL << 31))  // 32-bit index arithmetic wherever it suffices
    return launch_act<T, unsigned>(x, b, out, (unsigned)n, (unsigned)inner, C,
                                   slope, scale, stream);
  return launch_act<T, unsigned long long>(x, b, out, (unsigned long long)n,
                                           (unsigned long long)inner, C, slope,
                                           scale, stream);
}

}  // namespace keep

// x, out: n elements of (N, C, inner) in dtype (0 = float32, 1 = bfloat16);
// b: (C,) float32. Returns a cudaError_t value (0 = ok).
extern "C" int keep_fused_bias_lrelu(const void* x, const void* b, void* out,
                                     long long n, long long inner, int C,
                                     float slope, float scale, int dtype,
                                     void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || inner < 1 || C < 1 || n % (inner * C) != 0)
    return (int)cudaErrorInvalidValue;
  const float* bf = static_cast<const float*>(b);
  if (dtype == 0)
    return dispatch_index<float>(x, bf, out, n, inner, C, slope, scale, st);
  if (dtype == 1)
    return dispatch_index<bf16>(x, bf, out, n, inner, C, slope, scale, st);
  return (int)cudaErrorInvalidValue;
}
