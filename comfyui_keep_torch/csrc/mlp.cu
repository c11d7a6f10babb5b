// Fused transformer MLP tail of GMFlow's cross-attention sublayer, for
// Hopper (sm_90a):
//   out = src + LayerNorm(gelu(src @ W1a + msg @ W1b) @ W2) * gamma + beta
// with LayerNorm eps 1e-5, the hidden rounded to src's dtype before W2, and
// the sum taken in f32 before the cast back to src's dtype.
//
// Replaces comfyui_keep_tpu/ops/pallas_kernels.py: mlp_fused_pallas
// (_mlp_kernel). That kernel always uses the tanh gelu; here `approximate`
// selects tanh (bf16, as the TPU kernel) or erf (what the JAX package
// computes in f32, gmflow.py:336-337), so the kernel serves both dtypes.
//
// What bounds it on the H100: at C = 128, H = 1024 a row costs 6 C H = 786k
// flops against 6 C bytes in and 2 C bytes out (bf16), ~3000 flop/byte, so
// the tensor-core rate bounds it -- provided the (rows, H) hidden never
// reaches device memory (318 MB bf16 per call at the 20-frame chunk's
// 155,648 rows, written and read back).
//
// What the design does about it: one block per 64-row tile walks the hidden
// dimension in chunks of HC: h = src@W1a[:, j] + msg@W1b[:, j] into an f32
// shared tile, gelu, round to the input dtype, then acc += h @ W2[j, :] into
// an f32 (64 x C) shared accumulator. The epilogue computes the LayerNorm
// row statistics and writes src + LN(acc). bf16 products run on the tensor
// cores (WMMA); f32 products are plain FMA. Weights are re-read by every
// block from L2 (768 KB bf16 in all); staging them with TMA, multicast
// across a cluster, is left for the work that makes the kernel fast.
#include "common.cuh"

namespace keep {

constexpr int kC = 128;  // model width the kernel is built for

template <typename T> struct HiddenChunk { static constexpr int v = 64; };
template <> struct HiddenChunk<float> { static constexpr int v = 32; };

template <typename T>
struct MlpSmem {
  static constexpr int HC = HiddenChunk<T>::v;
  static constexpr int ldx = kC + Pad<T>::v;   // src / msg tiles, W2 chunk
  static constexpr int ldw = HC + Pad<T>::v;   // W1a / W1b chunks, hidden
  static constexpr int ldh = HC + 4;           // f32 hidden
  static constexpr int lda = kC + 4;           // f32 accumulator
  static constexpr size_t s = 0;
  static constexpr size_t m = s + align128(sizeof(T) * kRows * ldx);
  static constexpr size_t w1a = m + align128(sizeof(T) * kRows * ldx);
  static constexpr size_t w1b = w1a + align128(sizeof(T) * kC * ldw);
  static constexpr size_t w2 = w1b + align128(sizeof(T) * kC * ldw);
  static constexpr size_t hf = w2 + align128(sizeof(T) * HC * ldx);
  static constexpr size_t hs = hf + align128(sizeof(float) * kRows * ldh);
  static constexpr size_t acc = hs + align128(sizeof(T) * kRows * ldw);
  static constexpr size_t stats = acc + align128(sizeof(float) * kRows * lda);
  static constexpr size_t bytes = stats + align128(sizeof(float) * kRows * 2);
};

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// src, msg, out: (rows, 128); w1a, w1b: (128, H); w2: (H, 128); gamma, beta:
// (128,), all of T. H must be a multiple of HC. Grid ceil(rows / 64).
template <typename T, bool TANH>
__global__ void __launch_bounds__(kThreads)
    mlp_fused_kernel(const T* __restrict__ src, const T* __restrict__ msg,
                     const T* __restrict__ w1a, const T* __restrict__ w1b,
                     const T* __restrict__ w2, const T* __restrict__ gamma,
                     const T* __restrict__ beta, T* __restrict__ out, int rows,
                     int H) {
  using S = MlpSmem<T>;
  constexpr int HC = S::HC;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ss = reinterpret_cast<T*>(smem + S::s);
  T* Ms = reinterpret_cast<T*>(smem + S::m);
  T* W1as = reinterpret_cast<T*>(smem + S::w1a);
  T* W1bs = reinterpret_cast<T*>(smem + S::w1b);
  T* W2s = reinterpret_cast<T*>(smem + S::w2);
  float* Hf = reinterpret_cast<float*>(smem + S::hf);
  T* Hs = reinterpret_cast<T*>(smem + S::hs);
  float* Acc = reinterpret_cast<float*>(smem + S::acc);
  float* Stats = reinterpret_cast<float*>(smem + S::stats);

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kRows;
  load_tile(Ss, S::ldx, src, kC, r0, kRows, kC, rows);
  load_tile(Ms, S::ldx, msg, kC, r0, kRows, kC, rows);
  for (int i = tid; i < kRows * kC; i += kThreads)
    Acc[(i / kC) * S::lda + i % kC] = 0.0f;

  for (int h0 = 0; h0 < H; h0 += HC) {
    __syncthreads();  // previous chunk's weight and hidden reads are done
    for (int i = tid; i < kC * HC; i += kThreads) {
      const int r = i / HC, c = i % HC;
      W1as[r * S::ldw + c] = w1a[(size_t)r * H + h0 + c];
      W1bs[r * S::ldw + c] = w1b[(size_t)r * H + h0 + c];
    }
    load_tile(W2s, S::ldx, w2, kC, h0, HC, kC, H);
    __syncthreads();

    block_gemm<HC, kC, false, false>(Ss, S::ldx, W1as, S::ldw, Hf, S::ldh);
    __syncthreads();
    block_gemm<HC, kC, false, true>(Ms, S::ldx, W1bs, S::ldw, Hf, S::ldh);
    __syncthreads();

    for (int i = tid; i < kRows * HC; i += kThreads) {
      const int r = i / HC, c = i % HC;
      const float x = Hf[r * S::ldh + c];
      Hs[r * S::ldw + c] = from_f<T>(TANH ? gelu_tanh(x) : gelu_erf(x));
    }
    __syncthreads();

    block_gemm<kC, HC, false, true>(Hs, S::ldw, W2s, S::ldx, Acc, S::lda);
  }
  __syncthreads();

  // LayerNorm statistics: two threads per row, 64 columns each
  {
    const int row = tid >> 1, half = tid & 1;
    const float* arow = Acc + row * S::lda + half * (kC / 2);
    float sum = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kC / 2; ++c) sum += arow[c];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float mean = sum / kC;
    float sq = 0.0f;
#pragma unroll 8
    for (int c = 0; c < kC / 2; ++c) {
      const float d = arow[c] - mean;
      sq = fmaf(d, d, sq);
    }
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    if (half == 0) {
      Stats[2 * row] = mean;
      Stats[2 * row + 1] = rsqrtf(sq / kC + 1e-5f);
    }
  }
  __syncthreads();

  for (int i = tid; i < kRows * kC; i += kThreads) {
    const int r = i / kC, c = i % kC;
    if (r0 + r >= rows) continue;
    const float y = (Acc[r * S::lda + c] - Stats[2 * r]) * Stats[2 * r + 1] *
                        to_f(gamma[c]) +
                    to_f(beta[c]);
    out[(size_t)(r0 + r) * kC + c] = from_f<T>(to_f(Ss[r * S::ldx + c]) + y);
  }
}

template <typename T, bool TANH>
int launch_mlp(const void* src, const void* msg, const void* w1a,
               const void* w1b, const void* w2, const void* gamma,
               const void* beta, void* out, int rows, int H,
               cudaStream_t stream) {
  using S = MlpSmem<T>;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_kernel<T, TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kRows - 1) / kRows;
  mlp_fused_kernel<T, TANH><<<blocks, kThreads, S::bytes, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(msg),
      static_cast<const T*>(w1a), static_cast<const T*>(w1b),
      static_cast<const T*>(w2), static_cast<const T*>(gamma),
      static_cast<const T*>(beta), static_cast<T*>(out), rows, H);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16; approximate: 1 = tanh gelu, 0 = erf.
// Returns a cudaError_t value (0 = ok). C must be 128 and H a multiple of 64.
extern "C" int keep_mlp_fused(const void* src, const void* msg,
                              const void* w1a, const void* w1b, const void* w2,
                              const void* gamma, const void* beta, void* out,
                              int rows, int C, int H, int approximate,
                              int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return approximate
               ? launch_mlp<bf16, true>(src, msg, w1a, w1b, w2, gamma, beta,
                                        out, rows, H, st)
               : launch_mlp<bf16, false>(src, msg, w1a, w1b, w2, gamma, beta,
                                         out, rows, H, st);
  if (dtype == 0)
    return approximate
               ? launch_mlp<float, true>(src, msg, w1a, w1b, w2, gamma, beta,
                                         out, rows, H, st)
               : launch_mlp<float, false>(src, msg, w1a, w1b, w2, gamma,
                                          beta, out, rows, H, st);
  return (int)cudaErrorInvalidValue;
}
