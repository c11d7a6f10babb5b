// Flash-style single-head attention for Hopper (sm_90a), and the fused
// global-correlation softmax expectation, from one template.
//
// Replaces two TPU kernels of comfyui_keep_tpu/ops/pallas_kernels.py:
//   * attention_pallas (_attn_kernel, _attn_bias_kernel): softmax(q k^T *
//     scale [+ bias[b % Bm]]) v over (B, L, D). GMFlow's window self/cross
//     attention (L = 1024, D = 128, D_v = 128, bias on shifted layers) and
//     its global flow-propagation attention (L = 4096, D = 128, D_v = 2).
//   * global_correlation_expectation_pallas (_corr_flash_kernel):
//     softmax(f0 f1^T / sqrt(C)) @ grid with an f32 (L, 2) pixel grid shared
//     by the batch; P and the P-grid sum stay f32.
//
// What bounds it on the H100: at D = 128 every query tile re-reads all K/V
// once per tile, so the work is ~4 L^2 D flops against ~4 L D bytes per
// batch entry -- far above the card's ~295 flop/byte ridge in bf16, so the
// tensor-core rate bounds it, and the score matrix must never reach device
// memory (1 GB f32 per 20-frame chunk for the global attentions alone).
//
// What the design does about it: one block per (64-query tile, batch
// entry) loops over 64-key tiles staged in shared memory with an online
// softmax (running max m, running sum l, f32 accumulator), and normalises
// once after the last tile, so scores live only in a 64 x 64 shared tile.
// A TPU VMEM block holds a whole (bq, L) f32 score row block; an SM's 227 KB
// cannot at L = 1024 or 4096, hence the tile loop. bf16 products run on the
// tensor cores (WMMA, bf16 in, f32 accumulate); f32 products are plain FMA.
// Narrow V (D_v <= 8: the 2-wide flow and the pixel grid) is accumulated in
// registers by the softmax threads themselves, with no padding to 128 lanes.
// exp2 with log2(e) folded into the scale, as the TPU kernel does. Speed
// work (TMA, wgmma, a register-resident accumulator) is left for later.
#include "common.cuh"

namespace keep {

constexpr int kD = 128;    // q/k width the kernel is built for
constexpr int kKeys = 64;  // keys per tile

template <typename T, typename TV, typename TO, int DV, bool NARROW,
          bool ROUND_P>
struct AttnSmem {
  static constexpr int ldq = kD + Pad<T>::v;
  static constexpr int lds = kKeys + 4;
  static constexpr int ldp = kKeys + Pad<T>::v;
  static constexpr int ldv = NARROW ? DV : DV + Pad<TV>::v;
  static constexpr int ldo = DV + 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * kRows * ldq);
  static constexpr size_t v = k + align128(sizeof(T) * kKeys * ldq);
  static constexpr size_t s = v + align128(sizeof(TV) * kKeys * ldv);
  static constexpr size_t p = s + align128(sizeof(float) * kRows * lds);
  static constexpr size_t o =
      p + (NARROW ? 0 : align128(sizeof(T) * kRows * ldp));
  static constexpr size_t l =
      o + (NARROW ? 0 : align128(sizeof(float) * kRows * ldo));
  static constexpr size_t bytes = l + align128(sizeof(float) * kRows);
};

// q, k: (B, L, 128) of T; v: (B, L, DV) of TV with batch stride v_bstride
// elements (0 = one V shared by the batch); bias: (Bm, L, L) f32 or null;
// out: (B, L, DV) of TO. Grid (ceil(L / 64), B), 128 threads.
template <typename T, typename TV, typename TO, int DV, bool NARROW,
          bool ROUND_P>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const TV* __restrict__ v, size_t v_bstride,
                           const float* __restrict__ bias, int bm,
                           TO* __restrict__ out, int L, float scale_log2) {
  using S = AttnSmem<T, TV, TO, DV, NARROW, ROUND_P>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  TV* Vs = reinterpret_cast<TV*>(smem + S::v);
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  T* Ps = reinterpret_cast<T*>(smem + S::p);
  float* Os = reinterpret_cast<float*>(smem + S::o);
  float* Ls = reinterpret_cast<float*>(smem + S::l);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const T* qb = q + (size_t)b * L * kD;
  const T* kb = k + (size_t)b * L * kD;
  const TV* vb = v + (size_t)b * v_bstride;
  const float* biasb =
      bias ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;

  load_tile(Qs, S::ldq, qb, kD, q0, kRows, kD, L);
  if constexpr (!NARROW) {
    for (int i = tid; i < kRows * DV; i += kThreads)
      Os[(i / DV) * S::ldo + i % DV] = 0.0f;
  }

  // two threads per query row: row = tid / 2 owns key columns half*32..+31
  const int row = tid >> 1, half = tid & 1;
  float m_i = -INFINITY, l_i = 0.0f;
  float acc[NARROW ? DV : 1];
#pragma unroll
  for (int d = 0; d < (NARROW ? DV : 1); ++d) acc[d] = 0.0f;

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // previous tile's K/V/P reads are done
    load_tile(Ks, S::ldq, kb, kD, k0, kKeys, kD, L);
    load_tile(Vs, S::ldv, vb, DV, k0, kKeys, DV, L);
    __syncthreads();

    block_gemm<kKeys, kD, true, false>(Qs, S::ldq, Ks, S::ldq, Ss, S::lds);
    __syncthreads();

    // scale, bias and the ragged-tile mask, one coalesced pass
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, c = i % kKeys;
      const int j = k0 + c, qi = q0 + r;
      float s = Ss[r * S::lds + c] * scale_log2;
      if (j >= L)
        s = -INFINITY;
      else if (biasb != nullptr && qi < L)
        s += biasb[(size_t)qi * L + j] * kLog2e;
      Ss[r * S::lds + c] = s;
    }
    __syncthreads();

    // online softmax over this tile's 64 keys
    const float* srow = Ss + row * S::lds + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);  // finite: key 0 is always valid
    const float alpha = exp2f(m_i - m_new);
    float sum = 0.0f;
    if constexpr (NARROW) {
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] *= alpha;
    }
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f(srow[c] - m_new);
      sum += p;
      if constexpr (NARROW) {
        const float pv = ROUND_P ? to_f(from_f<T>(p)) : p;
        const TV* vrow = Vs + (half * 32 + c) * S::ldv;
#pragma unroll
        for (int d = 0; d < DV; ++d) acc[d] = fmaf(pv, to_f(vrow[d]), acc[d]);
      } else {
        Ps[row * S::ldp + half * 32 + c] = from_f<T>(p);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;

    if constexpr (!NARROW) {
      float* orow = Os + row * S::ldo + half * (DV / 2);
#pragma unroll 8
      for (int c = 0; c < DV / 2; ++c) orow[c] *= alpha;
      __syncthreads();
      block_gemm<DV, kKeys, false, true>(Ps, S::ldp, Vs, S::ldv, Os, S::ldo);
    }
  }

  if constexpr (NARROW) {
#pragma unroll
    for (int d = 0; d < DV; ++d)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], 1);
    if (half == 0 && q0 + row < L) {
      TO* orow = out + ((size_t)b * L + q0 + row) * DV;
#pragma unroll
      for (int d = 0; d < DV; ++d) orow[d] = from_f<TO>(acc[d] / l_i);
    }
  } else {
    if (half == 0) Ls[row] = l_i;
    __syncthreads();
    for (int i = tid; i < kRows * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      if (q0 + r < L)
        out[((size_t)b * L + q0 + r) * DV + c] =
            from_f<TO>(Os[r * S::ldo + c] / Ls[r]);
    }
  }
}

template <typename T, typename TV, typename TO, int DV, bool NARROW,
          bool ROUND_P>
int launch(const void* q, const void* k, const void* v, size_t v_bstride,
           const void* bias, int bm, void* out, int B, int L, float scale,
           cudaStream_t stream) {
  using S = AttnSmem<T, TV, TO, DV, NARROW, ROUND_P>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, TV, TO, DV, NARROW, ROUND_P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kRows - 1) / kRows, B);
  flash_attention_kernel<T, TV, TO, DV, NARROW, ROUND_P>
      <<<grid, kThreads, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const TV*>(v), v_bstride, static_cast<const float*>(bias),
      bm, static_cast<TO*>(out), L, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
// q, k: (B, L, D); v, out: (B, L, DV) of the same dtype; bias: (Bm, L, L)
// f32 or null. D must be 128 and DV 128 or 2.
extern "C" int keep_attention(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int B, int L, int D,
                              int DV, int Bm, float scale, int dtype,
                              void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != kD || B < 1 || L < 1 || (bias != nullptr && Bm < 1))
    return (int)cudaErrorInvalidValue;
  const size_t vb = (size_t)L * DV;
  if (DV == kD) {
    if (dtype == 1)
      return launch<bf16, bf16, bf16, kD, false, true>(q, k, v, vb, bias, Bm,
                                                       out, B, L, scale, st);
    if (dtype == 0)
      return launch<float, float, float, kD, false, true>(
          q, k, v, vb, bias, Bm, out, B, L, scale, st);
  } else if (DV == 2) {
    if (dtype == 1)
      return launch<bf16, bf16, bf16, 2, true, true>(q, k, v, vb, bias, Bm,
                                                     out, B, L, scale, st);
    if (dtype == 0)
      return launch<float, float, float, 2, true, true>(q, k, v, vb, bias, Bm,
                                                        out, B, L, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// f0, f1: (B, L, C) of dtype, C = 128; grid: (L, 2) f32; out: (B, L, 2) f32.
extern "C" int keep_corr_expectation(const void* f0, const void* f1,
                                     const void* grid, void* out, int B, int L,
                                     int C, float scale, int dtype,
                                     void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kD || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<bf16, float, float, 2, true, false>(f0, f1, grid, 0, nullptr,
                                                      1, out, B, L, scale, st);
  if (dtype == 0)
    return launch<float, float, float, 2, true, false>(
        f0, f1, grid, 0, nullptr, 1, out, B, L, scale, st);
  return (int)cudaErrorInvalidValue;
}
