// Fused transformer MLP tail of GMFlow's cross-attention sublayer, for
// Hopper (sm_90a):
//   out = src + LayerNorm(gelu([src | msg] @ W1^T) @ W2^T) * gamma + beta
// with W1 (H, 2C) and W2 (C, H) as nn.Linear holds them, LayerNorm eps 1e-5,
// the hidden rounded to src's dtype before W2, and the sum taken in f32
// before the cast back to src's dtype.
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
// 155,648 rows, written and read back). At that shape the bound is 0.124 ms.
//
// What the design does about it (bf16): one block of 8 warps owns 128 rows,
// one warp 16 of them. The warp's [src | msg] rows (16 x 256) are staged by
// cp.async into a swizzled shared tile and held in registers as mma.sync
// A fragments. The block walks the hidden dimension in chunks of 64: W1's 64
// rows (32 KB) and W2's 64 columns (16 KB) of a chunk land by 16-byte
// cp.async in swizzled tiles, three chunks deep, shared by the 8 warps and
// read by ldmatrix. Per chunk each warp forms its 16 x 64 hidden in f32
// registers (mma.sync m16n8k16), applies the gelu there, packs it to bf16 --
// the accumulator layout of m16n8k16 is its A-fragment layout, so the packed
// hidden feeds the second product directly -- and accumulates 16 x 128 of
// output in f32 registers. The LayerNorm runs on those registers: a row's
// 128 outputs sit in one quad of lanes, so its mean and variance are quad
// shuffles; the residual comes from the staged src, and the rows leave
// through shared memory in 16-byte stores. Neither the hidden nor the
// output accumulator passes through shared memory. The tanh gelu uses
// tanh.approx.f32 (relative error ~2^-11, under the bf16 rounding of the
// hidden that follows). Every block re-reads the 768 KB of weights from L2
// (~0.9 GB per call at the path's shape); sharing them across a cluster by
// TMA multicast is left for later work.
//
// f32 (the f32 training step, erf gelu): the first form, 64-row blocks of
// 4 warps with FMA products through shared memory (common.cuh block_gemm),
// reading the weights in nn.Linear's layout.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

constexpr int kC = 128;  // model width the kernels are built for

__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;  // sqrt(2 / pi)
  return 0.5f * x * (1.0f + tanhf(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_tanh_fast(float x) {
  const float c = 0.7978845608028654f;
  return 0.5f * x * (1.0f + tanh_approx(c * (x + 0.044715f * x * x * x)));
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.7071067811865476f));
}

// ---------------------------------------------------------------------------
// bf16: hidden and output accumulator in registers (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kMRows = 128;                       // rows per block: 8 x 16
constexpr int kMThreads = 256;
constexpr int kMHc = 64;                          // hidden units per chunk
constexpr int kMStages = 3;
constexpr int kARowBytes = 2 * kC * 2;            // a [src | msg] row: 512 B
constexpr int kW1RowBytes = 2 * kC * 2;           // a W1 row: 512 B
constexpr int kW2RowBytes = kMHc * 2;             // a W2 chunk row: 128 B
constexpr int kABytes = kMRows * kARowBytes;      // 64 KB
constexpr int kW1Bytes = kMHc * kW1RowBytes;      // 32 KB
constexpr int kStageBytes = kW1Bytes + kC * kW2RowBytes;   // 48 KB
constexpr int kMSmem = kABytes + kMStages * kStageBytes;   // 208 KB

// W1 rows [h0, h0 + 64) and W2 columns [h0, h0 + 64) into one stage
__device__ __forceinline__ void mlp_load_chunk(uint32_t stage, const bf16* w1,
                                               const bf16* w2, int h0, int H) {
#pragma unroll
  for (int k = 0; k < kMHc * 32 / kMThreads; ++k) {   // 8 per thread
    const int i = threadIdx.x + k * kMThreads;
    const int r = i >> 5, c = i & 31;
    sm90::cp_async16(stage + sm90::swz(r, c, kW1RowBytes),
                     w1 + (size_t)(h0 + r) * (2 * kC) + c * 8, 16);
  }
  const uint32_t s2 = stage + kW1Bytes;
#pragma unroll
  for (int k = 0; k < kC * 8 / kMThreads; ++k) {      // 4 per thread
    const int i = threadIdx.x + k * kMThreads;
    const int r = i >> 3, c = i & 7;
    sm90::cp_async16(s2 + sm90::swz(r, c, kW2RowBytes),
                     w2 + (size_t)r * H + h0 + c * 8, 16);
  }
}

// src, msg, out: (rows, 128); w1: (H, 256); w2: (128, H); gamma, beta:
// (128,), all bf16. H % 64 == 0. Grid ceil(rows / 128), 256 threads; warp
// w owns rows 16w..16w+15 of the block, and each lane holds, per 8-column
// tile j, the elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1), g =
// lane / 4, t = lane % 4 (mma.sync's accumulator layout).
template <bool TANH>
__global__ void __launch_bounds__(kMThreads, 1)
    mlp_fused_bf16_kernel(const bf16* __restrict__ src,
                          const bf16* __restrict__ msg,
                          const bf16* __restrict__ w1,
                          const bf16* __restrict__ w2,
                          const bf16* __restrict__ gamma,
                          const bf16* __restrict__ beta,
                          bf16* __restrict__ out, int rows, int H) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t sa = sm90::smem_u32(smem);
  const uint32_t sw = sa + kABytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int r0 = blockIdx.x * kMRows;
  const int n_chunks = H / kMHc;

  // [src | msg] rows: chunks 0..15 of a row are src, 16..31 msg; rows at or
  // past `rows` are zero-filled
#pragma unroll
  for (int k = 0; k < kMRows * 32 / kMThreads; ++k) {  // 16 per thread
    const int i = tid + k * kMThreads;
    const int r = i >> 5, c = i & 31;
    const bool ok = r0 + r < rows;
    const bf16* base = c < 16 ? src : msg;
    sm90::cp_async16(sa + sm90::swz(r, c, kARowBytes),
                     base + (size_t)(ok ? r0 + r : 0) * kC + (c & 15) * 8,
                     ok ? 16 : 0);
  }
  mlp_load_chunk(sw, w1, w2, 0, H);
  sm90::cp_async_commit();
  if (n_chunks > 1) mlp_load_chunk(sw + kStageBytes, w1, w2, kMHc, H);
  sm90::cp_async_commit();

  uint32_t a[16][4];  // the warp's 16 x 256 [src | msg] as A fragments
  float o[16][4];     // 16 x 128 f32 output accumulator
#pragma unroll
  for (int n = 0; n < 16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  for (int j = 0; j < n_chunks; ++j) {
    sm90::cp_async_wait<1>();
    __syncthreads();  // chunk j landed; every warp is done with chunk j - 1
    if (j == 0) {
#pragma unroll
      for (int s = 0; s < 16; ++s)
        sm90::ldsm_x4(sa + sm90::swz(16 * warp + (mi & 1) * 8 + mr,
                                     2 * s + (mi >> 1), kARowBytes),
                      a[s]);
    }
    if (j + 2 < n_chunks)
      mlp_load_chunk(sw + ((j + 2) % kMStages) * kStageBytes, w1, w2,
                     (j + 2) * kMHc, H);
    sm90::cp_async_commit();
    const uint32_t w1t = sw + (j % kMStages) * kStageBytes;
    const uint32_t w2t = w1t + kW1Bytes;

    // hidden = [src | msg] W1[h0:h0+64]^T: 16 x 64 per warp, f32
    float h[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) h[n][0] = h[n][1] = h[n][2] = h[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 16; ++ks) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];  // hidden tiles 2p, 2p+1 x k halves of this k step
        sm90::ldsm_x4(w1t + sm90::swz(16 * p + (mi >> 1) * 8 + mr,
                                      2 * ks + (mi & 1), kW1RowBytes),
                      b);
        sm90::mma_bf16(h[2 * p], a[ks], b[0], b[1]);
        sm90::mma_bf16(h[2 * p + 1], a[ks], b[2], b[3]);
      }
    }

    // gelu on the registers, rounded to bf16: the A fragments of h W2^T
    uint32_t pa[4][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = TANH ? gelu_tanh_fast(h[n][e]) : gelu_erf(h[n][e]);
      pa[n >> 1][(n & 1) * 2] = sm90::pack_bf16(v[0], v[1]);
      pa[n >> 1][(n & 1) * 2 + 1] = sm90::pack_bf16(v[2], v[3]);
    }

    // out += gelu(hidden) W2[:, h0:h0+64]^T: 16 x 128 per warp
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        uint32_t b[4];  // output tiles 2p, 2p+1 x k halves of this k step
        sm90::ldsm_x4(w2t + sm90::swz(16 * p + (mi >> 1) * 8 + mr,
                                      2 * ks + (mi & 1), kW2RowBytes),
                      b);
        sm90::mma_bf16(o[2 * p], pa[ks], b[0], b[1]);
        sm90::mma_bf16(o[2 * p + 1], pa[ks], b[2], b[3]);
      }
    }
  }

  // LayerNorm over each row's 128 outputs, held by one quad: rows g and g+8
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    s0 += o[n][0] + o[n][1];
    s1 += o[n][2] + o[n][3];
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, w);
    s1 += __shfl_xor_sync(0xffffffffu, s1, w);
  }
  const float mean0 = s0 * (1.f / kC), mean1 = s1 * (1.f / kC);
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float d0 = o[n][0] - mean0, d1 = o[n][1] - mean0;
    const float d2 = o[n][2] - mean1, d3 = o[n][3] - mean1;
    q0 = fmaf(d0, d0, fmaf(d1, d1, q0));
    q1 = fmaf(d2, d2, fmaf(d3, d3, q1));
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    q0 += __shfl_xor_sync(0xffffffffu, q0, w);
    q1 += __shfl_xor_sync(0xffffffffu, q1, w);
  }
  const float rs0 = rsqrtf(q0 * (1.f / kC) + 1e-5f);
  const float rs1 = rsqrtf(q1 * (1.f / kC) + 1e-5f);

  // + src (the staged tile's chunks 0..15), rounded to bf16 into the same
  // place: only this warp reads or writes its rows, each lane its own words
  const int ra = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int c = 8 * n + 2 * t;
    const float2 gm = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(gamma + c));
    const float2 bt = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(beta + c));
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mean = hh ? mean1 : mean0, rs = hh ? rs1 : rs0;
      uint32_t* p = reinterpret_cast<uint32_t*>(
          smem + sm90::swz(ra + 8 * hh, n, kARowBytes) + 4 * t);
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p));
      const float y0 = (o[n][2 * hh] - mean) * rs * gm.x + bt.x;
      const float y1 = (o[n][2 * hh + 1] - mean) * rs * gm.y + bt.y;
      *p = sm90::pack_bf16(x.x + y0, x.y + y1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    const int r = 16 * warp + (i >> 4), c = i & 15;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * kC + 8 * c) =
          *reinterpret_cast<const uint4*>(smem +
                                          sm90::swz(r, c, kARowBytes));
  }
}

template <bool TANH>
int launch_mlp_bf16(const void* src, const void* msg, const void* w1,
                    const void* w2, const void* gamma, const void* beta,
                    void* out, int rows, int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_bf16_kernel<TANH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kMRows - 1) / kMRows;
  mlp_fused_bf16_kernel<TANH><<<blocks, kMThreads, kMSmem, stream>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(msg),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<bf16*>(out), rows, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: the first form (FMA through shared memory)
// ---------------------------------------------------------------------------

constexpr int kF32Hc = 32;  // hidden units per chunk

struct MlpF32Smem {
  static constexpr int HC = kF32Hc;
  static constexpr int ldx = kC + Pad<float>::v;   // src / msg tiles, W2 chunk
  static constexpr int ldw = HC + Pad<float>::v;   // W1 chunks, hidden
  static constexpr int ldh = HC + 4;               // f32 hidden
  static constexpr int lda = kC + 4;               // f32 accumulator
  static constexpr size_t s = 0;
  static constexpr size_t m = s + align128(sizeof(float) * kRows * ldx);
  static constexpr size_t w1a = m + align128(sizeof(float) * kRows * ldx);
  static constexpr size_t w1b = w1a + align128(sizeof(float) * kC * ldw);
  static constexpr size_t w2 = w1b + align128(sizeof(float) * kC * ldw);
  static constexpr size_t hf = w2 + align128(sizeof(float) * HC * ldx);
  static constexpr size_t hs = hf + align128(sizeof(float) * kRows * ldh);
  static constexpr size_t acc = hs + align128(sizeof(float) * kRows * ldw);
  static constexpr size_t stats = acc + align128(sizeof(float) * kRows * lda);
  static constexpr size_t bytes = stats + align128(sizeof(float) * kRows * 2);
};

// src, msg, out: (rows, 128); w1: (H, 256); w2: (128, H); gamma, beta:
// (128,), all f32. H must be a multiple of 32. Grid ceil(rows / 64).
template <bool TANH>
__global__ void __launch_bounds__(kThreads)
    mlp_fused_f32_kernel(const float* __restrict__ src,
                         const float* __restrict__ msg,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int rows, int H) {
  using S = MlpF32Smem;
  constexpr int HC = S::HC;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  float* Ms = reinterpret_cast<float*>(smem + S::m);
  float* W1as = reinterpret_cast<float*>(smem + S::w1a);
  float* W1bs = reinterpret_cast<float*>(smem + S::w1b);
  float* W2s = reinterpret_cast<float*>(smem + S::w2);
  float* Hf = reinterpret_cast<float*>(smem + S::hf);
  float* Hs = reinterpret_cast<float*>(smem + S::hs);
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
    // W1a[k][j] = w1[h0 + j][k], W1b[k][j] = w1[h0 + j][128 + k]
    for (int i = tid; i < kC * HC; i += kThreads) {
      const int j = i / kC, k = i % kC;
      const float* wr = w1 + (size_t)(h0 + j) * (2 * kC);
      W1as[k * S::ldw + j] = wr[k];
      W1bs[k * S::ldw + j] = wr[kC + k];
    }
    // W2s[j][c] = w2[c][h0 + j]
    for (int i = tid; i < kC * HC; i += kThreads) {
      const int c = i / HC, j = i % HC;
      W2s[j * S::ldx + c] = w2[(size_t)c * H + h0 + j];
    }
    __syncthreads();

    block_gemm<HC, kC, false, false>(Ss, S::ldx, W1as, S::ldw, Hf, S::ldh);
    __syncthreads();
    block_gemm<HC, kC, false, true>(Ms, S::ldx, W1bs, S::ldw, Hf, S::ldh);
    __syncthreads();

    for (int i = tid; i < kRows * HC; i += kThreads) {
      const int r = i / HC, c = i % HC;
      const float x = Hf[r * S::ldh + c];
      Hs[r * S::ldw + c] = TANH ? gelu_tanh(x) : gelu_erf(x);
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
                        gamma[c] + beta[c];
    out[(size_t)(r0 + r) * kC + c] = Ss[r * S::ldx + c] + y;
  }
}

template <bool TANH>
int launch_mlp_f32(const void* src, const void* msg, const void* w1,
                   const void* w2, const void* gamma, const void* beta,
                   void* out, int rows, int H, cudaStream_t stream) {
  using S = MlpF32Smem;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_f32_kernel<TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kRows - 1) / kRows;
  mlp_fused_f32_kernel<TANH><<<blocks, kThreads, S::bytes, stream>>>(
      static_cast<const float*>(src), static_cast<const float*>(msg),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(out), rows, H);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16; approximate: 1 = tanh gelu, 0 = erf.
// w1: (H, 2C), w2: (C, H), nn.Linear's layouts; every pointer 16-byte
// aligned. Returns a cudaError_t value (0 = ok). C must be 128 and H a
// multiple of 64.
extern "C" int keep_mlp_fused(const void* src, const void* msg, const void* w1,
                              const void* w2, const void* gamma,
                              const void* beta, void* out, int rows, int C,
                              int H, int approximate, int dtype,
                              void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return approximate ? launch_mlp_bf16<true>(src, msg, w1, w2, gamma, beta,
                                               out, rows, H, st)
                       : launch_mlp_bf16<false>(src, msg, w1, w2, gamma,
                                                beta, out, rows, H, st);
  if (dtype == 0)
    return approximate ? launch_mlp_f32<true>(src, msg, w1, w2, gamma, beta,
                                              out, rows, H, st)
                       : launch_mlp_f32<false>(src, msg, w1, w2, gamma, beta,
                                               out, rows, H, st);
  return (int)cudaErrorInvalidValue;
}
