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
// f32 (the f32 training step's GMFlow, erf gelu): mlp_fused_f32_kernel
// keeps the arithmetic f32 (no TF32), so the FMA pipe's 67 TFLOP/s bounds
// it: 1.83 ms at the chunk's shape. A register-tiled FMA design, after the
// f32 flash attention kernel: one block of 8 warps owns 128 rows, staged
// once by cp.async into padded rows ([src | msg], 260 floats). Both
// products read K-contiguous operands, since nn.Linear's W1 row is a hidden
// unit over the inputs and W2's row an output over the hidden units. The
// weights stream through a 3-slot ring of 64 x 64 slices (16-byte cp.async,
// rows padded to 68 floats, two slices in flight while one multiplies):
// per 64-wide hidden chunk, W1 in four 64-deep input slices, then W2 in two
// 64-output halves. Lane 8 rg + cg of warp w forms a 4 x 8 hidden tile in
// registers (rows 16 w + rg + 4 r, units cg + 8 c: 12 float4 loads per 128
// FMAs, a warp's reads in distinct banks), applies the gelu there and
// stores it once into its warp's rows of a padded hidden tile, from which
// the same lane accumulates its 4 x 16 outputs in registers across all of
// H. The LayerNorm runs on those registers (a row's 8 lanes reduce with 3
// shuffles), and the residual comes from the staged src. 220 KB of shared
// memory: one block per SM.
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
// f32: register-tiled FMA (no TF32)
// ---------------------------------------------------------------------------

constexpr int kFRows = 128;           // rows per block: 8 warps x 16
constexpr int kFThreads = 256;
constexpr int kFHc = 64;              // hidden units per chunk
constexpr int kFSlice = 64;           // rows and depth of a weight slice
constexpr int kFParts = 6;            // slices per chunk: W1 in 4, W2 in 2
constexpr int kFStages = 3;           // ring slots; two slices load ahead
constexpr int kFLdx = 2 * kC + 4;     // floats per staged [src | msg] row
constexpr int kFLds = kFSlice + 4;    // floats per slice or hidden row
constexpr int kFXBytes = 4 * kFRows * kFLdx;         // 133,120
constexpr int kFHBytes = 4 * kFRows * kFLds;         // 34,816
constexpr int kFSlotBytes = 4 * kFSlice * kFLds;     // 17,408
constexpr int kFSmem = kFXBytes + kFHBytes + kFStages * kFSlotBytes;  // 220,160
static_assert(kFParts % kFStages == 0, "a part keeps its ring slot");

// slice t of the weight stream into ring slot (t % 6) % 3: chunk j = t / 6
// (hidden units h0 = 64 j ..), part p = t % 6. Parts 0-3 are W1's rows h0..
// over inputs 64 p .. 64 p + 63; parts 4-5 are W2's rows 64 (p - 4) .. over
// hidden units h0 .. h0 + 63. Each row of 64 floats is K-contiguous.
__device__ __forceinline__ void mlp_f32_load_slice(uint32_t ring,
                                                   const float* w1,
                                                   const float* w2, int t,
                                                   int H) {
  const int h0 = (t / kFParts) * kFHc, part = t % kFParts;
  const float* base = part < 4
      ? w1 + (size_t)h0 * (2 * kC) + kFSlice * part
      : w2 + (size_t)(kFSlice * (part - 4)) * H + h0;
  const size_t ld = part < 4 ? 2 * kC : (size_t)H;
  const uint32_t dst = ring + (part % kFStages) * kFSlotBytes;
#pragma unroll
  for (int k = 0; k < kFSlice * (kFSlice / 4) / kFThreads; ++k) {  // 4 each
    const int i = threadIdx.x + k * kFThreads;
    const int r = i >> 4, c = i & 15;
    sm90::cp_async16(dst + 4 * (r * kFLds + 4 * c), base + r * ld + 4 * c, 16);
  }
}

// acc[r][c] += sum_{k < 64} a[4 r LDA + k] b[8 c kFLds + k]: the lane's
// 4 x 8 tile, both operands K-contiguous, read 16 bytes at a time (12 loads
// per 128 FMAs)
template <int LDA>
__device__ __forceinline__ void mlp_f32_tile(float (&acc)[4][8],
                                             const float* a, const float* b) {
#pragma unroll 4
  for (int k = 0; k < kFSlice; k += 4) {
    float4 av[4], bv[8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      av[r] = *reinterpret_cast<const float4*>(a + 4 * r * LDA + k);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      bv[c] = *reinterpret_cast<const float4*>(b + 8 * c * kFLds + k);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
        acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
        acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
      }
  }
}

// src, msg, out: (rows, 128); w1: (H, 256); w2: (128, H); gamma, beta:
// (128,), all f32. H % 64 == 0. Grid ceil(rows / 128), 256 threads. Lane
// 8 rg + cg of warp w owns rows 16 w + rg + 4 r (r < 4) of the block: hidden
// units cg + 8 c (c < 8) of a chunk, and outputs 64 hh + cg + 8 c (hh < 2);
// a row's 8 lanes differ in lane bits 0-2. Every slice step commits one
// cp.async group, and the first carries the staged rows.
template <bool TANH>
__global__ void __launch_bounds__(kFThreads, 1)
    mlp_fused_f32_kernel(const float* __restrict__ src,
                         const float* __restrict__ msg,
                         const float* __restrict__ w1,
                         const float* __restrict__ w2,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ out, int rows, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sx = sm90::smem_u32(smem);
  const uint32_t ring = sx + kFXBytes + kFHBytes;
  const float* Xs = reinterpret_cast<const float*>(smem);
  float* Hs = reinterpret_cast<float*>(smem + kFXBytes);
  const float* Ring = reinterpret_cast<const float*>(smem + kFXBytes + kFHBytes);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int wr = 16 * warp + rg;  // the lane's rows: wr + 4 r of the block
  const int r0 = blockIdx.x * kFRows;
  const int steps = (H / kFHc) * kFParts;

  // [src | msg] rows: 16-byte chunks 0..31 of a row are src, 32..63 msg;
  // rows at or past `rows` are zero-filled
#pragma unroll 8
  for (int k = 0; k < kFRows * 64 / kFThreads; ++k) {  // 32 per thread
    const int i = tid + k * kFThreads;
    const int r = i >> 6, c = i & 63;
    const bool ok = r0 + r < rows;
    const float* base = c < 32 ? src : msg;
    sm90::cp_async16(sx + 4 * (r * kFLdx + 4 * c),
                     base + (size_t)(ok ? r0 + r : 0) * kC + 4 * (c & 31),
                     ok ? 16 : 0);
  }
  mlp_f32_load_slice(ring, w1, w2, 0, H);
  sm90::cp_async_commit();
  mlp_f32_load_slice(ring, w1, w2, 1, H);
  sm90::cp_async_commit();

  float o[2][4][8];  // the lane's 4 x 16 outputs, f32, across all of H
  float h[4][8];     // its 4 x 8 hidden units of the chunk
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) o[hh][r][c] = 0.f;

  for (int t0 = 0; t0 < steps; t0 += kFParts) {
#pragma unroll
    for (int part = 0; part < kFParts; ++part) {
      const int t = t0 + part;
      sm90::cp_async_wait<1>();
      __syncthreads();  // slice t landed; every warp is done with slice t - 1
      if (t + 2 < steps) mlp_f32_load_slice(ring, w1, w2, t + 2, H);
      sm90::cp_async_commit();
      const float* slot = Ring + (part % kFStages) * (kFSlotBytes / 4) +
                          cg * kFLds;
      if (part < 4) {
        // hidden += [src | msg][:, 64 part ..] W1[h0 .., 64 part ..]^T
        if (part == 0) {
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) h[r][c] = 0.f;
        }
        mlp_f32_tile<kFLdx>(h, Xs + wr * kFLdx + kFSlice * part, slot);
        if (part == 3) {
          // gelu on the registers, stored once into the warp's rows of the
          // hidden tile; the next step's barrier orders it before the reads
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c)
              Hs[(wr + 4 * r) * kFLds + cg + 8 * c] =
                  TANH ? gelu_tanh(h[r][c]) : gelu_erf(h[r][c]);
        }
      } else {
        // out[:, 64 (part - 4) ..] += gelu(hidden) W2[64 (part - 4) .., h0 ..]^T
        mlp_f32_tile<kFLds>(o[part & 1], Hs + wr * kFLds, slot);
      }
    }
  }

  // LayerNorm over each row's 128 outputs, held by its 8 lanes
  float mean[4], rs[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float s = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c) s += o[hh][r][c];
    mean[r] = s;
  }
#pragma unroll
  for (int w = 1; w < 8; w <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      mean[r] += __shfl_xor_sync(0xffffffffu, mean[r], w);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    mean[r] *= 1.f / kC;
    float q = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float d = o[hh][r][c] - mean[r];
        q = fmaf(d, d, q);
      }
    rs[r] = q;
  }
#pragma unroll
  for (int w = 1; w < 8; w <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], w);
#pragma unroll
  for (int r = 0; r < 4; ++r) rs[r] = rsqrtf(rs[r] * (1.f / kC) + 1e-5f);

  // + src from the staged rows; each store writes 8 consecutive floats of
  // 4 rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 64 * hh + cg + 8 * c;
      const float gm = __ldg(gamma + col), bt = __ldg(beta + col);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int row = wr + 4 * r;
        if (r0 + row < rows)
          out[(size_t)(r0 + row) * kC + col] =
              Xs[row * kFLdx + col] +
              ((o[hh][r][c] - mean[r]) * rs[r] * gm + bt);
      }
    }
}

template <bool TANH>
int launch_mlp_f32(const void* src, const void* msg, const void* w1,
                   const void* w2, const void* gamma, const void* beta,
                   void* out, int rows, int H, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_f32_kernel<TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kFRows - 1) / kFRows;
  mlp_fused_f32_kernel<TANH><<<blocks, kFThreads, kFSmem, stream>>>(
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
