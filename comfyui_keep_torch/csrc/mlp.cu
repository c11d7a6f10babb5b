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
//
// Backward (mlp_fused_bwd_kernel, both dtypes, f32 arithmetic): the TPU
// kernel has none (the JAX package differentiates its unfused branch); it
// computes the gradient of the function above. Under grad the forward also
// writes the LayerNorm's input o (rows, C) f32. Per 128 rows, the forward
// f32 kernel's layout (8 warps, 4 x 8 lane tiles, the weights streamed as
// 64 x 64 slices through the 3-slot ring): stage 1 recomputes a = [src |
// msg] W1^T and h = gelu(a) (rounded to src's dtype) and writes both to
// f32 memory; the LayerNorm backward runs on o's registers (dgamma and
// dbeta as fixed-order per-block column sums, then a reduce kernel); stage
// 2 walks H again: dh = dO' W2[:, h0 ..] with dO' staged over the [src |
// msg] rows, da = dh gelu'(a) (a's chunk staged one chunk ahead), written
// over a, and d[src | msg] += da W1[h0 ..] in registers (4 x 32 a lane).
// The weight gradients dW1 = da^T [src | msg] and dW2 = dO'^T h are
// products over every row, left to the caller (cuBLAS), as the JAX package
// leaves its weight products to XLA. Bound on the H100 by the FMA pipe:
// 64.4 GFLOP in the kernel at the GMFlow step's 49,152 rows (a, dh, dx),
// 38.7 in the two weight products.
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
                          bf16* __restrict__ out,
                          float* __restrict__ o_out, int rows, int H) {
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
  if (o_out != nullptr) {  // the LayerNorm's input, for the backward
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = r0 + 16 * warp + g + 8 * hh;
      if (row < rows) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(o_out + (size_t)row * kC + 8 * n + 2 * t) =
              make_float2(o[n][2 * hh], o[n][2 * hh + 1]);
      }
    }
  }

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
                    void* out, float* o_out, int rows, int H,
                    cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_bf16_kernel<TANH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kMRows - 1) / kMRows;
  mlp_fused_bf16_kernel<TANH><<<blocks, kMThreads, kMSmem, stream>>>(
      static_cast<const bf16*>(src), static_cast<const bf16*>(msg),
      static_cast<const bf16*>(w1), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(gamma), static_cast<const bf16*>(beta),
      static_cast<bf16*>(out), o_out, rows, H);
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
                         float* __restrict__ out,
                         float* __restrict__ o_out, int rows, int H) {
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
  if (o_out != nullptr) {  // the LayerNorm's input, for the backward
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r0 + wr + 4 * r;
      if (row >= rows) continue;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          o_out[(size_t)row * kC + 64 * hh + cg + 8 * c] = o[hh][r][c];
    }
  }

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
                   void* out, float* o_out, int rows, int H,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_f32_kernel<TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kFRows - 1) / kFRows;
  mlp_fused_f32_kernel<TANH><<<blocks, kFThreads, kFSmem, stream>>>(
      static_cast<const float*>(src), static_cast<const float*>(msg),
      static_cast<const float*>(w1), static_cast<const float*>(w2),
      static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float*>(out), o_out, rows, H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (both dtypes): register-tiled FMA in f32, 8 warps
// ---------------------------------------------------------------------------

constexpr int kGRows = 128;            // rows per block: 8 warps x 16
constexpr int kGThreads = 256;
constexpr int kGR = 4;                 // rows per lane
constexpr int kGLdx = 2 * kC + 4;      // floats per staged [src | msg] row
constexpr int kGLdo = kC + 4;          // floats per dO' row (stage 2)
constexpr int kGLds = kFSlice + 4;     // floats per slice, hidden or a row
constexpr int kGXBytes = 4 * kGRows * kGLdx;           // 133,120
constexpr int kGHBytes = 4 * kGRows * kGLds;           // 34,816
constexpr int kGSlotBytes = 4 * kFSlice * kGLds;       // 17,408
constexpr int kGAOff = 4 * kGRows * kGLdo;             // a's chunk (stage 2)
constexpr int kGSmem = kGXBytes + kGHBytes + kFStages * kGSlotBytes;  // 220,160
static_assert(kGAOff + kGHBytes <= kGXBytes, "dO' and a fit in the rows");

// d/dx of the gelu (erf, or the tanh form's as torch writes it)
template <bool TANH>
__device__ __forceinline__ float gelu_grad(float x) {
  if constexpr (TANH) {
    const float c = 0.7978845608028654f, k = 0.044715f;
    const float t = tanhf(c * (x + k * x * x * x));
    return 0.5f * (1.f + t) +
           0.5f * x * ((1.f - t * t) * c * (1.f + 3.f * k * x * x));
  }
  return 0.5f * (1.f + erff(x * 0.7071067811865476f)) +
         x * (0.3989422804014327f * expf(-0.5f * x * x));
}

// a 64 x 64 block of T at src (rows ld elements apart) into an f32 ring
// slot at byte offset `off`, rows padded to 68 floats: f32 by 16-byte
// cp.async (the caller commits), bf16 by 16-byte loads converted at once
template <typename T>
__device__ __forceinline__ void g_load_slice(unsigned char* smem, uint32_t off,
                                             const T* src, size_t ld) {
  if constexpr (is_f32<T>) {
    const uint32_t dst = sm90::smem_u32(smem) + off;
#pragma unroll
    for (int k = 0; k < kFSlice * 16 / kGThreads; ++k) {  // 4 per thread
      const int i = threadIdx.x + k * kGThreads, r = i >> 4, c = i & 15;
      sm90::cp_async16(dst + 4 * (r * kGLds + 4 * c), src + r * ld + 4 * c,
                       16);
    }
  } else {
#pragma unroll
    for (int k = 0; k < kFSlice * 8 / kGThreads; ++k) {  // 2 per thread
      const int i = threadIdx.x + k * kGThreads, r = i >> 3, c = i & 7;
      cvt8(reinterpret_cast<float*>(smem + off) + r * kGLds + 8 * c,
             __ldg(reinterpret_cast<const uint4*>(src + r * ld + 8 * c)));
    }
  }
}

// slice t of the backward's weight stream into ring slot t % 3: stage 1's
// four a 64-wide hidden chunk from t = 0 (chunk j = t / 4, hidden units
// h0 = 64 j ..: W1's rows h0 .. over inputs 64 p .., p = t % 4), then stage
// 2's six from t = 4 nc (parts 0, 1 W2's rows 64 p .. over hidden units
// h0 .., parts 2-5 W1's rows h0 .. over inputs 64 (p - 2) ..). A W1 slice
// is read K-contiguous in stage 1 (rows of the product's B) and row by row
// in stage 2 (the product's K dimension).
template <typename T>
__device__ __forceinline__ void g_slice(unsigned char* smem, uint32_t ring,
                                        const T* w1, const T* w2, int t,
                                        int nc, int H) {
  const bool st2 = t >= 4 * nc;
  const int u = st2 ? t - 4 * nc : t;
  const int per = st2 ? kFParts : 4;
  const int h0 = (u / per) * kFHc, part = u % per;
  const bool is_w1 = !st2 || part >= 2;
  const int q = st2 && is_w1 ? part - 2 : part;
  const T* src = is_w1 ? w1 + (size_t)h0 * (2 * kC) + kFSlice * q
                       : w2 + (size_t)(kFSlice * q) * H + h0;
  g_load_slice<T>(smem, ring + (t % kFStages) * kGSlotBytes, src,
                  is_w1 ? (size_t)(2 * kC) : (size_t)H);
}

// acc[r][c] += sum_{k < 64} A[4 r LDA + k] B[8 c kGLds + k]: the lane's
// 4 x 8 tile, both operands K-contiguous (the forward's summation order)
template <int LDA>
__device__ __forceinline__ void g_nt(float (&acc)[kGR][8], const float* A,
                                     const float* B) {
#pragma unroll 4
  for (int k = 0; k < kFSlice; k += 4) {
    float4 av[kGR], bv[8];
#pragma unroll
    for (int r = 0; r < kGR; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + 4 * r * LDA + k);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      bv[c] = *reinterpret_cast<const float4*>(B + 8 * c * kGLds + k);
#pragma unroll
    for (int r = 0; r < kGR; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[r][c] = fmaf(av[r].x, bv[c].x, acc[r][c]);
        acc[r][c] = fmaf(av[r].y, bv[c].y, acc[r][c]);
        acc[r][c] = fmaf(av[r].z, bv[c].z, acc[r][c]);
        acc[r][c] = fmaf(av[r].w, bv[c].w, acc[r][c]);
      }
  }
}

// acc[r][4 c2 + e] += sum_{k < 64} A[4 r LDA + k] B[k kGLds + 32 c2 + e]:
// the lane's 4 x 8 tile with B row by row (B at the lane's column 4 cg)
template <int LDA>
__device__ __forceinline__ void g_nn(float (&acc)[kGR][8], const float* A,
                                     const float* B) {
#pragma unroll 1
  for (int k = 0; k < kFSlice; k += 4) {
    float4 av[kGR];
#pragma unroll
    for (int r = 0; r < kGR; ++r)
      av[r] = *reinterpret_cast<const float4*>(A + 4 * r * LDA + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* brow = B + (k + kk) * kGLds;
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const float4 bv = *reinterpret_cast<const float4*>(brow + 32 * c2);
#pragma unroll
        for (int r = 0; r < kGR; ++r) {
          const float p = kk == 0 ? av[r].x : kk == 1 ? av[r].y
                        : kk == 2 ? av[r].z : av[r].w;
          acc[r][4 * c2 + 0] = fmaf(p, bv.x, acc[r][4 * c2 + 0]);
          acc[r][4 * c2 + 1] = fmaf(p, bv.y, acc[r][4 * c2 + 1]);
          acc[r][4 * c2 + 2] = fmaf(p, bv.z, acc[r][4 * c2 + 2]);
          acc[r][4 * c2 + 3] = fmaf(p, bv.w, acc[r][4 * c2 + 3]);
        }
      }
    }
  }
}

// The backward of mlp_fused_*_kernel, per block of 128 rows (grid
// ceil(rows / 128), 256 threads; lane 8 rg + cg of warp w owns rows
// 16 w + rg + 4 r, r < 4, of the block, as in mlp_fused_f32_kernel). src,
// msg, dout, dsrc, dmsg: (rows, 128); w1: (H, 256); w2: (128, H); gamma:
// (128,), all of T.
// o_in: (rows, 128) f32, the LayerNorm's input that the forward saved.
// Written: a_da (rows, H) f32, a in stage 1 and da = dh gelu'(a) over it in
// stage 2; hid (rows, H) f32, h = gelu(a) rounded to T; dob (rows, 128)
// f32, dO' (the LayerNorm's input gradient); part (blocks, 256) f32, the
// block's column sums of dout * ohat (dgamma) and of dout (dbeta), each in
// a fixed order. Stage 1 is the forward's f32 arithmetic for a (4 slices a
// chunk) and the gelu; then the LayerNorm statistics of o (the forward's
// order) and its backward in registers; stage 2 walks H again:
// dh = dO' W2[:, h0 ..] from dO' staged over the [src | msg] rows, da from
// a's chunk (staged by cp.async one chunk ahead), and dx += da W1[h0 ..],
// the lane's 4 x 32 of [dsrc | dmsg] in registers across H.
template <typename T, bool TANH>
__global__ void __launch_bounds__(kGThreads, 1)
    mlp_fused_bwd_kernel(const T* __restrict__ src, const T* __restrict__ msg,
                         const T* __restrict__ w1, const T* __restrict__ w2,
                         const T* __restrict__ gamma,
                         const T* __restrict__ dout,
                         const float* __restrict__ o_in, T* __restrict__ dsrc,
                         T* __restrict__ dmsg, float* __restrict__ a_da,
                         float* __restrict__ hid, float* __restrict__ dob,
                         float* __restrict__ part, int rows, int H) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t ring = kGXBytes + kGHBytes;
  const float* Xs = reinterpret_cast<const float*>(smem);
  float* DOs = reinterpret_cast<float*>(smem);
  float* As = reinterpret_cast<float*>(smem + kGAOff);
  float* Hs = reinterpret_cast<float*>(smem + kGXBytes);
  const float* Ring = reinterpret_cast<const float*>(smem + ring);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int ra = 16 * warp + rg;  // the lane's rows: ra + 4 r of the block
  const int r0 = blockIdx.x * kGRows;
  const int nc = H / kFHc, steps = 10 * nc;

  // [src | msg] rows, rows at or past `rows` zero
  if constexpr (is_f32<T>) {
#pragma unroll 4
    for (int k = 0; k < kGRows * 64 / kGThreads; ++k) {  // 32 per thread
      const int i = tid + k * kGThreads, r = i >> 6, c = i & 63;
      const bool ok = r0 + r < rows;
      const T* base = c < 32 ? src : msg;
      sm90::cp_async16(sm90::smem_u32(smem) + 4 * (r * kGLdx + 4 * c),
                       base + (size_t)(ok ? r0 + r : 0) * kC + 4 * (c & 31),
                       ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int k = 0; k < kGRows * 32 / kGThreads; ++k) {  // 16 per thread
      const int i = tid + k * kGThreads, r = i >> 5, c = i & 31;
      const T* base = c < 16 ? src : msg;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < rows)
        u = __ldg(reinterpret_cast<const uint4*>(
            base + (size_t)(r0 + r) * kC + 8 * (c & 15)));
      cvt8(DOs + r * kGLdx + 8 * c, u);
    }
  }
  g_slice<T>(smem, ring, w1, w2, 0, nc, H);
  sm90::cp_async_commit();
  g_slice<T>(smem, ring, w1, w2, 1, nc, H);
  sm90::cp_async_commit();

  // stage 1: a and h = gelu(a), as the forward computes them, to memory
  float a[kGR][8];  // the lane's hidden units cg + 8 c of the chunk
  for (int t0 = 0; t0 < 4 * nc; t0 += 4) {
    const int h0 = (t0 / 4) * kFHc;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int t = t0 + p;
      sm90::cp_async_wait<1>();
      __syncthreads();  // slice t landed; every warp is done with slice t - 1
      if (t + 2 < steps) g_slice<T>(smem, ring, w1, w2, t + 2, nc, H);
      sm90::cp_async_commit();
      const float* slot = Ring + (t % kFStages) * (kGSlotBytes / 4) +
                          cg * kGLds;
      if (p == 0) {
#pragma unroll
        for (int r = 0; r < kGR; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) a[r][c] = 0.f;
      }
      g_nt<kGLdx>(a, Xs + ra * kGLdx + kFSlice * p, slot);
      if (p == 3) {
#pragma unroll
        for (int r = 0; r < kGR; ++r) {
          const int row = r0 + ra + 4 * r;
          if (row >= rows) continue;
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const float x = a[r][c];
            const size_t gi = (size_t)row * H + h0 + cg + 8 * c;
            a_da[gi] = x;
            hid[gi] = round_to<T>(
                TANH ? (is_f32<T> ? gelu_tanh(x) : gelu_tanh_fast(x))
                     : gelu_erf(x));
          }
        }
      }
    }
  }

  // the LayerNorm statistics of the saved o (the forward's order), then
  // its backward: ohat into o, g = dout gamma, dO' = rs (g - mean(g) -
  // ohat mean(g ohat))
  float o[2][kGR][8];  // o[hh][r][c]: column 64 hh + cg + 8 c of row ra + 4 r
#pragma unroll
  for (int r = 0; r < kGR; ++r) {
    const int row = r0 + ra + 4 * r;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        o[hh][r][c] = row < rows
            ? o_in[(size_t)row * kC + 64 * hh + cg + 8 * c] : 0.f;
  }
  float mean[kGR], rs[kGR];
#pragma unroll
  for (int r = 0; r < kGR; ++r) {
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
    for (int r = 0; r < kGR; ++r)
      mean[r] += __shfl_xor_sync(0xffffffffu, mean[r], w);
#pragma unroll
  for (int r = 0; r < kGR; ++r) {
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
    for (int r = 0; r < kGR; ++r)
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], w);
  float gd[2][kGR][8], gs[kGR], ghs[kGR];
#pragma unroll
  for (int r = 0; r < kGR; ++r) {
    rs[r] = rsqrtf(rs[r] * (1.f / kC) + 1e-5f);
    const int row = r0 + ra + 4 * r;
    gs[r] = ghs[r] = 0.f;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * hh + cg + 8 * c;
        const float dy = row < rows ? to_f(dout[(size_t)row * kC + col]) : 0.f;
        const float oh = (o[hh][r][c] - mean[r]) * rs[r];
        const float g = dy * to_f(gamma[col]);
        o[hh][r][c] = oh;
        gd[hh][r][c] = g;
        gs[r] += g;
        ghs[r] = fmaf(g, oh, ghs[r]);
      }
  }
#pragma unroll
  for (int w = 1; w < 8; w <<= 1)
#pragma unroll
    for (int r = 0; r < kGR; ++r) {
      gs[r] += __shfl_xor_sync(0xffffffffu, gs[r], w);
      ghs[r] += __shfl_xor_sync(0xffffffffu, ghs[r], w);
    }
  // dO' over the staged rows, which every warp has left after this
  // barrier, and to memory
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kGR; ++r) {
    const int row = ra + 4 * r;
    const float mg = gs[r] * (1.f / kC), mgh = ghs[r] * (1.f / kC);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int col = 64 * hh + cg + 8 * c;
        const float d = rs[r] * (gd[hh][r][c] - mg - o[hh][r][c] * mgh);
        DOs[row * kGLdo + col] = d;
        if (r0 + row < rows) dob[(size_t)(r0 + row) * kC + col] = d;
      }
  }
  // a's first chunk, behind the rows of dO' (a was written by this block)
  const uint32_t as_addr = sm90::smem_u32(smem) + kGAOff;
  auto stage_a = [&](int h0) {
#pragma unroll
    for (int k = 0; k < kGRows * 16 / kGThreads; ++k) {  // 8 per thread
      const int i = tid + k * kGThreads, r = i >> 4, c = i & 15;
      const bool ok = r0 + r < rows;
      sm90::cp_async16(as_addr + 4 * (r * kGLds + 4 * c),
                       a_da + (size_t)(ok ? r0 + r : 0) * H + h0 + 4 * c,
                       ok ? 16 : 0);
    }
  };
  stage_a(0);
  sm90::cp_async_commit();
  // the block's column sums of dout * ohat and dout: over the lane's rows,
  // its row groups (shuffles; a warp's 16 rows are its lanes' 4 rows over
  // the 4 row groups), then the 8 warps in order through the hidden tile
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = 64 * hh + cg + 8 * c;
      float v1 = 0.f, v2 = 0.f;
#pragma unroll
      for (int r = 0; r < kGR; ++r) {
        const int row = r0 + ra + 4 * r;
        const float dy = row < rows ? to_f(dout[(size_t)row * kC + col]) : 0.f;
        v1 = fmaf(dy, o[hh][r][c], v1);
        v2 += dy;
      }
      v1 += __shfl_xor_sync(0xffffffffu, v1, 8);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 8);
      v1 += __shfl_xor_sync(0xffffffffu, v1, 16);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 16);
      if (rg == 0) {
        Hs[warp * 2 * kC + col] = v1;
        Hs[warp * 2 * kC + kC + col] = v2;
      }
    }
  __syncthreads();
  if (tid < 2 * kC) {
    float s = 0.f;
#pragma unroll 4
    for (int w = 0; w < kGThreads / 32; ++w) s += Hs[w * 2 * kC + tid];
    part[(size_t)blockIdx.x * 2 * kC + tid] = s;
  }

  // stage 2: dh = dO' W2[:, h0 ..], da = dh gelu'(a), dx += da W1[h0 ..]
  float dx[4][kGR][8];  // [src | msg] columns 64 q + 4 cg + 32 c2 + e
  float dh[kGR][8];     // hidden units 4 cg + 32 c2 + e of the chunk
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < kGR; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) dx[q][r][c] = 0.f;
  for (int t0 = 4 * nc; t0 < steps; t0 += kFParts) {
    const int h0 = ((t0 - 4 * nc) / kFParts) * kFHc;
#pragma unroll
    for (int p = 0; p < kFParts; ++p) {
      const int t = t0 + p;
      sm90::cp_async_wait<1>();
      __syncthreads();  // slice t (and a's chunk) landed; slice t - 1 left
      if (t + 2 < steps) g_slice<T>(smem, ring, w1, w2, t + 2, nc, H);
      // a's next chunk over this one, which every warp read at part 1
      if (p == 2 && h0 + kFHc < H) stage_a(h0 + kFHc);
      sm90::cp_async_commit();
      const float* slot = Ring + (t % kFStages) * (kGSlotBytes / 4) + 4 * cg;
      if (p < 2) {
        if (p == 0) {
#pragma unroll
          for (int r = 0; r < kGR; ++r)
#pragma unroll
            for (int c = 0; c < 8; ++c) dh[r][c] = 0.f;
        }
        g_nn<kGLdo>(dh, DOs + ra * kGLdo + kFSlice * p, slot);
        if (p == 1) {
          // da into the warp's rows of the hidden tile and over a in memory
#pragma unroll
          for (int r = 0; r < kGR; ++r) {
            const int row = ra + 4 * r;
#pragma unroll
            for (int c2 = 0; c2 < 2; ++c2) {
              const int col = 4 * cg + 32 * c2;
              const float4 av =
                  *reinterpret_cast<const float4*>(As + row * kGLds + col);
              const float4 da = make_float4(
                  dh[r][4 * c2 + 0] * gelu_grad<TANH>(av.x),
                  dh[r][4 * c2 + 1] * gelu_grad<TANH>(av.y),
                  dh[r][4 * c2 + 2] * gelu_grad<TANH>(av.z),
                  dh[r][4 * c2 + 3] * gelu_grad<TANH>(av.w));
              *reinterpret_cast<float4*>(Hs + row * kGLds + col) = da;
              if (r0 + row < rows)
                *reinterpret_cast<float4*>(
                    a_da + (size_t)(r0 + row) * H + h0 + col) = da;
            }
          }
        }
      } else {
        g_nn<kGLds>(dx[(p + 2) & 3], Hs + ra * kGLds, slot);
      }
    }
  }

  // dsrc = dx[:, :128] + dout (the residual), dmsg = dx[:, 128:]
#pragma unroll
  for (int r = 0; r < kGR; ++r) {
    const int row = r0 + ra + 4 * r;
    if (row >= rows) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int c2 = 0; c2 < 2; ++c2) {
        const int col = 64 * (q & 1) + 4 * cg + 32 * c2;
        float v[4] = {dx[q][r][4 * c2], dx[q][r][4 * c2 + 1],
                      dx[q][r][4 * c2 + 2], dx[q][r][4 * c2 + 3]};
        if (q < 2) {
          float d4[4];
          load4(dout + (size_t)row * kC + col, d4);
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] += d4[e];
        }
        store4((q < 2 ? dsrc : dmsg) + (size_t)row * kC + col, v[0], v[1],
               v[2], v[3]);
      }
  }
}

// dgamma, dbeta: output i (< 256: dgamma then dbeta) of the blocks' column
// sums, each thread of the block over blocks t, t + 128, .. in order, then
// a fixed tree. Grid 256, 128 threads.
__global__ void __launch_bounds__(128)
    mlp_bwd_reduce_kernel(const float* __restrict__ part, int blocks,
                          float* __restrict__ dgb) {
  __shared__ float red[128];
  const int i = blockIdx.x, t = threadIdx.x;
  float s = 0.f;
  for (int k = t; k < blocks; k += 128) s += part[(size_t)k * 2 * kC + i];
  red[t] = s;
  __syncthreads();
#pragma unroll
  for (int w = 64; w > 0; w >>= 1) {
    if (t < w) red[t] += red[t + w];
    __syncthreads();
  }
  if (t == 0) dgb[i] = red[0];
}

template <typename T, bool TANH>
int launch_mlp_bwd(const void* src, const void* msg, const void* w1,
                   const void* w2, const void* gamma, const void* dout,
                   const void* o_in, void* dsrc, void* dmsg, void* a_da,
                   void* hid, void* dob, void* part, void* dgb, int rows,
                   int H,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      mlp_fused_bwd_kernel<T, TANH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kGSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (rows + kGRows - 1) / kGRows;
  mlp_fused_bwd_kernel<T, TANH><<<blocks, kGThreads, kGSmem, stream>>>(
      static_cast<const T*>(src), static_cast<const T*>(msg),
      static_cast<const T*>(w1), static_cast<const T*>(w2),
      static_cast<const T*>(gamma), static_cast<const T*>(dout),
      static_cast<const float*>(o_in), static_cast<T*>(dsrc),
      static_cast<T*>(dmsg),
      static_cast<float*>(a_da), static_cast<float*>(hid),
      static_cast<float*>(dob), static_cast<float*>(part), rows, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_reduce_kernel<<<2 * kC, 128, 0, stream>>>(
      static_cast<const float*>(part), blocks, static_cast<float*>(dgb));
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16; approximate: 1 = tanh gelu, 0 = erf.
// w1: (H, 2C), w2: (C, H), nn.Linear's layouts; every pointer 16-byte
// aligned. o_out: (rows, C) f32 or null; when given, the LayerNorm's input
// o = h W2^T is written there for the backward; nothing else changes.
// Returns a cudaError_t value (0 = ok). C must be 128 and H a multiple of
// 64.
extern "C" int keep_mlp_fused(const void* src, const void* msg, const void* w1,
                              const void* w2, const void* gamma,
                              const void* beta, void* out, void* o_out,
                              int rows, int C, int H, int approximate,
                              int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(o_out);
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return approximate ? launch_mlp_bf16<true>(src, msg, w1, w2, gamma, beta,
                                               out, o, rows, H, st)
                       : launch_mlp_bf16<false>(src, msg, w1, w2, gamma,
                                                beta, out, o, rows, H, st);
  if (dtype == 0)
    return approximate ? launch_mlp_f32<true>(src, msg, w1, w2, gamma, beta,
                                              out, o, rows, H, st)
                       : launch_mlp_f32<false>(src, msg, w1, w2, gamma, beta,
                                               out, o, rows, H, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of keep_mlp_fused (arguments as there; beta has no part in
// it). dout, dsrc, dmsg: (rows, C) of dtype; o_in: (rows, C) f32, the
// forward's o_out. Scratch and outputs in f32:
// a_da and hid (rows, H), dob (rows, C), part (ceil(rows / 128), 2C); dgb
// (2, C) receives dgamma and dbeta. The weight gradients are products over
// every row of a_da (da), hid and dob, left to the caller. Two kernels on
// the stream; returns a cudaError_t value (0 = ok).
extern "C" int keep_mlp_fused_bwd(const void* src, const void* msg,
                                  const void* w1, const void* w2,
                                  const void* gamma, const void* dout,
                                  const void* o_in, void* dsrc, void* dmsg,
                                  void* a_da, void* hid, void* dob,
                                  void* part, void* dgb, int rows, int C,
                                  int H, int approximate, int dtype,
                                  void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0)
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(src, msg, w1, w2, gamma, dout, o_in, dsrc, dmsg, a_da, hid,
                  dob, part, dgb, rows, H, st);
  };
  if (dtype == 0)
    return approximate ? go(launch_mlp_bwd<float, true>)
                       : go(launch_mlp_bwd<float, false>);
  if (dtype == 1)
    return approximate ? go(launch_mlp_bwd<bf16, true>)
                       : go(launch_mlp_bwd<bf16, false>);
  return (int)cudaErrorInvalidValue;
}
