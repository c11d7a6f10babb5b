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
// What the design does about it (bf16): wgmma, whose 64-row warpgroup
// tiles read each weight tile in shared memory once for four warps
// (mma.sync's 16-row warp tiles read every weight chunk once per warp,
// which made shared memory the limit of the earlier design). A block owns
// 128 rows: two consumer warpgroups of 64 rows and a producer warpgroup,
// whose first thread issues every load by TMA and which hands its
// registers to the consumers (setmaxnreg: 24 / 240). The [src | msg] rows
// (128 x 256) land once and are held in registers as wgmma's register A
// operand. The block walks the hidden dimension in chunks of 64: W1's 64
// rows (32 KB) and W2's 64 columns (16 KB) of a chunk land in wgmma's
// 128-byte-swizzle layout, both K-major, through a ring of three stages;
// mbarriers say when a stage has landed and when both consumers have
// released it, so the consumers run free of each other (with one
// __syncthreads a chunk and cp.async from every thread the kernel took
// 1.16x the time). Per chunk a consumer forms its 64 x 64 hidden on wgmma
// m64n64k16 in f32 registers, applies the gelu there and packs it to bf16
// -- a wgmma accumulator's rows packed to bf16 pairs are its register A
// layout, so the packed hidden feeds the second product directly -- and
// accumulates 64 x 128 of output on m64n128k16 in f32 registers. The next
// chunk's hidden product is issued before this chunk's gelu and runs while
// it is computed; the two hidden accumulators swap roles between chunks
// (copying one into the other made ptxas serialize every product). The
// LayerNorm runs on the output registers: a row's 128 outputs sit in one
// quad of lanes, so its mean and variance are quad shuffles; the residual
// comes from the staged src, and the rows leave through shared memory in
// 16-byte stores. Neither the hidden nor the output accumulator passes
// through shared memory. The tanh gelu uses tanh.approx.f32 (relative
// error ~2^-11, under the bf16 rounding of the hidden that follows). Every
// block reads the 768 KB of weights from L2 (~0.9 GB per call at the
// path's shape): more rows a block would need registers the overlap takes
// (the accumulators and the register A take 208 a thread).
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
// Backward: the TPU kernel has none (the JAX package differentiates its
// unfused branch); these compute the gradient of the function above from
// the forward's inputs and o, the LayerNorm's input, which the forward
// writes (rows, C) f32 when the call records a gradient. With a = [src |
// msg] W1^T, h = gelu(a) rounded to src's dtype and dO' the LayerNorm's
// input gradient: dh = dO' W2, da = dh gelu'(a), d[src | msg] = da W1 (+
// dout for src), dW1 = da^T [src | msg], dW2 = dO'^T h. At the GMFlow
// step's 49,152 rows (C = 128, H = 1024) that is 103.1 GFLOP of products:
// at 989 TFLOP/s the bf16 bound is 0.104 ms, and f32 done as 3xTF32 (three
// TF32 products each) 0.625 ms at 495. Nothing (rows, H) wide is needed in
// memory except, in f32, da and h.
//   * mlp_bwd_prep_kernel: the LayerNorm's backward, a warp a row: dO'
//     (rows, C) and per-block column sums of dout ohat and dout; and W2^T
//     (H, C), so that both products with W2 read K-contiguous rows.
//   * mlp_fused_bwd_kernel, 8 warps a block, two kinds of block. Row blocks
//     own rows (bf16 128, f32 64) and stream W1 and W2^T in hidden chunks
//     through two cp.async stages: per chunk they form a = [src | msg]
//     W1^T and dh = dO' W2 for their rows, da on the registers, and d[src
//     | msg] += da W1 from those registers into a 16 x 256 accumulator a
//     warp across H. Weight blocks own a 64-wide hidden chunk over a slice
//     of 2,048 rows, in row tiles double-buffered by cp.async, and sum
//     dW1[chunk] and dW2[:, chunk] over the slice in registers. Per tile
//     the bf16 blocks recompute a and dh for the chunk from the staged
//     tiles and the chunk's weights (h and da for every row would be a
//     (rows, H) f32 tensor's bytes) and store da and h as tiles; the f32
//     ones read da and h, which the f32 row blocks wrote, in a second
//     launch (recomputing them took 1.4x the time on the H100: PERF.md).
//     bf16 runs both kinds in one grid, weight blocks first, so that they
//     fill the card's waves together.
//   * mlp_bwd_reduce_kernel: dgamma, dbeta and the slices' weight partials
//     summed in a fixed order. No atomics anywhere: two calls are bitwise
//     equal.
// bf16 on wgmma: every product a warpgroup issues (64-row tiles) reads its
// shared-memory operands once for the 4 warps, where mma.sync's 16-row
// warp tiles read each B operand by ldmatrix for every warp and made
// shared memory the limit. Each tile is stored once, in wgmma's
// 128-byte-swizzle layout (am_at), and is a K-major operand of one product
// and an MN-major one of the other: W1's rows are B of a and of d[src |
// msg], [src | msg] and dO' are A of a and dh and B and A of dW1 and dW2.
// d[src | msg] takes da as its A operand from registers (wgmma's register
// A layout is mma.sync's, and so is its accumulator layout). f32 on
// mma.sync by 3xTF32 (TF32 wgmma would need every operand K-major and
// split in shared memory): ldmatrix reads the K-contiguous tiles, scalar
// reads with the k slots relabelled the others (mm_nt, mm_nn, mm_tn).
// Precision. bf16: [src | msg], W1, W2 and h are bf16 values, so a and the
// products with h are exact bf16 products with f32 sums; dO' enters dh
// and dW2 as bf16 hi + lo (two products), da enters d[src | msg] and dW1
// rounded once. In a model of the rounding at a single row
// (tests/test_torch_kernel_backward.py) this scheme stood within 2.0x the
// plain backward's distance to float64 and dO' rounded once too up to 3.2x
// (the gate is 3x); hi + lo for da as well took 1.1x the time on the H100.
// f32: 3xTF32 on m16n8k8, every operand split into a TF32 hi and lo as it
// is loaded; the tensor core's adds truncate, so the hi x hi products run
// in short chains added in f32 (kAChain, kDhChain; the weight products'
// per row tile).
// What bounds it on the H100: bf16, the wgmmas run one group at a time,
// each waited for before the next (the da registers, the tiles' reuse),
// and the weight blocks' recompute adds 38.7 GFLOP; f32, issue: the
// splits, the chains' f32 adds and the scalar reads come to about five
// instructions an mma, and the 16 x 256 accumulator fills the registers
// (255, with 240-244 bytes spilled).
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

using sm90::am_at;
using sm90::desc_k;
using sm90::desc_mn;

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
// bf16: warpgroups on wgmma, [src | msg] and the hidden in registers,
// tiles by TMA
// ---------------------------------------------------------------------------

constexpr int kMRows = 128;                   // rows per block: 2 x 64
constexpr int kMThreads = 384;   // 2 consumer warpgroups and a producer
constexpr int kMHc = 64;                      // hidden units per chunk
constexpr int kMStages = 3;
constexpr int kABytes = kMRows * 2 * kC * 2;  // [src | msg]: 64 KB
constexpr int kW1Bytes = kMHc * 2 * kC * 2;   // W1's chunk rows: 32 KB
constexpr int kStageBytes = kW1Bytes + kC * kMHc * 2;  // + W2's: 48 KB
// byte offsets: the mbarriers, [src | msg], the stages (W1's rows, then
// W2's columns of a chunk), every tile an am_at tile on a 1024-byte
// boundary; the launch's bytes + 1024 for rounding the base up
constexpr uint32_t kMX = 1024;
constexpr uint32_t kMW = kMX + kABytes;
constexpr int kMSmem = kMW + kMStages * kStageBytes + 1024;  // 210 KB
// mbarriers: [src | msg] landed; stage s landed; stage s released by both
// consumer warpgroups (every consumer thread arrives)
constexpr int kBarX = 0, kBarWFull = 1, kBarWEmpty = 1 + kMStages;

// d = [src | msg] W1[h0:h0+64]^T on wgmma, issued and committed: xa the
// warp's rows as register A, W1's 64 rows at w1t K-major
__device__ __forceinline__ void mlp_hidden(float (&d)[32],
                                           const uint32_t (&xa)[16][4],
                                           uint32_t w1t) {
  sm90::wg_fence();
#pragma unroll
  for (int ks = 0; ks < 16; ++ks)
    sm90::WgRS<64, 0>::mma(d, xa[ks], desc_k(w1t, kMHc, 0, ks), ks > 0);
  sm90::wg_commit();
}

// Chunk j of a consumer warpgroup: its hidden a landed (and o through chunk
// j - 1, so stage (j - 1) % 3 is released); chunk j + 1's hidden product
// into an runs while the gelu of a packs it to bf16 as the register A of
// o += h W2[:, h0:h0+64]^T. Only wgmma defines a, an and o (the caller
// swaps a and an between chunks: a copy made ptxas serialize the products)
template <bool TANH>
__device__ __forceinline__ void mlp_chunk(int j, int n_chunks, float (&a)[32],
                                          float (&an)[32], float (&o)[64],
                                          const uint32_t (&xa)[16][4],
                                          uint32_t s0) {
  sm90::wg_wait<0>();
  sm90::fence_regs(a);
  if (j > 0) sm90::mbar_arrive(s0 + 8 * (kBarWEmpty + (j - 1) % kMStages));
  if (j + 1 < n_chunks) {
    const int st = (j + 1) % kMStages;
    sm90::mbar_wait(s0 + 8 * (kBarWFull + st), ((j + 1) / kMStages) & 1);
    mlp_hidden(an, xa, s0 + kMW + st * kStageBytes);
  }

  uint32_t ha[4][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      v[e] = TANH ? gelu_tanh_fast(a[4 * n + e]) : gelu_erf(a[4 * n + e]);
    ha[n >> 1][(n & 1) * 2] = sm90::pack_bf16(v[0], v[1]);
    ha[n >> 1][(n & 1) * 2 + 1] = sm90::pack_bf16(v[2], v[3]);
  }
  const uint32_t w2t = s0 + kMW + (j % kMStages) * kStageBytes + kW1Bytes;
  sm90::wg_fence();
#pragma unroll
  for (int ks = 0; ks < kMHc / 16; ++ks)
    sm90::WgRS<128, 0>::mma(o, ha[ks], desc_k(w2t, kC, 0, ks),
                            j > 0 || ks > 0);
  sm90::wg_commit();
}

// src, msg, out: (rows, 128), w1: (H, 256), w2: (128, H), gamma, beta:
// (128,), all bf16; src, msg, w1 and w2 are read through the tensor maps
// tsrc, tmsg, tw1, tw2. H % 64 == 0. Grid ceil(rows / 128), 384 threads:
// warpgroup wg < 2 owns rows 64 wg .. of the block, its warp w the 16 rows
// from 64 wg + 16 w; warpgroup 2 is the producer (24 registers a thread,
// the consumers 240), whose first thread issues every TMA load ([src |
// msg], then chunk j's W1 rows and W2 columns into stage j % 3 once both
// warpgroups have released it). Each lane holds, per 8-column group n of a
// wgmma accumulator, the elements (g, 8n + 2t), (g, 8n + 2t + 1), (g + 8,
// 8n + 2t), (g + 8, 8n + 2t + 1) of its warp's rows, g = lane / 4, t = lane
// % 4 (mma.sync's layout, which is also wgmma's register A layout).
template <bool TANH>
__global__ void __launch_bounds__(kMThreads, 1)
    mlp_fused_bf16_kernel(const __grid_constant__ CUtensorMap tsrc,
                          const __grid_constant__ CUtensorMap tmsg,
                          const __grid_constant__ CUtensorMap tw1,
                          const __grid_constant__ CUtensorMap tw2,
                          const bf16* __restrict__ gamma,
                          const bf16* __restrict__ beta,
                          bf16* __restrict__ out,
                          float* __restrict__ o_out, int rows, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = sm90::smem_u32(smem);
  const uint32_t sa = s0 + kMX;
  unsigned char* sx = smem + kMX;
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = blockIdx.x * kMRows;
  const int n_chunks = H / kMHc;

  if (tid == 0) {
    sm90::mbar_init(s0 + 8 * kBarX, 1);
    for (int st = 0; st < kMStages; ++st) {
      sm90::mbar_init(s0 + 8 * (kBarWFull + st), 1);
      sm90::mbar_init(s0 + 8 * (kBarWEmpty + st), 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: its registers go to the consumers
    sm90::setmaxnreg_dec<24>();
    if (tid == 256) {
      const uint32_t bx = s0 + 8 * kBarX;
      sm90::mbar_expect_tx(bx, kABytes);
#pragma unroll
      for (int cb = 0; cb < 2; ++cb) {
        sm90::tma_load_3d(sa + cb * kMRows * 128, &tsrc, 64 * cb, r0, 0, bx);
        sm90::tma_load_3d(sa + (2 + cb) * kMRows * 128, &tmsg, 64 * cb, r0, 0,
                          bx);
      }
      for (int j = 0; j < n_chunks; ++j) {
        const int st = j % kMStages;
        const uint32_t full = s0 + 8 * (kBarWFull + st);
        const uint32_t w = s0 + kMW + st * kStageBytes;
        if (j >= kMStages)
          sm90::mbar_wait(s0 + 8 * (kBarWEmpty + st),
                          (j / kMStages - 1) & 1);
        sm90::mbar_expect_tx(full, kStageBytes);
#pragma unroll
        for (int cb = 0; cb < 4; ++cb)
          sm90::tma_load_3d(w + cb * kMHc * 128, &tw1, 64 * cb, j * kMHc, 0,
                            full);
        sm90::tma_load_3d(w + kW1Bytes, &tw2, j * kMHc, 0, 0, full);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int g = lane >> 2, t = lane & 3;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int rw = 16 * (tid >> 5);           // the warp's first row
  sm90::mbar_wait(s0 + 8 * kBarX, 0);
  uint32_t xa[16][4];  // the warp's 16 x 256 [src | msg]: register A
#pragma unroll
  for (int s = 0; s < 16; ++s)
    sm90::ldsm_x4(sa + am_at(rw + (mi & 1) * 8 + mr, 2 * s + (mi >> 1),
                             kMRows),
                  xa[s]);
  float o[64];          // the warpgroup's 64 x 128 output, f32
  float a[32], an[32];  // hidden chunks j and j + 1: 64 x 64, f32
  sm90::mbar_wait(s0 + 8 * kBarWFull, 0);
  mlp_hidden(a, xa, s0 + kMW);
  for (int j = 0; j < n_chunks; j += 2) {  // a and an swap roles
    mlp_chunk<TANH>(j, n_chunks, a, an, o, xa, s0);
    if (j + 1 < n_chunks)
      mlp_chunk<TANH>(j + 1, n_chunks, an, a, o, xa, s0);
  }
  sm90::wg_wait<0>();
  sm90::fence_regs(o);

  // LayerNorm over each row's 128 outputs, held by one quad: rows g and g+8
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    sum0 += o[4 * n] + o[4 * n + 1];
    sum1 += o[4 * n + 2] + o[4 * n + 3];
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
  }
  const float mean0 = sum0 * (1.f / kC), mean1 = sum1 * (1.f / kC);
  float q0 = 0.f, q1 = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const float d0 = o[4 * n] - mean0, d1 = o[4 * n + 1] - mean0;
    const float d2 = o[4 * n + 2] - mean1, d3 = o[4 * n + 3] - mean1;
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
      const int row = r0 + rw + g + 8 * hh;
      if (row < rows) {
#pragma unroll
        for (int n = 0; n < 16; ++n)
          *reinterpret_cast<float2*>(o_out + (size_t)row * kC + 8 * n + 2 * t) =
              make_float2(o[4 * n + 2 * hh], o[4 * n + 2 * hh + 1]);
      }
    }
  }

  // + src (the staged tile's chunks 0..15), rounded to bf16 into the same
  // place: only this warp reads or writes its rows, each lane its own words
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
          sx + am_at(rw + g + 8 * hh, n, kMRows) + 4 * t);
      const float2 x = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p));
      const float y0 = (o[4 * n + 2 * hh] - mean) * rs * gm.x + bt.x;
      const float y1 = (o[4 * n + 2 * hh + 1] - mean) * rs * gm.y + bt.y;
      *p = sm90::pack_bf16(x.x + y0, x.y + y1);
    }
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = lane + 32 * k;
    const int r = rw + (i >> 4), c = i & 15;
    if (r0 + r < rows)
      *reinterpret_cast<uint4*>(out + (size_t)(r0 + r) * kC + 8 * c) =
          *reinterpret_cast<const uint4*>(sx + am_at(r, c, kMRows));
  }
}

template <bool TANH>
int launch_mlp_bf16(const void* src, const void* msg, const void* w1,
                    const void* w2, const void* gamma, const void* beta,
                    void* out, float* o_out, int rows, int H,
                    cudaStream_t stream) {
  CUtensorMap tsrc, tmsg, tw1, tw2;
  int err = sm90::tma_map_bf16(&tsrc, src, kC, rows, 1, kMRows);
  if (err == 0) err = sm90::tma_map_bf16(&tmsg, msg, kC, rows, 1, kMRows);
  if (err == 0) err = sm90::tma_map_bf16(&tw1, w1, 2 * kC, H, 1, kMHc);
  if (err == 0) err = sm90::tma_map_bf16(&tw2, w2, H, kC, 1, kC);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(mlp_fused_bf16_kernel<TANH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMSmem);
  if (err != 0) return err;
  const int blocks = (rows + kMRows - 1) / kMRows;
  mlp_fused_bf16_kernel<TANH><<<blocks, kMThreads, kMSmem, stream>>>(
      tsrc, tmsg, tw1, tw2, static_cast<const bf16*>(gamma),
      static_cast<const bf16*>(beta), static_cast<bf16*>(out), o_out, rows,
      H);
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
// Backward (both dtypes): tensor cores, bf16 on wgmma and f32 as 3xTF32
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;
constexpr int kLnRows = 128;   // rows a block of the LayerNorm backward
constexpr int kWHc = 64;       // hidden units a weight block owns
constexpr int kSlice = 2048;   // rows a weight block sums over
// 3xTF32 hi x hi chain lengths (k steps of 8) of a = [src | msg] W1^T and
// dh = dO' W2 before each is added to its f32 sum (the tensor core's adds
// truncate; attention_bwd.cu's S and dP chains)
constexpr int kAChain = 2, kDhChain = 4;

// A form's tiling. Row blocks own `rows` rows (8 warps: row groups of 16,
// `ks` warps splitting each chunk's hidden units; bf16: two warpgroups of
// 64 rows) and stream W1 and W2^T in chunks of `hc` hidden units through
// two stages, `hstep` units at a time. Weight blocks walk their rows in
// tiles of `wt`.
template <typename T> struct BwdCfg;
template <> struct BwdCfg<bf16> {
  static constexpr int rows = 128, hc = 64, ks = 1, hstep = 32, wt = 64;
};
template <> struct BwdCfg<float> {
  static constexpr int rows = 64, hc = 32, ks = 2, hstep = 16, wt = 32;
};

// byte offsets in a backward block's shared memory. f32 tiles are rows of
// 16-byte chunks at c ^ (r & 7) (sm90::swz); bf16 tiles are in wgmma's
// 128-byte-swizzle layout (am_at): 64-column blocks of the tile's rows x
// 128 B, so that one tile is a K-major operand of one product and an
// MN-major one of the other (W1's rows: B of a = X W1^T and of d[src |
// msg] = da W1; [src | msg] and dO': A of a and dh, B and A of dW1 and
// dW2)
template <typename T>
struct BwdSmem {
  using Cf = BwdCfg<T>;
  // bf16: dO' enters dh and dW2 as bf16 hi + lo (lo the rounded
  // remainder), two products each, and da enters d[src | msg] and dW1
  // rounded once; f32: both as they are (3xTF32)
  static constexpr int nd = is_f32<T> ? 1 : 2;
  static constexpr int rbx = 2 * kC * (int)sizeof(T);  // [src | msg], W1 row
  static constexpr int rbd = kC * (int)sizeof(T);      // dO', W2^T row
  static constexpr int rbh = kWHc * (int)sizeof(T);    // da, h tile row
  // row blocks: [src | msg], dO' (bf16: hi, lo), two stages of W1 and
  // W2^T rows
  static constexpr uint32_t r_d = Cf::rows * rbx;
  static constexpr uint32_t r_dlo = r_d + Cf::rows * rbd;
  static constexpr uint32_t r_ring = r_d + nd * Cf::rows * rbd;
  static constexpr uint32_t r_w2 = Cf::hc * rbx;  // W2^T's rows in a stage
  static constexpr uint32_t r_stage = Cf::hc * (rbx + rbd);
  static constexpr uint32_t r_bytes = r_ring + 2 * r_stage;
  // weight blocks: bf16, the chunk's W1 and W2^T rows, two buffers of a row
  // tile's [src | msg] and dO' (hi, lo), then the tile's da and h, which
  // the block recomputes; f32, two buffers of a row tile's [src | msg],
  // dO', da and h, the last two from the row blocks
  static constexpr uint32_t w_w2 = kWHc * rbx;
  static constexpr uint32_t w_buf = is_f32<T> ? 0 : w_w2 + kWHc * rbd;
  static constexpr uint32_t b_d = Cf::wt * rbx;
  static constexpr uint32_t b_dlo = b_d + Cf::wt * rbd;
  static constexpr uint32_t b_da = b_d + nd * Cf::wt * rbd;  // f32
  static constexpr uint32_t b_h = b_da + Cf::wt * rbh;        // f32
  static constexpr uint32_t buf = is_f32<T> ? b_h + Cf::wt * rbh : b_da;
  static constexpr uint32_t w_da = w_buf + 2 * buf;  // bf16
  static constexpr uint32_t w_h = w_da + Cf::wt * rbh;
  static constexpr uint32_t w_bytes =
      is_f32<T> ? w_buf + 2 * buf : w_h + Cf::wt * rbh;
  static constexpr uint32_t bytes = r_bytes > w_bytes ? r_bytes : w_bytes;
  // the launch's: the base is rounded up to 1024 B (wgmma's swizzle atoms)
  static constexpr uint32_t launch_bytes = bytes + 1024;
  // the f32 row block's second hidden half of d[src | msg], padded rows
  static constexpr int red_ld = 2 * kC + 8;
  static_assert(!is_f32<T> || 4 * Cf::rows * red_ld <= r_ring, "fits");
  static_assert(launch_bytes <= 232448, "227 KB a block");
  static_assert(r_ring % 1024 == 0 && r_stage % 1024 == 0 &&
                    w_buf % 1024 == 0 && buf % 1024 == 0 && b_d % 1024 == 0,
                "tiles on 1024-byte swizzle atoms");
};

template <typename T>
struct BwdArgs {
  const T* src; const T* msg; const T* w1;
  const T* w2t;    // W2^T (H, C), the LayerNorm kernel's
  const T* dout;
  const T* dop;    // dO' (rows, C) in T; bf16: hi, then lo at + rows C
  T* dsrc; T* dmsg;
  float* da; float* hid;  // f32: (rows, H) each, the row blocks' da and h
  float* ws;       // the weight blocks' partials: slice s at s 3 C H:
                   // dW1 (H, 2C) then dW2 (C, H)
  int rows, H, nwb;  // nwb: weight blocks, first in the grid
};

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

// h = gelu(x) as the forward computes it for T, rounded to T
template <typename T, bool TANH>
__device__ __forceinline__ float gelu_fwd(float x) {
  return round_to<T>(TANH ? (is_f32<T> ? gelu_tanh(x) : gelu_tanh_fast(x))
                          : gelu_erf(x));
}

// byte offset of element (r, col) of a swizzled tile of T, RB bytes a row
template <typename T>
__device__ __forceinline__ uint32_t tile_at(int r, int col, int RB) {
  const int b = col * (int)sizeof(T);
  return sm90::swz(r, b >> 4, RB) + (b & 15);
}

// rows [r0, r0 + R) of a matrix of T (ld elements a row), columns [c0, c0 +
// W), into a tile of W a row at shared address dst by 16-byte cp.async (the
// caller commits), swizzled for f32 and in am_at's layout for bf16; rows
// at or past lim are zero-filled
template <typename T, int R, int W>
__device__ __forceinline__ void g_tile(uint32_t dst, const T* src, size_t ld,
                                       int c0, int r0, int lim) {
  constexpr int RB = W * (int)sizeof(T), CH = RB / 16, E = 16 / sizeof(T);
  static_assert(R * CH % kGThreads == 0, "whole rounds of the block");
#pragma unroll
  for (int i0 = 0; i0 < R * CH; i0 += kGThreads) {
    const int i = i0 + threadIdx.x, r = i / CH, c = i % CH;
    const bool ok = r0 + r < lim;
    sm90::cp_async16(dst + (is_f32<T> ? sm90::swz(r, c, RB) : am_at(r, c, R)),
                     src + (size_t)(ok ? r0 + r : 0) * ld + c0 + c * E,
                     ok ? 16 : 0);
  }
}

// [src | msg] rows [r0, r0 + R) as g_tile's: the left half's chunks from
// src, the right half's from msg
template <typename T, int R>
__device__ __forceinline__ void g_xtile(uint32_t dst, const T* src,
                                        const T* msg, int r0, int lim) {
  constexpr int RB = 2 * kC * (int)sizeof(T), CH = RB / 16, E = 16 / sizeof(T);
  static_assert(R * CH % kGThreads == 0, "whole rounds of the block");
#pragma unroll
  for (int i0 = 0; i0 < R * CH; i0 += kGThreads) {
    const int i = i0 + threadIdx.x, r = i / CH, c = i % CH;
    const bool ok = r0 + r < lim;
    const T* base = c < CH / 2 ? src : msg;
    sm90::cp_async16(dst + (is_f32<T> ? sm90::swz(r, c, RB) : am_at(r, c, R)),
                     base + (size_t)(ok ? r0 + r : 0) * kC + (c % (CH / 2)) * E,
                     ok ? 16 : 0);
  }
}

// f32: acc (the warp's 16 x 8 NT accumulator fragments) += A B^T, A rows a0
// .. a0 + 15 of the swizzled tile at sa, B rows b0 .. b0 + 8 NT - 1 of the
// tile at sb, both K floats a row, k ascending: 3xTF32 on m16n8k8, each
// operand split as loaded (ldmatrix reads an f32 tile as the TF32
// fragments); the hi x hi products in chains of G k steps from zero, each
// then added to acc in f32, the two small terms in one chain over all of
// K, added at the end
template <int NT, int K, int G>
__device__ __forceinline__ void mm_nt(float (&acc)[NT][4], uint32_t sa,
                                      int a0, uint32_t sb, int b0) {
  constexpr int RB = K * 4;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  float part[NT][4], small[NT][4];
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) {  // two 16-byte chunks a k step
    uint32_t a[4];
    sm90::ldsm_x4(sa + sm90::swz(a0 + (mi & 1) * 8 + mr, 2 * ks + (mi >> 1),
                                 RB), a);
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int e = 0; e < 4; ++e) sm90::split_tf32(a[e], ah[e], al[e]);
#pragma unroll
    for (int p = 0; p < NT / 2; ++p) {
      uint32_t b[4];
      sm90::ldsm_x4(sb + sm90::swz(b0 + 16 * p + (mi >> 1) * 8 + mr,
                                   2 * ks + (mi & 1), RB), b);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sm90::split_tf32(b[e], bh[2 * p + e / 2][e % 2],
                         bl[2 * p + e / 2][e % 2]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (ks == 0)
        sm90::mma_tf32_0(small[n], al, bh[n][0], bh[n][1]);
      else
        sm90::mma_tf32(small[n], al, bh[n][0], bh[n][1]);
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
      sm90::mma_tf32(small[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (ks % G == 0)
        sm90::mma_tf32_0(part[n], ah, bh[n][0], bh[n][1]);
      else
        sm90::mma_tf32(part[n], ah, bh[n][0], bh[n][1]);
    }
    if (ks % G == G - 1) {
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += small[n][e];
}

// f32: acc (16 x 2C, the warp's rows of d[src | msg]) += D W, D the warp's
// 16 x 8 NT fragments in accumulator layout (k the hidden unit), W rows w0
// .. w0 + 8 NT - 1 of the stage's W1 tile at byte offset off: 3xTF32; k
// step j relabels its k slots (slot t the hidden unit 8 j + 2 t, slot t +
// 4 the unit 8 j + 2 t + 1), so D[j] = (c0, c1, c2, c3) is the A fragment
// (c0, c2, c1, c3) and W's B fragments are scalar reads, conflict-free in
// the swizzle; four output tiles at a time, chains over all NT k steps
// from zero, added in f32
template <int NT>
__device__ __forceinline__ void mm_nn(float (&acc)[32][4],
                                      const float (&d)[NT][4],
                                      const unsigned char* smem, uint32_t off,
                                      int w0) {
  constexpr int RB = 2 * kC * 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t base[2][4];  // row w0 + 2 t + e, column 8 n + g for n % 4 = m
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      base[e][m] = off + (w0 + 2 * t + e) * RB +
                   ((2 * (m ^ t) + ((g >> 2) ^ e)) << 4) + 4 * (g & 3);
  uint32_t ah[NT][4], al[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    sm90::split_tf32(__float_as_uint(d[j][0]), ah[j][0], al[j][0]);
    sm90::split_tf32(__float_as_uint(d[j][2]), ah[j][1], al[j][1]);
    sm90::split_tf32(__float_as_uint(d[j][1]), ah[j][2], al[j][2]);
    sm90::split_tf32(__float_as_uint(d[j][3]), ah[j][3], al[j][3]);
  }
#pragma unroll
  for (int n0 = 0; n0 < 32; n0 += 4) {
    float part[4][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const uint32_t o = 8 * j * RB + n0 * 32;
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sm90::split_tf32(
              *reinterpret_cast<const uint32_t*>(smem + base[e][m] + o),
              bh[m][e], bl[m][e]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (j == 0)
          sm90::mma_tf32_0(part[m], al[j], bh[m][0], bh[m][1]);
        else
          sm90::mma_tf32(part[m], al[j], bh[m][0], bh[m][1]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        sm90::mma_tf32(part[m], ah[j], bl[m][0], bl[m][1]);
#pragma unroll
      for (int m = 0; m < 4; ++m)
        sm90::mma_tf32(part[m], ah[j], bh[m][0], bh[m][1]);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + m][e] += part[m][e];
  }
}

// f32: acc (16 MT x 8 NT) += A^T B over the K rows of two swizzled tiles,
// A's columns m0 .. m0 + 16 MT - 1 (tile at byte offset oa, RBA bytes a
// row), B's columns n0 .. n0 + 8 NT - 1 (ob, RBB): the weight products,
// summed over rows. 3xTF32, both operands scalar reads with the k slots
// relabelled (slot t row 2 t, slot t + 4 row 2 t + 1 of each k step:
// conflict-free in the swizzle); per output m tile the hi x hi and the
// small chains run over the tile's K rows from zero and are added to acc
// in f32
template <int MT, int NT, int K, int RBA, int RBB>
__device__ __forceinline__ void mm_tn(float (&acc)[MT][NT][4],
                                      const unsigned char* smem, uint32_t oa,
                                      int m0, uint32_t ob, int n0) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  auto ld = [&](uint32_t o, int r, int col, int RB) {
    return *reinterpret_cast<const uint32_t*>(smem + o +
                                              tile_at<float>(r, col, RB));
  };
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float part[NT][4], small[NT][4];
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks) {
      const int r = 8 * ks + 2 * t, m = m0 + 16 * mt + g;
      const uint32_t a[4] = {ld(oa, r, m, RBA), ld(oa, r, m + 8, RBA),
                             ld(oa, r + 1, m, RBA),
                             ld(oa, r + 1, m + 8, RBA)};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) sm90::split_tf32(a[e], ah[e], al[e]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t bh[2], bl[2];
        sm90::split_tf32(ld(ob, r, n0 + 8 * n + g, RBB), bh[0], bl[0]);
        sm90::split_tf32(ld(ob, r + 1, n0 + 8 * n + g, RBB), bh[1], bl[1]);
        if (ks == 0) {
          sm90::mma_tf32_0(small[n], al, bh[0], bh[1]);
          sm90::mma_tf32_0(part[n], ah, bh[0], bh[1]);
        } else {
          sm90::mma_tf32(small[n], al, bh[0], bh[1]);
          sm90::mma_tf32(part[n], ah, bh[0], bh[1]);
        }
        sm90::mma_tf32(small[n], ah, bl[0], bl[1]);
      }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][n][e] += part[n][e] + small[n][e];
  }
}

template <int A, int B, int C>
__device__ __forceinline__ void zero(float (&x)[A][B][C]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j)
#pragma unroll
      for (int k = 0; k < C; ++k) x[i][j][k] = 0.f;
}
template <int A, int B>
__device__ __forceinline__ void zero(float (&x)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) x[i][j] = 0.f;
}

// a = [src | msg] W1^T and dh = dO' W2 (bf16) for a warpgroup's 64 rows of
// the staged tiles (R rows from r0; dO' hi, and lo at + dlo) and 32 hidden
// units from row hs of the W1 and W2^T tiles (HR rows), on wgmma with
// every operand K-major in shared memory; the warp's 16 rows come back in
// mma.sync's accumulator layout
template <int R, int HR>
__device__ __forceinline__ void wg_a_dh(float (&a)[4][4], float (&dh)[4][4],
                                        uint32_t x, uint32_t dop,
                                        uint32_t dlo, int r0, uint32_t w1,
                                        uint32_t w2t, int hs) {
  float(&av)[16] = reinterpret_cast<float(&)[16]>(a);
  float(&dv)[16] = reinterpret_cast<float(&)[16]>(dh);
  sm90::wg_fence();
#pragma unroll
  for (int s = 0; s < 2 * kC / 16; ++s)
    sm90::WgSS<32, 0, 0>::mma(av, desc_k(x, R, r0, s), desc_k(w1, HR, hs, s));
#pragma unroll
  for (int s = 0; s < kC / 16; ++s) {
    const uint64_t b = desc_k(w2t, HR, hs, s);
    sm90::WgSS<32, 0, 0>::mma(dv, desc_k(dlo, R, r0, s), b);
    sm90::WgSS<32, 0, 0>::mma(dv, desc_k(dop, R, r0, s), b);
  }
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(av);
  sm90::fence_regs(dv);
}

// One row block: rows R rb .. of d[src | msg]. Per chunk of HC hidden units
// (W1's rows and W2^T's, streamed through two stages), HS units at a time:
// a = [src | msg] W1^T and dh = dO' W2, da = dh gelu'(a) on the registers,
// then d[src | msg] += da W1 into each warp's 16 x 2C accumulator across
// H. bf16: warpgroup wgi owns rows 64 wgi .. and its products run on
// wgmma, d[src | msg]'s with da as the A operand from registers. f32: warp
// w = rg + 4 kh owns rows 16 rg .., takes the chunk's units kh HC / 2 ..,
// 3xTF32 on mma.sync (mm_nt, mm_nn), writes da and h = gelu(a) (f32) for
// the weight blocks, and its two hidden halves' sums are added (kh 0 + kh
// 1) through shared memory at the end.
template <typename T, bool TANH>
__device__ __forceinline__ void bwd_row_block(unsigned char* smem,
                                              const BwdArgs<T>& p, int rb) {
  using Cf = BwdCfg<T>;
  using S = BwdSmem<T>;
  constexpr int R = Cf::rows, HC = Cf::hc, KS = Cf::ks, HS = Cf::hstep;
  constexpr int NT = HS / 8, RG = 8 / KS;
  const uint32_t s0 = sm90::smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rg = warp % RG, kh = warp / RG, a0 = 16 * rg;
  const int r0 = rb * R, nc = p.H / HC;

  g_xtile<T, R>(s0, p.src, p.msg, r0, p.rows);
  g_tile<T, R, kC>(s0 + S::r_d, p.dop, kC, 0, r0, p.rows);
  if constexpr (!is_f32<T>)
    g_tile<T, R, kC>(s0 + S::r_dlo, p.dop + (size_t)p.rows * kC, kC, 0, r0,
                     p.rows);
  auto load_chunk = [&](int j) {
    const uint32_t w = s0 + S::r_ring + (j & 1) * S::r_stage;
    g_tile<T, HC, 2 * kC>(w, p.w1, 2 * kC, 0, j * HC, p.H);
    g_tile<T, HC, kC>(w + S::r_w2, p.w2t, kC, 0, j * HC, p.H);
  };
  load_chunk(0);
  sm90::cp_async_commit();

  float dx[32][4];
  zero(dx);
  for (int j = 0; j < nc; ++j) {
    sm90::cp_async_wait<0>();
    if constexpr (!is_f32<T>) sm90::fence_async_smem();  // visible to wgmma
    __syncthreads();  // chunk j landed; every warp left chunk j - 1
    if (j + 1 < nc) load_chunk(j + 1);  // into chunk j - 1's stage
    sm90::cp_async_commit();
    const uint32_t w1o = S::r_ring + (j & 1) * S::r_stage;
#pragma unroll 1
    for (int st = 0; st < HC / KS / HS; ++st) {
      const int hs = kh * (HC / KS) + st * HS;
      float a[NT][4], dh[NT][4];
      zero(a);
      zero(dh);
      if constexpr (!is_f32<T>)
        wg_a_dh<R, HC>(a, dh, s0, s0 + S::r_d, s0 + S::r_dlo, 64 * (warp >> 2),
                       s0 + w1o, s0 + w1o + S::r_w2, hs);
      else {
        mm_nt<NT, 2 * kC, kAChain>(a, s0, a0, s0 + w1o, hs);
        mm_nt<NT, kC, kDhChain>(dh, s0 + S::r_d, a0, s0 + w1o + S::r_w2, hs);
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float x0 = a[n][2 * hh], x1 = a[n][2 * hh + 1];
          a[n][2 * hh] = dh[n][2 * hh] * gelu_grad<TANH>(x0);
          a[n][2 * hh + 1] = dh[n][2 * hh + 1] * gelu_grad<TANH>(x1);
          if constexpr (is_f32<T>) {
            const int row = r0 + a0 + g + 8 * hh;
            if (row < p.rows) {
              const size_t o = (size_t)row * p.H + j * HC + hs + 8 * n + 2 * t;
              store2(p.da + o, a[n][2 * hh], a[n][2 * hh + 1]);
              store2(p.hid + o, gelu_fwd<T, TANH>(x0), gelu_fwd<T, TANH>(x1));
            }
          }
        }
      if constexpr (!is_f32<T>) {
        // d[src | msg] += da W1[hs ..]: da as bf16 A fragments (m16n8k16's
        // accumulator layout is its A layout), W1's rows MN-major; waited
        // for at once (the A registers)
        float(&d)[128] = reinterpret_cast<float(&)[128]>(dx);
        uint32_t ah[NT / 2][4];
#pragma unroll
        for (int jj = 0; jj < NT; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ah[jj >> 1][(jj & 1) * 2 + h] =
                sm90::pack_bf16(a[jj][2 * h], a[jj][2 * h + 1]);
        sm90::wg_fence();
#pragma unroll
        for (int ks = 0; ks < NT / 2; ++ks) {
          sm90::WgRS<256, 1>::mma(d, ah[ks],
                                  desc_mn(s0 + w1o, HC, 0, hs / 16 + ks));
        }
        sm90::wg_commit();
        sm90::wg_wait<0>();
        sm90::fence_regs(d);
      } else {
        mm_nn<NT>(dx, a, smem, w1o, hs);
      }
    }
  }

  if constexpr (KS == 2) {  // the second hidden half's sums, then kh 0 + kh 1
    __syncthreads();
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        if (kh == 1)
          store2(red + (a0 + g + 8 * hh) * S::red_ld + 8 * n + 2 * t,
                 dx[n][2 * hh], dx[n][2 * hh + 1]);
    __syncthreads();
    if (kh == 1) return;
#pragma unroll
    for (int n = 0; n < 32; ++n)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float2 v =
            load2(red + (a0 + g + 8 * hh) * S::red_ld + 8 * n + 2 * t);
        dx[n][2 * hh] += v.x;
        dx[n][2 * hh + 1] += v.y;
      }
  }
  // dsrc = d[src | msg][:, :C] + dout (the residual), dmsg the rest
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + a0 + g + 8 * hh;
    if (row >= p.rows) continue;
#pragma unroll
    for (int n = 0; n < 32; ++n) {
      const int col = (8 * n + 2 * t) % kC;
      float v0 = dx[n][2 * hh], v1 = dx[n][2 * hh + 1];
      if (n < 16) {
        const float2 d = load2(p.dout + (size_t)row * kC + col);
        v0 += d.x;
        v1 += d.y;
      }
      store2((n < 16 ? p.dsrc : p.dmsg) + (size_t)row * kC + col, v0, v1);
    }
  }
}

// One weight block: hidden chunk h0 = 64 (wb % (H / 64)) .. and rows slice
// wb / (H / 64) (kSlice rows; neighbouring blocks share a slice, so its
// rows are read from L2), in tiles of TR rows double-buffered by cp.async;
// dW1[h0 ..] (64 x 2C) and dW2[:, h0 ..] (C x 64) summed in registers
// across the slice, at the end into the slice's partials. bf16: per tile
// warpgroup wgi recomputes a and dh for the tile's rows and units 32 wgi ..
// from [src | msg], dO' and the chunk's W1 and W2^T rows (staged once) on
// wgmma and stores da (rounded to bf16) and h = gelu(a) as tiles; then it
// forms dW1[h0 .., 128 wgi ..] (64 x 128) += da^T [src | msg] and
// dW2[64 wgi .., h0 ..] (64 x 64) += dO'^T h, every operand MN-major in
// shared memory. f32: the tile's da and h come from the row blocks, and
// warp w forms dW1[h0 .., 32 w ..] and dW2[16 w .., h0 ..] by 3xTF32
// (mm_tn).
template <typename T, bool TANH>
__device__ __forceinline__ void bwd_weight_block(unsigned char* smem,
                                                 const BwdArgs<T>& p, int wb) {
  using Cf = BwdCfg<T>;
  using S = BwdSmem<T>;
  constexpr int TR = Cf::wt;
  const uint32_t s0 = sm90::smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nc = p.H / kWHc, h0 = (wb % nc) * kWHc, sl = wb / nc;
  const int rs0 = sl * kSlice, rs1 = min(p.rows, rs0 + kSlice);
  const int ntile = (rs1 - rs0 + TR - 1) / TR;

  auto load_tile = [&](int i) {
    const uint32_t d = s0 + S::w_buf + (i & 1) * S::buf;
    const int r = rs0 + i * TR;
    g_xtile<T, TR>(d, p.src, p.msg, r, rs1);
    g_tile<T, TR, kC>(d + S::b_d, p.dop, kC, 0, r, rs1);
    if constexpr (is_f32<T>) {
      g_tile<T, TR, kWHc>(d + S::b_da, p.da, p.H, h0, r, rs1);
      g_tile<T, TR, kWHc>(d + S::b_h, p.hid, p.H, h0, r, rs1);
    } else {
      g_tile<T, TR, kC>(d + S::b_dlo, p.dop + (size_t)p.rows * kC, kC, 0, r,
                        rs1);
    }
  };
  if constexpr (!is_f32<T>) {
    g_tile<T, kWHc, 2 * kC>(s0, p.w1, 2 * kC, 0, h0, p.H);
    g_tile<T, kWHc, kC>(s0 + S::w_w2, p.w2t, kC, 0, h0, p.H);
  }
  load_tile(0);
  sm90::cp_async_commit();

  // bf16: the warpgroup's dW1 (64 x 128) and dW2 (64 x 64) accumulators;
  // f32: the warp's dW1 (64 x 32) and dW2 (16 x 64) tiles
  float a1[4][4][4], a2[1][8][4];
  zero(a1);
  zero(a2);
  for (int i = 0; i < ntile; ++i) {
    sm90::cp_async_wait<0>();
    if constexpr (!is_f32<T>) sm90::fence_async_smem();  // visible to wgmma
    __syncthreads();  // tile i landed; every warp left tile i - 1
    if (i + 1 < ntile) load_tile(i + 1);
    sm90::cp_async_commit();
    const uint32_t bo = S::w_buf + (i & 1) * S::buf;
    if constexpr (is_f32<T>) {
      mm_tn<4, 4, TR, S::rbh, S::rbx>(a1, smem, bo + S::b_da, 0, bo,
                                      32 * warp);
      mm_tn<1, 8, TR, S::rbd, S::rbh>(a2, smem, bo + S::b_d, 16 * warp,
                                      bo + S::b_h, 0);
    } else {
      // a and dh for the warpgroup's 64 rows x 32 units, the warp's 16 rows
      const int wgi = warp >> 2, rw = 16 * (warp & 3), hs = 32 * wgi;
      float a[4][4], dh[4][4];
      zero(a);
      zero(dh);
      wg_a_dh<TR, kWHc>(a, dh, s0 + bo, s0 + bo + S::b_d, s0 + bo + S::b_dlo,
                        0, s0, s0 + S::w_w2, hs);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = rw + g + 8 * hh, col = hs + 8 * n + 2 * t;
          const float x0 = a[n][2 * hh], x1 = a[n][2 * hh + 1];
          const uint32_t o = tile_at<T>(row, col, S::rbh);
          store2(reinterpret_cast<T*>(smem + S::w_da + o),
                 dh[n][2 * hh] * gelu_grad<TANH>(x0),
                 dh[n][2 * hh + 1] * gelu_grad<TANH>(x1));
          store2(reinterpret_cast<T*>(smem + S::w_h + o),
                 gelu_fwd<T, TANH>(x0), gelu_fwd<T, TANH>(x1));
        }
      sm90::fence_async_smem();  // visible to wgmma
      __syncthreads();           // the da and h tiles written
      float(&w1a)[64] = reinterpret_cast<float(&)[64]>(a1);
      float(&w2a)[32] = reinterpret_cast<float(&)[32]>(a2);
      sm90::wg_fence();
#pragma unroll
      for (int ks = 0; ks < TR / 16; ++ks) {
        const uint64_t bh = desc_mn(s0 + S::w_h, TR, 0, ks);
        sm90::WgSS<128, 1, 1>::mma(w1a, desc_mn(s0 + S::w_da, TR, 0, ks),
                                   desc_mn(s0 + bo, TR, 2 * wgi, ks));
        sm90::WgSS<64, 1, 1>::mma(w2a, desc_mn(s0 + bo + S::b_dlo, TR, wgi, ks),
                                  bh);
        sm90::WgSS<64, 1, 1>::mma(w2a, desc_mn(s0 + bo + S::b_d, TR, wgi, ks),
                                  bh);
      }
      sm90::wg_commit();
      sm90::wg_wait<0>();  // before the next tile overwrites the operands
      sm90::fence_regs(w1a);
      sm90::fence_regs(w2a);
    }
  }

  float* w1p = p.ws + (size_t)sl * 3 * kC * p.H;  // dW1 (H, 2C)
  float* w2p = w1p + (size_t)2 * kC * p.H;        // dW2 (C, H)
  if constexpr (!is_f32<T>) {
    // warp w of warpgroup wgi holds rows 16 (w % 4) + g (+ 8) of its 64-row
    // tiles, columns 8 j + 2 t (+ 1) at index 4 j (+ 2) (+ 1)
    const float(&w1a)[64] = reinterpret_cast<const float(&)[64]>(a1);
    const float(&w2a)[32] = reinterpret_cast<const float(&)[32]>(a2);
    const int wgi = warp >> 2, wr = 16 * (warp & 3) + g;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store2(w1p + (size_t)(h0 + wr + 8 * hh) * 2 * kC + 128 * wgi + 8 * j +
                   2 * t,
               w1a[4 * j + 2 * hh], w1a[4 * j + 2 * hh + 1]);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store2(w2p + (size_t)(64 * wgi + wr + 8 * hh) * p.H + h0 + 8 * j +
                   2 * t,
               w2a[4 * j + 2 * hh], w2a[4 * j + 2 * hh + 1]);
    }
  } else {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int n = 0; n < 4; ++n)
          store2(w1p + (size_t)(h0 + 16 * mt + g + 8 * hh) * 2 * kC +
                     32 * warp + 8 * n + 2 * t,
                 a1[mt][n][2 * hh], a1[mt][n][2 * hh + 1]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(w2p + (size_t)(16 * warp + g + 8 * hh) * p.H + h0 + 8 * n +
                   2 * t,
               a2[0][n][2 * hh], a2[0][n][2 * hh + 1]);
    }
  }
}

// The weight blocks (blockIdx.x < nwb), then the row blocks
template <typename T, bool TANH>
__global__ void __launch_bounds__(kGThreads, 1)
    mlp_fused_bwd_kernel(const BwdArgs<T> p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // wgmma's swizzle atoms need a 1024-byte-aligned base
  const uint32_t raw = sm90::smem_u32(smem_raw);
  unsigned char* smem = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  if ((int)blockIdx.x < p.nwb)
    bwd_weight_block<T, TANH>(smem, p, blockIdx.x);
  else
    bwd_row_block<T, TANH>(smem, p, blockIdx.x - p.nwb);
}

// The LayerNorm's backward from the saved o, a warp a row (4 columns a
// lane), kLnRows rows a block: dO' = rs (g - mean(g) - ohat mean(g ohat)),
// g = dout gamma, written in T (bf16: hi, and the remainders lo at + rows
// C, each rounded to bf16); the block's column
// sums of dout ohat (dgamma) and of dout (dbeta), each lane's over its
// rows in order, then the 8 warps in order, into part (nb, 2C). Blocks
// from nb on write W2^T (H, C) of T.
template <typename T>
__global__ void __launch_bounds__(kGThreads)
    mlp_bwd_prep_kernel(const T* __restrict__ w2, const T* __restrict__ gamma,
                        const T* __restrict__ dout,
                        const float* __restrict__ o, T* __restrict__ dop,
                        float* __restrict__ part, T* __restrict__ w2t,
                        int rows, int H, int nb) {
  __shared__ float red[kGThreads / 32][2 * kC];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= nb) {
    const int i = (blockIdx.x - nb) * kGThreads + tid;  // h C + c
    if (i < H * kC) w2t[i] = w2[(size_t)(i % kC) * H + i / kC];
    return;
  }
  const int warp = tid >> 5, lane = tid & 31, c0 = 4 * lane;
  constexpr int kPer = kLnRows / (kGThreads / 32);
  float gm[4], v1[4] = {0.f, 0.f, 0.f, 0.f}, v2[4] = {0.f, 0.f, 0.f, 0.f};
  load4(gamma + c0, gm);
  auto allsum = [](float s) {
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) s += __shfl_xor_sync(0xffffffffu, s, w);
    return s;
  };
  for (int i = 0; i < kPer; ++i) {
    const int row = blockIdx.x * kLnRows + warp * kPer + i;
    if (row >= rows) break;
    float x[4], dy[4];
    load4(o + (size_t)row * kC + c0, x);
    load4(dout + (size_t)row * kC + c0, dy);
    const float mean = allsum(x[0] + x[1] + x[2] + x[3]) * (1.f / kC);
    float q = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) q = fmaf(x[e] - mean, x[e] - mean, q);
    const float rs = rsqrtf(allsum(q) * (1.f / kC) + 1e-5f);
    float oh[4], gg[4], gs = 0.f, ghs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      oh[e] = (x[e] - mean) * rs;
      gg[e] = dy[e] * gm[e];
      gs += gg[e];
      ghs = fmaf(gg[e], oh[e], ghs);
      v1[e] = fmaf(dy[e], oh[e], v1[e]);
      v2[e] += dy[e];
    }
    const float mg = allsum(gs) * (1.f / kC), mgh = allsum(ghs) * (1.f / kC);
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] = rs * (gg[e] - mg - oh[e] * mgh);
    store4(dop + (size_t)row * kC + c0, d[0], d[1], d[2], d[3]);
    if constexpr (!is_f32<T>) {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] -= round_to<T>(d[e]);
      store4(dop + ((size_t)rows + row) * kC + c0, d[0], d[1], d[2], d[3]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    red[warp][c0 + e] = v1[e];
    red[warp][kC + c0 + e] = v2[e];
  }
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kGThreads / 32; ++w) s += red[w][tid];
  part[(size_t)blockIdx.x * 2 * kC + tid] = s;
}

// Blocks 0 .. 2C - 1: dgamma then dbeta, output i the sum of part's nb
// block sums (each thread over blocks t, t + 128, .. in order, then a fixed
// tree); the rest: the weight gradients, dW1 (H, 2C) then dW2 (C, H), each
// element the sum of its S slice partials in order. All rounded once to T.
template <typename T>
__global__ void __launch_bounds__(128)
    mlp_bwd_reduce_kernel(const float* __restrict__ part, int nb,
                          const float* __restrict__ ws, int S, int H,
                          T* __restrict__ dgb, T* __restrict__ dw1,
                          T* __restrict__ dw2) {
  __shared__ float red[128];
  const int t = threadIdx.x;
  if ((int)blockIdx.x < 2 * kC) {
    const int i = blockIdx.x;
    float s = 0.f;
    for (int k = t; k < nb; k += 128) s += part[(size_t)k * 2 * kC + i];
    red[t] = s;
    __syncthreads();
#pragma unroll
    for (int w = 64; w > 0; w >>= 1) {
      if (t < w) red[t] += red[t + w];
      __syncthreads();
    }
    if (t == 0) dgb[i] = from_f<T>(red[0]);
    return;
  }
  const size_t n = (size_t)3 * kC * H;
  const size_t e = (size_t)(blockIdx.x - 2 * kC) * 128 + t;
  if (e >= n) return;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += ws[(size_t)k * n + e];
  if (e < (size_t)2 * kC * H)
    dw1[e] = from_f<T>(s);
  else
    dw2[e - (size_t)2 * kC * H] = from_f<T>(s);
}

// the LayerNorm backward's blocks (part's rows) and the weight blocks'
// row slices (ws's)
inline int bwd_ln_blocks(int rows) { return (rows + kLnRows - 1) / kLnRows; }
inline int bwd_slices(int rows) { return (rows + kSlice - 1) / kSlice; }

template <typename T, bool TANH>
int launch_mlp_bwd(const void* src, const void* msg, const void* w1,
                   const void* w2, const void* gamma, const void* dout,
                   const void* o_in, void* dsrc, void* dmsg, void* dw1,
                   void* dw2, void* dgb, void* dop, void* w2t, void* part,
                   void* ws, void* da, void* hid, int rows, int H,
                   cudaStream_t stream) {
  using S = BwdSmem<T>;
  auto kb = mlp_fused_bwd_kernel<T, TANH>;
  cudaError_t err = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::launch_bytes);
  if (err != cudaSuccess) return (int)err;
  const int nb = bwd_ln_blocks(rows), ns = bwd_slices(rows);
  const int nwb = (H / kWHc) * ns;
  const int nrb = (rows + BwdCfg<T>::rows - 1) / BwdCfg<T>::rows;
  mlp_bwd_prep_kernel<T><<<nb + (H * kC + kGThreads - 1) / kGThreads,
                           kGThreads, 0, stream>>>(
      static_cast<const T*>(w2), static_cast<const T*>(gamma),
      static_cast<const T*>(dout), static_cast<const float*>(o_in),
      static_cast<T*>(dop), static_cast<float*>(part), static_cast<T*>(w2t),
      rows, H, nb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BwdArgs<T> a{static_cast<const T*>(src), static_cast<const T*>(msg),
               static_cast<const T*>(w1),  static_cast<const T*>(w2t),
               static_cast<const T*>(dout), static_cast<const T*>(dop),
               static_cast<T*>(dsrc),      static_cast<T*>(dmsg),
               static_cast<float*>(da),    static_cast<float*>(hid),
               static_cast<float*>(ws),    rows, H, nwb};
  if constexpr (!is_f32<T>) {
    kb<<<nwb + nrb, kGThreads, S::launch_bytes, stream>>>(a);
  } else {  // the weight blocks read the row blocks' da and h
    a.nwb = 0;
    kb<<<nrb, kGThreads, S::launch_bytes, stream>>>(a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    a.nwb = nwb;
    kb<<<nwb, kGThreads, S::launch_bytes, stream>>>(a);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  mlp_bwd_reduce_kernel<T><<<2 * kC + (3 * kC * H + 127) / 128, 128, 0,
                             stream>>>(
      static_cast<const float*>(part), nb, static_cast<const float*>(ws), ns,
      H, static_cast<T*>(dgb), static_cast<T*>(dw1), static_cast<T*>(dw2));
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

// The bytes of the scratch keep_mlp_fused_bwd takes (arguments as there),
// into bytes[6]: dop (rows, C) of dtype (bf16: (2, rows, C), dO' hi and
// lo), w2t (H, C) of dtype, part (the LayerNorm backward's blocks, 2C) f32,
// ws (the weight blocks' row slices, 3 C H) f32, da and hid (rows, H) f32
// for dtype 0 and 0 (none) for 1. Returns a cudaError_t value (0 = ok).
extern "C" int keep_mlp_fused_bwd_scratch(int rows, int C, int H, int dtype,
                                          long long* bytes) {
  using namespace keep;
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long r = rows, h = H, es = dtype == 0 ? 4 : 2;
  bytes[0] = (dtype == 0 ? 1 : 2) * r * kC * es;
  bytes[1] = h * kC * es;
  bytes[2] = (long long)bwd_ln_blocks(rows) * 2 * kC * 4;
  bytes[3] = (long long)bwd_slices(rows) * 3 * kC * h * 4;
  bytes[4] = bytes[5] = dtype == 0 ? r * h * 4 : 0;
  return 0;
}

// The backward of keep_mlp_fused (arguments as there; beta has no part in
// it). dout, dsrc, dmsg: (rows, C) of dtype; o_in: (rows, C) f32, the
// forward's o_out. Outputs of dtype: dw1 (H, 2C), dw2 (C, H), dgb (2, C)
// (dgamma, dbeta). Scratch: dop, w2t, part, ws, da and hid of the bytes
// keep_mlp_fused_bwd_scratch gives (da and hid null for dtype 1). Four
// kernels on the stream in f32 (the LayerNorm's backward, the row blocks,
// the weight blocks, the reduce), three in bf16 (row and weight blocks in
// one grid); returns a cudaError_t value (0 = ok).
extern "C" int keep_mlp_fused_bwd(const void* src, const void* msg,
                                  const void* w1, const void* w2,
                                  const void* gamma, const void* dout,
                                  const void* o_in, void* dsrc, void* dmsg,
                                  void* dw1, void* dw2, void* dgb, void* dop,
                                  void* w2t, void* part, void* ws, void* da,
                                  void* hid, int rows, int C, int H,
                                  int approximate, int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && (da == nullptr || hid == nullptr))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto launch) {
    return launch(src, msg, w1, w2, gamma, dout, o_in, dsrc, dmsg, dw1, dw2,
                  dgb, dop, w2t, part, ws, da, hid, rows, H, st);
  };
  if (dtype == 0)
    return approximate ? go(launch_mlp_bwd<float, true>)
                       : go(launch_mlp_bwd<float, false>);
  if (dtype == 1)
    return approximate ? go(launch_mlp_bwd<bf16, true>)
                       : go(launch_mlp_bwd<bf16, false>);
  return (int)cudaErrorInvalidValue;
}
