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
// runs both products as 3xTF32 on wgmma (x = hi + lo, hi x rounded to
// TF32, a b = a_hi b_hi + a_hi b_lo + a_lo b_hi, f32 accumulation; a
// single TF32 product fails the f32 gates), so 3 x 6 C H flops a row at
// 495 TFLOP/s bound it: 0.742 ms at the chunk's 155,648 rows (the FMA
// pipe's 67 TFLOP/s, which the earlier register-tiled FMA kernel ran at
// 51-54 %, gives 1.83). TF32 wgmma takes shared-memory operands only
// K-major, which both weights are as nn.Linear holds them, and the split
// has to happen on chip: split weights read by every 128-row block would
// be 3.6 GB of L2 reads a call at that shape, the raw ones are 1.8 GB. So a
// block of 128 rows is two consumer warpgroups and a producer warpgroup
// (setmaxnreg 40 / 232): the producer's first thread loads [src | msg]
// (128 KB, raw) and, through a ring of three 32 KB slots, each 16 KB
// weight slice by TMA into its slot's lo tile, and its 128 threads split
// the slice in place into hi and lo tiles (raw and split share wgmma's
// 128-byte-swizzle layout). A consumer holds no [src | msg] in registers
// (its 64 x 256 would take 128 a thread): product 1 reads its A fragments
// from the staged rows by ldmatrix for every chunk and splits them two k
// steps at a time into one of two register sets. Per 64-wide hidden chunk
// it forms its 64 x 64 hidden on m64n64k8 in f32 registers, applies the
// gelu there and splits it into hi bits (the value's bits + 0x1000, which
// the tensor core reads as the TF32 rounding) and lo -- a wgmma
// accumulator's registers are its own A fragments once W2's hidden units
// are relabelled within each 8, which the producer does as it splits W2 --
// and accumulates 64 x 128 of output on m64n128k8. The tensor core's adds
// truncate, so no long sum runs through it (one chain over a row's 256
// inputs, and over the 1024 hidden units, failed the gradient gate of the
// card tests, whose backward reads this forward's LayerNorm input): the
// hidden's products run in groups of 2 k steps, each from zero, added in
// f32 once landed (two sets in flight), and each chunk's output product
// from zero too, added to the output in f32. Those sums take the registers
// that overlapping one chunk's output product with the next chunk's hidden
// would need, so a consumer runs its chunks in order and the two
// warpgroups overlap each other. A slot is released one group after its
// last product. The LayerNorm and the residual run on the output registers
// as in bf16, and the f32 rows leave by 8-byte stores.
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
// TF32 products each) 0.625 ms at 495. No atomics anywhere (two calls are
// bitwise equal); the weight products sum over slices of kSlice rows, whose
// partials a last kernel adds in a fixed order.
//   * mlp_bwd_prep_kernel: the LayerNorm's backward, a warp a row: dO'
//     (rows, C) and per-block column sums of dout ohat and dout; and W2^T
//     (H, C) (f32: and W1^T (2C, H)), so that every product reads its
//     weights K-contiguous.
//   * bf16: mlp_fused_bwd_kernel, 8 warps a block, two kinds of block in one
//     grid, weight blocks first, so that they fill the card's waves
//     together. Row blocks own 128 rows and stream W1 and W2^T in 64-unit
//     chunks through two cp.async stages: per chunk they form a = [src |
//     msg] W1^T and dh = dO' W2 for their rows, da on the registers, and
//     d[src | msg] += da W1 from those registers into a 16 x 256
//     accumulator a warp across H. Weight blocks own a 64-wide hidden chunk
//     over a slice of kSlice rows, in row tiles double-buffered by cp.async,
//     recompute a and dh for the chunk (h and da for every row would be a
//     (rows, H) f32 tensor's bytes), store da and h as tiles and sum dW1 and
//     dW2 over the slice in registers. Every product a warpgroup issues
//     (64-row tiles) reads its shared-memory operands once for the 4 warps;
//     each tile is stored once, in wgmma's 128-byte-swizzle layout (am_at),
//     and is a K-major operand of one product and an MN-major one of the
//     other; d[src | msg] takes da as its A operand from registers (wgmma's
//     register A layout is mma.sync's, and so is its accumulator layout).
//     Precision: [src | msg], W1, W2 and h are bf16 values, so a and the
//     products with h are exact bf16 products with f32 sums; dO' enters dh
//     and dW2 as bf16 hi + lo (two products), da enters d[src | msg] and
//     dW1 rounded once. In a model of the rounding at a single row
//     (tests/test_torch_kernel_backward.py) this scheme stood within 2.0x
//     the plain backward's distance to float64 and dO' rounded once too up
//     to 3.2x (the gate is 3x); hi + lo for da as well took 1.1x the time.
//   * f32: mlp_bwd_gemm_kernel, three launches of one warp-specialized
//     3xTF32 wgmma GEMM (AH, DX, W below), x = hi + lo with hi x rounded to
//     TF32, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi in f32. TF32 wgmma
//     reads shared memory only K-major, and of the weight products' operands
//     (K = rows) only da and h can be written so: AH computes a and dh for
//     128 rows x 64 units and writes da^T and h^T (H, rows) f32 from a
//     transposing staging tile by TMA (two (rows, H) f32 tensors' bytes);
//     DX forms d[src | msg] = da W1 from da^T
//     and W1^T; W forms dW1^T = [src | msg]^T da and dW2 = dO'^T h over row
//     slices from da^T and h^T (B, K-major) and the raw row tiles (A). A
//     block is two consumer warpgroups of 64 rows and a producer warpgroup
//     whose first thread loads a K step's raw A tile and B tile by TMA into
//     a ring of slots; its 128 threads split B in place into TF32 hi and lo
//     tiles, relabelling its K within each 8 (slots 0-3 the even K, 4-7 the
//     odd); the consumers read A from the raw tile into registers in the
//     same K order (K-major rows by 8-byte loads, MN-major tiles by 4-byte
//     loads, both without bank conflicts) and split it there. The tensor
//     core's adds truncate, so each K step's (4 k8 steps') products run
//     from zero into a part set, added in f32 once it has landed (the two
//     warpgroups overlap each other). AH's tiles are 64 units wide (it
//     holds a and dh), DX's and W's 128.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

using sm90::am_at;
using sm90::desc_k;
using sm90::desc_mn;
using sm90::f_add;

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
// f32: 3xTF32 on wgmma, [src | msg] in shared memory, the weights split on
// chip by a producer warpgroup
// ---------------------------------------------------------------------------

constexpr int kFRows = 128;        // rows per block: 2 warpgroups x 64
constexpr int kFThreads = 384;     // 2 consumer warpgroups and a producer
constexpr int kFHc = 64;           // hidden units per chunk
constexpr int kFStages = 3;        // slots of the weight ring
constexpr int kFTile = 16384;      // a slice's hi or lo tile
constexpr int kFXBytes = kFRows * 2 * kC * 4;  // [src | msg]: 128 KB
// byte offsets: the mbarriers, [src | msg] (raw f32, eight am_at column
// blocks of 32: src's four, then msg's), the ring's slots (a slice's hi
// tile, then its lo tile); the launch's bytes + 1024 for rounding the base
constexpr uint32_t kFX = 1024;
constexpr uint32_t kFW = kFX + kFXBytes;
constexpr int kFSmem = kFW + kFStages * 2 * kFTile + 1024;  // 226 KB
// mbarriers: [src | msg] landed; slot u split (128 producer threads
// arrive); slot u released (256 consumer threads); slot u's raw tile landed
constexpr int kFBarX = 0, kFFull = 1, kFEmpty = 1 + kFStages,
              kFRaw = 1 + 2 * kFStages;
static_assert(kFSmem <= 232448, "227 KB a block");

// The weight stream, slice by slice (16 KB raw each), six a chunk c in the
// order the consumers read them: W1's 64 rows of the chunk over inputs 64 p
// .. (parts p = 0..3), then W2's 128 rows over the chunk's hidden units 32
// (p - 4) .. (parts 4, 5)
constexpr int kFSlices = 6;


// Product 1's groups of slice p (stream index ts): the chunk's hidden +=
// [src | msg][:, 64 p ..] W1[chunk, 64 p ..]^T as 3xTF32 (x' Whi + x' Wlo
// + xlo Whi), 8 k steps in 4 groups of 2, each committed into part[c & 1]
// from zero (c = 4 p + q, the group in the chunk) and added to h once it
// has landed (the wait before group c + 2; the caller adds groups 14 and
// 15); [src | msg] read as A fragments by ldmatrix (an 8 x 8 b16 matrix is
// 8 rows of 4 f32: the TF32 A fragment's) and split into one of two
// register sets, each rewritten only once its group has landed. The
// slice's full wait comes after its first group's release of slice p - 1
// (released at the wait before group 4 p + 1, one group after its last),
// so a slot is released with at most the next slice waited for and the
// producer can load one slice ahead of the one it splits.
__device__ __forceinline__ void f_p1_slice(float (&h)[32],
                                           float (&part)[2][32], int p,
                                           int ts, uint32_t s0, int rw,
                                           int lane, uint32_t (&xh)[2][2][4],
                                           uint32_t (&xl)[2][2][4]) {
  const int mi = lane >> 3, mr = lane & 7;
  const int u = ts % kFStages;
  const uint32_t whi = s0 + kFW + u * 2 * kFTile;
  const uint64_t dwh = desc_k(whi, kFHc, 0, 0);
  const uint64_t dwl = desc_k(whi + kFTile, kFHc, 0, 0);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = 4 * p + q;
    if (c >= 2) {
      sm90::wg_wait<1>();  // group c - 2 landed
      sm90::fence_regs(part[c & 1]);
      f_add(h, part[c & 1], c == 2);
      if (q == 1 && p > 0)  // slice p - 1's last group landed
        sm90::mbar_arrive(s0 + 8 * (kFEmpty + (ts - 1) % kFStages));
    }
    if (q == 0) sm90::mbar_wait(s0 + 8 * (kFFull + u), (ts / kFStages) & 1);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int kg = 8 * p + 2 * q + kk;  // the k step over [src | msg]
      uint32_t a[4];
      sm90::ldsm_x4(s0 + kFX + am_at(rw + (mi & 1) * 8 + mr,
                                     2 * kg + (mi >> 1), kFRows),
                    a);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        xh[q & 1][kk][e] = sm90::tf32_hi_bits(a[e]);
        xl[q & 1][kk][e] = sm90::tf32_lo_of_hi(xh[q & 1][kk][e]);
      }
    }
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * q + kk;  // within the slice
      const uint64_t dh = sm90::desc_k_at(dwh, kFHc, ks);
      sm90::WgTf32<64>::mma(part[c & 1], xh[q & 1][kk], dh, kk > 0);
      sm90::WgTf32<64>::mma(part[c & 1], xh[q & 1][kk],
                            sm90::desc_k_at(dwl, kFHc, ks), 1);
      sm90::WgTf32<64>::mma(part[c & 1], xl[q & 1][kk], dh, 1);
    }
    sm90::wg_commit();
  }
}

// Product 2's group of W2 half p (stream index ts): op (+)= h[:, 32 p ..]
// W2[:, chunk, 32 p ..]^T as 3xTF32 from the split hidden's registers, op
// from zero at half 0; committed
__device__ __forceinline__ void f_p2_half(float (&op)[64], int p, int ts,
                                          uint32_t s0,
                                          const uint32_t (&ah)[8][4],
                                          const uint32_t (&al)[8][4]) {
  const int u = ts % kFStages;
  const uint32_t whi = s0 + kFW + u * 2 * kFTile;
  const uint64_t dwh = desc_k(whi, kC, 0, 0);
  const uint64_t dwl = desc_k(whi + kFTile, kC, 0, 0);
  sm90::mbar_wait(s0 + 8 * (kFFull + u), (ts / kFStages) & 1);
  sm90::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t dh = sm90::desc_k_at(dwh, kC, kk);
    const uint64_t dl = sm90::desc_k_at(dwl, kC, kk);
    sm90::WgTf32<128>::mma(op, ah[4 * p + kk], dh, p > 0 || kk > 0);
    sm90::WgTf32<128>::mma(op, ah[4 * p + kk], dl, 1);
    sm90::WgTf32<128>::mma(op, al[4 * p + kk], dh, 1);
  }
  sm90::wg_commit();
}

// src, msg, out: (rows, 128); w1: (H, 256); w2: (128, H); gamma, beta:
// (128,), all f32; src, msg, w1 and w2 are read through the tensor maps
// tsrc, tmsg, tw1, tw2. H % 64 == 0. Grid ceil(rows / 128), 384 threads:
// warpgroup wg < 2 owns rows 64 wg .. of the block, its warp w the 16 rows
// from 16 w; warpgroup 2 is the producer (40 registers a thread, the
// consumers 232): its first thread loads [src | msg] and each slice's raw
// tile by TMA (into the slot's lo tile), and its 128 threads split the
// slice in place into TF32 hi and lo tiles (W2's hidden units relabelled
// within each 8: slot t unit 2t, slot t + 4 unit 2t + 1, so that the gelu'd
// hidden's accumulator registers are the A fragments of product 2 as they
// stand). Per chunk a consumer forms its 64 x 64 hidden on m64n64k8 in f32
// registers, applies the gelu there, splits it into hi bits and lo, and
// accumulates 64 x 128 of output on m64n128k8, the sums in f32 (f_add).
template <bool TANH>
__global__ void __launch_bounds__(kFThreads, 1)
    mlp_fused_f32_kernel(const __grid_constant__ CUtensorMap tsrc,
                         const __grid_constant__ CUtensorMap tmsg,
                         const __grid_constant__ CUtensorMap tw1,
                         const __grid_constant__ CUtensorMap tw2,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         float* __restrict__ out,
                         float* __restrict__ o_out, int rows, int H) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = sm90::smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31;
  const int r0 = blockIdx.x * kFRows;
  const int n_chunks = H / kFHc, n_slices = kFSlices * n_chunks;
  auto bar = [&](int i) { return s0 + 8 * i; };

  if (tid == 0) {
    sm90::mbar_init(bar(kFBarX), 1);
    for (int u = 0; u < kFStages; ++u) {
      sm90::mbar_init(bar(kFFull + u), 128);
      sm90::mbar_init(bar(kFEmpty + u), 256);
      sm90::mbar_init(bar(kFRaw + u), 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer
    sm90::setmaxnreg_dec<40>();
    const int p = tid - 256;
    auto issue = [&](int t) {  // slice t's raw tile into its slot's lo tile
      const int u = t % kFStages;
      const int chunk = t / kFSlices, part = t % kFSlices;
      const uint32_t lo = s0 + kFW + u * 2 * kFTile + kFTile;
      sm90::mbar_expect_tx(bar(kFRaw + u), kFTile);
      if (part >= 4) {
        sm90::tma_load_3d(lo, &tw2, chunk * kFHc + 32 * (part - 4), 0, 0,
                          bar(kFRaw + u));
      } else {
#pragma unroll
        for (int cb = 0; cb < 2; ++cb)
          sm90::tma_load_3d(lo + cb * kFHc * 128, &tw1, 64 * part + 32 * cb,
                            chunk * kFHc, 0, bar(kFRaw + u));
      }
    };
    if (p == 0) {
      sm90::mbar_expect_tx(bar(kFBarX), kFXBytes);
#pragma unroll
      for (int cb = 0; cb < 4; ++cb) {
        sm90::tma_load_3d(s0 + kFX + cb * kFRows * 128, &tsrc, 32 * cb, r0, 0,
                          bar(kFBarX));
        sm90::tma_load_3d(s0 + kFX + (4 + cb) * kFRows * 128, &tmsg, 32 * cb,
                          r0, 0, bar(kFBarX));
      }
      issue(0);
    }
    // slice t + 1's raw tile is loaded while slice t is split: its slot is
    // released once the consumers have waited for slice t - 1 (f_p1_slice),
    // which is split already, so this wait cannot hold up slice t
    for (int t = 0; t < n_slices; ++t) {
      const int u = t % kFStages;
      unsigned char* hi = smem + kFW + u * 2 * kFTile;
      unsigned char* lo = hi + kFTile;
      if (t + 1 < n_slices) {
        const int t1 = t + 1;
        if (t1 >= kFStages)  // every producer thread waits: warps converged
          sm90::mbar_wait(bar(kFEmpty + t1 % kFStages),
                          (t1 / kFStages - 1) & 1);
        if (p == 0) issue(t1);
      }
      sm90::mbar_wait(bar(kFRaw + u), (t / kFStages) & 1);
      if (t % kFSlices >= 4) {
        // row n, hidden units 8 q .. 8 q + 7 (chunks 2q, 2q + 1, at c ^ (n
        // & 7)): slots 0-3 take units 0, 2, 4, 6, slots 4-7 units 1, 3, 5, 7
#pragma unroll
        for (int i = p; i < kC * 4; i += 128) {
          const int n = i & 127, q = i >> 7;
          const uint32_t oa = n * 128 + (((2 * q) ^ (n & 7)) << 4);
          const uint32_t ob = n * 128 + (((2 * q + 1) ^ (n & 7)) << 4);
          const uint4 ra = *reinterpret_cast<const uint4*>(lo + oa);
          const uint4 rb = *reinterpret_cast<const uint4*>(lo + ob);
          uint4 xa = make_uint4(ra.x, ra.z, rb.x, rb.z), ha;
          uint4 xb = make_uint4(ra.y, ra.w, rb.y, rb.w), hb;
          sm90::split_tf32_4(xa, ha);
          sm90::split_tf32_4(xb, hb);
          *reinterpret_cast<uint4*>(hi + oa) = ha;
          *reinterpret_cast<uint4*>(hi + ob) = hb;
          *reinterpret_cast<uint4*>(lo + oa) = xa;
          *reinterpret_cast<uint4*>(lo + ob) = xb;
        }
      } else {
#pragma unroll
        for (int i = p; i < kFTile / 16; i += 128) {
          uint4* l = reinterpret_cast<uint4*>(lo + 16 * i);
          uint4 x = *l, h;
          sm90::split_tf32_4(x, h);
          *reinterpret_cast<uint4*>(hi + 16 * i) = h;
          *l = x;
        }
      }
      sm90::fence_async_smem();  // the split tiles, to wgmma
      sm90::mbar_arrive(bar(kFFull + u));
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (tid >> 5);  // the warp's first row in the block
  auto release = [&](int ts) {
    sm90::mbar_arrive(bar(kFEmpty + ts % kFStages));
  };
  sm90::mbar_wait(bar(kFBarX), 0);

  float o[64];           // the warpgroup's 64 x 128 output, f32
  float op[64];          // a chunk's part of it, from zero
  float h[32];           // its 64 x 64 hidden of a chunk, f32
  float part[2][32];     // the hidden's groups in flight, from zero
  uint32_t ah[8][4], al[8][4];  // the gelu'd hidden as A: hi bits, lo
  uint32_t xh[2][2][4], xl[2][2][4];  // [src | msg] A fragments in flight

  // Per chunk: its hidden (product 1, 16 groups of 2 k steps, summed in
  // f32), the gelu split into product 2's A (slot t of k step j is unit 8j
  // + 2t), then product 2 into op from zero, added to o in f32. The tensor
  // core's adds truncate: one chain over a row's 256 inputs or a chunk
  // sequence's 1024 hidden units failed the gradient gate of the card
  // tests, whose backward reads this o
#pragma unroll 1
  for (int j = 0; j < n_chunks; ++j) {
    const int b = kFSlices * j;  // the chunk's first stream index
#pragma unroll
    for (int p = 0; p < 4; ++p)
      f_p1_slice(h, part, p, b + p, s0, rw, lane, xh, xl);
    sm90::wg_wait<0>();
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sm90::fence_regs(part[c]);
      f_add(h, part[c], false);
    }
    release(b + 3);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      float v[4] = {h[4 * jj], h[4 * jj + 2], h[4 * jj + 1], h[4 * jj + 3]};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = TANH ? gelu_tanh(v[e]) : gelu_erf(v[e]);
        ah[jj][e] = sm90::tf32_hi_bits(__float_as_uint(v[e]));
        al[jj][e] = sm90::tf32_lo_of_hi(ah[jj][e]);
      }
    }
    f_p2_half(op, 0, b + 4, s0, ah, al);
    f_p2_half(op, 1, b + 5, s0, ah, al);
    sm90::wg_wait<0>();
    sm90::fence_regs(op);
    release(b + 4);
    release(b + 5);
    f_add(o, op, j == 0);
  }

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
  // + src from the staged tile (column block c / 32, chunk (c / 4) % 8)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + rw + g + 8 * hh;
    if (row >= rows) continue;
    const float mean = hh ? mean1 : mean0, rs = hh ? rs1 : rs0;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int c = 8 * n + 2 * t;
      const float y0 = o[4 * n + 2 * hh], y1 = o[4 * n + 2 * hh + 1];
      if (o_out != nullptr)  // the LayerNorm's input, for the backward
        *reinterpret_cast<float2*>(o_out + (size_t)row * kC + c) =
            make_float2(y0, y1);
      const float2 x = *reinterpret_cast<const float2*>(
          smem + kFX + am_at(rw + g + 8 * hh, c >> 2, kFRows) + 4 * (c & 3));
      const float2 gm = __ldg(reinterpret_cast<const float2*>(gamma + c));
      const float2 bt = __ldg(reinterpret_cast<const float2*>(beta + c));
      *reinterpret_cast<float2*>(out + (size_t)row * kC + c) = make_float2(
          x.x + ((y0 - mean) * rs * gm.x + bt.x),
          x.y + ((y1 - mean) * rs * gm.y + bt.y));
    }
  }
}

template <bool TANH>
int launch_mlp_f32(const void* src, const void* msg, const void* w1,
                   const void* w2, const void* gamma, const void* beta,
                   void* out, float* o_out, int rows, int H,
                   cudaStream_t stream) {
  CUtensorMap tsrc, tmsg, tw1, tw2;
  int err = sm90::tma_map_f32(&tsrc, src, kC, rows, 1, kFRows);
  if (err == 0) err = sm90::tma_map_f32(&tmsg, msg, kC, rows, 1, kFRows);
  if (err == 0) err = sm90::tma_map_f32(&tw1, w1, 2 * kC, H, 1, kFHc);
  if (err == 0) err = sm90::tma_map_f32(&tw2, w2, H, kC, 1, kC);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(mlp_fused_f32_kernel<TANH>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kFSmem);
  if (err != 0) return err;
  const int blocks = (rows + kFRows - 1) / kFRows;
  mlp_fused_f32_kernel<TANH><<<blocks, kFThreads, kFSmem, stream>>>(
      tsrc, tmsg, tw1, tw2, static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<float*>(out), o_out, rows,
      H);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Backward (both dtypes): tensor cores, bf16 on wgmma and f32 as 3xTF32
// ---------------------------------------------------------------------------

constexpr int kGThreads = 256;
constexpr int kLnRows = 128;   // rows a block of the LayerNorm backward
constexpr int kWHc = 64;       // hidden units a weight block owns
constexpr int kSlice = 2048;   // rows a weight block sums over

// The bf16 form's tiling. Row blocks own `rows` rows (two warpgroups of
// 64) and stream W1 and W2^T in chunks of `hc` hidden units through two
// stages, `hstep` units at a time. Weight blocks walk their rows in tiles
// of `wt`.
template <typename T> struct BwdCfg;
template <> struct BwdCfg<bf16> {
  static constexpr int rows = 128, hc = 64, ks = 1, hstep = 32, wt = 64;
};

// byte offsets in a bf16 backward block's shared memory: tiles in wgmma's
// 128-byte-swizzle layout (am_at): 64-column blocks of the tile's rows x
// 128 B, so that one tile is a K-major operand of one product and an
// MN-major one of the other (W1's rows: B of a = X W1^T and of d[src |
// msg] = da W1; [src | msg] and dO': A of a and dh, B and A of dW1 and
// dW2)
template <typename T>
struct BwdSmem {
  using Cf = BwdCfg<T>;
  // dO' enters dh and dW2 as bf16 hi + lo (lo the rounded remainder), two
  // products each, and da enters d[src | msg] and dW1 rounded once
  static constexpr int nd = 2;
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
  // weight blocks: the chunk's W1 and W2^T rows, two buffers of a row
  // tile's [src | msg] and dO' (hi, lo), then the tile's da and h, which
  // the block recomputes
  static constexpr uint32_t w_w2 = kWHc * rbx;
  static constexpr uint32_t w_buf = w_w2 + kWHc * rbd;
  static constexpr uint32_t b_d = Cf::wt * rbx;
  static constexpr uint32_t b_dlo = b_d + Cf::wt * rbd;
  static constexpr uint32_t buf = b_d + nd * Cf::wt * rbd;
  static constexpr uint32_t w_da = w_buf + 2 * buf;
  static constexpr uint32_t w_h = w_da + Cf::wt * rbh;
  static constexpr uint32_t w_bytes = w_h + Cf::wt * rbh;
  static constexpr uint32_t bytes = r_bytes > w_bytes ? r_bytes : w_bytes;
  // the launch's: the base is rounded up to 1024 B (wgmma's swizzle atoms)
  static constexpr uint32_t launch_bytes = bytes + 1024;
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
  const T* dop;    // dO' (rows, C): hi, then lo at + rows C
  T* dsrc; T* dmsg;
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
// caller commits), in am_at's layout; rows at or past lim are zero-filled
template <typename T, int R, int W>
__device__ __forceinline__ void g_tile(uint32_t dst, const T* src, size_t ld,
                                       int c0, int r0, int lim) {
  constexpr int RB = W * (int)sizeof(T), CH = RB / 16, E = 16 / sizeof(T);
  static_assert(R * CH % kGThreads == 0, "whole rounds of the block");
#pragma unroll
  for (int i0 = 0; i0 < R * CH; i0 += kGThreads) {
    const int i = i0 + threadIdx.x, r = i / CH, c = i % CH;
    const bool ok = r0 + r < lim;
    sm90::cp_async16(dst + am_at(r, c, R),
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
    sm90::cp_async16(dst + am_at(r, c, R),
                     base + (size_t)(ok ? r0 + r : 0) * kC + (c % (CH / 2)) * E,
                     ok ? 16 : 0);
  }
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
// H. Warpgroup wgi owns rows 64 wgi .. (its warp w the 16 from 16 w) and
// its products run on wgmma, d[src | msg]'s with da as the A operand from
// registers.
template <typename T, bool TANH>
__device__ __forceinline__ void bwd_row_block(unsigned char* smem,
                                              const BwdArgs<T>& p, int rb) {
  using Cf = BwdCfg<T>;
  using S = BwdSmem<T>;
  constexpr int R = Cf::rows, HC = Cf::hc, HS = Cf::hstep;
  constexpr int NT = HS / 8;
  const uint32_t s0 = sm90::smem_u32(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int a0 = 16 * warp;
  const int r0 = rb * R, nc = p.H / HC;

  g_xtile<T, R>(s0, p.src, p.msg, r0, p.rows);
  g_tile<T, R, kC>(s0 + S::r_d, p.dop, kC, 0, r0, p.rows);
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
    sm90::fence_async_smem();  // visible to wgmma
    __syncthreads();  // chunk j landed; every warp left chunk j - 1
    if (j + 1 < nc) load_chunk(j + 1);  // into chunk j - 1's stage
    sm90::cp_async_commit();
    const uint32_t w1o = S::r_ring + (j & 1) * S::r_stage;
#pragma unroll 1
    for (int hs = 0; hs < HC; hs += HS) {
      float a[NT][4], dh[NT][4];
      zero(a);
      zero(dh);
      wg_a_dh<R, HC>(a, dh, s0, s0 + S::r_d, s0 + S::r_dlo, 64 * (warp >> 2),
                     s0 + w1o, s0 + w1o + S::r_w2, hs);
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float x0 = a[n][2 * hh], x1 = a[n][2 * hh + 1];
          a[n][2 * hh] = dh[n][2 * hh] * gelu_grad<TANH>(x0);
          a[n][2 * hh + 1] = dh[n][2 * hh + 1] * gelu_grad<TANH>(x1);
        }
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
// across the slice, at the end into the slice's partials. Per tile
// warpgroup wgi recomputes a and dh for the tile's rows and units 32 wgi ..
// from [src | msg], dO' and the chunk's W1 and W2^T rows (staged once) on
// wgmma and stores da (rounded to bf16) and h = gelu(a) as tiles; then it
// forms dW1[h0 .., 128 wgi ..] (64 x 128) += da^T [src | msg] and
// dW2[64 wgi .., h0 ..] (64 x 64) += dO'^T h, every operand MN-major in
// shared memory.
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
    g_tile<T, TR, kC>(d + S::b_dlo, p.dop + (size_t)p.rows * kC, kC, 0, r,
                      rs1);
  };
  g_tile<T, kWHc, 2 * kC>(s0, p.w1, 2 * kC, 0, h0, p.H);
  g_tile<T, kWHc, kC>(s0 + S::w_w2, p.w2t, kC, 0, h0, p.H);
  load_tile(0);
  sm90::cp_async_commit();

  // the warpgroup's dW1 (64 x 128) and dW2 (64 x 64) accumulators
  float w1a[64], w2a[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) w1a[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) w2a[i] = 0.f;
  const int wgi = warp >> 2;
  for (int i = 0; i < ntile; ++i) {
    sm90::cp_async_wait<0>();
    sm90::fence_async_smem();  // visible to wgmma
    __syncthreads();  // tile i landed; every warp left tile i - 1
    if (i + 1 < ntile) load_tile(i + 1);
    sm90::cp_async_commit();
    const uint32_t bo = S::w_buf + (i & 1) * S::buf;
    // a and dh for the warpgroup's 64 rows x 32 units, the warp's 16 rows
    const int rw = 16 * (warp & 3), hs = 32 * wgi;
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

  float* w1p = p.ws + (size_t)sl * 3 * kC * p.H;  // dW1 (H, 2C)
  float* w2p = w1p + (size_t)2 * kC * p.H;        // dW2 (C, H)
  // warp w of warpgroup wgi holds rows 16 (w % 4) + g (+ 8) of its 64-row
  // tiles, columns 8 j + 2 t (+ 1) at index 4 j (+ 2) (+ 1)
  const int wr = 16 * (warp & 3) + g;
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
// from nb on write W2^T (H, C) of T and, if w1t is given, W1^T (2C, H).
template <typename T>
__global__ void __launch_bounds__(kGThreads)
    mlp_bwd_prep_kernel(const T* __restrict__ w2, const T* __restrict__ gamma,
                        const T* __restrict__ dout,
                        const float* __restrict__ o, T* __restrict__ dop,
                        float* __restrict__ part, T* __restrict__ w2t,
                        int rows, int H, int nb, const T* __restrict__ w1,
                        T* __restrict__ w1t) {
  __shared__ float red[kGThreads / 32][2 * kC];
  const int tid = threadIdx.x;
  if ((int)blockIdx.x >= nb) {
    const int i = (blockIdx.x - nb) * kGThreads + tid;  // h C + c
    if (i < H * kC) {
      w2t[i] = w2[(size_t)(i % kC) * H + i / kC];
    } else if (w1t != nullptr && i < 3 * H * kC) {
      const int j = i - H * kC;  // c H + h
      w1t[j] = w1[(size_t)(j % H) * 2 * kC + j / H];
    }
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

// ---------------------------------------------------------------------------
// f32 backward: 3xTF32 on wgmma, three GEMM launches of one warp-specialized
// kernel (mlp_bwd_gemm_kernel), fed by TMA
// ---------------------------------------------------------------------------

constexpr int kGBM = 128;     // rows of a tile: 2 consumer warpgroups x 64
constexpr int kGBK = 32;      // a K step: 128 bytes of f32
constexpr int kGMaxStages = 8;
constexpr int kGA = kGBM * 128;          // a slot's raw A tile, 16 KB
constexpr int kGOut = 4 * 64 * 128;      // a warpgroup's da^T and h^T tiles

// The three products (f32, rows R, C = 128, H): the tiles' columns are H's
// hidden units in AH and W, d[src | msg]'s in DX.
//   AH: a = [src | msg] W1^T (K steps 0-7) and dh = dO' W2 (K steps 8-11,
//       W2^T from the prep kernel) for 128 rows x 64 units; the epilogue
//       writes da = dh gelu'(a) and h = gelu(a) transposed, da^T and h^T
//       (H, ld) f32, by TMA. A: the rows, K-major.
//   DX: d[src | msg] = da W1 (+ dout for src) for 128 rows x 128 columns of
//       2C, K = H (W1^T from the prep kernel). A: da^T's tiles, MN-major.
//   W:  dW1^T (2C x H) = [src | msg]^T da and dW2 (C x H) = dO'^T h over a
//       slice of kSlice rows (K), 128 columns of [src | msg] or dO' x 128
//       units a tile, into the slice's partials. A: the rows' tiles,
//       MN-major; B: da^T and h^T, K-major.
enum { kModeAH = 0, kModeDX = 1, kModeW = 2 };

// A mode's tile columns (AH holds two accumulators, a and dh, so 64) and
// shared memory: the mbarriers, AH's two warpgroups' staging, the ring of
// slots (the raw A tile, then B's hi and lo tiles); + 1 KB to round the
// base up to 1024 B
template <int MODE>
struct GemmTile {
  static constexpr int BN = MODE == kModeAH ? 64 : 128;
  static constexpr int B = BN * 128;  // a B hi or lo tile
  static constexpr int slot = kGA + 2 * B;
  static constexpr int out = MODE == kModeAH ? 2 * kGOut : 0;
  static constexpr int stages = MODE == kModeAH ? 5 : 4;
  static constexpr int smem = 1024 + out + stages * slot + 1024;
  static_assert(smem <= 232448 && stages <= kGMaxStages, "227 KB a block");
};

// tensor maps by mode (unused slots zero): A loads a[], B loads b[], the
// epilogue's stores out[]
struct GemmMaps {
  CUtensorMap a[3];   // AH: src, msg, dO' (32 x 128 boxes); DX: da^T (32 x
                      // 32); W: src, msg, dO' (32 x 32)
  CUtensorMap b[2];   // AH: W1, W2^T (32 x 64); DX: W1^T; W: da^T, h^T
                      // (32 x 128)
  CUtensorMap out[2]; // AH: da^T, h^T (32 x 64)
};

struct GemmArgs {
  const float* dout;
  float* dsrc;
  float* dmsg;
  float* ws;  // W: the slices' partials, slice s at s 3 C H: dW1, dW2
  int rows, H, m_tiles, n_tiles, tiles;
};

// W's tiles of one slice: 3 row tiles (src's and msg's columns of dW1^T,
// dO''s of dW2) x ceil(H / 128) unit tiles (H is a multiple of 64: the
// last may be half past H, read as TMA's zeros and not stored)
inline __host__ __device__ int w_tiles_a_slice(int H) {
  constexpr int bn = GemmTile<kModeW>::BN;
  return 3 * ((H + bn - 1) / bn);
}

// a tile's K steps
template <int MODE>
__device__ __forceinline__ int gemm_ksteps(const GemmArgs& p, int t) {
  if (MODE == kModeAH) return (2 * kC + kC) / kGBK;
  if (MODE == kModeDX) return p.H / kGBK;
  const int sl = t / w_tiles_a_slice(p.H);
  const int n = min(kSlice, p.rows - sl * kSlice);
  return (n + kGBK - 1) / kGBK;
}

// The producer's first thread: K step s of tile t into the slot at sa (its
// raw A tile, then B's raw tile into the lo tile), bytes on bar
template <int MODE>
__device__ __forceinline__ void gemm_issue(const GemmMaps& mp,
                                           const GemmArgs& p, int t, int s,
                                           uint32_t sa, uint32_t bar) {
  using G = GemmTile<MODE>;
  sm90::mbar_expect_tx(bar, kGA + G::B);
  const uint32_t sb = sa + kGA + G::B;
  if (MODE == kModeAH) {
    const int r0 = (t / p.n_tiles) * kGBM, u0 = (t % p.n_tiles) * G::BN;
    const int src = s < 4 ? 0 : s < 8 ? 1 : 2;
    sm90::tma_load_3d(sa, &mp.a[src], 32 * (s & 3), r0, 0, bar);
    if (s < 8)
      sm90::tma_load_3d(sb, &mp.b[0], 32 * s, u0, 0, bar);
    else
      sm90::tma_load_3d(sb, &mp.b[1], 32 * (s - 8), u0, 0, bar);
  } else if (MODE == kModeDX) {
    const int r0 = (t / p.n_tiles) * kGBM, n0 = (t % p.n_tiles) * G::BN;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sm90::tma_load_3d(sa + 4096 * i, &mp.a[0], r0 + 32 * i, 32 * s, 0, bar);
    sm90::tma_load_3d(sb, &mp.b[0], 32 * s, n0, 0, bar);
  } else {
    const int per = w_tiles_a_slice(p.H), sl = t / per, i0 = t % per;
    const int mt = i0 % 3, u0 = (i0 / 3) * G::BN;
    const int r = sl * kSlice + kGBK * s;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      sm90::tma_load_3d(sa + 4096 * i, &mp.a[mt], 32 * i, r, 0, bar);
    sm90::tma_load_3d(sb, &mp.b[mt == 2], r, u0, 0, bar);
  }
}

// A fragments of the K step's 4 k8 steps from the slot's raw A tile at sa
// for the warp's rows m = 64 wg + 16 warp + g (+ 8), k slot t the K index
// 2 t of the k8 step and slot t + 4 index 2 t + 1 (B's split relabels its
// K the same way), split into hi bits and lo. K-major (AH): row m's 32 K
// values as 128 swizzled bytes; MN-major (DX, W): four 4 KB boxes of 32 K
// rows x 32 m, m's box m / 32 (both conflict-free)
template <bool KMAJOR>
__device__ __forceinline__ void gemm_frags(uint32_t sa, int m, int t,
                                           uint32_t (&ah)[kGBK / 8][4],
                                           uint32_t (&al)[kGBK / 8][4]) {
#pragma unroll
  for (int j = 0; j < kGBK / 8; ++j) {
    uint32_t x[4];
    if (KMAJOR) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = m + 8 * h;
        uint2 v;
        asm volatile("ld.shared.v2.u32 {%0, %1}, [%2];\n"
                     : "=r"(v.x), "=r"(v.y)
                     : "r"(sa + r * 128 + (((2 * j + (t >> 1)) ^ (r & 7)) << 4) +
                           8 * (t & 1)));
        x[h] = v.x;
        x[2 + h] = v.y;
      }
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m + 8 * (e & 1), k = 8 * j + 2 * t + (e >> 1);
        asm volatile("ld.shared.u32 %0, [%1];\n"
                     : "=r"(x[e])
                     : "r"(sa + (r >> 5) * 4096 + k * 128 +
                           ((((r & 31) >> 2) ^ (k & 7)) << 4) + 4 * (r & 3)));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[j][e] = sm90::tf32_hi_bits(x[e]);
      al[j][e] = sm90::tf32_lo_of_hi(ah[j][e]);
    }
  }
}

// A K step's products: part = A (the fragments) times the slot's B (hi at
// sb, lo at sb + the tile's bytes) over its 4 k8 steps, 3xTF32 from zero;
// issued and committed
template <int BN>
__device__ __forceinline__ void gemm_group(float (&part)[BN / 2], uint32_t sb,
                                           const uint32_t (&ah)[kGBK / 8][4],
                                           const uint32_t (&al)[kGBK / 8][4]) {
  sm90::wg_fence();
#pragma unroll
  for (int j = 0; j < kGBK / 8; ++j) {
    const uint64_t dh = sm90::desc_sw128(sb + 32 * j, 16, 1024);
    sm90::WgTf32<BN>::mma(part, ah[j], dh, j > 0);
    sm90::WgTf32<BN>::mma(part, ah[j],
                          sm90::desc_sw128(sb + BN * 128 + 32 * j, 16, 1024),
                          1);
    sm90::WgTf32<BN>::mma(part, al[j], dh, 1);
  }
  sm90::wg_commit();
}

// One launch of the f32 backward's products (MODE above). 384 threads:
// warpgroups 0, 1 consume (warpgroup wg owns a tile's rows 64 wg ..), 2
// produces (setmaxnreg 40 / 232); min(tiles, SMs) persistent blocks walk
// the tiles b, b + gridDim.x, ... (AH and DX: the column tile fastest, so
// a row tile's rows stay in L2; W: slice by slice, the three row tiles of
// a unit tile together). K step q of the block goes to slot q % stages:
// raw mbarrier (the TMA bytes), full (the 128 producer threads, once B's
// raw tile is split into hi and lo in place, its K relabelled within each
// 8 as the A fragments read it), empty (lane 0 of each consumer warp). A
// is split in registers as it is read (gemm_frags); a K step's 4 k8 steps
// x 3 products run from zero into a part set, which is waited for and
// added in f32 (the tensor core's adds truncate; a group in flight across
// the loop would make ptxas serialize the wgmmas, C7514), the two
// warpgroups overlapping each other.
template <int MODE, bool TANH>
__global__ void __launch_bounds__(kFThreads, 1)
    mlp_bwd_gemm_kernel(const __grid_constant__ GemmMaps mp,
                        const GemmArgs p) {
  using G = GemmTile<MODE>;
  constexpr int BN = G::BN, stages = G::stages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = sm90::smem_u32(smem);
  const uint32_t ring = s0 + 1024 + G::out;
  const int tid = threadIdx.x;
  auto raw = [&](int st) { return s0 + 8 * st; };
  auto full = [&](int st) { return s0 + 8 * (kGMaxStages + st); };
  auto empty = [&](int st) { return s0 + 8 * (2 * kGMaxStages + st); };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(raw(st), 1);
      sm90::mbar_init(full(st), 128);
      sm90::mbar_init(empty(st), 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer
    sm90::setmaxnreg_dec<40>();
    const int pt = tid - 256;
    int it = blockIdx.x, is = 0, n_is = gemm_ksteps<MODE>(p, it);
    auto issue = [&](int q) {  // the next K step's loads (the first thread)
      const int st = q % stages;
      gemm_issue<MODE>(mp, p, it, is, ring + st * G::slot, raw(st));
      if (++is == n_is) {
        is = 0;
        it += gridDim.x;
        if (it < p.tiles) n_is = gemm_ksteps<MODE>(p, it);
      }
    };
    int total = 0;  // this block's K steps
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
      total += gemm_ksteps<MODE>(p, t);
    if (pt == 0 && total > 0) issue(0);
    for (int q = 0; q < total; ++q) {
      if (q + 1 < total) {
        if (q + 1 >= stages)  // every producer thread waits: warps converged
          sm90::mbar_wait(empty((q + 1) % stages), ((q + 1) / stages - 1) & 1);
        if (pt == 0) issue(q + 1);
      }
      const int st = q % stages;
      sm90::mbar_wait(raw(st), (q / stages) & 1);
      unsigned char* hi = smem + (ring - s0) + st * G::slot + kGA;
      unsigned char* lo = hi + G::B;
      // row n, K 8 c .. 8 c + 7 (chunks 2c, 2c + 1 at c' ^ (n & 7)): slots
      // 0-3 take K 0, 2, 4, 6, slots 4-7 K 1, 3, 5, 7
#pragma unroll
      for (int i = pt; i < BN * 4; i += 128) {
        const int n = i % BN, c = i / BN;
        const uint32_t oa = n * 128 + (((2 * c) ^ (n & 7)) << 4);
        const uint32_t ob = n * 128 + (((2 * c + 1) ^ (n & 7)) << 4);
        const uint4 ra = *reinterpret_cast<const uint4*>(lo + oa);
        const uint4 rb = *reinterpret_cast<const uint4*>(lo + ob);
        uint4 xa = make_uint4(ra.x, ra.z, rb.x, rb.z), ha;
        uint4 xb = make_uint4(ra.y, ra.w, rb.y, rb.w), hb;
        sm90::split_tf32_4(xa, ha);
        sm90::split_tf32_4(xb, hb);
        *reinterpret_cast<uint4*>(hi + oa) = ha;
        *reinterpret_cast<uint4*>(hi + ob) = hb;
        *reinterpret_cast<uint4*>(lo + oa) = xa;
        *reinterpret_cast<uint4*>(lo + ob) = xb;
      }
      sm90::fence_async_smem();  // the split tiles, to wgmma
      sm90::mbar_arrive(full(st));
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, wtid = tid & 127;
  const int m = 64 * wg + 16 * warp + g;  // the lane's first row of a tile
  float part[BN / 2];
  uint32_t ah[kGBK / 8][4], al[kGBK / 8][4];
  // K step q into acc
  auto kstep = [&](float (&acc)[BN / 2], int q) {
    const int st = q % stages;
    const uint32_t sa = ring + st * G::slot;
    sm90::mbar_wait(raw(st), (q / stages) & 1);
    sm90::mbar_wait(full(st), (q / stages) & 1);
    gemm_frags<MODE == kModeAH>(sa, m, t4, ah, al);
    gemm_group<BN>(part, sa + kGA, ah, al);
    sm90::wg_wait<0>();
    sm90::fence_regs(part);
    f_add(acc, part, false);
    if (lane == 0) sm90::mbar_arrive(empty(st));
    __syncwarp();
  };
  auto zero = [](float (&x)[BN / 2]) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) x[i] = 0.f;
  };
  float acc[BN / 2], acc2[BN / 2];  // AH: a, dh; else acc
  int q = 0;
  int passes = 0;
  for (int t = blockIdx.x; t < p.tiles; t += gridDim.x) {
    const int ks = gemm_ksteps<MODE>(p, t);
    zero(acc);
    if (MODE == kModeAH) {
      zero(acc2);
#pragma unroll 1
      for (int s = 0; s < 8; ++s, ++q) kstep(acc, q);
#pragma unroll 1
      for (int s = 8; s < ks; ++s, ++q) kstep(acc2, q);
    } else {
#pragma unroll 1
      for (int s = 0; s < ks; ++s, ++q) kstep(acc, q);
    }

    // lane (g, t4) holds rows m, m + 8 (h) x columns 8 j + 2 t4 + e of the
    // tile at index 4 j + 2 h + e
    if (MODE == kModeAH) {
      const int r0 = (t / p.n_tiles) * kGBM, u0 = (t % p.n_tiles) * BN;
      unsigned char* out = smem + 1024 + wg * kGOut;
      if (passes > 0) {  // the last tile's stores have read the staging
        if (wtid == 0) sm90::bulk_wait_read<0>();
        sm90::named_sync(1 + wg, 128);
      }
      // da^T then h^T, each two 32-row boxes (64 units x 128 B, swizzled)
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float x = acc[i];
            const float da = acc2[i] * gelu_grad<TANH>(x);
            const float hv = gelu_fwd<float, TANH>(x);
            const int lr = 16 * warp + g + 8 * h, u = 8 * j + 2 * t4 + e;
            const uint32_t o = (lr >> 5) * 8192 + u * 128 +
                               ((((lr & 31) >> 2) ^ (u & 7)) << 4) +
                               4 * (lr & 3);
            *reinterpret_cast<float*>(out + o) = da;
            *reinterpret_cast<float*>(out + 2 * 8192 + o) = hv;
          }
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);
      if (wtid == 0) {
        const uint32_t so = s0 + 1024 + wg * kGOut;
#pragma unroll
        for (int b = 0; b < 2; ++b) {
          const int r = r0 + 64 * wg + 32 * b;
          sm90::tma_store_3d(&mp.out[0], so + 8192 * b, r, u0, 0);
          sm90::tma_store_3d(&mp.out[1], so + 2 * 8192 + 8192 * b, r, u0, 0);
        }
        sm90::bulk_commit();
      }
      ++passes;
    } else if (MODE == kModeDX) {
      const int r0 = (t / p.n_tiles) * kGBM, n0 = (t % p.n_tiles) * BN;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + m + 8 * h;
        if (row >= p.rows) continue;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int col = n0 + 8 * j + 2 * t4;
          float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (col < kC) {
            const float2 d = load2(p.dout + (size_t)row * kC + col);
            store2(p.dsrc + (size_t)row * kC + col, v0 + d.x, v1 + d.y);
          } else {
            store2(p.dmsg + (size_t)row * kC + col - kC, v0, v1);
          }
        }
      }
    } else {
      const int per = w_tiles_a_slice(p.H), sl = t / per, i0 = t % per;
      const int mt = i0 % 3, u0 = (i0 / 3) * BN;
      float* w1p = p.ws + (size_t)sl * 3 * kC * p.H;  // dW1 (H, 2C)
      float* w2p = w1p + (size_t)2 * kC * p.H;        // dW2 (C, H)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = m + 8 * h;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
          const int u = u0 + 8 * j + 2 * t4;
          const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
          if (u >= p.H) continue;
          if (mt < 2) {
            w1p[(size_t)u * 2 * kC + kC * mt + c] = v0;
            w1p[(size_t)(u + 1) * 2 * kC + kC * mt + c] = v1;
          } else {
            store2(w2p + (size_t)c * p.H + u, v0, v1);
          }
        }
      }
    }
  }
  if (MODE == kModeAH && wtid == 0) sm90::bulk_wait<0>();
}

// the elements between rows of da^T and h^T (H, ld): rows rounded up to 4
// (a TMA stride is a multiple of 16 bytes)
inline long long bwd_f32_ld(int rows) { return (rows + 3LL) / 4 * 4; }

// The f32 launcher's statics have internal linkage (see sm90.cuh's
// TmaMapCache): the variants tool loads several builds of this file.
namespace {

// A tensor map of a (rows, d) f32 matrix (ld elements a row) for boxes of
// 32 columns x box_rows rows, from the source's cache: a backward call
// takes 14, mostly of the same weights and of scratch the allocator hands
// out again
inline int gmap(CUtensorMap* m, const void* base, int d, int rows,
                int box_rows, long long ld = 0) {
  return sm90::tma_maps<128>().get(
      {(long long)base, d, rows, box_rows, ld, 0, 0, 0}, m,
      [&](CUtensorMap* mm) {
        return sm90::tma_map_f32(mm, base, d, rows, 1, box_rows, ld);
      });
}

template <bool TANH>
int launch_mlp_bwd_f32(const void* src, const void* msg, const void* w1,
                       const void* w2, const void* gamma, const void* dout,
                       const void* o_in, void* dsrc, void* dmsg, void* dw1,
                       void* dw2, void* dgb, void* dop, void* w2t, void* part,
                       void* ws, void* da, void* hid, int rows, int H,
                       cudaStream_t stream) {
  const int nb = bwd_ln_blocks(rows), ns = bwd_slices(rows);
  const long long ld = bwd_f32_ld(rows);
  float* w1t = static_cast<float*>(w2t) + (size_t)H * kC;  // (2C, H)
  mlp_bwd_prep_kernel<float><<<nb + (3 * H * kC + kGThreads - 1) / kGThreads,
                               kGThreads, 0, stream>>>(
      static_cast<const float*>(w2), static_cast<const float*>(gamma),
      static_cast<const float*>(dout), static_cast<const float*>(o_in),
      static_cast<float*>(dop), static_cast<float*>(part),
      static_cast<float*>(w2t), rows, H, nb, static_cast<const float*>(w1),
      w1t);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  // the device's SM count and the three kernels' shared-memory attribute,
  // once a device
  static int sm_count[sm90::kMaxDevices] = {};
  int dev = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= sm90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sm_count[dev] == 0) {
    err = (int)cudaFuncSetAttribute(
        mlp_bwd_gemm_kernel<kModeAH, TANH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, GemmTile<kModeAH>::smem);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(
          mlp_bwd_gemm_kernel<kModeDX, TANH>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          GemmTile<kModeDX>::smem);
    if (err == 0)
      err = (int)cudaFuncSetAttribute(
          mlp_bwd_gemm_kernel<kModeW, TANH>,
          cudaFuncAttributeMaxDynamicSharedMemorySize,
          GemmTile<kModeW>::smem);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&sm_count[dev],
                                        cudaDevAttrMultiProcessorCount, dev);
    if (err != 0) return err;
  }
  const int sms = sm_count[dev];
  GemmArgs a{static_cast<const float*>(dout), static_cast<float*>(dsrc),
             static_cast<float*>(dmsg), static_cast<float*>(ws), rows, H,
             0, 0, 0};
  auto run = [&](auto kernel, int bytes, const GemmMaps& maps, int m_tiles,
                 int n_tiles, int tiles) {
    a.m_tiles = m_tiles, a.n_tiles = n_tiles, a.tiles = tiles;
    const int grid = tiles < sms ? tiles : sms;
    kernel<<<grid, kFThreads, bytes, stream>>>(maps, a);
    return (int)cudaGetLastError();
  };
  constexpr int nah = GemmTile<kModeAH>::BN, nb2 = GemmTile<kModeDX>::BN;
  const int mt = (rows + kGBM - 1) / kGBM;
  GemmMaps mp = {};
  // AH: a and dh, then da^T and h^T
  err = gmap(&mp.a[0], src, kC, rows, kGBM);
  if (err == 0) err = gmap(&mp.a[1], msg, kC, rows, kGBM);
  if (err == 0) err = gmap(&mp.a[2], dop, kC, rows, kGBM);
  if (err == 0) err = gmap(&mp.b[0], w1, 2 * kC, H, nah);
  if (err == 0) err = gmap(&mp.b[1], w2t, kC, H, nah);
  if (err == 0) err = gmap(&mp.out[0], da, rows, H, nah, ld);
  if (err == 0) err = gmap(&mp.out[1], hid, rows, H, nah, ld);
  if (err == 0)
    err = run(mlp_bwd_gemm_kernel<kModeAH, TANH>, GemmTile<kModeAH>::smem, mp,
              mt, H / nah, mt * (H / nah));
  if (err != 0) return err;
  // DX: d[src | msg] = da W1
  mp = {};
  err = gmap(&mp.a[0], da, rows, H, 32, ld);
  if (err == 0) err = gmap(&mp.b[0], w1t, H, 2 * kC, nb2);
  if (err == 0)
    err = run(mlp_bwd_gemm_kernel<kModeDX, TANH>, GemmTile<kModeDX>::smem, mp,
              mt, 2 * kC / nb2, mt * (2 * kC / nb2));
  if (err != 0) return err;
  // W: the weight gradients' slice partials
  mp = {};
  err = gmap(&mp.a[0], src, kC, rows, 32);
  if (err == 0) err = gmap(&mp.a[1], msg, kC, rows, 32);
  if (err == 0) err = gmap(&mp.a[2], dop, kC, rows, 32);
  if (err == 0) err = gmap(&mp.b[0], da, rows, H, nb2, ld);
  if (err == 0) err = gmap(&mp.b[1], hid, rows, H, nb2, ld);
  if (err == 0)
    err = run(mlp_bwd_gemm_kernel<kModeW, TANH>, GemmTile<kModeW>::smem, mp,
              0, 0, ns * w_tiles_a_slice(H));
  if (err != 0) return err;
  mlp_bwd_reduce_kernel<float><<<2 * kC + (3 * kC * H + 127) / 128, 128, 0,
                                 stream>>>(
      static_cast<const float*>(part), nb, static_cast<const float*>(ws), ns,
      H, static_cast<float*>(dgb), static_cast<float*>(dw1),
      static_cast<float*>(dw2));
  return (int)cudaGetLastError();
}

}  // namespace

template <bool TANH>
int launch_mlp_bwd_bf16(const void* src, const void* msg, const void* w1,
                        const void* w2, const void* gamma, const void* dout,
                        const void* o_in, void* dsrc, void* dmsg, void* dw1,
                        void* dw2, void* dgb, void* dop, void* w2t,
                        void* part, void* ws, void*, void*, int rows, int H,
                        cudaStream_t stream) {
  using T = bf16;
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
      rows, H, nb, nullptr, nullptr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  BwdArgs<T> a{static_cast<const T*>(src), static_cast<const T*>(msg),
               static_cast<const T*>(w1),  static_cast<const T*>(w2t),
               static_cast<const T*>(dout), static_cast<const T*>(dop),
               static_cast<T*>(dsrc),      static_cast<T*>(dmsg),
               static_cast<float*>(ws),    rows, H, nwb};
  kb<<<nwb + nrb, kGThreads, S::launch_bytes, stream>>>(a);
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
// lo), w2t (H, C) of dtype (f32: then W1^T (2C, H)), part (the LayerNorm
// backward's blocks, 2C) f32, ws (the weight blocks' row slices, 3 C H)
// f32, da and hid (H, ld) f32 for dtype 0 (da^T and h^T, ld = rows rounded
// up to 4) and 0 (none) for 1. Returns a cudaError_t value (0 = ok).
extern "C" int keep_mlp_fused_bwd_scratch(int rows, int C, int H, int dtype,
                                          long long* bytes) {
  using namespace keep;
  if (C != kC || rows < 1 || H < 64 || H % 64 != 0 || dtype < 0 || dtype > 1)
    return (int)cudaErrorInvalidValue;
  const long long r = rows, h = H, es = dtype == 0 ? 4 : 2;
  bytes[0] = (dtype == 0 ? 1 : 2) * r * kC * es;
  bytes[1] = (dtype == 0 ? 3 : 1) * h * kC * es;
  bytes[2] = (long long)bwd_ln_blocks(rows) * 2 * kC * 4;
  bytes[3] = (long long)bwd_slices(rows) * 3 * kC * h * 4;
  bytes[4] = bytes[5] = dtype == 0 ? bwd_f32_ld(rows) * h * 4 : 0;
  return 0;
}

// The backward of keep_mlp_fused (arguments as there; beta has no part in
// it). dout, dsrc, dmsg: (rows, C) of dtype; o_in: (rows, C) f32, the
// forward's o_out. Outputs of dtype: dw1 (H, 2C), dw2 (C, H), dgb (2, C)
// (dgamma, dbeta). Scratch: dop, w2t, part, ws, da and hid of the bytes
// keep_mlp_fused_bwd_scratch gives (da and hid null for dtype 1). Five
// kernels on the stream in f32 (the LayerNorm's backward, then
// mlp_bwd_gemm_kernel's AH, DX and W launches, the reduce), three in bf16
// (row and weight blocks in one grid); returns a cudaError_t value (0 =
// ok).
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
    return approximate ? go(launch_mlp_bwd_f32<true>)
                       : go(launch_mlp_bwd_f32<false>);
  if (dtype == 1)
    return approximate ? go(launch_mlp_bwd_bf16<true>)
                       : go(launch_mlp_bwd_bf16<false>);
  return (int)cudaErrorInvalidValue;
}
