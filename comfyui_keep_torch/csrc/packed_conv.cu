// Phase-packed convolution for Hopper (sm_90a): a stride-1 convolution of
// at most 2 x 2 taps over an NHWC input with zero pads of at most one cell,
//   out[b, i, j, n] = sum_{ty < kh, tx < kw} x[b, i + ty - pt, j + tx - pl, :]
//                                            . w[ty, tx, :, n]  [+ bias[n]]
// (reads outside the input are zeros), x NHWC, w HWIO, out NHWC in x's
// dtype, the products and the bias summed in f32 and rounded once. With
// mask_c > 0 (Cout = 4 mask_c) the output is a parity-1 phase-packed map
// and its pad half-cells are zeroed after the bias: phase block q =
// n / mask_c (qy = q / 2, qx = q % 2) of the first cell row if qy = 0, of
// the last if qy = 1, of the first cell column if qx = 0, of the last if
// qx = 1 (ops/phase_pack.py:_mask_parity1_).
//
// Replaces tools/_prof_packedconv.py: pallas_conv (body _kernel), the VALID
// 2x2 convolution of a parity-1 phase-packed tensor as four shifted GEMMs
// summed in f32 (called without bias and mask, the kernel computes exactly
// that function). One kernel serves every packed convolution of
// ops/phase_pack.py: 2x2 with pad 1 (parity 0 -> 1, the packed upconv) and
// VALID (parity 1 -> 0, the packed downsample); it also takes the one-tap
// and one-sided-pad forms of the JAX package's deeper packed levels, which
// the port does not run. On the 512-level path of one frame: (257, 257,
// 256) -> (256, 256, 256) and its mirror (256, 256, 256) -> (257, 257, 256),
// 34.4 GFLOP each; the LQ encoder batches 20 frames (a 20 x 257 x 257 x 256
// input: offsets are 64-bit).
//
// What bounds it on the H100: at the (257, 257, 256) shape 34.4 GFLOP
// against 68 MB moved, ~500 flop/byte, so the arithmetic bounds it: 35 us
// in bf16 on the tensor cores (989 TFLOP/s), 0.51 ms in f32 on the CUDA
// cores (67 TFLOP/s). Every K step of the implicit GEMM is a shifted patch
// of the input, so the input is re-read from L2 once per tap (4x), and each
// block reads the whole weight slab (512 KB) from L2.
//
// bf16 (the packed path's dtype), Cin and Cout multiples of 8:
// packed_conv_wgmma_kernel, an implicit GEMM with M = output pixels, N =
// Cout, K = taps x Cin, on a persistent grid (one block an SM) whose blocks
// walk the (M, N) tiles, M fastest within an N slice so that the slice's
// weights stay in L2. A block is two consumer warpgroups and a producer
// warpgroup (setmaxnreg 40 / 232) whose first thread keeps a ring of
// stages filled by TMA, one full and one empty mbarrier a stage, with no
// block-wide barrier in the K loop. A K step is 64 input channels of one
// tap: the input patch comes as one im2col load (tma_map_im2col_bf16) of
// BM consecutive output pixels, crossing rows and images, each read at its
// pixel shifted by the tap; the map's bounding box (lower corner (-pt,
// -pl), upper (pb - kh + 1, pr - kw + 1)) makes the traversal the output
// grid, and TMA zero-fills the pad cells, the pixels past the end and the
// channels past Cin, so no thread computes an address. The weight slice
// comes as BN / 64 boxes of 64 K-rows x 64 outputs of HWIO seen as (taps,
// Cin, Cout), N-major and 128-byte swizzled as wgmma's B reads it (read as
// K-major it was no faster: tools/torch_k6_variants.py b_k_major). Each
// consumer warpgroup multiplies its 64 MI pixels by the slice with wgmma
// m64nBNk16 (accumulators in registers) and releases the stage of the step
// before once that step's products are done. At the end of a tile it adds
// the bias, zeroes a masked pixel's pad half-cells, rounds into a staging
// tile and stores it by TMA, and goes on to the next tile, whose first
// stages the producer has already loaded. The tile (BM = 128 MI pixels x
// BN outputs) and the ring's depth come from
// ops/kernels.py:packed_conv_plan: 128 x 256 where Cout allows (256 x 128
// at Cout = 128, where a 256-wide tile would be half zero columns),
// narrower where the call's tiles would leave the card's last round mostly
// idle. What bounds it now (tools/torch_k6_variants.py, PERF.md): the K
// loop runs at ~75-80 % of the tensor cores' rate (an epilogue that only
// sums the accumulators), and the epilogue and its TMA stores add ~15 % at
// K6's own shape and cannot overlap the products (the accumulators fill
// the registers). Sharing each weight slice across a 2- or 4-block cluster
// by multicast TMA was no faster and is not kept.
//
// bf16 with Cin or Cout not a multiple of 8 (the encoder's first conv, Cin
// 12, and the generator's last, Cout 12; TMA needs 16-byte strides):
// packed_conv_cp_async_kernel. A block of 2
// warpgroups owns 128 pixels x BN channels (BN 256 when Cout > 64, else
// 64) and walks K in steps of 64 input channels of one tap through a
// 4-stage ring filled by 8-byte cp.async with zero-fill from every thread,
// two block barriers a step, wgmma m64nBNk16 as above, and an epilogue
// through shared memory.
//
// f32 (the f32 packed KEEP forward, processor(float32, phase512=True)):
// packed_conv_tf32_kernel<BN>, the same persistent warp-specialized implicit
// GEMM on the TF32 tensor cores as 3xTF32 (x = hi + lo, hi x rounded to
// TF32 by split_tf32, a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, f32 sums),
// bound by 3 x 34.4 GFLOP at 495 TFLOP/s, 0.21 ms at K6's own shape (the
// FMA pipe's 67 TFLOP/s gives 0.51). TF32 wgmma reads shared memory only
// K-major: the patch is (channels innermost), the HWIO weights are not, so
// a first kernel (packed_conv_w_split_kernel) writes the weights as (taps,
// Cout, Cin) hi and lo planes (1 MB -> 2 MB at K6's shape), which TMA loads
// as they are: 0.1-7.4 % of a call's device time (the producer's threads
// transposing raw HWIO slices into the ring instead left it 3 stages deep
// at 128 x 128 and took 1.8x the time: PERF.md). A K step is 32 input
// channels (128 bytes) of one tap: the producer's first thread loads the
// raw patch by im2col TMA (tma_map_im2col_f32; the zero fill pads K at Cin
// = 12) and the weights' hi and lo tiles. Each consumer warpgroup reads
// its rows of the patch by ldmatrix and splits them in registers (the producer splitting the patch
// in shared memory instead left the ring 3 stages deep at 128 x 128 and
// took 1.65x the time: PERF.md), runs the K step's 4 k8 steps x 3 products
// (m64nBNk8, A from registers, B in shared memory) from zero into a part
// set, waits for it and adds it in f32 to its accumulators (the tensor
// core's adds truncate, so no sum longer than a K step runs through them),
// the two warpgroups overlapping each other. The epilogue (bias, parity-1
// mask, TMA store in 32-column passes, clipped at Cout) is the bf16
// kernel's in f32. The tile (BM = 128 x BN 128, 64 or 32) and the ring's
// depth come from ops/kernels.py:packed_conv_plan.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

struct PcGeom {
  int Hi, Wi, Cin, Cout, kh, kw, pt, pl, Ho, Wo;
  long long M;  // B * Ho * Wo output pixels
};

// the fused epilogue: bias (Cout values, f32 or bf16, or none) and the
// parity-1 mask (mask_c > 0)
struct PcEpi {
  const void* bias;
  int bias_bf16;
  int mask_c;
};

__device__ __forceinline__ float pc_bias(const PcEpi& e, int n) {
  if (e.bias == nullptr) return 0.f;
  return e.bias_bf16 ? __bfloat162float(static_cast<const bf16*>(e.bias)[n])
                     : static_cast<const float*>(e.bias)[n];
}

// pad-cell flags of output pixel p: bit 0 first row, 1 last row, 2 first
// column, 3 last column (0 without a mask)
__device__ __forceinline__ int pc_edges(const PcGeom& g, const PcEpi& e,
                                        long long p) {
  if (e.mask_c <= 0) return 0;
  const long long rem = p % ((long long)g.Ho * g.Wo);
  const int i = (int)(rem / g.Wo), j = (int)(rem % g.Wo);
  return (i == 0) | ((i == g.Ho - 1) << 1) | ((j == 0) << 2) |
         ((j == g.Wo - 1) << 3);
}

// whether output channel n (< 4 mask_c) of a pixel with these edge flags is
// a pad half-cell; its phase block q = n / mask_c by comparisons
__device__ __forceinline__ bool pc_masked(int edges, int mask_c, int n) {
  const bool q1 = n >= mask_c, qy = n >= 2 * mask_c, q3 = n >= 3 * mask_c;
  const bool qx = q1 ^ qy ^ q3;
  return ((edges & 1) && !qy) || ((edges & 2) && qy) ||
         ((edges & 4) && !qx) || ((edges & 8) && qx);
}

// ---------------------------------------------------------------------------
// bf16, channels not a multiple of 8: cp.async and wgmma
// ---------------------------------------------------------------------------

constexpr int kWgRows = 128;     // output pixels per block (2 x 64)
constexpr int kWgK = 64;         // input channels per K step
constexpr int kWgStages = 4;
constexpr int kWgAhead = kWgStages - 1;  // K steps loading ahead
constexpr int kWgThreads = 256;
constexpr int kNoRow = -(1 << 29);  // row_i of a pixel past the end

template <int BN>
struct WgLayout {
  static constexpr int a_bytes = kWgRows * kWgK * 2;  // 16 KB, 128-B rows
  static constexpr int b_bytes = kWgK * BN * 2;       // BN/64 blocks of 8 KB
  static constexpr int stage = a_bytes + b_bytes;
  static constexpr int out_row = BN * 2;              // epilogue tile row
  static constexpr int ring = kWgStages * stage;
  static constexpr int bytes = ring + 1024;           // + 1024-B alignment
  static_assert(kWgRows * out_row <= ring, "epilogue tile overlays the ring");
};

// x: (B, Hi, Wi, Cin); w: (kh, kw, Cin, Cout); out: (B, Ho, Wo, Cout).
// Grid (ceil(M / 128), ceil(Cout / BN)), 256 threads.
template <int BN>
__global__ void __launch_bounds__(kWgThreads, 1)
    packed_conv_cp_async_kernel(const bf16* __restrict__ x,
                                const bf16* __restrict__ w,
                                bf16* __restrict__ out, PcGeom g, PcEpi e) {
  using Lay = WgLayout<BN>;
  constexpr int NACC = BN / 2;  // f32 accumulators per thread
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ long long row_pix[kWgRows];  // pixel index of (i - pt, j - pl)
  __shared__ int row_i[kWgRows], row_j[kWgRows];  // i - pt (kNoRow), j - pl
  __shared__ int row_edges[kWgRows];  // pc_edges of each output pixel
  __shared__ float bias_s[BN];

  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 B
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7;
  const long long m0 = (long long)blockIdx.x * kWgRows;
  const int n0 = blockIdx.y * BN;
  if (tid < kWgRows) {
    const long long p = m0 + tid;
    const long long hw = (long long)g.Ho * g.Wo;
    const long long rem = p % hw;
    const int i = (int)(rem / g.Wo) - g.pt, j = (int)(rem % g.Wo) - g.pl;
    row_pix[tid] = ((p / hw) * g.Hi + i) * g.Wi + j;
    row_i[tid] = p < g.M ? i : kNoRow;
    row_j[tid] = j;
    row_edges[tid] = pc_edges(g, e, p);
  }
  for (int i = tid; i < BN; i += kWgThreads)
    bias_s[i] = n0 + i < g.Cout ? pc_bias(e, n0 + i) : 0.f;
  __syncthreads();

  const int cblocks = (g.Cin + kWgK - 1) / kWgK;
  const int steps = g.kh * g.kw * cblocks;
  const bool a16 = (g.Cin & 7) == 0, b16 = (g.Cout & 7) == 0;

  // 16-byte copies: each thread's 4 input rows and weight column are fixed
  // across K steps, so their geometry stays in registers
  constexpr int kAPer = kWgRows * (kWgK / 8) / kWgThreads;  // 4
  const int a_c = (tid & 7) * 8;                           // channel in step
  long long a_pix[kAPer];
  int a_i[kAPer], a_j[kAPer];
  uint32_t a_dst[kAPer];
#pragma unroll
  for (int k = 0; k < kAPer; ++k) {
    const int r = (tid >> 3) + 32 * k;
    a_pix[k] = row_pix[r];
    a_i[k] = row_i[r];
    a_j[k] = row_j[r];
    a_dst[k] = sm90::swz(r, tid & 7, 128);
  }
  constexpr int kBCpr = BN / 8;                 // 16-byte chunks per K row
  constexpr int kBRpi = kWgThreads / kBCpr;     // K rows per pass
  const int b_nn = (tid % kBCpr) * 8, b_kr = tid / kBCpr;
  const uint32_t b_dst = (b_nn >> 6) * (kWgK * 128) +
                         sm90::swz(b_kr, (b_nn & 63) >> 3, 128);
  const bool b_col_ok = n0 + b_nn < g.Cout;

  // K step s: input channels c0 .. c0 + 63 of tap s % taps -> stage s % 4
  // (consecutive taps read the same channels of neighbouring pixels, which
  // the L1 still holds)
  const int taps = g.kh * g.kw;
  auto load_step = [&](int s) {
    const int tap = s % taps, c0 = (s / taps) * kWgK;
    const int ty = tap / g.kw, tx = tap % g.kw;
    const uint32_t sa = base + (s % kWgStages) * Lay::stage;
    const uint32_t sb = sa + Lay::a_bytes;
    // input patch: 128 pixels x 64 channels, K-major 128-byte rows
    if (a16) {
      const long long shift = (long long)ty * g.Wi + tx;
      const bool c_ok = c0 + a_c < g.Cin;
#pragma unroll
      for (int k = 0; k < kAPer; ++k) {
        const int ii = a_i[k] + ty, jj = a_j[k] + tx;
        const bool ok = c_ok && ii >= 0 && ii < g.Hi && jj >= 0 && jj < g.Wi;
        const bf16* src = ok ? x + (a_pix[k] + shift) * g.Cin + c0 + a_c : x;
        sm90::cp_async16_l1(sa + a_dst[k], src, ok ? 16 : 0);
      }
    } else {  // 8-byte copies, Cin a multiple of 4
      for (int i = tid; i < kWgRows * (kWgK / 4); i += kWgThreads) {
        const int r = i / (kWgK / 4), cc = (i % (kWgK / 4)) * 4;
        const int ii = row_i[r] + ty, jj = row_j[r] + tx;
        const bool ok = c0 + cc < g.Cin && ii >= 0 && ii < g.Hi && jj >= 0 &&
                        jj < g.Wi;
        const bf16* src =
            ok ? x + (row_pix[r] + (long long)ty * g.Wi + tx) * g.Cin + c0 + cc
               : x;
        sm90::cp_async8(sa + sm90::swz(r, cc >> 3, 128) + (cc & 7) * 2, src,
                        ok ? 8 : 0);
      }
    }
    // weight slice: 64 input channels x BN outputs, N-major: 64-wide output
    // blocks of 64 K rows x 128 B, 8 KB apart
    const bf16* wt = w + ((size_t)tap * g.Cin + c0) * g.Cout + n0;
    if (b16) {
#pragma unroll
      for (int k = 0; k < kWgK / kBRpi; ++k) {
        const int kr = b_kr + kBRpi * k;
        const bool ok = b_col_ok && c0 + kr < g.Cin;
        const bf16* src = ok ? wt + (size_t)kr * g.Cout + b_nn : w;
        sm90::cp_async16(sb + b_dst + kBRpi * k * 128, src, ok ? 16 : 0);
      }
    } else {  // 8-byte copies, Cout a multiple of 4
      for (int i = tid; i < kWgK * (BN / 4); i += kWgThreads) {
        const int kr = i / (BN / 4), nn = (i % (BN / 4)) * 4;
        const bool ok = c0 + kr < g.Cin && n0 + nn < g.Cout;
        const bf16* src = ok ? wt + (size_t)kr * g.Cout + nn : w;
        sm90::cp_async8(sb + (nn >> 6) * (kWgK * 128) +
                            sm90::swz(kr, (nn & 63) >> 3, 128) + (nn & 7) * 2,
                        src, ok ? 8 : 0);
      }
    }
  };

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

#pragma unroll
  for (int s = 0; s < kWgAhead; ++s) {
    if (s < steps) load_step(s);
    sm90::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    sm90::cp_async_wait<kWgAhead - 1>();  // this thread's copies of step s
    sm90::fence_async_smem();
    __syncthreads();  // every copy of step s is visible to wgmma
    const uint32_t sa = base + (s % kWgStages) * Lay::stage;
    const uint32_t sb = sa + Lay::a_bytes;
    sm90::wg_fence();
#pragma unroll
    for (int k = 0; k < kWgK / 16; ++k)
      sm90::Wgmma<BN>::mma(
          acc, sm90::desc_sw128(sa + wg * 64 * 128 + 32 * k, 16, 1024),
          sm90::desc_sw128(sb + 16 * 128 * k, kWgK * 128, 1024));
    sm90::wg_commit();
    // step s multiplies while step s + 3 loads into step s - 1's stage,
    // once both warpgroups are done with it
    sm90::wg_wait<1>();
    __syncthreads();
    if (s + kWgAhead < steps) load_step(s + kWgAhead);
    sm90::cp_async_commit();
  }
  sm90::wg_wait<0>();
  sm90::fence_regs(acc);
  sm90::cp_async_wait<0>();
  __syncthreads();  // the epilogue tile overlays the ring

  // accumulator (warp w of the warpgroup, lane l): rows 16w + l/4 (+ 8),
  // columns 8j + 2(l % 4) + {0, 1}
  const int lane = tid & 31;
  const int wr = 64 * wg + 16 * ((tid >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int cl = 8 * j + 2 * (lane & 3);
    const float b0 = bias_s[cl], b1 = bias_s[cl + 1];
    const float v[4] = {acc[4 * j] + b0, acc[4 * j + 1] + b1,
                        acc[4 * j + 2] + b0, acc[4 * j + 3] + b1};
    *reinterpret_cast<uint32_t*>(smem + sm90::swz(wr, j, Lay::out_row) +
                                 4 * (lane & 3)) = sm90::pack_bf16(v[0], v[1]);
    *reinterpret_cast<uint32_t*>(smem + sm90::swz(wr + 8, j, Lay::out_row) +
                                 4 * (lane & 3)) = sm90::pack_bf16(v[2], v[3]);
  }
  __syncthreads();
  // 16-byte (8-byte) coalesced stores; a masked pixel's pad half-cells
  // are zeroed on the way (zero before or after the rounding is the same)
  const int ow = b16 ? 8 : 4;  // channels per store
  for (int i = tid; i < kWgRows * (BN / ow); i += kWgThreads) {
    const int r = i / (BN / ow), nn = (i % (BN / ow)) * ow;
    const long long p = m0 + r;
    if (p >= g.M || n0 + nn >= g.Cout) continue;
    unsigned char* s =
        smem + sm90::swz(r, nn >> 3, Lay::out_row) + (nn & 7) * 2;
    const int edges = row_edges[r];
    if (edges) {
      bf16* sv = reinterpret_cast<bf16*>(s);
      for (int c = 0; c < ow; ++c)
        if (pc_masked(edges, e.mask_c, n0 + nn + c))
          sv[c] = __float2bfloat16(0.f);
    }
    bf16* d = out + p * g.Cout + n0 + nn;
    if (b16)
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(s);
    else
      *reinterpret_cast<uint2*>(d) = *reinterpret_cast<const uint2*>(s);
  }
}

template <int BN>
int launch_packed_conv_cp_async(const void* x, const void* w, void* out,
                                const PcGeom& g, const PcEpi& e,
                                cudaStream_t stream) {
  const long long mt = (g.M + kWgRows - 1) / kWgRows;
  if (mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      packed_conv_cp_async_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WgLayout<BN>::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)mt, (g.Cout + BN - 1) / BN);
  packed_conv_cp_async_kernel<BN>
      <<<grid, kWgThreads, WgLayout<BN>::bytes, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<bf16*>(out), g, e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, channels multiples of 8: TMA (im2col) into an mbarrier ring,
// warp-specialized wgmma, persistent
// ---------------------------------------------------------------------------

constexpr int kTThreads = 384;   // 2 consumer warpgroups and a producer
constexpr int kTMaxStages = 8;
constexpr int kTSmemLimit = 232448;  // a block's shared memory on the H100
constexpr int kTOutBytes = 2 * 64 * 64 * 2;  // a warpgroup's two 64 x 64 tiles

template <int MI, int BN>
struct TmaTile {
  static constexpr int BM = 128 * MI;             // pixels: 2 x 64 MI
  static constexpr int a_bytes = BM * kWgK * 2;   // BM K-major 128-B rows
  static constexpr int b_bytes = kWgK * BN * 2;   // BN / 64 blocks of 8 KB
  static constexpr int stage = a_bytes + b_bytes;
  // the mbarriers' 1 KB, the two warpgroups' epilogue staging, the ring; +
  // 1 KB to round the base up to the swizzle's 1024 B
  // (ops/kernels.py:packed_conv_plan counts the same)
  static constexpr int bytes(int stages) {
    return 2048 + 2 * kTOutBytes + stages * stage;
  }
};

// the phase blocks (bit q) a pixel with these edge flags (pc_edges) zeroes:
// blocks 0, 1 on the first cell row, 2, 3 on the last, 0, 2 on the first
// cell column, 1, 3 on the last
__device__ __forceinline__ int pc_zero_blocks(int edges) {
  return ((edges & 1) ? 0x3 : 0) | ((edges & 2) ? 0xC : 0) |
         ((edges & 4) ? 0x5 : 0) | ((edges & 8) ? 0xA : 0);
}

// One staging pass of the TMA kernel's epilogue: the 64 outputs from column
// 64 sub of a warpgroup's accumulator (rows 16 warp + lane / 4 (+ 8)) plus
// the bias (BIAS 0: none, 1: f32, 2: bf16, read at column n, clamped to
// Cout: what lies past Cout is never stored) and, with MASK, the phase
// blocks zero[h] of row h zeroed (a pair of columns lies in one block:
// mask_c is even at Cout % 8 == 0), rounded once into a staging tile of 64
// 128-byte rows in the 128-byte swizzle. Every decision is made once for
// the pass, so the unrolled loop is straight-line code (per-element
// branches on the bias and the mask made this loop the kernel's largest
// cost after the products: PERF.md)
template <int BN, int BIAS, bool MASK>
__device__ __forceinline__ void tma_stage_pass(const float (&acc)[BN / 2],
                                               int sub, int n0,
                                               const int (&zero)[2],
                                               const PcGeom& g,
                                               const PcEpi& e, int warp,
                                               int lane,
                                               unsigned char* tile) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const int j = 8 * sub + jj;
    const int n = n0 + 8 * j + 2 * (lane & 3);
    const int nb = n < g.Cout ? n : 0;
    float b0 = 0.f, b1 = 0.f;
    if (BIAS == 1) {
      const float* b = static_cast<const float*>(e.bias) + nb;
      b0 = __ldg(b), b1 = __ldg(b + 1);
    } else if (BIAS == 2) {
      const bf16* b = static_cast<const bf16*>(e.bias) + nb;
      b0 = __bfloat162float(b[0]), b1 = __bfloat162float(b[1]);
    }
    const int q = (n >= e.mask_c) + (n >= 2 * e.mask_c) + (n >= 3 * e.mask_c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (MASK && ((zero[h] >> q) & 1)) v0 = v1 = 0.f;
      *reinterpret_cast<uint32_t*>(tile + r * 128 + ((jj ^ (r & 7)) << 4) +
                                   4 * (lane & 3)) = sm90::pack_bf16(v0, v1);
    }
  }
}

// x: (B, Hi, Wi, Cin) through the im2col map tx (BM pixels a box); w:
// (kh, kw, Cin, Cout) through the tiled map tw over (taps, Cin, Cout), 64 x
// 64 boxes; out: (B, Ho, Wo, Cout) through the tiled map to over (M, Cout),
// 64 x 64 boxes. 384 threads, min(tiles, SMs) blocks: block b takes tiles
// b, b + gridDim.x, ..., tile t the pixels from (t % m_tiles) BM and the
// outputs from (t / m_tiles) BN. Warpgroup wg < 2 owns pixels 64 (wg MI +
// mi) .. of the tile (mi < MI), its warp w the 16 from there + 16 w, each
// lane (g, t4 = lane / 4, lane % 4) rows g and g + 8 of those at columns 8
// j + 2 t4 + {0, 1} (acc[mi][4 j + 2 h + {0, 1}], row g + 8 h). Stage st:
// full mbarrier s0 + 8 st (the producer's arrival and the stage's TMA
// bytes), empty s0 + 8 (kTMaxStages + st) (lane 0 of each consumer warp,
// once the warp's products of the stage are done).
template <int MI, int BN>
__global__ void __launch_bounds__(kTThreads, 1)
    packed_conv_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                             const __grid_constant__ CUtensorMap tw,
                             const __grid_constant__ CUtensorMap to,
                             PcGeom g, PcEpi e, int stages, int m_tiles,
                             int tiles) {
  using T = TmaTile<MI, BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t s0 = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s0 - sm90::smem_u32(smem_raw));
  const uint32_t ring = s0 + 1024 + 2 * kTOutBytes;
  const int tid = threadIdx.x;
  const int taps = g.kh * g.kw;
  const int ksteps = taps * ((g.Cin + kWgK - 1) / kWgK);

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(s0 + 8 * st, 1);
      sm90::mbar_init(s0 + 8 * (kTMaxStages + st), 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: its registers go to the consumers
    sm90::setmaxnreg_dec<40>();
    if (tid == 256) {
      const long long hw = (long long)g.Ho * g.Wo;
      int st = 0, ph = 0, used = 0;  // slot, its wrap parity, slots filled
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long m0 = (long long)(t % m_tiles) * T::BM;
        const int n0 = (t / m_tiles) * BN;
        // the tile's first pixel as the traversal's start: (j - pl, i - pt)
        // of image m0 / hw
        const int img = (int)(m0 / hw), rem = (int)(m0 % hw);
        const int h0 = rem / g.Wo - g.pt, w0 = rem % g.Wo - g.pl;
        for (int s = 0; s < ksteps; ++s) {
          // taps innermost: a K step's neighbour reads the same channels
          // of neighbouring pixels, which L2 still holds
          const int tap = s % taps, c0 = (s / taps) * kWgK;
          if (used >= stages)
            sm90::mbar_wait(s0 + 8 * (kTMaxStages + st), ph ^ 1);
          const uint32_t full = s0 + 8 * st;
          const uint32_t sa = ring + st * T::stage;
          sm90::mbar_expect_tx(full, T::stage);
          sm90::tma_load_im2col_4d(sa, &tx, c0, w0, h0, img,
                                   (uint16_t)(tap % g.kw),
                                   (uint16_t)(tap / g.kw), full);
#pragma unroll
          for (int b = 0; b < BN / 64; ++b)
            sm90::tma_load_3d(sa + T::a_bytes + b * kWgK * 128, &tw,
                              n0 + 64 * b, c0, tap, full);
          ++used;
          if (++st == stages) st = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wtid = tid & 127;
  unsigned char* stage_out = smem + 1024 + wg * kTOutBytes;
  const uint32_t stage_out_s = s0 + 1024 + wg * kTOutBytes;
  int passes = 0;  // staging passes so far: the tiles alternate
  // a stage goes back to the producer: lane 0 of each warp arrives once
  // the warp's products of it are done
  auto release = [&](int st) {
    if (lane == 0) sm90::mbar_arrive(s0 + 8 * (kTMaxStages + st));
    __syncwarp();
  };
  float acc[MI][BN / 2];
  int st = 0, ph = 0, prev = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int s = 0; s < ksteps; ++s) {
      sm90::mbar_wait(s0 + 8 * st, ph);
      const uint32_t sa = ring + st * T::stage;
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < kWgK / 16; ++k)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          sm90::Wgmma<BN>::mma(
              acc[mi],
              sm90::desc_sw128(sa + (wg * MI + mi) * 64 * 128 + 32 * k, 16,
                               1024),
              sm90::desc_sw128(sa + T::a_bytes + 16 * 128 * k, kWgK * 128,
                               1024),
              s > 0 || k > 0);
      sm90::wg_commit();
      // step s multiplies while the stage of step s - 1 goes back
      sm90::wg_wait<1>();
      if (s > 0) release(prev);
      prev = st;
      if (++st == stages) st = 0, ph ^= 1;
    }
    sm90::wg_wait<0>();
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) sm90::fence_regs(acc[mi]);
    release(prev);

    // epilogue: bias in f32, a masked pixel's pad half-cells zeroed,
    // rounded once into one of the warpgroup's two staging tiles (64 rows x
    // 64 outputs, tma_stage_pass), each stored by TMA (rows past M and
    // outputs past Cout are not written) while the next pass fills the
    // other tile and the warpgroup goes on to the next tile
    const long long m0 = (long long)(t % m_tiles) * T::BM;
    const int n0 = (t / m_tiles) * BN;
    const int bias_kind = e.bias == nullptr ? 0 : e.bias_bf16 ? 2 : 1;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const long long r0 = m0 + (wg * MI + mi) * 64;  // the pass's rows
      int zero[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        zero[h] = pc_zero_blocks(
            pc_edges(g, e, r0 + 16 * warp + (lane >> 2) + 8 * h));
      // the masked pass only for a warp that holds an edge pixel (a few of
      // a tile's 16-pixel warps)
      const bool masked = __any_sync(0xffffffffu, zero[0] | zero[1]);
#pragma unroll
      for (int sub = 0; sub < BN / 64; ++sub) {
        const int buf = passes & 1;
        if (passes >= 2) {  // the store two passes back has read this tile
          if (wtid == 0) sm90::bulk_wait_read<1>();
          sm90::named_sync(1 + wg, 128);
        }
#define KEEP_STAGE(BIAS, MASK)                                            \
  tma_stage_pass<BN, BIAS, MASK>(acc[mi], sub, n0, zero, g, e, warp, lane, \
                                 stage_out + buf * 8192)
        if (masked) {
          if (bias_kind == 0) KEEP_STAGE(0, true);
          else if (bias_kind == 1) KEEP_STAGE(1, true);
          else KEEP_STAGE(2, true);
        } else {
          if (bias_kind == 0) KEEP_STAGE(0, false);
          else if (bias_kind == 1) KEEP_STAGE(1, false);
          else KEEP_STAGE(2, false);
        }
#undef KEEP_STAGE
        sm90::fence_async_smem();
        sm90::named_sync(1 + wg, 128);
        if (wtid == 0) {
          sm90::tma_store_3d(&to, stage_out_s + buf * 8192, n0 + 64 * sub,
                             (int)r0, 0);
          sm90::bulk_commit();
        }
        ++passes;
      }
    }
  }
  if (wtid == 0) sm90::bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma, fed by TMA (im2col), the patch split on chip,
// warp-specialized, persistent
// ---------------------------------------------------------------------------

constexpr int kFK = 32;  // input channels a K step: 128 bytes of f32

template <int BN>
struct F32Tile {
  static constexpr int BM = 128;            // pixels: 2 x 64
  static constexpr int a_bytes = BM * 128;  // the raw patch
  static constexpr int b_bytes = BN * 128;  // the weights' hi or lo tile
  // a stage: the raw patch, the weights' hi and lo tiles; the rest as
  // TmaTile's (ops/kernels.py counts the same)
  static constexpr int stage = a_bytes + 2 * b_bytes;
  static constexpr int bytes(int stages) {
    return 2048 + 2 * kTOutBytes + stages * stage;
  }
};

// w (taps, Cin, Cout) f32 -> wt (2, taps, Cout, Cin): the TF32 hi plane,
// then the lo plane (split_tf32), each K-major as TF32 wgmma reads it.
// Block (32, 8) transposes a 32 x 32 tile through shared memory; grid
// (ceil(Cout / 32), ceil(Cin / 32), taps)
__global__ void __launch_bounds__(256)
    packed_conv_w_split_kernel(const float* __restrict__ w,
                               float* __restrict__ wt, int cin, int cout) {
  __shared__ float t[32][33];
  const int tap = blockIdx.z, c0 = blockIdx.y * 32, n0 = blockIdx.x * 32;
  const int taps = gridDim.z;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int ci = c0 + i, co = n0 + threadIdx.x;
    t[i][threadIdx.x] = ci < cin && co < cout
                            ? w[((size_t)tap * cin + ci) * cout + co]
                            : 0.f;
  }
  __syncthreads();
  const size_t plane = (size_t)taps * cout * cin;
  for (int i = threadIdx.y; i < 32; i += 8) {
    const int co = n0 + i, ci = c0 + threadIdx.x;
    if (co >= cout || ci >= cin) continue;
    uint32_t hi, lo;
    sm90::split_tf32(__float_as_uint(t[threadIdx.x][i]), hi, lo);
    const size_t o = ((size_t)tap * cout + co) * cin + ci;
    wt[o] = __uint_as_float(hi);
    wt[plane + o] = __uint_as_float(lo);
  }
}

// A K step of a consumer warpgroup, issued and committed: part = its 64
// pixels' patch times the weights' BN outputs (hi, lo) over the step's 32
// channels, 4 k8 steps of a_hi b_hi + a_hi b_lo + a_lo b_hi, from zero. The
// warp's 16 patch rows (from rw) are read by ldmatrix (an 8 x 8 b16 matrix
// is 8 rows of 4 f32: the TF32 A fragment's) into ah as hi bits (x +
// 0x1000, which the tensor core reads as x rounded to TF32) and al (lo),
// which must stay as they are until the group is waited for
template <int BN>
__device__ __forceinline__ void f32_kstep(float (&part)[BN / 2], uint32_t sa,
                                          int rw, int lane,
                                          uint32_t (&ah)[kFK / 8][4],
                                          uint32_t (&al)[kFK / 8][4]) {
  using T = F32Tile<BN>;
  const uint32_t bhi = sa + T::a_bytes, blo = bhi + T::b_bytes;
  const int mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int k = 0; k < kFK / 8; ++k) {
    uint32_t a[4];
    sm90::ldsm_x4(sa + sm90::am_at(rw + (mi & 1) * 8 + mr, 2 * k + (mi >> 1),
                                   T::BM),
                  a);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[k][e] = sm90::tf32_hi_bits(a[e]);
      al[k][e] = sm90::tf32_lo_of_hi(ah[k][e]);
    }
  }
  sm90::wg_fence();
#pragma unroll
  for (int k = 0; k < kFK / 8; ++k) {
    const uint64_t dbh = sm90::desc_sw128(bhi + 32 * k, 16, 1024);
    sm90::WgTf32<BN>::mma(part, ah[k], dbh, k > 0);
    sm90::WgTf32<BN>::mma(part, ah[k],
                          sm90::desc_sw128(blo + 32 * k, 16, 1024), 1);
    sm90::WgTf32<BN>::mma(part, al[k], dbh, 1);
  }
  sm90::wg_commit();
}

// One staging pass of the f32 epilogue: the 32 outputs from column 32 sub
// of a warpgroup's accumulator plus the bias (BIAS: f32, read at column n,
// clamped to Cout) and, with MASK, the phase blocks zero[h] of row h zeroed
// (each column's block on its own: mask_c may be odd in f32), into a
// staging tile of 64 128-byte rows in the 128-byte swizzle
template <int BN, bool BIAS, bool MASK>
__device__ __forceinline__ void f32_stage_pass(const float (&acc)[BN / 2],
                                               int sub, int n0,
                                               const int (&zero)[2],
                                               const PcGeom& g,
                                               const PcEpi& e, int warp,
                                               int lane,
                                               unsigned char* tile) {
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = 4 * sub + jj;
    const int n = n0 + 8 * j + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (BIAS) {
      const float* b = static_cast<const float*>(e.bias) + (n < g.Cout ? n : 0);
      b0 = __ldg(b), b1 = __ldg(b + 1);
    }
    const int q0 = (n >= e.mask_c) + (n >= 2 * e.mask_c) + (n >= 3 * e.mask_c);
    const int q1 = (n + 1 >= e.mask_c) + (n + 1 >= 2 * e.mask_c) +
                   (n + 1 >= 3 * e.mask_c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * warp + (lane >> 2) + 8 * h;
      float v0 = acc[4 * j + 2 * h] + b0;
      float v1 = acc[4 * j + 2 * h + 1] + b1;
      if (MASK && ((zero[h] >> q0) & 1)) v0 = 0.f;
      if (MASK && ((zero[h] >> q1) & 1)) v1 = 0.f;
      *reinterpret_cast<float2*>(
          tile + r * 128 + (((2 * jj + ((lane >> 1) & 1)) ^ (r & 7)) << 4) +
          8 * (lane & 1)) = make_float2(v0, v1);
    }
  }
}

// x: (B, Hi, Wi, Cin) f32 through the im2col map tx (128 pixels a box); the
// split weights (2, taps, Cout, Cin) through the tiled map tw over (2 taps,
// Cout, Cin), 32 x BN boxes (hi at tap, lo at taps + tap); out: (B, Ho, Wo,
// Cout) through the tiled map to over (M, Cout), 32 x 64 boxes. 384
// threads, min(tiles, SMs) blocks walking the tiles as
// packed_conv_wgmma_kernel's (M fastest within an N slice); warpgroup wg <
// 2 owns pixels 64 wg .. of a tile, its accumulators as there. K step q of
// the block goes to stage q % stages: full mbarrier s0 + 8 st (the
// producer's arrival and the step's TMA bytes), empty s0 + 8 (kTMaxStages
// + st) (lane 0 of each consumer warp, once the warp's products of the
// step have landed).
template <int BN>
__global__ void __launch_bounds__(kTThreads, 1)
    packed_conv_tf32_kernel(const __grid_constant__ CUtensorMap tx,
                            const __grid_constant__ CUtensorMap tw,
                            const __grid_constant__ CUtensorMap to, PcGeom g,
                            PcEpi e, int stages, int m_tiles, int tiles) {
  using T = F32Tile<BN>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t s0 = (sm90::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (s0 - sm90::smem_u32(smem_raw));
  const uint32_t ring = s0 + 1024 + 2 * kTOutBytes;
  const int tid = threadIdx.x;
  const int taps = g.kh * g.kw;
  const int ksteps = taps * ((g.Cin + kFK - 1) / kFK);
  auto full = [&](int st) { return s0 + 8 * st; };
  auto empty = [&](int st) { return s0 + 8 * (kTMaxStages + st); };

  if (tid == 0) {
    for (int st = 0; st < stages; ++st) {
      sm90::mbar_init(full(st), 1);
      sm90::mbar_init(empty(st), 8);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer: its registers go to the consumers
    sm90::setmaxnreg_dec<40>();
    if (tid == 256) {
      const long long hw = (long long)g.Ho * g.Wo;
      int q = 0;  // the block's K step
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long m0 = (long long)(t % m_tiles) * T::BM;
        const int n0 = (t / m_tiles) * BN;
        const int img = (int)(m0 / hw), rem = (int)(m0 % hw);
        const int h0 = rem / g.Wo - g.pt, w0 = rem % g.Wo - g.pl;
        for (int s = 0; s < ksteps; ++s, ++q) {
          const int st = q % stages;
          const int tap = s % taps, c0 = (s / taps) * kFK;
          if (q >= stages)
            sm90::mbar_wait(empty(st), (q / stages - 1) & 1);
          const uint32_t slot = ring + st * T::stage;
          sm90::mbar_expect_tx(full(st), T::stage);
          sm90::tma_load_im2col_4d(slot, &tx, c0, w0, h0, img,
                                   (uint16_t)(tap % g.kw),
                                   (uint16_t)(tap / g.kw), full(st));
          sm90::tma_load_3d(slot + T::a_bytes, &tw, c0, n0, tap, full(st));
          sm90::tma_load_3d(slot + T::a_bytes + T::b_bytes, &tw, c0, n0,
                            taps + tap, full(st));
        }
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int wtid = tid & 127;
  unsigned char* stage_out = smem + 1024 + wg * kTOutBytes;
  const uint32_t stage_out_s = s0 + 1024 + wg * kTOutBytes;
  int passes = 0;  // staging passes so far: the two tiles alternate
  auto release = [&](int q) {
    if (lane == 0) sm90::mbar_arrive(empty(q % stages));
    __syncwarp();
  };
  // K step by K step: its products into part from zero, waited for and
  // added to acc in f32 (no group stays in flight across the loop, which
  // would make ptxas serialize the wgmmas, C7514); the two warpgroups
  // overlap each other
  float acc[BN / 2], part[BN / 2];
  uint32_t ah[kFK / 8][4], al[kFK / 8][4];
  int q = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    for (int s = 0; s < ksteps; ++s, ++q) {
      const int st = q % stages;
      sm90::mbar_wait(full(st), (q / stages) & 1);
      f32_kstep<BN>(part, ring + st * T::stage, 64 * wg + 16 * warp, lane, ah,
                    al);
      sm90::wg_wait<0>();
      sm90::fence_regs(part);
      sm90::f_add(acc, part, s == 0);
      release(q);
    }

    // epilogue: as packed_conv_wgmma_kernel's, in 32-column passes
    const long long m0 = (long long)(t % m_tiles) * T::BM;
    const int n0 = (t / m_tiles) * BN;
    const long long r0 = m0 + wg * 64;
    int zero[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      zero[h] =
          pc_zero_blocks(pc_edges(g, e, r0 + 16 * warp + (lane >> 2) + 8 * h));
    const bool masked = __any_sync(0xffffffffu, zero[0] | zero[1]);
    const bool bias = e.bias != nullptr;
#pragma unroll
    for (int sub = 0; sub < BN / 32; ++sub) {
      const int buf = passes & 1;
      if (passes >= 2) {  // the store two passes back has read this tile
        if (wtid == 0) sm90::bulk_wait_read<1>();
        sm90::named_sync(1 + wg, 128);
      }
      unsigned char* tile = stage_out + buf * 8192;
      if (masked) {
        if (bias)
          f32_stage_pass<BN, true, true>(acc, sub, n0, zero, g, e, warp, lane,
                                         tile);
        else
          f32_stage_pass<BN, false, true>(acc, sub, n0, zero, g, e, warp,
                                          lane, tile);
      } else {
        if (bias)
          f32_stage_pass<BN, true, false>(acc, sub, n0, zero, g, e, warp,
                                          lane, tile);
        else
          f32_stage_pass<BN, false, false>(acc, sub, n0, zero, g, e, warp,
                                           lane, tile);
      }
      sm90::fence_async_smem();
      sm90::named_sync(1 + wg, 128);
      if (wtid == 0) {
        sm90::tma_store_3d(&to, stage_out_s + buf * 8192, n0 + 32 * sub,
                           (int)r0, 0);
        sm90::bulk_commit();
      }
      ++passes;
    }
  }
  if (wtid == 0) sm90::bulk_wait<0>();
}

// The launchers' statics have internal linkage (see sm90.cuh's
// TmaMapCache): two builds of this file in one process
// (tools/torch_k6_check.py --root) must not share them.
namespace {

template <int MI, int BN>
int launch_packed_conv_tma(const void* x, const void* w, void* out, int B,
                           const PcGeom& g, const PcEpi& e, int stages,
                           cudaStream_t stream) {
  using T = TmaTile<MI, BN>;
  const int bytes = T::bytes(stages);
  if (stages < 2 || stages > kTMaxStages || bytes > kTSmemLimit ||
      (g.Cin & 7) || (g.Cout & 7) || g.M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long m_tiles = (g.M + T::BM - 1) / T::BM;
  const long long tiles = m_tiles * ((g.Cout + BN - 1) / BN);
  // the input's bounding box: the base pixel (i - pt, j - pl) of every
  // output pixel
  const int taps = g.kh * g.kw;
  const int lo_w = -g.pl, lo_h = -g.pt;
  const int hi_w = g.Wo - g.Wi - g.pl, hi_h = g.Ho - g.Hi - g.pt;
  CUtensorMap tx, tw, to;
  int err = sm90::tma_maps().get(
      {(long long)x, B, g.Hi, g.Wi, g.Cin, T::BM,
       (lo_w + 2) | (lo_h + 2) << 4 | (hi_w + 2) << 8 | (hi_h + 2) << 12, 0},
      &tx, [&](CUtensorMap* m) {
        return sm90::tma_map_im2col_bf16(m, x, B, g.Hi, g.Wi, g.Cin, T::BM,
                                         lo_w, lo_h, hi_w, hi_h);
      });
  if (err == 0)
    err = sm90::tma_maps().get(
        {(long long)w, g.Cout, g.Cin, taps, kWgK, 0, 0, 1}, &tw,
        [&](CUtensorMap* m) {
          return sm90::tma_map_bf16(m, w, g.Cout, g.Cin, taps, kWgK);
        });
  if (err == 0)
    err = sm90::tma_maps().get(
        {(long long)out, g.Cout, g.M, 1, 64, 0, 0, 2}, &to,
        [&](CUtensorMap* m) {
          return sm90::tma_map_bf16(m, out, g.Cout, (int)g.M, 1, 64);
        });
  if (err != 0) return err;
  // the device's SM count and the kernel's shared-memory attribute, once a
  // device
  static int sms[sm90::kMaxDevices] = {};
  int dev = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= sm90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = (int)cudaFuncSetAttribute(
        packed_conv_wgmma_kernel<MI, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmemLimit);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&sms[dev],
                                        cudaDevAttrMultiProcessorCount, dev);
    if (err != 0) return err;
  }
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  packed_conv_wgmma_kernel<MI, BN><<<grid, kTThreads, bytes, stream>>>(
      tx, tw, to, g, e, stages, (int)m_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

template <int BN>
int launch_packed_conv_tf32(const void* x, const void* w, void* out,
                            void* wt, int B, const PcGeom& g, const PcEpi& e,
                            int stages, cudaStream_t stream) {
  using T = F32Tile<BN>;
  const int bytes = T::bytes(stages);
  if (stages < 2 || stages > kTMaxStages || bytes > kTSmemLimit ||
      wt == nullptr || (e.bias != nullptr && e.bias_bf16) ||
      g.M > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int taps = g.kh * g.kw;
  const dim3 sgrid((g.Cout + 31) / 32, (g.Cin + 31) / 32, taps);
  packed_conv_w_split_kernel<<<sgrid, dim3(32, 8), 0, stream>>>(
      static_cast<const float*>(w), static_cast<float*>(wt), g.Cin, g.Cout);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  const long long m_tiles = (g.M + T::BM - 1) / T::BM;
  const long long tiles = m_tiles * ((g.Cout + BN - 1) / BN);
  const int lo_w = -g.pl, lo_h = -g.pt;
  const int hi_w = g.Wo - g.Wi - g.pl, hi_h = g.Ho - g.Hi - g.pt;
  CUtensorMap tx, tw, to;
  err = sm90::tma_maps().get(
      {(long long)x, B, g.Hi, g.Wi, g.Cin, T::BM,
       (lo_w + 2) | (lo_h + 2) << 4 | (hi_w + 2) << 8 | (hi_h + 2) << 12, 3},
      &tx, [&](CUtensorMap* m) {
        return sm90::tma_map_im2col_f32(m, x, B, g.Hi, g.Wi, g.Cin, T::BM,
                                        lo_w, lo_h, hi_w, hi_h);
      });
  if (err == 0)
    err = sm90::tma_maps().get(
        {(long long)wt, g.Cin, g.Cout, 2 * taps, BN, 0, 0, 4}, &tw,
        [&](CUtensorMap* m) {
          return sm90::tma_map_f32(m, wt, g.Cin, g.Cout, 2 * taps, BN);
        });
  if (err == 0)
    err = sm90::tma_maps().get(
        {(long long)out, g.Cout, g.M, 1, 64, 0, 0, 5}, &to,
        [&](CUtensorMap* m) {
          return sm90::tma_map_f32(m, out, g.Cout, (int)g.M, 1, 64);
        });
  if (err != 0) return err;
  static int sms[sm90::kMaxDevices] = {};
  int dev = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  if (dev >= sm90::kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = (int)cudaFuncSetAttribute(
        packed_conv_tf32_kernel<BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kTSmemLimit);
    if (err == 0)
      err = (int)cudaDeviceGetAttribute(&sms[dev],
                                        cudaDevAttrMultiProcessorCount, dev);
    if (err != 0) return err;
  }
  const int grid = (int)(tiles < sms[dev] ? tiles : sms[dev]);
  packed_conv_tf32_kernel<BN><<<grid, kTThreads, bytes, stream>>>(
      tx, tw, to, g, e, stages, (int)m_tiles, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace keep

// a: B, Hi, Wi, Cin, Cout, kh, kw, pt, pb, pl, pr, bias_bf16, mask_c, dtype,
// route, bm, bn, stages. dtype: 0 = float32, 1 = bfloat16 (x, w and out).
// kh, kw in {1, 2}; pads in {0, 1}; Cin and Cout multiples of 4; x and w
// 16-byte aligned. bias: Cout values or null, bfloat16 if bias_bf16 else
// float32 (float32 for dtype 0); mask_c: 0, or the phase-block width with
// Cout = 4 mask_c. wt: for dtype 0, scratch of 2 kh kw Cin Cout f32 (the
// split weights), 16-byte aligned; else unused. The plan
// (ops/kernels.py:packed_conv_plan): route 0 = TMA (bf16, Cin and Cout
// multiples of 8; bm x bn in {128 x 256, 256 x 128, 128 x 128, 256 x 64,
// 128 x 64}, 2 .. 8 stages within the shared memory), 1 = cp.async (bf16;
// 128 x 256 or 128 x 64, 4 stages), 2 = 3xTF32 (f32; 128 x 128, 128 x 64 or
// 128 x 32, 3 .. 8 stages within the shared memory; two kernels: the
// weights' split, then the convolution). Returns a cudaError_t value (0 =
// ok; cudaErrorInvalidValue for a geometry or a plan the kernels do not
// take).
extern "C" int keep_packed_conv(const void* x, const void* w,
                                const void* bias, void* out, void* wt,
                                const int* a, void* stream) {
  const int B = a[0], Hi = a[1], Wi = a[2], Cin = a[3], Cout = a[4];
  const int kh = a[5], kw = a[6], pt = a[7], pb = a[8], pl = a[9], pr = a[10];
  const int bias_bf16 = a[11], mask_c = a[12], dtype = a[13], route = a[14];
  const int bm = a[15], bn = a[16], stages = a[17];
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PcGeom g;
  g.Hi = Hi; g.Wi = Wi; g.Cin = Cin; g.Cout = Cout; g.kh = kh; g.kw = kw;
  g.pt = pt; g.pl = pl;
  g.Ho = Hi + pt + pb - kh + 1;
  g.Wo = Wi + pl + pr - kw + 1;
  g.M = (long long)B * g.Ho * g.Wo;
  PcEpi e;
  e.bias = bias; e.bias_bf16 = bias_bf16; e.mask_c = mask_c;
  const bool pads_ok = pt >= 0 && pt <= 1 && pb >= 0 && pb <= 1 && pl >= 0 &&
                       pl <= 1 && pr >= 0 && pr <= 1;
  if (B < 1 || Hi < 1 || Wi < 1 || kh < 1 || kh > 2 || kw < 1 || kw > 2 ||
      !pads_ok || Cin < 4 || Cin % 4 != 0 || Cout < 4 || Cout % 4 != 0 ||
      g.Ho < 1 || g.Wo < 1 || mask_c < 0 || (mask_c > 0 && 4 * mask_c != Cout))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && route == 0) {
    if (bm == 128 && bn == 256)
      return launch_packed_conv_tma<1, 256>(x, w, out, B, g, e, stages, st);
    if (bm == 256 && bn == 128)
      return launch_packed_conv_tma<2, 128>(x, w, out, B, g, e, stages, st);
    if (bm == 128 && bn == 128)
      return launch_packed_conv_tma<1, 128>(x, w, out, B, g, e, stages, st);
    if (bm == 256 && bn == 64)
      return launch_packed_conv_tma<2, 64>(x, w, out, B, g, e, stages, st);
    if (bm == 128 && bn == 64)
      return launch_packed_conv_tma<1, 64>(x, w, out, B, g, e, stages, st);
  }
  if (dtype == 1 && route == 1 && bm == kWgRows && stages == kWgStages) {
    if (bn == 256) return launch_packed_conv_cp_async<256>(x, w, out, g, e, st);
    if (bn == 64) return launch_packed_conv_cp_async<64>(x, w, out, g, e, st);
  }
  if (dtype == 0 && route == 2 && bm == 128) {
    if (bn == 128)
      return launch_packed_conv_tf32<128>(x, w, out, wt, B, g, e, stages, st);
    if (bn == 64)
      return launch_packed_conv_tf32<64>(x, w, out, wt, B, g, e, stages, st);
    if (bn == 32)
      return launch_packed_conv_tf32<32>(x, w, out, wt, B, g, e, stages, st);
  }
  return (int)cudaErrorInvalidValue;
}
