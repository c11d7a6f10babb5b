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
// bf16 (the packed path's dtype): packed_conv_wgmma_kernel, an implicit
// GEMM with M = output pixels, N = Cout, K = taps x Cin. A block of 2
// warpgroups owns 128 pixels x BN channels (BN 256 when Cout > 64, so at
// the hot shapes each input patch is read once per tap; BN 64 for the
// narrow outputs) and walks K in steps of 64 input channels of one tap
// (128 bytes of bf16, one 128-byte swizzle row), channel block by channel
// block, the taps of a block in turn: a tap's patch is its neighbour's
// shifted by a pixel, so those copies go through L1 (cp.async.ca). Each
// step's 128 x 64 input patch and 64 x BN weight slice go through a
// 4-stage shared-memory ring filled by 16-byte cp.async with zero-fill
// (8-byte when Cin or Cout is not a multiple of 8), which serves the pad
// cells, the pixels past the end and the channels past Cin; three steps
// load ahead of the tensor cores. Each warpgroup multiplies its 64 pixels
// by the slice with wgmma m64nBNk16 (A K-major, B N-major as the HWIO
// weight lies, both 128-byte swizzled, accumulators in registers), then
// waits for its previous step only, so one step multiplies while the next
// loads. The epilogue adds the bias in f32, rounds once to bf16 into
// shared memory and writes 16-byte coalesced rows, zeroing a masked
// pixel's pad half-cells on the way, so a packed op is one launch with
// no separate bias add or mask zeroing. What bounds it now: the
// bytes each SM pulls from L2 per step (16 KB of patch, 32 KB of weights
// that every block re-reads), ~17 B/clock/SM at its own shape, which
// holds it near 35 % of the bf16 peak (~1.7x cuDNN's 2x2). Multicasting
// the weight slice across a 2-block cluster with TMA would halve the
// larger part.
//
// f32 (the f32 packed KEEP forward, processor(float32, phase512=True)):
// packed_conv_f32_kernel<128|64>, the same implicit GEMM on the FMA pipe,
// all f32 (no TF32), bound by its 67 TFLOP/s. A block of 8 warps owns 128
// pixels x BN channels (BN 128, or 64 when Cout <= 64), so at Cout = 256
// each input patch comes from L2 twice per tap. K steps of one tap x 32
// input channels go through a 4-stage ring filled by 16-byte cp.async with
// zero-fill (pad cells, pixels past the end, channels past Cin), three
// steps ahead, one barrier a step. Operand layouts: the input patch lies
// [pixel][channel] (K-contiguous, rows padded to 36 floats) and the HWIO
// weight slice [channel][output] (N-contiguous, unpadded), as they arrive.
// A lane owns 8 pixels x 8 outputs (two groups of 4 consecutive outputs,
// 64 apart; 8 x 4 at BN 64): per 4 channels it reads 8 float4 of the patch
// along K (a warp's 4 pixel rows fall in distinct banks, its 8 lanes of a
// row share the address) and, per channel, 2 float4 of the weight row (8
// lanes read 128 consecutive bytes): 16 shared loads per 256 FMAs, one
// wavefront each. The epilogue adds the bias in f32, zeroes a masked
// pixel's pad half-cells and stores 16 bytes a lane straight from the
// registers.
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
// bf16: wgmma implicit GEMM
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
    packed_conv_wgmma_kernel(const bf16* __restrict__ x,
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
int launch_packed_conv_bf16(const void* x, const void* w, void* out,
                            const PcGeom& g, const PcEpi& e,
                            cudaStream_t stream) {
  const long long mt = (g.M + kWgRows - 1) / kWgRows;
  if (mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      packed_conv_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WgLayout<BN>::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)mt, (g.Cout + BN - 1) / BN);
  packed_conv_wgmma_kernel<BN>
      <<<grid, kWgThreads, WgLayout<BN>::bytes, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<bf16*>(out), g, e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: register-tiled FMA implicit GEMM (no TF32)
// ---------------------------------------------------------------------------

constexpr int kPfRows = 128;          // output pixels per block
constexpr int kPfK = 32;              // input channels per K step
constexpr int kPfStages = 4;
constexpr int kPfAhead = kPfStages - 1;  // K steps loading ahead
constexpr int kPfThreads = 256;
constexpr int kPfLda = kPfK + 4;      // floats per staged pixel row

template <int BN>
struct PfLayout {
  static constexpr int a_bytes = 4 * kPfRows * kPfLda;  // 18,432
  static constexpr int b_bytes = 4 * kPfK * BN;         // 16,384 at BN 128
  static constexpr int stage = a_bytes + b_bytes;
  static constexpr int bytes = kPfStages * stage;       // 139,264 at BN 128
};

// x: (B, Hi, Wi, Cin); w: (kh, kw, Cin, Cout); out: (B, Ho, Wo, Cout).
// Grid (ceil(M / 128), ceil(Cout / BN)), 256 threads. Warp w = 4 wn + wm,
// lane 8 rg + cg: pixels 32 wm + rg + 4 r (r < 8) of the block against
// channels 32 wn + 4 cg + 64 q + e (q < BN / 64, e < 4).
template <int BN>
__global__ void __launch_bounds__(kPfThreads, 1)
    packed_conv_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           float* __restrict__ out, PcGeom g, PcEpi e) {
  using Lay = PfLayout<BN>;
  constexpr int NQ = BN / 64;  // float4 channel groups per lane
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ long long row_pix[kPfRows];  // pixel index of (i - pt, j - pl)
  __shared__ int row_i[kPfRows], row_j[kPfRows];  // i - pt (kNoRow), j - pl
  __shared__ int row_edges[kPfRows];  // pc_edges of each output pixel
  __shared__ float bias_s[BN];

  const uint32_t base = sm90::smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wn = warp >> 2, rg = lane >> 3, cg = lane & 7;
  const long long m0 = (long long)blockIdx.x * kPfRows;
  const int n0 = blockIdx.y * BN;
  if (tid < kPfRows) {
    const long long p = m0 + tid;
    const long long hw = (long long)g.Ho * g.Wo;
    const long long rem = p % hw;
    const int i = (int)(rem / g.Wo) - g.pt, j = (int)(rem % g.Wo) - g.pl;
    row_pix[tid] = ((p / hw) * g.Hi + i) * g.Wi + j;
    row_i[tid] = p < g.M ? i : kNoRow;
    row_j[tid] = j;
    row_edges[tid] = pc_edges(g, e, p);
  }
  for (int i = tid; i < BN; i += kPfThreads)
    bias_s[i] = n0 + i < g.Cout ? pc_bias(e, n0 + i) : 0.f;
  __syncthreads();

  const int taps = g.kh * g.kw;
  const int steps = taps * ((g.Cin + kPfK - 1) / kPfK);

  // 16-byte copies (4 channels; Cin and Cout are multiples of 4): each
  // thread's 4 pixel rows and its weight chunk are fixed across K steps, so
  // their geometry stays in registers
  constexpr int kAPer = kPfRows * (kPfK / 4) / kPfThreads;  // 4
  const int a_c = (tid & 7) * 4;                           // channel in step
  long long a_pix[kAPer];
  int a_i[kAPer], a_j[kAPer];
#pragma unroll
  for (int k = 0; k < kAPer; ++k) {
    const int r = (tid >> 3) + 32 * k;
    a_pix[k] = row_pix[r];
    a_i[k] = row_i[r];
    a_j[k] = row_j[r];
  }
  constexpr int kBCpr = BN / 4;              // 16-byte chunks per K row
  constexpr int kBRpi = kPfThreads / kBCpr;  // K rows per pass
  const int b_nn = (tid % kBCpr) * 4, b_kr = tid / kBCpr;
  const bool b_col_ok = n0 + b_nn < g.Cout;

  // K step s: input channels c0 .. c0 + 31 of tap s % taps -> stage s % 4
  // (consecutive taps read the same channels of neighbouring pixels, which
  // the L1 still holds). Pad cells, pixels past the end and channels past
  // Cin are zero-filled.
  auto load_step = [&](int s) {
    const int tap = s % taps, c0 = (s / taps) * kPfK;
    const int ty = tap / g.kw, tx = tap % g.kw;
    const uint32_t sa = base + (s % kPfStages) * Lay::stage;
    const uint32_t sb = sa + Lay::a_bytes;
    // input patch: 128 pixels x 32 channels, [pixel][channel]
    const long long shift = (long long)ty * g.Wi + tx;
    const bool c_ok = c0 + a_c < g.Cin;
#pragma unroll
    for (int k = 0; k < kAPer; ++k) {
      const int ii = a_i[k] + ty, jj = a_j[k] + tx;
      const bool ok = c_ok && ii >= 0 && ii < g.Hi && jj >= 0 && jj < g.Wi;
      const float* src = ok ? x + (a_pix[k] + shift) * g.Cin + c0 + a_c : x;
      sm90::cp_async16_l1(
          sa + 4 * (((tid >> 3) + 32 * k) * kPfLda + a_c), src, ok ? 16 : 0);
    }
    // weight slice: 32 input channels x BN outputs, [channel][output]
    const float* wt = w + ((size_t)tap * g.Cin + c0) * g.Cout + n0;
#pragma unroll
    for (int k = 0; k < kPfK / kBRpi; ++k) {
      const int kr = b_kr + kBRpi * k;
      const bool ok = b_col_ok && c0 + kr < g.Cin;
      const float* src = ok ? wt + (size_t)kr * g.Cout + b_nn : w;
      sm90::cp_async16(sb + 4 * (kr * BN + b_nn), src, ok ? 16 : 0);
    }
  };

  float acc[8][4 * NQ];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int n = 0; n < 4 * NQ; ++n) acc[r][n] = 0.f;

#pragma unroll
  for (int s = 0; s < kPfAhead; ++s) {
    if (s < steps) load_step(s);
    sm90::cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    sm90::cp_async_wait<kPfAhead - 1>();  // this thread's copies of step s
    __syncthreads();  // every copy of step s landed; step s - 1 is done
    if (s + kPfAhead < steps) load_step(s + kPfAhead);  // into s - 1's stage
    sm90::cp_async_commit();
    const float* as = reinterpret_cast<const float*>(
        smem + (s % kPfStages) * Lay::stage) + (32 * wm + rg) * kPfLda;
    const float* bs = reinterpret_cast<const float*>(
        smem + (s % kPfStages) * Lay::stage + Lay::a_bytes) + 32 * wn + 4 * cg;
#pragma unroll
    for (int k = 0; k < kPfK; k += 4) {
      float4 a[8];  // 4 channels of each of the lane's 8 pixels
#pragma unroll
      for (int r = 0; r < 8; ++r)
        a[r] = *reinterpret_cast<const float4*>(as + 4 * r * kPfLda + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float4 b[NQ];  // 4 outputs of each group at channel k + kk
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          b[q] = *reinterpret_cast<const float4*>(bs + (k + kk) * BN + 64 * q);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const float av = kk == 0 ? a[r].x : kk == 1 ? a[r].y
                         : kk == 2 ? a[r].z : a[r].w;
#pragma unroll
          for (int q = 0; q < NQ; ++q) {
            acc[r][4 * q + 0] = fmaf(av, b[q].x, acc[r][4 * q + 0]);
            acc[r][4 * q + 1] = fmaf(av, b[q].y, acc[r][4 * q + 1]);
            acc[r][4 * q + 2] = fmaf(av, b[q].z, acc[r][4 * q + 2]);
            acc[r][4 * q + 3] = fmaf(av, b[q].w, acc[r][4 * q + 3]);
          }
        }
      }
    }
  }
  sm90::cp_async_wait<0>();

  // bias in f32, a masked pixel's pad half-cells zeroed, 16-byte stores of
  // 4 consecutive outputs (a store instruction writes 128 bytes of 4 rows)
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int pl = 32 * wm + rg + 4 * r;
    const long long p = m0 + pl;
    if (p >= g.M) continue;
    const int edges = row_edges[pl];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int nl = 32 * wn + 4 * cg + 64 * q;
      if (n0 + nl >= g.Cout) continue;
      float v[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        v[c] = acc[r][4 * q + c] + bias_s[nl + c];
        if (edges && pc_masked(edges, e.mask_c, n0 + nl + c)) v[c] = 0.f;
      }
      *reinterpret_cast<float4*>(out + p * g.Cout + n0 + nl) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

template <int BN>
int launch_packed_conv_f32(const void* x, const void* w, void* out,
                           const PcGeom& g, const PcEpi& e,
                           cudaStream_t stream) {
  const long long mt = (g.M + kPfRows - 1) / kPfRows;
  if (mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      packed_conv_f32_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, PfLayout<BN>::bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)mt, (g.Cout + BN - 1) / BN);
  packed_conv_f32_kernel<BN>
      <<<grid, kPfThreads, PfLayout<BN>::bytes, stream>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<float*>(out), g, e);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). kh, kw in {1, 2}; pads
// in {0, 1}; Cin and Cout multiples of 4; x and w 16-byte aligned. bias:
// Cout values or null, bfloat16 if bias_bf16 else float32; mask_c: 0, or
// the phase-block width with Cout = 4 mask_c. Returns a cudaError_t value
// (0 = ok).
extern "C" int keep_packed_conv(const void* x, const void* w,
                                const void* bias, void* out, int B, int Hi,
                                int Wi, int Cin, int Cout, int kh, int kw,
                                int pt, int pb, int pl, int pr, int bias_bf16,
                                int mask_c, int dtype, void* stream) {
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
  if (dtype == 1)
    return Cout > 64 ? launch_packed_conv_bf16<256>(x, w, out, g, e, st)
                     : launch_packed_conv_bf16<64>(x, w, out, g, e, st);
  if (dtype == 0)
    return Cout > 64 ? launch_packed_conv_f32<128>(x, w, out, g, e, st)
                     : launch_packed_conv_f32<64>(x, w, out, g, e, st);
  return (int)cudaErrorInvalidValue;
}
