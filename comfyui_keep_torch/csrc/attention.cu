// Single-head flash attention for Hopper (sm_90a), and the fused
// global-correlation softmax expectation.
//
// Replaces two TPU kernels of comfyui_keep_tpu/ops/pallas_kernels.py:
//   * attention_pallas (_attn_kernel, _attn_bias_kernel): softmax(q k^T *
//     scale [+ bias[b % Bm]]) v over (B, L, D). GMFlow's window self/cross
//     attention (L = 1024, D = 128, D_v = 128, bias on shifted layers) and
//     its global flow-propagation attention (L = 4096, D = 128, D_v = 2).
//   * global_correlation_expectation_pallas (_corr_flash_kernel):
//     softmax(f0 f1^T / sqrt(C)) @ grid with an f32 (L, 2) pixel grid shared
//     by the batch; P and the P-grid sum stay f32.
// Every form keeps the TPU kernel's arithmetic: f32 scores, exp2 with
// log2(e) folded into the scale, an online softmax (running max m, running
// sum l), P rounded to V's dtype for P V (K1; K3 keeps P in f32), f32
// accumulation, and one normalisation after the last key tile. No form
// touches device memory with the score matrix (1 GB f32 per 20-frame chunk
// for the two global forms alone), and each call is one launch. A call that
// records a gradient passes an lse buffer: each kernel then also writes each
// query row's log2-sum-exp2 (the running max plus log2 of the running sum),
// which the backward kernels of attention_bwd.cu rebuild P from.
//
// Three kernels, one per bound:
//
// flash_attention_bf16_kernel: bf16, D_v = 128 (the window attentions:
// per 20-frame chunk 6 launches unmasked at B = 152, L = 1024 and 6 under
// the shifted-window mask; 6 + 6 in a mixed-precision GMFlow step at B =
// 64, L = 768). ~4 L^2 D flops against ~4 L D bytes per batch entry, far
// above the card's ~295 flop/byte ridge, so the tensor cores bound it --
// at 989 TFLOP/s only through wgmma, whose 64-row warpgroup tiles read
// each shared operand once for four warps (mma.sync's 16-row warp tiles
// read K and V once per warp: the earlier design lost to SDPA by 1.9x).
// One exp2 a score on the MUFU (16 a clock per SM) costs half the score's
// two products, so the softmax has to run beside them, and with two warps
// an SM sub-partition its instruction chains stall: the warpgroups must
// not wait for each other. A block owns 128 query rows: two consumer
// warpgroups of 64 rows and a producer warpgroup, whose first thread
// issues every load by TMA (Q once, then each 128-key K and V tile into a
// ring of buffers, three each without a bias and two with one, in wgmma's
// 128-byte-swizzle layout) and which
// hands its registers to the consumers (setmaxnreg: 24 / 240). mbarriers
// say when a tile has landed and when both consumers have released its
// buffer, so the consumers run free of each other (one __syncthreads a
// tile in lockstep, with every thread issuing cp.async, took 1.3-1.4x
// this kernel's time on the H100). Per tile a consumer issues S = Q K^T on wgmma
// m64n128k16 (Q and K in shared memory, both K-major) and the last tile's
// O += P V (P from registers, V MN-major) together, waits for S alone,
// and runs the online softmax on the accumulator registers (quad shuffles
// for the row max and sum; without a bias the scale folds into the
// exponent's FFMA) while P V runs; once that has landed it rescales O and
// packs P to bf16 as the next product's register A (packing it while the
// product ran gave wrong outputs that changed from run to run). The bias
// (f32, no reuse inside a block: at B = 152 each of the 4 masks is read by
// 38 batch entries from L2) goes by each consumer warp's own cp.async into
// its 8 KB of shared memory one tile ahead, read in the score layout (a
// 16-byte swizzle, two wavefronts a read); 226 KB a block with the bias. A
// block that took the same rows of b and b + Bm to share one bias tile
// would read K and V twice as often, as many bytes as the bias it saves.
//
// flash_narrow_bf16_kernel: bf16 q/k with a 2-wide V (K1's global flow
// attention, bf16 V, P rounded to bf16) or the f32 pixel grid (K3 bf16, P
// kept f32). Per score it does one 128-deep dot product on the tensor cores
// (256 flops), one exp2 on the MUFU (16 a clock per SM, so at D = 128 one
// exp2 costs about what the score's product does) and ~6 FP32 operations;
// the bytes are negligible (K is re-read from L2). So it is bound by issue
// across three pipes. On mma.sync: 128 query rows, 16 per warp, Q as A
// fragments, K by ldmatrix from swizzled cp.async tiles, double-buffered,
// the softmax on the accumulator registers, and no second product on the
// tensor cores: each lane multiplies
// its own 2 x 16 probabilities of a key tile by the 2 values of V (or of
// the grid) for its key columns, read from a 64-key slice staged beside K,
// and keeps 2 x 2 partial sums, reduced over the quad once after the last
// tile. Nothing pads V to 8 or 128 columns. The slice goes through a
// register one tile ahead (its rows need not be 16-byte aligned). 124
// registers and 65 KB a block let two blocks share an SM, so one warp's
// exp2 and FMAs issue while another's mma.sync run. exp2 is the MUFU's
// ex2.approx.ftz: exp2f adds a denormal fix-up to every score, which took
// ~5 % of this kernel's time. At B = 19, L = 4096 the 608 blocks run in 2.3
// waves; one 16-warp block per SM whose two halves take alternate key
// tiles and merge at the end (4.6 waves) measured 1.1-1.3x slower.
//
// flash_attention_f32_kernel: f32 throughout (the f32 training step's
// window attentions +- mask, its global flow attention, K3 f32). No TF32:
// the step's results stay f32, so the bound is the FMA pipe's 67 TFLOP/s
// (4 L^2 D flops per batch entry at D_v = 128, half of that at D_v = 2).
// A register-tiled FMA design: 8 warps own 128 query rows, Q resident in
// shared memory, 64-key K tiles double-buffered with 16-byte cp.async. Each
// lane computes a 4 x 8 score sub-tile (rows 16w + rg + 4r, keys cg + 8c
// for lane = 8 rg + cg) from float4 reads of Q and K rows, padded to 132
// floats so that a warp's reads fall in distinct banks: 12 loads per 128
// FMAs, since shared-memory wavefronts, not the FMAs, bound a 4 x 4 tile
// (8 per 64: 48-51 % of the FMA peak on the H100, against 52-53 % now).
// The row max and sum reduce over the 8 lanes of a row with three
// shuffles. P passes through the warp's own rows of a shared tile to the
// P V product, in which the lane owns 4 rows x 16 columns of O in
// registers (20 loads per 256 FMAs), normalised once at the end. V's tile
// loads during Q K^T; the (Bm, L, L) mask is staged by cp.async into the
// warp's P rows at the same time, so it costs neither registers nor time
// (a mask read into registers one tile ahead took 0.6 ms of 3.2). Q, two
// K tiles, V and P take 201 KB and 254 registers: one block per SM. The
// narrow forms (D_v = 2) stage V's 128-value slice beside K and multiply
// each lane's probabilities by it in registers, as the bf16 narrow kernel
// does. No model passes a bias with a 2-wide V, and no narrow form takes
// one.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

constexpr int kD = 128;    // q/k width the kernels are built for

// ---------------------------------------------------------------------------
// bf16, D = D_v = 128: warpgroups on wgmma, tiles by TMA
// ---------------------------------------------------------------------------

constexpr int kWaRows = 128;    // query rows per block: 2 warpgroups x 64
constexpr int kWaKeys = 128;    // keys per tile
constexpr int kWaThreads = 384;  // 2 consumer warpgroups and a producer
constexpr int kWaQBytes = kWaRows * kD * 2;    // 32 KB
constexpr int kWaTile = kWaKeys * kD * 2;      // one K or V tile: 32 KB
constexpr int kWaBiasRows = 16 * kWaKeys * 4;  // a warp's bias rows: 8 KB
// A block's shared memory: the mbarriers, Q, a ring of `stages` K and V
// buffers each, then (BIAS) each consumer warp's bias rows; every tile in
// wgmma's 128-byte-swizzle layout (sm90::am_at) on a 1024-byte boundary.
// mbarriers (8 bytes each): Q landed; K / V buffer s landed; K / V buffer
// s released by both consumer warpgroups (every consumer thread arrives).
template <bool BIAS>
struct WaSmem {
  static constexpr int stages = BIAS ? 2 : 3;
  static constexpr uint32_t q = 1024;
  static constexpr uint32_t k = q + kWaQBytes;
  static constexpr uint32_t v = k + stages * kWaTile;
  static constexpr uint32_t bias = v + stages * kWaTile;
  // + 1024 for rounding the base up to a swizzle atom: 226 KB either way
  static constexpr int bytes = bias + (BIAS ? 8 * kWaBiasRows : 0) + 1024;
  static_assert(bytes <= 232448, "227 KB a block");
  static constexpr int bar_q = 0, k_full = 1, k_empty = 1 + stages,
                       v_full = 1 + 2 * stages, v_empty = 1 + 3 * stages;
};

// a warp's 16 bias rows (query rows row0 ..) of the key tile at k0, f32, by
// the warp's own cp.async into its 8 KB: row rr at 512 rr, 16-byte chunk c
// at c ^ (rr & 7); 0 past L. 16-byte copies when `wide` (L % 4 == 0 and the
// bias 16-byte aligned: every row's chunks start on 16-byte boundaries),
// else 4-byte ones
__device__ __forceinline__ void wa_load_bias(uint32_t dst, const float* biasb,
                                             int row0, int k0, int L,
                                             bool wide, int lane) {
  if (wide) {
#pragma unroll
    for (int rr = 0; rr < 16; ++rr) {
      const int row = row0 + rr, key = k0 + 4 * lane;
      const bool ok = row < L && key < L;
      sm90::cp_async16(dst + rr * 512 + ((lane ^ (rr & 7)) << 4),
                       biasb + (ok ? (size_t)row * L + key : 0), ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < 16 * kWaKeys; i += 32) {
      const int rr = i >> 7, kk = i & 127;
      const int row = row0 + rr, key = k0 + kk;
      const bool ok = row < L && key < L;
      sm90::cp_async4(dst + rr * 512 + (((kk >> 2) ^ (rr & 7)) << 4) +
                          4 * (kk & 3),
                      biasb + (ok ? (size_t)row * L + key : 0), ok ? 4 : 0);
    }
  }
}

// q, k, v, out: (B, L, 128) bf16, read through the tensor maps tq, tk, tv;
// bias: (Bm, L, L) f32 for BIAS. Grid (ceil(L / 128), B), 384 threads:
// warpgroup wg < 2 owns query rows 64 wg .. of the block, its warp w the
// 16 rows from 64 wg + 16 w; warpgroup 2 is the producer (24 registers a
// thread, the consumers 240), whose first thread issues every TMA load (Q,
// then K_it and V_it into buffer it % stages once both warpgroups have
// released it). A wgmma accumulator gives each lane, per
// 8-column group j, the elements (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8,
// 8j + 2t), (g + 8, 8j + 2t + 1) of its warp's rows (g = lane / 4, t = lane
// % 4: mma.sync's layout), so a row's softmax statistics reduce over a
// quad, and its P packed to bf16 pairs is the A operand of P V from
// registers.
template <bool BIAS>
__global__ void __launch_bounds__(kWaThreads, 1)
    flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap tq,
                                const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv,
                                const float* __restrict__ bias, int bm,
                                bf16* __restrict__ out,
                                float* __restrict__ lse, int L,
                                float scale_log2) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  using S = WaSmem<BIAS>;
  constexpr int NS = S::stages;
  const uint32_t s0 = sm90::smem_u32(smem);
  const uint32_t sq = s0 + S::q, sk = s0 + S::k, sv = s0 + S::v;
  auto bar = [&](int i) { return s0 + 8 * i; };
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * kWaRows;
  const int n_tiles = (L + kWaKeys - 1) / kWaKeys;

  if (tid == 0) {
    sm90::mbar_init(bar(S::bar_q), 1);
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(bar(S::k_full + s), 1);
      sm90::mbar_init(bar(S::v_full + s), 1);
      sm90::mbar_init(bar(S::k_empty + s), 256);
      sm90::mbar_init(bar(S::v_empty + s), 256);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer: its registers go to the consumers
    sm90::setmaxnreg_dec<24>();
    if (tid == 256) {
      sm90::mbar_expect_tx(bar(S::bar_q), kWaQBytes);
      sm90::tma_load_3d(sq, &tq, 0, q0, b, bar(S::bar_q));
      sm90::tma_load_3d(sq + kWaRows * 128, &tq, 64, q0, b, bar(S::bar_q));
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % NS, k0 = it * kWaKeys;
        const int done = (it / NS - 1) & 1;  // the phase that released s
        if (it >= NS) sm90::mbar_wait(bar(S::k_empty + s), done);
        sm90::mbar_expect_tx(bar(S::k_full + s), kWaTile);
        sm90::tma_load_3d(sk + s * kWaTile, &tk, 0, k0, b, bar(S::k_full + s));
        sm90::tma_load_3d(sk + s * kWaTile + kWaKeys * 128, &tk, 64, k0, b,
                          bar(S::k_full + s));
        if (it >= NS) sm90::mbar_wait(bar(S::v_empty + s), done);
        sm90::mbar_expect_tx(bar(S::v_full + s), kWaTile);
        sm90::tma_load_3d(sv + s * kWaTile, &tv, 0, k0, b, bar(S::v_full + s));
        sm90::tma_load_3d(sv + s * kWaTile + kWaKeys * 128, &tv, 64, k0, b,
                          bar(S::v_full + s));
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int g = lane >> 2, t = lane & 3;
  const size_t bo = (size_t)b * L * kD;
  const int rw = 16 * (tid >> 5);      // the warp's first row in the block
  const int row0 = q0 + rw + g;        // this lane's rows: row0, row0 + 8
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;
  const uint32_t sb = s0 + S::bias + (tid >> 5) * kWaBiasRows;
  const float* bs = reinterpret_cast<const float*>(smem + S::bias +
                                                   (tid >> 5) * kWaBiasRows);
  // 16-byte bias copies need 16-byte aligned rows
  const bool wide =
      ((L & 3) | (reinterpret_cast<uintptr_t>(bias) & 15)) == 0;
  // without a bias the scale folds into the exponent's FFMA, so the row
  // max is taken on the raw scores: their min when the scale is negative
  const bool neg = scale_log2 < 0.f;
  if constexpr (BIAS) {
    wa_load_bias(sb, biasb, q0 + rw, 0, L, wide, lane);
    sm90::cp_async_commit();
  }

  float o[64];  // the warpgroup's 64 x 128 O, f32 (first set by P_0 V_0)
  float s[64];  // its 64 x 128 scores of one key tile
  uint32_t pp[8][4];  // P of the last tile, packed: the A of P V
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // running sums, this lane's part
  sm90::mbar_wait(bar(S::bar_q), 0);

  // Tile it: S = Q K_it^T on wgmma, and with it in flight P_(it-1) V_(it-1);
  // then the online softmax of S in place while that product runs, and
  // once it has landed the rescale of O and P_it packed into its A
  // registers (the product reads them until then). Each buffer is
  // released as soon as its product has landed.
  for (int it = 0; it < n_tiles; ++it) {
    // this tile's buffer, the last tile's, and their fill phases
    const int k0 = it * kWaKeys, kb = it % NS, pb = (it + NS - 1) % NS;
    sm90::mbar_wait(bar(S::k_full + kb), (it / NS) & 1);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks)
      sm90::WgSS<128, 0, 0>::mma(
          s, sm90::desc_k(sq, kWaRows, 64 * wg, ks),
          sm90::desc_k(sk + kb * kWaTile, kWaKeys, 0, ks), ks > 0);
    sm90::wg_commit();
    if (it > 0) {
      sm90::mbar_wait(bar(S::v_full + pb), ((it - 1) / NS) & 1);
#pragma unroll
      for (int ks = 0; ks < kWaKeys / 16; ++ks)
        sm90::WgRS<128, 1>::mma(
            o, pp[ks], sm90::desc_mn(sv + pb * kWaTile, kWaKeys, 0, ks),
            it > 1 || ks > 0);
      sm90::wg_commit();
      sm90::wg_wait<1>();  // S landed; P V still runs
    } else {
      sm90::wg_wait<0>();
    }
    sm90::fence_regs(s);
    sm90::mbar_arrive(bar(S::k_empty + kb));

    // the row max (log2 units) of the scaled scores, + bias, ragged keys -inf
    const bool ragged = k0 + kWaKeys > L;
    float mx0, mx1;
    if constexpr (BIAS) {
      sm90::cp_async_wait<0>();  // this warp's bias rows of tile it
      __syncwarp();
      mx0 = mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 bv = *reinterpret_cast<const float2*>(
              bs + (g + 8 * h) * kWaKeys + (((2 * j + (t >> 1)) ^ g) << 2) +
              2 * (t & 1));
          float x0 = fmaf(bv.x, kLog2e, s[4 * j + 2 * h] * scale_log2);
          float x1 = fmaf(bv.y, kLog2e, s[4 * j + 2 * h + 1] * scale_log2);
          if (ragged) {
            const int key = k0 + 8 * j + 2 * t;
            if (key >= L) x0 = -INFINITY;
            if (key + 1 >= L) x1 = -INFINITY;
          }
          s[4 * j + 2 * h] = x0;
          s[4 * j + 2 * h + 1] = x1;
        }
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      __syncwarp();  // the next tile's bias rows into the same place
      if (it + 1 < n_tiles) {
        wa_load_bias(sb, biasb, q0 + rw, k0 + kWaKeys, L, wide, lane);
        sm90::cp_async_commit();
      }
    } else {
      const float off = neg ? INFINITY : -INFINITY;  // scaled: -inf
      if (ragged) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int key = k0 + 8 * j + 2 * t;
          if (key >= L) s[4 * j] = s[4 * j + 2] = off;
          if (key + 1 >= L) s[4 * j + 1] = s[4 * j + 3] = off;
        }
      }
      float r0 = s[0], r1 = s[2];
      if (neg) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          r0 = fminf(r0, fminf(s[4 * j], s[4 * j + 1]));
          r1 = fminf(r1, fminf(s[4 * j + 2], s[4 * j + 3]));
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          r0 = fmaxf(r0, fmaxf(s[4 * j], s[4 * j + 1]));
          r1 = fmaxf(r1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
      }
      mx0 = r0 * scale_log2;
      mx1 = r1 * scale_log2;
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    // P = 2^(x - mn), in place; x = the scaled score (bias: s holds x)
    const float sc = BIAS ? 1.f : scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], sc, -mn0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sc, -mn0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sc, -mn1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sc, -mn1));
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    if (it > 0) {  // O through tile it - 1 landed: rescale it to mn
      sm90::wg_wait<0>();
      sm90::fence_regs(o);
      sm90::fence_regs(pp);
      sm90::mbar_arrive(bar(S::v_empty + pb));
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= a0;
        o[4 * j + 1] *= a0;
        o[4 * j + 2] *= a1;
        o[4 * j + 3] *= a1;
      }
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      pp[j >> 1][(j & 1) * 2] = sm90::pack_bf16(s[4 * j], s[4 * j + 1]);
      pp[j >> 1][(j & 1) * 2 + 1] =
          sm90::pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
  }

  // the last tile's P V
  const int vb = (n_tiles - 1) % NS;
  sm90::mbar_wait(bar(S::v_full + vb), ((n_tiles - 1) / NS) & 1);
  sm90::wg_fence();
#pragma unroll
  for (int ks = 0; ks < kWaKeys / 16; ++ks)
    sm90::WgRS<128, 1>::mma(o, pp[ks],
                            sm90::desc_mn(sv + vb * kWaTile, kWaKeys, 0, ks),
                            n_tiles > 1 || ks > 0);
  sm90::wg_commit();
  sm90::wg_wait<0>();
  sm90::fence_regs(o);

  // normalise once, round to bf16 into the warp's own Q rows (no wgmma
  // reads them any more), then 16-byte coalesced stores
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  if (lse != nullptr && t == 0) {  // the backward's row statistics
    if (row0 < L) lse[(size_t)b * L + row0] = m0 + log2f(l0);
    if (row0 + 8 < L) lse[(size_t)b * L + row0 + 8] = m1 + log2f(l1);
  }
  unsigned char* so = smem + S::q;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    *reinterpret_cast<uint32_t*>(so + sm90::am_at(rw + g, j, kWaRows) +
                                 4 * t) =
        sm90::pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
    *reinterpret_cast<uint32_t*>(so + sm90::am_at(rw + g + 8, j, kWaRows) +
                                 4 * t) =
        sm90::pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
  __syncwarp();
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    const int i = lane + 32 * k2;
    const int r = rw + (i >> 4), c = i & 15;
    if (q0 + r < L)
      *reinterpret_cast<uint4*>(out + bo + (size_t)(q0 + r) * kD + 8 * c) =
          *reinterpret_cast<const uint4*>(so + sm90::am_at(r, c, kWaRows));
  }
}

int launch_flash_bf16(const void* q, const void* k, const void* v,
                      const void* bias, int bm, void* out, float* lse, int B,
                      int L, float scale, cudaStream_t stream) {
  auto kernel = bias ? flash_attention_bf16_kernel<true>
                     : flash_attention_bf16_kernel<false>;
  const int smem = bias ? WaSmem<true>::bytes : WaSmem<false>::bytes;
  CUtensorMap tq, tk, tv;
  int err = sm90::tma_map_bf16(&tq, q, kD, L, B, kWaRows);
  if (err == 0) err = sm90::tma_map_bf16(&tk, k, kD, L, B, kWaKeys);
  if (err == 0) err = sm90::tma_map_bf16(&tv, v, kD, L, B, kWaKeys);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != 0) return err;
  dim3 grid((L + kWaRows - 1) / kWaRows, B);
  kernel<<<grid, kWaThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(bias), bm,
      static_cast<bf16*>(out), lse, L, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Shared by the narrow and f32 kernels
// ---------------------------------------------------------------------------

// element i of the 2-wide V slice of keys [k0, k0 + KEYS) (key k0 + i / 2,
// column i % 2), 0 past L; a plain load, so V's rows need no alignment
template <int KEYS, typename TV>
__device__ __forceinline__ TV narrow_fetch(const TV* vb, int k0, int i,
                                           int L) {
  return (i < 2 * KEYS && k0 + i / 2 < L) ? vb[(size_t)k0 * 2 + i]
                                          : from_f<TV>(0.0f);
}

// V's 2 values of keys c and c + 1 (c even) from a staged slice, as floats
__device__ __forceinline__ void narrow_pair(const bf16* vt, int c,
                                            float (&w)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(vt + 2 * c);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}
__device__ __forceinline__ void narrow_pair(const float* vt, int c,
                                            float (&w)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(vt + 2 * c);
  w[0] = u.x; w[1] = u.y; w[2] = u.z; w[3] = u.w;
}

// ---------------------------------------------------------------------------
// bf16 q/k, D_v = 2: scores on the tensor cores, the narrow product in FMAs
// ---------------------------------------------------------------------------

constexpr int kFaRows = 128;            // query rows per block: 8 warps x 16
constexpr int kFaKeys = 64;             // keys per tile
constexpr int kFaThreads = 256;
constexpr int kFaRowBytes = kD * 2;     // one swizzled row of Q, K or V
constexpr int kFaQBytes = kFaRows * kFaRowBytes;     // 32 KB
constexpr int kFaKvBytes = kFaKeys * kFaRowBytes;    // 16 KB

// rows [r0, r0 + ROWS) of a (L, 128) bf16 matrix into a swizzled tile, 16
// bytes per cp.async; rows at or past L are zero-filled
template <int ROWS>
__device__ __forceinline__ void fa_load_rows(uint32_t dst, const bf16* src,
                                             int r0, int L) {
#pragma unroll
  for (int k = 0; k < ROWS * 16 / kFaThreads; ++k) {
    const int i = threadIdx.x + k * kFaThreads;
    const int r = i >> 4, c = i & 15;
    const bool ok = r0 + r < L;
    sm90::cp_async16(dst + sm90::swz(r, c, kFaRowBytes),
                     src + (size_t)(ok ? r0 + r : 0) * kD + c * 8,
                     ok ? 16 : 0);
  }
}

constexpr int kNbVBytes = 2 * kFaKeys * 4;  // one staged slice, f32 at most
constexpr int kNbSmem = kFaQBytes + 2 * kFaKvBytes + 2 * kNbVBytes;  // 65 KB

// q, k: (B, L, 128) bf16; v: (L, 2) of TV at batch stride v_bstride
// elements (0: one V for the batch); out: (B, L, 2) of TO. ROUND_P rounds P to bf16 before the product (K1), as
// JAX's p.astype(v.dtype) does; K3 keeps it f32. Grid (ceil(L / 128), B),
// 256 threads; warp w owns query rows 16w..16w+15 of the block, in
// mma.sync's accumulator layout (g = lane / 4, t = lane % 4).
template <typename TV, typename TO, bool ROUND_P>
__global__ void __launch_bounds__(kFaThreads, 2)
    flash_narrow_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const TV* __restrict__ v, size_t v_bstride,
                             TO* __restrict__ out, float* __restrict__ lse,
                             int L, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = sm90::smem_u32(smem);
  const uint32_t sk = sq + kFaQBytes;
  TV* vs = reinterpret_cast<TV*>(smem + kFaQBytes + 2 * kFaKvBytes);
  constexpr int kSlice = 2 * kFaKeys;  // TV elements of one staged slice
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kFaRows;
  const size_t bo = (size_t)b * L * kD;
  const TV* vb = v + (size_t)b * v_bstride;
  const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0, row0 + 8

  fa_load_rows<kFaRows>(sq, q + bo, q0, L);
  fa_load_rows<kFaKeys>(sk, k + bo, 0, L);
  sm90::cp_async_commit();
  if (tid < kSlice) vs[tid] = narrow_fetch<kFaKeys>(vb, 0, tid, L);

  uint32_t qa[8][4];
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // running sums, this lane's part
  float o0x = 0.f, o0y = 0.f, o1x = 0.f, o1y = 0.f;  // rows row0, row0 + 8
  const int mi = lane >> 3, mr = lane & 7;
  const int n_tiles = (L + kFaKeys - 1) / kFaKeys;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kFaKeys;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    if (it == 0) {
#pragma unroll
      for (int s = 0; s < 8; ++s)
        sm90::ldsm_x4(sq + sm90::swz(16 * warp + (mi & 1) * 8 + mr,
                                     2 * s + (mi >> 1), kFaRowBytes),
                      qa[s]);
    }
    TV vn = from_f<TV>(0.0f);
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      fa_load_rows<kFaKeys>(sk + ((it + 1) & 1) * kFaKvBytes, k + bo,
                            k0 + kFaKeys, L);
      vn = narrow_fetch<kFaKeys>(vb, k0 + kFaKeys, tid, L);
    }
    sm90::cp_async_commit();
    const uint32_t kt = sk + (it & 1) * kFaKvBytes;
    const TV* vt = vs + (it & 1) * kSlice;

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kb[4];
        sm90::ldsm_x4(kt + sm90::swz(16 * p + (mi >> 1) * 8 + mr,
                                     2 * ks + (mi & 1), kFaRowBytes),
                      kb);
        sm90::mma_bf16(s[2 * p], qa[ks], kb[0], kb[1]);
        sm90::mma_bf16(s[2 * p + 1], qa[ks], kb[2], kb[3]);
      }
    }

    const bool ragged = k0 + kFaKeys > L;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= L) x = -INFINITY;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = ex2(m0 - mn0), a1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    o0x *= a0;
    o0y *= a0;
    o1x *= a1;
    o1y *= a1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4] = {ex2(s[j][0] - mn0), ex2(s[j][1] - mn0),
                    ex2(s[j][2] - mn1), ex2(s[j][3] - mn1)};
      sum0 += p[0] + p[1];
      sum1 += p[2] + p[3];
      if constexpr (ROUND_P) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = __bfloat162float(__float2bfloat16(p[e]));
      }
      float w[4];  // keys 8j + 2t and + 1, 2 values each
      narrow_pair(vt, 8 * j + 2 * t, w);
      o0x = fmaf(p[0], w[0], fmaf(p[1], w[2], o0x));
      o0y = fmaf(p[0], w[1], fmaf(p[1], w[3], o0y));
      o1x = fmaf(p[2], w[0], fmaf(p[3], w[2], o1x));
      o1y = fmaf(p[2], w[1], fmaf(p[3], w[3], o1y));
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    // slice it + 1 into the buffer of it - 1, which every warp left before
    // this tile's __syncthreads; read after the next one
    if (it + 1 < n_tiles && tid < kSlice) vs[((it + 1) & 1) * kSlice + tid] = vn;
  }

#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
    o0x += __shfl_xor_sync(0xffffffffu, o0x, w);
    o0y += __shfl_xor_sync(0xffffffffu, o0y, w);
    o1x += __shfl_xor_sync(0xffffffffu, o1x, w);
    o1y += __shfl_xor_sync(0xffffffffu, o1y, w);
  }
  if (t == 0) {
    if (lse != nullptr) {  // the backward's row statistics
      if (row0 < L) lse[(size_t)b * L + row0] = m0 + log2f(l0);
      if (row0 + 8 < L) lse[(size_t)b * L + row0 + 8] = m1 + log2f(l1);
    }
    if (row0 < L) {
      TO* o = out + ((size_t)b * L + row0) * 2;
      o[0] = from_f<TO>(o0x / l0);
      o[1] = from_f<TO>(o0y / l0);
    }
    if (row0 + 8 < L) {
      TO* o = out + ((size_t)b * L + row0 + 8) * 2;
      o[0] = from_f<TO>(o1x / l1);
      o[1] = from_f<TO>(o1y / l1);
    }
  }
}

template <typename TV, typename TO, bool ROUND_P>
int launch_narrow_bf16(const void* q, const void* k, const void* v,
                       size_t v_bstride, void* out, float* lse, int B, int L,
                       float scale, cudaStream_t stream) {
  auto kernel = flash_narrow_bf16_kernel<TV, TO, ROUND_P>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kNbSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kFaRows - 1) / kFaRows, B);
  kernel<<<grid, kFaThreads, kNbSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const TV*>(v), v_bstride, static_cast<TO*>(out), lse, L,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: register-tiled FMA (no TF32)
// ---------------------------------------------------------------------------

constexpr int kFfRows = 128;          // query rows per block: 8 warps x 16
constexpr int kFfKeys = 64;           // keys per tile
constexpr int kFfThreads = 256;
constexpr int kFfLd = kD + 4;         // floats per shared row of Q, K, V
constexpr int kFfLdp = kFfKeys + 8;   // floats per shared row of P

// Q, K[2], then V and P (wide) or the 2-wide V slices: 201 KB wide
template <int DV>
struct FfSmem {
  static constexpr bool wide = DV == kD;
  static constexpr size_t kv = sizeof(float) * kFfKeys * kFfLd;  // K or V
  static constexpr size_t k = sizeof(float) * kFfRows * kFfLd;   // after Q
  static constexpr size_t v = k + 2 * kv;
  static constexpr size_t p = v + (wide ? kv : sizeof(float) * 4 * kFfKeys);
  static constexpr size_t bytes =
      p + (wide ? sizeof(float) * kFfRows * kFfLdp : 0);
};

// rows [r0, r0 + ROWS) of a (L, 128) f32 matrix into a padded shared tile
// at dst, 16 bytes per cp.async; rows at or past L are zero-filled
template <int ROWS>
__device__ __forceinline__ void ff_load_rows(uint32_t dst, const float* src,
                                             int r0, int L) {
#pragma unroll
  for (int i0 = 0; i0 < ROWS * 32; i0 += kFfThreads) {
    const int i = threadIdx.x + i0;
    const int r = i >> 5, c = i & 31;
    const bool ok = r0 + r < L;
    sm90::cp_async16(dst + 4 * (r * kFfLd + 4 * c),
                     src + (size_t)(ok ? r0 + r : 0) * kD + 4 * c,
                     ok ? 16 : 0);
  }
}

// the bias of the warp's 16 rows (from row0) x the key tile at k0 into its
// rows of the P tile (pw, at pw_addr in the shared space), 0 past L: by
// cp.async when rows are 16-byte aligned (L % 4 == 0), else by plain loads
__device__ __forceinline__ void ff_stage_bias(float* pw, uint32_t pw_addr,
                                              const float* biasb, int row0,
                                              int k0, int L, int lane) {
  if ((L & 3) == 0) {
#pragma unroll
    for (int i = lane; i < 16 * kFfKeys / 4; i += 32) {
      const int r = i / (kFfKeys / 4), c = i % (kFfKeys / 4);
      const int row = row0 + r, key = k0 + 4 * c;
      const bool ok = row < L && key < L;
      sm90::cp_async16(pw_addr + 4 * (r * kFfLdp + 4 * c),
                       biasb + (ok ? (size_t)row * L + key : 0), ok ? 16 : 0);
    }
  } else {
    for (int i = lane; i < 16 * kFfKeys; i += 32) {
      const int r = i / kFfKeys, c = i % kFfKeys;
      const int row = row0 + r, key = k0 + c;
      pw[r * kFfLdp + c] =
          (row < L && key < L) ? __ldg(biasb + (size_t)row * L + key) : 0.f;
    }
  }
}

// q, k: (B, L, 128) f32; v: (L, DV) f32 at batch stride v_bstride elements
// (0: one V for the batch); bias: (Bm, L, L) f32 for BIAS (D_v = 128 only);
// out: (B, L, DV) f32. Grid (ceil(L / 128), B), 256 threads. Lane 8 rg + cg of warp w owns
// query rows 16w + rg + 4r (r < 4) of the block, key columns cg + 8c (c <
// 8) of a tile and, for D_v = 128, O's columns 4 (cg + 8 c4) + e (c4, e <
// 4); a row's 8 lanes differ in lane bits 0-2. Each iteration commits two
// cp.async groups: V and the bias of this tile (waited for after Q K^T),
// then K of the next (waited for at the next iteration).
template <int DV, bool BIAS>
__global__ void __launch_bounds__(kFfThreads, 1)
    flash_attention_f32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v, size_t v_bstride,
                               const float* __restrict__ bias, int bm,
                               float* __restrict__ out,
                               float* __restrict__ lse, int L,
                               float scale_log2) {
  using S = FfSmem<DV>;
  constexpr bool kWide = S::wide;
  static_assert(kWide || !BIAS, "the bias is staged in the P tile");
  constexpr int kO = kWide ? 16 : 2;  // O columns per lane and row
  constexpr int kSlice = 2 * kFfKeys;  // narrow V values of one tile
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = sm90::smem_u32(smem);
  const float* Qs = reinterpret_cast<const float*>(smem);
  const float* Vs = reinterpret_cast<const float*>(smem + S::v);
  float* Vn = reinterpret_cast<float*>(smem + S::v);  // narrow: [2][128]
  float* Ps = reinterpret_cast<float*>(smem + S::p);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int b = blockIdx.y, q0 = blockIdx.x * kFfRows;
  const int wr = 16 * warp + rg;  // the lane's rows: wr + 4r of the block
  const size_t bo = (size_t)b * L * kD;
  const float* vb = v + (size_t)b * v_bstride;
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;
  float* pw = Ps + 16 * warp * kFfLdp;  // the warp's rows of P
  const uint32_t pw_addr = sq + S::p + 4 * 16 * warp * kFfLdp;

  ff_load_rows<kFfRows>(sq, q + bo, q0, L);
  ff_load_rows<kFfKeys>(sq + S::k, k + bo, 0, L);
  sm90::cp_async_commit();
  if constexpr (!kWide) {
    if (tid < kSlice) Vn[tid] = narrow_fetch<kFfKeys>(vb, 0, tid, L);
  }

  float o[4][kO];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int n = 0; n < kO; ++n) o[r][n] = 0.f;
  float m[4], l[4];  // running max (log2 units), this lane's running sum
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  const int n_tiles = (L + kFfKeys - 1) / kFfKeys;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kFfKeys, buf = it & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();  // K of tile `it` landed; every warp is done with it - 1
    if constexpr (kWide) ff_load_rows<kFfKeys>(sq + S::v, vb, k0, L);
    if constexpr (BIAS)
      ff_stage_bias(pw, pw_addr, biasb, q0 + 16 * warp, k0, L, lane);
    sm90::cp_async_commit();
    float vn = 0.f;
    if (it + 1 < n_tiles) {  // the next K tile loads while this one computes
      ff_load_rows<kFfKeys>(sq + S::k + (buf ^ 1) * S::kv, k + bo,
                            k0 + kFfKeys, L);
      if constexpr (!kWide) vn = narrow_fetch<kFfKeys>(vb, k0 + kFfKeys, tid, L);
    }
    sm90::cp_async_commit();
    const float* Ks =
        reinterpret_cast<const float*>(smem + S::k + buf * S::kv);

    // S = Q K^T: 4 x 8 per lane, float4 reads along d
    float s[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kD; d += 4) {
      float4 a[4], kk[8];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        a[r] = *reinterpret_cast<const float4*>(Qs + (wr + 4 * r) * kFfLd + d);
#pragma unroll
      for (int c = 0; c < 8; ++c)
        kk[c] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * c) * kFfLd + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          s[r][c] = fmaf(a[r].x, kk[c].x, s[r][c]);
          s[r][c] = fmaf(a[r].y, kk[c].y, s[r][c]);
          s[r][c] = fmaf(a[r].z, kk[c].z, s[r][c]);
          s[r][c] = fmaf(a[r].w, kk[c].w, s[r][c]);
        }
    }

    // scale, bias, ragged keys; online softmax in log2 units
    if constexpr (BIAS) {
      sm90::cp_async_wait<1>();  // this lane's V and bias copies
      __syncwarp();              // the warp's bias rows
    }
    const bool ragged = k0 + kFfKeys > L;
    float mx[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      mx[r] = -INFINITY;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float x = s[r][c] * scale_log2;
        if constexpr (BIAS) x += pw[(rg + 4 * r) * kFfLdp + cg + 8 * c] * kLog2e;
        if (ragged && k0 + cg + 8 * c >= L) x = -INFINITY;
        s[r][c] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
#pragma unroll
    for (int w = 1; w < 8; w <<= 1)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], w));
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float mn = fmaxf(m[r], mx[r]);  // finite: key 0 is always valid
      const float alpha = ex2(m[r] - mn);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        s[r][c] = ex2(s[r][c] - mn);
        sum += s[r][c];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kO; ++n) o[r][n] *= alpha;
    }

    if constexpr (kWide) {
      // P through the warp's rows of a shared tile (over its bias, which
      // each lane read at exactly the places it writes), then O += P V
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          pw[(rg + 4 * r) * kFfLdp + cg + 8 * c] = s[r][c];
      sm90::cp_async_wait<1>();
      __syncthreads();  // V of this tile from every thread; P of the warp
#pragma unroll 2
      for (int j = 0; j < kFfKeys; j += 4) {
        float4 p4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          p4[r] = *reinterpret_cast<const float4*>(pw + (rg + 4 * r) * kFfLdp + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const float* vrow = Vs + (j + jj) * kFfLd + 4 * cg;
#pragma unroll
          for (int c4 = 0; c4 < 4; ++c4) {
            const float4 vv = *reinterpret_cast<const float4*>(vrow + 32 * c4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y
                            : jj == 2 ? p4[r].z : p4[r].w;
              o[r][4 * c4 + 0] = fmaf(p, vv.x, o[r][4 * c4 + 0]);
              o[r][4 * c4 + 1] = fmaf(p, vv.y, o[r][4 * c4 + 1]);
              o[r][4 * c4 + 2] = fmaf(p, vv.z, o[r][4 * c4 + 2]);
              o[r][4 * c4 + 3] = fmaf(p, vv.w, o[r][4 * c4 + 3]);
            }
          }
        }
      }
    } else {
      const float* vt = Vn + buf * kSlice;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 vv =
            *reinterpret_cast<const float2*>(vt + 2 * (cg + 8 * c));
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          o[r][0] = fmaf(s[r][c], vv.x, o[r][0]);
          o[r][1] = fmaf(s[r][c], vv.y, o[r][1]);
        }
      }
      // slice it + 1 into the buffer of it - 1 (see the bf16 kernel)
      if (it + 1 < n_tiles && tid < kSlice) Vn[(buf ^ 1) * kSlice + tid] = vn;
    }
  }

  // the row's sum (and, narrow, its 2 partial products) over its 8 lanes;
  // normalise once
#pragma unroll
  for (int w = 1; w < 8; w <<= 1)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], w);
      if constexpr (!kWide) {
        o[r][0] += __shfl_xor_sync(0xffffffffu, o[r][0], w);
        o[r][1] += __shfl_xor_sync(0xffffffffu, o[r][1], w);
      }
    }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + wr + 4 * r;
    if (row >= L) continue;
    if (lse != nullptr && cg == 0)  // the backward's row statistics
      lse[(size_t)b * L + row] = m[r] + log2f(l[r]);
    const float inv = 1.f / l[r];
    float* orow = out + ((size_t)b * L + row) * DV;
    if constexpr (kWide) {
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4)
        *reinterpret_cast<float4*>(orow + 4 * cg + 32 * c4) =
            make_float4(o[r][4 * c4] * inv, o[r][4 * c4 + 1] * inv,
                        o[r][4 * c4 + 2] * inv, o[r][4 * c4 + 3] * inv);
    } else if (cg == 0) {
      orow[0] = o[r][0] * inv;
      orow[1] = o[r][1] * inv;
    }
  }
}

template <int DV, bool BIAS>
int launch_f32(const void* q, const void* k, const void* v, size_t v_bstride,
               const void* bias, int bm, void* out, float* lse, int B, int L,
               float scale, cudaStream_t stream) {
  using S = FfSmem<DV>;
  auto kernel = flash_attention_f32_kernel<DV, BIAS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kFfRows - 1) / kFfRows, B);
  kernel<<<grid, kFfThreads, S::bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), v_bstride,
      static_cast<const float*>(bias), bm, static_cast<float*>(out), lse, L,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
// q, k: (B, L, D); v, out: (B, L, DV) of the same dtype; bias: (Bm, L, L)
// f32 or null. D must be 128 and DV 128, or 2 without a bias. lse: (B, L)
// f32 or null; when given, each query row's log2-sum-exp2 of its scores in
// log2 units (the running max plus log2 of the running sum) is written
// there for the backward (attention_bwd.cu); nothing else changes.
extern "C" int keep_attention(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* lse_out,
                              int B, int L, int D, int DV, int Bm,
                              float scale, int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (D != kD || B < 1 || L < 1 || (bias != nullptr && Bm < 1))
    return (int)cudaErrorInvalidValue;
  const size_t vb = (size_t)L * DV;
  if (DV == kD) {
    if (dtype == 1)
      return launch_flash_bf16(q, k, v, bias, Bm, out, lse, B, L, scale, st);
    if (dtype == 0)
      return bias ? launch_f32<kD, true>(q, k, v, vb, bias, Bm, out, lse, B,
                                         L, scale, st)
                  : launch_f32<kD, false>(q, k, v, vb, bias, Bm, out, lse, B,
                                          L, scale, st);
  } else if (DV == 2 && bias == nullptr) {
    if (dtype == 1)
      return launch_narrow_bf16<bf16, bf16, true>(q, k, v, vb, out, lse, B, L,
                                                  scale, st);
    if (dtype == 0)
      return launch_f32<2, false>(q, k, v, vb, nullptr, 1, out, lse, B, L,
                                  scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// f0, f1: (B, L, C) of dtype, C = 128; grid: (L, 2) f32; out: (B, L, 2) f32;
// lse: (B, L) f32 or null, as keep_attention's.
extern "C" int keep_corr_expectation(const void* f0, const void* f1,
                                     const void* grid, void* out,
                                     void* lse_out, int B, int L, int C,
                                     float scale, int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse = static_cast<float*>(lse_out);
  if (C != kD || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_narrow_bf16<float, float, false>(f0, f1, grid, 0, out, lse,
                                                   B, L, scale, st);
  if (dtype == 0)
    return launch_f32<2, false>(f0, f1, grid, 0, nullptr, 1, out, lse, B, L,
                                scale, st);
  return (int)cudaErrorInvalidValue;
}
