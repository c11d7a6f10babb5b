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
// flash_attention_f32_kernel: f32 inputs (the f32 training step's window
// attentions +- mask, its global flow attention, K3 f32), every product as
// 3xTF32 on the tensor cores: x = hi + lo with hi x rounded to TF32 (11
// significant bits) and lo the rest, a b = a_hi b_hi + a_hi b_lo + a_lo
// b_hi, f32 accumulation (attention_bwd.cu's scheme, whose gate a single
// TF32 product fails). 3 x 4 L^2 D flops a batch entry at D_v = 128 bound
// it at 495 TFLOP/s (the FMA pipe's 67 TFLOP/s, which the earlier
// register-tiled FMA kernel ran at 53 %, is 2.5x slower). wgmma takes TF32
// operands from shared memory only K-major, and TMA neither splits nor
// transposes, so a producer warpgroup does both: its first thread loads
// K's raw tiles by TMA into their stage's lo tile and V's into a staging
// tile, and its 128 threads split K in place (raw and split tiles share
// wgmma's 128-byte-swizzle layout) and V into V^T's hi and lo tiles, keys
// relabelled within each 8 (slot t key 2t, slot t + 4 key 2t + 1) so that
// P's accumulator registers are its A fragments as they stand; the block
// reads each raw K / V byte from L2 once (split tiles at 128-row blocks
// would read ~2.5 GB a call at B = 152, L = 1024, twice the raw bytes).
// Two consumer warpgroups of 64 rows run free of each other as in the bf16
// kernel (setmaxnreg 40 / 232). Q lands once by TMA and is read by
// ldmatrix every tile: its A fragments carry its bits + 0x1000, which the
// tensor core reads as Q rounded to TF32, and its lo parts, two k steps at
// a time in one of two register sets, each rewritten once its group has
// landed (held in registers, Q's fragments and O's 64 made ptxas serialize
// the wgmmas and spill). A key tile is 32 keys at D_v = 128 (S 16
// registers, the last P's hi and lo 32) and 64 at D_v = 2, in two stages.
// Per tile: S on m64n32k8 (m64n64k8), the last tile's P V on m64n128k8
// issued behind it, the online softmax on S's registers while P V runs,
// then O rescaled and P split into its hi bits and lo. The tensor core's
// adds truncate, so S's sums run as attention_bwd.cu's, whose kernels
// rebuild P from this lse: the small terms in one chain, the hi x hi
// products in chains of 2 k steps (D_v = 2: 4) added in f32 (one chain of
// all 48 products a row failed the gradient gate of the card tests). The
// (Bm, L, L) mask is staged by each consumer warp's cp.async one tile
// ahead, as in the bf16 kernel; the 2-wide forms multiply each lane's
// probabilities by V's 2 values (or the grid's), read through L1, in FMAs.
// Shared memory: 226 KB with the mask, 210 KB without, 194 KB at D_v = 2.
// No model passes a bias with a 2-wide V, and no narrow form takes one.
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
// The narrow bf16 kernel's 2-wide V slices
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
// f32: 3xTF32 on wgmma, K and V split on chip by a producer warpgroup
// ---------------------------------------------------------------------------

constexpr int kXRows = 128;      // query rows per block: 2 warpgroups x 64
constexpr int kXThreads = 384;   // 2 consumer warpgroups and a producer
constexpr int kXStages = 2;

// A block's shared memory: the mbarriers, then two stages of K's TF32 hi
// and lo tiles (keys x 128, K-major) and, D_v = 128, V^T's (128 x keys,
// keys relabelled as the P fragments read them), then (D_v = 128) V's raw
// tile, Q's raw rows (128 x 128) and each consumer warp's bias rows
// (BIAS); every tile in wgmma's 128-byte-swizzle layout on a 1024-byte
// boundary. K's raw tile lands by TMA in its lo tile and is split in
// place. mbarriers (8 bytes each): stage s split (the producer's 128
// threads arrive); stage s released by both consumer warpgroups (256
// arrive); K's raw tile of stage s landed; V's raw tile landed; Q landed.
template <int DV, bool BIAS>
struct XfSmem {
  static constexpr bool wide = DV == kD;
  static constexpr int keys = wide ? 32 : 64;  // keys a tile
  // S's q' Khi chains: groups of 2 k steps (4 k steps at D_v = 2), each
  // added in f32
  static constexpr int chain = wide ? 1 : 2;
  static constexpr uint32_t kt = keys * kD * 4;    // a K hi or lo tile
  static constexpr uint32_t vt = wide ? kt : 0;    // a V^T hi or lo tile
  static constexpr uint32_t stage = 2 * kt + 2 * vt;
  static constexpr uint32_t st0 = 1024;
  static constexpr uint32_t vraw = st0 + kXStages * stage;
  static constexpr uint32_t q = vraw + vt;
  static constexpr uint32_t bias = q + kXRows * kD * 4;
  static constexpr int bias_warp = 16 * keys * 4;  // a warp's bias rows
  static constexpr int bytes = bias + (BIAS ? 8 * bias_warp : 0) + 1024;
  static_assert(bytes <= 232448, "227 KB a block");
  static_assert(!BIAS || wide, "no narrow form takes a bias");
  static constexpr int full = 0, empty = kXStages, kraw = 2 * kXStages,
                       vbar = 3 * kXStages, qbar = vbar + 1;
  static __device__ __forceinline__ uint32_t khi(int s) {
    return st0 + s * stage;
  }
  static __device__ __forceinline__ uint32_t klo(int s) {
    return khi(s) + kt;
  }
  static __device__ __forceinline__ uint32_t vhi(int s) {
    return khi(s) + 2 * kt;
  }
  static __device__ __forceinline__ uint32_t vlo(int s) {
    return vhi(s) + vt;
  }
};

// a warp's 16 bias rows (query rows row0 ..) of the KEYS-key tile at k0,
// f32, by the warp's own cp.async into its rows: row rr at KEYS * 4 rr,
// 16-byte chunk c at c ^ (rr & 7); 0 past L. 16-byte copies when `wide`
// (L % 4 == 0 and the bias 16-byte aligned), else 4-byte ones
template <int KEYS>
__device__ __forceinline__ void xf_load_bias(uint32_t dst, const float* biasb,
                                             int row0, int k0, int L,
                                             bool wide, int lane) {
  constexpr int CH = KEYS / 4;  // 16-byte chunks a row
  if (wide) {
#pragma unroll
    for (int i = lane; i < 16 * CH; i += 32) {
      const int rr = i / CH, c = i % CH;
      const int row = row0 + rr, key = k0 + 4 * c;
      const bool ok = row < L && key < L;
      sm90::cp_async16(dst + rr * KEYS * 4 + ((c ^ (rr & 7)) << 4),
                       biasb + (ok ? (size_t)row * L + key : 0), ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int i = lane; i < 16 * KEYS; i += 32) {
      const int rr = i / KEYS, kk = i % KEYS;
      const int row = row0 + rr, key = k0 + kk;
      const bool ok = row < L && key < L;
      sm90::cp_async4(dst + rr * KEYS * 4 + (((kk >> 2) ^ (rr & 7)) << 4) +
                          4 * (kk & 3),
                      biasb + (ok ? (size_t)row * L + key : 0), ok ? 4 : 0);
    }
  }
}

// S (64 x N scores of the warpgroup) = Q K^T as 3xTF32 over the 16 k steps
// of d, issued in 8 groups of 2 k steps, with Q's A fragments read from its
// raw rows in shared memory by ldmatrix (an 8 x 8 b16 matrix is 8 rows of
// 4 f32: the TF32 A fragment's; the warp's rows from rw) and split into
// hi bits and lo in one of two register sets, each rewritten only once the
// group that read it has landed (wgmma.wait_group 1). The tensor core's
// adds truncate, so the sums run as attention_bwd.cu's do: the two small
// terms (q' Klo, qlo Khi) in one chain over all of d into sl, the q' Khi
// products in chains of CH groups, each from zero into one of two part
// sets and added to s in f32 once it has landed. Returns with the last
// group in flight; xf_scores_end finishes s once it has landed.
template <int N, int CH>
__device__ __forceinline__ void xf_chain_add(float (&s)[N / 2],
                                             float (&part)[2][N / 2], int ch) {
  sm90::fence_regs(part[ch & 1]);
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
    s[i] = ch == 0 ? part[0][i] : s[i] + part[ch & 1][i];
}

template <int N, int CH>
__device__ __forceinline__ void xf_scores(float (&s)[N / 2],
                                          float (&sl)[N / 2],
                                          float (&part)[2][N / 2],
                                          uint32_t sq, int rw, uint32_t khi,
                                          uint32_t klo) {
  const uint64_t dkh = sm90::desc_k(khi, N, 0, 0);
  const uint64_t dkl = sm90::desc_k(klo, N, 0, 0);
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  uint32_t qh[2][2][4], ql[2][2][4];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (c >= 2) {
      sm90::wg_wait<1>();  // group c - 2 landed
      if ((c - 2) % CH == CH - 1) xf_chain_add<N, CH>(s, part, (c - 2) / CH);
    }
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t a[4];
      sm90::ldsm_x4(sq + sm90::am_at(rw + (mi & 1) * 8 + mr,
                                     2 * (2 * c + kk) + (mi >> 1), kXRows),
                    a);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        qh[c & 1][kk][e] = sm90::tf32_hi_bits(a[e]);
        ql[c & 1][kk][e] = sm90::tf32_lo_of_hi(qh[c & 1][kk][e]);
      }
    }
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int ks = 2 * c + kk;
      const uint64_t dh = sm90::desc_k_at(dkh, N, ks);
      sm90::WgTf32<N>::mma(part[(c / CH) & 1], qh[c & 1][kk], dh,
                           c % CH > 0 || kk > 0);
      sm90::WgTf32<N>::mma(sl, qh[c & 1][kk], sm90::desc_k_at(dkl, N, ks),
                           ks > 0);
      sm90::WgTf32<N>::mma(sl, ql[c & 1][kk], dh, 1);
    }
    sm90::wg_commit();
  }
}

template <int N, int CH>
__device__ __forceinline__ void xf_scores_end(float (&s)[N / 2],
                                              float (&sl)[N / 2],
                                              float (&part)[2][N / 2]) {
#pragma unroll
  for (int c = 6; c < 8; ++c)
    if (c % CH == CH - 1) xf_chain_add<N, CH>(s, part, c / CH);
  sm90::fence_regs(sl);
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] += sl[i];
}

// q, k: (B, L, 128) f32 through the tensor maps tq, tk; v: (L, DV) f32 at
// batch stride v_bstride elements (0: one V for the batch; DV = 128
// through tv, DV = 2 read directly); bias: (Bm, L, L) f32 for BIAS; out:
// (B, L, DV) f32. Grid (ceil(L / 128), B), 384 threads: warpgroup wg < 2
// owns query rows 64 wg .. of the block, its warp w the 16 rows from 16 w;
// warpgroup 2 is the producer (40 registers a thread, the consumers 232):
// its first thread issues the TMA loads of Q's rows and of K's and V's raw
// tiles, and its 128 threads split them into TF32 hi and lo tiles (V
// transposed). A wgmma accumulator gives each lane, per 8-column group j,
// the elements (g, 8j + 2t), (g, 8j + 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j
// + 2t + 1) of its warp's rows (g = lane / 4, t = lane % 4); as the A of P
// V, slot t of k step j is key 8j + 2t and slot t + 4 key 8j + 2t + 1,
// which V^T's tiles are written to match.
template <int DV, bool BIAS>
__global__ void __launch_bounds__(kXThreads, 1)
    flash_attention_f32_kernel(const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const float* __restrict__ v, size_t v_bstride,
                               const float* __restrict__ bias, int bm,
                               float* __restrict__ out,
                               float* __restrict__ lse, int L,
                               float scale_log2) {
  using S = XfSmem<DV, BIAS>;
  constexpr bool kWide = S::wide;
  constexpr int KEYS = S::keys, NS = kXStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = sm90::smem_u32(smem);
  auto bar = [&](int i) { return s0 + 8 * i; };
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * kXRows;
  const int n_tiles = (L + KEYS - 1) / KEYS;

  if (tid == 0) {
    for (int s = 0; s < NS; ++s) {
      sm90::mbar_init(bar(S::full + s), 128);
      sm90::mbar_init(bar(S::empty + s), 256);
      sm90::mbar_init(bar(S::kraw + s), 1);
    }
    sm90::mbar_init(bar(S::vbar), 1);
    sm90::mbar_init(bar(S::qbar), 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {  // the producer
    sm90::setmaxnreg_dec<40>();
    const int p = tid - 256;
    // every producer thread waits for a stage to be released; the first
    // alone issues the loads, none of which waits (the warps stay converged
    // for bar.sync)
    auto wait_free = [&](int j) {
      if (j >= NS) sm90::mbar_wait(bar(S::empty + j % NS), (j / NS - 1) & 1);
    };
    auto issue_k = [&](int j) {  // K_j's raw tile into its stage's lo tile
      const int s = j % NS;
      sm90::mbar_expect_tx(bar(S::kraw + s), S::kt);
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        sm90::tma_load_3d(s0 + S::klo(s) + cb * KEYS * 128, &tk, 32 * cb,
                          j * KEYS, b, bar(S::kraw + s));
    };
    auto issue_v = [&](int j) {  // V_j's raw tile
      sm90::mbar_expect_tx(bar(S::vbar), S::vt);
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        sm90::tma_load_3d(s0 + S::vraw + cb * KEYS * 128, &tv, 32 * cb,
                          j * KEYS, b, bar(S::vbar));
    };
    // K_x goes into stage x % NS once the consumers have released tile x -
    // NS; they release tile j - 1 once tile j is split (wide: after P_(j-1)
    // V_(j-1), behind S_j), so K runs one tile ahead of the split
    static_assert(NS == 2, "K loads one tile ahead");
    if (p == 0) {
      sm90::mbar_expect_tx(bar(S::qbar), kXRows * kD * 4);
#pragma unroll
      for (int cb = 0; cb < 4; ++cb)
        sm90::tma_load_3d(s0 + S::q + cb * kXRows * 128, &tq, 32 * cb, q0, b,
                          bar(S::qbar));
      issue_k(0);
      if constexpr (kWide) issue_v(0);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % NS;
      sm90::mbar_wait(bar(S::kraw + s), (j / NS) & 1);
      // K: the raw tile and the split ones share a layout: split in place
#pragma unroll 2
      for (int i = p; i < KEYS * 32; i += 128) {
        uint4* lo = reinterpret_cast<uint4*>(smem + S::klo(s) + 16 * i);
        uint4 x = *lo, hi;
        sm90::split_tf32_4(x, hi);
        *reinterpret_cast<uint4*>(smem + S::khi(s) + 16 * i) = hi;
        *lo = x;
      }
      if constexpr (kWide) {
        // V^T: row n (of 128) holds the tile's 32 keys, slots 4c .. 4c + 3
        // in its 16-byte chunk c (at c ^ (n & 7)): keys 8 (c / 2) + 2e +
        // (c % 2), e < 4. Raw V: key r, column n at block n / 32 (r, chunk
        // (n / 4) % 8) as TMA's swizzle lays it
        sm90::mbar_wait(bar(S::vbar), j & 1);
#pragma unroll 1
        for (int i = p; i < kD * 8; i += 128) {
          const int n = i & 127, c = i >> 7;
          const uint32_t col = (n >> 5) * KEYS * 128 + 4 * (n & 3);
          uint32_t xv[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 8 * (c >> 1) + 2 * e + (c & 1);
            xv[e] = *reinterpret_cast<const uint32_t*>(
                smem + S::vraw + col + r * 128 +
                ((((n >> 2) & 7) ^ (r & 7)) << 4));
          }
          uint4 x = make_uint4(xv[0], xv[1], xv[2], xv[3]), hi;
          sm90::split_tf32_4(x, hi);
          const uint32_t o = n * 128 + ((c ^ (n & 7)) << 4);
          *reinterpret_cast<uint4*>(smem + S::vhi(s) + o) = hi;
          *reinterpret_cast<uint4*>(smem + S::vlo(s) + o) = x;
        }
      }
      sm90::fence_async_smem();  // the split tiles, to wgmma
      sm90::mbar_arrive(bar(S::full + s));
      if constexpr (kWide) {
        sm90::named_sync(1, 128);  // V's raw tile read by every thread
        if (p == 0 && j + 1 < n_tiles) issue_v(j + 1);
      }
      if (j + 1 < n_tiles) {
        wait_free(j + 1);
        if (p == 0) issue_k(j + 1);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * (tid >> 5);      // the warp's first row in the block
  const int row0 = q0 + rw + g;        // this lane's rows: row0, row0 + 8
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;
  const uint32_t sb = s0 + S::bias + (tid >> 5) * S::bias_warp;
  const float* bs = reinterpret_cast<const float*>(smem + S::bias +
                                                   (tid >> 5) * S::bias_warp);
  const bool wide_bias =
      ((L & 3) | (reinterpret_cast<uintptr_t>(bias) & 15)) == 0;
  if constexpr (BIAS) {
    xf_load_bias<KEYS>(sb, biasb, q0 + rw, 0, L, wide_bias, lane);
    sm90::cp_async_commit();
  }

  sm90::mbar_wait(bar(S::qbar), 0);  // Q's rows, 0 past L
  const float* vb = v + (size_t)b * v_bstride;

  constexpr int kO = kWide ? 64 : 4;
  float o[kO];  // wide: the warpgroup's 64 x 128 O (first set by P_0 V_0);
                // narrow: (row0, x), (row0, y), (row0 + 8, x), (.., y)
  if constexpr (!kWide) {
#pragma unroll
    for (int i = 0; i < kO; ++i) o[i] = 0.f;
  }
  float s[KEYS / 2];              // the 64 x KEYS scores of one tile
  float sl[KEYS / 2], part[2][KEYS / 2];  // their small terms, chains
  uint32_t pp[KEYS / 8][4], pl[KEYS / 8][4];  // P of the last tile: hi, lo
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // running sums, this lane's part

  // Tile it: S = Q K_it^T, then (wide) P_(it-1) V_(it-1) issued behind it;
  // the softmax of S while that runs; once it has landed, O rescaled, its
  // stage released and P_it split into pp / pl (read by the next P V).
  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KEYS, st = it % NS, ps = (it + NS - 1) % NS;
    sm90::mbar_wait(bar(S::full + st), (it / NS) & 1);
    xf_scores<KEYS, S::chain>(s, sl, part, s0 + S::q, rw, s0 + S::khi(st),
                              s0 + S::klo(st));
    if constexpr (kWide) {
      if (it > 0) {
        sm90::wg_fence();
        const uint64_t dvh = sm90::desc_k(s0 + S::vhi(ps), kD, 0, 0);
        const uint64_t dvl = sm90::desc_k(s0 + S::vlo(ps), kD, 0, 0);
#pragma unroll
        for (int ks = 0; ks < KEYS / 8; ++ks) {
          const uint64_t dh = sm90::desc_k_at(dvh, kD, ks);
          const uint64_t dl = sm90::desc_k_at(dvl, kD, ks);
          sm90::WgTf32<128>::mma(o, pp[ks], dh, it > 1 || ks > 0);
          sm90::WgTf32<128>::mma(o, pp[ks], dl, 1);
          sm90::WgTf32<128>::mma(o, pl[ks], dh, 1);
        }
        sm90::wg_commit();
        sm90::wg_wait<1>();  // S landed; P V still runs
      } else {
        sm90::wg_wait<0>();
      }
    } else {
      sm90::wg_wait<0>();
    }
    xf_scores_end<KEYS, S::chain>(s, sl, part);
    if constexpr (!kWide) sm90::mbar_arrive(bar(S::empty + st));

    // x = the scaled score (+ bias) in log2 units, ragged keys -inf
    const bool ragged = k0 + KEYS > L;
    if constexpr (BIAS) {
      sm90::cp_async_wait<0>();  // this warp's bias rows of tile it
      __syncwarp();
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float x0 = s[4 * j + 2 * h] * scale_log2;
        float x1 = s[4 * j + 2 * h + 1] * scale_log2;
        if constexpr (BIAS) {
          const int rr = g + 8 * h;
          const float2 bv = *reinterpret_cast<const float2*>(
              bs + rr * KEYS + (((2 * j + (t >> 1)) ^ (rr & 7)) << 2) +
              2 * (t & 1));
          x0 = fmaf(bv.x, kLog2e, x0);
          x1 = fmaf(bv.y, kLog2e, x1);
        }
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
    if constexpr (BIAS) {
      __syncwarp();  // the next tile's bias rows into the same place
      if (it + 1 < n_tiles) {
        xf_load_bias<KEYS>(sb, biasb, q0 + rw, k0 + KEYS, L, wide_bias,
                           lane);
        sm90::cp_async_commit();
      }
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
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      s[4 * j] = ex2(s[4 * j] - mn0);
      s[4 * j + 1] = ex2(s[4 * j + 1] - mn0);
      s[4 * j + 2] = ex2(s[4 * j + 2] - mn1);
      s[4 * j + 3] = ex2(s[4 * j + 3] - mn1);
      sum0 += s[4 * j] + s[4 * j + 1];
      sum1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    if constexpr (kWide) {
      if (it > 0) {  // O through tile it - 1 landed: rescale it to mn
        sm90::wg_wait<0>();
        sm90::fence_regs(o);
        sm90::fence_regs(pp);
        sm90::fence_regs(pl);
        sm90::mbar_arrive(bar(S::empty + ps));
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[4 * j] *= a0;
          o[4 * j + 1] *= a0;
          o[4 * j + 2] *= a1;
          o[4 * j + 3] *= a1;
        }
      }
      // P_it as the A of P V: slot t of k step j is key 8j + 2t
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const uint32_t e4[4] = {
            __float_as_uint(s[4 * j]), __float_as_uint(s[4 * j + 2]),
            __float_as_uint(s[4 * j + 1]), __float_as_uint(s[4 * j + 3])};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pp[j][e] = sm90::tf32_hi_bits(e4[e]);
          pl[j][e] = sm90::tf32_lo_of_hi(pp[j][e]);
        }
      }
    } else {
      // the 2-wide product in FMAs: V's 2 values of keys 8j + 2t, + 1
      o[0] *= a0;
      o[1] *= a0;
      o[2] *= a1;
      o[3] *= a1;
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) {
        const int key = k0 + 8 * j + 2 * t;
        const float2 w0 = key < L ? __ldg(reinterpret_cast<const float2*>(
                                        vb + 2 * (size_t)key))
                                  : make_float2(0.f, 0.f);
        const float2 w1 = key + 1 < L
                              ? __ldg(reinterpret_cast<const float2*>(
                                    vb + 2 * (size_t)key + 2))
                              : make_float2(0.f, 0.f);
        o[0] = fmaf(s[4 * j], w0.x, fmaf(s[4 * j + 1], w1.x, o[0]));
        o[1] = fmaf(s[4 * j], w0.y, fmaf(s[4 * j + 1], w1.y, o[1]));
        o[2] = fmaf(s[4 * j + 2], w0.x, fmaf(s[4 * j + 3], w1.x, o[2]));
        o[3] = fmaf(s[4 * j + 2], w0.y, fmaf(s[4 * j + 3], w1.y, o[3]));
      }
    }
  }

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
  if constexpr (kWide) {
    // the last tile's P V
    const int vs = (n_tiles - 1) % NS;
    sm90::wg_fence();
    const uint64_t dvh = sm90::desc_k(s0 + S::vhi(vs), kD, 0, 0);
    const uint64_t dvl = sm90::desc_k(s0 + S::vlo(vs), kD, 0, 0);
#pragma unroll
    for (int ks = 0; ks < KEYS / 8; ++ks) {
      const uint64_t dh = sm90::desc_k_at(dvh, kD, ks);
      const uint64_t dl = sm90::desc_k_at(dvl, kD, ks);
      sm90::WgTf32<128>::mma(o, pp[ks], dh, n_tiles > 1 || ks > 0);
      sm90::WgTf32<128>::mma(o, pp[ks], dl, 1);
      sm90::WgTf32<128>::mma(o, pl[ks], dh, 1);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(o);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= L) continue;
      const float inv = h ? i1 : i0;
      float* orow = out + ((size_t)b * L + row) * kD;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) = make_float2(
            o[4 * j + 2 * h] * inv, o[4 * j + 2 * h + 1] * inv);
    }
  } else {
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[i] += __shfl_xor_sync(0xffffffffu, o[i], w);
    if (t == 0) {
      if (row0 < L)
        *reinterpret_cast<float2*>(out + ((size_t)b * L + row0) * 2) =
            make_float2(o[0] * i0, o[1] * i0);
      if (row0 + 8 < L)
        *reinterpret_cast<float2*>(out + ((size_t)b * L + row0 + 8) * 2) =
            make_float2(o[2] * i1, o[3] * i1);
    }
  }
}

template <int DV, bool BIAS>
int launch_f32(const void* q, const void* k, const void* v, size_t v_bstride,
               const void* bias, int bm, void* out, float* lse, int B, int L,
               float scale, cudaStream_t stream) {
  using S = XfSmem<DV, BIAS>;
  auto kernel = flash_attention_f32_kernel<DV, BIAS>;
  CUtensorMap tq, tk, tv;
  int err = sm90::tma_map_f32(&tk, k, kD, L, B, S::keys);
  if (err == 0) err = sm90::tma_map_f32(&tq, q, kD, L, B, kXRows);
  // D_v = 2 reads V directly: its map is K's, unused
  if (err == 0)
    err = DV == kD ? sm90::tma_map_f32(&tv, v, kD, L, B, S::keys)
                   : sm90::tma_map_f32(&tv, k, kD, L, B, S::keys);
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes);
  if (err != 0) return err;
  dim3 grid((L + kXRows - 1) / kXRows, B);
  kernel<<<grid, kXThreads, S::bytes, stream>>>(
      tq, tk, tv, static_cast<const float*>(v), v_bstride,
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
