// Backward of the single-head flash attention (K1) and of the global
// correlation softmax expectation (K3), for Hopper (sm_90a), on the tensor
// cores.
//
// The TPU kernels these differentiate (comfyui_keep_tpu/ops/pallas_kernels.py:
// attention_pallas, global_correlation_expectation_pallas) have no backward:
// the JAX package differentiates its plain branch. These compute the
// gradient of the function each forward kernel of attention.cu computes,
// out = softmax(x) V with x = q k^T * scale [+ bias] (K3: V the f32 (L, 2)
// pixel grid, scale 1 / sqrt(C)), from the forward's inputs, its output and
// its row statistics: lse, each query row's log2-sum-exp2 of x log2(e),
// which the forward writes when the call records a gradient. With
// P = 2^(x log2(e) - lse), Delta = rowsum(dO o O) and dP = dO V^T:
//   dS = P o (dP - Delta), dQ = scale dS K, dK = scale dS^T Q, dV = P^T dO.
// The bias and the grid get no gradient. P is rebuilt tile by tile and no
// (L, L) tensor reaches device memory (the plain backward's score and
// softmax tensors are 151 MB a window call and 302 MB a global one in f32).
//
// A call is two kernels: attn_bwd_delta_kernel writes Delta, then one
// grid of blocks of two sides does the rest. No float atomics and no
// scratch beyond Delta, so a call is bitwise repeatable and its memory
// stays far below one (B, L, L) f32 tensor: a block owns rows of one side,
// staged once in shared memory, and loops over the other side's tiles.
//   * dQ blocks own query rows (Q, dO; lse and Delta in registers) and
//     stream key tiles of K and V: S = Q K^T and dP = dO V^T, P and dS on
//     the accumulator registers, dQ += dS K.
//   * dK / dV blocks own keys (K, V) and stream query tiles of Q and dO
//     with their lse and Delta: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T
//     on the registers, dV += P^T dO and dK += dS^T Q.
// Both sides share the grid so that their blocks fill the waves together,
// and the design does seven L x L x 128 products where five are the least
// (Q K^T and dO V^T on both sides): the one-pass layout (key blocks only,
// dQ summed across them) needs float atomics or per-block dQ partials,
// and partials over 128-key blocks take B L^2 4 bytes, the memory gate
// itself.
//
// attn_bwd_kernel<BwForm<...>>, every form (K1's window attentions +- the
// shifted mask, 12 of the 14 backward launches of a GMFlow training step,
// K1's 2-wide global flow attention and K3), warp-specialized on wgmma
// after attention.cu's forwards: 384
// threads, two consumer warpgroups that each own 64 of the block's rows
// and run free of each other, and a producer warpgroup (setmaxnreg 40 /
// 232) whose first thread loads every tile by TMA into mbarrier rings.
// What bounds it: the tensor cores (seven products at 989 TFLOP/s bf16,
// 3 x 7 at 495 TFLOP/s TF32 in f32) once the operands come from shared
// memory to whole warpgroups. At D_v = 2 there are three 128-deep products
// (S twice, dQ, dK); the 2-wide ones (dP = dO V^T, dV, K3's grid) are
// FMAs on the score registers, each lane's own rows' dO (or V) in
// registers and the streamed rows' V (or dO) in the stage's row data, dV
// summed in each lane over its queries, then over its quad.
//   * bf16 (mixed precision): blocks of 128 rows on both sides, 64-row
//     streamed tiles in two stages (three without the mask). Q K^T, dO V^T
//     and P~^T dO (P~ = P rounded to bf16, as the forward rounds it before
//     P V) are exact bf16 products with f32 sums: S and dP on m64n64k16,
//     both operands K-major in shared memory; the products over the
//     streamed rows take P~ and dS from the accumulator registers as the A
//     operand (packed to bf16 pairs they are its layout) and the streamed
//     tile as the MN-major B (wgmma's transpose bit), m64n128k16. dS is an
//     f32 value: it enters dQ = dS K and dK = dS^T Q as a bf16 hi part
//     plus a bf16 lo part (16 mantissa bits), two wgmmas a product, so
//     that the gradients' one rounding to bf16, at the end, is the only
//     one of their size (dS rounded once would add 2^-9 of each term).
//     The mask's f32 tiles come by TMA with the stage (16-byte aligned
//     rows; else the producer's threads copy them), read in the score
//     layout without bank conflicts. ptxas: 44 / 20 B spilled (without /
//     with the mask).
//   * f32: 3xTF32, x = hi + lo (hi x rounded to 11 significant bits, lo
//     the rest), a b = a_lo b_hi + a_hi b_lo + a_hi b_hi; a single TF32
//     product stands about a thousand times the plain backward's distance
//     to float64 (a CPU model of the rounding,
//     tests/test_torch_kernel_backward.py). TF32 wgmma reads shared memory
//     only K-major and TMA neither splits nor transposes, so the producer
//     warpgroup's 128 threads split each raw streamed tile in place and
//     write its transpose (K^T; Q^T and dO^T), the streamed rows
//     relabelled within each 8 (slot t row 2 t, slot t + 4 row 2 t + 1)
//     so that the accumulators' registers are the A fragments as they
//     stand. The own tiles stay raw, 64 KB each at 128 rows, their A
//     fragments read by ldmatrix every k step and split in registers (bits
//     + 0x1000, which the tensor core reads as the TF32 rounding): with
//     the split and transposed copies that leaves room for 16-row streamed
//     tiles in two stages (S on m64n16k8) and, on the D_v = 128 dK / dV
//     side, for 64 own keys a block, split by output: warpgroup 0 S^T,
//     P^T, dS^T and dK, warpgroup 1 dP^T and dV, swapping P^T and dP^T
//     through shared memory (dK and dV side by side would need 128
//     accumulator registers a thread and a per-tile sum each; at D_v = 2
//     dV is 2 wide and both sides own 128 rows). The tensor core's adds
//     truncate,
//     so no long sum runs through it: the small terms of S and dP in one
//     chain, the hi x hi products in chains of kFChain (4) k steps, each
//     tile's dQ / dK / dV product from zero, each added in f32 (chains of
//     the whole 128-deep row failed the gate on the H100: 3.6x, where the
//     source's stand at most 1.9x; tools/torch_attention_bwd_variants.py).
//     The mask's values are read by the consumers into registers before
//     each tile's scores. ptxas: no spill. At D_v = 128 the dK / dV blocks
//     (64 keys) take as long each as the dQ blocks (128 rows) and are
//     twice as many: two thirds of the time.
// bf16 inputs give bf16 gradients, rounded once.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

constexpr int kBD = 128;        // q/k width the kernels are built for
constexpr int kDThreads = 256;  // the Delta kernel's block

// Delta = rowsum(dO o O) of the B L rows of out, dout: (rows, DV) of TV,
// f32, summed in order along the row (D_v = 128: a warp a row, 4 values a
// lane, then the shuffle tree).
template <typename TV, int DV>
__global__ void __launch_bounds__(kDThreads)
    attn_bwd_delta_kernel(const TV* __restrict__ out,
                          const TV* __restrict__ dout,
                          float* __restrict__ delta, int rows) {
  if constexpr (DV == kBD) {
    const int row = blockIdx.x * (kDThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    if (row >= rows) return;
    float o4[4], d4[4], d = 0.f;
    load4(out + (size_t)row * kBD + 4 * lane, o4);
    load4(dout + (size_t)row * kBD + 4 * lane, d4);
#pragma unroll
    for (int e = 0; e < 4; ++e) d = fmaf(d4[e], o4[e], d);
#pragma unroll
    for (int w = 16; w >= 1; w >>= 1) d += __shfl_xor_sync(0xffffffffu, d, w);
    if (lane == 0) delta[row] = d;
  } else {
    const int row = blockIdx.x * kDThreads + threadIdx.x;
    if (row >= rows) return;
    delta[row] = fmaf(to_f(dout[(size_t)row * 2 + 1]),
                      to_f(out[(size_t)row * 2 + 1]),
                      to_f(dout[(size_t)row * 2]) * to_f(out[(size_t)row * 2]));
  }
}

// A backward form: q, k, dq, dk of T; v, out, dout, dv of TV (K3: V the f32
// grid, dout f32); D_v = DV (128, or 2); BIAS: the (Bm, L, L) mask (D_v =
// 128 only); ROUND_P: P rounded to bf16 in dV, as the forward rounds it
// before P V; DVOUT: dV is written (K3 has none).
template <typename T_, typename TV_, int DV, bool BIAS_, bool ROUND_P_,
          bool DVOUT_>
struct BwForm {
  using T = T_;
  using TV = TV_;
  static constexpr bool wide = DV == kBD, BIAS = BIAS_, ROUND_P = ROUND_P_,
                        DVOUT = DVOUT_;
  static_assert(DV == kBD || DV == 2, "D_v = 128 or 2");
  static_assert(wide || !BIAS, "no form takes a bias with a 2-wide V");
  static_assert(!wide || sizeof(T) == sizeof(TV), "one dtype when wide");
};

// element i (< 2 n) of the 2-wide rows [r0, r0 + n) of a (L, 2) matrix
// (row r0 + i / 2, column i % 2) as a float, 0 past L
template <typename TV>
__device__ __forceinline__ float bw_narrow(const TV* m, int r0, int i, int n,
                                           int L) {
  return (i < 2 * n && r0 + i / 2 < L) ? to_f(m[(size_t)r0 * 2 + i]) : 0.f;
}

constexpr int kWThreads = 384;  // 2 consumer warpgroups and a producer
constexpr int kWOwn = 128;      // rows a block owns: 64 a consumer warpgroup

// ---------------------------------------------------------------------------
// bf16: wgmma, tiles by TMA
// ---------------------------------------------------------------------------

constexpr int kWBox = 64;       // rows of a TMA box of q, k, v or dO

// A block's shared memory (bf16), either side: the mbarriers, the own
// tiles A0 and, D_v = 128, A1 (dQ side: Q, dO; dK / dV side: K, V), then
// `stages` stages of the streamed tile X and, D_v = 128, Y (dQ side: K,
// V; dK / dV side: Q, dO), each stage with (BIAS) its mask tile and its
// row data: the dK / dV side's lse and Delta of the streamed queries (and
// at D_v = 2 their dO), the dQ side's V of the streamed keys at D_v = 2.
// Every tile in wgmma's 128-byte swizzle (sm90::am_at) on a 1024-byte
// boundary; the f32 mask tile in the same swizzle, 32-column blocks of its
// rows (bw_mask_at). mbarriers: the own tiles landed; stage s full (its
// TMA bytes and the producer's 128 threads); stage s released by both
// consumer warpgroups (256 arrive).
template <class F>
struct BwW {
  static constexpr int n = 64;  // rows a streamed tile
  static constexpr int stages = F::BIAS ? 2 : 3;
  static constexpr int mats = F::wide ? 2 : 1;  // own and streamed tiles
  static constexpr uint32_t own = kWOwn * kBD * 2;  // 32 KB
  static constexpr uint32_t tile = n * kBD * 2;     // 16 KB
  static constexpr uint32_t mask = F::BIAS ? n * kWOwn * 4 : 0;
  static constexpr uint32_t a0 = 1024, a1 = a0 + own, st0 = a0 + mats * own;
  static constexpr uint32_t x = 0, y = tile, m = mats * tile, r = m + mask;
  static constexpr uint32_t stage = (r + 4 * n * 4 + 1023) / 1024 * 1024;
  static constexpr int bytes = st0 + stages * stage + 1024;
  static_assert(bytes <= 232448, "227 KB a block");
  static constexpr int bar_own = 0, full = 1, empty = 1 + stages;
};

// byte offset of f32 element (r, c) of a mask tile of R rows: 32-column
// blocks of R x 128 B, TMA's 128-byte swizzle (chunk ^ (r & 7))
__device__ __forceinline__ uint32_t bw_mask_at(int r, int c, int R) {
  return (uint32_t)((c >> 5) * R * 128 + r * 128 +
                    ((((c >> 2) & 7) ^ (r & 7)) << 4) + 4 * (c & 3));
}

// rows r0 .. r0 + ROWS of a (B, L, 128) bf16 tensor map into an am_at tile
// of ROWS rows at dst, in kWBox-row boxes (rows past L are zero-filled)
template <int ROWS>
__device__ __forceinline__ void bw_tma_rows(uint32_t dst, const void* map,
                                            int r0, int b, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < 2; ++cb)
#pragma unroll
    for (int rb = 0; rb < ROWS / kWBox; ++rb)
      sm90::tma_load_3d(dst + cb * ROWS * 128 + rb * kWBox * 128, map,
                        64 * cb, r0 + rb * kWBox, b, bar);
}

// The producer warpgroup of either side: its first thread loads the own
// tiles once, then each stage's X (and Y) tiles (and, with tma_bias, the
// mask tile) by TMA once both consumers have released it; its 128 threads
// write the stage's row data (0 past L) and, without tma_bias (L % 4 != 0
// or a bias that is not 16-byte aligned), the mask tile by plain loads,
// then arrive. vb, db: the batch's V and dO (D_v = 2).
template <class F, bool KV>
__device__ __forceinline__ void bw_produce(
    unsigned char* smem, uint32_t s0, int base, const CUtensorMap* ta0,
    const CUtensorMap* ta1, const CUtensorMap* tx, const CUtensorMap* ty,
    const CUtensorMap* tb, bool tma_bias, const float* __restrict__ biasb,
    int bm, const float* __restrict__ lse, const float* __restrict__ delta,
    const typename F::TV* __restrict__ vb,
    const typename F::TV* __restrict__ db, int L) {
  using S = BwW<F>;
  constexpr int N = S::n, NS = S::stages;
  constexpr int MR = KV ? N : kWOwn, MC = KV ? kWOwn : N;  // mask tile
  const int p = threadIdx.x - 256, b = blockIdx.y;
  const size_t so = (size_t)b * L;
  auto bar = [&](int i) { return s0 + 8 * i; };
  const int n_tiles = (L + N - 1) / N;
  if (p == 0) {
    sm90::mbar_expect_tx(bar(S::bar_own), S::mats * S::own);
    bw_tma_rows<kWOwn>(s0 + S::a0, ta0, base, b, bar(S::bar_own));
    if constexpr (F::wide)
      bw_tma_rows<kWOwn>(s0 + S::a1, ta1, base, b, bar(S::bar_own));
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS, j0 = j * N;
    const uint32_t st = S::st0 + s * S::stage;
    const int row0 = KV ? j0 : base, col0 = KV ? base : j0;  // the mask's
    if (j >= NS) sm90::mbar_wait(bar(S::empty + s), (j / NS - 1) & 1);
    float* rd = reinterpret_cast<float*>(smem + st + S::r);
    static_assert(2 * N == 128, "a producer thread an element of each row");
    if constexpr (KV) {  // lse, Delta; D_v = 2: dO
      const int q = j0 + (p & (N - 1));
      rd[p] = q < L ? (p < N ? lse[so + q] : delta[so + q]) : 0.f;
      if constexpr (!F::wide) rd[2 * N + p] = bw_narrow(db, j0, p, N, L);
    } else if constexpr (!F::wide) {  // V's 2 values of each key
      rd[p] = bw_narrow(vb, j0, p, N, L);
    }
    if constexpr (F::BIAS) {
      if (!tma_bias) {
        for (int i = p; i < MR * MC; i += 128) {
          const int r = i / MC, c = i % MC;
          const int row = row0 + r, col = col0 + c;
          *reinterpret_cast<float*>(smem + st + S::m + bw_mask_at(r, c, MR)) =
              (row < L && col < L) ? __ldg(biasb + (size_t)row * L + col)
                                   : 0.f;
        }
      }
    }
    if (p == 0) {
      const uint32_t full = bar(S::full + s);
      sm90::mbar_expect_tx(full, S::mats * S::tile +
                                     (F::BIAS && tma_bias ? S::mask : 0));
      bw_tma_rows<N>(s0 + st + S::x, tx, j0, b, full);
      if constexpr (F::wide) bw_tma_rows<N>(s0 + st + S::y, ty, j0, b, full);
      if (F::BIAS && tma_bias) {
#pragma unroll
        for (int cb = 0; cb < MC / 32; ++cb)
#pragma unroll
          for (int rb = 0; rb < MR / kWBox; ++rb)
            sm90::tma_load_3d(s0 + st + S::m + cb * MR * 128 +
                                  rb * kWBox * 128,
                              tb, col0 + 32 * cb, row0 + rb * kWBox,
                              b % bm, full);
      }
    } else {
      sm90::mbar_arrive(bar(S::full + s));
    }
  }
}

// A consumer warpgroup of either side: its 64 own rows (from 64 wg of the
// block's) against every streamed tile. dQ side (KV false): S = Q K^T and
// dP = dO V^T (A0 = Q, A1 = dO; X = K, Y = V), dS = P (dP - Delta), dQ +=
// dS K. dK / dV side: S^T = K Q^T and dP^T = V dO^T (A0 = K, A1 = V; X =
// Q, Y = dO), dV += P~^T dO, dK += dS^T Q. S and dP run on wgmma
// m64n64k16 with both operands K-major in shared memory; the products
// over the streamed rows take P~ (P rounded to bf16) and dS (bf16 hi + lo,
// lo first) from the accumulators' registers as the A operand and X or Y
// as the MN-major B (m64n128k16). At D_v = 2 the 2-wide products (dP, and
// dV summed in each lane over its queries, then over its quad) are FMAs on
// the score registers, the lane's own dO (V) in registers and the
// streamed rows' V (dO) in the stage's row data. A wgmma accumulator gives
// lane 4 g + t, per 8-column group j, the elements (g, 8j + 2t), (g, 8j +
// 2t + 1), (g + 8, 8j + 2t), (g + 8, 8j + 2t + 1) of its warp's 16 rows:
// the A fragment's layout once packed to bf16 pairs. Each tile's products
// are waited for before the next tile's: the other consumer warpgroup's
// products run meanwhile.
template <class F, bool KV>
__device__ __forceinline__ void bw_consume(
    const unsigned char* smem, uint32_t s0, int base,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const typename F::TV* __restrict__ vb,
    const typename F::TV* __restrict__ db, bf16* __restrict__ out0,
    typename F::TV* __restrict__ out1, int L, float scale_log2,
    float scale) {
  using S = BwW<F>;
  constexpr bool kWide = F::wide;
  constexpr int N = S::n, NS = S::stages, NK = N / 16;
  constexpr int MR = KV ? N : kWOwn;  // the mask tile's rows
  auto bar = [&](int i) { return s0 + 8 * i; };
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 64 * wg + 16 * ((tid >> 5) & 3);  // the warp's first row
  const int b = blockIdx.y, n_tiles = (L + N - 1) / N;
  const size_t so = (size_t)b * L;
  // dQ side: the own rows' lse and Delta; D_v = 2: the own rows' dO (dQ
  // side) or V (dK / dV side)
  float lse2[2] = {0.f, 0.f}, dlt2[2] = {0.f, 0.f}, own2[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = base + wr + g + 8 * h;
    if (!KV && row < L) {
      lse2[h] = lse[so + row];
      dlt2[h] = delta[so + row];
    }
    own2[h][0] = kWide ? 0.f : bw_narrow(KV ? vb : db, row, 0, 1, L);
    own2[h][1] = kWide ? 0.f : bw_narrow(KV ? vb : db, row, 1, 1, L);
  }
  constexpr bool kDvMma = KV && kWide, kDvFma = KV && !kWide && F::DVOUT;
  float acc0[64];                        // dQ, or dK
  float acc1[kDvMma ? 64 : 1];           // dV
  float dva[4] = {0.f, 0.f, 0.f, 0.f};  // D_v = 2: the lane's dV sums
  float sa[N / 2], dp[N / 2];  // S and dP of one tile, then P and dS
  uint32_t dsh[NK][4], dsl[NK][4], pp[kDvMma ? NK : 1][4];
  // the lane's byte offsets in a mask tile (bw_mask_at), own row r = wr + g
  // + 8 h. dQ side: float2 (r, 8 j + 2 t ..) at moff[h][j % 4] + (j / 4) *
  // 128 R; dK / dV side: (query 8 j + 2 t + e, key r) at moff[h][e] + 1024 j
  uint32_t moff[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wr + g + 8 * h;
#pragma unroll
    for (int m = 0; m < 4; ++m)
      moff[h][m] =
          KV ? (m < 2 ? bw_mask_at(2 * t + m, r, MR) : 0)
             : r * 128 + (((2 * m) ^ (t >> 1) ^ g) << 4) + 8 * (t & 1);
  }
  sm90::mbar_wait(bar(S::bar_own), 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS, j0 = it * N;
    const uint32_t st = S::st0 + s * S::stage;
    sm90::mbar_wait(bar(S::full + s), (it / NS) & 1);
    sm90::wg_fence();
#pragma unroll
    for (int ks = 0; ks < kBD / 16; ++ks)
      sm90::WgSS<N, 0, 0>::mma(sa, sm90::desc_k(s0 + S::a0, kWOwn, 64 * wg, ks),
                               sm90::desc_k(s0 + st + S::x, N, 0, ks), ks > 0);
    if constexpr (kWide) {
#pragma unroll
      for (int ks = 0; ks < kBD / 16; ++ks)
        sm90::WgSS<N, 0, 0>::mma(
            dp, sm90::desc_k(s0 + S::a1, kWOwn, 64 * wg, ks),
            sm90::desc_k(s0 + st + S::y, N, 0, ks), ks > 0);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(sa);
    sm90::fence_regs(dp);

    // P = 2^(x - lse), x = the scaled score (+ bias) in log2 units, ragged
    // streamed rows -inf; dS = P (dP - Delta); both packed as the A
    // fragments of the products over the streamed rows
    const unsigned char* mt = smem + st + S::m;
    const float* rd = reinterpret_cast<const float*>(smem + st + S::r);
    const bool ragged = j0 + N > L;
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      float w4[4];  // D_v = 2: the streamed rows 8 j + 2 t, + 1's 2 values
      if constexpr (!kWide) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            rd + (KV ? 2 * N : 0) + 16 * j + 4 * t);
        w4[0] = v4.x;
        w4[1] = v4.y;
        w4[2] = v4.z;
        w4[3] = v4.w;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e, c = 8 * j + 2 * t + (e & 1), h = e >> 1;
        float x = sa[i] * scale_log2;
        if constexpr (F::BIAS)
          x = fmaf(*reinterpret_cast<const float*>(
                       mt + (KV ? moff[h][e & 1] + 1024 * j
                                : moff[h][j & 3] + 4 * (e & 1) +
                                      MR * 128 * (j >> 2))),
                   kLog2e, x);
        if (ragged && j0 + c >= L) x = -INFINITY;
        const float pv = ex2(x - (KV ? rd[c] : lse2[h]));
        float dpv;
        if constexpr (kWide)
          dpv = dp[i];
        else
          dpv = fmaf(own2[h][1], w4[2 * (e & 1) + 1],
                     own2[h][0] * w4[2 * (e & 1)]);
        if constexpr (kDvFma) {
          const float pr = F::ROUND_P ? round_to<bf16>(pv) : pv;
          dva[2 * h] = fmaf(pr, w4[2 * (e & 1)], dva[2 * h]);
          dva[2 * h + 1] = fmaf(pr, w4[2 * (e & 1) + 1], dva[2 * h + 1]);
        }
        sa[i] = pv;
        dp[i] = pv * (dpv - (KV ? rd[N + c] : dlt2[h]));
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = (j & 1) * 2 + h;
        sm90::split_bf16(dp[4 * j + 2 * h], dp[4 * j + 2 * h + 1],
                         dsh[j >> 1][f], dsl[j >> 1][f]);
        if constexpr (kDvMma)
          pp[j >> 1][f] =
              sm90::pack_bf16(sa[4 * j + 2 * h], sa[4 * j + 2 * h + 1]);
      }
    }
    sm90::wg_fence();
    if constexpr (kDvMma) {
#pragma unroll
      for (int ks = 0; ks < NK; ++ks)
        sm90::WgRS<128, 1>::mma(acc1, pp[ks],
                                sm90::desc_mn(s0 + st + S::y, N, 0, ks),
                                it > 0 || ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) {
      const uint64_t dx = sm90::desc_mn(s0 + st + S::x, N, 0, ks);
      sm90::WgRS<128, 1>::mma(acc0, dsl[ks], dx, it > 0 || ks > 0);
      sm90::WgRS<128, 1>::mma(acc0, dsh[ks], dx, 1);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(acc0);
    if constexpr (kDvMma) sm90::fence_regs(acc1);
    sm90::fence_regs(dsh);
    sm90::fence_regs(dsl);
    sm90::fence_regs(pp);
    sm90::mbar_arrive(bar(S::empty + s));
  }

  if constexpr (kDvFma) {  // the 2-wide dV over the quad's lanes
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dva[e] += __shfl_xor_sync(0xffffffffu, dva[e], w);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = base + wr + g + 8 * h;
    if (row >= L) continue;
    bf16* o0 = out0 + (so + row) * kBD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store2(o0 + 8 * j, acc0[4 * j + 2 * h] * scale,
             acc0[4 * j + 2 * h + 1] * scale);
    if constexpr (kDvMma) {
      bf16* o1 = reinterpret_cast<bf16*>(out1) + (so + row) * kBD + 2 * t;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        store2(o1 + 8 * j, acc1[4 * j + 2 * h], acc1[4 * j + 2 * h + 1]);
    }
    if constexpr (kDvFma) {
      if (t == 0) store2(out1 + (so + row) * 2, dva[2 * h], dva[2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on wgmma, the streamed tiles split (and transposed) on chip
// ---------------------------------------------------------------------------

constexpr int kFRows = 16;  // rows of a streamed f32 tile and of its boxes

// A block's shared memory (f32). The own tiles raw: dQ side Q (and, D_v =
// 128, dO) of 128 rows, 64 KB each; dK / dV side K (and V), 64 rows at
// D_v = 128 (the warpgroups split the outputs), 128 at D_v = 2. Stage s:
// the streamed X (and, D_v = 128, Y) tile (16 rows: dQ side K, V; dK / dV
// side Q, dO) as TF32 hi and lo tiles (TMA lands the raw tile in the lo
// tile, split in place), then X^T (D_v = 128 dK / dV side also Y^T) as
// one 128 x 32 tile: slots 0-15 the hi parts, 16-31 the lo parts, the 16
// streamed rows relabelled within each 8 (slot t row 2 t, slot t + 4 row
// 2 t + 1) so that the accumulators' registers are the A fragments as
// they stand, then the row data (dK / dV side: the 16 queries' lse and
// Delta, and at D_v = 2 their dO; dQ side at D_v = 2: the 16 keys' V).
// Every tile in wgmma's 128-byte swizzle on a 1024-byte boundary.
// mbarriers: the own tiles landed; stage s split (the producer's 128
// threads arrive); stage s released (256); stage s's raw tiles landed.
template <class F, bool KV>
struct BwF {
  static constexpr bool split = KV && F::wide;  // outputs by warpgroup
  static constexpr int own_rows = split ? 64 : 128;
  static constexpr int mats = F::wide ? 2 : 1;
  static constexpr int stages = 2;
  static constexpr uint32_t own = own_rows * kBD * 4;
  static constexpr uint32_t nt = kFRows * kBD * 4;  // 8 KB
  static constexpr uint32_t tt = kBD * 32 * 4;      // 16 KB
  static constexpr uint32_t a0 = 1024, a1 = a0 + own, st0 = a0 + mats * own;
  static constexpr uint32_t xh = 0, xl = nt, yh = 2 * nt, yl = 3 * nt;
  static constexpr uint32_t xt = 2 * mats * nt, yt = xt + tt;
  static constexpr uint32_t r = xt + (split ? 2 : 1) * tt;
  static constexpr int rows_data = KV ? (F::wide ? 2 : 4) : (F::wide ? 0 : 2);
  static constexpr uint32_t stage =
      (r + rows_data * kFRows * 4 + 1023) / 1024 * 1024;
  // D_v = 128 dK / dV side: two buffers of the warpgroups' exchange, P^T
  // and dP^T (each thread's 8 values, 4 KB a warpgroup)
  static constexpr uint32_t xch = st0 + stages * stage;
  static constexpr int bytes = xch + (split ? 2 * 2 * 4096 : 0) + 1024;
  static_assert(bytes <= 232448, "227 KB a block");
  static constexpr int bar_own = 0, full = 1, empty = 1 + stages,
                       raw = 1 + 2 * stages;
};

// rows r0 .. r0 + ROWS of a (B, L, 128) f32 tensor map (16-row boxes) into
// an am_at tile of ROWS rows at dst (rows past L are zero-filled)
template <int ROWS>
__device__ __forceinline__ void bwf_tma_rows(uint32_t dst, const void* map,
                                             int r0, int b, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < 4; ++cb)
#pragma unroll
    for (int rb = 0; rb < ROWS / kFRows; ++rb)
      sm90::tma_load_3d(dst + cb * ROWS * 128 + rb * kFRows * 128, map,
                        32 * cb, r0 + rb * kFRows, b, bar);
}

// The f32 producer warpgroup: its first thread loads the own tiles, then
// each stage's raw X (and Y) tiles by TMA a tile ahead; its 128 threads
// split them into TF32 hi and lo in place, write X^T (and Y^T) from them,
// and the stage's row data (0 past L).
template <class F, bool KV>
__device__ __forceinline__ void bwf_produce(
    unsigned char* smem, uint32_t s0, int base, const CUtensorMap* ta0,
    const CUtensorMap* ta1, const CUtensorMap* tx, const CUtensorMap* ty,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const typename F::TV* __restrict__ vb,
    const typename F::TV* __restrict__ db, int L) {
  using S = BwF<F, KV>;
  constexpr int NS = S::stages;
  const int p = threadIdx.x - 256, b = blockIdx.y;
  const size_t so = (size_t)b * L;
  auto bar = [&](int i) { return s0 + 8 * i; };
  const int n_tiles = (L + kFRows - 1) / kFRows;
  auto issue = [&](int j) {  // tile j's raw X (and Y) into its lo tiles
    const uint32_t st = s0 + S::st0 + (j % NS) * S::stage;
    const uint32_t rb = bar(S::raw + j % NS);
    sm90::mbar_expect_tx(rb, S::mats * S::nt);
    bwf_tma_rows<kFRows>(st + S::xl, tx, j * kFRows, b, rb);
    if constexpr (F::wide)
      bwf_tma_rows<kFRows>(st + S::yl, ty, j * kFRows, b, rb);
  };
  if (p == 0) {
    sm90::mbar_expect_tx(bar(S::bar_own), S::mats * S::own);
    bwf_tma_rows<S::own_rows>(s0 + S::a0, ta0, base, b, bar(S::bar_own));
    if constexpr (F::wide)
      bwf_tma_rows<S::own_rows>(s0 + S::a1, ta1, base, b, bar(S::bar_own));
    issue(0);
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % NS, j0 = j * kFRows;
    unsigned char* st = smem + S::st0 + s * S::stage;
    float* rd = reinterpret_cast<float*>(st + S::r);
    if (p < 2 * kFRows) {
      if constexpr (KV) {  // lse, Delta; D_v = 2: dO
        const int q = j0 + (p & (kFRows - 1));
        rd[p] = q < L ? (p < kFRows ? lse[so + q] : delta[so + q]) : 0.f;
        if constexpr (!F::wide)
          rd[2 * kFRows + p] = bw_narrow(db, j0, p, kFRows, L);
      } else if constexpr (!F::wide) {  // V's 2 values of each key
        rd[p] = bw_narrow(vb, j0, p, kFRows, L);
      }
    }
    sm90::mbar_wait(bar(S::raw + s), (j / NS) & 1);
    // the raw tiles and the split ones share a layout: split in place
#pragma unroll 2
    for (int i = p; i < S::mats * kFRows * 32; i += 128) {
      const uint32_t o = (i < kFRows * 32 ? 0 : 2 * S::nt) + 16 * (i & 511);
      uint4* lo = reinterpret_cast<uint4*>(st + S::xl + o);
      uint4 x = *lo, hi;
      sm90::split_tf32_4(x, hi);
      *reinterpret_cast<uint4*>(st + S::xh + o) = hi;
      *lo = x;
    }
    sm90::named_sync(1, 128);  // the split tiles, read by every thread
    // X^T (Y^T): row n (of 128), 16-byte chunk c < 4 the hi parts of rows
    // 8 (c / 2) + 2 e + (c % 2), e < 4, of the natural tile, chunk 4 + c
    // their lo parts; a natural tile's (row r, column n) sits at am_at(r,
    // n / 4, 16) + 4 (n % 4)
#pragma unroll 1
    for (int i = p; i < (S::split ? 2 : 1) * kBD * 4; i += 128) {
      const int n = i & 127, c = (i >> 7) & 3, m = i >> 9;
      const unsigned char* hs = st + (m ? S::yh : S::xh);
      uint32_t vh[4], vl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * (c >> 1) + 2 * e + (c & 1);
        const uint32_t o = sm90::am_at(r, n >> 2, kFRows) + 4 * (n & 3);
        vh[e] = *reinterpret_cast<const uint32_t*>(hs + o);
        vl[e] = *reinterpret_cast<const uint32_t*>(hs + S::nt + o);
      }
      unsigned char* ts = st + (m ? S::yt : S::xt);
      *reinterpret_cast<uint4*>(ts + sm90::am_at(n, c, kBD)) =
          make_uint4(vh[0], vh[1], vh[2], vh[3]);
      *reinterpret_cast<uint4*>(ts + sm90::am_at(n, 4 + c, kBD)) =
          make_uint4(vl[0], vl[1], vl[2], vl[3]);
    }
    sm90::fence_async_smem();  // the split tiles, to wgmma
    sm90::mbar_arrive(bar(S::full + s));
    if (j + 1 < n_tiles) {  // tile j + 1 into the stage tile j - 1 held
      if (j + 1 >= NS)
        sm90::mbar_wait(bar(S::empty + (j + 1) % NS), ((j + 1) / NS - 1) & 1);
      if (p == 0) issue(j + 1);
    }
  }
}

// s[m] (the warpgroup's 64 x 16 of one streamed tile) = A_m X_m^T over
// the 128 columns in 3xTF32, for NM pairs (S and dP together: their k
// steps interleaved, 3 NM m64n16k8 a k step): A's fragments by ldmatrix
// from its raw f32 tile (ROWS rows, the warp's 16 from wr; an 8 x 8 b16
// matrix is 8 rows of 4 f32, the TF32 A fragment's), split in registers
// into hi bits (the tensor core reads x + 0x1000 as x rounded to TF32) and
// lo, in one of kFSets register sets, each rewritten only once the k step
// that read it has landed, so that kFSets - 1 k steps stay in flight while
// the next one's fragments load; X_m's hi and lo tiles K-major. The tensor core's adds truncate, so no long
// sum runs through it: the two small terms in one chain over all 16 k
// steps (sl), the hi x hi products in chains of kFChain k steps from zero,
// in one of two sets, each added to s in f32 once it has landed.
constexpr int kFChain = 4, kFSets = 3;

template <int NM>
__device__ __forceinline__ void bwf_chain_add(float (&s)[NM][8],
                                              float (&part)[NM][8],
                                              bool first) {
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    sm90::fence_regs(part[m]);
#pragma unroll
    for (int i = 0; i < 8; ++i)
      s[m][i] = first ? part[m][i] : s[m][i] + part[m][i];
  }
}

template <int ROWS, int NM>
__device__ __forceinline__ void bwf_scores(float (&s)[NM][8],
                                           const uint32_t (&sa)[NM], int wr,
                                           const uint32_t (&xh)[NM],
                                           const uint32_t (&xl)[NM]) {
  constexpr int C = kFChain, F = kFSets, KS = kBD / 8;
  // a chain's part set is rewritten only after the chain has been added
  static_assert(C >= F - 1, "chains cover the k steps in flight");
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  float sl[NM][8], part[2][NM][8];
  uint32_t ah[F][NM][4], al[F][NM][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const int f = ks % F;
    if (ks >= F) {
      sm90::wg_wait<F - 1>();  // k step ks - F landed
      if ((ks - F) % C == C - 1)
        bwf_chain_add<NM>(s, part[((ks - F) / C) & 1], ks - F == C - 1);
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      uint32_t a[4];
      sm90::ldsm_x4(sa[m] + sm90::am_at(wr + (mi & 1) * 8 + mr,
                                        2 * ks + (mi >> 1), ROWS),
                    a);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ah[f][m][e] = sm90::tf32_hi_bits(a[e]);
        al[f][m][e] = sm90::tf32_lo_of_hi(ah[f][m][e]);
      }
    }
    sm90::wg_fence();
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      const uint64_t bh = sm90::desc_k_at(sm90::desc_k(xh[m], kFRows, 0, 0),
                                          kFRows, ks);
      const uint64_t bl = sm90::desc_k_at(sm90::desc_k(xl[m], kFRows, 0, 0),
                                          kFRows, ks);
      sm90::WgTf32<16>::mma(part[(ks / C) & 1][m], ah[f][m], bh, ks % C);
      sm90::WgTf32<16>::mma(sl[m], ah[f][m], bl, ks > 0);
      sm90::WgTf32<16>::mma(sl[m], al[f][m], bh, 1);
    }
    sm90::wg_commit();
  }
  sm90::wg_wait<0>();
#pragma unroll
  for (int k = KS - F; k < KS; ++k)  // the chains not added yet, in order
    if (k % C == C - 1) bwf_chain_add<NM>(s, part[(k / C) & 1], k == C - 1);
#pragma unroll
  for (int m = 0; m < NM; ++m) {
    sm90::fence_regs(sl[m]);
#pragma unroll
    for (int i = 0; i < 8; ++i) s[m][i] += sl[m][i];
  }
}

// An f32 consumer warpgroup. dQ side (KV false): 64 of the block's 128
// query rows, S = Q K^T and dP = dO V^T (A0 = Q, A1 = dO; X = K, Y = V),
// dS = P (dP - Delta), dQ += dS K (B: X^T). dK / dV side at D_v = 128:
// both warpgroups own the block's 64 keys; warpgroup 0 computes S^T = K
// Q^T and P^T, warpgroup 1 dP^T = V dO^T, and they swap them through
// shared memory (each thread's values, read back by the same thread of the
// other warpgroup: the same accumulator positions), one named barrier a
// tile; then warpgroup 0 dS^T and dK += dS^T Q (B: X^T = Q^T), warpgroup 1
// dV += P^T dO (B: Y^T = dO^T). At D_v = 2 the warpgroups own 64 rows
// each on both sides and the 2-wide products (dP, dV) are FMAs on the
// score registers, as the bf16 kernel's. Each tile's product over its 16
// streamed rows (two k steps of three TF32 terms, A from the accumulator
// registers: relabelled, (c0, c2, c1, c3) is the A fragment) runs from
// zero into `part`, added to the gradient in f32 once it has landed. The
// mask values of a tile are loaded into registers before its scores.
template <class F, bool KV>
__device__ __forceinline__ void bwf_consume(
    const unsigned char* smem, uint32_t s0, int base,
    const float* __restrict__ biasb, const float* __restrict__ lse,
    const float* __restrict__ delta, const float* __restrict__ vb,
    const float* __restrict__ db, float* __restrict__ out0,
    float* __restrict__ out1, int L, float scale_log2, float scale) {
  using S = BwF<F, KV>;
  constexpr bool kWide = F::wide, kSplit = S::split;
  constexpr bool kDvFma = KV && !kWide && F::DVOUT;
  constexpr int NS = S::stages, R = S::own_rows;
  auto bar = [&](int i) { return s0 + 8 * i; };
  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = (kSplit ? 0 : 64 * wg) + 16 * ((tid >> 5) & 3);
  const bool ds_role = !kSplit || wg == 0;  // dS (dQ, dK), else P (dV)
  const int b = blockIdx.y, n_tiles = (L + kFRows - 1) / kFRows;
  const size_t so = (size_t)b * L;
  // dQ side: the own rows' lse and Delta; D_v = 2: the own rows' dO (dQ
  // side) or V (dK / dV side)
  float lse2[2] = {0.f, 0.f}, dlt2[2] = {0.f, 0.f}, own2[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = base + wr + g + 8 * h;
    if (!KV && row < L) {
      lse2[h] = lse[so + row];
      dlt2[h] = delta[so + row];
    }
    own2[h][0] = kWide ? 0.f : bw_narrow(KV ? vb : db, row, 0, 1, L);
    own2[h][1] = kWide ? 0.f : bw_narrow(KV ? vb : db, row, 1, 1, L);
  }
  float acc[64], part[64];
  float dva[4] = {0.f, 0.f, 0.f, 0.f};  // D_v = 2: the lane's dV sums
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  sm90::mbar_wait(bar(S::bar_own), 0);

  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % NS, j0 = it * kFRows;
    const uint32_t st = S::st0 + s * S::stage;
    // element 4 j + e: own row wr + g + 8 (e / 2), streamed row 8 j + 2 t +
    // e % 2
    float mb[8];
    if (F::BIAS && ds_role) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = base + wr + g + 8 * ((i & 3) >> 1);
        const int c = j0 + 8 * (i >> 2) + 2 * t + (i & 1);
        mb[i] = (r < L && c < L)
                    ? __ldg(biasb + (KV ? (size_t)c * L + r : (size_t)r * L + c))
                    : 0.f;
      }
    }
    sm90::mbar_wait(bar(S::full + s), (it / NS) & 1);
    float sd[2][8];  // S and dP (dQ side, D_v = 128); else S^T or dP^T
    if (!KV && kWide) {
      const uint32_t a[2] = {s0 + S::a0, s0 + S::a1};
      const uint32_t xh[2] = {s0 + st + S::xh, s0 + st + S::yh};
      const uint32_t xl[2] = {s0 + st + S::xl, s0 + st + S::yl};
      bwf_scores<R, 2>(sd, a, wr, xh, xl);
    } else {
      const bool y = kSplit && wg;
      const uint32_t a[1] = {s0 + (y ? S::a1 : S::a0)},
                     xh[1] = {s0 + st + (y ? S::yh : S::xh)},
                     xl[1] = {s0 + st + (y ? S::yl : S::xl)};
      bwf_scores<R, 1>(reinterpret_cast<float(&)[1][8]>(sd), a, wr, xh, xl);
    }
    const float* rd = reinterpret_cast<const float*>(smem + st + S::r);
    const bool ragged = j0 + kFRows > L;
    // D_v = 2: the streamed rows 8 j + 2 t, + 1's 2 values (V or dO)
    float w4[2][4];
    if constexpr (!kWide) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(
            rd + (KV ? 2 * kFRows : 0) + 16 * j + 4 * t);
        w4[j][0] = v4.x;
        w4[j][1] = v4.y;
        w4[j][2] = v4.z;
        w4[j][3] = v4.w;
      }
    }
    // element 4 j + e: P, then dS (or, dK / dV side, warpgroup 1: P)
    float v[8];
    if (ds_role) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);
        float x = sd[0][i] * scale_log2;
        if constexpr (F::BIAS) x = fmaf(mb[i], kLog2e, x);
        if (ragged && j0 + c >= L) x = -INFINITY;
        v[i] = ex2(x - (KV ? rd[c] : lse2[(i & 3) >> 1]));
      }
    }
    float dpv[8];
    if constexpr (kSplit) {  // swap P^T (warpgroup 0) and dP^T (warpgroup 1)
      float* xc = reinterpret_cast<float*>(
          const_cast<unsigned char*>(smem) + S::xch + (it & 1) * 8192 +
          ((tid & 127) << 5));
      float4* mine = reinterpret_cast<float4*>(xc + wg * 1024);
      float w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) w[i] = wg ? sd[0][i] : v[i];
      mine[0] = make_float4(w[0], w[1], w[2], w[3]);
      mine[1] = make_float4(w[4], w[5], w[6], w[7]);
      sm90::named_sync(2, 256);
      const float4* theirs = reinterpret_cast<const float4*>(
          xc + (wg ^ 1) * 1024);
      const float4 o0 = theirs[0], o1 = theirs[1];
      const float o[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (wg) v[i] = o[i];  // P^T, dV's A
        dpv[i] = o[i];
      }
    } else if constexpr (kWide) {
#pragma unroll
      for (int i = 0; i < 8; ++i) dpv[i] = sd[1][i];
    } else {  // the 2-wide dP (and dV) in FMAs
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = i >> 2, e = i & 3, h = e >> 1, k2 = 2 * (e & 1);
        dpv[i] = fmaf(own2[h][1], w4[j][k2 + 1], own2[h][0] * w4[j][k2]);
        if constexpr (kDvFma) {
          dva[2 * h] = fmaf(v[i], w4[j][k2], dva[2 * h]);
          dva[2 * h + 1] = fmaf(v[i], w4[j][k2 + 1], dva[2 * h + 1]);
        }
      }
    }
    if (ds_role) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int c = 8 * (i >> 2) + 2 * t + (i & 1);
        v[i] *= dpv[i] - (KV ? rd[kFRows + c] : dlt2[(i & 3) >> 1]);
      }
    }
    uint32_t fh[2][4], fl[2][4];  // v as A fragments: hi bits, lo
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint32_t e4[4] = {
          __float_as_uint(v[4 * j]), __float_as_uint(v[4 * j + 2]),
          __float_as_uint(v[4 * j + 1]), __float_as_uint(v[4 * j + 3])};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fh[j][e] = sm90::tf32_hi_bits(e4[e]);
        fl[j][e] = sm90::tf32_lo_of_hi(fh[j][e]);
      }
    }
    const uint64_t dt =
        sm90::desc_k(s0 + st + (ds_role ? S::xt : S::yt), kBD, 0, 0);
    sm90::wg_fence();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const uint64_t bh = sm90::desc_k_at(dt, kBD, j);
      sm90::WgTf32<128>::mma(part, fh[j], bh, j > 0);
      sm90::WgTf32<128>::mma(part, fh[j], sm90::desc_k_at(dt, kBD, 2 + j), 1);
      sm90::WgTf32<128>::mma(part, fl[j], bh, 1);
    }
    sm90::wg_commit();
    sm90::wg_wait<0>();
    sm90::fence_regs(part);
    sm90::fence_regs(fh);
    sm90::fence_regs(fl);
    sm90::mbar_arrive(bar(S::empty + s));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  if constexpr (kDvFma) {  // the 2-wide dV over the quad's lanes
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dva[e] += __shfl_xor_sync(0xffffffffu, dva[e], w);
  }
  float* out = ds_role ? out0 : out1;
  const float sc = ds_role ? scale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = base + wr + g + 8 * h;
    if (row >= L) continue;
    float* o = out + (so + row) * kBD + 2 * t;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      store2(o + 8 * j, acc[4 * j + 2 * h] * sc, acc[4 * j + 2 * h + 1] * sc);
    if constexpr (kDvFma) {
      if (t == 0) store2(out1 + (so + row) * 2, dva[2 * h], dva[2 * h + 1]);
    }
  }
}

// Both sides in one grid of (nq + nk, B) blocks of 384 threads: blocks x <
// nq own query rows (dQ), the rest keys (dK, dV); warpgroups 0 and 1
// consume (setmaxnreg 232), warpgroup 2 produces (40). nq = ceil(L / 128),
// nk = ceil(L / 128), ceil(L / 64) for the f32 D_v = 128 forms. Tensor
// maps of q, k and, D_v = 128, v and dO (bf16 64-row boxes, f32 16-row
// ones; the 2-wide forms pass q's in their place and read V and dO
// directly) and, bf16 with tma_bias, of the mask (else q's); the f32
// consumers read the mask themselves.
template <class F>
__global__ void __launch_bounds__(kWThreads, 1)
    attn_bwd_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tb, int tma_bias,
                    const typename F::TV* __restrict__ v, size_t v_bstride,
                    const typename F::TV* __restrict__ dout,
                    const float* __restrict__ bias, int bm,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    typename F::T* __restrict__ dq,
                    typename F::T* __restrict__ dk,
                    typename F::TV* __restrict__ dv, int L, int nq,
                    float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s0 = sm90::smem_u32(smem);
  const int tid = threadIdx.x;
  const bool kv = (int)blockIdx.x >= nq;
  const float* biasb =
      F::BIAS ? bias + (size_t)(blockIdx.y % bm) * (size_t)L * (size_t)L
              : nullptr;
  const typename F::TV* vb = v + (size_t)blockIdx.y * v_bstride;
  const typename F::TV* db = dout + (size_t)blockIdx.y * L * 2;
  if constexpr (is_f32<typename F::T>) {
    const int base = kv ? (blockIdx.x - nq) * BwF<F, true>::own_rows
                        : blockIdx.x * BwF<F, false>::own_rows;
    static_assert(BwF<F, true>::stages == BwF<F, false>::stages &&
                      BwF<F, true>::raw == BwF<F, false>::raw,
                  "one barrier layout");
    using S = BwF<F, false>;
    if (tid == 0) {
      sm90::mbar_init(s0 + 8 * S::bar_own, 1);
      for (int s = 0; s < S::stages; ++s) {
        sm90::mbar_init(s0 + 8 * (S::full + s), 128);
        sm90::mbar_init(s0 + 8 * (S::empty + s), 256);
        sm90::mbar_init(s0 + 8 * (S::raw + s), 1);
      }
      sm90::mbar_fence_init();
    }
    __syncthreads();
    if (tid >= 256) {
      sm90::setmaxnreg_dec<40>();
      if (kv)
        bwf_produce<F, true>(smem, s0, base, &tk, &tv, &tq, &tdo, lse, delta,
                             vb, db, L);
      else
        bwf_produce<F, false>(smem, s0, base, &tq, &tdo, &tk, &tv, lse,
                              delta, vb, db, L);
      return;
    }
    sm90::setmaxnreg_inc<232>();
    if (kv)
      bwf_consume<F, true>(smem, s0, base, biasb, lse, delta, vb, db, dk, dv,
                           L, scale_log2, scale);
    else
      bwf_consume<F, false>(smem, s0, base, biasb, lse, delta, vb, db, dq,
                            nullptr, L, scale_log2, scale);
  } else {
    using S = BwW<F>;
    const int base = (kv ? blockIdx.x - nq : blockIdx.x) * kWOwn;
    if (tid == 0) {
      sm90::mbar_init(s0 + 8 * S::bar_own, 1);
      for (int s = 0; s < S::stages; ++s) {
        sm90::mbar_init(s0 + 8 * (S::full + s), 128);
        sm90::mbar_init(s0 + 8 * (S::empty + s), 256);
      }
      sm90::mbar_fence_init();
    }
    __syncthreads();
    if (tid >= 256) {
      sm90::setmaxnreg_dec<40>();
      if (kv)
        bw_produce<F, true>(smem, s0, base, &tk, &tv, &tq, &tdo, &tb,
                            tma_bias, biasb, bm, lse, delta, vb, db, L);
      else
        bw_produce<F, false>(smem, s0, base, &tq, &tdo, &tk, &tv, &tb,
                             tma_bias, biasb, bm, lse, delta, vb, db, L);
      return;
    }
    sm90::setmaxnreg_inc<232>();
    if (kv)
      bw_consume<F, true>(smem, s0, base, lse, delta, vb, db, dk, dv, L,
                          scale_log2, scale);
    else
      bw_consume<F, false>(smem, s0, base, lse, delta, vb, db, dq, nullptr,
                           L, scale_log2, scale);
  }
}

template <class F>
int launch_attn_bwd(const void* q, const void* k, const void* v,
                    size_t v_bstride, const void* bias, int bm,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int L,
                    float scale, cudaStream_t stream) {
  using T = typename F::T;
  using TV = typename F::TV;
  constexpr bool f32 = is_f32<T>;
  constexpr int fb = BwF<F, false>::bytes > BwF<F, true>::bytes
                         ? BwF<F, false>::bytes
                         : BwF<F, true>::bytes;
  constexpr int bytes = f32 ? fb : BwW<F>::bytes;
  auto kb = attn_bwd_kernel<F>;
  const int box = f32 ? kFRows : kWBox;
  CUtensorMap tq, tk, tv, tdo, tb;
  int err = sm90::tma_map(&tq, q, sizeof(T), kBD, L, B, box);
  if (err == 0) err = sm90::tma_map(&tk, k, sizeof(T), kBD, L, B, box);
  if (err == 0 && F::wide)
    err = sm90::tma_map(&tv, v, sizeof(T), kBD, L, B, box);
  if (err == 0 && F::wide)
    err = sm90::tma_map(&tdo, dout, sizeof(T), kBD, L, B, box);
  if (err != 0) return err;
  if (!F::wide) tv = tdo = tq;
  // bf16: the mask by TMA where its rows are 16-byte aligned, else by plain
  // loads (the map is then q's, unused)
  const bool tma_bias =
      !f32 && F::BIAS &&
      ((L & 3) | (reinterpret_cast<uintptr_t>(bias) & 15)) == 0;
  if (tma_bias)
    err = sm90::tma_map_f32(&tb, bias, L, L, bm, kWBox);
  else
    tb = tq;
  if (err != 0) return err;
  err = (int)cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != 0) return err;
  constexpr int DV = F::wide ? kBD : 2;
  const int rows = B * L;
  constexpr int per = DV == kBD ? kDThreads / 32 : kDThreads;  // rows a block
  attn_bwd_delta_kernel<TV, DV><<<(rows + per - 1) / per, kDThreads, 0,
                                  stream>>>(
      static_cast<const TV*>(out), static_cast<const TV*>(dout),
      static_cast<float*>(delta), rows);
  err = (int)cudaGetLastError();
  if (err != 0) return err;
  const int nq = (L + kWOwn - 1) / kWOwn;
  const int nk = f32 ? (L + BwF<F, true>::own_rows - 1) / BwF<F, true>::own_rows
                     : nq;
  kb<<<dim3(nq + nk, B), kWThreads, bytes, stream>>>(
      tq, tk, tv, tdo, tb, tma_bias ? 1 : 0, static_cast<const TV*>(v),
      v_bstride, static_cast<const TV*>(dout),
      static_cast<const float*>(bias), bm, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<TV*>(dv), L, nq, scale * kLog2e,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace keep

// The backward of keep_attention. dtype: 0 = float32, 1 = bfloat16. q, k,
// dq, dk: (B, L, D); v, out, dout, dv: (B, L, DV) of the same dtype; bias:
// (Bm, L, L) f32 or null; lse: (B, L) f32, the forward's; delta: (B, L) f32
// scratch. D must be 128 and DV 128, or 2 without a bias; q, k (and, DV =
// 128, v and dout) 16-byte aligned. Two kernels on the stream; returns a
// cudaError_t value (0 = ok).
extern "C" int keep_attention_bwd(const void* q, const void* k, const void* v,
                                  const void* bias, const void* out,
                                  const void* dout, const void* lse,
                                  void* delta, void* dq, void* dk, void* dv,
                                  int B, int L, int D, int DV, int Bm,
                                  float scale, int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != kBD || B < 1 || L < 1 || (bias != nullptr && Bm < 1))
    return (int)cudaErrorInvalidValue;
  const size_t vb = (size_t)L * DV;
#define KEEP_BWD(T, TV, DVV, BIAS, RP)                                   \
  launch_attn_bwd<BwForm<T, TV, DVV, BIAS, RP, true>>(                   \
      q, k, v, vb, bias, Bm, out, dout, lse, delta, dq, dk, dv, B, L, scale, \
      st)
  if (DV == kBD) {
    if (dtype == 0)
      return bias ? KEEP_BWD(float, float, kBD, true, false)
                  : KEEP_BWD(float, float, kBD, false, false);
    if (dtype == 1)
      return bias ? KEEP_BWD(bf16, bf16, kBD, true, true)
                  : KEEP_BWD(bf16, bf16, kBD, false, true);
  } else if (DV == 2 && bias == nullptr) {
    if (dtype == 0) return KEEP_BWD(float, float, 2, false, false);
    if (dtype == 1) return KEEP_BWD(bf16, bf16, 2, false, true);
  }
#undef KEEP_BWD
  return (int)cudaErrorInvalidValue;
}

// The backward of keep_corr_expectation: f0, f1, df0, df1: (B, L, C) of
// dtype, C = 128, 16-byte aligned; grid: (L, 2) f32 (no gradient); out,
// dout: (B, L, 2) f32; lse: (B, L) f32, the forward's; delta: (B, L) f32
// scratch.
extern "C" int keep_corr_expectation_bwd(const void* f0, const void* f1,
                                         const void* grid, const void* out,
                                         const void* dout, const void* lse,
                                         void* delta, void* df0, void* df1,
                                         int B, int L, int C, float scale,
                                         int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kBD || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_attn_bwd<BwForm<float, float, 2, false, false, false>>(
        f0, f1, grid, 0, nullptr, 1, out, dout, lse, delta, df0, df1,
        nullptr, B, L, scale, st);
  if (dtype == 1)
    return launch_attn_bwd<BwForm<bf16, float, 2, false, false, false>>(
        f0, f1, grid, 0, nullptr, 1, out, dout, lse, delta, df0, df1,
        nullptr, B, L, scale, st);
  return (int)cudaErrorInvalidValue;
}
