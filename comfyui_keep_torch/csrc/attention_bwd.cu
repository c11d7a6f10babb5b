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
// A call is two kernels: attn_bwd_delta_kernel writes Delta, then
// attn_bwd_kernel does the rest in one grid of (2 ceil(L / 128), B) blocks
// of 8 warps. No float atomics, so a call is bitwise repeatable: a block
// owns 128 rows of one side (16 a warp), staged once in shared memory, and
// loops over the other side's tiles, double-buffered by 16-byte cp.async.
//   * dQ blocks (x < ceil(L / 128)) own query rows (Q and, D_v = 128, dO)
//     and stream key tiles of K and V (64 keys in bf16, 32 in f32): S = Q
//     K^T and dP = dO V^T as the warp's 16-row accumulator fragments, P and
//     dS on those registers, dQ += dS K.
//   * dK / dV blocks own keys (K and, D_v = 128, V) and stream 32-query
//     tiles (64 in the 2-wide bf16 forms) of Q and dO with their lse and
//     Delta: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T on the registers,
//     dV += P^T dO and dK += dS^T Q.
// Both sides share the grid so that their blocks fill the waves together
// (each side alone at B = 8, L = 3072 is 192 blocks: 1.45 waves of 132).
// So the design does seven L x L x 128 products where five are the least
// (Q K^T and dO V^T on both sides), and the accumulators stay in registers:
// dQ 64 a lane, dK and dV 128 (hence the 32-query tiles).
//
// What bounds it on the H100: mma.sync and the registers. The accumulators
// leave no room to load fragments ahead, and every warp reads the whole
// streamed tile (16-row warp tiles): wgmma, with 64-row warpgroups reading
// B from shared memory, is the next step.
//   * bf16 (mixed precision): Q, K, V and dO are bf16, so Q K^T, dO V^T and
//     P~^T dO (P~ = P rounded to bf16, as the forward rounds it before P V)
//     are exact products on m16n8k16 with f32 sums, the forward's fragments:
//     operands by ldmatrix (ldmatrix.trans for the [key][d] side of dQ, dK,
//     dV) from swizzled tiles (chunk c of row r at c ^ (r & 7)), the
//     accumulator layout reused as the next product's A operand. Only dS is
//     an f32 value: it enters dQ = dS K and dK = dS^T Q as a bf16 hi part
//     plus a bf16 lo part (16 mantissa bits), two mmas a product, so that
//     the gradients' one rounding to bf16, at the end, is the only one of
//     their size (dS rounded once would add 2^-9 of each term).
//   * f32: 3xTF32 on m16n8k8: each operand x = hi + lo, hi x rounded to 11
//     significant bits and lo the rest, split in registers as its fragment
//     is loaded (one f32 copy of each tile in shared memory), a b = a_lo b_hi
//     + a_hi b_lo + a_hi b_hi. A single TF32 product stands about a
//     thousand times the plain backward's distance to float64 (a CPU model
//     of the rounding, tests/test_torch_kernel_backward.py). The tensor
//     core's adds truncate, so no long sum runs through it: hi x hi sums
//     carried over the whole 128-deep row stood up to 4.3x the plain
//     backward's distance on the H100, the source's chains at most 2.6x
//     (tools/torch_attention_bwd_variants.py; bw_nt and bw_nn_f32 say how
//     the chains are cut). The f32 tiles take ldmatrix too (an 8 x 8 b16
//     matrix is 8 rows of 4 f32: the TF32 A and B fragments' layout),
//     except the [key][d] side of the products over keys or queries, read
//     as scalars: with the k index relabelled (slot t the key 2 t, slot
//     t + 4 the key 2 t + 1) the accumulator layout is the A layout, and
//     those reads fall in 32 distinct banks of the swizzled tile. The
//     splits (three operations a register) and the f32 adds make this form
//     issue-bound: about five instructions a mma by count.
// The 2-wide products (dO V^T and dV at D_v = 2, K3's grid) stay FMAs on
// the score registers, V's 2-wide slice (or dO's) staged beside the tile.
// The shifted-window mask is staged by cp.async a tile ahead, swizzled so
// that both sides read it without bank conflicts. Shared memory a block
// (own rows, own second tile, two buffers of each streamed tile and of the
// mask): dQ side bf16 128 KB (+64 KB with the mask), f32 192 KB (+32 KB);
// dK / dV side bf16 97 KB (+32 KB), f32 193 KB (+32 KB); the 2-wide forms
// less. One block an SM. bf16 inputs give bf16 gradients, rounded once.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

constexpr int kBD = 128;        // q/k width the kernels are built for
constexpr int kBRows = 128;     // rows a block owns: 8 warps x 16
constexpr int kBThreads = 256;
// 3xTF32 chain lengths (k steps of 8) of the hi x hi products of S = Q K^T
// (D_v = 128; the 2-wide forms') and dP = dO V^T before each is added to
// its f32 accumulator (bw_nt): the longest that held the gate with margin
// at the step's and the tests' shapes on the H100 (one k step throughout
// took 1.1x the time: more f32 adds; tools/torch_attention_bwd_variants.py)
constexpr int kSChain = 2, kDpChain = 4, kSChainNarrow = 4;

// a dQ block's shared memory: own Q, own dO (D_v = 128), two key tiles
// of K and two of V (D_v = 2: V's 2-wide slice as f32), two of the mask
// (BIAS: [128 queries][keys] f32)
template <typename T, int DV, bool BIAS>
struct BwSmemQ {
  static constexpr bool wide = DV == kBD;
  static constexpr int rb = kBD * (int)sizeof(T);  // bytes a row: 256 / 512
  // keys a tile: 32 in f32 (the 227 KB when wide; registers when narrow)
  static constexpr int keys = is_f32<T> ? 32 : 64;
  static constexpr uint32_t tile = keys * rb;
  static constexpr uint32_t btile = BIAS ? kBRows * keys * 4 : 0;
  static constexpr uint32_t dout = kBRows * rb;
  static constexpr uint32_t k = dout + (wide ? kBRows * rb : 0);
  static constexpr uint32_t v = k + 2 * tile;
  static constexpr uint32_t bias = v + (wide ? 2 * tile : 2 * keys * 2 * 4);
  static constexpr uint32_t bytes = bias + 2 * btile;
};

// a dK / dV block's: own K, own V (D_v = 128), two query tiles of Q and
// two of dO (D_v = 128), two buffers of the tile's row data (lse, Delta,
// D_v = 2: dO, 4 x the tile's queries), two of the mask (BIAS: [queries]
// [128 keys] f32)
template <typename T, int DV, bool BIAS>
struct BwSmemKV {
  static constexpr bool wide = DV == kBD;
  static constexpr int rb = kBD * (int)sizeof(T);
  // queries a tile: 32 when wide (dK and dV take 128 registers) or f32
  // (64 measured 1.1x slower at D_v = 2), 64 for the 2-wide bf16 forms
  static constexpr int queries = wide || is_f32<T> ? 32 : 64;
  static constexpr uint32_t tile = queries * rb;
  static constexpr uint32_t btile = BIAS ? queries * kBRows * 4 : 0;
  static constexpr uint32_t v = kBRows * rb;
  static constexpr uint32_t q = v + (wide ? kBRows * rb : 0);
  static constexpr uint32_t dout = q + 2 * tile;
  static constexpr uint32_t small = dout + (wide ? 2 * tile : 0);
  static constexpr uint32_t bias = small + 2 * 4 * queries * 4;
  static constexpr uint32_t bytes = bias + 2 * btile;
};

// rows [r0, r0 + ROWS) of a (L, 128) matrix of T into a swizzled tile at
// shared address dst by 16-byte cp.async (the caller commits); rows at or
// past L are zero-filled
template <typename T, int ROWS>
__device__ __forceinline__ void bw_load(uint32_t dst, const T* src, int r0,
                                        int L) {
  constexpr int RB = kBD * (int)sizeof(T), CH = RB / 16;
  static_assert(ROWS * CH % kBThreads == 0, "whole rounds of the block");
#pragma unroll
  for (int i0 = 0; i0 < ROWS * CH; i0 += kBThreads) {
    const int i = i0 + threadIdx.x, r = i / CH, c = i % CH;
    const bool ok = r0 + r < L;
    sm90::cp_async16(dst + sm90::swz(r, c, RB),
                     src + (size_t)(ok ? r0 + r : 0) * kBD +
                         c * (16 / sizeof(T)),
                     ok ? 16 : 0);
  }
}

// element i (< 2 n) of the 2-wide rows [r0, r0 + n) of a (L, 2) matrix
// (row r0 + i / 2, column i % 2) as a float, 0 past L
template <typename TV>
__device__ __forceinline__ float bw_narrow(const TV* m, int r0, int i, int n,
                                           int L) {
  return (i < 2 * n && r0 + i / 2 < L) ? to_f(m[(size_t)r0 * 2 + i]) : 0.f;
}

// acc (the warp's 16 x 8 NT accumulator fragments) += A B^T over the
// 128-wide rows: A rows a0 .. a0 + 15 of the tile at sa, B rows 0 .. 8 NT -
// 1 of the tile at sb, both swizzled with 128 T a row; d ascending. bf16:
// m16n8k16. f32: 3xTF32 on m16n8k8, both operands split as loaded, the NT
// tiles' chains interleaved (rounds of NT independent mmas). The tensor
// core's adds truncate, so no f32 sum runs long through it: the hi x hi
// products run in chains of G k steps (8 G terms) from zero, each then
// added to acc in f32, rounded to nearest; the two small terms (2^-11 of
// the product) run in one chain over all 128, added once at the end
template <typename T, int NT, int G>
__device__ __forceinline__ void bw_nt(float (&acc)[NT][4], uint32_t sa,
                                      int a0, uint32_t sb) {
  constexpr int RB = kBD * (int)sizeof(T);
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
  constexpr int NF = is_f32<T> ? NT : 1;
  float part[NF][4], small[NF][4];  // f32: the chains' sums
#pragma unroll
  for (int ks = 0; ks < RB / 32; ++ks) {  // two 16-byte chunks a k step
    uint32_t a[4];
    sm90::ldsm_x4(sa + sm90::swz(a0 + (mi & 1) * 8 + mr, 2 * ks + (mi >> 1),
                                 RB), a);
    if constexpr (is_f32<T>) {
      uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
#pragma unroll
      for (int e = 0; e < 4; ++e) sm90::split_tf32(a[e], ah[e], al[e]);
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        sm90::ldsm_x4(sb + sm90::swz(16 * p + (mi >> 1) * 8 + mr,
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
    } else {
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t b[4];
        sm90::ldsm_x4(sb + sm90::swz(16 * p + (mi >> 1) * 8 + mr,
                                     2 * ks + (mi & 1), RB), b);
        sm90::mma_bf16(acc[2 * p], a, b[0], b[1]);
        sm90::mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
      }
    }
  }
  if constexpr (is_f32<T>) {
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += small[n][e];
  }
}

// acc (16 x 128) += A M, bf16: A the warp's 16 x 8 NT operand as A
// fragments per 16-wide k step (hi, and lo when SPLIT), M rows 0 .. 8 NT -
// 1 of the swizzled bf16 tile at sm by ldmatrix.trans
template <int NT, bool SPLIT>
__device__ __forceinline__ void bw_nn_bf16(float (&acc)[16][4],
                                           const uint32_t (&ah)[NT / 2][4],
                                           const uint32_t (&al)[NT / 2][4],
                                           uint32_t sm) {
  constexpr int RB = kBD * 2;
  const int lane = threadIdx.x & 31, mi = lane >> 3, mr = lane & 7;
#pragma unroll
  for (int s = 0; s < NT / 2; ++s) {
#pragma unroll
    for (int p = 0; p < 8; ++p) {
      uint32_t b[4];  // rows 16 s .. 16 s + 15 x columns of d tiles 2p, 2p+1
      sm90::ldsm_x4_t(sm + sm90::swz(16 * s + (mi & 1) * 8 + mr,
                                     2 * p + (mi >> 1), RB), b);
      if constexpr (SPLIT) {
        sm90::mma_bf16(acc[2 * p], al[s], b[0], b[1]);
        sm90::mma_bf16(acc[2 * p + 1], al[s], b[2], b[3]);
      }
      sm90::mma_bf16(acc[2 * p], ah[s], b[0], b[1]);
      sm90::mma_bf16(acc[2 * p + 1], ah[s], b[2], b[3]);
    }
  }
}

// the same in f32 by 3xTF32: A the warp's 16 x 8 NT operand in accumulator
// layout (a[j] the n8 tile j), M rows 0 .. 8 NT - 1 of the swizzled f32
// tile at smem + off. k step j relabels its k slots: slot t is row 8 j + 2 t
// of M, slot t + 4 row 8 j + 2 t + 1, so a[j] = (c0, c1, c2, c3) is the A
// fragment (c0, c2, c1, c3). M's B fragments are scalar reads: b0 = M[8 j +
// 2 t][8 n + g], b1 = M[8 j + 2 t + 1][8 n + g], conflict-free in the
// swizzle (chunk 2 (n ^ t) + (g >> 2) ^ e of row 8 j + 2 t + e). Four d
// tiles at a time, their chains interleaved, each over 4 k steps (32 rows
// of M) from zero, then added to acc in f32.
template <int NT>
__device__ __forceinline__ void bw_nn_f32(float (&acc)[16][4],
                                          const float (&a)[NT][4],
                                          const unsigned char* smem,
                                          uint32_t off) {
  constexpr int RB = kBD * 4;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the lane's byte offsets of row 2 t + e, column 8 n + g for n % 4 = m
  uint32_t base[2][4];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      base[e][m] = off + (2 * t + e) * RB +
                   ((2 * (m ^ t) + ((g >> 2) ^ e)) << 4) + 4 * (g & 3);
  constexpr int JG = NT < 4 ? NT : 4;  // k steps a chain
#pragma unroll
  for (int j0 = 0; j0 < NT; j0 += JG) {
    uint32_t ah[JG][4], al[JG][4];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj) {
      const int j = j0 + jj;
      sm90::split_tf32(__float_as_uint(a[j][0]), ah[jj][0], al[jj][0]);
      sm90::split_tf32(__float_as_uint(a[j][2]), ah[jj][1], al[jj][1]);
      sm90::split_tf32(__float_as_uint(a[j][1]), ah[jj][2], al[jj][2]);
      sm90::split_tf32(__float_as_uint(a[j][3]), ah[jj][3], al[jj][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < 16; n0 += 4) {
      float part[4][4];
#pragma unroll
      for (int jj = 0; jj < JG; ++jj) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint32_t o = 8 * (j0 + jj) * RB + n0 * 32;
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sm90::split_tf32(
                *reinterpret_cast<const uint32_t*>(smem + base[e][m] + o),
                bh[m][e], bl[m][e]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          if (jj == 0)
            sm90::mma_tf32_0(part[m], al[jj], bh[m][0], bh[m][1]);
          else
            sm90::mma_tf32(part[m], al[jj], bh[m][0], bh[m][1]);
        }
#pragma unroll
        for (int m = 0; m < 4; ++m)
          sm90::mma_tf32(part[m], ah[jj], bl[m][0], bl[m][1]);
#pragma unroll
        for (int m = 0; m < 4; ++m)
          sm90::mma_tf32(part[m], ah[jj], bh[m][0], bh[m][1]);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + m][e] += part[m][e];
    }
  }
}

// a[j] (the warp's 16 x 8 NT f32 fragments) as bf16 A fragments per
// 16-wide k step: hi, and the remainders lo when SPLIT
template <int NT, bool SPLIT>
__device__ __forceinline__ void bw_frags_bf16(const float (&a)[NT][4],
                                              uint32_t (&ah)[NT / 2][4],
                                              uint32_t (&al)[NT / 2][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t& hi = ah[j >> 1][(j & 1) * 2 + h];
      if constexpr (SPLIT)
        sm90::split_bf16(a[j][2 * h], a[j][2 * h + 1], hi,
                         al[j >> 1][(j & 1) * 2 + h]);
      else
        hi = sm90::pack_bf16(a[j][2 * h], a[j][2 * h + 1]);
    }
  }
}

// dQ += scale dS K, or dK += scale dS^T Q, from the f32 dS fragments and
// the streamed tile (rows the other side's) at byte offset off
template <typename T, int NT>
__device__ __forceinline__ void bw_ds_product(float (&acc)[16][4],
                                              const float (&ds)[NT][4],
                                              const unsigned char* smem,
                                              uint32_t off) {
  if constexpr (is_f32<T>) {
    bw_nn_f32<NT>(acc, ds, smem, off);
  } else {
    uint32_t ah[NT / 2][4], al[NT / 2][4];
    bw_frags_bf16<NT, true>(ds, ah, al);
    bw_nn_bf16<NT, true>(acc, ah, al, sm90::smem_u32(smem) + off);
  }
}

// The mask's tiles, staged by cp.async a tile ahead: a [rows][cols] f32
// tile of bias[row0 + r][col0 + c], 0 past L, whose 16-byte chunk c of row
// r sits at chunk c ^ X(r). The dQ side reads float2 pairs at (query g,
// keys 8 j + 2 t ..) with X(r) = 2 (r % 4); the dK / dV side reads it
// transposed, scalars at (query 8 n + 2 t + e, key g) with X(r) = 2 ((r / 2)
// % 4): both conflict-free. Rows that are not 16-byte aligned (L % 4 != 0)
// go through registers.
__device__ __forceinline__ int bw_xq(int r) { return (r & 3) << 1; }
__device__ __forceinline__ int bw_xkv(int r) { return ((r >> 1) & 3) << 1; }

template <int ROWS, int COLS, bool KV>
__device__ __forceinline__ void bw_stage_bias(unsigned char* smem,
                                              uint32_t off,
                                              const float* biasb, int row0,
                                              int col0, int L) {
  constexpr int CH = COLS / 4;
  if ((L & 3) == 0) {
    const uint32_t dst = sm90::smem_u32(smem) + off;
#pragma unroll
    for (int i0 = 0; i0 < ROWS * CH; i0 += kBThreads) {
      const int i = i0 + threadIdx.x, r = i / CH, c = i % CH;
      const int row = row0 + r, col = col0 + 4 * c;
      const bool ok = row < L && col < L;
      const int x = KV ? bw_xkv(r) : bw_xq(r);
      sm90::cp_async16(dst + 16 * (r * CH + (c ^ x)),
                       biasb + (ok ? (size_t)row * L + col : 0), ok ? 16 : 0);
    }
  } else {
    float* tl = reinterpret_cast<float*>(smem + off);
    for (int i = threadIdx.x; i < ROWS * COLS; i += kBThreads) {
      const int r = i / COLS, c = i % COLS;
      const int row = row0 + r, col = col0 + c;
      const int x = KV ? bw_xkv(r) : bw_xq(r);
      tl[4 * (r * CH + ((c >> 2) ^ x)) + (c & 3)] =
          (row < L && col < L) ? __ldg(biasb + (size_t)row * L + col) : 0.f;
    }
  }
}

// Delta = rowsum(dO o O) of the B L rows of out, dout: (rows, DV) of TV,
// f32, summed in order along the row (D_v = 128: a warp a row, 4 values a
// lane, then the shuffle tree). 256 threads a block.
template <typename TV, int DV>
__global__ void __launch_bounds__(kBThreads)
    attn_bwd_delta_kernel(const TV* __restrict__ out,
                          const TV* __restrict__ dout,
                          float* __restrict__ delta, int rows) {
  if constexpr (DV == kBD) {
    const int row = blockIdx.x * (kBThreads / 32) + (threadIdx.x >> 5);
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
    const int row = blockIdx.x * kBThreads + threadIdx.x;
    if (row >= rows) return;
    delta[row] = fmaf(to_f(dout[(size_t)row * 2 + 1]),
                      to_f(out[(size_t)row * 2 + 1]),
                      to_f(dout[(size_t)row * 2]) * to_f(out[(size_t)row * 2]));
  }
}

// One block of the dQ side. q, k: (B, L, 128) of T; v, dout: (B, L, DV) of
// TV, v at batch stride v_bstride elements (0: one V for the batch); bias:
// (Bm, L, L) f32 for BIAS (D_v = 128 only); lse: (B, L) f32 log2-sum-exp2 of
// the forward; delta: (B, L) f32, the Delta kernel's; dq: (B, L, 128) of T.
// Block bx of batch blockIdx.y owns query rows 128 bx ..; warp w owns rows
// 16 w .. 16 w + 15 of those, and lane 4 g + t holds rows g and g + 8 of
// each 8-column fragment, columns 2 t and 2 t + 1 (mma.sync's accumulator
// layout).
template <typename T, typename TV, int DV, bool BIAS>
__device__ __forceinline__ void bw_dq_block(
    unsigned char* smem, int bx, const T* __restrict__ q,
    const T* __restrict__ k, const TV* __restrict__ v, size_t v_bstride,
    const float* __restrict__ bias, int bm, const TV* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int L, float scale_log2, float scale) {
  using S = BwSmemQ<T, DV, BIAS>;
  constexpr bool kWide = S::wide;
  constexpr int KN = S::keys, NT = KN / 8;
  static_assert(kWide || !BIAS, "no form takes a bias with a 2-wide V");
  static_assert(!kWide || sizeof(T) == sizeof(TV), "one dtype when wide");
  const uint32_t s0 = sm90::smem_u32(smem);
  float* Vn = reinterpret_cast<float*>(smem + S::v);  // narrow: [2][KN][2]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = bx * kBRows, wr = 16 * warp;
  const int row0 = q0 + wr + g;  // this lane's rows: row0, row0 + 8
  const size_t so = (size_t)b * L;
  const size_t bo = so * kBD;
  const TV* vb = v + (size_t)b * v_bstride;
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;

  bw_load<T, kBRows>(s0, q + bo, q0, L);
  if constexpr (kWide) bw_load<TV, kBRows>(s0 + S::dout, dout + bo, q0, L);
  bw_load<T, KN>(s0 + S::k, k + bo, 0, L);
  if constexpr (kWide) bw_load<TV, KN>(s0 + S::v, vb, 0, L);
  else if (tid < 2 * KN) Vn[tid] = bw_narrow(vb, 0, tid, KN, L);
  if constexpr (BIAS)
    bw_stage_bias<kBRows, KN, false>(smem, S::bias, biasb, q0, 0, L);
  sm90::cp_async_commit();

  // the lane's rows' lse, Delta and (narrow) dO
  float lse2[2], dlt[2], dor[2][2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool ok = row < L;
    lse2[h] = ok ? lse[so + row] : 0.f;
    dlt[h] = ok ? delta[so + row] : 0.f;
    dor[h][0] = kWide || !ok ? 0.f : to_f(dout[(so + row) * 2]);
    dor[h][1] = kWide || !ok ? 0.f : to_f(dout[(so + row) * 2 + 1]);
  }

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int n_tiles = (L + KN - 1) / KN;
  // the lane's float offsets in the staged mask tile: row r = wr + g + 8 h,
  // keys 8 j + 2 t, + 1 sit at r KN + 2 t + 8 (j ^ (g % 4)) (bw_xq)
  int boff[2], xj[4];
#pragma unroll
  for (int h = 0; h < 2; ++h) boff[h] = (wr + g + 8 * h) * KN + 2 * t;
#pragma unroll
  for (int m = 0; m < 4; ++m) xj[m] = 8 * (m ^ (g & 3));

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * KN, buf = it & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every warp left tile it - 1
    float vn = 0.f;
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      bw_load<T, KN>(s0 + S::k + (buf ^ 1) * S::tile, k + bo, k0 + KN, L);
      if constexpr (kWide)
        bw_load<TV, KN>(s0 + S::v + (buf ^ 1) * S::tile, vb, k0 + KN, L);
      else if (tid < 2 * KN)
        vn = bw_narrow(vb, k0 + KN, tid, KN, L);
      if constexpr (BIAS)
        bw_stage_bias<kBRows, KN, false>(smem, S::bias + (buf ^ 1) * S::btile,
                                         biasb, q0, k0 + KN, L);
    }
    sm90::cp_async_commit();
    const uint32_t kt = S::k + buf * S::tile;
    const float* bt =
        reinterpret_cast<const float*>(smem + S::bias + buf * S::btile);

    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    bw_nt<T, NT, kWide ? kSChain : kSChainNarrow>(s, s0, wr, s0 + kt);
    if constexpr (kWide) {
      bw_nt<T, NT, kDpChain>(dp, s0 + S::dout, wr, s0 + S::v + buf * S::tile);
    } else {
      const float* vt = Vn + buf * 2 * KN;
#pragma unroll
      for (int j = 0; j < NT; ++j) {  // V of keys 8 j + 2 t, 8 j + 2 t + 1
        const float4 v4 = *reinterpret_cast<const float4*>(vt + 16 * j + 4 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dp[j][2 * h] = fmaf(dor[h][1], v4.y, dor[h][0] * v4.x);
          dp[j][2 * h + 1] = fmaf(dor[h][1], v4.w, dor[h][0] * v4.z);
        }
      }
    }
    // P rebuilt from the scores and lse; dS = P (dP - Delta) over s
    float bq[BIAS ? NT : 1][4];  // bias[row][key] of the staged tile
    if constexpr (BIAS) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 b2 = *reinterpret_cast<const float2*>(
              bt + boff[h] + 32 * (j >> 2) + xj[j & 3]);
          bq[j][2 * h] = b2.x;
          bq[j][2 * h + 1] = b2.y;
        }
    }
    const bool ragged = k0 + KN > L;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if constexpr (BIAS) x += bq[j][e] * kLog2e;
        if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= L) x = -INFINITY;
        s[j][e] = ex2(x - lse2[e >> 1]) * (dp[j][e] - dlt[e >> 1]);
      }
    bw_ds_product<T, NT>(acc, s, smem, kt);  // dQ += dS K
    // narrow: V's slice of tile it + 1 into the buffer of it - 1, which
    // every warp left before this tile's barrier; read after the next one
    if constexpr (!kWide) {
      if (it + 1 < n_tiles && tid < 2 * KN) Vn[(buf ^ 1) * 2 * KN + tid] = vn;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= L) continue;
    T* drow = dq + (so + row) * kBD + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      store2(drow + 8 * n, acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
  }
}

// One block of the dK / dV side: arguments as bw_dq_block's, and dk: (B,
// L, 128) of T, dv: (B, L, DV) of TV (DVOUT; K3 has none). Block bx owns
// keys 128 bx ..; warp w owns keys 16 w .. 16 w + 15 of those, in the
// layout of the dQ side's query rows. ROUND_P rounds P to bf16 in dV, as
// the forward rounds it before P V.
template <typename T, typename TV, int DV, bool BIAS, bool ROUND_P,
          bool DVOUT>
__device__ __forceinline__ void bw_dkdv_block(
    unsigned char* smem, int bx, const T* __restrict__ q,
    const T* __restrict__ k, const TV* __restrict__ v, size_t v_bstride,
    const float* __restrict__ bias, int bm, const TV* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, TV* __restrict__ dv, int L, float scale_log2,
    float scale) {
  using S = BwSmemKV<T, DV, BIAS>;
  constexpr bool kWide = S::wide;
  constexpr int QN = S::queries, NT = QN / 8;
  static_assert(kWide || !BIAS, "no form takes a bias with a 2-wide V");
  static_assert(!kWide || sizeof(T) == sizeof(TV), "one dtype when wide");
  static_assert(!ROUND_P || !is_f32<TV>, "P is rounded to V's dtype");
  const uint32_t s0 = sm90::smem_u32(smem);
  float* Sm = reinterpret_cast<float*>(smem + S::small);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, j0 = bx * kBRows, wr = 16 * warp;
  const int key0 = j0 + wr + g;  // this lane's keys: key0, key0 + 8
  const size_t so = (size_t)b * L;
  const size_t bo = so * kBD;
  const TV* vb = v + (size_t)b * v_bstride;
  const TV* db = dout + so * DV;
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;

  // this thread's element of the row data of the query tile at i0
  auto small = [&](int i0) -> float {
    if (tid < QN) return i0 + tid < L ? lse[so + i0 + tid] : 0.f;
    if (tid < 2 * QN)
      return i0 + tid - QN < L ? delta[so + i0 + tid - QN] : 0.f;
    if constexpr (!kWide) return bw_narrow(db, i0, tid - 2 * QN, QN, L);
    return 0.f;
  };

  bw_load<T, kBRows>(s0, k + bo, j0, L);
  if constexpr (kWide) bw_load<TV, kBRows>(s0 + S::v, vb, j0, L);
  bw_load<T, QN>(s0 + S::q, q + bo, 0, L);
  if constexpr (kWide) bw_load<TV, QN>(s0 + S::dout, db, 0, L);
  if constexpr (BIAS)
    bw_stage_bias<QN, kBRows, true>(smem, S::bias, biasb, 0, j0, L);
  sm90::cp_async_commit();
  if (tid < 4 * QN) Sm[tid] = small(0);

  float vo[2][2];  // narrow: the lane's keys' V
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key0 + 8 * h;
    vo[h][0] = kWide || row >= L ? 0.f : to_f(vb[(size_t)row * 2]);
    vo[h][1] = kWide || row >= L ? 0.f : to_f(vb[(size_t)row * 2 + 1]);
  }
  constexpr int kDvN = kWide ? 16 : 1;
  float dka[16][4], dva[kDvN][4];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    dka[n][0] = dka[n][1] = dka[n][2] = dka[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < kDvN; ++n)
    dva[n][0] = dva[n][1] = dva[n][2] = dva[n][3] = 0.f;
  const int n_tiles = (L + QN - 1) / QN;
  // the lane's float offsets in the staged mask tile: query 8 n + 2 t + e1,
  // key wr + g + 8 e2 sits at 8 n 128 + koff[e1][e2] (bw_xkv)
  int koff[2][2];
#pragma unroll
  for (int e1 = 0; e1 < 2; ++e1)
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2)
      koff[e1][e2] = (2 * t + e1) * kBRows +
                     4 * ((4 * warp + 2 * e2 + (g >> 2)) ^ (2 * t)) + (g & 3);

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * QN, buf = it & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every warp left tile it - 1
    float sn = 0.f;
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      bw_load<T, QN>(s0 + S::q + (buf ^ 1) * S::tile, q + bo, i0 + QN, L);
      if constexpr (kWide)
        bw_load<TV, QN>(s0 + S::dout + (buf ^ 1) * S::tile, db, i0 + QN, L);
      if (tid < 4 * QN) sn = small(i0 + QN);
      if constexpr (BIAS)
        bw_stage_bias<QN, kBRows, true>(smem, S::bias + (buf ^ 1) * S::btile,
                                        biasb, i0 + QN, j0, L);
    }
    sm90::cp_async_commit();
    const uint32_t qt = S::q + buf * S::tile;
    const float* bt =
        reinterpret_cast<const float*>(smem + S::bias + buf * S::btile);
    const float* sm = Sm + buf * 4 * QN;

    // S^T = K Q^T, dP^T = V dO^T: rows the lane's keys, columns queries
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    bw_nt<T, NT, kWide ? kSChain : kSChainNarrow>(s, s0, wr, s0 + qt);
    if constexpr (kWide) {
      bw_nt<T, NT, kDpChain>(dp, s0 + S::v, wr, s0 + S::dout + buf * S::tile);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n) {  // dO of queries 8 n + 2 t, + 1
        const float4 d4 =
            *reinterpret_cast<const float4*>(sm + 2 * QN + 16 * n + 4 * t);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          dp[n][2 * h] = fmaf(d4.y, vo[h][1], d4.x * vo[h][0]);
          dp[n][2 * h + 1] = fmaf(d4.w, vo[h][1], d4.z * vo[h][0]);
        }
      }
    }
    // P^T from the scores and the queries' lse (into s), dS^T = P^T (dP^T
    // - Delta) (into dp)
    const bool ragged = i0 + QN > L;
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * n + 2 * t + (e & 1);
        float x = s[n][e] * scale_log2;
        if constexpr (BIAS)  // bias[query][key] of the staged tile
          x += bt[8 * kBRows * n + koff[e & 1][e >> 1]] * kLog2e;
        if (ragged && i0 + i >= L) x = -INFINITY;
        s[n][e] = ex2(x - sm[i]);
        dp[n][e] = s[n][e] * (dp[n][e] - sm[QN + i]);
      }
    if constexpr (DVOUT) {
      if constexpr (kWide) {  // dV += P^T dO
        if constexpr (is_f32<T>) {
          bw_nn_f32<NT>(dva, s, smem, S::dout + buf * S::tile);
        } else {
          uint32_t ph[NT / 2][4];
          bw_frags_bf16<NT, false>(s, ph, ph);
          bw_nn_bf16<NT, false>(dva, ph, ph, s0 + S::dout + buf * S::tile);
        }
      } else {  // the lane's partial sums over its queries
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float4 d4 =
              *reinterpret_cast<const float4*>(sm + 2 * QN + 16 * n + 4 * t);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float p0 = s[n][2 * h], p1 = s[n][2 * h + 1];
            if constexpr (ROUND_P) {
              p0 = round_to<bf16>(p0);
              p1 = round_to<bf16>(p1);
            }
            dva[0][2 * h] = fmaf(p1, d4.z, fmaf(p0, d4.x, dva[0][2 * h]));
            dva[0][2 * h + 1] =
                fmaf(p1, d4.w, fmaf(p0, d4.y, dva[0][2 * h + 1]));
          }
        }
      }
    }
    bw_ds_product<T, NT>(dka, dp, smem, qt);  // dK += dS^T Q
    // row data of tile it + 1 into the buffer of it - 1 (see the dQ side)
    if (it + 1 < n_tiles && tid < 4 * QN) Sm[(buf ^ 1) * 4 * QN + tid] = sn;
  }

  if constexpr (DVOUT && !kWide) {  // the narrow dV over the quad's lanes
#pragma unroll
    for (int w = 1; w < 4; w <<= 1)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dva[0][e] += __shfl_xor_sync(0xffffffffu, dva[0][e], w);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = key0 + 8 * h;
    if (row >= L) continue;
    T* krow = dk + (so + row) * kBD + 2 * t;
#pragma unroll
    for (int n = 0; n < 16; ++n)
      store2(krow + 8 * n, dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
    if constexpr (DVOUT) {
      if constexpr (kWide) {
        TV* vrow = dv + (so + row) * DV + 2 * t;
#pragma unroll
        for (int n = 0; n < kDvN; ++n)
          store2(vrow + 8 * n, dva[n][2 * h], dva[n][2 * h + 1]);
      } else if (t == 0) {
        store2(dv + (so + row) * 2, dva[0][2 * h], dva[0][2 * h + 1]);
      }
    }
  }
}

template <typename T, typename TV, int DV, bool BIAS>
constexpr uint32_t bw_smem_bytes() {
  return BwSmemQ<T, DV, BIAS>::bytes > BwSmemKV<T, DV, BIAS>::bytes
             ? BwSmemQ<T, DV, BIAS>::bytes
             : BwSmemKV<T, DV, BIAS>::bytes;
}

// Both sides in one grid, (2 nq, B) blocks of 256 threads: blocks x < nq =
// ceil(L / 128) take the dQ side, the rest the dK / dV side, so the two
// sides' blocks fill the card's waves together (at B = 8, L = 3072 each
// side alone is 192 blocks: 1.45 waves of 132).
template <typename T, typename TV, int DV, bool BIAS, bool ROUND_P,
          bool DVOUT>
__global__ void __launch_bounds__(kBThreads, 1)
    attn_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const TV* __restrict__ v, size_t v_bstride,
                    const float* __restrict__ bias, int bm,
                    const TV* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    T* __restrict__ dk, TV* __restrict__ dv, int L, int nq,
                    float scale_log2, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  if ((int)blockIdx.x < nq)
    bw_dq_block<T, TV, DV, BIAS>(smem, blockIdx.x, q, k, v, v_bstride, bias,
                                 bm, dout, lse, delta, dq, L, scale_log2,
                                 scale);
  else
    bw_dkdv_block<T, TV, DV, BIAS, ROUND_P, DVOUT>(
        smem, blockIdx.x - nq, q, k, v, v_bstride, bias, bm, dout, lse,
        delta, dk, dv, L, scale_log2, scale);
}

template <typename T, typename TV, int DV, bool BIAS, bool ROUND_P,
          bool DVOUT>
int launch_attn_bwd(const void* q, const void* k, const void* v,
                    size_t v_bstride, const void* bias, int bm,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int L,
                    float scale, cudaStream_t stream) {
  constexpr uint32_t kBytes = bw_smem_bytes<T, TV, DV, BIAS>();
  static_assert(kBytes <= 232448, "227 KB a block");
  auto kd = attn_bwd_delta_kernel<TV, DV>;
  auto kb = attn_bwd_kernel<T, TV, DV, BIAS, ROUND_P, DVOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kb, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
  if (err != cudaSuccess) return (int)err;
  const int rows = B * L;
  const int per = DV == kBD ? kBThreads / 32 : kBThreads;  // rows a block
  kd<<<(rows + per - 1) / per, kBThreads, 0, stream>>>(
      static_cast<const TV*>(out), static_cast<const TV*>(dout),
      static_cast<float*>(delta), rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nq = (L + kBRows - 1) / kBRows;
  kb<<<dim3(2 * nq, B), kBThreads, kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const TV*>(v), v_bstride, static_cast<const float*>(bias),
      bm, static_cast<const TV*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<TV*>(dv), L, nq, scale * kLog2e,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace keep

// The backward of keep_attention. dtype: 0 = float32, 1 = bfloat16. q, k,
// dq, dk: (B, L, D); v, out, dout, dv: (B, L, DV) of the same dtype; bias:
// (Bm, L, L) f32 or null; lse: (B, L) f32, the forward's; delta: (B, L) f32
// scratch. D must be 128 and DV 128, or 2 without a bias. Two kernels on the
// stream; returns a cudaError_t value (0 = ok).
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
  if (DV == kBD) {
    if (dtype == 0)
      return bias ? launch_attn_bwd<float, float, kBD, true, false, true>(
                        q, k, v, vb, bias, Bm, out, dout, lse, delta, dq, dk,
                        dv, B, L, scale, st)
                  : launch_attn_bwd<float, float, kBD, false, false, true>(
                        q, k, v, vb, bias, Bm, out, dout, lse, delta, dq, dk,
                        dv, B, L, scale, st);
    if (dtype == 1)
      return bias ? launch_attn_bwd<bf16, bf16, kBD, true, true, true>(
                        q, k, v, vb, bias, Bm, out, dout, lse, delta, dq, dk,
                        dv, B, L, scale, st)
                  : launch_attn_bwd<bf16, bf16, kBD, false, true, true>(
                        q, k, v, vb, bias, Bm, out, dout, lse, delta, dq, dk,
                        dv, B, L, scale, st);
  } else if (DV == 2 && bias == nullptr) {
    if (dtype == 0)
      return launch_attn_bwd<float, float, 2, false, false, true>(
          q, k, v, vb, nullptr, 1, out, dout, lse, delta, dq, dk, dv, B, L,
          scale, st);
    if (dtype == 1)
      return launch_attn_bwd<bf16, bf16, 2, false, true, true>(
          q, k, v, vb, nullptr, 1, out, dout, lse, delta, dq, dk, dv, B, L,
          scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The backward of keep_corr_expectation: f0, f1, df0, df1: (B, L, C) of
// dtype, C = 128; grid: (L, 2) f32 (no gradient); out, dout: (B, L, 2) f32;
// lse: (B, L) f32, the forward's; delta: (B, L) f32 scratch.
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
    return launch_attn_bwd<float, float, 2, false, false, false>(
        f0, f1, grid, 0, nullptr, 1, out, dout, lse, delta, df0, df1,
        nullptr, B, L, scale, st);
  if (dtype == 1)
    return launch_attn_bwd<bf16, float, 2, false, false, false>(
        f0, f1, grid, 0, nullptr, 1, out, dout, lse, delta, df0, df1,
        nullptr, B, L, scale, st);
  return (int)cudaErrorInvalidValue;
}
