// Backward of the single-head flash attention (K1) and of the global
// correlation softmax expectation (K3), for Hopper (sm_90a).
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
// No float atomics, so a call is bitwise repeatable: two kernels a call,
// each a loop inside the block over the other side's tiles.
//   * attn_bwd_dq_kernel: a block owns 64 query rows (Q and, D_v = 128, dO
//     staged once), writes Delta of its rows, and streams 64-key tiles of K
//     and V: S = Q K^T and dP = dO V^T in registers, P and dS there, dS
//     through the warp's rows of a shared tile into dQ += dS K.
//   * attn_bwd_dkdv_kernel: a block owns 64 keys (K and, D_v = 128, V staged
//     once) and streams 64-query tiles of Q and dO with their lse and Delta:
//     S^T = K Q^T and dP^T = V dO^T (the transposed tiles computed as they
//     are used), P^T through the shared tile into dV += P^T dO, then dS^T
//     into dK += dS^T Q. It runs after the first kernel, which wrote Delta.
// The shifted-window mask (Bm, L, L) is staged by cp.async into the score
// tile each step, read in either orientation (the dK/dV kernel reads it
// transposed), and overwritten only after a block barrier.
//
// What bounds it on the H100: f32 FMAs (no TF32, as the f32 forward), 67
// TFLOP/s. The least work of a D_v = 128 call is five L x L x 128 products
// (Q K^T, dO V^T, dV, dQ, dK); this design does seven (Q K^T and dO V^T in
// both kernels). The design is the f32 forward's register-tiled FMA form:
// 8 warps, lane 8 rg + cg of warp w owns rows 8 w + rg + 4 r (r < 2) of the
// block, columns cg + 8 c (c < 8) of a score tile and, in the products that
// accumulate over a tile, columns 4 cg + 32 c4 + e (c4, e < 4) of a 128-wide
// row; operands read as float4 from rows padded to 132 floats (72 for the
// score tile), so a warp's reads fall in distinct banks. Streamed tiles are
// double-buffered by 16-byte cp.async. Six f32 tiles and the score tile
// take 223 KB: one block per SM. bf16 inputs (mixed precision) are
// converted to f32 as they are staged and computed in f32, with the
// forward's rounding of P to bf16 before the P V product kept in dV (K1);
// the gradients are rounded once to the input's dtype.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

constexpr int kBD = 128;           // q/k width the kernels are built for
constexpr int kBRows = 64;         // rows a block owns (queries or keys)
constexpr int kBCols = 64;         // rows of a streamed tile
constexpr int kBThreads = 256;     // 8 warps of 8 rows
constexpr int kBLd = kBD + 4;      // floats per shared row of a 128-wide tile
constexpr int kBLdt = kBCols + 8;  // floats per row of the score tile
constexpr int kBSmall = 256;       // floats of per-tile row data a buffer

// own rows, the second own tile (D_v = 128), two streamed buffers of one or
// two tiles, the score tile, two buffers of per-tile row data: 223 KB wide
template <int DV>
struct BwSmem {
  static constexpr bool wide = DV == kBD;
  static constexpr size_t tile = sizeof(float) * kBRows * kBLd;  // 33,792
  static constexpr size_t own2 = tile;
  static constexpr size_t strm = own2 + (wide ? tile : 0);
  static constexpr size_t strm2 = strm + 2 * tile;
  static constexpr size_t st = strm2 + (wide ? 2 * tile : 0);
  static constexpr size_t small = st + sizeof(float) * kBRows * kBLdt;
  static constexpr size_t bytes = small + sizeof(float) * 2 * kBSmall;
};

// rows [r0, r0 + 64) of a (L, 128) matrix of T into a padded f32 tile at
// byte offset `off` of the shared space, rows at or past L zero: f32 by
// 16-byte cp.async (the caller commits), bf16 by 16-byte loads converted
// and stored at once
template <typename T>
__device__ __forceinline__ void bw_load_rows(unsigned char* smem, size_t off,
                                             const T* src, int r0, int L) {
  if constexpr (is_f32<T>) {
    const uint32_t dst = sm90::smem_u32(smem) + (uint32_t)off;
#pragma unroll
    for (int i0 = 0; i0 < kBRows * 32; i0 += kBThreads) {
      const int i = threadIdx.x + i0, r = i >> 5, c = i & 31;
      const bool ok = r0 + r < L;
      sm90::cp_async16(dst + 4 * (r * kBLd + 4 * c),
                       src + (size_t)(ok ? r0 + r : 0) * kBD + 4 * c,
                       ok ? 16 : 0);
    }
  } else {
    float* dst = reinterpret_cast<float*>(smem + off);
#pragma unroll
    for (int i0 = 0; i0 < kBRows * 16; i0 += kBThreads) {
      const int i = threadIdx.x + i0, r = i >> 4, c = i & 15;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < L)
        u = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * kBD +
                                                 8 * c));
      cvt8(dst + r * kBLd + 8 * c, u);
    }
  }
}

// bias[q0 + r][k0 + c] (r, c < 64) into the score tile ([query][key]), 0
// past L: 16-byte cp.async when rows are 16-byte aligned (L % 4 == 0, the
// caller commits), else plain loads
__device__ __forceinline__ void bw_stage_bias(unsigned char* smem, size_t off,
                                              const float* biasb, int q0,
                                              int k0, int L) {
  if ((L & 3) == 0) {
    const uint32_t dst = sm90::smem_u32(smem) + (uint32_t)off;
#pragma unroll
    for (int i0 = 0; i0 < kBRows * kBCols / 4; i0 += kBThreads) {
      const int i = threadIdx.x + i0, r = i >> 4, c = i & 15;
      const int row = q0 + r, key = k0 + 4 * c;
      const bool ok = row < L && key < L;
      sm90::cp_async16(dst + 4 * (r * kBLdt + 4 * c),
                       biasb + (ok ? (size_t)row * L + key : 0), ok ? 16 : 0);
    }
  } else {
    float* t = reinterpret_cast<float*>(smem + off);
    for (int i = threadIdx.x; i < kBRows * kBCols; i += kBThreads) {
      const int r = i >> 6, c = i & 63;
      const int row = q0 + r, key = k0 + c;
      t[r * kBLdt + c] =
          (row < L && key < L) ? __ldg(biasb + (size_t)row * L + key) : 0.f;
    }
  }
}

// acc[r][c] += sum_{d < DEPTH} A[4 r kBLd + d] B[8 c kBLd + d]: the lane's
// 2 x 8 tile of a product of two row-major tiles over their rows (A at the
// lane's first row, B at its first column's row), float4 reads along d,
// d ascending (the order of the forward's Q K^T)
template <int DEPTH>
__device__ __forceinline__ void bw_nt(float (&acc)[2][8], const float* A,
                                      const float* B) {
#pragma unroll 4
  for (int d = 0; d < DEPTH; d += 4) {
    float4 a[2], b[8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      a[r] = *reinterpret_cast<const float4*>(A + 4 * r * kBLd + d);
#pragma unroll
    for (int c = 0; c < 8; ++c)
      b[c] = *reinterpret_cast<const float4*>(B + 8 * c * kBLd + d);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[r][c] = fmaf(a[r].x, b[c].x, acc[r][c]);
        acc[r][c] = fmaf(a[r].y, b[c].y, acc[r][c]);
        acc[r][c] = fmaf(a[r].z, b[c].z, acc[r][c]);
        acc[r][c] = fmaf(a[r].w, b[c].w, acc[r][c]);
      }
  }
}

// acc[r][4 c4 + e] += sum_{j < 64} T[4 r kBLdt + j] M[j kBLd + 32 c4 + e]:
// the lane's 2 x 16 tile of a score tile times a 128-wide tile (T at the
// lane's first row of the score tile, M at column 4 cg)
__device__ __forceinline__ void bw_nn(float (&acc)[2][16], const float* T,
                                      const float* M) {
#pragma unroll 2
  for (int j = 0; j < kBCols; j += 4) {
    float4 p4[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      p4[r] = *reinterpret_cast<const float4*>(T + 4 * r * kBLdt + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float* mrow = M + (j + jj) * kBLd;
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const float4 mv = *reinterpret_cast<const float4*>(mrow + 32 * c4);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float p = jj == 0 ? p4[r].x : jj == 1 ? p4[r].y
                        : jj == 2 ? p4[r].z : p4[r].w;
          acc[r][4 * c4 + 0] = fmaf(p, mv.x, acc[r][4 * c4 + 0]);
          acc[r][4 * c4 + 1] = fmaf(p, mv.y, acc[r][4 * c4 + 1]);
          acc[r][4 * c4 + 2] = fmaf(p, mv.z, acc[r][4 * c4 + 2]);
          acc[r][4 * c4 + 3] = fmaf(p, mv.w, acc[r][4 * c4 + 3]);
        }
      }
    }
  }
}

// element i (< 128) of the 2-wide rows [r0, r0 + 64) of a (L, 2) matrix
// (row r0 + i / 2, column i % 2) as a float, 0 past L
template <typename TV>
__device__ __forceinline__ float bw_narrow(const TV* m, int r0, int i, int L) {
  return (i < 2 * kBCols && r0 + i / 2 < L) ? to_f(m[(size_t)r0 * 2 + i])
                                            : 0.f;
}

// q, k: (B, L, 128) of T; v, out, dout: (B, L, DV) of TV, v at batch stride
// v_bstride elements (0: one V for the batch); bias: (Bm, L, L) f32 for
// BIAS (D_v = 128 only); lse: (B, L) f32 log2-sum-exp2 of the forward;
// delta: (B, L) f32, written; dq: (B, L, 128) of T. Grid (ceil(L / 64), B),
// 256 threads: a block owns 64 query rows. One cp.async group a step for
// the bias (waited for after the products) and one for the next K / V tile.
template <typename T, typename TV, int DV, bool BIAS>
__global__ void __launch_bounds__(kBThreads, 1)
    attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const TV* __restrict__ v, size_t v_bstride,
                       const float* __restrict__ bias, int bm,
                       const TV* __restrict__ out,
                       const TV* __restrict__ dout,
                       const float* __restrict__ lse,
                       float* __restrict__ delta, T* __restrict__ dq, int L,
                       float scale_log2, float scale) {
  using S = BwSmem<DV>;
  constexpr bool kWide = S::wide;
  static_assert(kWide || !BIAS, "no form takes a bias with a 2-wide V");
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Qs = reinterpret_cast<const float*>(smem);
  const float* dOs = reinterpret_cast<const float*>(smem + S::own2);
  float* St = reinterpret_cast<float*>(smem + S::st);
  float* Vn = reinterpret_cast<float*>(smem + S::small);  // narrow: [2][128]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int b = blockIdx.y, q0 = blockIdx.x * kBRows;
  const int ra = 8 * warp + rg;  // the lane's rows: ra, ra + 4 of the block
  const size_t so = (size_t)b * L;
  const size_t bo = so * kBD;
  const TV* vb = v + (size_t)b * v_bstride;
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;

  bw_load_rows<T>(smem, 0, q + bo, q0, L);
  if constexpr (kWide) bw_load_rows<TV>(smem, S::own2, dout + so * DV, q0, L);
  bw_load_rows<T>(smem, S::strm, k + bo, 0, L);
  if constexpr (kWide) bw_load_rows<TV>(smem, S::strm2, vb, 0, L);
  else if (tid < 2 * kBCols) Vn[tid] = bw_narrow(vb, 0, tid, L);
  sm90::cp_async_commit();
  sm90::cp_async_wait<0>();
  __syncthreads();

  // the own rows' lse, Delta = dO . O (over the row's 8 lanes, D_v = 128)
  // and, narrow, dO
  float lse2[2], dlt[2], dor[2][2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ra + 4 * r;
    const bool ok = row < L;
    lse2[r] = ok ? lse[so + row] : 0.f;
    float d = 0.f;
    dor[r][0] = dor[r][1] = 0.f;
    if (ok) {
      if constexpr (kWide) {
        const TV* orow = out + (so + row) * DV;
        const float* drow = dOs + (ra + 4 * r) * kBLd;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          float o4[4];
          load4(orow + 4 * cg + 32 * c4, o4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            d = fmaf(drow[4 * cg + 32 * c4 + e], o4[e], d);
        }
      } else {
        dor[r][0] = to_f(dout[(so + row) * 2]);
        dor[r][1] = to_f(dout[(so + row) * 2 + 1]);
        d = fmaf(dor[r][1], to_f(out[(so + row) * 2 + 1]),
                 dor[r][0] * to_f(out[(so + row) * 2]));
      }
    }
    dlt[r] = d;
  }
  if constexpr (kWide) {
#pragma unroll
    for (int w = 1; w < 8; w <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        dlt[r] += __shfl_xor_sync(0xffffffffu, dlt[r], w);
  }
  if (cg == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (q0 + ra + 4 * r < L) delta[so + q0 + ra + 4 * r] = dlt[r];
  }

  float acc[2][16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < 16; ++n) acc[r][n] = 0.f;
  const int n_tiles = (L + kBCols - 1) / kBCols;

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = it * kBCols, buf = it & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();  // K / V of tile `it` landed; every warp left tile it - 1
    if constexpr (BIAS) bw_stage_bias(smem, S::st, biasb, q0, k0, L);
    sm90::cp_async_commit();
    float vn = 0.f;
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      bw_load_rows<T>(smem, S::strm + (buf ^ 1) * S::tile, k + bo,
                      k0 + kBCols, L);
      if constexpr (kWide)
        bw_load_rows<TV>(smem, S::strm2 + (buf ^ 1) * S::tile, vb,
                         k0 + kBCols, L);
      else
        vn = bw_narrow(vb, k0 + kBCols, tid, L);
    }
    sm90::cp_async_commit();
    const float* Ks =
        reinterpret_cast<const float*>(smem + S::strm + buf * S::tile);

    float s[2][8], dp[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = dp[r][c] = 0.f;
    bw_nt<kBD>(s, Qs + ra * kBLd, Ks + cg * kBLd);
    if constexpr (kWide) {
      const float* Vs =
          reinterpret_cast<const float*>(smem + S::strm2 + buf * S::tile);
      bw_nt<kBD>(dp, dOs + ra * kBLd, Vs + cg * kBLd);
    } else {
      const float* vt = Vn + buf * 2 * kBCols;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 vv =
            *reinterpret_cast<const float2*>(vt + 2 * (cg + 8 * c));
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dp[r][c] = fmaf(dor[r][1], vv.y, dor[r][0] * vv.x);
      }
    }
    if constexpr (BIAS) {
      sm90::cp_async_wait<1>();  // this thread's bias copies
      __syncthreads();           // everyone's
    }
    // P rebuilt from the scores and lse, dS = P (dP - Delta) into the
    // warp's rows of the score tile (over the bias each lane read there)
    const bool ragged = k0 + kBCols > L;
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        float* sp = St + (ra + 4 * r) * kBLdt + cg + 8 * c;
        float x = s[r][c] * scale_log2;
        if constexpr (BIAS) x += *sp * kLog2e;
        if (ragged && k0 + cg + 8 * c >= L) x = -INFINITY;
        *sp = ex2(x - lse2[r]) * (dp[r][c] - dlt[r]);
      }
    __syncwarp();
    bw_nn(acc, St + ra * kBLdt, Ks + 4 * cg);  // dQ += dS K
    // narrow: slice it + 1 into the buffer of it - 1, which every warp left
    // before this tile's barrier; read after the next one
    if constexpr (!kWide) {
      if (it + 1 < n_tiles && tid < 2 * kBCols)
        Vn[(buf ^ 1) * 2 * kBCols + tid] = vn;
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + ra + 4 * r;
    if (row >= L) continue;
    T* drow = dq + (so + row) * kBD + 4 * cg;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      store4(drow + 32 * c4, acc[r][4 * c4] * scale,
                acc[r][4 * c4 + 1] * scale, acc[r][4 * c4 + 2] * scale,
                acc[r][4 * c4 + 3] * scale);
  }
}

// Arguments as attn_bwd_dq_kernel's, with delta read (the first kernel's)
// and dk: (B, L, 128) of T, dv: (B, L, DV) of TV (DVOUT; K3 has none).
// Grid (ceil(L / 64), B), 256 threads: a block owns 64 keys. ROUND_P
// rounds P to bf16 in dV, as the forward rounds it before P V. The
// per-tile row data: lse [0, 64), Delta [64, 128), narrow dO [128, 256).
template <typename T, typename TV, int DV, bool BIAS, bool ROUND_P,
          bool DVOUT>
__global__ void __launch_bounds__(kBThreads, 1)
    attn_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const TV* __restrict__ v, size_t v_bstride,
                         const float* __restrict__ bias, int bm,
                         const TV* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dk, TV* __restrict__ dv, int L,
                         float scale_log2, float scale) {
  using S = BwSmem<DV>;
  constexpr bool kWide = S::wide;
  static_assert(kWide || !BIAS, "no form takes a bias with a 2-wide V");
  constexpr int kDvN = kWide ? 16 : 2;  // dV columns per lane and row
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Ks = reinterpret_cast<const float*>(smem);
  const float* Vs = reinterpret_cast<const float*>(smem + S::own2);
  float* St = reinterpret_cast<float*>(smem + S::st);
  float* Sm = reinterpret_cast<float*>(smem + S::small);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, cg = lane & 7;
  const int b = blockIdx.y, j0 = blockIdx.x * kBRows;
  const int ra = 8 * warp + rg;  // the lane's keys: ra, ra + 4 of the block
  const size_t so = (size_t)b * L;
  const size_t bo = so * kBD;
  const TV* vb = v + (size_t)b * v_bstride;
  const TV* db = dout + so * DV;
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;

  // this thread's element of the per-tile row data of query tile i0
  auto small = [&](int i0) -> float {
    if (tid < 64) return i0 + tid < L ? lse[so + i0 + tid] : 0.f;
    if (tid < 128) return i0 + tid - 64 < L ? delta[so + i0 + tid - 64] : 0.f;
    if constexpr (!kWide) return bw_narrow(db, i0, tid - 128, L);
    return 0.f;
  };

  bw_load_rows<T>(smem, 0, k + bo, j0, L);
  if constexpr (kWide) bw_load_rows<TV>(smem, S::own2, vb, j0, L);
  bw_load_rows<T>(smem, S::strm, q + bo, 0, L);
  if constexpr (kWide) bw_load_rows<TV>(smem, S::strm2, db, 0, L);
  sm90::cp_async_commit();
  Sm[tid] = small(0);

  float vo[2][2];  // narrow: the own keys' V
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j0 + ra + 4 * r;
    vo[r][0] = kWide || row >= L ? 0.f : to_f(vb[(size_t)row * 2]);
    vo[r][1] = kWide || row >= L ? 0.f : to_f(vb[(size_t)row * 2 + 1]);
  }
  float dka[2][16], dva[2][kDvN];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int n = 0; n < 16; ++n) dka[r][n] = 0.f;
#pragma unroll
    for (int n = 0; n < kDvN; ++n) dva[r][n] = 0.f;
  }
  const int n_tiles = (L + kBCols - 1) / kBCols;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = it * kBCols, buf = it & 1;
    sm90::cp_async_wait<0>();
    __syncthreads();  // Q / dO of tile `it` landed; every warp left it - 1
    if constexpr (BIAS) bw_stage_bias(smem, S::st, biasb, i0, j0, L);
    sm90::cp_async_commit();
    float sn = 0.f;
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      bw_load_rows<T>(smem, S::strm + (buf ^ 1) * S::tile, q + bo,
                      i0 + kBCols, L);
      if constexpr (kWide)
        bw_load_rows<TV>(smem, S::strm2 + (buf ^ 1) * S::tile, db,
                         i0 + kBCols, L);
      sn = small(i0 + kBCols);
    }
    sm90::cp_async_commit();
    const float* Qt =
        reinterpret_cast<const float*>(smem + S::strm + buf * S::tile);
    const float* dOt =
        reinterpret_cast<const float*>(smem + S::strm2 + buf * S::tile);
    const float* sm = Sm + buf * kBSmall;

    // S^T = K Q^T, dP^T = V dO^T: rows the own keys, columns the queries
    float s[2][8], dp[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) s[r][c] = dp[r][c] = 0.f;
    bw_nt<kBD>(s, Ks + ra * kBLd, Qt + cg * kBLd);
    if constexpr (kWide) {
      bw_nt<kBD>(dp, Vs + ra * kBLd, dOt + cg * kBLd);
    } else {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const float2 d2 =
            *reinterpret_cast<const float2*>(sm + 128 + 2 * (cg + 8 * c));
#pragma unroll
        for (int r = 0; r < 2; ++r)
          dp[r][c] = fmaf(d2.y, vo[r][1], d2.x * vo[r][0]);
      }
    }
    if constexpr (BIAS) {
      sm90::cp_async_wait<1>();  // this thread's bias copies
      __syncthreads();           // everyone's
    }
    // P^T from the scores and the queries' lse; dS^T = P^T (dP^T - Delta)
    const bool ragged = i0 + kBCols > L;
    float p[2][8];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const int i = cg + 8 * c;
        float x = s[r][c] * scale_log2;
        if constexpr (BIAS) x += St[i * kBLdt + ra + 4 * r] * kLog2e;
        if (ragged && i0 + i >= L) x = -INFINITY;
        p[r][c] = ex2(x - sm[i]);
        s[r][c] = p[r][c] * (dp[r][c] - sm[64 + i]);
      }
    if constexpr (BIAS) __syncthreads();  // every lane read its bias
    if constexpr (DVOUT) {
      if constexpr (ROUND_P) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            p[r][c] = round_to<bf16>(p[r][c]);
      }
      if constexpr (kWide) {  // dV += P^T dO through the warp's rows
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c)
            St[(ra + 4 * r) * kBLdt + cg + 8 * c] = p[r][c];
        __syncwarp();
        bw_nn(dva, St + ra * kBLdt, dOt + 4 * cg);
        __syncwarp();
      } else {  // the lane's partial sums over its queries
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(sm + 128 + 2 * (cg + 8 * c));
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            dva[r][0] = fmaf(p[r][c], d2.x, dva[r][0]);
            dva[r][1] = fmaf(p[r][c], d2.y, dva[r][1]);
          }
        }
      }
    }
    // dK += dS^T Q through the warp's rows
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c)
        St[(ra + 4 * r) * kBLdt + cg + 8 * c] = s[r][c];
    __syncwarp();
    bw_nn(dka, St + ra * kBLdt, Qt + 4 * cg);
    // row data of it + 1 into the buffer of it - 1 (see the dq kernel)
    if (it + 1 < n_tiles) Sm[(buf ^ 1) * kBSmall + tid] = sn;
  }

  if constexpr (DVOUT && !kWide) {  // the narrow dV over the row's 8 lanes
#pragma unroll
    for (int w = 1; w < 8; w <<= 1)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        dva[r][0] += __shfl_xor_sync(0xffffffffu, dva[r][0], w);
        dva[r][1] += __shfl_xor_sync(0xffffffffu, dva[r][1], w);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = j0 + ra + 4 * r;
    if (row >= L) continue;
    T* krow = dk + (so + row) * kBD + 4 * cg;
#pragma unroll
    for (int c4 = 0; c4 < 4; ++c4)
      store4(krow + 32 * c4, dka[r][4 * c4] * scale,
                dka[r][4 * c4 + 1] * scale, dka[r][4 * c4 + 2] * scale,
                dka[r][4 * c4 + 3] * scale);
    if constexpr (DVOUT) {
      if constexpr (kWide) {
        TV* vrow = dv + (so + row) * DV + 4 * cg;
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4)
          store4(vrow + 32 * c4, dva[r][4 * c4], dva[r][4 * c4 + 1],
                    dva[r][4 * c4 + 2], dva[r][4 * c4 + 3]);
      } else if (cg == 0) {
        dv[(so + row) * 2] = from_f<TV>(dva[r][0]);
        dv[(so + row) * 2 + 1] = from_f<TV>(dva[r][1]);
      }
    }
  }
}

template <typename T, typename TV, int DV, bool BIAS, bool ROUND_P,
          bool DVOUT>
int launch_attn_bwd(const void* q, const void* k, const void* v,
                    size_t v_bstride, const void* bias, int bm,
                    const void* out, const void* dout, const void* lse,
                    void* delta, void* dq, void* dk, void* dv, int B, int L,
                    float scale, cudaStream_t stream) {
  using S = BwSmem<DV>;
  auto kq = attn_bwd_dq_kernel<T, TV, DV, BIAS>;
  auto kkv = attn_bwd_dkdv_kernel<T, TV, DV, BIAS, ROUND_P, DVOUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kBRows - 1) / kBRows, B);
  const float sl2 = scale * kLog2e;
  kq<<<grid, kBThreads, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const TV*>(v), v_bstride, static_cast<const float*>(bias),
      bm, static_cast<const TV*>(out), static_cast<const TV*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<T*>(dq), L, sl2, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kkv<<<grid, kBThreads, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const TV*>(v), v_bstride, static_cast<const float*>(bias),
      bm, static_cast<const TV*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk),
      static_cast<TV*>(dv), L, sl2, scale);
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
