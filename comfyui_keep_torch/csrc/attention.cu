// Flash-style single-head attention for Hopper (sm_90a), and the fused
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
// sum l), P rounded to V's dtype for P V, f32 accumulation, and one
// normalisation after the last key tile.
//
// What bounds it on the H100: at D = 128 the work is ~4 L^2 D flops against
// ~4 L D bytes per batch entry, far above the card's ~295 flop/byte ridge in
// bf16, so the tensor-core rate bounds it, provided the score matrix never
// reaches device memory (1 GB f32 per 20-frame chunk for the global
// attentions alone). The window mask, (4, 1024, 1024) f32 = 16 MB, is read
// once per batch entry and stays in the 50 MB L2.
//
// bf16 with D_v = 128 (the window attentions, 24 launches per chunk):
// flash_attention_bf16_kernel keeps S, P and O in registers. A block of 8
// warps owns 128 query rows, 16 per warp; the warp holds its Q as mma.sync
// A fragments, computes its 16 x 64 score tile with mma.sync m16n8k16 (bf16
// in, f32 out; K fragments by ldmatrix from a swizzled shared tile), runs
// the online softmax on those registers (quad shuffles for the row max and
// sum), rounds P to bf16 in place as the A fragments of P V (the
// accumulator layout is the A layout), and accumulates its 16 x 128 O in
// registers (V fragments by ldmatrix.trans). The bias goes from L2
// straight into the score layout one key tile ahead, so its loads fly
// during the P V and Q K^T products before it is used (loads issued only
// one product ahead stall the softmax: 2.2x the unbiased kernel's time on
// the H100). The next K/V tile
// loads with 16-byte cp.async while this one multiplies (two buffers, one
// __syncthreads a tile). mma.sync rather than wgmma: a 16-row warp tile
// keeps the P -> A reuse in registers with no warpgroup choreography. What
// bounds it now: mma.sync's rate (below wgmma's) and the ldmatrix traffic
// of one shared read of K and V per 16 query rows; at B = 152, L = 1024 it
// runs at ~27 % of the bf16 peak, 1.9x SDPA. A wgmma form with 64-row
// warpgroups and a producer warp is the next step.
//
// The other forms (f32 with D_v = 128, the training step's; the 2-wide
// global flow attention; the correlation expectation) keep the first
// template: one block per 64-query tile stages 64-key tiles, scores go
// through a 64 x 64 f32 shared tile (WMMA for bf16, FMA for f32), two
// threads per query row run the softmax, and O lives in shared memory.
// Narrow V (D_v <= 8) is accumulated in registers by the softmax threads,
// with no padding to 128 lanes.
#include "common.cuh"
#include "sm90.cuh"

namespace keep {

constexpr int kD = 128;    // q/k width the kernel is built for
constexpr int kKeys = 64;  // keys per tile

template <typename T, typename TV, typename TO, int DV, bool NARROW,
          bool ROUND_P>
struct AttnSmem {
  static constexpr int ldq = kD + Pad<T>::v;
  static constexpr int lds = kKeys + 4;
  static constexpr int ldp = kKeys + Pad<T>::v;
  static constexpr int ldv = NARROW ? DV : DV + Pad<TV>::v;
  static constexpr int ldo = DV + 4;
  static constexpr size_t q = 0;
  static constexpr size_t k = q + align128(sizeof(T) * kRows * ldq);
  static constexpr size_t v = k + align128(sizeof(T) * kKeys * ldq);
  static constexpr size_t s = v + align128(sizeof(TV) * kKeys * ldv);
  static constexpr size_t p = s + align128(sizeof(float) * kRows * lds);
  static constexpr size_t o =
      p + (NARROW ? 0 : align128(sizeof(T) * kRows * ldp));
  static constexpr size_t l =
      o + (NARROW ? 0 : align128(sizeof(float) * kRows * ldo));
  static constexpr size_t bytes = l + align128(sizeof(float) * kRows);
};

// q, k: (B, L, 128) of T; v: (B, L, DV) of TV with batch stride v_bstride
// elements (0 = one V shared by the batch); bias: (Bm, L, L) f32 or null;
// out: (B, L, DV) of TO. Grid (ceil(L / 64), B), 128 threads.
template <typename T, typename TV, typename TO, int DV, bool NARROW,
          bool ROUND_P>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const TV* __restrict__ v, size_t v_bstride,
                           const float* __restrict__ bias, int bm,
                           TO* __restrict__ out, int L, float scale_log2) {
  using S = AttnSmem<T, TV, TO, DV, NARROW, ROUND_P>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + S::q);
  T* Ks = reinterpret_cast<T*>(smem + S::k);
  TV* Vs = reinterpret_cast<TV*>(smem + S::v);
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  T* Ps = reinterpret_cast<T*>(smem + S::p);
  float* Os = reinterpret_cast<float*>(smem + S::o);
  float* Ls = reinterpret_cast<float*>(smem + S::l);

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const T* qb = q + (size_t)b * L * kD;
  const T* kb = k + (size_t)b * L * kD;
  const TV* vb = v + (size_t)b * v_bstride;
  const float* biasb =
      bias ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;

  load_tile(Qs, S::ldq, qb, kD, q0, kRows, kD, L);
  if constexpr (!NARROW) {
    for (int i = tid; i < kRows * DV; i += kThreads)
      Os[(i / DV) * S::ldo + i % DV] = 0.0f;
  }

  // two threads per query row: row = tid / 2 owns key columns half*32..+31
  const int row = tid >> 1, half = tid & 1;
  float m_i = -INFINITY, l_i = 0.0f;
  float acc[NARROW ? DV : 1];
#pragma unroll
  for (int d = 0; d < (NARROW ? DV : 1); ++d) acc[d] = 0.0f;

  for (int k0 = 0; k0 < L; k0 += kKeys) {
    __syncthreads();  // previous tile's K/V/P reads are done
    load_tile(Ks, S::ldq, kb, kD, k0, kKeys, kD, L);
    load_tile(Vs, S::ldv, vb, DV, k0, kKeys, DV, L);
    __syncthreads();

    block_gemm<kKeys, kD, true, false>(Qs, S::ldq, Ks, S::ldq, Ss, S::lds);
    __syncthreads();

    // scale, bias and the ragged-tile mask, one coalesced pass
    for (int i = tid; i < kRows * kKeys; i += kThreads) {
      const int r = i / kKeys, c = i % kKeys;
      const int j = k0 + c, qi = q0 + r;
      float s = Ss[r * S::lds + c] * scale_log2;
      if (j >= L)
        s = -INFINITY;
      else if (biasb != nullptr && qi < L)
        s += biasb[(size_t)qi * L + j] * kLog2e;
      Ss[r * S::lds + c] = s;
    }
    __syncthreads();

    // online softmax over this tile's 64 keys
    const float* srow = Ss + row * S::lds + half * 32;
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) mx = fmaxf(mx, srow[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);  // finite: key 0 is always valid
    const float alpha = exp2f(m_i - m_new);
    float sum = 0.0f;
    if constexpr (NARROW) {
#pragma unroll
      for (int d = 0; d < DV; ++d) acc[d] *= alpha;
    }
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const float p = exp2f(srow[c] - m_new);
      sum += p;
      if constexpr (NARROW) {
        const float pv = ROUND_P ? to_f(from_f<T>(p)) : p;
        const TV* vrow = Vs + (half * 32 + c) * S::ldv;
#pragma unroll
        for (int d = 0; d < DV; ++d) acc[d] = fmaf(pv, to_f(vrow[d]), acc[d]);
      } else {
        Ps[row * S::ldp + half * 32 + c] = from_f<T>(p);
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * alpha + sum;
    m_i = m_new;

    if constexpr (!NARROW) {
      float* orow = Os + row * S::ldo + half * (DV / 2);
#pragma unroll 8
      for (int c = 0; c < DV / 2; ++c) orow[c] *= alpha;
      __syncthreads();
      block_gemm<DV, kKeys, false, true>(Ps, S::ldp, Vs, S::ldv, Os, S::ldo);
    }
  }

  if constexpr (NARROW) {
#pragma unroll
    for (int d = 0; d < DV; ++d)
      acc[d] += __shfl_xor_sync(0xffffffffu, acc[d], 1);
    if (half == 0 && q0 + row < L) {
      TO* orow = out + ((size_t)b * L + q0 + row) * DV;
#pragma unroll
      for (int d = 0; d < DV; ++d) orow[d] = from_f<TO>(acc[d] / l_i);
    }
  } else {
    if (half == 0) Ls[row] = l_i;
    __syncthreads();
    for (int i = tid; i < kRows * DV; i += kThreads) {
      const int r = i / DV, c = i % DV;
      if (q0 + r < L)
        out[((size_t)b * L + q0 + r) * DV + c] =
            from_f<TO>(Os[r * S::ldo + c] / Ls[r]);
    }
  }
}

template <typename T, typename TV, typename TO, int DV, bool NARROW,
          bool ROUND_P>
int launch(const void* q, const void* k, const void* v, size_t v_bstride,
           const void* bias, int bm, void* out, int B, int L, float scale,
           cudaStream_t stream) {
  using S = AttnSmem<T, TV, TO, DV, NARROW, ROUND_P>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, TV, TO, DV, NARROW, ROUND_P>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kRows - 1) / kRows, B);
  flash_attention_kernel<T, TV, TO, DV, NARROW, ROUND_P>
      <<<grid, kThreads, S::bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const TV*>(v), v_bstride, static_cast<const float*>(bias),
      bm, static_cast<TO*>(out), L, scale * kLog2e);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16, D = D_v = 128: S, P and O in registers (mma.sync)
// ---------------------------------------------------------------------------

constexpr int kFaRows = 128;            // query rows per block: 8 warps x 16
constexpr int kFaKeys = 64;             // keys per tile
constexpr int kFaThreads = 256;
constexpr int kFaRowBytes = kD * 2;     // one swizzled row of Q, K or V
constexpr int kFaQBytes = kFaRows * kFaRowBytes;     // 32 KB
constexpr int kFaKvBytes = kFaKeys * kFaRowBytes;    // 16 KB
constexpr int kFaSmem = kFaQBytes + 4 * kFaKvBytes;  // Q, K[2], V[2]: 96 KB

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

// this lane's 2 x 16 bias values of the key tile at k0 (rows row0 and
// row0 + 8), in the score layout, times log2(e); 0 past L
__device__ __forceinline__ void fa_load_bias(float (&bb)[8][4],
                                             const float* biasb, int row0,
                                             int k0, int t, int L) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int key = k0 + 8 * j + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      float2 bv = make_float2(0.f, 0.f);
      if (row < L) {
        const float* p = biasb + (size_t)row * L + key;
        if ((L & 1) == 0) {
          if (key < L) bv = __ldg(reinterpret_cast<const float2*>(p));
        } else {
          if (key < L) bv.x = __ldg(p);
          if (key + 1 < L) bv.y = __ldg(p + 1);
        }
      }
      bb[j][2 * h] = bv.x * kLog2e;
      bb[j][2 * h + 1] = bv.y * kLog2e;
    }
  }
}

// q, k, v, out: (B, L, 128) bf16; bias: (Bm, L, L) f32 for BIAS. Grid
// (ceil(L / 128), B), 256 threads; warp w owns query rows 16w..16w+15 of the
// block. Each lane holds, per 8-column tile j of a 16-row fragment, the
// elements (g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1) with g = lane / 4,
// t = lane % 4 (mma.sync's accumulator layout), so its two rows' softmax
// statistics reduce over the 4 lanes of a quad.
template <bool BIAS>
__global__ void __launch_bounds__(kFaThreads, 1)
    flash_attention_bf16_kernel(const bf16* __restrict__ q,
                                const bf16* __restrict__ k,
                                const bf16* __restrict__ v,
                                const float* __restrict__ bias, int bm,
                                bf16* __restrict__ out, int L,
                                float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sq = sm90::smem_u32(smem);
  const uint32_t sk = sq + kFaQBytes, sv = sk + 2 * kFaKvBytes;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, q0 = blockIdx.x * kFaRows;
  const size_t bo = (size_t)b * L * kD;
  const float* biasb =
      BIAS ? bias + (size_t)(b % bm) * (size_t)L * (size_t)L : nullptr;
  const int row0 = q0 + 16 * warp + g;  // this lane's rows: row0, row0 + 8

  fa_load_rows<kFaRows>(sq, q + bo, q0, L);
  fa_load_rows<kFaKeys>(sk, k + bo, 0, L);
  fa_load_rows<kFaKeys>(sv, v + bo, 0, L);
  sm90::cp_async_commit();

  uint32_t qa[8][4];  // the warp's 16 x 128 Q as A fragments, per 16-wide k
  float o[16][4];     // 16 x 128 f32 accumulator, per 8-wide d tile
#pragma unroll
  for (int n = 0; n < 16; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units)
  float l0 = 0.f, l1 = 0.f;              // running sums, this lane's part
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: matrix, row
  const int n_tiles = (L + kFaKeys - 1) / kFaKeys;
  // the bias goes straight from L2 into the score layout, one tile ahead:
  // its loads fly during the P V and Q K^T products before its use
  float bb[8][4];
  if constexpr (BIAS) fa_load_bias(bb, biasb, row0, 0, t, L);

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
    if (it + 1 < n_tiles) {  // the next tile loads while this one computes
      const uint32_t nb = ((it + 1) & 1) * kFaKvBytes;
      fa_load_rows<kFaKeys>(sk + nb, k + bo, k0 + kFaKeys, L);
      fa_load_rows<kFaKeys>(sv + nb, v + bo, k0 + kFaKeys, L);
    }
    sm90::cp_async_commit();
    const uint32_t kt = sk + (it & 1) * kFaKvBytes;
    const uint32_t vt = sv + (it & 1) * kFaKvBytes;

    // S = Q K^T: 16 x 64 per warp, f32 in registers
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t kb[4];  // key tiles 2p, 2p+1 x d halves of this k step
        sm90::ldsm_x4(kt + sm90::swz(16 * p + (mi >> 1) * 8 + mr,
                                     2 * ks + (mi & 1), kFaRowBytes),
                      kb);
        sm90::mma_bf16(s[2 * p], qa[ks], kb[0], kb[1]);
        sm90::mma_bf16(s[2 * p + 1], qa[ks], kb[2], kb[3]);
      }
    }

    // scale, bias, ragged keys; online softmax in log2 units
    const bool ragged = k0 + kFaKeys > L;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if constexpr (BIAS) x += bb[j][e];
        if (ragged && k0 + 8 * j + 2 * t + (e & 1) >= L) x = -INFINITY;
        s[j][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    if constexpr (BIAS) {
      if (it + 1 < n_tiles) fa_load_bias(bb, biasb, row0, k0 + kFaKeys, t, L);
    }
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);  // finite
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[4][4];  // P rounded to bf16: the A fragments of P V
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - mn0), p1 = exp2f(s[j][1] - mn0);
      const float p2 = exp2f(s[j][2] - mn1), p3 = exp2f(s[j][3] - mn1);
      sum0 += p0 + p1;
      sum1 += p2 + p3;
      pa[j >> 1][(j & 1) * 2] = sm90::pack_bf16(p0, p1);
      pa[j >> 1][(j & 1) * 2 + 1] = sm90::pack_bf16(p2, p3);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }

    // O += P V: 16 x 128 per warp
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        uint32_t vb[4];  // keys 16ks..+15 x d tiles 2p, 2p+1
        sm90::ldsm_x4_t(vt + sm90::swz(16 * ks + (mi & 1) * 8 + mr,
                                       2 * p + (mi >> 1), kFaRowBytes),
                        vb);
        sm90::mma_bf16(o[2 * p], pa[ks], vb[0], vb[1]);
        sm90::mma_bf16(o[2 * p + 1], pa[ks], vb[2], vb[3]);
      }
    }
  }

  // normalise once, round to bf16 into the warp's own Q rows (read only by
  // this warp, at the first tile), then 16-byte coalesced stores
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, w);
    l1 += __shfl_xor_sync(0xffffffffu, l1, w);
  }
  const float i0 = 1.f / l0, i1 = 1.f / l1;
  const int r0 = 16 * warp + g;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *reinterpret_cast<uint32_t*>(smem + sm90::swz(r0, n, kFaRowBytes) +
                                 4 * t) =
        sm90::pack_bf16(o[n][0] * i0, o[n][1] * i0);
    *reinterpret_cast<uint32_t*>(smem + sm90::swz(r0 + 8, n, kFaRowBytes) +
                                 4 * t) =
        sm90::pack_bf16(o[n][2] * i1, o[n][3] * i1);
  }
  __syncwarp();
#pragma unroll
  for (int k2 = 0; k2 < 8; ++k2) {
    const int i = lane + 32 * k2;
    const int r = 16 * warp + (i >> 4), c = i & 15;
    if (q0 + r < L)
      *reinterpret_cast<uint4*>(out + bo + (size_t)(q0 + r) * kD + 8 * c) =
          *reinterpret_cast<const uint4*>(smem + sm90::swz(r, c, kFaRowBytes));
  }
}

int launch_flash_bf16(const void* q, const void* k, const void* v,
                      const void* bias, int bm, void* out, int B, int L,
                      float scale, cudaStream_t stream) {
  auto kernel = bias ? flash_attention_bf16_kernel<true>
                     : flash_attention_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kFaSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((L + kFaRows - 1) / kFaRows, B);
  kernel<<<grid, kFaThreads, kFaSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias), bm,
      static_cast<bf16*>(out), L, scale * kLog2e);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t value (0 = ok).
// q, k: (B, L, D); v, out: (B, L, DV) of the same dtype; bias: (Bm, L, L)
// f32 or null. D must be 128 and DV 128 or 2.
extern "C" int keep_attention(const void* q, const void* k, const void* v,
                              const void* bias, void* out, int B, int L, int D,
                              int DV, int Bm, float scale, int dtype,
                              void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D != kD || B < 1 || L < 1 || (bias != nullptr && Bm < 1))
    return (int)cudaErrorInvalidValue;
  const size_t vb = (size_t)L * DV;
  if (DV == kD) {
    if (dtype == 1)
      return launch_flash_bf16(q, k, v, bias, Bm, out, B, L, scale, st);
    if (dtype == 0)
      return launch<float, float, float, kD, false, true>(
          q, k, v, vb, bias, Bm, out, B, L, scale, st);
  } else if (DV == 2) {
    if (dtype == 1)
      return launch<bf16, bf16, bf16, 2, true, true>(q, k, v, vb, bias, Bm,
                                                     out, B, L, scale, st);
    if (dtype == 0)
      return launch<float, float, float, 2, true, true>(q, k, v, vb, bias, Bm,
                                                        out, B, L, scale, st);
  }
  return (int)cudaErrorInvalidValue;
}

// f0, f1: (B, L, C) of dtype, C = 128; grid: (L, 2) f32; out: (B, L, 2) f32.
extern "C" int keep_corr_expectation(const void* f0, const void* f1,
                                     const void* grid, void* out, int B, int L,
                                     int C, float scale, int dtype,
                                     void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C != kD || B < 1 || L < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<bf16, float, float, 2, true, false>(f0, f1, grid, 0, nullptr,
                                                      1, out, B, L, scale, st);
  if (dtype == 0)
    return launch<float, float, float, 2, true, false>(
        f0, f1, grid, 0, nullptr, 1, out, B, L, scale, st);
  return (int)cudaErrorInvalidValue;
}
