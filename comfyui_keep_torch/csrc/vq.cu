// Nearest-codebook search for Hopper (sm_90a):
//   idx[t] = argmin_n ( e2[n] - 2 z[t] . e[n] ),  e2[n] = ||e[n]||^2 in f32
// with the products accumulated in f32 and ties going to the lowest index
// (jnp.argmin's rule). ||z[t]||^2 is the same for every n and is left out.
//
// Replaces comfyui_keep_tpu/ops/pallas_kernels.py: vq_nearest_indices_pallas
// (_vq_kernel). On its path (KEEP stage-II training, the GT codes of every
// step) T = B * frames * 256 = 4096 tokens, C = 256, N = 1024.
//
// What bounds it on the H100: 2 T N C = 2.15 GFLOP against ~2.6 MB of
// inputs, ~800 flop/byte, so the arithmetic bounds it: 32 us in f32 on the
// CUDA cores, 2.2 us in bf16 on the tensor cores. The (T, N) distance matrix
// (16 MB f32) never reaches device memory. At this size the work is a few
// microseconds a block, so what a design has to get right is parallelism and
// latency: enough blocks, loads in flight, no serial walk over the codebook.
//
// What the design does about it: the codebook is split across blocks. Block
// (x, s) takes one tile of tokens and split s of the codebook, a run of whole
// code tiles in ascending order, so T = 4096 gives 256 blocks (2 per SM).
// Each block computes ||e||^2 of the codes it stages (f32 sums of squares;
// no separate launch), keeps a running (min, index) per token with a strict
// '<' over ascending codes, and writes it to a scratch row of its split. A
// second small kernel merges the splits in ascending order, again with a
// strict '<', so the lowest index still wins a tie across splits. A call runs
// these two kernels and nothing else.
// - bf16: 64 tokens (4 warps x 16) against 64-code tiles, mma.sync
//   m16n8k16 with f32 accumulators. The token tile and double-buffered code
//   tiles arrive by 16-byte cp.async in swizzled rows and are read by
//   ldmatrix; the distances and the running minimum are taken on the
//   accumulator registers, each row's quad of lanes merged by shuffles.
// - f32: FMA on the CUDA cores (TF32 would change picks against the f32
//   reference). 128 tokens x 128 codes per tile, an 8 x 8 register tile per
//   thread of 256; 16-channel slices of tokens and codes are staged
//   channel-major (the next slice in registers while this one computes) and
//   read as float4 without bank conflicts.
#include <math.h>

#include "common.cuh"
#include "sm90.cuh"

namespace keep {
namespace vq {

constexpr int kMaxSplits = 16;

// (d, i) strictly before (bd, bi) in (distance, index) order
__device__ __forceinline__ bool before(float d, int i, float bd, int bi) {
  return d < bd || (d == bd && i < bi);
}

// ---------------------------------------------------------------------------
// bf16 (tensor cores)
// ---------------------------------------------------------------------------

constexpr int kBWarps = 4, kBTok = 16 * kBWarps, kBThreads = 32 * kBWarps;
constexpr int kBCodes = 64, kBLanesPerCode = kBThreads / kBCodes;

// rows of C bf16 (C / 8 16-byte chunks); chunk c of row r sits at c ^ (r &
// mask), mask + 1 the largest power of two up to 8 that divides the chunks
struct BTile {
  int row_bytes, chunks, mask;
  __host__ __device__ explicit BTile(int C)
      : row_bytes(2 * C), chunks(C / 8),
        mask((((C / 8) & -(C / 8)) < 8 ? ((C / 8) & -(C / 8)) : 8) - 1) {}
  __device__ __forceinline__ uint32_t at(int r, int c) const {
    return (uint32_t)(r * row_bytes + ((c ^ (r & mask)) << 4));
  }
};

// rows [r0, r0 + rows) of a (limit, C) bf16 matrix into a tile; rows at
// or past limit are zero-filled
__device__ __forceinline__ void b_load_rows(uint32_t dst, const BTile& L,
                                            const bf16* src, int r0,
                                            int rows, int limit) {
  for (int i = threadIdx.x; i < rows * L.chunks; i += kBThreads) {
    const int r = i / L.chunks, c = i % L.chunks;
    const bool ok = r0 + r < limit;
    sm90::cp_async16(dst + L.at(r, c),
                     src + (size_t)(ok ? r0 + r : 0) * (L.row_bytes / 2) +
                         c * 8,
                     ok ? 16 : 0);
  }
}

// z: (T, C), e: (N, C); part_d, part_i: (splits, T). Grid (ceil(T /
// kBTok), splits), kBThreads threads; split s walks code tiles [s * tps,
// (s + 1) * tps). Shared memory: the token tile, two code tiles, E2s.
__global__ void __launch_bounds__(kBThreads)
    vq_bf16_kernel(const bf16* __restrict__ z, const bf16* __restrict__ e,
                   float* __restrict__ part_d, int* __restrict__ part_i,
                   int T, int N, int C, int tps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BTile L(C);
  const int tile_bytes = kBCodes * L.row_bytes;
  const uint32_t sz = sm90::smem_u32(smem);
  const uint32_t se = sz + kBTok * L.row_bytes;
  float* E2s = reinterpret_cast<float*>(smem + kBTok * L.row_bytes +
                                        2 * tile_bytes);  // [2][kBCodes]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, mi = lane >> 3, mr = lane & 7;
  const int t0 = blockIdx.x * kBTok, split = blockIdx.y;
  const int n_tiles = (N + kBCodes - 1) / kBCodes;
  const int first = split * tps, count = min(tps, n_tiles - first);

  b_load_rows(sz, L, z, t0, kBTok, T);
  b_load_rows(se, L, e, first * kBCodes, kBCodes, N);
  sm90::cp_async_commit();

  float best[2] = {INFINITY, INFINITY};  // rows g and g + 8
  int best_i[2] = {0x7fffffff, 0x7fffffff};
  for (int it = 0; it < count; ++it) {
    const int n0 = (first + it) * kBCodes;
    const uint32_t et = se + (it & 1) * tile_bytes;
    float* E2 = E2s + (it & 1) * kBCodes;
    sm90::cp_async_wait<0>();
    __syncthreads();  // tile `it` landed; every warp is done with it - 1
    if (it + 1 < count) b_load_rows(se + ((it + 1) & 1) * tile_bytes, L, e,
                                    n0 + kBCodes, kBCodes, N);
    sm90::cp_async_commit();
    {  // ||e||^2 of this tile's codes: kBLanesPerCode threads a code, f32
      const int code = tid / kBLanesPerCode, part = tid % kBLanesPerCode;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int c = part; c < L.chunks; c += kBLanesPerCode) {
        const uint4 v = *reinterpret_cast<const uint4*>(
            smem + (et - sz) + L.at(code, c));
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[q]));
          acc[q] = fmaf(f.x, f.x, fmaf(f.y, f.y, acc[q]));
        }
      }
      float sq = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
      for (int w = 1; w < kBLanesPerCode; w <<= 1)
        sq += __shfl_xor_sync(0xffffffffu, sq, w);
      if (part == 0) E2[code] = n0 + code < N ? sq : INFINITY;
    }

    float s[8][4];  // 16 tokens x 64 codes per warp
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int ks = 0; ks < C / 16; ++ks) {
      uint32_t a[4];
      sm90::ldsm_x4(sz + L.at(16 * warp + (mi & 1) * 8 + mr,
                              2 * ks + (mi >> 1)),
                    a);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t b[4];  // code tiles 2p, 2p+1 x k halves of this k step
        sm90::ldsm_x4(et + L.at(16 * p + (mi >> 1) * 8 + mr,
                                2 * ks + (mi & 1)),
                      b);
        sm90::mma_bf16(s[2 * p], a, b[0], b[1]);
        sm90::mma_bf16(s[2 * p + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // E2 written
    // codes in ascending order and a strict '<': the lowest index wins ties
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e_ = 0; e_ < 4; ++e_) {
        const int col = 8 * j + 2 * t + (e_ & 1);
        const float d = fmaf(-2.0f, s[j][e_], E2[col]);  // == e2 - 2 s
        if (d < best[e_ >> 1]) {
          best[e_ >> 1] = d;
          best_i[e_ >> 1] = n0 + col;
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int w = 1; w < 4; w <<= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, best[h], w);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[h], w);
      if (before(od, oi, best[h], best_i[h])) {
        best[h] = od;
        best_i[h] = oi;
      }
    }
    const int tok = t0 + 16 * warp + g + 8 * h;
    if (t == 0 && tok < T) {
      part_d[(size_t)split * T + tok] = best[h];
      part_i[(size_t)split * T + tok] = best_i[h];
    }
  }
}

// ---------------------------------------------------------------------------
// f32 (CUDA cores)
// ---------------------------------------------------------------------------

constexpr int kFTok = 128, kFCodes = 128, kFK = 16, kFThreads = 256;
constexpr int kFLd = kFTok + 4;  // a channel's row of the staged slice

// thread's token / code offsets within a tile: 4 from each half
__device__ __forceinline__ int f_off(int lane16, int i) {
  return (i < 4 ? 0 : 64) + lane16 * 4 + (i & 3);
}

// z: (T, C), e: (N, C) f32, 16-byte aligned rows; part_d, part_i: (splits,
// T). Grid (ceil(T / 128), splits), 256 threads; thread (ty, tx) = (tid /
// 16, tid % 16) owns tokens f_off(ty, 0..7) against codes f_off(tx, 0..7).
__global__ void __launch_bounds__(kFThreads, 2)
    vq_f32_kernel(const float* __restrict__ z, const float* __restrict__ e,
                  float* __restrict__ part_d, int* __restrict__ part_i,
                  int T, int N, int C, int tps) {
  __shared__ __align__(16) float Zs[2][kFK][kFLd];
  __shared__ __align__(16) float Es[2][kFK][kFLd];
  __shared__ float E2s[kFCodes];
  // each token's running (min, index) over the tiles, kept here rather than
  // in registers, which the 8 x 8 tile and the prefetch fill
  __shared__ float Bd[kFTok];
  __shared__ int Bi[kFTok];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int t0 = blockIdx.x * kFTok, split = blockIdx.y;
  const int n_tiles = (N + kFCodes - 1) / kFCodes;
  const int first = split * tps, count = min(tps, n_tiles - first);
  const int n_k = C / kFK;
  // staging: float4 q of a slice is row (tid + 256 q) / 4, channels 4 (tid %
  // 4)..+3; rows past the matrix load zeros
  const int sr = tid >> 2, sc = (tid & 3) * 4;

  if (tid < kFTok) {
    Bd[tid] = INFINITY;
    Bi[tid] = 0x7fffffff;
  }
  for (int it = 0; it < count; ++it) {
    const int n0 = (first + it) * kFCodes;
    float4 zr[2], er[2];
    float e2p[2] = {0.f, 0.f};
    auto fetch = [&](int k0) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = sr + 64 * q;
        zr[q] = t0 + r < T ? *reinterpret_cast<const float4*>(
                                 z + (size_t)(t0 + r) * C + k0 + sc)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
        er[q] = n0 + r < N ? *reinterpret_cast<const float4*>(
                                 e + (size_t)(n0 + r) * C + k0 + sc)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    auto stage = [&](int b) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int r = sr + 64 * q;
        Zs[b][sc + 0][r] = zr[q].x;
        Zs[b][sc + 1][r] = zr[q].y;
        Zs[b][sc + 2][r] = zr[q].z;
        Zs[b][sc + 3][r] = zr[q].w;
        Es[b][sc + 0][r] = er[q].x;
        Es[b][sc + 1][r] = er[q].y;
        Es[b][sc + 2][r] = er[q].z;
        Es[b][sc + 3][r] = er[q].w;
        e2p[q] = fmaf(er[q].x, er[q].x, e2p[q]);
        e2p[q] = fmaf(er[q].y, er[q].y, e2p[q]);
        e2p[q] = fmaf(er[q].z, er[q].z, e2p[q]);
        e2p[q] = fmaf(er[q].w, er[q].w, e2p[q]);
      }
    };
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    __syncthreads();  // the previous tile's reads of Zs, Es, E2s are done
    fetch(0);
    stage(0);
    __syncthreads();
    for (int kc = 0; kc < n_k; ++kc) {
      const int b = kc & 1;
      if (kc + 1 < n_k) fetch((kc + 1) * kFK);
#pragma unroll
      for (int k = 0; k < kFK; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Zs[b][k][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&Zs[b][k][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Es[b][k][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&Es[b][k][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      if (kc + 1 < n_k) stage(b ^ 1);
      __syncthreads();  // slice kc + 1 staged; every thread is done with kc
    }
    // ||e||^2: the four threads that staged a code's channels
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      e2p[q] += __shfl_xor_sync(0xffffffffu, e2p[q], 1);
      e2p[q] += __shfl_xor_sync(0xffffffffu, e2p[q], 2);
      const int r = sr + 64 * q;
      if ((tid & 3) == 0) E2s[r] = n0 + r < N ? e2p[q] : INFINITY;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float best = INFINITY;
      int best_i = 0x7fffffff;
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // codes in ascending order
        const int col = f_off(tx, j);
        const float d = fmaf(-2.0f, acc[i][j], E2s[col]);
        if (d < best) {
          best = d;
          best_i = n0 + col;
        }
      }
      // merge the 16 threads of the token's row (tx = 0..15 of a half-warp)
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) {
        const float od = __shfl_xor_sync(0xffffffffu, best, w);
        const int oi = __shfl_xor_sync(0xffffffffu, best_i, w);
        if (before(od, oi, best, best_i)) {
          best = od;
          best_i = oi;
        }
      }
      const int r = f_off(ty, i);  // only this lane touches Bd[r], Bi[r]
      if (tx == 0 && before(best, best_i, Bd[r], Bi[r])) {
        Bd[r] = best;
        Bi[r] = best_i;
      }
    }
  }
  __syncthreads();
  if (tid < kFTok && t0 + tid < T) {
    part_d[(size_t)split * T + t0 + tid] = Bd[tid];
    part_i[(size_t)split * T + t0 + tid] = Bi[tid];
  }
}

// ---------------------------------------------------------------------------
// merge: splits in ascending order, strict '<'
// ---------------------------------------------------------------------------

__global__ void vq_merge_kernel(const float* __restrict__ part_d,
                                const int* __restrict__ part_i,
                                int* __restrict__ idx, int T, int splits) {
  const int tok = blockIdx.x * blockDim.x + threadIdx.x;
  if (tok >= T) return;
  float best = part_d[tok];
  int bi = part_i[tok];
  for (int s = 1; s < splits; ++s) {
    const float d = part_d[(size_t)s * T + tok];
    if (d < best) {
      best = d;
      bi = part_i[(size_t)s * T + tok];
    }
  }
  idx[tok] = bi;
}

// splits of n_tiles code tiles for tok_tiles token tiles: about two blocks
// per SM, whole tiles per split. Returns the splits; *tps the tiles of each.
int plan_splits(int tok_tiles, int n_tiles, int* tps) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 132;
  }
  int want = (2 * sms + tok_tiles - 1) / tok_tiles;
  want = max(1, min(want, min(kMaxSplits, n_tiles)));
  *tps = (n_tiles + want - 1) / want;
  return (n_tiles + *tps - 1) / *tps;
}

}  // namespace vq
}  // namespace keep

// z: (T, C), e: (N, C) of dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned; scratch: 2 * 16 * T int32 of any content; idx: (T,) int32.
// Returns a cudaError_t value (0 = ok). N must be a multiple of 64, C a
// multiple of 16 in [16, 512]. Runs two kernels: the split search and the
// merge.
extern "C" int keep_vq_nearest(const void* z, const void* e, void* scratch,
                               void* idx, int T, int N, int C, int dtype,
                               void* stream) {
  using namespace keep::vq;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || N < 64 || N % 64 != 0 || C < 16 || C % 16 != 0 || C > 512)
    return (int)cudaErrorInvalidValue;
  float* part_d = static_cast<float*>(scratch);
  int* part_i = static_cast<int*>(scratch) + (size_t)kMaxSplits * T;
  int tps = 1, splits = 1;
  if (dtype == 1) {
    const int tok_tiles = (T + kBTok - 1) / kBTok;
    splits = plan_splits(tok_tiles, (N + kBCodes - 1) / kBCodes, &tps);
    const int smem = (kBTok + 2 * kBCodes) * 2 * C +
                     2 * kBCodes * (int)sizeof(float);
    // the attribute once per device and size (each call's set costs ~2 us)
    static int set_bytes[64] = {0};
    int dev = 0;
    cudaGetDevice(&dev);
    if (dev >= 64 || smem > set_bytes[dev]) {
      cudaError_t err = cudaFuncSetAttribute(
          vq_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) set_bytes[dev] = smem;
    }
    vq_bf16_kernel<<<dim3(tok_tiles, splits), kBThreads, smem, st>>>(
        static_cast<const keep::bf16*>(z), static_cast<const keep::bf16*>(e),
        part_d, part_i, T, N, C, tps);
  } else if (dtype == 0) {
    const int tok_tiles = (T + kFTok - 1) / kFTok;
    splits = plan_splits(tok_tiles, (N + kFCodes - 1) / kFCodes, &tps);
    vq_f32_kernel<<<dim3(tok_tiles, splits), kFThreads, 0, st>>>(
        static_cast<const float*>(z), static_cast<const float*>(e), part_d,
        part_i, T, N, C, tps);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  vq_merge_kernel<<<(T + 255) / 256, 256, 0, st>>>(
      part_d, part_i, static_cast<int*>(idx), T, splits);
  return (int)cudaGetLastError();
}
