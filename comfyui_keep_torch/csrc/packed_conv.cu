// Phase-packed convolution for Hopper (sm_90a): a stride-1 convolution of
// at most 2 x 2 taps over an NHWC input with zero pads of at most one cell,
//   out[b, i, j, :] = sum_{ty < kh, tx < kw} x[b, i + ty - pt, j + tx - pl, :]
//                                            . w[ty, tx]
// (reads outside the input are zeros), x NHWC, w HWIO, out NHWC in x's
// dtype, the products summed in f32 and rounded once.
//
// Replaces tools/_prof_packedconv.py: pallas_conv (body _kernel), the VALID
// 2x2 convolution of a parity-1 phase-packed tensor as four shifted GEMMs
// summed in f32. One kernel serves every packed convolution of
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
// cores (67 TFLOP/s).
//
// What the design does about it: an implicit GEMM with rows = output
// pixels, K = taps x Cin, N = Cout. A block of 128 threads owns a 64-pixel
// x 64-channel output tile; it walks the taps and, for each, Cin in slices
// of 32 channels. Each slice's 64 x 32 input patch (the 64 pixels' shifted
// reads, zero-filled at pads and past ragged channels) and 32 x 64 weight
// slice are staged in shared memory with 8- or 16-byte loads (Cin and Cout
// are multiples of 4); the tile accumulates in registers across all slices:
// WMMA fragments (bf16 in, f32 out; each warp a 32 x 32 quarter) for bf16,
// FMA with no TF32 for f32. bf16 tiles then pass through an f32 shared tile
// to masked 4-wide stores. At 256^2 outputs one frame gives 1024 x Cout/64
// blocks, enough for 132 SMs. Nothing is pipelined: cp.async or TMA staging,
// wgmma and fused bias / mask epilogues are left for the work that makes the
// kernel fast.
#include "common.cuh"

namespace keep {

constexpr int kPcCols = 64;  // output channels per block
constexpr int kPcK = 32;     // input channels of one K slice
constexpr int kPcLdc = kPcCols + 4;  // f32 epilogue tile row stride

struct PcGeom {
  int Hi, Wi, Cin, Cout, kh, kw, pt, pl, Ho, Wo;
  long long M;  // B * Ho * Wo output pixels
};

// 4 consecutive elements as one load: 8 bytes of bf16, 16 bytes of f32
// (all-zero bits are 0.0 in both)
template <typename T> struct Vec4;
template <> struct Vec4<bf16> {
  using type = uint2;
  static __device__ __forceinline__ type zero() { return make_uint2(0, 0); }
};
template <> struct Vec4<float> {
  using type = float4;
  static __device__ __forceinline__ type zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
};

template <typename T> struct PcLayout {
  static constexpr int lda = kPcK + Pad<T>::v;     // input patch row stride
  static constexpr int ldb = kPcCols + Pad<T>::v;  // weight slice row stride
  static constexpr size_t a_bytes = align128(sizeof(T) * kRows * lda);
  static constexpr size_t ab_bytes =
      a_bytes + align128(sizeof(T) * kPcK * ldb);
  static constexpr size_t c_bytes = sizeof(float) * kRows * kPcLdc;
  static constexpr size_t bytes = ab_bytes > c_bytes ? ab_bytes : c_bytes;
};

template <typename T> struct PcAcc;

// bf16: warp w owns the 32 x 32 quarter (w / 2, w % 2) as 2 x 2 fragments
template <> struct PcAcc<bf16> {
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float>
      acc[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n) nvcuda::wmma::fill_fragment(acc[m][n], 0.f);
  }

  __device__ __forceinline__ void mma(const bf16* As, const bf16* Bs) {
    using namespace nvcuda;
    constexpr int lda = PcLayout<bf16>::lda, ldb = PcLayout<bf16>::ldb;
    const int wr = threadIdx.x / 64, wc = (threadIdx.x / 32) % 2;
#pragma unroll
    for (int k = 0; k < kPcK; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
        wmma::load_matrix_sync(a[m], As + (32 * wr + 16 * m) * lda + k, lda);
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wmma::load_matrix_sync(b[n], Bs + k * ldb + 32 * wc + 16 * n, ldb);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          wmma::mma_sync(acc[m][n], a[m], b[n], acc[m][n]);
    }
  }

  // the tile through an f32 shared tile (which overlays the staging
  // buffers: the caller synchronises first) to 4-wide masked stores
  __device__ __forceinline__ void store(unsigned char* smem, bf16* out,
                                        long long m0, int n0,
                                        const PcGeom& g) {
    using namespace nvcuda;
    float* Cs = reinterpret_cast<float*>(smem);
    const int wr = threadIdx.x / 64, wc = (threadIdx.x / 32) % 2;
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int n = 0; n < 2; ++n)
        wmma::store_matrix_sync(
            Cs + (32 * wr + 16 * m) * kPcLdc + 32 * wc + 16 * n, acc[m][n],
            kPcLdc, wmma::mem_row_major);
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * (kPcCols / 4); i += kThreads) {
      const int r = i / (kPcCols / 4), c = 4 * (i % (kPcCols / 4));
      const long long p = m0 + r;
      if (p >= g.M || n0 + c >= g.Cout) continue;
      const float* s = Cs + r * kPcLdc + c;
      __nv_bfloat162 lo = __floats2bfloat162_rn(s[0], s[1]);
      __nv_bfloat162 hi = __floats2bfloat162_rn(s[2], s[3]);
      uint2 v;
      v.x = *reinterpret_cast<const unsigned*>(&lo);
      v.y = *reinterpret_cast<const unsigned*>(&hi);
      *reinterpret_cast<uint2*>(out + p * g.Cout + n0 + c) = v;
    }
  }
};

// f32: thread t owns rows 4 (t / 8) .. + 3 against columns t % 8 + 8 j
template <> struct PcAcc<float> {
  float acc[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[r][j] = 0.f;
  }

  __device__ __forceinline__ void mma(const float* As, const float* Bs) {
    constexpr int lda = PcLayout<float>::lda, ldb = PcLayout<float>::ldb;
    const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
    const float* At = As + 4 * tr * lda;
#pragma unroll 8
    for (int k = 0; k < kPcK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = At[r * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k * ldb + tc + 8 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[r][j] = fmaf(a[r], b[j], acc[r][j]);
    }
  }

  __device__ __forceinline__ void store(unsigned char*, float* out,
                                        long long m0, int n0,
                                        const PcGeom& g) {
    const int tr = threadIdx.x / 8, tc = threadIdx.x % 8;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const long long p = m0 + 4 * tr + r;
      if (p >= g.M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int co = n0 + tc + 8 * j;
        if (co < g.Cout) out[p * g.Cout + co] = acc[r][j];
      }
    }
  }
};

// x: (B, Hi, Wi, Cin); w: (kh, kw, Cin, Cout); out: (B, Ho, Wo, Cout).
// Grid (ceil(M / 64), ceil(Cout / 64)), 128 threads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    packed_conv_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       T* __restrict__ out, PcGeom g) {
  using L = PcLayout<T>;
  using V = typename Vec4<T>::type;
  __shared__ __align__(128) unsigned char smem[L::bytes];
  __shared__ long long row_img[kRows];  // b * Hi * Wi, or -1 past the end
  __shared__ int row_i[kRows], row_j[kRows];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + L::a_bytes);

  const int tid = threadIdx.x;
  const long long m0 = (long long)blockIdx.x * kRows;
  const int n0 = blockIdx.y * kPcCols;
  if (tid < kRows) {
    const long long p = m0 + tid;
    const long long hw = (long long)g.Ho * g.Wo;
    const long long b = p / hw, rem = p % hw;
    row_img[tid] = p < g.M ? b * g.Hi * g.Wi : -1;
    row_i[tid] = (int)(rem / g.Wo) - g.pt;
    row_j[tid] = (int)(rem % g.Wo) - g.pl;
  }

  const V zero = Vec4<T>::zero();
  PcAcc<T> acc;
  acc.zero();
  for (int ty = 0; ty < g.kh; ++ty) {
    for (int tx = 0; tx < g.kw; ++tx) {
      const T* wt = w + (size_t)(ty * g.kw + tx) * g.Cin * g.Cout;
      for (int c0 = 0; c0 < g.Cin; c0 += kPcK) {
        __syncthreads();  // row geometry written; the previous slice read
        // input patch: 64 pixels x 32 channels, as 4-channel vectors
        for (int i = tid; i < kRows * (kPcK / 4); i += kThreads) {
          const int r = i / (kPcK / 4), c = c0 + 4 * (i % (kPcK / 4));
          const int ii = row_i[r] + ty, jj = row_j[r] + tx;
          V v = zero;
          if (row_img[r] >= 0 && ii >= 0 && ii < g.Hi && jj >= 0 &&
              jj < g.Wi && c < g.Cin)
            v = *reinterpret_cast<const V*>(
                x + (row_img[r] + (long long)ii * g.Wi + jj) * g.Cin + c);
          *reinterpret_cast<V*>(As + r * L::lda + (c - c0)) = v;
        }
        // weight slice: 32 input channels x 64 output channels
        for (int i = tid; i < kPcK * (kPcCols / 4); i += kThreads) {
          const int k = i / (kPcCols / 4), c = 4 * (i % (kPcCols / 4));
          V v = zero;
          if (c0 + k < g.Cin && n0 + c < g.Cout)
            v = *reinterpret_cast<const V*>(wt + (size_t)(c0 + k) * g.Cout +
                                            n0 + c);
          *reinterpret_cast<V*>(Bs + k * L::ldb + c) = v;
        }
        __syncthreads();
        acc.mma(As, Bs);
      }
    }
  }
  __syncthreads();  // the epilogue tile overlays the staging buffers
  acc.store(smem, out, m0, n0, g);
}

template <typename T>
int launch_packed_conv(const void* x, const void* w, void* out,
                       const PcGeom& g, cudaStream_t stream) {
  const long long mt = (g.M + kRows - 1) / kRows;
  if (mt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)mt, (g.Cout + kPcCols - 1) / kPcCols);
  packed_conv_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), g);
  return (int)cudaGetLastError();
}

}  // namespace keep

// dtype: 0 = float32, 1 = bfloat16 (x, w and out). kh, kw in {1, 2}; pads
// in {0, 1}; Cin and Cout multiples of 4; x and w 16-byte aligned. Returns a
// cudaError_t value (0 = ok).
extern "C" int keep_packed_conv(const void* x, const void* w, void* out,
                                int B, int Hi, int Wi, int Cin, int Cout,
                                int kh, int kw, int pt, int pb, int pl, int pr,
                                int dtype, void* stream) {
  using namespace keep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PcGeom g;
  g.Hi = Hi; g.Wi = Wi; g.Cin = Cin; g.Cout = Cout; g.kh = kh; g.kw = kw;
  g.pt = pt; g.pl = pl;
  g.Ho = Hi + pt + pb - kh + 1;
  g.Wo = Wi + pl + pr - kw + 1;
  g.M = (long long)B * g.Ho * g.Wo;
  const bool pads_ok = pt >= 0 && pt <= 1 && pb >= 0 && pb <= 1 && pl >= 0 &&
                       pl <= 1 && pr >= 0 && pr <= 1;
  if (B < 1 || Hi < 1 || Wi < 1 || kh < 1 || kh > 2 || kw < 1 || kw > 2 ||
      !pads_ok || Cin < 4 || Cin % 4 != 0 || Cout < 4 || Cout % 4 != 0 ||
      g.Ho < 1 || g.Wo < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_packed_conv<bf16>(x, w, out, g, st);
  if (dtype == 0) return launch_packed_conv<float>(x, w, out, g, st);
  return (int)cudaErrorInvalidValue;
}
