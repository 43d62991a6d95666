// ragged_matmul: grouped expert GEMM, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ragged_matmul` in
// src/repro/kernels/ragged_matmul.py (body `_kernel`), which walks the
// grid (E, cap/bm, F/bn, D/bk) in order and carries an f32 accumulator
// in VMEM across the K steps.
//
//   out[r, n] = sum_k x[r, k] * w[r / cap, k, n]    (f32 sum, x's dtype out)
//
// x is (E*cap, D), expert-contiguous; w is (E, D, F).  One block computes
// one output tile of one expert and loops over K itself (the TPU's
// sequential grid axis); tiles never straddle two experts, and rows past
// `cap` and columns past F or D are masked, so `cap` need not be a
// multiple of the tile.  Every offset into w is 64-bit: at Kimi-K2's
// expert FFN w holds 384 * 7168 * 2048 = 5.6e9 elements, past int range.
//
// bfloat16: 64x128 tiles, K steps of 32, 8 warps of 32x32 each on the
// tensor cores through nvcuda::wmma (16x16x16, f32 accumulate).
// float32: 64x64 SIMT tiles, 4x4 outputs a thread, full f32 FMAs (no
// TF32, so it agrees with a float32 matmul to rounding).
//
// Bound: at Kimi-K2's expert FFN (E=384, cap=56, D=7168, F=2048, bf16)
// the call does 631 GFLOP and must read w once, 11.3 GB: 3.4 ms of bytes
// at 3.35 TB/s against 0.64 ms of operations at 989 TFLOP/s, so bytes
// bound it.  The tile order puts the F tiles of one expert next to each
// other, so w is read from memory once and x's rows come from L2; the
// loads are 16 bytes a thread when D and F allow it.  No cp.async ring,
// no TMA, no wgmma yet: those are the next step.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 256;

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);
}

// Copy a ROWS x COLS tile at g (row stride ldg) into shared s (row stride
// lds), zero past rows_left / cols_left.  Chunks of 16 bytes when `vec`
// (16-byte aligned base, ldg a multiple of the chunk), else element-wise.
template <typename T, int ROWS, int COLS>
__device__ __forceinline__ void load_tile(T* s, int lds, const T* g,
                                          int64_t ldg, int64_t rows_left,
                                          int64_t cols_left, bool vec) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunksPerRow = COLS / kVec;
  constexpr int kChunks = ROWS * kChunksPerRow;
  static_assert(kChunks % kThreads == 0, "tile must split over the block");
#pragma unroll
  for (int i = 0; i < kChunks / kThreads; ++i) {
    const int chunk = threadIdx.x + i * kThreads;
    const int r = chunk / kChunksPerRow;
    const int c = (chunk % kChunksPerRow) * kVec;
    T* dst = s + r * lds + c;
    if (vec && r < rows_left && c + kVec <= cols_left) {
      *reinterpret_cast<uint4*>(dst) =
          *reinterpret_cast<const uint4*>(g + r * ldg + c);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        dst[j] = (r < rows_left && c + j < cols_left) ? g[r * ldg + c + j]
                                                      : from_f<T>(0.0f);
    }
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kBM = 64, kBN = 128, kBK = 32;
constexpr int kLdA = kBK + 8;   // bf16 row strides: multiples of 8 and of
constexpr int kLdB = kBN + 8;   // 16 bytes, off the 128-byte bank period
constexpr int kLdC = kBN + 4;   // f32 epilogue stage
constexpr int kSmemAB = (kBM * kLdA + kBK * kLdB) * sizeof(bf16);
constexpr int kSmemC = kBM * kLdC * sizeof(float);
constexpr int kSmem = kSmemAB > kSmemC ? kSmemAB : kSmemC;

__global__ void __launch_bounds__(kThreads)
ragged_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   bf16* __restrict__ out, int64_t cap, int64_t d,
                   int64_t f, int64_t n_tiles, int64_t m_tiles, bool vec) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kSmem];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* bs = as + kBM * kLdA;
  float* cs = reinterpret_cast<float*>(smem);  // reused after the K loop

  const int64_t tile = blockIdx.x;
  const int64_t nt = tile % n_tiles;
  const int64_t mt = (tile / n_tiles) % m_tiles;
  const int64_t e = tile / (n_tiles * m_tiles);
  const int64_t m0 = mt * kBM, n0 = nt * kBN;
  const int64_t rows = cap - m0 < kBM ? cap - m0 : kBM;
  const bf16* xa = x + (e * cap + m0) * d;
  const bf16* wb = w + e * d * f + n0;

  const int warp = threadIdx.x / 32;
  const int wm = (warp / 4) * 32, wn = (warp % 4) * 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int64_t k0 = 0; k0 < d; k0 += kBK) {
    load_tile<bf16, kBM, kBK>(as, kLdA, xa + k0, d, rows, d - k0, vec);
    load_tile<bf16, kBK, kBN>(bs, kLdB, wb + k0 * f, f, d - k0, f - n0,
                              vec);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], as + (wm + i * 16) * kLdA + kk, kLdA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], bs + kk * kLdB + wn + j * 16, kLdB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(cs + (wm + i * 16) * kLdC + wn + j * 16,
                              acc[i][j], kLdC, wmma::mem_row_major);
  __syncthreads();
  bf16* o = out + (e * cap + m0) * f + n0;
  for (int t = threadIdx.x; t < kBM * kBN; t += kThreads) {
    const int r = t / kBN, c = t % kBN;
    if (r < rows && n0 + c < f)
      o[r * f + c] = __float2bfloat16(cs[r * kLdC + c]);
  }
}

// ---------------------------------------------------------------- f32

constexpr int kFM = 64, kFN = 64, kFK = 16;
constexpr int kLdFA = kFK + 4, kLdFB = kFN + 4;

__global__ void __launch_bounds__(kThreads)
ragged_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  float* __restrict__ out, int64_t cap, int64_t d, int64_t f,
                  int64_t n_tiles, int64_t m_tiles, bool vec) {
  __shared__ __align__(16) float as[kFM * kLdFA];
  __shared__ __align__(16) float bs[kFK * kLdFB];
  const int64_t tile = blockIdx.x;
  const int64_t nt = tile % n_tiles;
  const int64_t mt = (tile / n_tiles) % m_tiles;
  const int64_t e = tile / (n_tiles * m_tiles);
  const int64_t m0 = mt * kFM, n0 = nt * kFN;
  const int64_t rows = cap - m0 < kFM ? cap - m0 : kFM;
  const float* xa = x + (e * cap + m0) * d;
  const float* wb = w + e * d * f + n0;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  float acc[4][4] = {};
  for (int64_t k0 = 0; k0 < d; k0 += kFK) {
    load_tile<float, kFM, kFK>(as, kLdFA, xa + k0, d, rows, d - k0, vec);
    load_tile<float, kFK, kFN>(bs, kLdFB, wb + k0 * f, f, d - k0, f - n0,
                               vec);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kFK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = as[(ty * 4 + i) * kLdFA + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = bs[k * kLdFB + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (e * cap + m0) * f + n0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ty * 4 + i, c = tx + 16 * j;
      if (r < rows && n0 + c < f) o[r * f + c] = acc[i][j];
    }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int BM, int BN, typename K>
int launch(K kernel, const void* x, const void* w, void* out, int64_t e,
           int64_t cap, int64_t d, int64_t f, void* stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = aligned16(x) && aligned16(w) && d % kVec == 0 &&
                   f % kVec == 0;
  const int64_t n_tiles = (f + BN - 1) / BN;
  const int64_t m_tiles = (cap + BM - 1) / BM;
  const int64_t blocks = e * m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return int(cudaErrorInvalidConfiguration);
  kernel<<<unsigned(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<T*>(out), cap, d, f, n_tiles, m_tiles, vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int ragged_matmul_f32(const void* x, const void* w, void* out,
                                 long long e, long long cap, long long d,
                                 long long f, void* stream) {
  return launch<float, kFM, kFN>(ragged_f32_kernel, x, w, out, e, cap, d, f,
                                 stream);
}

extern "C" int ragged_matmul_bf16(const void* x, const void* w, void* out,
                                  long long e, long long cap, long long d,
                                  long long f, void* stream) {
  return launch<bf16, kBM, kBN>(ragged_bf16_kernel, x, w, out, e, cap, d, f,
                                stream);
}
