// ragged_matmul_sm90: bf16 grouped expert GEMM on Hopper (sm_90a), the
// route of repro_torch.kernels.ragged_matmul for bf16 inputs that TMA can
// describe (D and F multiples of 8, 16-byte aligned tensors).
//
// Replaces the Pallas TPU kernel `_ragged_matmul` in
// src/repro/kernels/ragged_matmul.py (body `_kernel`), which walks the
// grid (E, cap/bm, F/bn, D/bk) in order and carries an f32 accumulator
// in VMEM across the K steps.
//
//   out[r, n] = sum_k x[r, k] * w[r / cap, k, n]    (f32 sum, bf16 out)
//
// x is (E*cap, D), expert-contiguous; w is (E, D, F).  Bound: at
// Kimi-K2's expert FFN (E=384, cap=56, D=7168, F=2048) the call must read
// w once, 11.3 GB: 3.4 ms at 3.35 TB/s against 0.64 ms of tensor-core
// operations, so the design is about keeping bytes in flight.
//
// A persistent grid, one block per SM, walks the output tiles (64 rows of
// one expert x BN columns) in the order of the earlier kernel: the F
// tiles of one expert side by side, so w is read from memory once and
// x's rows come from L2.  Two warpgroups: one thread of the first starts
// TMA loads into a ring of kStages stages (one 64 x 64 x tile and one
// 64 x BN w tile a stage, each stage on its own mbarrier, freed by the
// consumer through a second one): with BN = 256 that is 160 KB in flight
// per SM, 128 KB of it w.  The ring runs on across tile boundaries, so
// the next tile's loads overlap this tile's epilogue.  The second
// warpgroup runs wgmma m64nBNk16 (x K-major, w MN-major through the
// transpose bit, f32 accumulators in registers), then rounds the tile to
// bf16 through a padded shared-memory stage and writes it in 16-byte
// stores.
//
// The tensor maps are 3-D: x over (E, cap, D), so the rows of a 64-row
// tile past cap (8 of 64 at cap = 56) read zeros instead of the next
// expert's rows; w over (E, D, F).  Columns past D or F read zeros too,
// and stores past cap or F are skipped.
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBM = 64;       // rows a tile
constexpr int kBK = 64;       // K a stage (128 bytes of bf16)
constexpr int kStages = 4;
constexpr int kThreads = 256;  // producer + consumer warpgroup
constexpr int kConsumerWarps = 4;

// Shared memory: kStages x (x tile, w tile), the output stage, then the
// barriers (full[kStages], empty[kStages]).
template <int BN>
struct Layout {
  static constexpr int kX = kBM * 128;       // 64 rows x 64 K
  static constexpr int kWChunk = kBK * 128;  // 64 K rows x 64 columns
  static constexpr int kW = (BN / 64) * kWChunk;
  static constexpr int kStage = kX + kW;
  static constexpr int kLdC = BN + 8;  // bf16; rows 4 banks apart
  static constexpr int kC = kBM * kLdC * 2;
  static constexpr int kBars = kStages * kStage + kC;
  static constexpr int kSmem = kBars + 16 * kStages + 1024;
};

template <int BN>
__device__ __forceinline__ void product(float (&acc)[BN / 2], uint64_t a,
                                        uint64_t b, int scale_d) {
  if constexpr (BN == 128)
    wgmma_ss_m64n128<1>(acc, a, b, scale_d);
  else
    wgmma_ss_m64n256<1>(acc, a, b, scale_d);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
ragged_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   bf16* __restrict__ out, int cap, int d, int f,
                   int m_tiles, int n_tiles, int total) {
  using L = Layout<BN>;
  extern __shared__ uint8_t smem[];
  const uint32_t raw = smem_addr(smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full0 = base + L::kBars;
  const uint32_t empty0 = full0 + 8 * kStages;
  bf16* cs = reinterpret_cast<bf16*>(smem + (base - raw) +
                                     kStages * L::kStage);
  const int k_steps = (d + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ------------------------------------------------------- producer
    if (threadIdx.x == 0) {
      prefetch_map(&xmap);
      prefetch_map(&wmap);
      int it = 0;
      for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
        const int nt = tile % n_tiles;
        const int mt = (tile / n_tiles) % m_tiles;
        const int e = tile / (n_tiles * m_tiles);
        for (int ks = 0; ks < k_steps; ++ks, ++it) {
          const int s = it % kStages;
          const uint32_t full = full0 + 8 * s;
          mbar_wait(empty0 + 8 * s, ((it / kStages) & 1) ^ 1);
          const uint32_t st = base + s * L::kStage;
          mbar_expect_tx(full, L::kStage);
          tma_load_3d(st, &xmap, full, ks * kBK, mt * kBM, e);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(st + L::kX + c * L::kWChunk, &wmap, full,
                        nt * BN + 64 * c, ks * kBK, e);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumer
    const int t = threadIdx.x - 128, warp = t / 32, lane = t % 32;
    const int row = 16 * warp + lane / 4;  // and row + 8
    const int col0 = 2 * (lane % 4);
    int it = 0;
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int nt = tile % n_tiles;
      const int mt = (tile / n_tiles) % m_tiles;
      const int e = tile / (n_tiles * m_tiles);
      float acc[BN / 2];
      for (int ks = 0; ks < k_steps; ++ks, ++it) {
        const int s = it % kStages;
        mbar_wait(full0 + 8 * s, (it / kStages) & 1);
        const uint32_t st = base + s * L::kStage;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          product<BN>(acc, sw128_desc(st + kk * 32, 16, 1024),
                      sw128_desc(st + L::kX + kk * 2048, L::kWChunk, 1024),
                      ks > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(acc);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
      }

      // epilogue: bf16 through the padded stage, 16-byte stores
      bar_sync(1, 128);  // the previous tile's stores have read the stage
#pragma unroll
      for (int i = 0; i < BN / 2; i += 2) {
        const int r = row + 8 * ((i / 2) % 2);
        const int c = 8 * (i / 4) + col0;
        *reinterpret_cast<uint32_t*>(cs + r * L::kLdC + c) =
            pack_bf16(acc[i], acc[i + 1]);
      }
      bar_sync(1, 128);
      const int m0 = mt * kBM, n0 = nt * BN;
      const int rows = min(kBM, cap - m0);
      bf16* og = out + (int64_t(e) * cap + m0) * f + n0;
#pragma unroll 4
      for (int idx = t; idx < kBM * (BN / 8); idx += 128) {
        const int r = idx / (BN / 8), c = (idx % (BN / 8)) * 8;
        if (r < rows && n0 + c < f)
          *reinterpret_cast<uint4*>(og + int64_t(r) * f + c) =
              *reinterpret_cast<const uint4*>(cs + r * L::kLdC + c);
      }
    }
  }
}

template <int BN>
int launch(const void* x, const void* w, void* out, int64_t e, int64_t cap,
           int64_t d, int64_t f, int64_t grid, void* stream) {
  using L = Layout<BN>;
  static bool opted[64] = {};
  int err = smem_opt_in(ragged_sm90_kernel<BN>, L::kSmem, opted);
  if (err) return err;
  const int64_t m_tiles = (cap + kBM - 1) / kBM;
  const int64_t n_tiles = (f + BN - 1) / BN;
  const int64_t total = e * m_tiles * n_tiles;
  if (e < 1 || cap < 1 || d < 8 || f < 8 || d % 8 || f % 8 ||
      cap > 0x7fffffffLL || d > 0x7fffffffLL || f > 0x7fffffffLL ||
      total > 0x7fffffffLL || grid < 1 || grid > total)
    return int(cudaErrorInvalidValue);
  CUtensorMap xm, wm;
  if ((err = map_3d(&xm, x, d, cap, e, 64, kBM))) return err;
  if ((err = map_3d(&wm, w, f, d, e, 64, kBK))) return err;
  ragged_sm90_kernel<BN><<<unsigned(grid), kThreads, L::kSmem,
                           static_cast<cudaStream_t>(stream)>>>(
      xm, wm, static_cast<bf16*>(out), int(cap), int(d), int(f),
      int(m_tiles), int(n_tiles), int(total));
  return int(cudaGetLastError());
}

}  // namespace

// x (E*cap, D), w (E, D, F), out (E*cap, F): contiguous bf16, 16-byte
// aligned, D and F multiples of 8.  block_n (128 or 256) and grid (at most
// the number of tiles) come from the wrapper's plan.
extern "C" int ragged_matmul_sm90_bf16(const void* x, const void* w,
                                       void* out, long long e, long long cap,
                                       long long d, long long f,
                                       long long block_n, long long grid,
                                       void* stream) {
  if (block_n == 128)
    return launch<128>(x, w, out, e, cap, d, f, grid, stream);
  if (block_n == 256)
    return launch<256>(x, w, out, e, cap, d, f, grid, stream);
  return int(cudaErrorInvalidValue);
}
