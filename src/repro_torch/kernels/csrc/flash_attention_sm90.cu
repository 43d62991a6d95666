// flash_attention_sm90: bf16 online-softmax attention on Hopper's tensor
// cores (sm_90a), the bf16 route of repro_torch.kernels.flash_attention.
//
// Replaces the Pallas TPU kernel `_flash_attention` in
// src/repro/kernels/flash_attention.py (body `_kernel`), which walks the
// grid (B, H, Tq/bq, Tk/bk) with the key axis innermost and carries the
// running max, sum and accumulator in VMEM scratch across it.
//
//   out[b,h,i] = sum_j softmax_j(q[b,h,i] . k[b,h,j] / sqrt(d)) v[b,h,j]
//
// q is (B, H, tq, d), k and v (B, H, tk, d), bf16, d in {64, 128}.  One
// block takes one (b*h, 128-row query tile) and loops over 128-row key
// tiles (the TPU's sequential axis).  Three warpgroups: the first is the
// producer, of which one thread starts every TMA load (Q once, then K and
// V tiles into a ring of kStages stages, each completing on its own
// mbarrier; the consumers free a stage through a second mbarrier); the
// other two are consumers of 64 query rows each.  setmaxnreg moves the
// producer's registers to the consumers, which hold the output rows
// (d/2 f32 a thread) and one tile of scores (64 f32) in registers.
//
// Per key tile a consumer warpgroup runs S = Q K^T as wgmma m64n128k16
// (both operands in shared memory, K-major), masks it if the tile crosses
// the causal frontier or the end of k, folds it into the running max and
// sum (exp2 with scale * log2(e) folded in; a row's max and sum reduced
// over the 4 lanes that share it), rounds p to bf16 in registers, as the
// Pallas kernel's p.astype(v.dtype) does, and runs O += P V as wgmma
// m64nDk16 with P as the register A operand (the accumulator layout of
// S is the A-fragment layout) and V MN-major through the descriptor's
// transpose bit.  Scores, softmax state and O are f32.
//
// The tensor maps are 3-D over (B*H, T, d), so rows past T read zeros and
// no padding is needed.  Causal masks align bottom-right, as
// repro.kernels.ref does: query row i sees key columns j <= i + tk - tq.
// Key tiles past that frontier are never loaded, and only tiles that
// cross it are masked.  A row with no live key writes zeros.  Blocks take
// the query tiles heaviest first (every head's last tile, then the one
// before), so the causal tail is short.
//
// Bound: at Mistral-NeMo-12B prefill (B=1, H=32, T=4096, d=128, causal)
// the call does 137.5 GFLOP on 134 MB: 0.139 ms of tensor-core operations
// at 989 TFLOP/s against 0.040 ms of bytes, so operations bound it.
#include <math_constants.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kBQ = 128;       // query rows a block (two warpgroups of 64)
constexpr int kBK = 128;       // key rows a stage
constexpr int kStages = 2;     // K/V stages in the ring
constexpr int kThreads = 384;  // producer + two consumer warpgroups
constexpr int kConsumerWarps = 8;

// Shared memory: Q, then kStages x (K, V), each as d/64 chunks of rows x
// 128 bytes, then the barriers (Q, full[kStages], empty[kStages]).
template <int D>
struct Layout {
  static constexpr int kChunks = D / 64;
  static constexpr int kQChunk = kBQ * 128;
  static constexpr int kKChunk = kBK * 128;
  static constexpr int kQ = kChunks * kQChunk;
  static constexpr int kK = kChunks * kKChunk;  // K (or V) of one stage
  static constexpr int kStage = 2 * kK;
  static constexpr int kBars = kQ + kStages * kStage;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * kStages) + 1024;
};

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  if constexpr (D == 64)
    wgmma_rs_m64n64<1>(o, a, b, 1);
  else
    wgmma_rs_m64n128<1>(o, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  bf16* __restrict__ out, int bh_count, int tq, int tk,
                  int q_tiles, int causal, float scale_log2) {
  using L = Layout<D>;
  extern __shared__ uint8_t smem[];
  const uint32_t base = (smem_addr(smem) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t skv = base + L::kQ;
  const uint32_t qbar = base + L::kBars;
  const uint32_t full0 = qbar + 8;
  const uint32_t empty0 = full0 + 8 * kStages;

  // heaviest first: every head's last query tile, then the one before
  const int qt = q_tiles - 1 - int(blockIdx.x) / bh_count;
  const int bh = int(blockIdx.x) % bh_count;
  const int q0 = qt * kBQ;
  const int off = tk - tq;  // bottom-right alignment
  int n_kt = (tk + kBK - 1) / kBK;
  if (causal) {
    const int last = min(q0 + kBQ, tq) - 1 + off;
    n_kt = min(n_kt, last < 0 ? 0 : last / kBK + 1);
  }

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    fence_mbar_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0 && n_kt > 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(qbar, L::kQ);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load_3d(sq + c * L::kQChunk, &qmap, qbar, 64 * c, q0, bh);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % kStages;
        const uint32_t full = full0 + 8 * s;
        mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
        const uint32_t st = skv + s * L::kStage;
        mbar_expect_tx(full, L::kStage);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c) {
          tma_load_3d(st + c * L::kKChunk, &kmap, full, 64 * c, kt * kBK,
                      bh);
          tma_load_3d(st + L::kK + c * L::kKChunk, &vmap, full, 64 * c,
                      kt * kBK, bh);
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    setmaxnreg_inc<232>();
    const int cw = wg - 1;  // rows q0 + 64 cw ... + 63
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int first_row = q0 + 64 * cw;
    const int row0 = first_row + 16 * warp + lane / 4;  // and row0 + 8
    const int col0 = 2 * (lane % 4);
    const uint32_t qa = sq + cw * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float m[2] = {-CUDART_INF_F, -CUDART_INF_F}, l[2] = {0.0f, 0.0f};

    if (n_kt > 0) mbar_wait(qbar, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      const uint32_t ks = skv + s * L::kStage, vs = ks + L::kK;

      // S = Q K^T, K-major operands, 32 bytes of K per step
      float sc[kBK / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t at = (kk / 4) * L::kQChunk + (kk % 4) * 32;
        const uint32_t bt = (kk / 4) * L::kKChunk + (kk % 4) * 32;
        wgmma_ss_m64n128<0>(sc, sw128_desc(qa + at, 16, 1024),
                            sw128_desc(ks + bt, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      const int k0 = kt * kBK;
      if (k0 + kBK > tk || (causal && k0 + kBK - 1 > first_row + off)) {
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int row = row0 + 8 * ((i / 2) % 2);
          const int col = k0 + 8 * (i / 4) + col0 + i % 2;
          if (col >= tk || (causal && col > row + off))
            sc[i] = -CUDART_INF_F;
        }
      }

      // online softmax in the log2 domain; a row with nothing live yet
      // keeps m = -inf, l = 0, o = 0
      float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i)
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      float mu[2], alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * scale_log2);
        mu[r] = m_new == -CUDART_INF_F ? 0.0f : m_new;
        alpha[r] = exp2f(m[r] - mu[r]);
        m[r] = m_new;
      }
      float sum[2] = {0.0f, 0.0f};
      uint32_t pa[kBK / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = 8 * kk + 2 * j, r = j % 2;
          const float p0 = exp2f(fmaf(sc[i], scale_log2, -mu[r]));
          const float p1 = exp2f(fmaf(sc[i + 1], scale_log2, -mu[r]));
          sum[r] += p0 + p1;
          pa[kk][j] = pack_bf16(p0, p1);
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];

      // O += P V: P from registers, V MN-major (16 key rows = 2048 bytes
      // a step, the next 64 columns in the next chunk)
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        pv_product<D>(o, pa[kk],
                      sw128_desc(vs + kk * 2048, L::kKChunk, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = l[r] > 0.0f ? 1.0f / l[r] : 0.0f;
    }
    bf16* og = out + int64_t(bh) * tq * D;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int r = (i / 2) % 2, row = row0 + 8 * r;
      const int col = 8 * (i / 4) + col0;
      if (row < tq)
        *reinterpret_cast<uint32_t*>(og + int64_t(row) * D + col) =
            pack_bf16(o[i] * inv[r], o[i + 1] * inv[r]);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out,
           int64_t bh, int64_t tq, int64_t tk, int64_t causal,
           void* stream) {
  using L = Layout<D>;
  static bool opted[64] = {};
  int err = smem_opt_in(flash_sm90_kernel<D>, L::kSmem, opted);
  if (err) return err;
  const int64_t q_tiles = (tq + kBQ - 1) / kBQ;
  if (bh < 1 || tq < 1 || tk < 1 || tq > 0x7fffffffLL ||
      tk > 0x7fffffffLL || bh * q_tiles > 0x7fffffffLL)
    return int(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  if ((err = map_3d(&qm, q, D, tq, bh, 64, kBQ))) return err;
  if ((err = map_3d(&km, k, D, tk, bh, 64, kBK))) return err;
  if ((err = map_3d(&vm, v, D, tk, bh, 64, kBK))) return err;
  const float scale_log2 = 1.4426950408889634f / sqrtf(float(D));
  flash_sm90_kernel<D><<<unsigned(bh * q_tiles), kThreads, L::kSmem,
                         static_cast<cudaStream_t>(stream)>>>(
      qm, km, vm, static_cast<bf16*>(out), int(bh), int(tq), int(tk),
      int(q_tiles), int(causal != 0), scale_log2);
  return int(cudaGetLastError());
}

}  // namespace

// q, k, v, out: contiguous bf16 (B*H, T, d), 16-byte aligned; block_q and
// block_k must be the tiles this library was built with (the wrapper's
// plan names them).
extern "C" int flash_attention_sm90_bf16(const void* q, const void* k,
                                         const void* v, void* out,
                                         long long bh, long long tq,
                                         long long tk, long long d,
                                         long long causal, long long block_q,
                                         long long block_k, void* stream) {
  if (block_q != kBQ || block_k != kBK) return int(cudaErrorInvalidValue);
  if (d == 64) return launch<64>(q, k, v, out, bh, tq, tk, causal, stream);
  if (d == 128)
    return launch<128>(q, k, v, out, bh, tq, tk, causal, stream);
  return int(cudaErrorInvalidValue);
}
