// Flash attention backward for Hopper (sm_90a): bf16 q, k, v, dO + the
// forward's f32 LSE and di = rowsum(O * dO) in, bf16 dQ, dK, dV out.
//
// Replaces the two Pallas kernels of vlrlhf_tpu/ops/flash_attention.py:
// `_bwd_dkv_kernel` (dK, dV per KV block, iterating over Q blocks) and
// `_bwd_dq_kernel` (dQ per Q block, iterating over KV blocks). Same
// arithmetic: recompute p = exp(s * scale - lse) under the forward's mask
// (segment ids, where a padded query row carries -3 and a padded key -1,
// and causality by absolute index), dp = dO V^T, ds = p (dp - di) scale,
// dV = P^T dO, dK = dS^T Q, dQ = dS K. Two kernels and no atomics, as on the
// TPU, so the result is deterministic.
//
// Differences by design: GQA is handled inside the dK/dV kernel, which loops
// over the H / Hkv query heads of its KV head and sums their contributions
// in registers (the VJP of the JAX wrapper's jnp.repeat, done without a
// (B, S, H, D) intermediate); inputs stay in the strided (B, S, H, D) layout
// the forward takes; the ragged S edge is masked in-kernel; a fully masked
// query row (LSE -inf) contributes nothing: its p is produced as 0 before
// any product, so inf * 0 never appears.
//
// What bounds it on the H100: 2.5x the forward's matmul work (QK^T and dO V^T
// recomputed, then P^T dO, dS^T Q and dS K) over the same bytes, so it is
// compute-bound at S ~ 1000, D = 128: each kernel has to keep the tensor
// cores fed, which on Hopper means wgmma from swizzled shared memory that TMA
// fills while the previous tile is in use. Both kernels (D <= 128) are the
// forward's Hopper machinery (hopper.cuh): TMA, an mbarrier ring, a producer
// warp and two consumer warpgroups running wgmma (details at each kernel).
//   dK/dV (flash_bwd_dkv_wgmma_kernel): 128 keys a CTA, Q and dO streamed.
//   dQ (flash_bwd_dq_wgmma_kernel): 128 queries a CTA, Q and dO loaded once,
//     K and V streamed; it recomputes S and dP (two of its three GEMMs), so
//     it costs 1.5x the forward's work. mma.sync on fragments re-read
//     through ldmatrix, behind loads it waits for, reaches about a tenth of
//     the H100's bf16 peak here; so the ring's TMA loads, one warpgroup's
//     exp / dS work and the other's GEMMs overlap, and each tile's dQ
//     product stays in flight under the next tile's S and dP.
// D = 256 does not fit the wgmma kernels' f32 accumulators in registers (dK
// and dV 128 each; dQ 128 beside S and dP) and dispatches by shape to the
// FlashAttention-2 kernels below, on mma.sync m16n8k16, 4 warps a CTA, every
// warp owning 16 rows end to end:
//   dK/dV: a CTA owns 64 keys of one KV head; each warp computes S^T and
//     dP^T for its 16 keys against a 32-query tile, turns them into P^T and
//     dS^T in registers and feeds them straight back as the A operand of
//     dV += P^T dO and dK += dS^T Q. dK and dV accumulate in f32 registers
//     across every query tile of every head in the GQA group. Q, dO (and
//     their LSE, di, segment ids) stream through a 2-stage cp.async ring;
//     causal skipping starts at the first query tile that reaches the KV
//     block.
//   dQ: a CTA owns 64 queries of one head; each warp computes S and dP for
//     its 16 queries against a 64-key tile, dS in registers, dQ += dS K.
//     K/V stream through a 2-stage ring; causal skipping stops at the
//     diagonal.
// The mma.sync kernels re-read operand fragments from shared memory with
// ldmatrix (padded rows, conflict-free) instead of holding them in
// registers, which keeps the f32 accumulators in registers.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"

namespace {

using hopper::fast_exp2;
using hopper::ldmatrix_x2;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma16816;
using hopper::pack_bf16;
using hopper::smem_u32;

constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int MAX_D = 256;
constexpr int Q_PAD_SEG = -3;
constexpr int DKV_BN = 64;  // mma.sync dK/dV kernel: keys per CTA
constexpr int DKV_BM = 32;  // mma.sync dK/dV kernel: queries per streamed tile
constexpr int DQ_BM = 64;   // mma.sync dQ kernel: queries per CTA
constexpr int DQ_BN = 64;   // mma.sync dQ kernel: keys per streamed tile

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;     // (B, Sq, H, D) strided
  const bf16* k;     // (B, Skv, Hkv, D) strided
  const bf16* v;
  const bf16* dout;  // (B, Sq, H, D) contiguous
  const float* lse;  // (B, H, Sq)
  const float* di;   // (B, H, Sq)
  const int* seg_q;  // (B, Sq)
  const int* seg_kv; // (B, Skv)
  bf16* dq;          // (B, Sq, H, D) contiguous
  bf16* dk;          // (B, Skv, Hkv, D) contiguous
  bf16* dv;
  int B, H, Hkv, Sq, Skv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  float scale;
  int causal;
};

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 destination bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Copy rows [r0, r0+ROWS) x [0, DP) of one head into a padded shared tile
// (row stride DP + 8) as 16-byte cp.async chunks; rows past `rows` and
// columns past D are zero-filled.
template <int ROWS, int DP>
__device__ inline void load_tile_async(bf16* dst, const bf16* base, long long row_stride,
                                       int r0, int rows, int D) {
  constexpr int CPR = DP / 8;  // chunks per row
  for (int c = threadIdx.x; c < ROWS * CPR; c += NTHREADS) {
    const int r = c / CPR;
    const int d = (c % CPR) * 8;
    const bool ok = (r0 + r < rows) && (d < D);
    const bf16* src = ok ? base + (long long)(r0 + r) * row_stride + d : base;
    cp_async16(dst + r * (DP + 8) + d, src, ok);
  }
}

// Row-major A fragment (16 rows x 16 cols at column k0) of a padded tile.
template <int LD>
__device__ inline void load_a(uint32_t (&a)[4], const bf16* tile, int row0, int k0, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane % 16)) * LD + k0 + (lane / 16) * 8);
}
// B fragment (k = 16 columns at k0, n = 8 rows at n0) of a tile whose rows
// are the n index: the "col" operand of QK^T-shaped products.
template <int LD>
__device__ inline void load_b_rows(uint32_t (&b)[2], const bf16* tile, int n0, int k0, int lane) {
  ldmatrix_x2(b, tile + (n0 + (lane % 8)) * LD + k0 + ((lane / 8) % 2) * 8);
}
// Two B fragments (k = 16 rows at k0, n = 16 columns at n0) of a tile whose
// rows are the k index: the operand of P V-shaped products.
template <int LD>
__device__ inline void load_b_trans(uint32_t (&b)[4], const bf16* tile, int k0, int n0, int lane) {
  ldmatrix_x4_trans(b, tile + (k0 + (lane % 16)) * LD + n0 + (lane / 16) * 8);
}

// ─────────────────────────── dK / dV on mma.sync (D = 256) ───────────────────────────

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dkv_kernel(Params p) {
  constexpr int LD = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int DTILES = DP / 8;
  constexpr int BN = DKV_BN;
  constexpr int BM = DKV_BM;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BN * LD;
  bf16* sQ = sV + BN * LD;      // 2 stages
  bf16* sdO = sQ + 2 * BM * LD; // 2 stages
  float* sLse = reinterpret_cast<float*>(sdO + 2 * BM * LD);  // 2 stages x BM
  float* sDi = sLse + 2 * BM;
  int* sSeg = reinterpret_cast<int*>(sDi + 2 * BM);

  const int n0 = blockIdx.x * BN;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = p.H / p.Hkv;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;

  // this thread's two key rows: warp*16 + g and warp*16 + g + 8
  int krow[2], segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    krow[i] = n0 + warp * 16 + g + 8 * i;
    segk[i] = krow[i] < p.Skv ? p.seg_kv[(long long)b * p.Skv + krow[i]] : INT32_MIN;
  }

  // the first query tile that can see this KV block (BM divides BN)
  const int m_start = p.causal ? n0 : 0;
  const int nq = m_start < p.Sq ? (p.Sq - m_start + BM - 1) / BM : 0;
  const int n_iters = G * nq;

  const long long do_ss = (long long)p.H * p.D;
  const long long do_sb = (long long)p.Sq * do_ss;

  auto load_q = [&](int it, int stage) {
    const int h = hk * G + it / nq;
    const int m0 = m_start + (it % nq) * BM;
    load_tile_async<BM, DP>(sQ + stage * BM * LD, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, m0,
                            p.Sq, p.D);
    load_tile_async<BM, DP>(sdO + stage * BM * LD, p.dout + b * do_sb + (long long)h * p.D,
                            do_ss, m0, p.Sq, p.D);
    const long long row = ((long long)b * p.H + h) * p.Sq;
    for (int j = threadIdx.x; j < BM; j += NTHREADS) {
      const int qi = m0 + j;
      const bool ok = qi < p.Sq;
      sLse[stage * BM + j] = ok ? p.lse[row + qi] : -INFINITY;
      sDi[stage * BM + j] = ok ? p.di[row + qi] : 0.f;
      sSeg[stage * BM + j] = ok ? p.seg_q[(long long)b * p.Sq + qi] : Q_PAD_SEG;
    }
  };

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t) {
    dk[t][0] = dk[t][1] = dk[t][2] = dk[t][3] = 0.f;
    dv[t][0] = dv[t][1] = dv[t][2] = dv[t][3] = 0.f;
  }

  if (n_iters > 0) {
    load_tile_async<BN, DP>(sK, p.k + b * p.k_sb + hk * p.k_sh, p.k_ss, n0, p.Skv, p.D);
    load_tile_async<BN, DP>(sV, p.v + b * p.v_sb + hk * p.v_sh, p.v_ss, n0, p.Skv, p.D);
    load_q(0, 0);
    cp_async_commit();
  }

  for (int it = 0; it < n_iters; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_iters) {
      load_q(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cQ = sQ + stage * BM * LD;
    const bf16* cdO = sdO + stage * BM * LD;
    const float* cLse = sLse + stage * BM;
    const float* cDi = sDi + stage * BM;
    const int* cSeg = sSeg + stage * BM;
    const int m0 = m_start + (it % nq) * BM;

    // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x BM queries
    float s[BM / 8][4], dp[BM / 8][4];
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t ka[4], va[4];
      load_a<LD>(ka, sK, warp * 16, ks * 16, lane);
      load_a<LD>(va, sV, warp * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) {
        uint32_t qb[2], ob[2];
        load_b_rows<LD>(qb, cQ, j * 8, ks * 16, lane);
        load_b_rows<LD>(ob, cdO, j * 8, ks * 16, lane);
        mma16816(s[j], ka, qb[0], qb[1]);
        mma16816(dp[j], va, ob[0], ob[1]);
      }
    }

    // P^T and dS^T in registers; a masked entry is 0 before any product
#pragma unroll
    for (int j = 0; j < BM / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int cl = j * 8 + tq * 2 + (e % 2);
        const int qi = m0 + cl;
        const float lse = cLse[cl];
        const bool ok = qi < p.Sq && krow[r] < p.Skv && (!p.causal || krow[r] <= qi) &&
                        cSeg[cl] == segk[r] && lse != -INFINITY;
        const float pv = ok ? __expf(s[j][e] * p.scale - lse) : 0.f;
        s[j][e] = pv;
        dp[j][e] = pv * (dp[j][e] - cDi[cl]) * p.scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q: the accumulators become A operands
#pragma unroll
    for (int kk = 0; kk < BM / 16; ++kk) {
      uint32_t pa[4], da[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      da[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      da[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      da[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      da[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; t += 2) {
        uint32_t ob[4], qb[4];
        load_b_trans<LD>(ob, cdO, kk * 16, t * 8, lane);
        mma16816(dv[t], pa, ob[0], ob[1]);
        mma16816(dv[t + 1], pa, ob[2], ob[3]);
        load_b_trans<LD>(qb, cQ, kk * 16, t * 8, lane);
        mma16816(dk[t], da, qb[0], qb[1]);
        mma16816(dk[t + 1], da, qb[2], qb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= p.Skv) continue;
    const long long off = (((long long)b * p.Skv + krow[r]) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int t = 0; t < DTILES; ++t) {
      const int d = t * 8 + tq * 2;
      if (d < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + off + d) =
            __floats2bfloat162_rn(dk[t][2 * r], dk[t][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + off + d) =
            __floats2bfloat162_rn(dv[t][2 * r], dv[t][2 * r + 1]);
      }
    }
  }
}

// ─────────────────────── dK / dV on wgmma (D <= 128) ───────────────────────
//
// One CTA per (128 keys, KV head, batch row), three warpgroups. Warp 0 of the
// first is the producer: it TMA-loads the CTA's K and V tiles once, then
// streams 64-query tiles of Q and dO (every query tile of every head in the
// GQA group) through a ring of ST stages, and beside each tile writes its
// base-2 LSE, di and query segment ids, and their min / max, to shared
// memory. setmaxnreg hands its registers to the two consumer warpgroups,
// which own 64 keys each. Per query tile a consumer computes
//   S^T = K Q^T and dP^T = V dO^T   (wgmma, both operands K-major along D,
//                                    two commit groups: P^T is built while
//                                    dP^T is still in flight),
//   P^T = exp2(S^T scale log2(e) - lse2[query]) under the mask and
//   dS^T = P^T (dP^T - di[query])   (f32 registers; the per-query values
//                                    index the accumulator's columns),
//   dV += P^T dO and dK += dS^T Q   (wgmma with P^T / dS^T packed to bf16 as
//                                    the register A operand, dO and Q read
//                                    MN-major, as the forward reads V).
// dK and dV stay in f32 registers (64 + 64 at D = 128) across every tile;
// dK takes the softmax scale once at the end. A row past Sq or fully masked
// (LSE -inf) carries lse2 = +inf, so its p is 0 before any product. Masks
// apply only to tiles that straddle the diagonal, the ragged edge or a
// segment boundary (decided per warp from the tile's segment range). Causal
// work starts at the first query tile that reaches the key block, and the
// key-block index is the grid's slowest dimension, heaviest first. No
// atomics: deterministic.

constexpr int WBN = 128;       // keys per CTA: 64 per consumer warpgroup
constexpr int WBM = 64;        // queries per streamed tile
constexpr int WTHREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory plan (byte offsets from a 1024-aligned base). Each operand
// tile is DP/64 blocks of rows x 128 bytes in the 128-byte swizzle.
template <int DP, int ST>
struct DkvPlan {
  static constexpr int CH = DP / 64;
  static constexpr int KV_BYTES = CH * WBN * 128;  // K or V
  static constexpr int QT_BYTES = CH * WBM * 128;  // one Q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + ST * QT_BYTES;
  static constexpr int ROW_OFF = DO_OFF + ST * QT_BYTES;  // f32 lse2, di, int seg: [ST][WBM] each
  static constexpr int RANGE_OFF = ROW_OFF + 3 * ST * WBM * 4;  // int2 [ST]: min, max
  static constexpr int BAR_OFF = RANGE_OFF + ST * 8;            // kv, full[ST], empty[ST]
  static constexpr int ALLOC = BAR_OFF + (1 + 2 * ST) * 8 + 1024;  // + alignment slack
};

template <int DP, int ST>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using namespace hopper;
  using L = DkvPlan<DP, ST>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sK = smem;
  unsigned char* sV = smem + L::V_OFF;
  unsigned char* sQ = smem + L::Q_OFF;
  unsigned char* sdO = smem + L::DO_OFF;
  float* sLse = reinterpret_cast<float*>(smem + L::ROW_OFF);
  float* sDi = sLse + ST * WBM;
  int* sSeg = reinterpret_cast<int*>(sDi + ST * WBM);
  int2* sRange = reinterpret_cast<int2*>(smem + L::RANGE_OFF);
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + ST;

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int n0 = blockIdx.z * WBN;
  const int G = p.H / p.Hkv;
  // the first query tile that can see this key block (WBM divides WBN)
  const int m_start = p.causal ? n0 : 0;
  const int nq = m_start < p.Sq ? (p.Sq - m_start + WBM - 1) / WBM : 0;
  const int n_iters = G * nq;
  // warp-uniform as far as the compiler can see (a divergent-looking branch
  // around wgmma makes ptxas serialize it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);  // TMA bytes + the producer warp's 32 lanes (row values)
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32 || n_iters == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::KV_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(sK + c * WBN * 128, &tm_k, bar_kv, c * 64, hk, n0, b);
        tma_load_4d(sV + c * WBN * 128, &tm_v, bar_kv, c * 64, hk, n0, b);
      }
    }
    for (int it = 0; it < n_iters; ++it) {
      const int st = it % ST;
      const int h = hk * G + it / nq;
      const int m0 = m_start + (it % nq) * WBM;
      mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, so the row loads below overlap them
        mbar_arrive_expect_tx(&full[st], 2 * L::QT_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(sQ + st * L::QT_BYTES + c * WBM * 128, &tm_q, &full[st], c * 64, h, m0, b);
          tma_load_4d(sdO + st * L::QT_BYTES + c * WBM * 128, &tm_do, &full[st], c * 64, h, m0,
                      b);
        }
      }
      const long long row = ((long long)b * p.H + h) * p.Sq;
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < WBM; j += 32) {
        const int qi = m0 + j;
        const bool ok = qi < p.Sq;
        const float l = ok ? p.lse[row + qi] : -INFINITY;
        sLse[st * WBM + j] = l == -INFINITY ? INFINITY : l * LOG2E;  // p = 2^(x - inf) = 0
        sDi[st * WBM + j] = ok ? p.di[row + qi] : 0.f;
        const int s = ok ? p.seg_q[(long long)b * p.Sq + qi] : Q_PAD_SEG;
        sSeg[st * WBM + j] = s;
        lo = min(lo, s);
        hi = max(hi, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) sRange[st] = make_int2(lo, hi);
      mbar_arrive(&full[st]);  // each lane releases its own row-value stores
    }
    return;
  }

  // ---------------- consumers: 64 keys each ----------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // lane within the quad
  int krow[2], segk[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    krow[i] = n0 + cw * 64 + warp * 16 + g + 8 * i;
    // a key past Skv never matches (TMA's zero rows would give p = 2^-lse2)
    segk[i] = krow[i] < p.Skv ? p.seg_kv[(long long)b * p.Skv + krow[i]] : INT_MIN;
  }
  const float scale_log2 = p.scale * LOG2E;

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  float s[WBM / 2], dp[WBM / 2];
  uint32_t pa[WBM / 16][4], da[WBM / 16][4];
  const uint64_t dk_a = desc_sw128(sK + cw * 64 * 128, 16, 1024);
  const uint64_t dv_a = desc_sw128(sV + cw * 64 * 128, 16, 1024);
  if (n_iters > 0) mbar_wait(bar_kv, 0);

  for (int it = 0; it < n_iters; ++it) {
    const int st = it % ST;
    const int m0 = m_start + (it % nq) * WBM;
    unsigned char* cQ = sQ + st * L::QT_BYTES;
    unsigned char* cdO = sdO + st * L::QT_BYTES;
    mbar_wait(&full[st], (it / ST) & 1);
    // S^T = K Q^T, then dP^T = V dO^T: two commit groups
    const uint64_t dq_b = desc_sw128(cQ, 16, 1024);
    const uint64_t ddo_b = desc_sw128(cdO, 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int aoff = (ks / 4) * (WBN * 128) + (ks % 4) * 32;
      const int boff = (ks / 4) * (WBM * 128) + (ks % 4) * 32;
      wgmma_ss<WBM>(s, dk_a + (aoff >> 4), dq_b + (boff >> 4), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int aoff = (ks / 4) * (WBN * 128) + (ks % 4) * 32;
      const int boff = (ks / 4) * (WBM * 128) + (ks % 4) * 32;
      wgmma_ss<WBM>(dp, dv_a + (aoff >> 4), ddo_b + (boff >> 4), ks > 0);
    }
    wgmma_commit();

    wgmma_wait<1>();  // S^T is ready; dP^T is still in flight
#pragma unroll
    for (int i = 0; i < WBM / 2; ++i) fence_operand(s[i]);
    const float* lse2 = sLse + st * WBM;
    const float* dis = sDi + st * WBM;
    const int2 rg = sRange[st];
    const bool uniform = rg.x == rg.y && rg.x == segk[0] && rg.x == segk[1];
    const bool below = !p.causal || krow[1] <= m0;  // every key of the thread <= every query
    if (__all_sync(0xffffffffu, uniform && below)) {  // decided per warp
#pragma unroll
      for (int j = 0; j < WBM / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse2 + j * 8 + tq * 2);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[4 * j + e] = fast_exp2(s[4 * j + e] * scale_log2 - (e % 2 ? l.y : l.x));
        }
      }
    } else {
      const int* seg = sSeg + st * WBM;
#pragma unroll
      for (int j = 0; j < WBM / 8; ++j) {
        const int cl = j * 8 + tq * 2;
        const float2 l = *reinterpret_cast<const float2*>(lse2 + cl);
        const int sq[2] = {seg[cl], seg[cl + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const bool ok = (!p.causal || krow[r] <= m0 + cl + (e % 2)) && sq[e % 2] == segk[r];
          s[4 * j + e] =
              ok ? fast_exp2(s[4 * j + e] * scale_log2 - (e % 2 ? l.y : l.x)) : 0.f;
        }
      }
    }
#pragma unroll
    for (int kk = 0; kk < WBM / 16; ++kk) {  // P^T as wgmma's register A fragments
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    wgmma_wait<0>();  // dP^T is ready
#pragma unroll
    for (int i = 0; i < WBM / 2; ++i) fence_operand(dp[i]);
#pragma unroll
    for (int j = 0; j < WBM / 8; ++j) {
      const float2 d = *reinterpret_cast<const float2*>(dis + j * 8 + tq * 2);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dp[4 * j + e] = s[4 * j + e] * (dp[4 * j + e] - (e % 2 ? d.y : d.x));
      }
    }
#pragma unroll
    for (int kk = 0; kk < WBM / 16; ++kk) {
      da[kk][0] = pack_bf16(dp[8 * kk + 0], dp[8 * kk + 1]);
      da[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
      da[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
      da[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
    }

    // dV += P^T dO, dK += dS^T Q: dO and Q MN-major (queries are rows)
    const uint64_t bdo = desc_sw128(cdO, WBM * 128, 1024);
    const uint64_t bq = desc_sw128(cQ, WBM * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBM / 16; ++kk) wgmma_rs_tb<DP>(dv, pa[kk], bdo + ((kk * 2048) >> 4), 1);
#pragma unroll
    for (int kk = 0; kk < WBM / 16; ++kk) wgmma_rs_tb<DP>(dk, da[kk], bq + ((kk * 2048) >> 4), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) {
      fence_operand(dk[i]);
      fence_operand(dv[i]);
    }
#pragma unroll
    for (int kk = 0; kk < WBM / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        fence_operand(pa[kk][e]);
        fence_operand(da[kk][e]);
      }
    __syncwarp();  // this warp is done with stage st
    if (lane == 0) mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (krow[r] >= p.Skv) continue;
    const long long off = (((long long)b * p.Skv + krow[r]) * p.Hkv + hk) * p.D;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int d = t * 8 + tq * 2;
      if (d < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(p.dk + off + d) = __floats2bfloat162_rn(
            dk[4 * t + 2 * r] * p.scale, dk[4 * t + 2 * r + 1] * p.scale);
        *reinterpret_cast<__nv_bfloat162*>(p.dv + off + d) =
            __floats2bfloat162_rn(dv[4 * t + 2 * r], dv[4 * t + 2 * r + 1]);
      }
    }
  }
}

// ─────────────────────────── dQ on mma.sync (D = 256) ───────────────────────────

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_bwd_dq_kernel(Params p) {
  constexpr int LD = DP + 8;
  constexpr int KSTEPS = DP / 16;
  constexpr int DTILES = DP / 8;
  constexpr int BM = DQ_BM;
  constexpr int BN = DQ_BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdO = sQ + BM * LD;
  bf16* sK = sdO + BM * LD;    // 2 stages
  bf16* sV = sK + 2 * BN * LD; // 2 stages
  int* sSeg = reinterpret_cast<int*>(sV + 2 * BN * LD);  // 2 stages x BN

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;

  const long long do_ss = (long long)p.H * p.D;
  const long long do_sb = (long long)p.Sq * do_ss;
  const bf16* kbase = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vbase = p.v + b * p.v_sb + hk * p.v_sh;
  const int* segkv = p.seg_kv + (long long)b * p.Skv;

  // this thread's two query rows: warp*16 + g and warp*16 + g + 8
  int qrow[2], segq[2];
  float lse[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = m0 + warp * 16 + g + 8 * i;
    const bool ok = qrow[i] < p.Sq;
    const long long row = ((long long)b * p.H + h) * p.Sq + qrow[i];
    segq[i] = ok ? p.seg_q[(long long)b * p.Sq + qrow[i]] : Q_PAD_SEG;
    lse[i] = ok ? p.lse[row] : -INFINITY;
    di[i] = ok ? p.di[row] : 0.f;
  }

  const int n_end = p.causal ? min(p.Skv, m0 + BM) : p.Skv;
  const int n_tiles = (n_end + BN - 1) / BN;

  auto load_kv = [&](int tile, int stage) {
    const int n0 = tile * BN;
    load_tile_async<BN, DP>(sK + stage * BN * LD, kbase, p.k_ss, n0, p.Skv, p.D);
    load_tile_async<BN, DP>(sV + stage * BN * LD, vbase, p.v_ss, n0, p.Skv, p.D);
    for (int j = threadIdx.x; j < BN; j += NTHREADS) {
      sSeg[stage * BN + j] = (n0 + j < p.Skv) ? segkv[n0 + j] : INT32_MIN;
    }
  };

  float acc[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  if (n_tiles > 0) {
    load_tile_async<BM, DP>(sQ, p.q + b * p.q_sb + h * p.q_sh, p.q_ss, m0, p.Sq, p.D);
    load_tile_async<BM, DP>(sdO, p.dout + b * do_sb + (long long)h * p.D, do_ss, m0, p.Sq, p.D);
    load_kv(0, 0);
    cp_async_commit();
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_kv(it + 1, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* cK = sK + stage * BN * LD;
    const bf16* cV = sV + stage * BN * LD;
    const int* cSeg = sSeg + stage * BN;
    const int n0 = it * BN;

    // S = Q K^T and dP = dO V^T for this warp's 16 queries x BN keys
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, sQ, warp * 16, ks * 16, lane);
      load_a<LD>(oa, sdO, warp * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        uint32_t kb[2], vb[2];
        load_b_rows<LD>(kb, cK, j * 8, ks * 16, lane);
        load_b_rows<LD>(vb, cV, j * 8, ks * 16, lane);
        mma16816(s[j], qa, kb[0], kb[1]);
        mma16816(dp[j], oa, vb[0], vb[1]);
      }
    }

    // dS in registers; a masked entry is 0 before any product
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int cl = j * 8 + tq * 2 + (e % 2);
        const int col = n0 + cl;
        const bool ok = col < p.Skv && (!p.causal || col <= qrow[r]) && cSeg[cl] == segq[r] &&
                        lse[r] != -INFINITY;
        const float pv = ok ? __expf(s[j][e] * p.scale - lse[r]) : 0.f;
        s[j][e] = pv * (dp[j][e] - di[r]) * p.scale;
      }
    }

    // dQ += dS K: dS's accumulators become the A operand in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t da[4];
      da[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      da[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      da[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      da[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; t += 2) {
        uint32_t kb[4];
        load_b_trans<LD>(kb, cK, kk * 16, t * 8, lane);
        mma16816(acc[t], da, kb[0], kb[1]);
        mma16816(acc[t + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.Sq) continue;
    bf16* out = p.dq + (((long long)b * p.Sq + qrow[r]) * p.H + h) * p.D;
#pragma unroll
    for (int t = 0; t < DTILES; ++t) {
      const int d = t * 8 + tq * 2;
      if (d < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(acc[t][2 * r], acc[t][2 * r + 1]);
      }
    }
  }
}

// ──────────────────────────── dQ on wgmma (D <= 128) ────────────────────────────
//
// One CTA per (128 queries, head, batch row), three warpgroups, the forward's
// structure with its operand roles. Warp 0 of the first is the producer: it
// TMA-loads the CTA's Q and dO tiles once, then streams BN-key tiles of K and
// V (KV head h / (H / Hkv)) through a ring of ST stages, and beside each
// tile writes its key segment ids and their min / max to shared memory.
// setmaxnreg hands its registers to the two consumer warpgroups, which own
// 64 queries each and hold their rows' base-2 LSE and di in registers. Per
// key tile a consumer computes
//   S = Q K^T and dP = dO V^T      (wgmma, both operands K-major along D, two
//                                   commit groups: P is built while dP is
//                                   still in flight),
//   P = exp2(S scale log2(e) - lse2[row]) under the mask and
//   dS = P (dP - di[row])          (f32 registers),
//   dQ += dS K                     (wgmma with dS packed to bf16 as the
//                                   register A operand, K read MN-major
//                                   through its descriptor, as the forward
//                                   reads V: no transpose copy).
// A tile's dQ product is issued with the next tile's S and dP and finishes
// under that tile's exp / dS work; the two consumers take turns to issue
// (named barriers 1 and 2), so one's elementwise work runs under the other's
// GEMMs. dQ stays in f32 registers and takes the softmax scale once at the
// end. A row past Sq or fully masked (LSE -inf) carries lse2 = +inf, so its
// p is 0 before any product and its dQ exactly 0. Masks apply only to tiles
// that straddle the diagonal, the ragged Skv edge (missing keys carry
// segment INT_MIN) or a segment boundary, decided per warp from the tile's
// segment range. Causal work stops at each warpgroup's own diagonal (the
// first consumer's last tile past it is skipped) and query blocks launch
// heaviest first (the block index is reversed and is the grid's slowest
// dimension). Each CTA owns its dQ rows outright: no atomics, deterministic.

constexpr int DQW_BM = 128;  // queries per CTA: 64 per consumer warpgroup

// Shared-memory plan (byte offsets from a 1024-aligned base). Each operand
// tile is DP/64 blocks of rows x 128 bytes in the 128-byte swizzle.
template <int DP, int BN, int ST>
struct DqPlan {
  static constexpr int CH = DP / 64;
  static constexpr int Q_BYTES = CH * DQW_BM * 128;  // Q or dO
  static constexpr int KV_BYTES = CH * BN * 128;     // one K or V tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int SEG_OFF = V_OFF + ST * KV_BYTES;    // int [ST][BN]
  static constexpr int RANGE_OFF = SEG_OFF + ST * BN * 4;  // int2 [ST]: min, max
  static constexpr int BAR_OFF = RANGE_OFF + ST * 8;       // q, full[ST], empty[ST]
  static constexpr int ALLOC = BAR_OFF + (1 + 2 * ST) * 8 + 1024;  // + alignment slack
};

template <int DP, int BN, int ST>
__global__ void __launch_bounds__(WTHREADS, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do, const Params p) {
  using namespace hopper;
  using L = DqPlan<DP, BN, ST>;
  constexpr int CH = L::CH;
  // the first consumer skips at most the tiles of the CTA's last 64 rows,
  // which are the last tiles and are never refilled
  static_assert(ST >= 2 && ST * BN >= 64, "ring too short");
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sdO = smem + L::DO_OFF;
  unsigned char* sK = smem + L::K_OFF;
  unsigned char* sV = smem + L::V_OFF;
  int* sSeg = reinterpret_cast<int*>(smem + L::SEG_OFF);
  int2* sRange = reinterpret_cast<int2*>(smem + L::RANGE_OFF);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + ST;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int n_mblocks = (p.Sq + DQW_BM - 1) / DQW_BM;
  const int m0 = (p.causal ? n_mblocks - 1 - (int)blockIdx.z : (int)blockIdx.z) * DQW_BM;
  const int hk = h / (p.H / p.Hkv);
  // key tiles the CTA's rows can see, and those its first 64 rows can
  const int n_tiles = ((p.causal ? min(p.Skv, m0 + DQW_BM) : p.Skv) + BN - 1) / BN;
  const int n_first = ((p.causal ? min(p.Skv, m0 + 64) : p.Skv) + BN - 1) / BN;
  // warp-uniform as far as the compiler can see (a divergent-looking branch
  // around wgmma makes ptxas serialize it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full[s], 33);  // TMA bytes + the producer warp's 32 lanes (segment ids)
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x >= 32 || n_tiles == 0) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::Q_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(sQ + c * DQW_BM * 128, &tm_q, bar_q, c * 64, h, m0, b);
        tma_load_4d(sdO + c * DQW_BM * 128, &tm_do, bar_q, c * 64, h, m0, b);
      }
    }
    const int* segkv = p.seg_kv + (long long)b * p.Skv;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % ST;
      const int n0 = it * BN;
      mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
      if (lane == 0) {  // the tiles first, so the segment loads below overlap them
        mbar_arrive_expect_tx(&full[st], 2 * L::KV_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(sK + st * L::KV_BYTES + c * BN * 128, &tm_k, &full[st], c * 64, hk, n0, b);
          tma_load_4d(sV + st * L::KV_BYTES + c * BN * 128, &tm_v, &full[st], c * 64, hk, n0, b);
        }
      }
      int lo = INT_MAX, hi = INT_MIN;
      for (int j = lane; j < BN; j += 32) {
        const int s = n0 + j < p.Skv ? segkv[n0 + j] : INT_MIN;  // the ragged edge never matches
        sSeg[st * BN + j] = s;
        lo = min(lo, s);
        hi = max(hi, s);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
      }
      if (lane == 0) sRange[st] = make_int2(lo, hi);
      mbar_arrive(&full[st]);  // each lane releases its own segment-id stores
    }
    return;
  }

  // ---------------- consumers: 64 queries each ----------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // lane within the quad
  const int my_tiles = cw == 0 ? n_first : n_tiles;
  int qrow[2], segq[2];
  float lse2[2], dis[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = m0 + cw * 64 + warp * 16 + g + 8 * i;
    const bool ok = qrow[i] < p.Sq;
    const long long row = ((long long)b * p.H + h) * p.Sq + qrow[i];
    segq[i] = ok ? p.seg_q[(long long)b * p.Sq + qrow[i]] : Q_PAD_SEG;
    const float l = ok ? p.lse[row] : -INFINITY;
    lse2[i] = l == -INFINITY ? INFINITY : l * LOG2E;  // p = 2^(x - inf) = 0
    dis[i] = ok ? p.di[row] : 0.f;
  }
  const float scale_log2 = p.scale * LOG2E;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float s[BN / 2], dp[BN / 2];
  uint32_t da[BN / 16][4];  // dS of the tile whose dQ product is in flight
  const uint64_t a_q = desc_sw128(sQ + cw * 64 * 128, 16, 1024);
  const uint64_t a_do = desc_sw128(sdO + cw * 64 * 128, 16, 1024);
  if (my_tiles > 0) mbar_wait(bar_q, 0);

  auto issue_s_dp = [&](int st) {  // S = Q K^T, then dP = dO V^T: two commit groups
    const uint64_t bk = desc_sw128(sK + st * L::KV_BYTES, 16, 1024);
    const uint64_t bv = desc_sw128(sV + st * L::KV_BYTES, 16, 1024);
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int off = (ks / 4) * (DQW_BM * 128) + (ks % 4) * 32;
      const int koff = (ks / 4) * (BN * 128) + (ks % 4) * 32;
      wgmma_ss<BN>(s, a_q + (off >> 4), bk + (koff >> 4), ks > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int off = (ks / 4) * (DQW_BM * 128) + (ks % 4) * 32;
      const int koff = (ks / 4) * (BN * 128) + (ks % 4) * 32;
      wgmma_ss<BN>(dp, a_do + (off >> 4), bv + (koff >> 4), ks > 0);
    }
    wgmma_commit();
  };
  auto issue_dq = [&](int st) {  // dQ += dS K, K MN-major (keys are rows)
    const uint64_t bk = desc_sw128(sK + st * L::KV_BYTES, BN * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tb<DP>(acc, da[kk], bk + ((kk * 2048) >> 4), 1);
    wgmma_commit();
  };
  // S -> P in place: scale (base 2), minus the row's lse2, masked where the
  // tile needs it
  auto make_p = [&](int st, int n0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(s[i]);
    const int2 rg = sRange[st];
    const bool uniform = rg.x == rg.y && rg.x == segq[0] && rg.x == segq[1];
    const bool below = !p.causal || n0 + BN - 1 <= qrow[0];
    if (__all_sync(0xffffffffu, uniform && below)) {  // decided per warp
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = fast_exp2(s[i] * scale_log2 - lse2[(i / 2) % 2]);
    } else {
      const int* seg = sSeg + st * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = j * 8 + tq * 2;
        const int sk[2] = {seg[cl], seg[cl + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const bool ok = (!p.causal || n0 + cl + (e % 2) <= qrow[r]) && sk[e % 2] == segq[r];
          s[4 * j + e] = ok ? fast_exp2(s[4 * j + e] * scale_log2 - lse2[r]) : 0.f;
        }
      }
    }
  };
  auto make_ds = [&]() {  // dP -> dS in place
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      fence_operand(dp[i]);
      dp[i] = s[i] * (dp[i] - dis[(i / 2) % 2]);
    }
  };
  auto pack_ds = [&]() {  // dS in bf16 as wgmma's register A fragments (mma.sync's A layout)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      da[kk][0] = pack_bf16(dp[8 * kk + 0], dp[8 * kk + 1]);
      da[kk][1] = pack_bf16(dp[8 * kk + 2], dp[8 * kk + 3]);
      da[kk][2] = pack_bf16(dp[8 * kk + 4], dp[8 * kk + 5]);
      da[kk][3] = pack_bf16(dp[8 * kk + 6], dp[8 * kk + 7]);
    }
  };
  auto release = [&](int st) {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  // The consumers take turns to issue their GEMMs (named barriers 1 and 2).
  // The first walks n_first tiles, the second n_tiles >= n_first; the turns
  // pair up over the first n_first, the second gives the first its first
  // turn, and past n_first the second issues alone.
  auto wait_turn = [&](int it) {
    if (wg == 1 || it < n_first) bar_sync(wg, 256);
  };
  auto pass_turn = [&](int it) {
    if (wg == 1 || it + 1 < n_first) bar_arrive(3 - wg, 256);
  };
  if (wg == 2 && n_first > 0) bar_arrive(1, 256);

  // straight-line loop bodies, so ptxas can follow the commit groups
  if (my_tiles > 0) {  // tile 0: no dQ product in flight yet
    mbar_wait(&full[0], 0);
    wait_turn(0);
    wgmma_fence();
    issue_s_dp(0);
    pass_turn(0);
    wgmma_wait<1>();  // S is ready; dP is still in flight
    make_p(0, 0);
    wgmma_wait<0>();
    make_ds();
    pack_ds();
  }
  for (int it = 1; it < my_tiles; ++it) {
    const int st = it % ST;
    const int pst = (it - 1) % ST;  // the previous tile's stage
    mbar_wait(&full[st], (it / ST) & 1);
    wait_turn(it);
    wgmma_fence();
    issue_s_dp(st);
    issue_dq(pst);  // the previous tile's dQ runs under this tile's exp / dS work
    pass_turn(it);
    wgmma_wait<2>();  // S is ready
    make_p(st, it * BN);
    wgmma_wait<1>();  // dP is ready
    make_ds();
    wgmma_wait<0>();  // the previous dQ is done: its dS registers and stage are free
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(acc[i]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(da[kk][e]);
    release(pst);
    pack_ds();
  }
  if (my_tiles > 0) {  // the last tile's dQ
    const int st = (my_tiles - 1) % ST;
    wgmma_fence();
    issue_dq(st);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(acc[i]);
    release(st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.Sq) continue;
    bf16* out = p.dq + (((long long)b * p.Sq + qrow[r]) * p.H + h) * p.D;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int d = t * 8 + tq * 2;
      if (d < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) = __floats2bfloat162_rn(
            acc[4 * t + 2 * r] * p.scale, acc[4 * t + 2 * r + 1] * p.scale);
      }
    }
  }
}

// ─────────────────────────────── launch ───────────────────────────────

template <int DP>
int launch_dkv(const Params& p, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(2 * DKV_BN + 4 * DKV_BM) * LD * sizeof(bf16) +
                      2 * DKV_BM * (2 * sizeof(float) + sizeof(int));
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((p.Skv + DKV_BN - 1) / DKV_BN, p.Hkv, p.B);
  flash_bwd_dkv_kernel<DP><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int ST>
int launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int smem = DkvPlan<DP, ST>::ALLOC;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<DP, ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long do_ss = (long long)p.H * p.D;  // dO is contiguous
  CUtensorMap tq, tk, tv, tdo;
  int err = hopper::make_bshd_map(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh, WBM);
  if (!err) err = hopper::make_bshd_map(&tk, p.k, p.D, p.Hkv, p.Skv, p.B, p.k_sb, p.k_ss, p.k_sh, WBN);
  if (!err) err = hopper::make_bshd_map(&tv, p.v, p.D, p.Hkv, p.Skv, p.B, p.v_sb, p.v_ss, p.v_sh, WBN);
  if (!err) err = hopper::make_bshd_map(&tdo, p.dout, p.D, p.H, p.Sq, p.B, p.Sq * do_ss, do_ss, p.D, WBM);
  if (err) return err;
  dim3 grid(p.Hkv, p.B, (p.Skv + WBN - 1) / WBN);
  flash_bwd_dkv_wgmma_kernel<DP, ST><<<grid, WTHREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq(const Params& p, cudaStream_t stream) {
  constexpr int LD = DP + 8;
  const size_t smem = (size_t)(2 * DQ_BM + 4 * DQ_BN) * LD * sizeof(bf16) +
                      2 * DQ_BN * sizeof(int);
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((p.Sq + DQ_BM - 1) / DQ_BM, p.H, p.B);
  flash_bwd_dq_kernel<DP><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DP, int BN, int ST>
int launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  constexpr int smem = DqPlan<DP, BN, ST>::ALLOC;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<DP, BN, ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const long long do_ss = (long long)p.H * p.D;  // dO is contiguous
  CUtensorMap tq, tk, tv, tdo;
  int err = hopper::make_bshd_map(&tq, p.q, p.D, p.H, p.Sq, p.B, p.q_sb, p.q_ss, p.q_sh, DQW_BM);
  if (!err) err = hopper::make_bshd_map(&tk, p.k, p.D, p.Hkv, p.Skv, p.B, p.k_sb, p.k_ss, p.k_sh, BN);
  if (!err) err = hopper::make_bshd_map(&tv, p.v, p.D, p.Hkv, p.Skv, p.B, p.v_sb, p.v_ss, p.v_sh, BN);
  if (!err) {
    err = hopper::make_bshd_map(&tdo, p.dout, p.D, p.H, p.Sq, p.B, p.Sq * do_ss, do_ss, p.D,
                                DQW_BM);
  }
  if (err) return err;
  dim3 grid(p.H, p.B, (p.Sq + DQW_BM - 1) / DQW_BM);
  flash_bwd_dq_wgmma_kernel<DP, BN, ST><<<grid, WTHREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return (int)cudaGetLastError();
}

bool fill(Params& p, const void* q, const void* k, const void* v, const void* dout,
          const float* lse, const float* di, const int* seg_q, const int* seg_kv, void* dq,
          void* dk, void* dv, int B, int H, int Hkv, int Sq, int Skv, int D, long long q_sb,
          long long q_ss, long long q_sh, long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh, float scale, int causal) {
  if (D <= 0 || D % 8 != 0 || D > MAX_D || Hkv <= 0 || H % Hkv != 0) return false;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.di = di;
  p.seg_q = seg_q;
  p.seg_kv = seg_kv;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  return true;
}

}  // namespace

#define FLASH_BWD_ARGS                                                                       \
  const void *q, const void *k, const void *v, const void *dout, const float *lse,          \
      const float *di, const int *seg_q, const int *seg_kv, void *dq, void *dk, void *dv,   \
      int B, int H, int Hkv, int Sq, int Skv, int D, long long q_sb, long long q_ss,        \
      long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,       \
      long long v_ss, long long v_sh, float scale, int causal, void *stream
#define FLASH_BWD_FILL                                                                       \
  fill(p, q, k, v, dout, lse, di, seg_q, seg_kv, dq, dk, dv, B, H, Hkv, Sq, Skv, D, q_sb,   \
       q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, scale, causal)

// dK, dV (B, Skv, Hkv, D) from q, k, v, dO, LSE, di; head dims pad up to the
// next supported tile width with zero columns.
extern "C" int flash_bwd_dkv_bf16(FLASH_BWD_ARGS) {
  Params p;
  if (!FLASH_BWD_FILL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // by shape: D <= 128 is the wgmma kernel (a smaller D reads TMA's zero
  // fill); D = 256 would need 256 accumulator registers a thread for dK and
  // dV, so it keeps the mma.sync kernel
  if (D <= 64) return launch_dkv_wgmma<64, 4>(p, st);
  if (D <= 128) return launch_dkv_wgmma<128, 3>(p, st);
  return launch_dkv<256>(p, st);
}

// dQ (B, Sq, H, D) from the same inputs.
extern "C" int flash_bwd_dq_bf16(FLASH_BWD_ARGS) {
  Params p;
  if (!FLASH_BWD_FILL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // by shape: D <= 128 is the wgmma kernel (a smaller D reads TMA's zero
  // fill); at D = 256 the dQ accumulator alone would take 128 registers a
  // thread beside S and dP, so it keeps the mma.sync kernel. D = 128's 4
  // stages were timed against 5; D = 64's 4 against 6 at an unfrozen
  // tower's shape (B=2, S=577, H=16, non-causal), where 4 were faster
  if (D <= 64) return launch_dq_wgmma<64, 64, 4>(p, st);
  if (D <= 128) return launch_dq_wgmma<128, 64, 4>(p, st);
  return launch_dq<256>(p, st);
}
