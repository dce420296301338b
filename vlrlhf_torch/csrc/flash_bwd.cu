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
// compute-bound at S ~ 1000, D = 128. FlashAttention-2 structure on
// mma.sync m16n8k16, 4 warps a CTA, every warp owning 16 rows end to end:
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
// Operand fragments are re-read from shared memory with ldmatrix (padded
// rows, conflict-free) instead of held in registers, which keeps the f32
// accumulators in registers at D = 128. wgmma and TMA are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 128;  // 4 warps x 16 rows
constexpr int MAX_D = 256;
constexpr int Q_PAD_SEG = -3;
constexpr int DKV_BN = 64;  // dK/dV kernel: keys per CTA
constexpr int DKV_BM = 32;  // dK/dV kernel: queries per streamed tile
constexpr int DQ_BM = 64;   // dQ kernel: queries per CTA
constexpr int DQ_BN = 64;   // dQ kernel: keys per streamed tile

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

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ inline void cp_async16(void* dst, const void* src, bool valid) {
  // src-size 0 zero-fills the 16 destination bytes without reading src
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ inline void ldmatrix_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// D (16x8 f32) += A (16x16 bf16, row) * B (16x8 bf16, col)
__device__ inline void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

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

// ─────────────────────────────── dK / dV ───────────────────────────────

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

// ──────────────────────────────── dQ ────────────────────────────────

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
  if (D <= 16) return launch_dkv<16>(p, st);
  if (D <= 32) return launch_dkv<32>(p, st);
  if (D <= 64) return launch_dkv<64>(p, st);
  if (D <= 128) return launch_dkv<128>(p, st);
  return launch_dkv<256>(p, st);
}

// dQ (B, Sq, H, D) from the same inputs.
extern "C" int flash_bwd_dq_bf16(FLASH_BWD_ARGS) {
  Params p;
  if (!FLASH_BWD_FILL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch_dq<16>(p, st);
  if (D <= 32) return launch_dq<32>(p, st);
  if (D <= 64) return launch_dq<64>(p, st);
  if (D <= 128) return launch_dq<128>(p, st);
  return launch_dq<256>(p, st);
}
