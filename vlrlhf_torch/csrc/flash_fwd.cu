// Flash attention forward for Hopper (sm_90a), bf16 in, bf16 out + f32 LSE.
//
// Replaces the Pallas kernel `_fwd_kernel` / `_fwd_call` in
// vlrlhf_tpu/ops/flash_attention.py. Same semantics: online softmax in f32,
// causal tiles above the diagonal skipped, masking by segment ids where a
// padded query row carries segment -3 and a padded key -1 so they never
// match (the wrapper builds the ids), causality by absolute index (key
// position <= query position). Differences by design: GQA indexes kv head
// h / (H / Hkv) instead of repeating K and V; inputs stay in the public
// (B, S, H, D) layout and arrive as strides, so no transpose copy; the
// kernel masks its ragged S edge itself, so S=577 is not padded to 640; a
// fully masked row gives output 0 and LSE -inf.
//
// What bounds it on the H100: at the path's shapes (S 577-1024, D 64 or 128)
// attention is bound by the tensor cores (~S*D flops per byte of K/V), so
// the design keeps them fed (FlashAttention-3's structure, simplified):
// - one CTA per (128 query rows, head, batch row), three warpgroups. Warp 0
//   of the first is the producer: TMA loads Q once and K/V tiles of BN keys
//   into a ring of ST stages (full / empty mbarriers; the K and V halves of
//   a stage have their own full barriers), and writes each tile's key
//   segment ids and their min / max to shared memory. setmaxnreg moves its
//   registers to the two consumer warpgroups of 64 query rows each;
// - a consumer computes S = Q K^T with wgmma from 128-byte-swizzled shared
//   memory (both K-major), runs the online softmax in f32 registers, packs
//   P to bf16 in registers as the A operand of O += P V (V read MN-major
//   through its descriptor: no transpose copy). The P V product of tile i
//   is in flight while the S of tile i+1 is computed and softmaxed, and the
//   two consumers take turns to issue their GEMMs, so one's softmax runs
//   under the other's tensor-core work;
// - masks apply only where a tile needs them: the causal diagonal, the
//   ragged S edge (its missing keys carry segment INT_MIN) and tiles whose
//   key segments are not one value equal to the row's. Interior tiles skip
//   the per-element mask;
// - causal row blocks launch heaviest first (the query-block index is
//   reversed and is the grid's slowest dimension).
// Head dims are instantiated at 64, 128 and 256; a smaller D reads zeros
// from TMA past D (the box is 64 columns wide) and writes its D columns.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int BM = 128;           // query rows per CTA
constexpr int NTHREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int MAX_D = 256;
constexpr int Q_PAD_SEG = -3;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const int* seg_q;   // (B, Sq)
  const int* seg_kv;  // (B, Skv)
  __nv_bfloat16* o;   // (B, Sq, H, D) contiguous
  float* lse;         // (B, H, Sq)
  int B, H, Hkv, Sq, Skv, D, n_mblocks;
  float scale_log2;   // softmax scale * log2(e): the softmax runs in base 2
  int causal;
};

// Shared-memory plan (byte offsets from a 1024-aligned base). Each operand
// tile is DP/64 blocks of rows x 128 bytes in the 128-byte swizzle.
template <int DP, int BN, int ST>
struct Plan {
  static constexpr int CH = DP / 64;
  static constexpr int Q_BYTES = CH * BM * 128;
  static constexpr int KV_BYTES = CH * BN * 128;  // one K or V tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int SEG_OFF = V_OFF + ST * KV_BYTES;     // int [ST][BN]
  static constexpr int RANGE_OFF = SEG_OFF + ST * BN * 4;   // int2 [ST]: min, max
  static constexpr int BAR_OFF = RANGE_OFF + ST * 8;        // q, full_k[ST], full_v[ST], empty[ST]
  static constexpr int ALLOC = BAR_OFF + (1 + 3 * ST) * 8 + 1024;  // + alignment slack
};

template <int DP, int BN, int ST>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Plan<DP, BN, ST>;
  constexpr int CH = L::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sQ = smem;
  unsigned char* sK = smem + L::K_OFF;
  unsigned char* sV = smem + L::V_OFF;
  int* sSeg = reinterpret_cast<int*>(smem + L::SEG_OFF);
  int2* sRange = reinterpret_cast<int2*>(smem + L::RANGE_OFF);
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full_k = bar_q + 1;
  uint64_t* full_v = full_k + ST;
  uint64_t* empty = full_v + ST;

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int m0 = (p.causal ? p.n_mblocks - 1 - (int)blockIdx.z : (int)blockIdx.z) * BM;
  const int hk = h / (p.H / p.Hkv);
  const int n_end = p.causal ? min(p.Skv, m0 + BM) : p.Skv;
  const int n_tiles = (n_end + BN - 1) / BN;
  // warp-uniform as far as the compiler can see (a divergent-looking branch
  // around wgmma makes ptxas serialize it)
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(&full_k[s], 33);  // TMA bytes + the producer warp's 32 lanes (segment ids)
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], 8);    // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<40>();
    if (threadIdx.x >= 32) return;
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, L::Q_BYTES);
      for (int c = 0; c < CH; ++c) tma_load_4d(sQ + c * BM * 128, &tm_q, bar_q, c * 64, h, m0, b);
    }
    const int* segkv = p.seg_kv + (long long)b * p.Skv;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % ST;
      mbar_wait(&empty[st], ((it / ST) & 1) ^ 1);
      const int n0 = it * BN;
      if (lane == 0) {  // the tiles first, so the segment loads below overlap them
        mbar_arrive_expect_tx(&full_k[st], L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load_4d(sK + st * L::KV_BYTES + c * BN * 128, &tm_k, &full_k[st], c * 64, hk, n0, b);
        mbar_arrive_expect_tx(&full_v[st], L::KV_BYTES);
        for (int c = 0; c < CH; ++c)
          tma_load_4d(sV + st * L::KV_BYTES + c * BN * 128, &tm_v, &full_v[st], c * 64, hk, n0, b);
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
      mbar_arrive(&full_k[st]);  // each lane releases its own segment-id stores
    }
    return;
  }

  // ---------------- consumers ----------------
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x % 128) / 32;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // lane within the quad
  const int r0 = m0 + (wg - 1) * 64;  // this warpgroup's first query row
  int qrow[2], segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = r0 + warp * 16 + g + 8 * i;
    segq[i] = qrow[i] < p.Sq ? p.seg_q[(long long)b * p.Sq + qrow[i]] : Q_PAD_SEG;
  }

  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float s[BN / 2];
  uint32_t pa[BN / 16][4];  // P of the tile whose P V product is in flight
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)
  const uint64_t dq = desc_sw128(sQ + (wg - 1) * 64 * 128, 16, 1024);
  mbar_wait(bar_q, 0);

  auto issue_pv = [&](int st) {
    const uint64_t dv = desc_sw128(sV + st * L::KV_BYTES, BN * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) wgmma_rs_tb<DP>(o, pa[kk], dv + ((kk * 2048) >> 4), 1);
    wgmma_commit();
  };
  auto release = [&](int st) {  // this warp is done with stage st
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  };
  // The two consumer warpgroups take turns to issue their GEMMs (named
  // barriers 1 and 2), so one's softmax runs under the other's GEMMs. Both
  // walk all n_tiles tiles (the first one's tiles past its diagonal are
  // masked), so the turns pair up; the second warpgroup gives the first its
  // first turn and skips passing its last.
  auto wait_turn = [&]() { bar_sync(wg, 256); };
  auto pass_turn = [&](int it) {
    if (wg == 1 || it + 1 < n_tiles) {
      bar_arrive(3 - wg, 256);
    }
  };
  if (wg == 2 && n_tiles > 0) bar_arrive(1, 256);

  auto issue_s = [&](int st) {  // S = Q K^T over the head dim, one commit group
    const uint64_t dk = desc_sw128(sK + st * L::KV_BYTES, 16, 1024);
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      const int off = (ks / 4) * (BM * 128) + (ks % 4) * 32;
      const int koff = (ks / 4) * (BN * 128) + (ks % 4) * 32;
      wgmma_ss<BN>(s, dq + (off >> 4), dk + (koff >> 4), ks > 0);
    }
    wgmma_commit();
  };
  // scale (base 2), mask where the tile needs it, online softmax: s becomes
  // P (f32), m_i / l_i move on, alpha rescales O
  auto softmax = [&](int st, int n0, float (&alpha)[2]) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) fence_operand(s[i]);
    const int2 rg = sRange[st];
    const bool uniform = rg.x == rg.y && rg.x == segq[0] && rg.x == segq[1];
    const bool below = !p.causal || n0 + BN - 1 <= qrow[0];
    float mx[2] = {m_i[0], m_i[1]};
    if (__all_sync(0xffffffffu, uniform && below)) {  // decided per warp
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        s[i] *= p.scale_log2;
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
      }
    } else {
      const int* seg = sSeg + st * BN;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int cl = j * 8 + tq * 2;
        const int sk[2] = {seg[cl], seg[cl + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e / 2;
          const int col = n0 + cl + (e % 2);
          const bool ok = (!p.causal || col <= qrow[r]) && sk[e % 2] == segq[r];
          const float v = ok ? s[4 * j + e] * p.scale_log2 : -INFINITY;
          s[4 * j + e] = v;
          mx[r] = fmaxf(mx[r], v);
        }
      }
    }
    float mref[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = m_i[r] == -INFINITY ? 0.f : fast_exp2(m_i[r] - mx[r]);
      m_i[r] = mx[r];
      mref[r] = mx[r] == -INFINITY ? 0.f : mx[r];  // a fully masked row so far: every p is 0
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int r = (i / 2) % 2;
      s[i] = fast_exp2(s[i] - mref[r]);
      l_i[r] += s[i];
    }
  };
  auto pack_p = [&]() {  // P in bf16 as wgmma's register A fragments (mma.sync's A layout)
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
      pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // straight-line loop bodies, so ptxas can follow the two commit groups
  float alpha[2];
  if (n_tiles > 0) {  // tile 0: O is still zero
    mbar_wait(&full_k[0], 0);
    wait_turn();
    wgmma_fence();
    issue_s(0);
    pass_turn(0);
    wgmma_wait<0>();
    softmax(0, 0, alpha);
    pack_p();
  }
  for (int it = 1; it < n_tiles; ++it) {
    const int st = it % ST;
    const int pst = (it - 1) % ST;  // the previous tile's stage
    mbar_wait(&full_k[st], (it / ST) & 1);
    mbar_wait(&full_v[pst], ((it - 1) / ST) & 1);
    wait_turn();
    wgmma_fence();
    issue_s(st);
    issue_pv(pst);    // the previous tile's P V runs while this S is softmaxed
    pass_turn(it);
    wgmma_wait<1>();  // S is ready
    softmax(st, it * BN, alpha);
    wgmma_wait<0>();  // the previous P V is done: O and its P registers are free
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(o[i]);
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) fence_operand(pa[kk][e]);
    release(pst);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i / 2) % 2];
    pack_p();
  }
  if (n_tiles > 0) {  // the last tile's P V
    const int st = (n_tiles - 1) % ST;
    mbar_wait(&full_v[st], ((n_tiles - 1) / ST) & 1);
    wgmma_fence();
    issue_pv(st);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) fence_operand(o[i]);
    release(st);
  }
  // finalize: quad-reduce the row sums, normalize, write O and the LSE
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
    l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qrow[r] >= p.Sq) continue;
    const float inv = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
    __nv_bfloat16* out = p.o + (((long long)b * p.Sq + qrow[r]) * p.H + h) * p.D;
#pragma unroll
    for (int t = 0; t < DP / 8; ++t) {
      const int d = t * 8 + tq * 2;
      if (d < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(o[4 * t + 2 * r] * inv, o[4 * t + 2 * r + 1] * inv);
      }
    }
    if (tq == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + qrow[r]] =
          l_i[r] > 0.f ? (m_i[r] + log2f(l_i[r])) / LOG2E : -INFINITY;
    }
  }
}

template <int DP, int BN, int ST>
int launch(const void* q, const void* k, const void* v, Params p, const long long* st,
           cudaStream_t stream) {
  constexpr int smem = Plan<DP, BN, ST>::ALLOC;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DP, BN, ST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  CUtensorMap tq, tk, tv;
  int err = make_bshd_map(&tq, q, p.D, p.H, p.Sq, p.B, st[0], st[1], st[2], BM);
  if (!err) err = make_bshd_map(&tk, k, p.D, p.Hkv, p.Skv, p.B, st[3], st[4], st[5], BN);
  if (!err) err = make_bshd_map(&tv, v, p.D, p.Hkv, p.Skv, p.B, st[6], st[7], st[8], BN);
  if (err) return err;
  p.n_mblocks = (p.Sq + BM - 1) / BM;
  dim3 grid(p.H, p.B, p.n_mblocks);
  flash_fwd_kernel<DP, BN, ST><<<grid, NTHREADS, smem, stream>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_fwd_bf16(
    const void* q, const void* k, const void* v, const int* seg_q,
    const int* seg_kv, void* o, float* lse, int B, int H, int Hkv, int Sq,
    int Skv, int D, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, float scale, int causal, void* stream) {
  if (D <= 0 || D % 8 != 0 || D > MAX_D || Hkv <= 0 || H % Hkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)B * H * Sq == 0) return 0;
  Params p;
  p.seg_q = seg_q;
  p.seg_kv = seg_kv;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.scale_log2 = scale * LOG2E;
  p.causal = causal;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // head dims pad up to the next instantiated width with zero columns
  if (D <= 64) return launch<64, 128, 4>(q, k, v, p, st, s);
  if (D <= 128) return launch<128, 128, 2>(q, k, v, p, st, s);
  return launch<256, 64, 2>(q, k, v, p, st, s);
}
