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
// What bounds it on the H100: at the serving path's shapes (S ~ 600, D 64 or
// 128) attention is compute-bound — ~S*D flops per loaded byte of K/V — so
// the tensor cores must stay fed. FlashAttention-2 structure on mma.sync:
// one CTA per (64 query rows, head, batch row), 4 warps each owning 16
// query rows end to end. Q fragments, the S = QK^T accumulators, the
// probabilities (reused in registers as the A operand of PV) and the O
// accumulator all stay in registers; softmax statistics reduce across the
// 4 lanes of a quad, so no block barrier sits between QK^T, softmax and
// PV. K/V tiles (64 keys) stream through shared memory with cp.async, two
// stages deep so the next tile loads while this one computes; rows are
// padded by 16 bytes so ldmatrix reads are bank-conflict free. wgmma with
// TMA loads and warp specialisation are the next PRs' work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;         // query rows per CTA
constexpr int BN = 64;         // keys per tile
constexpr int NTHREADS = 128;  // 4 warps x 16 query rows
constexpr int MAX_D = 256;
constexpr int Q_PAD_SEG = -3;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* seg_q;   // (B, Sq)
  const int* seg_kv;  // (B, Skv)
  __nv_bfloat16* o;   // (B, Sq, H, D) contiguous
  float* lse;         // (B, H, Sq)
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

// Copy rows [r0, r0+64) x [0, DP) of one head into a padded shared tile
// (row stride DP + 8) as 16-byte cp.async chunks; rows past `rows` and
// columns past D are zero-filled.
template <int DP>
__device__ inline void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                       long long row_stride, int r0, int rows, int D) {
  constexpr int CPR = DP / 8;  // chunks per row
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR;
    const int d = (c % CPR) * 8;
    const bool ok = (r0 + r < rows) && (d < D);
    const __nv_bfloat16* src = ok ? base + (long long)(r0 + r) * row_stride + d : base;
    cp_async16(dst + r * (DP + 8) + d, src, ok);
  }
}

template <int DP>
__global__ void __launch_bounds__(NTHREADS) flash_fwd_kernel(Params p) {
  constexpr int LD = DP + 8;     // padded row stride (elements)
  constexpr int KSTEPS = DP / 16;  // mma k-steps over the head dim
  constexpr int DTILES = DP / 8;   // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BM * LD;        // 2 stages
  __nv_bfloat16* sV = sK + 2 * BN * LD;    // 2 stages
  int* sSeg = reinterpret_cast<int*>(sV + 2 * BN * LD);  // 2 stages x BN

  const int m0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (p.H / p.Hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;   // row within the warp's 8-row half
  const int tq = lane % 4;  // lane within the quad

  const __nv_bfloat16* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kbase = p.k + b * p.k_sb + hk * p.k_sh;
  const __nv_bfloat16* vbase = p.v + b * p.v_sb + hk * p.v_sh;
  const int* segkv = p.seg_kv + (long long)b * p.Skv;

  // this thread's two query rows: warp*16 + g and warp*16 + g + 8
  int qrow[2], segq[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qrow[i] = m0 + warp * 16 + g + 8 * i;
    segq[i] = qrow[i] < p.Sq ? p.seg_q[(long long)b * p.Sq + qrow[i]] : Q_PAD_SEG;
  }

  const int n_end = p.causal ? min(p.Skv, m0 + BM) : p.Skv;
  const int n_tiles = (n_end + BN - 1) / BN;

  auto load_kv = [&](int tile, int stage) {
    const int n0 = tile * BN;
    load_tile_async<DP>(sK + stage * BN * LD, kbase, p.k_ss, n0, p.Skv, p.D);
    load_tile_async<DP>(sV + stage * BN * LD, vbase, p.v_ss, n0, p.Skv, p.D);
    for (int j = threadIdx.x; j < BN; j += NTHREADS) {
      sSeg[stage * BN + j] = (n0 + j < p.Skv) ? segkv[n0 + j] : INT32_MIN;
    }
  };

  load_tile_async<DP>(sQ, qbase, p.q_ss, m0, p.Sq, p.D);
  if (n_tiles > 0) load_kv(0, 0);
  cp_async_commit();

  uint32_t qf[KSTEPS][4];
  float o[DTILES][4];
#pragma unroll
  for (int t = 0; t < DTILES; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // per-thread partial row sums (quad-reduced at the end)

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
    if (it == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        ldmatrix_x4(qf[ks], sQ + (warp * 16 + (lane % 16)) * LD + ks * 16 + (lane / 16) * 8);
      }
    }
    const __nv_bfloat16* cK = sK + stage * BN * LD;
    const __nv_bfloat16* cV = sV + stage * BN * LD;
    const int* cSeg = sSeg + stage * BN;
    const int n0 = it * BN;

    // S = Q K^T: 8 key tiles of 8
    float s[BN / 8][4];
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        uint32_t kb[2];
        ldmatrix_x2(kb, cK + (j * 8 + (lane % 8)) * LD + ks * 16 + ((lane / 8) % 2) * 8);
        mma16816(s[j], qf[ks], kb[0], kb[1]);
      }
    }

    // mask, online softmax (rows g and g+8 of this warp; quad-wide max)
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const int cl = j * 8 + tq * 2 + (e % 2);
        const int col = n0 + cl;
        const bool ok = col < p.Skv && (!p.causal || col <= qrow[r]) && cSeg[cl] == segq[r];
        const float v = ok ? s[j][e] * p.scale : -INFINITY;
        s[j][e] = v;
        mx[r] = fmaxf(mx[r], v);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = (m_i[r] == -INFINITY) ? 0.f : __expf(m_i[r] - mx[r]);
      m_i[r] = mx[r];
      l_i[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e / 2;
        const float pv = (s[j][e] == -INFINITY) ? 0.f : __expf(s[j][e] - m_i[r]);
        s[j][e] = pv;
        l_i[r] += pv;
      }
    }
#pragma unroll
    for (int t = 0; t < DTILES; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // O += P V: P's accumulators become the A operand in registers
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int t = 0; t < DTILES; t += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, cV + (kk * 16 + (lane % 16)) * LD + t * 8 + (lane / 16) * 8);
        mma16816(o[t], pa, vb[0], vb[1]);
        mma16816(o[t + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  cp_async_wait<0>();  // nothing may stay in flight at exit (Skv == 0)

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
    for (int t = 0; t < DTILES; ++t) {
      const int d = t * 8 + tq * 2;
      if (d < p.D) {
        *reinterpret_cast<__nv_bfloat162*>(out + d) =
            __floats2bfloat162_rn(o[t][2 * r] * inv, o[t][2 * r + 1] * inv);
      }
    }
    if (tq == 0) {
      p.lse[((long long)b * p.H + h) * p.Sq + qrow[r]] =
          l_i[r] > 0.f ? m_i[r] + logf(l_i[r]) : -INFINITY;
    }
  }
}

template <int DP>
int launch(const Params& p, cudaStream_t stream) {
  const size_t smem = (size_t)(BM + 4 * BN) * (DP + 8) * sizeof(__nv_bfloat16) +
                      2 * BN * sizeof(int);
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((p.Sq + BM - 1) / BM, p.H, p.B);
  flash_fwd_kernel<DP><<<grid, NTHREADS, smem, stream>>>(p);
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
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.seg_q = seg_q;
  p.seg_kv = seg_kv;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = lse;
  p.B = B; p.H = H; p.Hkv = Hkv; p.Sq = Sq; p.Skv = Skv; p.D = D;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // head dims pad up to the next supported tile width with zero columns
  if (D <= 16) return launch<16>(p, st);
  if (D <= 32) return launch<32>(p, st);
  if (D <= 64) return launch<64>(p, st);
  if (D <= 128) return launch<128>(p, st);
  return launch<256>(p, st);
}
