// The split-KV machinery shared by the attention kernels that stream the
// stacked head-major KV cache (decode_attention.cu, chunk_attention.cu).
//
// Tiles. In the (L, B, nkv, S, hd) cache, the TS = 32 consecutive slots of
// one (layer, row, kv head) are one contiguous span (TS * hd elements), and
// so are their TS bf16 scales in an int8 cache's (L, B, nkv, S) scales. One
// producer warp per CTA copies each K tile, V tile and scale span into a
// ring of shared-memory stages with `cp.async.bulk` (1-D, no tensor map),
// completing on the stage's "full" mbarrier; the consumers release a stage
// on its "empty" mbarrier. A tile is issued only if it holds a slot the CTA
// attends, and its copy stops at the first multiple of 8 slots at or past
// the last attended slot (never past the tile, never past S).
//
// A bulk copy needs 16-byte aligned addresses and a multiple of 16 bytes.
// Multiples of 8 slots give that for every hd (a multiple of 8) and both
// element types when the slots are contiguous (slot stride hd), S % 8 == 0
// and every base and stride is 16-byte aligned. The host checks exactly
// that (bulk_eligible); any other cache (a strided slice, odd S) takes the
// same kernel with the producer warp copying the tile by plain 8-byte
// loads instead, and the stage's full barrier counting its 32 lanes. The
// choice is by shape, made once per launch, never a fallback on failure.
//
// Splits (flash-decoding). S is split across `splits` CTAs of one
// thread-block cluster along z: split j takes tiles j, j + splits, ...
// (interleaved, so a row shorter than S still spreads evenly). `splits`
// comes from B, nkv, S and the SM count on the host, never from `lengths`,
// which live on the card: a launch does not synchronize. A split whose
// tiles lie wholly past a row's live end reads nothing and reports
// m = -inf. The splits' (m, l, acc) states merge through distributed
// shared memory inside the cluster (as int4_matmul.cu's contraction split
// does): one launch, no scratch tensor, no second pass. The decode self
// term joins there, once.
//
// The CUDA-core consumer (split_body, for decode and short chunks). Each of
// ncw consumer warps (8 where 8 stages fit the ring budget, else 4) takes
// whole tiles: tile k of the CTA goes to warp k % ncw, which owns ring
// stage k % ncw. Lane s owns slot s of the tile and computes the R rows'
// full dot products from shared memory. The bulk copy
// lands rows unswizzled (pitch hd), so lane s walks its row's 8-element
// chunks starting at chunk s (mod hd / 8): the 8 lanes of a shared-memory
// phase hit 8 different bank groups. q sits in shared memory in f32,
// pre-scaled, as two planes (elements 0-3 and 4-7 of every chunk) so the
// rotated reads are conflict-free too. Per tile and row: one warp max (five
// shuffles), each lane's exp and its own share of the denominator (summed
// once, after the last tile), the weights (times the v scale) into a
// per-warp buffer, then P V with lanes over hd (lane owns EPL contiguous
// elements) and the slots in order. No per-slot shuffle, no block barrier
// in the loop. int8 codes convert to f32 exactly by the 2^23 trick (one
// byte permute and one add per element, no int-to-float instruction).

#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

namespace kvrows {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

constexpr int TS = 32;          // slots per tile
constexpr int NCW = 4;          // consumer warps (split_body: 4 or 8, p.ncw)
constexpr int MAX_NCW = 8;
constexpr int NTHREADS = (NCW + 1) * 32;  // + one producer warp (the last)
constexpr int MAX_THREADS = (MAX_NCW + 1) * 32;
constexpr int MAX_STAGES = 8;
constexpr int MAX_HD = 256;
constexpr int MAX_SPLITS = 8;   // portable cluster size
constexpr int RING_BYTES = 68 * 1024;  // split_body: 8 stages if they fit in this, else 4

template <typename T>
struct Split {
  const bf16* q;                // (B, C, nh, hd) strides q_sb, q_sc, q_sh (decode: C = 1)
  const T* k;                   // stacked cache, layer offset applied
  const T* v;
  const bf16* ks;               // int8 only: (.., B, nkv, S) scales, layer offset applied
  const bf16* vs;
  const bf16* k_cur;            // decode's self term (B, nkv, hd); null for chunks
  const bf16* v_cur;
  const int* lengths;           // (B,)
  bf16* o;                      // (B, C, nh, hd) contiguous
  int C, g, nh, nkv, hd, S;
  int splits, stages, bulk;
  int ncw;                      // split_body's consumer warps
  int union_bytes;              // ring / merge area, bytes (host-computed)
  long long q_sb, q_sc, q_sh;
  long long c_sb, c_sh, c_ss;   // cache strides (batch, head, slot)
  long long s_sb, s_sh;         // scale strides (batch, head); slot stride 1
  long long cur_sb, cur_sh;
  float scale;
};

__host__ __device__ inline int align128(int x) { return (x + 127) & ~127; }

// bytes of one ring stage: K tile, V tile, and for int8 the two scale spans
template <typename T>
__host__ __device__ inline int stage_bytes(int hd) {
  return 2 * align128(TS * hd * (int)sizeof(T)) + (std::is_same_v<T, int8_t> ? 2 * 128 : 0);
}

__device__ inline float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// four int8 codes (byte e of w) -> exact f32: 2^23 + (code + 128) as bits,
// minus 2^23 + 128
__device__ inline void i8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + e)) - 8388736.f;
  }
}
__device__ inline void bf16x2_to_f32(uint32_t w, float* f) {
  f[0] = __uint_as_float(w << 16);
  f[1] = __uint_as_float(w & 0xffff0000u);
}

// N consecutive elements at p (aligned to N elements) -> f32
template <int N>
__device__ inline void load_f32(const bf16* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = __bfloat162float(*p);
  } else if constexpr (N == 2) {
    bf16x2_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
  } else if constexpr (N == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    bf16x2_to_f32(w.x, f);
    bf16x2_to_f32(w.y, f + 2);
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    bf16x2_to_f32(w.x, f);
    bf16x2_to_f32(w.y, f + 2);
    bf16x2_to_f32(w.z, f + 4);
    bf16x2_to_f32(w.w, f + 6);
  }
}
template <int N>
__device__ inline void load_f32(const int8_t* p, float (&f)[N]) {
  if constexpr (N == 1) {
    f[0] = static_cast<float>(*p);
  } else if constexpr (N == 2) {
    const char2 c = *reinterpret_cast<const char2*>(p);
    f[0] = static_cast<float>(c.x);
    f[1] = static_cast<float>(c.y);
  } else if constexpr (N == 4) {
    i8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
  } else {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    i8x4_to_f32(w.x, f);
    i8x4_to_f32(w.y, f + 4);
  }
}

// ---------------------------------------------------------------------------
// The producer warp: copies tiles split, split + splits, ... below `end`
// into the ring. All 32 lanes call it.

template <typename T>
__device__ inline void produce(const Split<T>& p, int b, int hk, int split, int end,
                               unsigned char* ring, uint64_t* full, uint64_t* empty, int lane) {
  constexpr bool QUANT = std::is_same_v<T, int8_t>;
  const int hd = p.hd;
  const int kv_bytes = align128(TS * hd * (int)sizeof(T));
  const int sb = stage_bytes<T>(hd);
  const T* kb = p.k + b * p.c_sb + hk * p.c_sh;
  const T* vb = p.v + b * p.c_sb + hk * p.c_sh;
  const bf16* ksb = QUANT ? p.ks + b * p.s_sb + hk * p.s_sh : nullptr;
  const bf16* vsb = QUANT ? p.vs + b * p.s_sb + hk * p.s_sh : nullptr;
  const int nt = (end + TS - 1) / TS;
  int k = 0;
  for (int t = split; t < nt; t += p.splits, ++k) {
    const int st = k % p.stages;
    hopper::mbar_wait(&empty[st], ((k / p.stages) & 1) ^ 1);
    unsigned char* dst = ring + st * sb;
    T* dk = reinterpret_cast<T*>(dst);
    T* dv = reinterpret_cast<T*>(dst + kv_bytes);
    bf16* dks = reinterpret_cast<bf16*>(dst + 2 * kv_bytes);
    bf16* dvs = dks + 64;
    const int s0 = t * TS;
    if (p.bulk) {
      if (lane == 0) {
        const int ns = min((end - s0 + 7) & ~7, TS);  // whole 8-slot groups: 16-byte sizes
        const uint32_t bytes = (uint32_t)(ns * hd * (int)sizeof(T));
        hopper::mbar_arrive_expect_tx(&full[st], 2 * bytes + (QUANT ? 4u * ns : 0u));
        hopper::bulk_load(dk, kb + (long long)s0 * hd, bytes, &full[st]);
        hopper::bulk_load(dv, vb + (long long)s0 * hd, bytes, &full[st]);
        if constexpr (QUANT) {
          hopper::bulk_load(dks, ksb + s0, 2u * ns, &full[st]);
          hopper::bulk_load(dvs, vsb + s0, 2u * ns, &full[st]);
        }
      }
    } else {
      // plain 8-byte loads (rows are 8-byte aligned: the wrapper's stride
      // checks), exactly the slots below `end`
      const int ns = min(end - s0, TS);
      const int upr = hd * (int)sizeof(T) / 8;  // 8-byte units per row
      for (int u = lane; u < ns * upr; u += 32) {
        const int row = u / upr, c = u % upr;
        const long long src = (long long)(s0 + row) * p.c_ss;
        reinterpret_cast<uint2*>(dk + row * hd)[c] = reinterpret_cast<const uint2*>(kb + src)[c];
        reinterpret_cast<uint2*>(dv + row * hd)[c] = reinterpret_cast<const uint2*>(vb + src)[c];
      }
      if constexpr (QUANT) {
        for (int s = lane; s < ns; s += 32) {
          dks[s] = ksb[s0 + s];
          dvs[s] = vsb[s0 + s];
        }
      }
      hopper::mbar_arrive(&full[st]);  // the barrier counts the 32 lanes
    }
  }
}

__device__ inline void init_ring(const int stages, const int bulk, uint64_t* full,
                                 uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      hopper::mbar_init(&full[s], bulk ? 1 : 32);
      hopper::mbar_init(&empty[s], 1);
    }
    hopper::fence_barrier_init();
  }
}

// ---------------------------------------------------------------------------
// Merge of the cluster's CTA states (cm, cl, cacc at the same shared offsets
// in every CTA) and, for decode, the self term; writes rows < `rows` of the
// output. Called by every thread of every CTA of the cluster after the CTA
// states are written (it syncs the cluster itself, before and after).

template <bool SELF>
__device__ inline void cluster_finalize(const float* cm, const float* cl, const float* cacc,
                                        const float* sself, const bf16* v_cur, int nrows,
                                        int rows, int row0, int hd, int splits, int C, int g,
                                        int nh, int b, int hk, bf16* o) {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int rank = (int)cluster.block_rank();
  // four consecutive elements of one row per thread (hd % 8 == 0)
  const int hd4 = hd / 4;
  const int nthreads = (int)blockDim.x;
  for (int idx = rank * nthreads + threadIdx.x; idx < nrows * hd4; idx += splits * nthreads) {
    const int r = idx / hd4, d = (idx % hd4) * 4;
    const int row = row0 + r;
    if (row >= rows) continue;
    // every split's state at once: the remote loads overlap
    float mj[MAX_SPLITS], lj[MAX_SPLITS];
    float4 aj[MAX_SPLITS];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      mj[j] = -INFINITY;
      lj[j] = 0.f;
      aj[j] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < splits) {
        mj[j] = cluster.map_shared_rank(cm, j)[r];
        lj[j] = cluster.map_shared_rank(cl, j)[r];
        aj[j] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(cacc, j) + r * hd + d);
      }
    }
    float mx = -INFINITY, den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    if constexpr (SELF) mx = sself[r];
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) mx = fmaxf(mx, mj[j]);
    if constexpr (SELF) {
      const float f = __expf(sself[r] - mx);
      float v[4];
      load_f32<4>(v_cur + d, v);
      num = make_float4(f * v[0], f * v[1], f * v[2], f * v[3]);
      den = f;
    }
#pragma unroll
    for (int j = 0; j < MAX_SPLITS; ++j) {
      const float f = mj[j] == -INFINITY ? 0.f : __expf(mj[j] - mx);  // -inf: no slot seen
      num.x += f * aj[j].x;
      num.y += f * aj[j].y;
      num.z += f * aj[j].z;
      num.w += f * aj[j].w;
      den += f * lj[j];
    }
    const int i = row / g, h = row % g;
    bf16* out = o + (((long long)b * C + i) * nh + hk * g + h) * hd + d;
    const float inv = 1.f / den;
    reinterpret_cast<__nv_bfloat162*>(out)[0] = __floats2bfloat162_rn(num.x * inv, num.y * inv);
    reinterpret_cast<__nv_bfloat162*>(out)[1] = __floats2bfloat162_rn(num.z * inv, num.w * inv);
  }
  cluster.sync();  // the others keep their shared memory until it has been read
}

// ---------------------------------------------------------------------------
// The CUDA-core split kernel body. R query rows per CTA: row r is (chunk
// query r / g, group head r % g); rows >= g * C are padding. Decode (SELF):
// C = 1, slots < lengths[b] plus the self term. Chunk: row r attends slots
// <= lengths[b] + r / g. Grid (nkv, B, splits), cluster (1, 1, splits).

// bytes of the merge area (warp states, then the CTA state read remotely)
__host__ __device__ inline int split_merge_bytes(int R, int hd, int ncw) {
  return 4 * ((ncw + 1) * R * hd + 2 * ncw * R + 2 * R);
}
// dynamic shared memory of split_body
__host__ __device__ inline int split_smem_bytes(int R, int hd, int union_bytes, int ncw) {
  return 128 + union_bytes + 4 * (R * hd + ncw * R * TS + R);
}

template <typename T, int R, int EPL, bool SELF>
__device__ inline void split_body(const Split<T>& p) {
  constexpr bool QUANT = std::is_same_v<T, int8_t>;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  unsigned char* ring = smem + 128;
  const int hd = p.hd, nc = hd / 8;
  const int ncw = p.ncw, nthreads = (ncw + 1) * 32;
  float* qlo = reinterpret_cast<float*>(ring + p.union_bytes);  // (R, nc, 4)
  float* qhi = qlo + R * hd / 2;
  float* pbuf = qhi + R * hd / 2;  // (ncw, R, TS)
  float* sself = pbuf + ncw * R * TS;

  const int hk = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rows = p.g * p.C;
  const int length = min(max(p.lengths[b], 0), p.S);
  const int end = SELF ? length : min(length + p.C, p.S);  // slots [0, end) may be read

  init_ring(p.stages, p.bulk, full, empty);
  __syncthreads();  // the barriers are ready: the producer starts at once

  float m[R], l[R], acc[R][EPL];
  if (warp == ncw) {
    produce<T>(p, b, hk, split, end, ring, full, empty, lane);
  } else {
    for (int idx = threadIdx.x; idx < R * hd; idx += ncw * 32) {
      const int r = idx / hd, d = idx % hd;
      float x = 0.f;
      if (r < rows) {
        const int i = r / p.g, h = r % p.g;
        x = __bfloat162float(p.q[b * p.q_sb + i * p.q_sc + (hk * p.g + h) * p.q_sh + d]) *
            p.scale;
      }
      const int e = d % 8;
      (e < 4 ? qlo : qhi)[(r * nc + d / 8) * 4 + (e & 3)] = x;
    }
    hopper::bar_sync(1, ncw * 32);  // the consumers' q planes are ready
    int limit[R];  // last attended slot per row; -1 for padding rows
#pragma unroll
    for (int r = 0; r < R; ++r) {
      limit[r] = r < rows ? (SELF ? end - 1 : min(length + r / p.g, p.S - 1)) : -1;
      m[r] = -INFINITY;
      l[r] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
    }
    const int kv_bytes = align128(TS * hd * (int)sizeof(T));
    const int sb = stage_bytes<T>(hd);
    const int nt = (end + TS - 1) / TS;
    const int d0 = lane * EPL;
    const float4* ql4 = reinterpret_cast<const float4*>(qlo);
    const float4* qh4 = reinterpret_cast<const float4*>(qhi);
    float* pw = pbuf + warp * R * TS;
    for (int k = warp;; k += ncw) {
      const int t = split + k * p.splits;
      if (t >= nt) break;
      const int st = k % p.stages;
      hopper::mbar_wait(&full[st], (k / p.stages) & 1);
      const unsigned char* src = ring + st * sb;
      const T* tk = reinterpret_cast<const T*>(src);
      const T* tv = reinterpret_cast<const T*>(src + kv_bytes);
      const int s0 = t * TS;
      const int nv = min(end - s0, TS);  // slots of this tile below `end`

      // scores of this lane's slot for every row: chunks in rotated order
      float sc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) sc[r] = 0.f;
      int cc = lane % nc;
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        float kf[8];
        load_f32<8>(tk + lane * hd + cc * 8, kf);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 a = ql4[r * nc + cc], z = qh4[r * nc + cc];
          sc[r] += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] + z.x * kf[4] +
                   z.y * kf[5] + z.z * kf[6] + z.w * kf[7];
        }
        cc = (cc + 1 == nc) ? 0 : cc + 1;
      }
      float ksc = 1.f, vsc = 1.f;
      if constexpr (QUANT) {
        const bf16* tks = reinterpret_cast<const bf16*>(src + 2 * kv_bytes);
        ksc = __bfloat162float(tks[lane]);
        vsc = __bfloat162float(tks[64 + lane]);
      }
      const int slot = s0 + lane;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        // garbage past the copied slots never survives the select
        const float s = slot <= limit[r] ? sc[r] * ksc : -INFINITY;
        const float mn = fmaxf(m[r], warp_max(s));
        const float a = m[r] == -INFINITY ? 0.f : __expf(m[r] - mn);
        const float pr = s == -INFINITY ? 0.f : __expf(s - mn);
        l[r] = l[r] * a + pr;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] *= a;
        m[r] = mn;
        pw[r * TS + lane] = s == -INFINITY ? 0.f : pr * vsc;  // the v scale folds in
      }
      __syncwarp();
      if (d0 < hd) {
        // slots past nv carry weight 0: their row index clamps to a copied row
#pragma unroll 2
        for (int s4 = 0; s4 < nv; s4 += 4) {
          float4 w4[R];
#pragma unroll
          for (int r = 0; r < R; ++r) w4[r] = *reinterpret_cast<const float4*>(pw + r * TS + s4);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float vf[EPL];
            load_f32<EPL>(tv + min(s4 + j, nv - 1) * hd + d0, vf);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const float w = j == 0 ? w4[r].x : j == 1 ? w4[r].y : j == 2 ? w4[r].z : w4[r].w;
#pragma unroll
              for (int e = 0; e < EPL; ++e) acc[r][e] += w * vf[e];
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[st]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) l[r] = warp_sum(l[r]);
  }
  __syncthreads();  // every tile consumed: the ring becomes the merge area

  float* wacc = reinterpret_cast<float*>(ring);  // (ncw, R, hd)
  float* cacc = wacc + ncw * R * hd;              // (R, hd)
  float* wm = cacc + R * hd;                      // (ncw, R)
  float* wl = wm + ncw * R;
  float* cm = wl + ncw * R;                       // (R,)
  float* cl = cm + R;
  if (warp < ncw) {
    const int d0 = lane * EPL;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (lane == 0) {
        wm[warp * R + r] = m[r];
        wl[warp * R + r] = l[r];
      }
      if (d0 < hd) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) wacc[(warp * R + r) * hd + d0 + e] = acc[r][e];
      }
    }
  }
  if constexpr (SELF) {
    // the current token's score per head, from the scaled q planes
    const bf16* kcur = p.k_cur + b * p.cur_sb + hk * p.cur_sh;
    for (int r = warp; r < R; r += ncw + 1) {
      float part = 0.f;
      for (int c = lane; c < nc; c += 32) {
        float kf[8];
        load_f32<8>(kcur + c * 8, kf);
        const float4 a = reinterpret_cast<const float4*>(qlo)[r * nc + c];
        const float4 z = reinterpret_cast<const float4*>(qhi)[r * nc + c];
        part += a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] + z.x * kf[4] +
                z.y * kf[5] + z.z * kf[6] + z.w * kf[7];
      }
      part = warp_sum(part);
      if (lane == 0) sself[r] = part;
    }
  }
  __syncthreads();
  // this CTA's state: its warps merged
  for (int idx = threadIdx.x; idx < R * hd; idx += nthreads) {
    const int r = idx / hd, d = idx % hd;
    float mx = -INFINITY;
    for (int w = 0; w < ncw; ++w) mx = fmaxf(mx, wm[w * R + r]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < ncw; ++w) {
      const float mw = wm[w * R + r];
      if (mw == -INFINITY) continue;  // this warp saw no attendable slot
      const float f = __expf(mw - mx);
      num += f * wacc[(w * R + r) * hd + d];
      den += f * wl[w * R + r];
    }
    cacc[idx] = num;
    if (d == 0) {
      cm[r] = mx;
      cl[r] = den;
    }
  }
  cluster_finalize<SELF>(cm, cl, cacc, sself,
                         SELF ? p.v_cur + b * p.cur_sb + hk * p.cur_sh : nullptr, R, rows, 0,
                         hd, p.splits, p.C, p.g, p.nh, b, hk, p.o);
}

// ---------------------------------------------------------------------------
// host side

// Whether every tile of this cache can be a 1-D bulk copy (see the top).
inline bool bulk_eligible(const void* k, const void* v, const void* ks, const void* vs,
                          int esize, int hd, int S, long long c_sb, long long c_sh,
                          long long c_ss, long long s_sb, long long s_sh) {
  auto a16 = [](const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; };
  bool ok = c_ss == hd && S % 8 == 0 && a16(k) && a16(v) && (c_sb * esize) % 16 == 0 &&
            (c_sh * esize) % 16 == 0;
  if (ks != nullptr) ok = ok && a16(ks) && a16(vs) && (s_sb * 2) % 16 == 0 && (s_sh * 2) % 16 == 0;
  return ok;
}

// split_body's consumer warps and ring stages for a stage of `bytes`: 8
// warps on 8 stages if those fit in RING_BYTES (int8 at hd <= 128, bf16
// at hd <= 64), else 4 on 4, so that two CTAs of a bf16 hd 128 ring fit
// on an SM (an 8-stage one there measured slower). One stage per warp:
// tile k goes to warp k % ncw and stage k % stages = the same, so each
// stage has one consumer, which waits for its phases in order (a parity
// wait cannot tell phase n + 2 from n).
inline void split_ring(int bytes, int& ncw, int& stages) {
  ncw = stages = MAX_NCW * bytes <= RING_BYTES ? MAX_NCW : NCW;
}

// CTAs that split S: the fewest that give the grid one CTA per SM (more
// splits measured slower: each adds a CTA's fixed cost and the cluster
// merge), from the grid without splits (`ctas`), S and the SM count alone;
// at most 8 (a portable cluster) and at most one per tile of S. Returns
// the CUDA error of reading the device or its SM count.
inline cudaError_t choose_splits(int ctas, int S, int& splits) {
  static int sms[16] = {0};
  int dev = 0, n = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 16 && sms[dev] > 0) {
    n = sms[dev];
  } else {
    e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (dev < 16) sms[dev] = n;
  }
  int s = (n + ctas - 1) / std::max(ctas, 1);
  s = std::min(s, MAX_SPLITS);
  s = std::min(s, (S + TS - 1) / TS);
  splits = std::max(s, 1);
  return cudaSuccess;
}

// Launch `kernel` on grid (nkv, B, z) with clusters of (1, 1, splits).
// smem_set: the dynamic shared memory already allowed, per device.
template <typename K, typename P>
int launch_cluster(K kernel, const P& p, dim3 grid, int threads, int splits, int smem,
                   cudaStream_t stream, int (&smem_set)[16]) {
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 16 || smem > smem_set[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < 16) smem_set[dev] = smem;
    }
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = (unsigned)splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace kvrows
