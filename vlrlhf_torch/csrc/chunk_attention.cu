// Chunk attention for Hopper (sm_90a): C chunk queries per row against the
// live stacked head-major KV cache, bf16 or int8 cache, f32 softmax.
//
// Replaces the Pallas kernel `_chunk_kernel` / `chunk_attention` in
// vlrlhf_tpu/ops/chunk_attention.py. Same contract: the chunk's own k/v
// are already in the cache at slots lengths[b] + i, and query i of row b
// attends slot j iff j <= lengths[b] + i (its own slot included). Slots
// past lengths[b] + C are never read. GQA query heads h share kv head
// h / g; the stacked (L, B, nkv, S, hd) cache is read at a `layer` pointer
// offset, in place. An int8 cache carries one bf16 scale per slot for k
// and for v: the k scale multiplies the f32 score after the dot, the v
// scale multiplies the softmax weight before it meets the value row.
// Chunk-pad queries (i >= the row's real chunk length) attend stale slots
// and give finite values that no caller reads.
//
// Both paths share decode's machinery (kv_rows.cuh): a producer warp
// streams 32-slot K / V tiles and int8 scale spans by 1-D bulk copies into
// a shared-memory ring on mbarriers, S is split across a thread-block
// cluster of up to 8 CTAs (interleaved tiles, `splits` from the shapes and
// the SM count), and the splits merge through distributed shared memory.
// A query row is (chunk query i, group head h), g * C rows per kv head.
//
// What bounds it on the H100, and the two paths:
// - Short chunks, g * C <= 16 rows (<= 8 at head_dim > 128), e.g. the
//   speculative verify chunk (C = 4, g = 1): bytes (~8 flops per cache
//   byte). chunk_split_kernel is decode's CUDA-core design with the R rows
//   sharing every tile; each row keeps its own causal limit and online
//   softmax. One CTA holds all rows, so the cache is read once.
// - Long chunks (a chat turn, C = 64 and longer): operations (~56 flops
//   per cache byte at C = 64 on a bf16 cache), so chunk_mma_kernel runs
//   the products on the tensor cores with mma.sync m16n8k16: a CTA owns
//   64 query rows (4 warps x 16) of one kv head and its split's tiles.
//   Each tile is converted once from the ring stage into padded bf16
//   operand tiles (int8 codes convert exactly, |code| <= 127; slots past
//   the live end and columns past head_dim become zeros), double-buffered
//   so one named barrier per tile suffices; S = Q K^T from ldmatrix
//   fragments, the k scale (and softmax scale) on S's columns, the causal
//   mask lengths[b] + i, the online softmax in registers (a quad's two
//   shuffles per row and tile), the v scale on P's columns before P is
//   rounded to bf16 for O += P V. No (B, H, C, S) score tensor reaches
//   device memory, and no chunk length is too long.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "kv_rows.cuh"

namespace {

using kvrows::bf16;
using kvrows::NCW;
using kvrows::Split;
using kvrows::TS;
using hopper::ldmatrix_x2;
using hopper::ldmatrix_x4;
using hopper::ldmatrix_x4_trans;
using hopper::mma16816;
using hopper::pack_bf16;

constexpr int QROWS = 64;  // query rows per tensor-core CTA (4 warps x 16)

template <typename T, int R, int EPL>
__global__ void __launch_bounds__(kvrows::MAX_THREADS) chunk_split_kernel(Split<T> p) {
  kvrows::split_body<T, R, EPL, false>(p);
}

// 8 cache elements -> 8 bf16 (int8 codes exactly)
__device__ inline uint4 to_bf16x8(const bf16* ptr) { return *reinterpret_cast<const uint4*>(ptr); }
__device__ inline uint4 to_bf16x8(const int8_t* ptr) {
  const uint2 w = *reinterpret_cast<const uint2*>(ptr);
  float f[8];
  kvrows::i8x4_to_f32(w.x, f);
  kvrows::i8x4_to_f32(w.y, f + 4);
  return make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                    pack_bf16(f[6], f[7]));
}

__device__ inline float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ inline float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// dynamic shared memory of chunk_mma_kernel<DP>: barriers, Q tile, ring /
// merge area, two (K, V) operand buffers, two (k scale, v scale) arrays
__host__ __device__ inline int mma_smem_bytes(int DP, int union_bytes) {
  const int LD = DP + 8;
  return 128 + QROWS * LD * 2 + union_bytes + 4 * TS * LD * 2 + 4 * TS * 4;
}

// Grid (nkv, B, qtiles * splits), cluster (1, 1, splits). Warp w < 4 owns
// tile rows 16w..16w+15 (row = (chunk query, group head) flattened, from
// qtile * 64); the last warp is the producer.
template <typename T, int DP>
__global__ void __launch_bounds__(kvrows::NTHREADS) chunk_mma_kernel(Split<T> p) {
  constexpr bool QUANT = std::is_same_v<T, int8_t>;
  constexpr int LD = DP + 8;   // padded row pitch (bf16): ldmatrix rows on distinct banks
  constexpr int NCH = DP / 8;  // 16-byte chunks per operand row
  constexpr int NT = TS / 8;   // n8 tiles of S per key tile
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kvrows::MAX_STAGES;
  bf16* qs = reinterpret_cast<bf16*>(smem + 128);  // (QROWS, LD)
  unsigned char* ring = smem + 128 + QROWS * LD * 2;
  bf16* kvp = reinterpret_cast<bf16*>(ring + p.union_bytes);  // 2 x (K, V) x (TS, LD)
  float* sf = reinterpret_cast<float*>(kvp + 4 * TS * LD);   // 2 x (k scale, v scale) x TS

  const int hk = blockIdx.x, b = blockIdx.y;
  const int qt = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int hd = p.hd;
  const int rows = p.g * p.C, row0 = qt * QROWS;
  const int length = min(max(p.lengths[b], 0), p.S);
  const int i_last = (min(row0 + QROWS, rows) - 1) / p.g;
  const int end = min(length + i_last + 1, p.S);  // slots [0, end) may be read

  kvrows::init_ring(p.stages, p.bulk, full, empty);
  __syncthreads();  // the barriers are ready: the producer starts at once

  const int ra = warp * 16 + lane / 4;  // this lane's two rows: ra, ra + 8
  float o[DP / 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (warp == NCW) {
    kvrows::produce<T>(p, b, hk, split, end, ring, full, empty, lane);
  } else {
    for (int idx = threadIdx.x; idx < QROWS * NCH; idx += NCW * 32) {
      const int rr = idx / NCH, c = idx % NCH, row = row0 + rr;
      uint4 w = make_uint4(0u, 0u, 0u, 0u);
      if (row < rows && c * 8 < hd) {
        const int i = row / p.g, h = row % p.g;
        w = *reinterpret_cast<const uint4*>(p.q + b * p.q_sb + i * p.q_sc +
                                            (hk * p.g + h) * p.q_sh + c * 8);
      }
      *reinterpret_cast<uint4*>(qs + rr * LD + c * 8) = w;
    }
    hopper::bar_sync(1, NCW * 32);  // the Q tile is ready
    int limit[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + ra + 8 * h;
      limit[h] = row < rows ? min(length + row / p.g, p.S - 1) : -1;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
    const int kv_bytes = kvrows::align128(TS * hd * (int)sizeof(T));
    const int sb = kvrows::stage_bytes<T>(hd);
    const int nt = (end + TS - 1) / TS;
    for (int k = 0;; ++k) {
      const int t = split + k * p.splits;
      if (t >= nt) break;
      const int st = k % p.stages;
      hopper::mbar_wait(&full[st], (k / p.stages) & 1);
      const unsigned char* src = ring + st * sb;
      const T* tk = reinterpret_cast<const T*>(src);
      const T* tv = reinterpret_cast<const T*>(src + kv_bytes);
      bf16* kp = kvp + (k & 1) * 2 * TS * LD;
      bf16* vp = kp + TS * LD;
      float* ksf = sf + (k & 1) * 2 * TS;
      float* vsf = ksf + TS;
      const int s0 = t * TS;
      const int nv = min(end - s0, TS);
      // the stage -> padded bf16 operands; zeros past the live end and hd
      for (int idx = threadIdx.x; idx < TS * NCH; idx += NCW * 32) {
        const int s = idx / NCH, c = idx % NCH;
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (s < nv && c * 8 < hd) {
          kw = to_bf16x8(tk + s * hd + c * 8);
          vw = to_bf16x8(tv + s * hd + c * 8);
        }
        *reinterpret_cast<uint4*>(kp + s * LD + c * 8) = kw;
        *reinterpret_cast<uint4*>(vp + s * LD + c * 8) = vw;
      }
      if (threadIdx.x < TS) {
        const int s = threadIdx.x;
        if constexpr (QUANT) {
          const bf16* tks = reinterpret_cast<const bf16*>(src + 2 * kv_bytes);
          ksf[s] = s < nv ? __bfloat162float(tks[s]) * p.scale : 0.f;
          vsf[s] = s < nv ? __bfloat162float(tks[64 + s]) : 0.f;
        } else {
          ksf[s] = p.scale;
          vsf[s] = 1.f;
        }
      }
      hopper::bar_sync(1, NCW * 32);  // operands ready, the stage fully read
      if (threadIdx.x == 0) hopper::mbar_arrive(&empty[st]);

      // S = Q K^T for this warp's 16 rows x TS slots
      float sacc[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if (kk * 16 < hd) {
          uint32_t a[4];
          ldmatrix_x4(a, qs + (warp * 16 + (lane % 16)) * LD + kk * 16 + (lane / 16) * 8);
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            uint32_t bb[2];
            ldmatrix_x2(bb, kp + (n * 8 + (lane % 8)) * LD + kk * 16 + ((lane / 8) % 2) * 8);
            mma16816(sacc[n], a, bb[0], bb[1]);
          }
        }
      }
      // scale, causal mask, online softmax (rows ra: e = 0, 1; ra + 8: e = 2, 3)
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * (lane % 4) + (e & 1);
          const float s = s0 + j <= limit[e / 2] ? sacc[n][e] * ksf[j] : -INFINITY;
          sacc[n][e] = s;
          mx[e / 2] = fmaxf(mx[e / 2], s);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mn = fmaxf(m[h], quad_max(mx[h]));
        alpha[h] = m[h] == -INFINITY ? 0.f : __expf(m[h] - mn);
        l[h] *= alpha[h];
        m[h] = mn;
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = n * 8 + 2 * (lane % 4) + (e & 1);
          const float pr = sacc[n][e] == -INFINITY ? 0.f : __expf(sacc[n][e] - m[e / 2]);
          l[e / 2] += pr;
          sacc[n][e] = pr * vsf[j];  // the v scale folds into the weight
        }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
      // O += P V: P's accumulators are the A fragments of TS / 16 k-steps
#pragma unroll
      for (int ks = 0; ks < TS / 16; ++ks) {
        const uint32_t pa[4] = {pack_bf16(sacc[2 * ks][0], sacc[2 * ks][1]),
                                pack_bf16(sacc[2 * ks][2], sacc[2 * ks][3]),
                                pack_bf16(sacc[2 * ks + 1][0], sacc[2 * ks + 1][1]),
                                pack_bf16(sacc[2 * ks + 1][2], sacc[2 * ks + 1][3])};
#pragma unroll
        for (int nd = 0; nd < DP / 16; ++nd) {
          if (nd * 16 < hd) {
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, vp + (ks * 16 + (lane % 16)) * LD + nd * 16 + (lane / 16) * 8);
            mma16816(o[2 * nd], pa, bv[0], bv[1]);
            mma16816(o[2 * nd + 1], pa, bv[2], bv[3]);
          }
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = quad_sum(l[h]);
  }
  __syncthreads();  // every tile consumed: the ring becomes the merge area

  float* cacc = reinterpret_cast<float*>(ring);  // (QROWS, hd)
  float* cm = cacc + QROWS * hd;
  float* cl = cm + QROWS;
  if (warp < NCW) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int col = n * 8 + 2 * (lane % 4);
      if (col < hd) {
        cacc[ra * hd + col] = o[n][0];
        cacc[ra * hd + col + 1] = o[n][1];
        cacc[(ra + 8) * hd + col] = o[n][2];
        cacc[(ra + 8) * hd + col + 1] = o[n][3];
      }
    }
    if (lane % 4 == 0) {
      cm[ra] = m[0];
      cl[ra] = l[0];
      cm[ra + 8] = m[1];
      cl[ra + 8] = l[1];
    }
  }
  kvrows::cluster_finalize<false>(cm, cl, cacc, nullptr, nullptr, QROWS, rows, row0, hd,
                                  p.splits, p.C, p.g, p.nh, b, hk, p.o);
}

// ---------------------------------------------------------------------------
// host

template <typename T, int R, int EPL>
int launch_split(Split<T> p, int B, cudaStream_t stream) {
  static int smem_set[16] = {0};
  kvrows::split_ring(kvrows::stage_bytes<T>(p.hd), p.ncw, p.stages);
  p.union_bytes = kvrows::align128(std::max(p.stages * kvrows::stage_bytes<T>(p.hd),
                                            kvrows::split_merge_bytes(R, p.hd, p.ncw)));
  const cudaError_t e = kvrows::choose_splits(p.nkv * B, p.S, p.splits);
  if (e != cudaSuccess) return (int)e;
  const int smem = kvrows::split_smem_bytes(R, p.hd, p.union_bytes, p.ncw);
  return kvrows::launch_cluster(chunk_split_kernel<T, R, EPL>, p, dim3(p.nkv, B, p.splits),
                                (p.ncw + 1) * 32, p.splits, smem, stream, smem_set);
}

template <typename T, int R>
int launch_split_e(const Split<T>& p, int B, cudaStream_t stream) {
  if (p.hd <= 32) return launch_split<T, R, 1>(p, B, stream);
  if (p.hd <= 64) return launch_split<T, R, 2>(p, B, stream);
  if (p.hd <= 128) return launch_split<T, R, 4>(p, B, stream);
  if constexpr (R <= 8) {
    return launch_split<T, R, 8>(p, B, stream);
  } else {
    return (int)cudaErrorInvalidValue;  // the dispatch sends these to the tensor cores
  }
}

template <typename T, int DP>
int launch_mma(Split<T> p, int B, cudaStream_t stream) {
  static int smem_set[16] = {0};
  // any depth >= 2 is safe here: every consumer warp takes every tile, and
  // tile k's stage is refilled only after all of them passed its barrier
  p.ncw = NCW;
  p.stages = p.hd <= 128 ? 3 : 2;
  p.union_bytes = kvrows::align128(
      std::max(p.stages * kvrows::stage_bytes<T>(p.hd), 4 * (QROWS * p.hd + 2 * QROWS)));
  const int qtiles = (p.g * p.C + QROWS - 1) / QROWS;
  const cudaError_t e = kvrows::choose_splits(p.nkv * B * qtiles, p.S, p.splits);
  if (e != cudaSuccess) return (int)e;
  const int smem = mma_smem_bytes(DP, p.union_bytes);
  return kvrows::launch_cluster(chunk_mma_kernel<T, DP>, p, dim3(p.nkv, B, qtiles * p.splits),
                                kvrows::NTHREADS, p.splits, smem, stream, smem_set);
}

// Short chunks (g * C <= 16 rows, <= 8 at head_dim > 128) on the CUDA
// cores with R = the next power of two rows; longer ones on the tensor
// cores with head_dim padded to 64, 128 or 256.
template <typename T>
int launch_any(const Split<T>& p, int B, cudaStream_t stream) {
  const int rows = p.g * p.C;
  if (rows <= 16 && (p.hd <= 128 || rows <= 8)) {
    if (rows <= 1) return launch_split_e<T, 1>(p, B, stream);
    if (rows <= 2) return launch_split_e<T, 2>(p, B, stream);
    if (rows <= 4) return launch_split_e<T, 4>(p, B, stream);
    if (rows <= 8) return launch_split_e<T, 8>(p, B, stream);
    return launch_split_e<T, 16>(p, B, stream);
  }
  if (p.hd <= 64) return launch_mma<T, 64>(p, B, stream);
  if (p.hd <= 128) return launch_mma<T, 128>(p, B, stream);
  return launch_mma<T, 256>(p, B, stream);
}

template <typename T>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
             const void* v_scale, const int* lengths, void* o, int B, int C, int nh, int nkv,
             int hd, int S, long long layer_offset, long long s_layer_offset, long long q_sb,
             long long q_sc, long long q_sh, long long c_sb, long long c_sh, long long c_ss,
             long long s_sb, long long s_sh, float scale, cudaStream_t st) {
  Split<T> p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const T*>(k_cache) + layer_offset;
  p.v = static_cast<const T*>(v_cache) + layer_offset;
  p.ks = k_scale ? static_cast<const bf16*>(k_scale) + s_layer_offset : nullptr;
  p.vs = v_scale ? static_cast<const bf16*>(v_scale) + s_layer_offset : nullptr;
  p.k_cur = p.v_cur = nullptr;
  p.lengths = lengths;
  p.o = static_cast<bf16*>(o);
  p.C = C; p.g = nh / nkv; p.nh = nh; p.nkv = nkv; p.hd = hd; p.S = S;
  p.q_sb = q_sb; p.q_sc = q_sc; p.q_sh = q_sh;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.s_sb = s_sb; p.s_sh = s_sh;
  p.cur_sb = p.cur_sh = 0;
  p.scale = scale;
  p.bulk = kvrows::bulk_eligible(p.k, p.v, p.ks, p.vs, (int)sizeof(T), hd, S, c_sb, c_sh, c_ss,
                                 s_sb, s_sh);
  return launch_any<T>(p, B, st);
}

}  // namespace

// `quantized` != 0: the caches are int8 and k_scale / v_scale (bf16, slot
// stride 1) are read; otherwise the caches are bf16 and the scales unused.
extern "C" int chunk_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const int* lengths, void* o, int B, int C, int nh, int nkv, int hd,
    int S, int quantized, long long layer_offset, long long s_layer_offset, long long q_sb,
    long long q_sc, long long q_sh, long long c_sb, long long c_sh, long long c_ss,
    long long s_sb, long long s_sh, float scale, void* stream) {
  const int g = nkv > 0 ? nh / nkv : 0;
  if (hd <= 0 || hd > kvrows::MAX_HD || hd % 8 != 0 || nkv <= 0 || nh % nkv != 0 ||
      (g != 1 && g != 2 && g != 4 && g != 8) || C <= 0 || S <= 0 ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return dispatch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, lengths, o, B, C, nh, nkv,
                            hd, S, layer_offset, s_layer_offset, q_sb, q_sc, q_sh, c_sb, c_sh,
                            c_ss, s_sb, s_sh, scale, st);
  }
  return dispatch<bf16>(q, k_cache, v_cache, nullptr, nullptr, lengths, o, B, C, nh, nkv, hd,
                        S, layer_offset, 0, q_sb, q_sc, q_sh, c_sb, c_sh, c_ss, 0, 0, scale, st);
}
