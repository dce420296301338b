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
// What bounds it on the H100: bytes at the speculative verify shape (C = 4,
// g = 1 for LLaVA-1.5-7B: 4 query rows per (row, kv head), ~8 flops per
// cache byte), operations on the CUDA cores at a chat turn's C in the tens
// to hundreds. One design covers both: the decode kernel's layout with a
// tile of R query rows per CTA. A CTA owns (row b, kv head, query tile):
// its R rows are (group head, chunk query) pairs, held in registers. Each
// of 8 warps walks its own interleaved share of the tile's live slots with
// a private online softmax per query row (no block barrier in the loop),
// loading UNROLL key and value rows per iteration as vector loads, so one
// pass over the cache serves all R rows; the warps merge once through
// shared memory. R is 4 at the verify shape (the tile is exactly the
// chunk, the cache is read once) and 16 for long chunks (the cache is read
// once per 16 queries, from L2 after the first tile). A 64-row tensor-core
// tile would sit 94% idle at C = 4; a wgmma row tile for long chunks is
// later work. No (B, H, C, S) score tensor reaches device memory, and no
// chunk length is too long: the kernel masks its own ragged edge.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "kv_rows.cuh"

namespace {

using kvrows::load_row;
using kvrows::warp_sum;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int MAX_HD = 256;

template <typename T>
struct Params {
  const __nv_bfloat16* q;   // (B, C, nh, hd)
  const T* kc;              // stacked cache, layer offset applied
  const T* vc;
  const __nv_bfloat16* ks;  // (.., B, nkv, S) scales, layer offset applied; int8 only
  const __nv_bfloat16* vs;
  const int* lengths;       // (B,) tokens in the cache before the chunk
  __nv_bfloat16* o;         // (B, C, nh, hd) contiguous
  int C, nh, nkv, g, hd, S, qt;  // qt: chunk queries per tile (R / g)
  long long q_sb, q_sc, q_sh;
  long long c_sb, c_sh, c_ss;  // cache strides (batch, head, slot)
  long long s_sb, s_sh;        // scale strides (batch, head); slot stride 1
  float scale;
};

template <typename T, int R, int EPL>
__global__ void __launch_bounds__(NTHREADS) chunk_kernel(Params<T> p) {
  constexpr bool QUANT = std::is_same_v<T, int8_t>;
  constexpr int UNROLL = R >= 16 ? 2 : 4;  // slots per warp per iteration
  extern __shared__ __align__(16) float sm[];
  float* sm_m = sm;                 // (NWARPS, R)
  float* sm_l = sm_m + NWARPS * R;  // (NWARPS, R)
  float* sm_acc = sm_l + NWARPS * R;  // (NWARPS, R, hd)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int tile = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hd = p.hd;
  const int length = max(p.lengths[b], 0);
  const int i0 = tile * p.qt;
  const int i_last = min(p.C, i0 + p.qt) - 1;  // last chunk query of the tile
  const int end = min(length + i_last + 1, p.S);  // slots [0, end) are read

  // row r = (group head r / qt, chunk query i0 + r % qt); limit: last slot
  float qv[R][EPL];
  int limit[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int h = r / p.qt, i = i0 + r % p.qt;
    const bool valid = h < p.g && i < p.C;
    limit[r] = valid ? min(length + i, end - 1) : -1;
    load_row<EPL>(p.q + b * p.q_sb + (long long)min(i, p.C - 1) * p.q_sc +
                      (hk * p.g + min(h, p.g - 1)) * p.q_sh,
                  lane, hd, qv[r]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[r][e] *= p.scale;
  }
  float m[R], l[R], acc[R][EPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  const T* kbase = p.kc + b * p.c_sb + hk * p.c_sh;
  const T* vbase = p.vc + b * p.c_sb + hk * p.c_sh;
  const __nv_bfloat16* ksbase = QUANT ? p.ks + b * p.s_sb + hk * p.s_sh : nullptr;
  const __nv_bfloat16* vsbase = QUANT ? p.vs + b * p.s_sb + hk * p.s_sh : nullptr;
  for (int s0 = warp * UNROLL; s0 < end; s0 += NWARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      const int s = min(s0 + t, end - 1);  // clamped: masked below
      load_row<EPL>(kbase + s * p.c_ss, lane, hd, kr[t]);
      load_row<EPL>(vbase + s * p.c_ss, lane, hd, vr[t]);
      if constexpr (QUANT) {
        ksc[t] = __bfloat162float(ksbase[s]);
        vsc[t] = __bfloat162float(vsbase[s]);
      } else {
        ksc[t] = vsc[t] = 1.f;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sc[UNROLL];
      float mx = m[r];
#pragma unroll
      for (int t = 0; t < UNROLL; ++t) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qv[r][e] * kr[t][e];
        part = warp_sum(part) * ksc[t];
        sc[t] = (s0 + t <= limit[r]) ? part : -INFINITY;
        mx = fmaxf(mx, sc[t]);
      }
      // branch-free, so the rows' reductions interleave: a row with nothing
      // attendable yet (mx == -inf) keeps m = -inf and l = acc = 0
      const float a = (m[r] == -INFINITY) ? 0.f : __expf(m[r] - mx);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= a;
#pragma unroll
      for (int t = 0; t < UNROLL; ++t) {
        const float pt = (sc[t] == -INFINITY) ? 0.f : __expf(sc[t] - mx);
        psum += pt;
        const float pv = pt * vsc[t];  // the v scale folds into the weight
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] += pv * vr[t][e];
      }
      l[r] = l[r] * a + psum;
      m[r] = mx;
    }
  }

  // publish this warp's partial state
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (lane == 0) {
      sm_m[warp * R + r] = m[r];
      sm_l[warp * R + r] = l[r];
    }
    const int d0 = lane * EPL;
    if (d0 < hd) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[(warp * R + r) * hd + d0 + e] = acc[r][e];
    }
  }
  __syncthreads();

  // merge the warps' states; one thread per (row, d). A valid row attends
  // slot 0 at least, so some warp holds a finite max.
  for (int idx = threadIdx.x; idx < R * hd; idx += NTHREADS) {
    const int r = idx / hd, d = idx % hd;
    const int h = r / p.qt, i = i0 + r % p.qt;
    if (h >= p.g || i >= p.C) continue;
    float mx = -INFINITY;
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w * R + r]);
    float num = 0.f, den = 0.f;
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = sm_m[w * R + r];
      if (mw == -INFINITY) continue;  // this warp saw no attendable slot
      const float f = __expf(mw - mx);
      num += f * sm_acc[(w * R + r) * hd + d];
      den += f * sm_l[w * R + r];
    }
    p.o[(((long long)b * p.C + i) * p.nh + hk * p.g + h) * hd + d] =
        __float2bfloat16(num / den);
  }
}

template <typename T, int R, int EPL>
int launch(Params<T> p, int B, cudaStream_t stream) {
  p.qt = R / p.g;
  const size_t smem = sizeof(float) * (2 * NWARPS * R + (size_t)NWARPS * R * p.hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(chunk_kernel<T, R, EPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.nkv, B, (p.C + p.qt - 1) / p.qt);
  chunk_kernel<T, R, EPL><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// R: the smallest of 4, 8, 16 that holds g * C rows (16 for longer chunks;
// 8 at head_dim > 128, where 16 rows of accumulators would spill)
template <typename T, int EPL>
int launch_r(const Params<T>& p, int B, cudaStream_t stream) {
  const int rows = p.g * p.C;
  if (rows <= 4 && p.g <= 4) return launch<T, 4, EPL>(p, B, stream);
  if constexpr (EPL == 8) {
    return launch<T, 8, EPL>(p, B, stream);
  } else {
    if (rows <= 8) return launch<T, 8, EPL>(p, B, stream);
    return launch<T, 16, EPL>(p, B, stream);
  }
}

template <typename T>
int launch_e(const Params<T>& p, int B, cudaStream_t stream) {
  if (p.hd <= 32) return launch_r<T, 1>(p, B, stream);
  if (p.hd <= 64) return launch_r<T, 2>(p, B, stream);
  if (p.hd <= 128) return launch_r<T, 4>(p, B, stream);
  return launch_r<T, 8>(p, B, stream);
}

template <typename T>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
             const void* v_scale, const int* lengths, void* o, int B, int C, int nh, int nkv,
             int hd, int S, long long layer_offset, long long s_layer_offset, long long q_sb,
             long long q_sc, long long q_sh, long long c_sb, long long c_sh, long long c_ss,
             long long s_sb, long long s_sh, float scale, cudaStream_t st) {
  Params<T> p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = static_cast<const T*>(k_cache) + layer_offset;
  p.vc = static_cast<const T*>(v_cache) + layer_offset;
  p.ks = k_scale ? static_cast<const __nv_bfloat16*>(k_scale) + s_layer_offset : nullptr;
  p.vs = v_scale ? static_cast<const __nv_bfloat16*>(v_scale) + s_layer_offset : nullptr;
  p.lengths = lengths;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.C = C; p.nh = nh; p.nkv = nkv; p.g = nh / nkv; p.hd = hd; p.S = S; p.qt = 1;
  p.q_sb = q_sb; p.q_sc = q_sc; p.q_sh = q_sh;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.s_sb = s_sb; p.s_sh = s_sh;
  p.scale = scale;
  return launch_e<T>(p, B, st);
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
  if (hd <= 0 || hd > MAX_HD || hd % 8 != 0 || nkv <= 0 || nh % nkv != 0 ||
      (g != 1 && g != 2 && g != 4 && g != 8) || C <= 0 ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return dispatch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, lengths, o, B, C, nh, nkv,
                            hd, S, layer_offset, s_layer_offset, q_sb, q_sc, q_sh, c_sb, c_sh,
                            c_ss, s_sb, s_sh, scale, st);
  }
  return dispatch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, lengths, o, B, C, nh,
                                 nkv, hd, S, layer_offset, 0, q_sb, q_sc, q_sh, c_sb, c_sh, c_ss,
                                 0, 0, scale, st);
}
