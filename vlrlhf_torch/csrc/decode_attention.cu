// Decode attention for Hopper (sm_90a): one query token per row against the
// stacked head-major KV cache, bf16 or int8 cache, f32 softmax.
//
// Replaces the Pallas kernel `_decode_kernel` / `decode_attention` in
// vlrlhf_tpu/ops/decode_attention.py. Same semantics: cache slots with
// slot < lengths[b] are attended (strict: the current token is not in the
// cache yet), the current token's k/v arrive separately (bf16, exact) and
// are folded in as an always-attended self term at the end, GQA query heads
// h share kv head h / g, and the stacked (L, B, nkv, S, hd) cache is indexed
// by `layer` through a pointer offset, so no per-layer slice is copied. An
// int8 cache carries one bf16 scale per (layer, row, head, slot) for k and
// for v: the k scale multiplies the f32 score after the dot, the v scale
// multiplies the softmax weight before it meets the value row, so the
// cache is never dequantized into memory.
//
// What bounds it on the H100: bytes. Each cache element feeds one
// multiply-add per query head of its group, far below the ~295 flop/byte
// where the tensor cores become the limit, so the kernel's job is to keep
// enough loads in flight to stream each live cache byte once and to skip
// the dead ones; int8 halves those bytes. One CTA per (b, kv head), 8
// warps. Each warp walks its own interleaved share of the slots below
// lengths[b] with a private online softmax (running max, denominator and
// accumulator in registers, no block barrier inside the loop), loading
// UNROLL key rows and value rows per iteration as vector loads (each lane
// owns EPL contiguous elements of a row) before reducing, so ~UNROLL*2 row
// loads per warp are in flight. The warps' partial states are merged once
// through shared memory, where the self term joins. No (B, H, S) score
// tensor reaches device memory. With few rows the grid (B * nkv CTAs)
// underfills 132 SMs at long lengths; splitting S across CTAs
// (flash-decoding) is later work.
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
constexpr int UNROLL = 4;  // slots per warp per iteration
constexpr int MAX_HD = 256;

template <typename T>
struct Params {
  const __nv_bfloat16* q;      // (B, nh, hd)
  const T* kc;                 // stacked cache, layer offset applied
  const T* vc;
  const __nv_bfloat16* ks;     // (.., B, nkv, S) scales, layer offset applied; int8 only
  const __nv_bfloat16* vs;
  const __nv_bfloat16* k_cur;  // (B, nkv, hd)
  const __nv_bfloat16* v_cur;
  const int* lengths;          // (B,)
  __nv_bfloat16* o;            // (B, nh, hd) contiguous
  int nkv, hd, S;
  long long q_sb, q_sh;
  long long c_sb, c_sh, c_ss;  // cache strides (batch, head, slot)
  long long s_sb, s_sh;        // scale strides (batch, head); slot stride 1
  long long cur_sb, cur_sh;
  float scale;
};

template <typename T, int G, int EPL>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(Params<T> p) {
  constexpr bool QUANT = std::is_same_v<T, int8_t>;
  // per-warp partial states: m, l (G each) and acc (G * hd)
  extern __shared__ __align__(16) float sm[];
  float* sm_m = sm;                           // (NWARPS, G)
  float* sm_l = sm_m + NWARPS * G;            // (NWARPS, G)
  float* sm_self = sm_l + NWARPS * G;         // (G,)
  float* sm_acc = sm_self + G;                // (NWARPS, G, hd)

  const int hk = blockIdx.x;
  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int hd = p.hd;
  const int length = min(max(p.lengths[b], 0), p.S);

  float qv[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    load_row<EPL>(p.q + b * p.q_sb + (hk * G + h) * p.q_sh, lane, hd, qv[h]);
#pragma unroll
    for (int e = 0; e < EPL; ++e) qv[h][e] *= p.scale;
  }
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[h][e] = 0.f;
  }

  const T* kbase = p.kc + b * p.c_sb + hk * p.c_sh;
  const T* vbase = p.vc + b * p.c_sb + hk * p.c_sh;
  const __nv_bfloat16* ksbase = QUANT ? p.ks + b * p.s_sb + hk * p.s_sh : nullptr;
  const __nv_bfloat16* vsbase = QUANT ? p.vs + b * p.s_sb + hk * p.s_sh : nullptr;
  for (int s0 = warp * UNROLL; s0 < length; s0 += NWARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
    float ksc[UNROLL], vsc[UNROLL];
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      const int s = min(s0 + t, length - 1);  // clamped: masked below
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
    for (int h = 0; h < G; ++h) {
      float sc[UNROLL];
      float mx = m[h];
#pragma unroll
      for (int t = 0; t < UNROLL; ++t) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part += qv[h][e] * kr[t][e];
        part = warp_sum(part) * ksc[t];
        sc[t] = (s0 + t < length) ? part : -INFINITY;
        mx = fmaxf(mx, sc[t]);
      }
      // mx is finite: slot s0 < length always contributes
      const float a = (m[h] == -INFINITY) ? 0.f : __expf(m[h] - mx);
      float psum = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[h][e] *= a;
#pragma unroll
      for (int t = 0; t < UNROLL; ++t) {
        const float pt = (sc[t] == -INFINITY) ? 0.f : __expf(sc[t] - mx);
        psum += pt;
        const float pv = pt * vsc[t];  // the v scale folds into the weight
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] += pv * vr[t][e];
      }
      l[h] = l[h] * a + psum;
      m[h] = mx;
    }
  }

  // publish this warp's partial state
#pragma unroll
  for (int h = 0; h < G; ++h) {
    if (lane == 0) {
      sm_m[warp * G + h] = m[h];
      sm_l[warp * G + h] = l[h];
    }
    const int d0 = lane * EPL;
    if (d0 < hd) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) sm_acc[(warp * G + h) * hd + d0 + e] = acc[h][e];
    }
  }
  // self term scores: warp h % NWARPS handles head h
  const __nv_bfloat16* kcur = p.k_cur + b * p.cur_sb + hk * p.cur_sh;
  const __nv_bfloat16* vcur = p.v_cur + b * p.cur_sb + hk * p.cur_sh;
  for (int h = warp; h < G; h += NWARPS) {
    float kv[EPL];
    load_row<EPL>(kcur, lane, hd, kv);
    float part = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) part += qv[h][e] * kv[e];
    part = warp_sum(part);
    if (lane == 0) sm_self[h] = part;
  }
  __syncthreads();

  // merge the warps' states and the self term; one thread per (head, d)
  for (int idx = threadIdx.x; idx < G * hd; idx += NTHREADS) {
    const int h = idx / hd, d = idx % hd;
    const float ss = sm_self[h];
    float mx = ss;
    for (int w = 0; w < NWARPS; ++w) mx = fmaxf(mx, sm_m[w * G + h]);
    float num = __expf(ss - mx) * __bfloat162float(vcur[d]);
    float den = __expf(ss - mx);
    for (int w = 0; w < NWARPS; ++w) {
      const float mw = sm_m[w * G + h];
      if (mw == -INFINITY) continue;  // this warp saw no slot
      const float f = __expf(mw - mx);
      num += f * sm_acc[(w * G + h) * hd + d];
      den += f * sm_l[w * G + h];
    }
    p.o[((long long)b * p.nkv * G + hk * G + h) * hd + d] = __float2bfloat16(num / den);
  }
}

template <typename T, int G, int EPL>
int launch(const Params<T>& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * NWARPS * G + G + (size_t)NWARPS * G * p.hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<T, G, EPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.nkv, B);
  decode_kernel<T, G, EPL><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int G>
int launch_g(const Params<T>& p, int B, cudaStream_t stream) {
  if (p.hd <= 32) return launch<T, G, 1>(p, B, stream);
  if (p.hd <= 64) return launch<T, G, 2>(p, B, stream);
  if (p.hd <= 128) return launch<T, G, 4>(p, B, stream);
  return launch<T, G, 8>(p, B, stream);
}

template <typename T>
int dispatch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
             const void* v_scale, const void* k_cur, const void* v_cur, const int* lengths,
             void* o, int B, int nh, int nkv, int hd, int S, long long layer_offset,
             long long s_layer_offset, long long q_sb, long long q_sh, long long c_sb,
             long long c_sh, long long c_ss, long long s_sb, long long s_sh,
             long long cur_sb, long long cur_sh, float scale, cudaStream_t st) {
  Params<T> p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = static_cast<const T*>(k_cache) + layer_offset;
  p.vc = static_cast<const T*>(v_cache) + layer_offset;
  p.ks = k_scale ? static_cast<const __nv_bfloat16*>(k_scale) + s_layer_offset : nullptr;
  p.vs = v_scale ? static_cast<const __nv_bfloat16*>(v_scale) + s_layer_offset : nullptr;
  p.k_cur = static_cast<const __nv_bfloat16*>(k_cur);
  p.v_cur = static_cast<const __nv_bfloat16*>(v_cur);
  p.lengths = lengths;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.nkv = nkv; p.hd = hd; p.S = S;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.s_sb = s_sb; p.s_sh = s_sh;
  p.cur_sb = cur_sb; p.cur_sh = cur_sh;
  p.scale = scale;
  switch (nh / nkv) {
    case 1: return launch_g<T, 1>(p, B, st);
    case 2: return launch_g<T, 2>(p, B, st);
    case 4: return launch_g<T, 4>(p, B, st);
    case 8: return launch_g<T, 8>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// `quantized` != 0: the caches are int8 and k_scale / v_scale (bf16, slot
// stride 1) are read; otherwise the caches are bf16 and the scales unused.
extern "C" int decode_attention(
    const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
    const void* v_scale, const void* k_cur, const void* v_cur, const int* lengths, void* o,
    int B, int nh, int nkv, int hd, int S, int quantized, long long layer_offset,
    long long s_layer_offset, long long q_sb, long long q_sh, long long c_sb, long long c_sh,
    long long c_ss, long long s_sb, long long s_sh, long long cur_sb, long long cur_sh,
    float scale, void* stream) {
  if (hd <= 0 || hd > MAX_HD || hd % 8 != 0 || nkv <= 0 || nh % nkv != 0 ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (quantized) {
    return dispatch<int8_t>(q, k_cache, v_cache, k_scale, v_scale, k_cur, v_cur, lengths, o,
                            B, nh, nkv, hd, S, layer_offset, s_layer_offset, q_sb, q_sh, c_sb,
                            c_sh, c_ss, s_sb, s_sh, cur_sb, cur_sh, scale, st);
  }
  return dispatch<__nv_bfloat16>(q, k_cache, v_cache, nullptr, nullptr, k_cur, v_cur, lengths,
                                 o, B, nh, nkv, hd, S, layer_offset, 0, q_sb, q_sh, c_sb, c_sh,
                                 c_ss, 0, 0, cur_sb, cur_sh, scale, st);
}
