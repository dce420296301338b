// Decode attention for Hopper (sm_90a): one query token per row against the
// stacked head-major KV cache, bf16 cache, f32 softmax.
//
// Replaces the Pallas kernel `_decode_kernel` / `decode_attention` in
// vlrlhf_tpu/ops/decode_attention.py. Same semantics: cache slots with
// slot < lengths[b] are attended (strict: the current token is not in the
// cache yet), the current token's k/v arrive separately and are folded in
// as an always-attended self term at the end, GQA query heads h share kv
// head h / g, and the stacked (L, B, nkv, S, hd) cache is indexed by
// `layer` through a pointer offset, so no per-layer slice is copied.
//
// What bounds it on the H100: bytes. Each cache element feeds one
// multiply-add per query head of its group, far below the ~295 flop/byte
// where the tensor cores become the limit, so the kernel's job is to keep
// enough loads in flight to stream each live cache byte once and to skip
// the dead ones. One CTA per (b, kv head), 8 warps. Each warp walks its own
// interleaved share of the slots below lengths[b] with a private online
// softmax (running max, denominator and accumulator in registers, no block
// barrier inside the loop), loading UNROLL key rows and value rows per
// iteration as vector loads (each lane owns EPL contiguous elements of a
// row) before reducing, so ~UNROLL*2 row loads per warp are in flight. The
// warps' partial states are merged once through shared memory, where the
// self term joins. No (B, H, S) score tensor reaches device memory. With
// few rows the grid (B * nkv CTAs) underfills 132 SMs at long lengths;
// splitting S across CTAs (flash-decoding) and int8 k/v scales are later
// PRs' work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int UNROLL = 4;  // slots per warp per iteration
constexpr int MAX_HD = 256;

struct Params {
  const __nv_bfloat16* q;      // (B, nh, hd)
  const __nv_bfloat16* kc;     // stacked cache, layer offset applied
  const __nv_bfloat16* vc;
  const __nv_bfloat16* k_cur;  // (B, nkv, hd)
  const __nv_bfloat16* v_cur;
  const int* lengths;          // (B,)
  __nv_bfloat16* o;            // (B, nh, hd) contiguous
  int nkv, hd, S;
  long long q_sb, q_sh;
  long long c_sb, c_sh, c_ss;  // cache strides (batch, head, slot)
  long long cur_sb, cur_sh;
  float scale;
};

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Lane `lane` owns elements [lane*EPL, lane*EPL + EPL) of a row; hd is a
// multiple of 8 and EPL divides 8, so a lane's chunk is wholly in or out.
template <int EPL>
__device__ inline void load_row(const __nv_bfloat16* row, int lane, int hd, float (&out)[EPL]) {
  const int d0 = lane * EPL;
  if (d0 >= hd) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = 0.f;
    return;
  }
  if constexpr (EPL == 1) {
    out[0] = __bfloat162float(row[d0]);
  } else if constexpr (EPL == 2) {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(row + d0);
    out[0] = __low2float(v);
    out[1] = __high2float(v);
  } else if constexpr (EPL == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d0);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      out[2 * e] = __low2float(v[e]);
      out[2 * e + 1] = __high2float(v[e]);
    }
  } else {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * e] = __low2float(v[e]);
      out[2 * e + 1] = __high2float(v[e]);
    }
  }
}

template <int G, int EPL>
__global__ void __launch_bounds__(NTHREADS) decode_kernel(Params p) {
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

  const __nv_bfloat16* kbase = p.kc + b * p.c_sb + hk * p.c_sh;
  const __nv_bfloat16* vbase = p.vc + b * p.c_sb + hk * p.c_sh;
  for (int s0 = warp * UNROLL; s0 < length; s0 += NWARPS * UNROLL) {
    float kr[UNROLL][EPL], vr[UNROLL][EPL];
#pragma unroll
    for (int t = 0; t < UNROLL; ++t) {
      const int s = min(s0 + t, length - 1);  // clamped: masked below
      load_row<EPL>(kbase + s * p.c_ss, lane, hd, kr[t]);
      load_row<EPL>(vbase + s * p.c_ss, lane, hd, vr[t]);
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
        part = warp_sum(part);
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
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] += pt * vr[t][e];
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

template <int G, int EPL>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * NWARPS * G + G + (size_t)NWARPS * G * p.hd);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(decode_kernel<G, EPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(p.nkv, B);
  decode_kernel<G, EPL><<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int G>
int launch_g(const Params& p, int B, cudaStream_t stream) {
  if (p.hd <= 32) return launch<G, 1>(p, B, stream);
  if (p.hd <= 64) return launch<G, 2>(p, B, stream);
  if (p.hd <= 128) return launch<G, 4>(p, B, stream);
  return launch<G, 8>(p, B, stream);
}

}  // namespace

extern "C" int decode_attention_bf16(
    const void* q, const void* k_cache, const void* v_cache, const void* k_cur,
    const void* v_cur, const int* lengths, void* o, int B, int nh, int nkv,
    int hd, int S, long long layer_offset, long long q_sb, long long q_sh,
    long long c_sb, long long c_sh, long long c_ss, long long cur_sb,
    long long cur_sh, float scale, void* stream) {
  if (hd <= 0 || hd > MAX_HD || hd % 8 != 0 || nkv <= 0 || nh % nkv != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.kc = static_cast<const __nv_bfloat16*>(k_cache) + layer_offset;
  p.vc = static_cast<const __nv_bfloat16*>(v_cache) + layer_offset;
  p.k_cur = static_cast<const __nv_bfloat16*>(k_cur);
  p.v_cur = static_cast<const __nv_bfloat16*>(v_cur);
  p.lengths = lengths;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.nkv = nkv; p.hd = hd; p.S = S;
  p.q_sb = q_sb; p.q_sh = q_sh;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.cur_sb = cur_sb; p.cur_sh = cur_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nh / nkv) {
    case 1: return launch_g<1>(p, B, st);
    case 2: return launch_g<2>(p, B, st);
    case 4: return launch_g<4>(p, B, st);
    case 8: return launch_g<8>(p, B, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
