// Row loads and warp reductions shared by the attention kernels that stream
// the head-major KV cache (decode_attention.cu, chunk_attention.cu).
//
// A warp reads one (hd,) row at a time: lane `lane` owns elements
// [lane*EPL, lane*EPL + EPL). hd is a multiple of 8 and EPL divides 8, so a
// lane's chunk is wholly in or out of the row, and the row start is aligned
// to EPL elements, which makes each lane's read one vector load (16 bytes
// for bf16 at EPL 8, 8 bytes for int8). int8 codes convert to float
// exactly (|code| <= 127).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace kvrows {

__device__ inline float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

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

template <int EPL>
__device__ inline void load_row(const int8_t* row, int lane, int hd, float (&out)[EPL]) {
  const int d0 = lane * EPL;
  if (d0 >= hd) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = 0.f;
    return;
  }
  if constexpr (EPL == 1) {
    out[0] = static_cast<float>(row[d0]);
  } else if constexpr (EPL == 2) {
    const char2 v = *reinterpret_cast<const char2*>(row + d0);
    out[0] = static_cast<float>(v.x);
    out[1] = static_cast<float>(v.y);
  } else if constexpr (EPL == 4) {
    const char4 v = *reinterpret_cast<const char4*>(row + d0);
    out[0] = static_cast<float>(v.x);
    out[1] = static_cast<float>(v.y);
    out[2] = static_cast<float>(v.z);
    out[3] = static_cast<float>(v.w);
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(row + d0);
    const char4* v = reinterpret_cast<const char4*>(&raw);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      out[4 * e] = static_cast<float>(v[e].x);
      out[4 * e + 1] = static_cast<float>(v[e].y);
      out[4 * e + 2] = static_cast<float>(v[e].z);
      out[4 * e + 3] = static_cast<float>(v[e].w);
    }
  }
}

}  // namespace kvrows
