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
// where the tensor cores become the limit; int8 halves the bytes. The
// design (kv_rows.cuh) keeps the bytes in flight without threads spending
// registers or instructions on them: a producer warp streams 32-slot K / V
// tiles (and int8 scale spans) with 1-D bulk copies into a shared-memory
// ring on mbarriers, one stage per consumer warp (8 warps where 8 stages
// fit, e.g. an int8 cache at hd 128; else 4), and the consumers compute
// from shared memory, a whole tile per warp, lane s owning slot s (full
// dot products, one warp max per tile, P V with lanes over hd). S is split
// across a thread-block cluster of up to 8 CTAs (flash-decoding) when the
// grid is small: the grid is (nkv, B, splits), `splits` the fewest that
// give one CTA per SM, from B, nkv, S and the SM count on the host, never
// from the lengths on the card (1 at the serving shape, B = 8 x nkv = 32;
// 5 for one row of 32 heads). The splits merge through distributed shared
// memory inside the cluster, where the self term joins once: one launch,
// no scratch, no host synchronisation. A cache that a bulk copy cannot read (strided
// slots, S % 8 != 0, misaligned strides) takes the same kernel with the
// producer copying by plain loads (by shape, never on failure).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "kv_rows.cuh"

namespace {

using kvrows::Split;

template <typename T, int G, int EPL>
__global__ void __launch_bounds__(kvrows::MAX_THREADS) decode_split_kernel(Split<T> p) {
  kvrows::split_body<T, G, EPL, true>(p);
}

template <typename T, int G, int EPL>
int launch(Split<T> p, int B, cudaStream_t stream) {
  static int smem_set[16] = {0};
  kvrows::split_ring(kvrows::stage_bytes<T>(p.hd), p.ncw, p.stages);
  p.union_bytes = kvrows::align128(std::max(p.stages * kvrows::stage_bytes<T>(p.hd),
                                            kvrows::split_merge_bytes(G, p.hd, p.ncw)));
  const cudaError_t e = kvrows::choose_splits(p.nkv * B, p.S, p.splits);
  if (e != cudaSuccess) return (int)e;
  const int smem = kvrows::split_smem_bytes(G, p.hd, p.union_bytes, p.ncw);
  return kvrows::launch_cluster(decode_split_kernel<T, G, EPL>, p, dim3(p.nkv, B, p.splits),
                                (p.ncw + 1) * 32, p.splits, smem, stream, smem_set);
}

template <typename T, int G>
int launch_g(const Split<T>& p, int B, cudaStream_t stream) {
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
  Split<T> p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const T*>(k_cache) + layer_offset;
  p.v = static_cast<const T*>(v_cache) + layer_offset;
  p.ks = k_scale ? static_cast<const __nv_bfloat16*>(k_scale) + s_layer_offset : nullptr;
  p.vs = v_scale ? static_cast<const __nv_bfloat16*>(v_scale) + s_layer_offset : nullptr;
  p.k_cur = static_cast<const __nv_bfloat16*>(k_cur);
  p.v_cur = static_cast<const __nv_bfloat16*>(v_cur);
  p.lengths = lengths;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.C = 1; p.g = nh / nkv; p.nh = nh; p.nkv = nkv; p.hd = hd; p.S = S;
  p.q_sb = q_sb; p.q_sc = 0; p.q_sh = q_sh;
  p.c_sb = c_sb; p.c_sh = c_sh; p.c_ss = c_ss;
  p.s_sb = s_sb; p.s_sh = s_sh;
  p.cur_sb = cur_sb; p.cur_sh = cur_sh;
  p.scale = scale;
  p.bulk = kvrows::bulk_eligible(p.k, p.v, p.ks, p.vs, (int)sizeof(T), hd, S, c_sb, c_sh, c_ss,
                                 s_sb, s_sh);
  switch (p.g) {
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
  if (hd <= 0 || hd > kvrows::MAX_HD || hd % 8 != 0 || nkv <= 0 || nh % nkv != 0 || S < 0 ||
      (quantized && (k_scale == nullptr || v_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (B <= 0) return 0;
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
