// W4A16 matmuls for Hopper (sm_90a): the forward y = x @ dequant(W) and the
// activation gradient dx = dy @ dequant(W)^T, bf16 in, f32 accumulation,
// bf16 out.
//
// Replaces the Pallas kernels `_int4_matmul_kernel` / `int4_matmul` and
// `_int4_matmul_t_kernel` / `int4_matmul_t` in vlrlhf_tpu/ops/int4.py. Same
// arithmetic: each weight element is bf16(q * s) (a 4-bit code times a bf16
// group scale is exact in f32, so the rounding matches the JAX path's bf16
// product bit for bit) and the dot accumulates in f32. The block structure is
// not carried over: the Mosaic layout helpers (`_unpack_block`,
// `_expand_pair`, `_scale_blocks`) and the wrapper's split, zero-padded x
// copies have no counterpart here.
//
// Layout (the port's, vlrlhf_torch/ops/int4.py): packed (out, half_p) int8,
// the transpose of the JAX package's (half_p, out); byte (o, i) holds
// W[i, o] in its low nibble and W[i + in/2, o] in its high nibble; rows are
// padded to half_p = ceil(in/2 / 128) * 128 with zero bytes. Scales (out, S)
// bf16, group 64 along `in`: in-row i takes scale column i / 64 (so the high
// half's group g is column n_lo + g, n_lo = in / 128); S = 2 n_lo + (n_lo & 1).
// Both kernels walk only the n_lo real 64-byte column blocks of a packed row:
// the padding block (odd n_lo) is never read, so no x column past `in` is
// either.
//
// What bounds them on the H100:
// - int4_matmul_kernel at T <= 64 (decode, verify chunks) streams the weight once:
//   bytes-bound (4096 x 11008: 22.5 MB, 7 us at 3.35 TB/s). Each lane loads
//   16 contiguous packed bytes of one output column straight into registers
//   (one 16-byte load per column and 64-byte block, the warp's loads fully
//   used) and issues U blocks of loads before it computes, so enough bytes
//   are in flight. A thread-block cluster of up to 8 CTAs splits the n_lo
//   blocks so that each CTA issues all its loads in one batch (U blocks or
//   fewer); the f32 partials are summed in rank order through distributed
//   shared memory (deterministic, no scratch tensor, one launch). The bytes
//   are dequantized in registers into mma.sync B fragments: at these widths
//   the tensor cores idle and bytes bound the time. The contraction order
//   inside one m16n8k16 step is permuted
//   (slot 2tq+e <- k0 + 16tq + 4s + e, slot 2tq+8+e <- k0 + 16tq + 4s + 2 + e)
//   so that one 32-bit word of packed bytes is exactly a lane's two B
//   registers; the x fragments are loaded with the same permutation. Each
//   byte feeds the low-half product (x column i) and the high-half product
//   (x column in/2 + i).
// - At T > 64 (prefill, T = 2048 in the QLoRA step) the forward is bound by
//   operations (185 GFLOP per 4096 x 11008 linear at T = 2048), so
//   int4_matmul_wgmma_kernel is a warp-specialised wgmma GEMM: TMA brings x
//   and the packed tiles, a dequantizing warpgroup writes each weight tile
//   once per 256 rows into shared memory while two consumer warpgroups run
//   wgmma on the previous one (details at the kernel).
// - dx contracts over `out`, across packed rows, so the weight goes through
//   shared memory as a bf16 [out][in] tile per chunk of 64 packed rows x 64
//   bytes. It is bound by operations too (185 GFLOP at T = 2048), so
//   int4_matmul_t_wgmma_kernel is kernel 6's machinery with the operands
//   turned round: TMA brings dy and the packed tiles, a dequantizing
//   warpgroup writes each weight tile MN-major once per 256 rows, two
//   consumer warpgroups run wgmma on it (details at the kernel). One CTA
//   writes the dx columns blk*64.. of the low half and in/2 + blk*64.. of
//   the high half directly: no padding, no concatenation. Only the QLoRA
//   step calls it, at T = 2048; a small T takes the same kernel (a
//   128-row tile, TMA's zero fill past T).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::mma16816;
using hopper::pack_bf16;

constexpr int GROUP = 64;      // quantization group rows along `in`; packed bytes per block
constexpr int NTHREADS = 128;  // register-direct forward: 4 warps

struct Params {
  const __nv_bfloat16* a;      // x (T, in) or dy (T, out), row-major
  const int8_t* packed;        // (out, half_p)
  const __nv_bfloat16* scale;  // (out, S)
  __nv_bfloat16* c;            // y (T, out) or dx (T, in)
  int T, in, out, half_p, S;
};

// Four packed bytes (byte e = bits 8e..8e+7) -> bf16 pairs of the
// low-nibble weights (bytes 0,1 and 2,3 times slo) and the high-nibble ones
// (times shi); slo / shi hold the scale in both halves. No int -> float
// conversion (a quarter of the ALU rate on this card): a nibble n becomes
// the bf16 bits 0x4300 | (n ^ 8), which is exactly 128 + (code + 8);
// subtracting 136 in bf16 is exact and leaves the code, and one bf16
// multiply by the scale rounds the exact product once. So each weight is
// bf16(f32(q) * f32(s)), bit for bit the JAX path's (`_unpack_block`
// sign-extends the same codes).
__device__ inline uint32_t bits(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ inline __nv_bfloat162 as_bf162(uint32_t u) {
  return *reinterpret_cast<__nv_bfloat162*>(&u);
}
__device__ inline void dequant_word(uint32_t w, __nv_bfloat162 slo, __nv_bfloat162 shi,
                                    uint32_t& lo01, uint32_t& lo23, uint32_t& hi01,
                                    uint32_t& hi23) {
  const __nv_bfloat162 off = as_bf162(0x43084308u);  // 136, 136
  const uint32_t t01 = __byte_perm(w, 0, 0x4140);   // bytes 0 and 1 at bits 0-7 and 16-23
  const uint32_t t23 = __byte_perm(w, 0, 0x4342);   // bytes 2 and 3
  lo01 = bits(__hmul2(__hsub2(as_bf162((t01 & 0x000F000Fu) ^ 0x43084308u), off), slo));
  lo23 = bits(__hmul2(__hsub2(as_bf162((t23 & 0x000F000Fu) ^ 0x43084308u), off), slo));
  hi01 = bits(__hmul2(__hsub2(as_bf162(((t01 >> 4) & 0x000F000Fu) ^ 0x43084308u), off), shi));
  hi23 = bits(__hmul2(__hsub2(as_bf162(((t23 >> 4) & 0x000F000Fu) ^ 0x43084308u), off), shi));
}

__device__ inline uint32_t word(const uint4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// Forward: CTA = 16*MT rows x 32*NT columns; warp w owns columns
// [w*8*NT, (w+1)*8*NT) of the tile and all its rows. One iteration of the
// inner loop is one 64-byte packed block j: 64 low-half and 64 high-half
// contraction rows, 4 mma k-steps of 16 for each half.

template <int MT, int NT, int U>
__global__ void __launch_bounds__(NTHREADS) int4_matmul_kernel(Params p) {
  namespace cg = cooperative_groups;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int n_base = blockIdx.x * (32 * NT) + warp * 8 * NT;
  const int m0 = blockIdx.y * (16 * MT);
  const int half = p.in / 2;
  const int n_lo = p.in / 128;

  const int8_t* wcol[NT];
  const __nv_bfloat16* scol[NT];
  bool col_ok[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int n = n_base + t * 8 + g;
    col_ok[t] = n < p.out;
    const long long nn = col_ok[t] ? n : 0;
    wcol[t] = p.packed + nn * p.half_p + 16 * tq;
    scol[t] = p.scale + nn * p.S;
  }
  const __nv_bfloat16* xrow[MT][2];
  bool row_ok[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + mt * 16 + g + 8 * r;
      row_ok[mt][r] = m < p.T;
      xrow[mt][r] = p.a + (long long)(row_ok[mt][r] ? m : 0) * p.in + 16 * tq;
    }
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int t = 0; t < NT; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  // this CTA's share of the blocks: the cluster (gridDim.z CTAs along z)
  // splits the contraction, each CTA a contiguous run
  const int per = (n_lo + gridDim.z - 1) / gridDim.z;
  const int jb = blockIdx.z * per;
  const int je = min(n_lo, jb + per);
  for (int j0 = jb; j0 < je; j0 += U) {
    // issue every load of U blocks before any compute
    uint4 raw[U][NT];
    __nv_bfloat162 slo[U][NT], shi[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const bool ok = col_ok[t] && j < je;
        raw[u][t] = ok ? __ldg(reinterpret_cast<const uint4*>(wcol[t] + j * GROUP))
                       : make_uint4(0u, 0u, 0u, 0u);
        slo[u][t] = __bfloat162bfloat162(ok ? scol[t][j] : __float2bfloat16(0.f));
        shi[u][t] = __bfloat162bfloat162(ok ? scol[t][n_lo + j] : __float2bfloat16(0.f));
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j >= je) break;  // uniform across the CTA
      uint32_t blo[4][NT][2], bhi[4][NT][2];  // B fragments of the 4 k16 steps
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          dequant_word(word(raw[u][t], s), slo[u][t], shi[u][t], blo[s][t][0], blo[s][t][1],
                       bhi[s][t][0], bhi[s][t][1]);
        }
      }
      const int kc = j * GROUP;  // + 16 tq is in xrow
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        // a lane's x columns of all 4 steps are 16 contiguous bf16: two
        // 16-byte loads per row and half (step s takes words 2s, 2s + 1)
        uint4 xl[2][2], xh[2][2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
          const uint4* lo = reinterpret_cast<const uint4*>(xrow[mt][r] + kc);
          const uint4* hi = reinterpret_cast<const uint4*>(xrow[mt][r] + half + kc);
          xl[r][0] = row_ok[mt][r] ? __ldg(lo) : zero;
          xl[r][1] = row_ok[mt][r] ? __ldg(lo + 1) : zero;
          xh[r][0] = row_ok[mt][r] ? __ldg(hi) : zero;
          xh[r][1] = row_ok[mt][r] ? __ldg(hi + 1) : zero;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int w0 = 2 * (s % 2);
          const uint32_t alo[4] = {word(xl[0][s / 2], w0), word(xl[1][s / 2], w0),
                                   word(xl[0][s / 2], w0 + 1), word(xl[1][s / 2], w0 + 1)};
          const uint32_t ahi[4] = {word(xh[0][s / 2], w0), word(xh[1][s / 2], w0),
                                   word(xh[0][s / 2], w0 + 1), word(xh[1][s / 2], w0 + 1)};
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            mma16816(acc[mt][t], alo, blo[s][t][0], blo[s][t][1]);
            mma16816(acc[mt][t], ahi, bhi[s][t][0], bhi[s][t][1]);
          }
        }
      }
    }
  }

  if (gridDim.z > 1) {
    // sum the cluster's f32 partials through distributed shared memory, in
    // rank order (deterministic); rank 0 writes the tile
    __shared__ float part[MT * NT * 4][NTHREADS];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int t = 0; t < NT; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[(mt * NT + t) * 4 + e][threadIdx.x] = acc[mt][t][e];
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (cluster.block_rank() == 0) {
      for (unsigned r = 1; r < cluster.num_blocks(); ++r) {
        const float* other = cluster.map_shared_rank(&part[0][0], r);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int t = 0; t < NT; ++t)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[mt][t][e] += other[((mt * NT + t) * 4 + e) * NTHREADS + threadIdx.x];
      }
    }
    cluster.sync();  // the others keep their shared memory until rank 0 has read it
    if (cluster.block_rank() != 0) return;
  }

  const bool pairs = (p.out % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + mt * 16 + g + 8 * r;
      if (m >= p.T) continue;
      __nv_bfloat16* yrow = p.c + (long long)m * p.out;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int n = n_base + t * 8 + 2 * tq;
        const float v0 = acc[mt][t][2 * r], v1 = acc[mt][t][2 * r + 1];
        if (pairs && n + 1 < p.out) {
          *reinterpret_cast<__nv_bfloat162*>(yrow + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < p.out) yrow[n] = __float2bfloat16_rn(v0);
          if (n + 1 < p.out) yrow[n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward at T > 64 (prefill, the QLoRA step): a warp-specialised wgmma GEMM.
// CTA = 256 (or 128) rows x 128 output columns, three warpgroups:
// - warpgroup 0 dequantizes (setmaxnreg gives its registers away): per
//   64-byte packed block j, TMA brings the 128 x 64-byte packed tile into a
//   ring of RST stages (running up to RST blocks ahead); each of its 128
//   threads turns one weight row's 64 bytes into bf16 in the low-half
//   (columns j*64..) and high-half (in/2 + j*64..) weight tiles of stage
//   j % GST, written K-major in the 128-byte swizzle that wgmma reads. Its
//   thread 0 also issues the stage's TMA loads of the two x tiles (256 rows
//   x 64 columns each, swizzled by TMA) and the packed tiles;
// - warpgroups 1 and 2 own 128 (or 64) rows each: per block, 2 halves x 4
//   k16 steps x 2 (or 1) m64 tiles of wgmma m64n128k16 (x as A, the weight as B, both from
//   shared memory), one commit group per block; the previous block's group
//   retires while this one runs, and then frees its stage.
// Each dequantized weight feeds 256 rows (T/256 dequantizations per weight
// per launch; 128-row CTAs where they fill the last wave better), and
// dequantization overlaps the tensor cores. The epilogue
// goes through the warpgroup's own x rows of stage 0 (swizzled, no bank
// conflicts) to coalesced 16-byte stores that mask ragged T and `out`.

constexpr int GBN = 128;               // output columns per CTA
constexpr int GST = 2;                 // x / weight stages
constexpr int RST = 4;                 // packed-tile stages
constexpr int GW_BYTES = GBN * 128;    // one half's weight tile
constexpr int GRAW = GBN * GROUP;      // one packed tile, 8 KB

// Shared-memory plan for WM m64 row tiles per consumer warpgroup (CTA rows
// 128 * WM): stage s holds the low / high x tiles and the low / high weight
// tiles; then the packed-tile ring and the barriers.
template <int WM>
struct GPlan {
  static constexpr int BM = 128 * WM;                       // rows per CTA
  static constexpr int X_BYTES = BM * 128;                  // one half's x tile
  static constexpr int STAGE = 2 * X_BYTES + 2 * GW_BYTES;  // 96 KB at WM = 2
  static constexpr int RAW_OFF = GST * STAGE;
  static constexpr int BAR_OFF = RAW_OFF + RST * GRAW;      // full[GST], empty[GST], raw[RST]
  static constexpr int SMEM = BAR_OFF + (2 * GST + RST) * 8 + 1024;  // + alignment slack
};
constexpr int GTHREADS = 384;

template <int ID>
__device__ inline void named_sync() {  // barrier ID among 128 threads
  asm volatile("bar.sync %0, %1;\n" ::"n"(ID), "n"(128) : "memory");
}

template <int WM>
__global__ void __launch_bounds__(GTHREADS, 1)
    int4_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_w, const Params p) {
  using namespace hopper;
  using L = GPlan<WM>;
  constexpr int GX_BYTES = L::X_BYTES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sRaw = smem + L::RAW_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + GST;
  uint64_t* raw_full = empty + GST;

  const int n0 = blockIdx.x * GBN;
  const int m0 = blockIdx.y * L::BM;
  const int half = p.in / 2;
  const int n_lo = p.in / 128;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform to ptxas
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < GST; ++s) {
      mbar_init(&full[s], 1 + 128);  // x bytes + the 128 dequantizing threads
      mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    for (int s = 0; s < RST; ++s) mbar_init(&raw_full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- dequantization (and the TMA issue) ----------------
    setmaxnreg_dec<56>();
    if (t == 0) {
      for (int j = 0; j < min(RST, n_lo); ++j) {
        mbar_arrive_expect_tx(&raw_full[j], GRAW);
        tma_load_2d(sRaw + j * GRAW, &tm_w, &raw_full[j], j * GROUP, n0);
      }
    }
    const int row = n0 + t;  // this thread's weight row
    const bool row_ok = row < p.out;
    const __nv_bfloat16* srow = p.scale + (long long)(row_ok ? row : 0) * p.S;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    __nv_bfloat162 slo = __bfloat162bfloat162(row_ok ? srow[0] : zero);
    __nv_bfloat162 shi = __bfloat162bfloat162(row_ok ? srow[n_lo] : zero);
    for (int j = 0; j < n_lo; ++j) {
      const int st = j % GST, rs = j % RST;
      unsigned char* stage = smem + st * L::STAGE;
      mbar_wait(&empty[st], ((j / GST) & 1) ^ 1);
      if (t == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * GX_BYTES);
        tma_load_2d(stage, &tm_x, &full[st], j * GROUP, m0);
        tma_load_2d(stage + GX_BYTES, &tm_x, &full[st], half + j * GROUP, m0);
      }
      // the next block's scales fly while this one is dequantized
      const bool more = row_ok && j + 1 < n_lo;
      const __nv_bfloat162 nlo = __bfloat162bfloat162(more ? srow[j + 1] : zero);
      const __nv_bfloat162 nhi = __bfloat162bfloat162(more ? srow[n_lo + j + 1] : zero);
      mbar_wait(&raw_full[rs], (j / RST) & 1);
      const unsigned char* raw = sRaw + rs * GRAW + t * GROUP;
      unsigned char* wlo = stage + 2 * GX_BYTES + t * 128;
      unsigned char* whi = wlo + GW_BYTES;
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int q = (qq + t) & 3;  // rotated: the warp's 16-byte reads hit distinct banks
        const uint4 w = *reinterpret_cast<const uint4*>(raw + 16 * q);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // 8 codes -> one 16-byte chunk per half
          uint32_t lo[4], hi[4];
          dequant_word(word(w, 2 * h2), slo, shi, lo[0], lo[1], hi[0], hi[1]);
          dequant_word(word(w, 2 * h2 + 1), slo, shi, lo[2], lo[3], hi[2], hi[3]);
          const int off = (((2 * q + h2) ^ (t & 7)) * 16);  // the 128-byte swizzle
          *reinterpret_cast<uint4*>(wlo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(whi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
      fence_proxy_async();  // the weight tiles are read by wgmma (the async proxy)
      mbar_arrive(&full[st]);
      named_sync<1>();  // every thread is done with packed stage rs
      if (t == 0 && j + RST < n_lo) {
        mbar_arrive_expect_tx(&raw_full[rs], GRAW);
        tma_load_2d(sRaw + rs * GRAW, &tm_w, &raw_full[rs], (j + RST) * GROUP, n0);
      }
      slo = nlo;
      shi = nhi;
    }
    return;
  }

  // ---------------- consumers: 64 * WM rows each ----------------
  setmaxnreg_inc<224>();
  const int c = wg - 1;
  const int warp = t / 32;
  const int lane = t % 32;
  float acc[WM][64];  // written first by wgmma (scale_d = 0): no other code defines it
  for (int j = 0; j < n_lo; ++j) {
    const int st = j % GST;
    unsigned char* stage = smem + st * L::STAGE;
    mbar_wait(&full[st], (j / GST) & 1);
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint64_t dx = desc_sw128(stage + h * GX_BYTES + c * WM * 64 * 128, 16, 1024);
      const uint64_t dw = desc_sw128(stage + 2 * GX_BYTES + h * GW_BYTES, 16, 1024);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int mt = 0; mt < WM; ++mt) {
          wgmma_ss<GBN>(acc[mt], dx + ((mt * 64 * 128 + ks * 32) >> 4), dw + ((ks * 32) >> 4),
                        j > 0 || h > 0 || ks > 0);
        }
      }
    }
    wgmma_commit();
    if (j > 0) {
      wgmma_wait<1>();  // block j-1 is done: free its stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(j - 1) % GST]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_operand(acc[mt][i]);

  // epilogue: this warpgroup's rows of stage 0's x tiles (every load has
  // landed and only this warpgroup reads these rows) hold its 64 * WM x 128
  // bf16 output, columns 0-63 in the low tile and 64-127 in the high one
  unsigned char* e0 = smem + c * WM * 64 * 128;
  unsigned char* e1 = e0 + GX_BYTES;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = mt * 64 + warp * 16 + g + 8 * r;
#pragma unroll
      for (int jt = 0; jt < 16; ++jt) {
        const int off = rr * 128 + (((jt % 8) ^ (rr & 7)) * 16) + tq * 4;
        *reinterpret_cast<uint32_t*>((jt < 8 ? e0 : e1) + off) =
            pack_bf16(acc[mt][4 * jt + 2 * r], acc[mt][4 * jt + 2 * r + 1]);
      }
    }
  }
  if (c == 0) {
    named_sync<2>();
  } else {
    named_sync<3>();
  }
  const bool vec = (p.out % 8) == 0;
#pragma unroll 4
  for (int i = 0; i < 8 * WM; ++i) {
    const int idx = t + 128 * i;
    const int rr = idx / 16, ch = idx % 16;
    const int m = m0 + c * WM * 64 + rr;
    const int n = n0 + ch * 8;
    if (m >= p.T || n >= p.out) continue;
    const unsigned char* src = (ch < 8 ? e0 : e1) + rr * 128 + (((ch % 8) ^ (rr & 7)) * 16);
    __nv_bfloat16* dst = p.c + (long long)m * p.out + n;
    if (vec && n + 8 <= p.out) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(src);
      for (int k = 0; k < 8 && n + k < p.out; ++k) dst[k] = vv[k];
    }
  }
}

template <int WM>
int launch_fwd_wgmma(const Params& p, cudaStream_t stream) {
  using L = GPlan<WM>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_wgmma_kernel<WM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // x (T, in) bf16, 64-column boxes of BM rows; packed (out, half_p) bytes,
  // 64-byte boxes of 128 rows (plain layout: the dequantizing threads read it)
  CUtensorMap tm_x, tm_w;
  const uint64_t xdims[2] = {(uint64_t)p.in, (uint64_t)p.T};
  const uint64_t xstride[1] = {(uint64_t)p.in * 2};
  const uint32_t xbox[2] = {GROUP, L::BM};
  int err = hopper::encode_tensor_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.a, xdims,
                                      xstride, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t wdims[2] = {(uint64_t)p.half_p, (uint64_t)p.out};
  const uint64_t wstride[1] = {(uint64_t)p.half_p};
  const uint32_t wbox[2] = {GROUP, GBN};
  if (!err) {
    err = hopper::encode_tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.packed, wdims,
                                    wstride, wbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err) return err;
  dim3 grid((p.out + GBN - 1) / GBN, (p.T + L::BM - 1) / L::BM);
  int4_matmul_wgmma_kernel<WM><<<grid, GTHREADS, L::SMEM, stream>>>(tm_x, tm_w, p);
  return (int)cudaGetLastError();
}

// 256-row CTAs dequantize each weight tile half as often as 128-row ones;
// the smaller tile wins where it fills the card's last wave better.
// Estimated time in waves of one CTA per SM, a 128-row CTA at 0.55 of a
// 256-row one. Returns 2 or 1 (the WM to launch), or -cudaError.
int rows_by_waves(long long cols, int T) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return -(int)e;
  }
  const long long waves256 = (cols * ((T + 255) / 256) + sms - 1) / sms;
  const long long waves128 = (cols * ((T + 127) / 128) + sms - 1) / sms;
  return 100 * waves256 <= 55 * waves128 ? 2 : 1;
}

int launch_fwd_wgmma_by_waves(const Params& p, cudaStream_t stream) {
  const int wm = rows_by_waves((p.out + GBN - 1) / GBN, p.T);
  if (wm < 0) return -wm;
  return wm == 2 ? launch_fwd_wgmma<2>(p, stream) : launch_fwd_wgmma<1>(p, stream);
}

// ---------------------------------------------------------------------------
// Backward (dx): a warp-specialised wgmma GEMM
// that contracts over `out`. CTA = 256 (or 128) dx rows x one 64-byte packed
// column block blk, i.e. dx columns blk*64.. of the low half and
// in/2 + blk*64.. of the high half (128 columns), three warpgroups:
// - warpgroup 0 dequantizes (setmaxnreg gives its registers away): per
//   chunk c of 64 `out` rows, TMA brings the 64 x 64-byte packed tile into a
//   ring of TRST stages; each pair of its threads turns one weight row's 64
//   bytes into bf16 rows of the low and the high weight tile of stage
//   c % TST, [64 out rows][64 in columns] each, MN-major for wgmma's B (the
//   layout the flash forward reads V in: k16 steps by two atoms, the high
//   tile one LBO after the low one, so one m64n128 wgmma covers both halves).
//   A row's scales are one per half, scale[o, blk] and scale[o, n_lo + blk].
//   Its thread 0 also issues the stage's dy tile (BM rows x 64 out columns,
//   K-major, swizzled by TMA);
// - warpgroups 1 and 2 own 64 * WM rows each: per chunk, 4 k16 steps x WM
//   m64 tiles of wgmma m64n128k16 (dy as A, the weight as B, both from
//   shared memory), one commit group per chunk; the previous chunk's group
//   retires while this one runs, and then frees its stage.
// Each weight is dequantized T / BM times per launch (8 at T = 2048) and
// the dequantization overlaps the tensor cores. A ragged `out` reads TMA's
// zero fill for dy and the packed bytes (a zero scale beside them); ragged
// T is masked at the stores. The
// epilogue goes through the warpgroup's own dy rows of stages 0 and 1 to
// coalesced 16-byte stores, written in place in both halves of dx.

constexpr int TST = 4;                // dy / weight stages
constexpr int TRST = 4;               // packed-tile stages
constexpr int TBK = 64;               // out rows per chunk
constexpr int TW_BYTES = TBK * 128;   // one half's bf16 weight tile, 8 KB
constexpr int TRAW = TBK * GROUP;     // one packed tile, 4 KB

template <int WM>
struct TPlan {
  static constexpr int BM = 128 * WM;                    // dx rows per CTA
  static constexpr int DY_BYTES = BM * 128;              // one dy tile
  static constexpr int STAGE = DY_BYTES + 2 * TW_BYTES;  // 48 KB at WM = 2
  static constexpr int RAW_OFF = TST * STAGE;
  static constexpr int BAR_OFF = RAW_OFF + TRST * TRAW;  // full[TST], empty[TST], raw[TRST]
  static constexpr int SMEM = BAR_OFF + (2 * TST + TRST) * 8 + 1024;  // + alignment slack
};

template <int WM>
__global__ void __launch_bounds__(GTHREADS, 1)
    int4_matmul_t_wgmma_kernel(const __grid_constant__ CUtensorMap tm_dy,
                               const __grid_constant__ CUtensorMap tm_w, const Params p) {
  using namespace hopper;
  using L = TPlan<WM>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* sRaw = smem + L::RAW_OFF;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + TST;
  uint64_t* raw_full = empty + TST;

  const int blk = blockIdx.x;
  const int m0 = blockIdx.y * L::BM;
  const int half = p.in / 2;
  const int n_lo = p.in / 128;
  const int n_chunks = (p.out + TBK - 1) / TBK;
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warp-uniform to ptxas
  const int t = threadIdx.x % 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TST; ++s) {
      mbar_init(&full[s], 1 + 128);  // dy bytes + the 128 dequantizing threads
      mbar_init(&empty[s], 8);       // one arrival per consumer warp
    }
    for (int s = 0; s < TRST; ++s) mbar_init(&raw_full[s], 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- dequantization (and the TMA issue) ----------------
    setmaxnreg_dec<56>();
    if (t == 0) {
      for (int c = 0; c < min(TRST, n_chunks); ++c) {
        mbar_arrive_expect_tx(&raw_full[c], TRAW);
        tma_load_2d(sRaw + c * TRAW, &tm_w, &raw_full[c], blk * GROUP, c * TBK);
      }
    }
    const int r = t / 2;     // this thread's weight row within a chunk
    const int part = t % 2;  // and its 32 of the row's 64 bytes
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    auto scales = [&](int c, __nv_bfloat162& lo, __nv_bfloat162& hi) {
      const int o = c * TBK + r;
      const bool ok = o < p.out;  // past `out`: a zero scale on TMA's zero bytes
      const __nv_bfloat16* srow = p.scale + (long long)(ok ? o : 0) * p.S;
      lo = __bfloat162bfloat162(ok ? srow[blk] : zero);
      hi = __bfloat162bfloat162(ok ? srow[n_lo + blk] : zero);
    };
    __nv_bfloat162 slo, shi;
    scales(0, slo, shi);
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % TST, rs = c % TRST;
      unsigned char* stage = smem + st * L::STAGE;
      mbar_wait(&empty[st], ((c / TST) & 1) ^ 1);
      if (t == 0) {
        mbar_arrive_expect_tx(&full[st], L::DY_BYTES);
        tma_load_2d(stage, &tm_dy, &full[st], c * TBK, m0);
      }
      __nv_bfloat162 nlo, nhi;  // the next chunk's scales fly while this one is dequantized
      scales(c + 1, nlo, nhi);
      mbar_wait(&raw_full[rs], (c / TRST) & 1);
      const unsigned char* raw = sRaw + rs * TRAW + r * GROUP + part * 32;
      unsigned char* wlo = stage + L::DY_BYTES + r * 128;
      unsigned char* whi = wlo + TW_BYTES;
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const int q = 2 * part + qq;  // 16-byte piece of the packed row
        const uint4 w = *reinterpret_cast<const uint4*>(raw + 16 * qq);
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {  // 8 codes -> one 16-byte chunk per half
          uint32_t lo[4], hi[4];
          dequant_word(word(w, 2 * h2), slo, shi, lo[0], lo[1], hi[0], hi[1]);
          dequant_word(word(w, 2 * h2 + 1), slo, shi, lo[2], lo[3], hi[2], hi[3]);
          const int off = (((2 * q + h2) ^ (r & 7)) * 16);  // the 128-byte swizzle
          *reinterpret_cast<uint4*>(wlo + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
          *reinterpret_cast<uint4*>(whi + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        }
      }
      fence_proxy_async();  // the weight tiles are read by wgmma (the async proxy)
      mbar_arrive(&full[st]);
      named_sync<1>();  // every thread is done with packed stage rs
      if (t == 0 && c + TRST < n_chunks) {
        mbar_arrive_expect_tx(&raw_full[rs], TRAW);
        tma_load_2d(sRaw + rs * TRAW, &tm_w, &raw_full[rs], blk * GROUP, (c + TRST) * TBK);
      }
      slo = nlo;
      shi = nhi;
    }
    return;
  }

  // ---------------- consumers: 64 * WM rows each ----------------
  setmaxnreg_inc<224>();
  const int cw = wg - 1;
  const int warp = t / 32;
  const int lane = t % 32;
  float acc[WM][64];  // written first by wgmma (scale_d = 0): no other code defines it
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % TST;
    unsigned char* stage = smem + st * L::STAGE;
    mbar_wait(&full[st], (c / TST) & 1);
    wgmma_fence();
    const uint64_t da = desc_sw128(stage + cw * WM * 64 * 128, 16, 1024);
    const uint64_t db = desc_sw128(stage + L::DY_BYTES, TW_BYTES, 1024);
#pragma unroll
    for (int ks = 0; ks < TBK / 16; ++ks) {
#pragma unroll
      for (int mt = 0; mt < WM; ++mt) {
        wgmma_ss_tb<128>(acc[mt], da + ((mt * 64 * 128 + ks * 32) >> 4),
                         db + ((ks * 2048) >> 4), c > 0 || ks > 0);
      }
    }
    wgmma_commit();
    if (c > 0) {
      wgmma_wait<1>();  // chunk c-1 is done: free its stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[(c - 1) % TST]);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int mt = 0; mt < WM; ++mt)
#pragma unroll
    for (int i = 0; i < 64; ++i) hopper::fence_operand(acc[mt][i]);

  // epilogue: this warpgroup's rows of the dy tiles of stages 0 and 1 (every
  // load has landed and only this warpgroup reads these rows) hold its
  // 64 * WM x 128 bf16 output, the low-half columns in stage 0's tile and
  // the high-half ones in stage 1's
  unsigned char* e0 = smem + cw * WM * 64 * 128;
  unsigned char* e1 = e0 + L::STAGE;
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int mt = 0; mt < WM; ++mt) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      const int rr = mt * 64 + warp * 16 + g + 8 * rh;
#pragma unroll
      for (int jt = 0; jt < 16; ++jt) {
        const int off = rr * 128 + (((jt % 8) ^ (rr & 7)) * 16) + tq * 4;
        *reinterpret_cast<uint32_t*>((jt < 8 ? e0 : e1) + off) =
            pack_bf16(acc[mt][4 * jt + 2 * rh], acc[mt][4 * jt + 2 * rh + 1]);
      }
    }
  }
  if (cw == 0) {
    named_sync<2>();
  } else {
    named_sync<3>();
  }
#pragma unroll 4
  for (int i = 0; i < 8 * WM; ++i) {
    const int idx = t + 128 * i;
    const int rr = idx / 16, ch = idx % 16;
    const int m = m0 + cw * WM * 64 + rr;
    if (m >= p.T) continue;
    const unsigned char* src = (ch < 8 ? e0 : e1) + rr * 128 + (((ch % 8) ^ (rr & 7)) * 16);
    const int n = (ch < 8 ? 0 : half) + blk * GROUP + (ch % 8) * 8;
    *reinterpret_cast<uint4*>(p.c + (long long)m * p.in + n) =
        *reinterpret_cast<const uint4*>(src);
  }
}

template <int WM>
int launch_t_wgmma(const Params& p, cudaStream_t stream) {
  using L = TPlan<WM>;
  static bool configured = false;  // per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_t_wgmma_kernel<WM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // dy (T, out) bf16, 64-column boxes of BM rows; packed (out, half_p)
  // bytes, 64-byte boxes of 64 rows (plain layout: the dequantizing threads
  // read it)
  CUtensorMap tm_dy, tm_w;
  const uint64_t ddims[2] = {(uint64_t)p.out, (uint64_t)p.T};
  const uint64_t dstride[1] = {(uint64_t)p.out * 2};
  const uint32_t dbox[2] = {TBK, L::BM};
  int err = hopper::encode_tensor_map(&tm_dy, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, p.a, ddims,
                                      dstride, dbox, CU_TENSOR_MAP_SWIZZLE_128B);
  const uint64_t wdims[2] = {(uint64_t)p.half_p, (uint64_t)p.out};
  const uint64_t wstride[1] = {(uint64_t)p.half_p};
  const uint32_t wbox[2] = {GROUP, TBK};
  if (!err) {
    err = hopper::encode_tensor_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p.packed, wdims,
                                    wstride, wbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  }
  if (err) return err;
  dim3 grid(p.in / 128, (p.T + L::BM - 1) / L::BM);
  int4_matmul_t_wgmma_kernel<WM><<<grid, GTHREADS, L::SMEM, stream>>>(tm_dy, tm_w, p);
  return (int)cudaGetLastError();
}

template <int MT, int NT, int U>
int launch_fwd(const Params& p, cudaStream_t stream) {
  static int capacity = 0;  // CTAs of this instantiation resident at once on the card
  if (capacity == 0) {
    int per_sm = 0, sms = 0, dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, int4_matmul_kernel<MT, NT, U>,
                                                        NTHREADS, 0);
    }
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    capacity = per_sm * sms;
  }
  // a cluster of 1-8 CTAs along z splits the n_lo blocks while a CTA would
  // issue more than U blocks of loads and the grid still fits in one wave
  const dim3 tiles((p.out + 32 * NT - 1) / (32 * NT), (p.T + 16 * MT - 1) / (16 * MT));
  const int n_lo = p.in / 128;
  unsigned cs = 1;
  while (cs < 8 && (n_lo + (int)cs - 1) / (int)cs > U &&
         (int)(tiles.x * tiles.y * 2 * cs) <= capacity) {
    cs *= 2;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles.x, tiles.y, cs);
  cfg.blockDim = dim3(NTHREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cs;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, int4_matmul_kernel<MT, NT, U>, p);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

bool valid_shape(int T, int in, int out, int half_p, int S) {
  const int n_lo = in / 128;
  return T >= 0 && in > 0 && in % 128 == 0 && out > 0 && half_p % 128 == 0 &&
         half_p >= in / 2 && S == 2 * n_lo + (n_lo & 1);
}

Params make_params(const void* a, const void* packed, const void* scale, void* c, int T,
                   int in, int out, int half_p, int S) {
  Params p;
  p.a = static_cast<const __nv_bfloat16*>(a);
  p.packed = static_cast<const int8_t*>(packed);
  p.scale = static_cast<const __nv_bfloat16*>(scale);
  p.c = static_cast<__nv_bfloat16*>(c);
  p.T = T; p.in = in; p.out = out; p.half_p = half_p; p.S = S;
  return p;
}

}  // namespace

// y (T, out) = x (T, in) @ dequant(packed, scale); all row-major, bf16 x / y.
extern "C" int int4_matmul(const void* x, const void* packed, const void* scale, void* y,
                           int T, int in, int out, int half_p, int S, void* stream) {
  if (!valid_shape(T, in, out, half_p, S)) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const Params p = make_params(x, packed, scale, y, T, in, out, half_p, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // decode and verify shapes stream the weight: register-direct CTAs of 32
  // or 64 columns with the contraction split across a cluster (at T <= 16
  // two column tiles per warp halve the x loads per weight byte); larger T
  // is the wgmma GEMM
  if (T <= 16) return launch_fwd<1, 2, 4>(p, st);
  if (T <= 32) return launch_fwd<2, 1, 8>(p, st);
  if (T <= 64) return launch_fwd<4, 2, 4>(p, st);
  return launch_fwd_wgmma_by_waves(p, st);
}

// dx (T, in) = dy (T, out) @ dequant(packed, scale)^T; out % 8 == 0.
extern "C" int int4_matmul_t(const void* dy, const void* packed, const void* scale, void* dx,
                             int T, int in, int out, int half_p, int S, void* stream) {
  if (!valid_shape(T, in, out, half_p, S) || out % 8 != 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const Params p = make_params(dy, packed, scale, dx, T, in, out, half_p, S);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 256- or 128-row CTAs by the wave estimate (128 at T <= 128)
  const int wm = rows_by_waves(in / 128, T);
  if (wm < 0) return -wm;
  return wm == 2 ? launch_t_wgmma<2>(p, st) : launch_t_wgmma<1>(p, st);
}
