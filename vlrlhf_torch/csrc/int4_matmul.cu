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
//   are in flight. The bytes are dequantized in registers into mma.sync
//   B fragments. The contraction order inside one m16n8k16 step is permuted
//   (slot 2tq+e <- k0 + 16tq + 4s + e, slot 2tq+8+e <- k0 + 16tq + 4s + 2 + e)
//   so that one 32-bit word of packed bytes is exactly a lane's two B
//   registers; the x fragments are loaded with the same permutation. Each
//   byte feeds the low-half product (x column i) and the high-half product
//   (x column in/2 + i).
// - At T > 64 (prefill, T = 2048 in the QLoRA step) the forward is bound by
//   operations (185 GFLOP per 4096 x 11008 linear at T = 2048), so
//   int4_matmul_kernel_tiled dequantizes each 128 x 64-byte packed tile once
//   into shared memory for 128 rows and runs a tiled mma.sync GEMM with
//   ldmatrix on both operands (8 warps, warp tile 64 x 32, two CTAs per
//   SM); the register-direct kernel would re-dequantize every weight per 64
//   rows and stream x through L1 for each warp.
// - int4_matmul_t_kernel contracts over `out`, across packed rows, so the
//   weight goes through shared memory: each chunk of 64 packed rows x 64
//   bytes is dequantized once into a bf16 [out][in] tile that
//   ldmatrix.trans reads as the B operand of 128 dx rows (same tiling as
//   the tiled forward). One CTA writes the dx columns blk*64.. of the low
//   half and in/2 + blk*64.. of the high half directly: no padding, no
//   concatenation.
// wgmma with TMA, larger tiles and a split-K decode variant are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int GROUP = 64;      // quantization group rows along `in`; packed bytes per block
constexpr int NTHREADS = 128;  // register-direct forward: 4 warps
constexpr int FTHREADS = 256;  // tiled kernels: 8 warps

struct Params {
  const __nv_bfloat16* a;      // x (T, in) or dy (T, out), row-major
  const int8_t* packed;        // (out, half_p)
  const __nv_bfloat16* scale;  // (out, S)
  __nv_bfloat16* c;            // y (T, out) or dx (T, in)
  int T, in, out, half_p, S;
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

// Four packed bytes (byte e = bits 8e..8e+7) -> bf16 pairs of the low-nibble
// weights (bytes 0,1 and 2,3 times slo) and the high-nibble ones (times
// shi). Codes sign-extend through int32 shifts, as `_unpack_block` does;
// q * s is exact in f32 and rounds to bf16 once.
__device__ inline void dequant_word(uint32_t w, float slo, float shi, uint32_t& lo01,
                                    uint32_t& lo23, uint32_t& hi01, uint32_t& hi23) {
  const int l0 = static_cast<int>(w << 28) >> 28, l1 = static_cast<int>(w << 20) >> 28;
  const int l2 = static_cast<int>(w << 12) >> 28, l3 = static_cast<int>(w << 4) >> 28;
  const int h0 = static_cast<int>(w << 24) >> 28, h1 = static_cast<int>(w << 16) >> 28;
  const int h2 = static_cast<int>(w << 8) >> 28, h3 = static_cast<int>(w) >> 28;
  lo01 = pack_bf16(static_cast<float>(l0) * slo, static_cast<float>(l1) * slo);
  lo23 = pack_bf16(static_cast<float>(l2) * slo, static_cast<float>(l3) * slo);
  hi01 = pack_bf16(static_cast<float>(h0) * shi, static_cast<float>(h1) * shi);
  hi23 = pack_bf16(static_cast<float>(h2) * shi, static_cast<float>(h3) * shi);
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

  for (int j0 = 0; j0 < n_lo; j0 += U) {
    // issue every load of U blocks before any compute
    uint4 raw[U][NT];
    float slo[U][NT], shi[U][NT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const bool ok = col_ok[t] && j < n_lo;
        raw[u][t] = ok ? __ldg(reinterpret_cast<const uint4*>(wcol[t] + j * GROUP))
                       : make_uint4(0u, 0u, 0u, 0u);
        slo[u][t] = ok ? __bfloat162float(scol[t][j]) : 0.f;
        shi[u][t] = ok ? __bfloat162float(scol[t][n_lo + j]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + u;
      if (j >= n_lo) break;  // uniform across the CTA
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t blo[NT][2], bhi[NT][2];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          dequant_word(word(raw[u][t], s), slo[u][t], shi[u][t], blo[t][0], blo[t][1],
                       bhi[t][0], bhi[t][1]);
        }
        const int kc = j * GROUP + 4 * s;  // + 16 tq is in xrow
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          uint2 xl[2], xh[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            xl[r] = row_ok[mt][r] ? __ldg(reinterpret_cast<const uint2*>(xrow[mt][r] + kc))
                                  : make_uint2(0u, 0u);
            xh[r] = row_ok[mt][r] ? __ldg(reinterpret_cast<const uint2*>(xrow[mt][r] + half + kc))
                                  : make_uint2(0u, 0u);
          }
          const uint32_t alo[4] = {xl[0].x, xl[1].x, xl[0].y, xl[1].y};
          const uint32_t ahi[4] = {xh[0].x, xh[1].x, xh[0].y, xh[1].y};
#pragma unroll
          for (int t = 0; t < NT; ++t) {
            mma16816(acc[mt][t], alo, blo[t][0], blo[t][1]);
            mma16816(acc[mt][t], ahi, bhi[t][0], bhi[t][1]);
          }
        }
      }
    }
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
// Backward (dx): CTA = 128 dx rows x one 64-byte packed column block `blk`
// (dx columns blk*64.. of the low half and in/2 + blk*64.. of the high
// half, 128 in all), 8 warps as 2 (rows) x 4 (columns), warp tile 64 x 32:
// warps 0-1 of each row pair own low-half columns, 2-3 high-half ones. The
// loop walks `out` in chunks of 64: each thread holds 16 packed bytes of one
// weight row in registers (loaded one chunk ahead), the block dequantizes
// them into a bf16 [out][in] tile per half, which ldmatrix.trans reads as
// the B operand; dy tiles arrive by cp.async (double buffered).

constexpr int BTM = 128;        // dx rows per CTA
constexpr int BKC = 64;         // contraction (out) per chunk
constexpr int LDB = GROUP + 8;  // padded dy / weight tile row (bf16): ldmatrix without conflicts
constexpr size_t BSMEM =
    (size_t)2 * BTM * LDB * sizeof(__nv_bfloat16)     // dy: 2 stages
    + (size_t)2 * BKC * LDB * sizeof(__nv_bfloat16);  // weight: 2 halves

__global__ void __launch_bounds__(FTHREADS, 2) int4_matmul_t_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sDy = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [st][BTM][LDB]
  __nv_bfloat16* sW = sDy + 2 * BTM * LDB;                             // [h][BKC][LDB]

  const int blk = blockIdx.x;
  const int m0 = blockIdx.y * BTM;
  const int half = p.in / 2;
  const int n_lo = p.in / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int wm = (warp / 4) * 64;  // warp's first dx row in the tile
  const int wh = (warp % 4) / 2;   // 0: low-half columns, 1: high-half
  const int wc = (warp % 2) * 32;  // warp's first column within its half
  const int n_chunks = (p.out + BKC - 1) / BKC;

  auto load_dy = [&](int chunk, int st) {
    const int n0 = chunk * BKC;
    for (int i = threadIdx.x; i < BTM * (BKC / 8); i += FTHREADS) {
      const int r = i / (BKC / 8), q = (i % (BKC / 8)) * 8;
      const bool ok = m0 + r < p.T && n0 + q < p.out;  // out % 8 == 0: whole chunks
      const __nv_bfloat16* src = ok ? p.a + (long long)(m0 + r) * p.out + n0 + q : p.a;
      cp_async16(sDy + (st * BTM + r) * LDB + q, src, ok);
    }
  };
  // dequantization: thread -> one packed row of the chunk, 16 of its 64 bytes
  const int dr = threadIdx.x / 4;
  const int dc = (threadIdx.x % 4) * 16;
  auto load_w = [&](int chunk, uint4& raw, float& slo, float& shi) {
    const int n = chunk * BKC + dr;
    const bool ok = n < p.out;
    raw = ok ? __ldg(reinterpret_cast<const uint4*>(p.packed + (long long)n * p.half_p +
                                                    blk * GROUP + dc))
             : make_uint4(0u, 0u, 0u, 0u);
    slo = ok ? __bfloat162float(p.scale[(long long)n * p.S + blk]) : 0.f;
    shi = ok ? __bfloat162float(p.scale[(long long)n * p.S + n_lo + blk]) : 0.f;
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  uint4 raw;
  float slo, shi;
  load_w(0, raw, slo, shi);
  load_dy(0, 0);
  cp_async_commit();
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c & 1;
    cp_async_wait<0>();
    __syncthreads();  // dy chunk c landed; every warp is done with sW and dy stage st^1
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t lo01, lo23, hi01, hi23;
      dequant_word(word(raw, s), slo, shi, lo01, lo23, hi01, hi23);
      *reinterpret_cast<uint2*>(sW + dr * LDB + dc + 4 * s) = make_uint2(lo01, lo23);
      *reinterpret_cast<uint2*>(sW + (BKC + dr) * LDB + dc + 4 * s) = make_uint2(hi01, hi23);
    }
    if (c + 1 < n_chunks) {  // the next chunk's loads fly during this chunk's mma
      load_dy(c + 1, st ^ 1);
      cp_async_commit();
      load_w(c + 1, raw, slo, shi);
    }
    __syncthreads();  // sW holds chunk c
    const __nv_bfloat16* cDy = sDy + st * BTM * LDB;
    const __nv_bfloat16* cW = sW + wh * BKC * LDB;
#pragma unroll
    for (int ks = 0; ks < BKC / 16; ++ks) {
      uint32_t bf[4][2];
#pragma unroll
      for (int t = 0; t < 4; t += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, cW + (ks * 16 + (lane % 16)) * LDB + wc + t * 8 + (lane / 16) * 8);
        bf[t][0] = vb[0];
        bf[t][1] = vb[1];
        bf[t + 1][0] = vb[2];
        bf[t + 1][1] = vb[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, cDy + (wm + mt * 16 + (lane % 16)) * LDB + ks * 16 + (lane / 16) * 8);
#pragma unroll
        for (int t = 0; t < 4; ++t) mma16816(acc[mt][t], af, bf[t][0], bf[t][1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + mt * 16 + g + 8 * r;
      if (m >= p.T) continue;
      __nv_bfloat16* dxrow = p.c + (long long)m * p.in + (wh ? half : 0) + blk * GROUP + wc;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        *reinterpret_cast<__nv_bfloat162*>(dxrow + t * 8 + 2 * tq) =
            __floats2bfloat162_rn(acc[mt][t][2 * r], acc[mt][t][2 * r + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Forward at T > 64 (prefill, the QLoRA step): a shared-memory tiled GEMM.
// CTA = 128 rows x 128 columns, 8 warps as 2 (rows) x 4 (columns), warp
// tile 64 x 32. Per 64-byte packed block j: each thread holds 32 packed
// bytes of one weight row in registers (loaded one block ahead), the block
// dequantizes them once into a bf16 [out][in] tile per half, and the warps
// read it and the x tiles of the low (columns j*64..) and high (in/2 +
// j*64..) halves (cp.async, double buffered) with ldmatrix. Each
// dequantized weight feeds 128 rows, where the register-direct kernel
// re-dequantizes it for every 64. 111 KB of shared memory: two CTAs per SM,
// so one's dequantization overlaps the other's mma.

constexpr int FBM = 128;                 // rows per CTA
constexpr int FBN = 128;                 // columns per CTA
constexpr int LDX = GROUP + 8;           // padded x / weight tile row (bf16)
constexpr size_t FSMEM =
    (size_t)2 * 2 * FBM * LDX * sizeof(__nv_bfloat16)  // x: 2 stages x 2 halves
    + (size_t)2 * FBN * LDX * sizeof(__nv_bfloat16);   // weight: 2 halves

__global__ void __launch_bounds__(FTHREADS, 2) int4_matmul_kernel_tiled(Params p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* sX = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [st][h][FBM][LDX]
  __nv_bfloat16* sW = sX + 2 * 2 * FBM * LDX;                        // [h][FBN][LDX]

  const int n0 = blockIdx.x * FBN;
  const int m0 = blockIdx.y * FBM;
  const int half = p.in / 2;
  const int n_lo = p.in / 128;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int tq = lane % 4;
  const int wm = (warp / 4) * 64;  // warp's first row in the tile
  const int wn = (warp % 4) * 32;  // warp's first column in the tile

  auto load_x = [&](int j, int st) {
    for (int i = threadIdx.x; i < 2 * FBM * (GROUP / 8); i += FTHREADS) {
      const int h = i / (FBM * (GROUP / 8));
      const int r = (i / (GROUP / 8)) % FBM, q = (i % (GROUP / 8)) * 8;
      const bool ok = m0 + r < p.T;
      const __nv_bfloat16* src =
          ok ? p.a + (long long)(m0 + r) * p.in + (h ? half : 0) + j * GROUP + q : p.a;
      cp_async16(sX + ((st * 2 + h) * FBM + r) * LDX + q, src, ok);
    }
  };
  // dequantization: thread -> one weight row of the tile, 32 of its 64 bytes
  const int dr = threadIdx.x / 2;
  const int dc = (threadIdx.x % 2) * 32;
  const bool drow_ok = n0 + dr < p.out;
  const int8_t* prow = p.packed + (long long)(drow_ok ? n0 + dr : 0) * p.half_p + dc;
  const __nv_bfloat16* srow = p.scale + (long long)(drow_ok ? n0 + dr : 0) * p.S;
  auto load_w = [&](int j, uint4 (&raw)[2], float& slo, float& shi) {
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    raw[0] = drow_ok ? __ldg(reinterpret_cast<const uint4*>(prow + j * GROUP)) : zero;
    raw[1] = drow_ok ? __ldg(reinterpret_cast<const uint4*>(prow + j * GROUP + 16)) : zero;
    slo = drow_ok ? __bfloat162float(srow[j]) : 0.f;
    shi = drow_ok ? __bfloat162float(srow[n_lo + j]) : 0.f;
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int t = 0; t < 4; ++t) acc[mt][t][0] = acc[mt][t][1] = acc[mt][t][2] = acc[mt][t][3] = 0.f;

  uint4 raw[2];
  float slo, shi;
  load_w(0, raw, slo, shi);
  load_x(0, 0);
  cp_async_commit();
  for (int j = 0; j < n_lo; ++j) {
    const int st = j & 1;
    cp_async_wait<0>();
    __syncthreads();  // x block j landed; every warp is done with sW and x stage st^1
#pragma unroll
    for (int v = 0; v < 2; ++v) {
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        uint32_t lo01, lo23, hi01, hi23;
        dequant_word(word(raw[v], s), slo, shi, lo01, lo23, hi01, hi23);
        const int col = dc + 16 * v + 4 * s;
        *reinterpret_cast<uint2*>(sW + dr * LDX + col) = make_uint2(lo01, lo23);
        *reinterpret_cast<uint2*>(sW + (FBN + dr) * LDX + col) = make_uint2(hi01, hi23);
      }
    }
    if (j + 1 < n_lo) {  // the next block's loads fly during this block's mma
      load_x(j + 1, st ^ 1);
      cp_async_commit();
      load_w(j + 1, raw, slo, shi);
    }
    __syncthreads();  // sW holds block j
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat16* cX = sX + (st * 2 + h) * FBM * LDX;
      const __nv_bfloat16* cW = sW + h * FBN * LDX;
#pragma unroll
      for (int ks = 0; ks < GROUP / 16; ++ks) {
        uint32_t bf[4][2];
#pragma unroll
        for (int t = 0; t < 4; t += 2) {
          uint32_t r4[4];
          // matrices: (tile t, k 0-7), (tile t, k 8-15), (tile t+1, k 0-7), (tile t+1, k 8-15)
          ldmatrix_x4(r4, cW + (wn + t * 8 + (lane / 16) * 8 + (lane % 8)) * LDX + ks * 16 +
                              ((lane / 8) % 2) * 8);
          bf[t][0] = r4[0];
          bf[t][1] = r4[1];
          bf[t + 1][0] = r4[2];
          bf[t + 1][1] = r4[3];
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t af[4];
          ldmatrix_x4(af, cX + (wm + mt * 16 + (lane % 16)) * LDX + ks * 16 + (lane / 16) * 8);
#pragma unroll
          for (int t = 0; t < 4; ++t) mma16816(acc[mt][t], af, bf[t][0], bf[t][1]);
        }
      }
    }
  }

  const bool pairs = (p.out % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int m = m0 + wm + mt * 16 + g + 8 * r;
      if (m >= p.T) continue;
      __nv_bfloat16* yrow = p.c + (long long)m * p.out;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int n = n0 + wn + t * 8 + 2 * tq;
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

int launch_fwd_tiled(const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_kernel_tiled,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FSMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid((p.out + FBN - 1) / FBN, (p.T + FBM - 1) / FBM);
  int4_matmul_kernel_tiled<<<grid, FTHREADS, FSMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int MT, int NT, int U>
int launch_fwd(const Params& p, cudaStream_t stream) {
  dim3 grid((p.out + 32 * NT - 1) / (32 * NT), (p.T + 16 * MT - 1) / (16 * MT));
  int4_matmul_kernel<MT, NT, U><<<grid, NTHREADS, 0, stream>>>(p);
  return (int)cudaGetLastError();
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
  // decode and verify shapes stream the weight: register-direct, narrow CTAs
  // (more of them) and deep load batches; larger T is a tiled GEMM
  if (T <= 16) return launch_fwd<1, 1, 8>(p, st);
  if (T <= 32) return launch_fwd<2, 1, 8>(p, st);
  if (T <= 64) return launch_fwd<4, 2, 4>(p, st);
  return launch_fwd_tiled(p, st);
}

// dx (T, in) = dy (T, out) @ dequant(packed, scale)^T; out % 8 == 0.
extern "C" int int4_matmul_t(const void* dy, const void* packed, const void* scale, void* dx,
                             int T, int in, int out, int half_p, int S, void* stream) {
  if (!valid_shape(T, in, out, half_p, S) || out % 8 != 0) return (int)cudaErrorInvalidValue;
  if (T == 0) return 0;
  const Params p = make_params(dy, packed, scale, dx, T, in, out, half_p, S);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(int4_matmul_t_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BSMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  dim3 grid(in / 128, (T + BTM - 1) / BTM);
  int4_matmul_t_kernel<<<grid, FTHREADS, BSMEM, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
