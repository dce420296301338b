"""Convert pre-quantized GPTQ checkpoints into the int4 layout (a numpy copy
of vlrlhf_tpu/utils/gptq.py, which the port may not import).

GPTQ stores W[i, o] = scales[g, o] * (q[i, o] - z[g, o]) with q in [0, 15]
packed 8 per int32 along `in` (qweight) and z packed 8 per int32 along `out`
(qzeros, stored minus one, the AutoGPTQ convention). The int4 kernels are
symmetric with codes in [-8, 7], so

    W = s * (q - 8)  +  s * (8 - z)

the first term is exactly the packed layout (codes q - 8, the same scales);
the second is constant within a (group, out) cell and becomes the
"kernel_gbias" (in/64, out) leaf, which ops/int4.py `int4_apply` adds as a
small group-summed-x product outside the kernel. Symmetric checkpoints
(z == 8 everywhere) produce no gbias leaf. A GPTQ group size must be a
multiple of 64; activation-ordered checkpoints (desc_act, a permuting
g_idx) are refused.

The leaves are the JAX package's (in, out) layout, so utils/bridge.py takes
them as it takes vlrlhf_tpu's, and tests compare them bit for bit. The bf16
scales and gbias are returned as float32 arrays holding bf16 values
(round to nearest even): the port does not depend on ml_dtypes.

The HF checkpoint import (utils/hf_port.py `_gptq_linear`) calls it for
every linear that comes as `qweight` / `qzeros` / `scales`.
"""

from __future__ import annotations

import numpy as np

GROUP = 64  # the int4 layout's group rows along `in`
_BLK = 128  # its packing unit


def _half_padded(half: int) -> int:
    return -(-half // _BLK) * _BLK


def round_bf16(a) -> np.ndarray:
    """float32 values rounded to the nearest bf16 (ties to even), as f32."""
    u = np.asarray(a, np.float32).view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


def unpack_rows_int32(packed: np.ndarray, bits: int = 4) -> np.ndarray:
    """(n/8, out) int32, 8 4-bit codes per word along DIM 0 -> (n, out)."""
    per = 32 // bits
    shifts = np.arange(per, dtype=np.uint32) * bits
    u = packed.astype(np.uint32)[:, None, :] >> shifts[None, :, None]
    u = (u & ((1 << bits) - 1)).astype(np.int32)
    return u.reshape(-1, packed.shape[1])


def unpack_cols_int32(packed: np.ndarray, bits: int = 4) -> np.ndarray:
    """(g, out/8) int32, 8 4-bit codes per word along DIM 1 -> (g, out)."""
    per = 32 // bits
    shifts = np.arange(per, dtype=np.uint32) * bits
    u = packed.astype(np.uint32)[:, :, None] >> shifts[None, None, :]
    u = (u & ((1 << bits) - 1)).astype(np.int32)
    return u.reshape(packed.shape[0], -1)


def convert_gptq_linear(
    qweight: np.ndarray,  # (in/8, out) int32
    qzeros: np.ndarray,  # (n_groups, out/8) int32 (stored as z-1)
    scales: np.ndarray,  # (n_groups, out) f16/f32
    g_idx: np.ndarray | None = None,  # (in,) group index per row
    bits: int = 4,
) -> dict:
    """One GPTQ linear -> {"kernel_q4", "kernel_scale"[, "kernel_gbias"]}.

    Raises ValueError for layouts the exact path cannot represent
    (bits != 4, activation ordering, group_size not a multiple of 64)."""
    if bits != 4:
        raise ValueError(f"only bits=4 GPTQ is ingestable (got {bits})")
    q = unpack_rows_int32(qweight, bits)  # (in, out) in [0, 15]
    din, dout = q.shape
    n_groups = scales.shape[0]
    if din % n_groups:
        raise ValueError(f"in={din} not divisible by n_groups={n_groups}")
    gsz = din // n_groups
    if g_idx is not None:
        expect = np.arange(din) // gsz
        if not np.array_equal(np.asarray(g_idx).ravel(), expect):
            raise ValueError(
                "activation-ordered GPTQ (desc_act=True) permutes rows during "
                "calibration; exact ingestion would need a runtime activation "
                "gather: re-quantize without act-order"
            )
    if gsz % GROUP:
        raise ValueError(
            f"GPTQ group_size={gsz} is not a multiple of {GROUP}; exact "
            "ingestion impossible (scales would straddle groups)"
        )
    if din % (2 * GROUP):
        raise ValueError(f"in={din} not divisible by {2 * GROUP}")

    z = unpack_cols_int32(qzeros, bits)[:, :dout] + 1  # AutoGPTQ z-1 storage
    rep = gsz // GROUP
    s64 = np.repeat(np.asarray(scales, np.float32), rep, axis=0)  # (din/64, out)
    z64 = np.repeat(z, rep, axis=0)

    # symmetric part: codes q-8 in [-8, 7], split-half nibble packing
    codes = (q - 8).astype(np.int8)
    half = din // 2
    packed = ((codes[:half] & np.int8(0x0F)) | (codes[half:] << 4)).astype(np.int8)
    pad = _half_padded(half) - half
    if pad:
        packed = np.pad(packed, ((0, pad), (0, 0)))
    # the kernels take bf16 scales: GPTQ's f16 scales round to bf16 (codes
    # stay exact)
    s64b = round_bf16(s64)
    scale2d = s64b
    if (din // _BLK) % 2:  # odd n_lo -> zero guard row
        scale2d = np.pad(scale2d, ((0, 1), (0, 0)))
    out = {"kernel_q4": packed, "kernel_scale": scale2d}

    # gbias from the bf16-rounded scales, so the two terms rebuild the W the
    # kernel computes: W = s_bf16 * (q-8) + s_bf16 * (8-z); stored bf16
    gbias = s64b * (8.0 - z64).astype(np.float32)
    if np.any(gbias != 0.0):
        out["kernel_gbias"] = round_bf16(gbias)
    return out


def dequantize_gptq_reference(qweight, qzeros, scales, bits=4) -> np.ndarray:
    """The textbook GPTQ dequant, the converter's oracle:
    W[i, o] = scales[g(i), o] * (q[i, o] - (qzeros[g(i), o] + 1))."""
    q = unpack_rows_int32(qweight, bits).astype(np.float32)
    din = q.shape[0]
    n_groups = scales.shape[0]
    gsz = din // n_groups
    z = (unpack_cols_int32(qzeros, bits) + 1).astype(np.float32)
    s = np.asarray(scales, np.float32)
    gi = np.arange(din) // gsz
    return s[gi] * (q - z[gi])


def pack_gptq_reference(q, z, s, gsz):
    """AutoGPTQ-layout tensors from plain (q, z, s), the synthetic-
    checkpoint generator for tests: q (in, out) in [0, 15]; z (n_groups,
    out) in [1, 16]; s (n_groups, out) float."""
    din, dout = q.shape
    per = 8
    qw = np.zeros((din // per, dout), np.uint32)
    for j in range(per):
        qw |= (q[j::per].astype(np.uint32) & 0xF) << (4 * j)
    zm1 = (z - 1).astype(np.uint32) & 0xF
    qz = np.zeros((z.shape[0], dout // per), np.uint32)
    for j in range(per):
        qz |= zm1[:, j::per] << (4 * j)
    return (
        qw.astype(np.int32),
        qz.astype(np.int32),
        np.asarray(s, np.float16),
        (np.arange(din) // gsz).astype(np.int32),
    )
