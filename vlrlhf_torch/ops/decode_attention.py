"""Decode attention: one query token per row against the stacked head-major
KV cache — the hand-written Hopper kernel (csrc/decode_attention.cu) and its
plain PyTorch version.

Replaces the Pallas `_decode_kernel` / `decode_attention` in
vlrlhf_tpu/ops/decode_attention.py. Layout as there: q (B, nh, hd); cache
k/v (L, B, nkv, S, hd) with `layer=`, or (B, nkv, S, hd) without; slot ==
absolute position; `lengths` (B,) the current position per row. Slots
< lengths[b] come from the cache (strict: the current token is not written
yet) and the current token's k/v (k_cur/v_cur, (B, nkv, hd)) join as an
always-attended self term, which lets the caller defer the cache write
(models/lm/llama.py `lm_decode`).

An int8 cache (ops/quant.py `quantize_kv`) comes with `k_scale` / `v_scale`,
bf16 (L, B, nkv, S) or (B, nkv, S): the k scale multiplies each score after
the dot and the v scale each softmax weight before the value sum, so the
cache is never dequantized into memory; the self term stays bf16-exact.

Dispatch: a CPU tensor takes `decode_attention_plain`; a CUDA tensor
launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vlrlhf_torch.ops import _build


def decode_attention_plain(
    q: torch.Tensor,  # (B, nh, hd)
    k_cache: torch.Tensor,  # (B, nkv, S, hd) — one layer
    v_cache: torch.Tensor,
    k_cur: torch.Tensor,  # (B, nkv, hd)
    v_cur: torch.Tensor,
    lengths: torch.Tensor,  # (B,)
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # (B, nkv, S) with an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, f32 softmax."""
    b, nh, hd = q.shape
    nkv, s = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    qf = q.float().reshape(b, nkv, g, hd) * scale
    scores = torch.einsum("bngd,bnsd->bngs", qf, k_cache.float())
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, :]
    slot = torch.arange(s, device=q.device)
    live = slot[None, :] < lengths.to(q.device).long()[:, None]  # (B, S)
    scores = scores.masked_fill(~live[:, None, None, :], float("-inf"))
    s_self = torch.einsum("bngd,bnd->bng", qf, k_cur.float())[..., None]
    probs = torch.softmax(torch.cat([scores, s_self], dim=-1), dim=-1)
    p_cache = probs[..., :s]
    if v_scale is not None:
        p_cache = p_cache * v_scale.float()[:, :, None, :]
    out = torch.einsum("bngs,bnsd->bngd", p_cache, v_cache.float())
    out = out + probs[..., s:] * v_cur.float()[:, :, None, :]
    return out.reshape(b, nh, hd).to(q.dtype)


def check_operand(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    """What the attention kernels' vector loads need of a tensor: its dtype,
    a unit last stride, strides divisible by 8 and a 16-byte aligned base."""
    if t.dtype != dtype:
        raise TypeError(f"kernel takes {dtype} {name}, got {t.dtype}")
    if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]) or t.data_ptr() % 16:
        raise ValueError(
            f"kernel needs {name} with unit last stride, strides divisible by 8 and a "
            f"16-byte aligned base; got {t.stride()}"
        )


def check_cache(k_cache, v_cache, k_scale, v_scale, stacked: bool, layer) -> bool:
    """Validate a (stacked) cache and its int8 scales for a kernel launch;
    returns whether the cache is int8."""
    quantized = k_scale is not None
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    check_operand("k_cache", k_cache, kv_dtype)
    check_operand("v_cache", v_cache, kv_dtype)
    if k_cache.shape != v_cache.shape or k_cache.stride() != v_cache.stride():
        raise ValueError("k_cache and v_cache must share shape and strides")
    if quantized:
        if k_scale.dtype != torch.bfloat16 or v_scale.dtype != torch.bfloat16:
            raise TypeError("int8 cache scales must be bf16")
        if k_scale.shape != k_cache.shape[:-1] or v_scale.shape != k_scale.shape \
                or k_scale.stride() != v_scale.stride() or k_scale.stride(-1) != 1:
            raise ValueError(f"scales must be {tuple(k_cache.shape[:-1])} with slot stride 1")
    if not 0 <= (layer or 0) < (k_cache.shape[0] if stacked else 1):
        raise IndexError(f"layer {layer} out of range")
    return quantized


def _launch(q, k_cache, v_cache, k_cur, v_cur, lengths, scale, layer, k_scale, v_scale):
    b, nh, hd = q.shape
    stacked = layer is not None
    nkv, s = k_cache.shape[-3], k_cache.shape[-2]
    for name, t in (("q", q), ("k_cur", k_cur), ("v_cur", v_cur)):
        check_operand(name, t, torch.bfloat16)
    quantized = check_cache(k_cache, v_cache, k_scale, v_scale, stacked, layer)
    if nh % nkv or nh // nkv not in (1, 2, 4, 8) or hd % 8 or not 0 < hd <= 256:
        raise ValueError(
            f"decode kernel takes GQA groups of 1, 2, 4 or 8 and head_dim a "
            f"multiple of 8 up to 256; got nh={nh} nkv={nkv} hd={hd}"
        )
    if tuple(k_cur.shape) != (b, nkv, hd) or k_cur.stride() != v_cur.stride():
        raise ValueError(f"k_cur/v_cur must be (B, nkv, hd) = {(b, nkv, hd)}")
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, nh, hd), dtype=q.dtype, device=q.device)
    if b == 0:
        return o
    cs = k_cache.stride()[-4:]  # (batch, head, slot, 1) either way
    ss = k_scale.stride()[-3:] if quantized else (0, 0, 1)
    layer_offset = layer * k_cache.stride(0) if stacked else 0
    s_layer_offset = layer * k_scale.stride(0) if stacked and quantized else 0
    fn = _build.load("decode_attention").decode_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 11
        + [ctypes.c_float, ctypes.c_void_p]
    )
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        k_cur.data_ptr(), v_cur.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        b, nh, nkv, hd, s, int(quantized), layer_offset, s_layer_offset,
        q.stride(0), q.stride(1),
        cs[0], cs[1], cs[2], ss[0], ss[1],
        k_cur.stride(0), k_cur.stride(1),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "decode_attention")
    decode_attention.launches += 1
    return o


def decode_attention(
    q: torch.Tensor,  # (B, nh, hd)
    k_cache: torch.Tensor,  # (B, nkv, S, hd) or (L, B, nkv, S, hd) with `layer`
    v_cache: torch.Tensor,
    k_cur: torch.Tensor,  # (B, nkv, hd) current token's k (not yet in cache)
    v_cur: torch.Tensor,
    lengths: torch.Tensor,  # (B,) int current positions
    scale: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # (B, nkv, S) or (L, B, nkv, S): int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, nh, hd) attention output. With `layer` the caches (and scales)
    are the full stacked buffers; the kernel offsets into layer `layer` in
    place."""
    hd = q.shape[-1]
    scale = hd**-0.5 if scale is None else scale
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, k_cur, v_cur, lengths, scale, layer,
                       k_scale, v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"decode_attention: no path for device {q.device}")
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    return decode_attention_plain(q, k_cache, v_cache, k_cur, v_cur, lengths, scale,
                                  k_scale, v_scale)


decode_attention.launches = 0  # kernel launches; the plain path never counts
