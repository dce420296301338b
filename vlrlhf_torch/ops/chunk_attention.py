"""Chunk attention: C chunk queries per row against the live stacked
head-major KV cache — the hand-written Hopper kernel
(csrc/chunk_attention.cu) and its plain PyTorch version.

Replaces the Pallas `_chunk_kernel` / `chunk_attention` in
vlrlhf_tpu/ops/chunk_attention.py: the multi-token step of serving (the
speculative verify chunk, a chat session's next turn). Contract, as
models/lm/llama.py `prefill_chunk` keeps it: the chunk's k/v are already
written to the cache at slots lengths[b] + i, and query i of row b attends
slot j iff j <= lengths[b] + i. Chunk-pad queries (i >= the row's real chunk
length) give finite values that no caller reads.

Layout: q (B, C, nh, hd); cache k/v (L, B, nkv, S, hd) with `layer=` (read
in place at the layer's offset) or (B, nkv, S, hd) without; an int8 cache
comes with bf16 `k_scale` / `v_scale` of the cache's shape minus hd, folded
as in the decode kernel. Output (B, C, nh, hd).

Dispatch: a CPU tensor takes `chunk_attention_plain`; a CUDA tensor
launches the kernel or raises. There is no chunk-length cap and no
fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vlrlhf_torch.ops import _build
from vlrlhf_torch.ops.decode_attention import check_cache, check_operand


def chunk_attention_plain(
    q: torch.Tensor,  # (B, C, nh, hd)
    k_cache: torch.Tensor,  # (B, nkv, S, hd) — one layer
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) tokens in the cache before the chunk
    scale: float,
    k_scale: Optional[torch.Tensor] = None,  # (B, nkv, S) with an int8 cache
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch, f32 softmax."""
    b, c, nh, hd = q.shape
    nkv, s = k_cache.shape[1], k_cache.shape[2]
    g = nh // nkv
    # (B, C, nkv, g, hd) -> (B, nkv, g, C, hd)
    qf = q.float().reshape(b, c, nkv, g, hd).permute(0, 2, 3, 1, 4) * scale
    scores = torch.einsum("bngcd,bnsd->bngcs", qf, k_cache.float())
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, None, :]
    limit = lengths.to(q.device).long()[:, None] + torch.arange(c, device=q.device)[None]
    attend = torch.arange(s, device=q.device)[None, None, :] <= limit[:, :, None]  # (B, C, S)
    scores = scores.masked_fill(~attend[:, None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.float()[:, :, None, None, :]
    out = torch.einsum("bngcs,bnsd->bngcd", probs, v_cache.float())
    return out.permute(0, 3, 1, 2, 4).reshape(b, c, nh, hd).to(q.dtype)


def _launch(q, k_cache, v_cache, lengths, scale, layer, k_scale, v_scale):
    b, c, nh, hd = q.shape
    stacked = layer is not None
    nkv, s = k_cache.shape[-3], k_cache.shape[-2]
    check_operand("q", q, torch.bfloat16)
    quantized = check_cache(k_cache, v_cache, k_scale, v_scale, stacked, layer)
    if nh % nkv or nh // nkv not in (1, 2, 4, 8) or hd % 8 or not 0 < hd <= 256:
        raise ValueError(
            f"chunk kernel takes GQA groups of 1, 2, 4 or 8 and head_dim a "
            f"multiple of 8 up to 256; got nh={nh} nkv={nkv} hd={hd}"
        )
    lengths = lengths.to(device=q.device, dtype=torch.int32).contiguous()
    o = torch.empty((b, c, nh, hd), dtype=q.dtype, device=q.device)
    if b == 0 or c == 0:
        return o
    cs = k_cache.stride()[-4:]  # (batch, head, slot, 1) either way
    ss = k_scale.stride()[-3:] if quantized else (0, 0, 1)
    layer_offset = layer * k_cache.stride(0) if stacked else 0
    s_layer_offset = layer * k_scale.stride(0) if stacked and quantized else 0
    fn = _build.load("chunk_attention").chunk_attention
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_longlong] * 10
        + [ctypes.c_float, ctypes.c_void_p]
    )
    err = fn(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        lengths.data_ptr(), o.data_ptr(),
        b, c, nh, nkv, hd, s, int(quantized), layer_offset, s_layer_offset,
        q.stride(0), q.stride(1), q.stride(2),
        cs[0], cs[1], cs[2], ss[0], ss[1],
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "chunk_attention")
    chunk_attention.launches += 1
    return o


def chunk_attention(
    q: torch.Tensor,  # (B, C, nh, hd)
    k_cache: torch.Tensor,  # (B, nkv, S, hd) or (L, B, nkv, S, hd) with `layer`
    v_cache: torch.Tensor,
    lengths: torch.Tensor,  # (B,) tokens in the cache BEFORE this chunk
    scale: Optional[float] = None,
    layer: Optional[int] = None,
    k_scale: Optional[torch.Tensor] = None,  # int8 cache: the cache's shape minus hd
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, C, nh, hd) attention output of the chunk's queries."""
    hd = q.shape[-1]
    scale = hd**-0.5 if scale is None else scale
    if (k_scale is None) != (v_scale is None):
        raise ValueError("pass both k_scale and v_scale or neither")
    if q.is_cuda:
        return _launch(q, k_cache, v_cache, lengths, scale, layer, k_scale, v_scale)
    if q.device.type != "cpu":
        raise ValueError(f"chunk_attention: no path for device {q.device}")
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
        if k_scale is not None:
            k_scale, v_scale = k_scale[layer], v_scale[layer]
    return chunk_attention_plain(q, k_cache, v_cache, lengths, scale, k_scale, v_scale)


chunk_attention.launches = 0  # kernel launches; the plain path never counts
