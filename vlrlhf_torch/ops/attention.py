"""Attention: the plain reference implementation and the dispatch to the
flash kernel (counterpart of vlrlhf_tpu/ops/attention.py).

Layouts: q (B, Sq, H, D); k, v (B, Skv, Hkv, D). Output (B, Sq, H, D).
Softmax in float32 always.
"""

from __future__ import annotations

from typing import Optional

import torch

from vlrlhf_torch.ops.flash_attention import flash_attention

NEG_INF = -1e30  # large-but-finite: keeps fully-masked rows NaN-free


def make_attention_mask(
    pad_mask_q: torch.Tensor,  # (B, Sq) 1 = real token
    pad_mask_kv: torch.Tensor,  # (B, Skv)
    causal: bool = True,
    segment_ids_q: Optional[torch.Tensor] = None,  # (B, Sq) int
    segment_ids_kv: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Boolean (B, 1, Sq, Skv) mask; True = attend."""
    mask = pad_mask_q[:, :, None].bool() & pad_mask_kv[:, None, :].bool()
    if causal:
        sq, skv = pad_mask_q.shape[-1], pad_mask_kv.shape[-1]
        # Align last query with last key (supports Sq < Skv decode steps).
        qpos = torch.arange(sq, device=mask.device)[:, None] + (skv - sq)
        kpos = torch.arange(skv, device=mask.device)[None, :]
        mask = mask & (kpos <= qpos)
    if segment_ids_q is not None and segment_ids_kv is not None:
        mask = mask & (segment_ids_q[:, :, None] == segment_ids_kv[:, None, :])
    return mask[:, None, :, :]


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def reference_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,  # (B, 1|H, Sq, Skv) bool
    scale: Optional[float] = None,
) -> torch.Tensor:
    b, sq, h, d = q.shape
    n_rep = h // k.shape[2]
    k, v = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    scale = d**-0.5 if scale is None else scale
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.float())
    return out.to(q.dtype)


def multi_head_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    pad_mask_q: Optional[torch.Tensor] = None,
    pad_mask_kv: Optional[torch.Tensor] = None,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Unified attention entry point: a CUDA tensor with Sq == Skv goes to
    the flash kernel (square only — the kernel's absolute-index causality
    equals the plain path's last-query/last-key alignment only then);
    everything else takes the plain path."""
    b, sq, _, _ = q.shape
    skv = k.shape[1]
    if q.is_cuda and sq == skv:
        return flash_attention(
            q, k, v, causal=causal,
            pad_mask_q=pad_mask_q, pad_mask_kv=pad_mask_kv,
            segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
            scale=scale,
        )
    if pad_mask_q is None:
        pad_mask_q = torch.ones((b, sq), dtype=torch.bool, device=q.device)
    if pad_mask_kv is None:
        pad_mask_kv = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    mask = make_attention_mask(
        pad_mask_q, pad_mask_kv, causal, segment_ids_q, segment_ids_kv
    )
    return reference_attention(q, k, v, mask=mask, scale=scale)
