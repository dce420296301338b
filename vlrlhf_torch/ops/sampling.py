"""Token sampling: temperature / top-k / top-p (counterpart of
vlrlhf_tpu/ops/sampling.py). Random draws come from an explicit
torch.Generator on the logits' device."""

from __future__ import annotations

from typing import Optional

import torch


def warp_logits(
    logits: torch.Tensor,  # (..., V) float32
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """The HF-order logits warpers (temperature -> top-k -> top-p)."""
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k is not None and top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None and top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until cumulative prob exceeds top_p (always keep top-1)
        cutoff_idx = ((cum - probs) < top_p).sum(dim=-1) - 1  # (...,)
        cutoff_logit = torch.gather(sorted_logits, -1, cutoff_idx[..., None])
        logits = logits.masked_fill(logits < cutoff_logit, float("-inf"))
    return logits


def sample_tokens(
    logits: torch.Tensor,  # (B, V) float
    generator: Optional[torch.Generator] = None,
    temperature: float = 1.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    do_sample: bool = True,
) -> torch.Tensor:
    """(B,) int32 token ids: argmax when greedy, else a draw from the
    warped distribution."""
    logits = logits.float()
    if not do_sample:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(warp_logits(logits, temperature, top_k, top_p), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)
