"""Rotary position embeddings, incl. linear and dynamic-NTK scaling
(counterpart of vlrlhf_tpu/ops/rope.py; HF "rotate_half" convention).

All trig in float32; application returns the input dtype."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    base: float = 10000.0
    scaling_type: str = "none"  # 'none' | 'linear' | 'dynamic' (NTK-aware)
    scaling_factor: float = 1.0
    max_position_embeddings: int = 2048


def _inv_freq(cfg: RopeConfig, device, seq_len: Optional[int] = None) -> torch.Tensor:
    dim = cfg.head_dim
    base = cfg.base
    if cfg.scaling_type == "dynamic" and seq_len is not None:
        # NTK-aware base rescaling, only active past the trained context.
        ratio = max(seq_len / cfg.max_position_embeddings, 1.0)
        alpha = cfg.scaling_factor * ratio - (cfg.scaling_factor - 1)
        base = base * alpha ** (dim / (dim - 2))
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (base**exponent)


def rope_frequencies(
    cfg: RopeConfig,
    positions: torch.Tensor,  # (..., seq) int positions
    seq_len: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each (..., seq, head_dim), rotate_half layout."""
    inv_freq = _inv_freq(cfg, positions.device, seq_len)
    pos = positions.float()
    if cfg.scaling_type == "linear":
        pos = pos / cfg.scaling_factor
    freqs = pos[..., None] * inv_freq  # (..., seq, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,  # (..., seq, n_heads, head_dim)
    k: torch.Tensor,  # (..., seq, n_kv_heads, head_dim)
    cos: torch.Tensor,  # (..., seq, head_dim)
    sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    cos = cos[..., :, None, :].float()
    sin = sin[..., :, None, :].float()
    qf, kf = q.float(), k.float()
    q_out = qf * cos + _rotate_half(qf) * sin
    k_out = kf * cos + _rotate_half(kf) * sin
    return q_out.to(q.dtype), k_out.to(k.dtype)
