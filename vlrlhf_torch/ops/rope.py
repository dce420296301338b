"""Rotary position embeddings, incl. linear and dynamic-NTK scaling
(counterpart of vlrlhf_tpu/ops/rope.py; HF "rotate_half" convention).

Two forms of QWen's own long-context rope (modeling_qwen.py), read from a
Qwen-VL config.json (cli/loading.py): scaling "qwen_dynamic", whose NTK
alpha is 2 ** ceil(log2(n / seq_length) + 1) - 1 (at least 1) for a
prefill of a row's n real tokens (`ntk_alpha`); as in QWen, where a
forward with a past reuses the prefill's alpha, decode and chunk steps
pass the alpha the row's cache keeps. And `logn_attn`, the queries at
position p scaled by log(p + 1) / log(seq_length) past seq_length. With logn the tables come back stacked,
(2, ..., seq, head_dim): [0] the queries' (the logn factor folded in, as
it multiplies the rotated query), [1] the keys'; `apply_rope` takes
either form, so no caller threads a second table. A config bridged from
vlrlhf_tpu keeps HF-llama's "dynamic" and no logn.

All trig in float32; application returns the input dtype."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class RopeConfig:
    head_dim: int
    base: float = 10000.0
    # 'none' | 'linear' | 'dynamic' (HF-llama's NTK-aware) | 'qwen_dynamic'
    scaling_type: str = "none"
    scaling_factor: float = 1.0
    max_position_embeddings: int = 2048  # QWen's seq_length for its two forms
    logn_attn: bool = False


def ntk_alpha(cfg: RopeConfig, n_keys: torch.Tensor) -> torch.Tensor:
    """QWen's dynamic-NTK alpha (f32, n_keys' shape) of a prefill over
    `n_keys` real tokens: 2 ** ceil(log2(n / seq_length) + 1) - 1, at
    least 1."""
    ratio = n_keys.double() / cfg.max_position_embeddings
    alpha = torch.where(ratio > 1.0, 2.0 ** torch.ceil(torch.log2(ratio) + 1.0) - 1.0,
                        torch.ones_like(ratio))
    return alpha.clamp(min=1.0).float()


def _inv_freq(cfg: RopeConfig, device, seq_len: Optional[int] = None,
              alpha: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(dim/2,) inverse frequencies, or (B, 1, dim/2) under "qwen_dynamic"
    with `alpha` (B,), each row's NTK alpha."""
    dim = cfg.head_dim
    base = cfg.base
    exponent = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    if cfg.scaling_type == "qwen_dynamic" and alpha is not None:
        base_b = (base * alpha.to(device=device, dtype=torch.float64)
                  ** (dim / (dim - 2))).float()
        return 1.0 / (base_b[:, None, None] ** exponent)
    if cfg.scaling_type == "dynamic" and seq_len is not None:
        # NTK-aware base rescaling, only active past the trained context.
        ratio = max(seq_len / cfg.max_position_embeddings, 1.0)
        alpha = cfg.scaling_factor * ratio - (cfg.scaling_factor - 1)
        base = base * alpha ** (dim / (dim - 2))
    return 1.0 / (base**exponent)


def logn_scale(cfg: RopeConfig, positions: torch.Tensor) -> torch.Tensor:
    """QWen's query factor per position: log(p + 1) / log(seq_length) past
    seq_length, else 1 (f32, positions' shape)."""
    n = positions.double() + 1.0
    s = torch.log(n) / torch.log(torch.tensor(float(cfg.max_position_embeddings),
                                              dtype=torch.float64, device=positions.device))
    return torch.where(n > cfg.max_position_embeddings, s, torch.ones_like(s)).float()


def rope_frequencies(
    cfg: RopeConfig,
    positions: torch.Tensor,  # (..., seq) int positions; (B, seq) with alpha
    seq_len: Optional[int] = None,
    alpha: Optional[torch.Tensor] = None,  # (B,) each row's NTK alpha (qwen_dynamic)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Return (cos, sin), each (..., seq, head_dim), rotate_half layout;
    with `logn_attn` each stacked (2, ..., seq, head_dim): the queries'
    tables (the logn factor folded in), then the keys'."""
    inv_freq = _inv_freq(cfg, positions.device, seq_len, alpha)
    pos = positions.float()
    if cfg.scaling_type == "linear":
        pos = pos / cfg.scaling_factor
    freqs = pos[..., None] * inv_freq  # (..., seq, dim/2)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos, sin = torch.cos(emb), torch.sin(emb)
    if cfg.logn_attn:
        s = logn_scale(cfg, positions)[..., None]
        return torch.stack([cos * s, cos]), torch.stack([sin * s, sin])
    return cos, sin


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(
    q: torch.Tensor,  # (..., seq, n_heads, head_dim)
    k: torch.Tensor,  # (..., seq, n_kv_heads, head_dim)
    cos: torch.Tensor,  # (..., seq, head_dim)
    sin: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    if cos.dim() == q.dim():  # stacked (queries', keys') tables: logn_attn
        (cq, ck), (sq, sk) = cos, sin
    else:
        cq = ck = cos
        sq = sk = sin
    qf, kf = q.float(), k.float()
    q_out = qf * cq[..., :, None, :].float() + _rotate_half(qf) * sq[..., :, None, :].float()
    k_out = kf * ck[..., :, None, :].float() + _rotate_half(kf) * sk[..., :, None, :].float()
    return q_out.to(q.dtype), k_out.to(k.dtype)
