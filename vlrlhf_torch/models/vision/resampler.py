"""Qwen-VL's perceiver resampler (counterpart of
vlrlhf_tpu/models/vision/resampler.py `sincos_2d_pos_embed`,
`resampler_forward`): 256 learned queries cross-attend to the tower's
patch features. The queries carry a fixed 2-D sincos table (16 x 16 for
256 queries); the keys carry the same table resized to the patch grid
(32 x 32 at 448 px) by ops/image.py `interpolate_pos_embed`. The features
go through `kv_proj` (1664 -> 4096, no bias) and `ln_kv`, the queries
through `ln_q`; `wo` projects the attention out. models/vlm.py's
`Projector` adds `ln_post` (eps 1e-6) and the bias-free square `proj`.

The cross-attention (Sq = 256 queries, Skv = 1024 keys, 32 heads, D = 128,
no mask) is plain `reference_attention` in vlrlhf_tpu. Here it calls the
flash kernel directly (ops/flash_attention.py, whose contract takes
Sq != Skv when non-causal): on the card it launches kernel 1, on the CPU it
is the kernel's plain version. ops/attention.py's square-only dispatch is
left as it is, so the Q-Former's cross-attention stays plain.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vlrlhf_torch.models.common import Linear, Norm, empty_param
from vlrlhf_torch.ops.flash_attention import flash_attention
from vlrlhf_torch.ops.image import interpolate_pos_embed
from vlrlhf_torch.ops.norms import layer_norm

LN_EPS = 1e-6


def sincos_2d_pos_embed(embed_dim: int, grid_size: int) -> np.ndarray:
    """MAE-style 2-D sincos table, (grid_size**2, embed_dim) f32."""
    def _1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
        omega = 1.0 / 10000**omega
        out = np.einsum("m,d->md", pos.reshape(-1), omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid_h = np.arange(grid_size, dtype=np.float32)
    grid_w = np.arange(grid_size, dtype=np.float32)
    grid = np.meshgrid(grid_w, grid_h)  # w goes first (MAE convention)
    grid = np.stack(grid, axis=0).reshape(2, 1, grid_size, grid_size)
    emb_h = _1d(embed_dim // 2, grid[0])
    emb_w = _1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1).astype(np.float32)


class _Attn(nn.Module):
    """The cross-attention's four biased linears (JAX path .../attn/w*)."""

    def __init__(self, d: int, device, dtype):
        super().__init__()
        self.wq = Linear(d, d, True, device, dtype)
        self.wk = Linear(d, d, True, device, dtype)
        self.wv = Linear(d, d, True, device, dtype)
        self.wo = Linear(d, d, True, device, dtype)


class Resampler(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, kv_dim: int, num_queries: int,
                 device, dtype):
        super().__init__()
        d = embed_dim
        self.num_heads, self.num_queries = num_heads, num_queries
        self.query = empty_param((num_queries, d), device, dtype)
        self.pos_embed = empty_param((num_queries, d), device, dtype)
        self.ln_q = Norm(d, True, device, dtype)
        self.ln_kv = Norm(d, True, device, dtype)
        self.attn = _Attn(d, device, dtype)
        self.kv_proj = Linear(kv_dim, d, False, device, dtype) if kv_dim != d else None

    @torch.no_grad()
    def reset_fixed_(self) -> None:
        """The query table's sincos values (vlrlhf_tpu's init)."""
        grid = round(self.num_queries**0.5)
        table = sincos_2d_pos_embed(self.pos_embed.shape[1], grid)
        self.pos_embed.copy_(torch.from_numpy(table).to(self.pos_embed.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, n_patches, kv_dim) -> (B, num_queries, embed_dim)."""
        b, n, _ = x.shape
        nq, nh = self.num_queries, self.num_heads
        d = self.query.shape[1]
        hd = d // nh
        pos = self.pos_embed.float()
        pos_k = interpolate_pos_embed(pos, n)
        if self.kv_proj is not None:
            x = self.kv_proj(x)
        x = layer_norm(x, self.ln_kv.weight, self.ln_kv.bias, LN_EPS)
        q_in = layer_norm(self.query.to(x.dtype), self.ln_q.weight, self.ln_q.bias, LN_EPS)
        q_in = q_in[None].expand(b, nq, d)
        q = self.attn.wq(q_in + pos.to(q_in.dtype)[None])
        k = self.attn.wk(x + pos_k.to(x.dtype)[None])
        v = self.attn.wv(x)
        out = flash_attention(q.reshape(b, nq, nh, hd), k.reshape(b, n, nh, hd),
                              v.reshape(b, n, nh, hd), causal=False)
        return self.attn.wo(out.reshape(b, nq, d))
