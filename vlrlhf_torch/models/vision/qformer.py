"""Q-Former: InstructBLIP's instruction-aware query transformer
(counterpart of vlrlhf_tpu/models/vision/qformer.py `qformer_forward`).

  - learned query tokens concatenated with the embedded instruction text,
    one LayerNorm over [queries; text];
  - BERT-style self-attention over [queries; text] under the joint mask;
  - every `cross_attention_frequency` layers, cross-attention from the
    query part only to the tower's features;
  - a split feed-forward: `ffn_query` at the query positions, `ffn` at the
    text positions;
  - the output is the query positions' hidden states.

Its attention is vlrlhf_tpu's plain `reference_attention` (no Pallas
kernel), so plain torch ops serve here too (ops/attention.py
`reference_attention`). The feed-forward's activation is the config's
HF name: BERT's erf "gelu" from an HF import, the tanh form jax.nn.gelu
computes in a config bridged from vlrlhf_tpu.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from vlrlhf_torch.models.common import Linear, Norm, activation, embed, empty_param
from vlrlhf_torch.models.config import QFormerConfig
from vlrlhf_torch.ops.attention import reference_attention
from vlrlhf_torch.ops.norms import layer_norm


class QAttention(nn.Module):
    """wq / wk / wv / wo with biases and the post-residual LayerNorm `ln`."""

    def __init__(self, h: int, kv_dim: int, device, dtype):
        super().__init__()
        self.wq = Linear(h, h, True, device, dtype)
        self.wk = Linear(kv_dim, h, True, device, dtype)
        self.wv = Linear(kv_dim, h, True, device, dtype)
        self.wo = Linear(h, h, True, device, dtype)
        self.ln = Norm(h, True, device, dtype)

    def forward(self, q_in, kv_in, nh: int, mask=None):
        b, sq, h = q_in.shape
        skv = kv_in.shape[1]
        hd = h // nh
        q = self.wq(q_in).reshape(b, sq, nh, hd)
        k = self.wk(kv_in).reshape(b, skv, nh, hd)
        v = self.wv(kv_in).reshape(b, skv, nh, hd)
        return self.wo(reference_attention(q, k, v, mask=mask).reshape(b, sq, h))


class QFFN(nn.Module):
    def __init__(self, h: int, inter: int, act: str, device, dtype):
        super().__init__()
        self.act = activation(act)
        self.fc1 = Linear(h, inter, True, device, dtype)
        self.fc2 = Linear(inter, h, True, device, dtype)
        self.ln = Norm(h, True, device, dtype)

    def forward(self, y, eps: float):
        h = self.fc2(self.act(self.fc1(y)))
        return layer_norm(y + h, self.ln.weight, self.ln.bias, eps)


class QFormerLayer(nn.Module):
    def __init__(self, cfg: QFormerConfig, cross: bool, device):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.dtype
        self.self_attn = QAttention(h, h, device, dt)
        self.ffn = QFFN(h, cfg.intermediate_size, cfg.act, device, dt)  # text positions
        self.ffn_query = QFFN(h, cfg.intermediate_size, cfg.act, device, dt)  # query positions
        self.cross_attn = (QAttention(h, cfg.encoder_hidden_size, device, dt)
                           if cross else None)


class QFormer(nn.Module):
    def __init__(self, cfg: QFormerConfig, device):
        super().__init__()
        h, dt = cfg.hidden_size, cfg.dtype
        self.cfg = cfg
        self.query_tokens = empty_param((cfg.num_query_tokens, h), device, dt)
        self.word_embed = empty_param((cfg.vocab_size, h), device, dt)
        self.pos_embed = empty_param((cfg.max_position_embeddings, h), device, dt)
        self.emb_ln = Norm(h, True, device, dt)
        self.layers = nn.ModuleList(
            QFormerLayer(cfg, i % cfg.cross_attention_frequency == 0, device)
            for i in range(cfg.num_layers)
        )

    def forward(
        self,
        image_features: torch.Tensor,  # (B, N_patches, encoder_hidden)
        instruction_ids: Optional[torch.Tensor] = None,  # (B, T) qformer text ids
        instruction_mask: Optional[torch.Tensor] = None,  # (B, T)
    ) -> torch.Tensor:
        """(B, num_query_tokens, hidden)."""
        cfg = self.cfg
        dt, eps = cfg.dtype, cfg.ln_eps
        b = image_features.shape[0]
        nq = cfg.num_query_tokens
        dev = image_features.device
        queries = self.query_tokens.to(dt)[None].expand(b, nq, cfg.hidden_size)
        if instruction_ids is not None:
            t = instruction_ids.shape[1]
            if t > cfg.max_position_embeddings:
                raise ValueError(f"{t} Q-Former instruction ids exceed its "
                                 f"{cfg.max_position_embeddings} positions")
            text = embed(self.word_embed, instruction_ids, self.word_embed.dtype)
            text = text + self.pos_embed[:t][None]
            x = torch.cat([queries, text.to(dt)], dim=1)
            tmask = (instruction_mask.bool() if instruction_mask is not None
                     else torch.ones((b, t), dtype=torch.bool, device=dev))
            full = torch.cat([torch.ones((b, nq), dtype=torch.bool, device=dev), tmask], dim=1)
        else:
            x = queries
            full = torch.ones((b, nq), dtype=torch.bool, device=dev)
        x = layer_norm(x, self.emb_ln.weight, self.emb_ln.bias, eps)
        s = x.shape[1]
        self_mask = (full[:, None, :] & full[:, :, None])[:, None]
        feats = image_features.to(dt)
        for layer in self.layers:
            sa = layer.self_attn
            x = layer_norm(x + sa(x, x, cfg.num_heads, self_mask), sa.ln.weight, sa.ln.bias, eps)
            if layer.cross_attn is not None:
                ca = layer.cross_attn
                q_part = x[:, :nq]
                q_part = layer_norm(q_part + ca(q_part, feats, cfg.num_heads), ca.ln.weight,
                                    ca.ln.bias, eps)
                x = torch.cat([q_part, x[:, nq:]], dim=1)
            q_part = layer.ffn_query(x[:, :nq], eps)
            x = torch.cat([q_part, layer.ffn(x[:, nq:], eps)], dim=1) if s > nq else q_part
        return x[:, :nq]
