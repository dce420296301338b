"""VLM assembly: vision tower + projector + LM + static-shape image merge
(counterpart of vlrlhf_tpu/models/vlm.py: `projector_forward`,
`encode_images`, `vlm_embeds`, `vlm_forward`, `lm_head_fn`).

Training passes precomputed `image_features` (the frozen tower runs once
per pair, outside autograd) and a `Ctx` that switches the LM's LoRA
adapters on or off; `head_fn` is the chunk head of the chunked logps.

The processor emits exactly `num_image_tokens` placeholder tokens per image
plus an `image_positions` map; projected features land at those positions
(models/common.py merge_multimodal_embeddings).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlrlhf_torch.models.common import Ctx, Linear, merge_multimodal_embeddings
from vlrlhf_torch.models.config import ProjectorConfig, VLMConfig
from vlrlhf_torch.models.lm.llama import LlamaDecoder
from vlrlhf_torch.models.vision.vit import VisionTower


class Projector(nn.Module):
    """LLaVA's mlp2x-GELU projector (vlrlhf_tpu `projector_forward`)."""

    def __init__(self, cfg: ProjectorConfig, device, dtype):
        super().__init__()
        if cfg.kind != "mlp2x_gelu":
            raise ValueError(f"projector kind {cfg.kind!r} is not ported yet")
        self.fc1 = Linear(cfg.in_dim, cfg.out_dim, True, device, dtype)
        self.fc2 = Linear(cfg.out_dim, cfg.out_dim, True, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # jax.nn.gelu defaults to the tanh approximation
        return self.fc2(F.gelu(self.fc1(x), approximate="tanh"))


class VLM(nn.Module):
    def __init__(self, cfg: VLMConfig, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision, device)
        self.projector = Projector(cfg.projector, device, cfg.lm.dtype)
        self.lm = LlamaDecoder(cfg.lm, device)

    @property
    def device(self) -> torch.device:
        return self.lm.embed_tokens.device

    def encode_images(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(N, H, W, 3) uint8 or normalized float -> (N, num_image_tokens,
        lm_hidden). uint8 pixels are rescaled and normalized here."""
        cfg = self.cfg
        if pixel_values.dtype == torch.uint8:
            x = pixel_values.float() / 255.0
            mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(cfg.image_std, dtype=torch.float32, device=x.device)
            pixel_values = ((x - mean) / std).to(cfg.lm.dtype)
        return self.projector(self.vision(pixel_values))

    def embeds(
        self,
        input_ids: torch.Tensor,  # (B, S) — placeholders already expanded
        pixel_values: Optional[torch.Tensor] = None,  # (B, n_img, H, W, 3)
        image_positions: Optional[torch.Tensor] = None,  # (B, n_img*N_tok)
        image_features: Optional[torch.Tensor] = None,  # (B, n_img*N_tok, H) precomputed
    ) -> torch.Tensor:
        """Token embeddings with image features merged in; precomputed
        `image_features` skip the tower."""
        embeds = self.lm.embed(input_ids)
        if pixel_values is None and image_features is None:
            return embeds
        if image_positions is None:
            raise ValueError("image inputs need image_positions")
        if image_features is None:
            b, n_img = pixel_values.shape[:2]
            flat = pixel_values.reshape(b * n_img, *pixel_values.shape[2:])
            image_features = self.encode_images(flat).reshape(
                b, n_img * self.cfg.num_image_tokens, -1
            )
        return merge_multimodal_embeddings(embeds, image_features, image_positions)

    def forward(
        self,
        input_ids: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
        image_positions: Optional[torch.Tensor] = None,
        pad_mask: Optional[torch.Tensor] = None,
        cache_len: Optional[int] = None,
        ctx: Optional[Ctx] = None,
        image_features: Optional[torch.Tensor] = None,
        kv_cache_dtype: str = "bf16",
    ):
        """vlm_forward: returns (final-normed hidden (B, S, H), cache or
        None); with `cache_len` the empty-prefill mode (a bf16 or int8
        cache), without it the training forward under `ctx`. Logits come
        from `head`."""
        embeds = self.embeds(input_ids, pixel_values, image_positions, image_features)
        lm_ctx = ctx.sub("lm") if ctx is not None else None
        return self.lm(embeds, pad_mask=pad_mask, cache_len=cache_len, ctx=lm_ctx,
                       kv_cache_dtype=kv_cache_dtype)

    def head(self, hidden: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        return self.lm.head(hidden, ctx.sub("lm") if ctx is not None else None)

    def head_fn(self, ctx: Optional[Ctx] = None):
        """(B, C, H) -> (B, C, V): the chunk head of train/losses.py
        chunked_logps (vlrlhf_tpu `lm_head_fn`)."""
        return lambda hc: self.head(hc, ctx)
