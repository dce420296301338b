"""VLM assembly: vision tower + projector + LM + static-shape image merge
(counterpart of vlrlhf_tpu/models/vlm.py: `projector_forward`,
`encode_images`, `vlm_embeds`, `vlm_forward`, `lm_head_fn`).

The processor emits exactly `num_image_tokens` placeholder tokens per image
plus an `image_positions` map; projected features land at those positions
(models/common.py merge_multimodal_embeddings).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlrlhf_torch.models.common import Linear, merge_multimodal_embeddings
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
    ) -> torch.Tensor:
        """Token embeddings with image features merged in."""
        embeds = self.lm.embed(input_ids)
        if pixel_values is None:
            return embeds
        if image_positions is None:
            raise ValueError("pixel_values need image_positions")
        b, n_img = pixel_values.shape[:2]
        flat = pixel_values.reshape(b * n_img, *pixel_values.shape[2:])
        feats = self.encode_images(flat).reshape(
            b, n_img * self.cfg.num_image_tokens, -1
        )
        return merge_multimodal_embeddings(embeds, feats, image_positions)

    def forward(
        self,
        input_ids: torch.Tensor,
        pixel_values: Optional[torch.Tensor] = None,
        image_positions: Optional[torch.Tensor] = None,
        pad_mask: Optional[torch.Tensor] = None,
        cache_len: Optional[int] = None,
    ):
        """vlm_forward in empty-prefill mode: returns (final-normed hidden
        (B, S, H), cache or None). Logits come from `head`."""
        embeds = self.embeds(input_ids, pixel_values, image_positions)
        return self.lm(embeds, pad_mask=pad_mask, cache_len=cache_len)

    def head(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.lm.head(hidden)
