"""VLM assembly: vision tower (+ Q-Former) + projector + LM + static-shape
image merge (counterpart of vlrlhf_tpu/models/vlm.py: `projector_forward`,
`encode_images`, `vlm_embeds`, `vlm_forward`, `lm_head_fn`).

The families' image inputs beside `pixel_values` (B, n_img, H, W, 3):
  - LLaVA-Next anyres: `pixel_values` (B, n_tiles, H, W, 3) holds each
    row's tiles and `anyres_gather` (B, n_tok) maps the tiles' features,
    plus the learned `image_newline` row, to the row's image tokens
    (models/anyres.py);
  - InstructBLIP: `qformer_input_ids` / `qformer_mask` (B * n_img, T), the
    instruction the Q-Former reads beside each image's tower features.
`image_inputs(batch)` picks them out of a collator batch.

Training passes precomputed `image_features` (the frozen tower runs once
per pair, outside autograd), or, with an unfrozen tower, `pixel_values`
tiled to every row, and a `Ctx` that switches the LoRA adapters on or off
(the tower's under ctx.sub("vision"), the LM's under ctx.sub("lm"));
`head_fn` is the chunk head of the chunked logps.

The processor emits exactly `num_image_tokens` placeholder tokens per image
plus an `image_positions` map; projected features land at those positions
(models/common.py merge_multimodal_embeddings). Under sequence parallelism
(core/mesh.py) every rank of a ring builds the whole sequence's
embeddings, the tower, projector, Q-Former or resampler, anyres gather and
image merge replicated on each, and the LM keeps the rank's slice of them
(and of the PLoRA mask); `forward` then returns that slice's hidden
states. For a PLoRA family
(InternLM-XC2) the same map gives the (B, S) mask that gates the
checkpoint's PLoRA to those positions (`Ctx.lora_mask`), in every forward
that takes image positions, adapters on or off (vlrlhf_tpu `vlm_forward`,
models/vlm.py:237-245).

The reward and value heads (`init_rm_head`, `reward_forward`,
`init_value_head`, `value_forward`) are f32 {"kernel" (H, 1)[, "bias"
(1,)]} dicts beside the model, as in vlrlhf_tpu (models/vlm.py:284-322).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

import dataclasses

from vlrlhf_torch.core.dist import sp_shard, sum_over_sp
from vlrlhf_torch.models.anyres import gather_anyres_features
from vlrlhf_torch.models.common import (
    Ctx, Linear, Norm, activation, empty_param, image_position_mask,
    merge_multimodal_embeddings,
)
from vlrlhf_torch.models.config import ProjectorConfig, VLMConfig
from vlrlhf_torch.models.lm.llama import LlamaDecoder
from vlrlhf_torch.models.vision.qformer import QFormer
from vlrlhf_torch.models.vision.resampler import LN_EPS, Resampler
from vlrlhf_torch.models.vision.vit import VisionTower
from vlrlhf_torch.ops.norms import layer_norm

# the families' extra image inputs: collator batch keys and model keywords
IMAGE_INPUT_KEYS = ("anyres_gather", "qformer_input_ids", "qformer_mask")


def image_inputs(batch: dict) -> dict:
    """A batch's anyres / Q-Former inputs (those it holds)."""
    return {k: batch[k] for k in IMAGE_INPUT_KEYS if batch.get(k) is not None}


class Projector(nn.Module):
    """LLaVA's and XC2's mlp2x-GELU projector, InstructBLIP's linear
    language_projection, or Qwen-VL's resampler + ln_post + bias-free
    square proj (vlrlhf_tpu `projector_forward`)."""

    def __init__(self, cfg: ProjectorConfig, device, dtype):
        super().__init__()
        if cfg.kind not in ("mlp2x_gelu", "linear", "resampler"):
            raise ValueError(f"projector kind {cfg.kind!r}: expected mlp2x_gelu, linear "
                             "or resampler")
        self.kind = cfg.kind
        if cfg.kind == "resampler":
            d = cfg.out_dim
            self.resampler = Resampler(d, cfg.num_heads, cfg.in_dim, cfg.num_queries,
                                       device, dtype)
            self.ln_post = Norm(d, True, device, dtype)
            self.proj = Linear(d, d, False, device, dtype)
            return
        self.fc1 = Linear(cfg.in_dim, cfg.out_dim, True, device, dtype)
        self.fc2 = (Linear(cfg.out_dim, cfg.out_dim, True, device, dtype)
                    if cfg.kind == "mlp2x_gelu" else None)
        self.act = activation(cfg.act)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "resampler":
            x = self.resampler(x)
            x = layer_norm(x, self.ln_post.weight, self.ln_post.bias, LN_EPS)
            return self.proj(x)
        x = self.fc1(x)
        return x if self.fc2 is None else self.fc2(self.act(x))


class VLM(nn.Module):
    def __init__(self, cfg: VLMConfig, device="cpu"):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg.vision, device)
        self.qformer = QFormer(cfg.qformer, device) if cfg.qformer is not None else None
        self.projector = Projector(cfg.projector, device, cfg.lm.dtype)
        self.lm = LlamaDecoder(cfg.lm, device)
        # LLaVA-Next's learned row after each row of unpadded tile features
        self.image_newline = (empty_param((cfg.lm.hidden_size,), device, cfg.lm.dtype)
                              if cfg.grid_pinpoints else None)

    @property
    def device(self) -> torch.device:
        return self.lm.embed_tokens.device

    def drop_vision_(self) -> None:
        """Free the tower and projector: the model becomes a text-only LM
        (an LLM judge's), whose image inputs are ignored."""
        self.vision = self.projector = self.qformer = None

    def encode_images(self, pixel_values: torch.Tensor, ctx: Optional[Ctx] = None,
                      qformer_input_ids: Optional[torch.Tensor] = None,
                      qformer_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, H, W, 3) uint8 or normalized float -> (N, num_image_tokens,
        lm_hidden). uint8 pixels are rescaled and normalized here; `ctx`
        is the VLM-level context (the tower runs under ctx.sub("vision")).
        With a Q-Former, `qformer_input_ids` / `qformer_mask` (N, T) are each
        image's instruction (None: the queries alone)."""
        cfg = self.cfg
        if pixel_values.dtype == torch.uint8:
            x = pixel_values.float() / 255.0
            mean = torch.tensor(cfg.image_mean, dtype=torch.float32, device=x.device)
            std = torch.tensor(cfg.image_std, dtype=torch.float32, device=x.device)
            pixel_values = ((x - mean) / std).to(cfg.lm.dtype)
        vctx = (ctx or Ctx()).sub("vision")
        if vctx.rows is not None:  # image rows: a rank's draw their own dropout masks
            vctx = dataclasses.replace(vctx, rows=None)
        feats = self.vision(pixel_values, vctx)
        if self.qformer is not None:
            feats = self.qformer(feats, qformer_input_ids, qformer_mask)
        return self.projector(feats)

    def row_features(self, pixel_values: torch.Tensor, ctx: Optional[Ctx] = None,
                     anyres_gather: Optional[torch.Tensor] = None,
                     qformer_input_ids: Optional[torch.Tensor] = None,
                     qformer_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, n_img | n_tiles, H, W, 3) -> (B, n_tok, lm_hidden), the rows
        the merge places at image_positions: each row's images' features
        in order, or with `anyres_gather` (B, n_tok) its tiles' features
        gathered with the newline rows (vlrlhf_tpu `vlm_embeds`). The
        frozen tower's entry outside `forward`: under a mesh an FSDP2
        forward method (core/partitioning.py), so `embeds` calls the body."""
        return self._row_features(pixel_values, ctx, anyres_gather, qformer_input_ids,
                                  qformer_mask)

    def _row_features(self, pixel_values, ctx, anyres_gather, qformer_input_ids, qformer_mask):
        b, n_img = pixel_values.shape[:2]
        flat = pixel_values.reshape(b * n_img, *pixel_values.shape[2:])
        feats = self.encode_images(flat, ctx, qformer_input_ids, qformer_mask)
        if anyres_gather is not None:
            return gather_anyres_features(feats.reshape(b, -1, feats.shape[-1]),
                                          anyres_gather, self.image_newline)
        return feats.reshape(b, n_img * self.cfg.num_image_tokens, -1)

    def embeds(
        self,
        input_ids: torch.Tensor,  # (B, S) — placeholders already expanded
        pixel_values: Optional[torch.Tensor] = None,  # (B, n_img | n_tiles, H, W, 3)
        image_positions: Optional[torch.Tensor] = None,  # (B, n_tok); -1 = unused
        image_features: Optional[torch.Tensor] = None,  # (B, n_tok, H) precomputed
        ctx: Optional[Ctx] = None,
        anyres_gather: Optional[torch.Tensor] = None,  # (B, n_tok) LLaVA-Next
        qformer_input_ids: Optional[torch.Tensor] = None,  # (B * n_img, T) InstructBLIP
        qformer_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Token embeddings with image features merged in; precomputed
        `image_features` skip the tower."""
        embeds = self.lm.embed(input_ids)
        if (pixel_values is None and image_features is None) or self.vision is None:
            return embeds
        if image_positions is None:
            raise ValueError("image inputs need image_positions")
        if image_features is None:
            image_features = self._row_features(pixel_values, ctx, anyres_gather,
                                               qformer_input_ids, qformer_mask)
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
        anyres_gather: Optional[torch.Tensor] = None,
        qformer_input_ids: Optional[torch.Tensor] = None,
        qformer_mask: Optional[torch.Tensor] = None,
    ):
        """vlm_forward: returns (final-normed hidden (B, S, H), cache or
        None); with `cache_len` the empty-prefill mode (a bf16 or int8
        cache), without it the training forward. `ctx` switches the
        adapters on or off in both; a PLoRA family's image positions add
        the PLoRA mask to it. Logits come from `head`."""
        embeds = self.embeds(input_ids, pixel_values, image_positions, image_features, ctx,
                             anyres_gather, qformer_input_ids, qformer_mask)
        if self.cfg.plora and image_positions is not None:
            ctx = dataclasses.replace(
                ctx or Ctx(), lora_mask=image_position_mask(image_positions, input_ids.shape[1]))
        lm_ctx = ctx.sub("lm") if ctx is not None else None
        return self.lm(embeds, pad_mask=pad_mask, cache_len=cache_len, ctx=lm_ctx,
                       kv_cache_dtype=kv_cache_dtype)

    def head(self, hidden: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        return self.lm.head(hidden, ctx.sub("lm") if ctx is not None else None)

    def head_fn(self, ctx: Optional[Ctx] = None):
        """(B, C, H) -> (B, C, V): the chunk head of train/losses.py
        chunked_logps (vlrlhf_tpu `lm_head_fn`)."""
        return lambda hc: self.head(hc, ctx)


# reward / value heads


def init_rm_head(hidden_size: int, device="cpu") -> dict[str, torch.Tensor]:
    """Zero (H, 1) f32 kernel scoring the last real token (vlrlhf_tpu
    `init_rm_head`: the reference's zero-initialised VLRewardModel head)."""
    return {"kernel": nn.Parameter(torch.zeros((hidden_size, 1), device=device))}


def last_token_scores(hidden: torch.Tensor, kernel: torch.Tensor, pad_mask: torch.Tensor,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B,) head scores at each row's last real token, sum(pad_mask) - 1
    (rows right-padded), the product taken in `dtype`. Under sequence
    parallelism `hidden` is this rank's slice of the (whole) `pad_mask`'s
    sequence: the rank holding a row's last token gives its score, the
    others 0, summed over the ring (core/dist.py sum_over_sp)."""
    scores = (hidden.to(dtype) @ kernel.to(dtype))[..., 0]  # (B, S) or (B, S/n)
    last = pad_mask.long().sum(dim=1) - 1
    sp = sp_shard()
    if sp is None:
        return scores.gather(1, last[:, None])[:, 0]
    lo, hi = sp.span(pad_mask.shape[1])
    here = (last >= lo) & (last < hi)
    got = scores.gather(1, (last - lo).clamp(0, hi - lo - 1)[:, None])[:, 0]
    return sum_over_sp(torch.where(here, got, torch.zeros_like(got)), sp)


def reward_forward(model: VLM, rm_head: dict, pad_mask: torch.Tensor,
                   ctx: Optional[Ctx] = None, **kwargs) -> torch.Tensor:
    """Scalar reward per sequence (vlrlhf_tpu `reward_forward`): the head on
    the last non-pad hidden state, in the hidden states' dtype. kwargs are
    the model's (input_ids, pixel_values, image_positions, ...)."""
    hidden, _ = model(pad_mask=pad_mask, ctx=ctx, **kwargs)
    return last_token_scores(hidden, rm_head["kernel"], pad_mask, hidden.dtype)


def init_value_head(hidden_size: int, device="cpu") -> dict[str, torch.Tensor]:
    """PPO's value head with a bias, both zero (vlrlhf_tpu `init_value_head`:
    init_linear at scale 0)."""
    return {"kernel": nn.Parameter(torch.zeros((hidden_size, 1), device=device)),
            "bias": nn.Parameter(torch.zeros((1,), device=device))}


def value_forward(hidden: torch.Tensor, v_head: dict) -> torch.Tensor:
    """(B, S) values: hidden in f32 @ kernel (+ bias when the head has one;
    `cmd_ppo`'s own head has none)."""
    values = (hidden.float() @ v_head["kernel"].float())[..., 0]
    if "bias" in v_head:
        values = values + v_head["bias"][0]
    return values
