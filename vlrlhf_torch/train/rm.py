"""Reward-model training step (counterpart of vlrlhf_tpu/train/rm.py:
RMConfig, rm_scores, rm_step_fn).

The Bradley-Terry loss over a [chosen; rejected] batch, each row scored by
a scalar head on its last real token's hidden state (rows right-padded,
the product in f32). The trainable leaves are the LoRA adapters plus the
head's (H, 1) kernel (the reference's `modules_to_save=['rm_head']`). The
frozen tower encodes each pair's images once, outside autograd, and the
features are tiled to both rows (train/dpo.py `pair_image_features`).
Metrics: loss, accuracy, reward/chosen, reward/rejected, grad_norm.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vlrlhf_torch.core.dist import all_reduce_mean, dp_rows, dp_size, grad_group, ring_size
from vlrlhf_torch.models.common import Ctx, fold_seed
from vlrlhf_torch.models.vlm import VLM, image_inputs, last_token_scores
from vlrlhf_torch.train.dpo import pair_image_features
from vlrlhf_torch.train.losses import rm_loss
from vlrlhf_torch.train.train_state import OptimizerConfig, TrainState, apply_updates


@dataclasses.dataclass(frozen=True)
class RMConfig:
    lora_scale: float = 0.25
    lora_dropout: float = 0.0
    dropout_seed: int = 0


def rm_scores(model: VLM, kernel: torch.Tensor, batch: dict, ctx: Optional[Ctx],
              image_features: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) f32 rewards: the head `kernel` (H, 1) on each row's last real
    token. Without image features the tower runs on the batch's
    pixel_values under `ctx`."""
    hidden, _ = model(
        batch["input_ids"], image_positions=batch.get("image_positions"),
        pad_mask=batch["pad_mask"], ctx=ctx, image_features=image_features,
        pixel_values=None if image_features is not None else batch.get("pixel_values"),
        **({} if image_features is not None else image_inputs(batch)),
    )
    return last_token_scores(hidden, kernel, batch["pad_mask"])


def rm_step(model: VLM, rcfg: RMConfig, ocfg: OptimizerConfig, state: TrainState,
            head: torch.Tensor, batch: dict) -> dict:
    """One update of `state.trainable`: the model's adapters and `head`, the
    rm_head kernel, which is one of its leaves."""
    n = batch["input_ids"].shape[0] // 2
    feats = pair_image_features(model, batch)
    seed = None
    if rcfg.lora_dropout > 0.0:
        seed = fold_seed(rcfg.dropout_seed, state.step)
    ctx = Ctx(adapters=True, lora_scale=rcfg.lora_scale, lora_dropout=rcfg.lora_dropout,
              dropout_seed=seed, rows=dp_rows(batch["input_ids"].shape[0], pairs=True))
    for p in state.trainable:
        p.grad = None
    scores = rm_scores(model, head, batch, ctx, feats)
    chosen, rejected = scores[:n], scores[n:]
    loss = rm_loss(chosen, rejected)
    n_ring = ring_size()
    (loss * n_ring if n_ring > 1 else loss).backward()  # the ring's partials summed (train/dpo.py)
    if dp_size() * n_ring > 1 and head.grad is not None:
        # the head is replicated, outside FSDP2: its gradient's mean over
        # the ranks FSDP2 reduces over is the global batch's, as theirs is
        head.grad = all_reduce_mean(head.grad, grad_group())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.trainable]
    chosen, rejected = chosen.detach(), rejected.detach()
    metrics = {
        "loss": loss.detach(),
        "accuracy": (chosen > rejected).float().mean(),
        "reward/chosen": chosen.mean(),
        "reward/rejected": rejected.mean(),
    }
    metrics["grad_norm"] = apply_updates(state, grads, ocfg)
    return metrics
