"""SFT training step (counterpart of vlrlhf_tpu/train/sft.py: SFTConfig,
sft_step_fn).

The causal-LM loss over the assistant tokens (labels not LABEL_PAD, inside
the pad mask), in one of two modes:
  - 'adapter': the LoRA adapters the model's Linears hold train (LoRA
    dropout seeded per step, as the DPO step seeds it);
  - 'full': every parameter but the vision tower's trains (vlrlhf_tpu's
    `freeze_patterns=(r"^vision/",)`): `full_parameters` gives the
    trainable leaves, f32 masters. The tower still runs under autograd, as
    in vlrlhf_tpu, so the step's grad_norm counts its gradients while the
    clip and the update see the trainable leaves only (optax.masked).
With `logits_chunk` the lm_head and the CE run per S-chunk
(losses.chunked_logps) and the (B, S, V) logits never exist. Metrics come
back as 0-dim device tensors: loss, ppl, grad_norm.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from vlrlhf_torch.core.dist import all_reduce_sum, dp_group, dp_rows, dp_size, ring_size, sp_shard
from vlrlhf_torch.models.common import Ctx, fold_seed
from vlrlhf_torch.models.vlm import VLM, image_inputs
from vlrlhf_torch.train.losses import LABEL_PAD, chunked_logps, sft_loss_terms
from vlrlhf_torch.train.train_state import OptimizerConfig, TrainState, apply_updates, global_norm


@dataclasses.dataclass(frozen=True)
class SFTConfig:
    lora_scale: float = 0.25
    mode: str = "adapter"  # 'adapter' | 'full'
    lora_dropout: float = 0.0
    dropout_seed: int = 0
    # > 0: chunked lm_head + CE over S-chunks of this size
    logits_chunk: int = 0


def full_parameters(model: VLM) -> tuple[list[torch.nn.Parameter], list[torch.nn.Parameter]]:
    """Full fine-tuning's leaves: (trainable, frozen). Everything under
    `vision.` is frozen; every leaf gets requires_grad so the frozen
    tower's gradients reach grad_norm as vlrlhf_tpu's do."""
    train, frozen = [], []
    for name, p in model.named_parameters():
        p.requires_grad_(True)
        (frozen if name.startswith("vision.") else train).append(p)
    return train, frozen


def sft_step(model: VLM, scfg: SFTConfig, ocfg: OptimizerConfig, state: TrainState,
             batch: dict, frozen: Optional[list] = None) -> dict:
    """One SFT update of `state.trainable` (the adapters, or in 'full' mode
    `full_parameters`' trainable leaves, whose frozen list is `frozen`)."""
    if scfg.mode not in ("adapter", "full"):
        raise ValueError(f"SFT mode {scfg.mode!r}: expected 'adapter' or 'full'")
    frozen = frozen or []
    if scfg.mode == "adapter":
        seed = None
        if scfg.lora_dropout > 0.0:
            seed = fold_seed(scfg.dropout_seed, state.step)
        ctx = Ctx(adapters=True, lora_scale=scfg.lora_scale, lora_dropout=scfg.lora_dropout,
                  dropout_seed=seed, rows=dp_rows(batch["input_ids"].shape[0], pairs=False))
    else:
        ctx = Ctx()
    for p in (*state.trainable, *frozen):
        p.grad = None
    hidden, _ = model(batch["input_ids"], batch.get("pixel_values"), batch.get("image_positions"),
                      batch["pad_mask"], ctx=ctx, **image_inputs(batch))
    sp = sp_shard()
    if scfg.logits_chunk:
        logps, _ = chunked_logps(hidden, batch["labels"], model.head_fn(ctx),
                                 loss_mask=batch["pad_mask"], chunk=scfg.logits_chunk, sp=sp)
        mask = (batch["labels"][:, 1:] != LABEL_PAD) & batch["pad_mask"][:, 1:].bool()
        nll_sum, count = -logps.sum(), mask.sum()
    else:
        nll_sum, count = sft_loss_terms(model.head(hidden, ctx), batch["labels"],
                                        batch["pad_mask"], sp=sp)
    n_dp, n_ring = dp_size(), ring_size()
    if n_dp > 1 or sp is not None:
        # the token mean of the global batch: the data-parallel ranks' sums
        # (each whole over its split) over their summed count; FSDP2
        # averages the gradients over the n_dp x n_ring ranks, which sums a
        # ring's partials and averages the replicas (the model split's
        # partials are summed by the optimizer: train/train_state.py)
        total = all_reduce_sum(count.float(), dp_group()).clamp(min=1)
        (nll_sum / total * (n_dp * n_ring)).backward()
        loss = all_reduce_sum(nll_sum.detach(), dp_group()) / total
    else:
        loss = nll_sum / count.clamp(min=1)
        loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.trainable]
    metrics = {"loss": loss.detach(), "ppl": torch.exp(loss.detach())}
    if frozen:
        metrics["grad_norm"] = global_norm(grads + [p.grad for p in frozen if p.grad is not None])
        apply_updates(state, grads, ocfg)
        for p in frozen:
            p.grad = None
    else:
        metrics["grad_norm"] = apply_updates(state, grads, ocfg)
    return metrics
