"""DPO training step (counterpart of vlrlhf_tpu/train/dpo.py: DPOConfig,
dpo_step_fn, make_ref_logps_fn, precompute_ref_logps, make_dpo_eval_fn).

One step, as in the JAX package:
  - with a frozen vision tower (`frozen_vision`, the default) the tower
    encodes each pair's images once, outside autograd, and the features are
    tiled to the [chosen; rejected] rows; unfrozen, the per-pair images are
    tiled to the 2B rows (`tile_pair_images`) and the tower runs inside
    every forward: under autograd with the adapters on in the policy
    forward, under no_grad with them off in the reference forward;
  - the reference logps come from the batch (precomputed), are zero
    (reference_free), or come from the same model with adapters off under
    no_grad — the same kernels as the policy forward, so with b = 0 the
    first loss is exactly ln 2;
  - the policy forward with adapters on, the loss, the backward into the
    LoRA adapters, the gradients' global norm and the optimizer update.
The metrics come back as 0-dim tensors on the device; the caller reads them
once per logging step.

Under sequence parallelism (core/mesh.py) each rank's forward holds a
slice of every row: its logps and logits sums are summed over the ring
(train/losses.py), so the loss is whole and equal on every rank of it,
and each rank's backward gives the partials of its slice. The gradient
rule is then a sum over the ring and a mean over `data`, where FSDP2's
reduction takes the mean over data x fsdp: the loss is scaled by the
ring's size before the backward (core/partitioning.py). `make_dpo_eval_fn` is the holdout pass: the same
loss with no update, the tower run as the step runs it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vlrlhf_torch.core.dist import dp_rows, ring_size, sp_shard, sum_over_sp
from vlrlhf_torch.lora.lora import lora_parameters
from vlrlhf_torch.models.common import Ctx, fold_seed
from vlrlhf_torch.models.vlm import VLM, image_inputs
from vlrlhf_torch.train.losses import batch_logps, chunked_logps, dpo_loss
from vlrlhf_torch.train.train_state import OptimizerConfig, TrainState, apply_updates


@dataclasses.dataclass(frozen=True)
class DPOConfig:
    beta: float = 0.1
    label_smoothing: float = 0.0
    loss_type: str = "sigmoid"  # sigmoid | ddpo | hinge | ipo | kto_pair
    reference_free: bool = False
    lora_scale: float = 0.25  # alpha / r
    # LoRA dropout on the policy forward only (the reference forward is
    # adapter-off, so dropout never touches it)
    lora_dropout: float = 0.0
    dropout_seed: int = 0
    # the tower is frozen: its features are computed once per pair outside
    # autograd; False runs it inside each forward on the tiled images
    frozen_vision: bool = True
    # > 0: logps through losses.chunked_logps over S-chunks of this size,
    # never materializing (B, S, V) logits; 0 = one lm_head matmul
    logits_chunk: int = 0

    @property
    def average_log_prob(self) -> bool:
        return self.loss_type == "ipo"


def batch_to_device(batch: dict, device) -> dict:
    """Numpy collator output -> tensors on `device` (dtypes kept)."""
    return {k: torch.from_numpy(np.array(v)).to(device, non_blocking=True)
            for k, v in batch.items() if v is not None}


@torch.no_grad()
def pair_image_features(model: VLM, batch: dict) -> Optional[torch.Tensor]:
    """The frozen tower's features for each pair's images, tiled to the
    [chosen; rejected] rows: (2B, n_tok, H), or None. A pair's features
    are computed once, with the pair's own Q-Former instruction
    (InstructBLIP's depend on it) and gathered through its anyres map
    (LLaVA-Next)."""
    pv = batch.get("pixel_values")
    if pv is None:
        return None
    feats = model.row_features(pv, None, **image_inputs(batch))
    return torch.cat([feats, feats], dim=0)


PAIR_IMAGE_KEYS = ("pixel_values", "anyres_gather", "qformer_input_ids", "qformer_mask")


def tile_pair_images(batch: dict) -> dict:
    """The batch with its per-pair image inputs (B pairs: pixel_values and
    the anyres / Q-Former fields) tiled to the 2B [chosen; rejected] rows
    (vlrlhf_tpu `_tile_pair_images`)."""
    n2 = batch["input_ids"].shape[0]
    out = dict(batch)
    for k in PAIR_IMAGE_KEYS:
        v = batch.get(k)
        if v is not None and v.shape[0] * 2 == n2:
            out[k] = torch.cat([v, v], dim=0)
    return out


def forward_logps(model: VLM, dcfg: DPOConfig, batch: dict, ctx: Ctx,
                  image_features: Optional[torch.Tensor]):
    """(logps (2B,), per-row f32 logits mean (2B,)) for the batch's rows.
    Without image features the tower runs on the batch's (tiled)
    pixel_values under `ctx`."""
    loss_mask = batch.get("loss_mask") if dcfg.loss_type == "ddpo" else None
    hidden, _ = model(
        batch["input_ids"], image_positions=batch.get("image_positions"),
        pad_mask=batch["pad_mask"], ctx=ctx, image_features=image_features,
        pixel_values=None if image_features is not None else batch.get("pixel_values"),
        **({} if image_features is not None else image_inputs(batch)),
    )
    s, v = batch["input_ids"].shape[1], model.cfg.lm.vocab_size  # the whole sequence's S
    sp = sp_shard()
    if dcfg.logits_chunk:
        logps, logits_sum = chunked_logps(
            hidden, batch["labels"], model.head_fn(ctx),
            average_log_prob=dcfg.average_log_prob, loss_mask=loss_mask,
            chunk=dcfg.logits_chunk, sp=sp,
        )
        return logps, logits_sum / (s * v)
    logits = model.head(hidden, ctx)
    logps = batch_logps(logits, batch["labels"], average_log_prob=dcfg.average_log_prob,
                        loss_mask=loss_mask, sp=sp)
    if sp is not None:
        return logps, sum_over_sp(logits.float().sum(dim=(1, 2)), sp) / (s * v)
    return logps, logits.float().mean(dim=(1, 2))


def dpo_step(model: VLM, dcfg: DPOConfig, ocfg: OptimizerConfig, state: TrainState,
             batch: dict) -> dict:
    """One DPO update of the LoRA adapters `state.trainable` (which are the
    model's adapter parameters). `batch` holds tensors on the model's
    device. Returns the metrics of vlrlhf_tpu's dpo_step_fn as 0-dim
    tensors; the adapters' .grad hold this step's gradients afterwards."""
    n_pairs = batch["input_ids"].shape[0] // 2
    feats = None
    if dcfg.frozen_vision:
        feats = pair_image_features(model, batch)
    else:
        batch = tile_pair_images(batch)

    if dcfg.reference_free:
        ref_chosen = ref_rejected = torch.zeros((n_pairs,), device=model.device)
    elif batch.get("ref_chosen_logps") is not None:
        ref_chosen, ref_rejected = batch["ref_chosen_logps"], batch["ref_rejected_logps"]
    else:
        with torch.no_grad():
            ref, _ = forward_logps(model, dcfg, batch, Ctx(), feats)
        ref_chosen, ref_rejected = ref[:n_pairs], ref[n_pairs:]

    seed = None
    if dcfg.lora_dropout > 0.0:
        # a per-step stream: step k always draws step k's masks
        seed = fold_seed(dcfg.dropout_seed, state.step)
    ctx = Ctx(adapters=True, lora_scale=dcfg.lora_scale, lora_dropout=dcfg.lora_dropout,
              dropout_seed=seed, rows=dp_rows(batch["input_ids"].shape[0], pairs=True))
    for p in state.trainable:
        p.grad = None
    logps, logits = forward_logps(model, dcfg, batch, ctx, feats)
    pc, pr = logps[:n_pairs], logps[n_pairs:]
    out = dpo_loss(pc, pr, ref_chosen, ref_rejected, beta=dcfg.beta,
                   label_smoothing=dcfg.label_smoothing, loss_type=dcfg.loss_type,
                   reference_free=dcfg.reference_free)
    n_ring = ring_size()
    (out.loss * n_ring if n_ring > 1 else out.loss).backward()  # the ring's partials summed
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.trainable]
    metrics = {
        "loss": out.loss.detach(),
        "rewards/chosen": out.chosen_rewards.mean(),
        "rewards/rejected": out.rejected_rewards.mean(),
        "rewards/accuracies": (out.chosen_rewards > out.rejected_rewards).float().mean(),
        "rewards/margins": (out.chosen_rewards - out.rejected_rewards).mean(),
        "logps/chosen": pc.detach().mean(),
        "logps/rejected": pr.detach().mean(),
        "logits/chosen": logits[:n_pairs].detach().mean(),
        "logits/rejected": logits[n_pairs:].detach().mean(),
    }
    metrics["grad_norm"] = apply_updates(state, grads, ocfg)
    return metrics


def adapter_params(model: VLM) -> list[torch.nn.Parameter]:
    """The trainable leaves of a LoRA run, in the optimizer's order."""
    return [p for _, p in lora_parameters(model)]


def make_ref_logps_fn(model: VLM, dcfg: DPOConfig):
    """Adapter-off logps for reference precomputation (TRL's
    precompute_ref_log_probs): batch -> (chosen_logps, rejected_logps)."""

    @torch.no_grad()
    def f(batch: dict):
        logps, _ = forward_logps(model, dcfg, batch, Ctx(), pair_image_features(model, batch))
        n = logps.shape[0] // 2
        return logps[:n], logps[n:]

    return f


def precompute_ref_logps(model: VLM, dcfg: DPOConfig, rows: list, tokenize_fn, collator,
                         batch_size: int = 8) -> list:
    """One adapter-off pass over the dataset; each row gains
    ref_chosen_logp / ref_rejected_logp floats, which the collator then
    ships so training steps skip the reference forward. The tail batch is
    padded by repeating its last row, as vlrlhf_tpu does. Under a mesh
    each data-parallel rank computes a contiguous ceil(n / ranks) share of
    the rows in the same number of batches (its model group's collectives
    run in step), and every rank gathers all of them in order (vlrlhf_tpu
    dpo.py:307-332)."""
    from vlrlhf_torch.core.dist import gather_objects
    from vlrlhf_torch.core.mesh import current_mesh

    fn = make_ref_logps_fn(model, dcfg)
    mesh = current_mesh()
    n_dp, dp_rank = (mesh.dp_size, mesh.dp_rank) if mesh is not None else (1, 0)
    per = -(-len(rows) // n_dp)
    mine = list(range(dp_rank * per, min((dp_rank + 1) * per, len(rows))))
    values = []
    for start in range(0, per, batch_size):
        idx = mine[start:start + batch_size]
        real = len(idx)
        idx += [idx[-1] if idx else 0] * (batch_size - real)
        batch = collator([tokenize_fn(rows[i]) for i in idx])
        batch.pop("loss_mask", None)
        c, r = fn(batch_to_device(batch, model.device))
        c, r = torch.stack([c, r]).cpu().tolist()  # one read per batch
        values += [[float(c[k]), float(r[k])] for k in range(real)]
    if mesh is not None:
        values = gather_objects(values, group=mesh.dp_group)
    return [dict(row, ref_chosen_logp=c, ref_rejected_logp=r)
            for row, (c, r) in zip(rows, values)]


def make_dpo_eval_fn(model: VLM, dcfg: DPOConfig):
    """The holdout pass (vlrlhf_tpu `make_dpo_eval_fn`, dpo.py:339-391):
    batch -> {"eval/loss", "eval/rewards_accuracies", "eval/rewards_margins"}
    as 0-dim device tensors, no update. The reference forward has the
    adapters off, the policy forward on, without dropout. The tower runs as
    in `dpo_step`: frozen, its features once per pair; unfrozen, inside each
    forward under that forward's ctx, so tower adapters count in the policy
    as they do in training, the samples and the merged save."""

    @torch.no_grad()
    def f(batch: dict) -> dict:
        n_pairs = batch["input_ids"].shape[0] // 2
        feats = None
        if dcfg.frozen_vision:
            feats = pair_image_features(model, batch)
        else:
            batch = tile_pair_images(batch)
        ref, _ = forward_logps(model, dcfg, batch, Ctx(), feats)
        logps, _ = forward_logps(model, dcfg, batch, Ctx(adapters=True, lora_scale=dcfg.lora_scale),
                                 feats)
        out = dpo_loss(logps[:n_pairs], logps[n_pairs:], ref[:n_pairs], ref[n_pairs:],
                       beta=dcfg.beta, label_smoothing=dcfg.label_smoothing,
                       loss_type=dcfg.loss_type, reference_free=dcfg.reference_free)
        return {
            "eval/loss": out.loss,
            "eval/rewards_accuracies": (out.chosen_rewards > out.rejected_rewards).float().mean(),
            "eval/rewards_margins": (out.chosen_rewards - out.rejected_rewards).mean(),
        }

    return f
