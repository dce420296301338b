"""PPO training (counterpart of vlrlhf_tpu/train/ppo.py: PPOConfig,
masked_mean, masked_whiten, RolloutStats, _token_logprobs,
_forward_logps_and_values, compute_rollout_stats, ppo_update_fn,
rollout_to_batch, ppo_update_epochs, RunningMoments, preprocess_scores,
AdaptiveKLController).

One outer step (cli/main.py `train_ppo` drives it):
  1. rollout: a generation engine samples responses with the policy's
     adapters on (the model's own `lora_a` / `lora_b`, so each step samples
     with the adapters of the last update);
  2. score: a reward model's adapters and head on the same base
     (train/rm.py rm_scores under the named set "reward"), or a synthetic
     reward;
  3. stats (`compute_rollout_stats`, under no_grad): policy logprobs and
     values, adapter-off reference logprobs, the per-token KL penalty, the
     sequence score on the last response token, GAE advantages and returns;
  4. update (`ppo_update_epochs`): ppo_epochs passes over shuffled
     minibatches, each one clipped-PG + clipped-value optimizer step;
  5. the adaptive KL controller on the host.

The value head rides the policy's trunk, or with value adapters
(`value_adapters=True`, the reference's use_value_adapter) a second trunk
pass under the named set VALUE_SET. The set a pass uses travels in its Ctx,
so torch.utils.checkpoint's recompute in the backward reads the same set.

Rollout tokens come to the host (`rollout_to_batch`, numpy), so nothing
made under an engine's inference_mode enters autograd; the stats pass runs
under no_grad and its tensors feed the update loss as constants. GAE's
reversed scan runs on the host in f32 numpy (`gae_host`): one device read
of the deltas instead of a few thousand per-position launches.

Right-padded rows throughout: prompt tokens, then response tokens.

Under a mesh (core/mesh.py) each data-parallel rank holds the global
rollout batch but runs the stats pass on its own rows; the statistics the
step takes over rows are global, as vlrlhf_tpu's over its sharded batch:
the whitening's mean and variance and the mean KL (`group`: sums
all-reduced over the data-parallel group), and the update's masked means,
whose denominators are the global minibatch's token counts
(`ppo_update`), each rank stepping on its share of every global minibatch
(`ppo_update_epochs`). GAE stays on the host, per row. Under a pipeline
(--mesh_pipe) every trunk pass here runs through the GPipe schedule
(models/lm/pipeline.py): the policy, value and reference forwards of the
stats pass and the update's, at the same slices of rows; the value head
is a leaf after the stack and the value adapters a stage's. Under a
sequence split (--sequence_parallel_axis fsdp or model) the stats pass
computes the per-token logps and values on a rank's slice of the
positions and gathers them whole before the score, the KL penalty, GAE
and the whitening; the update takes its per-token terms on the slice and
sums them over the split.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from vlrlhf_torch.core.dist import (
    all_reduce_mean, all_reduce_sum, dp_gather_rows, dp_group, dp_rank, dp_size, gather_seq,
    grad_group, ring_size, sp_shard, sum_over_sp,
)
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.vlm import IMAGE_INPUT_KEYS, VLM, image_inputs, value_forward
from vlrlhf_torch.train.losses import _gather_clipped, chunked_token_logps
from vlrlhf_torch.train.train_state import OptimizerConfig, TrainState, apply_updates

VALUE_SET = "value"  # the named adapter set of --use_value_adapter


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    lora_scale: float = 0.25
    init_kl_coef: float = 0.2
    target_kl: float = 6.0
    kl_horizon: int = 10000
    adaptive_kl: bool = True
    gamma: float = 1.0
    lam: float = 0.95
    cliprange: float = 0.2
    cliprange_value: float = 0.2
    vf_coef: float = 0.1
    ppo_epochs: int = 4
    minibatch_size: int = 0  # 0 = the full batch
    whiten_advantages: bool = True
    score_clip: Optional[float] = None
    use_score_scaling: bool = False
    use_score_norm: bool = False
    # > 0: per-token logps through losses.chunked_token_logps, the (B, L, V)
    # logits never materialized in the stats and update forwards
    logits_chunk: int = 0


def masked_mean(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of x over the mask; with a process `group`, over every
    rank's x and mask (the sums all-reduced)."""
    if group is None:
        return (x * mask).sum() / mask.sum().clamp(min=1)
    num, den = all_reduce_sum(torch.stack([(x * mask).sum(), mask.sum().to(x.dtype)]),
                              group).unbind()
    return num / den.clamp(min=1)


def masked_whiten(x: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """TRL's masked_whiten with shift_mean=True: the biased masked variance
    and rsqrt(var + 1e-8); with `group`, the moments of every rank's rows."""
    mean = masked_mean(x, mask, group)
    var = masked_mean((x - mean) ** 2, mask, group)
    return (x - mean) * torch.rsqrt(var + 1e-8)


class RolloutStats(NamedTuple):
    logprobs: torch.Tensor  # (B, L-1) logp of each next sequence token
    ref_logprobs: torch.Tensor
    values: torch.Tensor  # (B, L-1)
    advantages: torch.Tensor
    returns: torch.Tensor
    response_mask: torch.Tensor  # (B, L-1) f32, 1 on response tokens
    kl: torch.Tensor  # scalar mean KL (for the controller)


def token_logprobs(logits: torch.Tensor, ids: torch.Tensor, sp=None) -> torch.Tensor:
    """logp of ids[t+1] under logits[t], (B, L-1) f32; under `sp` (a
    core.dist.SPShard, logits this rank's (B, L/n, V) slice) the slice's
    positions, (B, L/n), the last position scored against id 0."""
    if sp is not None:
        nxt = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
        lo, hi = sp.span(ids.shape[1])
        logits = logits.float()
        return _gather_clipped(logits, nxt[:, lo:hi]) - torch.logsumexp(logits, dim=-1)
    logits = logits[:, :-1].float()
    return _gather_clipped(logits, ids[:, 1:]) - torch.logsumexp(logits, dim=-1)


def policy_ctx(pcfg: PPOConfig, adapter_set: str = "") -> Ctx:
    """Adapters on: the policy's own, or the named set `adapter_set`."""
    return Ctx(adapters=True, lora_scale=pcfg.lora_scale, adapter_set=adapter_set)


def _trunk(model: VLM, batch: dict, ctx: Ctx) -> torch.Tensor:
    hidden, _ = model(batch["input_ids"], batch.get("pixel_values"), batch.get("image_positions"),
                      batch["pad_mask"], ctx=ctx, **image_inputs(batch))
    return hidden


def _logps(model: VLM, pcfg: PPOConfig, hidden: torch.Tensor, ids: torch.Tensor,
           ctx: Ctx) -> torch.Tensor:
    sp = sp_shard()
    if pcfg.logits_chunk:
        return chunked_token_logps(hidden, ids, model.head_fn(ctx), chunk=pcfg.logits_chunk,
                                   sp=sp)
    return token_logprobs(model.head(hidden, ctx), ids, sp)


def forward_logps_and_values(model: VLM, pcfg: PPOConfig, v_head: dict, batch: dict, ctx: Ctx,
                             value_ctx: Optional[Ctx] = None):
    """(logps (B, L-1), values (B, L)) under `ctx`; with `value_ctx` the
    values come from a second trunk pass under it (vlrlhf_tpu
    `_forward_logps_and_values`). Under a sequence split both are this
    rank's slice, (B, L/n) each (`token_logprobs`)."""
    hidden = _trunk(model, batch, ctx)
    logprobs = _logps(model, pcfg, hidden, batch["input_ids"], ctx)
    if value_ctx is not None:
        hidden = _trunk(model, batch, value_ctx)
    return logprobs, value_forward(hidden, v_head)


def gae_host(deltas: np.ndarray, mask: np.ndarray, gamma_lam: float) -> np.ndarray:
    """GAE's reversed scan over positions in f32, vectorised over rows:
    a_t = delta_t + gamma * lam * a_{t+1} * mask_t (vlrlhf_tpu's gae_step,
    in its order of operations)."""
    c = np.float32(gamma_lam)
    last = np.zeros(deltas.shape[0], np.float32)
    out = np.empty_like(deltas)
    for t in range(deltas.shape[1] - 1, -1, -1):
        last = deltas[:, t] + c * last * mask[:, t]
        out[:, t] = last
    return out


def _row_chunks(batch: dict, size: int):
    """`batch` in consecutive slices of `size` rows (tensors whose leading
    axis is the batch's; others as they are)."""
    b = batch["input_ids"].shape[0]
    for lo in range(0, b, size):
        yield {k: v[lo: lo + size] if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] == b
               else v for k, v in batch.items()}


@torch.no_grad()
def compute_rollout_stats(model: VLM, pcfg: PPOConfig, v_head: dict, batch: dict,
                          scores: torch.Tensor, kl_coef: float,
                          value_adapters: bool = False) -> RolloutStats:
    """The stats pass over a rollout batch (input_ids (B, L) prompt +
    response, pad_mask, response_mask) with sequence `scores` (B,); under a
    mesh the rank's rows, the whitening and the mean KL taken over the
    data-parallel group's (`dp_group`).

    The forwards run in slices of the update's minibatch size, so they
    multiply matrices of the shapes the update's forwards do: cuBLAS picks
    its algorithm (split-K for the adapters' rank-r products among them) by
    shape, and under another shape the two forwards round differently in
    bf16 (on an H100 the first minibatch's ratio came out 4e-2 off 1 with
    8-row stats and 4-row minibatches, and exactly 1 with 4-row slices). The
    advantages and their whitening then take the whole batch, as in
    vlrlhf_tpu."""
    group = dp_group() if dp_size() > 1 else None
    value_ctx = policy_ctx(pcfg, adapter_set=VALUE_SET) if value_adapters else None
    sp = sp_shard()
    parts = []
    # a rank's share of each global minibatch, the update's own shape
    share = pcfg.minibatch_size // dp_size() if pcfg.minibatch_size else 0
    for sub in _row_chunks(batch, share or batch["input_ids"].shape[0]):
        lp, v = forward_logps_and_values(model, pcfg, v_head, sub, policy_ctx(pcfg), value_ctx)
        ref = _logps(model, pcfg, _trunk(model, sub, Ctx()), sub["input_ids"], Ctx())
        parts.append((lp, v, ref))
    logprobs, values, ref_logprobs = (torch.cat(t) for t in zip(*parts))
    ids = batch["input_ids"]
    b, n = ids.shape[0], ids.shape[1] - 1
    if sp is not None:
        # the slices joined whole: the score, the KL penalty, GAE's reverse
        # scan and the whitening take the whole response
        logprobs, values, ref_logprobs = (gather_seq(t, sp) for t in
                                          (logprobs, values, ref_logprobs))
        logprobs, ref_logprobs = logprobs[:, :n], ref_logprobs[:, :n]
    mask = batch["response_mask"][:, 1:].float()
    values = values[:, :-1] * mask
    scores = scores.float()
    if pcfg.score_clip is not None:
        scores = scores.clamp(-pcfg.score_clip, pcfg.score_clip)
    kl = (logprobs - ref_logprobs) * mask
    rewards = -kl_coef * kl
    # the sequence score lands on the last response token; an empty
    # response gives -1, which wraps to the last column as JAX's .at[] does,
    # and the mask then zeroes the row
    resp = batch["response_mask"].long()
    last_idx = resp.sum(dim=1) - 1
    resp_start = torch.argmax(resp, dim=1)
    last_pos = torch.remainder(resp_start + last_idx.clamp(min=0) - 1, n)
    rewards = rewards.index_put((torch.arange(b, device=ids.device), last_pos), scores,
                                accumulate=True)
    rewards = rewards * mask
    next_values = torch.cat([values[:, 1:], torch.zeros_like(values[:, :1])], dim=1)
    deltas = (rewards + pcfg.gamma * next_values - values) * mask
    adv = gae_host(deltas.cpu().numpy(), mask.cpu().numpy(), pcfg.gamma * pcfg.lam)
    advantages = torch.from_numpy(adv).to(ids.device) * mask
    returns = advantages + values
    if pcfg.whiten_advantages:
        advantages = masked_whiten(advantages, mask, group) * mask
    return RolloutStats(logprobs=logprobs, ref_logprobs=ref_logprobs, values=values,
                        advantages=advantages, returns=returns, response_mask=mask,
                        kl=masked_mean(kl, mask, group))


def gather_stats(stats: RolloutStats) -> RolloutStats:
    """Every data-parallel rank's rows of `stats`, in data-parallel order:
    the global batch's (the mean KL is global already)."""
    if dp_size() == 1:
        return stats
    return RolloutStats(*[f if f.dim() == 0 else dp_gather_rows(f) for f in stats])


def ppo_update(model: VLM, pcfg: PPOConfig, ocfg: OptimizerConfig, state: TrainState,
               v_head: dict, batch: dict, stats: RolloutStats,
               value_adapters: bool = False) -> dict:
    """One PPO optimizer step over `batch` (vlrlhf_tpu `ppo_update_fn`): the
    clipped policy loss plus vf_coef times the clipped value loss. The
    trainable leaves are the policy adapters, `v_head`'s and, with
    `value_adapters`, the VALUE_SET adapters; all are in `state.trainable`.
    Metrics come back as 0-dim device tensors.

    Under a mesh `batch` is the rank's share of a global minibatch: each
    masked mean divides the rank's sum by the global minibatch's token
    count, so the ranks' losses add up to the global one, and the backward
    takes dp_size times the rank's (FSDP2 averages the gradients over the
    data-parallel ranks; the replicated value head and value adapters are
    averaged here). The metrics are the global minibatch's on every rank.

    Under a sequence split the forwards give this rank's slice of the
    positions: the per-token terms are taken on it, from the whole
    stats' slice, and each masked sum is summed over the split
    (core.dist sum_over_sp); the gradients follow core/partitioning.py's
    rule (the fsdp ring's size scales the backward, the model split's
    partials are summed by the optimizer)."""
    value_ctx = policy_ctx(pcfg, adapter_set=VALUE_SET) if value_adapters else None
    n_dp = dp_size()
    group = dp_group() if n_dp > 1 else None
    sp = sp_shard()
    for p in state.trainable:
        p.grad = None
    new_logprobs, values = forward_logps_and_values(model, pcfg, v_head, batch,
                                                    policy_ctx(pcfg), value_ctx)
    mask = stats.response_mask
    count = mask.sum()
    if group is not None:
        count = all_reduce_sum(count, group)
    count = count.clamp(min=1)
    if sp is None:
        old_logps, old_values, advantages, returns = (
            stats.logprobs, stats.values, stats.advantages, stats.returns)
        values = values[:, :-1]
    else:  # the whole (B, L-1) stats' columns at this rank's positions
        lo, hi = sp.span(mask.shape[1] + 1)
        old_logps, old_values, advantages, returns, mask = (
            torch.nn.functional.pad(t, (0, 1))[:, lo:hi] for t in
            (stats.logprobs, stats.values, stats.advantages, stats.returns, mask))

    def mean(x):  # the rank's part of the global masked mean
        return sum_over_sp((x * mask).sum(), sp) / count

    values = values * mask
    ratio = torch.exp((new_logprobs - old_logps) * mask)
    pg1 = -advantages * ratio
    pg2 = -advantages * ratio.clamp(1.0 - pcfg.cliprange, 1.0 + pcfg.cliprange)
    pg_loss = mean(torch.maximum(pg1, pg2))
    v_clipped = torch.minimum(torch.maximum(values, old_values - pcfg.cliprange_value),
                              old_values + pcfg.cliprange_value)
    vf1 = (values - returns) ** 2
    vf2 = (v_clipped - returns) ** 2
    vf_loss = 0.5 * mean(torch.maximum(vf1, vf2))
    loss = pg_loss + pcfg.vf_coef * vf_loss
    scale = n_dp * ring_size()
    (loss * scale if scale > 1 else loss).backward()
    if scale > 1:
        from vlrlhf_torch.core.dist import local_tensor

        for p in state.trainable:  # the leaves outside FSDP2: their mean here
            if p.grad is not None and local_tensor(p) is p:
                p.grad = all_reduce_mean(p.grad, grad_group())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in state.trainable]
    with torch.no_grad():
        dev = (ratio - 1.0).abs()
        sums = torch.stack([pg_loss, vf_loss, loss,
                            mean(0.5 * (new_logprobs - old_logps) ** 2),
                            mean((dev > pcfg.cliprange).float()), mean(ratio)]).detach()
        # 0 in exact arithmetic on the first minibatch of epoch 0; the stats
        # and update forwards round differently in bf16, so it stays within
        # bf16's eps there (about 1e-2)
        dev_max = (dev * mask).max()
        import torch.distributed as tdist

        if group is not None:
            sums = all_reduce_sum(sums, group)
        for g in (group, None if sp is None else sp.group):
            if g is not None:
                dev_max = dev_max.clone()
                tdist.all_reduce(dev_max, op=tdist.ReduceOp.MAX, group=g)
        metrics = dict(zip(("ppo/loss/policy", "ppo/loss/value", "ppo/loss/total",
                            "ppo/policy/approxkl", "ppo/policy/clipfrac", "ppo/ratio_mean"),
                           sums.unbind()))
        metrics["ppo/ratio_max_abs_dev"] = dev_max
    metrics["grad_norm"] = apply_updates(state, grads, ocfg)
    return metrics


def rollout_to_batch(prompt_batch: dict, response_tokens, pad_token_id: int,
                     resp_lens=None) -> dict:
    """Host side: splice each row's generated response after its prompt
    (numpy in, numpy out; vlrlhf_tpu `rollout_to_batch`). `resp_lens` (B,)
    are the engine's exact response lengths; without them the lengths count
    non-pad tokens, which undercounts when a sampled token equals the pad
    id. L rounds up to a multiple of 128 past 128."""
    ids_p = np.asarray(prompt_batch["input_ids"])
    plens = np.asarray(prompt_batch["prompt_lens"])
    resp = np.asarray(response_tokens)
    b = resp.shape[0]
    if resp_lens is None:
        resp_lens = (resp != pad_token_id).sum(axis=1)
    else:
        resp_lens = np.asarray(resp_lens)
    L = int((plens + resp_lens).max())
    L = -(-L // 128) * 128 if L > 128 else L
    ids = np.full((b, L), pad_token_id, ids_p.dtype)
    pad_mask = np.zeros((b, L), bool)
    resp_mask = np.zeros((b, L), bool)
    for i in range(b):
        p, r = int(plens[i]), int(resp_lens[i])
        ids[i, :p] = ids_p[i, :p]
        ids[i, p: p + r] = resp[i, :r]
        pad_mask[i, : p + r] = True
        resp_mask[i, p: p + r] = True
    out = {"input_ids": ids, "pad_mask": pad_mask, "response_mask": resp_mask}
    # the image inputs ride along, the anyres map and Q-Former ids too
    # (vlrlhf_tpu's update forwards drop those two; ROADMAP.md §3)
    for k in ("pixel_values", "image_positions", *IMAGE_INPUT_KEYS):
        if prompt_batch.get(k) is not None:
            out[k] = prompt_batch[k]
    return out


def pad_to_split(batch: dict) -> dict:
    """A rollout batch (host arrays or tensors) whose length L a sequence
    split's ranks do not divide, padded on the right to the next multiple
    of them: id 0 and False masks, which every forward and mask drops (the
    batch itself when they divide it, or without a split). The stats pass
    and the update take it; the reward reads the unpadded batch (the
    synthetic reward's response share is of the rollout's own width; a
    reward model scores whole sequences, cli/main.py reward_model_fn)."""
    from vlrlhf_torch.core.dist import sp_size

    extra = -batch["input_ids"].shape[1] % sp_size()
    if not extra:
        return batch
    out = dict(batch)
    for k in ("input_ids", "pad_mask", "response_mask"):
        v = batch.get(k)
        if isinstance(v, np.ndarray):
            out[k] = np.pad(v, ((0, 0), (0, extra)))
        elif v is not None:
            out[k] = torch.cat([v, v.new_zeros((v.shape[0], extra))], dim=1)
    return out


def _take_rows(x, idx: torch.Tensor, b: int):
    if not isinstance(x, torch.Tensor) or x.dim() == 0 or x.shape[0] != b:
        return x
    return x[idx.to(x.device)]


def ppo_update_epochs(update_fn: Callable[[dict, RolloutStats], dict], batch: dict,
                      stats: RolloutStats, pcfg: PPOConfig, seed: int = 0,
                      history: Optional[list] = None) -> dict:
    """TRL's inner loop (vlrlhf_tpu `ppo_update_epochs`): for each of
    ppo_epochs, a permutation from np.random.default_rng(seed) (the same
    draws as vlrlhf_tpu's) and one `update_fn(minibatch, minibatch stats)`
    per minibatch of `minibatch_size` rows (0 = the full batch); rows past
    the last whole minibatch sit that epoch out. Returns the last update's
    metrics; `history` collects every update's. Under a mesh `batch` and
    `stats` are the global batch's: the permutation runs over the global
    rows, and each data-parallel rank steps on its contiguous share of
    every global minibatch (the minibatch a multiple of the ranks)."""
    b = batch["input_ids"].shape[0]
    mb = min(pcfg.minibatch_size, b) if pcfg.minibatch_size else b
    n_mb = b // mb
    n_dp, r = dp_size(), dp_rank()
    if mb % n_dp:
        raise ValueError(f"a PPO minibatch of {mb} rows does not split over {n_dp} "
                         "data-parallel ranks")
    share = mb // n_dp
    rng = np.random.default_rng(seed)
    metrics: dict = {}
    for _ in range(pcfg.ppo_epochs):
        perm = rng.permutation(b)[: n_mb * mb]
        for m in range(n_mb):
            idx = torch.as_tensor(perm[m * mb + r * share: m * mb + (r + 1) * share])
            mb_batch = {k: _take_rows(v, idx, b) for k, v in batch.items()}
            mb_stats = RolloutStats(*[_take_rows(f, idx, b) for f in stats])
            metrics = update_fn(mb_batch, mb_stats)
            if history is not None:
                history.append(metrics)
    return metrics


class RunningMoments:
    """TRL's RunningMoments (trl 0.8.1 core.py): a parallel-variance merge
    of per-batch moments, so mean / var are those of everything seen."""

    def __init__(self):
        self.mean = 0.0
        self.var = 1.0
        self.std = 1.0
        self.count = 1e-24

    def update(self, xs) -> tuple[float, float]:
        xs = np.asarray(xs, np.float64)
        xs_count = xs.size
        xs_mean = float(xs.mean())
        xs_var = float(xs.var())  # biased, as in TRL
        delta = xs_mean - self.mean
        tot_count = self.count + xs_count
        new_sum = xs_var * xs_count
        old_sum = self.var * self.count + delta**2 * self.count * xs_count / tot_count
        self.mean += delta * xs_count / tot_count
        self.var = (old_sum + new_sum) / tot_count
        self.std = float((self.var * tot_count / max(tot_count - 1, 1e-24)) ** 0.5)
        self.count = tot_count
        return xs_mean, float((xs_var * xs_count / max(xs_count - 1, 1e-24)) ** 0.5)


def preprocess_scores(scores, pcfg: PPOConfig, moments: RunningMoments) -> np.ndarray:
    """TRL's score pipeline in TRL's order, on the host: running scale /
    norm, then clip (compute_rollout_stats clips again, which is
    idempotent)."""
    scores = np.asarray(scores, np.float32)
    if pcfg.use_score_scaling:
        moments.update(scores)
        factor = moments.std + np.finfo(np.float32).eps
        if pcfg.use_score_norm:
            scores = (scores - moments.mean) / factor
        else:
            scores = scores / factor
    if pcfg.score_clip is not None:
        scores = np.clip(scores, -pcfg.score_clip, pcfg.score_clip)
    return scores


class AdaptiveKLController:
    """TRL's adaptive KL controller (proportional, clipped). The clipped
    error is rounded to f32 as vlrlhf_tpu's jnp.clip rounds it."""

    def __init__(self, cfg: PPOConfig):
        self.value = cfg.init_kl_coef
        self.cfg = cfg

    def update(self, current_kl: float, n_steps: int) -> float:
        if not self.cfg.adaptive_kl:
            return self.value
        err = np.clip(np.float32(current_kl / self.cfg.target_kl - 1), np.float32(-0.2),
                      np.float32(0.2))
        self.value *= 1 + float(err) * n_steps / self.cfg.kl_horizon
        return self.value
