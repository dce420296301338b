"""Train state and optimizer (counterpart of vlrlhf_tpu/train/train_state.py).

The JAX package chains optax `clip_by_global_norm(max_grad_norm)` into
`adamw(schedule)`, optionally wrapped in `optax.MultiSteps` for gradient
accumulation. This module writes the same update out in tensor code, update
for update:

  - clipping scales by max_norm / g_norm only when g_norm >= max_norm, with
    no epsilon (torch.nn.utils.clip_grad_norm_ adds 1e-6, so it is not
    used);
  - Adam's eps sits outside the square root of the bias-corrected second
    moment, and the decoupled weight decay applies to every leaf;
  - the schedule is read at the optimizer's count before the update, so with
    warmup the first update has lr 0;
  - accumulation keeps the running mean of the micro-step gradients and
    applies the inner update on every k-th call, as MultiSteps does.

The state is updated in place (the adapters, their moments and the
accumulator are the largest buffers a LoRA run owns), with multi-tensor
`torch._foreach_*` ops, and nothing is read back to the host.
`state_tree` / `load_state_tree_` give the whole state, keyed by the
trainable leaves' names, to train/checkpoint.py and back.

Under a mesh (core/partitioning.py) the trainable leaves are FSDP2's
DTensors: the update steps each rank's local shards, and `norm_groups`
makes `global_norm` the norm over the whole sharded tree, each distinct
value counted once, so clipping equals vlrlhf_tpu's optax clipping over
its sharded arrays. Under a pipeline `pipe_sum` names the leaves before
the stack, whose gradient only stage 0 computes: their gradients are
summed over the stages first, in place, so each stage steps them alike
(core/partitioning.py `pipe_role`). Under the model split `tp_sum` names
the leaves replicated over model, whose gradients each rank computes from
its slice of the sequence: they are summed over the tensor-parallel group
first, in place (core/partitioning.py, the gradient rule). The freeze masks
of full fine-tuning wait for that mode (vlrlhf_tpu's `--use_lora false`
trains adapters too: ROADMAP.md §3).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Sequence

import torch

from vlrlhf_torch.core.dist import local_tensor


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 1e-5
    warmup_steps: int = 0
    warmup_ratio: float = 0.1
    total_steps: int = 1000
    schedule: str = "cosine"  # 'cosine' | 'linear' | 'constant'
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    max_grad_norm: float = 1.0
    grad_accum_steps: int = 1


def _linear(count: int, init: float, end: float, steps: int) -> float:
    """optax.linear_schedule."""
    if steps <= 0:
        return init
    frac = 1.0 - min(max(count, 0), steps) / steps
    return (init - end) * frac + end


def lr_at(cfg: OptimizerConfig, count: int) -> float:
    """The learning rate of the update made at optimizer count `count`:
    'constant' = linear warmup to the peak, then flat; 'cosine' =
    optax.warmup_cosine_decay_schedule to 0 at total_steps; 'linear' =
    linear warmup, then linear decay to 0 at total_steps."""
    lr = cfg.learning_rate
    warmup = cfg.warmup_steps or int(cfg.warmup_ratio * cfg.total_steps)
    if cfg.schedule == "constant":
        return _linear(count, 0.0, lr, max(warmup, 1))
    if cfg.schedule == "linear":
        if count < warmup:
            return _linear(count, 0.0, lr, warmup)
        return _linear(count - warmup, lr, 0.0, max(cfg.total_steps - warmup, 1))
    if cfg.schedule != "cosine":
        raise ValueError(f"unknown schedule {cfg.schedule!r}")
    if count < warmup:
        return _linear(count, 0.0, lr, warmup)
    decay = max(cfg.total_steps, warmup + 1) - warmup
    t = min(count - warmup, decay)
    return lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def global_norm(tensors: Sequence[torch.Tensor],
                groups: Optional[Sequence[tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of squares of every element, f32, on the device.
    With `groups` (one tuple of process groups per tensor, the tensors
    being local shards) each tensor's sum of squares is summed over its
    groups first: the norm of the whole sharded tree."""
    norms = torch._foreach_norm([local_tensor(t).float() for t in tensors])
    if groups is None:
        return torch.linalg.vector_norm(torch.stack(norms))
    import torch.distributed as dist

    sq = torch.stack(norms) ** 2
    total = torch.zeros((), dtype=torch.float32, device=sq.device)
    for key in dict.fromkeys(groups):  # distinct group tuples, in first-seen order
        part = sq[[i for i, g in enumerate(groups) if g == key]].sum()
        for g in key:
            dist.all_reduce(part, group=g)
        total = total + part
    return total.sqrt()


@dataclasses.dataclass
class TrainState:
    """`step` counts calls (micro-steps, as vlrlhf_tpu's TrainState.step);
    `count` counts the updates applied (optax's adam/schedule count)."""

    trainable: list[torch.Tensor]
    mu: list[torch.Tensor]
    nu: list[torch.Tensor]
    acc_grads: Optional[list[torch.Tensor]] = None
    step: int = 0
    count: int = 0
    mini_step: int = 0
    # under a mesh: per leaf, the groups of its squared norm (global_norm)
    norm_groups: Optional[list[tuple]] = None
    # under a pipeline: (core.dist.PipeShard, indices of the leaves whose
    # gradients are summed over the stages before anything else)
    pipe_sum: Optional[tuple] = None
    # under the model split: (the tensor-parallel group, indices of the
    # leaves replicated over model, whose gradients are the partials of a
    # rank's slice of the sequence, summed over the group first)
    tp_sum: Optional[tuple] = None


def init_train_state(trainable: Sequence[torch.Tensor], cfg: OptimizerConfig) -> TrainState:
    trainable = list(trainable)
    for t in trainable:
        if t.dtype != torch.float32:
            raise TypeError(f"trainable leaves are f32 masters, got {t.dtype}")
    zeros = lambda: [torch.zeros_like(t) for t in trainable]  # noqa: E731
    return TrainState(
        trainable=trainable, mu=zeros(), nu=zeros(),
        acc_grads=zeros() if cfg.grad_accum_steps > 1 else None,
    )


@torch.no_grad()
def apply_updates(state: TrainState, grads: Sequence[torch.Tensor],
                  cfg: OptimizerConfig) -> torch.Tensor:
    """One call of the optax chain, in place on `state`. Returns the global
    norm of `grads` as given, before clipping (the step's grad_norm).
    Under a pipeline the gradients `state.pipe_sum` names are first summed
    over the stages, and under the model split those `state.tp_sum` names
    over the tensor-parallel group, in place."""
    grads = [local_tensor(g).float() for g in grads]
    if state.pipe_sum is not None:
        from vlrlhf_torch.core.dist import pipe_sum_

        pp, idx = state.pipe_sum
        pipe_sum_([grads[i] for i in idx], pp)
    if state.tp_sum is not None:
        import torch.distributed as dist

        group, idx = state.tp_sum
        for i in idx:
            dist.all_reduce(grads[i], group=group)
    g_norm = global_norm(grads, state.norm_groups)
    state.step += 1
    # under a mesh the leaves are DTensors: the update steps the local shards
    trainable, mu, nu = ([local_tensor(t) for t in ts]
                         for ts in (state.trainable, state.mu, state.nu))
    acc = None if state.acc_grads is None else [local_tensor(t) for t in state.acc_grads]
    if acc is not None:
        diff = torch._foreach_sub(grads, acc)
        torch._foreach_div_(diff, float(state.mini_step + 1))
        torch._foreach_add_(acc, diff)
        state.mini_step += 1
        if state.mini_step < cfg.grad_accum_steps:
            return g_norm
        grads = [a.clone() for a in acc]
        for a in acc:
            a.zero_()
        state.mini_step = 0
        clip_norm = global_norm(grads, state.norm_groups)  # of the averaged gradients
    else:
        clip_norm = g_norm

    # clip_by_global_norm: g * max_norm / g_norm when g_norm >= max_norm
    factor = torch.where(clip_norm < cfg.max_grad_norm, torch.ones_like(clip_norm),
                         cfg.max_grad_norm / clip_norm)
    grads = torch._foreach_mul(grads, factor)  # the callers' .grad stay as they are

    # adamw: scale_by_adam -> add_decayed_weights -> scale by -lr(count)
    lr = lr_at(cfg, state.count)
    state.count += 1
    torch._foreach_mul_(mu, cfg.b1)
    torch._foreach_add_(mu, grads, alpha=1.0 - cfg.b1)
    torch._foreach_mul_(nu, cfg.b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - cfg.b2)
    # at most two trainable-sized temporaries live at once from here on
    # (the step's memory peak at 7B LoRA r64 is this update's)
    del grads
    denom = torch._foreach_div(nu, 1.0 - cfg.b2**state.count)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, cfg.eps)
    upd = torch._foreach_div(mu, 1.0 - cfg.b1**state.count)  # mu_hat
    torch._foreach_div_(upd, denom)
    del denom
    if cfg.weight_decay:
        torch._foreach_add_(upd, trainable, alpha=cfg.weight_decay)
    torch._foreach_mul_(upd, -lr)
    torch._foreach_add_(trainable, upd)
    return g_norm


_COUNTERS = ("step", "count", "mini_step")


def state_tree(state: TrainState, keys: Sequence[str]) -> dict:
    """Everything a resume needs: {"trainable", "mu", "nu"[, "acc_grads"]}
    as {key: tensor} (the live tensors, not copies) and the three counters
    as ints. `keys` names the trainable leaves in order."""
    if len(keys) != len(state.trainable):
        raise ValueError(f"{len(keys)} keys for {len(state.trainable)} trainable leaves")
    tree = {"trainable": dict(zip(keys, state.trainable)), "mu": dict(zip(keys, state.mu)),
            "nu": dict(zip(keys, state.nu))}
    if state.acc_grads is not None:
        tree["acc_grads"] = dict(zip(keys, state.acc_grads))
    tree.update({c: getattr(state, c) for c in _COUNTERS})
    return tree


@torch.no_grad()
def load_state_tree_(state: TrainState, keys: Sequence[str], tree: dict,
                     place: Optional[Callable] = None) -> None:
    """Copy a `state_tree` (from a checkpoint) into `state` in place: each
    tensor lands on its leaf's device in its dtype. The groups, keys and
    shapes must be the ones `state` holds. Under a mesh the tree holds the
    world-1 tensors and `place(key, leaf, tensor)` gives this rank's part
    of one (core/partitioning.py shard_full), which lands in the leaf's
    local shard."""
    groups = {"trainable": state.trainable, "mu": state.mu, "nu": state.nu}
    if state.acc_grads is not None:
        groups["acc_grads"] = state.acc_grads
    if set(tree) - set(_COUNTERS) != set(groups):
        raise ValueError(f"checkpoint holds {sorted(tree)}, the state {sorted(groups)}")
    for group, leaves in groups.items():
        if list(tree[group]) != list(keys):
            raise ValueError(f"checkpoint {group} keys differ from the model's adapters")
        for key, dst, src in zip(keys, leaves, tree[group].values()):
            if place is not None:
                src, dst = place(key, dst, src), local_tensor(dst)
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"checkpoint {group} leaf {tuple(src.shape)} does not fit "
                                 f"{tuple(dst.shape)}")
            dst.copy_(src)
    for c in _COUNTERS:
        setattr(state, c, int(tree[c]))
