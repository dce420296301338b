"""Training losses (counterpart of vlrlhf_tpu/train/losses.py):
`batch_logps`, `chunked_logps`, `chunked_token_logps`, the `dpo_loss`
family (sigmoid with label smoothing, ddpo, hinge, ipo, kto_pair,
reference_free), `sft_loss` and `rm_loss`. Same numerics: logps in f32
from the logits' dtype, gather minus logsumexp, out-of-vocab labels
clamped like take(mode="clip").

Under sequence parallelism (`sp`, a core.dist.SPShard) the hidden states
or logits are this rank's slice of the sequence while the labels and
masks are whole: the shifted labels and masks are taken on the whole
sequence, then sliced (a slice's last position is labelled by the next
slice's first token), the per-row sums are summed over the ring
(core/dist.py sum_over_sp, whose backward is the identity) and the
counts come from the whole masks.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from vlrlhf_torch.core.dist import sum_over_sp

LABEL_PAD = -100


def _gather_clipped(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    idx = labels.long().clamp(0, logits.shape[-1] - 1)
    return torch.gather(logits, -1, idx[..., None])[..., 0]


def next_token_targets(labels: torch.Tensor, loss_mask: Optional[torch.Tensor] = None):
    """(targets, mask), each (B, S): at position t the label of t + 1
    (0 where it does not count) and whether it counts; the last position
    counts never."""
    pad_col = torch.full((labels.shape[0], 1), LABEL_PAD, dtype=labels.dtype,
                         device=labels.device)
    labels_next = torch.cat([labels[:, 1:], pad_col], dim=1)
    mask = labels_next != LABEL_PAD
    if loss_mask is not None:
        lm = torch.cat([loss_mask[:, 1:].bool(), torch.zeros_like(mask[:, :1])], dim=1)
        mask = mask & lm
    return torch.where(mask, labels_next, torch.zeros_like(labels_next)), mask


def _sp_slices(sp, s: int, *ts):
    lo, hi = sp.span(s)
    return [t[:, lo:hi] for t in ts]


def batch_logps(
    logits: torch.Tensor,  # (B, S, V); under sp this rank's (B, S/n, V)
    labels: torch.Tensor,  # (B, S), LABEL_PAD on non-completion tokens
    average_log_prob: bool = False,
    loss_mask: Optional[torch.Tensor] = None,  # extra mask (DDPO diff mask)
    sp=None,  # core.dist.SPShard: logits are a slice of the sequence
) -> torch.Tensor:
    """Sum (or mean) log p(label) over labeled positions, (B,) f32."""
    if sp is not None:
        safe, mask = next_token_targets(labels, loss_mask)
        local_safe, local_mask = _sp_slices(sp, labels.shape[1], safe, mask)
        lse = torch.logsumexp(logits.float(), dim=-1)
        per_token = (_gather_clipped(logits, local_safe).float() - lse) * local_mask
        total = sum_over_sp(per_token.sum(-1), sp)
        return total / mask.sum(-1).clamp(min=1) if average_log_prob else total
    logits = logits[:, :-1]
    labels = labels[:, 1:]
    mask = labels != LABEL_PAD
    if loss_mask is not None:
        mask = mask & loss_mask[:, 1:].bool()
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    lse = torch.logsumexp(logits.float(), dim=-1)
    per_token = (_gather_clipped(logits, safe).float() - lse) * mask
    if average_log_prob:
        return per_token.sum(-1) / mask.sum(-1).clamp(min=1)
    return per_token.sum(-1)


def _chunk_terms(head_fn, hc, lc, mc, vc):
    logits = head_fn(hc)  # (B, C, V)
    lse = torch.logsumexp(logits.float(), dim=-1)
    tok = _gather_clipped(logits, lc).float()
    return ((tok - lse) * mc).sum(-1), (logits.float().sum(-1) * vc).sum(-1)


def chunked_logps(
    hidden: torch.Tensor,  # (B, S, H) final hidden states (pre lm_head)
    labels: torch.Tensor,  # (B, S)
    head_fn,  # (B, C, H) -> (B, C, V)
    *,
    average_log_prob: bool = False,
    loss_mask: Optional[torch.Tensor] = None,
    chunk: int = 512,
    sp=None,  # core.dist.SPShard: hidden is this rank's (B, S/n, H) slice
) -> tuple[torch.Tensor, torch.Tensor]:
    """batch_logps without materializing (B, S, V) logits: a loop over
    S-chunks, each under torch.utils.checkpoint, so the backward rebuilds one
    (B, C, V) logits chunk at a time. Returns (logps (B,), logits_sum (B,)):
    logits_sum is the f32 sum of the logits over all S positions (the dense
    path's logits mean times S*V)."""
    b, s, _ = hidden.shape
    safe, mask = next_token_targets(labels, loss_mask)
    local_safe, local_mask = (safe, mask) if sp is None else \
        _sp_slices(sp, labels.shape[1], safe, mask)
    valid = torch.ones((b, s), dtype=torch.bool, device=hidden.device)
    c = min(chunk, s)
    logps = torch.zeros((b,), dtype=torch.float32, device=hidden.device)
    logits_sum = torch.zeros_like(logps)
    for lo in range(0, s, c):
        sl = slice(lo, lo + c)
        args = (head_fn, hidden[:, sl], local_safe[:, sl], local_mask[:, sl], valid[:, sl])
        if torch.is_grad_enabled() and hidden.requires_grad:
            lp, ls = checkpoint(_chunk_terms, *args, use_reentrant=False)
        else:
            lp, ls = _chunk_terms(*args)
        logps = logps + lp
        logits_sum = logits_sum + ls
    if sp is not None:
        logps, logits_sum = sum_over_sp(torch.stack([logps, logits_sum]), sp).unbind(0)
    if average_log_prob:
        logps = logps / mask.sum(-1).clamp(min=1)
    return logps, logits_sum


def _chunk_token_terms(head_fn, hc, lc):
    logits = head_fn(hc)  # (B, C, V)
    lse = torch.logsumexp(logits.float(), dim=-1)
    return _gather_clipped(logits, lc).float() - lse


def chunked_token_logps(
    hidden: torch.Tensor,  # (B, S, H) final hidden states (pre lm_head); under sp (B, S/n, H)
    ids: torch.Tensor,  # (B, S) token ids
    head_fn,  # (B, C, H) -> (B, C, V)
    *,
    chunk: int = 512,
    sp=None,  # core.dist.SPShard: hidden is this rank's slice of the sequence
) -> torch.Tensor:
    """Per-token logp of ids[t+1] under head(hidden[t]), (B, S-1) f32: PPO's
    token logprobs without materializing (B, S, V) logits. The same S-chunk
    loop as chunked_logps, each chunk under torch.utils.checkpoint, emitting
    the per-position values instead of their sum. Under `sp` the slice's
    positions, (B, S/n): the whole sequence's last position (no next
    token) is scored against id 0 and is the caller's to drop."""
    b, s, _ = hidden.shape
    ids_next = torch.cat([ids[:, 1:], torch.zeros_like(ids[:, :1])], dim=1)
    if sp is not None:
        (ids_next,) = _sp_slices(sp, ids.shape[1], ids_next)
    c = min(chunk, s)
    parts = []
    for lo in range(0, s, c):
        args = (head_fn, hidden[:, lo:lo + c], ids_next[:, lo:lo + c])
        if torch.is_grad_enabled() and hidden.requires_grad:
            parts.append(checkpoint(_chunk_token_terms, *args, use_reentrant=False))
        else:
            parts.append(_chunk_token_terms(*args))
    out = torch.cat(parts, dim=1)
    return out if sp is not None else out[:, : s - 1]


def sft_loss(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S)
    pad_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Mean shifted CE over labeled tokens (token mean, the HF convention)."""
    nll_sum, count = sft_loss_terms(logits, labels, pad_mask)
    return nll_sum / count.clamp(min=1)


def sft_loss_terms(
    logits: torch.Tensor,  # (B, S, V); under sp this rank's (B, S/n, V)
    labels: torch.Tensor,  # (B, S)
    pad_mask: Optional[torch.Tensor] = None,
    sp=None,  # core.dist.SPShard: logits are a slice of the sequence
) -> tuple[torch.Tensor, torch.Tensor]:
    """(summed shifted CE, labeled-token count) of `sft_loss`: a sharded
    batch divides the ranks' summed CE by their summed count."""
    if sp is not None:
        safe, mask = next_token_targets(labels, pad_mask)
        local_safe, local_mask = _sp_slices(sp, labels.shape[1], safe, mask)
        logits = logits.float()
        nll = -(_gather_clipped(logits, local_safe) - torch.logsumexp(logits, dim=-1))
        return sum_over_sp((nll * local_mask).sum(), sp), mask.sum()
    logits = logits[:, :-1].float()
    labels = labels[:, 1:]
    mask = labels != LABEL_PAD
    if pad_mask is not None:
        mask = mask & pad_mask[:, 1:].bool()
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    nll = -(_gather_clipped(logits, safe) - torch.logsumexp(logits, dim=-1))
    return (nll * mask).sum(), mask.sum()


def rm_loss(chosen_rewards: torch.Tensor, rejected_rewards: torch.Tensor) -> torch.Tensor:
    """Bradley-Terry pairwise loss (TRL RewardTrainer's default)."""
    return -F.logsigmoid(chosen_rewards - rejected_rewards).mean()


class DPOLossOutput(NamedTuple):
    loss: torch.Tensor  # scalar
    chosen_rewards: torch.Tensor  # (B,)
    rejected_rewards: torch.Tensor  # (B,)


def dpo_loss(
    policy_chosen_logps: torch.Tensor,
    policy_rejected_logps: torch.Tensor,
    ref_chosen_logps: torch.Tensor,
    ref_rejected_logps: torch.Tensor,
    *,
    beta: float = 0.1,
    label_smoothing: float = 0.0,
    loss_type: str = "sigmoid",  # sigmoid | ddpo | hinge | ipo | kto_pair
    reference_free: bool = False,
) -> DPOLossOutput:
    pi_logratios = policy_chosen_logps - policy_rejected_logps
    ref_logratios = (
        torch.zeros_like(pi_logratios) if reference_free
        else ref_chosen_logps - ref_rejected_logps
    )
    logits = pi_logratios - ref_logratios
    if loss_type in ("sigmoid", "ddpo"):
        losses = -F.logsigmoid(beta * logits) * (1 - label_smoothing) \
            - F.logsigmoid(-beta * logits) * label_smoothing
    elif loss_type == "hinge":
        losses = torch.relu(1 - beta * logits)
    elif loss_type == "ipo":
        losses = (logits - 1 / (2 * beta)) ** 2
    elif loss_type == "kto_pair":
        chosen_kl = (policy_chosen_logps - ref_chosen_logps).mean().clamp(min=0)
        rejected_kl = (policy_rejected_logps - ref_rejected_logps).mean().clamp(min=0)
        chosen_lr = policy_chosen_logps - ref_chosen_logps
        rejected_lr = policy_rejected_logps - ref_rejected_logps
        losses = torch.cat([
            1 - torch.sigmoid(beta * (chosen_lr - rejected_kl)),
            1 - torch.sigmoid(beta * (chosen_kl - rejected_lr)),
        ])
    else:
        raise ValueError(f"Unknown loss type: {loss_type}")
    chosen_rewards = beta * (policy_chosen_logps - ref_chosen_logps).detach()
    rejected_rewards = beta * (policy_rejected_logps - ref_rejected_logps).detach()
    return DPOLossOutput(losses.mean(), chosen_rewards, rejected_rewards)
