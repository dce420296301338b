"""The dataset split of vlrlhf_tpu/data/datasets.py (`train_eval_split`),
copied because importing anything under vlrlhf_tpu pulls in jax. The same
numpy permutation gives both packages the same rows. The local-JSON
dataset builders wait for their slice (ROADMAP.md §1c item 6)."""

from __future__ import annotations

import numpy as np


def train_eval_split(rows: list, eval_ratio: float = 0.005,
                     seed: int = 42) -> tuple[list, list]:
    """The reference's 0.5% eval split, seed 42 (dpo.py:111-114): at least
    one eval row from a non-empty list; rows keep their order."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(rows))
    n_eval = max(1, int(len(rows) * eval_ratio)) if rows else 0
    eval_idx = set(idx[:n_eval].tolist())
    train = [r for i, r in enumerate(rows) if i not in eval_idx]
    return train, [rows[i] for i in sorted(eval_idx)]
