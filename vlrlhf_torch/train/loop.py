"""The training loop (counterpart of vlrlhf_tpu/train/loop.py
`batch_iterator` and `run_training`), single process.

Rows are tokenized lazily per batch; each batch moves to the device, the
step runs, and the step's metrics stay on the device until a logging step,
where all of them come back in one read. Checkpoint saves wait for the
checkpointing slice.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from vlrlhf_torch.train.dpo import batch_to_device


def batch_iterator(
    rows: Sequence[dict],
    tokenize_fn: Callable[[dict], dict],
    collate_fn: Callable[[list[dict]], dict],
    batch_size: int,
    num_epochs: float,
    seed: int = 42,
) -> Iterable[dict]:
    """Numpy batches over `num_epochs` passes, reshuffled each epoch with
    one seeded generator, a short last batch dropped (the same order as
    vlrlhf_tpu's single-process iterator)."""
    n = len(rows)
    emitted_epochs = 0.0
    rng = np.random.default_rng(seed)
    while emitted_epochs < num_epochs:
        order = rng.permutation(n)
        for start in range(0, n, batch_size):
            idx = order[start : start + batch_size]
            if len(idx) < batch_size:
                continue
            yield collate_fn([tokenize_fn(rows[int(i)]) for i in idx])
            emitted_epochs += batch_size / n
            if emitted_epochs >= num_epochs:
                return


def read_metrics(metrics: dict) -> dict[str, float]:
    """Every metric of a step as a float, in one device-to-host read."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float().reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


def run_training(
    step_fn: Callable[[dict], dict],  # device batch -> metrics (0-dim tensors)
    batches: Iterable[dict],
    device,
    logger=None,
    logging_steps: int = 10,
    max_steps: int = 0,
) -> int:
    """Drive `step_fn` over numpy `batches`; returns the steps taken."""
    step = 0
    interval_tokens = interval_images = 0
    for batch in batches:
        metrics = step_fn(batch_to_device(batch, device))
        step += 1
        interval_tokens += int(np.prod(batch["input_ids"].shape))
        pv: Optional[np.ndarray] = batch.get("pixel_values")
        if pv is not None:
            interval_images += int(np.prod(pv.shape[:2]))
        if logger is not None and step % logging_steps == 0:
            host = read_metrics(metrics)  # the only sync of the interval
            host["perf/interval_tokens"] = interval_tokens
            host["perf/interval_images"] = interval_images
            interval_tokens = interval_images = 0
            logger.log(step, host)
        if max_steps and step >= max_steps:
            break
    return step
