"""The training loop (counterpart of vlrlhf_tpu/train/loop.py
`batch_iterator`, `PreemptionGuard`, `run_training` and
`prefetch_iterator`).

Rows are tokenized lazily per batch (on a background thread with
`prefetch_iterator`); each batch moves to the device, the step runs, and
the step's metrics stay on the device until a logging step, where all of
them come back in one read. Every `save_steps` steps, and at a SIGTERM
(`PreemptionGuard`: the step in progress finishes, then the state is saved
and the loop stops), the state tree goes to the checkpoint manager
(train/checkpoint.py).

Under a mesh (core/mesh.py) every rank draws the same permutation and
reads its data-parallel slice of each global batch (`batch_iterator`'s
`process_slice`); at a logging step the metrics and the interval's token
and image counts are averaged over the ranks in one collective, and a
SIGTERM on any rank stops every rank at the same step: the ranks vote
(`any_process_failed`) at logging and save steps only, which sync anyway,
so the save stays collective and no other step waits on the host.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from vlrlhf_torch.core.dist import any_process_failed, dp_size, global_metrics, process_count
from vlrlhf_torch.train.dpo import batch_to_device


def batch_iterator(
    rows: Sequence[dict],
    tokenize_fn: Callable[[dict], dict],
    collate_fn: Callable[[list[dict]], dict],
    batch_size: int,
    num_epochs: float,
    seed: int = 42,
    global_batch_size: int = 0,
    process_slice: Optional[tuple] = None,
) -> Iterable[dict]:
    """Numpy batches over `num_epochs` passes, reshuffled each epoch with
    one seeded generator, a short last batch dropped (the same order as
    vlrlhf_tpu's single-process iterator). Multi-process (vlrlhf_tpu's
    `global_batch_size` / `process_slice`, loop.py:35-60): every rank
    draws the same permutation, forms global batches of
    `global_batch_size` rows and collates its `process_slice` (lo, hi) of
    each, so the ranks' batches together are the single-process batch."""
    n = len(rows)
    g = global_batch_size or batch_size
    lo, hi = process_slice if process_slice is not None else (0, batch_size)
    if hi - lo != batch_size:
        raise ValueError(f"process_slice {process_slice} must cover batch_size {batch_size}")
    emitted_epochs = 0.0
    rng = np.random.default_rng(seed)
    while emitted_epochs < num_epochs:
        order = rng.permutation(n)
        for start in range(0, n, g):
            idx = order[start : start + g]
            if len(idx) < g:
                continue
            yield collate_fn([tokenize_fn(rows[int(i)]) for i in idx[lo:hi]])
            emitted_epochs += g / n
            if emitted_epochs >= num_epochs:
                return


def read_metrics(metrics: dict) -> dict[str, float]:
    """Every metric of a step as a float, in one device-to-host read."""
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).float().reshape(()) for k in keys])
    return dict(zip(keys, vals.cpu().tolist()))


class PreemptionGuard:
    """SIGTERM -> finish the current step, checkpoint, stop cleanly (a
    preemptible machine's notice). Installing it off the main thread is a
    no-op (the signal module's rule)."""

    def __init__(self):
        self.flag = False
        self._prev = None
        self._installed = False

    def install(self) -> "PreemptionGuard":
        import signal

        def _on(signum, frame):
            self.flag = True

        try:
            self._prev = signal.signal(signal.SIGTERM, _on)
            self._installed = True
        except ValueError:  # not the main thread
            pass
        return self

    def uninstall(self) -> None:
        if self._installed:
            import signal

            signal.signal(signal.SIGTERM, self._prev)
            self._installed = False


def run_training(
    step_fn: Callable[[dict], dict],  # device batch -> metrics (0-dim tensors)
    batches: Iterable[dict],
    device,
    logger=None,
    logging_steps: int = 10,
    max_steps: int = 0,
    checkpoint_manager=None,
    state_fn: Optional[Callable[[], dict]] = None,  # the state tree to save
    save_steps: int = 500,
    start_step: int = 0,
    on_step: Optional[Callable[[int, dict], None]] = None,  # (step, metrics)
) -> int:
    """Drive `step_fn` over numpy `batches`, counting steps from
    `start_step` (a resumed run: the batches start from the beginning
    again, as in vlrlhf_tpu); returns the last step's number."""
    guard = PreemptionGuard().install()
    last_saved = -1
    n_dp = dp_size()
    n_ranks = process_count()

    def save(step_idx):
        nonlocal last_saved
        if checkpoint_manager is not None and step_idx != last_saved:
            checkpoint_manager.save(step_idx, state_fn())
            last_saved = step_idx

    step = start_step
    interval_tokens = interval_images = 0
    try:
        for batch in batches:
            metrics = step_fn(batch_to_device(batch, device))
            step += 1
            interval_tokens += int(np.prod(batch["input_ids"].shape))
            pv: Optional[np.ndarray] = batch.get("pixel_values")
            if pv is not None:
                interval_images += int(np.prod(pv.shape[:2]))
            if logger is not None and step % logging_steps == 0:
                counts = {"perf/interval_tokens": interval_tokens * n_dp,
                          "perf/interval_images": interval_images * n_dp}
                metrics = dict(metrics, **{k: torch.tensor(float(v), device=device)
                                           for k, v in counts.items()})
                # the only sync of the interval (and its one collective)
                host = read_metrics(global_metrics(metrics))
                interval_tokens = interval_images = 0
                logger.log(step, host)
            if on_step is not None:
                on_step(step, metrics)
            if step % save_steps == 0:
                save(step)
            stop = guard.flag
            if n_ranks > 1:  # the ranks' vote is a collective: only at steps that sync anyway
                stop = (step % logging_steps == 0 or step % save_steps == 0) and \
                    any_process_failed(stop)
            if stop:
                # preempted: save at this step boundary and stop; the run
                # resumes here with --resume_from_checkpoint
                save(step)
                if checkpoint_manager is not None:
                    checkpoint_manager.wait()
                if logger is not None:
                    logger.log(step, {"train/preempted": 1.0})
                print(f"preempted: checkpoint saved at step {step}", flush=True)
                break
            if max_steps and step >= max_steps:
                break
    finally:
        guard.uninstall()
    return step


def prefetch_iterator(it: Iterable[dict], depth: int = 2) -> Iterable[dict]:
    """Run the upstream iterator (tokenize + collate + image loading) on a
    background thread, `depth` batches ahead, so host data work overlaps
    the device steps; a worker's exception is raised in the consumer."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    sentinel = object()
    err: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate into the consumer
            err.append(e)
        finally:
            q.put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is sentinel:
            if err:
                raise err[0]
            return
        yield item
