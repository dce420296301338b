"""Metrics logging to JSONL with tokens/s and MFU (counterpart of
vlrlhf_tpu/train/metrics.py).

`report_to` names the sinks: "jsonl", the metrics file, is the one the
port has. vlrlhf_tpu also takes "wandb" and drops it silently when wandb
cannot start; the port honours a flag or refuses it, so "wandb" and every
other name are refused by name.

MFU is taken against one NVIDIA H100 SXM's dense bf16 tensor-core peak,
989.4 TFLOP/s (NVIDIA's H100 data sheet), at the card's full 700 W limit.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

H100_BF16_DENSE_FLOPS = 989.4e12  # per card, dense (no sparsity)
REPORT_SINKS = ("jsonl",)


def check_report_to(report_to: str) -> tuple:
    """The sinks of a --report_to value (comma-separated), or ValueError
    naming each one the port does not write."""
    sinks = tuple(r.strip() for r in report_to.split(",") if r.strip())
    refused = [r for r in sinks if r not in REPORT_SINKS]
    if "wandb" in refused:
        raise ValueError("--report_to wandb: the port writes no Weights & Biases runs (no wandb "
                         "client on its machines) and refuses the sink rather than dropping it; "
                         "use --report_to jsonl")
    if refused or not sinks:
        raise ValueError(f"--report_to {report_to!r}: unknown sink(s) {refused}; the port "
                         f"writes {', '.join(REPORT_SINKS)}")
    return sinks


class MetricsLogger:
    """Appends one JSON object per logged step to
    <output_dir>/<run_name>_metrics.jsonl. From the second logged step on,
    it adds perf/step_time_s (wall time since the previous log divided by the
    steps between), perf/tokens_per_sec and perf/mfu, from the interval's
    token and image counts the loop reports as perf/interval_tokens and
    perf/interval_images."""

    def __init__(
        self,
        output_dir: str,
        run_name: str = "run",
        report_to: str = "jsonl",
        flops_per_token: Optional[float] = None,
        flops_per_image: Optional[float] = None,
        n_devices: int = 1,
        write: bool = True,
    ):
        """`report_to`: the sinks (`check_report_to`). `n_devices`: the GPUs
        the interval's tokens ran on (perf/mfu is against their summed
        peak). `write` False (the ranks but the first of a multi-GPU run)
        computes the same values and writes nothing."""
        check_report_to(report_to)
        self.path = os.path.join(output_dir, f"{run_name}_metrics.jsonl")
        self._file = None
        if write:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(self.path, "a")
        self.n_devices = n_devices
        self.flops_per_token = flops_per_token
        self.flops_per_image = flops_per_image
        self._last: Optional[tuple[float, int]] = None

    def log(self, step: int, metrics: dict[str, Any]) -> dict[str, Any]:
        now = time.perf_counter()
        out = {k: float(v) for k, v in metrics.items()}
        tokens = out.pop("perf/interval_tokens", None)
        images = out.pop("perf/interval_images", 0.0)
        if self._last is not None and tokens:
            dt = now - self._last[0]
            out["perf/step_time_s"] = dt / max(step - self._last[1], 1)
            out["perf/tokens_per_sec"] = tokens / dt
            if self.flops_per_token:
                flops = self.flops_per_token * tokens + (self.flops_per_image or 0.0) * images
                out["perf/mfu"] = flops / dt / (H100_BF16_DENSE_FLOPS * self.n_devices)
        self._last = (now, step)
        if self._file is not None:
            self._file.write(json.dumps({"step": step, **out}) + "\n")
            self._file.flush()
        return out

    def close(self):
        if self._file is not None:
            self._file.close()
