"""Checkpoints (counterpart of vlrlhf_tpu/train/checkpoint.py:
CheckpointManager with save / restore / latest_step / wait / close, and
save_params / load_params).

vlrlhf_tpu writes orbax, which needs JAX to read; the port's format is its
own. A checkpoint is a directory `<directory>/<step>/` holding `state.pt`,
a `torch.save` of the state tree (train/train_state.py `state_tree`: the
adapters, their AdamW moments and the counters, keyed by the adapters'
JAX-layout paths, lora.lora_keys), and `extra.json` when the caller passes
extra. `save` copies the tree to host memory at once (training updates the
tensors in place), then writes it on a thread, as orbax saves
asynchronously: into a hidden temporary directory that is renamed to
`<step>` when complete, so a reader never sees half a checkpoint. Only the
newest `max_to_keep` steps stay; `latest_step` reads the directory names.
`save_params` writes one tree (the adapters, the merged weights) the same
way, as `<path>/params.pt`.

Under a process group (a torchrun launch, core/dist.py) the tree handed to
`save` holds the world-1 tensors (core/partitioning.py full_state_tree
gathers them from the mesh), and the first rank alone writes it as above,
on its thread (no rank reads a checkpoint of the run it is in). Every rank
restores the same world-1 tree and the caller splits it for its own mesh,
so a checkpoint resumes under any layout and in a plain single-process
run, as vlrlhf_tpu's orbax manager restores onto any mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import torch

from vlrlhf_torch.core import dist


def _to_host(tree: Any) -> Any:
    """A copy of `tree` whose tensors live in host memory."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _write_dir(final: str, files: dict[str, Any]) -> None:
    """Write `files` ({name: tree for torch.save, or .json name: dict}) into
    a temporary sibling of `final` and rename it to `final`."""
    parent, name = os.path.split(final)
    tmp = os.path.join(parent, f".{name}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for fname, obj in files.items():
        if fname.endswith(".json"):
            with open(os.path.join(tmp, fname), "w") as f:
                json.dump(obj, f)
        else:
            torch.save(obj, os.path.join(tmp, fname))
    shutil.rmtree(final, ignore_errors=True)
    os.rename(tmp, final)


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _steps(self) -> list[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def save(self, step: int, state: dict, extra: Optional[dict] = None) -> None:
        """Snapshot `state` (a tree of tensors and ints) now; write it in
        the background. One save is in flight at a time. Under a process
        group only the first rank writes."""
        self.wait()
        if not dist.is_main_process():
            return
        files = {"state.pt": _to_host(state)}
        if extra:
            files["extra.json"] = extra

        def write():
            try:
                _write_dir(os.path.join(self.directory, str(step)), files)
                for old in self._steps()[: -self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
            except BaseException as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def restore(self, step: Optional[int] = None) -> tuple[dict, Optional[dict]]:
        """(state tree on the host, extra or None) of `step` (default: the
        latest). train_state.load_state_tree_ puts the tree back on the
        model's devices and dtypes."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoint in {self.directory}")
        path = os.path.join(self.directory, str(step))
        tree = torch.load(os.path.join(path, "state.pt"), map_location="cpu", weights_only=True)
        extra = None
        if os.path.exists(os.path.join(path, "extra.json")):
            with open(os.path.join(path, "extra.json")) as f:
                extra = json.load(f)
        return tree, extra

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self._steps()
        return steps[-1] if steps else None

    def wait(self) -> None:
        """Block until the save in flight is on disk; raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def close(self) -> None:
        self.wait()


def save_params(path: str, params: dict) -> None:
    """One-shot save of a tree of tensors (adapters, merged weights)."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    _write_dir(path, {"params.pt": _to_host(params)})


def load_params(path: str, mmap: bool = False) -> dict:
    """A tree written by save_params, on the host (with `mmap`, mapped
    from the file rather than read)."""
    return torch.load(os.path.join(os.path.abspath(path), "params.pt"), map_location="cpu",
                      weights_only=True, mmap=mmap)
