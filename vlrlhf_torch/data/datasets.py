"""Dataset builders and the train / eval split (vlrlhf_tpu/data/datasets.py:
`make_vlfeedback_pairs`, `make_vlfeedback_paired_dataset`,
`build_dataset_from_vlquery_json`, `make_rlhfv_paired_dataset`,
`build_plain_dpo_dataset`, `DATASET_MAP`, `train_eval_split`,
`shard_rows_for_process`), copied
because importing anything under vlrlhf_tpu pulls in jax.

The rows are the same as vlrlhf_tpu's for the same files. Data comes from
local .json / .jsonl files only: vlrlhf_tpu's `_load_json_or_hf` hands any
other path to HF `datasets` (the hub, or a datasets directory), which the
port refuses by name, since the card machine has no network.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from itertools import combinations
from typing import Any, Optional

import numpy as np

Row = dict[str, Any]


def make_vlfeedback_pairs(samples: list[dict], score_margin: float = -1) -> list[Row]:
    """VLFeedback's multi-annotator rows -> preference pairs: every pair of
    completions compared by mean annotator rating; unparseable ratings and
    ties are skipped; then every pair with gap >= score_margin, or with
    score_margin -1 only each sample's largest-gap pairs."""
    out: list[Row] = []
    for sample in samples:
        prompt = sample["prompt"]
        img_path = sample["img_path"]
        comps = sample["completions"]
        by_gap: dict[float, list[Row]] = defaultdict(list)
        annos = comps["annotations"]
        responses = comps["response"]
        for i1, i2 in combinations(range(len(annos)), 2):
            a1, a2 = annos[i1], annos[i2]
            try:
                s1 = np.mean([float(a1[k]["Rating"]) for k in a1])
                s2 = np.mean([float(a2[k]["Rating"]) for k in a2])
            except ValueError:
                continue
            if s1 > s2:
                chosen, rejected = responses[i1], responses[i2]
            elif s2 > s1:
                chosen, rejected = responses[i2], responses[i1]
            else:
                continue
            by_gap[abs(s1 - s2)].append(
                {"prompt": prompt, "chosen": chosen, "rejected": rejected, "img_path": img_path})
        if not by_gap:
            continue
        if score_margin == -1:
            out.extend(by_gap[max(by_gap)])
        else:
            for gap, rows in by_gap.items():
                if gap >= score_margin:
                    out.extend(rows)
    return out


def load_json_rows(path: str) -> list[dict]:
    """The rows of a local .json (a list) or .jsonl (one object a line)."""
    if not (os.path.isfile(path) and path.endswith((".json", ".jsonl"))):
        raise ValueError(
            f"{path!r}: the port reads local .json / .jsonl files only; a hub dataset name or a "
            "`datasets` directory needs HF datasets and a network (export the split to JSON)")
    with open(path) as f:
        if path.endswith(".jsonl"):
            return [json.loads(line) for line in f if line.strip()]
        return json.load(f)


def make_vlfeedback_paired_dataset(data_path: str = "MMInstruction/VLFeedback",
                                   image_root: Optional[str] = None,
                                   score_margin: float = -1) -> list[Row]:
    samples = load_json_rows(data_path)
    if image_root:
        for s in samples:
            if s.get("img_path") and not os.path.isabs(s["img_path"]):
                s["img_path"] = os.path.join(image_root, s["img_path"])
    return make_vlfeedback_pairs(samples, score_margin)


def build_dataset_from_vlquery_json(data_path: str, image_root: str = "") -> list[Row]:
    return [dict(d, img_path=os.path.join(image_root, d["image"]))
            for d in load_json_rows(data_path)]


def make_rlhfv_paired_dataset(data_path: str = "HaoyeZhang/RLHF-V-Dataset",
                              image_root: str = "") -> list[Row]:
    out = []
    for s in load_json_rows(data_path):
        text = json.loads(s["text"]) if isinstance(s["text"], str) else s["text"]
        out.append({"prompt": text["question"], "chosen": text["chosen"],
                    "rejected": text["rejected"],
                    "img_path": os.path.join(image_root, s["image_path"])})
    return out


def build_plain_dpo_dataset(data_path: str, image_root: str = "") -> list[Row]:
    return [{"prompt": d["prompt"], "chosen": d["chosen"], "rejected": d["rejected"],
             "img_path": os.path.join(image_root, d["image"]) if "image" in d else None}
            for d in load_json_rows(data_path)]


DATASET_MAP = {
    "vlfeedback_paired": make_vlfeedback_paired_dataset,
    "vlquery_json": build_dataset_from_vlquery_json,
    "rlhfv": make_rlhfv_paired_dataset,
    "plain_dpo": build_plain_dpo_dataset,
}


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


def shard_rows_for_process(rows: list[Row]) -> list[Row]:
    """This process's contiguous ceil(n / world) shard of the rows
    (vlrlhf_tpu `shard_rows_for_process`, datasets.py:157-167): eval's
    rows under torchrun, gathered back in process order."""
    from vlrlhf_torch.core.dist import process_count, process_index

    n = process_count()
    if n == 1:
        return rows
    idx = process_index()
    per = -(-len(rows) // n)
    return rows[idx * per : (idx + 1) * per]
