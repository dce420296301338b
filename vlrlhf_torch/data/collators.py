"""Collators: tokenized rows -> right-padded numpy batches (the generation,
DPO and SFT collators of vlrlhf_tpu/data/collators.py, copied because the
original imports jax through its package; no anyres or Q-Former; one image
slot per row, the first of a list, as vlrlhf_tpu's max_images=1).

Right padding because the engine's KV-cache slot index equals the absolute
token position (generate/engine.py). Images ship as raw uint8; rescale and
normalize happen on the device (models/vlm.py encode_images).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from vlrlhf_torch.data.diffmask import diff_masks
from vlrlhf_torch.data.processor import LABEL_PAD, VLProcessor


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def default_image_loader(path: str, size: int, mode: str = "shortest_edge_crop"):
    """Host-side decode + resize to (size, size, 3) uint8.

    mode 'shortest_edge_crop' = CLIP-style resize+center-crop; 'squash' =
    plain resize."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if mode == "squash":
        img = img.resize((size, size), Image.BICUBIC)
    else:
        w, h = img.size
        scale = size / min(w, h)
        img = img.resize((round(w * scale), round(h * scale)), Image.BICUBIC)
        w, h = img.size
        left, top = (w - size) // 2, (h - size) // 2
        img = img.crop((left, top, left + size, top + size))
    return np.asarray(img, np.uint8)


@dataclasses.dataclass
class CollatorConfig:
    pad_token_id: int = 0
    bucket_multiple: int = 128
    image_size: int = 336
    resize_mode: str = "shortest_edge_crop"
    compute_diff_mask: bool = False  # DDPO: precompute diff masks
    pad_to: int = 0  # fixed batch length; 0 = bucket by batch max


def _pad_rows(rows: list, pad_value: int, length: int, dtype=np.int32) -> np.ndarray:
    out = np.full((len(rows), length), pad_value, dtype)
    for i, r in enumerate(rows):
        out[i, : len(r)] = r[:length]
    return out


def _first_image(path):
    """The one image a row carries: a path, the first of a list, or None."""
    if isinstance(path, list):
        return path[0] if path else None
    return path


class GenerationCollator:
    """RIGHT-padded prompt batches for generation, one image slot per row."""

    def __init__(
        self,
        processor: VLProcessor,
        cfg: CollatorConfig,
        image_loader: Optional[Callable] = None,  # None = default_image_loader
    ):
        self.processor = processor
        self.cfg = cfg
        self.image_loader = image_loader or default_image_loader

    def __call__(self, rows: list[dict]) -> dict[str, Any]:
        """rows: {"input_ids": template-tokenized ids, "img_path": str|None}."""
        cfg = self.cfg
        expanded = []
        for r in rows:
            ids, _, pos = self.processor.expand_image_tokens(r["input_ids"])
            expanded.append((ids, pos))
        L = _round_up(max(len(ids) for ids, _ in expanded), cfg.bucket_multiple)
        b = len(rows)
        s = cfg.image_size
        ids = np.full((b, L), cfg.pad_token_id, np.int32)
        pad_mask = np.zeros((b, L), bool)
        img_pos = np.full((b, self.processor.cfg.num_image_tokens), -1, np.int32)
        pixels = np.zeros((b, 1, s, s, 3), np.uint8)
        for i, ((row_ids, pos), row) in enumerate(zip(expanded, rows)):
            ids[i, : len(row_ids)] = row_ids
            pad_mask[i, : len(row_ids)] = True
            img_pos[i, : len(pos)] = pos
            path = _first_image(row.get("img_path"))
            if path is not None:
                pixels[i, 0] = self.image_loader(path, s, cfg.resize_mode)
        return {
            "input_ids": ids,
            "pad_mask": pad_mask,
            "image_positions": img_pos,
            "prompt_lens": np.asarray([len(x) for x, _ in expanded], np.int32),
            "pixel_values": pixels,
        }


class DPOCollator:
    """Rows from tokenize_row_dpo -> a concatenated [chosen; rejected]
    batch: input_ids, labels, pad_mask, image_positions (2B rows),
    pixel_values (B pairs, 1, H, W, 3) uint8 (one image per pair), the precomputed
    ref_chosen_logps / ref_rejected_logps when the rows carry them, and the
    DDPO loss_mask when asked for."""

    def __init__(
        self,
        processor: VLProcessor,
        cfg: CollatorConfig,
        image_loader: Optional[Callable] = None,  # None = default_image_loader
    ):
        self.processor = processor
        self.cfg = cfg
        self.image_loader = image_loader or default_image_loader

    def _load_images(self, img_paths: list) -> np.ndarray:
        s = self.cfg.image_size
        out = np.zeros((len(img_paths), 1, s, s, 3), np.uint8)
        for i, path in enumerate(img_paths):
            path = _first_image(path)
            if path is not None:
                out[i, 0] = self.image_loader(path, s, self.cfg.resize_mode)
        return out

    def __call__(self, rows: list[dict]) -> dict[str, Any]:
        cfg = self.cfg
        exp = self.processor.expand_image_tokens
        chosen = [exp(r["chosen_input_ids"], r["chosen_labels"]) for r in rows]
        rejected = [exp(r["rejected_input_ids"], r["rejected_labels"]) for r in rows]
        all_rows = chosen + rejected  # [chosen...; rejected...]
        max_len = max(len(x[0]) for x in all_rows)
        L = cfg.pad_to or _round_up(max_len, cfg.bucket_multiple)
        if max_len > L:
            raise ValueError(f"row of {max_len} tokens does not fit pad_to={L}")
        labels = _pad_rows([x[1] for x in all_rows], LABEL_PAD, L, np.int64)
        img_pos = np.full((len(all_rows), self.processor.cfg.num_image_tokens), -1, np.int32)
        for i, (_, _, pos) in enumerate(all_rows):
            img_pos[i, : len(pos)] = pos
        batch = {
            "input_ids": _pad_rows([x[0] for x in all_rows], cfg.pad_token_id, L),
            "labels": labels,
            "pad_mask": _pad_rows([np.ones(len(x[0]), np.int32) for x in all_rows], 0, L)
            .astype(bool),
            "image_positions": img_pos,
            "pixel_values": self._load_images([r.get("img_path") for r in rows]),
        }
        if "ref_chosen_logp" in rows[0]:
            batch["ref_chosen_logps"] = np.asarray([r["ref_chosen_logp"] for r in rows], np.float32)
            batch["ref_rejected_logps"] = np.asarray(
                [r["ref_rejected_logp"] for r in rows], np.float32)
        if cfg.compute_diff_mask:
            n = len(rows)
            masks = np.zeros((2 * n, L), bool)
            for i in range(n):
                masks[i], masks[n + i] = diff_masks(labels[i], labels[n + i], LABEL_PAD)
            batch["loss_mask"] = masks
        return batch


class SFTCollator(DPOCollator):
    """Rows from tokenize_row_sft -> input_ids, labels (LABEL_PAD on the
    padding), pad_mask, image_positions and pixel_values (B, 1, H, W, 3)
    uint8: vlrlhf_tpu's SFTCollator (collators.py:284-330), the batch of
    the CE ranking forward (eval/harness.py run_vqa_ppl)."""

    def __call__(self, rows: list[dict]) -> dict[str, Any]:
        cfg = self.cfg
        expanded = [self.processor.expand_image_tokens(r["input_ids"], r["labels"])
                    for r in rows]
        L = cfg.pad_to or _round_up(max(len(x[0]) for x in expanded), cfg.bucket_multiple)
        img_pos = np.full((len(rows), self.processor.cfg.num_image_tokens), -1, np.int32)
        for i, (_, _, pos) in enumerate(expanded):
            img_pos[i, : len(pos)] = pos
        return {
            "input_ids": _pad_rows([x[0] for x in expanded], cfg.pad_token_id, L),
            "labels": _pad_rows([x[1] for x in expanded], LABEL_PAD, L, np.int64),
            "pad_mask": _pad_rows([np.ones(len(x[0]), np.int32) for x in expanded], 0, L)
            .astype(bool),
            "image_positions": img_pos,
            "pixel_values": self._load_images([r.get("img_path") for r in rows]),
        }
