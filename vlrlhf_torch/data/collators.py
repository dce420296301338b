"""Collators: tokenized rows -> right-padded numpy batches (the generation,
DPO, SFT and RM collators of vlrlhf_tpu/data/collators.py, copied because
the original imports jax through its package; one image slot per row, the
first of a list, as vlrlhf_tpu's max_images=1). Images decode through the
native JPEG loader unless the caller passes an `image_loader(path, size,
mode)`; a DPO batch decodes on its thread pool (`load_batch`), as
vlrlhf_tpu's default pipeline does.

The families' extras (vlrlhf_tpu collators.py:131-189):
  - LLaVA-Next anyres (`CollatorConfig.anyres`): each row's image is
    planned from its size and cut into tiles (models/anyres.py);
    `pixel_values` is (B, max_tiles, H, W, 3), `anyres_gather` (B,
    max_tokens) with PAD_IDX past a row's tokens, and the placeholder
    expands to the row's own token count. The image comes whole from
    `image_loader(path, 0, "raw")` (default: the native decoder);
  - InstructBLIP: rows carrying `qformer_input_ids` give
    `qformer_input_ids` / `qformer_mask` (B, T), padded to the batch's
    longest.

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
    """Host-side decode + resize to (size, size, 3) uint8 through the native
    JPEG loader (data/native_image.py; no PIL, no fallback).

    mode 'shortest_edge_crop' = CLIP-style resize+center-crop; 'squash' =
    plain resize; 'raw' = the image at its own size (H, W, 3), `size`
    unused (anyres tiling)."""
    from vlrlhf_torch.data.native_image import decode_image, load_image

    if mode == "raw":
        return decode_image(path)
    return load_image(path, size, mode)


@dataclasses.dataclass
class CollatorConfig:
    pad_token_id: int = 0
    bucket_multiple: int = 128
    image_size: int = 336
    resize_mode: str = "shortest_edge_crop"
    compute_diff_mask: bool = False  # DDPO: precompute diff masks
    pad_to: int = 0  # fixed batch length; 0 = bucket by batch max
    # LLaVA-Next anyres: variable tile grids + gather-map packing
    # (models/anyres.py); tile_grid = the tower's feature grid per tile
    anyres: bool = False
    grid_pinpoints: tuple = ()
    tile_grid: int = 24
    # the LM's sliding window (Mistral): a row longer than it is refused,
    # as the attention kernels hold no window (0 = full attention)
    sliding_window: int = 0


def _check_window(cfg: CollatorConfig, longest: int) -> None:
    if cfg.sliding_window and longest > cfg.sliding_window:
        raise ValueError(f"a row of {longest} tokens is longer than the LM's sliding_window "
                         f"{cfg.sliding_window}: windowed attention is not ported")


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


class _CollatorBase:
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
        """(B, 1, size, size, 3) uint8, a zero slot for a row without one
        (a batch without images never reaches the loader)."""
        s = self.cfg.image_size
        paths = [_first_image(p) for p in img_paths]
        if self.image_loader is default_image_loader and any(p is not None for p in paths):
            from vlrlhf_torch.data.native_image import load_batch

            return load_batch(paths, s, self.cfg.resize_mode)[:, None]
        out = np.zeros((len(paths), 1, s, s, 3), np.uint8)
        for i, path in enumerate(paths):
            if path is not None:
                out[i, 0] = self.image_loader(path, s, self.cfg.resize_mode)
        return out

    def _images(self, rows: list[dict]) -> tuple[dict, list]:
        """The batch's image fields and each row's per-image token counts
        (None: the fixed num_image_tokens): pixel_values, plus the anyres
        gather map in anyres mode."""
        img_paths = [r.get("img_path") for r in rows]
        if not self.cfg.anyres:
            return {"pixel_values": self._load_images(img_paths)}, [None] * len(rows)
        pixel, gather, counts = self._anyres_meta(img_paths)
        return {"pixel_values": pixel, "anyres_gather": gather}, counts

    def _anyres_meta(self, img_paths: list):
        """Per-row anyres plan and tiles: pixel (B, max_tiles, s, s, 3),
        gather (B, max_tokens) PAD_IDX-filled, and each row's counts
        ([] for a row without an image)."""
        from vlrlhf_torch.models.anyres import (
            DEFAULT_GRID_PINPOINTS, PAD_IDX, anyres_plan, tiles_from_image,
        )

        cfg = self.cfg
        s = cfg.image_size
        pinpoints = cfg.grid_pinpoints or DEFAULT_GRID_PINPOINTS
        plans, tiles = [], []
        for paths in img_paths:
            path = _first_image(paths)
            if path is None:
                plans.append(None)
                tiles.append(None)
                continue
            img = self.image_loader(path, 0, "raw")
            plan = anyres_plan(img.shape[:2], pinpoints, s, cfg.tile_grid)
            plans.append(plan)
            tiles.append(tiles_from_image(img, plan, s))
        max_tiles = max((p["n_tiles"] for p in plans if p), default=1)
        max_tok = max((p["n_tokens"] for p in plans if p), default=1)
        pixel = np.zeros((len(img_paths), max_tiles, s, s, 3), np.uint8)
        gather = np.full((len(img_paths), max_tok), PAD_IDX, np.int32)
        counts = []
        for i, (plan, t) in enumerate(zip(plans, tiles)):
            if plan is None:
                counts.append([])
                continue
            pixel[i, : plan["n_tiles"]] = t
            gather[i, : plan["n_tokens"]] = plan["gather"]
            counts.append([plan["n_tokens"]])
        return pixel, gather, counts

    def _qformer_batch(self, rows: list[dict]) -> dict:
        """Padded Q-Former instruction ids and mask (InstructBLIP rows)."""
        if not rows or "qformer_input_ids" not in rows[0]:
            return {}
        ids = [np.asarray(r["qformer_input_ids"]) for r in rows]
        L = max(len(x) for x in ids)
        out = np.zeros((len(ids), L), np.int32)
        mask = np.zeros((len(ids), L), bool)
        for i, x in enumerate(ids):
            out[i, : len(x)] = x
            mask[i, : len(x)] = True
        return {"qformer_input_ids": out, "qformer_mask": mask}

    def _positions(self, expanded: list, images: dict) -> np.ndarray:
        """(rows, n_tok) image positions, -1 past each row's own."""
        n_pos = (images["anyres_gather"].shape[1] if "anyres_gather" in images
                 else self.processor.cfg.num_image_tokens)
        img_pos = np.full((len(expanded), n_pos), -1, np.int32)
        for i, x in enumerate(expanded):
            img_pos[i, : len(x[-1])] = x[-1]
        return img_pos


class GenerationCollator(_CollatorBase):
    """RIGHT-padded prompt batches for generation, one image slot per row."""

    def __call__(self, rows: list[dict]) -> dict[str, Any]:
        """rows: {"input_ids": template-tokenized ids, "img_path": str|None,
        "qformer_input_ids"?}."""
        cfg = self.cfg
        images, counts = self._images(rows)
        expanded = [self.processor.expand_image_tokens(r["input_ids"], None, cnt)
                    for r, cnt in zip(rows, counts)]
        _check_window(cfg, max(len(x[0]) for x in expanded))
        L = cfg.pad_to or _round_up(max(len(x[0]) for x in expanded), cfg.bucket_multiple)
        b = len(rows)
        ids = np.full((b, L), cfg.pad_token_id, np.int32)
        pad_mask = np.zeros((b, L), bool)
        for i, (row_ids, _, _) in enumerate(expanded):
            ids[i, : len(row_ids)] = row_ids
            pad_mask[i, : len(row_ids)] = True
        return {
            "input_ids": ids,
            "pad_mask": pad_mask,
            "image_positions": self._positions(expanded, images),
            "prompt_lens": np.asarray([len(x[0]) for x in expanded], np.int32),
            **images,
            **self._qformer_batch(rows),
        }


class DPOCollator(_CollatorBase):
    """Rows from tokenize_row_dpo -> a concatenated [chosen; rejected]
    batch: input_ids, labels, pad_mask, image_positions (2B rows),
    pixel_values (B pairs, 1 | n_tiles, H, W, 3) uint8 (one image per
    pair), per pair the anyres_gather / qformer fields of its family, the
    precomputed ref_chosen_logps / ref_rejected_logps when the rows carry
    them, and the DDPO loss_mask when asked for."""

    def __call__(self, rows: list[dict]) -> dict[str, Any]:
        cfg = self.cfg
        exp = self.processor.expand_image_tokens
        images, counts = self._images(rows)
        chosen = [exp(r["chosen_input_ids"], r["chosen_labels"], c) for r, c in zip(rows, counts)]
        rejected = [exp(r["rejected_input_ids"], r["rejected_labels"], c)
                    for r, c in zip(rows, counts)]
        all_rows = chosen + rejected  # [chosen...; rejected...]
        max_len = max(len(x[0]) for x in all_rows)
        _check_window(cfg, max_len)
        L = cfg.pad_to or _round_up(max_len, cfg.bucket_multiple)
        if max_len > L:
            raise ValueError(f"row of {max_len} tokens does not fit pad_to={L}")
        labels = _pad_rows([x[1] for x in all_rows], LABEL_PAD, L, np.int64)
        batch = {
            "input_ids": _pad_rows([x[0] for x in all_rows], cfg.pad_token_id, L),
            "labels": labels,
            "pad_mask": _pad_rows([np.ones(len(x[0]), np.int32) for x in all_rows], 0, L)
            .astype(bool),
            "image_positions": self._positions(all_rows, images),
            **images,
            **self._qformer_batch(rows),
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
    padding), pad_mask, image_positions and pixel_values (B, 1 | n_tiles,
    H, W, 3) uint8 (+ the family's anyres / qformer fields): vlrlhf_tpu's SFTCollator (collators.py:284-330), the batch of
    the CE ranking forward (eval/harness.py run_vqa_ppl)."""

    def __call__(self, rows: list[dict]) -> dict[str, Any]:
        cfg = self.cfg
        images, counts = self._images(rows)
        expanded = [self.processor.expand_image_tokens(r["input_ids"], r["labels"], c)
                    for r, c in zip(rows, counts)]
        _check_window(cfg, max(len(x[0]) for x in expanded))
        L = cfg.pad_to or _round_up(max(len(x[0]) for x in expanded), cfg.bucket_multiple)
        return {
            "input_ids": _pad_rows([x[0] for x in expanded], cfg.pad_token_id, L),
            "labels": _pad_rows([x[1] for x in expanded], LABEL_PAD, L, np.int64),
            "pad_mask": _pad_rows([np.ones(len(x[0]), np.int32) for x in expanded], 0, L)
            .astype(bool),
            "image_positions": self._positions(expanded, images),
            **images,
            **self._qformer_batch(rows),
        }


class RMCollator(DPOCollator):
    """Reward-model batches share the DPO [chosen; rejected] layout; labels
    are unused by the RM loss but kept for parity checks (vlrlhf_tpu's
    RMCollator, collators.py:331)."""
