"""Generation collator: tokenized prompt rows -> right-padded numpy batches
(the serving subset of vlrlhf_tpu/data/collators.py, copied because the
original imports jax through its package).

Right padding because the engine's KV-cache slot index equals the absolute
token position (generate/engine.py). Images ship as raw uint8; rescale and
normalize happen on the device (models/vlm.py encode_images).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import numpy as np

from vlrlhf_torch.data.processor import VLProcessor


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
        expanded = [self.processor.expand_image_tokens(r["input_ids"]) for r in rows]
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
            if row.get("img_path") is not None:
                pixels[i, 0] = self.image_loader(row["img_path"], s, cfg.resize_mode)
        return {
            "input_ids": ids,
            "pad_mask": pad_mask,
            "image_positions": img_pos,
            "prompt_lens": np.asarray([len(x) for x, _ in expanded], np.int32),
            "pixel_values": pixels,
        }
