"""LLaVA-Next "anyres" multi-tile images (counterpart of
vlrlhf_tpu/models/anyres.py).

Host (at collate time, on the whole decoded image: the collators' loader
in its "raw" mode, the native JPEG decoder by default, which raises where
it does not build):
  - `select_best_resolution` over the grid pinpoints;
  - the tiles: tile 0 is the whole image squashed to one tile, tiles 1..
    are an aspect-preserving resize, centred on the best resolution's
    canvas and cut row-major (`tiles_from_image`, PIL's bicubic repeated
    bit for bit by data/resample.py);
  - the unpad + newline layout as a gather map from the flattened
    per-tile feature grid to the image's token stream (`anyres_plan`):
    NEWLINE_IDX marks the learned image_newline rows, PAD_IDX the padding
    of a batch's shorter rows.

Device (`gather_anyres_features`): one gather over the tower's patch
features plus the newline row; PAD_IDX slots give zero rows, which the
merge never places (their image_positions are -1).

Tokens per image = 576 (base tile) + unpadded_h * (unpadded_w + 1), HF's
pack_image_features count.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from vlrlhf_torch.data.resample import resize_bicubic

NEWLINE_IDX = -1
PAD_IDX = -2

DEFAULT_GRID_PINPOINTS = (
    (336, 672), (672, 336), (672, 672), (1008, 336), (336, 1008),
)


def anyres_max_dims(grid_pinpoints=DEFAULT_GRID_PINPOINTS, tile_size: int = 336,
                    tile_grid: int = 24) -> tuple[int, int]:
    """Worst-case (n_tiles, n_tokens) over the pinpoint grid: fixed
    collation shapes (unpad can only shrink below this bound)."""
    per_tile = tile_grid * tile_grid
    max_tiles, max_tok = 1, per_tile
    for h, w in grid_pinpoints:
        th, tw = h // tile_size, w // tile_size
        max_tiles = max(max_tiles, 1 + th * tw)
        gh, gw = th * tile_grid, tw * tile_grid
        max_tok = max(max_tok, per_tile + gh * (gw + 1))
    return max_tiles, max_tok


def select_best_resolution(orig_size: tuple[int, int],
                           grid_pinpoints: Sequence[tuple[int, int]]) -> tuple[int, int]:
    """HF's select_best_resolution over (height, width) pinpoints: the most
    effective resolution, then the least wasted area."""
    oh, ow = orig_size
    best_fit = None
    max_effective = 0
    min_wasted = float("inf")
    for h, w in grid_pinpoints:
        scale = min(w / ow, h / oh)
        dw, dh = int(ow * scale), int(oh * scale)
        effective = min(dw * dh, ow * oh)
        wasted = w * h - effective
        if effective > max_effective or (effective == max_effective and wasted < min_wasted):
            max_effective = effective
            min_wasted = wasted
            best_fit = (h, w)
    return best_fit


def unpadded_feature_dims(orig_size: tuple[int, int], grid_h: int,
                          grid_w: int) -> tuple[int, int, int, int]:
    """(new_h, new_w, pad_top, pad_left) after HF's unpad_image in feature
    space, which removes `pad` from both sides."""
    oh, ow = orig_size
    original_ar = ow / oh
    current_ar = grid_w / grid_h
    if original_ar > current_ar:
        scale = grid_w / ow
        new_h = int(round(oh * scale, 7))
        pad = (grid_h - new_h) // 2
        return grid_h - 2 * pad, grid_w, pad, 0
    scale = grid_h / oh
    new_w = int(round(ow * scale, 7))
    pad = (grid_w - new_w) // 2
    return grid_h, grid_w - 2 * pad, 0, pad


def anyres_plan(orig_size: tuple[int, int], grid_pinpoints=DEFAULT_GRID_PINPOINTS,
                tile_size: int = 336, tile_grid: int = 24) -> dict:
    """The plan of one (height, width) image: best_resolution (h, w),
    n_tiles (base included), tiles_hw, n_tokens and `gather`, int32
    (n_tokens,) indices into the flattened (n_tiles * tile_grid**2) feature
    rows, NEWLINE_IDX at the newline slots; the base tile's features come
    first, verbatim."""
    best = select_best_resolution(orig_size, grid_pinpoints)
    tiles_h, tiles_w = best[0] // tile_size, best[1] // tile_size
    n_tiles = 1 + tiles_h * tiles_w
    per_tile = tile_grid * tile_grid
    base = np.arange(per_tile, dtype=np.int32)
    grid_h, grid_w = tiles_h * tile_grid, tiles_w * tile_grid
    new_h, new_w, pad_top, pad_left = unpadded_feature_dims(orig_size, grid_h, grid_w)
    r = np.arange(pad_top, pad_top + new_h)[:, None]
    c = np.arange(pad_left, pad_left + new_w)[None, :]
    tile = 1 + (r // tile_grid) * tiles_w + (c // tile_grid)  # +1: the base tile is 0
    flat = tile * per_tile + (r % tile_grid) * tile_grid + (c % tile_grid)
    rows = np.concatenate([flat, np.full((new_h, 1), NEWLINE_IDX)], axis=1)
    gather = np.concatenate([base, rows.reshape(-1).astype(np.int32)])
    return {
        "best_resolution": best,
        "n_tiles": n_tiles,
        "tiles_hw": (tiles_h, tiles_w),
        "n_tokens": int(gather.shape[0]),
        "gather": gather,
    }


def tiles_from_image(img: np.ndarray, plan: dict, tile_size: int = 336) -> np.ndarray:
    """(n_tiles, tile, tile, 3) uint8 tiles of one (H, W, 3) uint8 image:
    tile 0 the squashed image, then the canvas tiles row-major (HF's
    LlavaNextImageProcessor geometry, PIL's bicubic)."""
    oh, ow = img.shape[:2]
    best_h, best_w = plan["best_resolution"]
    out = np.zeros((plan["n_tiles"], tile_size, tile_size, 3), np.uint8)
    out[0] = resize_bicubic(img, (tile_size, tile_size))
    scale = min(best_w / ow, best_h / oh)
    nw, nh = int(ow * scale), int(oh * scale)
    canvas = np.zeros((best_h, best_w, 3), np.uint8)
    top, left = (best_h - nh) // 2, (best_w - nw) // 2
    canvas[top: top + nh, left: left + nw] = resize_bicubic(img, (nw, nh))
    tiles_h, tiles_w = plan["tiles_hw"]
    t = 1
    for r in range(tiles_h):
        for c in range(tiles_w):
            out[t] = canvas[r * tile_size: (r + 1) * tile_size,
                            c * tile_size: (c + 1) * tile_size]
            t += 1
    return out


def gather_anyres_features(features: torch.Tensor, gather: torch.Tensor,
                           newline: torch.Tensor) -> torch.Tensor:
    """(B, n_tiles * per_tile, D) tile features + (B, n_tokens) gather maps
    -> (B, n_tokens, D): NEWLINE_IDX slots take `newline` (D,), PAD_IDX
    slots are zero."""
    g = gather.long()
    safe = g.clamp(min=0)
    out = features.gather(1, safe[..., None].expand(*safe.shape, features.shape[-1]))
    out = torch.where((g == NEWLINE_IDX)[..., None], newline.to(out.dtype), out)
    return torch.where((g == PAD_IDX)[..., None], torch.zeros((), dtype=out.dtype,
                                                              device=out.device), out)

