"""Bicubic resizing of a square position table (counterpart of
vlrlhf_tpu/ops/image.py `_torch_bicubic_matrix` / `interpolate_pos_embed`).

The table (n, d) is a g x g grid of d-wide rows. Resizing it to g' x g'
applies one (g', g) matrix along the rows and then along the columns,
in f32: the cubic-convolution kernel with a = -0.75 and clamped borders
that torch.nn.functional.interpolate(mode="bicubic", align_corners=False)
uses, which is what the released Qwen-VL and InternLM-XC2 weights were
trained under (their get_abs_pos / build_mlp resize). Three callers: a
tower whose table has another grid than its patches (XC2's 24 x 24 CLIP
table at 490 px), and the resampler's keys (Qwen-VL's 16 x 16 sincos table
over a 32 x 32 patch grid).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=16)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) f64 interpolation matrix of F.interpolate(bicubic,
    align_corners=False, antialias=False)."""
    a = -0.75

    def cubic(x: float) -> float:
        x = abs(x)
        if x <= 1:
            return (a + 2) * x**3 - (a + 3) * x**2 + 1
        if x < 2:
            return a * x**3 - 5 * a * x**2 + 8 * a * x - 4 * a
        return 0.0

    scale = n_in / n_out
    w = np.zeros((n_out, n_in), np.float64)
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        base = math.floor(src)
        frac = src - base
        for k in range(-1, 3):
            w[i, min(max(base + k, 0), n_in - 1)] += cubic(k - frac)
    return w


def interpolate_pos_embed(pos_embed: torch.Tensor, n_new: int) -> torch.Tensor:
    """(n_old, d) square-grid table -> (n_new, d) in its dtype, resized in
    f32; the same grid returns the table itself."""
    n_old, d = pos_embed.shape
    g_old, g_new = round(n_old**0.5), round(n_new**0.5)
    if g_old * g_old != n_old or g_new * g_new != n_new:
        raise ValueError(f"non-square grids: {n_old} -> {n_new}")
    if g_old == g_new:
        return pos_embed
    w = torch.from_numpy(bicubic_matrix(g_old, g_new)).to(torch.float32).to(pos_embed.device)
    grid = pos_embed.reshape(g_old, g_old, d).to(torch.float32)
    grid = torch.einsum("ij,jkd->ikd", w, grid)  # rows
    grid = torch.einsum("kj,ijd->ikd", w, grid)  # cols
    return grid.reshape(n_new, d).to(pos_embed.dtype)
