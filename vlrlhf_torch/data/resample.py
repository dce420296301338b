"""PIL's uint8 bicubic resize in numpy, bit for bit.

vlrlhf_tpu cuts LLaVA-Next's anyres tiles with PIL's
`Image.resize(size, Image.BICUBIC)` (vlrlhf_tpu/models/anyres.py
`tiles_from_image`); the port may not import PIL, so this module repeats
what PIL's Resample.c does for an 8-bit image:

  - two separable passes, horizontal first, each skipped when that axis
    keeps its size; the intermediate image is uint8 (clipped);
  - per output pixel, a bicubic (a = -0.5) kernel whose support widens
    with the downscale factor (antialiasing), centred at (x + 0.5) * scale,
    the window [xmin, xmin + xmax) rounded as PIL rounds it;
  - the weights normalised to sum 1 in double, then fixed point with 22
    fractional bits, each rounded half away from zero;
  - the sum starts at 1 << 21 (rounding) and is shifted right by 22 and
    clipped to [0, 255].

`tests/test_torch_anyres.py` holds it against PIL for up- and downscales
and odd sizes.
"""

from __future__ import annotations

import math

import numpy as np

PRECISION_BITS = 32 - 8 - 2
_SUPPORT = 2.0  # bicubic


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def coefficients(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """PIL's `precompute_coeffs` + `normalize_coeffs_8bpc` for the full box:
    (xmin (out,), xmax (out,) window lengths, int64 weights (out, ksize))."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.trunc(center - support + 0.5).astype(np.int64)  # C's (int) cast
    xmin = np.maximum(xmin, 0)
    xmax = np.trunc(center + support + 0.5).astype(np.int64)
    xmax = np.minimum(xmax, in_size) - xmin
    taps = np.arange(ksize, dtype=np.int64)
    live = taps[None, :] < xmax[:, None]
    pos = (taps[None, :] + xmin[:, None]).astype(np.float64)
    w = np.where(live, _bicubic((pos - center[:, None] + 0.5) * ss), 0.0)
    ww = np.zeros(out_size, np.float64)
    for k in range(ksize):  # PIL's left-to-right sum, not numpy's pairwise one
        ww = ww + w[:, k]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    fixed = w * (1 << PRECISION_BITS)
    fixed = np.trunc(np.where(fixed < 0, fixed - 0.5, fixed + 0.5)).astype(np.int64)
    return xmin, xmax, np.where(live, fixed, 0)


def _pass(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit resampling pass of `img` (H, W, C) uint8 along `axis`."""
    in_size = img.shape[axis]
    xmin, _, k = coefficients(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # (in, other, C)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int64)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)  # weight 0 past the window
        acc += src[idx] * k[:, t][:, None, None]
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, as PIL's
    `Image.fromarray(img).resize((width, height), Image.BICUBIC)`.
    `size` is (width, height), PIL's order."""
    width, height = size
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_bicubic takes (H, W, C) uint8, got {img.dtype} {img.shape}")
    if width < 1 or height < 1:
        raise ValueError(f"resize_bicubic: size {size} must be positive")
    out = img
    if width != img.shape[1]:
        out = _pass(out, width, 1)
    if height != img.shape[0]:
        out = _pass(out, height, 0)
    return np.array(out, copy=True) if out is img else out
