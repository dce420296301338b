"""JPEG decode through the native C++ image pipeline (native/imageops.cpp,
bound with ctypes) and PIL's bicubic resize (data/resample.py): the
counterpart of vlrlhf_tpu/data/native_image.py and the collators' default
image loader, so no PIL is needed on any path (the card machine has none).

Every image is decoded at its own size (no DCT downscaling) and resized by
data/resample.py, which is PIL's `Image.resize(..., BICUBIC)` bit for bit,
then centre-cropped as vlrlhf_tpu's PIL loader crops
(data/collators.py `default_image_loader`): what the reference feeds CLIP.
native/imageops.cpp's own bicubic (vlrlhf_tpu's native loader) is not
antialiased like PIL's and differs from it at sharp edges, so the port
does not call it.

The library is compiled from native/imageops.cpp with g++ (`-ljpeg
-lpthread`, the flags of native/Makefile) into `<repo>/build/` at first
use, keyed by the digest of the source and the flags; nothing is written
into native/. Unlike vlrlhf_tpu, nothing falls back to PIL: a failed build
raises with the compiler's own output (a library that does not load, with
the loader's), a path that is not a .jpg / .jpeg raises, and so does a file
the decoder rejects.

  load_image(path, size, mode)            one image -> (size, size, 3) uint8
  load_batch(paths, size, mode, threads)  a batch loaded on a thread pool
                                          (None or "" leaves a zero slot)
  decode_image(path)                      one image at its own size ->
                                          (H, W, 3) uint8 (anyres tiling)
  jpeg_size(path)                         (height, width) from the header
Modes: "shortest_edge_crop" (resize the short side to `size`, centre
crop; CLIP's) and "squash" (resize to size x size).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "imageops.cpp"
BUILD_DIR = ROOT / "build"
CXX_FLAGS = ["-O2", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]
LIBS = ["-ljpeg", "-lpthread"]
_MODES = ("squash", "shortest_edge_crop")
_JPEG = (".jpg", ".jpeg")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _library(source: Optional[Path] = None) -> ctypes.CDLL:
    """The loaded library built from `source` (default SOURCE), compiling
    it on first use; raises RuntimeError with g++'s output when the build
    fails."""
    source = Path(source or SOURCE)
    with _lock:
        lib = _libs.get(str(source))
        if lib is not None:
            return lib
        try:
            code = source.read_bytes()
        except OSError as e:
            raise RuntimeError(f"native image loader: cannot read {source}: {e}") from None
        digest = hashlib.sha256(code + " ".join(CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"libimageops-{digest}.so"
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", str(tmp),
                                   str(source), *LIBS], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"native image loader: g++ failed to build {source}:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: another process never loads a partial .so
        try:
            lib = ctypes.CDLL(str(out))
        except OSError as e:  # e.g. built where libjpeg is, loaded where it is not
            raise RuntimeError(f"native image loader: cannot load {out}: {e}") from None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.vlr_decode_jpeg.argtypes = [ctypes.c_char_p, u8p, ctypes.c_long, ip, ip]
        lib.vlr_decode_jpeg.restype = ctypes.c_long
        _libs[str(source)] = lib
        return lib


def _check(path: str) -> None:
    if not str(path).lower().endswith(_JPEG):
        raise ValueError(f"{path}: the native loader decodes JPEG (.jpg / .jpeg) only")


def resize_decoded(img: np.ndarray, size: int, mode: str = "shortest_edge_crop") -> np.ndarray:
    """A decoded (H, W, 3) uint8 image as the loader gives it: "squash"
    resizes to (size, size); "shortest_edge_crop" resizes the short side to
    `size` (the long one to round(side * scale)) and centre-crops, both
    with PIL's bicubic (vlrlhf_tpu's PIL loader, collators.py:43-53)."""
    from vlrlhf_torch.data.resample import resize_bicubic

    if mode not in _MODES:
        raise ValueError(f"resize mode {mode!r}: expected one of {sorted(_MODES)}")
    if mode == "squash":
        return resize_bicubic(img, (size, size))
    h, w = img.shape[:2]
    scale = size / min(w, h)
    nw, nh = round(w * scale), round(h * scale)
    out = resize_bicubic(img, (nw, nh))
    left, top = (nw - size) // 2, (nh - size) // 2
    return np.ascontiguousarray(out[top:top + size, left:left + size])


def load_image(path: str, size: int, mode: str = "shortest_edge_crop") -> np.ndarray:
    """Decode one JPEG at its own size, then resize: (size, size, 3) uint8."""
    _check(path)
    return resize_decoded(decode_image(path), size, mode)


def load_batch(paths: Sequence[Optional[str]], size: int, mode: str = "shortest_edge_crop",
               n_threads: int = 8) -> np.ndarray:
    """(len(paths), size, size, 3) uint8, each image `load_image`'s, on
    `n_threads` threads (the decode runs outside the GIL); a None or empty
    path leaves its slot zero."""
    from concurrent.futures import ThreadPoolExecutor

    for p in paths:
        if p:
            _check(p)
    out = np.zeros((len(paths), size, size, 3), np.uint8)
    live = [i for i, p in enumerate(paths) if p]

    def one(i):
        try:
            out[i] = load_image(paths[i], size, mode)
            return 0
        except ValueError:
            return 1

    with ThreadPoolExecutor(max(1, min(n_threads, len(live) or 1))) as pool:
        failed = sum(pool.map(one, live))
    if failed:
        raise ValueError(f"the native loader could not decode {failed} of the {len(paths)} "
                         f"images {[p for p in paths if p]}")
    return out


# JPEG start-of-frame markers (baseline, extended, progressive, lossless,
# and their arithmetic-coded twins); their payload holds the image size
_SOF = {0xC0, 0xC1, 0xC2, 0xC3, 0xC5, 0xC6, 0xC7, 0xC9, 0xCA, 0xCB, 0xCD, 0xCE, 0xCF}


def jpeg_size(path: str) -> tuple[int, int]:
    """(height, width) of a JPEG, read from its start-of-frame header (the
    size vlrlhf_tpu reads with PIL before it plans anyres tiles)."""
    _check(path)
    with open(path, "rb") as f:
        if f.read(2) != b"\xff\xd8":
            raise ValueError(f"{path}: not a JPEG")
        while True:
            byte = f.read(1)
            if not byte:
                break
            if byte != b"\xff":
                continue
            marker = f.read(1)
            while marker == b"\xff":  # fill bytes
                marker = f.read(1)
            if not marker:
                break
            m = marker[0]
            if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:  # no payload
                continue
            seg = f.read(2)
            if len(seg) < 2:
                break
            n = int.from_bytes(seg, "big")
            if m in _SOF:
                body = f.read(5)
                return int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big")
            f.seek(n - 2, 1)
    raise ValueError(f"{path}: no JPEG frame header")


def decode_image(path: str) -> np.ndarray:
    """Decode one JPEG at its own size: (H, W, 3) uint8 RGB."""
    _check(path)
    try:
        h, w = jpeg_size(path)
    except ValueError as e:
        raise ValueError(f"{path}: the native loader could not decode it ({e})") from None
    lib = _library()
    out = np.empty((h, w, 3), np.uint8)
    cw, ch = ctypes.c_int(0), ctypes.c_int(0)
    n = lib.vlr_decode_jpeg(os.fsencode(path), out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                            out.nbytes, ctypes.byref(cw), ctypes.byref(ch))
    if n < 0 or (ch.value, cw.value) != (h, w):
        raise ValueError(f"{path}: the native loader could not decode it")
    return out
