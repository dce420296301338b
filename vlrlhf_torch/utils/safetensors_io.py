"""Read and write the safetensors format without the `safetensors` package
(which vlrlhf_tpu imports, utils/hf_port.py and utils/hf_export.py, and the
card machine lacks).

A file is an 8-byte little-endian header length N, N bytes of JSON
({name: {"dtype", "shape", "data_offsets": [begin, end]}, optional
"__metadata__": {str: str}}), then the data block; offsets are relative to
the block's start. The reader maps the file once and gives each tensor as
a `torch.frombuffer` view of its byte range, so `__getitem__` reads one
tensor and nothing else; a sharded checkpoint is taken through its
`model.safetensors.index.json`. The writer puts tensors back to back in one
file, widest dtype first so that each starts at a multiple of its element
size (the format wants no gaps), with `__metadata__ {"format": "pt"}`.

A header that names an unknown dtype, gives a byte range that does not fit
its shape, overlaps another tensor's or runs past the end of the file is
refused with the file's name: a wrong offset would read another tensor's
bytes as weights.
"""

from __future__ import annotations

import json
import math
import mmap
import os
import struct
from typing import Iterator, Mapping

import torch

DTYPES = {
    "BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32,
    "I64": torch.int64, "I32": torch.int32, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}
INDEX_NAME = "model.safetensors.index.json"
_MAX_HEADER = 100 * 1024 * 1024  # the format's own limit


class SafetensorsFile(Mapping):
    """One .safetensors file: name -> tensor view (read-only use; the map is
    private copy-on-write, so a caller's in-place write never reaches the
    file)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            raw = f.read(8)
            if len(raw) < 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", raw)
            if n > _MAX_HEADER or 8 + n > size:
                raise ValueError(f"{path}: header length {n} does not fit a {size}-byte file")
            try:
                header = json.loads(f.read(n))
            except (UnicodeDecodeError, json.JSONDecodeError) as e:
                raise ValueError(f"{path}: header is not JSON: {e}") from None
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY) if size else None
        self.metadata = header.pop("__metadata__", None) or {}
        self._base = 8 + n
        self._entries = _check_header(path, header, size - self._base)

    def __getitem__(self, name: str) -> torch.Tensor:
        dtype, shape, begin, end = self._entries[name]
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        t = torch.frombuffer(self._map, dtype=dtype, count=math.prod(shape),
                             offset=self._base + begin)
        return t.reshape(shape)

    def __contains__(self, name) -> bool:  # Mapping's default would read the tensor
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def _check_header(path: str, header: dict, data_size: int) -> dict:
    entries = {}
    for name, info in header.items():
        dt = info.get("dtype") if isinstance(info, dict) else None
        if dt not in DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {dt!r}; the reader takes "
                             f"{sorted(DTYPES)}")
        shape = tuple(int(s) for s in info["shape"])
        begin, end = (int(o) for o in info["data_offsets"])
        want = math.prod(shape) * DTYPES[dt].itemsize
        if begin < 0 or end - begin != want:
            raise ValueError(f"{path}: tensor {name!r} {dt}{list(shape)} needs {want} bytes, "
                             f"its offsets [{begin}, {end}] give {end - begin}")
        if end > data_size:
            raise ValueError(f"{path}: tensor {name!r} ends at byte {end} of a "
                             f"{data_size}-byte data block (the file is cut short)")
        entries[name] = (DTYPES[dt], shape, begin, end)
    spans = sorted((b, e, k) for k, (_, _, b, e) in entries.items() if e > b)
    for (_, e0, k0), (b1, _, k1) in zip(spans, spans[1:]):
        if b1 < e0:
            raise ValueError(f"{path}: tensors {k0!r} and {k1!r} overlap")
    return entries


class SafetensorsDir(Mapping):
    """Every tensor of a checkpoint directory by name: the shards its
    index.json names, else every *.safetensors file in it. Each file is
    opened (its header read) once; values are read on access."""

    def __init__(self, path: str):
        index = os.path.join(path, INDEX_NAME)
        if os.path.exists(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
            files = sorted(set(weight_map.values()))
        else:
            files = sorted(n for n in os.listdir(path) if n.endswith(".safetensors"))
            weight_map = None
        if not files:
            raise FileNotFoundError(f"no .safetensors file under {path}")
        self._files = {n: SafetensorsFile(os.path.join(path, n)) for n in files}
        self._where: dict[str, str] = {}
        for n, sf in self._files.items():
            for k in sf:
                if k in self._where:
                    raise ValueError(f"{path}: tensor {k!r} is in both {self._where[k]} and {n}")
                self._where[k] = n
        if weight_map is not None:
            missing = sorted(k for k in weight_map if weight_map[k] != self._where.get(k))
            if missing:
                raise ValueError(f"{index} names tensors its shards do not hold where it says: "
                                 f"{missing[:5]}")

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._files[self._where[name]][name]

    def __contains__(self, name) -> bool:
        return name in self._where

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)


def save_file(tensors: Mapping[str, torch.Tensor], path: str,
              metadata: Mapping[str, str] | None = None,
              float_dtype: torch.dtype | None = None) -> int:
    """Write `tensors` (any device; each copied to the host in turn, floating
    ones cast to `float_dtype` when given) to one safetensors file; returns
    its size in bytes. The file appears only when complete (written beside
    it, then renamed)."""

    def dtype_of(t: torch.Tensor) -> torch.dtype:
        return float_dtype if float_dtype is not None and t.is_floating_point() else t.dtype

    header: dict = {"__metadata__": dict(metadata or {"format": "pt"})}
    order = sorted(tensors, key=lambda k: -dtype_of(tensors[k]).itemsize)  # stable
    offset = 0
    for name in order:
        t = tensors[name]
        dt = dtype_of(t)
        if dt not in _NAMES:
            raise ValueError(f"{name}: dtype {dt} has no safetensors name here")
        n = t.numel() * dt.itemsize
        header[name] = {"dtype": _NAMES[dt], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * ((-len(raw)) % 8)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(struct.pack("<Q", len(raw)))
            f.write(raw)
            for name in order:
                t = tensors[name]
                if t.numel():
                    host = t.detach().to(dtype_of(t)).to("cpu").contiguous().reshape(-1)
                    f.write(host.view(torch.uint8).numpy().data)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return 8 + len(raw) + offset
