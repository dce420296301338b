"""Benchmark dataset loaders (counterpart of vlrlhf_tpu/eval/datasets.py):
TSV files with base64 images (MME, MMBench, MMMU, MathVista) and JSON /
JSONL forms (POPE, MMVet, SEEDBench, generic VQA), on the standard library
only.

vlrlhf_tpu reads a TSV with pandas; `read_tsv` gives the same rows: cells
typed per column as pandas' `read_csv` types them (int when every present
cell is an integer, float when every present cell is a number and any is
missing or fractional, bool for True / False, else str), pandas' default
missing-value strings read as NaN, and rows whose image is missing dropped.
A short image cell (<= 64 characters) names the row whose index holds the
data. Each image is written once to a directory as `<index>.jpg`, and
rows carry its path: `img_dir`, which run_benchmark keeps for the whole
run, or else a temporary one removed with the TSVBenchmark (vlrlhf_tpu's
benchmarks drop it before the images are read). The decoded bytes are
written unchanged and the image loader decodes them later; vlrlhf_tpu
re-encodes them as JPEG through PIL first, so pixels differ from its by
that lossy re-save.
"""

from __future__ import annotations

import ast
import base64
import csv
import json
import math
import os
import re
import tempfile
from typing import Any, Optional

# pandas.read_csv's default na_values (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"\s*[+-]?\d+\s*")
_TRUE, _FALSE = frozenset({"True", "TRUE", "true"}), frozenset({"False", "FALSE", "false"})


def _is_float(cell: str) -> bool:
    if "_" in cell:  # float() takes digit groups, pandas does not
        return False
    try:
        float(cell)
    except ValueError:
        return False
    return True


def _column(cells: list) -> list:
    """One column's cells (None = missing) typed as pandas types them."""
    present = [c for c in cells if c is not None]
    nan = float("nan")
    if not present:
        return [nan] * len(cells)
    if all(_INT.fullmatch(c) for c in present):
        if len(present) == len(cells):
            return [int(c) for c in cells]
        return [nan if c is None else float(int(c)) for c in cells]
    if all(_is_float(c) for c in present):
        return [nan if c is None else float(c) for c in cells]
    if all(c in _TRUE or c in _FALSE for c in present):
        return [nan if c is None else c in _TRUE for c in cells]
    return [nan if c is None else c for c in cells]


def read_tsv(path: str) -> list[dict]:
    """The rows of a tab-separated file with a header row, as dicts in
    column order, typed per column (see the module note)."""
    with open(path, newline="", encoding="utf-8") as f:
        lines = [r for r in csv.reader(f, delimiter="\t") if r]
    header, body = lines[0], lines[1:]
    cols = []
    for j in range(len(header)):
        cells = [r[j] if j < len(r) else "" for r in body]
        cols.append(_column([None if c in NA_STRINGS else c for c in cells]))
    return [{name: col[i] for name, col in zip(header, cols)} for i in range(len(body))]


def _missing(v: Any) -> bool:
    return isinstance(v, float) and math.isnan(v)


class TSVBenchmark:
    """MME / MMBench / SEEDBench (tsv) / MMMU / MathVista style."""

    def __init__(self, data_file: str, img_dir: Optional[str] = None):
        data = [r for r in read_tsv(data_file) if not _missing(r["image"])]
        for r in data:
            r["index"], r["image"] = str(r["index"]), str(r["image"])
        # short 'image' cells point at the row whose index holds the real data
        image_map = {r["index"]: r["image"] for r in data}
        for k in list(image_map):
            if len(image_map[k]) <= 64:
                idx = image_map[k]
                if idx not in image_map or len(image_map[idx]) <= 64:
                    raise ValueError(f"row {k}: image cell {idx!r} names no row with image data")
                image_map[k] = image_map[idx]
        for r in data:
            r["image"] = image_map[r["index"]]
        self._tmp = tempfile.TemporaryDirectory() if img_dir is None else None
        self.img_dir = img_dir or self._tmp.name
        self.data = data
        self._img_cache: dict[str, str] = {}

    def _dump_image(self, index: str, b64: str) -> str:
        if index in self._img_cache:
            return self._img_cache[index]
        path = os.path.join(self.img_dir, f"{index}.jpg")
        if not os.path.exists(path):
            with open(path, "wb") as f:
                f.write(base64.b64decode(b64))
        self._img_cache[index] = path
        return path

    def rows(self) -> list[dict]:
        out = []
        for line in self.data:
            d = dict(line)
            img = d.pop("image")
            # MMMU-style multi-image rows store a python-list string
            if img.startswith("[") and img.endswith("]"):
                d["img"] = [self._dump_image(f"{d['index']}_{i}", b)
                            for i, b in enumerate(ast.literal_eval(img))]
            else:
                d["img"] = self._dump_image(str(d["index"]), img)
            out.append(d)
        return out


def load_json_benchmark(data_file: str, image_root: str = "",
                        image_key: str = "image") -> list[dict]:
    """POPE / MMVet / SEEDBench (json) / generic VQA."""
    with open(data_file) as f:
        if data_file.endswith(".jsonl"):
            raw = [json.loads(line) for line in f if line.strip()]
        else:
            raw = json.load(f)
            if isinstance(raw, dict):  # mmvet: {id: {...}}
                raw = [dict(v, index=k) for k, v in raw.items()]
    for d in raw:
        if image_key in d:
            d["img"] = os.path.join(image_root, d[image_key])
    return raw
