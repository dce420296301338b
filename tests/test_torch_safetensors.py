"""vlrlhf_torch/utils/safetensors_io.py against the `safetensors` package:
files written by safetensors.torch.save_file (bf16, f16, f32, i64, i32,
i8, u8, bool, an empty tensor, a sharded index) read back bit-exact; the
port's own files read by safetensors.safe_open bit-exact, its metadata
{"format": "pt"}; reads map one tensor and no other; the malformed headers
(unknown dtype, overlapping offsets, offsets past the end, a size that
does not fit the shape) are refused naming the file."""

import json
import struct

import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file as st_save_file

from vlrlhf_torch.utils import safetensors_io as sio


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "w.bf16": torch.randn(5, 7, generator=g).bfloat16(),
        "w.f16": torch.randn(3, 2, generator=g).half(),
        "w.f32": torch.randn(4, 3, 2, generator=g),
        "i.i64": torch.arange(-3, 6, dtype=torch.int64),
        "i.i32": torch.randint(-2**31, 2**31 - 1, (6,), generator=g, dtype=torch.int32),
        "i.i8": torch.randint(-128, 127, (2, 5), generator=g, dtype=torch.int8),
        "i.u8": torch.randint(0, 255, (9,), generator=g, dtype=torch.uint8),
        "m.bool": torch.tensor([True, False, True, True]),
        "e.empty": torch.zeros(0, 4),
        "s.scalar": torch.tensor(2.5),
    }


def _equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_reads_files_the_package_writes(tmp_path):
    want = _tensors()
    st_save_file(want, str(tmp_path / "a.safetensors"), metadata={"format": "pt"})
    f = sio.SafetensorsFile(str(tmp_path / "a.safetensors"))
    assert set(f) == set(want) and f.metadata == {"format": "pt"}
    for k, v in want.items():
        assert _equal(f[k], v), k


def test_package_reads_the_port_files(tmp_path):
    want = _tensors(1)
    path = str(tmp_path / "model.safetensors")
    size = sio.save_file(want, path)
    assert size == (tmp_path / "model.safetensors").stat().st_size
    with safe_open(path, framework="pt") as f:
        assert f.metadata() == {"format": "pt"}
        assert set(f.keys()) == set(want)
        for k, v in want.items():
            assert _equal(f.get_tensor(k), v), k
    # and the port reads its own back; floats cast on the way when asked
    sio.save_file(want, path, float_dtype=torch.bfloat16)
    back = sio.SafetensorsFile(path)
    for k, v in want.items():
        assert _equal(back[k], v.bfloat16() if v.is_floating_point() else v), k


def test_sharded_index_and_per_tensor_reads(tmp_path):
    want = _tensors(2)
    keys = sorted(want)
    shards = {"model-00001-of-00002.safetensors": keys[:5],
              "model-00002-of-00002.safetensors": keys[5:]}
    for name, ks in shards.items():
        st_save_file({k: want[k] for k in ks}, str(tmp_path / name))
    (tmp_path / sio.INDEX_NAME).write_text(json.dumps(
        {"metadata": {}, "weight_map": {k: n for n, ks in shards.items() for k in ks}}))
    (tmp_path / "stray.safetensors.bak").write_text("not read")
    sd = sio.SafetensorsDir(str(tmp_path))
    assert set(sd) == set(want) and len(sd) == len(want)
    assert "w.f32" in sd and "nope" not in sd
    for k, v in want.items():
        assert _equal(sd[k], v), k
    # a read is a view of that tensor's bytes only
    t = sd["w.f32"]
    assert t.untyped_storage().nbytes() == want["w.f32"].numel() * 4
    # an index that names a tensor a shard lacks is refused
    (tmp_path / sio.INDEX_NAME).write_text(json.dumps(
        {"weight_map": {"ghost": "model-00001-of-00002.safetensors"}}))
    with pytest.raises(ValueError, match="ghost"):
        sio.SafetensorsDir(str(tmp_path))


def _raw_file(path, header: dict, data: bytes) -> str:
    raw = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)) + raw + data)
    return str(path)


@pytest.mark.parametrize("header,data,match", [
    ({"a": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}}, b"\0" * 2,
     "dtype 'F8_E4M3'"),
    ({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
      "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}}, b"\0" * 12, "overlap"),
    ({"a": {"dtype": "F32", "shape": [4], "data_offsets": [0, 16]}}, b"\0" * 8, "cut short"),
    ({"a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}}, b"\0" * 8, "needs 12 bytes"),
])
def test_malformed_headers_are_refused_naming_the_file(tmp_path, header, data, match):
    path = _raw_file(tmp_path / "bad.safetensors", header, data)
    with pytest.raises(ValueError, match=match) as e:
        sio.SafetensorsFile(path)
    assert "bad.safetensors" in str(e.value)


def test_truncated_header_is_refused(tmp_path):
    path = tmp_path / "short.safetensors"
    path.write_bytes(struct.pack("<Q", 1000) + b"{}")
    with pytest.raises(ValueError, match="short.safetensors"):
        sio.SafetensorsFile(str(path))
