"""The port's JPEG loader (vlrlhf_torch/data/native_image.py: the native
decode at the image's own size, then data/resample.py's PIL bicubic)
against vlrlhf_tpu's PIL loader (data/collators.py default_image_loader,
what the reference feeds CLIP) and PIL: bit-equal to it on the committed
fixtures and on generated images, one image at a time and through
load_batch, in both resize modes and at several sizes; the resize of the
same decoded pixels is PIL's bit for bit at 336 px, so the end-to-end
difference is the JPEG decoders' alone (0 on the fixtures where the two
decoders agree); within the PIL bounds vlrlhf_tpu's own test holds on its
own images (tests/test_native_image.py); no fallback: a PNG, a
missing file, a broken build (a missing or non-compiling source) and a
built library that does not load raise. The collators decode
through it by default, and the committed fx_336_shortest_edge_crop.npz is
what it decodes from the committed JPEGs (chip_smoke.py feeds those arrays
where a machine has no libjpeg).

The fixtures under tests/fixtures/ were written by `write_fixtures` below
(PIL, JPEG quality 90, from seeds), and the .npz by `load_image(path, 336)`."""

import os
import pathlib

import numpy as np
import pytest
from PIL import Image

from vlrlhf_torch.data import native_image as N

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
SIZES = {"fx_square.jpg": (336, 336), "fx_landscape.jpg": (480, 640),
         "fx_wide.jpg": (427, 640), "fx_portrait.jpg": (500, 300),
         "fx_small.jpg": (64, 96), "fx_tall.jpg": (120, 50)}
NPZ = "fx_336_shortest_edge_crop.npz"


def fixture_image(h: int, w: int, seed: int) -> np.ndarray:
    """A smooth colour field with three flat discs, (h, w, 3) uint8."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    c0, c1, c2 = rng.uniform(0, 255, (3, 1, 1, 3))
    img = c0 * (1 - y) * (1 - x) + c1 * y + c2 * x * (1 - y)
    for _ in range(3):
        cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.3) * min(h, w)
        img[((np.arange(h)[:, None] - cy) ** 2 + (np.arange(w)[None] - cx) ** 2) < r * r] = \
            rng.uniform(0, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_fixtures(directory) -> list[str]:
    paths = []
    for i, (name, (h, w)) in enumerate(SIZES.items()):
        p = os.path.join(directory, name)
        Image.fromarray(fixture_image(h, w, i)).save(p, quality=90)
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jpegs():
    return [str(FIXTURES / n) for n in SIZES]


def test_fixtures_are_the_seeded_images(tmp_path, jpegs):
    assert sum(os.path.getsize(p) for p in jpegs) < 200_000
    for p, q in zip(jpegs, write_fixtures(tmp_path)):
        a = np.asarray(Image.open(p).convert("RGB"), np.int32)
        assert np.abs(a - np.asarray(Image.open(q).convert("RGB"), np.int32)).max() <= 1, p


@pytest.mark.parametrize("mode", ["squash", "shortest_edge_crop"])
def test_bit_equal_to_jax_loader(tmp_path, jpegs, mode):
    """vlrlhf_tpu's PIL loader (its native/imageops.cpp bicubic differs
    from PIL's at sharp edges, by up to 75 at 48 px and 52 at 336 px on
    these fixtures, so the port holds to the PIL one)."""
    from vlrlhf_tpu.data.collators import default_image_loader as J

    rng = np.random.default_rng(1)
    noisy = str(tmp_path / "noisy.jpg")  # high-frequency content exercises the resize taps
    Image.fromarray(rng.integers(0, 256, (200, 150, 3), dtype=np.uint8)).save(noisy, quality=85)
    paths = jpegs + [noisy]
    for size in (32, 48, 336):
        want = np.zeros((len(paths) + 2, size, size, 3), np.uint8)
        for i, p in enumerate(paths):
            want[i] = J(p, size, mode)
            np.testing.assert_array_equal(N.load_image(p, size, mode), want[i],
                                          err_msg=f"{p} {size}")
        got = N.load_batch(paths + [None, ""], size, mode, n_threads=3)
        np.testing.assert_array_equal(got, want)
        assert not got[-2:].any()


@pytest.mark.parametrize("mode", ["squash", "shortest_edge_crop"])
def test_resize_of_decoded_pixels_is_pils_at_336(jpegs, mode):
    """The resize and crop of the native decode equal PIL's resize and crop
    of the same pixels bit for bit; end to end the loader is then off PIL
    by what the two JPEG decoders differ by, no more."""
    from vlrlhf_tpu.data.collators import default_image_loader as pil

    for p in jpegs:
        dec = N.decode_image(p)
        img = Image.fromarray(dec)
        if mode == "squash":
            want = img.resize((336, 336), Image.BICUBIC)
        else:
            w, h = img.size
            s = 336 / min(w, h)
            img = img.resize((round(w * s), round(h * s)), Image.BICUBIC)
            left, top = (img.size[0] - 336) // 2, (img.size[1] - 336) // 2
            want = img.crop((left, top, left + 336, top + 336))
        np.testing.assert_array_equal(N.resize_decoded(dec, 336, mode), np.asarray(want),
                                      err_msg=p)
        decoder_gap = np.abs(dec.astype(int) - np.asarray(Image.open(p).convert("RGB"))).max()
        e2e = np.abs(N.load_image(p, 336, mode).astype(int) - pil(p, 336, mode)).max()
        assert e2e <= decoder_gap, (p, e2e, decoder_gap)


@pytest.mark.parametrize("mode", ["squash", "shortest_edge_crop"])
def test_within_pil_bounds_on_smooth_images(tmp_path, mode):
    """vlrlhf_tpu's bound on vlrlhf_tpu's images (tests/test_native_image.py:
    smooth gradients at 48 px): the 99th percentile of |native - PIL| is at
    most 3 and the mean under 1 (the port's loader is PIL's resize, so
    within the decoders' difference)."""
    from vlrlhf_tpu.data.collators import default_image_loader as pil

    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(96, 64), (50, 120), (336, 336), (41, 37)]):
        c = rng.uniform(0, 1, (1, 1, 3))
        img = (np.linspace(0, 255, h)[:, None, None] * c
               + np.linspace(0, 255, w)[None, :, None] * (1 - c)).astype(np.uint8)
        p = str(tmp_path / f"img{i}.jpg")
        Image.fromarray(img).save(p, quality=95)
        diff = np.abs(N.load_image(p, 48, mode).astype(int) - pil(p, 48, mode).astype(int))
        assert np.percentile(diff, 99) <= 3 and diff.mean() < 1.0, (p, diff.max())


def test_committed_arrays_are_the_loader_output(jpegs):
    arrays = np.load(FIXTURES / NPZ)
    assert sorted(arrays.files) == sorted(SIZES)
    for p in jpegs:
        np.testing.assert_array_equal(arrays[os.path.basename(p)], N.load_image(p, 336))


def test_no_fallback(tmp_path, monkeypatch):
    png = tmp_path / "x.png"
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(png)
    with pytest.raises(ValueError, match="JPEG"):
        N.load_image(str(png), 16)
    with pytest.raises(ValueError, match="JPEG"):
        N.load_batch([str(png)], 16)
    renamed = tmp_path / "png_bytes.jpg"
    renamed.write_bytes(png.read_bytes())
    with pytest.raises(ValueError, match="could not decode"):
        N.load_image(str(renamed), 16)
    with pytest.raises(ValueError, match="could not decode 1 of the 1"):
        N.load_batch([str(renamed)], 16)
    with pytest.raises(RuntimeError, match="cannot read"):
        N._library(tmp_path / "missing.cpp")
    copy = tmp_path / "imageops.cpp"  # a built library that does not load (no libjpeg)
    copy.write_bytes(N.SOURCE.read_bytes())

    def no_libjpeg(*a, **k):
        raise OSError("libjpeg.so.62: cannot open shared object file")

    with monkeypatch.context() as m:
        m.setattr(N.ctypes, "CDLL", no_libjpeg)
        with pytest.raises(RuntimeError, match="cannot load .*libjpeg.so.62"):
            N._library(copy)
    bad = tmp_path / "broken.cpp"
    bad.write_text("int vlr_load_image( {\n")
    monkeypatch.setattr(N, "SOURCE", bad)
    with pytest.raises(RuntimeError, match=r"g\+\+ failed to build .*broken.cpp"):
        N.load_image(str(FIXTURES / "fx_small.jpg"), 16)
    assert not any(bad.name in str(p) for p in N.BUILD_DIR.glob("*.so"))


def test_collators_decode_with_it(jpegs):
    from vlrlhf_torch.data import collators as C
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES

    proc = VLProcessor(ToyTokenizer(), FAMILIES["llava"].template,
                       ProcessorConfig(num_image_tokens=4, image_token_id=3))
    cfg = C.CollatorConfig(bucket_multiple=16, image_size=32)
    rows = [{"prompt": f"q{i}", "chosen": "a", "rejected": "b", "img_path": p}
            for i, p in enumerate([jpegs[0], None, jpegs[1]])]
    batch = C.RMCollator(proc, cfg)([proc.tokenize_row_dpo(r) for r in rows])
    assert batch["pixel_values"].shape == (3, 1, 32, 32, 3)
    np.testing.assert_array_equal(batch["pixel_values"][0, 0], N.load_image(jpegs[0], 32))
    assert not batch["pixel_values"][1].any()
    gen = C.GenerationCollator(proc, cfg)([
        {"input_ids": proc.process_conv([{"from": "user", "value": "<image>q"},
                                         {"from": "assistant", "value": ""}])["input_ids"],
         "img_path": jpegs[2]}])
    np.testing.assert_array_equal(gen["pixel_values"][0, 0], N.load_image(jpegs[2], 32))
