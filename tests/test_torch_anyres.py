"""LLaVA-Next anyres in vlrlhf_torch against vlrlhf_tpu (and PIL), f32 on
the CPU:
  - data/resample.py equals PIL's uint8 bicubic resize bit for bit, for up-
    and downscales, odd sizes and one-axis resizes;
  - the plan (best resolution, gather map, token count) and the tiles equal
    vlrlhf_tpu's models/anyres.py bit for bit; the device gather with
    PAD_IDX padding equals its gather_anyres_features;
  - the anyres DPO collator gives vlrlhf_tpu's batch array for array on
    PIL-written JPEGs (the port decodes with the native loader);
  - an anyres DPO step (frozen tower, and unfrozen with tiles tiled to both
    rows) equals dpo_step_fn: loss and metrics within 1e-5, LoRA gradients
    rtol 1e-5 (atol 1e-6 of the leaf's scale);
  - greedy anyres generation: the static Generator emits vlrlhf_tpu's
    tokens, and the continuous engine (requests of different tile counts
    padded in one prefill group) the static engine's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_families import PINPOINTS, TILE, TILE_GRID, anyres_inputs, family_port

GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("src,dst", [
    ((37, 53), (336, 336)), ((500, 333), (336, 336)), ((480, 640), (672, 504)),
    ((41, 29), (13, 7)), ((1000, 1500), (336, 336)), ((300, 300), (672, 672)),
    ((100, 101), (100, 55)), ((77, 77), (77, 300)),
])
def test_resample_matches_pil(src, dst):
    from PIL import Image

    from vlrlhf_torch.data.resample import resize_bicubic

    img = np.random.default_rng(src[0] * 7 + dst[1]).integers(0, 256, src + (3,), np.uint8)
    want = np.asarray(Image.fromarray(img).resize(dst, Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(img, dst), want)


@pytest.mark.parametrize("size", [(480, 640), (336, 1008), (672, 672), (500, 333),
                                  (1000, 200), (37, 53)])
def test_plan_and_tiles_match_jax(size):
    from vlrlhf_tpu.models import anyres as J
    from vlrlhf_torch.models import anyres as T

    want, got = J.anyres_plan(size), T.anyres_plan(size)
    assert got["best_resolution"] == want["best_resolution"]
    assert (got["n_tiles"], got["n_tokens"], got["tiles_hw"]) == (
        want["n_tiles"], want["n_tokens"], want["tiles_hw"])
    np.testing.assert_array_equal(got["gather"], want["gather"])
    img = np.random.default_rng(size[0]).integers(0, 256, size + (3,), np.uint8)
    np.testing.assert_array_equal(T.tiles_from_image(img, got), J.tiles_from_image(img, want))
    assert T.anyres_max_dims() == J.anyres_max_dims()


def test_gather_matches_jax():
    from vlrlhf_tpu.models.anyres import gather_anyres_features as jgather
    from vlrlhf_torch.models.anyres import gather_anyres_features

    rng = np.random.default_rng(0)
    _, gather, _, _ = anyres_inputs(rng)
    feats = rng.standard_normal((2, 5 * TILE_GRID * TILE_GRID, 8)).astype(np.float32)
    nl = rng.standard_normal(8).astype(np.float32)
    want = jax.vmap(lambda f, g: jgather(f, g, jnp.asarray(nl)))(jnp.asarray(feats),
                                                                  jnp.asarray(gather))
    got = gather_anyres_features(torch.from_numpy(feats), torch.from_numpy(gather),
                                 torch.from_numpy(nl))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _images(tmp_path, sizes=((24, 18), (20, 30))):
    from PIL import Image

    paths = []
    for i, (h, w) in enumerate(sizes):
        p = str(tmp_path / f"i{i}.jpg")
        Image.fromarray(np.random.default_rng(i).integers(0, 255, (h, w, 3), np.uint8)).save(p)
        paths.append(p)
    return paths


def _processors():
    from vlrlhf_tpu.data.chat_templates import TEMPLATES as JT
    from vlrlhf_tpu.data.processor import ProcessorConfig as JPC
    from vlrlhf_tpu.data.processor import VLProcessor as JP
    from vlrlhf_tpu.data.tokenizer import ToyTokenizer as JTok
    from vlrlhf_torch.data.chat_templates import TEMPLATES
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer

    kw = dict(num_image_tokens=16, image_token="<image>", image_token_id=3, max_length=64,
              max_prompt_length=48)
    return (JP(JTok(vocab_size=250), JT["llava_next_vicuna"], JPC(**kw)),
            VLProcessor(ToyTokenizer(vocab_size=250), TEMPLATES["llava_next_vicuna"],
                        ProcessorConfig(**kw)))


def _collators(kind, tmp_path):
    from vlrlhf_tpu.data import collators as JC
    from vlrlhf_torch.data import collators as TC

    jp, tp = _processors()
    kw = dict(pad_token_id=0, bucket_multiple=32, image_size=TILE, anyres=True,
              tile_grid=TILE_GRID, grid_pinpoints=PINPOINTS)
    return (jp, getattr(JC, kind)(jp, JC.CollatorConfig(**kw)),
            tp, getattr(TC, kind)(tp, TC.CollatorConfig(**kw)))


def _dpo_rows(proc, paths):
    return [proc.tokenize_row_dpo({"prompt": f"q {i} what", "chosen": "yes this one",
                                   "rejected": "no that", "img_path": p})
            for i, p in enumerate(paths)]


def test_dpo_collator_matches_jax(tmp_path):
    paths = _images(tmp_path)
    jp, jcoll, tp, tcoll = _collators("DPOCollator", tmp_path)
    want = jcoll(_dpo_rows(jp, paths))
    got = tcoll(_dpo_rows(tp, paths))
    assert set(got) == set(want) and "anyres_gather" in got
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert got["pixel_values"].shape[:2] == (2, 5)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("frozen", [True, False])
def test_anyres_dpo_step_matches_jax(frozen, tmp_path):
    from tests.test_torch_dpo import _assert_trees, _capture_grads, _jax_step, _torch_steps
    from vlrlhf_torch.train import dpo as tdpo
    from vlrlhf_torch.train.train_state import OptimizerConfig
    from vlrlhf_torch.utils.bridge import lora_tree

    jcfg, params, model, lcfg, adapters = family_port("llava_next_vicuna", lora=True)
    jp, jcoll, _, _ = _collators("DPOCollator", tmp_path)
    batch = jcoll(_dpo_rows(jp, _images(tmp_path)))
    kw = dict(beta=0.1, lora_scale=lcfg.scale, frozen_vision=frozen)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), _jax_batch(batch))
    _, tm = _torch_steps(model, kw, OptimizerConfig(learning_rate=5e-3, warmup_steps=1,
                                                    total_steps=50),
                         tdpo.batch_to_device(batch, "cpu"))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=1e-5, rtol=1e-5, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, "grad")


def _gen_batch(tmp_path):
    """vlrlhf_tpu's anyres generation batch of three images, and the port's
    processor and generation collator."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator

    jp, tp = _processors()
    _, jcoll, _, _ = _collators("GenerationCollator", tmp_path)
    paths = _images(tmp_path, ((40, 12), (12, 40), (30, 30)))  # 3, 3 and 5 tiles
    rows = [{"input_ids": jp.maybe_prefix_image_ids(jp.process_conv(
        [{"from": "user", "value": jp.format_multimodal_prompt(f"describe {i}", 1)},
         {"from": "assistant", "value": ""}])["input_ids"], 1), "img_path": p}
        for i, p in enumerate(paths)]
    tcoll = GenerationCollator(tp, CollatorConfig(
        pad_token_id=0, bucket_multiple=32, image_size=TILE, anyres=True,
        tile_grid=TILE_GRID, grid_pinpoints=PINPOINTS))
    for i, p in enumerate(paths):  # the port's rows are vlrlhf_tpu's
        assert tp.generation_row(f"describe {i}", p) == rows[i]
    return jcoll(rows), rows, tcoll


def test_anyres_greedy_generation_static_and_continuous(tmp_path):
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGC
    from vlrlhf_tpu.generate.engine import Generator as JGen
    from vlrlhf_torch.generate.continuous import ContinuousEngine, request_from_batch
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator

    jcfg, params, model = family_port("llava_next_mistral", seed=3)
    batch, rows, tcoll = _gen_batch(tmp_path)
    assert len(set(batch["prompt_lens"].tolist())) == 3  # three plans, three lengths
    want = np.asarray(JGen(jcfg, JGC(max_new_tokens=8, pad_token_id=-1))(params, batch))
    got = Generator(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1))(batch).numpy()
    np.testing.assert_array_equal(got, want)
    # one request per row, as the server builds them: each its own tiles
    reqs = [request_from_batch(tcoll([r]), 0, True) for r in rows]
    assert len({r.pixel_values.shape[0] for r in reqs}) > 1  # tile counts differ
    eng = ContinuousEngine(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1),
                           n_slots=3, cache_len=256, prefill_chunk=256)
    eng.MAX_PREFILL_GROUP = 3  # one prefill group pads all three plans
    outs = eng.run(reqs)
    assert eng.last_admits == 1
    for o, w in zip(outs, want):
        assert o == [int(t) for t in w if t != -1]


def test_text_only_batches_never_reach_the_image_loader(monkeypatch):
    """A batch without images (an LLM judge's prompts, text-only rows) is
    collated without the native loader, which does not build where there
    is no libjpeg."""
    from vlrlhf_torch.data import native_image
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator

    def refuse(*a, **k):
        raise RuntimeError("the native loader must not be reached")

    monkeypatch.setattr(native_image, "_library", refuse)
    _, tp = _processors()
    batch = GenerationCollator(tp, CollatorConfig(image_size=TILE))(
        [tp.generation_row("grade this answer", None), tp.generation_row("and this", None)])
    assert not batch["pixel_values"].any() and (batch["image_positions"] == -1).all()
