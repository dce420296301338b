"""LLaVA-Next and InstructBLIP checkpoints in vlrlhf_torch (utils/hf_port.py,
utils/hf_export.py, cli/loading.py), f32 on the CPU:
  - load_model_bundle on a tiny LlavaNextForConditionalGeneration (mistral
    text model, GQA) and a tiny InstructBlipForConditionalGeneration saved
    with save_pretrained: logits equal transformers' (anyres tiles and
    image_sizes; Q-Former instruction ids) at vlrlhf_tpu's tolerances
    (tests/test_anyres.py, tests/test_hf_port_families.py: 5e-4 / 5e-3;
    both packages compute GELU with the tanh approximation where HF's EVA
    tower and BERT Q-Former use erf), and every parameter equals
    vlrlhf_tpu's load_model_bundle bridged into the port, exactly;
  - the export equals vlrlhf_tpu's exporters key for key and bit for bit,
    and import(export(x)) is x;
  - quantizing while a checkpoint streams in (int4 LM; int8 LM, EVA tower
    with its split qkv, and projector) gives the codes of quantizing
    after;
  - the CLI round trip: `dpo --model_name_or_path` on a written checkpoint
    of each family (anyres JPEG rows for LLaVA-Next), then `merge`, whose
    merged_hf reloads as the merged weights;
  - an InstructBLIP checkpoint without qformer_tokenizer/ is refused
    (vlrlhf_tpu swallows the error and runs the Q-Former without the
    instruction)."""

import dataclasses
import json
import math
import os
import pathlib

import numpy as np
import pytest
import torch

from tests.test_torch_hf_import import hf_forms
from vlrlhf_torch.cli.loading import load_model_bundle

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
IMG = 32000
PINPOINTS = ((28, 56), (56, 28), (56, 56))
CPU = ["--device", "cpu", "--bf16", "false"]


def _hf_llava_next(seed=0):
    from transformers import LlavaNextConfig, LlavaNextForConditionalGeneration

    torch.manual_seed(seed)
    cfg = LlavaNextConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                           num_attention_heads=4, image_size=28, patch_size=14),
        text_config=dict(model_type="mistral", vocab_size=32064, hidden_size=48,
                         intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, rms_norm_eps=1e-5,
                         max_position_embeddings=256, rope_theta=1e6),
        image_token_index=IMG, vision_feature_layer=-2,
        vision_feature_select_strategy="default",
        image_grid_pinpoints=[list(p) for p in PINPOINTS])
    return LlavaNextForConditionalGeneration(cfg).eval().float()


def _hf_instructblip(seed=0):
    from transformers import InstructBlipConfig, InstructBlipForConditionalGeneration

    torch.manual_seed(seed)
    cfg = InstructBlipConfig(
        vision_config=dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=28, patch_size=14,
                           hidden_act="gelu", layer_norm_eps=1e-6, qkv_bias=True),
        qformer_config=dict(vocab_size=64, hidden_size=24, num_hidden_layers=2,
                            num_attention_heads=4, intermediate_size=48,
                            cross_attention_frequency=2, encoder_hidden_size=32,
                            max_position_embeddings=64),
        text_config=dict(architectures=["LlamaForCausalLM"], model_type="llama",
                         vocab_size=32064, hidden_size=48, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                         rms_norm_eps=1e-5, max_position_embeddings=128),
        num_query_tokens=8, image_token_index=IMG)
    return InstructBlipForConditionalGeneration(cfg).eval().float()


def _save(hf, path):
    from vlrlhf_torch.utils.synthetic_checkpoint import write_bert_tokenizer, write_tokenizer

    hf.save_pretrained(str(path))
    write_tokenizer(str(path))
    if "instructblip" in hf.config.model_type:
        write_bert_tokenizer(os.path.join(str(path), "qformer_tokenizer"), 63)
    return str(path)


@pytest.fixture(scope="module")
def next_ckpt(tmp_path_factory):
    hf = _hf_llava_next()
    return _save(hf, tmp_path_factory.mktemp("llava_next")), hf


@pytest.fixture(scope="module")
def blip_ckpt(tmp_path_factory):
    hf = _hf_instructblip()
    return _save(hf, tmp_path_factory.mktemp("instructblip")), hf


def _jax_bridged(path, cfg):
    """vlrlhf_tpu's import of `path` bridged into a port model of `cfg`
    (vlrlhf_tpu's config keeps the Q-Former's 512 positions whatever the
    checkpoint says; its params have the checkpoint's)."""
    import jax
    import jax.numpy as jnp

    from vlrlhf_tpu.cli.loading import load_model_bundle as jload
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    _, jcfg, jparams, _ = jload(path, jnp.float32)
    assert hf_forms(dataclasses.replace(vlm_config_from(jcfg), qformer=cfg.qformer), cfg) == cfg
    return load_vlm_params(VLM(cfg, device="cpu"), jax.device_get(jparams))


def _assert_same_params(model, other):
    got, exp = model.state_dict(), other.state_dict()
    assert got.keys() == exp.keys()
    for k in got:
        assert torch.equal(got[k], exp[k]), k


def test_llava_next_import_matches_transformers_and_jax(next_ckpt):
    from vlrlhf_torch.models.anyres import anyres_plan

    path, hf = next_ckpt
    family, cfg, model, proc = load_model_bundle(path, torch.float32, device="cpu")
    assert family.name == "llava_next_mistral" and cfg.grid_pinpoints == PINPOINTS
    assert cfg.lm.num_kv_heads == 2 and cfg.lm.rope_base == 1e6
    assert proc.cfg.image_token_id == IMG
    plan = anyres_plan((40, 30), PINPOINTS, tile_size=28, tile_grid=2)
    n_tok, s, start = plan["n_tokens"], plan["n_tokens"] + 8, 2
    g = torch.Generator().manual_seed(0)
    pixels = torch.randn(1, plan["n_tiles"], 3, 28, 28, generator=g)
    ids = torch.randint(0, 90, (1, s), generator=g)
    ids[:, start: start + n_tok] = IMG
    with torch.no_grad():
        want = hf(input_ids=ids, pixel_values=pixels,
                  image_sizes=torch.tensor([[40, 30]])).logits.numpy()
        h, _ = model(ids, pixels.permute(0, 1, 3, 4, 2),
                     torch.arange(start, start + n_tok, dtype=torch.int32)[None],
                     torch.ones(1, s, dtype=torch.bool),
                     anyres_gather=torch.from_numpy(plan["gather"])[None])
        got = model.head(h).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)
    _assert_same_params(model, _jax_bridged(path, cfg))


def test_instructblip_import_matches_transformers_and_jax(blip_ckpt):
    path, hf = blip_ckpt
    family, cfg, model, proc = load_model_bundle(path, torch.float32, device="cpu")
    assert family.name == "instructblip" and cfg.num_image_tokens == 8
    assert cfg.qformer.max_position_embeddings == 64 and cfg.projector.kind == "linear"
    assert proc.cfg.prefix_image_tokens and proc.qformer_tokenizer is not None
    q = proc.qformer_ids("<image>What is in the photo?")
    assert q[0] == 2 and q[-1] == 3  # [CLS] ... [SEP]
    g = torch.Generator().manual_seed(1)
    b, n_q = 2, 8
    ids = torch.randint(0, 90, (b, 18), generator=g)
    ids[:, 1: 1 + n_q] = IMG
    qids = torch.randint(0, 64, (b, 5), generator=g)
    pixels = torch.randn(b, 3, 28, 28, generator=g)
    with torch.no_grad():
        want = hf(input_ids=ids, pixel_values=pixels, qformer_input_ids=qids).logits.numpy()
        h, _ = model(ids, pixels.permute(0, 2, 3, 1)[:, None],
                     torch.arange(1, 1 + n_q, dtype=torch.int32)[None].expand(b, n_q),
                     torch.ones(ids.shape, dtype=torch.bool), qformer_input_ids=qids)
        got = model.head(h).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-3)
    _assert_same_params(model, _jax_bridged(path, cfg))


def test_missing_qformer_tokenizer_is_refused(blip_ckpt, tmp_path):
    import shutil

    path, _ = blip_ckpt
    bare = tmp_path / "bare"
    shutil.copytree(path, bare, ignore=shutil.ignore_patterns("qformer_tokenizer"))
    with pytest.raises(FileNotFoundError, match="qformer_tokenizer/tokenizer.json"):
        load_model_bundle(str(bare), torch.float32, device="cpu")


@pytest.mark.parametrize("which", ["llava_next", "instructblip"])
def test_export_matches_jax_and_round_trips(which, next_ckpt, blip_ckpt, tmp_path):
    import jax
    import jax.numpy as jnp

    from vlrlhf_tpu.cli.loading import load_model_bundle as jload
    from vlrlhf_tpu.utils.hf_export import EXPORTERS as JEXPORTERS
    from vlrlhf_torch.utils.hf_export import EXPORTERS, export_hf

    path = (next_ckpt if which == "llava_next" else blip_ckpt)[0]
    family, cfg, model, _ = load_model_bundle(path, torch.float32, device="cpu")
    got = EXPORTERS[family.name](model.state_dict(), cfg)
    _, jcfg, jparams, _ = jload(path, jnp.float32)
    want = JEXPORTERS[family.name](jax.device_get(jparams), jcfg)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    out = tmp_path / "out"
    export_hf(model.state_dict(), cfg, family.name, str(out), base_dir=path, dtype="float32")
    if family.name == "instructblip":
        assert os.path.exists(out / "qformer_tokenizer" / "tokenizer.json")
    _, cfg2, back, _ = load_model_bundle(str(out), torch.float32, device="cpu")
    assert cfg2 == cfg
    _assert_same_params(back, model)


def _tiny(family: str):
    """A tiny config of `family` with the 7B text vocabulary (so the seeded
    llama tokenizer fits) and 28-pixel tiles."""
    from vlrlhf_torch.models.config import FAMILIES, scale_down

    cfg = scale_down(FAMILIES[family].make_config())
    cfg = dataclasses.replace(
        cfg, lm=dataclasses.replace(cfg.lm, vocab_size=32064, max_position_embeddings=512),
        vision=dataclasses.replace(cfg.vision, image_size=28, patch_size=14),
        image_token_id=IMG)
    if cfg.grid_pinpoints:
        cfg = dataclasses.replace(cfg, grid_pinpoints=PINPOINTS)
    else:
        cfg = dataclasses.replace(cfg, num_image_tokens=cfg.qformer.num_query_tokens)
    return cfg


@pytest.mark.parametrize("family", ["llava_next_mistral", "instructblip"])
def test_cli_dpo_and_merge_from_checkpoint(family, tmp_path):
    from vlrlhf_torch.cli.main import main
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.checkpoint import load_params
    from vlrlhf_torch.utils.synthetic_checkpoint import write_checkpoint

    cfg = _tiny(family)
    ckpt = tmp_path / "ckpt"
    model = init_random_(VLM(cfg, device="cpu"), torch.Generator().manual_seed(2))
    write_checkpoint(str(ckpt), model.state_dict(), cfg, dtype="float32")
    f, cfg2, back, proc = load_model_bundle(str(ckpt), torch.float32, device="cpu")
    assert f.name == family and cfg2.grid_pinpoints == cfg.grid_pinpoints
    _assert_same_params(back, model)
    rows = [{"prompt": "What is shown in the image?", "image": "fx_wide.jpg",
             "chosen": "A dog is sitting on the table.", "rejected": "A red car."},
            {"prompt": "Describe the picture.", "image": "fx_portrait.jpg",
             "chosen": "two people", "rejected": "a cat"}]
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(rows))
    out = tmp_path / "out"
    main(["dpo", *CPU, "--model_name_or_path", str(ckpt), "--dataset_name", "plain_dpo",
          "--data_path", str(data), "--image_root", str(FIXTURES), "--output_dir", str(out),
          "--max_steps", "2", "--per_device_train_batch_size", "1", "--logging_steps", "1",
          "--max_length", "128", "--lora_r", "4", "--lora_alpha", "8", "--learning_rate",
          "1e-2", "--warmup_ratio", "0"])
    steps = [json.loads(x) for x in (out / "dpo_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in steps if "loss" in r]
    assert len(steps) == 2 and abs(steps[0]["loss"] - math.log(2)) < 1e-6
    assert math.isfinite(steps[1]["loss"])
    merged_dir = tmp_path / "m"
    main(["merge", *CPU, "--model_name_or_path", str(ckpt), "--adapter_path",
          str(out / "adapters"), "--output_dir", str(merged_dir), "--lora_r", "4",
          "--lora_alpha", "8"])
    merged = load_params(str(merged_dir / "merged"))
    _, _, again, _ = load_model_bundle(str(merged_dir / "merged_hf"), torch.float32,
                                       device="cpu")
    got = again.state_dict()
    assert got.keys() == merged.keys() and all(torch.equal(got[k], merged[k]) for k in got)
    assert not torch.equal(got["lm.layers.0.wq.weight"], model.state_dict()["lm.layers.0.wq.weight"])


@pytest.mark.parametrize("family,patterns,bits", [
    ("llava_next_mistral", "DEFAULT_QUANT_PATTERNS", 4),
    ("instructblip", "TRAIN_QUANT_PATTERNS_WIDE", 8),  # the EVA tower's split qkv too
])
def test_quantize_during_import_equals_quantize_after(family, patterns, bits, tmp_path):
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops import quant
    from vlrlhf_torch.utils.synthetic_checkpoint import write_checkpoint

    cfg = _tiny(family)
    model = init_random_(VLM(cfg, device="cpu"), torch.Generator().manual_seed(3))
    write_checkpoint(str(tmp_path), model.state_dict(), cfg)
    pats = getattr(quant, patterns)
    _, _, during, _ = load_model_bundle(str(tmp_path), torch.bfloat16, device="cpu",
                                        quantize_patterns=pats, quantize_bits=bits)
    _, _, after, _ = load_model_bundle(str(tmp_path), torch.bfloat16, device="cpu")
    done = quant.quantize_params(after, pats, bits=bits)
    assert len(done) > 0 and (family != "instructblip" or any("vision" in n for n in done))
    got, want = during.state_dict(), after.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
