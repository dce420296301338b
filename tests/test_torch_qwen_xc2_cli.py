"""Qwen-VL and InternLM-XC2 checkpoints through the port's import, export
and CLI, on the CPU, at tiny widths with the published vocabularies (so
the synthetic qwen.tiktoken and XC2 tokenizer.model fit the LM):
  - a checkpoint written by utils/synthetic_checkpoint.py (the published
    config.json layouts; XC2's tower table on a 3 x 3 grid, resized in the
    forward; XC2's PLoRA; XC2's config.json gives only the LM and the image
    size, the tower comes from the family entry, so both packages' entries
    hold the tiny tower here) imports (load_model_bundle) bit-equal to the
    model, and bit-equal to vlrlhf_tpu's config_from_hf + port_qwen_vl /
    port_internlm_xc2 + port_xc2_plora on the same state dict, bridged;
  - the exporters equal vlrlhf_tpu's export_qwen_vl / export_internlm_xc2 /
    export_xc2_plora key for key, bit for bit;
  - `dpo` from the checkpoint (plain_dpo rows with the JPEG fixtures),
    `merge` (merged_hf reloads bit-equal; XC2's PLoRA is kept apart, not
    folded), `serve` (one /generate over HTTP equals the static engine) and
    `eval` (pope) from it;
  - `sft`, `rm` and `ppo` with --synthetic and --model_family."""

import argparse
import dataclasses
import json
import math
import pathlib
import threading
import urllib.request

import numpy as np
import pytest
import torch

from tests.test_torch_hf_import import hf_forms
from vlrlhf_torch.cli.loading import load_model_bundle

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
CPU = ["--device", "cpu", "--bf16", "false"]
FAMILIES = ("qwen_vl", "internlm_xc2")


def tiny(family: str):
    """`family` scaled down, with its published vocabulary and 28-pixel
    images (a 2 x 2 patch grid); Qwen's resampler with the head count its
    config.json implies (output_dim // 128, at least 1)."""
    from vlrlhf_torch.models import config as C

    full = {"qwen_vl": C._qwen_vl_chat, "internlm_xc2": C._internlm_xc2_7b}[family]()
    cfg = C.scale_down(full)
    return dataclasses.replace(
        cfg, lm=dataclasses.replace(cfg.lm, vocab_size=full.lm.vocab_size,
                                    max_position_embeddings=512),
        vision=dataclasses.replace(cfg.vision, image_size=28, patch_size=14),
        projector=dataclasses.replace(cfg.projector, num_heads=1)
        if family == "qwen_vl" else cfg.projector,
        num_image_tokens=4, image_token_id=full.image_token_id)


@pytest.fixture(scope="module", autouse=True)
def tiny_xc2_entries():
    """XC2's family entry in both packages makes the tiny config (its
    config_from_hf takes the tower from the entry)."""
    from vlrlhf_tpu.models import registry
    from vlrlhf_torch.models import config

    def port_cfg(dtype=torch.float32):
        cfg = tiny("internlm_xc2")
        return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, dtype=dtype),
                                   vision=dataclasses.replace(cfg.vision, dtype=dtype))

    def jax_cfg(dtype=None):
        import jax.numpy as jnp

        cfg = registry.scale_down(registry._internlm_xc2_7b(), dtype or jnp.float32)
        return dataclasses.replace(cfg, vision=dataclasses.replace(
            cfg.vision, image_size=28, patch_size=14), num_image_tokens=4)

    with pytest.MonkeyPatch.context() as mp:
        for mod, fn in ((config, port_cfg), (registry, jax_cfg)):
            mp.setitem(mod.FAMILIES, "internlm_xc2", dataclasses.replace(
                mod.FAMILIES["internlm_xc2"], make_config=fn))
        yield


@pytest.fixture(scope="module", params=FAMILIES)
def ckpt(request, tmp_path_factory):
    """(family, cfg, model, checkpoint dir): seeded weights, XC2 with a
    3 x 3 (+ class) tower table and r = 4 PLoRA."""
    from vlrlhf_torch.lora.lora import init_plora_
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.synthetic_checkpoint import write_checkpoint

    family = request.param
    cfg = tiny(family)
    gen = torch.Generator().manual_seed(3)
    model = init_random_(VLM(cfg), gen)
    if cfg.plora:
        model.vision.set_pos_embed_(torch.randn((10, cfg.vision.hidden_size), generator=gen))
        init_plora_(model, 4, gen)
    path = tmp_path_factory.mktemp(family)
    write_checkpoint(str(path), model.state_dict(), cfg, dtype="float32")
    return family, cfg, model, str(path)


def _geometry(cfg):
    """`cfg` without its remat flags (training options, not geometry), its
    head width spelled out."""
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, remat=True,
                                                           head_dim=cfg.lm.head_dim_),
                               vision=dataclasses.replace(cfg.vision, remat=True))


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_import_matches_the_model_and_jax(ckpt):
    import jax.numpy as jnp
    from safetensors.numpy import load_file

    from vlrlhf_tpu.cli.loading import config_from_hf as jconfig
    from vlrlhf_tpu.utils.hf_port import PORTERS as JPORTERS
    from vlrlhf_tpu.utils.hf_port import port_xc2_plora
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    family, cfg, model, path = ckpt
    f, cfg2, back, proc = load_model_bundle(path, torch.float32, device="cpu")
    assert f.name == family
    assert _geometry(cfg2) == _geometry(hf_forms(dataclasses.replace(
        cfg, image_token_id=cfg2.image_token_id), cfg2))
    _same(back.state_dict(), model.state_dict())
    if family == "internlm_xc2":
        assert cfg2.image_token_id == proc.cfg.image_token_id == 92544  # <ImageHere>, added
        assert back.vision.pos_embed.shape[0] == 10
    else:
        assert proc.cfg.image_token == "<imgpad>" and proc.cfg.image_token_id == 151859
    hf = json.loads((pathlib.Path(path) / "config.json").read_text())
    _, jcfg = jconfig(hf, jnp.float32)
    if family == "internlm_xc2":
        jcfg = dataclasses.replace(jcfg, image_token_id=cfg2.image_token_id)
    assert _geometry(hf_forms(vlm_config_from(jcfg), cfg2)) == _geometry(cfg2)
    sd = load_file(str(pathlib.Path(path) / "model.safetensors"))
    params = JPORTERS[family](sd, jcfg)
    if family == "internlm_xc2":
        params["plora"] = port_xc2_plora(sd, jcfg)
    bridged = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(bridged, params)
    _same(bridged.state_dict(), back.state_dict())


def test_export_matches_jax(ckpt):
    from tests.test_torch_families import family_port
    from vlrlhf_tpu.utils.hf_export import EXPORTERS as JEXPORTERS
    from vlrlhf_tpu.utils.hf_export import export_xc2_plora
    from vlrlhf_torch.utils.hf_export import EXPORTERS

    family = ckpt[0]
    jcfg, params, model = family_port(family, seed=12)
    want = JEXPORTERS[family](params, jcfg)
    if family == "internlm_xc2":
        want.update(export_xc2_plora(params["plora"], jcfg))
        assert any("Plora_B" in k for k in want)
    got = EXPORTERS[family](model.state_dict(), model.cfg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k], np.float32), k)


def test_dpo_merge_serve_eval_from_checkpoint(ckpt, tmp_path):
    from vlrlhf_torch.cli.main import build_server, load_bundle, main
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device
    from vlrlhf_torch.train.checkpoint import load_params

    family, cfg, model, path = ckpt
    rows = [{"prompt": "What is shown in the image?", "image": "fx_wide.jpg",
             "chosen": "A dog is sitting on the table.", "rejected": "A red car."},
            {"prompt": "Describe the picture.", "image": "fx_portrait.jpg",
             "chosen": "two people", "rejected": "a cat"}]
    data = tmp_path / "pairs.json"
    data.write_text(json.dumps(rows))
    out = tmp_path / "out"
    main(["dpo", *CPU, "--model_name_or_path", path, "--dataset_name", "plain_dpo",
          "--data_path", str(data), "--image_root", str(FIXTURES), "--output_dir", str(out),
          "--max_steps", "2", "--per_device_train_batch_size", "1", "--logging_steps", "1",
          "--max_length", "512", "--lora_r", "4", "--lora_alpha", "8", "--learning_rate",
          "1e-2", "--warmup_ratio", "0"])
    steps = [json.loads(x) for x in (out / "dpo_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in steps if "loss" in r]
    assert len(steps) == 2 and abs(steps[0]["loss"] - math.log(2)) < 1e-6
    assert math.isfinite(steps[1]["loss"])
    adapters = load_params(str(out / "adapters"))
    assert family != "qwen_vl" or not any("/mlp/down/" in k for k in adapters)  # QWEN_TARGETS
    merged_dir = tmp_path / "m"
    main(["merge", *CPU, "--model_name_or_path", path, "--adapter_path", str(out / "adapters"),
          "--output_dir", str(merged_dir), "--lora_r", "4", "--lora_alpha", "8"])
    merged = load_params(str(merged_dir / "merged"))
    _, _, again, _ = load_model_bundle(str(merged_dir / "merged_hf"), torch.float32,
                                       device="cpu")
    _same(again.state_dict(), merged)
    base = model.state_dict()
    assert not torch.equal(merged["lm.layers.0.wq.weight"], base["lm.layers.0.wq.weight"])
    for k in (k for k in base if ".plora_" in k):  # PLoRA kept apart, unchanged
        assert torch.equal(merged[k], base[k]), k
    assert (family == "internlm_xc2") == any(".plora_" in k for k in merged)
    # serve: one /generate over HTTP equals the static engine
    sargs = argparse.Namespace(
        model_name_or_path=path, synthetic=0, device="cpu", bf16=False, max_length=768,
        max_new_tokens=5, do_sample=False, temperature=1.0, top_k=None, top_p=None, slots=2,
        seed=0, host="127.0.0.1", port=0, quantize="false", kv_cache_dtype="bf16",
        speculative_k=0, chat_sessions=0, fuse_decode=False, adapter=None)
    _, scfg, smodel, proc = load_bundle(sargs, torch.device("cpu"))
    image, question = str(FIXTURES / "fx_portrait.jpg"), "What is shown in the image?"
    batch = GenerationCollator(proc, CollatorConfig(pad_token_id=proc.tokenizer.pad_token_id,
                                                    bucket_multiple=128, image_size=28,
                                                    resize_mode="squash"))(
        [proc.generation_row(question, image)])
    from vlrlhf_torch.cli.main import stop_ids
    from vlrlhf_torch.models.config import FAMILIES as TF

    gen = Generator(smodel, GenerateConfig(max_new_tokens=5, pad_token_id=proc.tokenizer.pad_token_id,
                                           eos_token_ids=stop_ids(proc, TF[family], False)))
    want = [t for t in gen(batch_to_device(batch, "cpu"))[0].tolist()
            if t != proc.tokenizer.pad_token_id]
    httpd, srv = build_server(scfg, smodel, proc, sargs)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/generate",
            data=json.dumps({"question": question, "image": image}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
    assert got["tokens"] == len(want) > 0
    pope = tmp_path / "pope.jsonl"
    pope.write_text("".join(json.dumps({"text": f"Is there a {w} in the image?", "label": lab,
                                        "image": "fx_wide.jpg"}) + "\n"
                            for w, lab in (("dog", "yes"), ("car", "no"))))
    main(["eval", *CPU, "--model_name_or_path", path, "--benchmark", "pope", "--data_file",
          str(pope), "--image_root", str(FIXTURES), "--output_dir", str(tmp_path / "e"),
          "--max_new_tokens", "3", "--per_device_train_batch_size", "2"])
    assert (tmp_path / "e" / "pope.json").exists()


@pytest.mark.parametrize("cmd", ["sft", "rm", "ppo"])
def test_synthetic_trainers(cmd, tmp_path):
    from vlrlhf_torch.cli.main import main

    for family in FAMILIES:
        out = tmp_path / family
        extra = ["--max_new_tokens", "4"] if cmd == "ppo" else []
        main([cmd, *CPU, "--synthetic", "4", "--model_family", family, "--output_dir", str(out),
              "--per_device_train_batch_size", "2", "--max_steps", "1", "--logging_steps", "1",
              "--lora_r", "4", "--max_length", "64", *extra])
        lines = [json.loads(x) for x in (out / f"{cmd}_metrics.jsonl").read_text().splitlines()]
        assert lines and all(math.isfinite(v) for r in lines for v in r.values()
                             if isinstance(v, float))
