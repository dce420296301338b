"""The port's entry points on a checkpoint and a dataset, f32 on the CPU,
with a tiny LLaVA checkpoint in HF layout (utils/synthetic_checkpoint.py:
weights by utils/hf_export.py, the seeded llama tokenizer; this file does
not import transformers, whose import alone takes 10-20 s here):
  - `dpo --model_name_or_path --dataset_name plain_dpo --data_path
    --image_root` on the committed JPEG fixtures (decoded by the native
    loader): step-1 loss ln 2, finite metrics, adapters, merged and
    merged_hf, which imports as the merged weights and loads in transformers;
  - `merge --adapter_path --export_format hf` writes what the dpo run's
    merge wrote, and the reloaded model's logits equal the merged
    in-memory model's (tests/test_torch_hf_import.py loads an export in
    transformers);
  - `serve`'s bundle and server from the checkpoint answer a JPEG request
    with the greedy tokens of the same model run in-process;
  - `eval --model_name_or_path --judge_model_path` on mmvet: responses and
    judged scores equal vlrlhf_tpu's EvalRunner and EngineJudge over the
    same checkpoint (vlrlhf_tpu's importer; the tokenizer is JsonTokenizer,
    which tests/test_torch_tokenizer.py holds equal to HFTokenizer);
  - the refusals: a hub dataset name, a non-llava checkpoint, no weights."""

import argparse
import json
import math
import os
import pathlib
import threading
import urllib.request

import pytest
import torch

from vlrlhf_torch.cli.main import main

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
ROWS = [
    {"prompt": "What is shown in the image?", "image": "fx_square.jpg",
     "chosen": "A dog is sitting on the table.", "rejected": "A red car in the street."},
    {"prompt": "Describe the picture in detail.", "image": "fx_landscape.jpg",
     "chosen": "two people standing in front of a white car",
     "rejected": "a cat"},
    {"prompt": "How many animals are there?", "chosen": "three", "rejected": "there are two"},
]
CPU = ["--device", "cpu", "--bf16", "false"]


IMG, N_IMG = 32000, 4


def tiny_cfg():
    """tests/test_hf_port.py's tiny LLaVA geometry with llava's vocab."""
    from vlrlhf_torch.models.config import LMConfig, ProjectorConfig, ViTConfig, VLMConfig

    return VLMConfig(
        lm=LMConfig(vocab_size=32064, hidden_size=48, intermediate_size=96, num_layers=2,
                    num_heads=4, num_kv_heads=4, max_position_embeddings=128, rms_eps=1e-5,
                    dtype=torch.float32),
        vision=ViTConfig(image_size=28, patch_size=14, hidden_size=32, num_layers=3,
                         num_heads=4, mlp_dim=64, feature_layer=-2, drop_class_token=True,
                         dtype=torch.float32),
        projector=ProjectorConfig(in_dim=32, out_dim=48), image_token_id=IMG,
        num_image_tokens=N_IMG)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.synthetic_checkpoint import write_llava_checkpoint

    path = tmp_path_factory.mktemp("ckpt")
    cfg = tiny_cfg()
    model = init_random_(VLM(cfg, device="cpu"), torch.Generator().manual_seed(2))
    write_llava_checkpoint(str(path), model.state_dict(), cfg, dtype="float32")
    return str(path)


def port_logits(model, seed=4, b=2, s=20):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 90, (b, s), generator=g)
    ids[:, 3: 3 + N_IMG] = IMG
    px = torch.randn(b, 1, 28, 28, 3, generator=g)
    pos = torch.arange(3, 3 + N_IMG, dtype=torch.int32)[None].expand(b, N_IMG)
    with torch.no_grad():
        h, _ = model(ids, px, pos, torch.ones(b, s, dtype=torch.bool))
        return model.head(h)


@pytest.fixture(scope="module")
def dpo_run(ckpt, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dpo")
    data = tmp / "pairs.json"
    data.write_text(json.dumps(ROWS))
    out = tmp / "out"
    main(["dpo", *CPU, "--model_name_or_path", ckpt, "--dataset_name", "plain_dpo",
          "--data_path", str(data), "--image_root", str(FIXTURES), "--output_dir", str(out),
          "--max_steps", "2", "--per_device_train_batch_size", "1", "--logging_steps", "1",
          "--max_length", "256", "--lora_r", "8", "--lora_alpha", "16", "--learning_rate",
          "1e-2", "--warmup_ratio", "0", "--merge_adapter_after_training"])
    return out


def test_dpo_from_checkpoint_and_dataset(dpo_run, ckpt):
    from vlrlhf_torch.cli.loading import load_model_bundle
    from vlrlhf_torch.train.checkpoint import load_params

    lines = [json.loads(x) for x in (dpo_run / "dpo_metrics.jsonl").read_text().splitlines()]
    steps = [r for r in lines if "loss" in r]
    assert len(steps) == 2 and abs(steps[0]["loss"] - math.log(2)) < 1e-6
    assert all(math.isfinite(v) for r in steps for v in r.values() if isinstance(v, float))
    merged = load_params(str(dpo_run / "merged"))
    assert {"config.json", "model.safetensors", "tokenizer.json"} <= set(
        os.listdir(dpo_run / "merged_hf"))
    _, _, back, _ = load_model_bundle(str(dpo_run / "merged_hf"), torch.float32, device="cpu")
    got = back.state_dict()
    assert got.keys() == merged.keys()
    assert all(torch.equal(got[k], merged[k]) for k in got)
    _, _, base, _ = load_model_bundle(ckpt, torch.float32, device="cpu")
    # the adapters trained: the merged LM weights moved off the checkpoint's
    assert not torch.equal(got["lm.layers.0.wq.weight"], base.state_dict()["lm.layers.0.wq.weight"])


def test_merge_writes_the_dpo_merge_and_reloads_with_equal_logits(dpo_run, ckpt, tmp_path):
    from vlrlhf_torch.cli.loading import load_model_bundle
    from vlrlhf_torch.lora.lora import merge_lora, set_adapters_
    from vlrlhf_torch.train.checkpoint import load_params

    out = tmp_path / "m"
    main(["merge", *CPU, "--model_name_or_path", ckpt, "--adapter_path",
          str(dpo_run / "adapters"), "--output_dir", str(out), "--lora_r", "8",
          "--lora_alpha", "16"])
    a, b = load_params(str(out / "merged")), load_params(str(dpo_run / "merged"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # the merged in-memory model against the exported directory, reloaded
    _, cfg, model, _ = load_model_bundle(ckpt, torch.float32, device="cpu")
    set_adapters_(model, load_params(str(dpo_run / "adapters")))
    merged = merge_lora(model, 16 / 8)
    set_adapters_(model, None)
    model.load_state_dict(merged)
    _, _, back, _ = load_model_bundle(str(out / "merged_hf"), torch.float32, device="cpu")
    assert torch.equal(port_logits(back), port_logits(model))


def test_serve_from_checkpoint(ckpt):
    from vlrlhf_torch.cli.main import build_server, load_bundle
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device

    args = argparse.Namespace(
        model_name_or_path=ckpt, synthetic=0, device="cpu", bf16=False, max_length=128,
        max_new_tokens=6, do_sample=False, temperature=1.0, top_k=None, top_p=None, slots=2,
        seed=0, host="127.0.0.1", port=0, quantize="false", kv_cache_dtype="bf16",
        speculative_k=0, chat_sessions=0, fuse_decode=False, adapter=None)
    family, cfg, model, proc = load_bundle(args, torch.device("cpu"))
    image = str(FIXTURES / "fx_portrait.jpg")
    question = "What is shown in the image?"
    ids = proc.process_conv(make_single_turn_conv(proc.format_multimodal_prompt(question, 1),
                                                  ""))["input_ids"]
    batch = GenerationCollator(proc, CollatorConfig(pad_token_id=proc.tokenizer.pad_token_id,
                                                    bucket_multiple=128, image_size=28))(
        [{"input_ids": ids, "img_path": image}])
    gen = Generator(model, GenerateConfig(max_new_tokens=6, eos_token_ids=(2,),
                                          pad_token_id=proc.tokenizer.pad_token_id))
    want = gen(batch_to_device(batch, "cpu"))[0].tolist()
    httpd, srv = build_server(cfg, model, proc, args)
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
    assert not thread.is_alive()
    pad = proc.tokenizer.pad_token_id
    want_ids = [t for t in want if t != pad]
    assert got["tokens"] == len(want_ids) > 0
    assert got["text"] == proc.tokenizer.decode(want_ids, skip_special_tokens=True).strip()


def test_eval_with_judge_matches_jax(ckpt, tmp_path):
    import jax.numpy as jnp

    from vlrlhf_tpu.cli.loading import config_from_hf as jconfig
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.eval.benchmarks import run_benchmark as jrun
    from vlrlhf_tpu.eval.harness import EvalRunner as JEvalRunner
    from vlrlhf_tpu.eval.judge import EngineJudge as JJudge
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.models.registry import make_processor as jmake
    from vlrlhf_tpu.utils import hf_port as jport

    data = tmp_path / "mmvet.json"
    data.write_text(json.dumps({f"v{i}": {"imagename": name, "question": q, "answer": a}
                                for i, (name, q, a) in enumerate([
                                    ("fx_square.jpg", "What is shown?", "a dog"),
                                    ("fx_wide.jpg", "What color is it?", "red"),
                                    ("fx_small.jpg", "How many?", "two")])}))
    main(["eval", *CPU, "--model_name_or_path", ckpt, "--judge_model_path", ckpt,
          "--benchmark", "mmvet", "--data_file", str(data), "--image_root", str(FIXTURES),
          "--output_dir", str(tmp_path / "t"), "--max_new_tokens", "4",
          "--max_length", "512"])
    got = json.loads((tmp_path / "t" / "mmvet.json").read_text())

    _, jcfg = jconfig(json.loads(pathlib.Path(ckpt, "config.json").read_text()), jnp.float32)
    params = jport.port_llava(jport.load_hf_state_dict(ckpt), jcfg)
    from vlrlhf_torch.data.tokenizer import JsonTokenizer

    tok = JsonTokenizer(ckpt)
    from vlrlhf_tpu.models.registry import FAMILIES as JF

    jproc = jmake(JF["llava"], tok, num_image_tokens=jcfg.num_image_tokens,
                  image_token_id=jcfg.image_token_id, max_length=512, max_prompt_length=512)
    pad = tok.pad_token_id
    runner = JEvalRunner(
        model_cfg=jcfg, params=params, processor=jproc,
        gen_cfg=JGenerateConfig(max_new_tokens=4, eos_token_ids=(tok.eos_token_id,),
                                pad_token_id=pad),
        collator_cfg=JCollatorConfig(pad_token_id=pad, bucket_multiple=128,
                                     image_size=jcfg.vision.image_size))
    # vlrlhf_tpu keeps only the judge's LM ({"lm": ...}, cli/main.py:1175), which
    # its static runner cannot run (KeyError 'vision'); judge rows carry no
    # image, so the whole model judges alike
    judge = JJudge(JEvalRunner(
        model_cfg=jcfg, params=params, processor=jproc,
        gen_cfg=JGenerateConfig(max_new_tokens=4, pad_token_id=pad),
        collator_cfg=JCollatorConfig(pad_token_id=pad, bucket_multiple=128,
                                     image_size=jcfg.vision.image_size)))
    jrun("mmvet", runner, str(data), str(FIXTURES), output_json=str(tmp_path / "j.json"),
         judge=judge)
    want = json.loads((tmp_path / "j.json").read_text())
    assert [r["response"] for r in got] == [r["response"] for r in want]
    assert [r.get("judge_score") for r in got] == [r.get("judge_score") for r in want]
    # the judges' own greedy verdicts on the grading prompts, token for token
    from vlrlhf_torch.cli.main import build_parser, load_judge
    from vlrlhf_torch.eval.judge import GRADER_TEMPLATE

    args = build_parser().parse_args(["eval", *CPU, "--judge_model_path", ckpt, "--benchmark",
                                      "mmvet", "--data_file", str(data), "--output_dir", "x"])
    prompts = [{"question": GRADER_TEMPLATE.format(r["question"], r["answer"], r["response"]),
                "img": None} for r in got]
    ours = load_judge(args, torch.device("cpu")).runner.run_vqa(prompts)
    theirs = judge.runner.run_vqa(prompts)
    assert [r["response"] for r in ours] == [r["response"] for r in theirs]
    assert any(r["response"] for r in ours)


def test_refusals(ckpt, tmp_path):
    with pytest.raises(SystemExit, match="local .json / .jsonl files only"):
        main(["dpo", *CPU, "--model_name_or_path", ckpt, "--dataset_name",
              "vlfeedback_paired", "--data_path", "MMInstruction/VLFeedback",
              "--output_dir", str(tmp_path / "d")])
    other = tmp_path / "gpt2"
    other.mkdir()
    (other / "config.json").write_text(json.dumps({"architectures": ["GPT2LMHeadModel"]}))
    with pytest.raises(ValueError, match="not a family vlrlhf_tpu supports"):
        main(["eval", *CPU, "--model_name_or_path", str(other), "--benchmark", "pope",
              "--data_file", "x.jsonl", "--output_dir", str(tmp_path / "e")])
    with pytest.raises(SystemExit, match="--model_name_or_path"):
        main(["serve", *CPU])
