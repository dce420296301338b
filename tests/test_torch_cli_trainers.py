"""`python -m vlrlhf_torch.cli.main sft|rm|ppo` on the CPU with --synthetic
(vlrlhf_tpu's tests/test_cli.py for the same commands): sft with a merged
save, rm from ln 2 with its head saved beside the adapters, ppo with
static and continuous rollouts (value adapters on), ppo scored by an rm
run's --reward_model_path, ppo checkpoint and resume, `merge` of an rm
run's adapters (the head left out), and a flag the port does not honour
refused."""

import json
import os

import numpy as np
import pytest
import torch

from vlrlhf_torch.cli.main import main
from vlrlhf_torch.train.checkpoint import load_params


def _common(out, n=6, steps=2):
    return ["--synthetic", str(n), "--device", "cpu", "--output_dir", str(out),
            "--per_device_train_batch_size", "2", "--max_steps", str(steps),
            "--logging_steps", "1", "--save_steps", "100", "--lora_r", "4",
            "--max_length", "64", "--max_prompt_length", "48", "--bf16", "false"]


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _finite(records):
    for r in records:
        for k, v in r.items():
            assert np.isfinite(v), (k, r)


def test_sft_and_rm(tmp_path):
    main(["sft", *_common(tmp_path / "sft"), "--logits_chunk", "16",
          "--merge_adapter_after_training"])
    recs = _records(tmp_path / "sft" / "sft_metrics.jsonl")
    assert [r["step"] for r in recs] == [1, 2] and "ppl" in recs[0]
    _finite(recs)
    assert os.path.exists(tmp_path / "sft" / "merged" / "params.pt")
    assert all("/" in k and not k.startswith("adapters/")
               for k in load_params(tmp_path / "sft" / "adapters"))

    main(["rm", *_common(tmp_path / "rm")])
    recs = _records(tmp_path / "rm" / "rm_metrics.jsonl")
    assert recs[0]["loss"] == pytest.approx(np.log(2.0), abs=1e-6)
    assert {"accuracy", "reward/chosen", "reward/rejected", "grad_norm"} <= set(recs[0])
    _finite(recs)
    tree = load_params(tmp_path / "rm" / "adapters")
    assert tree["rm_head/kernel"].shape == (32, 1)
    assert all(k.startswith("adapters/") for k in tree if k != "rm_head/kernel")


@pytest.mark.parametrize("continuous", [False, True])
def test_ppo_rollouts(tmp_path, continuous):
    extra = (["--rollout_chunk_size", "2", "--rollout_continuous_batching", "true",
              "--use_value_adapter", "true"] if continuous else ["--ppo_epochs", "2"])
    main(["ppo", *_common(tmp_path), "--max_new_tokens", "4", *extra])
    recs = _records(tmp_path / "ppo_metrics.jsonl")
    assert [r["step"] for r in recs] == [1, 2]
    assert all("ppo/rollout_tok_s" in r and "ppo/skipped" not in r for r in recs)
    _finite(recs)
    assert os.path.exists(tmp_path / "ppo_gamelog.jsonl")
    keys = set(load_params(tmp_path / "adapters"))
    assert "v_head/kernel" in keys
    assert any(k.startswith("value_adapters/") for k in keys) == continuous


def test_ppo_from_reward_model_and_merge_of_rm_adapters(tmp_path):
    from vlrlhf_torch.cli.main import synthetic_bundle

    main(["rm", *_common(tmp_path / "rm"), "--learning_rate", "1e-2"])
    rm_dir = tmp_path / "rm" / "adapters"
    main(["ppo", *_common(tmp_path / "ppo"), "--max_new_tokens", "4", "--ppo_epochs", "1",
          "--reward_model_path", str(rm_dir)])
    main(["ppo", *_common(tmp_path / "syn"), "--max_new_tokens", "4", "--ppo_epochs", "1"])
    got = _records(tmp_path / "ppo" / "ppo_metrics.jsonl")
    syn = _records(tmp_path / "syn" / "ppo_metrics.jsonl")
    _finite(got)
    assert got[0]["ppo/mean_score"] != syn[0]["ppo/mean_score"]  # the RM scored, not the length

    main(["merge", "--synthetic", "6", "--device", "cpu", "--bf16", "false",
          "--max_length", "64", "--output_dir", str(tmp_path / "m"),
          "--adapter_path", str(rm_dir), "--lora_r", "4", "--export_format", "torch"])
    merged = load_params(tmp_path / "m" / "merged")
    assert not any("rm_head" in k or "lora" in k for k in merged)
    rm = load_params(rm_dir)
    args = type("A", (), {"model_family": "llava", "bf16": False, "seed": 42,
                          "max_length": 64, "max_prompt_length": 512})()
    _, _, base, _ = synthetic_bundle(args, torch.device("cpu"))
    a, b = rm["adapters/lm/layers/0/attn/wq/a"], rm["adapters/lm/layers/0/attn/wq/b"]
    want = base.lm.layers[0].wq.weight + (16.0 / 4) * (a @ b).T
    torch.testing.assert_close(merged["lm.layers.0.wq.weight"], want, rtol=1e-6, atol=1e-6)


def test_ppo_checkpoint_resume_and_refused_flag(tmp_path):
    args = [*_common(tmp_path), "--max_new_tokens", "4", "--ppo_epochs", "1", "--save_steps", "1"]
    main(["ppo", *args])
    assert sorted(os.listdir(tmp_path / "checkpoints")) == ["1", "2"]
    args[args.index("--max_steps") + 1] = "3"
    main(["ppo", *args, "--resume_from_checkpoint", "auto"])
    assert [r["step"] for r in _records(tmp_path / "ppo_metrics.jsonl")] == [1, 2, 3]
    with pytest.raises(SystemExit, match="not ported yet: --eval_steps"):
        main(["ppo", *args, "--eval_steps", "2"])
