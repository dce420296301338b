"""The multi-GPU entry points on the CPU: `torchrun --standalone
--nproc_per_node 2 -m vlrlhf_torch.cli.main ... --device cpu` (gloo) against
the same command in one plain process, f32:
  - `dpo --synthetic 10 --mesh_fsdp -1` with one row per rank and the
    eval hook (--eval_steps 2 --eval_samples 2): every dpo_metrics.jsonl
    value but perf/* (eval/* too) of the single-process run with two rows
    per batch within 1e-5, the same greedy samples (rank 0 writes them,
    generated from the gathered weights), and the rank-0 checkpoint a
    plain run resumes from; LoRA dropout is off, since a mask is drawn
    over a rank's own rows (tests/test_torch_dist_train.py holds the
    tensor-parallel masks to the single-process ones);
  - `dpo` from a tiny HF checkpoint and a plain_dpo dataset with
    --merge_adapter_after_training: adapters/, merged/ and merged_hf/
    equal the single-process run's within 1e-5;
  - `eval --synthetic 4` on pope (generation) and seedbench (CE ranking):
    each rank runs its shard of the rows, and the gathered rows and
    scores equal the single-process run's;
  - `ppo --synthetic 8` under fsdp = 2 (one row per rank) and model = 2
    (also with value adapters under full remat) with greedy rollouts
    (tests/torch_dist_worker.py greedy_rollouts), score scaling, 2
    epochs of 2-row minibatches: every ppo_metrics.jsonl value but perf/*
    and the rollout rate within 1e-5 of the single-process run with two
    rows per step, and its rank-0 checkpoint resumed in a plain process
    (the KL coefficient with it) takes the step a plain resume takes;
  - `dpo --eval_samples 2` under --mesh_model 2: the greedy samples, on
    each rank's heads with its group's tokens broadcast, and the metrics
    equal the single-process run's;
  - `dpo --eval_samples 2` and `ppo` under the sequence split over the
    tensor-parallel pair (--mesh_model 2 --sequence_parallel_axis model)
    and over the fsdp pair (--sequence_parallel_axis fsdp), 2 rows a step:
    the metrics of the single-process runs within 1e-5 and the same
    greedy samples (generated unsplit);
  - the refusals, each naming its reason: --mesh_pipe 2 without torchrun,
    --pipeline_microbatches without --mesh_pipe > 1 (ppo's and
    --eval_samples' too: both run under torchrun), the pipeline with the
    sequence split (fsdp or model) and on eval, rows, layers, a ppo
    minibatch share or a stats slice the pipeline does not divide,
    --sequence_parallel_axis fsdp or model without torchrun, over data (on
    dpo and on ppo) and over an unknown axis, on eval, mesh flags on eval,
    a mesh a plain run cannot make, heads or int4 row widths --mesh_model
    does not divide, and --report_to wandb (recipes/dpo_qwenvl.sh's) or an
    unknown sink. dpo, sft and rm steps under the ring:
    tests/test_torch_dist_sp.py; under the model split and ppo under either:
    tests/test_torch_dist_sp_model.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_cli_import import FIXTURES, ROWS, tiny_cfg
from tests.test_torch_score import _pope_and_seed
from tests.torch_dist_worker import greedy_rollouts
from vlrlhf_torch.cli.main import main

TOL = 1e-5
CPU = ["--device", "cpu", "--bf16", "false"]
DPO = ["--max_steps", "3", "--logging_steps", "1", "--lora_r", "4", "--max_length", "64",
       "--learning_rate", "1e-3", "--warmup_ratio", "0", "--lora_dropout", "0"]
# the eval hook: the holdout's loss pass under the mesh and greedy samples
# from the gathered weights (10 synthetic rows: 2 held out, 8 train)
EVAL = ["--eval_steps", "2", "--eval_ratio", "0.2", "--eval_samples", "2"]
PPO = ["ppo", *CPU, "--synthetic", "8", "--max_steps", "2", "--logging_steps", "1", "--lora_r",
       "4", "--max_length", "64", "--max_new_tokens", "4", "--lora_dropout", "0", "--ppo_epochs",
       "2", "--minibatch_size", "2", "--use_score_scaling", "true", "--save_steps", "1"]
# value adapters: a second LoRA set, replicated over the data-parallel ranks,
# its trunk pass recomputed in the backward
VALUE = ["--use_value_adapter", "true", "--remat_policy", "full"]
# the sequence split over each axis a pair of ranks can hold
SPLIT = {"model": ["--mesh_model", "2", "--mesh_fsdp", "1", "--sequence_parallel_axis", "model"],
         "fsdp": ["--mesh_fsdp", "2", "--sequence_parallel_axis", "fsdp"]}


def torchrun(args: list, nproc: int = 2) -> subprocess.Popen:
    """The CLI on `nproc` ranks; a ppo command with greedy rollouts."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    entry = (["tests.torch_dist_worker", "--greedy-ppo"] if args[0] == "ppo"
             else ["vlrlhf_torch.cli.main"])
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
         str(nproc), "-m", *entry, *args],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish(proc: subprocess.Popen) -> tuple[int, str]:
    out, _ = proc.communicate(timeout=300)
    return proc.returncode, out


def metrics(path) -> list[dict]:
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every torchrun command started at once; the single-process runs go
    meanwhile."""
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.synthetic_checkpoint import write_llava_checkpoint

    tmp = tmp_path_factory.mktemp("dist_cli")
    ckpt = tmp / "ckpt"
    cfg = tiny_cfg()
    write_llava_checkpoint(str(ckpt), init_random_(VLM(cfg, device="cpu"),
                                                   torch.Generator().manual_seed(2)).state_dict(),
                           cfg, dtype="float32")
    data = tmp / "pairs.json"
    data.write_text(json.dumps(ROWS + ROWS[:1]))  # 4 rows: 2 global batches of 2
    hf = ["--model_name_or_path", str(ckpt), "--dataset_name", "plain_dpo", "--data_path",
          str(data), "--image_root", str(FIXTURES), "--max_steps", "2", "--max_length", "256",
          "--lora_r", "8", "--lora_alpha", "16", "--learning_rate", "1e-2", "--warmup_ratio",
          "0", "--lora_dropout", "0", "--merge_adapter_after_training"]
    bench = _pope_and_seed(tmp)
    ev = {b: ["eval", *CPU, "--synthetic", "4", "--benchmark", b, "--data_file", str(bench[b]),
              "--max_new_tokens", "4", "--max_length", "128", "--per_device_train_batch_size",
              "2"] for b in bench}
    procs = {
        "dpo": torchrun(["dpo", *CPU, "--synthetic", "10", *DPO, *EVAL, "--save_steps", "2",
                         "--output_dir", str(tmp / "dpo2"), "--per_device_train_batch_size",
                         "1", "--mesh_fsdp", "-1"]),
        "hf": torchrun(["dpo", *CPU, *hf, "--output_dir", str(tmp / "hf2"),
                        "--per_device_train_batch_size", "1"]),
        "gqa": torchrun(["dpo", *CPU, "--synthetic", "4", "--model_family",
                         "llava_next_mistral", "--mesh_model", "2", "--output_dir",
                         str(tmp / "gqa")]),
        "dpo_model2": torchrun(["dpo", *CPU, "--synthetic", "10", *DPO, *EVAL, "--output_dir",
                                str(tmp / "dpo_model2"), "--per_device_train_batch_size", "2",
                                "--mesh_model", "2", "--mesh_fsdp", "1"]),
        "ppo_fsdp2": torchrun([*PPO, "--output_dir", str(tmp / "ppo_fsdp2"),
                               "--per_device_train_batch_size", "1", "--mesh_fsdp", "-1"]),
        "ppo_model2": torchrun([*PPO, "--output_dir", str(tmp / "ppo_model2"),
                                "--per_device_train_batch_size", "2", "--mesh_model", "2",
                                "--mesh_fsdp", "1"]),
        "ppo_value_model2": torchrun([*PPO, *VALUE, "--output_dir", str(tmp / "ppo_value_model2"),
                                      "--per_device_train_batch_size", "2", "--mesh_model", "2",
                                      "--mesh_fsdp", "1"]),
        # the sequence split: over the tensor-parallel pair, and over the
        # fsdp pair (a ring), 2 rows per step as the plain runs
        **{f"dpo_sp_{axis}": torchrun(["dpo", *CPU, "--synthetic", "10", *DPO, *EVAL,
                                       "--output_dir", str(tmp / f"dpo_sp_{axis}"),
                                       "--per_device_train_batch_size", "2", *SPLIT[axis]])
           for axis in SPLIT},
        **{f"ppo_sp_{axis}": torchrun([*PPO, "--output_dir", str(tmp / f"ppo_sp_{axis}"),
                                       "--per_device_train_batch_size", "2", *SPLIT[axis]])
           for axis in SPLIT},
        **{f"eval/{b}": torchrun([*ev[b], "--output_dir", str(tmp / f"{b}2")]) for b in bench},
    }
    main(["dpo", *CPU, "--synthetic", "10", *DPO, *EVAL, "--save_steps", "2", "--output_dir",
          str(tmp / "dpo1"), "--per_device_train_batch_size", "2"])
    main(["dpo", *CPU, *hf, "--output_dir", str(tmp / "hf1"), "--per_device_train_batch_size",
          "2"])
    for b in bench:
        main([*ev[b], "--output_dir", str(tmp / f"{b}1")])
    with greedy_rollouts():
        main([*PPO, "--output_dir", str(tmp / "ppo1"), "--per_device_train_batch_size", "2"])
        main([*PPO, *VALUE, "--output_dir", str(tmp / "ppo_value1"),
              "--per_device_train_batch_size", "2"])
    done = {k: finish(p) for k, p in procs.items()}
    return tmp, done


def _ok(done, key):
    rc, out = done[key]
    assert rc == 0, out[-3000:]
    return out


def test_dpo_on_two_ranks_logs_the_single_process_metrics(runs):
    tmp, done = runs
    _ok(done, "dpo")
    one, two = (metrics(tmp / d / "dpo_metrics.jsonl") for d in ("dpo1", "dpo2"))
    assert [r["step"] for r in two] == [1, 2, 2, 3] and len(one) == len(two)
    assert abs(two[0]["loss"] - np.log(2)) < 1e-6
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k in a.keys() - {"step"} - {k for k in a if k.startswith("perf/")}:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{a['step']} {k}")
    assert "eval/loss" in two[2]
    # rank 0 wrote the samples: the policy's and the reference's greedy tokens
    samples = [(tmp / d / "dpo_samples.jsonl").read_text().splitlines() for d in ("dpo1", "dpo2")]
    assert len(samples[1]) == 2 and samples[0] == samples[1]


def test_two_rank_checkpoint_resumes_in_a_plain_run(runs, tmp_path):
    """The rank-0 checkpoint at step 2 resumes in one process and its
    next step is the one a plain run resumed from its own step 2 takes."""
    tmp, done = runs
    _ok(done, "dpo")
    outs = {}
    for name in ("dpo2", "dpo1"):
        out = tmp_path / name
        src = tmp / name / "checkpoints"
        main(["dpo", *CPU, "--synthetic", "10", *DPO, *EVAL, "--output_dir", str(out),
              "--per_device_train_batch_size", "2", "--resume_from_checkpoint", str(src)])
        outs[name] = [r for r in metrics(out / "dpo_metrics.jsonl") if "loss" in r][-1]
    assert outs["dpo2"]["step"] == outs["dpo1"]["step"] == 3
    np.testing.assert_allclose(outs["dpo2"]["loss"], outs["dpo1"]["loss"], atol=TOL, rtol=TOL)


def test_checkpoint_run_writes_the_single_process_files(runs):
    from safetensors.numpy import load_file

    from vlrlhf_torch.train.checkpoint import load_params

    tmp, done = runs
    _ok(done, "hf")
    for sub in ("adapters", "merged"):
        a, b = load_params(str(tmp / "hf1" / sub)), load_params(str(tmp / "hf2" / sub))
        assert a.keys() == b.keys() and len(a) > 10
        for k in a:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(), atol=TOL, rtol=TOL,
                                       err_msg=f"{sub} {k}")
    a = load_file(str(tmp / "hf1" / "merged_hf" / "model.safetensors"))
    b = load_file(str(tmp / "hf2" / "merged_hf" / "model.safetensors"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=k)
    assert sorted(os.listdir(tmp / "hf1" / "merged_hf")) == sorted(
        os.listdir(tmp / "hf2" / "merged_hf"))


@pytest.mark.parametrize("bench", ["pope", "seedbench"])
def test_eval_on_two_ranks_gathers_the_single_process_rows(runs, bench):
    tmp, done = runs
    out = _ok(done, f"eval/{bench}")
    one = json.loads((tmp / f"{bench}1" / f"{bench}.json").read_text())
    two = json.loads((tmp / f"{bench}2" / f"{bench}.json").read_text())
    assert len(two) == len(one) == (3 if bench == "pope" else 8)
    key = "ppl" if bench == "seedbench" else "response"
    for a, b in zip(one, two):
        assert {k: v for k, v in a.items() if k != key} == {k: v for k, v in b.items() if k != key}
        if key == "ppl":
            np.testing.assert_allclose(b[key], a[key], rtol=TOL, atol=TOL)
        else:
            assert b[key] == a[key]
    assert out.count("{") >= 2  # both ranks print the metrics


def test_refuses_kv_heads_that_mesh_model_does_not_divide(runs):
    rc, out = runs[1]["gqa"]
    assert rc != 0 and "--mesh_model 2: num_kv_heads 1 is not divisible" in out, out[-2000:]


@pytest.mark.parametrize("flags,match", [
    # the pipeline runs under torchrun (tests/test_torch_dist_pipe.py, its
    # --eval_samples too); refused before anything loads: without torchrun,
    # a microbatch count without a pipeline, with the sequence split, rows or
    # layers it does not divide
    (["--mesh_pipe", "2"], "--mesh_pipe 2: the pipeline's stages are the ranks of a mesh "
                           "launched by torchrun"),
    (["--pipeline_microbatches", "4"],
     "--pipeline_microbatches 4: it splits the rows of a pipeline, which needs --mesh_pipe > 1"),
    (["--mesh_pipe", "2", "--sequence_parallel_axis", "fsdp"],
     "--mesh_pipe 2 with --sequence_parallel_axis fsdp: the pipeline and the sequence split "
     "are mutually exclusive"),
    (["--mesh_pipe", "2", "--eval_steps", "1", "--eval_samples", "2"],
     "--mesh_pipe 2: the pipeline's stages are the ranks of a mesh launched by torchrun"),
    (["--mesh_pipe", "2", "--pipeline_microbatches", "3", "--per_device_train_batch_size", "1"],
     "--mesh_pipe 2: 1 pairs = 2 rows per data-parallel rank .* do not split into 3 pipeline "
     "microbatches"),
    (["--mesh_pipe", "4", "--per_device_train_batch_size", "2"],
     "--mesh_pipe 4: the LM's 2 layers do not split into 4 equal stages"),
    (["--sequence_parallel_axis", "fsdp"], "--sequence_parallel_axis fsdp: .*launched by torchrun"),
    (["--mesh_model", "2"], "--mesh_model 2: .*launched by torchrun"),
    (["--sequence_parallel_axis", "data"],
     "--sequence_parallel_axis data: the data axis shards the batch's rows"),
    (["--sequence_parallel_axis", "model", "--mesh_model", "2"],
     "--sequence_parallel_axis model: .*launched by torchrun .*--mesh_model N"),
    (["--sequence_parallel_axis", "seq"], "--sequence_parallel_axis 'seq': not a mesh axis"),
    (["--mesh_pipe", "2", "--sequence_parallel_axis", "model"],
     "--mesh_pipe 2 with --sequence_parallel_axis model: the pipeline and the sequence split "
     "are mutually exclusive"),
    # recipes/dpo_qwenvl.sh's sinks: the port writes jsonl and refuses wandb by name
    (["--report_to", "jsonl,wandb", "--run_name", "dpo_qwenvl"], "--report_to wandb: "),
    (["--report_to", "tensorboard"], "--report_to 'tensorboard': unknown sink"),
])
def test_dpo_refusals(tmp_path, flags, match):
    with pytest.raises(SystemExit, match=match):
        main(["dpo", *CPU, "--synthetic", "4", "--output_dir", str(tmp_path), *flags])


@pytest.mark.parametrize("argv,match", [
    # ppo runs under either split (the torchruns below); an axis that holds
    # the rows is refused
    (["ppo", *CPU, "--synthetic", "4", "--sequence_parallel_axis", "data"],
     "--sequence_parallel_axis data: the data axis shards the batch's rows"),
    (["eval", *CPU, "--synthetic", "4", "--benchmark", "pope", "--data_file", "x",
      "--sequence_parallel_axis", "fsdp"],
     "eval refuses --sequence_parallel_axis fsdp"),
])
def test_ppo_and_eval_refuse_the_sequence_split(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        main([*argv, "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("argv,match", [
    (["ppo", *CPU, "--synthetic", "4", "--mesh_pipe", "2"],
     "--mesh_pipe 2: the pipeline's stages are the ranks of a mesh launched by torchrun"),
    (["ppo", *CPU, "--synthetic", "4", "--mesh_pipe", "2", "--mesh_fsdp", "1",
      "--minibatch_size", "3"],
     "--mesh_pipe 2: a PPO minibatch of 3 rows gives each of the 1 data-parallel ranks 3 "
     "rows, which do not split into 2 pipeline microbatches"),
    (["ppo", *CPU, "--synthetic", "4", "--mesh_pipe", "2", "--mesh_fsdp", "1",
      "--minibatch_size", "4", "--per_device_train_batch_size", "5"],
     "--mesh_pipe 2: the stats pass's last slice of a rank's 5 rollouts holds 1 rows, fewer "
     "than the 2 pipeline microbatches"),
    (["sft", *CPU, "--synthetic", "4", "--mesh_pipe", "2", "--pipeline_microbatches", "4",
      "--per_device_train_batch_size", "2"],
     "--mesh_pipe 2: 2 rows per data-parallel rank .* do not split into 4 pipeline"),
    (["eval", *CPU, "--synthetic", "4", "--benchmark", "pope", "--data_file", "x",
      "--mesh_pipe", "2"], "eval takes no mesh flags"),
])
def test_ppo_sft_and_eval_pipeline_refusals(tmp_path, argv, match):
    with pytest.raises(SystemExit, match=match):
        main([*argv, "--output_dir", str(tmp_path)])


def test_ppo_eval_and_eval_samples_refusals(runs, tmp_path):
    """eval keeps refusing mesh flags; ppo under torchrun and --eval_samples
    under --mesh_model 2, refused before, run (their results below)."""
    with pytest.raises(SystemExit, match="eval takes no mesh flags"):
        main(["eval", *CPU, "--synthetic", "4", "--benchmark", "pope", "--data_file", "x",
              "--output_dir", str(tmp_path), "--mesh_fsdp", "2"])
    for key in ("ppo_fsdp2", "ppo_model2", "dpo_model2"):
        _ok(runs[1], key)


def _comparable(row: dict) -> dict:
    return {k: v for k, v in row.items()
            if not k.startswith("perf/") and k not in ("ppo/rollout_tok_s", "step")}


@pytest.mark.parametrize("layout", ["fsdp2", "model2", "value_model2"])
def test_ppo_on_two_ranks_logs_the_single_process_metrics(runs, layout):
    tmp, done = runs
    _ok(done, f"ppo_{layout}")
    plain = "ppo_value1" if layout.startswith("value") else "ppo1"
    one, two = (metrics(tmp / d / "ppo_metrics.jsonl") for d in (plain, f"ppo_{layout}"))
    assert [r["step"] for r in two] == [1, 2] and len(one) == len(two)
    for a, b in zip(one, two):
        a, b = _comparable(a), _comparable(b)
        assert a.keys() == b.keys() and "ppo/kl_coef" in a
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=k)
    assert (tmp / f"ppo_{layout}" / "adapters" / "params.pt").exists()


def test_two_rank_ppo_checkpoint_resumes_in_a_plain_run(runs, tmp_path):
    """fsdp = 2's step-1 checkpoint (rank 0's world-1 tensors and the KL
    coefficient) resumed in one process takes the step a plain resume of
    the plain run's own step-1 checkpoint takes."""
    from vlrlhf_torch.train.checkpoint import CheckpointManager

    tmp, done = runs
    _ok(done, "ppo_fsdp2")
    last = {}
    for name in ("ppo_fsdp2", "ppo1"):
        src = tmp / name / "checkpoints"
        _, extra = CheckpointManager(str(src)).restore(1)
        assert extra["kl_coef"] == metrics(tmp / name / "ppo_metrics.jsonl")[0]["ppo/kl_coef"]
        out = tmp_path / name
        ckpt = CheckpointManager(str(out / "checkpoints"))
        tree, extra = CheckpointManager(str(src)).restore(1)
        ckpt.save(1, tree, extra=extra)
        ckpt.close()
        with greedy_rollouts():
            main([*PPO, "--output_dir", str(out), "--per_device_train_batch_size", "2",
                  "--resume_from_checkpoint", "auto"])
        last[name] = metrics(out / "ppo_metrics.jsonl")
    assert [r["step"] for r in last["ppo_fsdp2"]] == [2]
    a, b = (_comparable(last[n][0]) for n in ("ppo1", "ppo_fsdp2"))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=k)


def test_eval_samples_under_mesh_model_equal_the_single_process_run(runs):
    tmp, done = runs
    _ok(done, "dpo_model2")
    one, two = (metrics(tmp / d / "dpo_metrics.jsonl") for d in ("dpo1", "dpo_model2"))
    assert [r["step"] for r in two] == [r["step"] for r in one]
    for a, b in zip(one, two):
        for k in a.keys() - {"step"} - {k for k in a if k.startswith("perf/")}:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{a['step']} {k}")
    samples = [(tmp / d / "dpo_samples.jsonl").read_text().splitlines()
               for d in ("dpo1", "dpo_model2")]
    assert len(samples[1]) == 2 and samples[0] == samples[1]


@pytest.mark.parametrize("axis", list(SPLIT))
def test_dpo_and_eval_samples_under_the_sequence_split_equal_the_single_process_run(runs, axis):
    """dpo under the split over `axis` logs the plain run's metrics (the
    holdout's eval pass through the split forward) and writes its greedy
    samples, generated unsplit. Under the ring the logits/* means, which
    take pad positions too, are not compared (a padded query's attention
    output is 0 in the ring and a uniform average in the CPU's plain
    attention: tests/test_torch_dist_sp.py); the model split's attention
    is the plain one."""
    tmp, done = runs
    _ok(done, f"dpo_sp_{axis}")
    one, two = (metrics(tmp / d / "dpo_metrics.jsonl") for d in ("dpo1", f"dpo_sp_{axis}"))
    assert [r["step"] for r in two] == [r["step"] for r in one] and "eval/loss" in two[2]
    skip = ("perf/", "logits/", "eval/logits/") if axis == "fsdp" else ("perf/",)
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k in a.keys() - {"step"} - {k for k in a if k.startswith(skip)}:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{a['step']} {k}")
    samples = [(tmp / d / "dpo_samples.jsonl").read_text().splitlines()
               for d in ("dpo1", f"dpo_sp_{axis}")]
    assert len(samples[1]) == 2 and samples[0] == samples[1]


@pytest.mark.parametrize("axis", list(SPLIT))
def test_ppo_under_the_sequence_split_logs_the_single_process_metrics(runs, axis):
    tmp, done = runs
    _ok(done, f"ppo_sp_{axis}")
    one, two = (metrics(tmp / d / "ppo_metrics.jsonl") for d in ("ppo1", f"ppo_sp_{axis}"))
    assert [r["step"] for r in two] == [1, 2] and len(one) == len(two)
    for a, b in zip(one, two):
        a, b = _comparable(a), _comparable(b)
        assert a.keys() == b.keys() and "ppo/kl_coef" in a
        for k in a:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{axis} {k}")
    assert (tmp / f"ppo_sp_{axis}" / "adapters" / "params.pt").exists()


def test_int4_row_width_that_mesh_model_does_not_divide_is_refused():
    """An int4 row-parallel linear whose shard would not be a multiple of
    128 input rows is refused by name before anything is sharded."""
    from tests.test_int4 import _vlm128
    from vlrlhf_torch.core.partitioning import check_tp
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.utils.bridge import vlm_config_from

    model = init_random_(VLM(vlm_config_from(_vlm128()), device="cpu"),
                         torch.Generator().manual_seed(0))
    check_tp(model, 2)  # dense: 4 heads and 256 MLP rows split in two
    quantize_params(model, TRAIN_QUANT_PATTERNS, bits=4)
    with pytest.raises(ValueError, match=r"int4 row-parallel linear lm\.layers\.0\.wo would "
                                         r"hold 64 input rows"):
        check_tp(model, 2)
    with pytest.raises(ValueError, match="num_heads 4 is not divisible"):
        check_tp(model, 3)
