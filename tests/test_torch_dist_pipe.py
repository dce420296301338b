"""The GPipe pipeline on the CPU (`--mesh_pipe`): one gloo launch of 4
ranks (tests/torch_dist_worker.py) runs every case, f32, while the
references are computed in this process. Each rank holds its stage's
layers only (core/partitioning.py). At (data, fsdp, model, pipe):
  - dpo at (1, 1, 1, 4) on a 4-layer tiny LLaVA, 2 rows a microbatch;
  - dpo at (1, 2, 1, 2) with 4 microbatches of one row and LoRA dropout
    0.05 (a rank's microbatch keeps its rows of the global batch's mask);
  - dpo at (1, 1, 2, 2) with LoRA dropout and an unfrozen tower with tower
    LoRA (a leaf before the stack: only stage 0 backpropagates into it,
    the optimizer sums it over the stages); sft and rm at (2, 1, 1, 2)
    (rm's head is a leaf after the stack);
  - QLoRA int4 dpo at (2, 1, 1, 2) on the 256-wide LLaVA of
    tests/test_torch_dist_dpo.py, at its int4 bounds (loss 5e-3, leaves
    2e-2 relative);
  - a Qwen-VL pair past its seq_length (dynamic NTK from the whole row,
    logn) at (1, 1, 2, 2) and an InternLM-XC2 batch with PLoRA at (1, 1, 2,
    2) in 4 microbatches (the PLoRA mask's rows cut with the rows);
  - a checkpoint written at (1, 2, 1, 2) after one step resumes at world 1,
    and a world-1 checkpoint resumes at (1, 2, 1, 2), each continuing as
    the straight run does.
Rows are right-padded to different lengths, so every microbatch has its
own pad mask. Each run's losses and metrics of every step, the first
step's gradients of every leaf and every leaf after 3 steps equal the
single-process port's within 1e-5; every leaf outside the stack's layers
holds the same bits on every stage after the steps. The (1, 2, 1, 2) save
run's first step (metrics, and the adapters its checkpoint holds) equals
vlrlhf_tpu's DPO step under MeshConfig(fsdp=4, pipe=2) on the 8 virtual
devices at tests/test_torch_dist_dpo.py's bounds: a 4-rank job holds no
(1, 1, 1, 2) mesh, so fsdp = 2 stands in. And `torchrun --nproc_per_node
2 -m vlrlhf_torch.cli.main dpo|sft|rm --mesh_fsdp 1 --mesh_pipe 2` logs
the single-process run's metrics within 1e-5, LoRA dropout on, and writes
its adapters/ and merged/ (every stage's layers joined; dpo also with the
reference pass and the holdout's eval/* through the pipeline's forward, and
--eval_samples 2: the holdout's greedy samples from the whole stack, equal
to the single-process run's).
Adam's eps is 1e-3, as in tests/test_torch_dpo.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch
from tests.test_torch_dist_cli import CPU, finish, metrics, torchrun
from tests.test_torch_dist_dpo import (
    INT4_LOSS, INT4_REL, OPT, _family, _int4_model, assert_adapters, jax_steps,
)
from tests.test_torch_dist_sp import PAIR_LENS, SFT_LENS, _qwen_pair, right_padded
from tests.torch_dist_worker import Job, on_one_thread
from vlrlhf_torch.cli.main import main

TOL = 1e-5
STEPS = 3
DROPOUT = 0.05
LORA_PATTERNS = (r"lm/.*attn/", r"lm/.*mlp/")
TOWER_PATTERNS = (r"vision/.*attn/(wq|wv)/",)
# the CLI runs: synthetic rows, 2 pairs a step, 4 microbatches of one row,
# the merged save; dpo also with the reference pass and the holdout (2 of
# its 10 pairs) through the pipeline's forward, and the holdout's greedy
# samples generated on the whole stack (core/partitioning.py whole_stack)
CLI = [*CPU, "--max_steps", "2", "--logging_steps", "1", "--lora_r", "4", "--max_length", "64",
       "--learning_rate", "1e-3", "--warmup_ratio", "0", "--lora_dropout", "0.1",
       "--per_device_train_batch_size", "2", "--merge_adapter_after_training"]
DPO_CLI = ["--synthetic", "10", "--precompute_ref_logps", "true", "--eval_steps", "2",
           "--eval_ratio", "0.2", "--eval_samples", "2"]
PIPE_CLI = ["--mesh_fsdp", "1", "--mesh_pipe", "2"]


def _cli_args(cmd: str) -> list:
    return [cmd, *CLI, *(DPO_CLI if cmd == "dpo" else ["--synthetic", "8"])]


def _llava4():
    """The tiny LLaVA of tests/test_dpo_step.py at 4 LM layers: vlrlhf_tpu's
    config, params and adapters (b offset 0.01) and the bridged port
    model."""
    from tests.test_dpo_step import tiny_vlm_config
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, vlm_config_from

    base = tiny_vlm_config()
    jcfg = dataclasses.replace(base, lm=dataclasses.replace(base.lm, num_layers=4))
    params = jax.jit(init_vlm_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(1))
    adapters = jax.tree.map(lambda x: x + 0.01 * jnp.ones_like(x), adapters)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    return jcfg, params, lcfg, adapters, model


def _with_tower_lora(model):
    """The model with LoRA on the tower's wq / wv too (b offset 0.01)."""
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora

    model = copy.deepcopy(model)
    names = init_lora(model, LoraConfig(r=4, alpha=8.0, target_patterns=TOWER_PATTERNS),
                      torch.Generator().manual_seed(6))
    with torch.no_grad():
        for name in names:
            model.get_submodule(name).lora_b.add_(0.01)
    return model


def _case(name, mesh, model, batch, scale, step="dpo", steps=STEPS, micro=0, **kw):
    case = dict(name=name, mesh=mesh, model=model, batch=batch, steps=steps, ocfg=OPT,
                grads=True, step=step, micro=micro, cfg=dict(lora_scale=scale, **kw))
    if step == "dpo":
        case["cfg"]["beta"] = 0.1
    if step == "rm":
        case["head"] = 0.05 * np.random.default_rng(3).standard_normal(
            (model.cfg.lm.hidden_size, 1)).astype(np.float32)
    return case


def world1(case: dict, resume=None, save=None) -> dict:
    """The case's steps in this process with no mesh (from the state tree
    `resume`; with `save` a CheckpointManager the state is saved before
    step case["save_at"]): per-step metrics, the first step's gradients and
    the leaves after the steps."""
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.rm import RMConfig, rm_step
    from vlrlhf_torch.train.sft import SFTConfig, sft_step
    from vlrlhf_torch.train.train_state import (
        OptimizerConfig, init_train_state, load_state_tree_, state_tree,
    )

    model = copy.deepcopy(case["model"])
    params, keys, head = adapter_params(model), lora_keys(model), None
    if case["step"] == "rm":
        head = torch.nn.Parameter(torch.as_tensor(case["head"]).clone())
        params, keys = params + [head], [f"adapters/{k}" for k in keys] + ["rm_head/kernel"]
    ocfg = OptimizerConfig(**case["ocfg"])
    state = init_train_state(params, ocfg)
    if resume is not None:
        load_state_tree_(state, keys, resume)
    batch = batch_to_device(case["batch"], "cpu")
    out = {"metrics": []}
    for i in range(case["steps"]):
        if save is not None and i == case.get("save_at", 1):
            save.save(i, state_tree(state, keys))
        if case["step"] == "dpo":
            m = dpo_step(model, DPOConfig(**case["cfg"]), ocfg, state, batch)
        elif case["step"] == "sft":
            m = sft_step(model, SFTConfig(**case["cfg"]), ocfg, state, batch)
        else:
            m = rm_step(model, RMConfig(**case["cfg"]), ocfg, state, head, batch)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        if i == 0:
            out["grads"] = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                            .detach().numpy().copy() for k, p in zip(keys, state.trainable)}
    out["trainable"] = {k: p.detach().numpy() for k, p in zip(keys, state.trainable)}
    return out


def _jax_first_step(llava, batch):
    """vlrlhf_tpu's jitted DPO step with the stack pipelined over 2 stages
    under MeshConfig(fsdp=4, pipe=2): (metrics, adapters) after one step."""
    from vlrlhf_tpu.train.dpo import DPOConfig, make_dpo_step

    jcfg, params, lcfg, adapters = llava[:4]
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, pipeline_stages=2))
    return jax_steps(lambda c, tx: make_dpo_step(c, DPOConfig(beta=0.1, lora_scale=lcfg.scale),
                                                 tx), jcfg, params, adapters, batch, (1, 4, 1, 2),
                     steps=1)


TRAIN = ("dpo/pipe4", "dpo/fsdp2_pipe2_micro4", "dpo/model2_pipe2_tower", "sft/data2_pipe2",
         "rm/data2_pipe2", "qwen/model2_pipe2", "xc2/model2_pipe2_micro4")


@pytest.fixture(scope="module")
@on_one_thread
def runs(tmp_path_factory):
    """The 4-rank job and the CLI's torchrun runs started together; the
    references meanwhile."""
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_tpu.core import mesh as jmesh

    tmp = tmp_path_factory.mktemp("dist_pipe")
    prev = jmesh._GLOBAL_MESH
    try:
        llava = _llava4()
        model, scale = llava[4], llava[2].scale
        pairs = right_padded({k: np.asarray(v) for k, v in
                              tiny_batch(jax.random.PRNGKey(9), n_pairs=4).items()}, PAIR_LENS)
        sft = {k: np.asarray(v) for k, v in tiny_batch(jax.random.PRNGKey(5), n_pairs=2).items()}
        sft["pixel_values"] = np.concatenate([sft["pixel_values"]] * 2)
        sft = right_padded(sft, SFT_LENS)
        lcfg4, model4, batch4 = _int4_model()
        qwen = _qwen_pair()
        xc2 = _family("internlm_xc2", tmp_path_factory.mktemp("xc2"))
        train = [
            _case("dpo/pipe4", (1, 1, 1, 4), model, pairs, scale),
            _case("dpo/fsdp2_pipe2_micro4", (1, 2, 1, 2), model, pairs, scale, micro=4,
                  lora_dropout=DROPOUT, dropout_seed=7),
            _case("dpo/model2_pipe2_tower", (1, 1, 2, 2), _with_tower_lora(model), pairs, scale,
                  lora_dropout=DROPOUT, dropout_seed=7, frozen_vision=False),
            _case("sft/data2_pipe2", (2, 1, 1, 2), model, sft, scale, step="sft"),
            _case("rm/data2_pipe2", (2, 1, 1, 2), model, pairs, scale, step="rm"),
            _case("qwen/model2_pipe2", (1, 1, 2, 2), *qwen),
            _case("xc2/model2_pipe2_micro4", (1, 1, 2, 2), xc2[4], xc2[5], xc2[2].scale,
                  micro=4),
        ]
        int4 = _case("int4/data2_pipe2", (2, 1, 1, 2), model4, batch4, lcfg4.scale,
                     logits_chunk=16)
        saved = dict(_case("save/fsdp2_pipe2", (1, 2, 1, 2), model, pairs, scale),
                     save_dir=str(tmp / "ckpt_pipe"), save_at=1)
        # the reverse: a world-1 checkpoint after one step, resumed under the pipeline
        w1_ckpt = CheckpointManager(str(tmp / "ckpt_world1"))
        straight = world1(dict(saved, steps=STEPS), save=w1_ckpt)
        w1_ckpt.close()
        resumed = dict(_case("resumed/fsdp2_pipe2", (1, 2, 1, 2), model, pairs, scale,
                             steps=STEPS - 1), resume_dir=str(tmp / "ckpt_world1"), grads=False)
        job = Job([*train, int4, saved, resumed], 4, tmp / "w4", timeout=300)
        cli = {cmd: torchrun([*_cli_args(cmd), "--output_dir", str(tmp / f"{cmd}2"), *PIPE_CLI,
                              "--pipeline_microbatches", "4" if cmd != "sft" else "2"])
               for cmd in ("dpo", "sft", "rm")}
        want = {"jax": _jax_first_step(llava, pairs)}
    finally:
        jmesh._GLOBAL_MESH = prev
    want.update({c["name"]: world1(c) for c in train + [int4]})
    want["straight"] = straight
    for cmd in cli:
        main([*_cli_args(cmd), "--output_dir", str(tmp / f"{cmd}1")])
    done = {cmd: finish(p) for cmd, p in cli.items()}
    got = job.result()
    tree, _ = CheckpointManager(str(tmp / "ckpt_pipe")).restore()
    got["resumed/world1"] = world1(dict(saved, steps=STEPS - 1), resume=tree)
    got["saved_tree"] = tree
    return tmp, got, want, done


def _assert_run(g: dict, w: dict, name: str, tol: float = TOL) -> None:
    assert len(g["metrics"]) == len(w["metrics"]) == STEPS
    for i, (gm, wm) in enumerate(zip(g["metrics"], w["metrics"])):
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], atol=tol, rtol=tol, err_msg=f"{name} {i} {k}")
    for part in ("grads", "trainable"):
        assert g[part].keys() == w[part].keys()
        for k, wv in w[part].items():
            np.testing.assert_allclose(g[part][k], wv, atol=tol * max(1.0, float(np.abs(wv).max())),
                                       rtol=tol, err_msg=f"{name} {part} {k}")


@pytest.mark.parametrize("name", TRAIN)
def test_pipelined_steps_match_world1(runs, name):
    _, got, want, _ = runs
    _assert_run(got[name], want[name], name)
    assert all(got[name]["stages_equal"].values()), got[name]["stages_equal"]
    if name.startswith("dpo"):  # the first step has every LM gradient non-zero
        assert all(np.abs(v).max() > 0 for k, v in want[name]["grads"].items()
                   if k.startswith("lm/"))


def test_leaves_outside_the_stack_are_bit_equal_on_every_stage(runs):
    """The unfrozen tower's adapters (only stage 0 backpropagates into
    them) and rm's head (every stage computes its gradient) hold the same
    bits on every stage after the steps."""
    _, got, _, _ = runs
    tower = got["dpo/model2_pipe2_tower"]["stages_equal"]
    assert len(tower) == 8 and all(tower.values()), tower  # wq, wv x 2 tower layers x a, b
    assert got["rm/data2_pipe2"]["stages_equal"] == {"rm_head/kernel": True}
    g, w = got["dpo/model2_pipe2_tower"]["grads"], runs[2]["dpo/model2_pipe2_tower"]["grads"]
    # the tower's adapters train (its feature layer, -2, is its first layer's output)
    fed = [k for k in tower if k.startswith("vision/layers/0/")]
    assert len(fed) == 4 and all(np.abs(w[k]).max() > 0 and np.abs(g[k]).max() > 0 for k in fed)


def test_qlora_int4_pipelined_steps_match_world1(runs):
    _, got, want, _ = runs
    g, w = got["int4/data2_pipe2"], want["int4/data2_pipe2"]
    for gm, wm in zip(g["metrics"], w["metrics"]):
        assert abs(gm["loss"] - wm["loss"]) <= INT4_LOSS, (gm["loss"], wm["loss"])
    assert g["trainable"].keys() == w["trainable"].keys()
    for k, wv in w["trainable"].items():
        err = np.linalg.norm(g["trainable"][k] - wv) / max(np.linalg.norm(wv), 1e-12)
        assert err <= INT4_REL, (k, err)


def test_first_step_matches_vlrlhf_tpu_pipeline(runs):
    """The (1, 2, 1, 2) run's first step against vlrlhf_tpu's DPO step
    with pipeline_stages 2 under MeshConfig(fsdp=4, pipe=2)."""
    _, got, want, _ = runs
    wm, wa = want["jax"]
    g = got["save/fsdp2_pipe2"]["metrics"][0]
    for k in ("loss", "rewards/margins"):
        np.testing.assert_allclose(g[k], wm[0][k], atol=TOL, rtol=TOL, err_msg=k)
    assert_adapters({k: v.numpy() for k, v in got["saved_tree"]["trainable"].items()}, wa,
                    what="pipe2")


@pytest.mark.parametrize("where", ["world1", "fsdp2_pipe2"])
def test_checkpoints_cross_the_pipeline_both_ways(runs, where):
    """A checkpoint saved under the pipeline resumes at world 1, and a
    world-1 one under the pipeline; both continue as the straight run."""
    _, got, want, _ = runs
    straight = (got["save/fsdp2_pipe2"] if where == "world1" else want["straight"])["metrics"]
    resumed = got[f"resumed/{where}"]["metrics"]
    assert len(straight) == STEPS and len(resumed) == STEPS - 1
    for i, (g, w) in enumerate(zip(resumed, straight[1:])):
        for k in ("loss", "rewards/margins", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], atol=TOL, rtol=TOL, err_msg=f"{where} {i} {k}")
    assert abs(straight[2]["loss"] - straight[0]["loss"]) > 1e-3  # the steps moved the adapters
    tree = got["saved_tree"]
    assert list(tree["trainable"]) == sorted(tree["trainable"]) and tree["step"] == 1
    assert {int(k.split("/")[2]) for k in tree["trainable"]} == {0, 1, 2, 3}


@pytest.mark.parametrize("cmd", ["dpo", "sft", "rm"])
def test_torchrun_cli_under_the_pipeline_logs_the_single_process_metrics(runs, cmd):
    tmp, _, _, done = runs
    rc, out = done[cmd]
    assert rc == 0, out[-3000:]
    one, two = (metrics(tmp / d / f"{cmd}_metrics.jsonl") for d in (f"{cmd}1", f"{cmd}2"))
    assert [r["step"] for r in one] == [r["step"] for r in two] == (
        [1, 2, 2] if cmd == "dpo" else [1, 2])  # dpo: the holdout's eval/* line at step 2
    for a, b in zip(one, two):
        assert a.keys() == b.keys()
        for k in a.keys() - {"step"} - {k for k in a if k.startswith("perf/")}:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{a['step']} {k}")
    if cmd == "dpo":  # the greedy policy and reference samples of the whole stack
        samples = [(tmp / d / "dpo_samples.jsonl").read_text().splitlines()
                   for d in ("dpo1", "dpo2")]
        assert len(samples[1]) == 2 and samples[0] == samples[1]
    # adapters/ and merged/: the single-process files, every stage's layers joined
    from vlrlhf_torch.train.checkpoint import load_params

    for part in ("adapters", "merged"):
        w, g = (load_params(str(tmp / d / part)) for d in (f"{cmd}1", f"{cmd}2"))
        assert list(g) == list(w) if part == "adapters" else g.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_allclose(g[k].float().numpy(), v.float().numpy(), atol=TOL,
                                       rtol=TOL, err_msg=f"{part} {k}")
