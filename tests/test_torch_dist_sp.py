"""Sequence parallelism on the CPU (`--sequence_parallel_axis fsdp`): one
gloo launch of 4 ranks (tests/torch_dist_worker.py) runs every case, f32,
while the references are computed in this process:
  - the ring_attention op over a ring of 4 (mesh (1, 4, 1)) against
    vlrlhf_tpu's ring_attention under MeshConfig(fsdp=4): causal and
    not, a row padded mid-shard, GQA 4 / 2; O and the gradients of the
    valid rows' sum(O ** 2) at tests/test_ring_attention.py's bounds
    (2e-5; 5e-5 / 5e-4);
  - the LM forward (GQA, right padding) under the ring against
    vlrlhf_tpu's lm_forward with sequence_parallel_axis="fsdp", valid
    rows at 2e-4 / 2e-3 (test_lm_forward_sequence_parallel_option_matches_plain);
  - dpo steps at (data, fsdp, model) = (2, 2, 1) and (1, 2, 2) (LoRA
    dropout 0.05 there: a rank draws its rows and columns of the
    single-process mask), sft and rm steps at (1, 4, 1), on the tiny
    LLaVA with rows padded mid-shard; one Qwen-VL pair past its
    seq_length (the dynamic-NTK alpha from the whole row, logn at global
    positions) and one InternLM-XC2 pair (its PLoRA mask sliced with the
    sequence): losses and metrics of every step, the first step's
    gradients of every trainable leaf and the leaves after the steps
    within 1e-5 of the single-process port on the same batch (but dpo's
    logits/* metrics, means over every position, pads too: a padded
    query's attention output is 0 in the ring, the flash kernels'
    convention, and a uniform average in the CPU's plain attention).
And `torchrun --nproc_per_node 2 -m vlrlhf_torch.cli.main dpo|sft|rm
--mesh_fsdp 2 --sequence_parallel_axis fsdp` logs the single-process
run's metrics within 1e-5, LoRA dropout on. Adam's eps is 1e-3, as in
tests/test_torch_dpo.py."""

import copy
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch
from tests.test_torch_dist_cli import CPU, finish, metrics, torchrun
from tests.test_torch_dist_dpo import OPT, _llava
from tests.test_torch_ring_attention import CASES as RING_CASES, _inputs, _jax_ring
from tests.torch_dist_worker import Job, on_one_thread
from vlrlhf_torch.cli.main import main

TOL = 1e-5
RING_FWD, RING_GRAD_ATOL, RING_GRAD_RTOL = 2e-5, 5e-5, 5e-4
LM_ATOL, LM_RTOL = 2e-4, 2e-3
STEPS = 2
DROPOUT = 0.05
# each row's real length (chosen rows, then rejected): ends inside shards of
# 12 (fsdp = 4) and 24 (fsdp = 2) positions
PAIR_LENS = (48, 43, 37, 33, 46, 40, 35, 48)
SFT_LENS = (48, 41, 34, 45)
# the CLI runs: synthetic rows, 2 rows a step on both layouts
CLI = [*CPU, "--max_steps", "2", "--logging_steps", "1", "--lora_r", "4", "--max_length", "64",
       "--learning_rate", "1e-3", "--warmup_ratio", "0", "--lora_dropout", "0.1",
       "--per_device_train_batch_size", "2"]


def right_padded(batch: dict, lens) -> dict:
    """The batch with row r cut to lens[r] real tokens (pad 0, labels -100)."""
    out = {k: np.array(v) for k, v in batch.items()}
    keep = np.arange(out["input_ids"].shape[1])[None] < np.asarray(lens)[:, None]
    out["pad_mask"] = keep
    out["input_ids"] = np.where(keep, out["input_ids"], 0).astype(out["input_ids"].dtype)
    out["labels"] = np.where(keep, out["labels"], -100).astype(out["labels"].dtype)
    return out


def _ring_inputs():
    """Per case: the ring's inputs at n = 4 with dO = 2 O of vlrlhf_tpu's
    valid rows, and its (O, dQ, dK, dV)."""
    inputs, want = {}, {}
    for name in RING_CASES:
        q, k, v, pad, causal = _inputs(name, 4)
        o, grads = _jax_ring(q, k, v, pad, causal, 4)
        do = (2.0 * o * pad[:, :, None, None]).astype(np.float32)
        inputs[name] = dict(q=q, k=k, v=v, pad=pad, do=do, causal=causal)
        want[name] = (o, *grads)
    return inputs, want


def _gqa_lm():
    """The tiny VLM with a 4 / 2-head GQA LM (JAX params and config, the
    port's model), ids and a right-padded mask of 2 rows of 32."""
    import dataclasses

    from tests.test_dpo_step import tiny_vlm_config
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    base = tiny_vlm_config()
    jcfg = dataclasses.replace(base, lm=dataclasses.replace(
        base.lm, num_heads=4, num_kv_heads=2, head_dim=8))
    params = init_vlm_params(jcfg, jax.random.PRNGKey(0))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, 128), np.int32)
    pad = np.arange(32)[None] < np.asarray([32, 27])[:, None]
    return jcfg, params, model, ids, pad


def _jax_lm_logits(jcfg, params, ids, pad):
    import dataclasses

    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh
    from vlrlhf_tpu.models.lm.llama import lm_forward

    make_mesh(MeshConfig(data=1, fsdp=4, model=1))
    sp_cfg = dataclasses.replace(jcfg.lm, sequence_parallel_axis="fsdp")
    logits, _ = lm_forward(sp_cfg, params["lm"], input_ids=jnp.asarray(ids),
                           pad_mask=jnp.asarray(pad))
    return np.asarray(logits)


def _qwen_pair():
    """A Qwen-VL model past its 32-token seq_length (dynamic NTK, logn;
    tests/test_torch_faults.py) with LoRA (b non-zero), and one DPO pair."""
    from tests.test_torch_faults import SEQ, _qwen_model
    from tests.test_torch_qwen_xc2_train import FEATURES, collate, processor
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora

    model = _qwen_model()
    init_lora(model, LoraConfig(r=4, alpha=8.0, target_patterns=(r"lm/.*attn/", r"lm/.*mlp/")),
              torch.Generator().manual_seed(5))
    with torch.no_grad():
        for mod in model.modules():
            if getattr(mod, "lora_b", None) is not None:
                mod.lora_b.add_(0.01)
    proc = processor("qwen_vl", model.cfg)
    batch = collate("DPOCollator", proc, [proc.tokenize_row_dpo(dict(FEATURES[1]))])
    batch = {k: np.asarray(v) for k, v in batch.items()}
    assert batch["pad_mask"].sum(1).min() > SEQ and batch["input_ids"].shape[1] % 4 == 0
    return model, batch, 0.5


def _xc2_pair():
    """InternLM-XC2 with its PLoRA and LoRA (tests/test_torch_families.py
    family_port) and one DPO pair."""
    from tests.test_torch_families import family_port
    from tests.test_torch_qwen_xc2_train import FEATURES, collate, processor

    jcfg, _, model, lcfg, _ = family_port("internlm_xc2", seed=8, lora=True)
    assert model.lm.layers[0].wq.plora_a is not None
    proc = processor("internlm_xc2", jcfg)
    batch = collate("DPOCollator", proc, [proc.tokenize_row_dpo(dict(FEATURES[0]))])
    batch = {k: np.asarray(v) for k, v in batch.items()}
    assert batch["input_ids"].shape[1] % 4 == 0
    return model, batch, lcfg.scale


def _train_case(name, mesh, model, batch, scale, step="dpo", steps=STEPS, **kw):
    case = dict(name=name, mesh=mesh, model=model, batch=batch, steps=steps, ocfg=OPT, sp="fsdp",
                grads=True, step=step, cfg=dict(lora_scale=scale, **kw))
    if step == "dpo":
        case["cfg"]["beta"] = 0.1
    if step == "rm":
        case["head"] = 0.05 * np.random.default_rng(3).standard_normal(
            (model.cfg.lm.hidden_size, 1)).astype(np.float32)
    return case


def world1(case: dict) -> dict:
    """The case's steps in this process with no mesh: per-step metrics, the
    first step's gradients and the leaves after the steps (world-1 keys)."""
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.rm import RMConfig, rm_step
    from vlrlhf_torch.train.sft import SFTConfig, sft_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    model = copy.deepcopy(case["model"])
    params, keys, head = adapter_params(model), lora_keys(model), None
    if case["step"] == "rm":
        head = torch.nn.Parameter(torch.as_tensor(case["head"]).clone())
        params, keys = params + [head], [f"adapters/{k}" for k in keys] + ["rm_head/kernel"]
    ocfg = OptimizerConfig(**case["ocfg"])
    state = init_train_state(params, ocfg)
    batch = batch_to_device(case["batch"], "cpu")
    out = {"metrics": []}
    for i in range(case["steps"]):
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


@pytest.fixture(scope="module")
@on_one_thread
def runs(tmp_path_factory):
    """The 4-rank job and the CLI's torchrun runs started together; the
    references meanwhile."""
    from vlrlhf_tpu.core import mesh as jmesh

    tmp = tmp_path_factory.mktemp("dist_sp")
    prev = jmesh._GLOBAL_MESH
    try:
        ring_in, ring_want = _ring_inputs()
        jcfg, jparams, lm_model, ids, pad = _gqa_lm()
        llava = _llava()
        model, lcfg = llava[4], llava[2]
        pairs = right_padded(llava[5], PAIR_LENS)
        sft = {k: np.asarray(v) for k, v in tiny_batch(jax.random.PRNGKey(5), n_pairs=2).items()}
        sft["pixel_values"] = np.concatenate([sft["pixel_values"]] * 2)
        sft = right_padded(sft, SFT_LENS)
        qwen, xc2 = _qwen_pair(), _xc2_pair()
        train = [
            _train_case("dpo/data2_fsdp2", (2, 2, 1), model, pairs, lcfg.scale),
            _train_case("dpo/fsdp2_model2", (1, 2, 2), model, pairs, lcfg.scale,
                        lora_dropout=DROPOUT, dropout_seed=7),
            _train_case("sft/fsdp4", (1, 4, 1), model, sft, lcfg.scale, step="sft"),
            _train_case("rm/fsdp4", (1, 4, 1), model, pairs, lcfg.scale, step="rm"),
            _train_case("qwen/fsdp4", (1, 4, 1), *qwen, steps=1),
            _train_case("xc2/fsdp4", (1, 4, 1), *xc2, steps=1),
        ]
        job = Job([dict(name="ring", step="sp_ring", mesh=(1, 4, 1), inputs=ring_in),
                   dict(name="lm", step="sp_lm", mesh=(1, 4, 1), model=lm_model, ids=ids,
                        pad=pad), *train], 4, tmp / "w4", timeout=240)
        cli = {cmd: torchrun([cmd, *CLI, "--synthetic", "6", "--output_dir", str(tmp / f"{cmd}2"),
                              "--mesh_fsdp", "2", "--sequence_parallel_axis", "fsdp"])
               for cmd in ("dpo", "sft", "rm")}
        want = {"lm": _jax_lm_logits(jcfg, jparams, ids, pad)}
    finally:
        jmesh._GLOBAL_MESH = prev
    want.update({c["name"]: world1(c) for c in train})
    for cmd in cli:
        main([cmd, *CLI, "--synthetic", "6", "--output_dir", str(tmp / f"{cmd}1")])
    done = {cmd: finish(p) for cmd, p in cli.items()}
    got = job.result()
    return tmp, got, want, ring_want, pad, done


@pytest.mark.parametrize("case", list(RING_CASES))
def test_ring_op_over_four_ranks_matches_vlrlhf_tpu(runs, case):
    _, got, _, ring_want, _, _ = runs
    (o, dq, dk, dv), (wo, wq, wk, wv) = got["ring"][case], ring_want[case]
    valid = np.broadcast_to(_inputs(case, 4)[3][:, :, None, None], o.shape)
    np.testing.assert_allclose(o[valid], wo[valid], atol=RING_FWD, rtol=RING_FWD)
    assert (o[~valid] == 0).all()
    for name, g, w in (("dq", dq, wq), ("dk", dk, wk), ("dv", dv, wv)):
        np.testing.assert_allclose(g, w, atol=RING_GRAD_ATOL, rtol=RING_GRAD_RTOL, err_msg=name)


def test_lm_forward_under_the_ring_matches_vlrlhf_tpu(runs):
    _, got, want, _, pad, _ = runs
    np.testing.assert_allclose(got["lm"]["logits"][pad], want["lm"][pad], atol=LM_ATOL,
                               rtol=LM_RTOL)


TRAIN = ("dpo/data2_fsdp2", "dpo/fsdp2_model2", "sft/fsdp4", "rm/fsdp4", "qwen/fsdp4",
         "xc2/fsdp4")


@pytest.mark.parametrize("name", TRAIN)
def test_sequence_parallel_steps_match_world1(runs, name):
    _, got, want, _, _, _ = runs
    g, w = got[name], want[name]
    assert len(g["metrics"]) == len(w["metrics"])
    for i, (gm, wm) in enumerate(zip(g["metrics"], w["metrics"])):
        for k in [k for k in wm if not k.startswith("logits/")]:
            np.testing.assert_allclose(gm[k], wm[k], atol=TOL, rtol=TOL, err_msg=f"{i} {k}")
    for part in ("grads", "trainable"):
        assert g[part].keys() == w[part].keys()
        for k, wv in w[part].items():
            np.testing.assert_allclose(g[part][k], wv, atol=TOL * max(1.0, float(np.abs(wv).max())),
                                       rtol=TOL, err_msg=f"{part} {k}")
    if name.startswith("dpo"):  # the first step has every gradient non-zero
        assert all(np.abs(v).max() > 0 for v in w["grads"].values())


@pytest.mark.parametrize("cmd", ["dpo", "sft", "rm"])
def test_torchrun_cli_under_the_ring_logs_the_single_process_metrics(runs, cmd):
    tmp, _, _, _, _, done = runs
    rc, out = done[cmd]
    assert rc == 0, out[-3000:]
    one, two = (metrics(tmp / d / f"{cmd}_metrics.jsonl") for d in (f"{cmd}1", f"{cmd}2"))
    assert len(one) == len(two) == 2
    for a, b in zip(one, two):
        for k in a.keys() - {"step"} - {k for k in a if k.startswith(("perf/", "logits/"))}:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{a['step']} {k}")
    assert os.path.exists(tmp / f"{cmd}2" / "adapters" / "params.pt")
