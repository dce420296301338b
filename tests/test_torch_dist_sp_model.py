"""The sequence split over the tensor-parallel ranks on the CPU
(`--sequence_parallel_axis model`, Megatron-LM's sequence parallelism:
each layer gathers its normed slice before the column linears, attends
on its heads over the whole sequence and reduce-scatters after the row
linears), and ppo under either split. One gloo launch of 4 ranks
(tests/torch_dist_worker.py) runs every case, f32, while the references
are computed in this process:
  - the LM forward (GQA 8 / 4, a row padded mid-slice) at (data, fsdp,
    model) = (1, 1, 4) and (1, 2, 2) against vlrlhf_tpu's lm_forward
    with sequence_parallel_axis="model" under MeshConfig(model=4) and
    MeshConfig(fsdp=2, model=2), valid rows at tests/test_ring_attention.py's
    bounds (2e-4 / 2e-3);
  - dpo steps at (1, 1, 4) (an unfrozen tower with tower LoRA) and
    (2, 1, 2), both with LoRA dropout 0.05 (every linear reads the whole
    sequence, so a rank draws the single-process mask's columns), sft and
    rm steps at (1, 2, 2), on the tiny LLaVA with rows padded mid-slice;
    one Qwen-VL pair past its seq_length (the dynamic-NTK alpha and logn
    at the whole sequence's positions) and one InternLM-XC2 pair (8 / 4
    heads; its PLoRA mask whole on the column linears, sliced after the
    row ones), each at (1, 1, 4): the losses and metrics of every step, the first step's
    gradient of every trainable leaf (the leaves replicated over model
    summed over the group, the split ones not) and the leaves after the
    steps within 1e-5 of the single-process port on the same batch; and
    one dpo step at (1, 2, 2) under each remat policy (full, attn, dots,
    mlp, mlp1, acts: the gathers and scatters rerun in the backward's
    recompute, LoRA dropout on);
  - QLoRA: int8 bases at (1, 2, 2) within 1e-5 of world 1, int4 bases
    (a 256-wide LLaVA, row shards repacked) at (2, 1, 2) within
    tests/test_torch_qlora.py's int4 tolerances (loss 5e-3, adapters 2e-2
    relative);
  - two dpo steps at (1, 2, 2) without dropout against vlrlhf_tpu's
    make_dpo_step with sequence_parallel_axis="model" under
    MeshConfig(model=2) (loss, margins, adapters at 1e-5, Adam's eps
    1e-3 as in tests/test_torch_dist_dpo.py);
  - ppo, one outer step (2 epochs x 2 minibatches, score scaling, the
    adaptive KL controller) at (1, 1, 4) under `model` and at (1, 4, 1)
    under `fsdp`: greedy rollouts, static and continuous, token for token
    world 1's (generation runs unsplit, core/dist.py unsplit); sampled
    rollouts whose four ranks draw from different seeds equal on every
    rank (one group decodes one set of rows); every update's metrics, the
    adapters, the value head and the KL coefficient within 1e-5 of world 1,
    and the last update's metrics, the adapters and the value head within
    1e-5 of vlrlhf_tpu's make_ppo_fns / ppo_update_epochs with the same
    sequence_parallel_axis under MeshConfig(model=4) and
    MeshConfig(fsdp=4) on the 8 virtual devices (its rollout batch padded
    to a length the split divides, as the port's ppo_step pads it); ppo's
    reward model scoring a 37-position rollout under either split (whole
    sequences, as the rollouts) as world 1 scores it.
The torchrun runs of `dpo` and `ppo` under either split are in
tests/test_torch_dist_cli.py."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch
from tests.test_torch_dist_dpo import (
    OPT, _KEY, _int4_model, _int8, _llava, assert_adapters, assert_metrics, jax_dpo,
)
from tests.test_torch_dist_pipe import _with_tower_lora
from tests.test_torch_dist_sp import _qwen_pair, right_padded
from tests.test_torch_dist_sp import world1 as train_world1
from tests.test_torch_models import prompt_batch
from tests.test_torch_ppo import _rollout_batch
from tests.torch_dist_worker import Job, on_one_thread

TOL = 1e-5
INT4_LOSS, INT4_REL = 5e-3, 2e-2
LM_ATOL, LM_RTOL = 2e-4, 2e-3
STEPS = 2
DROPOUT = 0.05
# each row's real length (chosen rows, then rejected): ends inside slices of
# 12 (model = 4) and 24 (model = 2) positions
PAIR_LENS = (48, 43, 37, 33, 46, 40, 35, 48)
SFT_LENS = (48, 41, 34, 45)
LM_LAYOUTS = {"lm/model4": (1, 1, 4), "lm/fsdp2_model2": (1, 2, 2)}
# (mesh, split axis, vlrlhf_tpu's MeshConfig for the same split)
PPO_LAYOUTS = {"ppo/model4": ((1, 1, 4), "model", (1, -1, 4)),
               "ppo/fsdp4": ((1, 4, 1), "fsdp", (1, 4, 1))}
NEW_TOKENS = 5
PPO_SEED = 7
REMAT = ("full", "attn", "dots", "mlp", "mlp1", "acts")


def _gqa_lm():
    """The tiny VLM with an 8 / 4-head GQA LM of width-4 heads (model = 4
    splits both), its ids and a mask with one row padded mid-slice."""
    from tests.test_dpo_step import tiny_vlm_config
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    base = tiny_vlm_config()
    jcfg = dataclasses.replace(base, lm=dataclasses.replace(
        base.lm, num_heads=8, num_kv_heads=4, head_dim=4))
    params = init_vlm_params(jcfg, jax.random.PRNGKey(0))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    ids = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 32), 0, 128), np.int32)
    pad = np.arange(32)[None] < np.asarray([32, 27])[:, None]
    return jcfg, params, model, ids, pad


def _jax_lm_logits(jcfg, params, ids, pad, mesh_shape):
    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh
    from vlrlhf_tpu.models.lm.llama import lm_forward

    make_mesh(MeshConfig(*mesh_shape))
    sp_cfg = dataclasses.replace(jcfg.lm, sequence_parallel_axis="model")
    logits, _ = jax.jit(lambda p, i, m: lm_forward(sp_cfg, p, input_ids=i, pad_mask=m))(
        params["lm"], jnp.asarray(ids), jnp.asarray(pad))
    return np.asarray(logits)


def _remat(model, policy: str):
    """The model with its decoder rematerialized under `policy`."""
    model = copy.deepcopy(model)
    model.lm.cfg = dataclasses.replace(model.lm.cfg, remat=True, remat_policy=policy)
    return model


def _xc2_pair():
    """InternLM-XC2 at 8 / 4 heads (model = 4 splits its KV heads) with its
    PLoRA and LoRA, and one DPO pair."""
    from tests.test_torch_families import family_port
    from tests.test_torch_qwen_xc2_train import FEATURES, collate, processor

    gqa = (("num_heads", 8), ("num_kv_heads", 4), ("head_dim", 4))
    jcfg, _, model, lcfg, _ = family_port("internlm_xc2", seed=8, lora=True, lm_overrides=gqa)
    assert model.lm.layers[0].wq.plora_a is not None
    proc = processor("internlm_xc2", jcfg)
    batch = collate("DPOCollator", proc, [proc.tokenize_row_dpo(dict(FEATURES[0]))])
    batch = {k: np.asarray(v) for k, v in batch.items()}
    assert batch["input_ids"].shape[1] % 4 == 0
    return model, batch, lcfg.scale


def _train_case(name, mesh, model, batch, scale, step="dpo", steps=STEPS, **kw):
    case = dict(name=name, mesh=mesh, model=model, batch=batch, steps=steps, ocfg=OPT,
                sp="model", grads=True, step=step, cfg=dict(lora_scale=scale, **kw))
    if step == "dpo":
        case["cfg"]["beta"] = 0.1
    if step == "rm":
        case["head"] = 0.05 * np.random.default_rng(3).standard_normal(
            (model.cfg.lm.hidden_size, 1)).astype(np.float32)
    return case


def _ppo_case(name, mesh, axis, model, scale):
    ids, pad, plens, px, pos = prompt_batch(seed=5, lens=(30, 22, 26, 28))
    batch, raw = _rollout_batch()
    v_head = (np.random.default_rng(2).normal(size=(model.cfg.lm.hidden_size, 1)) * 0.1)
    return dict(name=name, step="ppo", mesh=mesh, sp=axis, model=model,
                v_head=v_head.astype(np.float32), ocfg=OPT,
                pcfg=dict(lora_scale=scale, init_kl_coef=0.05, ppo_epochs=2, minibatch_size=2,
                          use_score_scaling=True),
                prompts={"input_ids": ids, "pad_mask": pad, "prompt_lens": plens,
                         "pixel_values": px, "image_positions": pos},
                new_tokens=NEW_TOKENS, sampled=True, batch=batch, raw=raw * 3.0 + 1.0,
                seed=PPO_SEED)


def _reward_dir(model, path) -> str:
    """An rm run's adapters/ for `model` at `path`: a seeded rm_head and
    r2 adapters on the LM's MLP linears."""
    from vlrlhf_torch.lora.lora import match_lora_targets, module_path
    from vlrlhf_torch.train.checkpoint import save_params

    g = torch.Generator().manual_seed(14)
    tree = {"rm_head/kernel": torch.randn((model.cfg.lm.hidden_size, 1), generator=g)}
    for name, mod in match_lora_targets(model, (r"lm/.*mlp/",)):
        key = f"adapters/{module_path(name)[: -len('/kernel')]}"
        tree[f"{key}/a"] = torch.randn((mod.d_in, 2), generator=g)
        tree[f"{key}/b"] = torch.randn((2, mod.d_out), generator=g)
    save_params(str(path), tree)
    return str(path)


def reward_world1(model, path: str, batch: dict):
    from vlrlhf_torch.cli.main import reward_model_fn
    from vlrlhf_torch.train.dpo import batch_to_device

    return reward_model_fn(copy.deepcopy(model), path, 0.5)(batch_to_device(batch, "cpu")).numpy()


def ppo_world1(case: dict) -> dict:
    """The ppo case in this process with no mesh: greedy static and
    continuous rollouts of the whole prompt batch, then ppo_step."""
    from vlrlhf_torch.cli.main import PPORun, continuous_rollouts, ppo_step, static_rollouts
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.dpo import adapter_params
    from vlrlhf_torch.train.ppo import AdaptiveKLController, PPOConfig, RunningMoments
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    model = copy.deepcopy(case["model"])
    v_head = {"kernel": torch.nn.Parameter(torch.from_numpy(case["v_head"].copy()))}
    keys = [f"adapters/{k}" for k in lora_keys(model)] + ["v_head/kernel"]
    pcfg, ocfg = PPOConfig(**case["pcfg"]), OptimizerConfig(**case["ocfg"])
    state = init_train_state(adapter_params(model) + [v_head["kernel"]], ocfg)
    run = PPORun(model=model, pcfg=pcfg, ocfg=ocfg, lcfg=None, state=state, keys=keys,
                 v_head=v_head, value_adapters=False, gen_cfg=None, gen_collator=None, rows=[],
                 reward_fn=None, flops_per_token=0.0, flops_per_image=0.0)
    gcfg = GenerateConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    gen = Generator(model, gcfg, lora_scale=pcfg.lora_scale)
    gen.adapters = True
    prompts = case["prompts"]
    n = prompts["input_ids"].shape[0]
    out = {"static": static_rollouts(gen, prompts, 1, None),
           "continuous": continuous_rollouts(
               ContinuousEngine(model, gcfg, n_slots=1, cache_len=128, adapters=True,
                                lora_scale=pcfg.lora_scale, emit_stop_token=True),
               prompts, [{"img_path": "x"}] * n, None, NEW_TOKENS, 0)}
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(pcfg)
    scores, kl, history = ppo_step(run, case["batch"], case["raw"], moments, kl_ctl, case["seed"])
    out.update(scores=scores, kl=kl, history=history, kl_coef=kl_ctl.value,
               moments=(moments.mean, moments.var, moments.count),
               trainable={k: p.detach().numpy().copy() for k, p in zip(keys, state.trainable)})
    return out


def jax_ppo(llava, case: dict, axis: str, mesh_shape) -> dict:
    """vlrlhf_tpu's outer step on the case's rollout batch with its LM
    split over `axis` under MeshConfig(*mesh_shape) (params and state by
    default_lm_rules, the batch on data x fsdp), the batch's length padded
    to a multiple of 4 as the port's ppo_step pads it (train/ppo.py
    pad_to_split)."""
    from jax.sharding import NamedSharding

    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh
    from vlrlhf_tpu.core.partitioning import (
        batch_spec, default_lm_rules, make_sharding, shard_pytree,
    )
    from vlrlhf_tpu.train.ppo import AdaptiveKLController, PPOConfig, RunningMoments
    from vlrlhf_tpu.train.ppo import make_ppo_fns, ppo_update_epochs, preprocess_scores
    from vlrlhf_tpu.train.train_state import OptimizerConfig, init_train_state, make_optimizer

    jcfg, params, _, adapters = llava[:4]
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, sequence_parallel_axis=axis))
    extra = -case["batch"]["input_ids"].shape[1] % 4
    batch = {k: np.pad(v, ((0, 0), (0, extra))) if k in ("input_ids", "pad_mask", "response_mask")
             else v for k, v in case["batch"].items()}
    kw = case["pcfg"]
    trainable = jax.tree.map(jnp.array, {"adapters": adapters,
                                         "v_head": {"kernel": jnp.asarray(case["v_head"])}})
    tx = make_optimizer(OptimizerConfig(**case["ocfg"]), trainable)
    mesh = make_mesh(MeshConfig(*mesh_shape))
    rules = default_lm_rules()
    params = shard_pytree(rules, params, mesh)
    state = init_train_state(trainable, tx)
    state = jax.tree.map(jax.device_put, state, make_sharding(rules, state, mesh))
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, batch_spec()))
             for k, v in batch.items()}
    stats_fn, update_fn = make_ppo_fns(jcfg, PPOConfig(**kw), tx)
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(PPOConfig(**kw))
    scores = preprocess_scores(case["raw"], PPOConfig(**kw), moments)
    stats = stats_fn(params, state.trainable, batch, jnp.asarray(scores),
                     jnp.asarray(kl_ctl.value))
    state, metrics = ppo_update_epochs(update_fn, state, params, batch, stats, PPOConfig(**kw),
                                       seed=case["seed"])
    kl_ctl.update(float(stats.kl), case["batch"]["input_ids"].shape[0])
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "kl_coef": kl_ctl.value,
            "trainable": jax.device_get(state.trainable)}


@pytest.fixture(scope="module")
@on_one_thread
def runs(tmp_path_factory):
    """The 4-rank job started first; the references meanwhile."""
    from vlrlhf_tpu.core import mesh as jmesh

    tmp = tmp_path_factory.mktemp("dist_sp_model")
    prev = jmesh._GLOBAL_MESH
    try:
        jcfg, jparams, lm_model, ids, pad = _gqa_lm()
        llava = _llava()
        model, lcfg = llava[4], llava[2]
        pairs = right_padded(llava[5], PAIR_LENS)
        sft = {k: np.asarray(v) for k, v in tiny_batch(jax.random.PRNGKey(5), n_pairs=2).items()}
        sft["pixel_values"] = np.concatenate([sft["pixel_values"]] * 2)
        sft = right_padded(sft, SFT_LENS)
        train = [
            _train_case("dpo/model4_tower", (1, 1, 4), _with_tower_lora(model), pairs,
                        lcfg.scale, lora_dropout=DROPOUT, dropout_seed=7, frozen_vision=False),
            _train_case("dpo/data2_model2", (2, 1, 2), model, pairs, lcfg.scale,
                        lora_dropout=DROPOUT, dropout_seed=7),
            _train_case("dpo/fsdp2_model2", (1, 2, 2), model, pairs, lcfg.scale),
            _train_case("sft/fsdp2_model2", (1, 2, 2), model, sft, lcfg.scale, step="sft"),
            _train_case("rm/fsdp2_model2", (1, 2, 2), model, pairs, lcfg.scale, step="rm"),
            _train_case("qwen/model4", (1, 1, 4), *_qwen_pair(), steps=1),
            _train_case("xc2/model4", (1, 1, 4), *_xc2_pair(), steps=1),
        ]
        train += [_train_case(f"remat/{policy}", (1, 2, 2), _remat(model, policy), pairs,
                              lcfg.scale, steps=1, lora_dropout=DROPOUT, dropout_seed=9)
                  for policy in REMAT]
        int8 = _int8(llava)
        lcfg4, model4, batch4 = _int4_model()
        train += [
            _train_case("int8/fsdp2_model2", (1, 2, 2), int8[4], pairs, lcfg.scale,
                        logits_chunk=16),
            _train_case("int4/data2_model2", (2, 1, 2), model4, batch4, lcfg4.scale,
                        logits_chunk=16),
        ]
        ppo = [_ppo_case(name, mesh, axis, model, lcfg.scale)
               for name, (mesh, axis, _) in PPO_LAYOUTS.items()]
        reward_path = _reward_dir(model, tmp / "rm_adapters")
        rollouts, _ = _rollout_batch()  # 37 positions: no split divides them
        rewards = [dict(name=f"reward/{name}", step="reward", mesh=mesh, sp=axis, model=model,
                        reward_path=reward_path, batch=rollouts)
                   for name, (mesh, axis, _) in PPO_LAYOUTS.items()]
        lms = [dict(name=name, step="sp_lm", sp="model", mesh=mesh, model=lm_model, ids=ids,
                    pad=pad) for name, mesh in LM_LAYOUTS.items()]
        job = Job([*lms, *train, *ppo, *rewards], 4, tmp / "w4", timeout=300)
        want = {name: _jax_lm_logits(jcfg, jparams, ids, pad, mesh)
                for name, mesh in LM_LAYOUTS.items()}
        dkw = dict(beta=0.1, lora_scale=lcfg.scale)
        want["jax/dpo"] = jax_dpo(
            dataclasses.replace(llava[0], lm=dataclasses.replace(
                llava[0].lm, sequence_parallel_axis="model")),
            llava[1], llava[3], pairs, (1, -1, 2), dkw)
        for name, (_, axis, jmesh_shape) in PPO_LAYOUTS.items():
            want[f"jax/{name}"] = jax_ppo(llava, ppo[0], axis, jmesh_shape)
    finally:
        jmesh._GLOBAL_MESH = prev
    want.update({c["name"]: train_world1(c) for c in train})
    want["ppo"] = ppo_world1(ppo[0])
    want["reward"] = reward_world1(model, reward_path, rollouts)
    got = job.result()
    return got, want, pad


@pytest.mark.parametrize("name", list(LM_LAYOUTS))
def test_lm_forward_under_the_model_split_matches_vlrlhf_tpu(runs, name):
    got, want, pad = runs
    np.testing.assert_allclose(got[name]["logits"][pad], want[name][pad], atol=LM_ATOL,
                               rtol=LM_RTOL)


TRAIN = ("dpo/model4_tower", "dpo/data2_model2", "dpo/fsdp2_model2", "sft/fsdp2_model2",
         "rm/fsdp2_model2", "qwen/model4", "xc2/model4",
         *(f"remat/{policy}" for policy in REMAT))


@pytest.mark.parametrize("name", TRAIN)
def test_model_split_steps_match_world1(runs, name):
    got, want, _ = runs
    g, w = got[name], want[name]
    assert len(g["metrics"]) == len(w["metrics"])
    for i, (gm, wm) in enumerate(zip(g["metrics"], w["metrics"])):
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], atol=TOL, rtol=TOL, err_msg=f"{i} {k}")
    for part in ("grads", "trainable"):
        assert g[part].keys() == w[part].keys()
        for k, wv in w[part].items():
            np.testing.assert_allclose(g[part][k], wv, atol=TOL * max(1.0, float(np.abs(wv).max())),
                                       rtol=TOL, err_msg=f"{part} {k}")
    if name.startswith("dpo"):  # the first step has every gradient non-zero but the
        # tower's last layer's (its feature layer, -2, is its first layer's output)
        assert all(np.abs(v).max() > 0 for k, v in w["grads"].items()
                   if not k.startswith("vision/layers/1/"))
    if name == "dpo/model4_tower":  # the tower's adapters, replicated over model, train
        tower = [k for k in w["grads"] if k.startswith("vision/")]
        assert len(tower) == 8 and sum(k.startswith("vision/layers/0/") for k in tower) == 4


def test_qlora_int8_under_the_model_split_matches_world1(runs):
    """int8 bases (W8A16) under the split: the row parts' scaled products
    reduce-scattered, at 1e-5."""
    got, want, _ = runs
    g, w = got["int8/fsdp2_model2"], want["int8/fsdp2_model2"]
    for i, (gm, wm) in enumerate(zip(g["metrics"], w["metrics"])):
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], atol=TOL, rtol=TOL, err_msg=f"{i} {k}")
    for k, wv in w["trainable"].items():
        np.testing.assert_allclose(g["trainable"][k], wv,
                                   atol=TOL * max(1.0, float(np.abs(wv).max())), rtol=TOL,
                                   err_msg=k)


def test_qlora_int4_under_the_model_split_matches_world1(runs):
    """int4 bases under the split (the row shards repacked, their products
    reduce-scattered) at tests/test_torch_qlora.py's int4 tolerances: each
    int4 linear rounds its input to bf16, so the slices' shapes move the
    roundings."""
    got, want, _ = runs
    g, w = got["int4/data2_model2"], want["int4/data2_model2"]
    for gm, wm in zip(g["metrics"], w["metrics"]):
        assert abs(gm["loss"] - wm["loss"]) <= INT4_LOSS, (gm["loss"], wm["loss"])
    assert g["trainable"].keys() == w["trainable"].keys()
    for k, p in w["trainable"].items():
        err = np.linalg.norm(g["trainable"][k] - p) / max(np.linalg.norm(p), 1e-12)
        assert err <= INT4_REL, (k, err)


def test_model_split_dpo_matches_vlrlhf_tpu(runs):
    got, want, _ = runs
    g, w = got["dpo/fsdp2_model2"], want["jax/dpo"]
    assert_metrics(g["metrics"], w[0], what="model split")
    assert_adapters(g["trainable"], w[1], what="model split")


@pytest.mark.parametrize("name", list(PPO_LAYOUTS))
def test_reward_model_scores_whole_sequences_under_the_split(runs, name):
    """ppo's reward model (cli.main reward_model_fn) scores whole
    sequences under either split, as the rollouts run (core.dist
    unsplit): a rollout of 37 positions, which no split of 4 divides,
    scores as world 1 scores it, and the split reads on again after."""
    got, want, _ = runs
    g = got[f"reward/{name}"]
    np.testing.assert_allclose(g["scores"], want["reward"], atol=TOL, rtol=TOL)
    assert g["split_after"] and np.abs(want["reward"]).max() > 0


@pytest.mark.parametrize("name", list(PPO_LAYOUTS))
def test_greedy_rollouts_under_the_split_match_world1(runs, name):
    got, want, _ = runs
    g, w = got[name], want["ppo"]
    for kind in ("static", "continuous"):
        for part in (0, 1):
            np.testing.assert_array_equal(g[kind][part], w[kind][part], err_msg=f"{name} {kind}")
    assert (w["static"][1] > 0).all()


@pytest.mark.parametrize("name", list(PPO_LAYOUTS))
def test_sampled_rollouts_agree_across_the_split(runs, name):
    got, want, _ = runs
    ranks = got[name]["sampled"]
    assert len(ranks) == 4 and all(r == ranks[0] for r in ranks)
    assert ranks[0] != want["ppo"]["static"][0].tolist()  # sampled, not greedy


@pytest.mark.parametrize("name", list(PPO_LAYOUTS))
def test_ppo_outer_step_under_the_split_matches_world1(runs, name):
    got, want, _ = runs
    g, w = got[name], want["ppo"]
    assert len(g["history"]) == len(w["history"]) == 4
    for i, (gm, wm) in enumerate(zip(g["history"], w["history"])):
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], atol=TOL, rtol=TOL, err_msg=f"{name} {i} {k}")
    for k in ("scores", "kl", "kl_coef", "moments"):
        np.testing.assert_allclose(g[k], w[k], atol=TOL, rtol=TOL, err_msg=f"{name} {k}")
    assert g["trainable"].keys() == w["trainable"].keys()
    for k, wv in w["trainable"].items():
        np.testing.assert_allclose(g["trainable"][k], wv,
                                   atol=TOL * max(1.0, float(np.abs(wv).max())), rtol=TOL,
                                   err_msg=f"{name} {k}")


@pytest.mark.parametrize("name", list(PPO_LAYOUTS))
def test_ppo_outer_step_under_the_split_matches_vlrlhf_tpu(runs, name):
    got, want, _ = runs
    g, w = got[name], want[f"jax/{name}"]
    assert set(g["history"][-1]) == set(w["metrics"])
    for k, v in w["metrics"].items():
        np.testing.assert_allclose(g["history"][-1][k], v, rtol=TOL, atol=TOL,
                                   err_msg=f"{name} {k}")
    np.testing.assert_allclose(g["kl_coef"], w["kl_coef"], rtol=TOL, atol=TOL)
    assert_adapters(g["trainable"], w["trainable"]["adapters"], what=name)
    v = np.asarray(w["trainable"]["v_head"]["kernel"])
    np.testing.assert_allclose(g["trainable"]["v_head/kernel"], v, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(v).max())))
    assert any(_KEY.match(k) for k in g["trainable"])
