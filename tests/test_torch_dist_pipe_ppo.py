"""ppo under the GPipe pipeline on the CPU (`--mesh_pipe`): one gloo
launch of 4 ranks (tests/torch_dist_worker.py) runs every case, f32,
while the references are computed in this process. Each rank holds its
stage's layers; the rollouts run on the whole stack, every stage's layers
joined for the block (core/partitioning.py whole_stack), and the stats
pass, the reference, the reward and the update through the schedule
(models/lm/pipeline.py). On the 4-layer tiny LLaVA of
tests/test_torch_dist_pipe.py (bridged weights, adapters' b offset 0.01)
at (data, fsdp, model, pipe):
  - greedy rollouts, static and continuous, at (1, 1, 1, 4), (1, 2, 1, 2)
    and (1, 1, 2, 2), token for token the single-process rollouts; at
    (1, 1, 1, 4) sampled rollouts whose four stage ranks draw from
    different seeds agree token for token (the first rank's tokens are
    broadcast over model x pipe each step); the decoder holds the whole
    stack inside the block and its stage's layers after it, the joined
    layers freed;
  - one outer step over a global batch of 8 rollouts (one with an empty
    response) with score scaling and the adaptive KL controller, 2 epochs
    x 2 minibatches, at each of those layouts (M = S, and M = 4 at
    (1, 1, 2, 2)): every update's metrics,
    the adapters, the value head, the score moments and the KL
    coefficient within 1e-5 of world 1 and of vlrlhf_tpu's
    preprocess_scores / make_ppo_fns / ppo_update_epochs with
    pipeline_stages 2 under MeshConfig(fsdp=4, pipe=2) on the 8 virtual
    devices (a 4-rank job holds no (1, 1, 1, 2) mesh);
  - a value set (--use_value_adapter) and tower LoRA (a leaf before the
    stack, summed over the stages) at (1, 1, 2, 2) against world 1; the
    leaves outside the stack hold the same bits on every stage;
  - QLoRA int4 at (2, 1, 1, 2) on the 256-wide LLaVA of
    tests/test_torch_dist_dpo.py at its int4 bounds (tokens exact, the
    first update's policy loss 5e-3, leaves 2e-2 relative);
  - the consensus skip through cli.main train_ppo at (1, 2, 1, 2): a
    stage-1 rank's reward raises at the first outer step and every rank
    logs ppo/skipped there;
  - the whole stack at (1, 1, 2, 2) on a model whose layers hold every
    kind of tensor (int8 and dense bases, the policy's LoRA, PLoRA, a
    value and a reward set): each layer's world-1 bits on every rank;
  - a ppo checkpoint (adapters, value set, value head, KL coefficient)
    written at (1, 2, 1, 2) after one outer step resumes at world 1, and a
    world-1 one at (1, 2, 1, 2), each taking the straight run's second
    step.
And `torchrun --nproc_per_node 2 -m vlrlhf_torch.cli.main ppo --mesh_fsdp
1 --mesh_pipe 2 --use_value_adapter true` logs the single-process run's
ppo_metrics.jsonl within 1e-5 and writes its adapters/ (every stage's
layers joined, the value set beside the policy's). Adam's eps is 1e-3, as in tests/test_torch_dpo.py, and the learning
rate 5e-4 (see OPT)."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dist_cli import CPU, PPO, finish, metrics, torchrun
from tests.test_torch_dist_cli import VALUE as VALUE_CLI
from tests.test_torch_dist_dpo import _KEY, _int4_model, assert_adapters
from tests.test_torch_dist_pipe import LORA_PATTERNS, _llava4, _with_tower_lora
from tests.test_torch_models import prompt_batch
from tests.torch_dist_worker import Job, greedy_rollouts, on_one_thread
from vlrlhf_torch.cli.main import main

TOL = 1e-5
INT4_LOSS, INT4_REL = 5e-3, 2e-2
# 5e-4: at tests/test_torch_dist_ppo.py's 5e-3 the four Adam updates take
# this 4-layer model's ratio to 3.5 with 92% of the tokens clipped, where
# the port's single-process step and vlrlhf_tpu's f32 roundings of the
# largest ratio part by 2e-5 already (the port's own pipeline holds 1e-5
# against its world 1 there)
OPT = dict(learning_rate=5e-4, warmup_steps=0, warmup_ratio=0.0, total_steps=50,
           weight_decay=0.01, eps=1e-3)
# (mesh, --pipeline_microbatches): M = S by default, M = 4 rows of one at
# (1, 1, 2, 2)
LAYOUTS = {"pipe4": ((1, 1, 1, 4), 0), "fsdp2_pipe2": ((1, 2, 1, 2), 0),
           "model2_pipe2": ((1, 1, 2, 2), 4)}
NEW_TOKENS = 5
SEED = 7
LENS = (30, 22, 26, 28, 24, 29, 21, 27)
VALUE = dict(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)


def _v_head(width: int):
    return (np.random.default_rng(2).normal(size=(width, 1)) * 0.1).astype(np.float32)


def _pcfg(scale, scaling=True):
    return dict(lora_scale=scale, init_kl_coef=0.05, ppo_epochs=2, minibatch_size=4,
                use_score_scaling=scaling)


def _prompts():
    ids, pad, plens, px, pos = prompt_batch(seed=5, lens=LENS[:4])
    return {"input_ids": ids, "pad_mask": pad, "prompt_lens": plens, "pixel_values": px,
            "image_positions": pos}


def _rollout_batch():
    """A global rollout batch of 8 image prompts with responses of lengths
    5, 0 (a first-token stop), 3, 7, 2, 6, 1 and 4, spliced by vlrlhf_tpu's
    rollout_to_batch, and raw scores."""
    from vlrlhf_tpu.train.ppo import rollout_to_batch

    ids, pad, plens, px, pos = prompt_batch(seed=9, lens=LENS)
    pb = {"input_ids": ids, "pad_mask": pad, "prompt_lens": plens, "pixel_values": px,
          "image_positions": pos}
    rng = np.random.default_rng(4)
    tokens = rng.integers(4, 100, (len(LENS), 8)).astype(np.int32)
    batch = rollout_to_batch(pb, tokens, 0, resp_lens=np.asarray((5, 0, 3, 7, 2, 6, 1, 4),
                                                                 np.int32))
    return batch, rng.normal(size=(len(LENS),)).astype(np.float32) * 3.0 + 1.0


def _case(name, mesh, model, scale, micro=0, sampled=False, scaling=True, seed=SEED,
          rollouts=True, **kw):
    batch, raw = _rollout_batch()
    return dict(name=name, step="ppo", mesh=mesh, micro=micro, model=model,
                v_head=_v_head(model.cfg.lm.hidden_size), ocfg=OPT, pcfg=_pcfg(scale, scaling),
                prompts=_prompts(), new_tokens=NEW_TOKENS, sampled=sampled, batch=batch, raw=raw,
                seed=seed, rollouts=rollouts, **kw)


def _every_kind_of_layer(model, tmp) -> tuple:
    """(the model with int8 attention bases beside dense MLP ones, the
    policy's LoRA and PLoRA; an rm run's adapters/ at `tmp` for the reward
    set, seeded and non-zero on the MLP linears)."""
    from vlrlhf_torch.lora.lora import init_plora_, match_lora_targets, module_path
    from vlrlhf_torch.ops.quant import quantize_params
    from vlrlhf_torch.train.checkpoint import save_params

    model = copy.deepcopy(model)
    quantize_params(model, (r"lm/.*attn/",), bits=8)
    init_plora_(model, 4, torch.Generator().manual_seed(12))
    g = torch.Generator().manual_seed(14)
    tree = {"rm_head/kernel": torch.randn((model.cfg.lm.hidden_size, 1), generator=g)}
    for name, mod in match_lora_targets(model, (r"lm/.*mlp/",)):
        key = f"adapters/{module_path(name)[: -len('/kernel')]}"
        tree[f"{key}/a"] = torch.randn((mod.d_in, 2), generator=g)
        tree[f"{key}/b"] = torch.randn((2, mod.d_out), generator=g)
    save_params(str(tmp), tree)
    return model, str(tmp)


def _layer_tensors(model, reward_path: str) -> dict:
    """world 1's counterpart of the worker's whole_stack case: the model
    given its value set (build_ppo's init_lora) and reward set (cli.main
    reward_model_fn), then every decoder layer's registered parameters and
    named sets' a and b (bf16 ones as f32, which holds them exactly)."""
    from vlrlhf_torch.cli.main import reward_model_fn
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.train.ppo import VALUE_SET

    model = copy.deepcopy(model)
    init_lora(model, LoraConfig(**VALUE), torch.Generator().manual_seed(13), adapter_set=VALUE_SET)
    reward_model_fn(model, reward_path, 0.5)
    out = {}
    for name, mod in model.lm.layers.named_modules(prefix="lm.layers"):
        for leaf, p in mod._parameters.items():
            if p is not None:
                out[f"{name}.{leaf}"] = p.detach()
        for set_name, pair in getattr(mod, "lora_sets", {}).items():
            for leaf, p in zip(("lora_a", "lora_b"), pair):
                out[f"{name}.{set_name}.{leaf}"] = p.detach()
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy() for k, v in out.items()}


def world1(case: dict, resume=None, save=None) -> dict:
    """The case in this process with no mesh: greedy static and continuous
    rollouts of the whole prompt batch (unless the case has none), then
    ppo_step on the global rollout (from the checkpoint manager `resume`'s
    latest step; saving the state after the step to `save`)."""
    from vlrlhf_torch.cli.main import PPORun, continuous_rollouts, ppo_step, static_rollouts
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora, lora_keys, lora_parameters
    from vlrlhf_torch.train.dpo import adapter_params
    from vlrlhf_torch.train.ppo import VALUE_SET, AdaptiveKLController, PPOConfig, RunningMoments
    from vlrlhf_torch.train.train_state import (
        OptimizerConfig, init_train_state, load_state_tree_, state_tree,
    )

    model = copy.deepcopy(case["model"])
    v_head = {"kernel": torch.nn.Parameter(torch.from_numpy(case["v_head"].copy()))}
    leaves = adapter_params(model) + [v_head["kernel"]]
    keys = [f"adapters/{k}" for k in lora_keys(model)] + ["v_head/kernel"]
    if case.get("value"):
        init_lora(model, LoraConfig(**case["value"]),
                  torch.Generator().manual_seed(case["value_seed"]), adapter_set=VALUE_SET)
        value = lora_parameters(model, VALUE_SET)
        with torch.no_grad():
            for name, p in value:
                if name.endswith("lora_b"):
                    p.add_(0.01)
        leaves += [p for _, p in value]
        keys += [f"value_adapters/{k}" for k in lora_keys(model, VALUE_SET)]
    pcfg, ocfg = PPOConfig(**case["pcfg"]), OptimizerConfig(**case["ocfg"])
    state = init_train_state(leaves, ocfg)
    run = PPORun(model=model, pcfg=pcfg, ocfg=ocfg, lcfg=None, state=state, keys=keys,
                 v_head=v_head, value_adapters=bool(case.get("value")), gen_cfg=None,
                 gen_collator=None, rows=[], reward_fn=None, flops_per_token=0.0,
                 flops_per_image=0.0)
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(pcfg)
    out = {}
    if resume is not None:
        tree, extra = resume.restore()
        load_state_tree_(state, keys, tree)
        kl_ctl.value = extra["kl_coef"]
    if case["rollouts"]:
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
    scores, kl, history = ppo_step(run, case["batch"], case["raw"], moments, kl_ctl, case["seed"])
    if save is not None:
        save.save(1, state_tree(state, keys), extra={"kl_coef": kl_ctl.value})
    out.update(scores=scores, kl=kl, history=history, kl_coef=kl_ctl.value,
               moments=(moments.mean, moments.var, moments.count),
               trainable={k: p.detach().numpy().copy() for k, p in zip(keys, state.trainable)})
    return out


def jax_outer_step(llava, case: dict) -> dict:
    """vlrlhf_tpu's outer step on the case's global rollout with the stack
    pipelined over 2 stages under MeshConfig(fsdp=4, pipe=2) (params and
    state by default_lm_rules, the batch on data x fsdp):
    preprocess_scores, the stats pass, ppo_update_epochs, the KL
    controller."""
    from jax.sharding import NamedSharding

    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh
    from vlrlhf_tpu.core.partitioning import (
        batch_spec, default_lm_rules, make_sharding, shard_pytree,
    )
    from vlrlhf_tpu.train.ppo import AdaptiveKLController, PPOConfig, RunningMoments
    from vlrlhf_tpu.train.ppo import make_ppo_fns, ppo_update_epochs, preprocess_scores
    from vlrlhf_tpu.train.train_state import OptimizerConfig, init_train_state, make_optimizer

    jcfg, params, _, adapters = llava[:4]
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, pipeline_stages=2))
    kw = case["pcfg"]
    trainable = jax.tree.map(jnp.array, {"adapters": adapters,
                                         "v_head": {"kernel": jnp.asarray(case["v_head"])}})
    tx = make_optimizer(OptimizerConfig(**OPT), trainable)
    mesh = make_mesh(MeshConfig(1, 4, 1, 2))
    rules = default_lm_rules()
    params = shard_pytree(rules, params, mesh)
    state = init_train_state(trainable, tx)
    state = jax.tree.map(jax.device_put, state, make_sharding(rules, state, mesh))
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, batch_spec()))
             for k, v in case["batch"].items()}
    stats_fn, update_fn = make_ppo_fns(jcfg, PPOConfig(**kw), tx)
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(PPOConfig(**kw))
    scores = preprocess_scores(case["raw"], PPOConfig(**kw), moments)
    stats = stats_fn(params, state.trainable, batch, jnp.asarray(scores),
                     jnp.asarray(kl_ctl.value))
    state, metrics = ppo_update_epochs(update_fn, state, params, batch, stats, PPOConfig(**kw),
                                       seed=case["seed"])
    kl_ctl.update(float(stats.kl), case["batch"]["input_ids"].shape[0])
    return {"scores": np.asarray(scores), "kl": float(stats.kl),
            "metrics": {k: float(v) for k, v in metrics.items()}, "kl_coef": kl_ctl.value,
            "moments": (moments.mean, moments.var, moments.count),
            "trainable": jax.device_get(state.trainable)}


@pytest.fixture(scope="module")
@on_one_thread
def runs(tmp_path_factory):
    """The 4-rank job and the CLI's torchrun run started together; the
    references meanwhile."""
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_tpu.core import mesh as jmesh

    tmp = tmp_path_factory.mktemp("dist_pipe_ppo")
    prev = jmesh._GLOBAL_MESH
    try:
        llava = _llava4()
        model, scale = llava[4], llava[2].scale
        lcfg4, model4, _ = _int4_model()
        cases = [_case(f"llava/{name}", shape, model, scale, micro=micro,
                       sampled=name == "pipe4") for name, (shape, micro) in LAYOUTS.items()]
        cases += [
            _case("value_tower/model2_pipe2", (1, 1, 2, 2), _with_tower_lora(model), scale,
                  rollouts=False, value=VALUE, value_seed=11),
            _case("int4/data2_pipe2", (2, 1, 1, 2), model4, lcfg4.scale),
            _case("save/fsdp2_pipe2", (1, 2, 1, 2), model, scale, scaling=False,
                  rollouts=False, save_dir=str(tmp / "ckpt_pipe"), value=VALUE, value_seed=11),
        ]
        # a world-1 checkpoint after one outer step, resumed under the pipeline
        w1_ckpt = CheckpointManager(str(tmp / "ckpt_world1"))
        straight = [world1(cases[-1], save=w1_ckpt)]
        w1_ckpt.close()
        second = _case("resumed/fsdp2_pipe2", (1, 2, 1, 2), model, scale, scaling=False,
                       seed=SEED + 1, rollouts=False, resume_dir=str(tmp / "ckpt_world1"),
                       value=VALUE, value_seed=11)
        skip = dict(name="skip", step="ppo_cli", fail_at=1, fail_rank=3, argv=[
            "ppo", *CPU, "--synthetic", "8", "--max_steps", "2", "--logging_steps", "1",
            "--lora_r", "4", "--max_length", "64", "--max_new_tokens", "3", "--lora_dropout",
            "0", "--ppo_epochs", "1", "--use_score_scaling", "true",
            "--per_device_train_batch_size", "2", "--mesh_fsdp", "-1", "--mesh_pipe", "2",
            "--output_dir", str(tmp / "skip")])
        kinds, reward_path = _every_kind_of_layer(model, tmp / "rm_adapters")
        joined = dict(name="whole_stack", step="whole_stack", mesh=(1, 1, 2, 2), model=kinds,
                      value=VALUE, value_seed=13, reward_path=reward_path)
        job = Job([*cases, second, skip, joined], 4, tmp / "w4", timeout=300)
        cli = torchrun([*PPO, *VALUE_CLI, "--output_dir", str(tmp / "ppo_pipe2"),
                        "--per_device_train_batch_size", "2", "--mesh_fsdp", "1",
                        "--mesh_pipe", "2"])
        want = {"jax": jax_outer_step(llava, cases[0])}
    finally:
        jmesh._GLOBAL_MESH = prev
    # the three llava layouts share one world-1 run (same model, batch, seed)
    want.update(dict.fromkeys([f"llava/{name}" for name in LAYOUTS], world1(cases[0])))
    want.update({c["name"]: world1(c) for c in cases[3:5]})
    straight.append(world1(second, resume=CheckpointManager(str(tmp / "ckpt_world1"))))
    want["straight"] = straight
    want["whole_stack"] = _layer_tensors(kinds, reward_path)
    with greedy_rollouts():
        main([*PPO, *VALUE_CLI, "--output_dir", str(tmp / "ppo1"),
              "--per_device_train_batch_size", "2"])
    done = finish(cli)
    got = job.result()
    got["resumed/world1"] = world1(second, resume=CheckpointManager(str(tmp / "ckpt_pipe")))
    return tmp, got, want, done


def _assert_step(g: dict, w: dict, what: str, tol: float = TOL) -> None:
    """Every update's metrics, the scores, KL, KL coefficient, moments and
    every trainable leaf."""
    assert len(g["history"]) == len(w["history"]) == 4
    for i, (gm, wm) in enumerate(zip(g["history"], w["history"])):
        assert gm.keys() == wm.keys()
        for k in wm:
            np.testing.assert_allclose(gm[k], wm[k], atol=tol, rtol=tol, err_msg=f"{what} {i} {k}")
    for k in ("scores", "kl", "kl_coef", "moments"):
        np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=tol, err_msg=f"{what} {k}")
    assert g["trainable"].keys() == w["trainable"].keys()
    for k, wv in w["trainable"].items():
        np.testing.assert_allclose(g["trainable"][k], wv,
                                   atol=tol * max(1.0, float(np.abs(wv).max())), rtol=tol,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_greedy_rollouts_on_the_whole_stack_match_world1(runs, layout):
    _, got, want, _ = runs
    g, w = got[f"llava/{layout}"], want[f"llava/{layout}"]
    for kind in ("static", "continuous"):
        for part in (0, 1):
            np.testing.assert_array_equal(g[kind][part], w[kind][part], err_msg=f"{layout} {kind}")
    assert (w["static"][1] > 0).all()
    stages = LAYOUTS[layout][0][3]
    # the stage's layers, the whole stack inside the block, the stage's after it
    assert g["layers"] == [4 // stages, 4, 4 // stages]
    assert g["joined_alive"] == 0 and stages > 1  # the joined layers are freed after it


def test_whole_stack_joins_every_tensor_a_layer_holds(runs):
    """Inside the block every rank holds each of the 4 layers with the
    world-1 bits of each tensor (int8 codes and scales, dense weights, the
    policy's LoRA, PLoRA, the value and reward sets), gathered here over the
    tensor-parallel pair at (1, 1, 2, 2); the stage's 2 layers before and
    after it."""
    _, got, want, _ = runs
    g, w = got["whole_stack"], want["whole_stack"]
    assert g["layers"] == [2, 4, 2]
    assert g["tensors"].keys() == w.keys()
    kinds = {k.split(".", 3)[3] for k in w}  # "wq.weight_q", "up.reward.lora_b", ...
    assert {"wq.weight_q", "wq.weight_scale", "up.weight", "wq.plora_a", "wq.lora_a",
            "wq.value.lora_a", "up.reward.lora_b", "input_layernorm.weight"} <= kinds
    for k, v in w.items():
        np.testing.assert_array_equal(g["tensors"][k], v, err_msg=k)


def test_sampled_rollouts_agree_across_the_stages(runs):
    _, got, want, _ = runs
    ranks = got["llava/pipe4"]["sampled"]
    assert len(ranks) == 4 and all(r == ranks[0] for r in ranks)
    assert ranks[0] != want["llava/pipe4"]["static"][0].tolist()  # sampled, not greedy


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_outer_step_through_the_pipeline_matches_world1(runs, layout):
    _, got, want, _ = runs
    _assert_step(got[f"llava/{layout}"], want[f"llava/{layout}"], layout)
    assert got[f"llava/{layout}"]["stages_equal"] == {"v_head/kernel": True}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_outer_step_through_the_pipeline_matches_vlrlhf_tpu(runs, layout):
    _, got, want, _ = runs
    g, w = got[f"llava/{layout}"], want["jax"]
    for k in ("scores", "kl", "kl_coef", "moments"):
        np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=TOL, err_msg=f"{layout} {k}")
    assert set(g["history"][-1]) == set(w["metrics"])
    for k, v in w["metrics"].items():
        np.testing.assert_allclose(g["history"][-1][k], v, rtol=TOL, atol=TOL,
                                   err_msg=f"{layout} {k}")
    assert_adapters(g["trainable"], w["trainable"]["adapters"], what=layout)
    v = np.asarray(w["trainable"]["v_head"]["kernel"])
    np.testing.assert_allclose(g["trainable"]["v_head/kernel"], v, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(v).max())))
    assert {int(_KEY.match(k).group(2)) for k in g["trainable"] if _KEY.match(k)} == {0, 1, 2, 3}


def test_value_set_and_tower_lora_under_the_pipeline_match_world1(runs):
    """The value set's leaves (a stage's, like the policy's) and the
    tower's adapters (before the stack: only stage 0 backpropagates into
    them, the optimizer sums them over the stages) after the step."""
    _, got, want, _ = runs
    g, w = got["value_tower/model2_pipe2"], want["value_tower/model2_pipe2"]
    _assert_step(g, w, "value_tower")
    value = [k for k in w["trainable"] if k.startswith("value_adapters/lm/layers/")]
    assert {int(k.split("/")[3]) for k in value} == {0, 1, 2, 3}
    tower = [k for k in g["stages_equal"] if "/vision/" in k]
    assert len(tower) == 8 and all(g["stages_equal"].values()), g["stages_equal"]


def test_qlora_int4_under_the_pipeline_matches_world1(runs):
    _, got, want, _ = runs
    g, w = got["int4/data2_pipe2"], want["int4/data2_pipe2"]
    for kind in ("static", "continuous"):
        np.testing.assert_array_equal(g[kind][0], w[kind][0], err_msg=kind)
    loss = [h["ppo/loss/policy"] for h in (g["history"][0], w["history"][0])]
    assert abs(loss[0] - loss[1]) <= INT4_LOSS, loss
    assert g["trainable"].keys() == w["trainable"].keys()
    for k, p in w["trainable"].items():
        err = np.linalg.norm(g["trainable"][k] - p) / max(np.linalg.norm(p), 1e-12)
        assert err <= INT4_REL, (k, err)


def test_consensus_skip_takes_a_later_stages_failed_reward(runs):
    """Rank 3 (stage 1) raises in its reward at the first outer step: every
    rank skips it, and step 2 runs."""
    _, got, _, _ = runs
    g = got["skip"]
    assert g["lines"][0] == {"step": 1, "ppo/skipped": 1.0}
    assert g["lines"][1]["step"] == 2 and "ppo/loss/total" in g["lines"][1]
    assert list(g["moments"]) == [2]


@pytest.mark.parametrize("where", ["world1", "fsdp2_pipe2"])
def test_ppo_checkpoints_cross_the_pipeline_both_ways(runs, where):
    """The checkpoint saved under the pipeline resumes at world 1, and the
    world-1 one under the pipeline; each takes the straight run's second
    outer step (the KL coefficient from the checkpoint's extra)."""
    _, got, want, _ = runs
    first, second = want["straight"]
    assert any(k.startswith("value_adapters/lm/layers/3/") for k in first["trainable"])
    _assert_step(got["save/fsdp2_pipe2"], first, "first")
    _assert_step(got[f"resumed/{where}"], second, where)
    assert second["kl_coef"] != first["kl_coef"]  # the coefficient came through the checkpoint


def test_torchrun_ppo_under_the_pipeline_logs_the_single_process_metrics(runs):
    tmp, _, _, (rc, out) = runs
    assert rc == 0, out[-3000:]
    one, two = (metrics(tmp / d / "ppo_metrics.jsonl") for d in ("ppo1", "ppo_pipe2"))
    assert [r["step"] for r in two] == [r["step"] for r in one] == [1, 2]
    for a, b in zip(one, two):
        keys = {k for k in a if not k.startswith("perf/")} - {"ppo/rollout_tok_s", "step"}
        assert keys == {k for k in b if not k.startswith("perf/")} - {"ppo/rollout_tok_s",
                                                                        "step"}
        assert "ppo/kl_coef" in keys
        for k in keys:
            np.testing.assert_allclose(b[k], a[k], atol=TOL, rtol=TOL, err_msg=f"{a['step']} {k}")
    from vlrlhf_torch.train.checkpoint import load_params

    w, g = (load_params(str(tmp / d / "adapters")) for d in ("ppo1", "ppo_pipe2"))
    assert list(g) == list(w) and any(k.startswith("value_adapters/") for k in w)
    for k, v in w.items():
        np.testing.assert_allclose(g[k].numpy(), v.numpy(), atol=TOL, rtol=TOL, err_msg=k)
