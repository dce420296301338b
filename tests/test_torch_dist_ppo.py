"""Multi-GPU PPO on the CPU: cli.main's rollouts and `ppo_step` on gloo
ranks under a (data, fsdp, model) mesh against vlrlhf_tpu's PPO and the
single-process port, f32, on the tiny LLaVA of tests/test_dpo_step.py
with bridged weights and non-zero adapters:
  - greedy rollouts, static and continuous, each data-parallel rank on its
    rows of the global prompt batch from the gathered FSDP2 units, token
    for token the single-process rollouts, at fsdp = 2, data = 2 and
    model = 2;
  - sampled rollouts under model = 2 whose two ranks draw from different
    generator seeds agree token for token (the group's first rank's
    tokens are broadcast each step);
  - one outer step with score scaling and the adaptive KL controller, 2
    epochs x 2 minibatches over a global batch of 4 rollouts (one with an
    empty response): every update's metrics, the adapters and value head
    after the step, the score moments and the KL coefficient within 1e-5
    of vlrlhf_tpu's preprocess_scores, make_ppo_fns, ppo_update_epochs and
    AdaptiveKLController on the same global batch and weights (Adam's eps
    at 1e-3, as tests/test_torch_dpo.py has it), at each layout;
  - the consensus skip through train_ppo: rank 1's reward raises at the
    first outer step, both ranks log ppo/skipped there, and the score
    moments of the next step hold that step's rows only;
  - QLoRA int4 under model = 2 (row-parallel linears repacked per shard) on
    a 256-wide LLaVA against the single-process port: greedy tokens exact,
    the first update's policy loss within 5e-3, adapters within 2e-2
    relative (tests/test_torch_qlora.py's int4 tolerances).
One job of 2 ranks runs every case (tests/torch_dist_worker.py); the
references are computed while it runs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dist_dpo import _KEY, _int4_model, assert_adapters
from tests.test_torch_models import prompt_batch
from tests.test_torch_ppo import _rollout_batch
from tests.test_torch_sft_rm import _setup
from tests.torch_dist_worker import Job, on_one_thread

TOL = 1e-5
INT4_LOSS, INT4_REL = 5e-3, 2e-2
OPT = dict(learning_rate=5e-3, warmup_steps=0, warmup_ratio=0.0, total_steps=50,
           weight_decay=0.01, eps=1e-3)
MESHES = {"fsdp2": (1, 2, 1), "data2": (2, 1, 1), "model2": (1, 1, 2)}
NEW_TOKENS = 5
SEED = 7


def _v_head(width: int = 32):
    return (np.random.default_rng(2).normal(size=(width, 1)) * 0.1).astype(np.float32)


def _pcfg(lcfg):
    return dict(lora_scale=lcfg.scale, init_kl_coef=0.05, ppo_epochs=2, minibatch_size=2,
                use_score_scaling=True)


def _prompts():
    ids, pad, plens, px, pos = prompt_batch(seed=5, lens=(30, 22, 26, 28))
    return {"input_ids": ids, "pad_mask": pad, "prompt_lens": plens, "pixel_values": px,
            "image_positions": pos}


def _case(name, mesh, model, lcfg, sampled=False):
    batch, raw = _rollout_batch()
    return dict(name=name, step="ppo", mesh=mesh, model=model,
                v_head=_v_head(model.cfg.lm.hidden_size), ocfg=OPT,
                pcfg=_pcfg(lcfg), prompts=_prompts(), new_tokens=NEW_TOKENS, sampled=sampled,
                batch=batch, raw=raw * 3.0 + 1.0, seed=SEED)


def jax_outer_step(jcfg, params, adapters, lcfg):
    """vlrlhf_tpu's outer step on the global rollout: preprocess_scores,
    the stats pass, ppo_update_epochs, the KL controller."""
    from vlrlhf_tpu.train.ppo import AdaptiveKLController, PPOConfig, RunningMoments
    from vlrlhf_tpu.train.ppo import make_ppo_fns, ppo_update_epochs, preprocess_scores
    from vlrlhf_tpu.train.train_state import OptimizerConfig, init_train_state, make_optimizer

    batch, raw = _rollout_batch()
    kw = _pcfg(lcfg)
    trainable = {"adapters": adapters, "v_head": {"kernel": jnp.asarray(_v_head())}}
    tx = make_optimizer(OptimizerConfig(**OPT), trainable)
    stats_fn, update_fn = make_ppo_fns(jcfg, PPOConfig(**kw), tx)
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(PPOConfig(**kw))
    scores = preprocess_scores(raw * 3.0 + 1.0, PPOConfig(**kw), moments)
    stats = stats_fn(params, trainable, batch, jnp.asarray(scores), jnp.asarray(kl_ctl.value))
    state, metrics = ppo_update_epochs(update_fn, init_train_state(trainable, tx), params, batch,
                                       stats, PPOConfig(**kw), seed=SEED)
    kl_ctl.update(float(stats.kl), batch["input_ids"].shape[0])
    return {"scores": np.asarray(scores), "kl": float(stats.kl), "metrics": metrics,
            "kl_coef": kl_ctl.value, "moments": (moments.mean, moments.var, moments.count),
            "trainable": jax.device_get(state.trainable)}


def world1(model, prompts, pcfg_kw):
    """The single-process port: greedy static and continuous rollouts of
    the whole prompt batch, then ppo_step on the global rollout."""
    from vlrlhf_torch.cli.main import PPORun, continuous_rollouts, ppo_step, static_rollouts
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.dpo import adapter_params
    from vlrlhf_torch.train.ppo import AdaptiveKLController, PPOConfig, RunningMoments
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    v_head = {"kernel": torch.nn.Parameter(torch.from_numpy(_v_head(model.cfg.lm.hidden_size)))}
    pcfg, ocfg = PPOConfig(**pcfg_kw), OptimizerConfig(**OPT)
    state = init_train_state(adapter_params(model) + [v_head["kernel"]], ocfg)
    keys = [f"adapters/{k}" for k in lora_keys(model)] + ["v_head/kernel"]
    run = PPORun(model=model, pcfg=pcfg, ocfg=ocfg, lcfg=None, state=state, keys=keys,
                 v_head=v_head, value_adapters=False, gen_cfg=None, gen_collator=None, rows=[],
                 reward_fn=None, flops_per_token=0.0, flops_per_image=0.0)
    gcfg = GenerateConfig(max_new_tokens=NEW_TOKENS, pad_token_id=0)
    gen = Generator(model, gcfg, lora_scale=pcfg.lora_scale)
    gen.adapters = True
    n = prompts["input_ids"].shape[0]
    out = {"static": static_rollouts(gen, prompts, 1, None),
           "continuous": continuous_rollouts(
               ContinuousEngine(model, gcfg, n_slots=1, cache_len=128, adapters=True,
                                lora_scale=pcfg.lora_scale, emit_stop_token=True),
               prompts, [{"img_path": "x"}] * n, None, NEW_TOKENS, 0)}
    batch, raw = _rollout_batch()
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(pcfg)
    scores, kl, history = ppo_step(run, batch, raw * 3.0 + 1.0, moments, kl_ctl, SEED)
    out.update(history=history, trainable=dict(zip(keys, state.trainable)))
    return out


@pytest.fixture(scope="module")
@on_one_thread
def runs(tmp_path_factory):
    """The job started, then the references computed while it runs."""
    tmp = tmp_path_factory.mktemp("dist_ppo")
    jcfg, params, lcfg, adapters, model = _setup()
    lcfg4, model4, _ = _int4_model()
    cli = ["ppo", "--device", "cpu", "--bf16", "false", "--synthetic", "8", "--max_steps", "2",
           "--logging_steps", "1", "--lora_r", "4", "--max_length", "64", "--max_new_tokens",
           "3", "--lora_dropout", "0", "--ppo_epochs", "1", "--use_score_scaling", "true",
           "--per_device_train_batch_size", "1", "--mesh_fsdp", "-1", "--output_dir",
           str(tmp / "skip")]
    cases = [_case(f"llava/{m}", shape, model, lcfg, sampled=m == "model2")
             for m, shape in MESHES.items()]
    cases.append(_case("int4/model2", (1, 1, 2), model4, lcfg4))
    cases.append(dict(name="skip", step="ppo_cli", argv=cli, fail_at=1, fail_rank=1))
    job = Job(cases, 2, tmp / "w2")
    want = jax_outer_step(jcfg, params, adapters, lcfg)
    plain = world1(model, _prompts(), _pcfg(lcfg))
    plain4 = world1(model4, _prompts(), _pcfg(lcfg4))
    return job.result(), want, plain, plain4


@pytest.mark.parametrize("mesh", list(MESHES))
def test_greedy_rollouts_match_world1(runs, mesh):
    got, _, plain, _ = runs
    g = got[f"llava/{mesh}"]
    for kind in ("static", "continuous"):
        np.testing.assert_array_equal(g[kind][0], plain[kind][0], err_msg=f"{mesh} {kind}")
        np.testing.assert_array_equal(g[kind][1], plain[kind][1], err_msg=f"{mesh} {kind}")
    assert (plain["static"][1] > 0).all()


def test_sampled_rollouts_agree_across_the_model_group(runs):
    got, _, plain, _ = runs
    rank0, rank1 = got["llava/model2"]["sampled"]
    assert rank0 == rank1
    assert rank0 != plain["static"][0].tolist()  # sampled, not the greedy tokens


@pytest.mark.parametrize("mesh", list(MESHES))
def test_outer_step_matches_jax(runs, mesh):
    got, want, _, _ = runs
    g = got[f"llava/{mesh}"]
    np.testing.assert_allclose(g["scores"], want["scores"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g["kl"], want["kl"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g["kl_coef"], want["kl_coef"], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(g["moments"], want["moments"], rtol=TOL, atol=TOL)
    assert len(g["history"]) == 4 and set(g["history"][-1]) == set(want["metrics"])
    for k, v in want["metrics"].items():
        np.testing.assert_allclose(g["history"][-1][k], float(v), rtol=TOL, atol=TOL,
                                   err_msg=f"{mesh} {k}")
    assert_adapters(g["trainable"], want["trainable"]["adapters"], what=mesh)
    v = np.asarray(want["trainable"]["v_head"]["kernel"])
    np.testing.assert_allclose(g["trainable"]["v_head/kernel"], v, rtol=TOL,
                               atol=TOL * max(1.0, float(np.abs(v).max())))
    assert any(_KEY.match(k) for k in g["trainable"])


def test_consensus_skip_leaves_the_moments_untouched(runs):
    got, _, _, _ = runs
    g = got["skip"]
    assert g["lines"][0] == {"step": 1, "ppo/skipped": 1.0}
    assert g["lines"][1]["step"] == 2 and "ppo/loss/total" in g["lines"][1]
    # step 2's two global rows are all the moments ever saw
    assert list(g["moments"]) == [2] and g["moments"][2][2] == pytest.approx(2.0)


def test_qlora_int4_under_model2_matches_world1(runs):
    got, _, _, plain = runs
    g = got["int4/model2"]
    for kind in ("static", "continuous"):
        np.testing.assert_array_equal(g[kind][0], plain[kind][0], err_msg=kind)
    loss = [h["ppo/loss/policy"] for h in (g["history"][0], plain["history"][0])]
    assert abs(loss[0] - loss[1]) <= INT4_LOSS, loss
    for k, p in plain["trainable"].items():
        if not k.startswith("adapters/"):
            continue
        w = p.detach().numpy()
        err = np.linalg.norm(g["trainable"][k] - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= INT4_REL, (k, err)
