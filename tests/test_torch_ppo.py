"""The PPO slice: vlrlhf_torch's train/ppo.py against vlrlhf_tpu's (its
jitted make_ppo_fns, CPU, f32) on the tiny LLaVA of tests/test_dpo_step.py
with bridged weights and adapters: the stats pass (with an empty response
row), the multi-epoch minibatched update on the same permutation (the
value-adapter update under a recomputing remat policy in
tests/test_torch_ppo_value.py; the rollouts, the first-update invariants
and the host-side pieces in tests/test_torch_ppo_rollouts.py).
Tolerances: logps, values, returns, KL and losses 1e-5; whitened
advantages and parameters after updates 1e-4 (Adam's eps at 1e-3, as in
tests/test_torch_dpo.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dpo import _assert_trees
from tests.test_torch_models import prompt_batch
from tests.test_torch_sft_rm import _setup
from vlrlhf_torch.lora.lora import lora_parameters
from vlrlhf_torch.train import ppo as tp
from vlrlhf_torch.train.dpo import adapter_params, batch_to_device
from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state
from vlrlhf_torch.utils.bridge import load_lora_params, lora_tree

TOL = 1e-5
ADV_TOL = PARAM_TOL = 1e-4
OPT = dict(learning_rate=5e-3, warmup_steps=1, total_steps=50, weight_decay=0.01, eps=1e-3)
KL_COEF = 0.05


def _rollout_batch(b=4):
    """A rollout batch of image prompts with responses of lengths 5, 0 (a
    first-token stop), 3 and 7, spliced by vlrlhf_tpu's rollout_to_batch."""
    from vlrlhf_tpu.train.ppo import rollout_to_batch

    lens = (30, 22, 26, 28)[:b]
    ids, pad, plens, px, pos = prompt_batch(seed=9, lens=lens)
    pb = {"input_ids": ids, "pad_mask": pad, "prompt_lens": plens, "pixel_values": px,
          "image_positions": pos}
    rng = np.random.default_rng(4)
    tokens = rng.integers(4, 100, (b, 8)).astype(np.int32)
    resp_lens = np.asarray((5, 0, 3, 7)[:b], np.int32)
    batch = rollout_to_batch(pb, tokens, 0, resp_lens=resp_lens)
    scores = rng.normal(size=(b,)).astype(np.float32)
    return batch, scores


def _heads(bias: bool):
    """Non-zero value heads (JAX tree, port dict of parameters)."""
    rng = np.random.default_rng(2)
    kernel = (rng.normal(size=(32, 1)) * 0.1).astype(np.float32)
    jv = {"kernel": jnp.asarray(kernel)}
    tv = {"kernel": torch.nn.Parameter(torch.from_numpy(kernel.copy()))}
    if bias:
        jv["bias"] = jnp.asarray([0.3], jnp.float32)
        tv["bias"] = torch.nn.Parameter(torch.tensor([0.3]))
    return jv, tv


def _value_adapters(model, adapters):
    """A second, non-zero adapter set: vlrlhf_tpu's for the trainable tree
    and the port's VALUE_SET, bridged from it."""
    va = jax.tree.map(lambda x: x * 0.5 + 0.02, adapters)
    load_lora_params(model, jax.device_get(va), adapter_set=tp.VALUE_SET)
    return va


def _stats_fns(jcfg, pcfg_kw, trainable):
    from vlrlhf_tpu.train.ppo import PPOConfig as JPPO
    from vlrlhf_tpu.train.ppo import make_ppo_fns
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import make_optimizer

    tx = make_optimizer(JOpt(**OPT), trainable)
    return (*make_ppo_fns(jcfg, JPPO(**pcfg_kw), tx), tx)


@pytest.mark.parametrize("bias,logits_chunk", [(False, 0), (True, 16)])
def test_rollout_stats_match_jax(bias, logits_chunk):
    jcfg, params, lcfg, adapters, model = _setup()
    batch, scores = _rollout_batch()
    jv, tv = _heads(bias)
    kw = dict(lora_scale=lcfg.scale, logits_chunk=logits_chunk)
    stats_fn, _, _ = _stats_fns(jcfg, kw, {"adapters": adapters, "v_head": jv})
    want = stats_fn(params, {"adapters": adapters, "v_head": jv}, batch, jnp.asarray(scores),
                    jnp.asarray(KL_COEF))
    got = tp.compute_rollout_stats(model, tp.PPOConfig(**kw), tv, batch_to_device(batch, "cpu"),
                                   torch.from_numpy(scores), KL_COEF)
    assert float(got.response_mask[1].sum()) == 0.0  # the empty response
    for name in ("logprobs", "ref_logprobs", "values", "returns", "response_mask", "kl"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=TOL, atol=TOL, err_msg=name)
    np.testing.assert_allclose(got.advantages.numpy(), np.asarray(want.advantages), rtol=ADV_TOL,
                               atol=ADV_TOL)
    assert not np.allclose(np.asarray(want.logprobs), np.asarray(want.ref_logprobs))


def _port_state(model, tv, value_adapters: bool):
    leaves = adapter_params(model) + [tv[k] for k in sorted(tv)]
    if value_adapters:
        leaves += [p for _, p in lora_parameters(model, tp.VALUE_SET)]
    return init_train_state(leaves, OptimizerConfig(**OPT))


def _full_remat(model):
    model.cfg = dataclasses.replace(model.cfg, lm=dataclasses.replace(
        model.cfg.lm, remat=True, remat_policy="full"))
    model.lm.cfg = model.cfg.lm
    return model


def test_update_epochs_match_jax():
    check_update_epochs(value_adapters=False)


def check_update_epochs(value_adapters: bool):
    """2 epochs x 2 minibatches of 2 rows, shuffled by the same seeded
    permutation, against vlrlhf_tpu's ppo_update_epochs; with value
    adapters the port runs 'full' remat, so each layer is recomputed in the
    backward under the set its forward used."""
    from vlrlhf_tpu.train.ppo import PPOConfig as JPPO
    from vlrlhf_tpu.train.ppo import ppo_update_epochs
    from vlrlhf_tpu.train.train_state import init_train_state as jinit

    jcfg, params, lcfg, adapters, model = _setup()
    batch, scores = _rollout_batch()
    jv, tv = _heads(True)
    trainable = {"adapters": adapters, "v_head": jv}
    if value_adapters:
        trainable["value_adapters"] = _value_adapters(model, adapters)
        _full_remat(model)
    kw = dict(lora_scale=lcfg.scale, ppo_epochs=2, minibatch_size=2)
    stats_fn, update_fn, tx = _stats_fns(jcfg, kw, trainable)
    jstats = stats_fn(params, trainable, batch, jnp.asarray(scores), jnp.asarray(KL_COEF))
    jstate, jm = ppo_update_epochs(update_fn, jinit(trainable, tx), params, batch, jstats,
                                   JPPO(**kw), seed=3)
    pcfg, ocfg = tp.PPOConfig(**kw), OptimizerConfig(**OPT)
    state = _port_state(model, tv, value_adapters)
    tb = batch_to_device(batch, "cpu")
    stats = tp.compute_rollout_stats(model, pcfg, tv, tb, torch.from_numpy(scores), KL_COEF,
                                     value_adapters)
    history: list = []
    tm = tp.ppo_update_epochs(
        lambda b, s: tp.ppo_update(model, pcfg, ocfg, state, tv, b, s, value_adapters),
        tb, stats, pcfg, seed=3, history=history)
    assert len(history) == 4 and state.step == 4
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, atol=TOL, err_msg=k)
    jt = jax.device_get(jstate.trainable)
    _assert_trees(lora_tree(model), jt["adapters"], PARAM_TOL, PARAM_TOL, "adapter")
    for k in tv:
        np.testing.assert_allclose(tv[k].detach().numpy(), jt["v_head"][k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)
    if value_adapters:
        _assert_trees(lora_tree(model, adapter_set=tp.VALUE_SET), jt["value_adapters"],
                      PARAM_TOL, PARAM_TOL, "value adapter")
