"""The PPO stats pass and update of the Qwen-VL and InternLM-XC2 families in
vlrlhf_torch against vlrlhf_tpu's make_ppo_fns / ppo_update_epochs, f32
on the CPU, on the scaled-down family configs with bridged weights and
non-zero adapters (XC2 with its PLoRA tree, applied at the image positions
in the policy, value and reference forwards of both packages): image
prompts from the port's processor and GenerationCollator, responses of
lengths 4, 0 and 6 spliced by vlrlhf_tpu's rollout_to_batch; logprobs,
values, returns and KL at 1e-5, the update's metrics over 2 epochs x 2
minibatches at 1e-5 and the adapters and value head after them at 1e-4
(tests/test_torch_ppo.py's tolerances)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dpo import _assert_trees
from tests.test_torch_families import family_port
from tests.test_torch_ppo import ADV_TOL, KL_COEF, OPT, PARAM_TOL, TOL, _stats_fns
from tests.test_torch_qwen_xc2_train import FAMILIES, collate, processor
from vlrlhf_torch.train import ppo as tp
from vlrlhf_torch.train.dpo import adapter_params, batch_to_device
from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state
from vlrlhf_torch.utils.bridge import lora_tree


def _rollout_batch(family, jcfg):
    from vlrlhf_tpu.train.ppo import rollout_to_batch

    proc = processor(family, jcfg)
    prompts = collate("GenerationCollator", proc, [
        proc.generation_row(q, img) for q, img in (("What is in the photo?", "a.jpg"),
                                                   ("Describe it in detail please.", "b.jpg"),
                                                   ("Is there a dog?", "c.jpg"))])
    rng = np.random.default_rng(4)
    tokens = rng.integers(16, 240, (3, 8)).astype(np.int32)
    batch = rollout_to_batch(prompts, tokens, 0, resp_lens=np.asarray((4, 0, 6), np.int32))
    return {k: np.asarray(v) for k, v in batch.items()}, rng.normal(size=(3,)).astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_ppo_stats_and_update_match_jax(family):
    from vlrlhf_tpu.train.ppo import PPOConfig as JPPO
    from vlrlhf_tpu.train.ppo import ppo_update_epochs
    from vlrlhf_tpu.train.train_state import init_train_state as jinit

    jcfg, params, model, lcfg, adapters = family_port(family, seed=11, lora=True)
    batch, scores = _rollout_batch(family, jcfg)
    kernel = (np.random.default_rng(2).normal(size=(32, 1)) * 0.1).astype(np.float32)
    jv = {"kernel": jnp.asarray(kernel), "bias": jnp.asarray([0.3], jnp.float32)}
    tv = {"kernel": torch.nn.Parameter(torch.from_numpy(kernel.copy())),
          "bias": torch.nn.Parameter(torch.tensor([0.3]))}
    trainable = {"adapters": adapters, "v_head": jv}
    kw = dict(lora_scale=lcfg.scale, ppo_epochs=2, minibatch_size=2)
    stats_fn, update_fn, tx = _stats_fns(jcfg, kw, trainable)
    jstats = stats_fn(params, trainable, batch, jnp.asarray(scores), jnp.asarray(KL_COEF))
    pcfg, ocfg = tp.PPOConfig(**kw), OptimizerConfig(**OPT)
    tb = batch_to_device(batch, "cpu")
    stats = tp.compute_rollout_stats(model, pcfg, tv, tb, torch.from_numpy(scores), KL_COEF)
    assert float(stats.response_mask[1].sum()) == 0.0
    for name in ("logprobs", "ref_logprobs", "values", "returns", "response_mask", "kl"):
        np.testing.assert_allclose(getattr(stats, name).numpy(),
                                   np.asarray(getattr(jstats, name)), rtol=TOL, atol=TOL,
                                   err_msg=name)
    np.testing.assert_allclose(stats.advantages.numpy(), np.asarray(jstats.advantages),
                               rtol=ADV_TOL, atol=ADV_TOL)
    jstate, jm = ppo_update_epochs(update_fn, jinit(trainable, tx), params, batch, jstats,
                                   JPPO(**kw), seed=3)
    state = init_train_state(adapter_params(model) + [tv[k] for k in sorted(tv)], ocfg)
    tm = tp.ppo_update_epochs(lambda b, s: tp.ppo_update(model, pcfg, ocfg, state, tv, b, s),
                              tb, stats, pcfg, seed=3)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL, atol=TOL, err_msg=k)
    jt = jax.device_get(jstate.trainable)
    _assert_trees(lora_tree(model), jt["adapters"], PARAM_TOL, PARAM_TOL, "adapter")
    for k in tv:
        np.testing.assert_allclose(tv[k].detach().numpy(), jt["v_head"][k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)
