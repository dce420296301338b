"""PPO with --use_value_adapter: the value function on its own LoRA set
(the named set VALUE_SET), its trunk pass under a recomputing remat policy
('full'), against vlrlhf_tpu's trainable {"adapters", "v_head",
"value_adapters"} (CPU, f32, bridged weights): one update's gradients
(rtol 1e-4) and the 2-epoch x 2-minibatch update's parameters (1e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_dpo import _assert_trees, _capture_grads
from tests.test_torch_ppo import (
    KL_COEF, OPT, PARAM_TOL, _full_remat, _heads, _port_state, _rollout_batch, _value_adapters,
    check_update_epochs,
)
from tests.test_torch_sft_rm import _setup
from vlrlhf_torch.train import ppo as tp
from vlrlhf_torch.train.dpo import batch_to_device
from vlrlhf_torch.train.train_state import OptimizerConfig
from vlrlhf_torch.utils.bridge import lora_tree


def test_update_epochs_with_value_adapters_under_full_remat_match_jax():
    check_update_epochs(value_adapters=True)


def test_value_adapter_gradients_under_full_remat_match_jax():
    """One update's gradients with a separate value set, the port under
    'full' remat: the value set's gradients come only from the value pass,
    the policy set's only from the logps, as in vlrlhf_tpu."""
    from vlrlhf_tpu.train.ppo import PPOConfig as JPPO
    from vlrlhf_tpu.train.ppo import make_ppo_fns
    from vlrlhf_tpu.train.train_state import init_train_state as jinit

    jcfg, params, lcfg, adapters, model = _setup()
    batch, scores = _rollout_batch()
    jv, tv = _heads(False)
    trainable = {"adapters": adapters, "v_head": jv,
                 "value_adapters": _value_adapters(model, adapters)}
    _full_remat(model)
    kw = dict(lora_scale=lcfg.scale)
    stats_fn, update_fn = make_ppo_fns(jcfg, JPPO(**kw), _capture_grads())
    jstats = stats_fn(params, trainable, batch, jnp.asarray(scores), jnp.asarray(KL_COEF))
    jstate, _ = update_fn(jinit(trainable, _capture_grads()), params, batch, jstats)
    grads = jax.device_get(jstate.opt_state)
    pcfg = tp.PPOConfig(**kw)
    state = _port_state(model, tv, True)
    tb = batch_to_device(batch, "cpu")
    stats = tp.compute_rollout_stats(model, pcfg, tv, tb, torch.from_numpy(scores), KL_COEF, True)
    tp.ppo_update(model, pcfg, OptimizerConfig(**OPT), state, tv, tb, stats, True)
    _assert_trees(lora_tree(model, grads=True), grads["adapters"], PARAM_TOL, 1e-6, "grad")
    _assert_trees(lora_tree(model, grads=True, adapter_set=tp.VALUE_SET),
                  grads["value_adapters"], PARAM_TOL, 1e-6, "value grad")
    np.testing.assert_allclose(tv["kernel"].grad.numpy(), grads["v_head"]["kernel"],
                               rtol=PARAM_TOL, atol=1e-6)
