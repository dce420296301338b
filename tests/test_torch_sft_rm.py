"""The SFT and RM slice: vlrlhf_torch's sft_loss, rm_loss,
chunked_token_logps, sft_step and rm_step against vlrlhf_tpu's (jitted,
CPU, f32, no dropout) on the tiny LLaVA of tests/test_dpo_step.py with its
weights and adapters bridged from the JAX trees. Tolerances: losses, logps
and scores 1e-5; parameters after updates 1e-4 (Adam's eps at 1e-3, as in
tests/test_torch_dpo.py, so entries whose gradient is f32 noise move
alike)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch, tiny_vlm_config
from tests.test_torch_dpo import LORA_PATTERNS, _assert_trees, _tbatch
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.train import losses as tl
from vlrlhf_torch.train.dpo import adapter_params
from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state
from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, lora_tree, vlm_config_from

LOSS_TOL = 1e-5
PARAM_TOL = 1e-4
OPT = dict(learning_rate=5e-3, warmup_steps=1, total_steps=50, weight_decay=0.01, eps=1e-3)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jax_trees(b_offset: float):
    """(cfg, params, lora config, adapters) of the tiny LLaVA, built once
    per file (jitted: the eager init costs seconds per call)."""
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params

    jcfg = tiny_vlm_config()
    params = jax.jit(init_vlm_params, static_argnums=0)(jcfg, jax.random.PRNGKey(0))
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(1))
    adapters = jax.tree.map(lambda x: x + b_offset * jnp.ones_like(x), adapters)
    return jcfg, params, lcfg, adapters


def _setup(b_offset=0.01):
    """The JAX trees (fresh copies: the jitted steps donate their state)
    and a port model holding the same values."""
    jcfg, params, lcfg, adapters = _jax_trees(b_offset)
    params, adapters = jax.tree.map(jnp.array, (params, adapters))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    return jcfg, params, lcfg, adapters, model


def test_sft_loss_rm_loss_and_token_logps_match_jax():
    from vlrlhf_tpu.train import losses as jl

    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 10, 17)).astype(np.float32) * 3
    labels = rng.integers(0, 17, (3, 10)).astype(np.int32)
    labels[:, :4] = -100
    pad = np.ones((3, 10), bool)
    pad[1, 7:] = False
    got = tl.sft_loss(_t(logits), _t(labels), _t(pad))
    want = jl.sft_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(pad))
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_TOL, atol=LOSS_TOL)
    c, r = rng.normal(size=(2, 5)).astype(np.float32)
    np.testing.assert_allclose(float(tl.rm_loss(_t(c), _t(r))),
                               float(jl.rm_loss(jnp.asarray(c), jnp.asarray(r))),
                               rtol=LOSS_TOL, atol=LOSS_TOL)
    hidden = rng.normal(size=(2, 11, 8)).astype(np.float32)
    w = rng.normal(size=(8, 19)).astype(np.float32)
    ids = rng.integers(0, 19, (2, 11)).astype(np.int32)
    for chunk in (4, 11, 512):
        want = jax.jit(lambda h, i, c=chunk: jl.chunked_token_logps(
            h, i, lambda x: x @ jnp.asarray(w), chunk=c))(jnp.asarray(hidden), jnp.asarray(ids))
        h = _t(hidden).requires_grad_(True)
        got = tl.chunked_token_logps(h, _t(ids), lambda x: x @ _t(w), chunk=chunk)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=LOSS_TOL,
                                   atol=LOSS_TOL)
        # through the checkpointed chunks, the gradient is the dense one's
        got.sum().backward()
        hd = _t(hidden).requires_grad_(True)
        dense = torch.log_softmax(hd @ _t(w), -1)[:, :-1].gather(
            -1, _t(ids)[:, 1:, None].long())[..., 0]
        dense.sum().backward()
        np.testing.assert_allclose(h.grad.numpy(), hd.grad.numpy(), rtol=1e-5, atol=1e-6)


def _sft_batch():
    full = tiny_batch(jax.random.PRNGKey(2))
    pad = np.array(full["pad_mask"][:2])
    pad[1, -5:] = False
    return {"input_ids": full["input_ids"][:2], "labels": full["labels"][:2],
            "pad_mask": jnp.asarray(pad), "pixel_values": full["pixel_values"],
            "image_positions": full["image_positions"][:2]}


def test_sft_step_adapter_mode_with_logits_chunk_matches_jax(logits_chunk=20):
    from vlrlhf_tpu.train.sft import SFTConfig as JSFT
    from vlrlhf_tpu.train.sft import make_sft_step
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_tpu.train.train_state import make_optimizer
    from vlrlhf_torch.train.sft import SFTConfig, sft_step

    jcfg, params, lcfg, adapters, model = _setup()
    batch = _sft_batch()
    tx = make_optimizer(JOpt(**OPT), adapters)
    jstate = jinit(adapters, tx)
    ocfg = OptimizerConfig(**OPT)
    state = init_train_state(adapter_params(model), ocfg)
    scfg = SFTConfig(lora_scale=lcfg.scale, logits_chunk=logits_chunk)
    tb = _tbatch(batch)
    jstep = make_sft_step(jcfg, JSFT(lora_scale=lcfg.scale, logits_chunk=logits_chunk), tx)
    for _ in range(2):
        jstate, jm = jstep(jstate, params, batch)
        tm = sft_step(model, scfg, ocfg, state, tb)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    _assert_trees(lora_tree(model), jax.device_get(jstate.trainable), PARAM_TOL, PARAM_TOL,
                  "adapter")


def _port_params(model) -> dict:
    """The port's LM and projector weights in vlrlhf_tpu's layout (kernels
    (in, out), layers stacked), for comparison with a full-mode JAX tree."""
    lm = model.lm
    layers = {}
    for i, layer in enumerate(lm.layers):
        for grp, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
            for n in names:
                layers.setdefault((grp, n), []).append(getattr(layer, n).weight.detach().T)
        for n in ("input_layernorm", "post_attention_layernorm"):
            layers.setdefault((n,), []).append(getattr(layer, n).weight.detach())
    scanned: dict = {}
    for key, parts in layers.items():
        node = scanned
        for k in key[:-1]:
            node = node.setdefault(k, {})
        leaf = torch.stack(parts).numpy()
        node[key[-1]] = {"kernel": leaf} if key[0] in ("attn", "mlp") else {"weight": leaf}
    proj = model.projector
    return {
        "lm": {"embed_tokens": {"embedding": lm.embed_tokens.detach().numpy()},
               "norm": {"weight": lm.norm.weight.detach().numpy()},
               "lm_head": {"kernel": lm.lm_head.weight.detach().T.numpy()},
               "layers_scanned": scanned},
        "projector": {f: {"kernel": getattr(proj, f).weight.detach().T.numpy(),
                          "bias": getattr(proj, f).bias.detach().numpy()}
                      for f in ("fc1", "fc2")},
    }


def test_sft_step_full_mode_matches_jax_and_freezes_the_tower():
    from vlrlhf_tpu.train.sft import SFTConfig as JSFT
    from vlrlhf_tpu.train.sft import make_sft_step
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_tpu.train.train_state import make_optimizer
    from vlrlhf_torch.train.sft import SFTConfig, full_parameters, sft_step

    jcfg, params, _, _, model = _setup(b_offset=0.0)
    for mod in model.modules():  # full fine-tuning: no adapters
        if hasattr(mod, "lora_a"):
            mod.lora_a = mod.lora_b = None
    batch = _sft_batch()
    tx = make_optimizer(JOpt(**OPT, freeze_patterns=(r"^vision/",)), params)
    # the jitted step donates its state: the tree it trains is a copy
    jstate = jinit(jax.tree.map(jnp.array, params), tx)
    jstep = make_sft_step(jcfg, JSFT(mode="full"), tx)
    ocfg = OptimizerConfig(**OPT)
    train, frozen = full_parameters(model)
    vision_before = [p.detach().clone() for p in frozen]
    state = init_train_state(train, ocfg)
    tb = _tbatch(batch)
    for _ in range(2):
        jstate, jm = jstep(jstate, None, batch)
        tm = sft_step(model, SFTConfig(mode="full"), ocfg, state, tb, frozen)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    for a, b in zip(vision_before, frozen):
        assert torch.equal(a, b)
    want = jax.device_get(jstate.trainable)
    assert not np.allclose(want["lm"]["norm"]["weight"], params["lm"]["norm"]["weight"])
    _assert_trees(_port_params(model), {"lm": want["lm"], "projector": want["projector"]},
                  PARAM_TOL, PARAM_TOL, "param")


def test_rm_scores_and_steps_match_jax_from_ln2():
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.models.vlm import init_rm_head
    from vlrlhf_tpu.train.rm import RMConfig as JRM
    from vlrlhf_tpu.train.rm import rm_scores as jrm_scores
    from vlrlhf_tpu.train.rm import make_rm_step
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_tpu.train.train_state import make_optimizer
    from vlrlhf_torch.models.vlm import init_rm_head as tinit_rm_head
    from vlrlhf_torch.train.rm import RMConfig, rm_scores, rm_step

    jcfg, params, lcfg, adapters, model = _setup(b_offset=0.0)
    batch = dict(tiny_batch(jax.random.PRNGKey(3)))
    pad = np.array(batch["pad_mask"])
    pad[[0, 3], -6:] = False  # right-padded rows: the score sits at sum(pad) - 1
    batch["pad_mask"] = jnp.asarray(pad)
    tb = _tbatch(batch)
    # scores under a non-zero head, the tower run on the pixels
    kernel = np.random.default_rng(1).normal(size=(32, 1)).astype(np.float32)
    want = jrm_scores(jcfg, params, {"kernel": jnp.asarray(kernel)},
                      dict(batch, pixel_values=jnp.concatenate([batch["pixel_values"]] * 2)),
                      JCtx(adapters=adapters, lora_scale=lcfg.scale))
    with torch.no_grad():
        tiled = dict(tb, pixel_values=torch.cat([tb["pixel_values"]] * 2))
        got = rm_scores(model, _t(kernel), tiled, Ctx(adapters=True, lora_scale=lcfg.scale))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_TOL, atol=LOSS_TOL)

    trainable = {"adapters": adapters, "rm_head": init_rm_head(32, jnp.float32)}
    tx = make_optimizer(JOpt(**OPT), trainable)
    jstate = jinit(trainable, tx)
    ocfg = OptimizerConfig(**OPT)
    head = tinit_rm_head(32)["kernel"]
    state = init_train_state(adapter_params(model) + [head], ocfg)
    jstep = make_rm_step(jcfg, JRM(lora_scale=lcfg.scale), tx)
    for step in range(3):
        jstate, jm = jstep(jstate, params, batch)
        tm = rm_step(model, RMConfig(lora_scale=lcfg.scale), ocfg, state, head, tb)
        if step == 0:
            assert float(tm["loss"]) == pytest.approx(np.log(2.0), abs=1e-6)
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=LOSS_TOL,
                                       atol=LOSS_TOL, err_msg=k)
    jt = jax.device_get(jstate.trainable)
    _assert_trees(lora_tree(model), jt["adapters"], PARAM_TOL, PARAM_TOL, "adapter")
    np.testing.assert_allclose(head.detach().numpy(), jt["rm_head"]["kernel"], rtol=PARAM_TOL,
                               atol=PARAM_TOL)


def test_heads_and_flops_match_jax():
    """reward_forward (the head in the hidden states' dtype), the value
    head's init and value_forward with and without a bias, and the SFT / RM
    / PPO FLOP counts, against vlrlhf_tpu."""
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.models.vlm import init_value_head as jinit_value_head
    from vlrlhf_tpu.models.vlm import reward_forward as jreward_forward
    from vlrlhf_tpu.models.vlm import value_forward as jvalue_forward
    from vlrlhf_tpu.train import flops as jf
    from vlrlhf_torch.models.vlm import init_value_head, reward_forward, value_forward
    from vlrlhf_torch.train import flops as tf

    jcfg, params, lcfg, adapters, model = _setup()
    batch = tiny_batch(jax.random.PRNGKey(4), n_pairs=1)
    pad = np.array(batch["pad_mask"])
    pad[1, -7:] = False
    rng = np.random.default_rng(3)
    kernel = rng.normal(size=(32, 1)).astype(np.float32)
    pv = jnp.concatenate([batch["pixel_values"]] * 2)
    want = jreward_forward(jcfg, dict(params, rm_head={"kernel": jnp.asarray(kernel)}),
                           pad_mask=jnp.asarray(pad),
                           ctx=JCtx(adapters=adapters, lora_scale=lcfg.scale),
                           input_ids=batch["input_ids"], pixel_values=pv,
                           image_positions=batch["image_positions"])
    with torch.no_grad():
        got = reward_forward(model, {"kernel": _t(kernel)}, _t(pad),
                             Ctx(adapters=True, lora_scale=lcfg.scale),
                             input_ids=_t(batch["input_ids"]), pixel_values=_t(pv),
                             image_positions=_t(batch["image_positions"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LOSS_TOL, atol=LOSS_TOL)

    jv = jinit_value_head(32, jnp.float32, jax.random.PRNGKey(0))
    tv = init_value_head(32)
    assert set(tv) == set(jv)
    for k in jv:
        np.testing.assert_array_equal(tv[k].detach().numpy(), np.asarray(jv[k]).reshape(
            tuple(tv[k].shape)))
    hidden = rng.normal(size=(2, 5, 32)).astype(np.float32)
    head = {"kernel": kernel, "bias": np.asarray([0.7], np.float32)}
    for keys in (("kernel",), ("kernel", "bias")):
        jh = {k: jnp.asarray(head[k]) for k in keys}
        np.testing.assert_allclose(
            value_forward(_t(hidden), {k: _t(head[k]) for k in keys}).numpy(),
            np.asarray(jvalue_forward(jnp.asarray(hidden), jh)), rtol=LOSS_TOL, atol=LOSS_TOL)

    pcfg = vlm_config_from(jcfg)
    for mode in ("adapter", "full"):
        assert tf.sft_flops_per_token(pcfg, 1024, mode) == jf.sft_flops_per_token(jcfg, 1024, mode)
        assert tf.rm_flops_per_token(pcfg, 768, mode) == jf.rm_flops_per_token(jcfg, 768, mode)
        for sep in (False, True):
            assert tf.ppo_flops_per_token(pcfg, 768, 2, sep, mode) == \
                jf.ppo_flops_per_token(jcfg, 768, 2, sep, mode)
