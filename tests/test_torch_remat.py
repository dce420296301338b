"""The LM's remat policies (vlrlhf_tpu `remat_policy_for`): for each of
full, attn, dots, mlp, mlp1 and acts, the port's dpo_step gives the loss,
metrics and LoRA gradients of the port without remat (with LoRA dropout,
whose masks the recompute draws again: 1e-6 for full / attn / dots, which
replay the forward's ops in order, 1e-5 for the named policies, whose
regions sum a norm's gradient terms in another order) and of vlrlhf_tpu's
dpo_step_fn under the same policy (dropout 0, whose masks cannot match
JAX's PRNG: loss and metrics 1e-5, gradients rtol 1e-4), on the tiny LLaVA
with non-zero adapters; the same over an int8 QLoRA base under acts and
dots. The tensors each policy keeps for the backward, counted per layer
with saved-tensor hooks, grow in the order of the JAX policies' named sets
(full < attn < mlp1 < mlp < acts), and under dots the selective checkpoint
keeps only matmul outputs, never a buffer a kernel fills."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch, tiny_vlm_config
from tests.test_torch_dpo import (
    GRAD_ATOL, GRAD_RTOL, LOSS_TOL, _assert_trees, _capture_grads, _jax_step, _setup, _tbatch,
    _torch_steps,
)
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.train import dpo as tdpo
from vlrlhf_torch.train.train_state import OptimizerConfig
from vlrlhf_torch.utils.bridge import lora_tree

POLICIES = ("full", "attn", "dots", "mlp", "mlp1", "acts")


def _with_remat(cfg, remat: bool, policy: str, **lm):
    return dataclasses.replace(cfg, lm=dataclasses.replace(
        cfg.lm, remat=remat, remat_policy=policy, **lm))


def _set_remat(model, remat: bool, policy: str) -> None:
    model.lm.cfg = dataclasses.replace(model.lm.cfg, remat=remat, remat_policy=policy)


@pytest.mark.parametrize("policy", POLICIES)
def test_remat_policies_give_the_same_gradients(policy):
    jcfg, params, lcfg, adapters, model = _setup(jcfg=_with_remat(tiny_vlm_config(), True, policy))
    assert model.cfg.lm.remat and model.cfg.lm.remat_policy == policy
    batch = tiny_batch(jax.random.PRNGKey(2))
    ocfg = OptimizerConfig()

    # (1) the port with and without remat, LoRA dropout on
    drop = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16, lora_dropout=0.1,
                dropout_seed=3)
    snapshot = [p.detach().clone() for p in tdpo.adapter_params(model)]
    got = {}
    for name, remat in (("remat", True), ("off", False)):
        with torch.no_grad():
            for p, s in zip(tdpo.adapter_params(model), snapshot):
                p.copy_(s)
        _set_remat(model, remat, policy)
        _, m = _torch_steps(model, drop, ocfg, _tbatch(batch))
        got[name] = (m, lora_tree(model, grads=True))
    # full, attn and dots run the forward's own ops in its order; the named
    # policies' regions hand a norm's backward each gradient term apart
    # (the sum's order changes by f32 rounding)
    rtol, atol = (1e-6, 1e-7) if policy in ("full", "attn", "dots") else (1e-5, 1e-6)
    for k, v in got["off"][0].items():
        np.testing.assert_allclose(got["remat"][0][k], v, rtol=rtol, atol=atol, err_msg=k)
    _assert_trees(got["remat"][1], got["off"][1], rtol, atol, f"{policy} vs no remat")

    # (2) against vlrlhf_tpu under the same policy, dropout off
    with torch.no_grad():
        for p, s in zip(tdpo.adapter_params(model), snapshot):
            p.copy_(s)
    _set_remat(model, True, policy)
    kw = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), batch)
    _, tm = _torch_steps(model, kw, ocfg, _tbatch(batch))
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, f"{policy} grad")


def _kept_bytes(policy: str, n_layers: int) -> int:
    """Bytes of the distinct non-parameter storages the policy forward
    hands to autograd (saved tensors and checkpoint inputs)."""
    cfg = _with_remat(tiny_vlm_config(), True, policy, num_layers=n_layers)
    _, _, lcfg, _, model = _setup(jcfg=cfg)
    batch = _tbatch(tiny_batch(jax.random.PRNGKey(2)))
    feats = tdpo.pair_image_features(model, batch)
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    kept: dict = {}

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in params:
            kept[ptr] = t.untyped_storage().nbytes()
        return t

    dcfg = tdpo.DPOConfig(lora_scale=lcfg.scale, logits_chunk=16)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        logps, _ = tdpo.forward_logps(model, dcfg, batch, Ctx(True, lcfg.scale), feats)
    assert logps.requires_grad
    return sum(kept.values())


def test_kept_bytes_per_layer_follow_the_jax_policies():
    """Per layer (3 layers minus 2): full keeps the layer input, attn adds
    x + attn_out, mlp1 ffn_gate, mlp ffn_up, acts the q / k / v projections
    and the attention output. Each step up is exactly the named tensors'
    bytes at the tiny model's (4 rows x 48 tokens) f32 activations."""
    per_layer = {p: _kept_bytes(p, 3) - _kept_bytes(p, 2)
                 for p in ("full", "attn", "mlp1", "mlp", "acts")}
    t = 4 * 48 * 4  # rows x tokens x f32 bytes
    h, ff = 32, 64
    assert per_layer["full"] == t * h, per_layer
    assert per_layer["attn"] == per_layer["full"] + t * h, per_layer
    assert per_layer["mlp1"] == per_layer["attn"] + t * ff, per_layer
    assert per_layer["mlp"] == per_layer["mlp1"] + t * ff, per_layer
    assert per_layer["acts"] == per_layer["mlp"] + 4 * t * h, per_layer


def test_dots_keeps_only_matmul_outputs(monkeypatch):
    """Under dots the selective checkpoint keeps mm / addmm outputs and
    recomputes every other op, the allocations the flash Function's kernel
    fills on the card included (routed here through the Function, whose
    CPU forward is its plain version). The gradients stay those of the port
    without remat."""
    import vlrlhf_torch.models.lm.llama as tllama
    from torch.utils.checkpoint import CheckpointPolicy

    from vlrlhf_torch.ops.flash_attention import flash_attention

    monkeypatch.setattr(tllama, "multi_head_attention",
                        lambda q, k, v, **a: flash_attention(q, k, v, **a))
    decisions = []
    inner = tllama._keep_matmuls

    def spy(ctx, op, *args, **kwargs):
        out = inner(ctx, op, *args, **kwargs)
        decisions.append((op, out))
        return out

    monkeypatch.setattr(tllama, "_keep_matmuls", spy)
    _, _, lcfg, _, model = _setup(jcfg=_with_remat(tiny_vlm_config(), True, "dots"))
    batch = _tbatch(tiny_batch(jax.random.PRNGKey(2)))
    kw = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16)
    snapshot = [p.detach().clone() for p in tdpo.adapter_params(model)]
    _torch_steps(model, kw, OptimizerConfig(), batch)
    grads = lora_tree(model, grads=True)
    kept = {op for op, d in decisions if d == CheckpointPolicy.MUST_SAVE}
    assert torch.ops.aten.mm.default in kept and kept <= set(tllama._MATMULS), kept
    allocs = {op for op, _ in decisions if op.__name__.split(".")[0] in
              ("empty", "empty_like", "new_empty", "empty_strided", "zeros", "zeros_like")}
    assert all(d != CheckpointPolicy.MUST_SAVE for op, d in decisions if op in allocs)
    with torch.no_grad():
        for p, s in zip(tdpo.adapter_params(model), snapshot):
            p.copy_(s)
    _set_remat(model, False, "dots")
    _torch_steps(model, kw, OptimizerConfig(), batch)
    _assert_trees(grads, lora_tree(model, grads=True), 1e-6, 1e-7, "dots vs no remat")


@pytest.mark.parametrize("policy", ["acts", "dots"])
def test_qlora_int8_remat_matches_jax(policy):
    """QLoRA over vlrlhf_tpu's int8 LM linears (the W8A16 product keeps the
    codes, not a dense copy, for its backward) under acts and dots:
    loss, metrics and gradients against dpo_step_fn at the same policy."""
    from tests.test_torch_qlora import _setup as qlora_setup

    jcfg, params, lcfg, adapters, model = qlora_setup(8)
    jcfg = _with_remat(jcfg, True, policy)
    _set_remat(model, True, policy)
    batch = tiny_batch(jax.random.PRNGKey(2))
    kw = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), batch)
    _, tm = _torch_steps(model, kw, OptimizerConfig(), _tbatch(batch))
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, f"int8 {policy} grad")
