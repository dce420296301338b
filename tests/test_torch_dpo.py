"""The DPO slice end to end: vlrlhf_torch's dpo_step vs vlrlhf_tpu's
dpo_step_fn (unjitted, CPU, f32, lora_dropout 0) on the tiny LLaVA of
tests/test_dpo_step.py with its weights and adapters bridged from the JAX
trees. Tolerances: loss and metrics 1e-5, LoRA gradients rtol 1e-4 (atol
1e-6 times the leaf's largest magnitude, for entries near 0), adapters
after 3 updates 1e-5. Also: the step-1 loss is ln 2 with
zero b, precomputed and online reference logps agree, LoRA dropout's keep
fraction and scale, and the `dpo` CLI on the CPU. The remat policies are
held in tests/test_torch_remat.py."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.test_dpo_step import tiny_batch, tiny_vlm_config
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.train import dpo as tdpo
from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state
from vlrlhf_torch.utils.bridge import (
    load_lora_params,
    load_vlm_params,
    lora_tree,
    vlm_config_from,
)

LOSS_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
PARAM_TOL = 1e-5
LORA_PATTERNS = (r"lm/.*attn/", r"lm/.*mlp/")


def _capture_grads():
    """An optax transformation that applies nothing and keeps the
    gradients as its state, so dpo_step_fn hands back its exact grads."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g),
    )


def _setup(b_offset=0.01, jcfg=None, seed=0):
    """JAX cfg/params/adapters and the port model holding the same values."""
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params

    jcfg = jcfg or tiny_vlm_config()
    params = init_vlm_params(jcfg, jax.random.PRNGKey(seed))
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(1))
    if b_offset:  # non-zero adapters: policy != reference, gradients nontrivial
        adapters = jax.tree.map(lambda x: x + b_offset * jnp.ones_like(x), adapters)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    return jcfg, params, lcfg, adapters, model


def _tbatch(batch):
    return tdpo.batch_to_device({k: np.asarray(v) for k, v in batch.items()}, "cpu")


def _jax_step(jcfg, params, adapters, dcfg_kw, tx, batch, steps=1):
    from vlrlhf_tpu.train.dpo import DPOConfig, dpo_step_fn
    from vlrlhf_tpu.train.train_state import init_train_state as jinit

    state = jinit(adapters, tx)
    for _ in range(steps):
        state, metrics = dpo_step_fn(jcfg, DPOConfig(**dcfg_kw), tx, state, params, batch)
    return state, {k: float(v) for k, v in metrics.items()}


def _torch_steps(model, dcfg_kw, ocfg, batch, steps=1):
    dcfg = tdpo.DPOConfig(**dcfg_kw)
    state = init_train_state(tdpo.adapter_params(model), ocfg)
    for _ in range(steps):
        metrics = tdpo.dpo_step(model, dcfg, ocfg, state, batch)
    return state, {k: float(v) for k, v in metrics.items()}


def _assert_trees(got, want, rtol, atol, what):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    assert len(flat_w) == len(flat_g) and len(flat_w) > 0
    for path, w in flat_w:
        w = np.asarray(w)
        np.testing.assert_allclose(flat_g[path], w, rtol=rtol,
                                   atol=atol * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("logits_chunk", [0, 20])
def test_step_matches_jax_loss_metrics_and_grads(logits_chunk):
    jcfg, params, lcfg, adapters, model = _setup()
    batch = tiny_batch(jax.random.PRNGKey(2))
    kw = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=logits_chunk)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), batch)
    _, tm = _torch_steps(model, kw, OptimizerConfig(learning_rate=5e-3, warmup_steps=1,
                                                    total_steps=50), _tbatch(batch))
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, "grad")


@pytest.mark.parametrize("loss_type", ["ipo", "ddpo"])
def test_step_matches_jax_other_losses(loss_type):
    jcfg, params, lcfg, adapters, model = _setup()
    batch = dict(tiny_batch(jax.random.PRNGKey(2)))
    if loss_type == "ddpo":
        rng = np.random.default_rng(0)
        batch["loss_mask"] = jnp.asarray(rng.integers(0, 2, batch["labels"].shape).astype(bool))
    kw = dict(beta=0.1, lora_scale=lcfg.scale, loss_type=loss_type)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), batch)
    _, tm = _torch_steps(model, kw, OptimizerConfig(), _tbatch(batch))
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, "grad")


def test_flash_function_in_the_decoder_matches_jax(monkeypatch):
    """On the card the decoder's attention runs the FlashAttention Function
    (kernels forward and backward); on the CPU it runs the reference
    attention. Routed through the Function's plain forward and backward,
    on right-padded rows (fully masked query rows), the step still matches
    dpo_step_fn's loss, metrics and LoRA gradients. logits/* average the
    logits over every position, padded ones too, whose hidden states differ
    by design (the flash path gives 0 for a fully masked row, the reference
    a uniform average), so they are the two metrics left out."""
    import vlrlhf_torch.models.lm.llama as tllama
    from vlrlhf_torch.ops.flash_attention import flash_attention

    jcfg, params, lcfg, adapters, model = _setup()
    batch = {k: np.array(v) for k, v in tiny_batch(jax.random.PRNGKey(2)).items()}
    for row in (1, 3):  # the last 8 positions of a chosen and a rejected row are padding
        batch["pad_mask"][row, -8:] = False
        batch["input_ids"][row, -8:] = 0
        batch["labels"][row, -8:] = -100
    kw = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    monkeypatch.setattr(tllama, "multi_head_attention",
                        lambda q, k, v, **a: flash_attention(q, k, v, **a))
    _, tm = _torch_steps(model, kw, OptimizerConfig(), _tbatch(batch))
    for k in set(jm) - {"logits/chosen", "logits/rejected"}:
        np.testing.assert_allclose(tm[k], jm[k], atol=LOSS_TOL, rtol=LOSS_TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, "grad")


def test_three_updates_match_jax_adapters():
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import make_optimizer

    jcfg, params, lcfg, adapters, model = _setup()
    batch = tiny_batch(jax.random.PRNGKey(2))
    # Adam's eps at 1e-3: an entry whose gradient is f32 rounding noise
    # (|g| ~ 1e-6, where the two frameworks' summation orders differ) would
    # otherwise take a full normalized step of either sign
    opt = dict(learning_rate=5e-3, warmup_steps=1, total_steps=50, weight_decay=0.01, eps=1e-3)
    kw = dict(beta=0.1, lora_scale=lcfg.scale)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, make_optimizer(JOpt(**opt), adapters),
                           batch, steps=3)
    _, tm = _torch_steps(model, kw, OptimizerConfig(**opt), _tbatch(batch), steps=3)
    np.testing.assert_allclose(tm["loss"], jm["loss"], atol=LOSS_TOL, rtol=LOSS_TOL)
    _assert_trees(lora_tree(model), jax.device_get(jstate.trainable), PARAM_TOL, PARAM_TOL,
                  "adapter")


def test_zero_b_first_loss_is_ln2_and_precomputed_ref_agrees():
    jcfg, params, lcfg, adapters, model = _setup(b_offset=0.0)
    batch = _tbatch(tiny_batch(jax.random.PRNGKey(2)))
    kw = dict(beta=0.1, lora_scale=lcfg.scale)
    ocfg = OptimizerConfig(learning_rate=5e-3, warmup_steps=0, warmup_ratio=0.0,
                           schedule="cosine", total_steps=10)
    state = init_train_state(tdpo.adapter_params(model), ocfg)
    m = tdpo.dpo_step(model, tdpo.DPOConfig(**kw), ocfg, state, batch)
    assert float(m["loss"]) == pytest.approx(np.log(2.0), abs=1e-6)
    assert float(m["rewards/margins"]) == pytest.approx(0.0, abs=1e-6)
    # after an update b != 0: online and precomputed reference logps agree
    dcfg = tdpo.DPOConfig(**kw)
    c, r = tdpo.make_ref_logps_fn(model, dcfg)(batch)
    snapshot = [p.detach().clone() for p in state.trainable]
    online = tdpo.dpo_step(model, dcfg, ocfg, state, batch)
    with torch.no_grad():
        for p, s in zip(state.trainable, snapshot):
            p.copy_(s)
    state.count, state.step = 1, 1
    state.mu = [torch.zeros_like(t) for t in state.mu]
    state.nu = [torch.zeros_like(t) for t in state.nu]
    cached = tdpo.dpo_step(model, dcfg, ocfg, state,
                           dict(batch, ref_chosen_logps=c, ref_rejected_logps=r))
    assert float(online["loss"]) != pytest.approx(np.log(2.0), abs=1e-4)
    for k in ("loss", "rewards/margins", "grad_norm"):
        np.testing.assert_allclose(float(cached[k]), float(online[k]), atol=1e-6, rtol=1e-6)


def test_lora_dropout_keep_fraction_scale_and_reference():
    """Dropout on the policy forward: keep fraction ~ 1-p, kept entries
    scaled by 1/(1-p), the same mask on a rerun of the same seed (what
    checkpoint's recompute relies on), and an adapter-off forward that is
    untouched by it."""
    from vlrlhf_torch.lora.lora import lora_delta

    x = torch.ones(64, 256)
    eye = torch.eye(256)
    p = 0.25
    h = lora_delta(x, eye, eye, 1.0, dropout=p, seed=123)
    kept = h != 0
    assert abs(kept.float().mean().item() - (1 - p)) < 0.01
    assert torch.allclose(h[kept], torch.full_like(h[kept], 1 / (1 - p)))
    assert torch.equal(h, lora_delta(x, eye, eye, 1.0, dropout=p, seed=123))
    assert not torch.equal(h, lora_delta(x, eye, eye, 1.0, dropout=p, seed=124))

    _, _, lcfg, _, model = _setup()
    batch = _tbatch(tiny_batch(jax.random.PRNGKey(2)))
    feats = tdpo.pair_image_features(model, batch)
    dcfg = tdpo.DPOConfig(lora_scale=lcfg.scale)
    with torch.no_grad():
        ref = tdpo.forward_logps(model, dcfg, batch, Ctx(), feats)[0]
        ref_drop = tdpo.forward_logps(model, dcfg, batch, Ctx(lora_dropout=0.5, dropout_seed=7),
                                      feats)[0]
        pol = tdpo.forward_logps(model, dcfg, batch, Ctx(True, lcfg.scale), feats)[0]
        pol_drop = tdpo.forward_logps(model, dcfg, batch,
                                      Ctx(True, lcfg.scale, 0.5, dropout_seed=7), feats)[0]
    assert torch.equal(ref, ref_drop)
    assert not torch.allclose(pol, pol_drop)


def test_cli_dpo_synthetic_cpu(tmp_path):
    from vlrlhf_torch.cli.main import main

    main(["dpo", "--synthetic", "16", "--device", "cpu", "--max_steps", "3",
          "--output_dir", str(tmp_path), "--logging_steps", "1",
          "--per_device_train_batch_size", "2", "--logits_chunk", "16"])
    lines = [json.loads(x) for x in (tmp_path / "dpo_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2, 3]
    assert round(lines[0]["loss"], 4) == 0.6931
    for r in lines:
        assert all(np.isfinite(v) for v in r.values())
    assert "perf/mfu" in lines[1] and "perf/tokens_per_sec" in lines[1]


def test_cli_refuses_unported_flags(tmp_path):
    from vlrlhf_torch.cli.main import main

    with pytest.raises(SystemExit, match="--data_path"):
        main(["dpo", "--synthetic", "4", "--device", "cpu", "--output_dir", str(tmp_path),
              "--data_path", "pairs.json"])
    with pytest.raises(SystemExit, match="--mesh_fsdp"):
        main(["dpo", "--synthetic", "4", "--device", "cpu", "--output_dir", str(tmp_path),
              "--mesh_fsdp", "2"])
