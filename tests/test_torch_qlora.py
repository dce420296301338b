"""QLoRA DPO (LoRA over a frozen int4 or int8 base): vlrlhf_torch's dpo_step
vs vlrlhf_tpu's dpo_step_fn (unjitted, CPU, f32, the Pallas int4 kernels in
interpret mode) on the 128-wide tiny LLaVA, its LM linears quantized by
vlrlhf_tpu with TRAIN_QUANT_PATTERNS (lm_head stays f32) and bridged with
the adapters into the port.

Tolerances: the loss within 1e-3 (the BASELINE.md target; measured 6.2e-5
with int4). LoRA gradients: over int8, elementwise at rtol 1e-4 (atol 1e-6
times the leaf's largest magnitude); over int4, each leaf's relative
Frobenius error within 2e-2 (measured at most 6.1e-3). Every int4 linear
rounds its input activations to bf16 in both packages, so f32 differences
of ~1e-7 upstream flip whole bf16 ulps (vlrlhf_tpu's own training forward
and empty prefill differ by 2.2e-3 in the logits, tests/test_torch_int4.py)
and the gradients, which read those activations, inherit it. Also: zero-b
adapters give the port's step-1 loss ln 2 within 1e-6 (vlrlhf_tpu's within
1e-4, as tests/test_int4.py holds it) and a few port steps lower it;
`dpo --q_lora true --bits {4,8}` on the CPU (whose --synthetic widths fall
back to int8, as in vlrlhf_tpu); build_dpo on the 128-wide model runs the
plain versions of both int4 kernels and launches none."""

import argparse
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch
from tests.test_torch_dpo import (
    GRAD_ATOL, GRAD_RTOL, LORA_PATTERNS, _assert_trees, _capture_grads, _jax_step, _tbatch,
    _torch_steps,
)
from vlrlhf_torch.models.common import Linear
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.ops import int4 as t4
from vlrlhf_torch.train.train_state import OptimizerConfig
from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, lora_tree, vlm_config_from

LOSS_TOL = 1e-3
INT4_GRAD_REL = 2e-2  # per-leaf relative Frobenius error over an int4 base (docstring)


def _setup(bits, b_offset=0.01, seed=16):
    """JAX cfg / quantized params / adapters and the port model holding them."""
    from tests.test_int4 import _vlm128
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_tpu.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params

    jcfg = _vlm128()
    params = quantize_params(init_vlm_params(jcfg, jax.random.PRNGKey(seed)),
                             TRAIN_QUANT_PATTERNS, bits=bits)
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(17))
    if b_offset:
        adapters = jax.tree.map(lambda x: x + b_offset, adapters)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    layer = model.lm.layers[0]
    assert (layer.down.weight_q4 is not None) == (bits == 4)
    assert (layer.wq.weight_q is not None) == (bits == 8)
    assert model.lm.lm_head.weight is not None
    return jcfg, params, lcfg, adapters, model


@pytest.mark.parametrize("bits", [4, 8])
def test_qlora_step_matches_jax(bits):
    jcfg, params, lcfg, adapters, model = _setup(bits)
    batch = tiny_batch(jax.random.PRNGKey(2))
    kw = dict(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16)
    jstate, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), batch)
    _, tm = _torch_steps(model, kw, OptimizerConfig(), _tbatch(batch))
    assert abs(tm["loss"] - jm["loss"]) <= LOSS_TOL, (tm["loss"], jm["loss"])
    got, want = lora_tree(model, grads=True), jax.device_get(jstate.opt_state)
    if bits == 8:
        _assert_trees(got, want, GRAD_RTOL, GRAD_ATOL, "grad")
        return
    flat = dict(jax.tree_util.tree_flatten_with_path(got)[0])
    leaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(leaves) == len(flat) == 14
    for path, w in leaves:
        w, g = np.asarray(w, np.float64), np.asarray(flat[path], np.float64)
        rel = np.linalg.norm(g - w) / np.linalg.norm(w)
        assert rel <= INT4_GRAD_REL, f"grad {jax.tree_util.keystr(path)}: rel {rel:.3e}"


@pytest.mark.parametrize("bits", [4, 8])
def test_qlora_first_loss_is_ln2_and_steps_lower_it(bits):
    jcfg, params, lcfg, adapters, model = _setup(bits, b_offset=0.0)
    batch = tiny_batch(jax.random.PRNGKey(18))
    kw = dict(beta=0.1, lora_scale=lcfg.scale)
    _, jm = _jax_step(jcfg, params, adapters, kw, _capture_grads(), batch)
    from vlrlhf_torch.train import dpo as tdpo
    from vlrlhf_torch.train.train_state import init_train_state

    ocfg = OptimizerConfig(learning_rate=5e-3, warmup_steps=1, total_steps=50)
    state = init_train_state(tdpo.adapter_params(model), ocfg)
    tb, dcfg = _tbatch(batch), tdpo.DPOConfig(**kw)
    losses = [float(tdpo.dpo_step(model, dcfg, ocfg, state, tb)["loss"]) for _ in range(7)]
    assert losses[0] == pytest.approx(np.log(2.0), abs=1e-6)
    assert jm["loss"] == pytest.approx(np.log(2.0), abs=1e-4)
    assert losses[-1] < losses[0] - 1e-3, losses


def _dpo_args(**kw):
    base = dict(
        lora_r=4, lora_alpha=8.0, lora_dropout=0.0, seed=0, learning_rate=5e-3,
        warmup_ratio=0.0, max_steps=3, lr_scheduler_type="constant", weight_decay=0.0,
        max_grad_norm=1.0, gradient_accumulation_steps=1, beta=0.1, label_smoothing=0.0,
        loss_type="sigmoid", reference_free=False, precompute_ref_logps=False, logits_chunk=16,
        max_length=64, max_prompt_length=48, per_device_train_batch_size=2, synthetic=4,
        q_lora=True, bits=4, q_lora_vision=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def _count_plain(monkeypatch):
    calls = {"fwd": 0, "dx": 0}

    def wrap(fn, key):
        def counted(*a):
            calls[key] += 1
            return fn(*a)
        return counted

    monkeypatch.setattr(t4, "int4_matmul_plain", wrap(t4.int4_matmul_plain, "fwd"))
    monkeypatch.setattr(t4, "int4_matmul_t_plain", wrap(t4.int4_matmul_t_plain, "dx"))
    return calls


def wide_bundle(seed=3):
    """A seeded 128-wide port model (LLaVA layout, every LM linear and lm_head
    int4-eligible) and a processor over its 128-token vocabulary."""
    from tests.test_int4 import _vlm128
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES

    cfg = vlm_config_from(_vlm128())
    model = init_random_(VLM(cfg, "cpu"), torch.Generator().manual_seed(seed))
    pcfg = ProcessorConfig(num_image_tokens=cfg.num_image_tokens, image_token_id=3,
                           max_length=64, max_prompt_length=48)
    return cfg, model, VLProcessor(ToyTokenizer(vocab_size=128), FAMILIES["llava"].template, pcfg)


def test_build_dpo_on_the_wide_model_runs_the_plain_int4_versions(monkeypatch):
    from vlrlhf_torch.cli.main import build_dpo, synthetic_rows
    from vlrlhf_torch.train.dpo import batch_to_device

    cfg, model, proc = wide_bundle()
    calls = _count_plain(monkeypatch)
    launches = (t4.int4_matmul.launches, t4.int4_matmul_t.launches)
    loader = lambda p, s, m: np.zeros((s, s, 3), np.uint8)  # noqa: E731
    run = build_dpo(cfg, model, proc, _dpo_args(), synthetic_rows(4), loader)
    lin = [m for n, m in model.named_modules() if isinstance(m, Linear) and n.startswith("lm.")]
    assert all(m.weight_q4 is not None for m in lin if m is not model.lm.lm_head)
    assert model.lm.lm_head.weight is not None and model.vision.layers[0].wq.weight is not None
    assert all(m.lora_a is not None for m in lin if m is not model.lm.lm_head)  # after quantization
    batch = batch_to_device(run.collator([run.tokenize_fn(r) for r in run.rows[:2]]), "cpu")
    m = run.step(batch)
    assert float(m["loss"]) == pytest.approx(np.log(2.0), abs=1e-6)
    assert calls["fwd"] > 0 and calls["dx"] > 0
    assert (t4.int4_matmul.launches, t4.int4_matmul_t.launches) == launches


@pytest.mark.parametrize("q_lora_vision", [False, True])
def test_synthetic_widths_fall_back_to_int8_as_in_jax(q_lora_vision):
    """scale_down's hidden 32 / intermediate 64 are no multiples of 128, so
    --bits 4 quantizes the same linears as vlrlhf_tpu, all to int8."""
    from tests.test_torch_quant import _quantized_kinds
    from vlrlhf_tpu.cli.main import _synthetic_bundle
    from vlrlhf_tpu.ops import quant as jq
    from vlrlhf_torch.cli.main import synthetic_bundle
    from vlrlhf_torch.ops import quant as tq

    pats = jq.TRAIN_QUANT_PATTERNS_WIDE if q_lora_vision else jq.TRAIN_QUANT_PATTERNS
    assert pats == (tq.TRAIN_QUANT_PATTERNS_WIDE if q_lora_vision else tq.TRAIN_QUANT_PATTERNS)
    args = argparse.Namespace(model_family="llava", max_length=64, max_prompt_length=48,
                              synthetic=4, bf16=False, seed=0)
    _, _, params, _ = _synthetic_bundle(args)
    want = _quantized_kinds(jax.device_get(jq.quantize_params(params, pats, bits=4)))
    _, _, model, _ = synthetic_bundle(args, torch.device("cpu"))
    tq.quantize_params(model, pats, bits=4)
    got = {tq.linear_path(n): ("int4" if m.weight_q4 is not None else
                               "int8" if m.weight_q is not None else "dense")
           for n, m in model.named_modules() if isinstance(m, Linear)}
    assert {p: k for p, k in got.items() if k != "dense"} == want
    assert set(want.values()) == {"int8"}


@pytest.mark.parametrize("bits", ["4", "8"])
def test_cli_qlora_dpo_synthetic_cpu(tmp_path, bits):
    from vlrlhf_torch.cli.main import main

    main(["dpo", "--synthetic", "4", "--device", "cpu", "--max_steps", "2",
          "--output_dir", str(tmp_path), "--logging_steps", "1",
          "--per_device_train_batch_size", "2", "--logits_chunk", "16",
          "--q_lora", "true", "--bits", bits])
    lines = [json.loads(x) for x in (tmp_path / "dpo_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert round(lines[0]["loss"], 4) == 0.6931
    for r in lines:
        assert all(np.isfinite(v) for v in r.values())


def test_flops_do_not_depend_on_quantization():
    """vlrlhf_tpu's DPO FLOP count ignores quantization; so does the port's."""
    from vlrlhf_torch.train.flops import dpo_flops_per_token

    cfg, model, _ = wide_bundle()
    before = dpo_flops_per_token(cfg, 64)
    from vlrlhf_torch.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params

    quantize_params(model, TRAIN_QUANT_PATTERNS, bits=4)
    assert dpo_flops_per_token(dataclasses.replace(cfg), 64) == before


@pytest.mark.parametrize("bits", [8, 4])
def test_init_lora_targets_quantized_linears_as_jax(bits):
    """init_lora / match_lora_targets on a quantized model: the same targets
    and adapter shapes as vlrlhf_tpu's init_lora on its quantized tree
    (`d_in` is the true width, not the packed one)."""
    from vlrlhf_tpu.lora.lora import LoraConfig as JLoraConfig
    from vlrlhf_tpu.lora.lora import init_lora as jinit
    from vlrlhf_torch.lora.lora import LM_ALL_LINEARS, LoraConfig, init_lora, match_lora_targets

    from tests.test_torch_int4 import int4_ported

    _, params, model = int4_ported(bits=bits, seed=24)
    want = jax.device_get(jinit(params, JLoraConfig(r=4, target_patterns=LM_ALL_LINEARS),
                                jax.random.PRNGKey(0)))
    assert len(match_lora_targets(model, LM_ALL_LINEARS)) == 14
    init_lora(model, LoraConfig(r=4, target_patterns=LM_ALL_LINEARS), torch.Generator().manual_seed(0))
    got = lora_tree(model)
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), got)
    assert shapes == jax.tree.map(lambda a: tuple(np.shape(a)), want)
    assert model.lm.layers[0].down.lora_a.shape == (256, 4)
