"""Checkpoints, resume, preemption and the merged save (vlrlhf_torch
train/checkpoint.py, train/loop.py, lora.merge_lora, cli.main train_dpo /
finish_run), on the CPU in f32.

  - 4 `dpo` steps straight are bit-identical to 2 steps + a checkpoint + a
    resume (`auto`, and an explicit checkpoints path) + 2 steps: adapters,
    AdamW moments, the counters, the learning rate and every logged
    metric, with LoRA dropout on (its masks follow the restored step). The
    rows are one pair repeated, so the resumed run, which iterates its
    batches from the start as vlrlhf_tpu's does, sees the same batches;
  - the manager keeps the newest 3 steps, reads the latest from the
    directory names (None when there is none), its restored tree goes back
    onto a TrainState's leaves and dtypes through load_state_tree_, and it
    raises a failed background write;
  - SIGTERM through PreemptionGuard: the step in progress finishes, the
    state is saved at that boundary, the loop stops and logs
    train/preempted;
  - merge_lora equals vlrlhf_tpu's merge_lora on bridged params and
    adapters: within 1e-6 over an f32 base, within one bf16 unit in the
    last place over bf16 and int8 bases (both round W + s A B to bf16, from
    f32 products of A and B whose summation order may differ); over an int4
    base against the port's own dequantized weight plus the delta, and
    against vlrlhf_tpu's where the checkpoint has no gbias;
  - prefetch_iterator yields the batches in order and raises a worker's
    exception in the consumer."""

import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dpo import LORA_PATTERNS
from vlrlhf_torch.train.checkpoint import CheckpointManager, load_params, save_params


def _args(out, *extra):
    from vlrlhf_torch.cli.main import build_parser

    argv = ["dpo", "--synthetic", "1", "--device", "cpu", "--bf16", "false", "--output_dir",
            str(out), "--max_steps", "4", "--per_device_train_batch_size", "1",
            "--lora_dropout", "0.1", "--learning_rate", "1e-3", "--warmup_ratio", "0.25",
            "--weight_decay", "0.01", "--logging_steps", "1", "--save_steps", "2", *extra]
    args, unknown = build_parser().parse_known_args(argv)
    assert not unknown
    return args


def _train(out, epochs: int, *extra):
    """A `dpo` run over one synthetic pair repeated: `epochs` batches at
    most (the data ends there), up to step 4."""
    from vlrlhf_torch.cli.main import build_dpo, synthetic_bundle, synthetic_rows, train_dpo
    from vlrlhf_torch.train.metrics import MetricsLogger

    args = _args(out, "--num_train_epochs", str(epochs), *extra)
    _, cfg, model, proc = synthetic_bundle(args, torch.device("cpu"))
    run = build_dpo(cfg, model, proc, args, synthetic_rows(1))
    logger = MetricsLogger(args.output_dir, "dpo")
    try:
        last = train_dpo(run, proc, args, logger)
    finally:
        logger.close()
    lines = [json.loads(x) for x in open(logger.path).read().splitlines()]
    return run, last, {r["step"]: {k: v for k, v in r.items() if not k.startswith("perf/")}
                       for r in lines}


@pytest.mark.parametrize("resume", ["auto", "path"])
def test_resume_is_bit_identical_to_a_straight_run(tmp_path, resume):
    from vlrlhf_torch.train.train_state import lr_at

    straight, last, want = _train(tmp_path / "a", 100)
    assert last == 4 and sorted(want) == [1, 2, 3, 4]
    first, last, got = _train(tmp_path / "b", 2)
    assert last == 2 and sorted(got) == [1, 2]
    assert os.listdir(tmp_path / "b" / "checkpoints") == ["2"]
    out = tmp_path / ("b" if resume == "auto" else "c")
    spec = "auto" if resume == "auto" else str(tmp_path / "b" / "checkpoints")
    resumed, last, more = _train(out, 100, "--resume_from_checkpoint", spec)
    assert last == 4 and {3, 4} <= set(more)  # "auto" appends to the first leg's log
    for step in (1, 2):
        assert got[step] == want[step], step
    for step in (3, 4):
        assert more[step] == want[step], step
    a, b = straight.state, resumed.state
    assert (a.step, a.count, a.mini_step) == (b.step, b.count, b.mini_step) == (4, 4, 0)
    assert lr_at(straight.ocfg, a.count) == lr_at(resumed.ocfg, b.count)
    for group in ("trainable", "mu", "nu"):
        for x, y in zip(getattr(a, group), getattr(b, group)):
            assert torch.equal(x, y), group
    saved = sorted(os.listdir(out / "checkpoints"))
    assert saved == (["2", "4"] if resume == "auto" else ["4"])


def test_manager_keeps_three_and_restores_onto_the_template(tmp_path):
    """The template is the TrainState a resume fills: the host tree the
    manager restores goes back through train_state.load_state_tree_ onto
    the state's leaves, in their dtype, and a leaf of another shape is
    refused."""
    from vlrlhf_torch.train.train_state import (
        OptimizerConfig, TrainState, init_train_state, load_state_tree_, state_tree)

    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert mgr.latest_step() is None
    with pytest.raises(FileNotFoundError):
        mgr.restore()
    keys = ["lm/x/a"]
    state = init_train_state([torch.arange(6, dtype=torch.float32).reshape(2, 3)],
                             OptimizerConfig())
    for step in range(1, 6):
        state.trainable[0].mul_(step)
        state.mu[0].fill_(step)
        state.step = state.count = step
        mgr.save(step, state_tree(state, keys), extra={"note": step})
        state.trainable[0].add_(100.0)  # the saved copy was taken at save time
    mgr.wait()
    assert sorted(os.listdir(tmp_path / "ck")) == ["3", "4", "5"]
    assert mgr.latest_step() == 5
    tree, extra = mgr.restore()
    assert extra == {"note": 5} and tree["step"] == 5
    template = TrainState(*([torch.zeros(2, 3, dtype=torch.float64)] for _ in range(3)))
    load_state_tree_(template, keys, tree)
    assert template.trainable[0].dtype == torch.float64 and template.step == template.count == 5
    want = torch.arange(6.0).reshape(2, 3)
    for k in range(1, 6):
        want = want * k + (100.0 if k < 5 else 0.0)
    np.testing.assert_array_equal(template.trainable[0].numpy(), want.numpy())
    np.testing.assert_array_equal(template.mu[0].numpy(), np.full((2, 3), 5.0))
    wrong = init_train_state([torch.zeros(3, 2)], OptimizerConfig())
    with pytest.raises(ValueError, match="does not fit"):
        load_state_tree_(wrong, keys, mgr.restore(3)[0])
    x = state.trainable[0]
    (tmp_path / "ck" / "7").write_text("a file where the step directory goes")
    mgr.save(7, {"w": {"a": x}, "step": 7})
    with pytest.raises(OSError):
        mgr.wait()
    mgr.close()
    save_params(str(tmp_path / "p"), {"lm/x/a": torch.ones(2, dtype=torch.bfloat16)})
    p = load_params(str(tmp_path / "p"))
    assert p["lm/x/a"].dtype == torch.bfloat16 and p["lm/x/a"].sum() == 2


class _Ckpt:
    def __init__(self):
        self.saved, self.waited = {}, False

    def save(self, step, tree):
        self.saved[step] = tree

    def wait(self):
        self.waited = True


class _Log:
    def __init__(self):
        self.lines = []

    def log(self, step, metrics):
        self.lines.append((step, metrics))


def test_sigterm_saves_at_the_step_boundary_and_stops():
    from vlrlhf_torch.train.loop import run_training

    ckpt, log, seen = _Ckpt(), _Log(), []

    def step_fn(batch):
        seen.append(int(batch["input_ids"][0, 0]))
        return {"loss": torch.tensor(0.5)}

    def on_step(step, metrics):
        if step == 13:
            os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice

    batches = ({"input_ids": np.full((1, 2), i)} for i in range(100))
    last = run_training(step_fn, batches, "cpu", log, logging_steps=50,
                        checkpoint_manager=ckpt, state_fn=lambda: {"n": len(seen)},
                        save_steps=50, start_step=10, on_step=on_step)
    assert seen == [0, 1, 2] and last == 13
    assert ckpt.saved == {13: {"n": 3}} and ckpt.waited
    assert log.lines == [(13, {"train/preempted": 1.0})]
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def _bridged(bits=0, dtype=jnp.float32):
    """JAX params (quantized with TRAIN_QUANT_PATTERNS when bits) and
    adapters with non-zero b, and the port model holding them."""
    from tests.test_dpo_step import tiny_vlm_config
    from tests.test_int4 import _vlm128
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_tpu.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params

    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, vlm_config_from

    jcfg = _vlm128() if bits == 4 else tiny_vlm_config()
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, dtype=dtype),
                               vision=dataclasses.replace(jcfg.vision, dtype=dtype))
    params = init_vlm_params(jcfg, jax.random.PRNGKey(3))
    if bits:
        params = quantize_params(params, TRAIN_QUANT_PATTERNS, bits=bits)
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)
    adapters = jax.tree.map(lambda x: x + 0.05, init_lora(params, lcfg, jax.random.PRNGKey(4)))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    return params, adapters, lcfg.scale, model


def _jax_merged(params, adapters, scale, bits):
    from vlrlhf_tpu.lora.lora import merge_lora
    from vlrlhf_tpu.ops.quant import dequantize_params

    if bits:
        params = dequantize_params(params)
    return jax.device_get(merge_lora(params, adapters, scale))


def _pairs(merged_t, merged_j):
    """(port weight (out, in), JAX kernel transposed) for every LM linear."""
    layers = merged_j["lm"]["layers_scanned"]
    for i in range(layers["attn"]["wq"]["kernel"].shape[0]):
        for group, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
            for n in names:
                yield (f"lm.layers.{i}.{n}", merged_t[f"lm.layers.{i}.{n}.weight"],
                       np.asarray(layers[group][n]["kernel"][i], np.float32).T)


@pytest.mark.parametrize("base", ["f32", "bf16", "int8"])
def test_merge_matches_jax(base):
    from vlrlhf_torch.lora.lora import merge_lora
    from vlrlhf_torch.ops.quant import dequantize_params

    bits = 8 if base == "int8" else 0
    dtype = jnp.bfloat16 if base == "bf16" else jnp.float32
    params, adapters, scale, model = _bridged(bits, dtype)
    want = _jax_merged(params, adapters, scale, bits)
    if bits:
        assert model.lm.layers[0].wq.weight is None
        with pytest.raises(ValueError, match="dequantize first"):
            merge_lora(model, scale)
        dequantize_params(model)
    got = merge_lora(model, scale)
    assert not any(k.endswith(("lora_a", "lora_b")) for k in got)
    n = 0
    for name, g, w in _pairs(got, want):
        g = g.float().numpy()
        if base == "f32":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=name)
        else:  # within one bf16 unit in the last place
            np.testing.assert_array_less(np.abs(g - w), np.abs(w) * 2.0**-7 + 1e-30,
                                         err_msg=name)
            assert np.mean(g == w) > 0.99, name
        n += 1
    assert n == 14
    np.testing.assert_array_equal(got["lm.norm.weight"].float().numpy(),
                                  np.asarray(want["lm"]["norm"]["weight"], np.float32))


def test_merge_over_int4_is_dequantized_weight_plus_delta():
    from vlrlhf_torch.lora.lora import merge_lora
    from vlrlhf_torch.ops.quant import dequantize_params

    params, adapters, scale, model = _bridged(bits=4)
    lin = model.lm.layers[1].down
    assert lin.weight_q4 is not None and lin.weight_gbias is None
    a, b = lin.lora_a.detach().clone(), lin.lora_b.detach().clone()
    dequantize_params(model)
    w = lin.weight.float()
    got = merge_lora(model, scale)
    own = (w + (a @ b).T * scale).to(torch.bfloat16)
    assert torch.equal(got["lm.layers.1.down.weight"], own)
    want = _jax_merged(params, adapters, scale, 4)
    for name, g, wj in _pairs(got, want):
        g = g.float().numpy()
        np.testing.assert_array_less(np.abs(g - wj), np.abs(wj) * 2.0**-7 + 1e-30,
                                     err_msg=name)


def test_prefetch_iterator_order_and_worker_errors():
    from vlrlhf_torch.train.loop import prefetch_iterator

    assert list(prefetch_iterator(iter(range(17)), depth=3)) == list(range(17))

    def broken():
        yield 1
        yield 2
        raise KeyError("row 3")

    got = []
    with pytest.raises(KeyError, match="row 3"):
        for x in prefetch_iterator(broken()):
            got.append(x)
    assert got == [1, 2]
