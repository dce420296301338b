"""vlrlhf_torch's AdamW + clip + schedule vs vlrlhf_tpu's optax chain
(make_optimizer / apply_updates) on the same numpy gradients, 5 updates,
f32, tolerance 1e-6: a warmup step with lr 0, clipped and unclipped steps,
weight decay, the schedules (the 'linear' one against optax's
join_schedules: vlrlhf_tpu's names an optax function that does not exist),
and MultiSteps accumulation."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vlrlhf_torch.train import train_state as T

TOL = 1e-6


def _leaves(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((6, 3)).astype(np.float32),
            "b": rng.standard_normal((3, 5)).astype(np.float32)}


def _grads(seed, n, scale):
    rng = np.random.default_rng(seed)
    # the 3rd gradient is 50x larger: clipped at max_grad_norm=1, the others not
    return [{k: (rng.standard_normal(s) * (scale * 50 if i == 2 else scale)).astype(np.float32)
             for k, s in (("a", (6, 3)), ("b", (3, 5)))} for i in range(n)]


def _run_jax(cfg, params, grads):
    from vlrlhf_tpu.train.train_state import (
        OptimizerConfig,
        apply_updates,
        init_train_state,
        make_optimizer,
    )

    jcfg = OptimizerConfig(**dataclasses.asdict(cfg))
    p = {k: jnp.asarray(v) for k, v in params.items()}
    tx = make_optimizer(jcfg, p)
    state = init_train_state(p, tx)
    out = []
    for g in grads:
        state = apply_updates(state, {k: jnp.asarray(v) for k, v in g.items()}, tx)
        out.append({k: np.asarray(v) for k, v in state.trainable.items()})
    return out


def _run_torch(cfg, params, grads):
    leaves = [torch.tensor(params[k]) for k in ("a", "b")]
    state = T.init_train_state(leaves, cfg)
    out = []
    for g in grads:
        T.apply_updates(state, [torch.tensor(g[k]) for k in ("a", "b")], cfg)
        out.append({k: t.numpy().copy() for k, t in zip(("a", "b"), state.trainable)})
    return out, state


@pytest.mark.parametrize("schedule,weight_decay,warmup_steps,accum", [
    ("cosine", 0.0, 1, 1),  # warmup: the first update has lr 0
    ("cosine", 0.01, 2, 1),
    ("constant", 0.1, 1, 1),
    ("cosine", 0.0, 1, 2),  # MultiSteps: an update on every 2nd call
])
def test_updates_match_optax(schedule, weight_decay, warmup_steps, accum):
    cfg = T.OptimizerConfig(learning_rate=1e-2, warmup_steps=warmup_steps, total_steps=8,
                            schedule=schedule, weight_decay=weight_decay,
                            grad_accum_steps=accum)
    params = _leaves(0)
    grads = _grads(1, 5 * accum, 0.1)  # norms ~0.5 < max_grad_norm; the 3rd (~25) is clipped
    want = _run_jax(cfg, params, grads)
    got, state = _run_torch(cfg, params, grads)
    for i, (w, g) in enumerate(zip(want, got)):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=TOL, rtol=TOL, err_msg=f"call {i} {k}")
    if warmup_steps and accum == 1:
        np.testing.assert_array_equal(got[0]["a"], params["a"])  # lr 0 at count 0
    assert state.step == 5 * accum and state.count == 5


def test_schedules_match_optax():
    """lr_at against optax's schedules at every count, warmup 3 of 10."""
    lr = 3e-4
    cos = optax.warmup_cosine_decay_schedule(0.0, lr, 3, 10)
    const = optax.linear_schedule(0.0, lr, 3)
    lin = optax.join_schedules(
        [optax.linear_schedule(0.0, lr, 3), optax.linear_schedule(lr, 0.0, 7)], [3])
    for name, fn in (("cosine", cos), ("constant", const), ("linear", lin)):
        cfg = T.OptimizerConfig(learning_rate=lr, warmup_steps=3, total_steps=10, schedule=name)
        for c in range(12):
            np.testing.assert_allclose(T.lr_at(cfg, c), float(fn(c)), rtol=1e-6, atol=1e-12,
                                       err_msg=f"{name} count {c}")


def test_clipping_leaves_callers_grads_and_norm():
    """The global norm is optax's, and apply_updates returns it before
    clipping; clipping works on a copy."""
    g = [torch.full((3,), 4.0), torch.full((4,), 3.0)]
    want = float(optax.global_norm([jnp.full((3,), 4.0), jnp.full((4,), 3.0)]))
    np.testing.assert_allclose(float(T.global_norm(g)), want, rtol=1e-6)
    cfg = T.OptimizerConfig(learning_rate=1.0, warmup_steps=0, warmup_ratio=0.0,
                            schedule="constant", total_steps=4)
    state = T.init_train_state([torch.zeros(3), torch.zeros(4)], cfg)
    got = T.apply_updates(state, g, cfg)
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert torch.all(g[0] == 4.0) and torch.all(g[1] == 3.0)
