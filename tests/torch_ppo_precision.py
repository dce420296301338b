"""ppo's outer step at lr 5e-3 on the 4-layer tiny LLaVA of
tests/test_torch_dist_pipe_ppo.py: the port's single-process step against
vlrlhf_tpu's single-process step (make_ppo_fns, ppo_update_epochs), in f32
or in f64. Not a test: it prints each metric of the last update, the
largest gaps of the stats pass (logps, values, advantages) and of the
leaves after the step, for one precision per run:

    JAX_PLATFORMS=cpu python -m tests.torch_ppo_precision f32
    JAX_PLATFORMS=cpu python -m tests.torch_ppo_precision f64

f64 runs both packages in double precision: JAX with x64 enabled and its
explicit `jnp.float32` casts (the logps, the value head, the attention's
accumulators, the rope tables) rebound to float64, the port with its
model, adapters, value head and optimizer state in float64 and its
explicit f32 (`Tensor.float()`, the rope tables, the norms', attention's
and the flash path's `torch.float32`, GAE's f32 discount) made float64.
Both start from the same f32-representable weights and adapters and read
the same f32 scores, so what is left between them in f64 is what their
arithmetic does differently; what f32 adds is rounding. ~1 minute on the
CPU for each precision."""

import copy
import dataclasses
import sys
import types

import numpy as np


def _port_f64() -> None:
    """The port's explicit f32 made f64 for this process."""
    import torch

    import vlrlhf_torch.ops.attention as attention
    import vlrlhf_torch.ops.flash_attention as flash
    import vlrlhf_torch.ops.norms as norms
    import vlrlhf_torch.ops.rope as rope
    import vlrlhf_torch.train.ppo as tppo
    import vlrlhf_torch.train.train_state as ts
    import vlrlhf_torch.utils.bridge as bridge

    named = bridge._torch_dtype
    bridge._torch_dtype = lambda dt: torch.float64 if "float64" in (
        getattr(dt, "__name__", None) or str(np.dtype(dt))) else named(dt)

    def init_train_state(trainable, cfg):
        trainable = list(trainable)
        return ts.TrainState(trainable=trainable, mu=[torch.zeros_like(t) for t in trainable],
                             nu=[torch.zeros_like(t) for t in trainable])

    ts.init_train_state = init_train_state
    torch.Tensor.float = lambda self, *a, **k: self.double()
    proxy = types.SimpleNamespace(**{k: getattr(torch, k) for k in dir(torch)
                                     if not k.startswith("__")})
    proxy.float32 = torch.float64
    for mod in (rope, norms, attention, flash):
        mod.torch = proxy

    def gae_host(deltas, mask, gamma_lam):
        last = np.zeros(deltas.shape[0])
        out = np.empty_like(deltas)
        for t in range(deltas.shape[1] - 1, -1, -1):
            last = deltas[:, t] + gamma_lam * last * mask[:, t]
            out[:, t] = last
        return out

    tppo.gae_host = gae_host


def main(precision: str) -> None:
    import jax
    import jax.numpy as jnp

    f64 = precision == "f64"
    if f64:
        jax.config.update("jax_enable_x64", True)
        jnp.float32 = jnp.float64
        _port_f64()
    import torch

    import tests.test_torch_dist_pipe_ppo as pipe_ppo
    from tests.test_dpo_step import tiny_vlm_config
    from tests.test_torch_dist_dpo import _KEY, jax_leaf
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_tpu.train.ppo import (
        PPOConfig, RunningMoments, make_ppo_fns, ppo_update_epochs, preprocess_scores,
    )
    from vlrlhf_tpu.train.train_state import OptimizerConfig, init_train_state, make_optimizer
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.ppo import PPOConfig as PortPPO
    from vlrlhf_torch.train.ppo import compute_rollout_stats
    from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, vlm_config_from

    opt = dict(pipe_ppo.OPT, learning_rate=5e-3)
    pipe_ppo.OPT = opt
    dt = np.float64 if f64 else np.float32
    base = tiny_vlm_config()
    f32cfg = dataclasses.replace(
        base, lm=dataclasses.replace(base.lm, num_layers=4, dtype=np.float32),
        vision=dataclasses.replace(base.vision, dtype=np.float32))
    jcfg = dataclasses.replace(f32cfg, lm=dataclasses.replace(f32cfg.lm, dtype=dt),
                               vision=dataclasses.replace(f32cfg.vision, dtype=dt))
    params = init_vlm_params(f32cfg, jax.random.PRNGKey(0))
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=pipe_ppo.LORA_PATTERNS)
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(1))
    adapters = jax.tree.map(lambda x: (x + 0.01 * jnp.ones_like(x)).astype(np.float32), adapters)
    params, adapters = jax.tree.map(
        lambda x: jnp.asarray(x, dt) if jnp.issubdtype(x.dtype, jnp.floating) else x,
        (params, adapters))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    if f64:
        model.double()
        for mod in model.modules():
            for leaf in ("lora_a", "lora_b"):
                p = getattr(mod, leaf, None)
                if p is not None:
                    p.data = p.data.double()
    case = pipe_ppo._case("precision", (1, 1, 1, 1), model, lcfg.scale, rollouts=False)
    case["v_head"] = case["v_head"].astype(dt)
    case["batch"] = {k: v.astype(dt) if v.dtype == np.float32 else v
                     for k, v in case["batch"].items()}
    port = pipe_ppo.world1(case)

    kw = case["pcfg"]
    trainable = jax.tree.map(jnp.array, {"adapters": adapters,
                                         "v_head": {"kernel": jnp.asarray(case["v_head"])}})
    tx = make_optimizer(OptimizerConfig(**opt), trainable)
    state = init_train_state(trainable, tx)
    stats_fn, update_fn = make_ppo_fns(jcfg, PPOConfig(**kw), tx)
    scores = preprocess_scores(case["raw"], PPOConfig(**kw), RunningMoments())
    batch = {k: jnp.asarray(v) for k, v in case["batch"].items()}
    kl0 = jnp.asarray(pipe_ppo._pcfg(lcfg.scale)["init_kl_coef"], dt)
    jstats = stats_fn(params, state.trainable, batch, jnp.asarray(scores, dt), kl0)
    state, metrics = ppo_update_epochs(update_fn, state, params, batch, jstats,
                                       PPOConfig(**kw), seed=case["seed"])
    print(f"precision {precision}: the last update's metrics, port / vlrlhf_tpu / |gap|")
    last = port["history"][-1]
    for k in sorted(metrics):
        print(f"  {k:28s} {last[k]: .9e} {float(metrics[k]): .9e} "
              f"{abs(last[k] - float(metrics[k])):.3e}")
    worst = max(float(np.abs(v - jax_leaf(state.trainable["adapters"], k)).max())
                for k, v in port["trainable"].items() if _KEY.match(k))
    vh = np.abs(port["trainable"]["v_head/kernel"]
                - np.asarray(state.trainable["v_head"]["kernel"])).max()
    print(f"  adapters after the step, max |gap| {worst:.3e}; value head {float(vh):.3e}")

    # the stats pass of both on the step's inputs, before any update
    fresh = copy.deepcopy(case["model"])
    v_head = {"kernel": torch.nn.Parameter(torch.from_numpy(case["v_head"].copy()))}
    stats = compute_rollout_stats(fresh, PortPPO(**kw), v_head,
                                  batch_to_device(case["batch"], "cpu"),
                                  torch.from_numpy(np.asarray(scores)), float(kl0))
    start = {"adapters": adapters, "v_head": {"kernel": jnp.asarray(case["v_head"])}}
    jstats = stats_fn(params, start, batch, jnp.asarray(scores, dt), kl0)
    for f in ("logprobs", "ref_logprobs", "values", "advantages", "returns"):
        gap = np.abs(getattr(stats, f).double().numpy() - np.asarray(getattr(jstats, f))).max()
        print(f"  stats {f:12s} max |gap| {float(gap):.3e}")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "f32")
