"""Multi-GPU DPO on the CPU: the port's `dpo_step` on gloo ranks under a
(data, fsdp, model) mesh (core/partitioning.py: FSDP2 over data x fsdp,
tensor parallelism over model) against vlrlhf_tpu's jitted DPO step under
the same MeshConfig on the 8 virtual CPU devices of tests/conftest.py,
f32, on the same bridged weights and non-zero LoRA adapters:
  - the tiny LLaVA of tests/test_dpo_step.py (4 pairs) under fsdp=2,
    data=2 x fsdp=2 and fsdp=2 x model=2;
  - llava_next_mistral (GQA; anyres batches), qwen_vl (qkv bias) and
    internlm_xc2 (PLoRA, GQA) under fsdp=2 x model=2, the GQA LMs at 8
    heads / 2 KV heads so that model=2 splits both;
  - QLoRA int8 under fsdp=2.
Loss and margins of 2 steps and the adapters after them agree within
1e-5 (Adam's eps at 1e-3, as tests/test_torch_dpo.py has it). QLoRA int4
under model=2, whose row-parallel linears are repacked per shard, against
the world-1 port on a 256-wide LLaVA, at the int4 tolerances of
tests/test_torch_qlora.py: loss 5e-3, adapters 2e-2 relative.

The ranks (tests/torch_dist_worker.py) import torch and the port only; the
cases travel to them pickled and their results come back through a file.
Two jobs, 4 ranks and 2 ranks, run at once."""

import dataclasses
import re
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch
from tests.torch_dist_worker import Job, on_one_thread

TOL = 1e-5
INT4_LOSS, INT4_REL = 5e-3, 2e-2
OPT = dict(learning_rate=5e-3, warmup_steps=0, warmup_ratio=0.0, total_steps=50,
           weight_decay=0.01, eps=1e-3)
STEPS = 2


def jax_steps(step_factory, jcfg, params, trainable, batch, mesh_shape, steps=STEPS):
    """vlrlhf_tpu's jitted step under MeshConfig(*mesh_shape): params and
    state by default_lm_rules, the batch on data x fsdp
    (tests/test_dpo_step.py test_sharded_step_matches_unsharded). Returns
    (per-step metrics, trainable after the steps)."""
    from jax.sharding import NamedSharding

    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh
    from vlrlhf_tpu.core.partitioning import (
        batch_spec, default_lm_rules, make_sharding, shard_pytree,
    )
    from vlrlhf_tpu.train.train_state import OptimizerConfig, init_train_state, make_optimizer

    trainable = jax.tree.map(jnp.array, trainable)  # the step donates its state
    tx = make_optimizer(OptimizerConfig(**OPT), trainable)
    state = init_train_state(trainable, tx)
    mesh = make_mesh(MeshConfig(*mesh_shape))
    rules = default_lm_rules()
    params = shard_pytree(rules, params, mesh)
    state = jax.tree.map(jax.device_put, state, make_sharding(rules, state, mesh))
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(mesh, batch_spec()))
             for k, v in batch.items()}
    step = step_factory(jcfg, tx)
    metrics = []
    for _ in range(steps):
        state, m = step(state, params, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, jax.device_get(state.trainable)


def jax_dpo(jcfg, params, adapters, batch, mesh_shape, dkw):
    from vlrlhf_tpu.train.dpo import DPOConfig, make_dpo_step

    return jax_steps(lambda c, tx: make_dpo_step(c, DPOConfig(**dkw), tx), jcfg, params,
                     adapters, batch, mesh_shape)


_KEY = re.compile(r"^(?:adapters/)?(\w+)/layers/(\d+)/(\w+)/(\w+)/(a|b)$")


def jax_leaf(tree, key: str) -> np.ndarray:
    """The JAX adapter tree's value for a port checkpoint key
    ("lm/layers/1/attn/wq/a" -> tree["lm"]["layers_scanned"]["attn"]["wq"]["a"][1])."""
    m = _KEY.match(key)
    tower, layer, group, lin, leaf = m.groups()
    return np.asarray(tree[tower]["layers_scanned"][group][lin][leaf][int(layer)])


def assert_adapters(got: dict, want_tree, tol=TOL, what=""):
    keys = [k for k in got if _KEY.match(k)]
    assert keys
    for k in keys:
        w = jax_leaf(want_tree, k)
        np.testing.assert_allclose(got[k], w, atol=tol * max(1.0, float(np.abs(w).max())),
                                   rtol=tol, err_msg=f"{what} {k}")


def assert_metrics(got: list, want: list, keys=("loss", "rewards/margins"), tol=TOL, what=""):
    assert len(got) == len(want) == STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], atol=tol, rtol=tol, err_msg=f"{what} {i} {k}")


def _llava():
    from tests.test_torch_sft_rm import _setup

    jcfg, params, lcfg, adapters, model = _setup()
    batch = {k: np.asarray(v) for k, v in tiny_batch(jax.random.PRNGKey(9), n_pairs=4).items()}
    return jcfg, params, lcfg, adapters, model, batch


def _family(name, tmp):
    """(jax cfg, params, lcfg, adapters, port model, DPO batch) of a
    scaled-down family with 2 preference pairs."""
    from tests.test_torch_families import family_port

    # mistral's and XC2's scaled-down LMs keep their 4:1 GQA at 4 / 1 heads:
    # 8 / 2 heads of width 4 let model=2 split the KV heads too
    gqa = (("num_heads", 8), ("num_kv_heads", 2), ("head_dim", 4))
    if name == "llava_next_mistral":
        from tests.test_torch_anyres import _collators, _dpo_rows, _images

        jcfg, params, model, lcfg, adapters = family_port(name, seed=5, lora=True,
                                                          lm_overrides=gqa)
        jp, jcoll, _, _ = _collators("DPOCollator", tmp)
        batch = jcoll(_dpo_rows(jp, _images(tmp)))
    else:
        from tests.test_torch_qwen_xc2_train import FEATURES, collate, processor

        jcfg, params, model, lcfg, adapters = family_port(
            name, seed=8, lora=True, lm_overrides=gqa if name == "internlm_xc2" else ())
        proc = processor(name, jcfg)
        batch = collate("DPOCollator", proc, [proc.tokenize_row_dpo(dict(f)) for f in FEATURES])
    return jcfg, params, lcfg, adapters, model, {k: np.asarray(v) for k, v in batch.items()}


def _int8(llava):
    """The tiny LLaVA's LM linears quantized to int8 by vlrlhf_tpu
    (TRAIN_QUANT_PATTERNS) and bridged, with its adapters."""
    from vlrlhf_tpu.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, vlm_config_from

    jcfg, params, lcfg, adapters, _, batch = llava
    params = quantize_params(params, TRAIN_QUANT_PATTERNS, bits=8)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    load_lora_params(model, jax.device_get(adapters))
    assert model.lm.layers[0].wq.weight_q is not None
    return jcfg, params, lcfg, adapters, model, batch


def _int4_model():
    """A 256-wide LLaVA (the port's config) with its LM linears in int4 and
    LoRA on every LM linear: at model=2 each row-parallel shard holds 128
    input rows."""
    from tests.test_int4 import _vlm128
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.utils.bridge import vlm_config_from

    cfg = vlm_config_from(_vlm128())
    cfg = dataclasses.replace(
        cfg, lm=dataclasses.replace(cfg.lm, hidden_size=256, intermediate_size=512),
        projector=dataclasses.replace(cfg.projector, out_dim=256))
    model = init_random_(VLM(cfg, device="cpu"), torch.Generator().manual_seed(3))
    quantize_params(model, TRAIN_QUANT_PATTERNS, bits=4)
    assert model.lm.layers[0].down.weight_q4 is not None
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=(r"lm/.*attn/", r"lm/.*mlp/"))
    init_lora(model, lcfg, torch.Generator().manual_seed(4))
    with torch.no_grad():  # non-zero b: the policy differs from the reference
        for mod in model.modules():
            if getattr(mod, "lora_b", None) is not None:
                mod.lora_b.add_(0.01)
    batch = {k: np.asarray(v) for k, v in tiny_batch(jax.random.PRNGKey(2)).items()}
    return lcfg, model, batch


def _case(name, mesh, model, batch, lcfg, **kw):
    return dict(name=name, mesh=mesh, model=model, batch=batch, steps=STEPS, ocfg=OPT,
                cfg=dict(beta=0.1, lora_scale=lcfg.scale, **kw))


MESHES = {"fsdp2": (1, 2, 1), "data2_fsdp2": (2, 2, 1), "fsdp2_model2": (1, 2, 2)}
FAMILIES = ("llava_next_mistral", "qwen_vl", "internlm_xc2")


@pytest.fixture(scope="module")
@on_one_thread
def runs(tmp_path_factory):
    """Both jobs started, then the JAX references computed while they run."""
    tmp = tmp_path_factory.mktemp("dist_dpo")
    llava = _llava()
    fams = {f: _family(f, tmp_path_factory.mktemp(f)) for f in FAMILIES}
    int8 = _int8(llava)
    lcfg4, model4, batch4 = _int4_model()
    jobs = {
        4: Job([_case(f"llava/{m}", MESHES[m], llava[4], llava[5], llava[2])
                for m in ("data2_fsdp2", "fsdp2_model2")]
               + [_case(f, MESHES["fsdp2_model2"], fams[f][4], fams[f][5], fams[f][2])
                  for f in FAMILIES], 4, tmp / "w4"),
        2: Job([_case("llava/fsdp2", MESHES["fsdp2"], llava[4], llava[5], llava[2]),
                _case("int8/fsdp2", MESHES["fsdp2"], int8[4], int8[5], int8[2], logits_chunk=16),
                _case("int4/model2", (1, 1, 2), model4, batch4, lcfg4, logits_chunk=16)],
               2, tmp / "w2"),
    }
    calls = {f"llava/{m}": (llava, MESHES[m], {}) for m in MESHES}
    calls.update({f: (fams[f], MESHES["fsdp2_model2"], {}) for f in FAMILIES})
    calls["int8/fsdp2"] = (int8, MESHES["fsdp2"], dict(logits_chunk=16))
    # the references' compiles overlap on threads; vlrlhf_tpu's make_mesh
    # registers its mesh globally, and a mesh left registered turns the
    # later files of this worker onto vlrlhf_tpu's model-sharded paths
    # (its int4 linears under model > 1: tests/test_torch_qwen_xc2_quant.py
    # read 7e-3 where it reads 1.5e-3), so the registry is put back
    from vlrlhf_tpu.core import mesh as jmesh

    prev = jmesh._GLOBAL_MESH
    try:
        with ThreadPoolExecutor(4) as pool:
            futures = {name: pool.submit(jax_dpo, c[0], c[1], c[3], c[5], mesh,
                                         dict(beta=0.1, lora_scale=c[2].scale, **kw))
                       for name, (c, mesh, kw) in calls.items()}
            want = {name: f.result() for name, f in futures.items()}
    finally:
        jmesh._GLOBAL_MESH = prev
    got = {**jobs[4].result(), **jobs[2].result()}
    return got, want, (lcfg4, model4, batch4)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_llava_dpo_steps_match_jax_under_the_mesh(runs, mesh):
    got, want, _ = runs
    g, (wm, wa) = got[f"llava/{mesh}"], want[f"llava/{mesh}"]
    assert_metrics(g["metrics"], wm, what=mesh)
    assert_adapters(g["trainable"], wa, what=mesh)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_dpo_steps_match_jax_under_fsdp2_model2(runs, family):
    got, want, _ = runs
    g, (wm, wa) = got[family], want[family]
    assert_metrics(g["metrics"], wm, what=family)
    assert_adapters(g["trainable"], wa, what=family)


def test_qlora_int8_dpo_steps_match_jax_under_fsdp2(runs):
    got, want, _ = runs
    g, (wm, wa) = got["int8/fsdp2"], want["int8/fsdp2"]
    assert_metrics(g["metrics"], wm, what="int8")
    assert_adapters(g["trainable"], wa, what="int8")


def test_qlora_int4_dpo_steps_under_model2_match_world1(runs):
    """Row-parallel int4 linears run on repacked shards; the result is the
    single-process port's at the int4 tolerances."""
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    got, _, (lcfg, model, batch) = runs
    ocfg = OptimizerConfig(**OPT)
    state = init_train_state(adapter_params(model), ocfg)
    dcfg = DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=16)
    tb = batch_to_device(batch, "cpu")
    want = [{k: float(v) for k, v in dpo_step(model, dcfg, ocfg, state, tb).items()}
            for _ in range(STEPS)]
    g = got["int4/model2"]
    for gm, wm in zip(g["metrics"], want):
        assert abs(gm["loss"] - wm["loss"]) <= INT4_LOSS, (gm["loss"], wm["loss"])
    for k, p in zip(lora_keys(model), state.trainable):
        w = p.detach().numpy()
        err = np.linalg.norm(g["trainable"][k] - w) / max(np.linalg.norm(w), 1e-12)
        assert err <= INT4_REL, (k, err)
