"""LoRA in vlrlhf_torch vs vlrlhf_tpu/lora/lora.py: targets chosen by the
same regexes, init_lora's shapes, f32 masters and zero b, lora_delta on the
same numpy inputs (f32, tolerance 1e-5, bf16 inputs cast a and b like
lora.py:146-147), the Linear's adapter switch, and the bridge's round trip
of an adapter tree and of its gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_vlm_config
from vlrlhf_tpu.lora import lora as J
from vlrlhf_tpu.models.registry import LM_ALL_LINEARS as J_LM_ALL_LINEARS
from vlrlhf_tpu.models.vlm import init_vlm_params
from vlrlhf_torch.lora import lora as T
from vlrlhf_torch.models.common import Ctx, Linear
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.utils.bridge import load_lora_params, lora_tree, vlm_config_from

TOL = 1e-5


def _model():
    jcfg = tiny_vlm_config()
    return jcfg, VLM(vlm_config_from(jcfg), device="cpu")


def test_targets_and_init_match_the_jax_package():
    assert T.LM_ALL_LINEARS == J_LM_ALL_LINEARS
    jcfg, model = _model()
    params = init_vlm_params(jcfg, jax.random.PRNGKey(0))
    jt = J.init_lora(params, J.LoraConfig(r=4, target_patterns=J_LM_ALL_LINEARS),
                     jax.random.PRNGKey(1))
    names = T.init_lora(model, T.LoraConfig(r=4, target_patterns=T.LM_ALL_LINEARS),
                        torch.Generator().manual_seed(1))
    assert len(names) == 7 * jcfg.lm.num_layers
    assert all(n.startswith("lm.layers.") for n in names)
    tree = lora_tree(model)
    flat_j = jax.tree_util.tree_flatten_with_path(jt)[0]
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert len(flat_j) == len(flat_t) == 14
    for path, leaf in flat_j:
        assert flat_t[path].shape == leaf.shape, path
    for _, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.lora_a is not None:
            assert mod.lora_a.dtype == mod.lora_b.dtype == torch.float32
            assert mod.lora_a.requires_grad and torch.all(mod.lora_b == 0)
            assert abs(mod.lora_a.std().item() - 0.5) < 0.2  # N(0, 1/r), r = 4
    names2 = [n for n, _ in T.lora_parameters(model)]
    assert len(names2) == 2 * len(names) and names2[0].endswith("lora_a")


def test_module_path():
    assert T.module_path("lm.layers.3.wq") == "lm/layers/3/attn/wq/kernel"
    assert T.module_path("lm.layers.0.down") == "lm/layers/0/mlp/down/kernel"
    assert T.module_path("vision.layers.1.fc2") == "vision/layers/1/mlp/fc2/kernel"
    assert T.module_path("projector.fc1") == "projector/fc1/kernel"
    assert T.module_path("lm.lm_head") == "lm/lm_head/kernel"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_delta_matches_jax(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 12)).astype(np.float32)
    a = rng.standard_normal((12, 4)).astype(np.float32)
    b = rng.standard_normal((4, 7)).astype(np.float32)
    jd = getattr(jnp, dtype)
    td = getattr(torch, dtype)
    want = J.lora_delta(jnp.asarray(x, jd), {"a": jnp.asarray(a), "b": jnp.asarray(b)}, 0.5)
    got = T.lora_delta(torch.from_numpy(x).to(td), torch.from_numpy(a), torch.from_numpy(b), 0.5)
    assert got.dtype == td
    tol = TOL if dtype == "float32" else 2e-2  # bf16 rounds at two matmuls
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=tol * 10, rtol=tol)


def test_linear_adapter_switch():
    lin = Linear(12, 7, True, "cpu", torch.float32)
    torch.nn.init.normal_(lin.weight)
    torch.nn.init.normal_(lin.bias)
    x = torch.randn(3, 12)
    base = lin(x)
    lin.lora_a = torch.nn.Parameter(torch.randn(12, 4))
    lin.lora_b = torch.nn.Parameter(torch.randn(4, 7))
    assert torch.equal(lin(x), base) and torch.equal(lin(x, Ctx()), base)
    on = lin(x, Ctx(adapters=True, lora_scale=0.5))
    torch.testing.assert_close(on, base + (x @ lin.lora_a) @ lin.lora_b * 0.5)


def test_bridge_round_trip_adapters_and_grads():
    jcfg, model = _model()
    params = init_vlm_params(jcfg, jax.random.PRNGKey(0))
    jt = J.init_lora(params, J.LoraConfig(r=4, target_patterns=J_LM_ALL_LINEARS),
                     jax.random.PRNGKey(1))
    jt = jax.tree.map(lambda t: t + 0.3, jax.device_get(jt))
    names = load_lora_params(model, jt)
    assert len(names) == 14
    back = lora_tree(model)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.asarray(w)), back, jt)
    # gradients come back in the same structure
    for _, p in T.lora_parameters(model):
        p.grad = torch.full_like(p, 2.0)
    grads = lora_tree(model, grads=True)
    jax.tree.map(lambda g, w: np.testing.assert_array_equal(g, np.full(w.shape, 2.0)), grads, jt)
