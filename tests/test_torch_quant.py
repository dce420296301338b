"""int8 quantization: vlrlhf_torch/ops/quant.py and the W8A16 Linear vs
vlrlhf_tpu/ops/quant.py and vlrlhf_tpu's `linear`, f32 on CPU.

Scales must match bitwise. Codes may differ by ±1 on exact round-half ties
(XLA can rewrite x / scale as x * (1 / scale), a 1-ulp quotient wobble;
vlrlhf_tpu/ops/quant.py:104-107). Products of the same codes and scales
match within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_models import ported, prompt_batch
from vlrlhf_torch.models.common import Linear
from vlrlhf_torch.ops import quant as tq

TOL = 1e-5


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("shape,dtype", [
    ((2, 3, 17, 8), np.float32),
    ((4, 2, 5, 128), np.float32),
    ((3, 64), "bfloat16"),
])
def test_quantize_kv_matches_jax(shape, dtype):
    from vlrlhf_tpu.ops.quant import quantize_kv

    rng = np.random.default_rng(len(shape) * 100 + shape[-1])
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0, shape[:-1] + (1,))).astype(np.float32)
    x[0, ..., :] = 0.0  # an all-zero vector takes scale 1
    jx = jnp.asarray(x, dtype=jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
    jq, js = quantize_kv(jx)
    tx = torch.from_numpy(_f32(jx)).to(torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    q, s = tq.quantize_kv(tx)
    assert q.dtype == torch.int8 and s.dtype == torch.bfloat16
    np.testing.assert_array_equal(s.float().numpy(), _f32(js))  # bitwise
    assert np.abs(q.numpy().astype(np.int32) - np.asarray(jq, np.int32)).max() <= 1
    back = tq.dequantize_kv(q, s)
    np.testing.assert_allclose(back.numpy(), _f32(jx), atol=float(np.abs(x).max()) / 100)


def _quantized_paths(tree, path=""):
    if isinstance(tree, dict):
        if "kernel_q" in tree:
            return [path]
        return [p for k, v in tree.items()
                for p in _quantized_paths(v, f"{path}/{k}" if path else k)]
    return []


def _quantized_kinds(tree, path=""):
    if isinstance(tree, dict):
        if "kernel_q4" in tree or "kernel_q" in tree:
            return {path: "int4" if "kernel_q4" in tree else "int8"}
        return {p: k for key, v in tree.items()
                for p, k in _quantized_kinds(v, f"{path}/{key}" if path else key).items()}
    return {}


@pytest.mark.parametrize("which", ["default", "serve_wide"])
def test_quantize_params_selects_the_same_linears(which):
    from vlrlhf_tpu.ops import quant as jquant

    patterns = {"default": jquant.DEFAULT_QUANT_PATTERNS,
                "serve_wide": jquant.SERVE_QUANT_PATTERNS_WIDE}[which]
    _, params, model = ported()
    want = _quantized_paths(jquant.quantize_params(params, patterns))
    got = tq.quantize_params(model, patterns)
    # JAX quantizes a stacked linear once for all layers; the port per layer
    assert sorted(set(got)) == sorted(want)
    n_layers = {"lm": len(model.lm.layers), "vision": len(model.vision.layers)}
    for path in set(got):
        stacked = "layers_scanned" in path
        assert got.count(path) == (n_layers[path.split("/")[0]] if stacked else 1), path
    # bits=4 on the 128-wide model: the same linears, int4 where in % 128
    # == 0 and int8 elsewhere (the 16-wide tower, projector fc1), as in JAX
    from tests.test_int4 import _vlm128

    _, params4, model4 = ported(jcfg=_vlm128())
    want4 = _quantized_kinds(jquant.quantize_params(params4, patterns, bits=4))
    tq.quantize_params(model4, patterns, bits=4)
    got4 = {tq.linear_path(n): "int4" if m.weight_q4 is not None else "int8"
            for n, m in model4.named_modules() if isinstance(m, Linear) and m.weight is None}
    assert got4 == want4 and "int4" in want4.values()
    assert ("int8" in want4.values()) == (which == "serve_wide")


@pytest.mark.parametrize("bias", [False, True])
def test_w8a16_linear_matches_jax_linear(bias):
    from vlrlhf_tpu.models.common import linear
    from vlrlhf_tpu.ops.quant import quantize_linear

    rng = np.random.default_rng(3)
    d_in, d_out = 48, 40
    p = {"kernel": jnp.asarray(rng.standard_normal((d_in, d_out)).astype(np.float32))}
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal((d_out,)).astype(np.float32))
    qp = jax.device_get(quantize_linear(p))
    x = rng.standard_normal((3, 5, d_in)).astype(np.float32)
    want = np.asarray(linear(qp, jnp.asarray(x)))
    lin = Linear(d_in, d_out, bias, "cpu", torch.float32)
    lin.set_quantized_(torch.from_numpy(np.asarray(qp["kernel_q"]).T.copy()),
                       torch.from_numpy(_f32(qp["kernel_scale"]).reshape(-1)))
    if bias:
        with torch.no_grad():
            lin.bias.copy_(torch.from_numpy(np.asarray(qp["bias"])))
    assert lin.weight is None
    got = lin(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    # the port's own quantization of the same kernel: scales bitwise, codes ±1
    ref = Linear(d_in, d_out, bias, "cpu", torch.float32)
    with torch.no_grad():
        ref.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
    ref.quantize_()
    np.testing.assert_array_equal(ref.weight_scale.float().numpy(),
                                  _f32(qp["kernel_scale"]).reshape(-1))
    diff = ref.weight_q.numpy().astype(np.int32) - np.asarray(qp["kernel_q"]).T.astype(np.int32)
    assert np.abs(diff).max() <= 1
    # dequantize_linear is vlrlhf_tpu's dequantize_linear transposed
    from vlrlhf_tpu.ops.quant import dequantize_linear

    np.testing.assert_allclose(
        tq.dequantize_linear(lin.weight_q, lin.weight_scale, torch.float32).numpy(),
        np.asarray(dequantize_linear(qp, jnp.float32)["kernel"]).T, atol=TOL, rtol=TOL)


def test_lora_applies_on_top_of_an_int8_linear():
    from vlrlhf_torch.models.common import Ctx

    rng = np.random.default_rng(5)
    lin = Linear(16, 12, False, "cpu", torch.float32)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(rng.standard_normal((12, 16)).astype(np.float32)))
    lin.quantize_()
    a = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((4, 12)).astype(np.float32))
    lin.lora_a, lin.lora_b = torch.nn.Parameter(a), torch.nn.Parameter(b)
    x = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    base = x @ lin.weight_q.float().T * lin.weight_scale.float()
    got = lin(x, Ctx(adapters=True, lora_scale=0.5))
    torch.testing.assert_close(got, base + (x @ a @ b) * 0.5, atol=TOL, rtol=TOL)
    torch.testing.assert_close(lin(x, Ctx()), base, atol=TOL, rtol=TOL)


def test_bridged_int8_weights_round_trip():
    """vlrlhf_tpu's quantized params bridged into the port: the int8 leaves
    read back from the modules bitwise, and the empty-prefill forward on
    them matches vlrlhf_tpu's within 1e-4 (f32)."""
    from vlrlhf_tpu.models.vlm import vlm_forward
    from vlrlhf_tpu.ops.quant import DEFAULT_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    jcfg, params, _ = ported(seed=6)
    qparams = jax.device_get(quantize_params(params, DEFAULT_QUANT_PATTERNS))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, qparams)
    lm = qparams["lm"]
    for i, layer in enumerate(model.lm.layers):
        for name, group in (("wq", "attn"), ("down", "mlp")):
            mod, src = getattr(layer, name), lm["layers_scanned"][group][name]
            assert mod.weight is None
            np.testing.assert_array_equal(mod.weight_q.numpy().T, np.asarray(src["kernel_q"])[i])
            np.testing.assert_array_equal(mod.weight_scale.float().numpy(),
                                          _f32(src["kernel_scale"])[i].reshape(-1))
    assert model.lm.lm_head.weight is None and model.vision.layers[0].wq.weight is not None
    ids, pad, lens, px, pos = prompt_batch(seed=2)
    s = ids.shape[1]
    want, _ = vlm_forward(
        jcfg, qparams, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
        image_positions=jnp.asarray(pos), pad_mask=jnp.asarray(pad),
        positions=jnp.broadcast_to(jnp.arange(s)[None], ids.shape), cache_len=64,
    )
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(ids), torch.from_numpy(px), torch.from_numpy(pos),
                          torch.from_numpy(pad), cache_len=64)
        got = model.head(hidden).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n], atol=1e-4, rtol=1e-4)
