"""Qwen-VL's fused-qkv bias and InternLM-XC2's PLoRA under int8 and int4
bases in vlrlhf_torch against vlrlhf_tpu, on the CPU: 128-wide
scaled-down LMs (intermediate 256, so every LM linear and lm_head takes
int4), the JAX tree quantized by vlrlhf_tpu and bridged into the port
(PLoRA stays f32 beside the codes, as it stays bf16 on the card). Prefill
logits against vlrlhf_tpu's (int4 at tests/test_torch_int4.py's
MODEL_TOL, int8 at 1e-4; int8's greedy tokens identical in both
packages), then the port fused (`--fuse_decode`: the bias concatenated,
PLoRA fused block diagonal) equal to unfused in logits and tokens."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from tests.test_torch_families import _jax_init
from tests.test_torch_int4 import no_jax_mesh  # noqa: F401 (autouse)
from tests.test_torch_plora import TOL, _jax_logits, _port_logits, _xc2_batch

MODEL_TOL = 5e-3  # int4 linears round their input to bf16 in both packages


def _wide(family: str, bits: int, seed: int = 30):
    """(jax cfg, params, port model): `family` scaled down with a 128-wide LM
    (intermediate 256, so every LM linear and lm_head takes int4), its LM
    linears and lm_head quantized by vlrlhf_tpu (bits 8 or 4; 0 keeps f32),
    non-zero Qwen qkv biases, XC2's PLoRA; bridged into the port."""
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.models.registry import scale_down
    from vlrlhf_tpu.ops.quant import DEFAULT_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    jcfg = scale_down(JF[family].make_config())
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(
        jcfg.lm, hidden_size=128, intermediate_size=256, head_dim=32),
        projector=dataclasses.replace(jcfg.projector, out_dim=128))
    params = _jax_init(jcfg)(jax.random.PRNGKey(seed))
    if jcfg.lm.qkv_bias:
        attn = params["lm"]["layers_scanned"]["attn"]
        for k, name in enumerate(("wq", "wk", "wv")):
            attn[name]["bias"] = 0.1 * jax.random.normal(jax.random.PRNGKey(seed + k),
                                                         attn[name]["bias"].shape)
    if jcfg.plora:
        plora = init_lora(params, LoraConfig(r=4, alpha=4.0, target_patterns=(
            r"lm/.*attn/", r"lm/.*mlp/")), jax.random.PRNGKey(seed + 5))
        params["plora"] = jax.tree.map(lambda x: x + 0.02, plora)
    if bits:
        params = jax.jit(functools.partial(quantize_params, patterns=DEFAULT_QUANT_PATTERNS,
                                           bits=bits))(params)
    params = jax.device_get(params)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, params)
    return jcfg, params, model


@pytest.mark.parametrize("family,bits", [("internlm_xc2", 8), ("internlm_xc2", 4),
                                         ("qwen_vl", 4)])
def test_plora_and_bias_under_fused_quantized_bases(family, bits):
    _check_quantized(family, bits)


def _check_quantized(family: str, bits: int) -> None:
    """XC2's PLoRA (f32 here, beside int8 / int4 codes) and
    Qwen's fused-wqkv bias: prefill logits against vlrlhf_tpu's, greedy
    tokens fused equal to unfused (and to vlrlhf_tpu's under int8)."""
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGC
    from vlrlhf_tpu.generate.engine import Generator as JGen
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.models.lm.fuse import fuse_lm_

    jcfg, params, model = _wide(family, bits)
    layer = model.lm.layers[0]
    assert (layer.wq.weight_q4 is not None) == (bits == 4)
    assert (layer.wq.plora_a is not None) == (family == "internlm_xc2")
    ids, pad, px, pos = _xc2_batch(jcfg, seed=2)
    tol = MODEL_TOL if bits == 4 else 1e-4
    want, _ = _jax_logits(jcfg, params, ids, pad, px, pos, cache_len=64)
    got, _ = _port_logits(model, ids, pad, px, pos, cache_len=64)
    err = np.abs(got[pad] - want[pad]).max() / np.abs(want[pad]).max()
    assert err <= tol, err
    batch = {"input_ids": ids, "pad_mask": pad, "prompt_lens": pad.sum(1).astype(np.int32),
             "pixel_values": px, "image_positions": pos}
    gen = Generator(model, GenerateConfig(max_new_tokens=5, pad_token_id=-1))
    want_tok = gen(batch).numpy()
    if bits == 8:  # vlrlhf_tpu's int4 engine runs its Pallas kernel in interpret mode here
        jgen = JGen(jcfg, JGC(max_new_tokens=5, pad_token_id=-1))
        np.testing.assert_array_equal(want_tok, np.asarray(jgen(params, batch)))
    fuse_lm_(model.lm)
    assert model.lm.layers[0].wqkv.bias is not None or family != "qwen_vl"
    assert (model.lm.layers[0].wqkv.plora_a is not None) == (family == "internlm_xc2")
    fused, _ = _port_logits(model, ids, pad, px, pos, cache_len=64)
    np.testing.assert_allclose(fused[pad], got[pad], atol=1e-5 * max(1, np.abs(got).max()),
                               rtol=1e-5)
    np.testing.assert_array_equal(gen(batch).numpy(), want_tok)
