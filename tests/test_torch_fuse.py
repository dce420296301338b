"""The fused serving layout (`--fuse_decode`): vlrlhf_torch/models/lm/fuse.py
vs vlrlhf_tpu/models/lm/fuse.py on the 128-wide tiny LLaVA, f32 on the
CPU, with f32, int8 and int4 LM linears bridged from vlrlhf_tpu.

Fusion concatenates along `out`, so every output column is computed as
before: the port's fused logits equal its unfused ones within 1e-5, and
greedy tokens are identical in both packages, fused and unfused. The
concatenated int4 leaves match vlrlhf_tpu's `_concat_linears` byte for
byte (gbias zero-filled for a symmetric part); a part without a bias
contributes zeros."""

import numpy as np
import pytest
import torch

from tests.test_torch_int4 import int4_ported
from tests.test_torch_models import prompt_batch
from vlrlhf_torch.generate.engine import GenerateConfig, Generator
from vlrlhf_torch.models.common import Linear
from vlrlhf_torch.models.lm.fuse import concat_linears, fuse_lm_

TOL = 1e-5


def _logits(model, ids, pad, px, pos):
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(ids), torch.from_numpy(px), torch.from_numpy(pos),
                          torch.from_numpy(pad), cache_len=64)
        return model.head(hidden).numpy()


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_fused_matches_unfused_in_both_packages(bits):
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator
    from vlrlhf_tpu.models.lm.fuse import fuse_vlm_params

    jcfg, params, model = int4_ported(bits=bits, seed=21)
    ids, pad, lens, px, pos = prompt_batch(seed=8)
    batch = {"input_ids": ids, "pad_mask": pad, "prompt_lens": lens,
             "pixel_values": px, "image_positions": pos}
    jgen = JGenerator(jcfg, JGenerateConfig(max_new_tokens=6, pad_token_id=-1))
    want = np.asarray(jgen(params, batch))
    want_fused = np.asarray(jgen(fuse_vlm_params(params), batch))
    gen = Generator(model, GenerateConfig(max_new_tokens=6, pad_token_id=-1))
    before = _logits(model, ids, pad, px, pos)
    got = gen(batch).numpy()
    fuse_lm_(model.lm)
    layer = model.lm.layers[0]
    assert layer.wq is None and layer.gate is None and layer.wqkv.d_out == 3 * 128
    assert (layer.wqkv.weight_q4 is not None) == (bits == 4)
    assert (layer.gateup.weight_q is not None) == (bits == 8)
    after = _logits(model, ids, pad, px, pos)
    got_fused = gen(batch).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(after[i, :n], before[i, :n], atol=TOL, rtol=TOL)
    for tokens in (want_fused, got, got_fused):
        np.testing.assert_array_equal(tokens, want)
    assert fuse_lm_(model.lm) is model.lm and model.lm.layers[0].wqkv is layer.wqkv  # idempotent


def _int4_leaf(seed, d_out, bias: bool, asym: bool):
    """A vlrlhf_tpu int4 linear leaf of in=128, from GPTQ (with gbias) or
    from its RTN quantizer."""
    import jax

    from tests.test_gptq import _synth
    from vlrlhf_tpu.ops.int4 import quantize_linear_int4
    from vlrlhf_tpu.utils.gptq import convert_gptq_linear, pack_gptq_reference

    rng = np.random.default_rng(seed)
    if asym:
        q, z, s = _synth(seed, din=128, dout=d_out, gsz=64)
        p = dict(convert_gptq_linear(*pack_gptq_reference(q, z, s, 64)))
    else:
        p = jax.device_get(quantize_linear_int4(
            {"kernel": rng.standard_normal((128, d_out)).astype(np.float32) * 0.1}))
    if bias:
        p["bias"] = rng.standard_normal((d_out,)).astype(np.float32)
    return {k: np.asarray(v) for k, v in p.items()}


def test_concat_linears_matches_jax_concat():
    import jax

    from vlrlhf_tpu.models.lm.fuse import _concat_linears
    from vlrlhf_torch.utils.bridge import _linear

    # biases on every part: vlrlhf_tpu's `_concat_linears` zero-fills a
    # missing bias only for dense and int8 parts (it raises on int4 ones);
    # the port's zero-fill is checked through the outputs below
    leaves = [_int4_leaf(1, 64, True, False), _int4_leaf(2, 32, True, True),
              _int4_leaf(3, 32, True, False)]
    want = jax.device_get(_concat_linears(leaves))
    parts = []
    for p in leaves:
        lin = Linear(128, p["kernel_q4"].shape[1], "bias" in p, "cpu", torch.float32)
        _linear(lin, p)
        parts.append(lin)
    fused = concat_linears(parts)
    assert fused.d_out == 128 and fused.weight is None
    np.testing.assert_array_equal(fused.weight_q4.numpy(), np.asarray(want["kernel_q4"]).T)
    for name, key in (("weight_scale4", "kernel_scale"), ("weight_gbias", "kernel_gbias")):
        np.testing.assert_array_equal(getattr(fused, name).float().numpy(),
                                      np.asarray(want[key], np.float32).T)
    np.testing.assert_array_equal(fused.bias.numpy(), np.asarray(want["bias"], np.float32))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 128)).astype(np.float32))
    torch.testing.assert_close(fused(x), torch.cat([p(x) for p in parts], dim=1),
                               atol=TOL, rtol=TOL)
    parts[1].bias = None  # a part without a bias: zeros in its columns
    fused = concat_linears(parts)
    assert float(fused.bias[64:96].abs().max()) == 0.0
    torch.testing.assert_close(fused(x), torch.cat([p(x) for p in parts], dim=1),
                               atol=TOL, rtol=TOL)


def test_fusion_refuses_adapters_and_mixed_kinds():
    _, _, model = int4_ported(bits=4, seed=22)
    layer = model.lm.layers[0]
    layer.wk.lora_a = torch.nn.Parameter(torch.zeros(128, 2))
    layer.wk.lora_b = torch.nn.Parameter(torch.zeros(2, 128))
    with pytest.raises(ValueError, match="LoRA adapter"):
        fuse_lm_(model.lm)
    dense = Linear(128, 8, False, "cpu", torch.float32)
    with pytest.raises(ValueError, match="one kind"):
        concat_linears([model.lm.layers[1].wq, dense])
    layer.wk.lora_a = layer.wk.lora_b = None
    fuse_lm_(model.lm)
    layer.wqkv.lora_a = torch.nn.Parameter(torch.zeros(128, 2))
    layer.wqkv.lora_b = torch.nn.Parameter(torch.zeros(2, 3 * 128))
    with pytest.raises(ValueError, match="LoRA adapter"):
        layer.qkv(torch.zeros(1, 2, 128))


def test_build_server_int4_fused_on_the_wide_model(monkeypatch):
    """build_server with --quantize int4 --fuse_decode true on the 128-wide
    model: int4 wqkv / gateup / wo / down / lm_head, /generate answers, the
    plain version runs and no kernel launch is counted."""
    import threading

    from tests.test_torch_qlora import _count_plain, wide_bundle
    from tests.test_torch_serving import _seeded_image
    from tests.test_torch_serving_spec import _post, _serve_args
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.ops import int4 as t4

    cfg, model, proc = wide_bundle(seed=5)
    calls = _count_plain(monkeypatch)
    launches = t4.int4_matmul.launches
    httpd, srv = build_server(cfg, model, proc,
                              _serve_args(quantize="int4", fuse_decode=True, synthetic=0),
                              _seeded_image)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        layer = model.lm.layers[1]
        assert all(m.weight_q4 is not None for m in
                   (layer.wqkv, layer.gateup, layer.wo, layer.down, model.lm.lm_head))
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        res = _post(url, "/generate", {"question": "what is shown?", "image": "img0.png",
                                       "max_new_tokens": 4})
        assert res["tokens"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
    # per forward: 4 fused products per layer and the head
    assert calls["fwd"] >= 2 * 4 + 1 and t4.int4_matmul.launches == launches
