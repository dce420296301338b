"""The Qwen-VL and InternLM-XC2 model pieces in vlrlhf_torch against
vlrlhf_tpu, f32 on the CPU, on the scaled-down family configs with the JAX
weights bridged into the port (tests/test_torch_families.py `family_port`:
3 x 3 tower tables, XC2's PLoRA tree):
  - `interpolate_pos_embed` at 1e-6 (and against F.interpolate's bicubic);
  - both tower layouts (Qwen's: no class token, pre-norm, no post-norm,
    tanh GELU; XC2's: the class row kept apart, every layer, no post-norm)
    and the resampler projector at 1e-5;
  - Qwen's LM with the fused-qkv bias and the dynamic-NTK rope past a
    max_position_embeddings of 32: the empty prefill, two decode steps and
    a verify chunk at 1e-5 (the rope without NTK scaling differs).
PLoRA: tests/test_torch_plora.py; PLoRA and the bias under fused and
quantized bases: tests/test_torch_qwen_xc2_quant.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_families import family_port

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("g_old,g_new", [(3, 4), (24, 35), (16, 32), (5, 3)])
def test_interpolate_pos_embed_matches_jax(g_old, g_new):
    import torch.nn.functional as F

    from vlrlhf_tpu.ops.image import interpolate_pos_embed as jinterp
    from vlrlhf_torch.ops.image import interpolate_pos_embed

    table = np.random.default_rng(g_old).standard_normal((g_old * g_old, 8)).astype(np.float32)
    got = interpolate_pos_embed(_t(table), g_new * g_new).numpy()
    np.testing.assert_allclose(got, np.asarray(jinterp(jnp.asarray(table), g_new * g_new)),
                               atol=1e-6, rtol=1e-6)
    grid = _t(table).reshape(1, g_old, g_old, 8).permute(0, 3, 1, 2)
    ref = F.interpolate(grid, size=(g_new, g_new), mode="bicubic", align_corners=False)
    np.testing.assert_allclose(got, ref[0].permute(1, 2, 0).reshape(-1, 8).numpy(), atol=1e-5)
    same = _t(table)
    assert interpolate_pos_embed(same, g_old * g_old) is same
    with pytest.raises(ValueError, match="non-square"):
        interpolate_pos_embed(_t(table), 10)


@pytest.mark.parametrize("family", ["qwen_vl", "internlm_xc2"])
def test_tower_and_projector_match_jax(family):
    from vlrlhf_tpu.models.vlm import projector_forward
    from vlrlhf_tpu.models.vision.vit import vit_forward

    jcfg, params, model = family_port(family, seed=3)
    assert model.vision.pos_embed.shape[0] == 9 + int(jcfg.vision.use_class_token)
    px = np.random.default_rng(1).standard_normal((2, 16, 16, 3)).astype(np.float32)
    want = jax.jit(functools.partial(vit_forward, jcfg.vision))(params["vision"],
                                                                jnp.asarray(px))
    with torch.no_grad():
        got = model.vision(_t(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    proj = jax.jit(functools.partial(projector_forward, jcfg.projector))(
        params["projector"], want)
    with torch.no_grad():
        tproj = model.projector(got)
    assert tproj.shape == (2, jcfg.num_image_tokens, jcfg.lm.hidden_size)
    np.testing.assert_allclose(tproj.numpy(), np.asarray(proj), atol=TOL, rtol=TOL)


def test_resampler_sincos_table_and_init():
    from vlrlhf_tpu.models.vision.resampler import sincos_2d_pos_embed as jsincos
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.vision.resampler import sincos_2d_pos_embed
    from vlrlhf_torch.models.vlm import VLM

    np.testing.assert_array_equal(sincos_2d_pos_embed(32, 16), jsincos(32, 16))
    model = init_random_(VLM(scale_down(FAMILIES["qwen_vl"].make_config())),
                         torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(model.projector.resampler.pos_embed.numpy(),
                                  jsincos(32, 2))
    assert model.projector.proj.bias is None and model.projector.resampler.kv_proj is not None


def _qwen_lm(max_pos=32, seed=4):
    """(jax cfg, params, port model): the scaled-down Qwen-VL with a short
    trained context, so the dynamic-NTK rope rescales its base."""
    from tests.test_torch_families import _jax_family, _jax_init
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    jcfg, _ = _jax_family("qwen_vl", 0)
    jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(
        jcfg.lm, max_position_embeddings=max_pos))
    params = jax.device_get(_jax_init(jcfg)(jax.random.PRNGKey(seed)))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, params)
    return jcfg, params, model


def test_qwen_lm_bias_and_dynamic_ntk_match_jax():
    """Prefill 40 tokens into a 64-slot cache (past max_position_embeddings
    32: alpha 2), two decode steps, then a 3-token verify chunk returning
    every position's logits; the qkv biases are non-zero."""
    from vlrlhf_tpu.generate.engine import _empty_pending
    from vlrlhf_tpu.models.lm.llama import lm_decode, lm_prefill_chunk
    from vlrlhf_tpu.models.vlm import vlm_forward
    from vlrlhf_torch.models.lm.llama import empty_pending

    jcfg, params, model = _qwen_lm()
    rng = np.random.default_rng(2)
    lm = params["lm"]["layers_scanned"]["attn"]
    for name in ("wq", "wk", "wv"):
        lm[name]["bias"] = rng.standard_normal(lm[name]["bias"].shape).astype(np.float32) * 0.1
    from vlrlhf_torch.utils.bridge import load_vlm_params

    load_vlm_params(model, params)
    assert float(model.lm.layers[0].wk.bias.abs().sum()) > 0
    s, cache_len = 40, 64
    lens = np.asarray([40, 33], np.int32)
    ids = rng.integers(4, 200, (2, s)).astype(np.int32)
    pad = np.arange(s)[None] < lens[:, None]
    fwd = jax.jit(lambda cfg, p, i, m: vlm_forward(cfg, p, input_ids=i, pad_mask=m,
                                                   cache_len=cache_len), static_argnums=0)
    want, jcache = fwd(jcfg, params, jnp.asarray(ids), jnp.asarray(pad))
    with torch.no_grad():
        hidden, tcache = model(_t(ids), pad_mask=_t(pad), cache_len=cache_len)
        got = model.head(hidden).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n], atol=TOL, rtol=TOL)
    model.lm.cfg = dataclasses.replace(model.lm.cfg, rope_scaling_type="none")
    with torch.no_grad():
        plain = model.head(model(_t(ids), pad_mask=_t(pad), cache_len=cache_len)[0]).numpy()
    model.lm.cfg = model.cfg.lm
    assert np.abs(plain - got)[0, 39].max() > 1e-3  # the rescaled base matters here
    jlm = jcfg.lm
    jpend, tpend = _empty_pending(jlm, 2, cache_len), empty_pending(model.cfg.lm, 2, cache_len,
                                                                   "cpu")
    tok, jlen, tlen = np.asarray([7, 42], np.int32), jnp.asarray(lens), _t(lens)
    jdecode = jax.jit(functools.partial(lm_decode, jlm))
    for _ in range(2):
        jlog, jcache, jpend = jdecode(params["lm"], last_token=jnp.asarray(tok),
                                      lengths=jlen, cache=jcache, pending=jpend)
        with torch.no_grad():
            tlog, tpend = model.lm.decode(_t(tok), tlen, tcache, tpend)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog)[:, 0], atol=TOL, rtol=TOL)
        tok = np.asarray(jnp.argmax(jlog[:, 0], -1), np.int32)
        jlen, tlen = jlen + 1, tlen + 1
    chunk = np.asarray([[5, 6, 7], [8, 9, 10]], np.int32)
    clens = np.asarray([3, 3], np.int32)
    jl, _, _ = jax.jit(functools.partial(lm_prefill_chunk, jlm, return_all_logits=True))(
        params["lm"], input_ids=jnp.asarray(chunk), chunk_lens=jnp.asarray(clens),
        lengths=jlen, cache=jcache, pending=jpend)
    with torch.no_grad():
        tl, _ = model.lm.prefill_chunk(_t(chunk), _t(clens), tlen, tcache, pending=tpend,
                                       return_all_logits=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
