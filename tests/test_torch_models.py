"""vlrlhf_torch models vs vlrlhf_tpu on the same weights (bridged from the
JAX param tree) and the same numpy inputs, f32 on CPU, tolerance 1e-4:
the vision tower, the projector, the empty-prefill VLM forward (hidden
states at valid positions, cache slots below the prompt length) and one
decode step (logits and the deferred k/v)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import IMG_TOKEN, N_IMG_TOKENS, tiny_vlm_config
from vlrlhf_tpu.models.lm.llama import lm_decode
from vlrlhf_tpu.models.vision.vit import vit_forward
from vlrlhf_tpu.models.vlm import init_vlm_params, projector_forward, vlm_forward
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

TOL = 1e-4


def ported(jcfg=None, seed=0):
    """(jax cfg, jax params, port model) sharing one set of weights."""
    jcfg = jcfg or tiny_vlm_config()
    params = init_vlm_params(jcfg, jax.random.PRNGKey(seed))
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    return jcfg, params, model


def prompt_batch(seed=0, lens=(30, 22), seq=32):
    """Right-padded image prompts: ids, pad mask, prompt lens, pixels
    (B, 1, 16, 16, 3) f32 in [0, 1], image positions."""
    rng = np.random.default_rng(seed)
    b = len(lens)
    ids = rng.integers(4, 100, (b, seq)).astype(np.int32)
    pos = np.broadcast_to(np.arange(2, 2 + N_IMG_TOKENS, dtype=np.int32), (b, N_IMG_TOKENS)).copy()
    ids[:, 2:2 + N_IMG_TOKENS] = IMG_TOKEN
    pad = np.arange(seq)[None] < np.asarray(lens)[:, None]
    ids = np.where(pad, ids, 0).astype(np.int32)
    pixels = (rng.integers(0, 255, (b, 1, 16, 16, 3)) / 255.0).astype(np.float32)
    return ids, pad, np.asarray(lens, np.int32), pixels, pos


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_vision_tower_and_projector():
    jcfg, params, model = ported()
    rng = np.random.default_rng(1)
    px = rng.standard_normal((2, 16, 16, 3)).astype(np.float32)
    jfeat = vit_forward(jcfg.vision, params["vision"], jnp.asarray(px))
    with torch.no_grad():
        tfeat = model.vision(_t(px))
    np.testing.assert_allclose(tfeat.numpy(), np.asarray(jfeat), atol=TOL, rtol=TOL)
    jproj = projector_forward(jcfg.projector, params["projector"], jfeat)
    with torch.no_grad():
        tproj = model.projector(tfeat)
    np.testing.assert_allclose(tproj.numpy(), np.asarray(jproj), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu"])
def test_vision_tower_activations_and_uint8_encode(act):
    """Both tower activations (gelu is jax's tanh approximation) and the
    uint8 rescale+normalize path of encode_images."""
    import dataclasses

    from vlrlhf_tpu.models.vlm import encode_images

    base = tiny_vlm_config()
    jcfg = dataclasses.replace(base, vision=dataclasses.replace(base.vision, act=act))
    jcfg, params, model = ported(jcfg, seed=3)
    px = np.random.default_rng(2).integers(0, 255, (2, 16, 16, 3)).astype(np.uint8)
    want = encode_images(jcfg, params, jnp.asarray(px))
    with torch.no_grad():
        got = model.encode_images(_t(px))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_vlm_forward_empty_prefill():
    jcfg, params, model = ported()
    ids, pad, lens, px, pos = prompt_batch()
    cache_len = 64
    s = ids.shape[1]
    jhidden, jcache = vlm_forward(
        jcfg, params, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
        image_positions=jnp.asarray(pos), pad_mask=jnp.asarray(pad),
        positions=jnp.broadcast_to(jnp.arange(s)[None], ids.shape),
        cache_len=cache_len, return_logits=False,
    )
    with torch.no_grad():
        thidden, tcache = model(_t(ids), _t(px), _t(pos), _t(pad), cache_len=cache_len)
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(thidden[i, :n].numpy(), np.asarray(jhidden)[i, :n],
                                   atol=TOL, rtol=TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(
                tcache[key][:, i, :, :n].numpy(), np.asarray(jcache[key])[:, i, :, :n],
                atol=TOL, rtol=TOL,
            )
    # head on the valid rows
    jlog = np.asarray(jhidden @ params["lm"]["lm_head"]["kernel"])
    with torch.no_grad():
        tlog = model.head(thidden).numpy()
    for i, n in enumerate(lens):
        np.testing.assert_allclose(tlog[i, :n], jlog[i, :n], atol=TOL, rtol=TOL)


def test_lm_decode_step_with_pending():
    """Two decode steps: the first runs with nothing pending (pos == Sc, a
    dropped write in JAX, a masked write here), the second lands the first
    step's deferred k/v; logits and pending k/v match after each."""
    jcfg, params, model = ported()
    ids, pad, lens, px, pos = prompt_batch(seed=5)
    cache_len = 64
    s = ids.shape[1]
    _, jcache = vlm_forward(
        jcfg, params, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
        image_positions=jnp.asarray(pos), pad_mask=jnp.asarray(pad),
        positions=jnp.broadcast_to(jnp.arange(s)[None], ids.shape),
        cache_len=cache_len, return_logits=False,
    )
    with torch.no_grad():
        _, tcache = model(_t(ids), _t(px), _t(pos), _t(pad), cache_len=cache_len)
    from vlrlhf_tpu.generate.engine import _empty_pending
    from vlrlhf_torch.models.lm.llama import empty_pending

    lm = jcfg.lm
    jpend = _empty_pending(lm, len(lens), cache_len)
    tpend = empty_pending(model.cfg.lm, len(lens), cache_len, "cpu")
    tok = np.asarray([7, 42], np.int32)
    jlen, tlen = jnp.asarray(lens), _t(lens)
    for _ in range(2):
        jlog, jcache, jpend = lm_decode(lm, params["lm"], last_token=jnp.asarray(tok),
                                        lengths=jlen, cache=jcache, pending=jpend)
        with torch.no_grad():
            tlog, tpend = model.lm.decode(_t(tok), tlen, tcache, tpend)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog)[:, 0], atol=TOL, rtol=TOL)
        for key in ("k", "v"):
            np.testing.assert_allclose(tpend[key].numpy(), np.asarray(jpend[key]),
                                       atol=TOL, rtol=TOL)
        np.testing.assert_array_equal(tpend["pos"].numpy(), np.asarray(jpend["pos"]))
        tok = np.asarray(jnp.argmax(jlog[:, 0], -1), np.int32)
        jlen, tlen = jlen + 1, tlen + 1
    # the first step's pending write landed at slot lens[b] in both caches
    for i, n in enumerate(lens):
        np.testing.assert_allclose(tcache["k"][:, i, :, : n + 1].numpy(),
                                   np.asarray(jcache["k"])[:, i, :, : n + 1], atol=TOL, rtol=TOL)


def test_embed_clamps_out_of_vocab_ids():
    from vlrlhf_torch.models.common import embed

    table = torch.arange(12.0).reshape(4, 3)
    out = embed(table, torch.tensor([[0, 3, 9, -2]]), torch.float32)
    torch.testing.assert_close(out[0], table[[0, 3, 3, 0]])
