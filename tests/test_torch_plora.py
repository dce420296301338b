"""InternLM-XC2's PLoRA in vlrlhf_torch against vlrlhf_tpu, f32 on the CPU,
on the scaled-down family config with the JAX weights and PLoRA tree
bridged into the port (tests/test_torch_families.py `family_port`):
  - gated to the image positions, active in the adapter-off reference
    forward, absent from text-only rows, while trainable LoRA acts at every
    position (vlrlhf_tpu's test_plora_base_adapters_gated_to_image_positions);
  - absent from decode steps and chunk prefills, even under a Ctx that
    carries a mask: their logits equal vlrlhf_tpu's lm_decode /
    lm_prefill_chunk (which drop base_adapters) from the same caches;
  - through the static and continuous engines and beside a stacked
    adapter set.
Under int8 and int4 bases, fused and unfused:
tests/test_torch_qwen_xc2_quant.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests.test_torch_families import family_port
from vlrlhf_torch.models.common import Ctx

TOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _xc2_batch(jcfg, seed=0, image=True):
    rng = np.random.default_rng(seed)
    n, s = jcfg.num_image_tokens, 30
    px = rng.integers(0, 255, (2, 1, 16, 16, 3)).astype(np.uint8)
    pos = np.broadcast_to(np.arange(3, 3 + n, dtype=np.int32), (2, n)).copy()
    if not image:
        pos[:] = -1
    ids = rng.integers(4, 200, (2, s)).astype(np.int32)
    pad = np.ones((2, s), bool)
    pad[1, s - 6:] = False
    return ids, pad, px, pos


@functools.lru_cache(maxsize=None)
def _jax_runner(jcfg, scale: float, cache_len):
    """vlrlhf_tpu's vlm_forward under a Ctx with `adapters`, jitted once per
    (config, scale, cache_len)."""
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.models.vlm import vlm_forward

    @jax.jit
    def run(params, adapters, ids, px, pos, pad):
        return vlm_forward(jcfg, params, input_ids=ids, pixel_values=px, image_positions=pos,
                           pad_mask=pad, cache_len=cache_len,
                           ctx=JCtx(adapters=adapters, lora_scale=scale))

    return run


def _jax_logits(jcfg, params, ids, pad, px, pos, adapters=None, scale=1.0, cache_len=None):
    out, cache = _jax_runner(jcfg, scale, cache_len)(
        params, adapters, *(jnp.asarray(a) for a in (ids, px, pos, pad)))
    return np.asarray(out), cache


def _port_logits(model, ids, pad, px, pos, ctx=None, cache_len=None):
    with torch.no_grad():
        hidden, cache = model(_t(ids), _t(px), _t(pos), _t(pad), ctx=ctx, cache_len=cache_len)
        return model.head(hidden, ctx).numpy(), cache


def test_plora_gated_to_image_positions_like_jax():
    """vlrlhf_tpu's test_plora_base_adapters_gated_to_image_positions on
    the port: PLoRA acts in the base forward (adapters off) at the image
    positions only; trainable LoRA acts everywhere."""
    from vlrlhf_torch.models.common import Linear, image_position_mask

    jcfg, params, model, lcfg, adapters = family_port("internlm_xc2", seed=5, lora=True)
    assert sum(m.plora_a is not None for m in model.modules() if isinstance(m, Linear)) == \
        7 * jcfg.lm.num_layers
    bare = {k: v for k, v in params.items() if k != "plora"}
    for image in (True, False):
        ids, pad, px, pos = _xc2_batch(jcfg, image=image)
        want, _ = _jax_logits(jcfg, params, ids, pad, px, pos)
        got, _ = _port_logits(model, ids, pad, px, pos, ctx=Ctx(adapters=False))
        np.testing.assert_allclose(got[pad], want[pad], atol=TOL, rtol=TOL)
        base, _ = _jax_logits(jcfg, bare, ids, pad, px, pos)
        assert np.allclose(base, want, atol=1e-5) != image  # moves only with image positions
        want_on, _ = _jax_logits(jcfg, params, ids, pad, px, pos, adapters, lcfg.scale)
        got_on, _ = _port_logits(model, ids, pad, px, pos,
                                 ctx=Ctx(adapters=True, lora_scale=lcfg.scale))
        np.testing.assert_allclose(got_on[pad], want_on[pad], atol=TOL, rtol=TOL)
        assert not np.allclose(got_on, got, atol=1e-4)  # LoRA acts on text rows too
    mask = image_position_mask(_t(np.asarray([[1, 3, -1], [0, -1, -1]])), 4)
    np.testing.assert_array_equal(mask.numpy(), [[0, 1, 0, 1], [1, 0, 0, 0]])


def test_plora_absent_from_decode_and_chunks_like_jax():
    """The prefill applies PLoRA at the image positions; the decode step and
    a chunk prefill do not, even when handed a Ctx that carries a mask:
    their logits equal vlrlhf_tpu's lm_decode / lm_prefill_chunk (which
    drop base_adapters) from the same caches."""
    from vlrlhf_tpu.generate.engine import _empty_pending
    from vlrlhf_tpu.models.lm.llama import lm_decode, lm_prefill_chunk
    from vlrlhf_torch.models.lm.llama import empty_pending

    jcfg, params, model = family_port("internlm_xc2", seed=6)
    ids, pad, px, pos = _xc2_batch(jcfg, seed=1)
    lens = pad.sum(1).astype(np.int32)
    want, jcache = _jax_logits(jcfg, params, ids, pad, px, pos, cache_len=64)
    got, tcache = _port_logits(model, ids, pad, px, pos, cache_len=64)
    for i, n in enumerate(lens):
        np.testing.assert_allclose(got[i, :n], want[i, :n], atol=TOL, rtol=TOL)
    stale = Ctx(lora_mask=torch.ones((2, 1)))  # a mask must not reach a decode step
    lm = jcfg.lm
    tok = np.asarray([7, 42], np.int32)
    jlog, jcache, jpend = lm_decode(lm, params["lm"], last_token=jnp.asarray(tok),
                                    lengths=jnp.asarray(lens), cache=jcache,
                                    pending=_empty_pending(lm, 2, 64))
    with torch.no_grad():
        tlog, tpend = model.lm.decode(_t(tok), _t(lens), tcache,
                                      empty_pending(model.cfg.lm, 2, 64, "cpu"), ctx=stale)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog)[:, 0], atol=TOL, rtol=TOL)
    chunk = np.asarray([[5, 6, 7], [8, 9, 0]], np.int32)
    clens = np.asarray([3, 2], np.int32)
    jl, _, _ = lm_prefill_chunk(lm, params["lm"], input_ids=jnp.asarray(chunk),
                                chunk_lens=jnp.asarray(clens), lengths=jnp.asarray(lens + 1),
                                cache=jcache, pending=jpend)
    with torch.no_grad():
        tl, _ = model.lm.prefill_chunk(_t(chunk), _t(clens), _t(lens + 1), tcache,
                                       pending=tpend, ctx=Ctx(lora_mask=torch.ones((2, 3))))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)


def test_plora_through_the_engines_like_jax():
    """XC2 with PLoRA: the static Generator's greedy tokens equal
    vlrlhf_tpu's on a batch of three image prompts of different lengths;
    the continuous engine (two slots, prefill groups padded with image
    positions -1, which PLoRA's mask leaves out) gives the same tokens,
    and so does it serving a stacked adapter set beside the base model
    (PLoRA under the set's per-row mix) against static engines that hold
    the set or none."""
    from tests.test_torch_qwen_xc2_train import collate, processor
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGC
    from vlrlhf_tpu.generate.engine import Generator as JGen
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.generate.continuous import ContinuousEngine, request_from_batch
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.utils.bridge import adapter_keys, load_lora_params

    jcfg, params, model = family_port("internlm_xc2", seed=13)
    proc = processor("internlm_xc2", jcfg)
    rows = [proc.generation_row(q, img) for q, img in (
        ("What is in the photo?", "a.jpg"), ("Describe the picture in detail please.", "b.jpg"),
        ("Is there a dog?", "c.jpg"))]
    batch = collate("GenerationCollator", proc, rows)
    gcfg = GenerateConfig(max_new_tokens=6, pad_token_id=-1)
    want = np.asarray(JGen(jcfg, JGC(max_new_tokens=6, pad_token_id=-1))(params, batch))
    base = Generator(model, gcfg)(batch).numpy()
    np.testing.assert_array_equal(base, want)
    reqs = [request_from_batch(collate("GenerationCollator", proc, [r]), 0, True) for r in rows]
    eng = ContinuousEngine(model, gcfg, n_slots=2, cache_len=192, prefill_chunk=16)
    eng.MAX_PREFILL_GROUP = 2
    assert eng.run(reqs) == [[int(t) for t in w if t != -1] for w in want]
    tree = init_lora(params, LoraConfig(r=2, alpha=4.0, target_patterns=(r"lm/.*attn/(wq|wv)/",)),
                     jax.random.PRNGKey(14))
    tree = jax.device_get(jax.tree.map(lambda x: x + 0.05, tree))
    load_lora_params(model, tree)
    gen = Generator(model, gcfg, 2.0)
    gen.adapters = True
    adapted = gen(batch).numpy()
    assert not np.array_equal(adapted, base)
    load_lora_params(model, [tree])  # the model's own adapter gives way to the stacked set
    idx = [0, None, 0]
    for r, i in zip(reqs, idx):
        r.adapter_idx = i
    eng = ContinuousEngine(model, gcfg, n_slots=2, cache_len=192, prefill_chunk=16,
                           adapter_sets=[adapter_keys(tree)], lora_scale=2.0)
    got = eng.run(reqs)
    assert got == [[int(t) for t in (adapted if i == 0 else base)[n] if t != -1]
                   for n, i in enumerate(idx)]
