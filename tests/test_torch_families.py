"""The LLaVA-Next (vicuna, mistral), Qwen-VL, InternLM-XC2 and InstructBLIP
families in vlrlhf_torch against vlrlhf_tpu, f32 on the CPU, tolerance
1e-5, on the scaled-down family configs (models/config.py `scale_down`)
with the JAX weights bridged into the port (utils/bridge.py); Qwen-VL's and
XC2's towers hold a 3 x 3 position table (resized to the 4 x 4 patch grid
in the forward, XC2's beside its class row) and XC2 a PLoRA tree:
  - the family forward: logits of vlm_forward and VLM.forward on the same
    numpy inputs, with anyres gather maps of two image sizes padded to the
    batch's longest (PAD_IDX / -1 slots scatter nowhere) and Q-Former
    instruction ids with a padded mask;
  - encode_images with uint8 pixels (the Q-Former with and without ids);
  - the registry: the 7B configs and their scaled-down versions equal
    vlrlhf_tpu's field for field, `resolve_family` by architecture and
    text model (qwen_vl and internlm_xc2 included), the refusal of an
    unknown architecture, each family's LoRA targets, freeze patterns,
    processor defaults and chat template.

`family_port` is shared with tests/test_torch_anyres.py and
tests/test_torch_instructblip.py."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, vlm_config_from

TOL = 1e-5
FAMILIES = ("llava_next_vicuna", "llava_next_mistral", "qwen_vl", "internlm_xc2",
            "instructblip")
# the scaled-down tile: 16 pixels, patch 4 -> a 4x4 feature grid per tile
PINPOINTS = ((16, 32), (32, 16), (32, 32))
TILE, TILE_GRID = 16, 4


@functools.lru_cache(maxsize=None)
def _jax_init(jcfg):
    """vlrlhf_tpu's init_vlm_params, jitted once per config (the eager init
    dispatches op by op: seconds for the Q-Former)."""
    from vlrlhf_tpu.models.vlm import init_vlm_params

    return jax.jit(functools.partial(init_vlm_params, jcfg))


@functools.lru_cache(maxsize=None)
def _jax_family(family: str, seed: int, lm_overrides: tuple = ()):
    """(jax cfg, jax params) of the scaled-down `family`, built once per
    (family, seed, lm_overrides: (field, value) pairs replaced in its
    LMConfig) and shared by the tests (jax arrays are immutable)."""
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.models.registry import scale_down

    jcfg = scale_down(JF[family].make_config())
    if lm_overrides:
        jcfg = dataclasses.replace(jcfg, lm=dataclasses.replace(jcfg.lm, **dict(lm_overrides)))
    if jcfg.grid_pinpoints:
        jcfg = dataclasses.replace(jcfg, grid_pinpoints=PINPOINTS)
    params = _jax_init(jcfg)(jax.random.PRNGKey(seed))
    if jcfg.grid_pinpoints:
        params["image_newline"] = {"embedding": jax.random.normal(
            jax.random.PRNGKey(seed + 9), (jcfg.lm.hidden_size,))}
    if family in ("qwen_vl", "internlm_xc2"):
        # a checkpoint's table of another grid (3 x 3, + the class row)
        rows = 9 + int(jcfg.vision.use_class_token)
        params["vision"] = dict(params["vision"], pos_embed={"embedding": 0.02 * jax.random.normal(
            jax.random.PRNGKey(seed + 11), (rows, jcfg.vision.hidden_size))})
    if jcfg.plora:  # the checkpoint's PLoRA (params["plora"], cli/loading.py)
        from vlrlhf_tpu.lora.lora import LoraConfig, init_lora

        plora = init_lora(params, LoraConfig(r=2, alpha=2.0, target_patterns=(
            r"lm/.*attn/", r"lm/.*mlp/")), jax.random.PRNGKey(seed + 12))
        params["plora"] = jax.tree.map(lambda x: x + 0.05, plora)
    return jcfg, params


def family_port(family: str, seed: int = 0, lora: bool = False, b_offset: float = 0.01,
                lm_overrides: tuple = ()):
    """(jax cfg, jax params, port model[, lcfg, jax adapters]) sharing one
    set of weights; anyres families get a newline row and the small
    pinpoints (vlrlhf_tpu's tests/test_anyres.py setup). The port's model
    is new on every call; the JAX side is shared (`_jax_family`)."""
    jcfg, params = _jax_family(family, seed, lm_overrides)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    if not lora:
        return jcfg, params, model
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora

    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=(r"lm/.*attn/", r"lm/.*mlp/"))
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(seed + 1))
    if b_offset:  # non-zero adapters: policy != reference
        adapters = jax.tree.map(lambda x: x + b_offset * jnp.ones_like(x), adapters)
    load_lora_params(model, jax.device_get(adapters))
    return jcfg, params, model, lcfg, adapters


def anyres_inputs(rng, sizes=((24, 18), (20, 30)), start=2):
    """Pixels (B, max_tiles, 16, 16, 3) uint8, gather (B, max_tok) and
    image positions (B, max_tok) for images of `sizes`, padded to the
    longest plan."""
    from vlrlhf_torch.models.anyres import PAD_IDX, anyres_plan

    plans = [anyres_plan(s, PINPOINTS, TILE, TILE_GRID) for s in sizes]
    nt = max(p["n_tiles"] for p in plans)
    nk = max(p["n_tokens"] for p in plans)
    b = len(sizes)
    px = rng.integers(0, 255, (b, nt, TILE, TILE, 3)).astype(np.uint8)
    gather = np.full((b, nk), PAD_IDX, np.int32)
    pos = np.full((b, nk), -1, np.int32)
    for i, p in enumerate(plans):
        gather[i, : p["n_tokens"]] = p["gather"]
        pos[i, : p["n_tokens"]] = np.arange(start, start + p["n_tokens"])
    return px, gather, pos, [p["n_tokens"] for p in plans]


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("family", FAMILIES)
def test_family_forward_matches_jax(family):
    from vlrlhf_tpu.models.vlm import vlm_forward

    jcfg, params, model = family_port(family, seed=1)
    rng = np.random.default_rng(0)
    jkw, tkw = {}, {}
    if jcfg.grid_pinpoints:
        px, gather, pos, _ = anyres_inputs(rng)
        s = pos.max() + 6
        jkw["anyres_gather"], tkw["anyres_gather"] = jnp.asarray(gather), _t(gather)
    else:
        n = jcfg.num_image_tokens
        px = rng.integers(0, 255, (2, 1, 16, 16, 3)).astype(np.uint8)
        pos = np.broadcast_to(np.arange(0, n, dtype=np.int32), (2, n)).copy()
        s = 40
    if jcfg.qformer is not None:
        q = rng.integers(0, jcfg.qformer.vocab_size, (2, 7)).astype(np.int32)
        qm = np.ones((2, 7), bool)
        qm[1, 4:] = False
        jkw.update(qformer_ids=jnp.asarray(q), qformer_mask=jnp.asarray(qm))
        tkw.update(qformer_input_ids=_t(q), qformer_mask=_t(qm))
    ids = rng.integers(4, 200, (2, s)).astype(np.int32)
    pad = np.ones((2, s), bool)
    pad[1, s - 5:] = False
    # jitted: the eager forward dispatches op by op
    want, _ = jax.jit(functools.partial(vlm_forward, jcfg))(
        params, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
        image_positions=jnp.asarray(pos), pad_mask=jnp.asarray(pad), **jkw)
    with torch.no_grad():
        h, _ = model(_t(ids), _t(px), _t(pos), _t(pad), **tkw)
        got = model.head(h)
    np.testing.assert_allclose(got.numpy()[pad], np.asarray(want)[pad], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("with_ids", [True, False])
def test_instructblip_encode_images_matches_jax(with_ids):
    from vlrlhf_tpu.models.vlm import encode_images

    jcfg, params, model = family_port("instructblip", seed=2)
    rng = np.random.default_rng(3)
    px = rng.integers(0, 255, (3, 16, 16, 3)).astype(np.uint8)
    q = rng.integers(0, 64, (3, 5)).astype(np.int32) if with_ids else None
    want = jax.jit(functools.partial(encode_images, jcfg))(
        params, jnp.asarray(px), qformer_ids=None if q is None else jnp.asarray(q))
    with torch.no_grad():
        got = model.encode_images(_t(px), qformer_input_ids=None if q is None else _t(q))
    assert got.shape == (3, jcfg.num_image_tokens, jcfg.lm.hidden_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("family", FAMILIES)
def test_configs_match_jax(family):
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.models.registry import scale_down as jscale
    from vlrlhf_torch.models.config import FAMILIES as TF
    from vlrlhf_torch.models.config import scale_down

    jfam, tfam = JF[family], TF[family]
    assert tfam.make_config() == vlm_config_from(jfam.make_config())
    small, want = scale_down(tfam.make_config()), vlm_config_from(jscale(jfam.make_config()))
    # the port's scale_down keeps the tower's remat flag (it applies only
    # under autograd); vlrlhf_tpu's turns it off
    assert small == dataclasses.replace(want, vision=dataclasses.replace(
        want.vision, remat=small.vision.remat))
    assert tfam.hf_architectures == jfam.hf_architectures
    assert tfam.lora_targets == jfam.lora_targets
    assert tfam.freeze_vision_patterns == jfam.freeze_vision_patterns
    assert tfam.processor_defaults == jfam.processor_defaults
    assert tfam.resize_mode == jfam.resize_mode and tfam.stop_tokens == jfam.stop_tokens
    jt = jfam.template
    tt = tfam.template
    for f in dataclasses.fields(tt):
        assert getattr(tt, f.name) == getattr(jt, f.name), f.name


def test_resolve_family_and_refusals():
    from vlrlhf_tpu.models.registry import resolve_family as jresolve
    from vlrlhf_torch.models.config import resolve_family

    cases = [("LlavaForConditionalGeneration", ""),
             ("LlavaNextForConditionalGeneration", "mistralai/Mistral-7B-Instruct-v0.2"),
             ("LlavaNextForConditionalGeneration", "lmsys/vicuna-7b-v1.5"),
             ("LlavaNextForConditionalGeneration", "mistral"),
             ("InstructBlipForConditionalGeneration", ""), ("InstructBlipForRL", "")]
    cases += [("QWenLMHeadModel", ""), ("InternLMXComposer2ForCausalLM", "")]
    for arch, text in cases:
        assert resolve_family(arch, text).name == jresolve(arch, text).name
    with pytest.raises(ValueError, match="not a family"):
        resolve_family("GPT2LMHeadModel")


def test_lora_targets_select_the_lm_linears_only():
    """The family default targets (every LM attention and MLP linear) pick
    the same Linears in the port as init_lora picks leaves in vlrlhf_tpu;
    the tower, Q-Former and projector keep none."""
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.lora.lora import LoraConfig as TLoraConfig
    from vlrlhf_torch.lora.lora import init_lora as tinit
    from vlrlhf_torch.models.config import FAMILIES as TF

    jcfg, params, model = family_port("instructblip", seed=4)
    targets = TF["instructblip"].lora_targets
    jad = init_lora(params, LoraConfig(r=2, alpha=4.0, target_patterns=targets),
                    jax.random.PRNGKey(0))
    tinit(model, TLoraConfig(r=2, alpha=4.0, target_patterns=targets),
          torch.Generator().manual_seed(0))
    from vlrlhf_torch.utils.bridge import lora_tree

    got = jax.tree_util.tree_structure(lora_tree(model))
    assert got == jax.tree_util.tree_structure(jax.device_get(jad))
    assert set(jad) == {"lm"}
