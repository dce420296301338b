"""The GPipe pipeline (models/lm/pipeline.py) in one process, f32 on the
CPU:
  - `pipeline_local` (all S stages in this process, through the schedule
    the ranks run) against vlrlhf_tpu's pipelined `lm_forward`
    (`pipeline_stages`) under make_mesh(MeshConfig(1, 8 // pipe, 1, pipe))
    on the 8 virtual devices, with tests/test_pipeline.py's config, cases
    and bounds: (pipe, microbatches) = (2, 0), (4, 0), (2, 4) over every
    parameter, then LoRA with `attn` remat over the adapters; the loss at
    rtol 1e-5, the gradients at atol 2e-4 / rtol 1e-3;
  - the same cases against the port's plain decoder (world 1) within
    1e-5, and with LoRA dropout on (each microbatch keeps its rows of the
    whole batch's mask) under each remat policy, and batches of 5 and 7
    rows in 2 and 3 uneven microbatches;
  - `init_lora` on a stage's layers draws the single-process adapters;
  - the refusals: a layer count the stages do not divide, rows fewer than
    the microbatches, the prefill / decode / chunk paths on a stage's
    layers (the whole stack prefills), and the CLI's before anything loads (tests/test_torch_dist_cli.py has
    the rest).
vlrlhf_tpu's make_mesh registers its mesh globally; the registry is put
back after each reference."""

import dataclasses
import functools
import re

import jax
import numpy as np
import pytest
import torch

from tests.test_pipeline import _cfg, _data
from vlrlhf_torch.models.common import Ctx

LOSS_RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 2e-4, 1e-3
TOL = 1e-5
CASES = [(2, 0), (4, 0), (2, 4)]
LORA_PATTERNS = (r"attn/(wq|wv)", r"mlp/gate")


@functools.lru_cache(maxsize=None)
def _params(seed: int, **cfg_kw):
    """vlrlhf_tpu's LM params of tests/test_pipeline.py's config (built once
    per seed and config: the eager init costs seconds)."""
    from vlrlhf_tpu.models.lm.llama import init_lm_params

    return init_lm_params(_cfg(**cfg_kw), jax.random.PRNGKey(seed))


class _Holder(torch.nn.Module):
    """A port LlamaDecoder under the name "lm", so adapter keys read
    "lm/layers/<i>/..." as in a VLM."""

    def __init__(self, lm):
        super().__init__()
        self.lm = lm


def _port_lm(jcfg, params):
    """The port's LlamaDecoder holding vlrlhf_tpu's LM params."""
    from vlrlhf_torch.models.config import LMConfig
    from vlrlhf_torch.models.lm.llama import LlamaDecoder
    from vlrlhf_torch.utils.bridge import _copy, _layer, _linear, _norm

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(LMConfig)
          if hasattr(jcfg, f.name)}
    lm = LlamaDecoder(LMConfig(**dict(kw, dtype=torch.float32)), "cpu")
    params = jax.device_get(params)
    _copy(lm.embed_tokens, params["embed_tokens"]["embedding"])
    for i, layer in enumerate(lm.layers):
        lp = _layer(params["layers_scanned"], i)
        _norm(layer.input_layernorm, lp["input_layernorm"])
        _norm(layer.post_attention_layernorm, lp["post_attention_layernorm"])
        for group, names in (("attn", ("wq", "wk", "wv", "wo")), ("mlp", ("gate", "up", "down"))):
            for name in names:
                _linear(getattr(layer, name), lp[group][name])
    _norm(lm.norm, params["norm"])
    _linear(lm.lm_head, params["lm_head"])
    for p in lm.parameters():
        p.requires_grad_(True)
    return lm


def _port_grads(lm) -> dict:
    """The port LM's parameter gradients in vlrlhf_tpu's tree layout."""
    def t(p):
        return p.grad.detach().numpy()

    def stack(fn):
        return np.stack([fn(layer) for layer in lm.layers])

    layers = {
        "input_layernorm": {"weight": stack(lambda la: t(la.input_layernorm.weight))},
        "post_attention_layernorm": {
            "weight": stack(lambda la: t(la.post_attention_layernorm.weight))},
        "attn": {n: {"kernel": stack(lambda la, n=n: t(getattr(la, n).weight).T)}
                 for n in ("wq", "wk", "wv", "wo")},
        "mlp": {n: {"kernel": stack(lambda la, n=n: t(getattr(la, n).weight).T)}
                for n in ("gate", "up", "down")},
    }
    return {"embed_tokens": {"embedding": t(lm.embed_tokens)}, "layers_scanned": layers,
            "norm": {"weight": t(lm.norm.weight)}, "lm_head": {"kernel": t(lm.lm_head.weight).T}}


def _port_loss(lm, ids, mask, ctx: Ctx, pipe: int = 1, micro: int = 0) -> torch.Tensor:
    """tests/test_pipeline.py's `_loss` on the port: the stack through
    `pipeline_local` (pipe > 1) or the plain layers."""
    from vlrlhf_torch.models.lm.pipeline import pipeline_local
    from vlrlhf_torch.ops.norms import rms_norm
    from vlrlhf_torch.ops.rope import rope_frequencies

    ids, mask = torch.from_numpy(np.array(ids)).long(), torch.from_numpy(np.array(mask))
    b, s = ids.shape
    x = lm.embed(ids)
    cos, sin = rope_frequencies(lm.cfg.rope, torch.arange(s)[None].expand(b, s), seq_len=s)
    lctx = ctx.sub("lm").sub("layers_scanned")
    if pipe > 1:
        h = pipeline_local(lm, pipe, micro, x, cos, sin, mask, lctx)
    else:
        h = lm.run_layers(x, cos, sin, mask, lctx)
    logits = lm.head(rms_norm(h, lm.norm.weight, lm.cfg.rms_eps))
    tgt = torch.roll(ids, -1, dims=1)
    tok = torch.log_softmax(logits.float(), -1).gather(-1, tgt[..., None])[..., 0]
    return -(tok * mask).sum() / mask.sum()


def _jax_pipelined(cfg, loss_fn, arg, pipe: int):
    """vlrlhf_tpu's value_and_grad of `loss_fn(arg)` with the stack
    pipelined over `pipe` stages of the 8 virtual devices."""
    from vlrlhf_tpu.core import mesh as jmesh
    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh

    prev = jmesh._GLOBAL_MESH
    try:
        make_mesh(MeshConfig(data=1, fsdp=8 // pipe, model=1, pipe=pipe))
        loss, grads = jax.jit(jax.value_and_grad(lambda a: loss_fn(cfg, a)))(arg)
        return float(loss), jax.device_get(grads)
    finally:
        jmesh._GLOBAL_MESH = prev


def _close(got, want, atol, rtol, what):
    gl, wl = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_leaves(got)
    assert len(gl) == len(wl), what
    for (path, w), g in zip(gl, wl):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=f"{what} {jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("pipe,micro", CASES)
def test_pipeline_local_matches_vlrlhf_tpu_and_world1(pipe, micro):
    from tests.test_pipeline import _loss
    from vlrlhf_tpu.models.common import Ctx as JCtx

    cfg0 = _cfg()
    params = _params(0)
    ids, mask = _data()
    jctx = JCtx(attn_impl="xla")
    want_loss, want_grads = _jax_pipelined(
        _cfg(pipeline_stages=pipe, pipeline_microbatches=micro),
        lambda c, p: _loss(c, p, ids, mask, jctx), params, pipe)

    out = {}
    for name, p in (("pipe", pipe), ("world1", 1)):
        lm = _port_lm(cfg0, params)
        loss = _port_loss(lm, ids, mask, Ctx(), p, micro)
        loss.backward()
        out[name] = (loss.item(), _port_grads(lm))
    np.testing.assert_allclose(out["pipe"][0], want_loss, rtol=LOSS_RTOL)
    _close(out["pipe"][1], want_grads, GRAD_ATOL, GRAD_RTOL, "vs vlrlhf_tpu")
    np.testing.assert_allclose(out["pipe"][0], out["world1"][0], rtol=TOL, atol=TOL)
    _close(out["pipe"][1], out["world1"][1], TOL, TOL, "vs world 1")


def _lora_lm(cfg, params, adapters):
    from vlrlhf_torch.utils.bridge import load_lora_params

    holder = _Holder(_port_lm(cfg, params))
    assert load_lora_params(holder, {"lm": jax.device_get(adapters)})
    for p in holder.parameters():
        p.requires_grad_(False)
    for mod in holder.modules():
        if getattr(mod, "lora_a", None) is not None:
            mod.lora_a.requires_grad_(True)
            mod.lora_b.requires_grad_(True)
    return holder


def test_pipeline_local_with_adapters_and_remat_matches_vlrlhf_tpu():
    """tests/test_pipeline.py's LoRA case (stacked adapters ride the stage
    split, attn remat inside the stage body) on the port's pipeline, over
    the adapters; with LoRA dropout on it equals world 1."""
    from tests.test_pipeline import _loss
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_torch.utils.bridge import lora_tree

    cfg0 = _cfg(remat=True, remat_policy="attn")
    params = _params(1, remat=True, remat_policy="attn")
    lcfg = LoraConfig(r=4, alpha=8, dropout=0.0, target_patterns=LORA_PATTERNS)
    adapters = init_lora(params, lcfg, jax.random.PRNGKey(2))
    adapters = jax.tree.map(
        lambda a: a + 0.02 * jax.random.normal(jax.random.PRNGKey(3), a.shape, a.dtype), adapters)
    ids, mask = _data(seed=4)

    def jloss(cfg, ad):
        return _loss(cfg, params, ids, mask, JCtx(adapters=ad, lora_scale=lcfg.scale,
                                                  attn_impl="xla"))

    want_loss, want_grads = _jax_pipelined(dataclasses.replace(cfg0, pipeline_stages=2), jloss,
                                           adapters, 2)
    got = {}
    for name, pipe, dropout in (("pipe", 2, 0.0), ("world1", 1, 0.0), ("pipe_dropout", 2, 0.1),
                                ("world1_dropout", 1, 0.1)):
        holder = _lora_lm(cfg0, params, adapters)
        ctx = Ctx(adapters=True, lora_scale=lcfg.scale, lora_dropout=dropout, dropout_seed=5)
        loss = _port_loss(holder.lm, ids, mask, ctx, pipe, micro=4 if dropout else 0)
        loss.backward()
        got[name] = (loss.item(), lora_tree(holder, grads=True)["lm"])
    np.testing.assert_allclose(got["pipe"][0], want_loss, rtol=LOSS_RTOL)
    _close(got["pipe"][1], want_grads, GRAD_ATOL, GRAD_RTOL, "vs vlrlhf_tpu")
    for a, b in (("pipe", "world1"), ("pipe_dropout", "world1_dropout")):
        np.testing.assert_allclose(got[a][0], got[b][0], rtol=TOL, atol=TOL)
        _close(got[a][1], got[b][1], TOL, TOL, f"{a} vs {b}")
    assert abs(got["pipe_dropout"][0] - got["pipe"][0]) > 1e-4  # the masks dropped something


@pytest.mark.parametrize("policy", ["full", "attn", "dots", "mlp", "mlp1", "acts"])
def test_every_remat_policy_under_the_pipeline_matches_world1(policy):
    """A stage runs its layers under each remat policy (LoRA on every LM
    linear, dropout on): the adapters' gradients equal world 1's."""
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.utils.bridge import lora_tree

    cfg0 = _cfg(remat=True, remat_policy=policy)
    ids, mask = _data(seed=7)
    got = {}
    for name, pipe in (("pipe", 2), ("world1", 1)):
        holder = _Holder(_port_lm(cfg0, _params(0)))
        for p in holder.parameters():
            p.requires_grad_(False)
        init_lora(holder, LoraConfig(r=4, target_patterns=(r"lm/.*attn/", r"lm/.*mlp/")),
                  torch.Generator().manual_seed(8))
        with torch.no_grad():
            for mod in holder.modules():
                if getattr(mod, "lora_b", None) is not None:
                    mod.lora_b.add_(0.02)
        ctx = Ctx(adapters=True, lora_scale=0.5, lora_dropout=0.1, dropout_seed=9)
        loss = _port_loss(holder.lm, ids, mask, ctx, pipe, micro=4)
        loss.backward()
        got[name] = (loss.item(), lora_tree(holder, grads=True)["lm"])
    np.testing.assert_allclose(got["pipe"][0], got["world1"][0], rtol=TOL, atol=TOL)
    _close(got["pipe"][1], got["world1"][1], TOL, TOL, f"{policy} vs world 1")


@pytest.mark.parametrize("rows,micro", [(5, 2), (7, 3)])
def test_uneven_microbatches_match_world1(rows, micro):
    """A batch the microbatches do not divide (a holdout's tail batch) runs
    microbatches a row apart, forward and backward, as world 1."""
    cfg0 = _cfg()
    params = _params(0)
    ids, mask = _data(b=rows, seed=6)
    out = {}
    for name, pipe in (("pipe", 2), ("world1", 1)):
        lm = _port_lm(cfg0, params)
        loss = _port_loss(lm, ids, mask, Ctx(), pipe, micro)
        loss.backward()
        out[name] = (loss.item(), _port_grads(lm))
    np.testing.assert_allclose(out["pipe"][0], out["world1"][0], rtol=TOL, atol=TOL)
    _close(out["pipe"][1], out["world1"][1], TOL, TOL, "uneven vs world 1")


def test_init_lora_on_a_stage_draws_the_single_process_adapters():
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora, lora_keys, lora_parameters
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.lm.llama import StageLayers
    from vlrlhf_torch.models.vlm import VLM

    cfg = scale_down(FAMILIES["llava"].make_config(), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_layers=12))
    lcfg = LoraConfig(r=4, target_patterns=(r"lm/.*attn/(wq|wo)/", r"vision/.*mlp/fc1/",
                                            r"lm/.*mlp/up/"))
    whole = init_random_(VLM(cfg), torch.Generator().manual_seed(0))
    init_lora(whole, lcfg, torch.Generator().manual_seed(3))
    want = dict(zip(lora_keys(whole), (p for _, p in lora_parameters(whole))))
    for lo, hi in ((0, 6), (6, 12), (4, 8)):
        stage = init_random_(VLM(cfg), torch.Generator().manual_seed(0))
        stage.lm.layers = StageLayers(list(stage.lm.layers)[lo:hi], lo)
        init_lora(stage, lcfg, torch.Generator().manual_seed(3))
        keys = lora_keys(stage)
        assert all(lo <= int(m.group(1)) < hi for k in keys
                   if (m := re.search(r"lm/layers/(\d+)/", k)))
        assert any(k.startswith("vision/") for k in keys)
        for k, (_, p) in zip(keys, lora_parameters(stage)):
            assert torch.equal(p, want[k]), k


def test_refusals():
    from vlrlhf_torch.cli.main import main
    from vlrlhf_torch.core.dist import PipeShard, microbatch_spans
    from vlrlhf_torch.core.mesh import Mesh, set_global_mesh
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.lm.llama import StageLayers
    from vlrlhf_torch.models.lm.pipeline import stage_span
    from vlrlhf_torch.models.vlm import VLM

    with pytest.raises(ValueError, match="--mesh_pipe 4: the LM's 6 layers do not split"):
        stage_span(6, 4, 0)
    assert stage_span(8, 4, 3) == (6, 8)
    assert microbatch_spans(7, 3) == [(0, 3), (3, 5), (5, 7)]
    with pytest.raises(ValueError, match="2 rows cannot form 4 pipeline microbatches"):
        microbatch_spans(2, 4)
    model = init_random_(VLM(scale_down(FAMILIES["llava"].make_config(), dtype=torch.float32)),
                         torch.Generator().manual_seed(0))
    ids = torch.ones((1, 8), dtype=torch.long)
    set_global_mesh(Mesh(device_mesh=None, data=1, fsdp=1, model=1, coords=(0, 0, 0),
                         dp_group=None, fsdp_group=None, tp_group=None, pipe=2,
                         pp=PipeShard(None, 0, 2, "gloo", 2)))
    try:
        # the whole stack (core/partitioning.py whole_stack) prefills; a
        # stage's layers refuse the prefill, the decode and the chunk
        _, cache = model(ids, cache_len=16)
        stage = model.lm.layers
        model.lm.layers = StageLayers(list(stage)[:1], 0)
        lens = torch.full((1,), 8, dtype=torch.int32)
        for path, call in (
                ("prefill", lambda: model(ids, cache_len=16)),
                ("decode", lambda: model.lm.decode(ids[:, 0], lens, cache)),
                ("chunk prefill", lambda: model.lm.prefill_chunk(ids[:, :2], lens, lens, cache))):
            with pytest.raises(ValueError, match=f"the {path} path refuses a pipeline stage's "
                                                 "layers"):
                call()
        model.lm.layers = stage
    finally:
        set_global_mesh(None)
    base = ["dpo", "--device", "cpu", "--bf16", "false", "--synthetic", "4", "--output_dir",
            "/nonexistent"]
    for flags, match in (
            (["--mesh_pipe", "4", "--per_device_train_batch_size", "2"],
             "--mesh_pipe 4: the LM's 2 layers do not split into 4 equal stages"),
            (["--mesh_pipe", "2", "--pipeline_microbatches", "3"],
             "--mesh_pipe 2: 4 pairs = 8 rows per data-parallel rank .* 3 pipeline microbatches"),
            (["--pipeline_microbatches", "2"],
             "--pipeline_microbatches 2: .* needs --mesh_pipe > 1")):
        with pytest.raises(SystemExit, match=match):
            main(base + flags)
