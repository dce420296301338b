"""The port's mesh, plan and per-process data against vlrlhf_tpu's:
  - core.mesh.MeshConfig.resolve equals vlrlhf_tpu's over a table of
    shapes and device counts, its errors included;
  - the plan's placement on the model axis (core.partitioning.model_spec)
    against `default_lm_rules().spec_for` for every leaf of each family's
    scaled-down params (XC2's PLoRA tree too), of the tiny LLaVA's LoRA
    adapters and of its int8-quantized params, in the port's (out, in)
    orientation; where they differ, an explicit table names the leaf and
    both placements (the results are the same: tests/test_torch_dist_*.py);
  - the rank layout rank = p * (data * fsdp * model) + (d * fsdp + f) *
    model + m (core.mesh.rank_of / coords_of): init_device_mesh's
    row-major order over (pipe, data, fsdp, model), a stage a contiguous
    block of ranks, a tensor-parallel group adjacent ranks, a pipe group
    one rank per stage at the same (data, fsdp, model);
  - data.datasets.shard_rows_for_process equals vlrlhf_tpu's for 1-5
    processes and 0-11 rows, jax.process_count / process_index
    monkeypatched;
  - one gloo rank in this process: every LlamaLayer and the VLM are FSDP2
    units whose parameters are DTensors sharded on dim 0, the registered
    forward methods run, and `unsharded` gathers plain tensors for a
    block and frees them after it;
  - save_merged's one merge path (core.partitioning.full_model_state, a
    quantized base made dense, then lora.merge_state) equals
    ops.quant.dequantize_params + lora.merge_lora bit for bit, on a plain
    model (f32, int8, int4 bases) and on the FSDP2 units of one rank."""

import os
import re
import socket

import jax
import pytest
import torch

from vlrlhf_torch.core.mesh import MeshConfig
from vlrlhf_torch.core.partitioning import model_spec

RESOLVE_CASES = [
    ((1, -1, 1, 1), 8), ((2, -1, 1, 1), 8), ((1, -1, 2, 1), 8), ((2, 2, 2, 1), 8),
    ((1, 2, 1, 1), 8), ((1, -1, 1, 2), 4), ((-1, 2, 1, 1), 4), ((1, 1, 1, 1), 1),
    ((1, -1, 4, 1), 4), ((1, -1, 3, 1), 8), ((-1, -1, 1, 1), 8), ((1, 4, 4, 1), 8),
    ((2, 2, 1, 1), 2), ((1, -1, 1, 1), 1), ((3, -1, 1, 1), 6),
]


@pytest.mark.parametrize("shape,n", RESOLVE_CASES)
def test_mesh_config_resolve_matches_jax(shape, n):
    from vlrlhf_tpu.core.mesh import MeshConfig as JMeshConfig

    try:
        want = JMeshConfig(*shape).resolve(n)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            MeshConfig(*shape).resolve(n)
        return
    assert MeshConfig(*shape).resolve(n) == want


@pytest.mark.parametrize("shape", [(2, 1, 2, 2), (4, 1, 1, 1), (2, 2, 1, 1), (2, 1, 1, 2),
                                   (1, 2, 2, 2), (3, 2, 1, 2)])
def test_rank_layout_pipe_outermost_model_innermost(shape):
    from vlrlhf_torch.core.mesh import coords_of, rank_of

    pipe, data, fsdp, model = shape
    world = pipe * data * fsdp * model
    grid = torch.arange(world).reshape(shape)  # init_device_mesh's layout of the world
    block = data * fsdp * model
    for rank in range(world):
        p, d, f, m = coords_of(shape, rank)
        assert rank_of(shape, p, d, f, m) == rank == int(grid[p, d, f, m])
        assert rank == p * block + (d * fsdp + f) * model + m
        assert p * block <= rank < (p + 1) * block  # a stage: a contiguous block
        tp = [rank_of(shape, p, d, f, k) for k in range(model)]
        assert tp == list(range(tp[0], tp[0] + model))  # a tensor-parallel group: neighbours
        assert [rank_of(shape, q, d, f, m) for q in range(pipe)] == \
            [q * block + rank % block for q in range(pipe)]  # a pipe group: one per stage


# Where the port's plan places a leaf on the model axis otherwise than
# vlrlhf_tpu's rules: (path pattern, vlrlhf_tpu's model dims, the port's),
# dims in the port's orientation (weights (out, in), adapters a (in, r) /
# b (r, out), tables (rows, width)).
DEVIATIONS = [
    # the embedding and lm_head stay whole on model (a vocab-parallel
    # log-softmax in chunked_logps is later work)
    (r"^lm/embed_tokens/embedding$", (1,), ()),
    (r"^lm/lm_head/kernel$", (0,), ()),
    # the towers, the Q-Former and the resampler stay whole on model
    (r"^(vision|qformer|projector)/.*/kernel$", "any", ()),
    # a column linear's bias is split with its out rows
    (r"^lm/layers_scanned/attn/(wq|wk|wv)/bias$", (), (0,)),
    # LoRA and PLoRA: vlrlhf_tpu replicates both factors; the port splits
    # a column linear's b on out and a row linear's a on in
    (r"^(plora/)?lm/layers_scanned/(attn/(wq|wk|wv)|mlp/(gate|up))/b$", (), (1,)),
    (r"^(plora/)?lm/layers_scanned/(attn/wo|mlp/down)/a$", (), (0,)),
]


def _jax_model_dims(path: str, ndim: int) -> tuple:
    """The dims of vlrlhf_tpu's spec that name "model", in the port's
    orientation: an (in, out) kernel's dims swap, a (1, out) scale drops
    its leading 1; a scanned leaf's layer axis is not counted."""
    from vlrlhf_tpu.core.partitioning import default_lm_rules

    spec = list(default_lm_rules().spec_for(path, ndim))
    if "_scanned" in path:
        spec, ndim = spec[1:], ndim - 1
    dims = [i for i, s in enumerate(spec) if s == "model"]
    leaf = path.rsplit("/", 1)[1]
    if leaf in ("kernel", "kernel_q") and ndim == 2:
        dims = [1 - d for d in dims]
    elif leaf == "kernel_scale":
        dims = [d - 1 for d in dims]
    return tuple(sorted(dims))


def _trees():
    """(name, [(path, leaf shape)]) of every tree the plan is held against:
    shapes only (jax.eval_shape), each family's scaled-down params with
    XC2's PLoRA tree, the tiny LLaVA's params, LoRA adapters (LM and tower)
    and int8-quantized params."""
    import functools

    from tests.test_dpo_step import tiny_vlm_config
    from tests.test_torch_families import FAMILIES
    from vlrlhf_tpu.core.partitioning import tree_paths
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.models.registry import scale_down
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_tpu.ops.quant import TRAIN_QUANT_PATTERNS, quantize_params

    key = jax.random.PRNGKey(0)

    def lora(params, patterns):
        return jax.eval_shape(lambda p: init_lora(p, LoraConfig(r=4, target_patterns=patterns),
                                                  key), params)

    out = []
    for f in FAMILIES:
        jcfg = scale_down(JF[f].make_config())
        params = jax.eval_shape(functools.partial(init_vlm_params, jcfg), key)
        if jcfg.plora:
            params["plora"] = lora(params, (r"lm/.*attn/", r"lm/.*mlp/"))
        out.append((f, params))
    params = jax.eval_shape(functools.partial(init_vlm_params, tiny_vlm_config()), key)
    out.append(("llava", params))
    out.append(("llava/adapters", lora(params, (r"lm/.*attn/", r"lm/.*mlp/", r"vision/.*attn/"))))
    out.append(("llava/int8", jax.eval_shape(
        lambda p: quantize_params(p, TRAIN_QUANT_PATTERNS, bits=8), params)))
    return [(name, tree_paths(t)) for name, t in out]


def test_plan_matches_default_lm_rules_but_for_the_listed_deviations():
    seen, used = 0, set()
    for name, leaves in _trees():
        for path, leaf in leaves:
            ndim = getattr(leaf, "ndim", 0)
            want = _jax_model_dims(path, ndim)
            real = ndim - 1 if "_scanned" in path else ndim
            got = tuple(i for i, s in enumerate(model_spec(path, real)) if s == "model")
            rows = [i for i, (pat, _, _) in enumerate(DEVIATIONS) if re.search(pat, path)]
            if rows:
                _, jdims, pdims = DEVIATIONS[rows[0]]
                used.add(rows[0])
                assert got == pdims, (name, path, got)
                assert jdims == "any" or want == jdims, (name, path, want)
            else:
                assert got == want, (name, path, got, want)
            seen += 1
    assert seen > 200
    assert used == set(range(len(DEVIATIONS))), "a deviation row matches no leaf"


@pytest.mark.parametrize("n_proc", [1, 2, 3, 4, 5])
def test_shard_rows_for_process_matches_jax(monkeypatch, n_proc):
    from vlrlhf_tpu.data.datasets import shard_rows_for_process as jshard
    from vlrlhf_torch.core import dist
    from vlrlhf_torch.data.datasets import shard_rows_for_process

    for n_rows in range(12):
        rows = [{"i": i} for i in range(n_rows)]
        shards = []
        for idx in range(n_proc):
            monkeypatch.setattr(jax, "process_count", lambda n=n_proc: n)
            monkeypatch.setattr(jax, "process_index", lambda i=idx: i)
            monkeypatch.setattr(dist, "process_count", lambda n=n_proc: n)
            monkeypatch.setattr(dist, "process_index", lambda i=idx: i)
            got = shard_rows_for_process(rows)
            assert got == jshard(rows), (n_proc, n_rows, idx)
            shards.extend(got)
        assert shards == rows  # contiguous shards in process order: dataset order


@pytest.fixture
def one_rank(monkeypatch):
    """A gloo group of one in this process and its (1, 1, 1) mesh, torn down
    after the test."""
    import torch.distributed as tdist

    from vlrlhf_torch.core import dist
    from vlrlhf_torch.core.mesh import make_mesh, set_global_mesh

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port)).items():
        monkeypatch.setenv(k, v)
    assert dist.initialize("cpu")
    try:
        yield make_mesh(MeshConfig(), "cpu")
    finally:
        set_global_mesh(None)
        tdist.destroy_process_group()
    assert not dist.is_initialized() and os.environ["RANK"] == "0"


def test_fsdp_units_and_unsharded_on_one_rank(one_rank):
    from torch.distributed.fsdp import FSDPModule
    from torch.distributed.tensor import DTensor, Shard

    from tests.test_torch_sft_rm import _setup
    from vlrlhf_torch.core.partitioning import fsdp_units, shard_model_, unsharded
    from vlrlhf_torch.models.common import Ctx

    model = _setup()[4]
    shard_model_(model, one_rank)
    units = fsdp_units(model)
    assert units[0] is model and all(isinstance(layer, FSDPModule) for layer in model.lm.layers)
    assert len(units) == len(model.lm.layers) + 1
    for name, p in model.named_parameters():
        assert isinstance(p, DTensor) and p.placements == (Shard(0),), name
    ids = torch.randint(0, 100, (2, 12))
    with torch.no_grad():
        hidden, _ = model(ids, pad_mask=torch.ones(2, 12, dtype=torch.bool), ctx=Ctx())
        logits = model.head(hidden)  # the root keeps its weights after forward
    assert logits.shape == (2, 12, 128) and torch.isfinite(logits).all()
    with unsharded(model):
        assert not any(isinstance(p, DTensor) for p in model.parameters())
        w = model.lm.layers[0].wq.weight
        assert tuple(w.shape) == (32, 32)
    assert isinstance(model.lm.layers[0].wq.weight, DTensor)


def _merged_pair(bits: int, mesh=None) -> tuple[dict, dict]:
    """(save_merged's merge of a bridged model, possibly placed on `mesh`;
    dequantize_params + merge_lora of a plain copy)."""
    import copy

    from tests.test_torch_checkpoint import _bridged
    from vlrlhf_torch.core.partitioning import full_model_state, shard_model_
    from vlrlhf_torch.lora.lora import merge_lora, merge_state
    from vlrlhf_torch.ops.quant import dequantize_params

    _, _, scale, model = _bridged(bits)
    plain = copy.deepcopy(model)
    dequantize_params(plain, torch.bfloat16)
    want = merge_lora(plain, scale)
    if mesh is not None:
        shard_model_(model, mesh)
    return merge_state(full_model_state(model, mesh, torch.bfloat16), scale), want


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_merge_path_equals_merge_lora_without_a_mesh(bits):
    got, want = _merged_pair(bits)
    assert got.keys() == want.keys() and not any("lora_" in k for k in got)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_merge_path_equals_merge_lora_on_one_rank(one_rank):
    got, want = _merged_pair(8, one_rank)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k

