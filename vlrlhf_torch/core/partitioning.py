"""The parameter plan (counterpart of vlrlhf_tpu/core/partitioning.py,
`default_lm_rules` and `pipe_layers`): how every leaf of the port's model
is placed on the (pipe, data, fsdp, model) mesh, and the functions that
apply it and undo it.

The pipeline over `pipe` (S stages) comes first: stage p keeps decoder
layers [p L/S, (p+1) L/S) (`keep_stage_layers_`, a StageLayers named by
their global indices) and drops the others, so a rank's resident memory
falls by (S-1)/S of the stack; vlrlhf_tpu lays the stacked layers' leading
axis over `pipe` likewise (partitioning.py:55-78). Everything else, the
root unit below (embedding, towers, projector, final norm, head), stays
on every stage, as vlrlhf_tpu's towers stay unpipelined. Tensor
parallelism and FSDP2 then apply to the stage's layers and the root over
the stage's own model and data x fsdp ranks.

FSDP2 over (data, fsdp): `fully_shard` splits dim 0 of every parameter
over `fsdp`, and replicates over `data` when data > 1 (HSDP), as
vlrlhf_tpu's params ride `fsdp` while its batch rides data x fsdp. The
units are each `LlamaLayer` and the `VLM` root, which holds the embedding,
lm_head, the final norm, the vision tower, the projector, the Q-Former and
the resampler. FSDP2's hooks fire on a module's `__call__`, so the layer
methods the remat loop calls (`attn_out`, `mlp_residual`,
`_named_forward`) and the root's `row_features` are registered forward
methods.

Tensor parallelism over `model`, by hand on plain local tensors (the
port's `Linear` carries LoRA sets, PLoRA and int8 / int4 fields, which
torch's ColwiseParallel / RowwiseParallel do not know):
  - wq, wk, wv, gate, up are column-parallel: the weight's out rows, the
    bias, int8 codes and scales, int4 packed rows, scales and gbias are
    split; LoRA's and PLoRA's `b` is split on out and `a` replicated;
  - wo, down are row-parallel: the weight's in columns are split, the bias
    and the int8 per-out scales stay whole (the bias is added once, after
    the all-reduce); int4 is split-half packed along in, so each row
    shard is unpacked and packed again, which needs (in / model) % 128 ==
    0; LoRA's and PLoRA's `a` is split on in and `b` replicated.
  The collectives are `core.dist.copy_to_tp` / `reduce_from_tp` inside
  `Linear` (under the model split `gather_seq` before the column linears
  and `scatter_seq` after the row ones instead), and each layer's head
  counts and MLP width become local.
Replicated over `model` in this slice: embed_tokens and lm_head, the
norms, the towers, the projector, the Q-Former and the resampler.
vlrlhf_tpu's rules also split lm_head, the embedding and the towers'
linears on `model`, replicate the LoRA adapters and the qkv bias, and put
fsdp on a kernel's `in` dim; the results are the same, and
tests/test_torch_mesh.py pins each deviation in an explicit table.

Under a pipeline a leaf is a stage's (its LM layer's; `pipe_role`
"stage"), before the stack ("before": the embedding, the towers and the
projector, whose gradient only stage 0 computes) or after it ("after":
lm_head, rm's and ppo's heads, whose gradient every stage computes from
the same whole output). The optimizer sums a "before" leaf's gradient
over the stages (train/train_state.py `pipe_sum`), so every replicated
leaf is bit-equal on every stage after a step, and the gradient norm sums
a stage leaf's squared norm over the stages too.

The gradient rule: a trainable leaf's gradient is the mean over the
ranks that read different rows of their gradients. FSDP2's reduction
(and a leaf outside its units, rm's or ppo's head, reduced over core.dist
`grad_group` as it is) averages over data x fsdp. Under the fsdp sequence
split (core/mesh.py) the fsdp ranks of a ring hold one row set between
them, each rank's gradient the partial of its slice of the sequence, so
the rule becomes the sum over the ring, then the mean over data: the
steps scale their loss by the ring's size before the backward
(core.dist `ring_size`; train/dpo.py, sft.py, rm.py, ppo.py), and the
reduction's mean over data x fsdp gives it.

Under the model split (Megatron-LM's sequence parallelism over the
tensor-parallel group; its layout and collectives in core/mesh.py) FSDP2
does not reduce over `model`, so the loss is not scaled. Instead each
leaf is one of two kinds:
  - split over model (tp_dim not None: a column linear's weight shards and
    LoRA / PLoRA `b`, a row linear's weight shards and `a`): it reads the
    whole gathered sequence or receives the whole gathered gradient, so
    its gradient is complete on each rank and is not summed;
  - replicated over model (tp_dim None: the norms, embed_tokens, lm_head,
    rm's and ppo's heads, the towers, the projector, the Q-Former and the
    resampler under tower LoRA, a column linear's `a` and a row linear's
    `b`): it sees this rank's slice only (a column linear's u = x a takes
    no copy_to_tp, the gather's backward summing x's gradient; a row
    linear's u is scattered to the slice), so its gradient is the slice's
    partial, and the optimizer sums it over the tensor-parallel group
    (train/train_state.py `tp_sum`, set by `attach_norm_groups_`).
The gradient norm and the clip then see the summed gradients.

Generation (ppo's rollouts, dpo's --eval_samples) runs inside
`whole_stack`: FSDP2's units gathered, no sequence split (core.dist
`unsplit`: whole sequences, the tensor-parallel linears as without a
split), and under a pipeline the whole stack, as vlrlhf_tpu's GSPMD
gathers every stage's layers for its plain decode scan: `whole_stack`
joins the other stages' layers onto every rank of the pipe group and
drops them after the block.

Checkpoints and final saves gather every tensor to its world-1 layout
(`full_tensor`, then the stages' layers joined over the pipe group) and
restores split it again for the mesh at hand (`stage_tree` keeps a
stage's layers, `shard_full` its part of each), so a checkpoint resumes
under any layout.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Optional

import torch
from torch import nn

from vlrlhf_torch.core.dist import TPShard

COLUMN = ("wq", "wk", "wv", "gate", "up")
ROW = ("wo", "down")
# per Linear parameter: the dim tensor parallelism splits (None: whole)
_COLUMN_DIMS = {"weight": 0, "bias": 0, "weight_q": 0, "weight_scale": 0, "weight_q4": 0,
                "weight_scale4": 0, "weight_gbias": 0, "lora_a": None, "lora_b": 1,
                "plora_a": None, "plora_b": 1}
_ROW_DIMS = {"weight": 1, "bias": None, "weight_q": 1, "weight_scale": None, "weight_q4": 1,
             "weight_scale4": 1, "weight_gbias": 1, "lora_a": 0, "lora_b": None,
             "plora_a": 0, "plora_b": None}
# JAX-layout leaf names -> the port's Linear parameter names
_JAX_LEAVES = {"kernel": "weight", "bias": "bias", "kernel_q": "weight_q",
               "kernel_scale": "weight_scale", "kernel_q4": "weight_q4",
               "kernel_scale4": "weight_scale4", "kernel_gbias": "weight_gbias",
               "a": "lora_a", "b": "lora_b"}
_LM_LAYER = re.compile(r"(^|[/.])lm([/.])layers\2(\d+)\2")
_AFTER_STACK = re.compile(r"^(?:adapters/)?lm/(?:lm_head|norm)/|^(?:rm_head|v_head)/")
_LAYER_LINEAR = re.compile(
    r"^(?:adapters/|value_adapters/|plora/)?lm/layers(?:_scanned|/\d+)/(?:attn|mlp)/(\w+)/(\w+)$")


def tp_mode(name: str) -> Optional[str]:
    """'column', 'row' or None for an LM layer Linear's name (wq, down, ...)."""
    return "column" if name in COLUMN else "row" if name in ROW else None


def linear_tp_dim(mode: Optional[str], leaf: str) -> Optional[int]:
    """The dim of a Linear's parameter `leaf` that the model axis splits."""
    if mode is None:
        return None
    return (_COLUMN_DIMS if mode == "column" else _ROW_DIMS)[leaf]


def tp_dim(path: str) -> Optional[int]:
    """The dim (in the port's orientation: weights (out, in), adapters
    a (in, r) / b (r, out)) of the leaf at a JAX-layout path ("lm/
    layers_scanned/attn/wq/kernel", a checkpoint key "lm/layers/3/attn/wo/a",
    XC2's PLoRA "plora/lm/layers_scanned/attn/wq/a", split like LoRA) that the
    model axis splits, or None when it is replicated over model. A scanned
    path's leading layer axis is not counted. ppo's value adapters
    ("value_adapters/...") and its reward set are split like LoRA."""
    m = _LAYER_LINEAR.match(path)
    if m is None or m.group(2) not in _JAX_LEAVES:
        return None
    return linear_tp_dim(tp_mode(m.group(1)), _JAX_LEAVES[m.group(2)])


def layer_index(key: str) -> Optional[int]:
    """The global LM layer index a state-tree key ("lm/layers/3/attn/wq/a",
    "adapters/lm/layers/3/...") or a parameter name ("lm.layers.3.wq.weight")
    names, or None for a leaf outside the stack's layers."""
    m = _LM_LAYER.search(key)
    return None if m is None else int(m.group(3))


def with_layer_index(key: str, index: int) -> str:
    """`key` naming LM layer `index` instead of its own."""
    m = _LM_LAYER.search(key)
    return f"{key[:m.start(3)]}{index}{key[m.end(3):]}"


def pipe_role(key: str) -> str:
    """"stage" (an LM layer's leaf), "after" (a leaf after the stack:
    lm_head, the final norm, a reward or value head) or "before" (the
    embedding, the towers, the projector) for a state-tree key."""
    if layer_index(key) is not None:
        return "stage"
    return "after" if _AFTER_STACK.search(key) else "before"


def model_spec(path: str, ndim: int) -> tuple:
    """The leaf's placement on the model axis as one entry per dim ("model"
    or None), in the port's orientation: the counterpart of the "model"
    entries of vlrlhf_tpu's `default_lm_rules().spec_for`."""
    d = tp_dim(path)
    return tuple("model" if i == d else None for i in range(ndim))


# ---------------------------------------------------------------------------
# Applying the plan


def check_tp(model, model_size: int) -> None:
    """Refuse a tensor-parallel degree the LM does not divide: heads, KV
    heads and the MLP width, and for an int4 row-parallel linear its local
    input width (a multiple of 128: its codes are repacked per shard)."""
    if model_size == 1:
        return
    lm = model.cfg.lm
    for what, n in (("num_heads", lm.num_heads), ("num_kv_heads", lm.num_kv_heads),
                    ("intermediate_size", lm.intermediate_size)):
        if n % model_size:
            raise ValueError(f"--mesh_model {model_size}: {what} {n} is not divisible by it")
    lo, _ = model.lm.layer_span
    for i, layer in enumerate(model.lm.layers, lo):
        for name in ROW:
            lin = getattr(layer, name)
            if lin.weight_q4 is not None and (lin.d_in // model_size) % 128:
                raise ValueError(
                    f"--mesh_model {model_size}: the int4 row-parallel linear "
                    f"lm.layers.{i}.{name} would hold {lin.d_in // model_size} input rows per "
                    "rank, not a multiple of 128 (its packed codes are repacked per shard)")


def _slice(t: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n).contiguous()


def _repack_int4_rows(packed: torch.Tensor, scale: torch.Tensor, rank: int, size: int):
    """An int4 weight's input columns [rank * in/size, (rank + 1) * in/size)
    as a weight of its own: codes unpacked, sliced and packed split-half
    again over the shard's width, and the shard's group scales (plus the
    guard column when its 128-blocks are odd in number)."""
    from vlrlhf_torch.ops.int4 import (
        GROUP, din_from_scale_cols, half_padded, scale_cols, unpack_int4,
    )

    d_in = din_from_scale_cols(scale.shape[1])
    half, half_p = d_in // 2, packed.shape[1]
    codes = unpack_int4(packed)
    q = torch.cat([codes[:, :half], codes[:, half_p:half_p + half]], dim=1)
    n = d_in // size
    lo = rank * n
    u = q[:, lo:lo + n].contiguous().view(torch.uint8)
    v = (u[:, : n // 2] & 0x0F) | (u[:, n // 2:] << 4)
    out = torch.zeros((q.shape[0], half_padded(n // 2)), dtype=torch.int8, device=packed.device)
    out[:, : n // 2] = v.view(torch.int8)
    s = torch.zeros((q.shape[0], scale_cols(n)), dtype=scale.dtype, device=scale.device)
    s[:, : n // GROUP] = scale[:, lo // GROUP:(lo + n) // GROUP]
    return out, s


@torch.no_grad()
def shard_linear_(lin, mode: str, group, rank: int, size: int) -> None:
    """Keep this rank's tensor-parallel part of a Linear in place: its
    parameters become the local slices (trainable ones stay trainable) and
    `lin.tp` makes its forward run the collectives."""
    if lin.tp is not None:
        raise ValueError("the Linear is sharded already")
    d_in, d_out = lin.d_in, lin.d_out
    dims = _COLUMN_DIMS if mode == "column" else _ROW_DIMS
    if mode == "row" and lin.weight_q4 is not None:
        packed, scale = _repack_int4_rows(lin.weight_q4, lin.weight_scale4, rank, size)
        lin.weight_q4 = nn.Parameter(packed, requires_grad=False)
        lin.weight_scale4 = nn.Parameter(scale, requires_grad=False)
        skip = {"weight_q4", "weight_scale4"}
    else:
        skip = set()
    for leaf, dim in dims.items():
        p = getattr(lin, leaf)
        if p is None or leaf in skip or dim is None:
            continue
        setattr(lin, leaf, nn.Parameter(_slice(p.data, dim, rank, size),
                                        requires_grad=p.requires_grad))
    if mode == "column":
        lin.d_out = d_out // size
    else:
        lin.d_in = d_in // size
    lin.tp = TPShard(mode=mode, group=group, rank=rank, size=size, d_in=d_in, d_out=d_out)


def apply_tensor_parallel_(model, mesh) -> None:
    """Split every LM layer over the mesh's model axis: the seven linears
    by COLUMN / ROW and each layer's head counts and MLP width made local
    (a per-layer copy of its LMConfig)."""
    size = mesh.model
    if size == 1:
        return
    check_tp(model, size)
    for layer in model.lm.layers:
        if layer.wqkv is not None or layer.gateup is not None:
            raise ValueError("the fused wqkv / gateup serving layout is not sharded over "
                             "--mesh_model (it is not on the training path)")
        cfg = layer.cfg
        layer.cfg = dataclasses.replace(
            cfg, num_heads=cfg.num_heads // size, num_kv_heads=cfg.num_kv_heads // size,
            intermediate_size=cfg.intermediate_size // size, head_dim=cfg.head_dim_)
        for name in COLUMN + ROW:
            shard_linear_(getattr(layer, name), tp_mode(name), mesh.tp_group, mesh.tp_rank, size)


LAYER_METHODS = ("attn_out", "mlp_residual", "_named_forward")


def apply_fsdp_(model, mesh) -> None:
    """FSDP2 units: each LlamaLayer (with the remat loop's methods
    registered) and the VLM root (with `row_features`, the frozen tower's
    entry outside `forward`)."""
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    dp_mesh = mesh.fsdp_mesh()
    with torch.no_grad():  # FSDP2 shards contiguous parameters only
        for p in model.parameters():
            if not p.is_contiguous():
                p.data = p.data.contiguous()
    for layer in model.lm.layers:
        fully_shard(layer, mesh=dp_mesh)
        for name in LAYER_METHODS:
            register_fsdp_forward_method(layer, name)
    fully_shard(model, mesh=dp_mesh)
    register_fsdp_forward_method(model, "row_features")


def keep_stage_layers_(model, mesh) -> None:
    """Under a pipeline, drop every decoder layer but this rank's stage's
    (models/lm/llama.py StageLayers keeps their global names); their
    weights and adapters are freed. A layer count the stages do not divide
    is refused."""
    from vlrlhf_torch.models.lm.llama import StageLayers
    from vlrlhf_torch.models.lm.pipeline import stage_span

    if mesh.pp is None:
        return
    lm = model.lm
    if len(lm.layers) != lm.cfg.num_layers:
        raise ValueError("the model holds one stage's layers already")
    lo, hi = stage_span(lm.cfg.num_layers, mesh.pipe, mesh.pipe_rank)
    lm.layers = StageLayers(list(lm.layers)[lo:hi], lo)


def shard_model_(model, mesh) -> None:
    """The whole plan on a model that holds its full weights (quantized and
    with adapters attached, as `setup_training` leaves it): the stage's
    layers, then tensor parallelism and FSDP2 over the stage's ranks."""
    keep_stage_layers_(model, mesh)
    apply_tensor_parallel_(model, mesh)
    apply_fsdp_(model, mesh)


def fsdp_units(model) -> list:
    from torch.distributed.fsdp import FSDPModule

    return [m for m in model.modules() if isinstance(m, FSDPModule)]


@contextlib.contextmanager
def unsharded(model):
    """Every FSDP unit's parameters gathered for the block (generation and
    the final gathers call module methods outside FSDP's hooks), resharded
    after it. A model without units is left as it is."""
    units = fsdp_units(model)
    for u in units:
        u.unshard()
    try:
        yield
    finally:
        for u in units:
            u.reshard()


def _layer_tensors(layer) -> list:
    """(kind, module name, leaf, tensor) for every tensor a decoder layer
    holds, in one order on every stage: each registered parameter
    (weights, biases, int8 / int4 codes, scales and gbias, the policy's
    LoRA, PLoRA, the norms) and each named LoRA set's a and b."""
    from vlrlhf_torch.models.common import Linear

    out = []
    for mname, mod in layer.named_modules():
        out += [("param", mname, leaf, p) for leaf, p in mod._parameters.items() if p is not None]
        if isinstance(mod, Linear):
            for name in sorted(mod.lora_sets):
                a, b = mod.lora_sets[name]
                out += [("set_a", mname, name, a), ("set_b", mname, name, b)]
    return out


def _stage_copies(layer, mesh) -> list:
    """Every stage's copy of the layer at this one's place in its stage, in
    stage order: this stage's is `layer` itself, each other a new
    LlamaLayer (built on the meta device, then given the joined tensors as
    frozen parameters: views into one gathered buffer per dtype, each
    16-byte aligned, so the int4 wrapper reads its codes in place) with
    layer's per-layer config, tensor-parallel places and widths."""
    from vlrlhf_torch.models.common import Linear
    from vlrlhf_torch.models.lm.llama import LlamaLayer

    items = _layer_tensors(layer)
    dtypes = sorted({t.dtype for *_, t in items}, key=str)

    def slot(t):  # each tensor's slot starts 16-byte aligned, as the kernels' loads need
        unit = max(16 // t.element_size(), 1)
        return -(-t.numel() // unit) * unit

    parts: dict = {}
    for dt in dtypes:
        flat = torch.cat([torch.cat([t.detach().reshape(-1),
                                     t.new_zeros(slot(t) - t.numel())])
                          for *_, t in items if t.dtype == dt])
        parts[dt] = _pipe_join(flat, mesh, to_all=True)
    copies = []
    for s in range(mesh.pipe):
        if s == mesh.pipe_rank:
            copies.append(layer)
            continue
        new = LlamaLayer(layer.cfg, "meta")
        for mname, mod in layer.named_modules():
            dst = new.get_submodule(mname)
            for leaf in mod._parameters:
                setattr(dst, leaf, None)
            if isinstance(mod, Linear):
                dst.d_in, dst.d_out, dst.tp = mod.d_in, mod.d_out, mod.tp
                dst.wqkv = dst.gateup = None
        offsets = dict.fromkeys(dtypes, 0)
        sets: dict = {}
        for kind, mname, leaf, t in items:
            at, dst = offsets[t.dtype], new.get_submodule(mname)
            view = parts[t.dtype][s][at:at + t.numel()].view(t.shape)
            offsets[t.dtype] += slot(t)
            if kind == "param":
                setattr(dst, leaf, nn.Parameter(view, requires_grad=False))
            else:
                sets.setdefault((mname, leaf), []).append(view)
        for (mname, name), (a, b) in sets.items():
            new.get_submodule(mname).lora_sets[name] = (a, b)
        copies.append(new)
    return copies


@contextlib.contextmanager
def whole_stack(model, mesh):
    """The model with every decoder layer for the block: generation's
    counterpart of vlrlhf_tpu's plain scan over a pipe-sharded stack, in
    which GSPMD gathers every stage's layers onto each device
    (models/lm/llama.py:758-761). FSDP2's units are gathered (`unsharded`)
    and, under a pipeline, the other stages' layers are joined over the
    pipe group (collective: every rank of the group enters): each layer's
    weights or int8 / int4 fields as this rank's tensor-parallel part
    holds them, the policy's LoRA, every named set (ppo's value set, the
    reward set) and PLoRA, as they are now (after the last update).
    `model.lm.layers` is then the whole stack in global order; after the
    block it is the stage's layers again, and the joined ones are freed.
    Without a pipeline this is `unsharded`. Under either sequence split
    the block is core.dist's `unsplit`: generation runs whole sequences."""
    from vlrlhf_torch.core.dist import unsplit

    if mesh is None or mesh.pp is None:
        with unsharded(model), unsplit():
            yield
        return
    lm = model.lm
    stage = lm.layers
    with unsharded(model), unsplit():
        per_place = [_stage_copies(layer, mesh) for layer in stage]
        lm.layers = nn.ModuleList(per_place[i][s] for s in range(mesh.pipe)
                                  for i in range(len(stage)))
        del per_place
        try:
            yield
        finally:
            lm.layers = stage


# ---------------------------------------------------------------------------
# The gradient norm's groups


def attach_norm_groups_(state, keys: list, mesh) -> None:
    """Give a TrainState over the mesh's leaves (named by their state-tree
    keys) its gradient-norm groups: per leaf, the process groups its
    squared norm is summed over: fsdp for an FSDP2-sharded leaf (the data
    replicas hold the same shard), then model for a leaf tensor
    parallelism splits, then pipe for a stage's leaf; a plain replicated
    leaf (the reward head) sums over none. Every distinct value then
    counts once. Under a pipeline also its `pipe_sum`: the leaves before
    the stack, whose gradients are summed over the stages (`pipe_role`);
    under the model split its `tp_sum`: the leaves replicated over model,
    whose gradients are summed over the tensor-parallel group (the
    gradient rule in the module note)."""
    from torch.distributed.tensor import DTensor

    groups = []
    for p, key in zip(state.trainable, keys):
        g = (mesh.fsdp_group,) if isinstance(p, DTensor) and mesh.fsdp > 1 else ()
        if tp_dim(key) is not None and mesh.model > 1:
            g = g + (mesh.tp_group,)
        if mesh.pp is not None and pipe_role(key) == "stage":
            g = g + (mesh.pipe_group,)
        groups.append(g)
    state.norm_groups = groups
    if mesh.pp is not None:
        state.pipe_sum = (mesh.pp, [i for i, k in enumerate(keys) if pipe_role(k) == "before"])
    if mesh.sp is not None and mesh.sp.axis == "model" and mesh.model > 1:
        state.tp_sum = (mesh.tp_group, [i for i, k in enumerate(keys) if tp_dim(k) is None])


# ---------------------------------------------------------------------------
# Between the mesh and the world-1 layout


def _tp_gather(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    import torch.distributed as dist

    if dim is None or mesh.model == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(mesh.model)]
    dist.all_gather(parts, t.contiguous(), group=mesh.tp_group)
    return torch.cat(parts, dim=dim)


def _fsdp_gather(t, mesh) -> torch.Tensor:
    """An FSDP2 DTensor's whole value from its dim-0 shards, gathered with a
    plain all_gather over the fsdp group (FSDP2 gives rank i rows [i * c,
    (i + 1) * c), c = ceil(n / fsdp), the last ranks fewer or none; each
    part is padded to c rows and the join cut to n). Not
    DTensor.full_tensor: with two gloo ranks sharing one H100 that call
    took a rank down (SIGSEGV) on a CUDA shard, where the plain all_gather
    that FSDP2 and _tp_gather use runs."""
    import torch.distributed as dist

    local = t.to_local().detach()
    n = t.shape[0]
    if mesh.fsdp == 1:
        return local
    c = -(-n // mesh.fsdp)
    if local.shape[0] < c:
        local = torch.cat([local, local.new_zeros((c - local.shape[0], *local.shape[1:]))])
    parts = [torch.empty_like(local) for _ in range(mesh.fsdp)]
    dist.all_gather(parts, local.contiguous(), group=mesh.fsdp_group)
    return torch.cat(parts)[:n]


def full_tensor(t: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """A leaf's world-1 value on every rank: FSDP2's shards gathered, then
    the tensor-parallel parts along `dim` (collective: every rank calls)."""
    from torch.distributed.tensor import DTensor

    if isinstance(t, DTensor):
        t = _fsdp_gather(t, mesh)
    return _tp_gather(t.detach(), dim, mesh)


def tp_part(full: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """This rank's tensor-parallel part of a world-1 tensor along `dim`
    (the tensor itself when `dim` is None or model == 1)."""
    if dim is None or mesh is None or mesh.model == 1:
        return full
    return _slice(full, dim, mesh.tp_rank, mesh.model)


def shard_full(full: torch.Tensor, like: torch.Tensor, dim: Optional[int], mesh) -> torch.Tensor:
    """This rank's part of a world-1 `full` tensor for a leaf placed like
    `like` (a DTensor of FSDP2 or a plain tensor): the tensor-parallel slice
    along `dim`, then FSDP2's dim-0 shard, on like's device and dtype."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    full = tp_part(full, dim, mesh).to(like.device, like.dtype)
    if isinstance(like, DTensor):
        return distribute_tensor(full, like.device_mesh, like.placements,
                                 src_data_rank=None).to_local()
    return full


def _pipe_join(t: torch.Tensor, mesh, to_all: bool) -> Optional[list]:
    """Every stage's `t` (one shape on each), in stage order: on every rank
    (`to_all`), or on stage 0 alone (the others get None). Under gloo a
    device tensor goes through a host copy."""
    import torch.distributed as dist

    pp = mesh.pp
    src = t.detach().to("cpu") if pp.staged(t) else t.detach().contiguous()
    if to_all:
        parts = [torch.empty_like(src) for _ in range(pp.size)]
        dist.all_gather(parts, src, group=pp.group)
    else:
        parts = [torch.empty_like(src) for _ in range(pp.size)] if pp.rank == 0 else None
        dist.gather(src, parts, dst=pp.peer(0), group=pp.group)
    return None if parts is None else [p.to(t.device) for p in parts]


def gather_stages(tree: dict, mesh) -> dict:
    """A {key: world-1 tensor} dict of this rank's stage (its layers keyed
    by global index) joined over the stages: every stage's layers, then
    the rest, in sorted key order, on every rank (collective; the tree
    itself without a pipeline). The stages' keys are matched by their
    place in the stage, so each stage calls with the same structure."""
    if mesh is None or mesh.pp is None:
        return tree
    idx = {k: layer_index(k) for k in tree}
    local = [k for k in tree if idx[k] is not None]
    out = {k: v for k, v in tree.items() if idx[k] is None}
    if local:
        lo, n = min(idx[k] for k in local), len({idx[k] for k in local})
        for k in sorted(local, key=lambda k: with_layer_index(k, idx[k] - lo)):
            for s, t in enumerate(_pipe_join(tree[k], mesh, to_all=True)):
                out[with_layer_index(k, s * n + idx[k] - lo)] = t
    return {k: out[k] for k in sorted(out)}


def stage_tree(tree: dict, keys: list) -> dict:
    """A world-1 `state_tree` cut to a stage's leaves `keys` (in their
    order), the counters kept: what a pipeline stage restores."""
    out = {}
    for group, val in tree.items():
        if isinstance(val, dict):
            missing = [k for k in keys if k not in val]
            if missing:
                raise ValueError(f"checkpoint {group} keys differ from the model's adapters: "
                                 f"{missing[:4]} missing")
            out[group] = {k: val[k] for k in keys}
        else:
            out[group] = val
    return out


def full_state_tree(tree: dict, mesh) -> dict:
    """A train_state `state_tree` with every tensor gathered to its world-1
    layout, every stage's layers joined (collective)."""
    out = {}
    for group, val in tree.items():
        if isinstance(val, dict):
            out[group] = gather_stages({k: full_tensor(t, tp_dim(k), mesh)
                                        for k, t in val.items()}, mesh)
        else:
            out[group] = val
    return out


def _linear_owner(model, name: str):
    from vlrlhf_torch.models.common import Linear

    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    return (mod, leaf) if isinstance(mod, Linear) else (None, leaf)


@torch.no_grad()
def full_model_state(model, mesh, dtype: torch.dtype) -> dict:
    """The model's state dict in the world-1 layout, with every quantized
    Linear made dense in `dtype` (ops/quant.py dense_weight), the base
    lora.merge_state folds the adapters into: under a mesh FSDP2's units
    gathered, each Linear's local part made dense on its rank, then the
    tensor-parallel parts joined (collective: every rank calls, the first
    keeps the tensors, the others get {}). Without a mesh the model's own
    tensors, on its device."""
    from vlrlhf_torch.core.dist import is_main_process
    from vlrlhf_torch.ops.quant import dense_weight

    out = {}
    with unsharded(model):
        units = bool(fsdp_units(model))
        for name, p in model.named_parameters():
            mod, leaf = _linear_owner(model, name)
            mode = mod.tp.mode if mod is not None and mod.tp is not None else None
            if mod is not None and leaf in ("weight_q", "weight_q4"):
                name, p, leaf = name.rpartition(".")[0] + ".weight", dense_weight(mod, dtype), \
                    "weight"
            elif mod is not None and leaf in ("weight_scale", "weight_scale4", "weight_gbias"):
                continue
            t = full_tensor(p, linear_tp_dim(mode, leaf), mesh)
            g = layer_index(name) if mesh is not None and mesh.pp is not None else None
            if g is not None:
                lo, hi = model.lm.layer_span
                parts = _pipe_join(t, mesh, to_all=False)
                if is_main_process():
                    for s, part in enumerate(parts):
                        out[with_layer_index(name, s * (hi - lo) + g - lo)] = part
            elif is_main_process():
                # a copy: an unsharded parameter's storage is freed at reshard
                out[name] = t.clone() if units else t
    return out
