"""The device mesh (counterpart of vlrlhf_tpu/core/mesh.py).

One process per GPU; the world's ranks form a `DeviceMesh` with named dims

  pipe   — GPipe stages: stage p holds decoder layers [p L/S, (p+1) L/S)
  data   — replicas of the sharded model (HSDP's replicate dim)
  fsdp   — FSDP2 parameter, gradient and optimizer-state sharding
  model  — tensor parallelism over attention heads and the MLP width

laid out rank = p * (data * fsdp * model) + (d * fsdp + f) * model + m:
`pipe` outermost and `model` innermost, so a tensor-parallel group is
ranks next to each other (one host's NVLink peers) and a stage is a
contiguous block of data x fsdp x model ranks. FSDP2 and tensor
parallelism work inside a stage (their groups share its p); the only
traffic between blocks is the pipeline's (models/lm/pipeline.py): one
microbatch's activations per hop, its gradient back, the stack's output
made whole, and the gradients of leaves before the stack summed. The
pipe group (`Mesh.pipe_group`, a core.dist.PipeShard's) joins the S
ranks that share (d, f, m), one per stage, and is a process group of its
own, so the hops never interleave with a stage's collectives. The ranks
of one pipe group read the same rows: `dp_size` and `dp_rank` count
data x fsdp alone.

Sequence parallelism (vlrlhf_tpu's LMConfig.sequence_parallel_axis) splits
each sequence into contiguous slices over one axis's ranks, which then
read the same rows; `Mesh.sp` (a core.dist.SPShard) names the axis, its
group and this rank's slice:
  - "fsdp": the ranks of one fsdp group each hold an S / fsdp slice and
    attention runs as a ring over the group (ops/ring_attention.py). The
    rows then ride `data` alone, as vlrlhf_tpu's `sp_batch_spec` has them
    (core/partitioning.py:157-169): `dp_size` and `dp_rank` count data
    replicas, `dp_group` joins them, and `grad_group` (data x fsdp, the
    ranks FSDP2 reduces over) is unchanged. The ring has a process group
    of its own, so its point-to-point exchanges never interleave with
    FSDP2's collectives on the fsdp group.
  - "model": Megatron-LM's sequence parallelism over the tensor-parallel
    group, whose ranks read the same rows anyway. Norms, residuals, the
    final norm, lm_head and the loss terms run on a rank's S / model
    slice; each layer all-gathers the normed slice before its column
    linears (wq / wk / wv, gate / up), runs attention on its heads over
    the whole sequence (kernels 1-3), and its row linears (wo, down)
    reduce-scatter their partial sums back to the slice
    (models/lm/llama.py, models/common.py Linear, core/dist.py
    gather_seq / scatter_seq). The split's group is `tp_group`; the rows
    ride data x fsdp, so `dp_size`, `dp_rank`, `dp_group` and
    `grad_group` are a plain mesh's.
The port keeps the switch on the mesh, not on the LM's config: every
training forward under such a mesh is sequence-parallel, and generation
(prefill, decode, chunks) runs whole sequences inside core/dist.py's
`unsplit` block (core/partitioning.py whole_stack), as vlrlhf_tpu's decode
takes its cache branch; outside it they refuse a split by name. A
pipeline and the sequence split are refused together, as vlrlhf_tpu
asserts (models/lm/pipeline.py:87-91).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from vlrlhf_torch.core.dist import PipeShard, SPShard

MESH_DIMS = ("pipe", "data", "fsdp", "model")


def check_sp_axis(axis: str) -> str:
    """The sequence-parallel axis a mesh accepts: "" (none), "fsdp" or
    "model". Every other name is refused by name."""
    if axis in ("", "fsdp", "model"):
        return axis
    if axis == "data":
        raise ValueError("--sequence_parallel_axis data: the data axis shards the batch's rows, "
                         "so it cannot split their sequence too (vlrlhf_tpu cannot form "
                         "P('data', 'data') either); use fsdp or model")
    raise ValueError(f"--sequence_parallel_axis {axis!r}: not a mesh axis the sequence can be "
                     "split over; expected fsdp or model")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape. -1 axes absorb remaining devices (at most one)."""

    data: int = 1
    fsdp: int = -1
    model: int = 1
    pipe: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int, int]:
        """vlrlhf_tpu's MeshConfig.resolve (mesh.py:53-78), the same sizes
        and the same errors."""
        sizes = [self.data, self.fsdp, self.model, self.pipe]
        n_auto = sum(1 for s in sizes if s == -1)
        if n_auto > 1:
            raise ValueError(f"At most one mesh axis may be -1, got {sizes}")
        fixed = math.prod(s for s in sizes if s != -1)
        if n_auto == 1:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes = [n_devices // fixed if s == -1 else s for s in sizes]
        elif fixed > n_devices:
            raise ValueError(
                f"Mesh {sizes} needs {fixed} devices but {n_devices} are available"
            )
        return tuple(sizes)


@dataclasses.dataclass
class Mesh:
    """The world's `DeviceMesh` and the process groups the port's own
    collectives use. `grad_group` joins the ranks of one model coordinate
    (data x fsdp: they hold the same model shard and FSDP2 reduces their
    gradients), `dp_group` the ranks that read different rows (the same
    ranks, or under the fsdp split those of one (fsdp, model)
    coordinate), `tp_group` the ranks of one (data, fsdp) coordinate and
    `sp` (sequence parallelism only) the split: under "fsdp" a ring of the
    ranks of one (data, model) coordinate, under "model" `tp_group`. Every
    group but `pp`'s and `token_group`'s lies inside this rank's stage;
    `pp` (pipe > 1 only) joins the stages' ranks of this (data, fsdp,
    model) coordinate, and `token_group` the ranks that decode the same
    rows: the model x pipe ranks of this (data, fsdp) coordinate, or under
    the fsdp split the fsdp x model ranks of this data coordinate."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data: int
    fsdp: int
    model: int
    coords: tuple[int, int, int]  # this rank's (data, fsdp, model)
    dp_group: object
    fsdp_group: object
    tp_group: object
    grad_group: object = None
    sp: Optional[SPShard] = None  # the ring, under sequence parallelism
    pipe: int = 1
    pp: Optional[PipeShard] = None  # the stages, under a pipeline
    # the ranks of one (data, fsdp) coordinate, model x pipe of them, which
    # decode the same rows (core.dist model_group_tokens); None when this
    # rank is alone in it
    token_group: object = None
    # inside core.dist's `unsplit` block: generation sees no sequence split
    split_off: bool = False

    @property
    def pipe_rank(self) -> int:
        """This rank's stage (0 without a pipeline)."""
        return 0 if self.pp is None else self.pp.rank

    @property
    def pipe_group(self):
        """The S ranks of this (data, fsdp, model) coordinate, one per stage
        (None without a pipeline)."""
        return None if self.pp is None else self.pp.group

    @property
    def sp_size(self) -> int:
        """Ranks one sequence is split over (1: no sequence parallelism)."""
        return 1 if self.sp is None else self.sp.size

    @property
    def sp_rank(self) -> int:
        """This rank's place in the ring: it holds slice sp_rank of S / sp_size."""
        return 0 if self.sp is None else self.sp.rank

    @property
    def ring(self) -> bool:
        """Whether the sequence is split over fsdp, whose ranks then read
        the same rows."""
        return self.sp is not None and self.sp.axis == "fsdp"

    @property
    def dp_size(self) -> int:
        return self.data if self.ring else self.data * self.fsdp

    @property
    def dp_rank(self) -> int:
        """This rank's data-parallel coordinate: which slice of each global
        batch it reads."""
        if self.ring:
            return self.coords[0]
        return self.coords[0] * self.fsdp + self.coords[1]

    @property
    def tp_rank(self) -> int:
        return self.coords[2]

    def fsdp_mesh(self):
        """The DeviceMesh FSDP2 shards over: fsdp alone, or (data, fsdp)
        for HSDP when data > 1."""
        if self.data > 1:
            return self.device_mesh["data", "fsdp"]
        return self.device_mesh["fsdp"]


def rank_of(shape: tuple[int, int, int, int], p: int, d: int, f: int, m: int) -> int:
    """The rank at (pipe, data, fsdp, model) coordinates (p, d, f, m) of a
    mesh of `shape` (pipe, data, fsdp, model): pipe outermost, model
    innermost, as init_device_mesh lays the world out."""
    _, data, fsdp, model = shape
    return ((p * data + d) * fsdp + f) * model + m


def coords_of(shape: tuple[int, int, int, int], rank: int) -> tuple[int, int, int, int]:
    """`rank_of`'s inverse: (p, d, f, m)."""
    _, data, fsdp, model = shape
    return (rank // (data * fsdp * model), rank // (fsdp * model) % data,
            rank // model % fsdp, rank % model)


_GLOBAL_MESH: Optional[Mesh] = None


def set_global_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    global _GLOBAL_MESH
    _GLOBAL_MESH = mesh
    return mesh


def get_global_mesh() -> Mesh:
    if _GLOBAL_MESH is None:
        raise RuntimeError("No global mesh registered: call core.mesh.make_mesh() first")
    return _GLOBAL_MESH


def current_mesh() -> Optional[Mesh]:
    """The registered mesh, or None in a plain single-process run."""
    return _GLOBAL_MESH


def make_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda",
              sequence_parallel_axis: str = "", microbatches: int = 0) -> Mesh:
    """The (pipe, data, fsdp, model) mesh over every rank of the
    initialized process group, registered as the global mesh. Every rank
    takes part: a mesh smaller than the world is refused (vlrlhf_tpu idles
    the spare devices; a spare process would deadlock the collectives).
    With `sequence_parallel_axis` "fsdp" the fsdp ranks split each
    sequence, with "model" the tensor-parallel ranks; with pipe > 1 the
    batch's rows cross the stages as
    `microbatches` microbatches (0: one per stage, vlrlhf_tpu's default).
    See the module note."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    world = dist.get_world_size()
    data, fsdp, model, pipe = config.resolve(world)
    axis = check_sp_axis(sequence_parallel_axis)
    sp = axis == "fsdp"
    if pipe > 1 and axis:
        raise ValueError(f"--mesh_pipe {pipe} with --sequence_parallel_axis {axis}: the "
                         "pipeline and the sequence split are mutually exclusive (as in "
                         "vlrlhf_tpu, models/lm/pipeline.py:87-91)")
    if microbatches and pipe == 1:
        raise ValueError(f"--pipeline_microbatches {microbatches}: it splits the rows of a "
                         "pipeline, which needs --mesh_pipe > 1")
    if pipe * data * fsdp * model != world:
        raise ValueError(f"mesh pipe={pipe} data={data} fsdp={fsdp} model={model} covers "
                         f"{pipe * data * fsdp * model} ranks, the world has {world}")
    shape = (pipe, data, fsdp, model)
    dm = init_device_mesh(device_type, shape, mesh_dim_names=MESH_DIMS)
    p, *coords = coords_of(shape, dist.get_rank())
    coords = tuple(coords)

    def groups(members, key) -> object:
        """new_group for every coordinate (every rank creates every group,
        in one order); returns the one holding this rank."""
        mine = None
        for c, ranks in members:
            g = dist.new_group(ranks)
            if c == key:
                mine = g
        return mine

    def at(q, d, f, m):
        return rank_of(shape, q, d, f, m)

    grad_group = groups((((q, m), [at(q, d, f, m) for d in range(data) for f in range(fsdp)])
                         for q in range(pipe) for m in range(model)), (p, coords[2]))
    dp_group = sp_group = pp = None
    if sp:
        dp_group = groups((((f, m), [at(0, d, f, m) for d in range(data)])
                           for f in range(fsdp) for m in range(model)), coords[1:])
        sp_group = groups((((d, m), [at(0, d, f, m) for f in range(fsdp)])
                           for d in range(data) for m in range(model)), (coords[0], coords[2]))
    if pipe > 1:
        pipe_group = groups(((c, [at(q, *c) for q in range(pipe)])
                             for c in ((d, f, m) for d in range(data) for f in range(fsdp)
                                       for m in range(model))), coords)
        pp = PipeShard(pipe_group, p, pipe, dist.get_backend(pipe_group), microbatches or pipe)
        # the group's first operation is a collective of all its ranks (NCCL
        # leaves a first point-to-point call on a group undefined otherwise)
        dist.barrier(group=pipe_group)
        token_group = groups((((d, f), [at(q, d, f, m) for q in range(pipe)
                                        for m in range(model)])
                              for d in range(data) for f in range(fsdp)), coords[:2])
    elif sp and fsdp * model > 1:  # a ring's ranks decode its rows together
        token_group = groups(((d, [at(0, d, f, m) for f in range(fsdp) for m in range(model)])
                              for d in range(data)), coords[0])
    else:
        token_group = dm.get_group("model") if model > 1 else None
    tp_group = dm.get_group("model")
    if sp:
        split = SPShard(sp_group, coords[1], fsdp, dist.get_backend(sp_group), "fsdp")
    elif axis == "model":
        split = SPShard(tp_group, coords[2], model, dist.get_backend(tp_group), "model")
    else:
        split = None
    return set_global_mesh(Mesh(
        device_mesh=dm, data=data, fsdp=fsdp, model=model, coords=coords,
        dp_group=dp_group if sp else grad_group, fsdp_group=dm.get_group("fsdp"),
        tp_group=tp_group, grad_group=grad_group, sp=split,
        pipe=pipe, pp=pp, token_group=token_group,
    ))
