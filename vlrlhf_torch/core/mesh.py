"""The device mesh (counterpart of vlrlhf_tpu/core/mesh.py).

One process per GPU; the world's ranks form a `DeviceMesh` with named dims

  data   — replicas of the sharded model (HSDP's replicate dim)
  fsdp   — FSDP2 parameter, gradient and optimizer-state sharding
  model  — tensor parallelism over attention heads and the MLP width

laid out rank = (d * fsdp + f) * model + m, so a tensor-parallel group is
ranks next to each other (one host's NVLink peers). vlrlhf_tpu's fourth
axis, `pipe`, is parsed and resolved the same way, but a mesh with
pipe > 1 is refused here: the pipeline is part 2 of the port's multi-GPU
work (ROADMAP.md).

Sequence parallelism (`sequence_parallel_axis="fsdp"`, vlrlhf_tpu's
LMConfig.sequence_parallel_axis): the ranks of one fsdp group read the
same rows and each holds a contiguous S / fsdp slice of every sequence,
attention running as a ring over the group (ops/ring_attention.py). The
rows then ride `data` alone, as vlrlhf_tpu's `sp_batch_spec` has them
(core/partitioning.py:157-169): `dp_size` and `dp_rank` count data
replicas, `dp_group` joins them, and `grad_group` (data x fsdp, the ranks
FSDP2 reduces over) is unchanged. The ring has a process group of its own
(`Mesh.sp`, a core.dist.SPShard over the fsdp group's ranks), so its
point-to-point exchanges never interleave with FSDP2's collectives on the
fsdp group. The port
keeps the switch on the mesh, not on the LM's config: every training
forward under such a mesh is sequence-parallel, and the paths that cannot
be (prefill, decode, chunks) refuse it by name.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from vlrlhf_torch.core.dist import SPShard

MESH_DIMS = ("data", "fsdp", "model")


def check_sp_axis(axis: str) -> str:
    """The sequence-parallel axis a mesh accepts: "" (none) or "fsdp". Every
    other name is refused by name."""
    if axis in ("", "fsdp"):
        return axis
    if axis == "data":
        raise ValueError("--sequence_parallel_axis data: the data axis shards the batch's rows, "
                         "so it cannot split their sequence too (vlrlhf_tpu cannot form "
                         "P('data', 'data') either); use fsdp")
    if axis == "model":
        raise ValueError("--sequence_parallel_axis model: a sequence split over the "
                         "tensor-parallel ranks needs Megatron-style sequence gathers around "
                         "the tensor-parallel linears, which are not ported (ROADMAP.md); use "
                         "fsdp")
    raise ValueError(f"--sequence_parallel_axis {axis!r}: not a mesh axis the sequence can be "
                     "split over; expected fsdp")


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
    ranks, or under sequence parallelism those of one (fsdp, model)
    coordinate), `tp_group` the ranks of one (data, fsdp) coordinate and
    `sp` (sequence parallelism only) the ring: the ranks of one (data,
    model) coordinate."""

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

    @property
    def sp_size(self) -> int:
        """Ranks one sequence is split over (1: no sequence parallelism)."""
        return 1 if self.sp is None else self.sp.size

    @property
    def sp_rank(self) -> int:
        """This rank's place in the ring: it holds slice sp_rank of S / sp_size."""
        return 0 if self.sp is None else self.sp.rank

    @property
    def dp_size(self) -> int:
        return self.data * self.fsdp // self.sp_size

    @property
    def dp_rank(self) -> int:
        """This rank's data-parallel coordinate: which slice of each global
        batch it reads."""
        if self.sp is not None:
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
              sequence_parallel_axis: str = "") -> Mesh:
    """The (data, fsdp, model) mesh over every rank of the initialized
    process group, registered as the global mesh. Every rank takes part:
    a mesh smaller than the world is refused (vlrlhf_tpu idles the spare
    devices; a spare process would deadlock the collectives). With
    `sequence_parallel_axis` "fsdp" the fsdp ranks split each sequence
    (the module note)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    config = config or MeshConfig()
    world = dist.get_world_size()
    data, fsdp, model, pipe = config.resolve(world)
    if pipe > 1:
        raise ValueError(f"--mesh_pipe {pipe}: the pipeline is not ported yet (multi-GPU "
                         "part 2, ROADMAP.md)")
    if data * fsdp * model != world:
        raise ValueError(f"mesh data={data} fsdp={fsdp} model={model} covers "
                         f"{data * fsdp * model} ranks, the world has {world}")
    sp = check_sp_axis(sequence_parallel_axis) == "fsdp"
    dm = init_device_mesh(device_type, (data, fsdp, model), mesh_dim_names=MESH_DIMS)
    rank = dist.get_rank()
    coords = (rank // (fsdp * model), (rank // model) % fsdp, rank % model)

    def groups(members, key) -> object:
        """new_group for every coordinate (every rank creates every group,
        in one order); returns the one holding this rank."""
        mine = None
        for c, ranks in members:
            g = dist.new_group(ranks)
            if c == key:
                mine = g
        return mine

    def at(d, f, m):
        return (d * fsdp + f) * model + m

    grad_group = groups(((m, [at(d, f, m) for d in range(data) for f in range(fsdp)])
                         for m in range(model)), coords[2])
    dp_group = sp_group = None
    if sp:
        dp_group = groups((((f, m), [at(d, f, m) for d in range(data)])
                           for f in range(fsdp) for m in range(model)), coords[1:])
        sp_group = groups((((d, m), [at(d, f, m) for f in range(fsdp)])
                           for d in range(data) for m in range(model)), (coords[0], coords[2]))
    return set_global_mesh(Mesh(
        device_mesh=dm, data=data, fsdp=fsdp, model=model, coords=coords,
        dp_group=dp_group if sp else grad_group, fsdp_group=dm.get_group("fsdp"),
        tp_group=dm.get_group("model"), grad_group=grad_group,
        sp=SPShard(sp_group, coords[1], fsdp, dist.get_backend(sp_group)) if sp else None,
    ))
