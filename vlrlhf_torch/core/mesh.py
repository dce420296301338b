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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

MESH_DIMS = ("data", "fsdp", "model")


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
    collectives use. `dp_group` joins the ranks of one model coordinate
    (data x fsdp: they read different rows and hold the same model shard),
    `tp_group` the ranks of one (data, fsdp) coordinate."""

    device_mesh: object  # torch.distributed.device_mesh.DeviceMesh
    data: int
    fsdp: int
    model: int
    coords: tuple[int, int, int]  # this rank's (data, fsdp, model)
    dp_group: object
    fsdp_group: object
    tp_group: object

    @property
    def dp_size(self) -> int:
        return self.data * self.fsdp

    @property
    def dp_rank(self) -> int:
        """This rank's data-parallel coordinate: which slice of each global
        batch it reads."""
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


def make_mesh(config: Optional[MeshConfig] = None, device_type: str = "cuda") -> Mesh:
    """The (data, fsdp, model) mesh over every rank of the initialized
    process group, registered as the global mesh. Every rank takes part:
    a mesh smaller than the world is refused (vlrlhf_tpu idles the spare
    devices; a spare process would deadlock the collectives)."""
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
    dm = init_device_mesh(device_type, (data, fsdp, model), mesh_dim_names=MESH_DIMS)
    rank = dist.get_rank()
    coords = (rank // (fsdp * model), (rank // model) % fsdp, rank % model)
    dp_group = None
    for m in range(model):  # every rank creates every group, in one order
        ranks = [(d * fsdp + f) * model + m for d in range(data) for f in range(fsdp)]
        g = dist.new_group(ranks)
        if m == coords[2]:
            dp_group = g
    return set_global_mesh(Mesh(
        device_mesh=dm, data=data, fsdp=fsdp, model=model, coords=coords,
        dp_group=dp_group, fsdp_group=dm.get_group("fsdp"), tp_group=dm.get_group("model"),
    ))
