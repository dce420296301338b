"""The process group and its host collectives (counterpart of
vlrlhf_tpu/core/dist.py).

A multi-GPU run is one process per GPU started by torchrun, which sets
RANK, WORLD_SIZE, LOCAL_RANK and the rendezvous address; `initialize`
joins them in a process group: NCCL on cuda:LOCAL_RANK, or gloo when the
caller runs on the CPU (the tests' multi-process dry runs). There is no
fallback from NCCL to gloo. Without a process group every function here is
the single-process identity, so a plain run takes none of this.

vlrlhf_tpu's `make_global_batch` / `_sharded_concat` assemble one global
array from per-process rows; here each rank keeps its local
[chosen; rejected] batch as a plain tensor, and the gradients meet in
FSDP2's reduce-scatter, so they have no counterpart. `batch_process_span`
becomes `data_parallel_slice`: a rank's data-parallel coordinate gives its
slice of every global batch, and the ranks of one tensor-parallel group
read the same rows (and under the fsdp sequence split, those of one fsdp
group too: core/mesh.py).

Sequence parallelism's collectives live here too: `SPShard` (a rank's
place in the split, over `fsdp` a ring, over `model` the tensor-parallel
group), `ring_exchange` (each tensor to the ring's next rank, the previous
rank's back), `sum_over_sp` (a loss term's sum over the split whose
backward is the identity), `gather_seq` / `scatter_seq` (the model
split's all-gather of the sequence before the column linears and
reduce-scatter after the row linears) and `unsplit` (generation's block,
in which nothing is split). So do the pipeline's: `PipeShard`
(a rank's stage, the pipe group and the microbatch count), `pipe_send` /
`pipe_recv` (one microbatch's tensor to the next or previous stage),
`pipe_broadcast` (a stage's tensor to every stage) and `pipe_sum_` (a sum
over the stages in place).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os
from typing import Any

import numpy as np
import torch


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def launched_by_torchrun() -> bool:
    """True when the environment carries torchrun's rank variables."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))


def local_device(device_type: str) -> torch.device:
    """cuda:LOCAL_RANK under torchrun (cuda:0 otherwise), or the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def initialize(device_type: str = "cuda") -> bool:
    """Join torchrun's process group (a no-op when one is up already, or
    when the process was not launched by torchrun). Returns whether a
    process group is up."""
    if is_initialized():
        return True
    if not launched_by_torchrun():
        return False
    dist = _dist()
    if device_type == "cuda":
        dev = local_device("cuda")
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev,
                                timeout=datetime.timedelta(minutes=30))
    else:
        dist.init_process_group("gloo", timeout=datetime.timedelta(minutes=30))
    return True


def shutdown() -> None:
    if is_initialized():
        _dist().destroy_process_group()


def process_index() -> int:
    return _dist().get_rank() if is_initialized() else 0


def process_count() -> int:
    return _dist().get_world_size() if is_initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def sync_global_devices(name: str = "barrier") -> None:
    """A barrier over every rank (`name` labels it for the reader)."""
    if is_initialized():
        _dist().barrier()


def gather_objects(objs: list, group=None) -> list:
    """Every rank's list of JSON-serialisable objects, concatenated in
    rank order (ranks hold contiguous shards, `shard_rows_for_process`, so
    this is dataset order; vlrlhf_tpu `gather_objects`, dist.py:62)."""
    if not is_initialized():
        return list(objs)

    def _default(o):
        return o.item() if hasattr(o, "item") else str(o)

    payload = json.dumps(list(objs), default=_default)
    out: list = [None] * _dist().get_world_size(group)
    _dist().all_gather_object(out, payload, group=group)
    return [o for p in out for o in json.loads(p)]


def process_allgather(x: Any) -> np.ndarray:
    """Every rank's array stacked on a new leading axis (rank order)."""
    x = np.asarray(x)
    if not is_initialized():
        return x[None]
    out: list = [None] * process_count()
    _dist().all_gather_object(out, x)
    return np.stack(out)


def any_process_failed(local_fail: bool) -> bool:
    """True iff any rank hit a failure this step: every rank then takes the
    same branch, keeping the collectives aligned (vlrlhf_tpu
    `any_process_failed`, dist.py:208)."""
    if not is_initialized():
        return bool(local_fail)
    return bool(process_allgather(np.asarray([int(local_fail)], np.int32)).sum() > 0)


@contextlib.contextmanager
def main_process_first(name: str = "main_first"):
    """Rank 0 runs the body first (a dataset cache it builds), the others
    after it (vlrlhf_tpu `main_process_first`, dist.py:221)."""
    if is_main_process():
        yield
        sync_global_devices(f"{name}_done")
    else:
        sync_global_devices(f"{name}_done")
        yield


def data_parallel_slice(local_batch: int) -> tuple[int, tuple[int, int]]:
    """(global batch, (lo, hi)): --per_device_train_batch_size rows per
    data-parallel rank, the global batch that times data x fsdp, and this
    rank's rows of it. Without a mesh: (local_batch, (0, local_batch))."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        return local_batch, (0, local_batch)
    lo = mesh.dp_rank * local_batch
    return local_batch * mesh.dp_size, (lo, lo + local_batch)


def all_reduce_mean(t: torch.Tensor, group=None) -> torch.Tensor:
    """The mean over the group's ranks of a tensor (a copy)."""
    if not is_initialized():
        return t
    dist = _dist()
    out = t.detach().clone()
    dist.all_reduce(out, group=group)
    return out / dist.get_world_size(group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over the group's ranks (a copy; the identity without a
    process group)."""
    if not is_initialized():
        return t
    out = t.detach().clone()
    _dist().all_reduce(out, group=group)
    return out


def dp_group():
    """The data-parallel group of the registered mesh, the ranks that read
    different rows (None: no mesh)."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    return None if mesh is None else mesh.dp_group


def grad_group():
    """The ranks whose gradients FSDP2 reduces together, data x fsdp at
    this rank's model coordinate (None: no mesh): a trainable leaf outside
    the FSDP2 units (rm's head) reduces over the same ranks."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    return None if mesh is None else mesh.grad_group


def dp_size() -> int:
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    return 1 if mesh is None else mesh.dp_size


def global_metrics(metrics: dict) -> dict:
    """A step's 0-dim metrics as means over the ranks, in one collective
    (a rank's metric is the mean over its rows; the rows are equal in
    number on every rank, so this is the mean over the global batch).
    Under sequence parallelism the ranks of one ring hold equal metrics
    (their loss terms are summed over the ring first), so each data
    replica counts as often as every other and the mean over all ranks is
    still the mean over the replicas: nothing is counted twice."""
    if not is_initialized() or not metrics:
        return metrics
    keys = list(metrics)
    vals = torch.stack([torch.as_tensor(metrics[k]).detach().float().reshape(())
                        for k in keys])
    vals = all_reduce_mean(vals)
    return dict(zip(keys, vals.unbind()))


def dp_rank() -> int:
    """This rank's data-parallel coordinate (0 without a mesh)."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    return 0 if mesh is None else mesh.dp_rank


def dp_rows(n: int, pairs: bool) -> "tuple[tuple[int, ...], int] | None":
    """This data-parallel rank's `n` local rows as (their indices in the
    global batch, its row count), the layout `data_parallel_slice` gives:
    a pair batch [chosen; rejected] holds the rank's pairs in both halves
    of the global [chosen; rejected] batch, another batch a contiguous
    block. None when one rank reads every row (models/common.py Ctx.rows:
    the LoRA dropout rows)."""
    size = dp_size()
    if size == 1:
        return None
    if not pairs:
        lo = dp_rank() * n
        return tuple(range(lo, lo + n)), n * size
    h = n // 2
    lo, g = dp_rank() * h, h * size
    return tuple(range(lo, lo + h)) + tuple(range(g + lo, g + lo + h)), 2 * g


def dp_gather_rows(t: torch.Tensor) -> torch.Tensor:
    """Every data-parallel rank's rows of `t` (same shape on each),
    concatenated in data-parallel order along dim 0: the global batch's
    tensor (the identity without a mesh)."""
    if dp_size() == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(dp_size())]
    _dist().all_gather(parts, t.contiguous(), group=dp_group())
    return torch.cat(parts)


def vote_and_gather(flags: tuple, payload: Any) -> tuple[tuple, list]:
    """One host collective over every rank: each flag OR-ed over the ranks
    of every stage (a failure, a SIGTERM, a later stage's failed reward:
    every rank then takes the same branch), and every data-parallel rank's
    payload in data-parallel order, the first rank of each data-parallel
    coordinate of the first stage speaking for it (a coordinate's ranks are
    contiguous: its tensor-parallel group, and under the fsdp split its
    ring too, read the same rows; a pipeline's stages hold the same rows
    and tokens). Without a process group: (flags, [payload])."""
    flags = tuple(bool(f) for f in flags)
    if not is_initialized():
        return flags, [payload]
    from vlrlhf_torch.core.mesh import current_mesh

    out: list = [None] * process_count()
    _dist().all_gather_object(out, (flags, payload))
    mesh = current_mesh()
    voted = tuple(any(f[i] for f, _ in out) for i in range(len(flags)))
    if mesh is None:
        return voted, [p for _, p in out]
    block = mesh.data * mesh.fsdp * mesh.model  # the first stage's ranks
    return voted, [p for _, p in out[:block:block // mesh.dp_size]]


def model_group_tokens(t: torch.Tensor) -> torch.Tensor:
    """Tokens the ranks of one data-parallel coordinate all emit: under a
    mesh with model x pipe > 1, each step's sampled tokens broadcast from
    the first rank of the group those ranks form (`Mesh.token_group`; on
    the device, no host sync), so a tensor-parallel group, and under a
    pipeline every stage decoding the whole stack, decodes one sequence by
    construction, whatever each rank's generator drew. Elsewhere `t`
    itself."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None or mesh.token_group is None or not is_initialized():
        return t
    t = t.contiguous()
    group = mesh.token_group
    _dist().broadcast(t, src=_dist().get_global_rank(group, 0), group=group)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    if not is_initialized():
        return obj
    box = [obj]
    _dist().broadcast_object_list(box, src=src)
    return box[0]


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: in-place updates reach the DTensor),
    any other tensor itself."""
    if is_initialized():
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            return t.to_local()
    return t


# ---------------------------------------------------------------------------
# Sequence parallelism's collectives


@dataclasses.dataclass(frozen=True)
class SPShard:
    """A rank's place in the sequence split: the group the sequence is split
    over, this rank's index in it (it holds slice `rank` of S / size), the
    group's size, its backend (which picks the transport) and the mesh
    axis: "fsdp", a ring of its own whose ranks run attention as
    ops/ring_attention.py's ring, or "model", the tensor-parallel group,
    whose ranks gather the sequence around their linears (core/mesh.py)."""

    group: Any
    rank: int
    size: int
    backend: str
    axis: str

    def span(self, s: int) -> tuple[int, int]:
        """[lo, hi): this rank's contiguous slice of a length-s sequence."""
        if s % self.size:
            raise ValueError(f"a sequence of {s} positions does not split over the "
                             f"{self.size} sequence-parallel ranks (the collator rounds its "
                             "bucket up to a multiple of them)")
        n = s // self.size
        return self.rank * n, (self.rank + 1) * n


@contextlib.contextmanager
def unsplit():
    """A block in which `sp_shard()` reads None (the registered mesh's
    `split_off`): generation (prefill, decode, chunks) runs on whole
    sequences under either split, as vlrlhf_tpu's decode takes its cache
    branch, not the ring (models/lm/llama.py:295); under the model split
    its tensor-parallel linears run as without one (core/partitioning.py
    whole_stack enters it, and ppo's reward model: cli/main.py
    reward_model_fn)."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    if mesh is None:
        yield
        return
    kept, mesh.split_off = mesh.split_off, True
    try:
        yield
    finally:
        mesh.split_off = kept


def sp_shard() -> "SPShard | None":
    """The registered mesh's sequence split (None: no mesh, no sequence
    parallelism, or inside an `unsplit` block)."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    return None if mesh is None or mesh.split_off else mesh.sp


def sp_size() -> int:
    sp = sp_shard()
    return 1 if sp is None else sp.size


def model_split() -> "SPShard | None":
    """The sequence split when it runs over the tensor-parallel group
    (`--sequence_parallel_axis model`), else None."""
    sp = sp_shard()
    return sp if sp is not None and sp.axis == "model" else None


def ring_size() -> int:
    """The ranks of the fsdp ring, whose gradient partials FSDP2's mean must
    sum (the steps scale their loss by it; core/partitioning.py), else 1.
    The model split's partials are summed by the optimizer instead
    (train/train_state.py `tp_sum`)."""
    sp = sp_shard()
    return sp.size if sp is not None and sp.axis == "fsdp" else 1


class RingExchange:
    """An exchange in flight (`ring_exchange`): `wait()` returns the
    received tensors, on the senders' device."""

    def __init__(self, works: list, sent: list, received: list, device):
        self._works, self._sent, self._received, self._device = works, sent, received, device

    def wait(self) -> list:
        for w in self._works:
            w.wait()
        self._sent = None
        return [r.to(self._device) for r in self._received]


def ring_exchange(tensors, sp: SPShard) -> RingExchange:
    """Start sending each tensor to the ring's next rank and receiving the
    previous rank's tensor of the same shape and dtype. Under NCCL the
    pairs go as one `batch_isend_irecv`, device to device; gloo's
    point-to-point ops read and write host memory only (two gloo ranks on
    an H100, torch 2.11: isend of a CUDA tensor aborted the sending rank,
    "writev: Bad address"), so under gloo a device tensor is staged
    through a host copy (chosen by the group's backend, never by catching
    an error)."""
    dist = _dist()
    device = tensors[0].device
    host = sp.backend == "gloo" and device.type != "cpu"
    sent = [t.detach().to("cpu") if host else t.detach().contiguous() for t in tensors]
    received = [torch.empty_like(t) for t in sent]
    nxt = dist.get_global_rank(sp.group, (sp.rank + 1) % sp.size)
    prv = dist.get_global_rank(sp.group, (sp.rank - 1) % sp.size)
    ops = []
    for s, r in zip(sent, received):
        ops += [dist.P2POp(dist.isend, s, nxt, sp.group), dist.P2POp(dist.irecv, r, prv, sp.group)]
    return RingExchange(dist.batch_isend_irecv(ops), sent, received, device)


class _SumOverSP(torch.autograd.Function):
    """The ring's sum of a loss term, added in f32. Backward, the gradient
    as it is: the summed term is replicated on every rank of the ring,
    each rank backpropagates it into its own slice of the sequence, and
    the ranks' parameter partials are added up by the gradient reduction
    (torch.distributed.nn's all_reduce would sum the gradients here too,
    scaling every one by the ring's size)."""

    @staticmethod
    def forward(ctx, t, group):
        acc = t.detach().to(torch.float32, copy=True).contiguous()
        _dist().all_reduce(acc, group=group)
        return acc.to(t.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_sp(t: torch.Tensor, sp: "SPShard | None") -> torch.Tensor:
    """`t` summed over the split (`_SumOverSP`); `t` itself without one."""
    return t if sp is None else _SumOverSP.apply(t, sp.group)


def _gather_seq(x: torch.Tensor, sp: SPShard) -> torch.Tensor:
    """The split's slices of x (dim 1) joined in rank order (a plain
    all_gather: gloo carries it on CUDA tensors too)."""
    parts = [torch.empty_like(x) for _ in range(sp.size)]
    _dist().all_gather(parts, x.contiguous(), group=sp.group)
    return torch.cat(parts, dim=1)


def _scatter_seq(t: torch.Tensor, sp: SPShard) -> torch.Tensor:
    """This rank's slice (dim 1) of the split's sum of t, added in f32 and
    rounded once to t's dtype, as `_sum_over` rounds. Under NCCL a
    reduce-scatter; gloo has none for CUDA tensors, so there an f32
    all-reduce of which the rank keeps its slice (chosen by the group's
    backend)."""
    n = t.shape[1] // sp.size
    if sp.backend == "nccl":
        src = t.to(torch.float32).movedim(1, 0).contiguous()
        out = src.new_empty((n, *src.shape[1:]))
        _dist().reduce_scatter_tensor(out, src, group=sp.group)
        return out.movedim(0, 1).to(t.dtype).contiguous()
    acc = t.to(torch.float32, copy=True).contiguous()
    _dist().all_reduce(acc, group=sp.group)
    return acc[:, sp.rank * n:(sp.rank + 1) * n].to(t.dtype).contiguous()


class _GatherSeq(torch.autograd.Function):
    """The model split's entry to a column linear: the sequence slices
    all-gathered; backward, the ranks' partial input gradients summed and
    scattered back to their slices."""

    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _gather_seq(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(g, ctx.sp), None


class _ScatterSeq(torch.autograd.Function):
    """The model split's exit from a row linear: the ranks' partial sums
    added up, each rank keeping its slice; backward, the slices' gradients
    gathered whole."""

    @staticmethod
    def forward(ctx, y, sp):
        ctx.sp = sp
        return _scatter_seq(y, sp)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.sp), None


def gather_seq(x: torch.Tensor, sp: "SPShard | None") -> torch.Tensor:
    """(B, S/n, ...) -> (B, S, ...) over the split (`_GatherSeq`); x itself
    without one or over one rank."""
    return x if sp is None or sp.size == 1 else _GatherSeq.apply(x, sp)


def scatter_seq(y: torch.Tensor, sp: SPShard) -> torch.Tensor:
    """(B, S, ...) partial sums -> this rank's (B, S/n, ...) slice of their
    sum (`_ScatterSeq`)."""
    return y if sp.size == 1 else _ScatterSeq.apply(y, sp)


# ---------------------------------------------------------------------------
# The pipeline's collectives


def microbatch_spans(b: int, m: int) -> list[tuple[int, int]]:
    """[lo, hi) of each of m microbatches of b rows: b / m rows each, or
    when m does not divide b (a holdout's tail batch) the first b % m one
    row more."""
    if b < m:
        raise ValueError(f"{b} rows cannot form {m} pipeline microbatches "
                         "(--pipeline_microbatches)")
    n, extra = divmod(b, m)
    bounds = [i * n + min(i, extra) for i in range(m + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


@dataclasses.dataclass(frozen=True)
class PipeShard:
    """A rank's stage of the GPipe pipeline (models/lm/pipeline.py): the
    pipe group (the S ranks of one (data, fsdp, model) coordinate, stage
    order), this rank's stage, S, the group's backend (which picks the
    hop's transport) and M, the microbatches each batch's rows cross the
    stages in."""

    group: Any
    rank: int
    size: int
    backend: str
    microbatches: int

    def spans(self, b: int) -> list[tuple[int, int]]:
        return microbatch_spans(b, self.microbatches)

    def peer(self, stage: int) -> int:
        """The global rank of `stage`'s member of this pipe group."""
        return _dist().get_global_rank(self.group, stage)

    def staged(self, t: torch.Tensor) -> bool:
        """Whether `t` travels through a host copy: gloo's point-to-point
        ops read and write host memory only (ring_exchange)."""
        return self.backend == "gloo" and t.device.type != "cpu"


def pipe_shard() -> "PipeShard | None":
    """The registered mesh's pipeline (None: no mesh, or pipe == 1)."""
    from vlrlhf_torch.core.mesh import current_mesh

    mesh = current_mesh()
    return None if mesh is None else mesh.pp


def pipe_send(t: torch.Tensor, pp: PipeShard, stage: int) -> list:
    """Start sending `t` to `stage`; returns what `wait_sends` waits on.
    Under NCCL a `batch_isend_irecv` of the device tensor, under gloo a
    host copy (ring_exchange's rule: gloo's isend of a CUDA tensor aborted
    the sending rank on the card machine)."""
    dist = _dist()
    buf = t.detach().to("cpu") if pp.staged(t) else t.detach().contiguous()
    return [(dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, pp.peer(stage), pp.group)]),
             buf)]


def wait_sends(pending: list) -> None:
    for works, _ in pending:
        for w in works:
            w.wait()
    pending.clear()


def pipe_recv(shape, dtype, device, pp: PipeShard, stage: int) -> torch.Tensor:
    """`stage`'s tensor of `shape` and `dtype` (its `pipe_send`), on
    `device`."""
    dist = _dist()
    host = pp.backend == "gloo" and torch.device(device).type != "cpu"
    buf = torch.empty(shape, dtype=dtype, device="cpu" if host else device)
    for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, buf, pp.peer(stage), pp.group)]):
        w.wait()
    return buf.to(device) if host else buf


def pipe_broadcast(t: torch.Tensor, pp: PipeShard, stage: int) -> torch.Tensor:
    """`stage`'s `t` on every stage (a new tensor; `t`'s shape and dtype
    on every rank). Under gloo a device tensor goes through the host."""
    buf = t.detach().to("cpu") if pp.staged(t) else t.detach().clone().contiguous()
    _dist().broadcast(buf, src=pp.peer(stage), group=pp.group)
    return buf.to(t.device) if pp.staged(t) else buf


def pipe_sum_(tensors: list, pp: PipeShard) -> None:
    """Each tensor summed over the stages, in place (every stage then holds
    the same bits)."""
    for t in tensors:
        _dist().all_reduce(t, group=pp.group)


# ---------------------------------------------------------------------------
# Tensor parallelism's collectives


@dataclasses.dataclass(frozen=True)
class TPShard:
    """A tensor-parallel Linear's place: 'column' (its out rows split) or
    'row' (its in columns split), the group and this rank's index in it, and
    the full widths."""

    mode: str
    group: Any
    rank: int
    size: int
    d_in: int
    d_out: int


def _sum_over(t: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of `t` (a new tensor in t's dtype), added in f32:
    a bf16 sum of bf16 partials would round once more than the
    single-process product does."""
    acc = t.to(torch.float32, copy=True).contiguous()
    _dist().all_reduce(acc, group=group)
    return acc.to(t.dtype)


class _CopyToTP(torch.autograd.Function):
    """The input of a column-parallel product: identity forward; backward,
    the ranks' partial input gradients summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_over(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    """The output of a row-parallel product: the ranks' partial sums added
    up forward; backward, the gradient as it is (every rank holds it
    whole)."""

    @staticmethod
    def forward(ctx, y, group):
        return _sum_over(y, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _F32Product(torch.autograd.Function):
    """x @ m with the products summed and returned in f32: a row-parallel
    rank's partial sum, which the all-reduce adds in f32 and rounds once,
    as the single-process product rounds once (a bf16 partial would round
    twice). On the card a bf16 GEMM with an f32 output; backward in x's
    dtype, as F.linear's: dx = g @ m.T, and dm = x.T @ g when m trains."""

    @staticmethod
    def forward(ctx, x, m):
        x2 = x.reshape(-1, x.shape[-1])
        if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16):
            y = torch.mm(x2, m, out_dtype=torch.float32)
        else:
            y = x2.float() @ m.float()
        ctx.save_for_backward(x if m.requires_grad else None, m)
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return y.reshape(*x.shape[:-1], m.shape[1])

    @staticmethod
    def backward(ctx, g):
        x, m = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(ctx.x_dtype)
        dx = (g2 @ m.to(ctx.x_dtype).t()).reshape(ctx.x_shape)
        dm = None
        if x is not None:
            dm = (x.reshape(-1, x.shape[-1]).t() @ g2).to(m.dtype)
        return dx, dm


def f32_product(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return _F32Product.apply(x, m)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyToTP.apply(x, group)


def reduce_from_tp(y: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFromTP.apply(y, group)


def tp_factor(x: torch.Tensor, a: torch.Tensor, tp) -> torch.Tensor:
    """u = x @ a, the rank-r middle of a factored delta (x a) b, made
    whole under tensor parallelism: a column linear's u is whole on every
    rank and its gradient a partial sum (copy_to_tp); a row linear's u is
    a partial sum, taken in f32 and added up (reduce_from_tp). Then b,
    replicated or split on out, applies to a whole u, so b's gradient is
    whole too. Without tp: x @ a.

    Under the model split a column linear's x is the gathered sequence,
    whose backward sums the ranks' partial input gradients (gather_seq):
    u takes no copy_to_tp, so a's gradient is a partial sum, which the
    optimizer sums over the group as it does every leaf replicated over
    model (train/train_state.py `tp_sum`). A row linear's u is
    reduce-scattered to this rank's slice of the sequence, so its
    replicated b sees the slice and its gradient is partial too."""
    if tp is None:
        return x @ a
    sp = model_split()
    if tp.mode == "column":
        return x @ a if sp is not None else copy_to_tp(x @ a, tp.group)
    part = f32_product(x, a)
    return (reduce_from_tp(part, tp.group) if sp is None else scatter_seq(part, sp)).to(x.dtype)
