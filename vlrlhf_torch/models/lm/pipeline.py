"""GPipe pipeline over the mesh's `pipe` axis (counterpart of
vlrlhf_tpu/models/lm/pipeline.py, `pipeline_decoder`).

Under a mesh with pipe = S > 1 (core/mesh.py) each rank's decoder holds
its stage's L / S layers (core/partitioning.py drops the others), and the
training forward's stack runs here:

  - the batch's rows split into M microbatches (`PipeShard.spans`; M is
    --pipeline_microbatches, or S); with them the per-row inputs: cos /
    sin (stacked for QWen's logn: their row axis is the third from the
    end, and they carry each row's dynamic-NTK alpha), the pad mask, and
    in the Ctx the PLoRA mask and the LoRA dropout rows (`Ctx.row_shard`:
    a microbatch keeps its rows of the whole batch's mask, so a pipelined
    run draws the single-process masks; vlrlhf_tpu draws one stream for
    every microbatch instead);
  - forward, M + S - 1 steps: at step t stage s runs microbatch t - s on
    its layers (`LlamaDecoder.run_layers`, every remat policy, each layer
    folding its global index into the dropout seed) and sends the output
    to stage s + 1; stage 0 reads the embeddings. The last stage's outputs
    make the stack's output, which is broadcast to every stage (vlrlhf_tpu
    psums it from the last stage, pipeline.py:200-206);
  - backward, M + S - 1 steps in reverse: at step t stage s takes
    microbatch M - 1 - (t - (S - 1 - s)), its output's gradient (the last
    stage's share of the whole output's gradient, else stage s + 1's
    hop), backpropagates it through its layers and sends its input's
    gradient to stage s - 1; stage 0's make the embeddings' gradient.

Both ends of every hop follow this one order, written out by hand.
`torch.distributed.pipelining` is not used: its schedules compute a loss
per microbatch on the last stage, and a DPO batch stacks the chosen rows
over the rejected ones, so a microbatch of one row has no pair to score.
As in vlrlhf_tpu only the stack is pipelined; the final norm, the head and
every loss run on the whole batch on every stage, so the loss, the
metrics and the gradients of leaves after the stack (rm's head) are the
same on each stage, while only stage 0 backpropagates into the leaves
before the stack (the embedding, an unfrozen tower's adapters), whose
gradients the optimizer sums over the stages (train/train_state.py).

`pipeline` is an autograd Function on each rank: its forward builds each
microbatch's graph of the stage's layers, its backward runs the backward
schedule through them. Under FSDP2 the layer units gather and free their
weights per microbatch, forward and backward, and their reduce-scatters
add the microbatches' gradients up. Without autograd (the reference pass,
the holdout) the forward schedule runs alone. `pipeline_local` runs all S
stages in one process through the same schedule (the CPU tests' and the
card's plain check). The bubble is (S - 1) / (M + S - 1) of the steps.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, Optional

import torch

from vlrlhf_torch.core.dist import (
    PipeShard, microbatch_spans, pipe_broadcast, pipe_recv, pipe_send, wait_sends,
)
from vlrlhf_torch.models.common import Ctx


def stage_span(num_layers: int, stages: int, stage: int) -> tuple[int, int]:
    """[lo, hi): the global layers stage `stage` of `stages` holds."""
    if num_layers % stages:
        raise ValueError(f"--mesh_pipe {stages}: the LM's {num_layers} layers do not split "
                         "into equal stages")
    n = num_layers // stages
    return stage * n, (stage + 1) * n


def _table_rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows [lo, hi) of a rope table (B, S, hd), or of stacked (queries',
    keys') tables (2, B, S, hd)."""
    return t.narrow(t.dim() - 3, lo, hi - lo)


class _Wire:
    """The hops of one rank: core/dist.py's point-to-point ops over the
    pipe group."""

    def __init__(self, pp: PipeShard):
        self.pp, self.pending = pp, []

    def send(self, t: torch.Tensor, src: int, dst: int) -> None:
        self.pending += pipe_send(t, self.pp, dst)

    def recv(self, shape, dtype, device, at: int, src: int) -> torch.Tensor:
        return pipe_recv(shape, dtype, device, self.pp, src)

    def flush(self) -> None:
        wait_sends(self.pending)


class _LocalWire:
    """The hops of every stage in one process: a queue per link."""

    def __init__(self):
        self.queues: dict = {}

    def send(self, t: torch.Tensor, src: int, dst: int) -> None:
        self.queues.setdefault((src, dst), []).append(t.detach().clone())

    def recv(self, shape, dtype, device, at: int, src: int) -> torch.Tensor:
        t = self.queues[(src, at)].pop(0)
        if tuple(t.shape) != tuple(shape) or t.dtype != dtype:
            raise RuntimeError(f"hop {src} -> {at}: got {tuple(t.shape)} {t.dtype}, want "
                               f"{tuple(shape)} {dtype}")
        return t

    def flush(self) -> None:
        pass


class _Stage:
    """One stage's part of the schedule: its layers (`run`), the
    microbatches' inputs it keeps for the backward, its outputs."""

    def __init__(self, stage: int, stages: int, run: Callable, inputs: tuple, spans: list,
                 wire, keep: bool):
        self.stage, self.stages, self.run, self.spans, self.wire = stage, stages, run, spans, wire
        self.x, self.cos, self.sin, self.pad, self.ctx = inputs
        self.keep = keep
        m = len(spans)
        self.ins: list = [None] * m
        self.outs: list = [None] * m
        self.results: list = [None] * m
        self.dx: list = [None] * m

    def forward_step(self, t: int) -> None:
        """Step t of the forward: microbatch t - stage, if there is one."""
        i, s = t - self.stage, self.stage
        if not 0 <= i < len(self.spans):
            return
        lo, hi = self.spans[i]
        x, b = self.x, self.x.shape[0]
        if s == 0:
            h = x[lo:hi]
        else:
            h = self.wire.recv((hi - lo, *x.shape[1:]), x.dtype, x.device, s, s - 1)
        if self.keep:
            h = h.detach().requires_grad_(True)
            self.ins[i] = h
        pad = None if self.pad is None else self.pad[lo:hi]
        with torch.enable_grad() if self.keep else contextlib.nullcontext():
            out = self.run(h, _table_rows(self.cos, lo, hi), _table_rows(self.sin, lo, hi), pad,
                           self.ctx.row_shard(lo, hi, b))
        if self.keep:
            self.outs[i] = out
        if s < self.stages - 1:
            self.wire.send(out.detach(), s, s + 1)
        else:
            self.results[i] = out.detach()

    def backward_step(self, t: int, grad: torch.Tensor) -> None:
        """Step t of the backward: microbatch M - 1 - (t - (S - 1 - stage)),
        if there is one; `grad` is the whole output's gradient."""
        s, m = self.stage, len(self.spans)
        i = m - 1 - (t - (self.stages - 1 - s))
        if not 0 <= i < m:
            return
        lo, hi = self.spans[i]
        out, h = self.outs[i], self.ins[i]
        if s == self.stages - 1:
            g = grad[lo:hi]
        else:
            g = self.wire.recv(tuple(out.shape), out.dtype, out.device, s, s + 1)
        torch.autograd.backward(out, g)
        self.outs[i] = self.ins[i] = None
        dh = h.grad if h.grad is not None else torch.zeros_like(h)
        if s > 0:
            self.wire.send(dh, s, s - 1)
        else:
            self.dx[i] = dh


class _Plan:
    """A call's stages (one on a rank, all S in one process), the steps'
    count and how the last stage's output reaches every stage."""

    def __init__(self, stages: list, n_stages: int, whole: Callable):
        self.stages, self.n_stages, self.whole = stages, n_stages, whole
        self.steps = len(stages[0].spans) + n_stages - 1

    def forward(self) -> torch.Tensor:
        for t in range(self.steps):
            for st in self.stages:
                st.forward_step(t)
        for st in self.stages:
            st.wire.flush()
        return self.whole(self.stages)

    def backward(self, grad: torch.Tensor) -> Optional[torch.Tensor]:
        for t in range(self.steps):
            for st in self.stages:
                st.backward_step(t, grad)
        for st in self.stages:
            st.wire.flush()
        first = self.stages[0]
        return torch.cat(first.dx) if first.stage == 0 else None


class _Pipeline(torch.autograd.Function):
    """The schedule as one differentiable op: forward(anchor, x) -> the
    stack's output, whole; backward -> x's gradient (stage 0's; None on
    the others). `anchor`, a 0-dim tensor requiring grad, makes the output
    require grad when x does not (a frozen tower's embeddings), so the
    layers' adapters still get theirs."""

    @staticmethod
    def forward(ctx, anchor, x, plan: _Plan):
        ctx.plan = plan
        return plan.forward()

    @staticmethod
    def backward(ctx, grad):
        plan, ctx.plan = ctx.plan, None
        dx = plan.backward(grad.contiguous())
        return None, dx if ctx.needs_input_grad[1] else None, None


def _run(plan: _Plan, x: torch.Tensor) -> torch.Tensor:
    if not torch.is_grad_enabled():
        return plan.forward()
    anchor = torch.zeros((), device=x.device, requires_grad=True)
    return _Pipeline.apply(anchor, x, plan)


def pipeline(run_layers: Callable, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
             pad_mask: Optional[torch.Tensor], ctx: Ctx, pp: PipeShard) -> torch.Tensor:
    """The stack on this rank's stage: `run_layers(h, cos, sin, pad_mask,
    ctx)` runs the stage's layers on one microbatch (the decoder's
    `run_layers`), `x` (B, S, H) is the whole batch's embeddings (read on
    stage 0), `ctx` the layers' context (ctx.sub("layers_scanned")).
    Returns the stack's output (B, S, H), the same on every stage."""
    wire = _Wire(pp)
    keep = torch.is_grad_enabled()
    stage = _Stage(pp.rank, pp.size, run_layers, (x, cos, sin, pad_mask, ctx),
                   pp.spans(x.shape[0]), wire, keep)
    last = pp.size - 1

    def whole(stages):
        out = torch.cat(stages[0].results) if pp.rank == last else torch.empty_like(x)
        return pipe_broadcast(out, pp, last)

    return _run(_Plan([stage], pp.size, whole), x)


def pipeline_local(decoder, stages: int, microbatches: int, x: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, pad_mask: Optional[torch.Tensor],
                   ctx: Ctx) -> torch.Tensor:
    """`pipeline` with all `stages` stages in this process: `decoder` (a
    LlamaDecoder holding every layer) gives stage s its layers
    [stage_span), the hops are in-process queues, and the forward and
    backward steps run in the schedule's order, stage by stage within a
    step. `microbatches` 0 means one per stage. Returns the stack's output
    (B, S, H), before the final norm."""
    n_layers = decoder.cfg.num_layers
    if len(decoder.layers) != n_layers:
        raise ValueError("pipeline_local needs a decoder that holds every layer")
    spans = microbatch_spans(x.shape[0], microbatches or stages)
    wire = _LocalWire()
    keep = torch.is_grad_enabled()
    parts = [_Stage(s, stages, functools.partial(decoder.run_layers,
                                                 span=stage_span(n_layers, stages, s)),
                    (x, cos, sin, pad_mask, ctx), spans, wire, keep) for s in range(stages)]
    return _run(_Plan(parts, stages, lambda sts: torch.cat(sts[-1].results)), x)
