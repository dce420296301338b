"""Ring attention: attention over a sequence split across the ranks of a
ring (counterpart of vlrlhf_tpu/ops/ring_attention.py).

Each rank holds a contiguous S/n slice of Q, K, V and the pad mask; K and
V (with their KV heads, never repeated to the query heads: kernels 1-3
take GQA, so the exchange carries n_rep times fewer bytes than
vlrlhf_tpu's, which repeats first) go round the ring n - 1 times, and each
rank merges the (O, LSE) partials of its queries over every block. No new
kernel: a block is the flash kernels of ops/flash_attention.py on the
card, or their plain versions on the CPU (the dispatch `flash_attention`
uses: a CPU tensor takes the plain version, a CUDA tensor the kernel).

  - `ring_block_forward`: one (query shard idx, key shard src) block.
    Causal, the diagonal block (src == idx) is kernel 1 causal (the shards
    are equal, so local causality is global causality), a block before it
    kernel 1 non-causal, and a block after it is skipped: it contributes
    exactly zero (vlrlhf_tpu computes it under a mask with the same
    values);
  - `merge`: two (O, LSE) partials joined by log-add-exp in f32; a row
    that is -inf everywhere stays -inf and gives O = 0, as the flash path
    does for a fully masked row;
  - `ring_block_backward`: a block's dQ and dK / dV from the dK/dV and dQ
    kernels (2 and 3), fed the FINAL merged LSE and di = rowsum(dO * O),
    O the merged output (a block's own LSE would give wrong gradients);
  - `RingAttention` / `ring_attention`: the op over a process group
    (core/dist.py `ring_exchange`). Forward, K, V and the key segments
    (the pad mask, folded as the kernels take it) rotate, each exchange
    started before the block it overlaps is computed. Backward, K and V
    rotate again and the f32 dK / dV accumulators travel with their block,
    one more step taking each back to its owner;
  - `ring_attention_local`: the same per-block functions over n shards in
    one process, in the ring's order (the tests' and chip_smoke.py's
    simulated ring).

Causality is position-based with global positions, as in vlrlhf_tpu: query
shard idx, key shard src.
"""

from __future__ import annotations

from typing import Optional

import torch

from vlrlhf_torch.ops.flash_attention import (
    KV_PAD_SEG, Q_PAD_SEG, _launch, flash_attention_bwd_plain, flash_attention_plain,
    flash_bwd_dkv, flash_bwd_dq, make_segments,
)


def ring_block_forward(q, k_blk, v_blk, seg_q, seg_kv, src: int, idx: int, scale: float,
                       causal: bool = True, attend=None):
    """(O (B, Sq, H, D) in q's dtype, LSE (B, H, Sq) f32) of query shard
    `idx` over the K/V block of shard `src`, or None for a block causality
    masks whole (src > idx). `attend`, a function of flash_attention_plain's
    arguments, replaces the device dispatch (a check of the kernels runs
    the plain version on the card with it)."""
    if causal and src > idx:
        return None
    diagonal = causal and src == idx
    if attend is not None:
        return attend(q, k_blk, v_blk, seg_q, seg_kv, diagonal, scale)
    if q.is_cuda:
        return _launch(q, k_blk, v_blk, seg_q, seg_kv, diagonal, scale)
    if q.device.type != "cpu":
        raise ValueError(f"ring_block_forward: no path for device {q.device}")
    return flash_attention_plain(q, k_blk, v_blk, seg_q, seg_kv, diagonal, scale)


def merge(acc, part):
    """Join two (O, LSE) partials: O f32 (B, S, H, D), LSE f32 (B, H, S);
    either may be None (nothing yet, a skipped block)."""
    if part is None:
        return acc
    if acc is None:
        return part[0].float(), part[1]
    (o1, l1), (o2, l2) = acc, part
    lse = torch.logaddexp(l1, l2)
    safe = torch.where(torch.isinf(lse), 0.0, lse)  # a row masked in both stays -inf, O = 0
    w1 = torch.exp(l1 - safe).transpose(1, 2)[..., None]
    w2 = torch.exp(l2 - safe).transpose(1, 2)[..., None]
    return o1 * w1 + o2.float() * w2, lse


def ring_block_backward(q, k_blk, v_blk, do, lse, di, seg_q, seg_kv, src: int, idx: int,
                        scale: float, causal: bool = True, attend_bwd=None):
    """(dQ, dK, dV) of one block, or None for a skipped block: the kernels'
    bf16 on the card, the plain version's f32 on the CPU. `lse` and `di`
    are the merged ones (B, H, Sq) f32; `do` is contiguous in q's dtype.
    `attend_bwd` (flash_attention_bwd_plain's arguments) replaces the
    dispatch as `attend` does in ring_block_forward."""
    if causal and src > idx:
        return None
    diagonal = causal and src == idx
    if attend_bwd is not None:
        return attend_bwd(q, k_blk, v_blk, do, lse, di, seg_q, seg_kv, diagonal, scale)
    if q.is_cuda:
        dk, dv = flash_bwd_dkv(q, k_blk, v_blk, do, lse, di, seg_q, seg_kv, diagonal, scale)
        dq = flash_bwd_dq(q, k_blk, v_blk, do, lse, di, seg_q, seg_kv, diagonal, scale)
        return dq, dk, dv
    if q.device.type != "cpu":
        raise ValueError(f"ring_block_backward: no path for device {q.device}")
    return flash_attention_bwd_plain(q, k_blk, v_blk, do, lse, di, seg_q, seg_kv, diagonal, scale)


def backward_inputs(o, do, q):
    """(dO as the backward kernels take it, di = rowsum(dO * O) (B, H, S)
    f32) from the merged output."""
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    do = do.to(q.dtype).contiguous()
    if do.data_ptr() % 16:  # the backward kernels' TMA maps need a 16-byte aligned base
        do = do.clone()
    return do, di


def _forward(q, k, v, seg_q, seg_kv, sp, causal: bool, scale: float):
    from vlrlhf_torch.core.dist import ring_exchange

    idx, n = sp.rank, sp.size
    blk, acc = (k, v, seg_kv), None
    for i in range(n):
        nxt = ring_exchange(blk, sp) if i < n - 1 else None
        acc = merge(acc, ring_block_forward(q, blk[0], blk[1], seg_q, blk[2], (idx - i) % n, idx,
                                            scale, causal))
        if nxt is not None:
            blk = tuple(nxt.wait())
    o, lse = acc
    return o.to(q.dtype), lse.contiguous()


def _backward(q, k, v, o, lse, do, seg_q, seg_kv, sp, causal: bool, scale: float):
    from vlrlhf_torch.core.dist import ring_exchange

    idx, n = sp.rank, sp.size
    do, di = backward_inputs(o, do, q)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    blk = (k, v, seg_kv)
    for i in range(n):
        part = ring_block_backward(q, blk[0], blk[1], do, lse, di, seg_q, blk[2],
                                   (idx - i) % n, idx, scale, causal)
        if part is not None:
            dq += part[0]
            dk += part[1]
            dv += part[2]
        if n > 1:  # the accumulators move on with their block; after the last, to its owner
            moved = ring_exchange((*blk, dk, dv) if i < n - 1 else (dk, dv), sp).wait()
            if i < n - 1:
                blk = tuple(moved[:3])
            dk, dv = moved[-2:]
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class RingAttention(torch.autograd.Function):
    """The ring with its backward ring (jax.grad of vlrlhf_tpu's shard_map
    ring). Each forward is free of side effects but the exchanges and the
    launch counters, so torch.utils.checkpoint may rerun it; every rank of
    the ring reruns it in the same order."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, sp, causal: bool, scale: float):
        o, lse = _forward(q, k, v, seg_q, seg_kv, sp, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.sp, ctx.causal, ctx.scale = sp, causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, o, lse, do, seg_q, seg_kv, ctx.sp, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def ring_attention(
    q: torch.Tensor,  # (B, S/n, H, D): this rank's query slice
    k: torch.Tensor,  # (B, S/n, Hkv, D)
    v: torch.Tensor,
    pad_mask: Optional[torch.Tensor],  # (B, S/n) of this rank's keys and queries
    sp,  # core.dist.SPShard: the ring
    causal: bool = True,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Sequence-parallel attention over the ring `sp`: O (B, S/n, H, D) of
    this rank's queries over the whole sequence. Padded queries give 0."""
    b, s, _, d = q.shape
    scale = d**-0.5 if scale is None else scale
    seg_q = make_segments(b, s, q.device, None, pad_mask, Q_PAD_SEG)
    seg_kv = make_segments(b, s, q.device, None, pad_mask, KV_PAD_SEG)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return RingAttention.apply(q, k, v, seg_q, seg_kv, sp, causal, scale)
    return _forward(q, k, v, seg_q, seg_kv, sp, causal, scale)[0]


def ring_attention_local(q, k, v, pad_mask, n: int, causal: bool = True,
                         scale: Optional[float] = None, do: Optional[torch.Tensor] = None,
                         attend=None, attend_bwd=None):
    """The ring of `n` ranks in one process, over whole (B, S, ., D) inputs
    cut into n contiguous shards: each query shard merges its blocks in the
    ring's order (src = idx, idx - 1, ...), and with `do` the backward
    takes each block in that order with the merged LSE and di, dK / dV
    summed per key shard in the order its accumulator travels (its owner
    first). Returns O (B, S, H, D) in q's dtype, with `do` also (dQ, dK,
    dV) in the inputs' dtypes. `attend` / `attend_bwd` go to the block
    functions."""
    b, s, _, d = q.shape
    scale = d**-0.5 if scale is None else scale
    if s % n:
        raise ValueError(f"S = {s} does not split into {n} shards")
    c = s // n
    seg_q = make_segments(b, s, q.device, None, pad_mask, Q_PAD_SEG)
    seg_kv = make_segments(b, s, q.device, None, pad_mask, KV_PAD_SEG)

    def sl(t, j):
        return t[:, j * c:(j + 1) * c].contiguous()

    outs = []
    for idx in range(n):
        acc = None
        for i in range(n):
            src = (idx - i) % n
            acc = merge(acc, ring_block_forward(sl(q, idx), sl(k, src), sl(v, src),
                                                sl(seg_q, idx), sl(seg_kv, src), src, idx,
                                                scale, causal, attend))
        outs.append(acc)
    o = torch.cat([a[0] for a in outs], dim=1).to(q.dtype)
    if do is None:
        return o
    lse = [a[1].contiguous() for a in outs]
    grads = [backward_inputs(sl(o, idx), sl(do, idx), q) for idx in range(n)]
    dq = [torch.zeros((b, c, *q.shape[2:]), dtype=torch.float32, device=q.device)
          for _ in range(n)]
    dk = [torch.zeros((b, c, *k.shape[2:]), dtype=torch.float32, device=q.device)
          for _ in range(n)]
    dv = [torch.zeros_like(t) for t in dk]
    for src in range(n):
        for t in range(n):  # the accumulator of block src visits src, src + 1, ...
            idx = (src + t) % n
            part = ring_block_backward(sl(q, idx), sl(k, src), sl(v, src), grads[idx][0],
                                       lse[idx], grads[idx][1], sl(seg_q, idx), sl(seg_kv, src),
                                       src, idx, scale, causal, attend_bwd)
            if part is not None:
                dq[idx] += part[0]
                dk[src] += part[1]
                dv[src] += part[2]
    return o, (torch.cat(dq, 1).to(q.dtype), torch.cat(dk, 1).to(k.dtype),
               torch.cat(dv, 1).to(v.dtype))
