"""Flash attention: the hand-written Hopper kernels (csrc/flash_fwd.cu,
csrc/flash_bwd.cu) and their plain PyTorch versions.

Replaces the Pallas forward `_fwd_kernel` and the backward pair
`_bwd_dkv_kernel` / `_bwd_dq_kernel` of vlrlhf_tpu/ops/flash_attention.py,
wired as there through a custom gradient (`FlashAttention`, a
torch.autograd.Function, in place of jax.custom_vjp). Public layout as
there: q (B, Sq, H, D), k/v (B, Skv, Hkv, D) -> O (B, Sq, H, D), plus the
f32 LSE (B, H, Sq) on request. Padding folds into
segment ids: a padded query row gets segment -3 and a padded key -1, so they
never match anything. Causality is by absolute index (key <= query), which
equals "last query aligned with last key" only for square inputs — the
dispatch (ops/attention.py) sends square shapes alone.

A fully masked query row (a right-pad row) gives output 0 and LSE -inf here,
where vlrlhf_tpu's plain path gives a uniform average; no caller reads those
rows, so comparisons use valid rows only.

Dispatch: a CPU tensor takes `flash_attention_plain` /
`flash_attention_bwd_plain`; a CUDA tensor launches the kernels or raises.
There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vlrlhf_torch.ops import _build

Q_PAD_SEG = -3  # sentinel segment for padded query rows
KV_PAD_SEG = -1  # sentinel segment for padded kv rows (never equal to q pad)


def make_segments(
    b: int,
    s: int,
    device,
    segment_ids: Optional[torch.Tensor],
    pad_mask: Optional[torch.Tensor],
    pad_value: int,
) -> torch.Tensor:
    if segment_ids is None:
        if pad_mask is None:
            return torch.zeros((b, s), dtype=torch.int32, device=device)
        # valid -> 0, pad -> pad_value: two in-place passes over a fresh copy
        return pad_mask.to(torch.int32, copy=True).sub_(1).mul_(-pad_value).contiguous()
    seg = segment_ids.to(torch.int32)
    if pad_mask is not None:
        seg = torch.where(pad_mask.bool(), seg, pad_value).to(torch.int32)
    return seg.contiguous()


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    seg_q: torch.Tensor,  # (B, Sq) int32, pads already folded in
    seg_kv: torch.Tensor,  # (B, Skv) int32
    causal: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch, f32: (O, LSE)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().transpose(1, 2)  # (B, H, Sq, D)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale  # (B, H, Sq, Skv)
    mask = seg_q[:, :, None] == seg_kv[:, None, :]  # (B, Sq, Skv)
    if causal:
        qpos = torch.arange(sq, device=q.device)[:, None]
        kpos = torch.arange(skv, device=q.device)[None, :]
        mask = mask & (kpos <= qpos)
    s = s.masked_fill(~mask[:, None], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)  # -inf on fully masked rows
    p = torch.exp(s - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
    o = torch.matmul(p, vf)  # fully masked rows: p == 0 -> o == 0
    return o.transpose(1, 2).to(q.dtype), lse


# the C prototypes of flash_fwd_bf16 and the two backward entry points
_FWD_ARGS = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_BWD_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def _check_inputs(q, k, v):
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"flash kernel takes bf16, got {name} {t.dtype}")
        if t.stride(3) != 1 or any(st % 8 for st in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError(
                f"flash kernel needs {name} with unit last stride, strides "
                f"divisible by 8 and a 16-byte aligned base; got {t.stride()}"
            )
    if d % 8 or not 0 < d <= 256:
        raise ValueError(f"flash kernel takes head_dim a multiple of 8 up to 256, got {d}")
    if h % hkv:
        raise ValueError(f"num_heads {h} is not a multiple of num_kv_heads {hkv}")
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shapes {tuple(k.shape)} {tuple(v.shape)} do not fit q {tuple(q.shape)}")


def _launch(q, k, v, seg_q, seg_kv, causal, scale):
    _check_inputs(q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * sq * h == 0:
        return o, lse
    err = _build.fn("flash_fwd", "flash_fwd_bf16", _FWD_ARGS)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(),
        seg_kv.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, h, hkv, sq, skv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "flash_fwd_bf16")
    flash_attention.launches += 1
    return o, lse


def flash_attention_bwd_plain(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    do: torch.Tensor,  # (B, Sq, H, D)
    lse: torch.Tensor,  # (B, H, Sq) f32, -inf on fully masked rows
    di: torch.Tensor,  # (B, H, Sq) f32, rowsum(O * dO)
    seg_q: torch.Tensor,
    seg_kv: torch.Tensor,
    causal: bool,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward kernels' arithmetic in plain PyTorch, f32: recompute
    p = exp(s - lse) under the mask (0 where masked, before any product),
    ds = p (dp - di) scale; returns f32 (dQ, dK, dV) in the input layouts,
    dK/dV summed over each KV head's group of query heads."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    qf = q.float().transpose(1, 2)  # (B, H, Sq, D)
    kf = k.float().transpose(1, 2).repeat_interleave(g, dim=1)
    vf = v.float().transpose(1, 2).repeat_interleave(g, dim=1)
    dof = do.float().transpose(1, 2)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    mask = seg_q[:, :, None] == seg_kv[:, None, :]
    if causal:
        mask = mask & (
            torch.arange(skv, device=q.device)[None, :]
            <= torch.arange(sq, device=q.device)[:, None]
        )
    mask = mask[:, None] & ~torch.isinf(lse)[..., None]
    lse_safe = torch.where(torch.isinf(lse), 0.0, lse.float())
    p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
    dv = torch.matmul(p.transpose(-1, -2), dof)  # (B, H, Skv, D)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - di.float()[..., None]) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)

    def group_sum(x):  # (B, H, Skv, D) -> (B, Skv, Hkv, D)
        return x.reshape(b, hkv, g, skv, d).sum(2).transpose(1, 2)

    return dq.transpose(1, 2), group_sum(dk), group_sum(dv)


def _bwd_args(q, k, v, do, lse, di, seg_q, seg_kv, dq, dk, dv, causal, scale) -> tuple:
    """The argument tuple of the backward entry points (`_BWD_ARGS`); an
    output that is None (the other kernel's) passes a null pointer."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    return (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        di.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
        *(None if t is None else t.data_ptr() for t in (dq, dk, dv)),
        b, h, hkv, sq, skv, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        scale, int(causal), torch.cuda.current_stream(q.device).cuda_stream,
    )


def _bwd_launch(name, q, k, v, do, lse, di, seg_q, seg_kv, dq, dk, dv, causal, scale):
    err = _build.fn("flash_bwd", name, _BWD_ARGS)(
        *_bwd_args(q, k, v, do, lse, di, seg_q, seg_kv, dq, dk, dv, causal, scale))
    _build.check(err, name)


def _check_bwd(q, k, do, lse, di, seg_q, seg_kv):
    if do.dtype != torch.bfloat16 or not do.is_contiguous() or do.shape != q.shape:
        raise ValueError(f"dO must be a contiguous bf16 tensor of q's shape, got "
                         f"{do.dtype} {tuple(do.shape)} contiguous={do.is_contiguous()}")
    want = (q.shape[0], q.shape[2], q.shape[1])
    for name, t in (("lse", lse), ("di", di)):
        if t.dtype != torch.float32 or not t.is_contiguous() or tuple(t.shape) != want:
            raise ValueError(f"{name} must be contiguous f32 {want}, got {t.dtype} {tuple(t.shape)}")
    for name, t, s in (("seg_q", seg_q, q.shape[1]), ("seg_kv", seg_kv, k.shape[1])):
        if t.dtype != torch.int32 or not t.is_contiguous() or tuple(t.shape) != (q.shape[0], s):
            raise ValueError(f"{name} must be contiguous int32 {(q.shape[0], s)}, got "
                             f"{t.dtype} {tuple(t.shape)}")


def flash_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale):
    """dK, dV (B, Skv, Hkv, D) bf16 from the dK/dV kernel (CUDA tensors only)."""
    _check_inputs(q, k, v)
    _check_bwd(q, k, do, lse, di, seg_q, seg_kv)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel():
        _bwd_launch("flash_bwd_dkv_bf16", q, k, v, do, lse, di, seg_q, seg_kv,
                    None, dk, dv, causal, scale)
        flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale):
    """dQ (B, Sq, H, D) bf16 from the dQ kernel (CUDA tensors only)."""
    _check_inputs(q, k, v)
    _check_bwd(q, k, do, lse, di, seg_q, seg_kv)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel():
        _bwd_launch("flash_bwd_dq_bf16", q, k, v, do, lse, di, seg_q, seg_kv,
                    dq, None, None, causal, scale)
        flash_bwd_dq.launches += 1
    return dq


flash_bwd_dkv.launches = 0  # kernel launches; the plain path never counts
flash_bwd_dq.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, seg_q, seg_kv, causal, scale):
    """(dQ, dK, dV) in the input dtype: di = rowsum(O * dO) in f32 (XLA's
    part on the TPU), then the dK/dV and dQ kernels on the card or the plain
    version on the CPU."""
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()  # (B, H, Sq)
    if q.is_cuda:
        do = do.to(q.dtype).contiguous()  # autograd may hand over any strides
        if do.data_ptr() % 16:  # the backward kernels' TMA maps need a 16-byte aligned base
            do = do.clone()
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        return dq, dk, dv
    if q.device.type != "cpu":
        raise ValueError(f"flash_attention_bwd: no path for device {q.device}")
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention with its backward kernels (jax.custom_vjp's
    counterpart). forward -> (O, LSE); the LSE is not differentiable.
    Each forward and backward launch is free of side effects apart from the
    launch counters, so torch.utils.checkpoint may rerun the forward."""

    @staticmethod
    def forward(ctx, q, k, v, seg_q, seg_kv, causal: bool, scale: float):
        if q.is_cuda:
            o, lse = _launch(q, k, v, seg_q, seg_kv, causal, scale)
        elif q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, seg_q, seg_kv, causal, scale)
        else:
            raise ValueError(f"flash_attention: no path for device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse, seg_q, seg_kv)
        ctx.causal, ctx.scale = causal, scale
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse, seg_q, seg_kv = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, seg_q, seg_kv,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    pad_mask_q: Optional[torch.Tensor] = None,  # (B, Sq) bool/int
    pad_mask_kv: Optional[torch.Tensor] = None,
    segment_ids_q: Optional[torch.Tensor] = None,  # (B, Sq) int
    segment_ids_kv: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Flash attention over (B, S, H, D) inputs; returns O (B, Sq, H, D)
    [and the f32 LSE (B, H, Sq)]. When autograd records (grad enabled and
    q, k or v requires grad) the call goes through `FlashAttention`, so the
    backward runs the backward kernels; otherwise (serving, no_grad) it is
    the forward alone."""
    b, sq, _, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    seg_q = make_segments(b, sq, q.device, segment_ids_q, pad_mask_q, Q_PAD_SEG)
    seg_kv = make_segments(b, skv, q.device, segment_ids_kv, pad_mask_kv, KV_PAD_SEG)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        o, lse = FlashAttention.apply(q, k, v, seg_q, seg_kv, causal, scale)
    elif q.is_cuda:
        o, lse = _launch(q, k, v, seg_q, seg_kv, causal, scale)
    elif q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, seg_q, seg_kv, causal, scale)
    else:
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return (o, lse) if return_lse else o


flash_attention.launches = 0  # kernel launches; the plain path never counts
