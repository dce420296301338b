"""Flash attention forward: the hand-written Hopper kernel
(csrc/flash_fwd.cu) and its plain PyTorch version.

Replaces the Pallas forward `_fwd_kernel` / `flash_attention` in
vlrlhf_tpu/ops/flash_attention.py. Public layout as there: q (B, Sq, H, D),
k/v (B, Skv, Hkv, D) -> O (B, Sq, H, D), plus the f32 LSE (B, H, Sq) on
request (the backward kernels of a later port read it). Padding folds into
segment ids: a padded query row gets segment -3 and a padded key -1, so they
never match anything. Causality is by absolute index (key <= query), which
equals "last query aligned with last key" only for square inputs — the
dispatch (ops/attention.py) sends square shapes alone.

A fully masked query row (a right-pad row) gives output 0 and LSE -inf here,
where vlrlhf_tpu's plain path gives a uniform average; no caller reads those
rows, so comparisons use valid rows only.

Dispatch: a CPU tensor takes `flash_attention_plain`; a CUDA tensor launches
the kernel or raises. There is no fallback.
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
    seg = (
        segment_ids.to(torch.int32)
        if segment_ids is not None
        else torch.zeros((b, s), dtype=torch.int32, device=device)
    )
    if pad_mask is not None:
        seg = torch.where(pad_mask.bool(), seg, torch.full_like(seg, pad_value))
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


def _launch(q, k, v, seg_q, seg_kv, causal, scale):
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
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
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if b * sq * h == 0:
        return o, lse
    lib = _build.load("flash_fwd")
    fn = lib.flash_fwd_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_longlong] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    err = fn(
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
    [and the f32 LSE (B, H, Sq)]."""
    b, sq, _, d = q.shape
    skv = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    seg_q = make_segments(b, sq, q.device, segment_ids_q, pad_mask_q, Q_PAD_SEG)
    seg_kv = make_segments(b, skv, q.device, segment_ids_kv, pad_mask_kv, KV_PAD_SEG)
    if q.is_cuda:
        o, lse = _launch(q, k, v, seg_q, seg_kv, causal, scale)
    elif q.device.type == "cpu":
        o, lse = flash_attention_plain(q, k, v, seg_q, seg_kv, causal, scale)
    else:
        raise ValueError(f"flash_attention: no path for device {q.device}")
    return (o, lse) if return_lse else o


flash_attention.launches = 0  # kernel launches; the plain path never counts
