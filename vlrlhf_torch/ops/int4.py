"""Weights-only int4 (W4A16): group-wise quantization, split-half nibble
packing, and the dequantizing matmuls — the hand-written Hopper kernels
(csrc/int4_matmul.cu) and their plain PyTorch versions.

Counterpart of vlrlhf_tpu/ops/int4.py. Kernel 6 (`int4_matmul`) replaces
the Pallas `_int4_matmul_kernel`: y = x @ dequant(W), the forward of every
int4 linear in serving and in QLoRA training. Kernel 7 (`int4_matmul_t`)
replaces `_int4_matmul_t_kernel`: dx = dy @ dequant(W)^T, the activation
gradient through a frozen int4 base. The bf16 weight never exists in device
memory on the card: the kernels dequantize in registers or shared memory.

Representation, in the port's (out, in) convention (the transposes of the
JAX package's (in, out) leaves; the bridge copies the same bytes):
  packed (out, half_p) int8, half_p = ceil(in/2 / 128) * 128: byte (o, i)
      holds code W[o, i] in its low nibble and W[o, i + in/2] in its high
      nibble; bytes i >= in/2 are zero padding.
  scale  (out, S) bf16: symmetric per-(out channel, 64-row group) scales,
      in-column i takes scale column i // 64; S = 2 n_lo + (n_lo odd),
      n_lo = in / 128 (one zero guard column when n_lo is odd), so
      in = 64 * (S - S % 2).
  gbias  (out, in/64), optional: the zero-point term of an asymmetric GPTQ
      checkpoint (utils/gptq.py), y += group-summed x @ gbias^T, a plain
      product outside the kernel (`int4_apply`).
Codes are in [-8, 7]; W[o, i] = bf16(code * scale[o, i // 64]).

Numbers: like the JAX path, x (or dy) is rounded to bf16 and the weight is
bf16(q * s) even for an f32 model; products accumulate in f32 and the
output takes x's dtype (the gradient dy's, after a bf16 rounding, as the
JAX custom VJP does). The plain versions repeat exactly that, so f32 CPU
parity with the Pallas kernels in interpret mode holds at 1e-5.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel or raises. There is no fallback and no multi-device dense path.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from vlrlhf_torch.ops import _build

GROUP = 64  # quantization group along `in`
BLOCK = 128  # packing unit: in % 128 == 0, packed rows pad to a multiple of 128


def half_padded(half: int) -> int:
    return -(-half // BLOCK) * BLOCK


def din_from_scale_cols(s_cols: int) -> int:
    """The linear's true input width from the scale column count."""
    return GROUP * (s_cols - s_cols % 2)


def scale_cols(d_in: int) -> int:
    n_lo = d_in // BLOCK
    return 2 * n_lo + n_lo % 2


# ---------------------------------------------------------------------------
# Quantize / pack / dequantize


@torch.no_grad()
def quantize_int4(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) float weight -> (packed (out, half_p) int8, scale (out, S)
    bf16) on the weight's device: f32 group amax / 7, round half to even,
    clip to [-8, 7] (vlrlhf_tpu's quantize_kernel_int4, transposed).
    Requires in % 128 == 0."""
    d_out, d_in = weight.shape
    if d_in % (2 * GROUP):
        raise ValueError(f"in={d_in} not divisible by {2 * GROUP}")
    # a private copy, divided in place below
    wf = weight.to(torch.float32, copy=True).reshape(d_out, d_in // GROUP, GROUP)
    amax = wf.abs().amax(dim=2, keepdim=True)
    # a tensor divisor, as in ops/quant.py quantize_linear: host and card agree
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 7.0), torch.ones_like(amax))
    # codes as bytes: -8..7 -> two's complement, whose low nibble is the code's
    q = wf.div_(scale).round_().clamp_(-8, 7).to(torch.int8).reshape(d_out, d_in)
    del wf
    q = q.view(torch.uint8)
    half = d_in // 2
    v = (q[:, :half] & 0x0F) | (q[:, half:] << 4)  # uint8: the shift drops the high nibble
    packed = torch.zeros((d_out, half_padded(half)), dtype=torch.int8, device=weight.device)
    packed[:, :half] = v.view(torch.int8)
    scale2d = torch.zeros((d_out, scale_cols(d_in)), dtype=torch.bfloat16, device=weight.device)
    scale2d[:, : d_in // GROUP] = scale[:, :, 0].to(torch.bfloat16)
    return packed, scale2d


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(out, half_p) packed -> (out, 2 half_p) int8 codes in [-8, 7]: the low
    nibbles then the high ones (padding bytes decode to 0). Sign extension
    goes through int32 shifts, as `_unpack_block` does."""
    p32 = packed.to(torch.int32)
    lo = (p32 << 28) >> 28
    hi = (p32 << 24) >> 28
    return torch.cat([lo, hi], dim=1).to(torch.int8)


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Dense (out, in) weight in `dtype`: f32 code x scale, one rounding."""
    d_in = din_from_scale_cols(scale.shape[1])
    half, half_p = d_in // 2, packed.shape[1]
    codes = unpack_int4(packed)
    q = torch.cat([codes[:, :half], codes[:, half_p:half_p + half]], dim=1).float()
    s = scale.float().repeat_interleave(GROUP, dim=1)[:, :d_in]
    return (q * s).to(dtype)


# ---------------------------------------------------------------------------
# Plain versions (the kernels' arithmetic)


def int4_matmul_plain(x2d: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y (T, out) = bf16(x) @ bf16 dequant(W)^T in f32, in x's dtype."""
    w = dequantize_int4(packed, scale, torch.bfloat16).float()
    return (x2d.to(torch.bfloat16).float() @ w.T).to(x2d.dtype)


def int4_matmul_t_plain(dy2d: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dx (T, in) = bf16(dy) @ bf16 dequant(W) in f32, in dy's dtype."""
    w = dequantize_int4(packed, scale, torch.bfloat16).float()
    return (dy2d.to(torch.bfloat16).float() @ w).to(dy2d.dtype)


# ---------------------------------------------------------------------------
# Kernels


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned start (the kernels' vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_weight(packed: torch.Tensor, scale: torch.Tensor, device) -> tuple[int, int, int]:
    if packed.dtype != torch.int8 or scale.dtype != torch.bfloat16:
        raise ValueError(f"int4 weight must be int8 codes and bf16 scales, got "
                         f"{packed.dtype} / {scale.dtype}")
    if packed.device != device or scale.device != device:
        raise ValueError(f"int4 weight on {packed.device} / {scale.device}, operand on {device}")
    d_out, half_p = packed.shape
    d_in = din_from_scale_cols(scale.shape[1])
    if scale.shape[0] != d_out or d_in % BLOCK or half_p != half_padded(d_in // 2):
        raise ValueError(f"packed {tuple(packed.shape)} / scale {tuple(scale.shape)} "
                         "is not an int4 weight")
    return d_in, d_out, half_p


_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]  # both C prototypes


def _launch(name: str, a2d, packed, scale, d_c: int, d_in: int, d_out: int, half_p: int):
    t = a2d.shape[0]
    c = torch.empty((t, d_c), dtype=torch.bfloat16, device=a2d.device)
    if t == 0:
        return c
    a2d, packed, scale = _aligned(a2d.to(torch.bfloat16)), _aligned(packed), _aligned(scale)
    err = _build.fn("int4_matmul", name, _ARGS)(a2d.data_ptr(), packed.data_ptr(), scale.data_ptr(), c.data_ptr(),
             t, d_in, d_out, half_p, scale.shape[1],
             torch.cuda.current_stream(a2d.device).cuda_stream)
    _build.check(err, name)
    return c


def int4_matmul(x2d: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """y (T, out) = x (T, in) @ dequant(packed, scale)^T, in x's dtype,
    without materializing the weight on the card."""
    if x2d.is_cuda:
        d_in, d_out, half_p = _check_weight(packed, scale, x2d.device)
        if x2d.dim() != 2 or x2d.shape[1] != d_in:
            raise ValueError(f"x {tuple(x2d.shape)} vs int4 in-width {d_in}")
        y = _launch("int4_matmul", x2d, packed, scale, d_out, d_in, d_out, half_p)
        int4_matmul.launches += 1
        return y.to(x2d.dtype)
    if x2d.device.type != "cpu":
        raise ValueError(f"int4_matmul: no path for device {x2d.device}")
    return int4_matmul_plain(x2d, packed, scale)


def int4_matmul_t(dy2d: torch.Tensor, packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """dx (T, in) = dy (T, out) @ dequant(packed, scale), in dy's dtype."""
    if dy2d.is_cuda:
        d_in, d_out, half_p = _check_weight(packed, scale, dy2d.device)
        if dy2d.dim() != 2 or dy2d.shape[1] != d_out or d_out % 8:
            raise ValueError(f"dy {tuple(dy2d.shape)} vs int4 out-width {d_out} "
                             "(the kernel takes out % 8 == 0)")
        dx = _launch("int4_matmul_t", dy2d, packed, scale, d_in, d_in, d_out, half_p)
        int4_matmul_t.launches += 1
        return dx.to(dy2d.dtype)
    if dy2d.device.type != "cpu":
        raise ValueError(f"int4_matmul_t: no path for device {dy2d.device}")
    return int4_matmul_t_plain(dy2d, packed, scale)


int4_matmul.launches = 0  # kernel launches; the plain path never counts
int4_matmul_t.launches = 0


class Int4Matmul(torch.autograd.Function):
    """x2d @ dequant(W)^T, differentiable in x only (QLoRA over a frozen int4
    base). Saves the packed weight and the scales, no activation; re-runs
    cleanly under torch.utils.checkpoint's recompute."""

    @staticmethod
    def forward(ctx, x2d, packed, scale):
        ctx.save_for_backward(packed, scale)
        return int4_matmul(x2d, packed, scale)

    @staticmethod
    def backward(ctx, g):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        packed, scale = ctx.saved_tensors
        # the JAX custom VJP: dy rounded to bf16, dx in bf16, then dy's dtype
        dx = int4_matmul_t(g.to(torch.bfloat16).contiguous(), packed, scale)
        return dx.to(g.dtype), None, None


def int4_apply(
    x: torch.Tensor,  # (..., in)
    packed: torch.Tensor,
    scale: torch.Tensor,
    gbias: Optional[torch.Tensor] = None,  # (out, in/64)
) -> torch.Tensor:
    """A quantized Linear's int4 product (..., in) -> (..., out), in x's
    dtype. The asymmetric `gbias` term is an f32 (T, in/64) @ (in/64, out)
    product outside the kernel, differentiated by autograd
    (vlrlhf_tpu/ops/int4.py:475-480)."""
    lead = x.shape[:-1]
    x2d = x.reshape(-1, x.shape[-1])
    if torch.is_grad_enabled() and x2d.requires_grad:
        y2d = Int4Matmul.apply(x2d, packed, scale)
    else:
        y2d = int4_matmul(x2d, packed, scale)
    if gbias is not None:
        xg = x2d.float().reshape(x2d.shape[0], gbias.shape[1], GROUP).sum(dim=-1)
        y2d = y2d + (xg @ gbias.float().T).to(y2d.dtype)
    return y2d.reshape(*lead, y2d.shape[-1]).to(x.dtype)
