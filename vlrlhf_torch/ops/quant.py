"""Weights-only int8 quantization and the int8 KV cache (counterpart of
vlrlhf_tpu/ops/quant.py: DEFAULT_QUANT_PATTERNS, quantize_linear,
quantize_params, dequantize_linear, quantize_kv).

A quantized `models.common.Linear` holds `weight_q` (out, in) int8 and
`weight_scale` (out,) bf16 in place of `weight`: symmetric per output
channel, y = (x @ weight_q.T) * weight_scale (W8A16). The JAX package
computes that product in plain XLA with no Pallas kernel, so the port's is
a plain matmul too. Paths are the JAX layout's ("lm/layers/3/attn/wq/kernel"
via lora.module_path), so the JAX patterns select the same linears.

The int8 KV cache quantizes per vector over head_dim: codes (..., hd) int8
and one bf16 scale per vector; the decode and chunk kernels fold the
scales into the scores and the softmax weights. int4 (bits=4) belongs to a
later slice and raises.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch
from torch import nn

from vlrlhf_torch.lora.lora import module_path

# The LM decoder stack and lm_head: ~99% of a 7B model's weight bytes. The
# vision tower and projector stay bf16.
DEFAULT_QUANT_PATTERNS = (
    r"(^|/)lm/layers_scanned/(attn|mlp)/",
    r"(^|/)lm/lm_head$",
)


def linear_path(name: str) -> str:
    """The JAX-layout path of a Linear MODULE (what the patterns address):
    "lm.layers.3.wq" -> "lm/layers_scanned/attn/wq", "lm.lm_head" ->
    "lm/lm_head"."""
    parts = module_path(name)[: -len("/kernel")].split("/")
    if len(parts) > 3 and parts[1] == "layers":
        del parts[2]
        parts[1] = "layers_scanned"
    return "/".join(parts)


def quantize_linear(weight: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, in) weight -> (int8 codes (out, in), bf16 scales (out,)):
    f32 amax / 127 per output channel, round half to even, clip to ±127."""
    wf = weight.float()
    amax = wf.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(wf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[:, 0].to(torch.bfloat16)


def dequantize_linear(q: torch.Tensor, scale: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """The inverse: (out, in) codes x per-row scales, in `dtype`."""
    return (q.float() * scale.float()[:, None]).to(dtype)


@torch.no_grad()
def quantize_params(
    model: nn.Module,
    patterns: Sequence[str] = DEFAULT_QUANT_PATTERNS,
    bits: int = 8,
) -> list[str]:
    """Quantize, in place, every Linear whose JAX-layout path matches a
    pattern; returns those paths. One linear at a time: the transient is
    one f32 copy of one weight, never a second model."""
    from vlrlhf_torch.models.common import Linear

    if bits != 8:
        raise NotImplementedError(f"bits={bits}: int4 quantization is not ported yet")
    regs = [re.compile(p) for p in patterns]
    done = []
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.weight is not None:
            path = linear_path(name)
            if any(r.search(path) for r in regs):
                mod.quantize_()
                done.append(path)
    return done


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector int8 KV quantization over the trailing head_dim:
    x (..., hd) -> (codes int8 (..., hd), scales bf16 (...,)). The codes
    divide by the f32 scale; the stored scale is its bf16 rounding."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale[..., 0].to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """codes (..., hd) x scales (...,) -> values in `dtype`."""
    return (q.float() * scale.float()[..., None]).to(dtype)
