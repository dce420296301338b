"""Weights-only quantization and the int8 KV cache (counterpart of
vlrlhf_tpu/ops/quant.py: DEFAULT_QUANT_PATTERNS, SERVE_QUANT_PATTERNS_WIDE,
TRAIN_QUANT_PATTERNS[_WIDE],
quantize_linear, quantize_params, dequantize_linear, dequantize_params,
quantize_kv).

An int8 `models.common.Linear` holds `weight_q` (out, in) int8 and
`weight_scale` (out,) bf16 in place of `weight`: symmetric per output
channel, y = (x @ weight_q.T) * weight_scale (W8A16). The JAX package
computes that product in plain XLA with no Pallas kernel, so the port's is
a plain matmul too. An int4 Linear (bits=4) holds group-64 packed codes and
scales (ops/int4.py) and runs the W4A16 kernel on the card; a linear whose
`in` is not a multiple of 128 falls back to int8, as in vlrlhf_tpu. Paths
are the JAX layout's ("lm/layers/3/attn/wq/kernel" via lora.module_path),
so the JAX patterns select the same linears.

The int8 KV cache quantizes per vector over head_dim: codes (..., hd) int8
and one bf16 scale per vector; the decode and chunk kernels fold the
scales into the scores and the softmax weights.
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

# serving beside a co-resident judge also quantizes the tower and projector
SERVE_QUANT_PATTERNS_WIDE = DEFAULT_QUANT_PATTERNS + (
    r"(^|/)vision/layers_scanned/(attn|mlp)/",
    r"(^|/)projector/",
)

# QLoRA training keeps lm_head bf16 (DPO logps are logit-precision
# sensitive); the wide set also quantizes the frozen tower and projector.
TRAIN_QUANT_PATTERNS = (r"(^|/)lm/layers_scanned/(attn|mlp)/",)
TRAIN_QUANT_PATTERNS_WIDE = TRAIN_QUANT_PATTERNS + (
    r"(^|/)vision/layers_scanned/(attn|mlp)/",
    r"(^|/)projector/",
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
    wf = weight.to(torch.float32, copy=True)  # a private copy: divided in place below
    amax = wf.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: CUDA multiplies by the reciprocal of a Python-scalar
    # one, a rounding off the host's division, and the importer quantizes
    # on the host what a quantize after the load does on the card
    scale = torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))
    q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
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
    pattern; returns those paths. bits=4 takes int4 where in % 128 == 0 and
    int8 elsewhere (vlrlhf_tpu/ops/quant.py:158-164). One linear at a time:
    the transient is one f32 copy of one weight, never a second model."""
    from vlrlhf_torch.models.common import Linear
    from vlrlhf_torch.ops.int4 import BLOCK

    if bits not in (8, 4):
        raise ValueError(f"bits={bits}: expected 8 or 4")
    regs = [re.compile(p) for p in patterns]
    done = []
    for name, mod in model.named_modules():
        if isinstance(mod, Linear) and mod.weight is not None:
            path = linear_path(name)
            if any(r.search(path) for r in regs):
                mod.quantize_(bits=4 if bits == 4 and mod.d_in % BLOCK == 0 else 8)
                done.append(path)
    return done


@torch.no_grad()
def dense_weight(mod: nn.Module, dtype=torch.bfloat16) -> torch.Tensor:
    """A quantized Linear's weight made dense: its int8 or int4 codes times
    their scales (plus an int4 group bias), in f32 and then cast to
    `dtype`."""
    from vlrlhf_torch.ops.int4 import GROUP, dequantize_int4

    if mod.weight_q4 is not None:
        w = dequantize_int4(mod.weight_q4, mod.weight_scale4, torch.float32)
        if mod.weight_gbias is not None:
            w = w + mod.weight_gbias.float().repeat_interleave(GROUP, dim=1)
    else:
        w = dequantize_linear(mod.weight_q, mod.weight_scale, torch.float32)
    return w.to(dtype)


@torch.no_grad()
def dequantize_params(model: nn.Module, dtype=torch.bfloat16) -> list[str]:
    """Restore a dense `dtype` weight in every int8 or int4 Linear, in place
    (the plain oracle, and the base a LoRA merge needs); returns the
    paths."""
    from vlrlhf_torch.models.common import Linear

    done = []
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear) or mod.weight is not None:
            continue
        w = dense_weight(mod, dtype)
        mod.weight_q = mod.weight_scale = mod.weight_q4 = mod.weight_scale4 = None
        mod.weight_gbias = None
        mod.weight = nn.Parameter(w, requires_grad=False)
        done.append(linear_path(name))
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
