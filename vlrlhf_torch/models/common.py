"""Shared building blocks (counterpart of vlrlhf_tpu/models/common.py):
`Ctx` (the per-call adapter switch and LoRA dropout seed), `Linear` (dense
+ optional bias + optional LoRA adapter), clamped `embed`, the
static-shape image-feature merge, and seeded random initialisation.

Weights follow PyTorch's (out, in) convention; utils/bridge.py transposes
vlrlhf_tpu's (in, out) kernels on the way in. Parameters are allocated empty
on the requested device and filled by `init_random_` or the bridge, so a
full-width model is built directly on the card.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlrlhf_torch.lora.lora import lora_delta

_MASK63 = (1 << 63) - 1


def fold_seed(seed: int, value: int) -> int:
    """A new 63-bit seed from (seed, value): splitmix64's finalizer, the
    counterpart of jax.random.fold_in for the port's dropout seeds."""
    x = (seed * 0x9E3779B97F4A7C15 + value + 1) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return (x ^ (x >> 31)) & _MASK63


@dataclasses.dataclass(frozen=True)
class Ctx:
    """Per-call context threaded through the model (vlrlhf_tpu's Ctx).

    `adapters` switches the LoRA adapters the Linears hold on or off: the
    DPO reference forward is the same model with adapters off. LoRA dropout
    draws from `dropout_seed`, which `sub` folds with crc32 of each child's
    key and the decoder folds with the layer index, so every module of every
    layer gets its own mask, per step."""

    adapters: bool = False
    lora_scale: float = 1.0
    lora_dropout: float = 0.0
    dropout_seed: Optional[int] = None

    def sub(self, key: str) -> "Ctx":
        return self.fold(zlib.crc32(key.encode()) & 0x7FFFFFFF)

    def fold(self, value: int) -> "Ctx":
        if self.dropout_seed is None:
            return self
        return dataclasses.replace(self, dropout_seed=fold_seed(self.dropout_seed, value))


def empty_param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Linear(nn.Module):
    """y = x @ weight.T (+ bias) (+ LoRA delta); weight (out, in).

    `lora_a` (in, r) / `lora_b` (r, out) are None until lora.init_lora
    attaches an adapter; it applies when the call's Ctx has adapters on.

    Quantized (`quantize_` or the bridge's int8 leaves), `weight` is None
    and `weight_q` (out, in) int8 with `weight_scale` (out,) bf16 take its
    place: y = (x @ weight_q.T) * weight_scale, the W8A16 path of
    vlrlhf_tpu's `linear` (models/common.py:76-78)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device, dtype):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.weight = empty_param((d_out, d_in), device, dtype)
        self.bias = empty_param((d_out,), device, dtype) if bias else None
        self.register_parameter("weight_q", None)
        self.register_parameter("weight_scale", None)
        self.register_parameter("lora_a", None)
        self.register_parameter("lora_b", None)

    @property
    def device(self) -> torch.device:
        return (self.weight if self.weight is not None else self.weight_q).device

    def set_quantized_(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Hold int8 codes (out, in) and bf16 scales (out,) instead of weight."""
        if tuple(q.shape) != (self.d_out, self.d_in) or tuple(scale.shape) != (self.d_out,):
            raise ValueError(f"int8 weight {tuple(q.shape)} / scale {tuple(scale.shape)} "
                             f"does not fit ({self.d_out}, {self.d_in})")
        self.weight = None
        self.weight_q = nn.Parameter(q.to(torch.int8), requires_grad=False)
        self.weight_scale = nn.Parameter(scale.to(torch.bfloat16), requires_grad=False)

    @torch.no_grad()
    def quantize_(self) -> None:
        """Replace weight by its int8 codes and scales (ops/quant.py)."""
        from vlrlhf_torch.ops.quant import quantize_linear

        self.set_quantized_(*quantize_linear(self.weight))

    def forward(self, x: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        if self.weight is None:
            y = F.linear(x, self.weight_q.to(x.dtype)) * self.weight_scale.to(x.dtype)
        else:
            y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if ctx is not None and ctx.adapters and self.lora_a is not None:
            delta = lora_delta(x, self.lora_a, self.lora_b, ctx.lora_scale,
                               ctx.lora_dropout, ctx.dropout_seed)
            y = y + delta.to(y.dtype)
        return y


class Norm(nn.Module):
    """Holds a norm's weight (and bias for LayerNorm); the math lives in
    ops/norms.py."""

    def __init__(self, dim: int, bias: bool, device, dtype):
        super().__init__()
        self.weight = empty_param((dim,), device, dtype)
        self.bias = empty_param((dim,), device, dtype) if bias else None


def embed(table: torch.Tensor, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Row lookup with out-of-vocab ids clamped to the table (F.embedding
    would raise where vlrlhf_tpu's take(mode="clip") clamps)."""
    ids = ids.long().clamp(0, table.shape[0] - 1)
    return F.embedding(ids, table).to(dtype)


def merge_multimodal_embeddings(
    token_embeds: torch.Tensor,  # (B, S, D)
    image_features: torch.Tensor,  # (B, N_img, D)
    image_positions: torch.Tensor,  # (B, N_img) int; -1 = unused slot
) -> torch.Tensor:
    """Splice image features into the token-embedding sequence at their
    precomputed positions (static shapes). Unused slots (position -1)
    scatter nowhere. Positions within a row are distinct (the processor
    emits one placeholder per feature), so an index copy is exact."""
    b, s, d = token_embeds.shape
    pos = image_positions.long()
    valid = pos >= 0
    rows = torch.arange(b, device=pos.device)[:, None].expand_as(pos)
    out = token_embeds.clone()
    out[rows[valid], pos[valid]] = image_features.to(token_embeds.dtype)[valid]
    return out


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in vlrlhf_tpu's init scheme (models/common.py
    init_linear and the per-module inits): linear kernels N(0, 1/d_in),
    biases 0, norm weights 1 and biases 0, embedding-like tables N(0, 0.02),
    the class token 0. Draws happen on the parameters' device."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if leaf in ("lora_a", "lora_b"):
            raise ValueError("init_random_ runs before lora.init_lora attaches adapters")
        if leaf in ("weight_q", "weight_scale"):
            raise ValueError("init_random_ runs before quantization")
        if isinstance(owner, Linear) and leaf == "weight":
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        elif isinstance(owner, Norm) and leaf == "weight":
            p.fill_(1.0)
        elif leaf == "bias" or name.endswith("cls_token"):
            p.zero_()
        else:
            p.normal_(0.0, 0.02, generator=generator)
    return module
