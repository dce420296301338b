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
from vlrlhf_torch.ops.int4 import BLOCK, GROUP, half_padded, int4_apply, quantize_int4, scale_cols

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
    layer gets its own mask, per step.

    `adapter_mix` (B, N) serves stacked adapter sets (lora.py
    `stack_adapter_sets`): row b's delta is the mix-weighted sum of the
    sets' deltas, so a one-hot row selects its set and a zero row runs the
    base model (vlrlhf_tpu's Ctx.adapter_mix, models/common.py:40-44)."""

    adapters: bool = False
    lora_scale: float = 1.0
    lora_dropout: float = 0.0
    dropout_seed: Optional[int] = None
    adapter_mix: Optional[torch.Tensor] = None

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
    Stacked sets for multi-adapter serving hold (in, N, r) / (N*r, out)
    and read the Ctx's per-row `adapter_mix` (lora.set_adapters_).

    Quantized (`quantize_` or the bridge's int8 / int4 leaves), `weight` is
    None and one of two states takes its place:
      - int8: `weight_q` (out, in) int8 with `weight_scale` (out,) bf16,
        y = (x @ weight_q.T) * weight_scale, the W8A16 path of vlrlhf_tpu's
        `linear` (models/common.py:76-78);
      - int4: `weight_q4` (out, half_p) packed codes with `weight_scale4`
        (out, S) bf16 group scales and, from an asymmetric GPTQ
        checkpoint, `weight_gbias` (out, in/64); y = ops/int4.py
        `int4_apply`, the W4A16 kernel on the card (vlrlhf_tpu's `linear`,
        models/common.py:80-86)."""

    def __init__(self, d_in: int, d_out: int, bias: bool, device, dtype):
        super().__init__()
        self.d_in, self.d_out = d_in, d_out
        self.weight = empty_param((d_out, d_in), device, dtype)
        self.bias = empty_param((d_out,), device, dtype) if bias else None
        self.register_parameter("weight_q", None)
        self.register_parameter("weight_scale", None)
        self.register_parameter("weight_q4", None)
        self.register_parameter("weight_scale4", None)
        self.register_parameter("weight_gbias", None)
        self.register_parameter("lora_a", None)
        self.register_parameter("lora_b", None)

    @property
    def device(self) -> torch.device:
        held = next(t for t in (self.weight, self.weight_q, self.weight_q4) if t is not None)
        return held.device

    def set_quantized_(self, q: torch.Tensor, scale: torch.Tensor) -> None:
        """Hold int8 codes (out, in) and bf16 scales (out,) instead of weight."""
        if tuple(q.shape) != (self.d_out, self.d_in) or tuple(scale.shape) != (self.d_out,):
            raise ValueError(f"int8 weight {tuple(q.shape)} / scale {tuple(scale.shape)} "
                             f"does not fit ({self.d_out}, {self.d_in})")
        self.weight = None
        self.weight_q = nn.Parameter(q.to(torch.int8), requires_grad=False)
        self.weight_scale = nn.Parameter(scale.to(torch.bfloat16), requires_grad=False)

    def set_quantized4_(self, packed: torch.Tensor, scale: torch.Tensor,
                        gbias: Optional[torch.Tensor] = None) -> None:
        """Hold int4 packed codes (out, half_p), bf16 group scales (out, S)
        and an optional zero-point gbias (out, in/64) instead of weight."""
        if self.d_in % BLOCK:
            raise ValueError(f"int4 needs in % {BLOCK} == 0, got in={self.d_in}")
        want = ((self.d_out, half_padded(self.d_in // 2)), (self.d_out, scale_cols(self.d_in)))
        if (tuple(packed.shape), tuple(scale.shape)) != want or (
                gbias is not None and tuple(gbias.shape) != (self.d_out, self.d_in // GROUP)):
            raise ValueError(f"int4 weight {tuple(packed.shape)} / scale {tuple(scale.shape)} "
                             f"does not fit ({self.d_out}, {self.d_in})")
        self.weight = None
        # contiguous: the kernels read them in place on every call
        self.weight_q4 = nn.Parameter(packed.to(torch.int8).contiguous(), requires_grad=False)
        self.weight_scale4 = nn.Parameter(scale.to(torch.bfloat16).contiguous(),
                                          requires_grad=False)
        self.weight_gbias = None if gbias is None else nn.Parameter(
            gbias.to(torch.bfloat16).contiguous(), requires_grad=False)

    @torch.no_grad()
    def quantize_(self, bits: int = 8) -> None:
        """Replace weight by its int8 codes and scales, or (bits=4) its int4
        packed codes and group scales (ops/quant.py, ops/int4.py)."""
        from vlrlhf_torch.ops.quant import quantize_linear

        if bits == 4:
            self.set_quantized4_(*quantize_int4(self.weight))
        elif bits == 8:
            self.set_quantized_(*quantize_linear(self.weight))
        else:
            raise ValueError(f"bits={bits}: expected 8 or 4")

    def base(self, x: torch.Tensor) -> torch.Tensor:
        """The frozen product x @ W.T (+ bias). Its backward needs no
        activation: autograd keeps only weights (int8 codes and scales for
        a W8A16 base, packed codes for int4)."""
        if self.weight_q4 is not None:
            y = int4_apply(x, self.weight_q4, self.weight_scale4, self.weight_gbias)
        elif self.weight is None:
            y = W8A16.apply(x, self.weight_q, self.weight_scale)
        else:
            y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def adapted(self, ctx: Optional[Ctx]) -> bool:
        return ctx is not None and ctx.adapters and self.lora_a is not None

    def delta(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """The adapter's term for input x under ctx (see `adapted`)."""
        return lora_delta(x, self.lora_a, self.lora_b, ctx.lora_scale,
                          ctx.lora_dropout, ctx.dropout_seed, ctx.adapter_mix)

    def forward(self, x: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        y = self.base(x)
        if self.adapted(ctx):
            y = y + self.delta(x, ctx).to(y.dtype)
        return y


class W8A16(torch.autograd.Function):
    """(x @ q.T) * scale with int8 codes q (out, in) and bf16 scales (out,),
    differentiable in x only. Autograd through the plain expression would
    keep the codes' x.dtype copy (a dense weight per linear) for the
    backward; this keeps the codes and converts again there."""

    @staticmethod
    def forward(ctx, x, q, scale):
        ctx.save_for_backward(q, scale)
        return F.linear(x, q.to(x.dtype)) * scale.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        return (g * scale.to(g.dtype)) @ q.to(g.dtype), None, None


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
        if leaf in ("weight_q", "weight_scale", "weight_q4", "weight_scale4", "weight_gbias"):
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
