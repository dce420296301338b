"""Shared building blocks (counterpart of vlrlhf_tpu/models/common.py):
`Ctx` (the per-call adapter switch, LoRA dropout seed and PLoRA mask),
`Linear` (dense + optional bias + optional LoRA adapter + optional frozen
PLoRA), clamped `embed`, the static-shape image-feature merge, PLoRA's
`image_position_mask`, and seeded random initialisation.

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

from vlrlhf_torch.core.dist import (
    TPShard, copy_to_tp, f32_product, model_split, reduce_from_tp, scatter_seq, tp_factor,
)
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
    base model (vlrlhf_tpu's Ctx.adapter_mix, models/common.py:40-44).

    `adapter_set` names which of a Linear's adapters apply: "" the pair it
    holds as `lora_a` / `lora_b`, any other name a set of `Linear.lora_sets`
    (PPO's value adapters, a reward model's adapters on the policy's base).
    vlrlhf_tpu's Ctx carries the adapter tree itself; here the name travels
    with the call, so a remat region recomputed in the backward reads the
    set its forward read.

    `lora_mask` (B, S) gates PLoRA (InternLM-XC2's checkpoint-built-in
    LoRA, `Linear.plora_a` / `plora_b`) to the image positions: 1.0 there,
    0 elsewhere (vlrlhf_tpu's Ctx.lora_mask / base_adapters). VLM.forward
    sets it from the image positions for a PLoRA family, with adapters on
    or off alike; the decode step and the chunk prefill drop it (their
    tokens are text). Being part of the call's Ctx, a remat region's
    recompute reads the mask its forward read.

    `seq_span` (offset, whole length) marks a call on a slice of the
    sequence (the fsdp split, models/lm/llama.py): LoRA dropout then
    draws the whole sequence's mask and keeps the slice's rows, so a
    sequence-parallel run draws the single-process masks. Under the model
    split every linear reads the whole sequence, so the LM's Ctx keeps its
    whole `lora_mask` and no `seq_span`.

    `rows` (indices, whole count) marks a call on some rows of the global
    batch: a data-parallel rank's (the steps set it from core.dist
    `dp_rows`) or a pipeline microbatch's (`row_shard`,
    models/lm/pipeline.py). LoRA dropout then draws the whole batch's mask
    and keeps those rows, so data-parallel and pipelined runs draw the
    single-process masks too. The towers' image rows do not follow it (a
    rank's images draw their own masks: VLM.encode_images)."""

    adapters: bool = False
    lora_scale: float = 1.0
    lora_dropout: float = 0.0
    dropout_seed: Optional[int] = None
    adapter_mix: Optional[torch.Tensor] = None
    adapter_set: str = ""
    lora_mask: Optional[torch.Tensor] = None
    seq_span: Optional[tuple[int, int]] = None
    rows: Optional[tuple[tuple[int, ...], int]] = None

    def row_shard(self, lo: int, hi: int, b: int) -> "Ctx":
        """The context of a call on rows [lo, hi) of this call's b rows: the
        PLoRA mask's rows kept, the dropout rows narrowed."""
        mask = None if self.lora_mask is None else self.lora_mask[lo:hi]
        ids, whole = self.rows if self.rows is not None else (tuple(range(b)), b)
        return dataclasses.replace(self, lora_mask=mask, rows=(ids[lo:hi], whole))

    def seq_shard(self, lo: int, hi: int, s: int) -> "Ctx":
        """The context of a call on positions [lo, hi) of a length-s
        sequence: the PLoRA mask sliced, the dropout span set."""
        mask = None if self.lora_mask is None else self.lora_mask[:, lo:hi]
        return dataclasses.replace(self, lora_mask=mask, seq_span=(lo, s))

    def sub(self, key: str) -> "Ctx":
        return self.fold(zlib.crc32(key.encode()) & 0x7FFFFFFF)

    def fold(self, value: int) -> "Ctx":
        if self.dropout_seed is None:
            return self
        return dataclasses.replace(self, dropout_seed=fold_seed(self.dropout_seed, value))


GELU_TANH = "gelu_pytorch_tanh"  # HF's name for jax.nn.gelu's default form


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def activation(name: str):
    """The activation of an HF `hidden_act` name: "gelu" is the erf form
    (nn.GELU, HF's GELUActivation), "gelu_pytorch_tanh" / "gelu_new" the
    tanh approximation (jax.nn.gelu's default, which vlrlhf_tpu computes
    everywhere), "quick_gelu" x * sigmoid(1.702 x)."""
    if name == "quick_gelu":
        return _quick_gelu
    if name == "gelu":
        return F.gelu
    if name in (GELU_TANH, "gelu_new"):
        return _gelu_tanh
    raise ValueError(f"activation {name!r}: expected gelu, {GELU_TANH}, gelu_new or quick_gelu")


def empty_param(shape, device, dtype) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, device=device, dtype=dtype), requires_grad=False)


class Linear(nn.Module):
    """y = x @ weight.T (+ bias) (+ LoRA delta); weight (out, in).

    `lora_a` (in, r) / `lora_b` (r, out) are None until lora.init_lora
    attaches an adapter; it applies when the call's Ctx has adapters on.
    Stacked sets for multi-adapter serving hold (in, N, r) / (N*r, out)
    and read the Ctx's per-row `adapter_mix` (lora.set_adapters_).
    `lora_sets` holds further named (a, b) pairs, outside the state dict;
    a Ctx with that `adapter_set` applies them instead (lora.init_lora,
    lora.set_adapters_).

    Quantized (`quantize_` or the bridge's int8 / int4 leaves), `weight` is
    None and one of two states takes its place:
      - int8: `weight_q` (out, in) int8 with `weight_scale` (out,) bf16,
        y = (x @ weight_q.T) * weight_scale, the W8A16 path of vlrlhf_tpu's
        `linear` (models/common.py:76-78);
      - int4: `weight_q4` (out, half_p) packed codes with `weight_scale4`
        (out, S) bf16 group scales and, from an asymmetric GPTQ
        checkpoint, `weight_gbias` (out, in/64); y = ops/int4.py
        `int4_apply`, the W4A16 kernel on the card (vlrlhf_tpu's `linear`,
        models/common.py:80-86).

    PLoRA (InternLM-XC2): `plora_a` (in, r) / `plora_b` (r, out), frozen
    weights of the checkpoint in the model's dtype, saved and exported
    with it, never trained and never folded by lora.merge_lora. Under a Ctx
    with a `lora_mask` they add mask * (x @ a @ b) (scale 1.0, r = alpha)
    before the trainable adapter's term, whatever the base's kind
    (vlrlhf_tpu `linear_deltas`, models/common.py:97-121)."""

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
        self.register_parameter("plora_a", None)
        self.register_parameter("plora_b", None)
        self.lora_sets: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
        # core.partitioning.shard_linear_ sets it: this rank holds a column
        # or row part of the weight and its forward runs the collectives
        self.tp: Optional[TPShard] = None

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
        a W8A16 base, packed codes for int4). Tensor-parallel, a column
        part's input gradient is summed over the group and a row part's
        output is, before the whole bias is added. Under the model split
        (core/mesh.py) a column part's x is the gathered sequence, whose
        own backward sums the input gradient (core/dist.py gather_seq), and
        a row part's partial sums are reduce-scattered to this rank's slice
        of the sequence (core/dist.py scatter_seq), the whole bias added to
        the slice."""
        tp = self.tp
        row = tp is not None and tp.mode == "row"
        split = model_split()
        if tp is not None and tp.mode == "column" and split is None:
            x = copy_to_tp(x, tp.group)

        def row_sum(part):  # the ranks' partial sums added up, or scattered to the slice
            return reduce_from_tp(part, tp.group) if split is None else scatter_seq(part, split)

        if row and self.weight is not None:
            # a dense row part's partial sum in f32, added up, rounded once
            y = row_sum(f32_product(x, self.weight.to(x.dtype).t())).to(x.dtype)
        else:
            if self.weight_q4 is not None:
                y = int4_apply(x, self.weight_q4, self.weight_scale4, self.weight_gbias)
            elif self.weight is None:
                y = W8A16.apply(x, self.weight_q, self.weight_scale)
            else:
                y = F.linear(x, self.weight.to(x.dtype))
            if row:
                y = row_sum(y)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def adapter_pair(self, adapter_set: str = "") -> Optional[tuple[torch.Tensor, torch.Tensor]]:
        """(a, b) of the named set ("" = lora_a / lora_b), or None."""
        if adapter_set:
            return self.lora_sets.get(adapter_set)
        return None if self.lora_a is None else (self.lora_a, self.lora_b)

    def set_adapter_pair(self, adapter_set: str, a: Optional[torch.Tensor],
                         b: Optional[torch.Tensor]) -> None:
        """Hold (a, b) as the named set ("" = lora_a / lora_b); None drops it."""
        if not adapter_set:
            self.lora_a, self.lora_b = a, b
        elif a is None:
            self.lora_sets.pop(adapter_set, None)
        else:
            self.lora_sets[adapter_set] = (a, b)

    def set_plora_(self, a: Optional[torch.Tensor], b: Optional[torch.Tensor]) -> None:
        """Hold frozen PLoRA weights a (in, r) / b (r, out); None drops them."""
        if a is None:
            self.plora_a = self.plora_b = None
            return
        if a.shape[0] != self.d_in or b.shape != (a.shape[1], self.d_out):
            raise ValueError(f"PLoRA {tuple(a.shape)} {tuple(b.shape)} does not fit "
                             f"({self.d_out}, {self.d_in})")
        self.plora_a = nn.Parameter(a, requires_grad=False)
        self.plora_b = nn.Parameter(b, requires_grad=False)

    def _lora_on(self, ctx: Optional[Ctx]) -> bool:
        return ctx is not None and ctx.adapters and self.adapter_pair(ctx.adapter_set) is not None

    def _plora_on(self, ctx: Optional[Ctx]) -> bool:
        return ctx is not None and ctx.lora_mask is not None and self.plora_a is not None

    def adapted(self, ctx: Optional[Ctx]) -> bool:
        """Whether `delta` adds anything under ctx: the trainable adapter is
        on, or PLoRA is held and the call carries its mask."""
        return self._lora_on(ctx) or self._plora_on(ctx)

    def delta(self, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        """The adapter terms for input x under ctx (see `adapted`): PLoRA
        at the masked positions, then the trainable adapter at all."""
        out = None
        if self._plora_on(ctx):
            out = tp_factor(x, self.plora_a.to(x.dtype), self.tp) @ self.plora_b.to(x.dtype)
            mask = ctx.lora_mask
            split = model_split()
            if split is not None and self.tp is not None and self.tp.mode == "row":
                lo, hi = split.span(mask.shape[1])  # the row part's output is the slice
                mask = mask[:, lo:hi]
            out = out * mask[..., None].to(out.dtype)
        if self._lora_on(ctx):
            a, b = self.adapter_pair(ctx.adapter_set)
            d = lora_delta(x, a, b, ctx.lora_scale, ctx.lora_dropout, ctx.dropout_seed,
                           ctx.adapter_mix, tp=self.tp, seq_span=ctx.seq_span,
                           rows=ctx.rows)
            out = d if out is None else out + d.to(out.dtype)
        return out

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


def image_position_mask(image_positions: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, S) f32, 1.0 at the image-token positions of (B, N) positions
    (-1 = unused slot): PLoRA's im_mask (vlrlhf_tpu `image_position_mask`)."""
    pos = image_positions.long()
    b = pos.shape[0]
    valid = (pos >= 0) & (pos < seq_len)
    rows = torch.arange(b, device=pos.device)[:, None].expand_as(pos)
    mask = torch.zeros((b, seq_len), dtype=torch.float32, device=pos.device)
    mask[rows[valid], pos[valid]] = 1.0
    return mask


@torch.no_grad()
def init_random_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights in vlrlhf_tpu's init scheme (models/common.py
    init_linear and the per-module inits): linear kernels N(0, 1/d_in),
    biases 0, norm weights 1 and biases 0, embedding-like tables N(0, 0.02),
    the class token 0. Draws happen on the parameters' device."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
        if leaf in ("lora_a", "lora_b", "plora_a", "plora_b"):
            raise ValueError("init_random_ runs before adapters or PLoRA are attached")
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
    for mod in module.modules():
        if hasattr(mod, "reset_fixed_"):  # fixed tables (the resampler's sincos)
            mod.reset_fixed_()
    return module
