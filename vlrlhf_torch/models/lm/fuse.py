"""Fused serving weights: wq/wk/wv -> wqkv, gate/up -> gateup (counterpart
of vlrlhf_tpu/models/lm/fuse.py, `--fuse_decode`).

Concatenating linears along `out` is exact: every output column keeps its
own reduction over `in`. That holds for dense weights, for int8 codes with
per-out-channel scales and for int4 packed codes with group scales (int4
packs along `in`, so each output row's bytes and scales move as a unit),
gbias and biases included (zero-filled for a part that lacks one). A
decode layer then runs 4 weight products instead of 7: with int4 weights,
129 launches of the W4A16 kernel per step instead of 225.

A serving transform, applied after quantization: training, LoRA targets
and the bridge address wq/wk/wv/gate/up separately. Adapters the parts
hold (single or stacked sets, one rank) fuse with them
(lora.fuse_adapter_group): the a's side by side on the rank axis, the b's
block diagonal (zeros for a part without one), so the fused linear's delta
equals the parts' deltas side by side.
"""

from __future__ import annotations

import torch
from torch import nn

from vlrlhf_torch.lora.lora import fuse_adapter_group
from vlrlhf_torch.models.common import Linear
from vlrlhf_torch.ops.int4 import GROUP


def _cat(parts: list, attr: str, fill_shape) -> torch.Tensor | None:
    """Concatenate one parameter of every part along out (dim 0); parts
    without it contribute zeros of `fill_shape(part)` when another has it."""
    held = [getattr(p, attr) for p in parts]
    if all(t is None for t in held):
        return None
    ref = next(t for t in held if t is not None)
    return torch.cat([t.detach() if t is not None else
                      torch.zeros(fill_shape(p), dtype=ref.dtype, device=ref.device)
                      for t, p in zip(held, parts)], dim=0)


@torch.no_grad()
def concat_linears(parts: list[Linear]) -> Linear:
    """One Linear whose output is the parts' outputs side by side."""
    kinds = {"int4" if p.weight_q4 is not None else "int8" if p.weight_q is not None
             else "dense" for p in parts}
    if len(kinds) != 1 or len({p.d_in for p in parts}) != 1:
        raise ValueError(f"fusion needs linears of one kind and width, got {kinds}")
    kind = kinds.pop()
    first = parts[0]
    # built on "meta" and filled with the concatenations: no empty weight
    # of the fused size is ever allocated
    fused = Linear(first.d_in, sum(p.d_out for p in parts), False, "meta", torch.float32)
    if kind == "dense":
        fused.weight = nn.Parameter(torch.cat([p.weight for p in parts], dim=0),
                                    requires_grad=False)
    elif kind == "int8":
        fused.set_quantized_(_cat(parts, "weight_q", None), _cat(parts, "weight_scale", None))
    else:
        fused.set_quantized4_(
            _cat(parts, "weight_q4", None), _cat(parts, "weight_scale4", None),
            _cat(parts, "weight_gbias", lambda p: (p.d_out, p.d_in // GROUP)))
    bias = _cat(parts, "bias", lambda p: (p.d_out,))
    fused.bias = None if bias is None else nn.Parameter(bias, requires_grad=False)
    if any(p.lora_a is not None for p in parts):
        a, b = fuse_adapter_group(
            [None if p.lora_a is None else (p.lora_a.detach(), p.lora_b.detach()) for p in parts],
            [p.d_out for p in parts])
        fused.lora_a = nn.Parameter(a, requires_grad=False)
        fused.lora_b = nn.Parameter(b, requires_grad=False)
    return fused


@torch.no_grad()
def fuse_lm_(lm: nn.Module) -> nn.Module:
    """Rewrite every decoder layer in place to the fused serving layout;
    idempotent. The parts are released as their fused twin lands, so the
    transient is one layer's linears."""
    for layer in lm.layers:
        if layer.wqkv is not None:
            continue
        layer.wqkv = concat_linears([layer.wq, layer.wk, layer.wv])
        layer.wq = layer.wk = layer.wv = None
        layer.gateup = concat_linears([layer.gate, layer.up])
        layer.gate = layer.up = None
    return lm
