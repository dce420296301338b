"""LoRA adapters (counterpart of vlrlhf_tpu/lora/lora.py: LoraConfig,
target matching, init_lora, lora_delta).

In the JAX package adapters are a pytree beside the params; here each
targeted `models.common.Linear` holds its own pair as parameters, `lora_a`
(in, r) and `lora_b` (r, out), f32 masters that the forward casts to the
activation dtype. Whether they apply is the forward's `Ctx.adapters` switch
(models/common.py), so the DPO reference policy is the same modules with
adapters off.

Targets are chosen by the JAX package's regexes (e.g. LM_ALL_LINEARS)
applied to each Linear's parameter path in the JAX layout, which
`module_path` derives from the port's module name ("lm.layers.3.wq" ->
"lm/layers/3/attn/wq/kernel"); `lora_parameters` names each adapter leaf
by that path ("lm/layers/3/attn/wq/a"), the keys of the port's
checkpoints. `merge_lora` folds the adapters into the base weights.

Multi-adapter serving (vlrlhf_tpu's `stack_adapter_sets` /
`fuse_adapter_sets`, lora.py:179-296): N sets of one structure stack per
Linear into `lora_a` (in, N, r) and `lora_b` (N*r, out), and the forward's
`Ctx.adapter_mix` (B, N) picks (one-hot) or blends each row's set, so the
mixed delta is two dense matmuls. `set_adapters_` puts a tree of adapters
(single or stacked, keyed by JAX-layout paths) on a model's Linears;
`lend_adapters` does so for a block and then restores what they held.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Mapping, Optional, Sequence

import torch
from torch import nn

# The JAX package's default LLaVA targets (vlrlhf_tpu/models/registry.py).
LM_ALL_LINEARS = (r"lm/.*attn/(wq|wk|wv|wo)/", r"lm/.*mlp/(gate|up|down)/")

_ATTN = ("wq", "wk", "wv", "wo", "wqkv")  # wqkv, gateup: the fused serving layout
_MLP = ("gate", "up", "down", "fc1", "fc2", "gateup")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: float = 16.0
    dropout: float = 0.05
    target_patterns: tuple[str, ...] = ()

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def module_path(name: str) -> str:
    """The JAX-layout path of a Linear's kernel for a port module name:
    layer linears gain their "attn"/"mlp" group ("vision.layers.0.fc1" ->
    "vision/layers/0/mlp/fc1/kernel"), others map dot for slash."""
    parts = name.split(".")
    if len(parts) == 4 and parts[1] == "layers":
        group = "attn" if parts[3] in _ATTN else "mlp" if parts[3] in _MLP else None
        if group is not None:
            parts = parts[:3] + [group, parts[3]]
    return "/".join(parts) + "/kernel"


def match_lora_targets(model: nn.Module, patterns: Sequence[str]) -> list[tuple[str, nn.Module]]:
    """(module name, Linear) for every Linear whose path matches a pattern,
    sorted by path as vlrlhf_tpu's init_lora orders its draws."""
    from vlrlhf_torch.models.common import Linear

    regs = [re.compile(p) for p in patterns]
    found = [
        (module_path(name), name, mod) for name, mod in model.named_modules()
        if isinstance(mod, Linear) and any(r.search(module_path(name)) for r in regs)
    ]
    return [(name, mod) for _, name, mod in sorted(found, key=lambda t: t[0])]


def init_lora(model: nn.Module, cfg: LoraConfig, generator: torch.Generator) -> list[str]:
    """Attach adapters to every matched Linear: a ~ N(0, 1/r), b = 0, both
    f32 on the module's device, drawn from `generator` in path order. b = 0
    makes the adapted model start equal to the base (the DPO step-1 loss is
    ln 2). Returns the names of the adapted modules."""
    names = []
    for name, mod in match_lora_targets(model, cfg.target_patterns):
        d_out, d_in = mod.d_out, mod.d_in
        dev = mod.device
        a = torch.randn((d_in, cfg.r), generator=generator, device=dev, dtype=torch.float32)
        mod.lora_a = nn.Parameter(a / cfg.r**0.5)
        mod.lora_b = nn.Parameter(torch.zeros((cfg.r, d_out), device=dev, dtype=torch.float32))
        names.append(name)
    if not names:
        raise ValueError(f"no Linear matches the LoRA targets {cfg.target_patterns}")
    return names


def _adapted(model: nn.Module) -> list[tuple[str, str, nn.Module]]:
    """(JAX-layout path, module name, Linear) of every adapted Linear, by path."""
    from vlrlhf_torch.models.common import Linear

    return sorted(
        ((module_path(n), n, m) for n, m in model.named_modules()
         if isinstance(m, Linear) and m.lora_a is not None),
        key=lambda t: t[0],
    )


def lora_parameters(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """Every adapter parameter as (name, param), in module path order then
    a before b: the optimizer's leaf order."""
    return [(f"{n}.{leaf}", getattr(m, leaf)) for _, n, m in _adapted(model)
            for leaf in ("lora_a", "lora_b")]


def lora_keys(model: nn.Module) -> list[str]:
    """The JAX-layout key of each leaf of `lora_parameters`, in its order:
    "lm/layers/3/attn/wq/a", "lm/layers/3/attn/wq/b", ..."""
    return [f"{path[: -len('/kernel')]}/{leaf}" for path, _, _ in _adapted(model)
            for leaf in ("a", "b")]


@torch.no_grad()
def merge_lora(model: nn.Module, scale: float) -> dict[str, torch.Tensor]:
    """The model's state dict with every adapter folded into its base
    weight, W + scale * (A @ B).T summed in f32 and cast back to W's dtype
    (vlrlhf_tpu `merge_lora`, lora.py:298); the adapter leaves are left
    out. The model is not changed. An adapted Linear must hold a dense
    weight: a quantized base goes through ops/quant.py dequantize_params
    first, as vlrlhf_tpu's merge does."""
    merged = {}
    for _, name, mod in _adapted(model):
        if mod.weight is None:
            raise ValueError(f"{name}: merge_lora needs a dense weight; dequantize first")
        delta = (mod.lora_a.float() @ mod.lora_b.float()) * scale  # (in, out)
        merged[f"{name}.weight"] = (mod.weight.float() + delta.T).to(mod.weight.dtype)
    return {k: merged.get(k, v) for k, v in model.state_dict().items()
            if not k.endswith((".lora_a", ".lora_b"))}


def lora_delta(
    x: torch.Tensor,
    a: torch.Tensor,  # (in, r), or stacked sets (in, N, r)
    b: torch.Tensor,  # (r, out), or stacked sets (N*r, out)
    scale: float,
    dropout: float = 0.0,
    seed: Optional[int] = None,
    mix: Optional[torch.Tensor] = None,  # (B, N) per-row set weights, stacked sets only
) -> torch.Tensor:
    """delta = dropout(x) @ a @ b * scale, a and b cast to x's dtype.

    Stacked sets (`stack_adapter_sets`) take the mixed path of vlrlhf_tpu's
    `lora_delta` (lora.py:160-176): delta_b = sum_n mix_bn (x_b @ a_n) @ b_n
    as two dense matmuls at width N*r, the mix applied between them; x's
    leading axis is the batch row.

    The dropout mask comes from a generator seeded with `seed` at each call
    (not a running stream), so torch.utils.checkpoint's recompute draws the
    same mask as the first forward. It is not JAX's mask: the keep
    probability and the 1/(1-p) scale are what match."""
    h = x
    if seed is not None and dropout > 0.0:
        gen = torch.Generator(device=x.device)
        gen.manual_seed(seed)
        keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - dropout
        h = torch.where(keep, x / (1.0 - dropout), torch.zeros((), dtype=x.dtype, device=x.device))
    if a.dim() == 3:
        if mix is None:
            raise ValueError("stacked adapter sets need a per-row Ctx.adapter_mix")
        d_in, n, r = a.shape
        t = (h @ a.reshape(d_in, n * r).to(x.dtype)).unflatten(-1, (n, r))
        w = mix.to(x.dtype).reshape(mix.shape[0], *([1] * (h.dim() - 2)), n, 1)
        return (t * w).flatten(-2) @ b.to(x.dtype) * scale
    return (h @ a.to(x.dtype)) @ b.to(x.dtype) * scale


def stack_adapter_sets(sets: Sequence[Mapping[str, torch.Tensor]]) -> dict[str, torch.Tensor]:
    """Stack N adapter sets, each {JAX-layout key: tensor} ("lm/layers/3/
    attn/wq/a": (in, r), ".../b": (r, out); the `dpo` adapters file), for
    multi-adapter serving. vlrlhf_tpu's axis contract for one layer
    (lora.py:179-214): an "a" leaf stacks on the inner axis to (in, N, r),
    a "b" leaf folds N into its rows, (N*r, out). The sets must share keys
    and shapes (one target list and rank)."""
    if not sets:
        raise ValueError("stack_adapter_sets needs at least one set")
    keys = sorted(sets[0])
    for i, s in enumerate(sets[1:], 1):
        if sorted(s) != keys:
            raise ValueError(f"adapter set {i} has other keys than set 0")
    out = {}
    for k in keys:
        parts = [s[k] for s in sets]
        if len({tuple(p.shape) for p in parts}) != 1:
            raise ValueError(f"{k}: the sets' shapes differ {[tuple(p.shape) for p in parts]}")
        out[k] = torch.stack(parts, dim=1) if k.endswith("/a") else torch.cat(parts, dim=0)
    return out


def fuse_adapter_group(pairs: Sequence[Optional[tuple[torch.Tensor, torch.Tensor]]],
                       d_outs: Sequence[int]):
    """(a, b) of the fused linear for the (a, b) of its parts (wq / wk / wv
    or gate / up, widths `d_outs`), single or stacked: the a's concatenate
    on the rank axis, (in, [N,] T*r), and b is per set block diagonal,
    ([N*]T*r, sum out). Exact: every reduction over `in` is untouched and
    the blocks add only structural zeros (vlrlhf_tpu `fuse_adapter_sets`,
    lora.py:217-296). A part without an adapter (None) takes a zero one,
    which adds nothing; vlrlhf_tpu keeps such a group per target instead,
    with the same outputs. The adapters must share one rank and set count."""
    held = [p for p in pairs if p is not None]
    shapes = {tuple(a.shape[1:]) for a, _ in held}
    if len(shapes) != 1:
        raise ValueError(f"fusing adapters needs one rank and set count, got {sorted(shapes)}")
    a0, b0 = held[0]
    n, r = (a0.shape[1], a0.shape[2]) if a0.dim() == 3 else (1, a0.shape[1])
    big = torch.zeros((n, len(pairs) * r, sum(d_outs)), dtype=b0.dtype, device=b0.device)
    a_parts, off = [], 0
    for t, (pair, d_out) in enumerate(zip(pairs, d_outs)):
        if pair is None:
            a_parts.append(torch.zeros_like(a0))
        else:
            a_parts.append(pair[0])
            big[:, t * r:(t + 1) * r, off:off + d_out] = pair[1].reshape(n, r, d_out)
        off += d_out
    return torch.cat(a_parts, dim=-1), big.reshape(n * len(pairs) * r, sum(d_outs))


_FUSED_GROUPS = (("attn", ("wq", "wk", "wv"), "wqkv"), ("mlp", ("gate", "up"), "gateup"))


def fuse_adapter_sets(tree: Mapping[str, torch.Tensor], lm_cfg) -> dict[str, torch.Tensor]:
    """An adapter tree (single or stacked, JAX-layout keys) in the fused
    serving layout of models/lm/fuse.py: per LM layer, wq / wk / wv ->
    wqkv and gate / up -> gateup (`fuse_adapter_group`; `lm_cfg`, the
    LMConfig, gives the parts' widths). Other keys pass through."""
    q, kv = lm_cfg.num_heads * lm_cfg.head_dim_, lm_cfg.num_kv_heads * lm_cfg.head_dim_
    widths = {"attn": (q, kv, kv), "mlp": (lm_cfg.intermediate_size,) * 2}
    out = dict(tree)
    prefixes = {k.rsplit("/", 3)[0] for k in tree
                if re.match(r"lm/layers/\d+/(attn|mlp)/", k)}
    for prefix in sorted(prefixes):
        for group, names, fused in _FUSED_GROUPS:
            keys = [f"{prefix}/{group}/{n}" for n in names]
            pairs = [(out.pop(f"{k}/a"), out.pop(f"{k}/b")) if f"{k}/a" in tree else None
                     for k in keys]
            if any(p is not None for p in pairs):
                out[f"{prefix}/{group}/{fused}/a"], out[f"{prefix}/{group}/{fused}/b"] = \
                    fuse_adapter_group(pairs, widths[group])
    return out


def set_adapters_(model: nn.Module, tree: Optional[Mapping[str, torch.Tensor]]) -> list[str]:
    """Hold `tree`'s adapters (single (in, r) / (r, out) or stacked (in, N,
    r) / (N*r, out), keyed by JAX-layout paths) on the model's Linears, as
    frozen parameters on each module's device; every other Linear holds
    none. A key that names no Linear of the model is an error. Returns the
    adapted module names."""
    from vlrlhf_torch.models.common import Linear

    tree = dict(tree or {})
    done = []
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        key = module_path(name)[: -len("/kernel")]
        a, b = tree.pop(f"{key}/a", None), tree.pop(f"{key}/b", None)
        if a is None or b is None:
            mod.lora_a = mod.lora_b = None
            continue
        if a.shape[0] != mod.d_in or b.shape[-1] != mod.d_out or b.shape[0] != a[0].numel():
            raise ValueError(f"{name}: adapter {tuple(a.shape)} {tuple(b.shape)} does not fit "
                             f"({mod.d_out}, {mod.d_in})")
        dev = mod.device
        mod.lora_a = nn.Parameter(a.to(dev), requires_grad=False)
        mod.lora_b = nn.Parameter(b.to(dev), requires_grad=False)
        done.append(name)
    if tree:
        raise ValueError(f"adapter keys that name no Linear of the model: {sorted(tree)[:4]}")
    return done


@contextlib.contextmanager
def lend_adapters(model: nn.Module, tree: Mapping[str, torch.Tensor]):
    """Hold `tree` on the model's Linears (`set_adapters_`) for the block,
    then give every Linear back the adapters it held before (trained LoRA
    and tower adapters included). One lender at a time: a model whose
    Linears are already lent raises, so two engines that serve different
    sets from one model cannot overwrite each other."""
    from vlrlhf_torch.models.common import Linear

    if getattr(model, "_adapters_lent", False):
        raise RuntimeError("the model's Linears already hold another engine's adapter sets; "
                           "serve one engine's sets at a time")
    before = [(mod, mod.lora_a, mod.lora_b) for mod in model.modules() if isinstance(mod, Linear)]
    model._adapters_lent = True
    try:
        set_adapters_(model, tree)
        yield
    finally:
        for mod, a, b in before:
            mod.lora_a, mod.lora_b = a, b
        model._adapters_lent = False
