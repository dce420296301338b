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
"lm/layers/3/attn/wq/kernel"). Stacked adapter sets (multi-adapter
serving) and `merge_lora` belong to later slices.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence

import torch
from torch import nn

# The JAX package's default LLaVA targets (vlrlhf_tpu/models/registry.py).
LM_ALL_LINEARS = (r"lm/.*attn/(wq|wk|wv|wo)/", r"lm/.*mlp/(gate|up|down)/")

_ATTN = ("wq", "wk", "wv", "wo")
_MLP = ("gate", "up", "down", "fc1", "fc2")


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


def lora_parameters(model: nn.Module) -> list[tuple[str, nn.Parameter]]:
    """Every adapter parameter as (name, param), in module path order then
    a before b: the optimizer's leaf order."""
    from vlrlhf_torch.models.common import Linear

    mods = sorted(
        ((module_path(n), n, m) for n, m in model.named_modules()
         if isinstance(m, Linear) and m.lora_a is not None),
        key=lambda t: t[0],
    )
    return [(f"{n}.{leaf}", getattr(m, leaf)) for _, n, m in mods for leaf in ("lora_a", "lora_b")]


def lora_delta(
    x: torch.Tensor,
    a: torch.Tensor,  # (in, r)
    b: torch.Tensor,  # (r, out)
    scale: float,
    dropout: float = 0.0,
    seed: Optional[int] = None,
) -> torch.Tensor:
    """delta = dropout(x) @ a @ b * scale, a and b cast to x's dtype.

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
    return (h @ a.to(x.dtype)) @ b.to(x.dtype) * scale
