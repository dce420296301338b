"""Bridge a vlrlhf_tpu parameter tree (nested dicts of numpy arrays, e.g.
`jax.device_get(init_vlm_params(cfg, key))`) into the port's modules.

vlrlhf_tpu layouts (keys as in vlrlhf_tpu/models/common.py and the
per-module inits) and what the bridge does with them:
  - linear {"kernel" (in, out)[, "bias"]} -> Linear.weight (out, in): transposed
  - "layers_scanned": every leaf stacked on a leading layer axis -> one
    slice per nn.ModuleList entry
  - vision "patch_embed" HWIO kernel (p, p, 3, h) -> (h, p*p*3), flattened
    in (row, col, channel) order to match the tower's patch extraction
The copy goes to each parameter's device and dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from vlrlhf_torch.models import config as C
from vlrlhf_torch.models.common import Linear, Norm
from vlrlhf_torch.models.vlm import VLM


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(src.shape)} -> {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dtype=dst.dtype, device=dst.device))


def _linear(dst: Linear, p: Mapping[str, Any]) -> None:
    _copy(dst.weight, np.asarray(p["kernel"]).T)
    if dst.bias is not None:
        _copy(dst.bias, p["bias"])
    elif "bias" in p:
        raise ValueError("source linear has a bias the module lacks")


def _norm(dst: Norm, p: Mapping[str, Any]) -> None:
    _copy(dst.weight, p["weight"])
    if dst.bias is not None:
        _copy(dst.bias, p["bias"])


def _layer(tree: Any, i: int) -> Any:
    """Slice layer i out of a stacked ("layers_scanned") subtree."""
    if isinstance(tree, Mapping):
        return {k: _layer(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


def load_vlm_params(model: VLM, params: Mapping[str, Any]) -> VLM:
    """Copy a vlrlhf_tpu VLM param tree into `model`; returns `model`."""
    vis, vp = model.vision, params["vision"]
    kernel = np.asarray(vp["patch_embed"]["kernel"])  # (p, p, 3, h)
    _copy(vis.patch_weight, kernel.reshape(-1, kernel.shape[-1]).T)
    if vis.patch_bias is not None:
        _copy(vis.patch_bias, vp["patch_embed"]["bias"])
    _copy(vis.pos_embed, vp["pos_embed"]["embedding"])
    if vis.cls_token is not None:
        _copy(vis.cls_token, vp["cls"]["token"])
    if vis.ln_pre is not None:
        _norm(vis.ln_pre, vp["ln_pre"])
    if vis.ln_post is not None:
        _norm(vis.ln_post, vp["ln_post"])
    for i, blk in enumerate(vis.layers):
        lp = _layer(vp["layers_scanned"], i)
        _norm(blk.ln1, lp["ln1"])
        _norm(blk.ln2, lp["ln2"])
        for name in ("wq", "wk", "wv", "wo"):
            _linear(getattr(blk, name), lp["attn"][name])
        _linear(blk.fc1, lp["mlp"]["fc1"])
        _linear(blk.fc2, lp["mlp"]["fc2"])

    pp = params["projector"]
    _linear(model.projector.fc1, pp["fc1"])
    _linear(model.projector.fc2, pp["fc2"])

    lm, lmp = model.lm, params["lm"]
    _copy(lm.embed_tokens, lmp["embed_tokens"]["embedding"])
    for i, layer in enumerate(lm.layers):
        lp = _layer(lmp["layers_scanned"], i)
        _norm(layer.input_layernorm, lp["input_layernorm"])
        _norm(layer.post_attention_layernorm, lp["post_attention_layernorm"])
        for name in ("wq", "wk", "wv", "wo"):
            _linear(getattr(layer, name), lp["attn"][name])
        for name in ("gate", "up", "down"):
            _linear(getattr(layer, name), lp["mlp"][name])
    _norm(lm.norm, lmp["norm"])
    if lm.lm_head is not None:
        _linear(lm.lm_head, lmp["lm_head"])
    return model


def _torch_dtype(dt) -> torch.dtype:
    name = getattr(dt, "__name__", None) or str(np.dtype(dt))
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def vlm_config_from(src) -> C.VLMConfig:
    """The port's VLMConfig for a vlrlhf_tpu VLMConfig (read by attribute
    name, so this module needs no jax import); dtypes map by name."""

    def conv(cls, obj):
        kw = {}
        for f in dataclasses.fields(cls):
            if hasattr(obj, f.name):
                v = getattr(obj, f.name)
                kw[f.name] = _torch_dtype(v) if f.name == "dtype" else v
        return cls(**kw)

    if getattr(src, "qformer", None) is not None or getattr(src, "plora", False) \
            or getattr(src, "grid_pinpoints", ()):
        raise ValueError("only LLaVA-1.5-style configs are ported")
    return C.VLMConfig(
        lm=conv(C.LMConfig, src.lm),
        vision=conv(C.ViTConfig, src.vision),
        projector=conv(C.ProjectorConfig, src.projector),
        image_token_id=src.image_token_id,
        num_image_tokens=src.num_image_tokens,
        family=src.family,
        image_mean=tuple(src.image_mean),
        image_std=tuple(src.image_std),
    )
