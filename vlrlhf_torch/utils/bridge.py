"""Bridge a vlrlhf_tpu parameter tree (nested dicts of numpy arrays, e.g.
`jax.device_get(init_vlm_params(cfg, key))`) into the port's modules.

vlrlhf_tpu layouts (keys as in vlrlhf_tpu/models/common.py and the
per-module inits) and what the bridge does with them:
  - linear {"kernel" (in, out)[, "bias"]} -> Linear.weight (out, in): transposed
  - int8 linear {"kernel_q" (in, out) int8, "kernel_scale" (1, out) bf16}
    (ops/quant.py) -> Linear.weight_q (out, in) / weight_scale (out,)
  - int4 linear {"kernel_q4" (half_p, out) int8, "kernel_scale" (S, out)
    bf16[, "kernel_gbias" (in/64, out)]} (ops/int4.py, utils/gptq.py) ->
    Linear.weight_q4 (out, half_p) / weight_scale4 (out, S) / weight_gbias
    (out, in/64): the same packed bytes and scales, transposed
  - "layers_scanned": every leaf stacked on a leading layer axis -> one
    slice per nn.ModuleList entry
  - vision "patch_embed" HWIO kernel (p, p, 3, h) -> (h, p*p*3), flattened
    in (row, col, channel) order to match the tower's patch extraction
  - "qformer" (a list of per-layer dicts: self_attn, cross_attn every
    cross_attention_frequency layers, ffn, ffn_query) -> QFormer's layers;
    "image_newline" {"embedding" (H,)} -> VLM.image_newline
  - vision "pos_embed" of another grid than the patches (a checkpoint's
    table, resized in the forward) -> VisionTower.set_pos_embed_
  - projector "resampler" {query, pos_embed, ln_q, ln_kv, kv_proj, attn/
    wq..wo} with "ln_post" and the bias-free "proj" -> Projector's
    Resampler, ln_post and proj (Qwen-VL)
  - "plora" (InternLM-XC2's checkpoint PLoRA, an adapter-shaped tree
    {"lm": {"layers_scanned": ...}}) -> each LM Linear's frozen plora_a /
    plora_b in the model's dtype
  - LoRA adapter trees ({"a" (in, r), "b" (r, out)} leaves beside the base
    tree, stacked on the layer axis under "layers_scanned") -> each Linear's
    lora_a / lora_b, f32; a list of N such trees (vlrlhf_tpu's
    multi-adapter `adapter_sets`) -> the port's stacked sets, (in, N, r) /
    (N*r, out) on each Linear (lora.stack_adapter_sets); `adapter_keys`
    flattens one tree to the port's {JAX-layout key: tensor} form (the
    `dpo` adapters file); `lora_tree` is the way back, for the adapters or
    their gradients, so tests compare leaf by leaf
The copy goes to each parameter's device and dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from vlrlhf_torch.lora.lora import module_path, set_adapters_, stack_adapter_sets
from vlrlhf_torch.models import config as C
from vlrlhf_torch.models.common import GELU_TANH, Linear, Norm
from vlrlhf_torch.models.vlm import VLM


def _copy(dst: torch.Tensor, src) -> None:
    src = torch.from_numpy(np.array(src, dtype=np.float32))  # a writable copy
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: {tuple(src.shape)} -> {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src.to(dtype=dst.dtype, device=dst.device))


def _f32(a) -> torch.Tensor:
    """A leaf (numpy float, or ml_dtypes bf16) as an f32 tensor, exactly."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _linear(dst: Linear, p: Mapping[str, Any]) -> None:
    if "kernel_q4" in p:
        # W4A16: packed (half_p, out) codes and (S, out) group scales, the
        # same bytes transposed to the port's (out, ...) convention
        dev = dst.device
        packed = torch.from_numpy(np.ascontiguousarray(np.asarray(p["kernel_q4"], np.int8).T))
        scale = _f32(np.asarray(p["kernel_scale"]).T)
        gbias = _f32(np.asarray(p["kernel_gbias"]).T).to(dev) if "kernel_gbias" in p else None
        dst.set_quantized4_(packed.to(dev), scale.to(dev), gbias)
    elif "kernel_q" in p:
        # W8A16: (in, out) int8 codes and (1, out) bf16 scales, transposed
        dev = dst.device
        q = torch.from_numpy(np.array(np.asarray(p["kernel_q"]).T, dtype=np.int8))
        scale = _f32(p["kernel_scale"]).reshape(-1)
        dst.set_quantized_(q.to(dev), scale.to(dev))
    else:
        if dst.weight is None:
            raise ValueError("source linear is not quantized, the module is")
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
    pos = vp["pos_embed"]["embedding"]
    if tuple(np.shape(pos)) != tuple(vis.pos_embed.shape):
        vis.set_pos_embed_(_f32(pos).to(vis.patch_weight.device))
    else:
        _copy(vis.pos_embed, pos)
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

    pp, proj = params["projector"], model.projector
    if proj.kind == "resampler":
        _load_resampler(proj, pp)
    else:
        _linear(proj.fc1, pp["fc1"])
        if proj.fc2 is not None:
            _linear(proj.fc2, pp["fc2"])
    if model.qformer is not None:
        _load_qformer(model.qformer, params["qformer"])
    if model.image_newline is not None:
        _copy(model.image_newline, params["image_newline"]["embedding"])

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
    if params.get("plora"):
        load_plora_params(model, params["plora"])
    return model


def _load_resampler(proj, pp: Mapping[str, Any]) -> None:
    r, rp = proj.resampler, pp["resampler"]
    _copy(r.query, rp["query"])
    _copy(r.pos_embed, rp["pos_embed"])
    _norm(r.ln_q, rp["ln_q"])
    _norm(r.ln_kv, rp["ln_kv"])
    if r.kv_proj is not None:
        _linear(r.kv_proj, rp["kv_proj"])
    for name in ("wq", "wk", "wv", "wo"):
        _linear(getattr(r.attn, name), rp["attn"][name])
    _norm(proj.ln_post, pp["ln_post"])
    _linear(proj.proj, pp["proj"])


def load_plora_params(model: VLM, plora: Mapping[str, Any]) -> list[str]:
    """vlrlhf_tpu's PLoRA tree (port_xc2_plora's output: {"a", "b"} leaves
    stacked under lm/layers_scanned) -> each LM Linear's frozen PLoRA, in
    the LM's dtype. Returns the module names that hold one."""
    done = []
    dt = model.cfg.lm.dtype
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        key, layer = _adapter_key(name)
        node: Any = plora
        for k in key:
            node = node.get(k) if isinstance(node, Mapping) else None
        if not isinstance(node, Mapping) or "a" not in node:
            continue
        a, b = _f32(node["a"]), _f32(node["b"])
        if layer is not None:
            a, b = a[layer], b[layer]
        mod.set_plora_(a.to(mod.device, dt), b.to(mod.device, dt))
        done.append(name)
    return done


def _load_qformer(qf, p: Mapping[str, Any]) -> None:
    """vlrlhf_tpu's Q-Former tree (a list of heterogeneous layers, not a
    stacked one) into models/vision/qformer.py's modules."""
    _copy(qf.query_tokens, p["query_tokens"])
    emb = p["embeddings"]
    _copy(qf.word_embed, emb["word"]["embedding"])
    _copy(qf.pos_embed, emb["position"]["embedding"])
    _norm(qf.emb_ln, emb["ln"])
    if len(p["layers"]) != len(qf.layers):
        raise ValueError(f"{len(p['layers'])} Q-Former layers for {len(qf.layers)}")
    for layer, lp in zip(qf.layers, p["layers"]):
        for name in ("self_attn", "cross_attn"):
            mod = getattr(layer, name)
            if (mod is None) != (name not in lp):
                raise ValueError(f"Q-Former {name} layout differs")
            if mod is not None:
                for w in ("wq", "wk", "wv", "wo"):
                    _linear(getattr(mod, w), lp[name][w])
                _norm(mod.ln, lp[name]["ln"])
        for name in ("ffn", "ffn_query"):
            mod = getattr(layer, name)
            _linear(mod.fc1, lp[name]["fc1"])
            _linear(mod.fc2, lp[name]["fc2"])
            _norm(mod.ln, lp[name]["ln"])


def _adapter_key(name: str) -> tuple[tuple[str, ...], Optional[int]]:
    """A Linear's key in a vlrlhf_tpu adapter tree and its layer index:
    "lm.layers.3.wq" -> (("lm", "layers_scanned", "attn", "wq"), 3)."""
    path = module_path(name)[: -len("/kernel")].split("/")
    if len(path) > 2 and path[1] == "layers":
        return (path[0], "layers_scanned", *path[3:]), int(path[2])
    return tuple(path), None


def adapter_keys(adapters: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A vlrlhf_tpu adapter tree as {JAX-layout key: f32 tensor}, the
    per-layer keys of the port's checkpoints: ("lm", "layers_scanned",
    "attn", "wq", "a") (L, in, r) -> "lm/layers/<i>/attn/wq/a" (in, r)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),))
            return
        arr = _f32(node)
        if "layers_scanned" in path:
            j = path.index("layers_scanned")
            for i in range(arr.shape[0]):
                out["/".join(path[:j] + ("layers", str(i)) + path[j + 1:])] = arr[i].clone()
        else:
            out["/".join(path)] = arr

    walk(adapters, ())
    return out


def load_lora_params(model: nn.Module,
                     adapters: Union[Mapping[str, Any], Sequence[Mapping[str, Any]]],
                     adapter_set: str = "") -> list[str]:
    """Attach (or overwrite) f32 adapters from a vlrlhf_tpu adapter tree
    (init_lora's output, numpy leaves), as the named set `adapter_set` when
    given; from a list of trees, hold them as stacked sets for
    multi-adapter serving (the set index is the list index; every other
    Linear's adapter is dropped). Returns the adapted module names."""
    if not isinstance(adapters, Mapping):
        return set_adapters_(model, stack_adapter_sets([adapter_keys(t) for t in adapters]))
    done = []
    for name, mod in model.named_modules():
        if not isinstance(mod, Linear):
            continue
        key, layer = _adapter_key(name)
        node: Any = adapters
        for k in key:
            node = node.get(k) if isinstance(node, Mapping) else None
        if not isinstance(node, Mapping) or "a" not in node:
            continue
        a, b = np.asarray(node["a"], np.float32), np.asarray(node["b"], np.float32)
        if layer is not None:
            a, b = a[layer], b[layer]
        dev = mod.device
        if a.shape != (mod.d_in, b.shape[0]) or b.shape[1] != mod.d_out:
            raise ValueError(f"{name}: adapter {a.shape} {b.shape} does not fit "
                             f"({mod.d_out}, {mod.d_in})")
        mod.set_adapter_pair(adapter_set, nn.Parameter(torch.tensor(a, device=dev)),
                             nn.Parameter(torch.tensor(b, device=dev)))
        done.append(name)
    return done


def lora_tree(model: nn.Module, grads: bool = False, adapter_set: str = "") -> dict:
    """The port's adapters (or, with grads=True, their .grad) as a numpy
    tree with vlrlhf_tpu's structure: per-layer pairs stacked under
    "layers_scanned". `adapter_set` picks a named set."""
    stacked: dict = {}
    for name, mod in model.named_modules():
        pair = mod.adapter_pair(adapter_set) if isinstance(mod, Linear) else None
        if pair is None:
            continue
        key, layer = _adapter_key(name)
        for leaf, p in zip(("a", "b"), pair):
            t = p.grad if grads else p
            arr = np.zeros(tuple(p.shape), np.float32) if t is None else t.detach().float().cpu().numpy()
            stacked.setdefault(key + (leaf,), {})[layer] = arr
    tree: dict = {}
    for key, by_layer in stacked.items():
        node = tree
        for k in key[:-1]:
            node = node.setdefault(k, {})
        node[key[-1]] = (by_layer[None] if None in by_layer
                         else np.stack([by_layer[i] for i in sorted(by_layer)]))
    return tree


def _torch_dtype(dt) -> torch.dtype:
    name = getattr(dt, "__name__", None) or str(np.dtype(dt))
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def vlm_config_from(src) -> C.VLMConfig:
    """The port's VLMConfig for a vlrlhf_tpu VLMConfig (read by attribute
    name, so this module needs no jax import); dtypes map by name. Every
    GELU is the tanh form vlrlhf_tpu computes (jax.nn.gelu's default): the
    tower's "gelu" and the projector's and Q-Former's defaults."""

    def conv(cls, obj):
        kw = {}
        for f in dataclasses.fields(cls):
            if hasattr(obj, f.name):
                v = getattr(obj, f.name)
                kw[f.name] = _torch_dtype(v) if f.name == "dtype" else v
        return cls(**kw)

    qf = getattr(src, "qformer", None)
    vision = conv(C.ViTConfig, src.vision)
    if vision.act == "gelu":  # jax.nn.gelu's default: the tanh form
        vision = dataclasses.replace(vision, act=GELU_TANH)
    return C.VLMConfig(
        lm=conv(C.LMConfig, src.lm),
        vision=vision,
        projector=conv(C.ProjectorConfig, src.projector),
        image_token_id=src.image_token_id,
        num_image_tokens=src.num_image_tokens,
        qformer=None if qf is None else conv(C.QFormerConfig, qf),
        plora=bool(getattr(src, "plora", False)),
        family=src.family,
        grid_pinpoints=tuple(tuple(p) for p in getattr(src, "grid_pinpoints", ())),
        image_mean=tuple(src.image_mean),
        image_std=tuple(src.image_std),
    )
