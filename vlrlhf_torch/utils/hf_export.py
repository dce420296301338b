"""Export the port's weights of any of the five families as an HF
checkpoint (vlrlhf_tpu/utils/hf_export.py: `_ln`, `_linear`,
`export_llama_lm`, `export_clip_vit`, `export_llava` (with
`image_newline`), `export_qwen_lm`, `export_qwen_visual`, `export_qwen_vl`,
`export_internlm2_lm`, `export_internlm_xc2`, `export_xc2_plora`,
`export_instructblip_vit`, `export_qformer`, `export_instructblip`,
`save_hf_checkpoint`, `export_hf` and `ARCHITECTURES`). XC2's PLoRA leaves
(`plora_a` / `plora_b`, kept apart from the merged weights) go out as its
Plora_A / Plora_B weights, as vlrlhf_tpu's export_hf(plora_adapters=...)
writes them.

The input is a state dict keyed by the port's parameter names (a model's
`state_dict()`, or `lora.merge_lora`'s merged one); each exporter inverts
its importer in utils/hf_port.py (the same name tables), so
import(export(x)) is x bit for bit. Keys follow the 4.41-era llava layout
(language_model.model.*), as vlrlhf_tpu writes it. A quantized linear
(int8 or int4 codes) is refused: dequantize it first (ops/quant.py
dequantize_params), as a merged save over a QLoRA base does.

`save_hf_checkpoint` writes one model.safetensors through
utils/safetensors_io.py, the config.json (the source checkpoint's with
`architectures` and `torch_dtype` set, or a minimal one) and the source's
tokenizer / processor files beside it (InstructBLIP's qformer_tokenizer/
directory too).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Mapping, Optional

import torch

from vlrlhf_torch.utils.hf_port import (
    CLIP_LINEARS, CLIP_NORMS, EVA_LINEARS, EVA_NORMS, INTERNLM2_LINEARS, INTERNLM2_NORMS,
    LLAMA_LINEARS, LLAMA_NORMS, LLAVA_PROJECTOR, QFORMER_ATTNS, QFORMER_BERT, QFORMER_FFNS,
    QFORMER_TOKENIZER_DIR, QWEN_LINEARS, QWEN_NORMS, QWEN_VIS_LINEARS, QWEN_VIS_NORMS,
    XC2_PROJECTOR, conv_from_patch,
)
from vlrlhf_torch.utils.safetensors_io import save_file

StateDict = Mapping[str, torch.Tensor]


class _SD(dict):
    """state_dict builder that rejects accidental double-writes."""

    def put(self, key: str, value: torch.Tensor) -> None:
        if key in self:
            raise ValueError(f"duplicate export key {key}")
        self[key] = value


def _get(src: StateDict, key: str) -> torch.Tensor:
    if key not in src:
        stem = key.rsplit(".", 1)[0]
        if f"{stem}.weight_q" in src or f"{stem}.weight_q4" in src:
            raise ValueError(f"{stem} is quantized: dequantize it before the export "
                             "(ops/quant.py dequantize_params)")
        raise KeyError(f"the state dict has no {key!r}")
    return src[key]


def _linear(sd: _SD, prefix: str, src: StateDict, ours: str) -> None:
    """weight (out, in) as HF holds it, and the bias if any."""
    sd.put(f"{prefix}.weight", _get(src, f"{ours}.weight"))
    if f"{ours}.bias" in src:
        sd.put(f"{prefix}.bias", src[f"{ours}.bias"])


_ln = _linear  # a norm's weight and bias go out as a linear's do


def _n_layers(src: StateDict, prefix: str) -> int:
    return len({k.split(".")[2] for k in src if k.startswith(f"{prefix}.layers.")})


def export_llama_lm(src: StateDict, sd: _SD, prefix: str = "model") -> None:
    """Inverse of hf_port.port_llama_lm (the port's `lm.*` keys)."""
    sd.put(f"{prefix}.embed_tokens.weight", _get(src, "lm.embed_tokens"))
    for i in range(_n_layers(src, "lm")):
        ours, theirs = f"lm.layers.{i}", f"{prefix}.layers.{i}"
        for o, t in LLAMA_NORMS:
            _ln(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
        for o, t in LLAMA_LINEARS:
            _linear(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
    _ln(sd, f"{prefix}.norm", src, "lm.norm")
    if any(k.startswith("lm.lm_head.") for k in src):
        head = prefix.rsplit(".", 1)[0] if prefix.endswith(".model") else ""
        _linear(sd, f"{head}.lm_head" if head else "lm_head", src, "lm.lm_head")


def export_clip_vit(src: StateDict, sd: _SD, prefix: str, patch: int) -> None:
    """Inverse of hf_port.port_clip_vit (the port's `vision.*` keys)."""
    emb = f"{prefix}.embeddings"
    sd.put(f"{emb}.patch_embedding.weight", conv_from_patch(_get(src, "vision.patch_weight"),
                                                            patch))
    if "vision.patch_bias" in src:
        sd.put(f"{emb}.patch_embedding.bias", src["vision.patch_bias"])
    sd.put(f"{emb}.position_embedding.weight", _get(src, "vision.pos_embed"))
    if "vision.cls_token" in src:
        sd.put(f"{emb}.class_embedding", src["vision.cls_token"])
    for i in range(_n_layers(src, "vision")):
        ours, theirs = f"vision.layers.{i}", f"{prefix}.encoder.layers.{i}"
        for o, t in CLIP_NORMS:
            _ln(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
        for o, t in CLIP_LINEARS:
            _linear(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
    if "vision.ln_pre.weight" in src:
        _ln(sd, f"{prefix}.pre_layrnorm", src, "vision.ln_pre")  # HF CLIP's (sic)
    if "vision.ln_post.weight" in src:
        _ln(sd, f"{prefix}.post_layernorm", src, "vision.ln_post")


def export_llava(src: StateDict, cfg) -> dict[str, torch.Tensor]:
    """The port's LLaVA / LLaVA-Next state dict -> HF
    LlavaForConditionalGeneration / LlavaNextForConditionalGeneration keys
    (vlrlhf_tpu's export_llava)."""
    sd = _SD()
    export_clip_vit(src, sd, "vision_tower.vision_model", cfg.vision.patch_size)
    for ours, theirs in LLAVA_PROJECTOR:
        _linear(sd, theirs, src, f"projector.{ours}")
    export_llama_lm(src, sd, "language_model.model")
    if "image_newline" in src:
        sd.put("image_newline", src["image_newline"])
    return dict(sd)


def export_qwen_lm(src: StateDict, sd: _SD, prefix: str = "transformer") -> None:
    """Inverse of hf_port.port_qwen_lm: wq / wk / wv (and biases) fused
    back into c_attn by blocks of rows."""
    sd.put(f"{prefix}.wte.weight", _get(src, "lm.embed_tokens"))
    for i in range(_n_layers(src, "lm")):
        ours, theirs = f"lm.layers.{i}", f"{prefix}.h.{i}"
        for o, t in QWEN_NORMS:
            _ln(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
        for leaf in ("weight", "bias"):
            sd.put(f"{theirs}.attn.c_attn.{leaf}", torch.cat(
                [_get(src, f"{ours}.{n}.{leaf}") for n in ("wq", "wk", "wv")], dim=0))
        for o, t in QWEN_LINEARS:
            _linear(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
    _ln(sd, f"{prefix}.ln_f", src, "lm.norm")
    _linear(sd, "lm_head", src, "lm.lm_head")


def export_qwen_visual(src: StateDict, sd: _SD, cfg, prefix: str = "transformer.visual") -> None:
    """Inverse of hf_port.port_qwen_visual: the tower's in_proj rows per
    head interleaved again, the resampler's in blocks, proj as (in, out)."""
    nh = cfg.vision.num_heads
    sd.put(f"{prefix}.conv1.weight", conv_from_patch(_get(src, "vision.patch_weight"),
                                                     cfg.vision.patch_size))
    sd.put(f"{prefix}.positional_embedding", _get(src, "vision.pos_embed"))
    _ln(sd, f"{prefix}.ln_pre", src, "vision.ln_pre")
    for i in range(_n_layers(src, "vision")):
        ours, theirs = f"vision.layers.{i}", f"{prefix}.transformer.resblocks.{i}"
        for o, t in QWEN_VIS_NORMS:
            _ln(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
        ws = [_get(src, f"{ours}.{n}.weight") for n in ("wq", "wk", "wv")]
        d, h = ws[0].shape
        sd.put(f"{theirs}.attn.in_proj.weight",
               torch.stack([w.reshape(nh, d // nh, h) for w in ws], dim=1).reshape(3 * d, h))
        bs = [_get(src, f"{ours}.{n}.bias") for n in ("wq", "wk", "wv")]
        sd.put(f"{theirs}.attn.in_proj.bias",
               torch.stack([b.reshape(nh, d // nh) for b in bs], dim=1).reshape(3 * d))
        for o, t in QWEN_VIS_LINEARS:
            _linear(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
    ap, r = f"{prefix}.attn_pool", "projector.resampler"
    sd.put(f"{ap}.query", _get(src, f"{r}.query"))
    sd.put(f"{ap}.pos_embed", _get(src, f"{r}.pos_embed"))
    _ln(sd, f"{ap}.ln_q", src, f"{r}.ln_q")
    _ln(sd, f"{ap}.ln_kv", src, f"{r}.ln_kv")
    if f"{r}.kv_proj.weight" in src:
        _linear(sd, f"{ap}.kv_proj", src, f"{r}.kv_proj")
    for leaf, hf in (("weight", "in_proj_weight"), ("bias", "in_proj_bias")):
        sd.put(f"{ap}.attn.{hf}", torch.cat(
            [_get(src, f"{r}.attn.{n}.{leaf}") for n in ("wq", "wk", "wv")], dim=0))
    _linear(sd, f"{ap}.attn.out_proj", src, f"{r}.attn.wo")
    _ln(sd, f"{prefix}.ln_post", src, "projector.ln_post")
    sd.put(f"{prefix}.proj", _get(src, "projector.proj.weight").t())


def export_qwen_vl(src: StateDict, cfg) -> dict[str, torch.Tensor]:
    """The port's Qwen-VL state dict -> HF QWenLMHeadModel keys."""
    sd = _SD()
    export_qwen_visual(src, sd, cfg)
    export_qwen_lm(src, sd)
    return dict(sd)


def _qkv_interleave(parts, nh: int, nkv: int, hd: int) -> torch.Tensor:
    """Inverse of hf_port._qkv_groups: [q rows, k rows, v rows] ->
    InternLM2's grouped-interleaved rows."""
    tail = parts[0].shape[-1]
    q = parts[0].reshape(nkv, nh // nkv, hd, tail)
    k = parts[1].reshape(nkv, 1, hd, tail)
    v = parts[2].reshape(nkv, 1, hd, tail)
    return torch.cat([q, k, v], dim=1).reshape(-1, tail)


def export_internlm2_lm(src: StateDict, sd: _SD, cfg, prefix: str = "model") -> None:
    """Inverse of hf_port.port_internlm2_lm."""
    lm = cfg.lm
    sd.put(f"{prefix}.tok_embeddings.weight", _get(src, "lm.embed_tokens"))
    for i in range(_n_layers(src, "lm")):
        ours, theirs = f"lm.layers.{i}", f"{prefix}.layers.{i}"
        for o, t in INTERNLM2_NORMS:
            _ln(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
        sd.put(f"{theirs}.attention.wqkv.weight", _qkv_interleave(
            [_get(src, f"{ours}.{n}.weight") for n in ("wq", "wk", "wv")],
            lm.num_heads, lm.num_kv_heads, lm.head_dim_))
        for o, t in INTERNLM2_LINEARS:
            _linear(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
    _ln(sd, f"{prefix}.norm", src, "lm.norm")
    _linear(sd, "output", src, "lm.lm_head")


def export_xc2_plora(src: StateDict, sd: _SD, cfg, prefix: str = "model") -> None:
    """Inverse of hf_port.port_xc2_plora: the PLoRA leaves as Plora_A /
    Plora_B weights; wqkv's A is wq's, its B re-interleaved by groups."""
    lm = cfg.lm
    for i in range(_n_layers(src, "lm")):
        ours, theirs = f"lm.layers.{i}", f"{prefix}.layers.{i}"
        if f"{ours}.wq.plora_a" not in src:
            continue
        sd.put(f"{theirs}.attention.wqkv.Plora_A.weight", src[f"{ours}.wq.plora_a"].t())
        sd.put(f"{theirs}.attention.wqkv.Plora_B.weight", _qkv_interleave(
            [src[f"{ours}.{n}.plora_b"].t() for n in ("wq", "wk", "wv")],
            lm.num_heads, lm.num_kv_heads, lm.head_dim_))
        for o, t in INTERNLM2_LINEARS:
            sd.put(f"{theirs}.{t}.Plora_A.weight", src[f"{ours}.{o}.plora_a"].t())
            sd.put(f"{theirs}.{t}.Plora_B.weight", src[f"{ours}.{o}.plora_b"].t())


def export_internlm_xc2(src: StateDict, cfg) -> dict[str, torch.Tensor]:
    """The port's XC2 state dict -> HF InternLMXComposer2ForCausalLM keys,
    its PLoRA included when the state dict holds it."""
    sd = _SD()
    export_clip_vit(src, sd, "vit.vision_tower.vision_model", cfg.vision.patch_size)
    for ours, theirs in XC2_PROJECTOR:
        _linear(sd, theirs, src, f"projector.{ours}")
    export_internlm2_lm(src, sd, cfg)
    export_xc2_plora(src, sd, cfg)
    return dict(sd)


def export_instructblip_vit(src: StateDict, sd: _SD, prefix: str, patch: int) -> None:
    """Inverse of hf_port.port_instructblip_vit: wq / wk / wv fused back
    into one qkv linear, the embeddings as raw Parameters."""
    emb = f"{prefix}.embeddings"
    sd.put(f"{emb}.patch_embedding.weight", conv_from_patch(_get(src, "vision.patch_weight"),
                                                            patch))
    sd.put(f"{emb}.patch_embedding.bias", _get(src, "vision.patch_bias"))
    sd.put(f"{emb}.position_embedding", _get(src, "vision.pos_embed")[None])
    sd.put(f"{emb}.class_embedding", _get(src, "vision.cls_token")[None, None])
    for i in range(_n_layers(src, "vision")):
        ours, theirs = f"vision.layers.{i}", f"{prefix}.encoder.layers.{i}"
        for o, t in EVA_NORMS:
            _ln(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
        for leaf in ("weight", "bias"):
            sd.put(f"{theirs}.self_attn.qkv.{leaf}", torch.cat(
                [_get(src, f"{ours}.{n}.{leaf}") for n in ("wq", "wk", "wv")], dim=0))
        for o, t in EVA_LINEARS:
            _linear(sd, f"{theirs}.{t}", src, f"{ours}.{o}")
    _ln(sd, f"{prefix}.post_layernorm", src, "vision.ln_post")


def export_qformer(src: StateDict, sd: _SD, prefix: str = "qformer") -> None:
    """Inverse of hf_port.port_qformer."""
    sd.put("query_tokens", _get(src, "qformer.query_tokens")[None])
    sd.put(f"{prefix}.embeddings.word_embeddings.weight", _get(src, "qformer.word_embed"))
    sd.put(f"{prefix}.embeddings.position_embeddings.weight", _get(src, "qformer.pos_embed"))
    _ln(sd, f"{prefix}.embeddings.layernorm", src, "qformer.emb_ln")
    for i in range(_n_layers(src, "qformer")):
        ours, theirs = f"qformer.layers.{i}", f"{prefix}.encoder.layer.{i}"
        for mod, att, out in QFORMER_ATTNS:
            if f"{ours}.{mod}.wq.weight" not in src:
                continue  # cross-attention every cross_attention_frequency layers
            for o, t in QFORMER_BERT:
                _linear(sd, f"{theirs}.{att}.{t}", src, f"{ours}.{mod}.{o}")
            _linear(sd, f"{theirs}.{out}.dense", src, f"{ours}.{mod}.wo")
            _ln(sd, f"{theirs}.{out}.LayerNorm", src, f"{ours}.{mod}.ln")
        for mod, fc1, fc2 in QFORMER_FFNS:
            _linear(sd, f"{theirs}.{fc1}.dense", src, f"{ours}.{mod}.fc1")
            _linear(sd, f"{theirs}.{fc2}.dense", src, f"{ours}.{mod}.fc2")
            _ln(sd, f"{theirs}.{fc2}.LayerNorm", src, f"{ours}.{mod}.ln")


def export_instructblip(src: StateDict, cfg) -> dict[str, torch.Tensor]:
    """The port's InstructBLIP state dict -> HF
    InstructBlipForConditionalGeneration keys (vlrlhf_tpu's
    export_instructblip)."""
    sd = _SD()
    export_instructblip_vit(src, sd, "vision_model", cfg.vision.patch_size)
    export_qformer(src, sd)
    _linear(sd, "language_projection", src, "projector.fc1")
    export_llama_lm(src, sd, "language_model.model")
    return dict(sd)


EXPORTERS = {"llava": export_llava, "llava_next_vicuna": export_llava,
             "llava_next_mistral": export_llava, "qwen_vl": export_qwen_vl,
             "internlm_xc2": export_internlm_xc2, "instructblip": export_instructblip}
ARCHITECTURES = {
    "llava": ["LlavaForConditionalGeneration"],
    "llava_next_vicuna": ["LlavaNextForConditionalGeneration"],
    "llava_next_mistral": ["LlavaNextForConditionalGeneration"],
    "qwen_vl": ["QWenLMHeadModel"],
    "internlm_xc2": ["InternLMXComposer2ForCausalLM"],
    "instructblip": ["InstructBlipForConditionalGeneration"],
}

# Files copied from the source checkpoint so the exported directory is a
# complete, loadable HF checkpoint (tokenizer, processor, generation config)
_SIDECAR_PATTERNS = (
    "tokenizer", "special_tokens", "preprocessor", "processor", "chat_template",
    "generation_config", "added_tokens", "vocab", "merges", "qwen.tiktoken",
)
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def save_hf_checkpoint(state_dict: StateDict, out_dir: str, family: str,
                       base_dir: Optional[str] = None, dtype: str = "bfloat16") -> int:
    """Write model.safetensors (floating tensors cast to `dtype`), the
    config.json and, from `base_dir`, the tokenizer and processor files.
    With a base_dir its config.json is copied with `architectures` and
    `torch_dtype` set (the reference's merge_peft_model.py); without one a
    minimal config.json is written. Returns the weights file's bytes."""
    os.makedirs(out_dir, exist_ok=True)
    nbytes = save_file(state_dict, os.path.join(out_dir, "model.safetensors"),
                       float_dtype=_DTYPES[dtype])
    config: dict = {"architectures": ARCHITECTURES[family], "torch_dtype": dtype}
    if base_dir and os.path.exists(os.path.join(base_dir, "config.json")):
        with open(os.path.join(base_dir, "config.json")) as f:
            config = json.load(f)
        config["architectures"] = ARCHITECTURES[family]
        config["torch_dtype"] = dtype
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(config, f, indent=2)
    if base_dir and os.path.isdir(base_dir):
        for name in os.listdir(base_dir):
            src = os.path.join(base_dir, name)
            if any(pat in name for pat in _SIDECAR_PATTERNS) and os.path.isfile(src):
                shutil.copy2(src, os.path.join(out_dir, name))
            elif name == QFORMER_TOKENIZER_DIR and os.path.isdir(src):
                shutil.copytree(src, os.path.join(out_dir, name), dirs_exist_ok=True)
    return nbytes


def export_hf(state_dict: StateDict, cfg, family: str, out_dir: str,
              base_dir: Optional[str] = None, dtype: str = "bfloat16") -> dict[str, torch.Tensor]:
    """State dict -> HF checkpoint directory; returns the HF-keyed dict."""
    sd = EXPORTERS[family](state_dict, cfg)
    save_hf_checkpoint(sd, out_dir, family, base_dir, dtype)
    return sd
