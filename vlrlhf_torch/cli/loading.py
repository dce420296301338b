"""Model bundle loading: an HF checkpoint directory -> (family, config,
model, processor) for any of the five families (vlrlhf_tpu/cli/loading.py
`config_from_hf`, `load_model_bundle`).

config.json gives the family (`architectures[0]`, models/config.py
`resolve_family`; LLaVA-Next's text model names vicuna or mistral) and the
geometry. A key the config leaves out takes the default of the
transformers config class that reads it (LlamaConfig / MistralConfig for
text_config, CLIPVisionConfig or InstructBlipVisionConfig for
vision_config, InstructBlipQFormerConfig for qformer_config), as
`from_pretrained` would: published configs write only the keys that
differ. The weights stream from the checkpoint into a model built on the
meta device (utils/hf_port.py), quantized on the way when asked, and the
processor runs on the checkpoint's tokenizer (data/tokenizer.py
`load_tokenizer`: tokenizer.json, a sentencepiece tokenizer.model, or
Qwen's qwen.tiktoken); InstructBLIP's Q-Former reads qformer_tokenizer/
tokenizer.json, and a checkpoint without one is refused (vlrlhf_tpu runs
its Q-Former without instructions then).

Qwen-VL (QWenLMHeadModel) reads its flat config: intermediate_size is
twice the MLP width, kv_channels the head width, seq_length the trained
context of QWen's own dynamic-NTK rope (`use_dynamic_ntk`) and of its
logn query scaling (`use_logn_attn`; both ops/rope.py, vlrlhf_tpu reads
HF-llama's NTK and no logn), `visual` the tower (nn.GELU: erf) and
resampler; its placeholder is the tokenizer-special <imgpad>
(image_start_id + 2). InternLM-XC2 keeps the family's tower and projector with
the config's LM geometry and `img_size`; its tokenizer gains <ImageHere>
as a special token, whose id becomes the image token id (it may equal the
LM's vocabulary size: embed clamps it, and its features overwrite it).

Every GELU takes the form config.json names (models/common.py
`activation`): `projector_hidden_act`, `vision_config.hidden_act`,
`qformer_config.hidden_act`, where "gelu" is the erf form (vlrlhf_tpu
computes jax.nn.gelu's tanh form everywhere). A Mistral text model's
`sliding_window` is read into LMConfig.sliding_window: set, every longer
sequence and KV cache is refused by name (the attention kernels hold no
window); null, as Mistral-7B-Instruct-v0.2 ships it, changes nothing.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence

import torch

from vlrlhf_torch.models.config import (
    LMConfig, ModelFamily, ProjectorConfig, QFormerConfig, ViTConfig, VLMConfig, resolve_family,
)

# transformers' LlamaConfig and CLIPVisionConfig defaults (the keys read here)
LLAMA_DEFAULTS = dict(
    vocab_size=32000, hidden_size=4096, intermediate_size=11008, num_hidden_layers=32,
    num_attention_heads=32, rope_theta=10000.0, max_position_embeddings=2048,
    rms_norm_eps=1e-6,
)
# MistralConfig's (LLaVA-Next mistral's text model)
MISTRAL_DEFAULTS = dict(
    LLAMA_DEFAULTS, intermediate_size=14336, num_key_value_heads=8,
    max_position_embeddings=4096 * 32,
)
CLIP_VISION_DEFAULTS = dict(
    hidden_size=768, intermediate_size=3072, num_hidden_layers=12, num_attention_heads=12,
    image_size=224, patch_size=32, hidden_act="quick_gelu", layer_norm_eps=1e-5,
)
# InstructBlipVisionConfig / InstructBlipQFormerConfig / InstructBlipConfig
EVA_VISION_DEFAULTS = dict(
    hidden_size=1408, intermediate_size=6144, num_hidden_layers=39, num_attention_heads=16,
    image_size=224, patch_size=14, hidden_act="gelu", layer_norm_eps=1e-6,
)
QFORMER_DEFAULTS = dict(
    vocab_size=30522, hidden_size=768, num_hidden_layers=12, num_attention_heads=12,
    intermediate_size=3072, cross_attention_frequency=2, encoder_hidden_size=1408,
    max_position_embeddings=512, layer_norm_eps=1e-12, hidden_act="gelu",
)


def _llama_lm_from_hf(tc: dict, dtype) -> LMConfig:
    tc = {**(MISTRAL_DEFAULTS if tc.get("model_type") == "mistral" else LLAMA_DEFAULTS), **tc}
    if tc.get("rope_scaling"):
        raise ValueError(f"text_config rope_scaling {tc['rope_scaling']} is not ported")
    head_dim = tc.get("head_dim") or 0
    if head_dim == tc["hidden_size"] // tc["num_attention_heads"]:
        head_dim = 0  # the LMConfig default: hidden_size // num_heads
    return LMConfig(
        vocab_size=tc["vocab_size"],
        hidden_size=tc["hidden_size"],
        intermediate_size=tc["intermediate_size"],
        num_layers=tc["num_hidden_layers"],
        num_heads=tc["num_attention_heads"],
        num_kv_heads=tc.get("num_key_value_heads") or tc["num_attention_heads"],
        head_dim=head_dim,
        rope_base=tc["rope_theta"],
        max_position_embeddings=tc["max_position_embeddings"],
        rms_eps=tc["rms_norm_eps"],
        tie_embeddings=bool(tc.get("tie_word_embeddings", False)),
        sliding_window=tc.get("sliding_window"),
        dtype=dtype,
    )


def _clip_vit_from_hf(vc: dict, dtype, feature_layer: int = -2) -> ViTConfig:
    vc = {**CLIP_VISION_DEFAULTS, **vc}
    return ViTConfig(
        image_size=vc["image_size"],
        patch_size=vc["patch_size"],
        hidden_size=vc["hidden_size"],
        num_layers=vc["num_hidden_layers"],
        num_heads=vc["num_attention_heads"],
        mlp_dim=vc["intermediate_size"],
        act=vc["hidden_act"],
        feature_layer=feature_layer,
        drop_class_token=True,
        ln_eps=vc["layer_norm_eps"],
        dtype=dtype,
    )


def _instructblip_from_hf(hf: dict, family: ModelFamily, dtype) -> VLMConfig:
    """vlrlhf_tpu/cli/loading.py:145-180: the EVA tower (no pre-norm, a
    post norm, a patch bias, the class token kept), the Q-Former and the
    linear language projection."""
    tc = hf.get("text_config") or {}
    vc = {**EVA_VISION_DEFAULTS, **(hf.get("vision_config") or {})}
    qc = {**QFORMER_DEFAULTS, **(hf.get("qformer_config") or {})}
    n_query = hf.get("num_query_tokens") or 32
    return VLMConfig(
        lm=_llama_lm_from_hf(tc, dtype),
        vision=ViTConfig(
            image_size=vc["image_size"], patch_size=vc["patch_size"],
            hidden_size=vc["hidden_size"], num_layers=vc["num_hidden_layers"],
            num_heads=vc["num_attention_heads"], mlp_dim=vc["intermediate_size"],
            act=vc["hidden_act"], use_pre_norm=False, use_post_norm=True, patch_bias=True,
            ln_eps=vc["layer_norm_eps"], dtype=dtype,
        ),
        projector=ProjectorConfig(kind="linear", in_dim=qc["hidden_size"],
                                  out_dim={**LLAMA_DEFAULTS, **tc}["hidden_size"]),
        qformer=QFormerConfig(
            vocab_size=qc["vocab_size"], hidden_size=qc["hidden_size"],
            num_layers=qc["num_hidden_layers"], num_heads=qc["num_attention_heads"],
            intermediate_size=qc["intermediate_size"], encoder_hidden_size=vc["hidden_size"],
            num_query_tokens=n_query, cross_attention_frequency=qc["cross_attention_frequency"],
            max_position_embeddings=qc["max_position_embeddings"], ln_eps=qc["layer_norm_eps"],
            act=qc["hidden_act"], dtype=dtype,
        ),
        image_token_id=hf.get("image_token_index") or 32000,
        num_image_tokens=n_query,
        family=family.name,
    )


def _qwen_vl_from_hf(hf: dict, dtype) -> VLMConfig:
    """vlrlhf_tpu/cli/loading.py:92-134."""
    vis = hf["visual"]
    return VLMConfig(
        lm=LMConfig(
            vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"] // 2,
            num_layers=hf["num_hidden_layers"], num_heads=hf["num_attention_heads"],
            num_kv_heads=hf["num_attention_heads"], head_dim=hf.get("kv_channels", 128),
            qkv_bias=True, rope_base=hf.get("rotary_emb_base", 10000.0),
            rope_scaling_type="qwen_dynamic" if hf.get("use_dynamic_ntk") else "none",
            logn_attn=bool(hf.get("use_logn_attn", False)),
            max_position_embeddings=hf.get("seq_length", 8192),
            rms_eps=hf.get("layer_norm_epsilon", 1e-6), dtype=dtype,
        ),
        vision=ViTConfig(
            image_size=vis["image_size"], patch_size=vis["patch_size"],
            hidden_size=vis["width"], num_layers=vis["layers"], num_heads=vis["heads"],
            mlp_dim=int(vis["width"] * vis["mlp_ratio"]), act=vis.get("hidden_act", "gelu"),
            use_class_token=False,
            use_pre_norm=True, use_post_norm=False, ln_eps=1e-6, dtype=dtype,
        ),
        projector=ProjectorConfig(
            kind="resampler", in_dim=vis["width"], out_dim=vis["output_dim"],
            num_queries=vis.get("n_queries", 256), num_heads=max(vis["output_dim"] // 128, 1),
        ),
        image_token_id=vis.get("image_start_id", 151857) + 2,  # <imgpad>
        num_image_tokens=vis.get("n_queries", 256),
        family="qwen_vl",
    )


def _xc2_from_hf(hf: dict, family: ModelFamily, dtype) -> VLMConfig:
    """vlrlhf_tpu/cli/loading.py:135-145: the family's tower (at the
    config's img_size) and projector, the LM from the config."""
    import dataclasses

    base = family.make_config(dtype)
    img_size = hf.get("img_size", base.vision.image_size)
    return dataclasses.replace(
        base, lm=_llama_lm_from_hf(hf, dtype),
        vision=dataclasses.replace(base.vision, image_size=img_size),
        # XC2's vision_proj is nn.Sequential(Linear, nn.GELU(), Linear): erf
        projector=dataclasses.replace(base.projector,
                                      act=hf.get("projector_hidden_act", "gelu")),
        num_image_tokens=(img_size // base.vision.patch_size) ** 2,
    )


def config_from_hf(hf: dict, dtype=torch.bfloat16) -> tuple[ModelFamily, VLMConfig]:
    """The family and VLMConfig of an HF config.json."""
    arch = hf["architectures"][0]
    tc = hf.get("text_config") or {}
    family = resolve_family(arch, tc.get("_name_or_path", "") or tc.get("model_type", ""))
    if family.name == "qwen_vl":
        return family, _qwen_vl_from_hf(hf, dtype)
    if family.name == "internlm_xc2":
        return family, _xc2_from_hf(hf, family, dtype)
    if tc.get("model_type", "llama") not in ("llama", "mistral"):
        raise ValueError(f"text model {tc['model_type']!r}: the llava-layout families read "
                         "llama or mistral text models, as vlrlhf_tpu's do")
    if family.name == "instructblip":
        return family, _instructblip_from_hf(hf, family, dtype)
    if hf.get("vision_feature_select_strategy", "default") != "default":
        raise ValueError("vision_feature_select_strategy "
                         f"{hf['vision_feature_select_strategy']!r} is not ported (only "
                         "'default', which drops the class token)")
    vc = {**CLIP_VISION_DEFAULTS, **(hf.get("vision_config") or {})}
    cfg = VLMConfig(
        lm=_llama_lm_from_hf(tc, dtype),
        vision=_clip_vit_from_hf(vc, dtype, feature_layer=hf.get("vision_feature_layer", -2)),
        projector=ProjectorConfig(kind="mlp2x_gelu", in_dim=vc["hidden_size"],
                                  out_dim={**LLAMA_DEFAULTS, **tc}["hidden_size"],
                                  act=hf.get("projector_hidden_act", "gelu")),
        image_token_id=hf.get("image_token_index", 32000),
        num_image_tokens=(vc["image_size"] // vc["patch_size"]) ** 2,
        family=family.name,
        grid_pinpoints=(tuple(tuple(p) for p in hf.get("image_grid_pinpoints") or ())
                        if family.name.startswith("llava_next") else ()),
    )
    if family.name.startswith("llava_next") and not cfg.grid_pinpoints:
        raise ValueError("a LLaVA-Next config.json needs image_grid_pinpoints")
    return family, cfg


def make_processor(family: ModelFamily, tokenizer, cfg: VLMConfig, qformer_tokenizer=None,
                   **overrides):
    """The family's VLProcessor over `tokenizer` (and InstructBLIP's
    `qformer_tokenizer`), its placeholder count and id taken from the
    checkpoint's config (vlrlhf_tpu keeps the family defaults, which are
    the 7B checkpoints')."""
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor

    pcfg = ProcessorConfig(**{**family.processor_defaults,
                              "num_image_tokens": cfg.num_image_tokens,
                              "image_token_id": cfg.image_token_id, **overrides})
    return VLProcessor(tokenizer, family.template, pcfg, qformer_tokenizer)


def load_qformer_tokenizer(path: str):
    """InstructBLIP's Q-Former tokenizer, <path>/qformer_tokenizer/ (a BERT
    tokenizer.json). Missing, it is an error: vlrlhf_tpu swallows it and
    runs the Q-Former without the instruction, a different model."""
    from vlrlhf_torch.data.tokenizer import JsonTokenizer
    from vlrlhf_torch.utils.hf_port import QFORMER_TOKENIZER_DIR

    qdir = os.path.join(path, QFORMER_TOKENIZER_DIR)
    if not os.path.exists(os.path.join(qdir, "tokenizer.json")):
        raise FileNotFoundError(
            f"{path}: an InstructBLIP checkpoint needs its Q-Former tokenizer at "
            f"{QFORMER_TOKENIZER_DIR}/tokenizer.json (the Q-Former reads each prompt through it)")
    return JsonTokenizer(qdir)


def load_model_bundle(
    path: str,
    dtype=torch.bfloat16,
    max_length: int = 1024,
    max_prompt_length: int = 512,
    quantize_patterns: Optional[Sequence[str]] = None,
    quantize_bits: int = 8,
    device="cuda",
    remat_policy: str = "",
):
    """Config, weights, tokenizer and processor of a checkpoint directory,
    the model on `device`. quantize_patterns (ops/quant.py pattern tuples)
    quantizes the matching linears to int8 or, with quantize_bits=4, int4
    while they stream in, so the device never holds their bf16 weights
    (the same codes as quantizing after the load: tests/
    test_torch_hf_import.py). remat_policy ('' keeps the default) sets the
    LM's training remat policy."""
    import dataclasses

    from vlrlhf_torch.data.tokenizer import load_tokenizer
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.hf_port import PORTERS, open_hf_state_dict

    with open(os.path.join(path, "config.json")) as f:
        hf = json.load(f)
    family, cfg = config_from_hf(hf, dtype)
    window = cfg.lm.sliding_window
    if window and max_length > window:
        raise ValueError(f"{path}: --max_length {max_length} is longer than the text model's "
                         f"sliding_window {window}: windowed attention is not ported (the "
                         "kernels attend every earlier token)")
    if remat_policy:
        cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, remat_policy=remat_policy))
    tokenizer = load_tokenizer(path)  # before the weights: a refusal costs no load
    qtok = load_qformer_tokenizer(path) if cfg.qformer is not None else None
    overrides: dict = {}
    if family.name == "qwen_vl":
        # the placeholder must be one tokenizer-special id for
        # expand_image_tokens to find; "Picture 1: ...\n" is the processor's
        overrides["image_token"] = "<imgpad>"
    if family.name == "internlm_xc2":
        cfg = dataclasses.replace(cfg, image_token_id=tokenizer.add_special_token("<ImageHere>"))
    model = VLM(cfg, device="meta")
    PORTERS[family.name](open_hf_state_dict(path), model, device,
                         quantize=quantize_patterns or (), bits=quantize_bits)
    processor = make_processor(family, tokenizer, cfg, qtok, max_length=max_length,
                               max_prompt_length=max_prompt_length, **overrides)
    return family, cfg, model, processor
