"""A seeded stand-in for a downloaded checkpoint of any of the five
families, for machines that cannot download one: a config.json in the
layout of the published one (llava-hf/llava-1.5-7b-hf,
llava-hf/llava-v1.6-{vicuna,mistral}-7b-hf, Qwen/Qwen-VL-Chat,
internlm/internlm-xcomposer2-vl-7b, Salesforce/instructblip-vicuna-7b)
with the model's geometry written out, a tokenizer generated from a seed
(a llama-layout tokenizer.json; Qwen-VL's qwen.tiktoken; XC2's
sentencepiece tokenizer.model; for InstructBLIP also a BERT WordPiece
qformer_tokenizer/), and weights written by utils/hf_export.py. The import
path (cli/loading.py) reads such a directory exactly as it reads a real
one; chip_smoke.py and the tests use it.

`write_qwen_tiktoken` writes the full 151,643 mergeable ranks (the 256
bytes, every 2-byte pair, then 3-byte tokens), so Qwen's special tokens sit
on their published ids (<|im_start|> 151644, <img> 151857, <imgpad>
151859). `sentencepiece_model` writes a BPE ModelProto by hand (no
protobuf): llama's pieces and merges with scores that order them, and for
XC2 92,544 pieces whose last six are the user-defined [UNUSED_TOKEN_141]
... [UNUSED_TOKEN_146] (146 = 92543, InternLM2's <|im_start|>).

The tokenizer follows llama's layout: <unk> 0, <s> 1, </s> 2, the 256
byte-fallback tokens <0x00>..<0xFF>, the single characters, then BPE
pieces up to `vocab_size` (32000), and the added tokens <image> 32000 and
<pad> 32001. Its merges first build a list of common English words letter
by letter (so text tokenizes into word pieces, as it would with a trained
vocabulary), then join random pairs of pieces of up to 4 characters until
the vocabulary is full.
`layout` picks the older normalizer (Prepend + Replace) or the newer
Metaspace pre-tokenizer (prepend_scheme "first").
"""

from __future__ import annotations

import json
import os
import string
from typing import Mapping

import numpy as np

# llava-hf/llava-1.5-7b-hf config.json as published (keys it leaves out take
# transformers' LlamaConfig / CLIPVisionConfig defaults)
LLAVA_15_7B_CONFIG = {
    "architectures": ["LlavaForConditionalGeneration"],
    "ignore_index": -100,
    "image_token_index": 32000,
    "model_type": "llava",
    "pad_token_id": 32001,
    "projector_hidden_act": "gelu",
    "text_config": {
        "_name_or_path": "lmsys/vicuna-7b-v1.5",
        "architectures": ["LlamaForCausalLM"],
        "max_position_embeddings": 4096,
        "model_type": "llama",
        "rms_norm_eps": 1e-05,
        "torch_dtype": "float16",
        "vocab_size": 32064,
    },
    "tie_word_embeddings": False,
    "torch_dtype": "float16",
    "vision_config": {
        "hidden_size": 1024,
        "image_size": 336,
        "intermediate_size": 4096,
        "model_type": "clip_vision_model",
        "num_attention_heads": 16,
        "num_hidden_layers": 24,
        "patch_size": 14,
        "projection_dim": 768,
        "vocab_size": 32000,
    },
    "vision_feature_layer": -2,
    "vision_feature_select_strategy": "default",
    "vocab_size": 32064,
}

_WORDS = (
    "the of and to a in is that it for on with as was be by this are at from or an have "
    "not but what all were when we there can which their if do will each about how up out "
    "them then she many some so these would other into has more her two like him see time "
    "could no make than first been its who now people my made over did down only way find "
    "use may water long little very after words called just where most know get through "
    "back much before go good new write our used me man too any day same right look think "
    "also around another came come work three word must because does part even place well "
    "such here take why help put different away again off went old number image picture "
    "photo show shown describe detail answer question color left right person people "
    "animal table street white black red blue green yellow dog cat car sitting standing "
    "holding wearing front background USER ASSISTANT yes no there two three large small"
).split()


def llava_config(cfg) -> dict:
    """The published LLaVA-1.5-7B config.json with `cfg`'s geometry written
    out key by key (so a narrower or shallower model round-trips too)."""
    out = json.loads(json.dumps(LLAVA_15_7B_CONFIG))
    lm, vis = cfg.lm, cfg.vision
    out["text_config"].update(
        vocab_size=lm.vocab_size, hidden_size=lm.hidden_size,
        intermediate_size=lm.intermediate_size, num_hidden_layers=lm.num_layers,
        num_attention_heads=lm.num_heads, num_key_value_heads=lm.num_kv_heads,
        max_position_embeddings=lm.max_position_embeddings, rms_norm_eps=lm.rms_eps,
        rope_theta=lm.rope_base)
    out["vision_config"].update(
        hidden_size=vis.hidden_size, image_size=vis.image_size, intermediate_size=vis.mlp_dim,
        num_attention_heads=vis.num_heads, num_hidden_layers=vis.num_layers,
        patch_size=vis.patch_size, hidden_act=vis.act, layer_norm_eps=vis.ln_eps)
    out.update(image_token_index=cfg.image_token_id, vocab_size=lm.vocab_size,
               vision_feature_layer=vis.feature_layer, projector_hidden_act=cfg.projector.act)
    return out


def llava_next_config(cfg) -> dict:
    """A LlavaNextForConditionalGeneration config.json with `cfg`'s geometry
    and grid pinpoints; the text model is named after the family's
    (vicuna or mistral), which is how the family is told apart."""
    out = llava_config(cfg)
    mistral = cfg.family == "llava_next_mistral"
    out.update(architectures=["LlavaNextForConditionalGeneration"], model_type="llava_next",
               image_grid_pinpoints=[list(p) for p in cfg.grid_pinpoints],
               use_image_newline_parameter=True)
    out["text_config"].update(
        _name_or_path=("mistralai/Mistral-7B-Instruct-v0.2" if mistral
                       else "lmsys/vicuna-7b-v1.5"),
        architectures=["MistralForCausalLM" if mistral else "LlamaForCausalLM"],
        model_type="mistral" if mistral else "llama")
    if mistral:
        out["text_config"]["sliding_window"] = cfg.lm.sliding_window
    return out


def instructblip_config(cfg) -> dict:
    """An InstructBlipForConditionalGeneration config.json (the layout of
    Salesforce/instructblip-vicuna-7b's) with `cfg`'s geometry."""
    lm, vis, qf = cfg.lm, cfg.vision, cfg.qformer
    return {
        "architectures": ["InstructBlipForConditionalGeneration"],
        "initializer_factor": 1.0, "initializer_range": 0.02,
        "model_type": "instructblip",
        "num_query_tokens": qf.num_query_tokens,
        "image_token_index": cfg.image_token_id,
        "text_config": {
            "_name_or_path": "lmsys/vicuna-7b-v1.1", "architectures": ["LlamaForCausalLM"],
            "model_type": "llama", "vocab_size": lm.vocab_size, "hidden_size": lm.hidden_size,
            "intermediate_size": lm.intermediate_size, "num_hidden_layers": lm.num_layers,
            "num_attention_heads": lm.num_heads, "num_key_value_heads": lm.num_kv_heads,
            "max_position_embeddings": lm.max_position_embeddings,
            "rms_norm_eps": lm.rms_eps, "rope_theta": lm.rope_base,
            "pad_token_id": 0, "bos_token_id": 1, "eos_token_id": 2,
        },
        "vision_config": {
            "model_type": "instructblip_vision_model", "hidden_size": vis.hidden_size,
            "intermediate_size": vis.mlp_dim, "num_hidden_layers": vis.num_layers,
            "num_attention_heads": vis.num_heads, "image_size": vis.image_size,
            "patch_size": vis.patch_size, "hidden_act": vis.act, "layer_norm_eps": vis.ln_eps,
            "qkv_bias": True,
        },
        "qformer_config": {
            "model_type": "instructblip_qformer", "vocab_size": qf.vocab_size,
            "hidden_size": qf.hidden_size, "num_hidden_layers": qf.num_layers,
            "num_attention_heads": qf.num_heads, "intermediate_size": qf.intermediate_size,
            "cross_attention_frequency": qf.cross_attention_frequency,
            "encoder_hidden_size": qf.encoder_hidden_size,
            "max_position_embeddings": qf.max_position_embeddings,
            "layer_norm_eps": qf.ln_eps, "hidden_act": qf.act,
        },
        "tie_word_embeddings": False,
        "use_decoder_only_language_model": True,
    }


# Qwen/Qwen-VL-Chat config.json as published (the geometry is rewritten)
QWEN_VL_CHAT_CONFIG = {
    "architectures": ["QWenLMHeadModel"],
    "attn_dropout_prob": 0.0, "bf16": True, "emb_dropout_prob": 0.0,
    "hidden_size": 4096, "initializer_range": 0.02, "intermediate_size": 22016,
    "kv_channels": 128, "layer_norm_epsilon": 1e-06, "max_position_embeddings": 8192,
    "model_type": "qwen", "no_bias": True, "num_attention_heads": 32,
    "num_hidden_layers": 32, "onnx_safe": None, "rotary_emb_base": 10000,
    "rotary_pct": 1.0, "scale_attn_weights": True, "seq_length": 2048,
    "tie_word_embeddings": False, "tokenizer_type": "QWenTokenizer",
    "use_cache": True, "use_dynamic_ntk": True, "use_flash_attn": False,
    "use_logn_attn": True, "vocab_size": 151936,
    "visual": {"heads": 16, "image_size": 448, "image_start_id": 151857, "layers": 48,
               "mlp_ratio": 4.9231, "output_dim": 4096, "patch_size": 14, "width": 1664},
}
# internlm/internlm-xcomposer2-vl-7b config.json as published
XC2_7B_CONFIG = {
    "architectures": ["InternLMXComposer2ForCausalLM"],
    "bias": False, "bos_token_id": 1, "eos_token_id": 2, "hidden_act": "silu",
    "hidden_size": 4096, "img_size": 490, "initializer_range": 0.02,
    "intermediate_size": 14336, "max_length": 4096, "max_position_embeddings": 32768,
    "model_type": "internlmxcomposer2", "num_attention_heads": 32,
    "num_hidden_layers": 32, "num_key_value_heads": 8, "pad_token_id": 2,
    "rms_norm_eps": 1e-05, "rope_scaling": None, "rope_theta": 1000000,
    "tie_word_embeddings": False, "torch_dtype": "bfloat16", "use_cache": True,
    "vocab_size": 92544,
}


def qwen_vl_config(cfg) -> dict:
    """The published Qwen-VL-Chat config.json with `cfg`'s geometry; QWen's
    intermediate_size is twice the MLP width (w1 and w2 together), its
    visual mlp_ratio gives the tower's MLP width by int(width * ratio)."""
    import math

    lm, vis = cfg.lm, cfg.vision
    out = json.loads(json.dumps(QWEN_VL_CHAT_CONFIG))
    ratio = math.ceil(vis.mlp_dim / vis.hidden_size * 1e4) / 1e4
    if int(vis.hidden_size * ratio) != vis.mlp_dim:
        raise ValueError(f"no 4-digit mlp_ratio gives {vis.mlp_dim} from {vis.hidden_size}")
    out.update(hidden_size=lm.hidden_size, intermediate_size=2 * lm.intermediate_size,
               kv_channels=lm.head_dim_, layer_norm_epsilon=lm.rms_eps,
               num_attention_heads=lm.num_heads, num_hidden_layers=lm.num_layers,
               rotary_emb_base=lm.rope_base, seq_length=lm.max_position_embeddings,
               use_dynamic_ntk=lm.rope_scaling_type in ("dynamic", "qwen_dynamic"),
               use_logn_attn=lm.logn_attn, vocab_size=lm.vocab_size)
    out["visual"].update(heads=vis.num_heads, image_size=vis.image_size,
                         image_start_id=cfg.image_token_id - 2, layers=vis.num_layers,
                         mlp_ratio=ratio, output_dim=cfg.projector.out_dim,
                         patch_size=vis.patch_size, width=vis.hidden_size,
                         n_queries=cfg.projector.num_queries, hidden_act=vis.act)
    return out


def xc2_config(cfg) -> dict:
    """The published XComposer2-VL-7B config.json with `cfg`'s geometry."""
    lm = cfg.lm
    out = json.loads(json.dumps(XC2_7B_CONFIG))
    out.update(hidden_size=lm.hidden_size, img_size=cfg.vision.image_size,
               intermediate_size=lm.intermediate_size,
               max_position_embeddings=lm.max_position_embeddings,
               num_attention_heads=lm.num_heads, num_hidden_layers=lm.num_layers,
               num_key_value_heads=lm.num_kv_heads, rms_norm_eps=lm.rms_eps,
               rope_theta=lm.rope_base, vocab_size=lm.vocab_size,
               projector_hidden_act=cfg.projector.act)
    return out


def bert_tokenizer(vocab_size: int = 30522, seed: int = 0) -> tuple[dict, dict]:
    """(tokenizer.json, tokenizer_config.json) contents of a seeded
    bert-base-uncased-style WordPiece tokenizer of `vocab_size` pieces
    ([PAD] [UNK] [CLS] [SEP] [MASK], the characters and their "##"
    continuations, common words, then seeded pieces) plus the added [DEC]
    token (InstructBLIP's Q-Former tokenizer has it)."""
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    chars = string.ascii_lowercase + string.digits + string.punctuation
    pieces = specials + list(chars) + ["##" + c for c in chars]
    pieces = list(dict.fromkeys(pieces + [w.lower() for w in _WORDS]))
    rng = np.random.default_rng(seed)
    seen = set(pieces)
    while len(pieces) < vocab_size:
        n = int(rng.integers(2, 6))
        w = "".join(rng.choice(list(string.ascii_lowercase), n))
        w = w if rng.random() < 0.5 else "##" + w
        if w not in seen:
            seen.add(w)
            pieces.append(w)
    vocab = {t: i for i, t in enumerate(pieces[:vocab_size])}
    added = [{"id": vocab[t], "content": t, "single_word": False, "lstrip": False,
              "rstrip": False, "normalized": False, "special": True}
             for t in specials if t in vocab]
    added.append({"id": vocab_size, "content": "[DEC]", "single_word": False, "lstrip": False,
                  "rstrip": False, "normalized": False, "special": True})
    tok = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": {"type": "BertNormalizer", "clean_text": True,
                       "handle_chinese_chars": True, "strip_accents": None,
                       "lowercase": True},
        "pre_tokenizer": {"type": "BertPreTokenizer"},
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}},
                       {"SpecialToken": {"id": "[SEP]", "type_id": 0}}],
            "pair": [{"SpecialToken": {"id": "[CLS]", "type_id": 0}},
                     {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 0}},
                     {"Sequence": {"id": "B", "type_id": 1}},
                     {"SpecialToken": {"id": "[SEP]", "type_id": 1}}],
            "special_tokens": {t: {"id": t, "ids": [vocab[t]], "tokens": [t]}
                               for t in ("[CLS]", "[SEP]")},
        },
        "decoder": {"type": "WordPiece", "prefix": "##", "cleanup": True},
        "model": {"type": "WordPiece", "unk_token": "[UNK]",
                  "continuing_subword_prefix": "##", "max_input_chars_per_word": 100,
                  "vocab": vocab},
    }
    conf = {
        "tokenizer_class": "BertTokenizer", "do_lower_case": True, "unk_token": "[UNK]",
        "sep_token": "[SEP]", "pad_token": "[PAD]", "cls_token": "[CLS]",
        "mask_token": "[MASK]", "bos_token": "[DEC]", "clean_up_tokenization_spaces": True,
        "model_max_length": 512,
    }
    return tok, conf


def _write_json_pair(path: str, tok: dict, conf: dict) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.json"), "w", encoding="utf-8") as f:
        json.dump(tok, f, ensure_ascii=False)
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump(conf, f, indent=2)


def llama_tokenizer(vocab_size: int = 32000, seed: int = 0,
                    layout: str = "prepend") -> tuple[dict, dict]:
    """(tokenizer.json, tokenizer_config.json) contents of a seeded llama
    BPE tokenizer with byte fallback; `layout` "prepend" (the older
    normalizer) or "metaspace" (the newer pre-tokenizer)."""
    if layout not in ("prepend", "metaspace"):
        raise ValueError(f"layout {layout!r}: expected 'prepend' or 'metaspace'")
    specials = ["<unk>", "<s>", "</s>"]
    vocab: dict[str, int] = {t: i for i, t in enumerate(specials)}
    for b in range(256):
        vocab[f"<0x{b:02X}>"] = len(vocab)
    chars = "▁" + string.ascii_letters + string.digits + string.punctuation
    for c in chars:
        vocab[c] = len(vocab)
    merges: list[tuple[str, str]] = []

    def add(a: str, b: str) -> None:
        if a + b not in vocab and len(vocab) < vocab_size:
            merges.append((a, b))
            vocab[a + b] = len(vocab)

    for w in _WORDS:
        w = "▁" + w
        for i in range(2, len(w) + 1):
            add(w[: i - 1], w[i - 1])
    rng = np.random.default_rng(seed)
    short = [t for t in vocab if t not in specials and not t.startswith("<0x") and len(t) <= 4]
    while len(vocab) < vocab_size:
        for i, j in rng.integers(0, len(short), (4096, 2)).tolist():
            a, b = short[i], short[j]
            if a + b not in vocab:
                add(a, b)
                if len(a + b) <= 4:
                    short.append(a + b)
    added = [{"id": i, "content": t, "single_word": False, "lstrip": False, "rstrip": False,
              "normalized": False, "special": True}
             for i, t in enumerate(specials)]
    added += [{"id": vocab_size + j, "content": t, "single_word": False, "lstrip": False,
               "rstrip": False, "normalized": False, "special": True}
              for j, t in enumerate(("<image>", "<pad>"))]
    if layout == "prepend":
        normalizer = {"type": "Sequence", "normalizers": [
            {"type": "Prepend", "prepend": "▁"},
            {"type": "Replace", "pattern": {"String": " "}, "content": "▁"}]}
        pre_tokenizer = None
    else:
        normalizer = None
        pre_tokenizer = {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "first",
                         "split": False}
    bos = {"SpecialToken": {"id": "<s>", "type_id": 0}}
    tok = {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": added,
        "normalizer": normalizer,
        "pre_tokenizer": pre_tokenizer,
        "post_processor": {
            "type": "TemplateProcessing",
            "single": [bos, {"Sequence": {"id": "A", "type_id": 0}}],
            "pair": [bos, {"Sequence": {"id": "A", "type_id": 0}},
                     {"SpecialToken": {"id": "<s>", "type_id": 1}},
                     {"Sequence": {"id": "B", "type_id": 1}}],
            "special_tokens": {"<s>": {"id": "<s>", "ids": [1], "tokens": ["<s>"]}},
        },
        "decoder": {"type": "Sequence", "decoders": [
            {"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
            {"type": "ByteFallback"}, {"type": "Fuse"},
            {"type": "Strip", "content": " ", "start": 1, "stop": 0}]},
        "model": {
            "type": "BPE", "dropout": None, "unk_token": "<unk>",
            "continuing_subword_prefix": None, "end_of_word_suffix": None, "fuse_unk": True,
            "byte_fallback": True, "ignore_merges": False, "vocab": vocab,
            "merges": [f"{a} {b}" for a, b in merges],
        },
    }
    conf = {
        "tokenizer_class": "LlamaTokenizer", "bos_token": "<s>", "eos_token": "</s>",
        "unk_token": "<unk>", "pad_token": "<pad>", "add_bos_token": True,
        "add_eos_token": False, "clean_up_tokenization_spaces": False,
        "legacy": layout == "prepend", "model_max_length": 4096, "padding_side": "left",
    }
    return tok, conf


QWEN_N_RANKS = 151643  # Qwen-VL's mergeable ranks


def write_qwen_tiktoken(path: str, n_ranks: int = QWEN_N_RANKS) -> None:
    """<path>/qwen.tiktoken with `n_ranks` mergeable ranks: the 256 bytes,
    every 2-byte pair, then 3-byte tokens (each one merge from a 2-byte
    prefix and a byte), and Qwen-VL's tokenizer_config.json."""
    import base64

    os.makedirs(path, exist_ok=True)
    toks = [bytes([b]) for b in range(256)]
    toks += [bytes([a, b]) for a in range(256) for b in range(256)]
    outer = 0
    while len(toks) < n_ranks:
        a, b = divmod(outer, 256)
        toks += [bytes([a, b, c]) for c in range(min(256, n_ranks - len(toks)))]
        outer += 1
    with open(os.path.join(path, "qwen.tiktoken"), "w") as f:
        f.write("".join(f"{base64.b64encode(t).decode()} {r}\n"
                        for r, t in enumerate(toks[:n_ranks])))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "QWenTokenizer", "model_max_length": 8192,
                   "padding_side": "right"}, f, indent=2)


def _pb_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b, n = n & 0x7F, n >> 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


def _pb(num: int, value) -> bytes:
    """One protobuf field: an int as a varint, bytes length-delimited, a
    float as fixed32."""
    import struct

    if isinstance(value, bool) or isinstance(value, int):
        return _pb_varint(num << 3) + _pb_varint(int(value))
    if isinstance(value, float):
        return _pb_varint(num << 3 | 5) + struct.pack("<f", value)
    return _pb_varint(num << 3 | 2) + _pb_varint(len(value)) + value


def sentencepiece_model(pieces, byte_fallback: bool = True, add_dummy_prefix: bool = True,
                        remove_extra_whitespaces: bool = False) -> bytes:
    """A BPE ModelProto's bytes for `pieces` [(piece, score, type)]
    (data/tokenizer.py SPM_* types), an identity normalizer."""
    out = b"".join(_pb(1, _pb(1, p.encode("utf-8")) + _pb(2, float(sc)) + _pb(3, t))
                   for p, sc, t in pieces)
    out += _pb(2, _pb(3, 2) + _pb(35, byte_fallback) + _pb(45, b"<unk>"))
    out += _pb(3, _pb(1, b"identity") + _pb(3, add_dummy_prefix)
               + _pb(4, remove_extra_whitespaces) + _pb(5, True))
    return out


def spm_pieces(vocab_size: int = 32000, seed: int = 0, user_defined=()) -> list:
    """llama_tokenizer's vocabulary as sentencepiece pieces: <unk> UNKNOWN,
    <s> / </s> CONTROL, the bytes BYTE, the characters, the merged pieces
    scored by their merge order (first merged = highest), and
    `user_defined` pieces last (USER_DEFINED)."""
    from vlrlhf_torch.data.tokenizer import (
        SPM_BYTE, SPM_CONTROL, SPM_NORMAL, SPM_UNKNOWN, SPM_USER_DEFINED,
    )

    tok, _ = llama_tokenizer(vocab_size - len(user_defined), seed)
    vocab = tok["model"]["vocab"]
    merged = {a.replace(" ", "", 1): k for k, a in enumerate(tok["model"]["merges"])}
    pieces = []
    for p, i in sorted(vocab.items(), key=lambda t: t[1]):
        if p == "<unk>":
            pieces.append((p, 0.0, SPM_UNKNOWN))
        elif p in ("<s>", "</s>"):
            pieces.append((p, 0.0, SPM_CONTROL))
        elif p.startswith("<0x"):
            pieces.append((p, 0.0, SPM_BYTE))
        else:
            pieces.append((p, -float(merged.get(p, len(merged) + i)), SPM_NORMAL))
    pieces += [(p, 0.0, SPM_USER_DEFINED) for p in user_defined]
    return pieces


XC2_USER_DEFINED = tuple(f"[UNUSED_TOKEN_{i}]" for i in range(141, 147))


def write_sentencepiece_tokenizer(path: str, vocab_size: int = 32000, seed: int = 0,
                                  user_defined=(), tokenizer_class: str = "LlamaTokenizer",
                                  pad_token: str = "<pad>") -> None:
    """<path>/tokenizer.model (`spm_pieces`) and a tokenizer_config.json."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "tokenizer.model"), "wb") as f:
        f.write(sentencepiece_model(spm_pieces(vocab_size, seed, user_defined)))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": tokenizer_class, "bos_token": "<s>", "eos_token": "</s>",
                   "unk_token": "<unk>", "pad_token": pad_token, "add_bos_token": True,
                   "add_eos_token": False, "clean_up_tokenization_spaces": False}, f, indent=2)


def write_xc2_tokenizer(path: str, vocab_size: int = 92544, seed: int = 0) -> None:
    """XC2's tokenizer.model of `vocab_size` pieces (the last six the
    [UNUSED_TOKEN_141..146] user-defined pieces) and its config."""
    write_sentencepiece_tokenizer(path, vocab_size, seed, XC2_USER_DEFINED,
                                  "InternLMXComposer2Tokenizer", pad_token="</s>")


def write_tokenizer(path: str, vocab_size: int = 32000, seed: int = 0,
                    layout: str = "prepend") -> None:
    _write_json_pair(path, *llama_tokenizer(vocab_size, seed, layout))


def write_bert_tokenizer(path: str, vocab_size: int = 30522, seed: int = 0) -> None:
    _write_json_pair(path, *bert_tokenizer(vocab_size, seed))


def write_family_tokenizer(path: str, family: str) -> None:
    """The seeded tokenizer of `family`'s published layout in `path`."""
    if family == "qwen_vl":
        write_qwen_tiktoken(path)
    elif family == "internlm_xc2":
        write_xc2_tokenizer(path)
    else:
        write_tokenizer(path)


def hf_config(cfg) -> dict:
    """The config.json of `cfg`'s family."""
    if cfg.family == "instructblip":
        return instructblip_config(cfg)
    if cfg.family == "qwen_vl":
        return qwen_vl_config(cfg)
    if cfg.family == "internlm_xc2":
        return xc2_config(cfg)
    if cfg.family.startswith("llava_next"):
        return llava_next_config(cfg)
    return llava_config(cfg)


def write_checkpoint(path: str, state_dict: Mapping, cfg, dtype: str = "bfloat16",
                     config: dict | None = None) -> int:
    """An HF checkpoint directory of `cfg`'s family from the port's state
    dict: the weights (utils/hf_export.py EXPORTERS), `config` (default
    hf_config(cfg)) and the family's seeded tokenizer; for InstructBLIP also a seeded WordPiece qformer_tokenizer/ over the
    Q-Former's vocabulary (less the added [DEC]). Returns the weights
    file's bytes."""
    from vlrlhf_torch.utils.hf_export import EXPORTERS, save_hf_checkpoint
    from vlrlhf_torch.utils.hf_port import QFORMER_TOKENIZER_DIR

    nbytes = save_hf_checkpoint(EXPORTERS[cfg.family](state_dict, cfg), path, cfg.family,
                                dtype=dtype)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(dict(config or hf_config(cfg), torch_dtype=dtype), f, indent=2)
    write_family_tokenizer(path, cfg.family)
    if cfg.qformer is not None:
        write_bert_tokenizer(os.path.join(path, QFORMER_TOKENIZER_DIR),
                             cfg.qformer.vocab_size - 1)
    return nbytes


write_llava_checkpoint = write_checkpoint  # the name LLaVA-1.5's callers use
