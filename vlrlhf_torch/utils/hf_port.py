"""Import an HF LLaVA, LLaVA-Next or InstructBLIP checkpoint into the
port's `VLM` (those families' half of vlrlhf_tpu/utils/hf_port.py: `_ln`,
`_linear`, `port_llama_lm`, `port_clip_vit`, `_normalize_llava_keys`,
`port_llava` (with LLaVA-Next's `image_newline`), `port_instructblip_vit`,
`port_instructblip`, `LazyStateDict`, `open_hf_state_dict`,
`load_hf_state_dict` and `PORTERS`).

The port's Linear holds (out, in) as torch does, so vlrlhf_tpu's transposes
drop out; only the CLIP patch convolution changes layout ((h, 3, p, p) ->
the tower's (h, p*p*3) in (row, col, channel) order). The importer fills a
model built on the meta device one tensor at a time, on the target device:
each checkpoint tensor is read once (a view of the mapped file), cast to the
model's dtype on the host, quantized there when its linear matches a
quantize pattern (int8, or group-64 int4 where in % 128 == 0), and copied
to the card. So the device holds the model being built and one tensor
more, never a full-precision or unquantized twin, and the host one tensor
(vlrlhf_tpu's `port_dtype` and `port_quantize` contexts become the model's
dtype and the `quantize` argument). A GPTQ linear (`qweight` / `qzeros` /
`scales`) becomes the int4 layout through utils/gptq.py.

A parameter the checkpoint does not provide is an error naming it; keys
the model does not use (e.g. CLIP's text-free `position_ids` buffer) are
ignored, as in vlrlhf_tpu.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Iterator, Mapping, Optional, Sequence

import torch
from torch import nn

from vlrlhf_torch.models.common import Linear, Norm
from vlrlhf_torch.utils.safetensors_io import INDEX_NAME, SafetensorsDir

# (port name, HF name) within one decoder / tower layer; hf_export inverts these
LLAMA_NORMS = (("input_layernorm", "input_layernorm"),
               ("post_attention_layernorm", "post_attention_layernorm"))
LLAMA_LINEARS = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                 ("wv", "self_attn.v_proj"), ("wo", "self_attn.o_proj"),
                 ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"),
                 ("down", "mlp.down_proj"))
CLIP_NORMS = (("ln1", "layer_norm1"), ("ln2", "layer_norm2"))
CLIP_LINEARS = (("wq", "self_attn.q_proj"), ("wk", "self_attn.k_proj"),
                ("wv", "self_attn.v_proj"), ("wo", "self_attn.out_proj"),
                ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
LLAVA_PROJECTOR = (("fc1", "multi_modal_projector.linear_1"),
                   ("fc2", "multi_modal_projector.linear_2"))
# InstructBLIP's EVA tower (the qkv linear is fused, split in blocks of rows)
EVA_NORMS = (("ln1", "layer_norm1"), ("ln2", "layer_norm2"))
EVA_LINEARS = (("wo", "self_attn.projection"), ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
# Q-Former layer: (port module, HF attention prefix, HF output prefix) of its
# BERT attentions, and (port module, HF fc1, HF fc2 / LayerNorm prefix) of
# its two feed-forwards
QFORMER_ATTNS = (("self_attn", "attention.attention", "attention.output"),
                 ("cross_attn", "crossattention.attention", "crossattention.output"))
QFORMER_BERT = (("wq", "query"), ("wk", "key"), ("wv", "value"))
QFORMER_FFNS = (("ffn", "intermediate", "output"),
                ("ffn_query", "intermediate_query", "output_query"))
QFORMER_TOKENIZER_DIR = "qformer_tokenizer"  # InstructBLIP's second tokenizer


def patch_from_conv(w: torch.Tensor) -> torch.Tensor:
    """HF conv (h, 3, p, p) -> the tower's (h, p*p*3), (row, col, channel)."""
    return w.permute(0, 2, 3, 1).reshape(w.shape[0], -1)


def conv_from_patch(w: torch.Tensor, patch: int) -> torch.Tensor:
    """The inverse of patch_from_conv."""
    return w.reshape(w.shape[0], patch, patch, 3).permute(0, 3, 1, 2).contiguous()


class _Port:
    """Fills a meta-device model from a state dict on `device`, quantizing
    the linears whose JAX-layout path (ops/quant.linear_path) matches
    `patterns` to `bits` on the host as they are read."""

    def __init__(self, sd: Mapping[str, torch.Tensor], model: nn.Module, device,
                 patterns: Sequence[str] = (), bits: int = 8):
        if bits not in (8, 4):
            raise ValueError(f"bits={bits}: expected 8 or 4")
        self.sd, self.device, self.bits = sd, torch.device(device), bits
        self.regs = [re.compile(p) for p in patterns]
        self.names = {id(m): n for n, m in model.named_modules()}
        self.bytes_read = 0

    def read(self, key: str) -> torch.Tensor:
        if key not in self.sd:
            raise KeyError(f"the checkpoint has no tensor {key!r}")
        t = self.sd[key]
        self.bytes_read += t.numel() * t.element_size()
        return t

    def put(self, owner: nn.Module, attr: str, host: torch.Tensor) -> None:
        """Replace owner.<attr> with `host` cast to its dtype, on the device."""
        old = getattr(owner, attr)
        if tuple(host.shape) != tuple(old.shape):
            raise ValueError(f"{self.names.get(id(owner), '?')}.{attr}: checkpoint shape "
                             f"{tuple(host.shape)}, model {tuple(old.shape)}")
        setattr(owner, attr, nn.Parameter(host.to(old.dtype).to(self.device),
                                          requires_grad=False))

    def quantizes(self, lin: Linear) -> bool:
        from vlrlhf_torch.ops.quant import linear_path

        path = linear_path(self.names[id(lin)])
        return any(r.search(path) for r in self.regs)


def _ln(p: _Port, prefix: str, norm: Norm) -> None:
    p.put(norm, "weight", p.read(f"{prefix}.weight"))
    if norm.bias is not None:
        p.put(norm, "bias", p.read(f"{prefix}.bias"))


def _weight(p: _Port, lin: Linear, w: torch.Tensor, name: str) -> None:
    """A dense weight (out, in) into `lin`, quantized on the host first when
    the linear matches the port's patterns."""
    if p.quantizes(lin):
        from vlrlhf_torch.ops.int4 import BLOCK, quantize_int4
        from vlrlhf_torch.ops.quant import quantize_linear

        w = w.to(lin.weight.dtype)
        if tuple(w.shape) != (lin.d_out, lin.d_in):
            raise ValueError(f"{name}: checkpoint shape {tuple(w.shape)}, model "
                             f"({lin.d_out}, {lin.d_in})")
        if p.bits == 4 and lin.d_in % BLOCK == 0:
            packed, scale = quantize_int4(w)
            lin.set_quantized4_(packed.to(p.device), scale.to(p.device))
        else:
            q, scale = quantize_linear(w)
            lin.set_quantized_(q.to(p.device), scale.to(p.device))
    else:
        p.put(lin, "weight", w)


def _linear(p: _Port, prefix: str, lin: Linear) -> None:
    """A dense, quantized-on-read or GPTQ linear, then its bias. A
    checkpoint bias for a bias-free linear must be zero (AutoGPTQ writes
    zero biases)."""
    if f"{prefix}.qweight" in p.sd:
        _gptq_linear(p, prefix, lin)
    else:
        _weight(p, lin, p.read(f"{prefix}.weight"), f"{prefix}.weight")
    if lin.bias is not None:
        p.put(lin, "bias", p.read(f"{prefix}.bias"))
    elif f"{prefix}.bias" in p.sd and p.read(f"{prefix}.bias").any():
        raise ValueError(f"{prefix}.bias is non-zero but the model's linear has no bias")


def _gptq_linear(p: _Port, prefix: str, lin: Linear) -> None:
    """AutoGPTQ int4 codes -> the int4 layout (utils/gptq.py returns the
    JAX package's (in, out) leaves; the port holds their transposes)."""
    from vlrlhf_torch.utils.gptq import convert_gptq_linear

    g_idx = p.read(f"{prefix}.g_idx").numpy() if f"{prefix}.g_idx" in p.sd else None
    leaves = convert_gptq_linear(p.read(f"{prefix}.qweight").numpy(),
                                 p.read(f"{prefix}.qzeros").numpy(),
                                 p.read(f"{prefix}.scales").float().numpy(), g_idx)

    def dev(key):
        return torch.from_numpy(leaves[key].T.copy()).to(p.device)

    lin.set_quantized4_(dev("kernel_q4"), dev("kernel_scale"),
                        dev("kernel_gbias") if "kernel_gbias" in leaves else None)


def port_llama_lm(p: _Port, lm: nn.Module, prefix: str = "model") -> None:
    """HF Llama / Vicuna -> the port's LlamaDecoder; `prefix` is e.g.
    'language_model.model' inside a llava checkpoint. The head is read
    from '<prefix minus .model>.lm_head.weight' or the top-level
    'lm_head.weight'."""
    p.put(lm, "embed_tokens", p.read(f"{prefix}.embed_tokens.weight"))
    for i, layer in enumerate(lm.layers):
        hp = f"{prefix}.layers.{i}"
        for ours, theirs in LLAMA_NORMS:
            _ln(p, f"{hp}.{theirs}", getattr(layer, ours))
        for ours, theirs in LLAMA_LINEARS:
            _linear(p, f"{hp}.{theirs}", getattr(layer, ours))
    _ln(p, f"{prefix}.norm", lm.norm)
    if lm.lm_head is not None:
        head = prefix.rsplit(".", 1)[0] if prefix.endswith(".model") else prefix
        key = f"{head}.lm_head"
        if f"{key}.weight" not in p.sd and "lm_head.weight" in p.sd:
            key = "lm_head"
        _linear(p, key, lm.lm_head)


def port_clip_vit(p: _Port, vis: nn.Module, prefix: str) -> None:
    """HF CLIPVisionModel -> the port's VisionTower (every layer, the
    pre and post norms, whatever feature_layer the forward stops at)."""
    emb = f"{prefix}.embeddings"
    p.put(vis, "patch_weight", patch_from_conv(p.read(f"{emb}.patch_embedding.weight")))
    if vis.patch_bias is not None:
        p.put(vis, "patch_bias", p.read(f"{emb}.patch_embedding.bias"))
    p.put(vis, "pos_embed", p.read(f"{emb}.position_embedding.weight"))
    if vis.cls_token is not None:
        p.put(vis, "cls_token", p.read(f"{emb}.class_embedding"))
    for i, blk in enumerate(vis.layers):
        hp = f"{prefix}.encoder.layers.{i}"
        for ours, theirs in CLIP_NORMS:
            _ln(p, f"{hp}.{theirs}", getattr(blk, ours))
        for ours, theirs in CLIP_LINEARS:
            _linear(p, f"{hp}.{theirs}", getattr(blk, ours))
    if vis.ln_pre is not None:
        _ln(p, f"{prefix}.pre_layrnorm", vis.ln_pre)  # HF CLIP's (sic) spelling
    if vis.ln_post is not None:
        _ln(p, f"{prefix}.post_layernorm", vis.ln_post)


class _Renamed(Mapping):
    """A key-renaming view: no tensor is read to rename."""

    def __init__(self, sd: Mapping, rename):
        self._sd = sd
        self._keys = {rename(k): k for k in sd}

    def __getitem__(self, k):
        return self._sd[self._keys[k]]

    def __contains__(self, k) -> bool:
        return k in self._keys

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def __len__(self) -> int:
        return len(self._keys)


def _llava_key(k: str) -> str:
    if k.startswith("model.language_model."):
        return "language_model.model." + k[len("model.language_model."):]
    if k == "lm_head.weight":
        return "language_model.lm_head.weight"
    if k.startswith("model."):
        return k[len("model."):]
    return k


def _normalize_llava_keys(sd: Mapping) -> Mapping:
    """transformers >= 4.52 writes model.language_model.* / lm_head.*; the
    importer reads the 4.41-era layout (language_model.model.*), as
    vlrlhf_tpu does. Renames lazily: vlrlhf_tpu's dict comprehension reads
    every tensor of a streamed checkpoint."""
    if not any(k.startswith("model.language_model.") for k in sd):
        return sd
    return _Renamed(sd, _llava_key)


def _check_complete(model: nn.Module) -> None:
    left = [n for n, t in model.named_parameters() if t.is_meta]
    if left:
        raise ValueError(f"the checkpoint left {len(left)} parameters unset: {left[:5]}")


def port_llava(sd: Mapping, model: nn.Module, device,
               quantize: Sequence[str] = (), bits: int = 8) -> int:
    """Fill a meta-device LLaVA VLM from an HF LlavaForConditionalGeneration
    (or LlavaNextForConditionalGeneration, whose `image_newline` the
    anyres gather places) state dict on `device`; linears matching
    `quantize` become int8 or int4 (`bits`) on the way. Returns the
    checkpoint bytes read."""
    sd = _normalize_llava_keys(sd)
    p = _Port(sd, model, device, quantize, bits)
    port_clip_vit(p, model.vision, "vision_tower.vision_model")
    for ours, theirs in LLAVA_PROJECTOR:
        _linear(p, theirs, getattr(model.projector, ours))
    port_llama_lm(p, model.lm, "language_model.model")
    if model.image_newline is not None:
        p.put(model, "image_newline", p.read("image_newline"))
    _check_complete(model)
    return p.bytes_read


def port_instructblip_vit(p: _Port, vis: nn.Module, prefix: str) -> None:
    """HF InstructBlipVisionModel (EVA ViT-g) -> the port's VisionTower:
    the fused qkv linear split into wq / wk / wv by blocks of rows, the
    class and position embeddings raw (1, 1, h) / (1, n, h) Parameters,
    no pre-norm, a post norm."""
    emb = f"{prefix}.embeddings"
    p.put(vis, "patch_weight", patch_from_conv(p.read(f"{emb}.patch_embedding.weight")))
    p.put(vis, "patch_bias", p.read(f"{emb}.patch_embedding.bias"))
    p.put(vis, "pos_embed", p.read(f"{emb}.position_embedding")[0])
    p.put(vis, "cls_token", p.read(f"{emb}.class_embedding")[0, 0])
    for i, blk in enumerate(vis.layers):
        hp = f"{prefix}.encoder.layers.{i}"
        for ours, theirs in EVA_NORMS:
            _ln(p, f"{hp}.{theirs}", getattr(blk, ours))
        w = p.read(f"{hp}.self_attn.qkv.weight").chunk(3, dim=0)
        b = p.read(f"{hp}.self_attn.qkv.bias").chunk(3, dim=0)
        for j, name in enumerate(("wq", "wk", "wv")):
            lin = getattr(blk, name)
            _weight(p, lin, w[j], f"{hp}.self_attn.qkv.weight[{name}]")
            p.put(lin, "bias", b[j])
        for ours, theirs in EVA_LINEARS:
            _linear(p, f"{hp}.{theirs}", getattr(blk, ours))
    _ln(p, f"{prefix}.post_layernorm", vis.ln_post)


def port_qformer(p: _Port, qf: nn.Module, prefix: str = "qformer") -> None:
    """HF InstructBlipQFormerModel (+ the top-level query_tokens) -> the
    port's QFormer."""
    p.put(qf, "query_tokens", p.read("query_tokens")[0])
    p.put(qf, "word_embed", p.read(f"{prefix}.embeddings.word_embeddings.weight"))
    p.put(qf, "pos_embed", p.read(f"{prefix}.embeddings.position_embeddings.weight"))
    _ln(p, f"{prefix}.embeddings.layernorm", qf.emb_ln)
    for i, layer in enumerate(qf.layers):
        hp = f"{prefix}.encoder.layer.{i}"
        for ours, att, out in QFORMER_ATTNS:
            mod = getattr(layer, ours)
            if mod is None:
                continue
            for o, t in QFORMER_BERT:
                _linear(p, f"{hp}.{att}.{t}", getattr(mod, o))
            _linear(p, f"{hp}.{out}.dense", mod.wo)
            _ln(p, f"{hp}.{out}.LayerNorm", mod.ln)
        for ours, fc1, fc2 in QFORMER_FFNS:
            mod = getattr(layer, ours)
            _linear(p, f"{hp}.{fc1}.dense", mod.fc1)
            _linear(p, f"{hp}.{fc2}.dense", mod.fc2)
            _ln(p, f"{hp}.{fc2}.LayerNorm", mod.ln)


def port_instructblip(sd: Mapping, model: nn.Module, device,
                      quantize: Sequence[str] = (), bits: int = 8) -> int:
    """Fill a meta-device InstructBLIP VLM from an HF
    InstructBlipForConditionalGeneration state dict (vlrlhf_tpu
    `port_instructblip`); returns the checkpoint bytes read."""
    sd = _normalize_llava_keys(sd)
    p = _Port(sd, model, device, quantize, bits)
    port_instructblip_vit(p, model.vision, "vision_model")
    port_qformer(p, model.qformer)
    _linear(p, "language_projection", model.projector.fc1)
    port_llama_lm(p, model.lm, "language_model.model")
    _check_complete(model)
    return p.bytes_read


PORTERS = {"llava": port_llava, "llava_next_vicuna": port_llava,
           "llava_next_mistral": port_llava, "instructblip": port_instructblip}


class LazyStateDict(Mapping):
    """A checkpoint directory's tensors by name, read on access: safetensors
    (its index.json when present) one tensor per read, from the mapped file;
    `pytorch_model*.bin` shards one whole shard at a time (a .bin cannot be
    read in part), the last one kept. Tensors keep the checkpoint's dtype."""

    def __init__(self, path: str):
        self._st: Optional[SafetensorsDir] = None
        self._index: dict[str, str] = {}
        self._cache: tuple = (None, None)
        if os.path.exists(os.path.join(path, INDEX_NAME)) or glob.glob(
                os.path.join(path, "*.safetensors")):
            self._st = SafetensorsDir(path)
            return
        bins = sorted(glob.glob(os.path.join(path, "pytorch_model*.bin")))
        if not bins:
            raise FileNotFoundError(f"no weights (*.safetensors, pytorch_model*.bin) under {path}")
        for f in bins:
            for k in torch.load(f, map_location="meta", weights_only=True):
                self._index[k] = f

    def __getitem__(self, k: str) -> torch.Tensor:
        if self._st is not None:
            return self._st[k]
        f = self._index[k]
        if self._cache[0] != f:
            self._cache = (None, None)  # drop the last shard before the next loads
            self._cache = (f, torch.load(f, map_location="cpu", weights_only=True))
        return self._cache[1][k]

    def __contains__(self, k) -> bool:
        return k in (self._st if self._st is not None else self._index)

    def __iter__(self) -> Iterator[str]:
        return iter(self._st if self._st is not None else self._index)

    def __len__(self) -> int:
        return len(self._st if self._st is not None else self._index)


def open_hf_state_dict(path: str) -> LazyStateDict:
    """The streaming open the loader uses: per-tensor reads."""
    return LazyStateDict(path)


def load_hf_state_dict(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a checkpoint directory, copied into memory."""
    sd = LazyStateDict(path)
    return {k: sd[k].clone() for k in sd}
