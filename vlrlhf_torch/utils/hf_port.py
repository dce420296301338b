"""Import an HF checkpoint of any of the five families into the port's
`VLM` (vlrlhf_tpu/utils/hf_port.py: `_ln`, `_linear`, `port_llama_lm`,
`port_clip_vit`, `_normalize_llava_keys`, `port_llava` (with LLaVA-Next's
`image_newline`), `port_qwen_lm`, `port_qwen_visual`, `port_qwen_vl`,
`port_internlm2_lm`, `port_internlm_xc2`, `port_xc2_plora`,
`port_instructblip_vit`, `port_instructblip`, `LazyStateDict`,
`open_hf_state_dict`, `load_hf_state_dict` and `PORTERS`).

The fused projections split as vlrlhf_tpu splits them: QWen's c_attn in
three blocks of rows (with its bias), Qwen's visual in_proj per head
interleaved [q; k; v], the resampler's nn.MultiheadAttention in_proj in
blocks, InternLM2's wqkv grouped-interleaved (per kv head: its q heads,
then k, then v), and XC2's PLoRA on wqkv as one shared A with B split the
same way. XC2's PLoRA becomes each LM Linear's frozen plora_a / plora_b in
the model's dtype, never quantized.

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
# QWen (Qwen-VL's LM): the MLP is c_proj(w1(x) * silu(w2(x))), so w2 = gate
QWEN_NORMS = (("input_layernorm", "ln_1"), ("post_attention_layernorm", "ln_2"))
QWEN_LINEARS = (("wo", "attn.c_proj"), ("gate", "mlp.w2"), ("up", "mlp.w1"),
                ("down", "mlp.c_proj"))
QWEN_VIS_NORMS = (("ln1", "ln_1"), ("ln2", "ln_2"))
QWEN_VIS_LINEARS = (("wo", "attn.out_proj"), ("fc1", "mlp.c_fc"), ("fc2", "mlp.c_proj"))
# InternLM2 (XC2's LM); PLoRA rides on every one of these and on wqkv
INTERNLM2_NORMS = (("input_layernorm", "attention_norm"),
                   ("post_attention_layernorm", "ffn_norm"))
INTERNLM2_LINEARS = (("wo", "attention.wo"), ("gate", "feed_forward.w1"),
                     ("up", "feed_forward.w3"), ("down", "feed_forward.w2"))
XC2_PROJECTOR = (("fc1", "vision_proj.0"), ("fc2", "vision_proj.2"))


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


def _pos_table(p: _Port, vis: nn.Module, table: torch.Tensor) -> None:
    """A tower's position table: the model's shape, or a checkpoint's
    square grid of another size (XC2's 24 x 24 CLIP table at 490 px),
    which the forward resizes."""
    if tuple(table.shape) == tuple(vis.pos_embed.shape):
        p.put(vis, "pos_embed", table)
    else:
        vis.set_pos_embed_(table.to(vis.cfg.dtype).to(p.device))


def port_clip_vit(p: _Port, vis: nn.Module, prefix: str) -> None:
    """HF CLIPVisionModel -> the port's VisionTower (every layer, the
    pre and post norms, whatever feature_layer the forward stops at)."""
    emb = f"{prefix}.embeddings"
    p.put(vis, "patch_weight", patch_from_conv(p.read(f"{emb}.patch_embedding.weight")))
    if vis.patch_bias is not None:
        p.put(vis, "patch_bias", p.read(f"{emb}.patch_embedding.bias"))
    _pos_table(p, vis, p.read(f"{emb}.position_embedding.weight"))
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


def _split_weight(p: _Port, lins, w: torch.Tensor, b: Optional[torch.Tensor], name: str):
    """Fill `lins` (wq, wk, wv) from the row blocks of a fused weight (and
    bias) already split into a list."""
    for j, lin in enumerate(lins):
        _weight(p, lin, w[j], f"{name}[{j}]")
        if b is not None:
            p.put(lin, "bias", b[j])


def port_qwen_lm(p: _Port, lm: nn.Module, prefix: str = "transformer") -> None:
    """QWen (Qwen-VL's LM) -> the LlamaDecoder: c_attn's rows (and bias)
    in three blocks for wq / wk / wv; w2 = gate, w1 = up, c_proj = down."""
    p.put(lm, "embed_tokens", p.read(f"{prefix}.wte.weight"))
    for i, layer in enumerate(lm.layers):
        hp = f"{prefix}.h.{i}"
        for ours, theirs in QWEN_NORMS:
            _ln(p, f"{hp}.{theirs}", getattr(layer, ours))
        w = p.read(f"{hp}.attn.c_attn.weight").chunk(3, dim=0)
        b = p.read(f"{hp}.attn.c_attn.bias").chunk(3, dim=0)
        _split_weight(p, (layer.wq, layer.wk, layer.wv), w, b, f"{hp}.attn.c_attn.weight")
        for ours, theirs in QWEN_LINEARS:
            _linear(p, f"{hp}.{theirs}", getattr(layer, ours))
    _ln(p, f"{prefix}.ln_f", lm.norm)
    _linear(p, "lm_head", lm.lm_head)


def port_qwen_visual(p: _Port, vis: nn.Module, proj: nn.Module,
                     prefix: str = "transformer.visual") -> None:
    """Qwen's ViT-bigG and its resampler: the tower's in_proj rows are per
    head interleaved [q; k; v] (VisualAttention), the resampler's
    nn.MultiheadAttention in_proj in blocks; `proj` is stored (in, out)."""
    nh = vis.cfg.num_heads
    p.put(vis, "patch_weight", patch_from_conv(p.read(f"{prefix}.conv1.weight")))
    _pos_table(p, vis, p.read(f"{prefix}.positional_embedding"))
    _ln(p, f"{prefix}.ln_pre", vis.ln_pre)
    for i, blk in enumerate(vis.layers):
        hp = f"{prefix}.transformer.resblocks.{i}"
        for ours, theirs in QWEN_VIS_NORMS:
            _ln(p, f"{hp}.{theirs}", getattr(blk, ours))
        w = p.read(f"{hp}.attn.in_proj.weight")
        d, h = w.shape[0] // 3, w.shape[1]
        w = w.reshape(nh, 3, d // nh, h)
        b = p.read(f"{hp}.attn.in_proj.bias").reshape(nh, 3, d // nh)
        _split_weight(p, (blk.wq, blk.wk, blk.wv), [w[:, j].reshape(d, h) for j in range(3)],
                      [b[:, j].reshape(d) for j in range(3)], f"{hp}.attn.in_proj.weight")
        for ours, theirs in QWEN_VIS_LINEARS:
            _linear(p, f"{hp}.{theirs}", getattr(blk, ours))
    ap, r = f"{prefix}.attn_pool", proj.resampler
    p.put(r, "query", p.read(f"{ap}.query"))
    p.put(r, "pos_embed", p.read(f"{ap}.pos_embed"))
    _ln(p, f"{ap}.ln_q", r.ln_q)
    _ln(p, f"{ap}.ln_kv", r.ln_kv)
    if r.kv_proj is not None:
        _linear(p, f"{ap}.kv_proj", r.kv_proj)
    w = p.read(f"{ap}.attn.in_proj_weight").chunk(3, dim=0)
    b = p.read(f"{ap}.attn.in_proj_bias").chunk(3, dim=0)
    _split_weight(p, (r.attn.wq, r.attn.wk, r.attn.wv), w, b, f"{ap}.attn.in_proj_weight")
    _linear(p, f"{ap}.attn.out_proj", r.attn.wo)
    _ln(p, f"{prefix}.ln_post", proj.ln_post)
    _weight(p, proj.proj, p.read(f"{prefix}.proj").t().contiguous(), f"{prefix}.proj")


def port_qwen_vl(sd: Mapping, model: nn.Module, device,
                 quantize: Sequence[str] = (), bits: int = 8) -> int:
    """Fill a meta-device Qwen-VL VLM from an HF QWenLMHeadModel state dict
    (vlrlhf_tpu `port_qwen_vl`); returns the checkpoint bytes read."""
    p = _Port(sd, model, device, quantize, bits)
    port_qwen_visual(p, model.vision, model.projector)
    port_qwen_lm(p, model.lm)
    _check_complete(model)
    return p.bytes_read


def _qkv_groups(t: torch.Tensor, nh: int, nkv: int, hd: int) -> list[torch.Tensor]:
    """InternLM2's grouped-interleaved rows (per kv head: its q heads, its
    k head, its v head) -> [q rows (nh*hd), k rows, v rows]; the trailing
    axis (in, or PLoRA's r) is kept."""
    g = nh // nkv
    w = t.reshape(nkv, g + 2, hd, t.shape[-1])
    return [w[:, :g].reshape(nh * hd, -1), w[:, g].reshape(nkv * hd, -1),
            w[:, g + 1].reshape(nkv * hd, -1)]


def port_internlm2_lm(p: _Port, lm: nn.Module, prefix: str = "model") -> None:
    """InternLM2 -> the LlamaDecoder: wqkv split by kv-head groups; w1 =
    gate, w3 = up, w2 = down; the head is `output`."""
    cfg = lm.cfg
    p.put(lm, "embed_tokens", p.read(f"{prefix}.tok_embeddings.weight"))
    for i, layer in enumerate(lm.layers):
        hp = f"{prefix}.layers.{i}"
        for ours, theirs in INTERNLM2_NORMS:
            _ln(p, f"{hp}.{theirs}", getattr(layer, ours))
        w = _qkv_groups(p.read(f"{hp}.attention.wqkv.weight"), cfg.num_heads,
                        cfg.num_kv_heads, cfg.head_dim_)
        _split_weight(p, (layer.wq, layer.wk, layer.wv), w, None, f"{hp}.attention.wqkv.weight")
        for ours, theirs in INTERNLM2_LINEARS:
            _linear(p, f"{hp}.{theirs}", getattr(layer, ours))
    _ln(p, f"{prefix}.norm", lm.norm)
    _linear(p, "output", lm.lm_head)


def port_xc2_plora(p: _Port, lm: nn.Module, prefix: str = "model") -> int:
    """XC2's trained PLoRA (Plora_A / Plora_B on wqkv, wo, w1, w3, w2) ->
    each LM Linear's frozen plora_a (in, r) / plora_b (r, out) in the
    model's dtype; wqkv's one A is shared by wq / wk / wv and its B split
    by kv-head groups (vlrlhf_tpu `port_xc2_plora`). Returns the layers
    that hold PLoRA (0 for a checkpoint without)."""
    cfg = lm.cfg
    if f"{prefix}.layers.0.attention.wqkv.Plora_A.weight" not in p.sd:
        return 0

    def pair(key):
        return (p.read(f"{key}.Plora_A.weight").t(), p.read(f"{key}.Plora_B.weight").t())

    def hold(lin, a, b):
        lin.set_plora_(a.to(cfg.dtype).to(p.device).contiguous(),
                       b.to(cfg.dtype).to(p.device).contiguous())

    for i, layer in enumerate(lm.layers):
        hp = f"{prefix}.layers.{i}"
        a = p.read(f"{hp}.attention.wqkv.Plora_A.weight").t()
        bs = _qkv_groups(p.read(f"{hp}.attention.wqkv.Plora_B.weight"), cfg.num_heads,
                         cfg.num_kv_heads, cfg.head_dim_)
        for lin, b in zip((layer.wq, layer.wk, layer.wv), bs):
            hold(lin, a, b.t())
        for ours, theirs in INTERNLM2_LINEARS:
            hold(getattr(layer, ours), *pair(f"{hp}.{theirs}"))
    return len(lm.layers)


def port_internlm_xc2(sd: Mapping, model: nn.Module, device,
                      quantize: Sequence[str] = (), bits: int = 8) -> int:
    """Fill a meta-device XC2 VLM from an HF InternLMXComposer2ForCausalLM
    state dict: the CLIP tower under vit.vision_tower.vision_model (its
    table at the checkpoint's grid), the two-layer vision_proj, the
    InternLM2 LM and the PLoRA; returns the checkpoint bytes read."""
    p = _Port(sd, model, device, quantize, bits)
    port_clip_vit(p, model.vision, "vit.vision_tower.vision_model")
    for ours, theirs in XC2_PROJECTOR:
        _linear(p, theirs, getattr(model.projector, ours))
    port_internlm2_lm(p, model.lm)
    port_xc2_plora(p, model.lm)
    _check_complete(model)
    return p.bytes_read


PORTERS = {"llava": port_llava, "llava_next_vicuna": port_llava,
           "llava_next_mistral": port_llava, "qwen_vl": port_qwen_vl,
           "internlm_xc2": port_internlm_xc2, "instructblip": port_instructblip}


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
