"""Faults of the port against the reference, repaired in the port alone
(vlrlhf_tpu keeps its behaviour and its bridged configs keep theirs), f32
on the CPU:
  - GELU forms: an HF import carries the form config.json names
    (`projector_hidden_act`, `vision_config.hidden_act`,
    `qformer_config.hidden_act`; "gelu" is erf) for LLaVA, InstructBLIP,
    Qwen-VL and XC2, and a config bridged from vlrlhf_tpu keeps the tanh
    form jax.nn.gelu computes (the logits against transformers at 1e-5 are
    in tests/test_torch_hf_import.py);
  - Qwen-VL past its trained context: a tiny Qwen LM with QWen's own
    dynamic NTK (2 ** ceil(log2(n / seq_length) + 1) - 1 for a prefill of
    n tokens, reused by every later step with a past) and logn query
    scaling (log(p + 1) / log(seq_length) past seq_length) read from
    config.json, prefill, decode and a chunk at positions past
    seq_length = 32, against a plain transcription of QWen's formulas at
    1e-5, and the continuous engine's slots keeping each row's alpha;
  - Mistral's sliding window: read on import, every longer sequence
    (at load, at collation) and KV cache (at allocation) refused by name;
    a null window, as Mistral-7B-Instruct-v0.2 ships it, changes nothing."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vlrlhf_torch.cli.loading import config_from_hf, load_model_bundle
from vlrlhf_torch.models.common import GELU_TANH, activation

TOL = 1e-5


def test_imported_configs_carry_the_gelu_form_config_json_names():
    from tests.test_torch_qwen_xc2 import _qwen_lm
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.utils.synthetic_checkpoint import (
        LLAVA_15_7B_CONFIG, QWEN_VL_CHAT_CONFIG, XC2_7B_CONFIG, instructblip_config,
    )

    x = torch.linspace(-4, 4, 101)
    assert torch.equal(activation("gelu")(x), F.gelu(x))
    assert torch.equal(activation(GELU_TANH)(x), F.gelu(x, approximate="tanh"))
    assert (activation("gelu")(x) - activation(GELU_TANH)(x)).abs().max() > 1e-4
    with pytest.raises(ValueError, match="activation 'relu'"):
        activation("relu")

    llava = config_from_hf(LLAVA_15_7B_CONFIG)[1]
    assert (llava.projector.act, llava.vision.act) == ("gelu", "quick_gelu")
    qwen = config_from_hf(QWEN_VL_CHAT_CONFIG)[1]
    assert qwen.vision.act == "gelu"  # QWen's visual.py: nn.GELU
    assert config_from_hf(XC2_7B_CONFIG)[1].projector.act == "gelu"  # vision_proj's nn.GELU
    blip = instructblip_config(scale_down(FAMILIES["instructblip"].make_config()))
    for vis_act, qf_act in (("gelu", "gelu"), ("gelu_pytorch_tanh", "gelu_new")):
        blip["vision_config"]["hidden_act"], blip["qformer_config"]["hidden_act"] = vis_act, qf_act
        got = config_from_hf(blip)[1]
        assert (got.vision.act, got.qformer.act) == (vis_act, qf_act)
    del blip["vision_config"]["hidden_act"], blip["qformer_config"]["hidden_act"]
    got = config_from_hf(blip)[1]  # InstructBlip*Config's defaults
    assert (got.vision.act, got.qformer.act) == ("gelu", "gelu")
    # a config bridged from vlrlhf_tpu computes what vlrlhf_tpu computes
    bridged = _qwen_lm()[2].cfg
    assert (bridged.vision.act, bridged.projector.act) == (GELU_TANH, GELU_TANH)
    assert bridged.lm.rope_scaling_type == "dynamic" and not bridged.lm.logn_attn


# ---------------------------------------------------------------------------
# Qwen-VL past seq_length


SEQ = 32  # the tiny model's trained context (QWen's seq_length)


def _qwen_model():
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.synthetic_checkpoint import qwen_vl_config

    cfg = scale_down(FAMILIES["qwen_vl"].make_config(), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, max_position_embeddings=SEQ))
    hf = dict(qwen_vl_config(cfg), use_dynamic_ntk=True, use_logn_attn=True)
    cfg = config_from_hf(hf, torch.float32)[1]
    assert cfg.lm.rope_scaling_type == "qwen_dynamic" and cfg.lm.logn_attn
    assert cfg.lm.max_position_embeddings == SEQ
    model = init_random_(VLM(cfg, device="cpu"), torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for layer in model.lm.layers:
            for name in ("wq", "wk", "wv"):
                b = getattr(layer, name).bias
                b.copy_(0.1 * torch.randn(b.shape, generator=g))
    return model


def _qwen_alpha(kv_len: int) -> float:
    """modeling_qwen.py's get_ntk_alpha of a forward without a past."""
    if kv_len <= SEQ:
        return 1.0
    return max(2 ** math.ceil(math.log(kv_len / SEQ, 2) + 1) - 1, 1)


def _qwen_rotary(hd: int, base: float, ntk_alpha: float, positions: torch.Tensor):
    """modeling_qwen.py's RotaryEmbedding at `ntk_alpha`: (cos, sin)."""
    base = base * ntk_alpha ** (hd / (hd - 2))
    inv_freq = 1.0 / (base ** (torch.arange(0, hd, 2).float() / hd))
    freqs = torch.outer(positions.float(), inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def _rotate(x, cos, sin):  # x (S, H, hd)
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos[:, None] + torch.cat([-x2, x1], dim=-1) * sin[:, None]


def _logn(p: int) -> float:
    return math.log(p + 1, SEQ) if p + 1 > SEQ else 1.0


class QwenReference:
    """One row through QWen's attention formulas on the port's weights: the
    prefill (a forward without a past) takes the NTK alpha of its tokens,
    and every later forward (decode, a chunk) reuses it, as QWenModel's
    `_ntk_alpha_cached` does; cached keys keep the rotation they were made
    with; queries scaled by logn."""

    def __init__(self, model):
        self.model, self.lm = model, model.lm
        self.k, self.v = [[] for _ in self.lm.layers], [[] for _ in self.lm.layers]
        self.alpha = None

    def forward(self, ids: torch.Tensor, start: int) -> torch.Tensor:
        from vlrlhf_torch.ops.norms import rms_norm

        lm, cfg = self.lm, self.lm.cfg
        s, hd = ids.shape[0], cfg.head_dim_
        pos = torch.arange(start, start + s)
        if start == 0:
            self.alpha = _qwen_alpha(s)
        cos, sin = _qwen_rotary(hd, cfg.rope_base, self.alpha, pos)
        logn = torch.tensor([_logn(int(p)) for p in pos])[:, None, None]
        x = lm.embed(ids[None])[0]
        for i, layer in enumerate(lm.layers):
            h = rms_norm(x[None], layer.input_layernorm.weight, cfg.rms_eps)
            q, k, v = (t[0] for t in layer.qkv(h))
            q, k = _rotate(q, cos, sin) * logn, _rotate(k, cos, sin)
            self.k[i].append(k)
            self.v[i].append(v)
            keys, vals = torch.cat(self.k[i]), torch.cat(self.v[i])
            att = torch.einsum("qhd,khd->hqk", q, keys) / math.sqrt(hd)
            causal = torch.arange(keys.shape[0])[None] <= pos[:, None]
            att = att.masked_fill(~causal[None], float("-inf")).softmax(-1)
            out = torch.einsum("hqk,khd->qhd", att, vals).reshape(s, -1)
            x = x + layer.wo(out[None])[0]
            h = rms_norm(x[None], layer.post_attention_layernorm.weight, cfg.rms_eps)
            x = x + layer.mlp(h)[0]
        return lm.head(rms_norm(x[None], lm.norm.weight, cfg.rms_eps))[0]


def test_qwen_logn_and_ntk_past_seq_length_match_qwens_formulas():
    """Three rows of 70, 45 and 30 tokens (NTK alpha 7, 3 and 1) prefilled
    into a 128-slot cache, then 4 decode steps and a 3-token chunk at the
    prefill's alpha, logn at each position; the 30-token row crosses
    seq_length while it decodes, where recomputing the alpha from its key
    count would move it to 3. Logits within 1e-5 of the transcription."""
    from vlrlhf_torch.models.lm.llama import empty_pending

    model = _qwen_model()
    lens = [70, 45, 30]
    s, cache_len = max(lens), 128
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(4, 200, (len(lens), s), generator=g)
    pad = torch.arange(s)[None] < torch.tensor(lens)[:, None]
    steps = torch.randint(4, 200, (4, len(lens)), generator=g)
    chunk = torch.randint(4, 200, (len(lens), 3), generator=g)
    refs = [QwenReference(model) for _ in lens]
    with torch.no_grad():
        hidden, cache = model.lm(model.lm.embed(ids), pad, cache_len=cache_len)
        assert cache["ntk_alpha"].tolist() == [7.0, 3.0, 1.0]
        got = model.lm.head(hidden)
        for r, (ref, n) in enumerate(zip(refs, lens)):
            want = ref.forward(ids[r, :n], 0)
            np.testing.assert_allclose(got[r, :n].numpy(), want.numpy(), atol=TOL, rtol=TOL)
        lengths = torch.tensor(lens, dtype=torch.int32)
        pending = empty_pending(model.lm.cfg, len(lens), cache_len, "cpu")
        for tok in steps:
            logits, pending = model.lm.decode(tok.to(torch.int32), lengths, cache, pending)
            for r, ref in enumerate(refs):
                want = ref.forward(tok[r:r + 1], int(lengths[r]))[0]
                np.testing.assert_allclose(logits[r].numpy(), want.numpy(), atol=TOL, rtol=TOL)
            lengths = lengths + 1
        clens = torch.full((len(lens),), 3, dtype=torch.int32)
        logits, _ = model.lm.prefill_chunk(chunk, clens, lengths, cache, pending=pending,
                                           return_all_logits=True)
        for r, ref in enumerate(refs):
            want = ref.forward(chunk[r], int(lengths[r]))
            np.testing.assert_allclose(logits[r].numpy(), want.numpy(), atol=TOL, rtol=TOL)
    # both forms move these logits: without them the model is another one
    plain = dataclasses.replace(model.lm.cfg, rope_scaling_type="none", logn_attn=False)
    model.lm.cfg = plain
    with torch.no_grad():
        other = model.lm.head(model.lm(model.lm.embed(ids), pad, cache_len=cache_len)[0])
    assert (other[0, 60:70] - got[0, 60:70]).abs().max() > 1e-3


def test_qwen_continuous_slots_keep_their_prefills_alpha():
    """The continuous engine copies each admitted group's cache rows into
    its slots, "ntk_alpha" with them: text prompts of 70, 45 and 30 tokens
    (alpha 7, 3 and 1) on 2 slots, so a slot is refilled, give the
    transcription's greedy tokens row by row."""
    from vlrlhf_torch.generate.continuous import ContinuousEngine, Request
    from vlrlhf_torch.generate.engine import GenerateConfig

    model = _qwen_model()
    g = torch.Generator().manual_seed(4)
    prompts = [torch.randint(4, 200, (n,), generator=g) for n in (70, 45, 30)]
    want = []
    with torch.no_grad():
        for p in prompts:
            ref = QwenReference(model)
            toks = [int(ref.forward(p, 0)[-1].argmax())]
            for _ in range(5):
                pos = len(p) + len(toks) - 1
                toks.append(int(ref.forward(torch.tensor(toks[-1:]), pos)[-1].argmax()))
            want.append(toks)
    eng = ContinuousEngine(model, GenerateConfig(max_new_tokens=6, pad_token_id=-1),
                           n_slots=2, cache_len=128, prefill_chunk=8)
    got = eng.run([Request(input_ids=p.numpy().astype(np.int32)) for p in prompts])
    assert got == want


# ---------------------------------------------------------------------------
# Mistral's sliding window


def _mistral_hf(window):
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.utils.synthetic_checkpoint import llava_next_config

    cfg = scale_down(FAMILIES["llava_next_mistral"].make_config(), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, sliding_window=window))
    return cfg, llava_next_config(cfg)


def test_sliding_window_is_read_and_longer_inputs_refused(tmp_path):
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator, SFTCollator
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.lm.llama import empty_cache

    cfg, hf = _mistral_hf(64)
    assert hf["text_config"]["sliding_window"] == 64
    got = config_from_hf(hf, torch.float32)[1]
    assert got.lm.sliding_window == 64
    (tmp_path / "config.json").write_text(json.dumps(hf))
    with pytest.raises(ValueError, match="--max_length 128 is longer than the text model's "
                                         "sliding_window 64"):
        load_model_bundle(str(tmp_path), torch.float32, max_length=128, device="cpu")
    with pytest.raises(ValueError, match="KV cache of 128 slots is longer than the LM's "
                                         "sliding_window 64"):
        empty_cache(got.lm, 2, 128, "bf16", "cpu")
    assert empty_cache(got.lm, 2, 64, "int8", "cpu")["k"].shape[3] == 64
    proc = VLProcessor(ToyTokenizer(), FAMILIES["llava"].template,
                       ProcessorConfig(num_image_tokens=4, image_token_id=3, max_length=512,
                                       max_prompt_length=512))
    long_q = " ".join(["word"] * 80)
    ccfg = CollatorConfig(bucket_multiple=16, image_size=32, sliding_window=64)
    with pytest.raises(ValueError, match="longer than the LM's sliding_window 64"):
        GenerationCollator(proc, ccfg)([proc.generation_row(long_q, None)])
    with pytest.raises(ValueError, match="longer than the LM's sliding_window 64"):
        SFTCollator(proc, ccfg)([proc.tokenize_row_sft({"prompt": long_q, "answer": "a"})])
    short = GenerationCollator(proc, ccfg)([proc.generation_row("a short one", None)])
    assert short["input_ids"].shape[1] <= 64


def test_null_sliding_window_changes_nothing():
    """Mistral-7B-Instruct-v0.2's null window: nothing is refused, and the
    collator config a run builds from the model carries no window."""
    import argparse

    from vlrlhf_torch.cli.main import collator_config
    from vlrlhf_torch.data.collators import GenerationCollator
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.lm.llama import empty_cache

    cfg, hf = _mistral_hf(None)
    assert hf["text_config"]["sliding_window"] is None
    got = config_from_hf(hf, torch.float32)[1]
    assert got.lm.sliding_window is None
    assert empty_cache(got.lm, 1, 8192, "bf16", "cpu")["k"].shape[3] == 8192
    family = FAMILIES["llava_next_mistral"]
    proc = VLProcessor(ToyTokenizer(), family.template,
                       ProcessorConfig(num_image_tokens=4, image_token_id=3, max_length=512,
                                       max_prompt_length=512))
    ccfg = collator_config(got, family, proc, argparse.Namespace(synthetic=4))
    assert ccfg.sliding_window == 0
    batch = GenerationCollator(proc, ccfg)([proc.generation_row(" ".join(["word"] * 80), None)])
    assert batch["prompt_lens"][0] > 64
