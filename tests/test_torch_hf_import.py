"""HF checkpoint import and export in vlrlhf_torch (utils/hf_port.py,
utils/hf_export.py, cli/loading.py) against transformers and vlrlhf_tpu,
f32 on the CPU:
  - load_model_bundle on a tiny LlavaForConditionalGeneration saved with
    save_pretrained: logits equal transformers' at tests/test_hf_port.py's
    tolerances; every parameter equals vlrlhf_tpu's load_model_bundle
    bridged into the port (utils/bridge.py), exactly;
  - the published llava-hf/llava-1.5-7b-hf, Qwen/Qwen-VL-Chat and
    internlm/internlm-xcomposer2-vl-7b config.json files map to the port's
    7B configs as vlrlhf_tpu's config_from_hf maps them (Qwen's trained
    context is its seq_length, 2,048, its head width kv_channels); an
    unknown architecture is refused;
  - int8 and int4 quantization during the import give the codes of
    quantizing after it (the serving, QLoRA and wide pattern sets);
  - a GPTQ-layout linear imports as vlrlhf_tpu's import does;
  - the export equals vlrlhf_tpu's export_llava key for key and bit for
    bit, import(export(x)) is x, and the written directory loads in
    transformers with equal logits;
  - the streaming import's host memory stays within the model and a few of
    its largest tensors (tests/test_streaming_port.py:245's check);
  - the DPO loss of two imported models equals the HF pipeline's within
    1e-3 (tests/test_e2e_loss_parity.py, out of the slow mark here)."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vlrlhf_torch.cli.loading import config_from_hf, load_model_bundle
from vlrlhf_torch.utils.synthetic_checkpoint import write_tokenizer

IMG = 32000  # llava's image token id; the tiny models keep llava's text vocab
N_IMG = 4  # (28 / 14)^2 image tokens


def tiny_hf_llava(seed=0, hidden=48, inter=96, vis_hidden=32):
    """tests/test_hf_port.py's _tiny_llava with llava's 32064-token vocab
    and image id, so that the seeded llama tokenizer fits it."""
    from transformers import LlavaConfig, LlavaForConditionalGeneration

    torch.manual_seed(seed)
    cfg = LlavaConfig(
        vision_config=dict(hidden_size=vis_hidden, intermediate_size=2 * vis_hidden,
                           num_hidden_layers=3, num_attention_heads=4, image_size=28,
                           patch_size=14, projection_dim=16),
        text_config=dict(vocab_size=32064, hidden_size=hidden, intermediate_size=inter,
                         num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
                         max_position_embeddings=128, rms_norm_eps=1e-5),
        image_token_index=IMG, vision_feature_layer=-2,
        vision_feature_select_strategy="default", projector_hidden_act="gelu")
    return LlavaForConditionalGeneration(cfg).eval().float()


def save_tiny(path, seed=0, **kw):
    """A tiny HF LLaVA checkpoint directory with the seeded tokenizer;
    returns the HF model."""
    hf = tiny_hf_llava(seed, **kw)
    hf.save_pretrained(str(path))
    write_tokenizer(str(path))
    return hf


def _inputs(b=2, s=20, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 90, (b, s), generator=g)
    ids[:, 3: 3 + N_IMG] = IMG
    return ids, torch.randn(b, 3, 28, 28, generator=g)


def hf_forms(cfg, imported):
    """`cfg` with the fields an HF import reads from config.json and a
    config bridged from vlrlhf_tpu (or a family config) fixes otherwise
    taken from `imported`: the GELU forms of the tower, projector and
    Q-Former, Qwen's NTK and logn, Mistral's sliding window."""
    lm = dataclasses.replace(cfg.lm, rope_scaling_type=imported.lm.rope_scaling_type,
                             logn_attn=imported.lm.logn_attn,
                             sliding_window=imported.lm.sliding_window)
    qf = cfg.qformer
    if qf is not None and imported.qformer is not None:
        qf = dataclasses.replace(qf, act=imported.qformer.act)
    return dataclasses.replace(
        cfg, lm=lm, qformer=qf, vision=dataclasses.replace(cfg.vision, act=imported.vision.act),
        projector=dataclasses.replace(cfg.projector, act=imported.projector.act))


def port_logits(model, ids, pixels, pad_mask=None):
    b, s = ids.shape
    pos = torch.arange(3, 3 + N_IMG, dtype=torch.int32)[None].expand(b, N_IMG)
    with torch.no_grad():
        h, _ = model(ids, pixels.permute(0, 2, 3, 1)[:, None], pos,
                     torch.ones(b, s, dtype=torch.bool) if pad_mask is None else pad_mask)
        return model.head(h)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = tmp_path_factory.mktemp("tiny_llava")
    return str(path), save_tiny(path)


def test_import_matches_transformers_and_jax(tiny):
    import jax
    import jax.numpy as jnp

    from vlrlhf_tpu.cli.loading import load_model_bundle as jload
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    path, hf = tiny
    family, cfg, model, proc = load_model_bundle(path, torch.float32, device="cpu")
    assert family.name == "llava" and cfg.num_image_tokens == N_IMG
    assert proc.cfg.image_token_id == IMG and proc.tokenizer.vocab_size == 32002
    ids, px = _inputs()
    with torch.no_grad():
        want = hf(input_ids=ids, pixel_values=px).logits.numpy()
    np.testing.assert_allclose(port_logits(model, ids, px).numpy(), want, atol=2e-4, rtol=2e-3)

    _, jcfg, jparams, _ = jload(path, jnp.float32)
    bridged = load_vlm_params(VLM(vlm_config_from(jcfg), device="cpu"),
                              jax.device_get(jparams))
    got, exp = model.state_dict(), bridged.state_dict()
    assert got.keys() == exp.keys()
    for k in got:
        assert torch.equal(got[k], exp[k]), k


def test_imported_gelu_forms_give_transformers_logits_at_1e_5(tiny):
    """The projector's "gelu" is erf (projector_hidden_act), CLIP's
    quick_gelu: the imported model's logits are transformers' within 1e-5.
    On these inputs the erf projector reads 3.9e-7 off, the tanh form
    vlrlhf_tpu computes 2.1e-5 (7.6e-6 on `_inputs()`'s)."""
    path, hf = tiny
    _, cfg, model, _ = load_model_bundle(path, torch.float32, device="cpu")
    assert (cfg.projector.act, cfg.vision.act) == ("gelu", "quick_gelu")
    ids, px = _inputs(seed=3)
    with torch.no_grad():
        want = hf(input_ids=ids, pixel_values=px).logits.numpy()
    assert np.abs(port_logits(model, ids, px).numpy() - want).max() <= 1e-5


def test_published_llava_15_config_and_refusals():
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.utils.synthetic_checkpoint import LLAVA_15_7B_CONFIG, llava_config

    _, cfg = config_from_hf(LLAVA_15_7B_CONFIG)
    assert cfg == hf_forms(_llava_7b(), cfg) and cfg.projector.act == "gelu"
    small = dataclasses.replace(_llava_7b(), lm=dataclasses.replace(_llava_7b().lm, num_layers=2))
    assert config_from_hf(llava_config(small))[1] == small
    from vlrlhf_tpu.cli.loading import config_from_hf as jconfig
    from vlrlhf_torch.models.config import _internlm_xc2_7b, _qwen_vl_chat
    from vlrlhf_torch.utils.bridge import vlm_config_from
    from vlrlhf_torch.utils.synthetic_checkpoint import QWEN_VL_CHAT_CONFIG, XC2_7B_CONFIG

    qwen = _qwen_vl_chat()
    for hf, want in ((QWEN_VL_CHAT_CONFIG, dataclasses.replace(qwen, lm=dataclasses.replace(
            qwen.lm, max_position_embeddings=2048, head_dim=128))),
                     (XC2_7B_CONFIG, _internlm_xc2_7b())):
        family, got = config_from_hf(hf)
        assert got == hf_forms(want, got) and family.name == want.family
        assert hf_forms(vlm_config_from(jconfig(hf)[1]), got) == got
    with pytest.raises(ValueError, match="not a family vlrlhf_tpu supports"):
        config_from_hf(dict(LLAVA_15_7B_CONFIG, architectures=["GPT2LMHeadModel"]))


def _port_model(cfg, seed=0):
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.vlm import VLM

    model = VLM(cfg, device="cpu")
    init_random_(model, torch.Generator().manual_seed(seed))
    return model


def _wide_cfg(dtype=torch.bfloat16):
    """LM widths that are multiples of 128 (int4 applies), a tower whose
    fc2 input (64) is not (int8 fallback)."""
    from vlrlhf_torch.models.config import _llava_7b, scale_down

    cfg = scale_down(_llava_7b(), dtype=dtype)
    return dataclasses.replace(
        cfg, image_token_id=IMG,
        lm=dataclasses.replace(cfg.lm, vocab_size=32064, hidden_size=128,
                               intermediate_size=256, head_dim=0, num_heads=4, num_kv_heads=4),
        vision=dataclasses.replace(cfg.vision, hidden_size=128, mlp_dim=64),
        projector=dataclasses.replace(cfg.projector, in_dim=128, out_dim=128))


@pytest.mark.parametrize("patterns,bits", [
    ("DEFAULT_QUANT_PATTERNS", 8), ("DEFAULT_QUANT_PATTERNS", 4),
    ("TRAIN_QUANT_PATTERNS_WIDE", 4),
])
def test_quantize_during_import_equals_quantize_after(tmp_path, patterns, bits):
    from vlrlhf_torch.ops import quant
    from vlrlhf_torch.utils.synthetic_checkpoint import write_llava_checkpoint

    cfg = _wide_cfg()
    write_llava_checkpoint(str(tmp_path), _port_model(cfg).state_dict(), cfg)
    pats = getattr(quant, patterns)
    _, _, during, _ = load_model_bundle(str(tmp_path), torch.bfloat16, device="cpu",
                                        quantize_patterns=pats, quantize_bits=bits)
    _, _, after, _ = load_model_bundle(str(tmp_path), torch.bfloat16, device="cpu")
    done = quant.quantize_params(after, pats, bits=bits)
    assert len(done) > 0
    got, want = during.state_dict(), after.state_dict()
    assert got.keys() == want.keys()
    assert any(k.endswith("weight_q4") for k in got) == (bits == 4)
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_gptq_linear_imports_as_jax_does(tmp_path):
    from tests.test_gptq import _synth
    from vlrlhf_tpu.utils import hf_port as jport
    from vlrlhf_torch.utils.gptq import pack_gptq_reference
    from vlrlhf_torch.utils.safetensors_io import SafetensorsFile, save_file
    from vlrlhf_torch.utils.synthetic_checkpoint import write_llava_checkpoint

    cfg = _wide_cfg(torch.float32)
    write_llava_checkpoint(str(tmp_path), _port_model(cfg).state_dict(), cfg, dtype="float32")
    sd = dict(SafetensorsFile(str(tmp_path / "model.safetensors")))
    prefix = "language_model.model.layers.1.mlp.down_proj"  # in 256, out 128
    q, z, s = _synth(5, sym=False, gsz=128, din=256, dout=128)
    qweight, qzeros, scales, g_idx = pack_gptq_reference(q, z, s, 128)
    del sd[f"{prefix}.weight"]
    sd.update({f"{prefix}.qweight": torch.from_numpy(qweight),
               f"{prefix}.qzeros": torch.from_numpy(qzeros),
               f"{prefix}.scales": torch.from_numpy(scales),
               f"{prefix}.g_idx": torch.from_numpy(g_idx),
               f"{prefix}.bias": torch.zeros(128)})
    save_file({k: v.clone() for k, v in sd.items()}, str(tmp_path / "model.safetensors"))
    _, _, model, _ = load_model_bundle(str(tmp_path), torch.float32, device="cpu")
    lin = model.lm.layers[1].down
    want = jport._linear({k: v.numpy() for k, v in sd.items() if k.startswith(prefix)}, prefix)
    assert lin.weight is None and lin.weight_gbias is not None
    np.testing.assert_array_equal(lin.weight_q4.numpy(), np.asarray(want["kernel_q4"]).T)
    for ours, theirs in (("weight_scale4", "kernel_scale"), ("weight_gbias", "kernel_gbias")):
        np.testing.assert_array_equal(getattr(lin, ours).float().numpy(),
                                      np.asarray(want[theirs], np.float32).T)


def test_export_matches_jax_and_round_trips(tiny, tmp_path):
    from transformers import LlavaForConditionalGeneration

    from vlrlhf_tpu.utils import hf_export as jexport
    from vlrlhf_tpu.utils import hf_port as jport
    from vlrlhf_torch.utils.hf_export import export_hf, export_llava

    path, hf = tiny
    _, cfg, model, _ = load_model_bundle(path, torch.float32, device="cpu")
    hf_sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    from vlrlhf_tpu.cli.loading import config_from_hf as jconfig

    with open(os.path.join(path, "config.json")) as f:
        _, jcfg = jconfig(json.load(f))
    want = jexport.export_llava(jport.port_llava(hf_sd, jcfg), jcfg)
    got = export_llava(model.state_dict(), cfg)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)

    out = tmp_path / "exported"
    export_hf(model.state_dict(), cfg, "llava", str(out), base_dir=path, dtype="float32")
    assert {"config.json", "model.safetensors", "tokenizer.json",
            "tokenizer_config.json"} <= set(os.listdir(out))
    _, _, back, _ = load_model_bundle(str(out), torch.float32, device="cpu")
    a, b = model.state_dict(), back.state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    reloaded = LlavaForConditionalGeneration.from_pretrained(str(out)).eval().float()
    ids, px = _inputs(seed=3)
    with torch.no_grad():
        theirs = reloaded(input_ids=ids, pixel_values=px).logits.numpy()
    np.testing.assert_allclose(port_logits(model, ids, px).numpy(), theirs, atol=2e-4, rtol=2e-3)


def test_pytorch_bin_checkpoint_imports_as_the_safetensors_one(tiny, tmp_path):
    """The `pytorch_model*.bin` branch (torch.load, weights_only): two
    shards read one at a time, the same model as from safetensors."""
    from vlrlhf_torch.utils.hf_port import LazyStateDict, load_hf_state_dict

    path, hf = tiny
    hf.save_pretrained(str(tmp_path), safe_serialization=False, max_shard_size="200KB")
    write_tokenizer(str(tmp_path))
    assert not list(tmp_path.glob("*.safetensors"))
    assert len(list(tmp_path.glob("pytorch_model*.bin"))) >= 2
    lazy, eager = LazyStateDict(str(tmp_path)), load_hf_state_dict(str(tmp_path))
    assert set(lazy) == set(eager) and all(torch.equal(lazy[k], eager[k]) for k in eager)
    a = load_model_bundle(str(tmp_path), torch.float32, device="cpu")[2].state_dict()
    b = load_model_bundle(path, torch.float32, device="cpu")[2].state_dict()
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_quantized_state_dict_export_is_refused():
    from vlrlhf_torch.ops.quant import DEFAULT_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.utils.hf_export import export_llava

    cfg = _wide_cfg(torch.float32)
    model = _port_model(cfg)
    quantize_params(model, DEFAULT_QUANT_PATTERNS)
    with pytest.raises(ValueError, match="quantized: dequantize"):
        export_llava(model.state_dict(), cfg)


_RSS_WORKER = r"""
import json, sys, torch
from vlrlhf_torch.cli.loading import load_model_bundle

def anon_mb():
    # RssAnon: anonymous memory only; the mapped checkpoint is page cache
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("RssAnon"):
                return int(line.split()[1]) / 1024.0

base = anon_mb()
_, _, model, _ = load_model_bundle(sys.argv[1], torch.bfloat16, device="cpu")
end = anon_mb()
resident = sum(p.numel() * p.element_size() for p in model.parameters()) / 2**20
print(json.dumps({"delta": end - base, "resident": resident}))
"""


def test_streaming_import_bounds_host_rss(tmp_path):
    """A checkpoint written in f32 and imported as bf16: the host keeps the
    bf16 model and, while it imports, about one f32 tensor; an eager import
    would hold the whole f32 state dict (twice the model) besides."""
    import dataclasses as dc

    from vlrlhf_torch.models.config import _llava_7b, scale_down
    from vlrlhf_torch.utils.synthetic_checkpoint import write_llava_checkpoint

    small = scale_down(_llava_7b(), dtype=torch.float32)
    cfg = dc.replace(small, image_token_id=IMG, lm=dc.replace(
        small.lm, vocab_size=32064, hidden_size=768, intermediate_size=1536, num_layers=8,
        num_heads=12, num_kv_heads=12, head_dim=0))
    cfg = dc.replace(cfg, projector=dc.replace(cfg.projector, out_dim=768))
    total = write_llava_checkpoint(str(tmp_path), _port_model(cfg).state_dict(), cfg,
                                   dtype="float32") / 2**20
    largest = 32064 * 768 * 4 / 2**20  # embed_tokens / lm_head in f32
    script = tmp_path / "worker.py"
    script.write_text(_RSS_WORKER)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, str(script), str(tmp_path)], capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert abs(r["resident"] - total / 2) < 0.01 * total
    assert r["delta"] < r["resident"] + 2 * largest + 64, (r, total, largest)
    assert r["delta"] < 0.6 * (total + r["resident"]), (r, total)


def _torch_logps(logits, labels):
    labels = labels[:, 1:].clone()
    logits = logits[:, :-1, :]
    mask = labels != -100
    labels[labels == -100] = 0
    per_tok = torch.gather(logits.log_softmax(-1), 2, labels.unsqueeze(2)).squeeze(2)
    return (per_tok * mask).sum(-1)


def test_dpo_loss_of_imported_models_matches_hf(tmp_path):
    """The BASELINE.md target on the port: two independently initialized HF
    LLaVAs (policy, reference) saved and imported; the port's batch_logps
    and dpo_loss against the reference trainer's formulas on HF's logits."""
    from vlrlhf_torch.train.losses import batch_logps, dpo_loss

    pol_hf = save_tiny(tmp_path / "policy", seed=1)
    ref_hf = save_tiny(tmp_path / "ref", seed=7)
    b2, s = 4, 24
    ids, px = _inputs(b2, s, seed=5)
    labels = ids.clone()
    labels[:, : s // 2] = -100
    with torch.no_grad():
        pl = _torch_logps(pol_hf(input_ids=ids, pixel_values=px).logits.float(), labels)
        rl = _torch_logps(ref_hf(input_ids=ids, pixel_values=px).logits.float(), labels)
    beta = 0.1
    want = (-F.logsigmoid(beta * ((pl[:2] - pl[2:]) - (rl[:2] - rl[2:])))).mean().item()

    def logps(name):
        _, _, model, _ = load_model_bundle(str(tmp_path / name), torch.float32, device="cpu")
        return batch_logps(port_logits(model, ids, px), labels)

    tpl, trl = logps("policy"), logps("ref")
    out = dpo_loss(tpl[:2], tpl[2:], trl[:2], trl[2:], beta=beta)
    assert abs(float(out.loss) - want) < 1e-3, (float(out.loss), want)
    np.testing.assert_allclose(tpl.numpy(), pl.numpy(), atol=5e-3, rtol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_host_quantization_equals_the_cards(bits):
    """The importer quantizes on the host what `quantize_params` after a
    load quantizes on the card: the codes and scales must be the same bits
    (a Python-scalar divisor made the card's scales one rounding off, PR 11's
    first card run). Card only."""
    from vlrlhf_torch.ops.int4 import quantize_int4
    from vlrlhf_torch.ops.quant import quantize_linear

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card's arithmetic with the host's")
    w = torch.randn(1024, 4096, generator=torch.Generator().manual_seed(bits)).bfloat16()
    fn = quantize_int4 if bits == 4 else quantize_linear
    for host, card in zip(fn(w), fn(w.cuda())):
        assert torch.equal(host, card.cpu())
