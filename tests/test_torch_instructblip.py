"""InstructBLIP in vlrlhf_torch against vlrlhf_tpu, f32 on the CPU, on the
scaled-down family config with bridged weights (tests/test_torch_families.py
`family_port`) and a seeded WordPiece Q-Former tokenizer (utils/
synthetic_checkpoint.py, read by the port's JsonTokenizer in both
packages' processors):
  - the Q-Former alone at 1e-5, with a padded instruction mask;
  - the processor: the prefix image ids, the Q-Former ids (placeholder
    stripped, [CLS] ... [SEP]) and the DPO / SFT / generation rows equal
    vlrlhf_tpu's, and so do the collated batches with their qformer fields;
  - greedy generation with the Q-Former ids through the static Generator
    (vlrlhf_tpu's tokens) and the continuous engine (the static engine's);
  - the CE ranking (EvalRunner.run_vqa_ppl) at 1e-5;
  - a DPO step with a frozen tower (each pair's features once, with its
    own instruction) and with an unfrozen one: loss and metrics 1e-5, LoRA
    gradients rtol 1e-5;
  - an SFT step at 1e-5, and the RM step: vlrlhf_tpu's rm_step_fn encodes
    the frozen features without the Q-Former ids (ROADMAP.md §3), so the
    step is held against it on a batch without them, and the port's scores
    with them against rm_scores on features computed with them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_families import family_port

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.fixture(scope="module")
def qtok(tmp_path_factory):
    from vlrlhf_torch.data.tokenizer import JsonTokenizer
    from vlrlhf_torch.utils.synthetic_checkpoint import write_bert_tokenizer

    path = tmp_path_factory.mktemp("qformer_tokenizer")
    write_bert_tokenizer(str(path), 63)  # + [DEC] = the tiny Q-Former's 64 ids
    return JsonTokenizer(str(path))


def _processors(qtok, image_token_id=3):
    from vlrlhf_tpu.data.chat_templates import TEMPLATES as JT
    from vlrlhf_tpu.data.processor import ProcessorConfig as JPC
    from vlrlhf_tpu.data.processor import VLProcessor as JP
    from vlrlhf_tpu.data.tokenizer import ToyTokenizer as JTok
    from vlrlhf_torch.data.chat_templates import TEMPLATES
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer

    kw = dict(num_image_tokens=4, image_token="<image>", image_token_id=image_token_id,
              max_length=64, max_prompt_length=48, prefix_image_tokens=True)
    return (JP(JTok(vocab_size=250), JT["instructblip"], JPC(**kw), qformer_tokenizer=qtok),
            VLProcessor(ToyTokenizer(vocab_size=250), TEMPLATES["instructblip"],
                        ProcessorConfig(**kw), qformer_tokenizer=qtok))


FEATURES = [
    {"prompt": "What is in the photo?", "chosen": "a dog on the table", "rejected": "a cat",
     "answer": "a dog", "img_path": "a.jpg"},
    {"prompt": "<image>Describe the picture in detail please.", "chosen": "two people",
     "rejected": "a red car in the street", "answer": "people", "img_path": "b.jpg"},
]


def _loader(path, size, mode):
    return np.random.default_rng(len(path) + ord(path[0])).integers(
        0, 255, (size, size, 3), np.uint8)


def _collators(kind, qtok):
    from vlrlhf_tpu.data import collators as JC
    from vlrlhf_torch.data import collators as TC

    jp, tp = _processors(qtok)
    kw = dict(pad_token_id=0, bucket_multiple=16, image_size=16)
    return (jp, getattr(JC, kind)(jp, JC.CollatorConfig(**kw), _loader),
            tp, getattr(TC, kind)(tp, TC.CollatorConfig(**kw), _loader))


def test_qformer_matches_jax():
    from vlrlhf_tpu.models.vision.qformer import qformer_forward

    jcfg, params, model = family_port("instructblip", seed=5)
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, jcfg.vision.seq_len, 16)).astype(np.float32)
    ids = rng.integers(0, 64, (3, 9)).astype(np.int32)
    mask = np.ones((3, 9), bool)
    mask[1, 3:] = False
    mask[2, 7:] = False
    want = jax.jit(qformer_forward, static_argnums=0)(
        jcfg.qformer, params["qformer"], jnp.asarray(feats), jnp.asarray(ids), jnp.asarray(mask))
    with torch.no_grad():
        got = model.qformer(_t(feats), _t(ids), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_rows_and_batches_match_jax(qtok):
    jp, tp = _processors(qtok)
    q = tp.qformer_ids("<image>What is in the photo?")
    assert q == jp.qformer_ids("<image>What is in the photo?")
    assert q[0] == qtok.convert_token_to_id("[CLS]") and q[-1] == qtok.convert_token_to_id("[SEP]")
    assert tp.maybe_prefix_image_ids([1, 5, 6], 1) == [3, 1, 5, 6]
    for f in FEATURES:
        assert tp.tokenize_row_dpo(f) == jp.tokenize_row_dpo(f)
        sft = {k: f[k] for k in ("prompt", "answer", "img_path")}
        assert tp.tokenize_row_sft(sft) == jp.tokenize_row_sft(sft)
        row = tp.generation_row(f["prompt"], f["img_path"])
        assert row["input_ids"][0] == 3 and row["qformer_input_ids"] == jp.qformer_ids(f["prompt"])
    for kind, rows in (("DPOCollator", lambda p: [p.tokenize_row_dpo(f) for f in FEATURES]),
                       ("SFTCollator", lambda p: [p.tokenize_row_sft(
                           {k: f[k] for k in ("prompt", "answer", "img_path")})
                           for f in FEATURES])):
        jp, jc, tp, tc = _collators(kind, qtok)
        want, got = jc(rows(jp)), tc(rows(tp))
        assert set(got) == set(want) and "qformer_mask" in got
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{kind} {k}")


def _gen_batch(qtok):
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator

    _, tp = _processors(qtok, image_token_id=250)
    coll = GenerationCollator(tp, CollatorConfig(pad_token_id=0, bucket_multiple=16,
                                                 image_size=16), _loader)
    rows = [tp.generation_row(p, img) for p, img in (
        ("What is in the photo?", "a.jpg"), ("Describe the picture in detail please.", "b.jpg"),
        ("Is there a dog?", "c.jpg"))]
    return coll(rows), coll, rows


def test_qformer_ids_through_the_engines_match_jax(qtok):
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGC
    from vlrlhf_tpu.generate.engine import Generator as JGen
    from vlrlhf_torch.generate.continuous import ContinuousEngine, request_from_batch
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator

    jcfg, params, model = family_port("instructblip", seed=6)
    batch, coll, rows = _gen_batch(qtok)
    assert batch["qformer_mask"].sum(1).tolist() != [batch["qformer_mask"].shape[1]] * 3
    want = np.asarray(JGen(jcfg, JGC(max_new_tokens=8, pad_token_id=-1))(params, batch))
    got = Generator(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1))(batch).numpy()
    np.testing.assert_array_equal(got, want)
    # the instruction matters: without it the tokens differ
    plain = {k: v for k, v in batch.items() if not k.startswith("qformer")}
    assert not np.array_equal(
        Generator(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1))(plain).numpy(), got)
    reqs = [request_from_batch(coll([r]), 0, True) for r in rows]
    assert len({len(r.qformer_input_ids) for r in reqs}) > 1
    eng = ContinuousEngine(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1),
                           n_slots=3, cache_len=64, prefill_chunk=16)
    eng.MAX_PREFILL_GROUP = 3
    outs = eng.run(reqs)
    for o, w in zip(outs, want):
        assert o == [int(t) for t in w if t != -1]


def test_ce_ranking_matches_jax(qtok):
    from vlrlhf_tpu.data.collators import CollatorConfig as JCC
    from vlrlhf_tpu.eval.harness import EvalRunner as JRunner
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGC
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.engine import GenerateConfig

    jcfg, params, model = family_port("instructblip", seed=7)
    jp, tp = _processors(qtok, image_token_id=250)
    rows = [{"question": f["prompt"], "answer": a, "img": f["img_path"]}
            for f in FEATURES for a in (f["chosen"], f["rejected"])]
    kw = dict(pad_token_id=0, bucket_multiple=16, image_size=16)
    want = JRunner(jcfg, params, jp, JGC(max_new_tokens=4), JCC(**kw),
                   _loader).run_vqa_ppl(rows, batch_size=4)
    got = EvalRunner(model, tp, GenerateConfig(max_new_tokens=4), CollatorConfig(**kw),
                     _loader).run_vqa_ppl(rows, batch_size=4)
    np.testing.assert_allclose([r["ppl"] for r in got], [r["ppl"] for r in want],
                               atol=TOL, rtol=TOL)


def _train_batch(kind, qtok, image_token_id=250):
    from vlrlhf_torch.data import collators as TC

    _, tp = _processors(qtok, image_token_id)
    coll = getattr(TC, kind)(tp, TC.CollatorConfig(pad_token_id=0, bucket_multiple=16,
                                                   image_size=16), _loader)
    if kind == "SFTCollator":
        return coll([tp.tokenize_row_sft({k: f[k] for k in ("prompt", "answer", "img_path")})
                     for f in FEATURES])
    return coll([tp.tokenize_row_dpo(f) for f in FEATURES])


@pytest.mark.parametrize("frozen", [True, False])
def test_dpo_step_matches_jax(frozen, qtok):
    from tests.test_torch_dpo import _assert_trees, _capture_grads, _torch_steps
    from vlrlhf_tpu.train.dpo import DPOConfig, dpo_step_fn
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_torch.train import dpo as tdpo
    from vlrlhf_torch.train.train_state import OptimizerConfig
    from vlrlhf_torch.utils.bridge import lora_tree

    jcfg, params, model, lcfg, adapters = family_port("instructblip", seed=8, lora=True)
    batch = _train_batch("DPOCollator", qtok)
    kw = dict(beta=0.1, lora_scale=lcfg.scale, frozen_vision=frozen)
    tx = _capture_grads()
    # jitted: the eager Q-Former of dpo_step_fn dispatches op by op
    jstate, jm = jax.jit(lambda st, p, b: dpo_step_fn(jcfg, DPOConfig(**kw), tx, st, p, b))(
        jinit(adapters, tx), params, {k: jnp.asarray(v) for k, v in batch.items()})
    jm = {k: float(v) for k, v in jm.items()}
    _, tm = _torch_steps(model, kw, OptimizerConfig(learning_rate=5e-3, warmup_steps=1,
                                                    total_steps=50),
                         tdpo.batch_to_device(batch, "cpu"))
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], atol=TOL, rtol=TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, "grad")


def test_sft_and_rm_steps_match_jax(qtok):
    from tests.test_torch_sft_rm import OPT
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.models.vlm import encode_images, init_rm_head
    from vlrlhf_tpu.train.rm import RMConfig as JRM
    from vlrlhf_tpu.train.rm import make_rm_step, rm_scores as jrm_scores
    from vlrlhf_tpu.train.sft import SFTConfig as JSFT
    from vlrlhf_tpu.train.sft import make_sft_step
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_tpu.train.train_state import make_optimizer
    from vlrlhf_torch.models.common import Ctx
    from vlrlhf_torch.models.vlm import init_rm_head as tinit_rm_head
    from vlrlhf_torch.train.dpo import adapter_params, batch_to_device, pair_image_features
    from vlrlhf_torch.train.rm import RMConfig, rm_scores, rm_step
    from vlrlhf_torch.train.sft import SFTConfig, sft_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    jcfg, params, model, lcfg, adapters = family_port("instructblip", seed=9, lora=True)
    ocfg = OptimizerConfig(**OPT)
    # SFT: the Q-Former ids ride in the batch, both packages use them
    batch = _train_batch("SFTCollator", qtok)
    tx = make_optimizer(JOpt(**OPT), adapters)
    jstate = jinit(adapters, tx)
    state = init_train_state(adapter_params(model), ocfg)
    jstep = make_sft_step(jcfg, JSFT(lora_scale=lcfg.scale), tx)
    tb = batch_to_device(batch, "cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, params, {k: jnp.asarray(v) for k, v in batch.items()})
        tm = sft_step(model, SFTConfig(lora_scale=lcfg.scale), ocfg, state, tb)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL,
                                       err_msg=k)
    # RM: the port's scores use each pair's instruction
    jcfg, params, model, lcfg, adapters = family_port("instructblip", seed=9, lora=True)
    batch = _train_batch("RMCollator", qtok)
    tb = batch_to_device(batch, "cpu")
    kernel = np.random.default_rng(1).normal(size=(32, 1)).astype(np.float32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    b = jb["pixel_values"].shape[0]

    @jax.jit  # the eager Q-Former and forward dispatch op by op
    def jscores(params, adapters, head, jb):
        feats = encode_images(jcfg, params, jb["pixel_values"].reshape(b, 16, 16, 3),
                              qformer_ids=jb["qformer_input_ids"],
                              qformer_mask=jb["qformer_mask"])
        return jrm_scores(jcfg, params, {"kernel": head}, jb,
                          JCtx(adapters=adapters, lora_scale=lcfg.scale),
                          jnp.concatenate([feats, feats]))

    want = jscores(params, adapters, jnp.asarray(kernel), jb)
    with torch.no_grad():
        got = rm_scores(model, _t(kernel), tb, Ctx(adapters=True, lora_scale=lcfg.scale),
                        pair_image_features(model, tb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the step, on the batch without the ids (vlrlhf_tpu's step drops them)
    plain = {k: v for k, v in batch.items() if not k.startswith("qformer")}
    trainable = {"adapters": adapters, "rm_head": init_rm_head(32, jnp.float32)}
    tx = make_optimizer(JOpt(**OPT), trainable)
    jstate = jinit(trainable, tx)
    head = tinit_rm_head(32)["kernel"]
    state = init_train_state(adapter_params(model) + [head], ocfg)
    jstep = make_rm_step(jcfg, JRM(lora_scale=lcfg.scale), tx)
    tplain = batch_to_device(plain, "cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, params, {k: jnp.asarray(v) for k, v in plain.items()})
        tm = rm_step(model, RMConfig(lora_scale=lcfg.scale), ocfg, state, head, tplain)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL,
                                       err_msg=k)
