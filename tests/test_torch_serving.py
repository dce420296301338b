"""vlrlhf_torch serving path vs vlrlhf_tpu's, greedy, f32 on CPU, same
weights: the static Generator and the ContinuousEngine must emit the JAX
engines' tokens token for token; serve_http must answer with the same
tokens; the copied data/ modules must build byte-identical batches."""

import argparse
import json
import threading
import urllib.request
import zlib

import jax
import numpy as np
import pytest
import torch

from tests.test_continuous import _generator_expected, _requests
from tests.test_torch_models import ported
from vlrlhf_torch.generate.continuous import ContinuousEngine, Request
from vlrlhf_torch.generate.engine import GenerateConfig, Generator


def _to_port(reqs):
    return [
        Request(input_ids=r.input_ids, pixel_values=r.pixel_values,
                image_positions=r.image_positions, max_new_tokens=r.max_new_tokens)
        for r in reqs
    ]


def test_generator_greedy_matches_jax():
    jcfg, params, model = ported()
    reqs = _requests(n=3, seed=11)
    want = _generator_expected(jcfg, params, reqs, max_new=10)
    gen = Generator(model, GenerateConfig(max_new_tokens=10, pad_token_id=-1))
    for r, w in zip(reqs, want):
        L = len(r.input_ids)
        batch = {
            "input_ids": r.input_ids[None],
            "pad_mask": np.ones((1, L), bool),
            "prompt_lens": np.asarray([L], np.int32),
            "pixel_values": r.pixel_values[None, None],
            "image_positions": r.image_positions[None],
        }
        got = [int(t) for t in gen(batch)[0] if t != -1]
        assert got == w, (got, w)


def test_generator_batched_rows_match_jax_batch():
    """A right-padded batch of two prompts through both static engines."""
    from tests.test_torch_models import prompt_batch
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator

    jcfg, params, model = ported(seed=4)
    ids, pad, lens, px, pos = prompt_batch(seed=9)
    batch = {"input_ids": ids, "pad_mask": pad, "prompt_lens": lens,
             "pixel_values": px, "image_positions": pos}
    want = np.asarray(JGenerator(jcfg, JGenerateConfig(max_new_tokens=6, pad_token_id=-1))(
        params, batch))
    got = Generator(model, GenerateConfig(max_new_tokens=6, pad_token_id=-1))(batch)
    np.testing.assert_array_equal(got.numpy(), want)


def test_continuous_engine_matches_jax_engine():
    from vlrlhf_tpu.generate.continuous import ContinuousEngine as JEngine
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig

    jcfg, params, model = ported()
    reqs = _requests()
    want = JEngine(jcfg, JGenerateConfig(max_new_tokens=10, pad_token_id=-1),
                   n_slots=2, cache_len=64, prefill_chunk=8).run(params, reqs)
    eng = ContinuousEngine(model, GenerateConfig(max_new_tokens=10, pad_token_id=-1),
                           n_slots=2, cache_len=64, prefill_chunk=8)
    got = eng.run(_to_port(reqs))
    assert got == want
    assert eng.last_admits >= 3 and eng.last_bursts >= 2


def test_continuous_engine_eos_and_text_only():
    """An eos id frees its slot early; text-only rows merge nothing."""
    from vlrlhf_tpu.generate.continuous import ContinuousEngine as JEngine
    from vlrlhf_tpu.generate.continuous import Request as JRequest
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig

    jcfg, params, model = ported(seed=2)
    rng = np.random.default_rng(7)
    texts = [rng.integers(4, 100, (12 + 3 * i,)).astype(np.int32) for i in range(3)]
    jreqs = _requests(n=2, seed=3) + [JRequest(input_ids=t, max_new_tokens=6) for t in texts]
    first = JEngine(jcfg, JGenerateConfig(max_new_tokens=8, pad_token_id=-1),
                    n_slots=2, cache_len=64, prefill_chunk=8).run(params, jreqs)
    eos = first[0][2] if len(first[0]) > 2 else first[0][-1]
    jgen = JGenerateConfig(max_new_tokens=8, pad_token_id=-1, eos_token_ids=(eos,))
    want = JEngine(jcfg, jgen, n_slots=2, cache_len=64, prefill_chunk=8).run(params, jreqs)
    eng = ContinuousEngine(
        model, GenerateConfig(max_new_tokens=8, pad_token_id=-1, eos_token_ids=(eos,)),
        n_slots=2, cache_len=64, prefill_chunk=8,
    )
    assert eng.run(_to_port(jreqs)) == want


def _seeded_image(path, size, mode):
    seed = zlib.crc32(str(path).encode())
    return np.random.default_rng(seed).integers(0, 256, (size, size, 3), dtype=np.uint8)


def _bundles():
    """One synthetic llava model in both packages + both processors."""
    from vlrlhf_tpu.cli.main import _synthetic_bundle
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    args = argparse.Namespace(model_family="llava", max_length=64,
                              max_prompt_length=48, synthetic=2)
    family, jcfg, params, jproc = _synthetic_bundle(args)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    pcfg = ProcessorConfig(**{k: getattr(jproc.cfg, k) for k in (
        "num_image_tokens", "image_token", "image_token_id")})
    tproc = VLProcessor(ToyTokenizer(), FAMILIES["llava"].template, pcfg)
    return jcfg, params, jproc, model, tproc


def test_collator_batches_byte_identical():
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.data.collators import GenerationCollator as JCollator
    from vlrlhf_tpu.data.processor import make_single_turn_conv as jconv
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv

    _, _, jproc, _, tproc = _bundles()
    questions = ["what is in the picture?", "describe item 3 w7 w9", "count: a, b, c!"]
    images = ["a.png", None, "c.jpg"]
    jrows, trows = [], []
    for q, img in zip(questions, images):
        n = 0 if img is None else 1
        jids = jproc.process_conv(jconv(jproc.format_multimodal_prompt(q, n), ""))
        tids = tproc.process_conv(make_single_turn_conv(tproc.format_multimodal_prompt(q, n), ""))
        assert (jids["input_ids"], jids["raw_str"]) == (tids["input_ids"], tids["raw_str"])
        jrows.append({"input_ids": jids["input_ids"], "img_path": img})
        trows.append({"input_ids": tids["input_ids"], "img_path": img})
    for bucket in (32, 128):
        jb = JCollator(jproc, JCollatorConfig(bucket_multiple=bucket, image_size=16),
                       _seeded_image)(jrows)
        tb = GenerationCollator(tproc, CollatorConfig(bucket_multiple=bucket, image_size=16),
                                _seeded_image)(trows)
        assert set(tb) == set(jb)
        for key in tb:
            assert tb[key].dtype == jb[key].dtype, key
            assert tb[key].tobytes() == jb[key].tobytes(), key


def test_serve_http_matches_jax_engine():
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.generate.continuous import ContinuousEngine as JEngine
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.server import RequestBuilder as JBuilder
    from vlrlhf_torch.cli.main import build_server

    jcfg, params, jproc, model, tproc = _bundles()
    questions = [("what is shown?", "img0.png"), ("name two w3 things", None),
                 ("where is it?", "img2.png")]
    jbuild = JBuilder(jproc, JCollatorConfig(bucket_multiple=32, image_size=16),
                      _seeded_image)
    jreqs = [jbuild.build(q, img, 5) for q, img in questions]
    want = JEngine(jcfg, JGenerateConfig(max_new_tokens=5, pad_token_id=0,
                                         eos_token_ids=(2,)),
                   n_slots=2, cache_len=128, prefill_chunk=128).run(params, jreqs)
    args = argparse.Namespace(
        max_new_tokens=5, synthetic=2, do_sample=False, temperature=1.0, top_k=None,
        top_p=None, max_length=64, slots=2, seed=0, host="127.0.0.1", port=0,
    )
    httpd, srv = build_server(model.cfg, model, tproc, args, _seeded_image)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        results = [None] * len(questions)

        def post(i):
            q, img = questions[i]
            body = json.dumps({"question": q, "image": img, "max_new_tokens": 5}).encode()
            req = urllib.request.Request(url + "/generate", data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = json.loads(r.read())

        clients = [threading.Thread(target=post, args=(i,)) for i in range(len(questions))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=180)
        assert not any(c.is_alive() for c in clients)
        for res, w in zip(results, want):
            assert res["tokens"] == len(w), (res, w)
            assert res["text"] == tproc.tokenizer.decode(w, skip_special_tokens=True).strip()
        # the same request streamed as server-sent events
        q, img = questions[0]
        body = json.dumps({"question": q, "image": img, "max_new_tokens": 5,
                           "stream": True}).encode()
        req = urllib.request.Request(url + "/generate", data=body, method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            events = [ln for ln in r.read().decode().split("\n\n") if ln]
        assert events[-1] == "data: [DONE]"
        text = "".join(json.loads(e[len("data: "):])["delta"] for e in events[:-1])
        assert text.strip() == results[0]["text"]
        with urllib.request.urlopen(url + "/health", timeout=30) as r:
            assert json.loads(r.read())["ok"] is True
        req = urllib.request.Request(url + "/chat", data=b"{}", method="POST")
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(req, timeout=30)
        assert err.value.code == 501
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()
