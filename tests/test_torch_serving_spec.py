"""The serving extensions of vlrlhf_torch vs vlrlhf_tpu, f32 on CPU, same
bridged weights: prefill_chunk and flush_pending (the f32 model's own
cache, labelled "bf16" as the serve flag names it, and an int8 cache;
tolerance 1e-4 on logits and caches; int8 codes within ±1), the
prompt-lookup drafts (exact), speculative continuous batching (greedy
token for token against the port's plain engine and vlrlhf_tpu's
speculative engine; sampled with top_k=1 equal to greedy; sampled
marginals against plain decoding), the adaptive gate, ChatSession, the
int8 KV cache through the engines, /chat over HTTP and the serve flags."""

import argparse
import json
import threading
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_continuous import _requests
from tests.test_torch_models import ported, prompt_batch
from tests.test_torch_serving import _bundles, _seeded_image, _to_port
from vlrlhf_torch.generate.continuous import ContinuousEngine, Request, device_draft
from vlrlhf_torch.generate.engine import ChatSession, GenerateConfig, Generator

TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _live_caches(kv: str, seed=5, cache_len=64):
    """An empty prefill of the same prompts in both packages: (jax cfg,
    params, port model, jax cache, port cache, prompt lengths)."""
    from vlrlhf_tpu.models.vlm import vlm_forward

    jcfg, params, model = ported(seed=seed)
    ids, pad, lens, px, pos = prompt_batch(seed=seed)
    s = ids.shape[1]
    _, jcache = vlm_forward(
        jcfg, params, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
        image_positions=jnp.asarray(pos), pad_mask=jnp.asarray(pad),
        positions=jnp.broadcast_to(jnp.arange(s)[None], ids.shape), cache_len=cache_len,
        kv_cache_dtype=jnp.int8 if kv == "int8" else None, return_logits=False,
    )
    with torch.no_grad():
        _, tcache = model(_t(ids), _t(px), _t(pos), _t(pad), cache_len=cache_len,
                          kv_cache_dtype=kv)
    return jcfg, params, model, jcache, tcache, lens


def _assert_caches_close(tcache, jcache, rows_upto):
    for key in tcache:
        got, want = tcache[key], np.asarray(jnp.asarray(jcache[key]).astype(
            jnp.float32 if key.endswith("scale") or tcache[key].dtype != torch.int8 else jnp.int32))
        for b, n in enumerate(rows_upto):
            g = got[:, b, :, :n].float().numpy()
            if got.dtype == torch.int8:
                assert np.abs(g - want[:, b, :, :n]).max() <= 1, key
            else:
                np.testing.assert_allclose(g, want[:, b, :, :n], atol=TOL, rtol=TOL, err_msg=key)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_chunk_with_pending_matches_jax(kv):
    """A decode step leaves a pending write; prefill_chunk lands it, writes
    a ragged chunk (one row's chunk shorter, its pad positions parked) and
    returns all logits, then the last-position head; the caches agree."""
    from vlrlhf_tpu.models.lm.llama import lm_decode, lm_prefill_chunk
    from vlrlhf_torch.models.lm.llama import empty_pending

    jcfg, params, model, jcache, tcache, lens = _live_caches(kv)
    lm = jcfg.lm
    from vlrlhf_tpu.generate.engine import _empty_pending

    tok = np.asarray([7, 42], np.int32)
    _, jcache, jpend = lm_decode(lm, params["lm"], last_token=jnp.asarray(tok),
                                 lengths=jnp.asarray(lens), cache=jcache,
                                 pending=_empty_pending(lm, 2, 64))
    with torch.no_grad():
        _, tpend = model.lm.decode(_t(tok), _t(lens), tcache, empty_pending(model.cfg.lm, 2, 64,
                                                                            "cpu"))
    chunk = np.asarray([[11, 12, 13, 14, 15], [21, 22, 23, 0, 0]], np.int32)
    clens = np.asarray([5, 3], np.int32)
    lens1 = lens + 1
    for all_logits in (True, False):
        jl, jcache_out, jlen = lm_prefill_chunk(
            lm, params["lm"], input_ids=jnp.asarray(chunk), chunk_lens=jnp.asarray(clens),
            lengths=jnp.asarray(lens1), cache=jcache, pending=jpend,
            return_all_logits=all_logits,
        )
        tc = {k: v.clone() for k, v in tcache.items()}
        with torch.no_grad():
            tl, tlen = model.lm.prefill_chunk(_t(chunk), _t(clens), _t(lens1), tc,
                                              pending=tpend, return_all_logits=all_logits)
        np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
        jl = np.asarray(jl)
        if all_logits:
            for b, n in enumerate(clens):
                np.testing.assert_allclose(tl[b, :n].numpy(), jl[b, :n], atol=TOL, rtol=TOL)
        else:
            np.testing.assert_allclose(tl.numpy(), jl, atol=TOL, rtol=TOL)
        _assert_caches_close(tc, jcache_out, lens1 + clens)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_flush_pending_matches_jax(kv):
    from vlrlhf_tpu.models.lm.llama import flush_pending as jflush
    from vlrlhf_torch.models.lm.llama import flush_pending

    jcfg, _, model, jcache, tcache, lens = _live_caches(kv, seed=7)
    lm = jcfg.lm
    rng = np.random.default_rng(3)
    shape = (lm.num_layers, 2, lm.num_kv_heads, lm.head_dim_)
    pk, pv = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    pos = np.asarray([lens[0], 64], np.int32)  # row 1: nothing pending (dropped)
    want = jflush(lm, jcache, {"k": jnp.asarray(pk), "v": jnp.asarray(pv),
                               "pos": jnp.asarray(pos)})
    flush_pending(tcache, {"k": _t(pk), "v": _t(pv), "pos": _t(pos)})
    _assert_caches_close(tcache, want, (64, 64))


def test_device_draft_matches_jax_and_host_lookup():
    from vlrlhf_tpu.generate.continuous import _device_draft
    from vlrlhf_tpu.generate.speculative import prompt_lookup_draft

    rng = np.random.default_rng(0)
    for trial in range(20):
        b, s, k = int(rng.integers(1, 5)), int(rng.integers(8, 40)), int(rng.integers(1, 5))
        hist = rng.integers(0, 5, (b, s)).astype(np.int32)  # small vocab: repeats
        hlen = rng.integers(2, s + 1, (b,)).astype(np.int32)
        got = device_draft(_t(hist), _t(hlen), k, -7).numpy()
        want = np.asarray(_device_draft(jnp.asarray(hist), jnp.asarray(hlen), k, -7))
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        for i in range(b):
            assert got[i].tolist() == prompt_lookup_draft(hist[i, : hlen[i]].tolist(), k, -7)


def _engines(jcfg, params, model, gen_kw, k, kv="bf16", **eng_kw):
    from vlrlhf_tpu.generate.continuous import ContinuousEngine as JEngine
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig

    kw = dict(n_slots=2, cache_len=64, prefill_chunk=8, **eng_kw)
    jeng = JEngine(jcfg, JGenerateConfig(kv_cache_dtype=kv, **gen_kw), speculative_k=k, **kw)
    teng = ContinuousEngine(model, GenerateConfig(kv_cache_dtype=kv, **gen_kw),
                            speculative_k=k, **kw)
    return jeng, teng


@pytest.mark.parametrize("k", [1, 3])
def test_spec_greedy_matches_plain_and_jax_spec(k):
    """Speculative continuous batching, greedy f32: the port's spec engine
    == the port's plain engine == vlrlhf_tpu's spec engine, token for
    token, across refills and per-request budgets."""
    jcfg, params, model = ported()
    reqs = _requests()
    gen_kw = dict(max_new_tokens=10, pad_token_id=-1)
    jeng, teng = _engines(jcfg, params, model, gen_kw, k, speculative_adaptive=False)
    want = jeng.run(params, reqs)
    got = teng.run(_to_port(reqs))
    plain = ContinuousEngine(model, GenerateConfig(**gen_kw), n_slots=2, cache_len=64,
                             prefill_chunk=8).run(_to_port(reqs))
    assert got == want == plain
    assert teng.last_spec_bursts == teng.last_bursts > 0 and teng.last_verify_steps > 0


def test_spec_eos_mid_chunk():
    """An eos inside an accepted chunk ends the response there; the tokens
    after it are dropped and the slot frees, as in plain decoding."""
    jcfg, params, model = ported()
    reqs = _requests(3, seed=3)
    for r in reqs:
        r.max_new_tokens = 8
    plain = ContinuousEngine(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1),
                             n_slots=2, cache_len=64, prefill_chunk=16).run(_to_port(reqs))
    assert len(plain[0]) >= 3
    eos = plain[0][2]
    gen_kw = dict(max_new_tokens=8, pad_token_id=-1, eos_token_ids=(eos,))
    jeng, teng = _engines(jcfg, params, model, gen_kw, 3, speculative_adaptive=False)
    teng.prefill_chunk = jeng.prefill_chunk = 16
    want = ContinuousEngine(model, GenerateConfig(**gen_kw), n_slots=2, cache_len=64,
                            prefill_chunk=16).run(_to_port(reqs))
    got = teng.run(_to_port(reqs))
    assert got == want == jeng.run(params, reqs)
    assert eos not in got[0] and len(got[0]) == 2


def test_spec_text_only_rows_and_short_burst():
    """A decode burst shorter than one chunk (max_new_tokens 2 < K+1) is
    raised to K+1 (else no slot could advance) and text-only rows still
    match plain greedy."""
    _, _, model = ported()
    rng = np.random.default_rng(7)
    reqs = [Request(input_ids=rng.integers(4, 100, (12 + 3 * i,)).astype(np.int32),
                    max_new_tokens=2) for i in range(3)]
    gen = GenerateConfig(max_new_tokens=2, pad_token_id=-1)
    eng = ContinuousEngine(model, gen, n_slots=2, cache_len=48, prefill_chunk=8,
                           speculative_k=3, speculative_adaptive=False)
    assert eng.decode_burst == 4
    plain = ContinuousEngine(model, gen, n_slots=2, cache_len=48, prefill_chunk=8)
    assert eng.run(reqs) == plain.run(reqs)


def test_spec_sampled_topk1_matches_greedy():
    """top_k=1 sampling is the argmax whatever the draws, so the sampled
    speculative path (acceptance, residual and bonus draws) reproduces
    greedy exactly."""
    _, _, model = ported()
    reqs = _to_port(_requests(4, seed=11))
    greedy = ContinuousEngine(model, GenerateConfig(max_new_tokens=8, pad_token_id=-1),
                              n_slots=2, cache_len=64, prefill_chunk=8).run(reqs)
    eng = ContinuousEngine(
        model, GenerateConfig(max_new_tokens=8, pad_token_id=-1, do_sample=True, top_k=1,
                              temperature=0.7),
        n_slots=2, cache_len=64, prefill_chunk=8, speculative_k=2, speculative_adaptive=False,
    )
    assert eng.run(reqs, torch.Generator().manual_seed(42)) == greedy


def test_spec_sampled_marginals_match_plain():
    """Lossless speculative sampling: per-position token histograms of many
    sampled responses match plain sampling within sampling noise (the
    plain engine's own split-half total variation sets the floor, as in
    tests/test_continuous_spec.py). The draws cannot be vlrlhf_tpu's: its
    random stream is not torch's."""
    _, _, model = ported(seed=4)
    rng = np.random.default_rng(9)
    ids = rng.integers(4, 100, (14,)).astype(np.int32)
    gen = GenerateConfig(max_new_tokens=3, pad_token_id=-1, do_sample=True, temperature=0.5,
                         top_k=5)
    n = 400

    def sample(k, seed):
        eng = ContinuousEngine(model, gen, n_slots=8, cache_len=32, prefill_chunk=16,
                               speculative_k=k, speculative_adaptive=False)
        outs = eng.run([Request(input_ids=ids, max_new_tokens=3) for _ in range(n)],
                       torch.Generator().manual_seed(seed))
        return np.asarray([o + [0] * (3 - len(o)) for o in outs])

    plain, spec = sample(0, 1), sample(2, 2)
    v = model.cfg.lm.vocab_size

    def tv(a, b, pos):
        ha = np.bincount(a[:, pos], minlength=v) / len(a)
        hb = np.bincount(b[:, pos], minlength=v) / len(b)
        return 0.5 * np.abs(ha - hb).sum()

    for pos in range(3):
        floor = tv(plain[: n // 2], plain[n // 2:], pos)
        cross = tv(plain, spec, pos)
        assert cross < 1.8 * floor + 0.03, (pos, cross, floor)


def test_adaptive_gate_probes_both_modes_and_keeps_greedy():
    """With the gate re-probing every other burst, the engine runs both
    burst kinds and greedy output stays that of plain decoding."""
    _, _, model = ported()
    reqs = _to_port(_requests())
    gen = GenerateConfig(max_new_tokens=10, pad_token_id=-1)
    want = ContinuousEngine(model, gen, n_slots=2, cache_len=64, prefill_chunk=8).run(reqs)
    eng = ContinuousEngine(model, gen, n_slots=2, cache_len=64, prefill_chunk=8,
                           speculative_k=3)
    assert eng.speculative_adaptive
    eng._probe_every = 2
    assert eng.run(reqs) == want
    assert 0 < eng.last_spec_bursts < eng.last_bursts
    assert eng.last_decode_steps > 0 and eng.last_verify_steps > 0


def test_plain_burst_keeps_the_draft_history():
    """A plain burst on a speculative engine appends every emitted token to
    the history (prompt + first token + tokens at hist[:lengths+1])."""
    _, _, model = ported()
    reqs = _to_port(_requests(2, seed=5))
    for r in reqs:
        r.max_new_tokens = 6
    eng = ContinuousEngine(model, GenerateConfig(max_new_tokens=6, pad_token_id=-1),
                           n_slots=2, cache_len=64, prefill_chunk=8, speculative_k=2)
    cache, pending, state, hist = eng._fresh_buffers()
    gen = torch.Generator().manual_seed(0)
    with torch.inference_mode():
        eng._admit_group(cache, pending, state, hist, [(0, 0), (1, 1)], reqs, gen)
        _, _, packed, hist = eng._burst(cache, pending, state, hist, 0, gen)
    for slot in (0, 1):
        prompt = [int(t) for t in reqs[slot].input_ids]
        n_adv = int(packed[slot, -1]) - len(prompt)
        assert n_adv > 0
        want = prompt + [int(packed[slot, 0])] + [int(t) for t in packed[slot, 1:1 + n_adv]]
        assert hist[slot, : len(want)].tolist() == want


def test_int8_kv_engines_match_jax():
    """The int8 KV cache through the static, continuous and speculative
    engines: the same tokens as vlrlhf_tpu's int8 engines."""
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator

    jcfg, params, model = ported()
    reqs = _requests(4, seed=2)
    gen_kw = dict(max_new_tokens=8, pad_token_id=-1)
    for k in (0, 3):
        jeng, teng = _engines(jcfg, params, model, gen_kw, k, kv="int8",
                              speculative_adaptive=False)
        assert teng.run(_to_port(reqs)) == jeng.run(params, reqs), k
    ids, pad, lens, px, pos = prompt_batch(seed=9)
    batch = {"input_ids": ids, "pad_mask": pad, "prompt_lens": lens, "pixel_values": px,
             "image_positions": pos}
    want = np.asarray(JGenerator(jcfg, JGenerateConfig(kv_cache_dtype="int8", **gen_kw))(
        params, batch))
    got = Generator(model, GenerateConfig(kv_cache_dtype="int8", **gen_kw))(batch)
    np.testing.assert_array_equal(got.numpy(), want)


def _text_batch(prompt):
    b, l1 = prompt.shape
    return {"input_ids": prompt, "pad_mask": np.ones((b, l1), bool),
            "prompt_lens": np.full((b,), l1, np.int32), "pixel_values": None,
            "image_positions": None}


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_two_turn_session_matches_oneshot_and_jax(kv):
    """Turn 2 through ChatSession.extend equals one-shot generation over the
    concatenated tokens (bf16 label: an f32 model's native cache), and both
    turns equal vlrlhf_tpu's ChatSession."""
    from vlrlhf_tpu.generate.engine import ChatSession as JChatSession
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator

    jcfg, params, model = ported(seed=1)
    rng = np.random.default_rng(1)
    b, n1 = 2, 4
    prompt = rng.integers(5, 100, (b, 8)).astype(np.int32)
    turn2 = rng.integers(5, 100, (b, 3)).astype(np.int32)
    gen_cfg = GenerateConfig(max_new_tokens=n1, pad_token_id=0, kv_cache_dtype=kv)
    session = ChatSession(Generator(model, gen_cfg), cache_len=64)
    out1 = session.start(_text_batch(prompt)).numpy()
    assert (out1 != 0).all()
    new_ids = np.concatenate([out1[:, -1:], turn2], axis=1)
    out2 = session.extend(new_ids, np.full((b,), new_ids.shape[1], np.int32)).numpy()
    jsess = JChatSession(JGenerator(jcfg, JGenerateConfig(max_new_tokens=n1, pad_token_id=0,
                                                          kv_cache_dtype=kv)), cache_len=64)
    np.testing.assert_array_equal(out1, np.asarray(jsess.start(params, _text_batch(prompt))))
    np.testing.assert_array_equal(out2, np.asarray(jsess.extend(
        new_ids, np.full((b,), new_ids.shape[1], np.int32))))
    if kv == "bf16":
        full = np.concatenate([prompt, out1, turn2], axis=1)
        want = Generator(model, GenerateConfig(max_new_tokens=n1, pad_token_id=0))(
            _text_batch(full)).numpy()
        np.testing.assert_array_equal(out2, want)
    else:
        assert session.state["cache"]["k"].dtype == torch.int8


def test_session_cache_full_error():
    _, _, model = ported()
    prompt = np.random.default_rng(1).integers(5, 100, (2, 8)).astype(np.int32)
    session = ChatSession(Generator(model, GenerateConfig(max_new_tokens=4, pad_token_id=0)),
                          cache_len=36)
    with pytest.raises(RuntimeError, match="start"):
        session.extend(prompt[:, :3], np.full((2,), 3, np.int32))
    out1 = session.start(_text_batch(prompt)).numpy()
    chunk = np.concatenate([out1[:, -1:], prompt[:, :2]], 1)
    assert session.extend(chunk, np.full((2,), 3, np.int32)).shape == (2, 4)  # 8+4+3+4 = 19
    assert session.extend(chunk, np.full((2,), 3, np.int32)).shape == (2, 4)  # 26
    with pytest.raises(ValueError, match="session cache full"):
        for _ in range(4):
            session.extend(chunk, np.full((2,), 3, np.int32))


def _serve_args(**kw):
    base = dict(max_new_tokens=5, synthetic=2, do_sample=False, temperature=1.0, top_k=None,
                top_p=None, max_length=64, slots=2, seed=0, host="127.0.0.1", port=0,
                quantize="false", kv_cache_dtype="bf16", speculative_k=0, chat_sessions=2)
    base.update(kw)
    return argparse.Namespace(**base)


def _post(url, path, body):
    req = urllib.request.Request(url + path, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_chat_over_http_matches_jax_chat_backend():
    """Two /chat turns of one session and a second session over HTTP give
    vlrlhf_tpu ChatBackend's texts; /generate on the same server (with
    --speculative_k 3) still answers as the JAX engine does."""
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.server import ChatBackend as JChatBackend
    from vlrlhf_torch.cli.main import build_server

    jcfg, params, jproc, model, tproc = _bundles()
    jchat = JChatBackend(jcfg, params, jproc, JCollatorConfig(bucket_multiple=32, image_size=16),
                         JGenerateConfig(max_new_tokens=5, pad_token_id=0, eos_token_ids=(2,)),
                         cache_len=128, max_sessions=2, image_loader=_seeded_image)
    turns = [("what is shown?", "img0.png"), ("and then w5 w6?", None)]
    want = []
    sid = None
    for msg, img in turns:
        text, sid = jchat.chat(msg, sid, img)
        want.append(text)
    want_other, _ = jchat.chat("tell me about w9", None, None)
    httpd, srv = build_server(model.cfg, model, tproc, _serve_args(speculative_k=3),
                              _seeded_image)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        sid = None
        for (msg, img), w in zip(turns, want):
            res = _post(url, "/chat", {"message": msg, "session_id": sid, "image": img})
            assert res["text"] == w
            sid = res["session_id"]
        other = _post(url, "/chat", {"message": "tell me about w9"})
        assert other["text"] == want_other and other["session_id"] != sid
        gen = _post(url, "/generate", {"question": "what is shown?", "image": "img0.png",
                                       "max_new_tokens": 5})
        assert gen["tokens"] >= 1
        assert srv.engine.speculative_k == 3 and srv.engine.last_spec_bursts >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_serve_accepts_int4_and_fuse_decode_and_refuses_adapter():
    """`serve --quantize int4 --fuse_decode true` on the synthetic model:
    its widths (32, 64) are no multiple of 128, so every LM linear and
    lm_head falls back to int8 (as vlrlhf_tpu's quantize_params does), the
    layers are fused, and /generate answers. An --adapter that is not
    NAME=PATH is refused."""
    from vlrlhf_torch.cli.main import build_parser, build_server, main

    args = build_parser().parse_args(
        ["serve", "--quantize", "int4", "--fuse_decode", "true", "--kv_cache_dtype", "int8",
         "--speculative_k", "3", "--chat_sessions", "4"])
    assert (args.quantize, args.fuse_decode, args.kv_cache_dtype, args.speculative_k,
            args.chat_sessions) == ("int4", True, "int8", 3, 4)
    _, _, _, model, tproc = _bundles()
    httpd, srv = build_server(model.cfg, model, tproc,
                              _serve_args(quantize="int4", fuse_decode=True, kv_cache_dtype="int8",
                                          speculative_k=3), _seeded_image)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        layer = model.lm.layers[0]
        assert layer.wq is None and layer.wqkv.weight_q is not None
        assert layer.gateup.weight_q is not None and layer.down.weight_q is not None
        assert model.lm.lm_head.weight_q is not None and model.lm.lm_head.weight_q4 is None
        assert model.vision.layers[0].wq.weight is not None
        assert srv.engine.gen_cfg.kv_cache_dtype == "int8"
        url = f"http://127.0.0.1:{httpd.server_address[1]}"
        gen = _post(url, "/generate", {"question": "what is shown?", "image": "img0.png",
                                       "max_new_tokens": 4})
        assert gen["tokens"] >= 1
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
    with pytest.raises(SystemExit, match="NAME=PATH"):
        main(["serve", "--device", "cpu", "--synthetic", "2", "--adapter", "a"])
