"""Multi-adapter serving in vlrlhf_torch vs vlrlhf_tpu, f32 on CPU, the
same bridged weights and adapter sets (tests/test_multilora.py `_sets`:
r=4 on the LM's wq / wv / gate with a non-zero b): the stacked layout against
vlrlhf_tpu's stack_adapter_sets (exact), the static Generator and the
continuous engine (plain and speculative bursts) with a per-row mix against
single-set engines and vlrlhf_tpu's engines (greedy tokens exact), the
fused wqkv / gateup layout with adapters against the unfused one, the
`adapter` field of /generate, the fused sets after they are reassigned,
and an engine's sets lent to the model only while it serves."""

import argparse
import json
import threading
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from tests.test_continuous import _requests
from tests.test_multilora import _sets
from tests.test_torch_models import ported
from tests.test_torch_serving import _bundles, _seeded_image, _to_port
from vlrlhf_torch.generate.continuous import ContinuousEngine
from vlrlhf_torch.generate.engine import GenerateConfig, Generator, adapter_mix_rows
from vlrlhf_torch.utils.bridge import adapter_keys, load_lora_params


def _port_sets(params):
    """vlrlhf_tpu's two sets (numpy trees) and the port's {key: tensor}
    twins, the LM's targets only: vlrlhf_tpu never applies tower adapters
    (ROADMAP.md §3), the port does."""
    sets, lcfg = _sets(params)
    sets = [{"lm": jax.device_get(s["lm"])} for s in sets]
    return sets, [adapter_keys(s) for s in sets], lcfg


def test_stack_adapter_sets_matches_jax_layout():
    from vlrlhf_tpu.lora.lora import stack_adapter_sets as jstack
    from vlrlhf_torch.lora.lora import stack_adapter_sets

    jcfg, params, model = ported()
    sets, tsets, _ = _port_sets(params)
    want = jax.device_get(jstack(sets))
    got = stack_adapter_sets(tsets)
    n_layers = jcfg.lm.num_layers
    assert len(got) == 2 * 3 * n_layers  # wq, wv, gate per layer; a and b
    for i in range(n_layers):
        for group, name in (("attn", "wq"), ("attn", "wv"), ("mlp", "gate")):
            for leaf in ("a", "b"):
                w = np.asarray(want["lm"]["layers_scanned"][group][name][leaf])[i]
                g = got[f"lm/layers/{i}/{group}/{name}/{leaf}"]
                assert tuple(g.shape) == w.shape  # (in, N, r) / (N*r, out)
                np.testing.assert_array_equal(g.numpy(), w)
    names = load_lora_params(model, sets)  # the bridge's list form: stacked on the modules
    assert len(names) == 3 * n_layers
    assert tuple(model.lm.layers[0].wq.lora_a.shape) == tuple(got["lm/layers/0/attn/wq/a"].shape)


def _batch(seed=7):
    from tests.test_speculative import _batch as jbatch

    return jax.device_get(jbatch([20, 24, 22, 26], 32, seed=seed))


def test_static_generator_mix_matches_single_sets_and_jax():
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator
    from vlrlhf_tpu.lora.lora import stack_adapter_sets as jstack

    jcfg, params, model = ported()
    sets, _, lcfg = _port_sets(params)
    batch = _batch()
    idx = [0, 1, 1, 0]
    gcfg = GenerateConfig(max_new_tokens=8, pad_token_id=0)
    singles = []
    for s in sets:
        load_lora_params(model, s)
        gen = Generator(model, gcfg, lcfg.scale)
        gen.adapters = True
        singles.append(gen(batch).numpy())
    assert (singles[0] != singles[1]).any()  # the sets disagree: the test has teeth
    want = np.stack([singles[j][i] for i, j in enumerate(idx)])
    load_lora_params(model, sets)
    gen = Generator(model, gcfg, lcfg.scale)
    gen.adapters = True
    got = gen(batch, adapter_mix=adapter_mix_rows(idx, 2, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    mix = np.zeros((4, 2), np.float32)
    mix[np.arange(4), idx] = 1.0
    jgot = JGenerator(jcfg, JGenerateConfig(max_new_tokens=8, pad_token_id=0),
                      adapters=dict(jstack(sets), __mix__=mix), lora_scale=lcfg.scale)(params,
                                                                                     batch)
    np.testing.assert_array_equal(got, np.asarray(jgot))


@pytest.mark.parametrize("spec_k", [0, 3])
def test_continuous_multilora_matches_single_sets_and_jax(spec_k):
    """Requests over set 0, set 1 and the base model in one engine: each
    request's tokens are those of an engine holding only its set (the base
    model's for None), and with explicit indexes vlrlhf_tpu's engine's;
    the speculative bursts too."""
    from vlrlhf_tpu.generate.continuous import ContinuousEngine as JEngine
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig

    jcfg, params, model = ported()
    sets, tsets, lcfg = _port_sets(params)
    jreqs = _requests(n=5, seed=13)
    idx = [0, 1, None, 1, 0]
    gcfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    kw = dict(n_slots=2, cache_len=64, prefill_chunk=8)
    reqs = _to_port(jreqs)
    for r, i in zip(reqs, idx):
        r.adapter_idx = i
    want = {None: ContinuousEngine(model, gcfg, **kw).run(_to_port(jreqs))}
    for j, t in enumerate(tsets):
        want[j] = ContinuousEngine(model, gcfg, adapter_sets=[t], lora_scale=lcfg.scale,
                                   **kw).run([_with_idx(r, 0) for r in _to_port(jreqs)])
    assert want[0] != want[1]
    eng = ContinuousEngine(model, gcfg, adapter_sets=tsets, lora_scale=lcfg.scale,
                           speculative_k=spec_k, speculative_adaptive=False, **kw)
    got = eng.run(reqs)
    assert got == [want[i][n] for n, i in enumerate(idx)]
    if spec_k:
        assert eng.last_verify_steps > 0
        return
    for r, i in zip(jreqs, idx):
        r.adapter_idx = 0 if i is None else i
    jgot = JEngine(jcfg, JGenerateConfig(max_new_tokens=8, pad_token_id=-1), adapter_sets=sets,
                   lora_scale=lcfg.scale, **kw).run(params, jreqs)
    assert [g for g, i in zip(got, idx) if i is not None] == \
        [g for g, i in zip(jgot, idx) if i is not None]


def _with_idx(r, idx):
    r.adapter_idx = idx
    return r


def test_fused_layout_with_adapter_sets_gives_unfused_tokens():
    from vlrlhf_torch.models.lm.fuse import fuse_lm_

    _, params, model = ported()
    _, tsets, lcfg = _port_sets(params)
    _, _, fused_model = ported()
    fuse_lm_(fused_model.lm)
    reqs = _to_port(_requests(n=4, seed=17))
    for r, i in zip(reqs, [0, 1, None, 1]):
        r.adapter_idx = i
    gcfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    kw = dict(n_slots=2, cache_len=64, prefill_chunk=8, adapter_sets=tsets, lora_scale=lcfg.scale)
    want = ContinuousEngine(model, gcfg, **kw).run(reqs)
    eng = ContinuousEngine(fused_model, gcfg, **kw)
    assert eng.run(reqs) == want
    layer, held = fused_model.lm.layers[0], eng.adapter_sets
    assert "lm/layers/0/mlp/gateup/a" in held and "lm/layers/0/attn/wq/a" not in held
    # wq and wv hold r=4 sets, wk a zero pair: (in, N, 3 r) and (N 3 r, out)
    assert tuple(held["lm/layers/0/attn/wqkv/a"].shape) == (layer.wqkv.d_in, 2, 3 * 4)
    assert tuple(held["lm/layers/0/attn/wqkv/b"].shape) == (2 * 3 * 4, layer.wqkv.d_out)
    # lent for the run only: the fused Linears hold no adapter afterwards
    assert layer.wqkv.lora_a is None and layer.gateup.lora_a is None


def test_reassigned_adapter_sets_are_served_not_a_stale_fused_tree(monkeypatch):
    """The fused layout of the stacked sets is made per engine. After
    `adapter_sets` is reassigned the new sets must be served. With id()
    made constant in the engine's module (a new tree at a freed tree's
    address), a cache keyed by id() would serve the old fused tree; the
    engine makes the fused tree when the sets are assigned."""
    import vlrlhf_torch.generate.continuous as continuous
    from vlrlhf_torch.models.lm.fuse import fuse_lm_

    _, params, model = ported()
    fuse_lm_(model.lm)
    _, tsets, lcfg = _port_sets(params)
    reqs = _to_port(_requests(n=3, seed=19))
    for r in reqs:
        r.adapter_idx = 0
    gcfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    kw = dict(n_slots=2, cache_len=64, prefill_chunk=8, lora_scale=lcfg.scale)
    want_b = ContinuousEngine(model, gcfg, adapter_sets=[tsets[1]], **kw).run(reqs)
    eng = ContinuousEngine(model, gcfg, adapter_sets=[tsets[0]], **kw)
    got_a = eng.run(reqs)
    assert got_a != want_b
    monkeypatch.setattr(continuous, "id", lambda obj: 0, raising=False)
    eng.adapter_sets = [tsets[1]]
    assert eng.run(reqs) == want_b
    eng.adapter_sets = [tsets[0]]
    assert eng.run(reqs) == got_a


def test_engine_lends_its_sets_and_gives_back_the_models_own_adapters():
    """An engine's sets are on the model's Linears only while it serves:
    afterwards the model's own adapters (here set 0, single) are back, the
    very parameters, and give their tokens again. A second engine on a
    model whose Linears are lent raises instead of overwriting them."""
    from vlrlhf_torch.lora.lora import lend_adapters, stack_adapter_sets

    _, params, model = ported()
    sets, tsets, lcfg = _port_sets(params)
    load_lora_params(model, sets[0])
    own = {n: (m.lora_a, m.lora_b) for n, m in model.named_modules() if hasattr(m, "lora_a")}
    gen = Generator(model, GenerateConfig(max_new_tokens=8, pad_token_id=0), lcfg.scale)
    gen.adapters = True
    batch = _batch()
    before = gen(batch).numpy()
    reqs = [_with_idx(r, 0) for r in _to_port(_requests(n=3, seed=23))]
    gcfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    kw = dict(n_slots=2, cache_len=64, prefill_chunk=8, lora_scale=lcfg.scale)
    ContinuousEngine(model, gcfg, adapter_sets=[tsets[1]], **kw).run(reqs)
    assert all(m.lora_a is own[n][0] and m.lora_b is own[n][1]
               for n, m in model.named_modules() if n in own)
    np.testing.assert_array_equal(gen(batch).numpy(), before)
    with lend_adapters(model, stack_adapter_sets(tsets)):
        with pytest.raises(RuntimeError, match="already hold another engine"):
            ContinuousEngine(model, gcfg, adapter_sets=[tsets[0]], **kw).run(reqs)
    np.testing.assert_array_equal(gen(batch).numpy(), before)


def test_http_adapter_selection(tmp_path):
    """serve's --adapter NAME=PATH over the files a dpo run writes: each
    request gets its named set's tokens (none: the base model's), an
    unknown name answers 400 with the registered names."""
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.generate.server import RequestBuilder
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.train.checkpoint import save_params

    jcfg, params, _, model, tproc = _bundles()
    _, tsets, lcfg = _port_sets(params)
    for name, t in zip("ab", tsets):
        save_params(str(tmp_path / name / "adapters"), t)
    questions = [("what is shown?", "img0.png", "a"), ("name two w3 things", None, "b"),
                 ("where is it?", "img2.png", None), ("what is shown?", "img0.png", "b")]
    builder = RequestBuilder(tproc, CollatorConfig(bucket_multiple=32, image_size=16),
                             _seeded_image)
    gcfg = GenerateConfig(max_new_tokens=5, pad_token_id=0, eos_token_ids=(2,))
    kw = dict(n_slots=2, cache_len=128, lora_scale=lcfg.scale)
    want = {}
    for key, sets in (("a", [tsets[0]]), ("b", [tsets[1]]), (None, None)):
        reqs = [builder.build(q, img, 5, adapter_idx=0 if sets else None)
                for q, img, _ in questions]
        want[key] = ContinuousEngine(model, gcfg, adapter_sets=sets, **kw).run(reqs)
    assert want["a"] != want["b"]
    args = argparse.Namespace(
        max_new_tokens=5, synthetic=2, do_sample=False, temperature=1.0, top_k=None,
        top_p=None, max_length=64, slots=2, seed=0, host="127.0.0.1", port=0,
        quantize="false", kv_cache_dtype="bf16", speculative_k=0, chat_sessions=0,
        adapter=[f"a={tmp_path / 'a' / 'adapters'}", f"b={tmp_path / 'b' / 'adapters'}"],
        lora_r=lcfg.r, lora_alpha=lcfg.alpha,
    )
    httpd, srv = build_server(model.cfg, model, tproc, args, _seeded_image)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{httpd.server_address[1]}/generate"
        for n, (q, img, name) in enumerate(questions):
            body = {"question": q, "image": img, "max_new_tokens": 5}
            if name is not None:
                body["adapter"] = name
            req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=120) as r:
                res = json.loads(r.read())
            w = want[name][n]
            assert res["text"] == tproc.tokenizer.decode(w, skip_special_tokens=True).strip()
            assert res["tokens"] == len(w)
        body = json.dumps({"question": "x", "adapter": "nope"}).encode()
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(urllib.request.Request(url, data=body, method="POST"),
                                   timeout=30)
        assert err.value.code == 400
        assert "['a', 'b']" in json.loads(err.value.read())["error"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_chat_session_turns_with_adapters_match_jax():
    """A chat session's next turn runs prefill_chunk under the adapters:
    both turns equal vlrlhf_tpu's ChatSession over the same set."""
    from tests.test_torch_serving_spec import _text_batch
    from vlrlhf_tpu.generate.engine import ChatSession as JChatSession
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator
    from vlrlhf_torch.generate.engine import ChatSession

    jcfg, params, model = ported(seed=1)
    sets, _, lcfg = _port_sets(params)
    load_lora_params(model, sets[1])
    rng = np.random.default_rng(1)
    prompt = rng.integers(5, 100, (2, 8)).astype(np.int32)
    turn2 = rng.integers(5, 100, (2, 3)).astype(np.int32)
    gen = Generator(model, GenerateConfig(max_new_tokens=4, pad_token_id=0), lcfg.scale)
    gen.adapters = True
    session = ChatSession(gen, cache_len=64)
    out1 = session.start(_text_batch(prompt)).numpy()
    new_ids = np.concatenate([out1[:, -1:], turn2], axis=1)
    out2 = session.extend(new_ids, np.full((2,), new_ids.shape[1], np.int32)).numpy()
    jsess = JChatSession(JGenerator(jcfg, JGenerateConfig(max_new_tokens=4, pad_token_id=0),
                                    adapters=sets[1], lora_scale=lcfg.scale), cache_len=64)
    np.testing.assert_array_equal(out1, np.asarray(jsess.start(params, _text_batch(prompt))))
    np.testing.assert_array_equal(out2, np.asarray(jsess.extend(
        new_ids, np.full((2,), new_ids.shape[1], np.int32))))
