"""/score and `eval` of vlrlhf_torch, f32 on CPU: /score (through
EndpointRunner.run_vqa_ppl) equals the in-process run_vqa_ppl and
vlrlhf_tpu's within 1e-5 relative; EndpointRunner.run_vqa equals the
in-process responses; `cli.main eval --synthetic 4 --device cpu` writes
the json, xlsx and sqlite artifacts for pope and seedbench, and `eval
--endpoint` against a serving process gives the in-process results;
--judge_model_path is refused."""

import argparse
import json
import os
import sqlite3
import threading

import numpy as np
import pytest

from tests.test_torch_serving import _bundles, _seeded_image

PPL_RTOL = 1e-5
ROWS = [{"question": f"what is shown {i}?", "answer": a, "img": img}
        for i, (a, img) in enumerate((("The answer is: a dog", "a.png"),
                                      ("The answer is: a cat w3 w9", "b.png"),
                                      ("no", None), ("The answer is: a bird", "a.png"),
                                      ("yes it is", None)))]


def _serve(model, tproc, **kw):
    from vlrlhf_torch.cli.main import build_server

    base = dict(max_new_tokens=4, synthetic=2, do_sample=False, temperature=1.0, top_k=None,
                top_p=None, max_length=64, slots=2, seed=0, host="127.0.0.1", port=0,
                quantize="false", kv_cache_dtype="bf16", speculative_k=0, chat_sessions=0)
    base.update(kw)
    httpd, srv = build_server(model.cfg, model, tproc, argparse.Namespace(**base), _seeded_image)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()

    def stop():
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        thread.join(timeout=30)
        assert not thread.is_alive()

    return f"http://127.0.0.1:{httpd.server_address[1]}", stop


def _runner(model, tproc, **kw):
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.engine import GenerateConfig

    return EvalRunner(model, tproc, GenerateConfig(max_new_tokens=4, pad_token_id=0,
                                                   eos_token_ids=(2,)),
                      CollatorConfig(pad_token_id=0, bucket_multiple=32, image_size=16),
                      _seeded_image, **kw)


def test_score_endpoint_matches_local_and_jax():
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.eval.harness import EvalRunner as JEvalRunner
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_torch.generate.server import EndpointRunner

    jcfg, params, jproc, model, tproc = _bundles()
    want = JEvalRunner(model_cfg=jcfg, params=params, processor=jproc,
                       gen_cfg=JGenerateConfig(max_new_tokens=4, pad_token_id=0),
                       collator_cfg=JCollatorConfig(pad_token_id=0, bucket_multiple=32,
                                                    image_size=16),
                       image_loader=_seeded_image).run_vqa_ppl(ROWS, batch_size=2)
    local = _runner(model, tproc).run_vqa_ppl(ROWS, batch_size=2)
    url, stop = _serve(model, tproc)
    try:
        remote = EndpointRunner(url).run_vqa_ppl(ROWS, batch_size=2)
    finally:
        stop()
    for got in (local, remote):
        assert [{k: v for k, v in r.items() if k != "ppl"} for r in got] == ROWS
        np.testing.assert_allclose([r["ppl"] for r in got], [r["ppl"] for r in want],
                                   rtol=PPL_RTOL)
    assert all(np.isfinite(r["ppl"]) and r["ppl"] > 0 for r in local)


def test_endpoint_run_vqa_matches_in_process():
    """/generate from EndpointRunner's threads gives the in-process
    continuous runner's responses (the server's engine), which are the
    static runner's."""
    from vlrlhf_torch.generate.server import EndpointRunner

    _, _, _, model, tproc = _bundles()
    rows = [{"question": q, "img": img} for q, img in (
        ("is there a dog?", "a.png"), ("what color is the sky?", None),
        ("describe the picture", "b.png"))]
    want = _runner(model, tproc, continuous_batching=True).run_vqa(rows, batch_size=2)
    assert [r["response"] for r in want] == \
        [r["response"] for r in _runner(model, tproc).run_vqa(rows, batch_size=2)]
    url, stop = _serve(model, tproc)
    try:
        got = EndpointRunner(url, num_threads=3).run_vqa(rows)
    finally:
        stop()
    assert got == want


def _pope_and_seed(tmp_path):
    pope = tmp_path / "pope.jsonl"
    pope.write_text("\n".join(json.dumps({"text": f"is there a {w}?", "label": lab,
                                          "image": f"{w}.jpg"})
                              for w, lab in (("dog", "yes"), ("cat", "no"), ("cow", "no"))))
    seed = tmp_path / "seed.json"
    seed.write_text(json.dumps({"questions": [
        {"question_id": f"q{i}", "question": f"what is shown {i}?", "choice_a": "a dog",
         "choice_b": "a cat", "choice_c": "a bird", "choice_d": "a fish",
         "answer": "ABCD"[i], "data_id": f"img{i}.jpg", "question_type_id": 1}
        for i in range(2)]}))
    return {"pope": pope, "seedbench": seed}


@pytest.mark.parametrize("bench", ["pope", "seedbench"])
def test_cli_eval_synthetic_writes_json_xlsx_sqlite(tmp_path, bench, capsys):
    from vlrlhf_torch.cli.main import main

    data = _pope_and_seed(tmp_path)[bench]
    out = tmp_path / "out"
    db = tmp_path / "db.sqlite"
    main(["eval", "--device", "cpu", "--synthetic", "4", "--benchmark", bench, "--data_file",
          str(data), "--output_dir", str(out), "--sqlite_db", str(db), "--tag", "run1",
          "--max_new_tokens", "4", "--max_length", "128"])
    rows = json.loads((out / f"{bench}.json").read_text())
    assert len(rows) == (3 if bench == "pope" else 8)
    key = "ppl" if bench == "seedbench" else "response"
    assert all(key in r for r in rows)
    assert (out / f"{bench}.xlsx").stat().st_size > 0
    conn = sqlite3.connect(str(db))
    tags = [r[0] for r in conn.execute(f'SELECT tag FROM "{bench.upper()}"')]
    conn.close()
    assert tags == ["run1"]
    assert "acc" in capsys.readouterr().out


def test_cli_eval_endpoint_matches_in_process_and_refuses_judge(tmp_path, capsys):
    from vlrlhf_torch.cli.main import main

    _, _, _, model, tproc = _bundles()
    data = _pope_and_seed(tmp_path)
    rows = [dict(r, question=r["text"], img=os.path.join("", r["image"]))
            for r in map(json.loads, data["pope"].read_text().splitlines())]
    want = _runner(model, tproc, continuous_batching=True).run_vqa(rows, batch_size=2)
    url, stop = _serve(model, tproc)
    try:
        for bench in ("pope", "seedbench"):
            main(["eval", "--endpoint", url, "--benchmark", bench, "--data_file",
                  str(data[bench]), "--output_dir", str(tmp_path / "remote")])
    finally:
        stop()
    got = json.loads((tmp_path / "remote" / "pope.json").read_text())
    assert [r["response"] for r in got] == [r["response"] for r in want]
    seed = json.loads((tmp_path / "remote" / "seedbench.json").read_text())
    assert len(seed) == 8 and all(np.isfinite(r["ppl"]) for r in seed)
    with pytest.raises(SystemExit, match=r"ROADMAP.md §1c item 8"):
        main(["eval", "--device", "cpu", "--synthetic", "4", "--benchmark", "pope",
              "--data_file", str(data["pope"]), "--output_dir", str(tmp_path / "j"),
              "--judge_model_path", "some/judge"])
