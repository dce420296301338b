"""vlrlhf_torch's eval harness vs vlrlhf_tpu's, f32 on CPU, one synthetic
LLaVA model bridged into both packages: the scorers and every benchmark's
scoring (MMBench circular included) on the same rows, the TSV loader
(pandas-free) and the JSON loader on the same files, the sqlite sink
(schema evolution included) and the xlsx writer, and run_benchmark end to
end for mme, mmbench, pope, seedbench (CE ranking and generate) and mmvet
with an LLM judge: responses equal, `ppl` within 1e-5 relative, metrics
equal. The continuous and speculative run_vqa paths give the static
path's responses. eval/ imports neither pandas nor PIL."""

import base64
import io
import json
import math
import os
import pathlib
import sqlite3
import subprocess
import sys
import zipfile

import numpy as np
import pytest

from tests.test_torch_serving import _bundles, _seeded_image

ROOT = pathlib.Path(__file__).resolve().parents[1]
PPL_RTOL = 1e-5


def _loader(path, size, mode):
    """A seeded image per file name: both packages' temp dirs differ."""
    return _seeded_image(os.path.basename(str(path)), size, mode)


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


def _assert_rows_equal(got, want, ppl=False):
    """Row for row, key for key (NaN equal to NaN); image paths by file
    name; `ppl` within PPL_RTOL relative."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = dict(g), dict(w)
        assert g.keys() == w.keys(), (sorted(g), sorted(w))
        if "img" in g:
            names = [[os.path.basename(p) for p in (r["img"] if isinstance(r["img"], list)
                                                    else [r["img"]])] for r in (g, w)]
            assert names[0] == names[1]
            del g["img"], w["img"]
        if ppl:
            np.testing.assert_allclose(g.pop("ppl"), w.pop("ppl"), rtol=PPL_RTOL)
        assert _same(g, w), (g, w)


def _image_b64(seed=0, fmt="PNG"):
    from PIL import Image

    img = Image.fromarray(np.random.default_rng(seed).integers(0, 255, (16, 16, 3), np.uint8))
    buf = io.BytesIO()
    img.save(buf, format=fmt)
    return base64.b64encode(buf.getvalue()).decode()


def _write_tsv(path, header, rows):
    with open(path, "w") as f:
        f.write("\t".join(header) + "\n")
        for r in rows:
            f.write("\t".join("" if c is None else str(c) for c in r) + "\n")


# ───────────────────────── scorers and scoring ─────────────────────────


RESPONSES = ["Yes, it is.", "No.", "there is not", "Sure thing", "B", "(C) the cat",
             "The answer is D.", "A. because", "I think it's a blue boat", "no idea",
             "answer: e", "Option B seems right", "the answer is a red car", ""]


def test_scorers_match_jax():
    from vlrlhf_tpu.eval import scorers as J
    from vlrlhf_torch.eval import scorers as T

    opts = {"A": "a red car", "B": "a blue boat", "C": float("nan")}
    for r in RESPONSES:
        assert T.extract_yes_no(r) == J.extract_yes_no(r), r
        assert T.extract_choice(r) == J.extract_choice(r), r
        clean = {k: v for k, v in opts.items() if isinstance(v, str)}
        assert T.extract_choice(r, clean) == J.extract_choice(r, clean), r
    rng = np.random.default_rng(0)
    rows = [{"response": RESPONSES[int(rng.integers(len(RESPONSES)))],
             "label": ["yes", "no"][int(rng.integers(2))], "answer": "ABCD"[int(rng.integers(4))],
             "A": "a red car", "B": "a blue boat", "C": float("nan"),
             "category": ["existence", "count", "OCR", "code_reasoning"][i % 4],
             "image_id": f"{i // 2}", "index": f"q{i // 3}", "choice_idx": i % 3,
             "answer_idx": 1, "ppl": float(rng.random())} for i in range(24)]
    for fn in ("pope_metrics", "multiple_choice_accuracy", "ppl_choice_accuracy",
               "vqa_accuracy"):
        assert getattr(T, fn)(rows) == getattr(J, fn)(rows), fn
    mme = [dict(r, answer=["Yes", "No"][i % 2]) for i, r in enumerate(rows)]
    assert T.mme_scores(mme) == J.mme_scores(mme)


def test_benchmark_scoring_matches_jax_mmbench_circular_included():
    from vlrlhf_tpu.eval.benchmarks import BENCHMARKS as JB
    from vlrlhf_torch.eval.benchmarks import BENCHMARKS as TB

    assert sorted(TB) == sorted(JB)
    circular = [
        {"index": "1", "response": "A", "answer": "A", "options_dict": {"A": "x", "B": "y"}},
        {"index": "1000001", "response": "B", "answer": "B", "options_dict": {"A": "y", "B": "x"}},
        {"index": "2", "response": "A", "answer": "A", "options_dict": {"A": "u", "B": "v"}},
        {"index": "1000002", "response": "A", "answer": "B", "options_dict": {"A": "v", "B": "u"}},
    ]
    assert TB["mmbench"].score(circular) == JB["mmbench"].score(circular) == \
        {"acc": 50.0, "mode": "circular"}
    rng = np.random.default_rng(1)
    rows = [{"response": RESPONSES[int(rng.integers(len(RESPONSES)))], "answer": "B",
             "label": "yes", "A": "a red car", "B": "a blue boat",
             "options_dict": {"A": "a red car", "B": "a blue boat"} if i % 3 else {},
             "category": "existence", "index": str(i), "image_id": str(i // 2),
             "choice_idx": i % 2, "answer_idx": 0, "ppl": float(rng.random()),
             "judge_score": 0.5 if i % 4 == 0 else None} for i in range(12)]
    for name in sorted(TB):
        assert TB[name].score(rows) == JB[name].score(rows), name


# ───────────────────────── loaders and sinks ─────────────────────────


def test_tsv_and_json_loaders_match_jax(tmp_path):
    """MMBench-style TSV (short image cells, an empty hint, int and float
    columns, a quoted tab, 'None' read as missing as pandas reads it),
    MMMU-style multi-image rows, and POPE / MMVet / SEEDBench JSON."""
    from vlrlhf_tpu.eval import benchmarks as JB
    from vlrlhf_tpu.eval.datasets import TSVBenchmark as JTSV
    from vlrlhf_tpu.eval.datasets import load_json_benchmark as jload
    from vlrlhf_torch.eval import benchmarks as TB
    from vlrlhf_torch.eval.datasets import TSVBenchmark as TTSV
    from vlrlhf_torch.eval.datasets import load_json_benchmark as tload

    b64, b64b = _image_b64(0), _image_b64(1)
    tsv = tmp_path / "mmbench.tsv"
    _write_tsv(tsv, ["index", "image", "question", "hint", "A", "B", "C", "answer", "n", "f"], [
        (0, b64, "what color?", None, "red", "blue", "None", "A", 1, 0.5),
        (1, "0", '"a quoted\ttab"', "look closely", "round", "square", "flat", "B", 2, None),
        (1000001, b64b, "what color?", None, "blue", "red", None, "B", 3, 2.0),
    ])
    _assert_rows_equal(TTSV(str(tsv)).rows(), JTSV(str(tsv)).rows())
    _assert_rows_equal(TB.BENCHMARKS["mmbench"].load_rows(str(tsv)),
                       JB.BENCHMARKS["mmbench"].load_rows(str(tsv)))
    _assert_rows_equal(TB.BENCHMARKS["mmmu"].load_rows(str(tsv)),
                       JB.BENCHMARKS["mmmu"].load_rows(str(tsv)))
    # the port writes the decoded bytes unchanged (vlrlhf_tpu re-encodes them)
    loader = TTSV(str(tsv))  # its temporary image directory lives as long as it
    assert pathlib.Path(loader.rows()[1]["img"]).read_bytes() == base64.b64decode(b64)
    multi = tmp_path / "multi.tsv"
    _write_tsv(multi, ["index", "image", "question"],
               [("0", str([b64, b64b]), "compare <image 1> and <image 2>"), ("1", b64, "what?")])
    got, want = TTSV(str(multi)).rows(), JTSV(str(multi)).rows()
    _assert_rows_equal(got, want)
    assert isinstance(got[0]["img"], list) and len(got[0]["img"]) == 2
    pope = tmp_path / "pope.jsonl"
    pope.write_text("\n".join(json.dumps({"text": f"is there a {w}?", "label": "yes",
                                          "image": f"{w}.jpg"}) for w in ("dog", "cat")))
    mmvet = tmp_path / "mmvet.json"
    mmvet.write_text(json.dumps({"v1": {"imagename": "v1.png", "question": "what?",
                                        "answer": "a cat"}}))
    for name, path in (("pope", pope), ("mmvet", mmvet), ("vqa", pope)):
        _assert_rows_equal(TB.BENCHMARKS[name].load_rows(str(path), image_root="r"),
                           JB.BENCHMARKS[name].load_rows(str(path), image_root="r"))
    _assert_rows_equal(tload(str(pope), "root"), jload(str(pope), "root"))


def test_sqlite_and_xlsx_match_jax(tmp_path):
    from vlrlhf_tpu.eval import db as J
    from vlrlhf_tpu.eval.xlsx import write_xlsx as jwrite
    from vlrlhf_torch.eval import db as T
    from vlrlhf_torch.eval.xlsx import write_xlsx as twrite

    for mod, name in ((J, "j.sqlite"), (T, "t.sqlite")):
        mod.log_metrics_to_sqlite(str(tmp_path / name), "MME", {"acc": 1.0, "f-1": "x"}, "a")
        mod.log_metrics_to_sqlite(str(tmp_path / name), "MME", {"acc": 2.0, "yes_rate": 3}, "b")
    want, got = J.read_sqlite(str(tmp_path / "j.sqlite"), "MME"), \
        T.read_sqlite(str(tmp_path / "t.sqlite"), "MME")
    for w, g in zip(want, got):
        w.pop("ts"), g.pop("ts")
    assert got == want and got[1]["yes_rate"] == 3 and got[0]["f_1"] == "x"
    conn = sqlite3.connect(str(tmp_path / "t.sqlite"))
    cols = [r[1] for r in conn.execute('PRAGMA table_info("MME")')]
    conn.close()
    assert cols == ["tag", "ts", "acc", "f_1", "yes_rate"]  # columns added as metrics appear
    rows = [{"index": 0, "question": "dog & <b>?", "response": "yes", "score": 0.85,
             "hit": True, "nan": float("nan")}, {"index": 1, "response": None, "extra": [1]}]
    twrite(str(tmp_path / "t.xlsx"), rows)
    jwrite(str(tmp_path / "j.xlsx"), rows)
    with zipfile.ZipFile(tmp_path / "t.xlsx") as zt, zipfile.ZipFile(tmp_path / "j.xlsx") as zj:
        assert zt.namelist() == zj.namelist()
        for part in zt.namelist():
            assert zt.read(part) == zj.read(part), part
    T.save_results_xlsx(str(tmp_path / "s.xlsx"), rows)
    with zipfile.ZipFile(tmp_path / "s.xlsx") as zs, zipfile.ZipFile(tmp_path / "t.xlsx") as zt:
        assert zs.read("xl/worksheets/sheet1.xml") == zt.read("xl/worksheets/sheet1.xml")


def test_sft_rows_and_batches_match_jax():
    """tokenize_row_sft (single-turn and conversations, with and without an
    image) and SFTCollator build vlrlhf_tpu's rows and batches byte for
    byte: the CE ranking's input."""
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.data.collators import SFTCollator as JSFTCollator
    from vlrlhf_torch.data.collators import CollatorConfig, SFTCollator

    _, _, jproc, _, tproc = _bundles()
    feats = [{"prompt": "what is shown?", "answer": "The answer is: a dog", "img_path": "a.png"},
             {"prompt": "count: a, b, c!", "answer": "three w3", "img_path": None},
             {"conversations": [{"from": "user", "value": "hi there"},
                                {"from": "assistant", "value": "hello w9 w9"},
                                {"from": "user", "value": "and now?"},
                                {"from": "assistant", "value": "now this."}],
              "img_path": "b.png"}]
    jrows = [jproc.tokenize_row_sft(f) for f in feats]
    trows = [tproc.tokenize_row_sft(f) for f in feats]
    assert trows == jrows
    jb = JSFTCollator(jproc, JCollatorConfig(bucket_multiple=32, image_size=16), _loader)(jrows)
    tb = SFTCollator(tproc, CollatorConfig(bucket_multiple=32, image_size=16), _loader)(trows)
    assert set(tb) == set(jb)
    for key in tb:
        assert tb[key].dtype == jb[key].dtype and tb[key].tobytes() == jb[key].tobytes(), key


def test_eval_imports_neither_pandas_nor_pil(tmp_path):
    """With pandas and PIL blocked, every eval module imports and a TSV
    benchmark loads, scores and writes its artifacts."""
    b64 = _image_b64(0)
    tsv = tmp_path / "mme.tsv"
    _write_tsv(tsv, ["index", "image", "question", "answer", "category"],
               [("0-0", b64, "is it blue?", "Yes", "existence"),
                ("0-1", "0-0", "is it red?", "No", "existence")])
    code = (
        "import sys\n"
        "sys.modules['pandas'] = None\n"
        "sys.modules['PIL'] = None\n"
        "from vlrlhf_torch.eval import benchmarks, datasets, db, harness, judge, scorers, xlsx\n"
        f"rows = benchmarks.BENCHMARKS['mme'].load_rows({str(tsv)!r})\n"
        "res = [dict(r, response='Yes') for r in rows]\n"
        "m = benchmarks.BENCHMARKS['mme'].score(res)\n"
        f"db.save_results_json({str(tmp_path / 'o.json')!r}, res)\n"
        f"db.save_results_xlsx({str(tmp_path / 'o.xlsx')!r}, res)\n"
        "assert m['existence'] == 50.0, m  # acc 1/2, acc+ 0\n"
        "assert not any(k.split('.')[0] in ('pandas', 'PIL', 'jax', 'vlrlhf_tpu')\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# ───────────────────────── run_benchmark end to end ─────────────────────────


@pytest.fixture(scope="module")
def runners():
    """(port runner, vlrlhf_tpu runner) over one bridged synthetic model."""
    from vlrlhf_tpu.data.collators import CollatorConfig as JCollatorConfig
    from vlrlhf_tpu.eval.harness import EvalRunner as JEvalRunner
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.engine import GenerateConfig

    jcfg, params, jproc, model, tproc = _bundles()
    tr = EvalRunner(model, tproc, GenerateConfig(max_new_tokens=4, pad_token_id=0),
                    CollatorConfig(pad_token_id=0, bucket_multiple=32, image_size=16), _loader)
    jr = JEvalRunner(model_cfg=jcfg, params=params, processor=jproc,
                     gen_cfg=JGenerateConfig(max_new_tokens=4, pad_token_id=0),
                     collator_cfg=JCollatorConfig(pad_token_id=0, bucket_multiple=32,
                                                  image_size=16),
                     image_loader=_loader)
    return tr, jr


def _files(tmp_path):
    b64 = _image_b64(0)
    mme = tmp_path / "mme.tsv"
    _write_tsv(mme, ["index", "image", "question", "answer", "category"],
               [(f"{i // 2}-{i % 2}", b64 if i % 2 == 0 else f"{i // 2}-0",
                 f"is the thing {i} blue?", ["Yes", "No"][i % 2], "existence") for i in range(4)])
    mmbench = tmp_path / "mmbench.tsv"
    _write_tsv(mmbench, ["index", "image", "question", "hint", "A", "B", "answer", "category"],
               [("0", b64, "what color?", None, "red", "blue", "A", "color"),
                ("1", "0", "what shape?", "look closely", "round", "square", "B", "shape")])
    pope = tmp_path / "pope.jsonl"
    pope.write_text("\n".join(json.dumps({"text": f"is there a {w}?", "label": lab,
                                          "image": f"{w}.jpg"})
                              for w, lab in (("dog", "yes"), ("cat", "no"), ("cow", "no"))))
    seed = tmp_path / "seed.json"
    seed.write_text(json.dumps({"questions": [
        {"question_id": f"q{i}", "question": f"what is shown {i}?", "choice_a": "a dog",
         "choice_b": "a cat", "choice_c": "a bird", "choice_d": "a fish w3 w9",
         "answer": "ABCD"[i], "data_id": f"img{i}.jpg", "question_type_id": 1} for i in range(3)
    ] + [{"question_id": "v1", "question": "video?", "answer": "A", "choice_a": "x",
          "choice_b": "y", "choice_c": "z", "choice_d": "w", "data_id": "v.mp4",
          "question_type_id": 10}]}))
    mmvet = tmp_path / "mmvet.json"
    mmvet.write_text(json.dumps({f"v{i}": {"imagename": f"v{i}.png", "question": f"what {i}?",
                                           "answer": ["a cat", "", "w3"][i]} for i in range(3)}))
    return {"mme": mme, "mmbench": mmbench, "pope": pope, "seedbench": seed,
            "seedbench_gen": seed, "mmvet": mmvet}


@pytest.mark.parametrize("name", ["mme", "mmbench", "pope", "seedbench", "seedbench_gen",
                                  "mmvet"])
def test_run_benchmark_matches_jax(tmp_path, runners, name):
    from vlrlhf_tpu.eval.benchmarks import run_benchmark as jrun
    from vlrlhf_tpu.eval.judge import EngineJudge as JJudge
    from vlrlhf_torch.eval.benchmarks import run_benchmark
    from vlrlhf_torch.eval.judge import EngineJudge

    tr, jr = runners
    data = str(_files(tmp_path)[name])
    judge = (EngineJudge(tr), JJudge(jr)) if name == "mmvet" else (None, None)
    got = run_benchmark(name, tr, data, "imgs", output_json=str(tmp_path / "t" / f"{name}.json"),
                        sqlite_db=str(tmp_path / "t.sqlite"), tag="t", judge=judge[0])
    want = jrun(name, jr, data, "imgs", output_json=str(tmp_path / "j" / f"{name}.json"),
                judge=judge[1])
    assert got == want
    t_rows = json.loads((tmp_path / "t" / f"{name}.json").read_text())
    j_rows = json.loads((tmp_path / "j" / f"{name}.json").read_text())
    _assert_rows_equal(t_rows, j_rows, ppl=name == "seedbench")
    assert ("ppl" in t_rows[0]) == (name == "seedbench")
    assert (tmp_path / "t" / f"{name}.xlsx").exists()
    import vlrlhf_torch.eval.db as db

    assert db.read_sqlite(str(tmp_path / "t.sqlite"), name.upper())[0]["tag"] == "t"


@pytest.mark.parametrize("adapters", [False, True])
def test_run_vqa_continuous_and_speculative_paths_match_static(runners, adapters):
    """The continuous engine (2 slots; plain and speculative bursts) and
    the static speculative generator give the static path's responses,
    vlrlhf_tpu's static responses without adapters; with the model's
    adapters on (a set with a non-zero b), the same and different ones."""
    import dataclasses

    import jax

    from tests.test_multilora import _sets
    from vlrlhf_torch.utils.bridge import load_lora_params

    tr, jr = runners
    rows = [{"question": q, "img": img} for q, img in (
        ("is there a dog?", "a.png"), ("what color is the sky w3 w3 w3?", None),
        ("describe the picture", "b.png"), ("count: a, b, c!", None))]
    base = tr.run_vqa(rows, batch_size=2)
    if adapters:
        sets, lcfg = _sets(jr.params)
        load_lora_params(tr.model, {"lm": jax.device_get(sets[0]["lm"])})
        tr = dataclasses.replace(tr, adapters=True, lora_scale=lcfg.scale)
    else:
        assert [r["response"] for r in base] == \
            [r["response"] for r in jr.run_vqa(rows, batch_size=2)]
    static = tr.run_vqa(rows, batch_size=2)
    assert (static != base) == adapters
    for kw in (dict(continuous_batching=True), dict(continuous_batching=True, speculative_k=3),
               dict(speculative_k=3)):
        runner = dataclasses.replace(tr, **kw)
        got = runner.run_vqa(rows, batch_size=2)
        assert [r["response"] for r in got] == [r["response"] for r in static], kw
    assert runner._gen.verify_calls >= 1
