"""The benchmark definitions (counterpart of vlrlhf_tpu/eval/benchmarks.py):
loaders, prompt building and scoring for MME, MMBench (circular scoring
over rotated copies), SEEDBench (CE ranking, and generate-and-extract),
MMVet, MMMU, MathVista, POPE and generic VQA, and `run_benchmark`.

Prompts are string-identical to vlrlhf_tpu's (the reference's
per-benchmark Dataset classes). Each benchmark yields rows with a
`question` (the full prompt), `img` path(s) and metadata, and a
`score(results)`. Modes: 'generate' (run_vqa) or 'ppl' (run_vqa_ppl).
"""

from __future__ import annotations

import re
import string
import tempfile
from typing import Callable, Optional

from vlrlhf_torch.eval.datasets import TSVBenchmark, load_json_benchmark
from vlrlhf_torch.eval.scorers import (
    mme_scores,
    multiple_choice_accuracy,
    pope_metrics,
    ppl_choice_accuracy,
    vqa_accuracy,
)


def _notna(v) -> bool:
    return v is not None and v == v and v != ""


class Benchmark:
    name: str = ""
    mode: str = "generate"

    def load_rows(self, data_file: str, **kw) -> list[dict]:
        raise NotImplementedError

    def score(self, results: list[dict]) -> dict:
        raise NotImplementedError


class MME(Benchmark):
    """eval/mme/eval.py: prompt = the raw question (yes/no); acc + acc+."""

    name = "mme"

    def load_rows(self, data_file: str, **kw) -> list[dict]:
        rows = TSVBenchmark(data_file, kw.get("img_dir")).rows()
        return [dict(r, question=r["question"]) for r in rows]

    def score(self, results):
        return mme_scores(results)


class MMBench(Benchmark):
    """eval/mmbench/eval.py:74-115: hint + question + lettered options +
    'please only output the option letter.'"""

    name = "mmbench"
    sys_prompt = "There are several options:"

    def load_rows(self, data_file: str, **kw) -> list[dict]:
        out = []
        for r in TSVBenchmark(data_file, kw.get("img_dir")).rows():
            options = {
                c: r[c]
                for c in ("A", "B", "C", "D", "E")
                if c in r and _notna(r[c])
            }
            options_prompt = f"{self.sys_prompt}\n"
            for k, v in options.items():
                options_prompt += f"{k}. {v}\n"
            hint = r.get("hint")
            if _notna(hint):
                prompt = (
                    f"{hint} {r['question']} {options_prompt}\n"
                    "please only output the option letter."
                )
            else:
                prompt = (
                    f"{r['question']} {options_prompt}\n"
                    "please only output the option letter."
                )
            out.append(dict(r, question=prompt, options_dict=options))
        return out

    def score(self, results):
        """CircularEval when the TSV carries rotated copies (official MMBench
        convention: rotations share `index % 1e6`; a question counts only if
        every rotation is answered correctly — what VLMEvalKit computes for
        the reference). Falls back to plain accuracy otherwise."""
        from collections import defaultdict

        from vlrlhf_torch.eval.scorers import extract_choice

        has_circular = any(int(r["index"]) >= 1_000_000 for r in results
                           if str(r["index"]).isdigit())
        if not has_circular:
            return multiple_choice_accuracy(results)
        by_q = defaultdict(list)
        for r in results:
            by_q[int(r["index"]) % 1_000_000].append(r)
        n_correct = 0
        for rows in by_q.values():
            ok = all(
                extract_choice(r["response"], r.get("options_dict"))
                == str(r["answer"]).strip().upper()
                for r in rows
            )
            n_correct += ok
        return {
            "acc": round(100 * n_correct / max(len(by_q), 1), 2),
            "mode": "circular",
        }


class SEEDBench(Benchmark):
    """eval/seedbench/eval.py:23-57: log-likelihood over 4 'The answer is:
    <choice>' continuations; image-only questions (question_type_id <= 9)."""

    name = "seedbench"
    mode = "ppl"

    def load_rows(self, data_file: str, image_root: str = "", **kw) -> list[dict]:
        import json
        import os

        with open(data_file) as f:
            raw = json.load(f)["questions"]
        out = []
        letters = ("a", "b", "c", "d")
        for q in raw:
            if q.get("question_type_id", 0) > 9:
                continue  # video questions
            answer_idx = letters.index(q["answer"].lower())
            for i, c in enumerate(letters):
                key = f"choice_{c}"
                if key not in q:
                    continue
                out.append(
                    {
                        "index": q["question_id"],
                        "question": q["question"],
                        "answer": "The answer is: " + q[key],
                        "choice_idx": i,
                        "answer_idx": answer_idx,
                        "img": os.path.join(
                            image_root or "", q.get("data_id", "")
                        ),
                    }
                )
        return out

    def score(self, results):
        return ppl_choice_accuracy(results)


class SEEDBenchGen(Benchmark):
    """SEEDBench generate-and-judge mode (eval/seedbench/eval_generate.py +
    extract_choice.py): lettered-options prompt, regex-first extraction in
    place of the reference's lmdeploy LLM judge."""

    name = "seedbench_gen"

    def load_rows(self, data_file: str, image_root: str = "", **kw) -> list[dict]:
        import json
        import os

        with open(data_file) as f:
            raw = json.load(f)["questions"]
        out = []
        for q in raw:
            if q.get("question_type_id", 0) > 9:
                continue
            options = {
                c.upper(): q[f"choice_{c}"]
                for c in ("a", "b", "c", "d")
                if f"choice_{c}" in q
            }
            prompt = q["question"] + "\nThere are several options:\n"
            for k, v in options.items():
                prompt += f"{k}. {v}\n"
            prompt += "please only output the option letter."
            out.append(
                {
                    "index": q["question_id"],
                    "question": prompt,
                    "answer": q["answer"].upper(),
                    "img": os.path.join(image_root or "", q.get("data_id", "")),
                    **options,
                }
            )
        return out

    def score(self, results):
        return multiple_choice_accuracy(results)


class MMVet(Benchmark):
    """eval/mmvet/eval.py: free-form answers saved for grading; in-repo
    fallback scores exact/substring match against the gold answer."""

    name = "mmvet"

    def load_rows(self, data_file: str, image_root: str = "", **kw) -> list[dict]:
        rows = load_json_benchmark(data_file, image_root, image_key="imagename")
        return [dict(r, question=r["question"]) for r in rows]

    def score(self, results):
        # Graded rows (LLM grading judge, eval/judge.py:grade_freeform — the
        # official MM-Vet GPT-grader role) average their 0-1 judge_score;
        # ungraded rows use the hermetic substring fallback.
        total = 0.0
        for r in results:
            if r.get("judge_score") is not None:
                total += float(r["judge_score"])
            elif (
                str(r.get("answer", "")).lower().strip()
                and str(r["answer"]).lower().strip() in r["response"].lower()
            ):
                total += 1.0
        return {"acc": round(100 * total / max(len(results), 1), 2)}


class _TSVMultipleChoice(Benchmark):
    """Shared MMMU/MathVista form (eval/mmmu/eval.py:85-104): Hint + Question
    + 'Options:' block + instruction; multi-image via <image n> markers."""

    instruction = "Please select the correct answer from the options above. \n"

    def load_rows(self, data_file: str, **kw) -> list[dict]:
        out = []
        for r in TSVBenchmark(data_file, kw.get("img_dir")).rows():
            options = {
                c: r[c]
                for c in string.ascii_uppercase
                if c in r and _notna(r[c])
            }
            prompt = ""
            if _notna(r.get("hint")):
                prompt += f"Hint: {r['hint']}\n"
            prompt += f"Question: {r['question']}\n"
            if options:
                prompt += "Options:\n"
                for k, v in options.items():
                    prompt += f"{k}. {v}\n"
                prompt += self.instruction
            prompt = re.sub(r"<image \d>", "<image>", prompt)
            out.append(dict(r, question=prompt, options_dict=options))
        return out

    def score(self, results):
        mc = [r for r in results if r.get("options_dict")]
        open_rows = [r for r in results if not r.get("options_dict")]
        metrics = multiple_choice_accuracy(mc) if mc else {"acc": 0.0}
        if open_rows:
            open_acc = vqa_accuracy(open_rows)["acc"]
            n_mc, n_open = len(mc), len(open_rows)
            metrics["open_acc"] = open_acc
            metrics["overall"] = round(
                (metrics["acc"] * n_mc + open_acc * n_open) / (n_mc + n_open), 2
            )
        else:
            metrics["overall"] = metrics["acc"]
        return metrics


class MMMU(_TSVMultipleChoice):
    name = "mmmu"


class MathVista(_TSVMultipleChoice):
    name = "mathvista"


class POPE(Benchmark):
    """eval/pope/eval.py: jsonl {question(text), label} yes/no hallucination
    probe; acc/P/R/F1/yes-rate."""

    name = "pope"

    def load_rows(self, data_file: str, image_root: str = "", **kw) -> list[dict]:
        rows = load_json_benchmark(data_file, image_root)
        out = []
        for r in rows:
            question = r.get("text", r.get("question"))
            out.append(dict(r, question=question))
        return out

    def score(self, results):
        return pope_metrics(results)


class VQA(Benchmark):
    """eval/vqa/generate.py: generic {image, prompt} json."""

    name = "vqa"

    def load_rows(self, data_file: str, image_root: str = "", **kw) -> list[dict]:
        rows = load_json_benchmark(data_file, image_root)
        return [dict(r, question=r.get("prompt", r.get("question"))) for r in rows]

    def score(self, results):
        if results and "answer" in results[0]:
            return vqa_accuracy(results)
        return {"n": len(results)}


BENCHMARKS: dict[str, Benchmark] = {
    b.name: b
    for b in (
        MME(), MMBench(), SEEDBench(), SEEDBenchGen(), MMVet(), MMMU(),
        MathVista(), POPE(), VQA(),
    )
}


def run_benchmark(
    name: str,
    runner,
    data_file: str,
    image_root: str = "",
    batch_size: int = 16,
    output_json: Optional[str] = None,
    sqlite_db: Optional[str] = None,
    tag: Optional[str] = None,
    progress: bool = False,
    judge=None,  # eval.judge.EngineJudge: LLM fallback for choice extraction
) -> dict:
    """Load -> run (generate or ppl) -> score -> persist, one process (the
    whole dataset, in order: vlrlhf_tpu's per-process shard and gather are
    the identity here). `runner` is an EvalRunner or an EndpointRunner."""
    bench = BENCHMARKS[name]
    # a TSV benchmark's decoded images live for the whole run
    with tempfile.TemporaryDirectory() as img_dir:
        rows = bench.load_rows(data_file, image_root=image_root, img_dir=img_dir)
        if bench.mode == "ppl":
            results = runner.run_vqa_ppl(rows, batch_size=batch_size, progress=progress)
        else:
            results = runner.run_vqa(rows, batch_size=batch_size, progress=progress)
    if judge is not None and bench.mode != "ppl":
        # two-stage extraction: deterministic first, the LLM judge for the rest
        from vlrlhf_torch.eval.judge import grade_freeform, judge_unresolved

        if name == "mmvet":
            results = grade_freeform(results, judge)  # MM-Vet's 0-1 grading role
        else:
            results = judge_unresolved(results, judge)
    metrics = bench.score(results)
    if output_json:
        from vlrlhf_torch.eval.db import save_results_json, save_results_xlsx

        save_results_json(output_json, results)
        if output_json.endswith(".json"):  # the xlsx twin of the json artifact
            save_results_xlsx(output_json[: -len(".json")] + ".xlsx", results)
    if sqlite_db:
        from vlrlhf_torch.eval.db import log_metrics_to_sqlite

        log_metrics_to_sqlite(sqlite_db, name.upper(), metrics, tag)
    return metrics
