"""LLM choice-extraction judge and MM-Vet grader served by the port's own
engine (counterpart of vlrlhf_tpu/eval/judge.py): the reference's judging
prompts, run through an EvalRunner of the judge model. The regex extractor
(eval/scorers.py) stays the first line; the judge sees only responses it
could not resolve (`judge_unresolved`), or grades free-form answers 0-1
(`grade_freeform`).
"""

from __future__ import annotations

from typing import Optional, Sequence

from vlrlhf_torch.eval.scorers import extract_choice

# the reference's judging prompt, verbatim protocol
# (eval/seedbench/extract_choice.py:5-20)
JUDGE_TEMPLATE = (
    "You are an AI assistant who will help me to match "
    "an answer with several options of a single-choice question. "
    "You are provided with a question, several options, and an answer, "
    "and you need to find which option is most similar to the answer. "
    "If the meaning of all options are significantly different from the "
    "answer, output Z. "
    "Your should output a single uppercase character in A, B, C, D (if they "
    "are valid options), and Z. \n"
    "Example 1: \n"
    "Question: What is the main object in image?\n"
    "Options: A. teddy bear B. rabbit C. cat D. dog\n"
    "Answer: a cute teddy bear\nYour output: A\n"
    "Example 2: \n"
    "Question: What is the main object in image?\n"
    "Options: A. teddy bear B. rabbit C. cat D. dog\n"
    "Answer: Spider\nYour output: Z\n"
    "Example 3: \n"
    "Question: {}?\nOptions: {}\nAnswer: {}\nYour output: "
)


# MM-Vet grading protocol (the official evaluator the reference calls via
# the whyu-mm-vet-evaluator HF space, eval/mmvet/calculate.py:25): grade a
# free-form prediction against a gold answer with <AND>/<OR> structure on a
# 0.0-1.0 scale. Few-shot examples paraphrase the public rubric.
GRADER_TEMPLATE = (
    "Compare the ground truth and prediction from AI models, to give a "
    "correctness score for the prediction. <AND> in the ground truth means "
    "it is correct only if all elements are present in the prediction, and "
    "<OR> means it is correct if any one element is present. The "
    "correctness score is a number between 0.0 (totally wrong) and 1.0 "
    "(totally right), in steps of 0.1. Output ONLY the score.\n"
    "Example 1:\n"
    "Question: What is x in the equation?\n"
    "Ground truth: -1 <AND> -5\nPrediction: x = 3\nCorrectness: 0.0\n"
    "Example 2:\n"
    "Question: What occasion is shown?\n"
    "Ground truth: birthday <OR> celebration\n"
    "Prediction: It looks like a birthday party.\nCorrectness: 1.0\n"
    "Example 3:\n"
    "Question: {}\nGround truth: {}\nPrediction: {}\nCorrectness: "
)

_SCORE_RE = None


def parse_score(text: str):
    """First 0-1 float in the judge's output, clipped to [0, 1]; None if
    unparseable. The raw float is kept (no snapping to the 0.1 grid): the
    official MM-Vet grader averages whatever the judge emits and lets the
    rubric prompt's 0.1 steps do the quantizing — snapping here would shift
    e.g. a judged 0.85 by 0.05 per row vs the reference protocol."""
    import re

    global _SCORE_RE
    if _SCORE_RE is None:
        _SCORE_RE = re.compile(r"(?<!\d)(1(?:\.0+)?|0?\.\d+|0|1)(?!\d)")
    m = _SCORE_RE.search(text)
    if not m:
        return None
    return min(max(float(m.group(1)), 0.0), 1.0)


class EngineJudge:
    """Batch choice-matching over an EvalRunner (any text-capable family).

    `runner` is an eval.harness.EvalRunner wrapping the judge model — the
    same machinery that serves the benchmark model, so a judge deployment is
    one more checkpoint, not one more serving system."""

    def __init__(self, runner, batch_size: int = 16):
        self.runner = runner
        self.batch_size = batch_size

    def extract(self, rows: Sequence[dict]) -> list[Optional[str]]:
        """rows: [{question, options: {letter: text}, response}] ->
        one letter (or None for the reference's 'Z' / unparseable)."""
        prompts = []
        for r in rows:
            options = " ".join(
                f"{k}. {v}" for k, v in sorted(r["options"].items())
            )
            prompts.append(
                JUDGE_TEMPLATE.format(
                    str(r["question"]).rstrip("?"), options, r["response"]
                )
            )
        judged = self.runner.run_vqa(
            [{"question": p, "img": None} for p in prompts],
            batch_size=self.batch_size,
        )
        out: list[Optional[str]] = []
        for r, j in zip(rows, judged):
            text = j["response"].strip()
            letter = text[:1].upper() if text else ""
            if letter in r["options"]:
                out.append(letter)
            else:
                # judge was verbose — run the deterministic extractor on it
                out.append(extract_choice(text, r["options"]))
        return out


    def grade(self, rows: Sequence[dict]) -> "list[Optional[float]]":
        """rows: [{question, answer, response}] -> 0.0-1.0 scores (None for
        unparseable judge output). The MM-Vet grading role."""
        prompts = [
            GRADER_TEMPLATE.format(r["question"], r["answer"], r["response"])
            for r in rows
        ]
        judged = self.runner.run_vqa(
            [{"question": p, "img": None} for p in prompts],
            batch_size=self.batch_size,
        )
        return [parse_score(j["response"]) for j in judged]


def grade_freeform(
    results: Sequence[dict],
    judge: "EngineJudge",
) -> list[dict]:
    """Attach a 'judge_score' to every row with a gold answer (the MM-Vet
    grading pass); rows whose score the judge failed to emit stay ungraded
    and fall back to the deterministic scorer."""
    idx = [i for i, r in enumerate(results) if str(r.get("answer", "")).strip()]
    rows = [
        {"question": results[i].get("question", ""),
         "answer": results[i]["answer"], "response": results[i]["response"]}
        for i in idx
    ]
    out = [dict(r) for r in results]
    if rows:
        for i, s in zip(idx, judge.grade(rows)):
            if s is not None:
                out[i]["judge_score"] = s
    return out


def judge_unresolved(
    results: Sequence[dict],
    judge: "EngineJudge",
    options_keys: Sequence[str] = ("A", "B", "C", "D", "E"),
    question_key: str = "question",
) -> list[dict]:
    """Two-stage extraction over benchmark results: rows whose response the
    deterministic extractor can't resolve get a 'judged_choice' field from
    the LLM judge; resolved rows pass through untouched. Mirrors
    extract_choice.py's fast-path + unclear_results split."""
    unresolved_idx = []
    unresolved_rows = []
    out = [dict(r) for r in results]
    for i, r in enumerate(out):
        options = {
            k: r[k] for k in options_keys
            if r.get(k) not in (None, "") and r.get(k) == r.get(k)  # not NaN
        }
        if extract_choice(r["response"], options or None) is None and options:
            unresolved_idx.append(i)
            unresolved_rows.append(
                {"question": r.get(question_key, ""), "options": options,
                 "response": r["response"]}
            )
    if unresolved_rows:
        for i, letter in zip(unresolved_idx, judge.extract(unresolved_rows)):
            if letter is not None:
                out[i]["judged_choice"] = letter
                # scoring reads `response`; normalize to a clean letter but
                # keep the model's actual generation in the saved artifacts
                out[i]["raw_response"] = out[i]["response"]
                out[i]["response"] = letter
    return out
