"""In-repo scorers of the benchmark suite (a copy of
vlrlhf_tpu/eval/scorers.py, pure Python): POPE's yes/no normalization and
metrics, MME acc + acc+, regex-first multiple-choice extraction with an
option-content fallback, lowest-CE choice accuracy and normalized
exact-match VQA accuracy.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Optional, Sequence


def extract_yes_no(response: str) -> str:
    """POPE's normalization (eval/pope/eval.py:36-47): first sentence, comma
    stripped; 'no'/'not'/'No' anywhere -> no, else yes."""
    text = response
    if "." in text:
        text = text.split(".")[0]
    text = text.replace(",", "")
    words = text.split(" ")
    return "no" if ("No" in words or "not" in words or "no" in words) else "yes"


def pope_metrics(results: Sequence[dict]) -> dict:
    """results: [{response, label('yes'/'no')}]."""
    preds = [1 if extract_yes_no(r["response"]) == "yes" else 0 for r in results]
    labels = [1 if r["label"] == "yes" else 0 for r in results]
    tp = sum(1 for p, l in zip(preds, labels) if p == 1 and l == 1)
    fp = sum(1 for p, l in zip(preds, labels) if p == 1 and l == 0)
    tn = sum(1 for p, l in zip(preds, labels) if p == 0 and l == 0)
    fn = sum(1 for p, l in zip(preds, labels) if p == 0 and l == 1)
    precision = tp / max(tp + fp, 1)
    recall = tp / max(tp + fn, 1)
    f1 = 2 * precision * recall / max(precision + recall, 1e-9)
    acc = (tp + tn) / max(len(preds), 1)
    return {
        "acc": round(acc * 100, 2),
        "precision": round(precision * 100, 2),
        "recall": round(recall * 100, 2),
        "f1": round(f1 * 100, 2),
        "yes_rate": round(100 * sum(preds) / max(len(preds), 1), 2),
    }


MME_PERCEPTION_TASKS = (
    "existence", "count", "position", "color", "posters", "celebrity",
    "scene", "landmark", "artwork", "OCR",
)
MME_COGNITION_TASKS = (
    "commonsense_reasoning", "numerical_calculation", "text_translation",
    "code_reasoning",
)


def mme_scores(results: Sequence[dict]) -> dict:
    """results: [{category, image_id|index, response, answer('Yes'/'No')}].
    Per-task score = 100*(acc + acc+), acc+ = both questions of an image
    correct. Returns per-task scores + perception/cognition totals."""
    by_task_img = defaultdict(lambda: defaultdict(list))
    for r in results:
        img_key = r.get("image_id", r.get("index"))
        # two questions share an image; index pairs like '0-0','0-1'
        img_key = str(img_key).rsplit("-", 1)[0] if "-" in str(img_key) else img_key
        correct = extract_yes_no(r["response"]) == str(r["answer"]).strip().lower()
        by_task_img[r["category"]][img_key].append(correct)
    out = {}
    for task, imgs in by_task_img.items():
        flat = [c for qs in imgs.values() for c in qs]
        acc = sum(flat) / max(len(flat), 1)
        acc_plus = sum(1 for qs in imgs.values() if all(qs) and len(qs) >= 2) / max(
            len(imgs), 1
        )
        out[task] = round(100 * (acc + acc_plus), 2)
    out["perception"] = round(
        sum(out.get(t, 0.0) for t in MME_PERCEPTION_TASKS), 2
    )
    out["cognition"] = round(sum(out.get(t, 0.0) for t in MME_COGNITION_TASKS), 2)
    return out


_CHOICE_PATTERNS = [
    re.compile(r"^\s*\(?([A-E])\)?[\s\.\,\:\)]", re.IGNORECASE),
    re.compile(r"^\s*([A-E])$", re.IGNORECASE),
    re.compile(r"answer is[^A-E]*([A-E])\b", re.IGNORECASE),
    re.compile(r"answer[^A-E]*([A-E])\b", re.IGNORECASE),
    re.compile(r"option[^A-E]*([A-E])\b", re.IGNORECASE),
    re.compile(r"\(([A-E])\)"),
]


def extract_choice(
    response: str, options: Optional[dict[str, str]] = None
) -> Optional[str]:
    """Regex-first letter extraction; falls back to matching option CONTENT
    (the deterministic part of eval/seedbench/extract_choice.py's protocol)."""
    response = response.strip()
    for pat in _CHOICE_PATTERNS:
        m = pat.search(response)
        if m:
            letter = m.group(1).upper()
            if options is None or letter in options:
                return letter
    if options:
        lowered = response.lower()
        # exact option text match, longest first to avoid substring hits
        for letter, text in sorted(
            options.items(), key=lambda kv: -len(str(kv[1]))
        ):
            if text and str(text).lower() in lowered:
                return letter
    return None


def multiple_choice_accuracy(
    results: Sequence[dict],
    answer_key: str = "answer",
    options_keys: Sequence[str] = ("A", "B", "C", "D", "E"),
) -> dict:
    """results: [{response, answer, A..E?}] -> accuracy + extraction rate."""
    def _valid(v):
        if v is None or v == "":
            return False
        return not (isinstance(v, float) and v != v)  # NaN

    n_correct, n_extracted = 0, 0
    for r in results:
        options = {k: r[k] for k in options_keys if _valid(r.get(k))}
        pred = extract_choice(r["response"], options or None)
        if pred is not None:
            n_extracted += 1
        if pred == str(r[answer_key]).strip().upper():
            n_correct += 1
    n = max(len(results), 1)
    return {
        "acc": round(100 * n_correct / n, 2),
        "extraction_rate": round(100 * n_extracted / n, 2),
    }


def ppl_choice_accuracy(results: Sequence[dict]) -> dict:
    """Log-likelihood mode: rows carry (index, choice_idx, ppl, answer_idx);
    the lowest-CE choice wins (eval/seedbench/eval.py + run_vqa_ppl)."""
    by_q = defaultdict(list)
    for r in results:
        by_q[r["index"]].append(r)
    n_correct = 0
    for rows in by_q.values():
        best = min(rows, key=lambda r: r["ppl"])
        if best["choice_idx"] == rows[0]["answer_idx"]:
            n_correct += 1
    return {"acc": round(100 * n_correct / max(len(by_q), 1), 2)}


def vqa_accuracy(results: Sequence[dict], answer_key: str = "answer") -> dict:
    """Generic VQA: normalized exact match."""

    def norm(s):
        return re.sub(r"[^a-z0-9 ]", "", str(s).lower().strip())

    n_correct = sum(
        1 for r in results if norm(r["response"]) == norm(r[answer_key])
    )
    return {"acc": round(100 * n_correct / max(len(results), 1), 2)}
