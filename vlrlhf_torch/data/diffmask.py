"""DDPO token-diff masks, computed at preprocessing time (copy of
vlrlhf_tpu/data/diffmask.py: numpy and difflib only, copied because the
original imports jax through its package).

Behavioral port of the reference's diff semantics
(VL-RLHF's src/vlrlhf/utils/diff_lib.py:73-180): difflib
SequenceMatcher matching blocks of size >= min_match_size partition both
sequences into alternating (modified, matched) spans; a modified span pair is
kept only when BOTH sides are non-empty (substitutions — pure insertions or
deletions are not scored). `get_diff_ids` returns the modified token indices
on each side.

Crucially, the reference recomputes this with Python difflib INSIDE every
training step on CPU (base/trainer.py:169-184) — a per-step host sync. Here
the masks are computed once per example in the data pipeline and shipped to
the device as a static bool tensor (SURVEY.md §7.3.6).
"""

from __future__ import annotations

import difflib
from typing import Sequence

import numpy as np


def _match_spans(a: Sequence[int], b: Sequence[int], min_match_size: int):
    sm = difflib.SequenceMatcher(None, list(a), list(b), autojunk=False)
    mb = sm.get_matching_blocks()  # last element is the (len,len,0) sentinel
    mb = [m for m in mb[:-1] if m.size >= min_match_size] + [mb[-1]]
    a_matches = [(m.a, m.a + m.size) for m in mb]
    b_matches = [(m.b, m.b + m.size) for m in mb]
    return a_matches, b_matches


def _complete_spans(matches, length):
    i, j = 0, matches[0][0]
    out = []
    for idx in range(len(matches)):
        out.append((i, j))
        out.append(matches[idx])
        if idx + 1 < len(matches):
            i, j = matches[idx][1], matches[idx + 1][0]
        else:
            i, j = matches[idx][1], length
    return out


def get_diff_ids(
    a: Sequence[int], b: Sequence[int], min_match_size: int = 3
) -> tuple[list[int], list[int]]:
    """Indices of modified (substituted) tokens on each side."""
    a_matches, b_matches = _match_spans(a, b, min_match_size)
    a_spans = _complete_spans(a_matches, len(a))
    b_spans = _complete_spans(b_matches, len(b))
    a_ids, b_ids = set(), set()
    for idx, (sa, sb) in enumerate(zip(a_spans, b_spans)):
        if idx % 2 == 1:  # matched span
            continue
        if sa[0] != sa[1] and sb[0] != sb[1]:  # both sides non-empty
            a_ids.update(range(*sa))
            b_ids.update(range(*sb))
    return sorted(a_ids), sorted(b_ids)


def diff_masks(
    chosen_labels: Sequence[int],
    rejected_labels: Sequence[int],
    label_pad: int = -100,
    min_match_size: int = 3,
) -> tuple[np.ndarray, np.ndarray]:
    """Bool masks (True = token participates in the DDPO loss).

    Matches the reference exactly: the diff runs over the label sequences
    with pad positions replaced by 0 (trainer.py:163-180 sets masked labels
    to 0 *before* diffing), and the result is ANDed with the label mask.
    """
    c = np.asarray(chosen_labels)
    r = np.asarray(rejected_labels)
    c_for_diff = np.where(c == label_pad, 0, c)
    r_for_diff = np.where(r == label_pad, 0, r)
    c_ids, r_ids = get_diff_ids(
        c_for_diff.tolist(), r_for_diff.tolist(), min_match_size
    )
    c_mask = np.zeros(len(c), dtype=bool)
    r_mask = np.zeros(len(r), dtype=bool)
    c_mask[c_ids] = True
    r_mask[r_ids] = True
    return c_mask & (c != label_pad), r_mask & (r != label_pad)
