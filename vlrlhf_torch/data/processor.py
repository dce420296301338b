"""VLProcessor: prompt formatting, conversation tokenization, DPO row
tokenization and image placeholder expansion — the serving and DPO subset of
vlrlhf_tpu/data/processor.py (incremental-template families), copied
because importing anything under vlrlhf_tpu pulls in jax.

`tokenize_row_dpo` follows TRL 0.8.1 DPOTrainer.tokenize_row as the JAX
package does: merge-boundary handling in `_build_tokenized_answer`, BOS/EOS
insertion, keep_end prompt truncation.

`expand_image_tokens` rewrites each image placeholder id into
`num_image_tokens` copies and returns the position map, so the model merges
image features with a static-shape scatter (models/common.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence

import numpy as np

from vlrlhf_torch.data.chat_templates import ChatTemplate

LABEL_PAD = -100


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    num_image_tokens: int = 576
    image_token: str = "<image>"  # string form inside prompts
    image_token_id: int = 32000
    max_length: int = 1024
    max_prompt_length: int = 512  # truncation keeps a prompt's end


def make_single_turn_conv(prompt: str, answer: str = "") -> list[dict]:
    return [
        {"from": "user", "value": prompt},
        {"from": "assistant", "value": answer},
    ]


class VLProcessor:
    def __init__(self, tokenizer, template: ChatTemplate, cfg: ProcessorConfig):
        self.tokenizer = tokenizer
        self.template = template
        self.cfg = cfg

    def format_multimodal_prompt(self, prompt: str, n_images: int = 1) -> str:
        ph = self.template.image_placeholder
        if n_images == 0:
            return prompt
        if n_images == 1 and self.cfg.image_token not in prompt:
            return ph + prompt
        if prompt.count(self.cfg.image_token) != n_images:
            raise ValueError(
                f"{n_images} images but prompt has "
                f"{prompt.count(self.cfg.image_token)} placeholders"
            )
        return prompt.replace(self.cfg.image_token, ph)

    def process_conv(self, conv: Sequence[dict]) -> dict[str, Any]:
        """Returns {input_ids, raw_str} for one conversation: the templated
        string, tokenized once with the BOS token (the incremental labeling
        of vlrlhf_tpu yields the same ids; serving needs no labels)."""
        t = self.template
        role_begin = {"user": t.user_begin, "assistant": t.assistant_begin}
        role_end = {"user": t.user_end, "assistant": t.assistant_end}
        raw = t.preamble
        for turn in conv:
            value = turn["value"]
            raw += role_begin[turn["from"]] + value + (role_end[turn["from"]] if value else "")
        return {
            "input_ids": self.tokenizer.encode(raw, add_special_tokens=True),
            "raw_str": raw,
        }

    # ─────────── DPO row tokenization (TRL 0.8.1 semantics) ───────────

    def _build_tokenized_answer(self, prompt: str, answer: str):
        tok = self.tokenizer
        full = tok.encode(prompt + answer, add_special_tokens=False)
        prompt_ids = tok.encode(prompt, add_special_tokens=False)
        if len(full) < len(prompt_ids):
            raise ValueError("prompt tokenization longer than full tokenization")
        start = len(prompt_ids)
        # Sentencepiece merge at the boundary: move the split back by one.
        if prompt_ids != full[:start]:
            start -= 1
        return {"prompt_input_ids": full[:start], "input_ids": full[start:]}

    def tokenize_row_dpo(self, feature: dict) -> dict:
        """feature: {prompt, chosen, rejected, img_path?}. The prompt is
        templated with an empty assistant turn, as the reference builds it
        (base/trainer.py:105-118)."""
        n_images = 0
        if feature.get("img_path"):
            n_images = (
                len(feature["img_path"])
                if isinstance(feature["img_path"], list)
                else 1
            )
        prompt_raw = self.process_conv(
            make_single_turn_conv(
                self.format_multimodal_prompt(feature["prompt"], n_images), ""
            )
        )["raw_str"]
        chosen = feature["chosen"] + self.template.assistant_end
        rejected = feature["rejected"] + self.template.assistant_end

        tok = self.tokenizer
        cfg = self.cfg
        prompt_ids = tok.encode(prompt_raw, add_special_tokens=False)
        chosen_t = self._build_tokenized_answer(prompt_raw, chosen)
        rejected_t = self._build_tokenized_answer(prompt_raw, rejected)
        prompt_len = min(
            len(chosen_t["prompt_input_ids"]), len(rejected_t["prompt_input_ids"])
        )
        prompt_ids = prompt_ids[:prompt_len]

        def with_bos(ids):
            if tok.bos_token_id is not None:
                return [tok.bos_token_id] + ids
            return ids

        prompt_ids = with_bos(prompt_ids)
        chosen_prompt = with_bos(chosen_t["prompt_input_ids"])
        rejected_prompt = with_bos(rejected_t["prompt_input_ids"])
        chosen_ans = chosen_t["input_ids"] + [tok.eos_token_id]
        rejected_ans = rejected_t["input_ids"] + [tok.eos_token_id]

        longer = max(len(chosen_ans), len(rejected_ans))
        rows = {"prompt": prompt_ids, "chosen": chosen_prompt, "rejected": rejected_prompt}
        for k, ids in rows.items():
            if len(ids) + longer > cfg.max_length:
                rows[k] = ids[-cfg.max_prompt_length :]
        chosen_prompt, rejected_prompt = rows["chosen"], rows["rejected"]
        if len(chosen_prompt) + longer > cfg.max_length:
            chosen_ans = chosen_ans[: cfg.max_length - cfg.max_prompt_length]
        if len(rejected_prompt) + longer > cfg.max_length:
            rejected_ans = rejected_ans[: cfg.max_length - cfg.max_prompt_length]

        return {
            "chosen_input_ids": chosen_prompt + chosen_ans,
            "chosen_labels": [LABEL_PAD] * len(chosen_prompt) + chosen_ans,
            "rejected_input_ids": rejected_prompt + rejected_ans,
            "rejected_labels": [LABEL_PAD] * len(rejected_prompt) + rejected_ans,
            "prompt_input_ids": rows["prompt"],
            "img_path": feature.get("img_path"),
        }

    # ─────────── image token expansion ───────────

    def expand_image_tokens(
        self,
        input_ids: Sequence[int],
        labels: Optional[Sequence[int]] = None,
    ) -> tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Expand each image placeholder id into num_image_tokens copies
        (labels LABEL_PAD there). Returns (new_ids, new_labels or None,
        image_positions) with one position per expanded image token."""
        ids = np.asarray(input_ids)
        img_id = self.cfg.image_token_id
        occ = np.nonzero(ids == img_id)[0]
        if len(occ) == 0:
            return ids, (None if labels is None else np.asarray(labels)), np.zeros((0,), np.int32)
        n_tok = self.cfg.num_image_tokens
        out_ids, out_labels, positions = [], [], []
        prev = 0
        for o in occ:
            out_ids.extend(ids[prev:o].tolist())
            if labels is not None:
                out_labels.extend(list(labels[prev:o]))
            start = len(out_ids)
            out_ids.extend([img_id] * n_tok)
            if labels is not None:
                out_labels.extend([LABEL_PAD] * n_tok)
            positions.extend(range(start, start + n_tok))
            prev = o + 1
        out_ids.extend(ids[prev:].tolist())
        if labels is not None:
            out_labels.extend(list(labels[prev:]))
        return (
            np.asarray(out_ids, np.int32),
            None if labels is None else np.asarray(out_labels, np.int64),
            np.asarray(positions, np.int32),
        )
