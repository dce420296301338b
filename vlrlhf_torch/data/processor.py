"""VLProcessor: prompt formatting, conversation tokenization and image
placeholder expansion — the serving subset of vlrlhf_tpu/data/processor.py,
copied because importing anything under vlrlhf_tpu pulls in jax.

`expand_image_tokens` rewrites each image placeholder id into
`num_image_tokens` copies and returns the position map, so the model merges
image features with a static-shape scatter (models/common.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np

from vlrlhf_torch.data.chat_templates import ChatTemplate


@dataclasses.dataclass(frozen=True)
class ProcessorConfig:
    num_image_tokens: int = 576
    image_token: str = "<image>"  # string form inside prompts
    image_token_id: int = 32000


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

    def expand_image_tokens(
        self, input_ids: Sequence[int]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Expand each image placeholder id into num_image_tokens copies.
        Returns (new_ids, image_positions), one position per image token."""
        ids = np.asarray(input_ids)
        img_id = self.cfg.image_token_id
        n_tok = self.cfg.num_image_tokens
        out_ids, positions = [], []
        prev = 0
        for o in np.nonzero(ids == img_id)[0]:
            out_ids.extend(ids[prev:o].tolist())
            positions.extend(range(len(out_ids), len(out_ids) + n_tok))
            out_ids.extend([img_id] * n_tok)
            prev = o + 1
        out_ids.extend(ids[prev:].tolist())
        return np.asarray(out_ids, np.int32), np.asarray(positions, np.int32)
