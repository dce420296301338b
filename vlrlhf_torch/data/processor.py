"""VLProcessor: prompt formatting, conversation tokenization, DPO and SFT
row tokenization and image placeholder expansion — the serving, training
and eval subset of vlrlhf_tpu/data/processor.py, copied because importing
anything under vlrlhf_tpu pulls in jax.

Qwen-VL's template is ChatML, built token by token (`style="chatml"`,
`_process_conv_chatml`, `_tokenize_row_dpo_chatml`) with no BOS
(`add_bos=False`); its image placeholder is wrapped: "Picture 1: <img>"
text around one placeholder id that expands to image_start_id, n pad ids
and image_end_id, the features landing on the pad ids
(`format_multimodal_prompt`, `expand_image_tokens`).

InstructBLIP is a prefix-embedding model: its prompt text has no
placeholder, and one image token per image is put before the sequence
(`prefix_image_tokens`, `maybe_prefix_image_ids`); its Q-Former reads the
prompt through a second, BERT tokenizer (`qformer_tokenizer`,
`qformer_ids`), and the DPO and SFT rows carry those ids as
`qformer_input_ids`. LLaVA-Next's anyres images expand to a per-image
token count (`expand_image_tokens(counts=...)`).

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
    add_bos: bool = True
    # Qwen-style wrapped expansion: placeholder -> start + n * pad + end,
    # the features scattered onto the pad slots
    image_start_id: Optional[int] = None
    image_end_id: Optional[int] = None
    image_pad_id: Optional[int] = None  # defaults to image_token_id
    # prefix-embedding models (InstructBLIP): no placeholder in the text;
    # one image token per image is prepended to the sequence (before BOS)
    # and expands to num_image_tokens, the reference's query-embeds prepend
    prefix_image_tokens: bool = False


def make_single_turn_conv(prompt: str, answer: str = "") -> list[dict]:
    return [
        {"from": "user", "value": prompt},
        {"from": "assistant", "value": answer},
    ]


QFORMER_MAX_IDS = 512  # the reference's clamp (models/InstructBlip/__init__.py:305-322)


class VLProcessor:
    def __init__(self, tokenizer, template: ChatTemplate, cfg: ProcessorConfig,
                 qformer_tokenizer=None):
        self.tokenizer = tokenizer
        self.template = template
        self.cfg = cfg
        self.qformer_tokenizer = qformer_tokenizer  # InstructBLIP's second tokenizer

    def qformer_ids(self, text: str, max_len: int = QFORMER_MAX_IDS) -> list[int]:
        """The Q-Former's instruction ids of a prompt: the text without its
        image placeholders, [CLS] ... [SEP], clamped to `max_len`."""
        clean = text.replace(self.template.image_placeholder, "").replace(
            self.cfg.image_token, "")
        return self.qformer_tokenizer.encode(clean, add_special_tokens=True)[:max_len]

    def format_multimodal_prompt(self, prompt: str, n_images: int = 1) -> str:
        ph = self.template.image_placeholder
        if n_images == 0:
            return prompt
        if self.cfg.image_start_id is not None:
            # wrapped mode (Qwen-VL): "Picture 1: <img>...</img>\n" for a bare
            # single-image prompt, "<img>...</img>\n" per "<image>" otherwise;
            # cfg.image_token is the tokenizer-special surface form
            if n_images == 1 and "<image>" not in prompt:
                return f"Picture 1: {self.cfg.image_token}\n{prompt}"
            if prompt.count("<image>") != n_images:
                raise ValueError(f"{n_images} images but prompt has "
                                 f"{prompt.count('<image>')} placeholders")
            return prompt.replace("<image>", f"{self.cfg.image_token}\n")
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
        of vlrlhf_tpu yields the same ids; serving needs no labels), or the
        ChatML build."""
        if self.template.style == "chatml":
            return self._process_conv_chatml(conv, False)
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

    def maybe_prefix_image_ids(self, input_ids: Sequence[int], n_images: int) -> list:
        """The prompt ids of a generation row (vlrlhf_tpu processor.py:90-95):
        a prefix-embedding model gets one placeholder per image in front;
        LLaVA's placeholder sits in the text already."""
        if self.cfg.prefix_image_tokens and n_images:
            return [self.cfg.image_token_id] * n_images + list(input_ids)
        return list(input_ids)

    def generation_row(self, question: str, img_path=None) -> dict:
        """A GenerationCollator row for `question`: the templated prompt
        with an empty assistant turn, image ids prefixed where the family
        wants them, and the Q-Former's instruction ids where it has one
        (vlrlhf_tpu builds this row in the server, eval and PPO paths)."""
        n_img = 0 if img_path is None else (len(img_path) if isinstance(img_path, list) else 1)
        prompt = self.format_multimodal_prompt(question, n_img)
        ids = self.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        row = {"input_ids": self.maybe_prefix_image_ids(ids, n_img), "img_path": img_path}
        if self.qformer_tokenizer is not None:
            row["qformer_input_ids"] = self.qformer_ids(question)
        return row

    def label_conv(self, conv: Sequence[dict], add_end_for_empty_value: bool = False) -> dict:
        """{input_ids, labels, raw_str}: vlrlhf_tpu's incremental labeling
        (`_process_conv_incremental`): the growing conversation is
        retokenized turn by turn, and an assistant turn's new tokens are
        labelled with the tail of its answer tokenized alone; or the ChatML
        build's labels."""
        if self.template.style == "chatml":
            return self._process_conv_chatml(conv, add_end_for_empty_value)
        t = self.template
        role_begin = {"user": t.user_begin, "assistant": t.assistant_begin}
        role_end = {"user": t.user_end, "assistant": t.assistant_end}
        raw = t.preamble
        labels: list[int] = []
        input_ids: list[int] = []
        prev_len = 0
        for idx, turn in enumerate(conv):
            value = turn["value"]
            raw += role_begin[turn["from"]] + value + (
                role_end[turn["from"]] if value != "" or add_end_for_empty_value else "")
            text_tokens = self.tokenizer.encode(value, add_special_tokens=(idx == 0))
            input_ids = self.tokenizer.encode(raw, add_special_tokens=True)
            extend_len = len(input_ids) - prev_len
            prev_len = len(input_ids)
            labels.extend([LABEL_PAD] * extend_len)
            if turn["from"] == "assistant" and text_tokens:
                target_len = min(extend_len, len(text_tokens), len(labels))
                if target_len > 0:
                    labels[-target_len:] = text_tokens[-target_len:]
        return {"input_ids": input_ids, "labels": labels, "raw_str": raw}

    def _process_conv_chatml(self, conv: Sequence[dict], add_end_for_empty_value: bool) -> dict:
        """Qwen's ChatML, token by token (vlrlhf_tpu `_process_conv_chatml`):
        <|im_start|>role\n ... <|im_end|>\n per turn after a system turn;
        labels pad everything between each im_start and im_end except an
        assistant turn's answer. Returns {input_ids, labels, raw_str,
        prompt_ids, answer_ids, answer_labels}."""
        tok = self.tokenizer
        im_start = tok.convert_token_to_id("<|im_start|>")
        im_end = tok.convert_token_to_id("<|im_end|>")
        nl = tok.encode("\n")
        system_msg = self.template.system_message
        system = [im_start] + tok.encode("system") + nl + tok.encode(system_msg) + [im_end] + nl
        input_ids = list(system)
        labels = [im_start] + [LABEL_PAD] * (len(system) - 2 - len(nl)) + [im_end] + nl
        raw = f"<|im_start|>system\n{system_msg}<|im_end|>\n"
        prompt_ids: list[int] = []
        answer_ids: list[int] = []
        answer_labels: list[int] = []
        for turn in conv:
            role = "user" if turn["from"] == "user" else "assistant"
            role_ids = tok.encode(f"<|im_start|>{role}")
            value = turn["value"]
            closed = value != "" or add_end_for_empty_value
            turn_ids = role_ids + nl
            raw += f"<|im_start|>{role}\n"
            if closed:
                turn_ids = turn_ids + tok.encode(value) + [im_end] + nl
                raw += f"{value}<|im_end|>\n"
            input_ids += turn_ids
            if not closed:
                turn_labels = [im_start] + [LABEL_PAD] * (len(turn_ids) - 1)
            elif role == "user":
                turn_labels = ([im_start] + [LABEL_PAD] * (len(turn_ids) - 2 - len(nl))
                               + [im_end] + nl)
            else:
                value_ids = turn_ids[len(role_ids) + len(nl): -(1 + len(nl))]
                turn_labels = ([im_start] + [LABEL_PAD] * (len(role_ids) - 1 + len(nl))
                               + value_ids + [im_end] + nl)
            if role == "user":
                prompt_ids = list(input_ids)
            else:
                answer_ids += turn_ids
                answer_labels += turn_labels
            labels += turn_labels
        return {"input_ids": input_ids, "labels": labels, "raw_str": raw,
                "prompt_ids": prompt_ids, "answer_ids": answer_ids,
                "answer_labels": answer_labels}

    def tokenize_row_sft(self, feature: dict) -> dict:
        """feature: {prompt, answer | conversations, img_path?} -> {input_ids,
        labels, img_path} (vlrlhf_tpu `tokenize_row_sft`, processor.py:384;
        the reference's VLSFTTrainer.tokenize_row). The assistant turn's
        new tokens carry labels (`label_conv`), everything else LABEL_PAD."""
        n_images = 1 if feature.get("img_path") else 0
        if "conversations" in feature:
            conv = list(feature["conversations"])
            conv[0] = dict(conv[0], value=self.format_multimodal_prompt(conv[0]["value"],
                                                                        n_images))
        else:
            conv = make_single_turn_conv(
                self.format_multimodal_prompt(feature["prompt"], n_images), feature["answer"])
        out = self.label_conv(conv, add_end_for_empty_value=True)
        ids, labels = out["input_ids"], out["labels"]
        if self.template.assistant_end == "" and self.tokenizer.eos_token_id is not None:
            ids = ids + [self.tokenizer.eos_token_id]
            labels = labels + [self.tokenizer.eos_token_id]
        if self.cfg.prefix_image_tokens and n_images:
            ids = [self.cfg.image_token_id] * n_images + ids
            labels = [LABEL_PAD] * n_images + labels
        out = {"input_ids": ids[: self.cfg.max_length], "labels": labels[: self.cfg.max_length],
               "img_path": feature.get("img_path")}
        if self.qformer_tokenizer is not None:
            src = feature.get("prompt") or feature["conversations"][0]["value"]
            out["qformer_input_ids"] = self.qformer_ids(src)
        return out

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
        if self.template.style == "chatml":
            return self._tokenize_row_dpo_chatml(feature, n_images)
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
            if cfg.add_bos and tok.bos_token_id is not None:
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

        chosen_ids = chosen_prompt + chosen_ans
        rejected_ids = rejected_prompt + rejected_ans
        chosen_labels = [LABEL_PAD] * len(chosen_prompt) + chosen_ans
        rejected_labels = [LABEL_PAD] * len(rejected_prompt) + rejected_ans
        if cfg.prefix_image_tokens and n_images:
            pre = [cfg.image_token_id] * n_images
            chosen_ids, rejected_ids = pre + chosen_ids, pre + rejected_ids
            chosen_labels = [LABEL_PAD] * n_images + chosen_labels
            rejected_labels = [LABEL_PAD] * n_images + rejected_labels
        out = {
            "chosen_input_ids": chosen_ids,
            "chosen_labels": chosen_labels,
            "rejected_input_ids": rejected_ids,
            "rejected_labels": rejected_labels,
            "prompt_input_ids": rows["prompt"],
            "img_path": feature.get("img_path"),
        }
        if self.qformer_tokenizer is not None:
            out["qformer_input_ids"] = self.qformer_ids(feature["prompt"])
        return out

    def _tokenize_row_dpo_chatml(self, feature: dict, n_images: int) -> dict:
        """Qwen's ChatML DPO row (vlrlhf_tpu `_tokenize_row_dpo_chatml`):
        the prompt and answer streams of the ChatML build, EOS after each
        answer, TRL-style truncation keeping the prompt's end."""
        cfg = self.cfg
        eos = self.tokenizer.eos_token_id
        prompt = self.format_multimodal_prompt(feature["prompt"], n_images)
        chosen_c = self._process_conv_chatml(make_single_turn_conv(prompt, feature["chosen"]),
                                             False)
        rejected_c = self._process_conv_chatml(
            make_single_turn_conv(prompt, feature["rejected"]), False)
        prompt_ids = list(chosen_c["prompt_ids"])
        chosen_ans = list(chosen_c["answer_ids"]) + [eos]
        chosen_lab = list(chosen_c["answer_labels"]) + [eos]
        rejected_ans = list(rejected_c["answer_ids"]) + [eos]
        rejected_lab = list(rejected_c["answer_labels"]) + [eos]
        longer = max(len(chosen_ans), len(rejected_ans))
        if len(prompt_ids) + longer > cfg.max_length:
            prompt_ids = prompt_ids[-cfg.max_prompt_length:]
        if len(prompt_ids) + longer > cfg.max_length:
            cut = cfg.max_length - cfg.max_prompt_length
            chosen_ans, chosen_lab = chosen_ans[:cut], chosen_lab[:cut]
            rejected_ans, rejected_lab = rejected_ans[:cut], rejected_lab[:cut]
        prompt_pad = [LABEL_PAD] * len(prompt_ids)
        return {
            "chosen_input_ids": prompt_ids + chosen_ans,
            "chosen_labels": prompt_pad + chosen_lab,
            "rejected_input_ids": prompt_ids + rejected_ans,
            "rejected_labels": prompt_pad + rejected_lab,
            "prompt_input_ids": prompt_ids,
            "img_path": feature.get("img_path"),
        }

    # ─────────── image token expansion ───────────

    def expand_image_tokens(
        self,
        input_ids: Sequence[int],
        labels: Optional[Sequence[int]] = None,
        counts: Optional[Sequence[int]] = None,  # anyres: per-image token counts
    ) -> tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Expand each image placeholder id into num_image_tokens copies, or
        `counts[i]` copies for anyres images (labels LABEL_PAD there); in
        wrapped mode into image_start_id, the copies as image_pad_id, and
        image_end_id. Returns (new_ids, new_labels or None,
        image_positions) with one position per expanded image token."""
        ids = np.asarray(input_ids)
        img_id = self.cfg.image_token_id
        occ = np.nonzero(ids == img_id)[0]
        if len(occ) == 0:
            return ids, (None if labels is None else np.asarray(labels)), np.zeros((0,), np.int32)
        pad_id = self.cfg.image_pad_id if self.cfg.image_pad_id is not None else img_id
        wrapped = self.cfg.image_start_id is not None
        out_ids, out_labels, positions = [], [], []
        prev = 0
        for j, o in enumerate(occ):
            n_tok = int(counts[j]) if counts is not None else self.cfg.num_image_tokens
            out_ids.extend(ids[prev:o].tolist())
            if labels is not None:
                out_labels.extend(list(labels[prev:o]))
            if wrapped:
                out_ids.append(self.cfg.image_start_id)
                if labels is not None:
                    out_labels.append(LABEL_PAD)
            start = len(out_ids)
            out_ids.extend([pad_id] * n_tok)
            if labels is not None:
                out_labels.extend([LABEL_PAD] * n_tok)
            positions.extend(range(start, start + n_tok))
            if wrapped:
                out_ids.append(self.cfg.image_end_id)
                if labels is not None:
                    out_labels.append(LABEL_PAD)
            prev = o + 1
        out_ids.extend(ids[prev:].tolist())
        if labels is not None:
            out_labels.extend(list(labels[prev:]))
        return (
            np.asarray(out_ids, np.int32),
            None if labels is None else np.asarray(out_labels, np.int64),
            np.asarray(positions, np.int32),
        )
