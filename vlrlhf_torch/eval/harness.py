"""Eval harness core (counterpart of vlrlhf_tpu/eval/harness.py): batched
generation and per-choice CE ranking over a port model.

`EvalRunner.run_vqa` answers each row's question with one of three
engines:
  - static batches through `Generator` (the default);
  - slot-refill continuous batching through `ContinuousEngine` when
    `continuous_batching` is set (batch_size is then the slot count), one
    engine per (slots, cache length), kept for later calls;
  - static batches through `SpeculativeGenerator` when `speculative_k` > 0
    without continuous batching (with it, the continuous engine's
    speculative bursts).
Only new tokens are decoded, so no echo stripping is needed.
`run_vqa_ppl` gives each row the mean cross-entropy of its answer tokens
from one training-mode VLM forward per batch (the flash forward on the
card over right-padded rows) and the LM head's product against the
vocabulary; the lowest wins in CE-ranked benchmarks.

The runner holds the model itself, not a params tree: `adapters` switches
the model's LoRA adapters on at `lora_scale` (they live on its Linears).
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator, SFTCollator
from vlrlhf_torch.data.processor import LABEL_PAD, VLProcessor
from vlrlhf_torch.generate.engine import GenerateConfig, Generator
from vlrlhf_torch.generate.speculative import SpeculativeGenerator
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.vlm import IMAGE_INPUT_KEYS, VLM, image_inputs


def _progress(done: int, total: int, on: bool) -> None:
    if on:
        print(f"\r{done}/{total}", end="\n" if done >= total else "", file=sys.stderr,
              flush=True)


@dataclasses.dataclass
class EvalRunner:
    model: VLM
    processor: VLProcessor
    gen_cfg: GenerateConfig
    collator_cfg: CollatorConfig
    image_loader: Optional[Callable] = None  # (path, size, mode) -> uint8 (size, size, 3)
    adapters: bool = False
    lora_scale: float = 1.0
    continuous_batching: bool = False  # batch_size then sets the slot count
    speculative_k: int = 0  # >0: speculative decoding with this draft length
    seed: int = 0  # the sampling generator's seed, per batch or engine run

    def __post_init__(self):
        if self.speculative_k > 0 and not self.continuous_batching:
            self._gen = SpeculativeGenerator(self.model, self.gen_cfg, self.lora_scale,
                                             k_draft=self.speculative_k)
        else:
            self._gen = Generator(self.model, self.gen_cfg, self.lora_scale)
        self._gen.adapters = self.adapters
        self._cb_engines: dict = {}

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.model.device).manual_seed(self.seed)

    # ───────────── generation mode ─────────────

    def _decode(self, toks) -> str:
        return self.processor.tokenizer.decode(list(toks), skip_special_tokens=True).strip()

    def _run_vqa_continuous(self, rows, prompt_key, image_key, n_slots, progress) -> list[dict]:
        """Slot-refill serving of the rows: a finished row's slot takes the
        next prompt while the others decode (generate/continuous.py)."""
        from vlrlhf_torch.generate.continuous import ContinuousEngine
        from vlrlhf_torch.generate.server import RequestBuilder

        # one Request-building path for the harness and the HTTP server
        builder = RequestBuilder(self.processor, self.collator_cfg, self.image_loader)
        reqs = [builder.build(r[prompt_key], r.get(image_key)) for r in rows]
        cache_len = -(-(max(len(q.input_ids) for q in reqs)
                        + self.gen_cfg.max_new_tokens) // 128) * 128
        key = (n_slots, cache_len)
        if key not in self._cb_engines:
            self._cb_engines[key] = ContinuousEngine(
                self.model, self.gen_cfg, n_slots=n_slots, cache_len=cache_len,
                speculative_k=self.speculative_k, adapters=self.adapters,
                lora_scale=self.lora_scale,
            )
        outs = self._cb_engines[key].run(reqs, self._generator())
        _progress(len(rows), len(rows), progress)
        return [dict(r, response=self._decode(toks)) for r, toks in zip(rows, outs)]

    def run_vqa(
        self,
        rows: Sequence[dict],
        batch_size: int = 16,
        prompt_key: str = "question",
        image_key: str = "img",
        progress: bool = False,
    ) -> list[dict]:
        """Each row gains a 'response' string; returns rows in order."""
        if self.continuous_batching:
            return self._run_vqa_continuous(rows, prompt_key, image_key, batch_size, progress)
        collator = GenerationCollator(self.processor, self.collator_cfg, self.image_loader)
        pad = self.gen_cfg.pad_token_id
        results = []
        for start in range(0, len(rows), batch_size):
            chunk = list(rows[start: start + batch_size])
            batch = collator([self.processor.generation_row(r[prompt_key], r.get(image_key))
                              for r in chunk])
            tokens = self._gen(batch, self._generator()).cpu().numpy()
            for r, toks in zip(chunk, tokens):
                results.append(dict(r, response=self._decode(toks[toks != pad])))
            _progress(len(results), len(rows), progress)
        return results

    # ───────────── log-likelihood mode ─────────────

    @torch.inference_mode()
    def ce(self, batch: dict) -> torch.Tensor:
        """(B,) mean CE of each row's labelled tokens (labels shifted by
        one against the logits), f32."""
        dev = self.model.device
        t = {k: torch.as_tensor(np.asarray(batch[k])).to(dev)
             for k in ("input_ids", "labels", "pad_mask", "pixel_values", "image_positions",
                       *IMAGE_INPUT_KEYS) if batch.get(k) is not None}
        ctx = Ctx(adapters=self.adapters, lora_scale=self.lora_scale)
        hidden, _ = self.model(t["input_ids"], t.get("pixel_values"), t.get("image_positions"),
                               t["pad_mask"], ctx=ctx, **image_inputs(t))
        logits = self.model.head(hidden[:, :-1], ctx).float()
        labels = t["labels"][:, 1:].long()
        nll = F.cross_entropy(logits.transpose(1, 2), labels, ignore_index=LABEL_PAD,
                              reduction="none")
        n = (labels != LABEL_PAD).sum(-1)
        return nll.sum(-1) / n.clamp(min=1)

    def run_vqa_ppl(
        self,
        rows: Sequence[dict],
        batch_size: int = 16,
        prompt_key: str = "question",
        answer_key: str = "answer",
        image_key: str = "img",
        progress: bool = False,
    ) -> list[dict]:
        """Each row gains 'ppl' = the mean CE of its answer tokens (the
        reference's per-choice ranking metric)."""
        collator = SFTCollator(self.processor, self.collator_cfg, self.image_loader)
        results = []
        for start in range(0, len(rows), batch_size):
            chunk = list(rows[start: start + batch_size])
            batch = collator([self.processor.tokenize_row_sft(
                {"prompt": r[prompt_key], "answer": r[answer_key], "img_path": r.get(image_key)})
                for r in chunk])
            for r, c in zip(chunk, self.ce(batch).cpu().tolist()):
                results.append(dict(r, ppl=float(c)))
            _progress(len(results), len(rows), progress)
        return results
