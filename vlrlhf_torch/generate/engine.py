"""Bucketed prefill + decode generation (counterpart of
vlrlhf_tpu/generate/engine.py: GenerateConfig, `_generate_impl`,
`_empty_pending`, `_decode_body`, and the host-loop `Generator`).

Right padding everywhere: KV slot == absolute position, so each row decodes
from its own prompt_len slot. The prefill (`prefill`) runs the full
multimodal forward into a fresh cache and samples the first token; each
decode step (`decode_step`) runs `LlamaDecoder.decode` with the deferred
cache write. PyTorch runs eagerly, so the decode loop is a Python loop that
updates the cache and the output buffer in place.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vlrlhf_torch.models.lm.llama import empty_pending
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.ops.sampling import sample_tokens


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    eos_token_ids: tuple[int, ...] = ()
    pad_token_id: int = 0


def _sample(gen_cfg: GenerateConfig, logits, generator):
    return sample_tokens(
        logits, generator, temperature=gen_cfg.temperature,
        top_k=gen_cfg.top_k, top_p=gen_cfg.top_p, do_sample=gen_cfg.do_sample,
    )


def eos_tensor(gen_cfg: GenerateConfig, device) -> torch.Tensor:
    return torch.tensor(gen_cfg.eos_token_ids or (-1,), dtype=torch.int32, device=device)


def prefill(
    model: VLM,
    gen_cfg: GenerateConfig,
    cache_len: int,
    input_ids: torch.Tensor,  # (B, L) right-padded prompts
    pad_mask: torch.Tensor,  # (B, L)
    prompt_lens: torch.Tensor,  # (B,)
    pixel_values: Optional[torch.Tensor],  # (B, n_img, H, W, 3)
    image_positions: Optional[torch.Tensor],
    generator: Optional[torch.Generator],
):
    """Prefill into a fresh (L, B, nkv, cache_len, hd) cache and sample the
    first token. Returns (cache, lengths, first_token, done0, out0,
    last_logits). Only the last prompt position goes through the LM head."""
    b = input_ids.shape[0]
    hidden, cache = model(
        input_ids, pixel_values, image_positions, pad_mask, cache_len=cache_len
    )
    rows = torch.arange(b, device=hidden.device)
    last_h = hidden[rows, prompt_lens.long() - 1][:, None]  # (B, 1, H)
    last_logits = model.head(last_h)[:, 0]
    first = _sample(gen_cfg, last_logits, generator)
    done0 = torch.isin(first, eos_tensor(gen_cfg, first.device))
    pad = gen_cfg.pad_token_id
    out0 = torch.full((b, gen_cfg.max_new_tokens), pad, dtype=torch.int32, device=first.device)
    out0[:, 0] = torch.where(done0, torch.full_like(first, pad), first)
    return cache, prompt_lens.to(torch.int32), first, done0, out0, last_logits


def decode_step(
    model: VLM,
    gen_cfg: GenerateConfig,
    eos: torch.Tensor,
    cache: dict,  # updated in place
    pending: dict,
    lengths: torch.Tensor,
    last_token: torch.Tensor,
    done: torch.Tensor,
    out: torch.Tensor,  # (B, N), column `step` written in place
    step: int,
    generator: Optional[torch.Generator],
):
    """One decode token for every row. Returns (pending, lengths,
    next_token, done)."""
    logits, pending = model.lm.decode(last_token, lengths, cache, pending)
    nxt = _sample(gen_cfg, logits, generator)
    nxt = torch.where(done, torch.full_like(nxt, gen_cfg.pad_token_id), nxt)
    out[:, step] = nxt
    new_done = done | torch.isin(nxt, eos)
    lengths = torch.where(done, lengths, lengths + 1)
    return pending, lengths, nxt, new_done


def batch_to_device(batch: dict, device) -> dict:
    """GenerationCollator numpy batch -> tensors on `device`."""
    out = {}
    for key in ("input_ids", "pad_mask", "prompt_lens", "pixel_values", "image_positions"):
        v = batch.get(key)
        out[key] = None if v is None else torch.as_tensor(np.asarray(v)).to(device)
    return out


class Generator:
    """Static-batch generation: one prefill, then a host loop of decode
    steps with an early-exit check every few steps."""

    EARLY_EXIT_EVERY = 8  # decode steps between host checks for all-done

    def __init__(self, model: VLM, gen_cfg: GenerateConfig):
        self.model = model
        self.gen_cfg = gen_cfg

    @torch.inference_mode()
    def __call__(
        self,
        batch: dict,  # from GenerationCollator (right-padded)
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """Returns (B, max_new_tokens) int32 token ids."""
        gen_cfg = self.gen_cfg
        device = self.model.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        t = batch_to_device(batch, device)
        l = t["input_ids"].shape[1]
        cache_len = -(-(l + gen_cfg.max_new_tokens) // 128) * 128
        cache, lengths, last, done, out, _ = prefill(
            self.model, gen_cfg, cache_len, t["input_ids"], t["pad_mask"],
            t["prompt_lens"], t["pixel_values"], t["image_positions"], generator,
        )
        if gen_cfg.max_new_tokens <= 1:
            return out
        lm = self.model.cfg.lm
        pending = empty_pending(lm, lengths.shape[0], cache_len, device)
        eos = eos_tensor(gen_cfg, device)
        # slot `prompt_lens` holds the first generated token; loop writes 1..
        for step in range(1, gen_cfg.max_new_tokens):
            pending, lengths, last, done = decode_step(
                self.model, gen_cfg, eos, cache, pending, lengths, last, done,
                out, step, generator,
            )
            if step % self.EARLY_EXIT_EVERY == 0 and bool(done.all()):
                break
        return out
