"""Static-batch speculative decoding: prompt-lookup drafts + chunk verify
(counterpart of vlrlhf_tpu/generate/speculative.py: `prompt_lookup_draft`
and `SpeculativeGenerator`, the eval harness's static speculative path).

A host loop over the port's chunk prefill: after one prefill of the whole
batch, each step builds per row [last token, up to K drafts] from prompt
lookup (the tokens that followed the latest earlier occurrence of the
row's trailing bigram) and verifies them in ONE `LlamaDecoder.
prefill_chunk(..., return_all_logits=True)` over the live cache, on the
chunk-attention kernel on the card. Greedy accepts the longest draft
prefix equal to the model's argmax continuation plus the model's own next
token, so the tokens are the plain `Generator`'s; sampled accepts draft d
with probability p(d) under the warped distribution (ops/sampling.py
`warp_logits`) and, at the first rejection, samples p without d
renormalized (or, when every draft survives, a bonus token from p): each
emitted token is distributed as a plain sampled step's (point-mass
rejection sampling), from an explicit torch.Generator.

Rejected positions leave stale k/v in the cache; the next chunk starts at
the accepted length and rewrites them before any query attends them.
`verify_calls` counts the chunk forwards, `verify_rows` the rows they
verified and `verify_tokens` the tokens those rows emitted.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vlrlhf_torch.generate.continuous import _categorical
from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.ops.sampling import warp_logits


def prompt_lookup_draft(src: list[int], k: int, pad_token_id: int) -> list[int]:
    """k tokens: those that followed the latest earlier occurrence of src's
    trailing bigram, pad-filled past the history; without one, the last
    token repeated; without any history, pads."""
    n = len(src)
    if n >= 2:
        t1, t2 = src[-2], src[-1]
        for i in range(n - 3, -1, -1):  # the trailing bigram itself excluded
            if src[i] == t1 and src[i + 1] == t2:
                cont = src[i + 2: i + 2 + k]
                if cont:
                    return cont + [pad_token_id] * (k - len(cont))
                break
    if n:
        return [src[-1]] * k
    return [pad_token_id] * k


class SpeculativeGenerator:
    """Drop-in for Generator's __call__: the same batch in, the same (B,
    max_new_tokens) int32 ids out (greedy: the same tokens). `adapters`
    and `lora_scale` switch the model's adapters as in Generator."""

    def __init__(self, model: VLM, gen_cfg: GenerateConfig, lora_scale: float = 1.0,
                 k_draft: int = 7):
        self.model = model
        self.gen_cfg = gen_cfg
        self.k = max(1, k_draft)
        self.lora_scale = lora_scale
        self.adapters = False
        self.verify_calls = 0  # chunk forwards, over every call
        self.verify_rows = 0  # rows verified, summed over the chunk forwards
        self.verify_tokens = 0  # tokens emitted by the verified rows

    def _verify(self, cache, chunk, clens, lengths, ctx, generator):
        """One chunk forward; greedy: the argmax at each position (B, C);
        sampled: (accept (B, C-1), residual draws (B, C-1), full draws (B, C))."""
        gcfg = self.gen_cfg
        logits, _ = self.model.lm.prefill_chunk(chunk, clens, lengths, cache,
                                                return_all_logits=True, ctx=ctx.sub("lm"))
        self.verify_calls += 1
        if not gcfg.do_sample:
            return torch.argmax(logits.float(), dim=-1).cpu().numpy()
        warped = warp_logits(logits.float(), gcfg.temperature, gcfg.top_k, gcfg.top_p)
        v = warped.shape[-1]
        d_next = chunk[:, 1:].long()  # position j is held against the draft at j + 1
        # a pad draft (pad_token_id may be negative) gathers modulo v, as
        # JAX's take_along_axis does
        p_draft = torch.softmax(warped[:, :-1], dim=-1).gather(
            2, d_next.remainder(v)[..., None])[..., 0]
        accept = torch.rand(p_draft.shape, generator=generator, device=p_draft.device) < p_draft
        excl = warped[:, :-1].masked_fill(
            torch.arange(v, device=warped.device) == d_next[..., None], float("-inf"))
        res = _categorical(excl, generator)
        full = _categorical(warped, generator)
        return accept.cpu().numpy(), res.cpu().numpy(), full.cpu().numpy()

    @torch.inference_mode()
    def __call__(
        self,
        batch: dict,
        generator: Optional[torch.Generator] = None,
        cache_len: Optional[int] = None,
    ) -> torch.Tensor:
        gcfg = self.gen_cfg
        n_new, k = gcfg.max_new_tokens, self.k
        device = self.model.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        t = batch_to_device(batch, device)
        ids = np.asarray(batch["input_ids"])
        b, l = ids.shape
        plens = np.asarray(batch["prompt_lens"])
        if cache_len is None:
            # verify chunks write up to k slots past the final token
            cache_len = -(-(l + n_new + k + 1) // 128) * 128
        ctx = Ctx(adapters=self.adapters, lora_scale=self.lora_scale)
        cache, _, first, done0, _, _ = prefill(
            self.model, dataclasses.replace(gcfg, max_new_tokens=1), cache_len, t["input_ids"],
            t["pad_mask"], t["prompt_lens"], t["pixel_values"], t["image_positions"],
            generator, ctx,
        )
        eos = {int(e) for e in (gcfg.eos_token_ids or ())}
        first = first.cpu().numpy()
        done = done0.cpu().numpy().copy()
        lengths = plens.astype(np.int32).copy()
        src = [list(map(int, ids[i, : plens[i]])) for i in range(b)]
        emitted: list[list[int]] = [[] for _ in range(b)]
        last = np.full((b,), gcfg.pad_token_id, np.int32)
        for i in range(b):
            if not done[i]:
                emitted[i].append(int(first[i]))
                src[i].append(int(first[i]))
                last[i] = first[i]
        done |= np.array([len(e) >= n_new for e in emitted])
        c = k + 1
        while not done.all():
            chunk = np.full((b, c), gcfg.pad_token_id, np.int32)
            clens = np.zeros((b,), np.int32)
            for i in range(b):
                if done[i]:
                    continue
                ci = 1 + min(k, n_new - len(emitted[i]) - 1)
                chunk[i, 0] = last[i]
                chunk[i, 1:ci] = prompt_lookup_draft(src[i], ci - 1, gcfg.pad_token_id)
                clens[i] = ci
            chunk_t = torch.as_tensor(chunk).to(device)
            self.verify_rows += int((clens > 0).sum())
            out = self._verify(cache, chunk_t, torch.as_tensor(clens).to(device),
                               torch.as_tensor(lengths).to(device), ctx, generator)
            for i in range(b):
                ci = int(clens[i])
                if ci == 0:
                    continue
                a = 0
                if gcfg.do_sample:
                    acc, res, full = out
                    while a < ci - 1 and acc[i, a]:
                        a += 1
                    toks = [int(chunk[i, j + 1]) for j in range(a)]
                    toks.append(int(full[i, a]) if a == ci - 1 else int(res[i, a]))
                else:
                    g = out
                    while a < ci - 1 and g[i, a] == chunk[i, a + 1]:
                        a += 1
                    toks = [int(g[i, j]) for j in range(a + 1)]
                for tok in toks:
                    self.verify_tokens += 1
                    lengths[i] += 1  # this chunk position's k/v is now valid
                    emitted[i].append(tok)
                    if tok in eos:
                        # written to the output, as the plain engine writes
                        # an eos after the first token
                        done[i] = True
                        break
                    src[i].append(tok)
                    last[i] = tok
                    if len(emitted[i]) >= n_new:
                        done[i] = True
                        break
        out = np.full((b, n_new), gcfg.pad_token_id, np.int32)
        for i in range(b):
            out[i, : len(emitted[i])] = emitted[i]
        return torch.as_tensor(out)
