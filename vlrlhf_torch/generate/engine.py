"""Bucketed prefill + decode generation (counterpart of
vlrlhf_tpu/generate/engine.py: GenerateConfig, `_generate_impl`,
`_empty_pending`, `_decode_body`, the host-loop `Generator`, `_extend_impl`
and `ChatSession`).

Right padding everywhere: KV slot == absolute position, so each row decodes
from its own prompt_len slot. The prefill (`prefill`) runs the full
multimodal forward into a fresh bf16 or int8 cache and samples the first
token; each decode step (`decode_step`) runs `LlamaDecoder.decode` with the
deferred cache write. PyTorch runs eagerly, so the decode loop is a Python
loop that updates the cache and the output buffer in place. A ChatSession
keeps the cache of one conversation and chunk-prefills each next turn into
it (`extend`).

`Generator.adapters` switches the model's LoRA adapters on (at
`lora_scale`) or off for its runs, vlrlhf_tpu's single-adapter
`serving_ctx` (engine.py:72-76): the DPO eval samples decode the policy
with them on and the reference with them off. When the model holds
stacked adapter sets (lora.set_adapters_), a call's `adapter_mix` (B, N)
picks each row's set (`adapter_mix_rows`), as vlrlhf_tpu's Generator does
with a "__mix__" beside its stacked tree.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vlrlhf_torch.core.dist import model_group_tokens
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.lm.llama import empty_pending
from vlrlhf_torch.models.vlm import IMAGE_INPUT_KEYS, VLM, image_inputs
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
    # 'bf16' | 'int8': int8 halves the KV cache (capacity and decode bytes)
    # with per-vector scales folded into the decode and chunk kernels
    # (ops/quant.py quantize_kv); the current token's self term stays bf16
    kv_cache_dtype: str = "bf16"


def _sample(gen_cfg: GenerateConfig, logits, generator):
    """A step's tokens (B,) int32. Under a mesh with --mesh_model or
    --mesh_pipe > 1 the model x pipe ranks of a data-parallel coordinate
    take their first rank's (core/dist.py model_group_tokens), so they
    decode one sequence by construction."""
    return model_group_tokens(sample_tokens(
        logits, generator, temperature=gen_cfg.temperature,
        top_k=gen_cfg.top_k, top_p=gen_cfg.top_p, do_sample=gen_cfg.do_sample,
    ))


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
    ctx: Optional[Ctx] = None,  # VLM-level: adapters on or off
    **image_kw,  # anyres_gather / qformer_input_ids / qformer_mask (models/vlm.py)
):
    """Prefill into a fresh (L, B, nkv, cache_len, hd) cache and sample the
    first token. Returns (cache, lengths, first_token, done0, out0,
    last_logits). Only the last prompt position goes through the LM head."""
    b = input_ids.shape[0]
    hidden, cache = model(
        input_ids, pixel_values, image_positions, pad_mask, cache_len=cache_len,
        ctx=ctx, kv_cache_dtype=gen_cfg.kv_cache_dtype, **image_kw,
    )
    rows = torch.arange(b, device=hidden.device)
    last_h = hidden[rows, prompt_lens.long() - 1][:, None]  # (B, 1, H)
    last_logits = model.head(last_h, ctx)[:, 0]
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
    ctx: Optional[Ctx] = None,  # VLM-level: adapters on or off
):
    """One decode token for every row. Returns (pending, lengths,
    next_token, done)."""
    logits, pending = model.lm.decode(last_token, lengths, cache, pending,
                                      ctx.sub("lm") if ctx is not None else None)
    nxt = _sample(gen_cfg, logits, generator)
    nxt = torch.where(done, torch.full_like(nxt, gen_cfg.pad_token_id), nxt)
    out[:, step] = nxt
    new_done = done | torch.isin(nxt, eos)
    lengths = torch.where(done, lengths, lengths + 1)
    return pending, lengths, nxt, new_done


def adapter_mix_rows(idx, n_sets: int, device) -> torch.Tensor:
    """(B, n_sets) one-hot rows for per-row set indices; None or a negative
    index gives a zero row, the base model."""
    mix = torch.zeros((len(idx), n_sets), dtype=torch.float32)
    for row, i in enumerate(idx):
        if i is not None and i >= 0:
            if i >= n_sets:
                raise ValueError(f"adapter index {i} out of range for {n_sets} sets")
            mix[row, i] = 1.0
    return mix.to(device)


def batch_to_device(batch: dict, device) -> dict:
    """GenerationCollator numpy batch -> tensors on `device` (the anyres /
    Q-Former fields too, where the batch has them)."""
    out = {}
    for key in ("input_ids", "pad_mask", "prompt_lens", "pixel_values", "image_positions",
                *IMAGE_INPUT_KEYS):
        v = batch.get(key)
        out[key] = None if v is None else torch.as_tensor(np.asarray(v)).to(device)
    return out


def decode_loop(
    model: VLM,
    gen_cfg: GenerateConfig,
    cache: dict,  # updated in place
    lengths: torch.Tensor,
    last: torch.Tensor,
    done: torch.Tensor,
    out: torch.Tensor,  # (B, N), columns 1.. written in place
    generator: Optional[torch.Generator],
    early_exit_every: int = 8,
    ctx: Optional[Ctx] = None,
):
    """Decode columns 1..N-1 after a prefill that sampled column 0, with a
    host check for all-done every `early_exit_every` steps. Returns the
    live (pending, lengths)."""
    lm = model.lm.cache_cfg
    pending = empty_pending(lm, lengths.shape[0], cache["k"].shape[3], lengths.device)
    eos = eos_tensor(gen_cfg, lengths.device)
    for step in range(1, gen_cfg.max_new_tokens):
        pending, lengths, last, done = decode_step(
            model, gen_cfg, eos, cache, pending, lengths, last, done, out, step, generator, ctx,
        )
        if step % early_exit_every == 0 and bool(done.all()):
            break
    return pending, lengths


class Generator:
    """Static-batch generation: one prefill, then a host loop of decode
    steps with an early-exit check every few steps. Set `adapters` True
    and the model's LoRA adapters apply at `lora_scale`."""

    EARLY_EXIT_EVERY = 8  # decode steps between host checks for all-done

    def __init__(self, model: VLM, gen_cfg: GenerateConfig, lora_scale: float = 1.0):
        self.model = model
        self.gen_cfg = gen_cfg
        self.lora_scale = lora_scale
        self.adapters = False

    @torch.inference_mode()
    def __call__(
        self,
        batch: dict,  # from GenerationCollator (right-padded)
        generator: Optional[torch.Generator] = None,
        return_state: bool = False,
        cache_len: Optional[int] = None,
        adapter_mix: Optional[torch.Tensor] = None,  # (B, N) for stacked sets
    ):
        """Returns (B, max_new_tokens) int32 token ids, with return_state
        also the live session state {"cache", "pending", "lengths"} (see
        ChatSession). `cache_len` reserves extra slots (multi-turn
        sessions); by default the cache holds the bucket plus the new
        tokens, rounded up to 128."""
        gen_cfg = self.gen_cfg
        device = self.model.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        t = batch_to_device(batch, device)
        if cache_len is None:
            cache_len = -(-(t["input_ids"].shape[1] + gen_cfg.max_new_tokens) // 128) * 128
        ctx = self.ctx(adapter_mix)
        cache, lengths, last, done, out, _ = prefill(
            self.model, gen_cfg, cache_len, t["input_ids"], t["pad_mask"],
            t["prompt_lens"], t["pixel_values"], t["image_positions"], generator, ctx,
            **image_inputs(t),
        )
        pending, lengths = decode_loop(self.model, gen_cfg, cache, lengths, last, done, out,
                                       generator, self.EARLY_EXIT_EVERY, ctx)
        if return_state:
            return out, {"cache": cache, "pending": pending, "lengths": lengths, "ctx": ctx}
        return out

    def ctx(self, adapter_mix: Optional[torch.Tensor] = None) -> Ctx:
        """The VLM-level context of a run: adapters on or off, the mix."""
        mix = None if adapter_mix is None else adapter_mix.to(self.model.device)
        return Ctx(adapters=self.adapters, lora_scale=self.lora_scale, adapter_mix=mix)


class ChatSession:
    """Multi-turn serving over one cache (vlrlhf_tpu ChatSession,
    engine.py:425-479): start(batch) decodes turn 1; extend(new_ids,
    chunk_lens) chunk-prefills the next turn's tokens into the live cache
    and decodes. The previous response's last token leads the next chunk:
    its k/v were never computed. Rows are right-padded."""

    def __init__(self, generator: Generator, cache_len: Optional[int] = None):
        self.gen = generator
        self.cache_len = cache_len  # total session budget (prompt + all turns)
        self.state: Optional[dict] = None

    def start(self, batch: dict, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Turn 1; the session keeps its adapter context for the turns that
        follow."""
        out, self.state = self.gen(batch, generator, return_state=True,
                                   cache_len=self.cache_len)
        return out

    @torch.inference_mode()
    def extend(self, new_ids, chunk_lens, generator: Optional[torch.Generator] = None):
        """new_ids (B, C) right-padded, chunk_lens (B,); returns (B,
        max_new_tokens) token ids (vlrlhf_tpu `_extend_impl`)."""
        if self.state is None:
            raise RuntimeError("call start() first")
        gen_cfg = self.gen.gen_cfg
        model = self.gen.model
        device = model.device
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        s = self.state
        new_ids = torch.as_tensor(np.asarray(new_ids)).to(device)
        chunk_lens = torch.as_tensor(np.asarray(chunk_lens)).to(device)
        c = new_ids.shape[1]
        sc = s["cache"]["k"].shape[3]
        needed = int(s["lengths"].max()) + c + gen_cfg.max_new_tokens
        if needed > sc:
            raise ValueError(
                f"session cache full: need {needed} slots, have {sc} — start a new "
                "session with a larger cache or trim the conversation"
            )
        cache = s["cache"]
        ctx = s["ctx"]
        logits, lengths = model.lm.prefill_chunk(new_ids, chunk_lens, s["lengths"], cache,
                                                 pending=s["pending"], ctx=ctx.sub("lm"))
        first = _sample(gen_cfg, logits, generator)
        done = torch.isin(first, eos_tensor(gen_cfg, device))
        pad = gen_cfg.pad_token_id
        out = torch.full((first.shape[0], gen_cfg.max_new_tokens), pad, dtype=torch.int32,
                         device=device)
        out[:, 0] = torch.where(done, torch.full_like(first, pad), first)
        pending, lengths = decode_loop(model, gen_cfg, cache, lengths, first, done, out,
                                       generator, self.gen.EARLY_EXIT_EVERY, ctx)
        self.state = {"cache": cache, "pending": pending, "lengths": lengths, "ctx": ctx}
        return out
