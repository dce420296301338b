"""Continuous-batching (slot-refill) serving engine (counterpart of
vlrlhf_tpu/generate/continuous.py, with its speculative burst and the
adaptive speculation gate).

A fixed B-slot KV cache (bf16 or int8); when a request finishes its slot is
refilled with the next queued prompt while the other slots keep decoding.
Two phases:

  - ADMIT (`_admit_group`): one batched multimodal prefill of the prompts
    admitted this round that share a prompt bucket (exact group size, no
    padding rows), written into the freed slots of the big cache in place,
    their stale deferred writes parked, their scheduler-state rows set.
  - DECODE BURST: with queued work the burst exits once EXIT_FREE slots
    have retired, so refills wait about one step; with an empty queue it
    runs long. Each step checks the exit condition on the host (one small
    sync per step). Two kinds share one contract:
      `_burst`       one decode token per active slot per step;
      `_spec_burst`  (speculative_k = K > 0) per step, each active slot
                     verifies a K-token prompt-lookup draft (`device_draft`,
                     from its token history `hist`) in ONE chunk forward
                     (`prefill_chunk`, return_all_logits) and emits the
                     accepted prefix plus the model's own next token: up to
                     K+1 tokens for one pass over the weights. Greedy
                     acceptance compares with the argmax; sampled acceptance
                     is lossless point-mass rejection sampling.
    With speculation on, `speculative_adaptive` picks the kind per burst
    from an EMA of wall seconds per emitted token of each kind.

Scheduler state (lengths / last token / active / remaining budget) lives on
the device as a (4, B) int32 tensor; the host keeps a mirror updated from
one packed download per burst: [first-token echo | tokens | final length].

Adapters (vlrlhf_tpu continuous.py:425-534): `adapters=True` runs the
model's own LoRA adapters at `lora_scale`; `adapter_sets` (N trees keyed
by JAX-layout paths, the `dpo` adapters file) serves N sets at once. They
are stacked once (lora.stack_adapter_sets), in the fused wqkv / gateup
layout when the model is fused (lora.fuse_adapter_sets), at assignment:
reassigning `adapter_sets` replaces the served tree, so no cache can serve
a stale fused tree (vlrlhf_tpu keys that cache by id(), which a new tree
at a freed tree's address can match). `serve` lends the tree to the
model's Linears for its run and gives back what they held before
(lora.lend_adapters; a model already lent to another engine raises); each
request's `adapter_idx` picks its set (None: the base model) through a
per-slot one-hot `Ctx.adapter_mix` row, in admit groups and in plain and
speculative bursts alike.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import numpy as np
import torch

from vlrlhf_torch.generate.engine import (
    GenerateConfig, adapter_mix_rows, decode_step, eos_tensor, prefill,
)
from vlrlhf_torch.lora.lora import fuse_adapter_sets, lend_adapters, stack_adapter_sets
from vlrlhf_torch.models.anyres import PAD_IDX
from vlrlhf_torch.models.common import Ctx
from vlrlhf_torch.models.lm.llama import empty_cache, empty_pending, flush_pending
from vlrlhf_torch.models.vlm import VLM
from vlrlhf_torch.ops.sampling import warp_logits

FREE, DECODE = 0, 2

# Scheduler state rows (device-resident (4, B) int32).
_LEN, _TOK, _ACT, _REM = 0, 1, 2, 3


@dataclasses.dataclass
class Request:
    """One serving request (prompt ids already image-expanded, as emitted by
    VLProcessor.expand_image_tokens / GenerationCollator rows)."""

    input_ids: np.ndarray  # (L,)
    # (H, W, 3), one image; with anyres_gather (n_tiles, H, W, 3), its tiles
    pixel_values: Optional[np.ndarray] = None
    image_positions: Optional[np.ndarray] = None  # (N_img_tok,)
    max_new_tokens: Optional[int] = None  # per-request cap (else gen_cfg's)
    adapter_idx: Optional[int] = None  # which of the engine's adapter_sets; None = base
    qformer_input_ids: Optional[np.ndarray] = None  # (T,) InstructBLIP instruction
    anyres_gather: Optional[np.ndarray] = None  # (N_img_tok,) LLaVA-Next gather map


def request_from_batch(batch: dict, i: int, has_image: bool, **kw) -> Request:
    """Row i of a GenerationCollator batch as a Request: its prompt, and
    with an image its pixels (one image, or anyres tiles with the gather
    map), positions and Q-Former ids. `kw` sets max_new_tokens /
    adapter_idx."""
    plen = int(batch["prompt_lens"][i])
    pv = gather = qids = None
    if has_image:
        if batch.get("anyres_gather") is not None:
            pv, gather = np.asarray(batch["pixel_values"][i]), np.asarray(batch["anyres_gather"][i])
        else:
            pv = np.asarray(batch["pixel_values"][i, 0])
    if batch.get("qformer_input_ids") is not None:
        qids = np.asarray(batch["qformer_input_ids"][i])[np.asarray(batch["qformer_mask"][i])]
    return Request(
        input_ids=np.asarray(batch["input_ids"][i, :plen]),
        pixel_values=pv,
        image_positions=np.asarray(batch["image_positions"][i]) if has_image else None,
        qformer_input_ids=qids,
        anyres_gather=gather,
        **kw,
    )


def device_draft(hist: torch.Tensor, hlen: torch.Tensor, k: int, pad_id: int) -> torch.Tensor:
    """Prompt-lookup drafts for every row at once (vlrlhf_tpu
    `_device_draft`): the tokens that followed the latest earlier
    occurrence of the row's trailing bigram in hist[:, :hlen], pad-filled
    past the history; rows without one repeat their last token.
    hist (B, S) int32, hlen (B,) -> (B, k) int32."""
    b, s = hist.shape
    dev = hist.device
    hlen = hlen.long()
    idx = torch.arange(s - 1, device=dev)
    t1 = hist.gather(1, (hlen - 2).clamp(min=0)[:, None])
    t2 = hist.gather(1, (hlen - 1).clamp(min=0)[:, None])
    m = (hist[:, :-1] == t1) & (hist[:, 1:] == t2)
    # exclude the query bigram itself and anything beyond the history
    m &= idx[None, :] <= (hlen - 3)[:, None]
    best = torch.where(m, idx[None, :], torch.full_like(idx[None, :], -1)).amax(dim=1)
    gidx = best[:, None] + 2 + torch.arange(k, device=dev)[None, :]
    cont = hist.gather(1, gidx.clamp(0, s - 1))
    cont = torch.where(gidx < hlen[:, None], cont, torch.full_like(cont, pad_id))
    return torch.where((best >= 0)[:, None], cont, t2.expand(b, k))


def _categorical(logits: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
    """One draw per row of the last axis by the Gumbel-max trick (as
    jax.random.categorical); a row of all -inf gives index 0 instead of
    failing as torch.multinomial would."""
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20, max=1.0 - 1e-7)))
    return torch.argmax(logits + gumbel, dim=-1)


class ContinuousEngine:
    """Slot-refill serving over a fixed B-slot cache."""

    MAX_PREFILL_GROUP = 2  # prompts per batched admission prefill
    EXIT_FREE = 2  # with queued work, a burst exits once this many slots retire

    def __init__(
        self,
        model: VLM,
        gen_cfg: GenerateConfig,
        n_slots: int = 8,
        cache_len: int = 1024,
        prefill_chunk: int = 128,  # prompt-length bucket multiple
        speculative_k: int = 0,  # >0: bursts verify K-token drafts per slot
        speculative_adaptive: bool = True,  # with speculation: the gate
        adapters: bool = False,  # the model's own adapters on (single set)
        adapter_sets: Optional[Sequence[dict]] = None,  # N sets, per-request choice
        lora_scale: float = 1.0,
        # the stop token joins its response (PPO rollouts: the reward lands
        # on it, as in the static engine's output); a first-token stop still
        # gives an empty response, as the static engine masks it
        emit_stop_token: bool = False,
    ):
        if adapters and adapter_sets:
            raise ValueError("pass either adapters (the model's own) or adapter_sets")
        self.model = model
        self.gen_cfg = gen_cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.prefill_chunk = max(prefill_chunk, 1)
        # a burst can run a whole response when the queue is empty
        self.decode_burst = max(gen_cfg.max_new_tokens, 1)
        self.speculative_k = max(0, speculative_k)
        if self.speculative_k:
            # a spec burst emits whole K+1 chunks only: a burst shorter than
            # one chunk could never advance any slot (the host would spin)
            self.decode_burst = max(self.decode_burst, self.speculative_k + 1)
        self.speculative_adaptive = bool(speculative_adaptive) and self.speculative_k > 0
        self._probe_every = 16  # the gate re-probes the idle mode this often (tests shrink it)
        # dispatch counters of the last serve() call
        self.last_bursts = 0
        self.last_spec_bursts = 0
        self.last_admits = 0
        self.last_decode_steps = 0  # one-token steps (plain bursts)
        self.last_verify_steps = 0  # chunk forwards (speculative bursts)
        self.adapters = adapters
        self.lora_scale = lora_scale
        self.adapter_sets = adapter_sets
        self.emit_stop_token = emit_stop_token

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def adapter_sets(self) -> Optional[dict]:
        """The served sets, stacked (lora.stack_adapter_sets) on the device
        in the model's layout (fused or not); assign a list of sets (or
        None) to replace them."""
        return self._held

    @adapter_sets.setter
    def adapter_sets(self, sets: Optional[Sequence[dict]]) -> None:
        self.n_adapter_sets = len(sets) if sets else 0
        self._held = None
        if sets:
            # held in the model's dtype: the delta casts to the activations' anyway
            dt = self.model.cfg.lm.dtype
            self._held = {k: v.to(self.device, dt)
                          for k, v in stack_adapter_sets(list(sets)).items()}
            if self.model.lm.layers[0].wqkv is not None:
                self._held = fuse_adapter_sets(self._held, self.model.cfg.lm)

    def _ctx(self, adapter_mix: Optional[torch.Tensor]) -> Optional[Ctx]:
        """The VLM-level context of a dispatch: None without adapters."""
        if self._held is not None:
            return Ctx(adapters=True, lora_scale=self.lora_scale, adapter_mix=adapter_mix)
        return Ctx(adapters=True, lora_scale=self.lora_scale) if self.adapters else None

    def _fresh_buffers(self):
        """(cache, pending, state, hist): hist (B, Sc) int32 is the token
        history of each slot, kept only when speculating (else None)."""
        lm = self.model.lm.cache_cfg
        b, sc = self.n_slots, self.cache_len
        cache = empty_cache(lm, b, sc, self.gen_cfg.kv_cache_dtype, self.device)
        pending = empty_pending(lm, b, sc, self.device)
        state = torch.zeros((4, b), dtype=torch.int32, device=self.device)
        hist = (torch.zeros((b, sc), dtype=torch.int32, device=self.device)
                if self.speculative_k else None)
        # each slot's one-hot adapter row (zeros: the base model)
        self._slot_mix = torch.zeros((b, max(self.n_adapter_sets, 1)), dtype=torch.float32,
                                     device=self.device)
        return cache, pending, state, hist

    # ---------------- admission ----------------

    def _admit_group(self, cache, pending, state, hist, group, requests, generator):
        """One batched prefill for the (slot, request index) pairs of
        `group`, which share a prompt bucket and modality. Writes the big
        cache, `pending`, `state` and `hist` in place."""
        dev = self.device
        slots = [s for s, _ in group]
        reqs = [requests[ridx] for _, ridx in group]
        lb = max(-(-len(r.input_ids) // self.prefill_chunk) * self.prefill_chunk for r in reqs)
        bp = len(group)
        rows = np.zeros((bp, lb), np.int32)
        pad = np.zeros((bp, lb), bool)
        plens = np.zeros((bp,), np.int32)
        budgets = np.zeros((bp,), np.int32)
        for i, r in enumerate(reqs):
            ids = np.asarray(r.input_ids, np.int32)
            rows[i, : len(ids)] = ids
            pad[i, : len(ids)] = True
            plens[i] = len(ids)
            budgets[i] = r.max_new_tokens or self.gen_cfg.max_new_tokens
        pv = ipos = None
        image_kw = {}
        if reqs[0].pixel_values is not None:
            pv, ipos, image_kw = self._group_images(reqs)
        rows_t, plens_t = torch.as_tensor(rows).to(dev), torch.as_tensor(plens).to(dev)
        slot_t = torch.as_tensor(np.asarray(slots, np.int64)).to(dev)
        if self._held is not None:
            self._slot_mix[slot_t] = adapter_mix_rows([r.adapter_idx for r in reqs],
                                                      self.n_adapter_sets, dev)
        small, _, first, done0, _, _ = prefill(
            self.model, self.gen_cfg, lb, rows_t, torch.as_tensor(pad).to(dev),
            plens_t, pv, ipos, generator, self._ctx(self._slot_mix[slot_t]), **image_kw,
        )
        for key in small:
            if key == "ntk_alpha":  # per row, QWen's dynamic NTK
                cache[key][slot_t] = small[key]
                continue
            # in place into the big cache (and scales): stale kv beyond lb is
            # never attended (slot masking) and is overwritten by decode
            cache[key][:, slot_t, :, :lb] = small[key]
        del small
        pending["pos"][slot_t] = self.cache_len  # park stale deferred writes
        rem = torch.as_tensor(budgets).to(dev) - 1  # prefill emitted token 1
        active = (~done0) & (rem > 0)
        state[_LEN, slot_t] = plens_t
        state[_TOK, slot_t] = first
        state[_ACT, slot_t] = active.to(torch.int32)
        state[_REM, slot_t] = rem.to(torch.int32)
        if hist is not None:
            # the prompt and the first token seed the prompt lookup; pad
            # columns past prompt_len are masked by the history length
            hist[slot_t, :lb] = rows_t
            hist[slot_t, plens_t.long()] = first

    def _group_images(self, reqs: list):
        """A group's pixel_values, image_positions and model keywords on the
        device. The layout follows the first request; anyres tiles, gather
        maps and positions, and Q-Former ids pad to the group's longest
        (PAD_IDX / -1 / mask False scatter nowhere)."""
        dev = self.device
        bp = len(reqs)
        kw = {}
        if reqs[0].anyres_gather is not None:
            n_tiles = max(np.asarray(r.pixel_values).shape[0] for r in reqs)
            n_tok = max(len(r.anyres_gather) for r in reqs)
            first = np.asarray(reqs[0].pixel_values)
            pv = np.zeros((bp, n_tiles) + first.shape[1:], first.dtype)
            gather = np.full((bp, n_tok), PAD_IDX, np.int32)
            ipos = np.full((bp, n_tok), -1, np.int32)
            for i, r in enumerate(reqs):
                t = np.asarray(r.pixel_values)
                pv[i, : t.shape[0]] = t
                gather[i, : len(r.anyres_gather)] = r.anyres_gather
                ipos[i, : len(r.image_positions)] = r.image_positions
            kw["anyres_gather"] = torch.as_tensor(gather).to(dev)
        else:
            pv = np.stack([np.asarray(r.pixel_values)[None] for r in reqs])
            ipos = np.stack([np.asarray(r.image_positions, np.int32) for r in reqs])
        if reqs[0].qformer_input_ids is not None:
            ql = max(len(r.qformer_input_ids) for r in reqs)
            qi = np.zeros((bp, ql), np.int32)
            qm = np.zeros((bp, ql), bool)
            for i, r in enumerate(reqs):
                q = np.asarray(r.qformer_input_ids, np.int32)
                qi[i, : len(q)] = q
                qm[i, : len(q)] = True
            kw["qformer_input_ids"] = torch.as_tensor(qi).to(dev)
            kw["qformer_mask"] = torch.as_tensor(qm).to(dev)
        return torch.as_tensor(pv).to(dev), torch.as_tensor(ipos).to(dev), kw

    # ---------------- decode bursts ----------------

    def _burst(self, cache, pending, state, hist, exit_free: int, generator):
        """Up to `decode_burst` tokens for every active slot, one per step.
        Returns (pending, state, hist, packed (B, decode_burst+2) numpy)."""
        gen_cfg = self.gen_cfg
        b, sc = self.n_slots, self.cache_len
        eos = eos_tensor(gen_cfg, self.device)
        lengths0, last0 = state[_LEN].clone(), state[_TOK].clone()
        active0 = state[_ACT].bool()
        remaining = state[_REM]
        out = torch.full((b, self.decode_burst), gen_cfg.pad_token_id,
                         dtype=torch.int32, device=self.device)
        # park stale deferred writes of inactive slots (a freed row must not
        # leak a late kv write into a later prompt's range)
        pending = dict(pending, pos=torch.where(active0, pending["pos"],
                                                torch.full_like(pending["pos"], sc)))
        lengths, last, done = lengths0.clone(), last0.clone(), ~active0
        rows = torch.arange(b, device=self.device)
        ctx = self._ctx(self._slot_mix)
        for i in range(self.decode_burst):
            go = ~done.all()
            if exit_free:
                go &= (done & active0).sum() < exit_free
            if not bool(go):
                break
            lengths_in = lengths
            pending, lengths, last, done = decode_step(
                self.model, gen_cfg, eos, cache, pending, lengths, last, done,
                out, i, generator, ctx,
            )
            if hist is not None:
                # the history's valid length is lengths + 1: this step's
                # token lands at lengths_in + 1 on the rows that advanced
                hpos = (lengths_in.long() + 1).clamp(max=sc - 1)
                hist[rows, hpos] = torch.where(lengths > lengths_in, last, hist[rows, hpos])
            done = done | (active0 & ((lengths - lengths0) >= remaining))
            self.last_decode_steps += 1
        return pending, *self._finish_burst(lengths0, last0, active0, remaining,
                                            lengths, last, done, out), hist

    def _spec_burst(self, cache, pending, state, hist, exit_free: int, generator):
        """The speculative burst (vlrlhf_tpu `_cb_spec_burst_impl`): per step
        every active slot verifies [last token, K drafts] in one chunk
        forward and emits the accepted prefix plus one token of the model's
        own. Same contract as `_burst`; the pending write is flushed up
        front (chunk forwards write their own kv), so the returned pending
        is empty. History invariant: hist holds prompt + every emitted
        token, valid length == cache length + 1 (the newest token's kv is
        written by the next chunk, which starts with it)."""
        gen_cfg = self.gen_cfg
        dev = self.device
        k = self.speculative_k
        c = k + 1
        b, sc = self.n_slots, self.cache_len
        max_burst = self.decode_burst
        pad_id = gen_cfg.pad_token_id
        eos = eos_tensor(gen_cfg, dev)
        lengths0, last0 = state[_LEN].clone(), state[_TOK].clone()
        active0 = state[_ACT].bool()
        remaining = state[_REM]
        out = torch.full((b, max_burst), pad_id, dtype=torch.int32, device=dev)
        pending = dict(pending, pos=torch.where(active0, pending["pos"],
                                                torch.full_like(pending["pos"], sc)))
        flush_pending(cache, pending)
        pending_out = dict(pending, pos=torch.full_like(pending["pos"], sc))
        jj = torch.arange(c, device=dev)[None, :]
        rows = torch.arange(b, device=dev)
        ctx = self._ctx(self._slot_mix)
        lm_ctx = None if ctx is None else ctx.sub("lm")
        lengths, last, done = lengths0.clone(), last0.clone(), ~active0
        for _ in range(max_burst):
            delta = lengths - lengths0
            # rows with fewer than C columns left in `out` sit this burst out
            # (the next burst resumes them): a partial chunk would desync the
            # emitted count from the kv the chunk wrote
            can = (~done) & (delta + c <= max_burst)
            go = can.any()
            if exit_free:
                go &= (done & active0).sum() < exit_free
            if not bool(go):
                break
            hlen = lengths + 1  # the history includes the not-yet-written last token
            chunk = torch.cat([last[:, None], device_draft(hist, hlen, k, pad_id)], dim=1)
            clens = torch.where(can, c, 0).to(torch.int32)  # 0 writes no kv
            logits, _ = self.model.lm.prefill_chunk(chunk, clens, lengths, cache,
                                                    return_all_logits=True,
                                                    ctx=lm_ctx)  # (B, C, V)
            self.last_verify_steps += 1
            if not gen_cfg.do_sample:
                tok = torch.argmax(logits, dim=-1).to(torch.int32)  # (B, C)
                match = tok[:, :-1] == chunk[:, 1:]
            else:
                tok, match = self._spec_sample(logits, chunk, generator)
            allowed = torch.cat([torch.ones((b, 1), dtype=torch.bool, device=dev),
                                 torch.cumprod(match.int(), dim=1).bool()], dim=1)
            allowed &= jj < (remaining - delta)[:, None]
            allowed &= can[:, None]
            is_eos = torch.isin(tok, eos)
            eos_before = torch.cumsum(is_eos.int(), dim=1) - is_eos.int()
            emit = allowed & (eos_before == 0)
            n_emit = emit.sum(dim=1).to(torch.int32)  # == the kv advance
            for j in range(c):  # one column at a time: no two writes share a slot
                col = (delta.long() + j).clamp(max=max_burst - 1)
                out[rows, col] = torch.where(emit[:, j], tok[:, j], out[rows, col])
                hpos = (hlen.long() + j).clamp(max=sc - 1)
                hist[rows, hpos] = torch.where(emit[:, j], tok[:, j], hist[rows, hpos])
            new_last = tok.gather(1, (n_emit.long() - 1).clamp(min=0)[:, None])[:, 0]
            last = torch.where(n_emit > 0, new_last, last)
            lengths = lengths + n_emit
            done = done | (emit & is_eos).any(dim=1)
            done = done | ((lengths - lengths0) >= remaining)
        return pending_out, *self._finish_burst(lengths0, last0, active0, remaining,
                                                lengths, last, done, out), hist

    def _spec_sample(self, logits, chunk, generator):
        """Lossless point-mass rejection sampling over the chunk: draft j+1
        is accepted with probability p_j(draft); at the first rejection the
        residual (p_j with the draft removed, renormalized) is sampled, and
        when every draft survives the last position samples a bonus token.
        Returns (tokens (B, C), accepted (B, C-1)); top_k=1 reproduces
        greedy exactly."""
        gen_cfg = self.gen_cfg
        b, c, v = logits.shape
        warped = warp_logits(logits.float(), gen_cfg.temperature, gen_cfg.top_k, gen_cfg.top_p)
        p = torch.softmax(warped, dim=-1)
        d_next = chunk[:, 1:].long()  # the draft proposed for position j's output
        # a pad draft (pad_token_id may be negative) gathers as JAX's
        # take_along_axis does, index modulo v, and excludes no token
        p_draft = p[:, :-1].gather(2, d_next.remainder(v)[..., None])[..., 0]  # (B, C-1)
        u = torch.rand(p_draft.shape, generator=generator, device=logits.device)
        accept = u < p_draft
        vocab = torch.arange(v, device=logits.device)
        excl = warped[:, :-1].masked_fill(vocab == d_next[..., None], float("-inf"))
        res = _categorical(excl, generator)  # (B, C-1)
        full = _categorical(warped, generator)  # (B, C)
        n_acc = torch.cumprod(accept.int(), dim=1).sum(dim=1)  # (B,)
        jj = torch.arange(c, device=logits.device)[None, :]
        res_pad = torch.cat([res, res[:, -1:]], dim=1)
        d_pad = torch.cat([d_next, d_next[:, -1:]], dim=1)
        # position j emits the accepted draft (j < a), the residual draw at
        # the rejection point, or the bonus sample when all drafts survived
        tok = torch.where(jj < n_acc[:, None], d_pad,
                          torch.where(jj == c - 1, full, res_pad)).to(torch.int32)
        return tok, jj[:, : c - 1] < n_acc[:, None]

    @staticmethod
    def _finish_burst(lengths0, last0, active0, remaining, lengths, last, done, out):
        """(state, packed numpy) at the end of a burst of either kind."""
        state = torch.stack([
            lengths,
            last,
            (active0 & ~done).to(torch.int32),
            remaining - (lengths - lengths0),
        ])
        packed = torch.cat([last0[:, None], out, lengths[:, None]], dim=1)
        return state, packed.cpu().numpy()

    # ---------------- the scheduler ----------------

    def _check_fits(self, r: Request) -> None:
        need = len(r.input_ids) + (r.max_new_tokens or self.gen_cfg.max_new_tokens)
        if need > self.cache_len:
            raise ValueError(f"request needs {need} cache slots, engine has {self.cache_len}")
        if r.adapter_idx is not None and not 0 <= r.adapter_idx < self.n_adapter_sets:
            raise ValueError(f"adapter_idx {r.adapter_idx}: the engine serves "
                             f"{self.n_adapter_sets} adapter sets")

    def run(
        self,
        requests: Sequence[Request],
        generator: Optional[torch.Generator] = None,
    ) -> list[list[int]]:
        """Serve all requests; returns response token ids per request, in
        request order. Admission is FIFO into whichever slots free first."""
        for r in requests:
            self._check_fits(r)
        responses: list = [None] * len(requests)
        self.serve(
            _ListSource(requests),
            lambda ridx, toks: responses.__setitem__(ridx, toks),
            generator=generator,
        )
        return responses

    @torch.inference_mode()
    def serve(
        self,
        source,
        on_finish,
        generator: Optional[torch.Generator] = None,
        on_token=None,  # callable(ridx, tok) per streamed response token
    ) -> None:
        """Generic slot-refill scheduler loop, shared by batch mode
        (run/_ListSource) and the live server (generate/server.py
        QueueSource).

        source protocol:
          take()    -> (ridx, Request) | None   — next request, if any NOW
          pending() -> int                      — queued count
          done()    -> bool                     — no request will EVER arrive
          wait()    -> None                     — block briefly for work
        on_finish(ridx, tokens) fires as each request completes."""
        if self._held is None:
            return self._serve_loop(source, on_finish, generator, on_token)
        with lend_adapters(self.model, self._held):
            return self._serve_loop(source, on_finish, generator, on_token)

    def _serve_loop(self, source, on_finish, generator, on_token) -> None:
        gen_cfg = self.gen_cfg
        b = self.n_slots
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        cache, pending, state, hist = self._fresh_buffers()

        # host MIRROR of the device scheduler state, updated only from the
        # packed burst downloads
        phase = np.full((b,), FREE, np.int32)
        lengths = np.zeros((b,), np.int32)
        stop_at = np.zeros((b,), np.int32)
        req_idx = np.full((b,), -1, np.int32)
        inflight: dict = {}  # ridx -> Request (alive while slot occupied)
        resp: dict = {}  # ridx -> token list being accumulated
        eos = set(gen_cfg.eos_token_ids or ())
        live = 0
        it = 0
        self.last_bursts = 0
        self.last_spec_bursts = 0
        self.last_admits = 0
        self.last_decode_steps = 0
        self.last_verify_steps = 0
        newly: set[int] = set()
        # the adaptive speculation gate (vlrlhf_tpu continuous.py:789-817,
        # :975-1017): an EMA per mode of wall seconds per emitted token over
        # the whole interval between burst downloads (host gap + burst), so
        # the host's per-burst cost counts against the mode that pays it.
        # Asymmetric hysteresis: any plain advantage leaves spec; entering
        # spec needs a 10% advantage. The idle mode is probed on the second
        # burst, then with exponential backoff (x2 per confirming probe, at
        # most 8x _probe_every; a switch resets it).
        adaptive = self.speculative_adaptive
        use_spec = bool(self.speculative_k)
        ema: dict = {True: None, False: None}
        t_mark = None
        probe_gap = self._probe_every
        next_probe = 1

        def finish(slot: int):
            nonlocal live
            ridx = int(req_idx[slot])
            phase[slot] = FREE
            req_idx[slot] = -1
            live -= 1
            on_finish(ridx, resp.pop(ridx))
            inflight.pop(ridx)

        def record(slot: int, tok: int) -> bool:
            """Append one sampled token; False when the slot retired."""
            ridx = int(req_idx[slot])
            if tok in eos:
                # with emit_stop_token the stop token joins a non-empty
                # response (vlrlhf_tpu continuous.py:833-840)
                if self.emit_stop_token and resp[ridx]:
                    resp[ridx].append(tok)
                finish(slot)
                return False
            resp[ridx].append(tok)
            if on_token is not None:
                on_token(ridx, tok)
            if len(resp[ridx]) >= stop_at[slot]:
                finish(slot)
                return False
            return True

        def consume(packed: np.ndarray) -> None:
            echo, toks = packed[:, 0], packed[:, 1:-1]
            new_lengths = packed[:, -1]
            for i in range(b):
                if phase[i] != DECODE:
                    continue
                if i in newly:
                    # a newly admitted slot's first token arrives as the echo
                    newly.discard(i)
                    if not record(i, int(echo[i])):
                        continue
                # tokens sampled == device length advance (the final one is
                # eos when the device stopped early)
                n_adv = int(new_lengths[i]) - int(lengths[i])
                for t in toks[i, :n_adv]:
                    if not record(i, int(t)):
                        break
                if phase[i] == DECODE:
                    lengths[i] = int(new_lengths[i])

        while True:
            admits: list[tuple[int, int]] = []
            for slot in range(b):
                if phase[slot] != FREE:
                    continue
                item = source.take()
                if item is None:
                    break
                ridx, r = item
                self._check_fits(r)
                inflight[ridx] = r
                resp[ridx] = []
                admits.append((slot, ridx))
            if admits:
                by_bucket: dict[tuple, list] = {}
                for slot, ridx in admits:
                    r = inflight[ridx]
                    lb = -(-len(r.input_ids) // self.prefill_chunk) * self.prefill_chunk
                    # a text-only row never shares a prefill with an image
                    # row; the group's qformer / anyres layout follows its
                    # first request
                    key = (lb, r.pixel_values is not None, r.qformer_input_ids is not None,
                           r.anyres_gather is not None)
                    by_bucket.setdefault(key, []).append((slot, ridx))
                g = self.MAX_PREFILL_GROUP
                groups = [
                    glist[i : i + g]
                    for glist in by_bucket.values()
                    for i in range(0, len(glist), g)
                ]
                for group in groups:
                    self._admit_group(cache, pending, state, hist, group, inflight, generator)
                    self.last_admits += 1
                    for slot, ridx in group:
                        r = inflight[ridx]
                        req_idx[slot] = ridx
                        stop_at[slot] = r.max_new_tokens or gen_cfg.max_new_tokens
                        lengths[slot] = len(r.input_ids)
                        phase[slot] = DECODE
                        live += 1
                        newly.add(slot)
                if adaptive:
                    # finish the admissions and restart the interval clock:
                    # admission time must not count against the next burst
                    state.cpu()
                    t_mark = time.perf_counter()
            if live == 0:
                if source.done():
                    return
                source.wait()
                continue
            exit_free = min(self.EXIT_FREE, source.pending(), live)
            spec = use_spec
            if adaptive and it == next_probe:
                spec = not use_spec  # refresh the idle mode's estimate
            burst = self._spec_burst if spec else self._burst
            pending, state, packed, hist = burst(cache, pending, state, hist, exit_free,
                                                 generator)
            if adaptive:
                # snapshot before consume mutates phase / lengths
                dec = phase == DECODE
                emitted = int((packed[dec, -1] - lengths[dec]).sum())
            consume(packed)
            if adaptive:
                # the interval ends after consume: the host's drain cost
                # belongs to the burst whose tokens it drains
                now = time.perf_counter()
                if t_mark is not None and emitted > 0:
                    cost = (now - t_mark) / emitted
                    ema[spec] = cost if ema[spec] is None else 0.7 * ema[spec] + 0.3 * cost
                was = use_spec
                if ema[True] is not None and ema[False] is not None:
                    if use_spec and ema[False] < ema[True]:
                        use_spec = False
                    elif not use_spec and ema[True] < 0.9 * ema[False]:
                        use_spec = True
                if spec != was:  # this burst was a probe
                    probe_gap = (self._probe_every if use_spec != was
                                 else min(2 * probe_gap, 8 * self._probe_every))
                    next_probe = it + probe_gap
                t_mark = now
            self.last_spec_bursts += int(spec)
            it += 1
            self.last_bursts = it


class _ListSource:
    """Batch-mode request source: a fixed list, drained FIFO."""

    def __init__(self, requests: Sequence[Request]):
        self._q = list(enumerate(requests))
        self._i = 0

    def take(self):
        if self._i >= len(self._q):
            return None
        item = self._q[self._i]
        self._i += 1
        return item

    def pending(self) -> int:
        return len(self._q) - self._i

    def done(self) -> bool:
        return self._i >= len(self._q)

    def wait(self) -> None:  # batch mode never idles
        pass
