"""Continuous-batching (slot-refill) serving engine (counterpart of the
non-speculative path of vlrlhf_tpu/generate/continuous.py).

A fixed B-slot KV cache; when a request finishes its slot is refilled with
the next queued prompt while the other slots keep decoding. Two phases:

  - ADMIT (`_admit_group`): one batched multimodal prefill of the prompts
    admitted this round that share a prompt bucket (exact group size, no
    padding rows), written into the freed slots of the big cache in place,
    their stale deferred writes parked, their scheduler-state rows set.
  - DECODE BURST (`_burst`): up to max_new_tokens decode steps for every
    active slot. With queued work the burst exits once EXIT_FREE slots
    have retired, so refills wait about one token; with an empty queue it
    runs long. Each step checks the exit condition on the host (one small
    sync per token).

Scheduler state (lengths / last token / active / remaining budget) lives on
the device as a (4, B) int32 tensor; the host keeps a mirror updated from
one packed download per burst: [first-token echo | tokens | final length].
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from vlrlhf_torch.generate.engine import GenerateConfig, decode_step, eos_tensor, prefill
from vlrlhf_torch.models.lm.llama import empty_pending
from vlrlhf_torch.models.vlm import VLM

FREE, DECODE = 0, 2

# Scheduler state rows (device-resident (4, B) int32).
_LEN, _TOK, _ACT, _REM = 0, 1, 2, 3


@dataclasses.dataclass
class Request:
    """One serving request (prompt ids already image-expanded, as emitted by
    VLProcessor.expand_image_tokens / GenerationCollator rows)."""

    input_ids: np.ndarray  # (L,)
    pixel_values: Optional[np.ndarray] = None  # (H, W, 3), one image
    image_positions: Optional[np.ndarray] = None  # (N_img_tok,)
    max_new_tokens: Optional[int] = None  # per-request cap (else gen_cfg's)


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
    ):
        self.model = model
        self.gen_cfg = gen_cfg
        self.n_slots = n_slots
        self.cache_len = cache_len
        self.prefill_chunk = max(prefill_chunk, 1)
        # a burst can run a whole response when the queue is empty
        self.decode_burst = max(gen_cfg.max_new_tokens, 1)
        # dispatch counters of the last serve() call
        self.last_bursts = 0
        self.last_admits = 0
        self.last_decode_steps = 0

    @property
    def device(self) -> torch.device:
        return self.model.device

    def _fresh_buffers(self):
        lm = self.model.cfg.lm
        b, sc = self.n_slots, self.cache_len
        shape = (lm.num_layers, b, lm.num_kv_heads, sc, lm.head_dim_)
        cache = {
            "k": torch.zeros(shape, dtype=lm.dtype, device=self.device),
            "v": torch.zeros(shape, dtype=lm.dtype, device=self.device),
        }
        pending = empty_pending(lm, b, sc, self.device)
        state = torch.zeros((4, b), dtype=torch.int32, device=self.device)
        return cache, pending, state

    # ---------------- admission ----------------

    def _admit_group(self, cache, pending, state, group, requests, generator):
        """One batched prefill for the (slot, request index) pairs of
        `group`, which share a prompt bucket and modality. Writes the big
        cache, `pending` and `state` in place."""
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
        if reqs[0].pixel_values is not None:
            pv = torch.as_tensor(np.stack([np.asarray(r.pixel_values)[None] for r in reqs])).to(dev)
            ipos = torch.as_tensor(
                np.stack([np.asarray(r.image_positions, np.int32) for r in reqs])
            ).to(dev)
        small, _, first, done0, _, _ = prefill(
            self.model, self.gen_cfg, lb,
            torch.as_tensor(rows).to(dev), torch.as_tensor(pad).to(dev),
            torch.as_tensor(plens).to(dev), pv, ipos, generator,
        )
        slot_t = torch.as_tensor(np.asarray(slots, np.int64)).to(dev)
        for key in ("k", "v"):
            # in place into the big cache: stale kv beyond lb is never
            # attended (slot < length masking) and is overwritten by decode
            cache[key][:, slot_t, :, :lb] = small[key]
        del small
        pending["pos"][slot_t] = self.cache_len  # park stale deferred writes
        rem = torch.as_tensor(budgets).to(dev) - 1  # prefill emitted token 1
        active = (~done0) & (rem > 0)
        state[_LEN, slot_t] = torch.as_tensor(plens).to(dev)
        state[_TOK, slot_t] = first
        state[_ACT, slot_t] = active.to(torch.int32)
        state[_REM, slot_t] = rem.to(torch.int32)

    # ---------------- decode burst ----------------

    def _burst(self, cache, pending, state, exit_free: int, generator):
        """Up to `decode_burst` tokens for every active slot. Returns
        (pending, state, packed (B, decode_burst+2) numpy)."""
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
        for i in range(self.decode_burst):
            go = ~done.all()
            if exit_free:
                go &= (done & active0).sum() < exit_free
            if not bool(go):
                break
            pending, lengths, last, done = decode_step(
                self.model, gen_cfg, eos, cache, pending, lengths, last, done,
                out, i, generator,
            )
            done = done | (active0 & ((lengths - lengths0) >= remaining))
            self.last_decode_steps += 1
        state = torch.stack([
            lengths,
            last,
            (active0 & ~done).to(torch.int32),
            remaining - (lengths - lengths0),
        ])
        packed = torch.cat([last0[:, None], out, lengths[:, None]], dim=1)
        return pending, state, packed.cpu().numpy()

    # ---------------- the scheduler ----------------

    def _check_fits(self, r: Request) -> None:
        need = len(r.input_ids) + (r.max_new_tokens or self.gen_cfg.max_new_tokens)
        if need > self.cache_len:
            raise ValueError(f"request needs {need} cache slots, engine has {self.cache_len}")

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
        gen_cfg = self.gen_cfg
        b = self.n_slots
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        cache, pending, state = self._fresh_buffers()

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
        self.last_bursts = 0
        self.last_admits = 0
        self.last_decode_steps = 0
        newly: set[int] = set()

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
                # the stop token stays out of the response
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
                    # a text-only row never shares a prefill with an image row
                    key = (lb, r.pixel_values is not None)
                    by_bucket.setdefault(key, []).append((slot, ridx))
                g = self.MAX_PREFILL_GROUP
                groups = [
                    glist[i : i + g]
                    for glist in by_bucket.values()
                    for i in range(0, len(glist), g)
                ]
                for group in groups:
                    self._admit_group(cache, pending, state, group, inflight, generator)
                    self.last_admits += 1
                    for slot, ridx in group:
                        r = inflight[ridx]
                        req_idx[slot] = ridx
                        stop_at[slot] = r.max_new_tokens or gen_cfg.max_new_tokens
                        lengths[slot] = len(r.input_ids)
                        phase[slot] = DECODE
                        live += 1
                        newly.add(slot)
            if live == 0:
                if source.done():
                    return
                source.wait()
                continue
            exit_free = min(self.EXIT_FREE, source.pending(), live)
            pending, state, packed = self._burst(cache, pending, state, exit_free, generator)
            consume(packed)
            self.last_bursts += 1


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
