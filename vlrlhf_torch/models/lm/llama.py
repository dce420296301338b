"""Llama-family decoder (counterpart of vlrlhf_tpu/models/lm/llama.py):
the training forward and the empty-prefill forward (`lm_forward` without a
cache / with `cache_len`), the single-token decode step with the deferred
cache write (`lm_decode`, `flush_pending`) and the chunk prefill into a
live cache (`lm_prefill_chunk`).

Training: each Linear applies its LoRA adapter when the call's Ctx has
adapters on, and under autograd the layers are rematerialized by
`torch.utils.checkpoint` following `remat_policy_for` (llama.py:647-672),
each policy keeping the per-layer tensors its JAX counterpart keeps:
  - "full": the layer input only (one region per layer);
  - "attn": `attn_out`, held as the residual x + attn_out that the MLP
    half's region takes as input (the same bytes);
  - "mlp1" / "mlp" / "acts": the named activations `attn_out` (again as
    x + attn_out), `ffn_gate` (mlp1), `ffn_up` (mlp), and `attn_q`,
    `attn_k`, `attn_v`, `attn_pre_wo` (acts). The layer is cut into
    regions whose inputs are exactly those tensors (`_named_forward`), so
    nothing else stays and no frozen product whose output is kept is
    computed twice: one region computes a norm or activation and the
    adapter terms of the Linears that read it (`_lins`), and their frozen
    products run on its output outside any region (their backward needs
    weights only);
  - "dots": every matmul output without batch dims
    (`dots_with_no_batch_dims_saveable`): a selective checkpoint of the
    layer that keeps `aten.mm` / `aten.addmm` results. The flash and int4
    Functions' buffers come from allocations filled by their kernels, never
    from those ops, so they are recomputed whole, as JAX recomputes its
    Pallas calls.
`LMConfig.remat=False` keeps everything.

Under a sequence-parallel mesh (core/mesh.py) the training forward takes
the whole sequence's embeddings and pad mask, keeps this rank's contiguous
slice of the embeddings, and runs every layer on it. Over `fsdp` the
layers see the slice alone: global positions (the rank's offset), cos /
sin at the global length, QWen's dynamic-NTK alpha from each row's global
real length and its logn at the global positions, the pad mask's slice,
attention as the ring over the fsdp group (ops/ring_attention.py). Over
`model` (Megatron-LM's sequence parallelism) each layer all-gathers its
normed slice before the column linears (core/dist.py gather_seq), so q /
k / v hold this rank's heads over the whole sequence: cos / sin, the NTK
alpha and logn are the whole sequence's, attention is
`multi_head_attention` (kernels 1-3) with the whole pad mask, and the row
linears reduce-scatter back to the slice (models/common.py Linear); the
MLP gathers likewise before gate / up and down scatters. Norms and
residuals run on the slice. Under every remat policy the gathered tensor
is recomputed, never kept (the gather sits inside the regions, after the
norm; "attn" keeps the (B, S/n, h) slices), and torch.utils.checkpoint
reruns the collectives in the backward, every rank in the same order.
Either way the forward returns the slice's hidden states. The prefill,
decode and chunk paths refuse a split by name; generation runs them
inside core/dist.py's `unsplit` block.

Under a mesh with pipe > 1 each rank's decoder holds its stage's layers
only (`StageLayers`, named by their global indices; core/partitioning.py)
and the training forward runs them through the GPipe schedule
(models/lm/pipeline.py): the batch's rows cross the stages as
microbatches, each stage running its layers (`run_layers`, every remat
policy, each layer's dropout stream folded from its global index) on a
microbatch's rows, and the stack's output comes back whole on every stage,
where the final norm and everything after it run on the whole batch. The
prefill, decode and chunk paths refuse a stage's layers by name; they run
when the decoder holds the whole stack again (core/partitioning.py
`whole_stack`, generation's block), and the training forward then runs
the stack plainly, not through the schedule.

KV cache layout is vlrlhf_tpu's head-major decode layout: {"k", "v"} each
(L, B, nkv, Sc, hd), slot == absolute position (right-padded prompts); an
int8 cache adds {"k_scale", "v_scale"} (L, B, nkv, Sc) bf16 and every write
quantizes per vector (ops/quant.py). Prefill attention dispatches to the
flash kernel on the card (ops/attention.py); decode and chunk attention to
their kernels (ops/decode_attention.py, ops/chunk_attention.py), which read
the stacked cache by layer offset.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from vlrlhf_torch.core.dist import gather_seq, model_split, pipe_shard, sp_shard
from vlrlhf_torch.models.common import Ctx, Linear, Norm, empty_param, embed
from vlrlhf_torch.models.config import LMConfig
from vlrlhf_torch.ops.attention import multi_head_attention
from vlrlhf_torch.ops.chunk_attention import chunk_attention
from vlrlhf_torch.ops.decode_attention import decode_attention
from vlrlhf_torch.ops.norms import rms_norm
from vlrlhf_torch.ops.quant import quantize_kv
from vlrlhf_torch.ops.ring_attention import ring_attention
from vlrlhf_torch.ops.rope import apply_rope, ntk_alpha, rope_frequencies


def train_attention(q, k, v, pad_mask) -> torch.Tensor:
    """A training layer's causal attention: the ring over the fsdp split's
    ranks when the mesh has it, else `multi_head_attention` (under the
    model split on this rank's heads over the whole sequence)."""
    sp = sp_shard()
    if sp is not None and sp.axis == "fsdp":
        return ring_attention(q, k, v, pad_mask, sp, causal=True)
    return multi_head_attention(q, k, v, causal=True, pad_mask_q=pad_mask, pad_mask_kv=pad_mask)


def whole_seq(h: torch.Tensor) -> torch.Tensor:
    """A normed slice made whole for the column linears under the model
    split (core/dist.py gather_seq), else h itself."""
    return gather_seq(h, model_split())


def refuse_split(path: str, whole: bool) -> None:
    """Refuse a prefill, decode or chunk under sequence parallelism (outside
    core/dist.py's `unsplit` block), or under a pipeline on a decoder that
    holds one stage's layers (`whole`: it holds every layer,
    core/partitioning.py whole_stack)."""
    if sp_shard() is not None:
        raise ValueError(f"the {path} path refuses sequence parallelism "
                         "(--sequence_parallel_axis): only the training forward is "
                         "sequence-parallel; generation runs inside core.dist.unsplit")
    if pipe_shard() is not None and not whole:
        raise ValueError(f"the {path} path refuses a pipeline stage's layers (--mesh_pipe): "
                         "a stage holds some of the layers; generation runs on the whole "
                         "stack (core/partitioning.py whole_stack)")


class LlamaLayer(nn.Module):
    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        h, ff = cfg.hidden_size, cfg.intermediate_size
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        dt = cfg.dtype
        self.input_layernorm = Norm(h, False, device, dt)
        self.post_attention_layernorm = Norm(h, False, device, dt)
        self.wq = Linear(h, nh * hd, cfg.qkv_bias, device, dt)
        self.wk = Linear(h, nkv * hd, cfg.qkv_bias, device, dt)
        self.wv = Linear(h, nkv * hd, cfg.qkv_bias, device, dt)
        self.wo = Linear(nh * hd, h, cfg.o_bias, device, dt)
        self.gate = Linear(h, ff, False, device, dt)
        self.up = Linear(h, ff, False, device, dt)
        self.down = Linear(ff, h, False, device, dt)
        # the fused serving layout (models/lm/fuse.py) replaces wq/wk/wv by
        # wqkv and gate/up by gateup
        self.wqkv: Optional[Linear] = None
        self.gateup: Optional[Linear] = None
        self.cfg = cfg

    def qkv(self, h: torch.Tensor, actx: Optional[Ctx] = None):
        """(B, S, H) normed input -> q (B,S,nh,hd), k/v (B,S,nkv,hd)."""
        cfg = self.cfg
        b, s, _ = h.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        actx = actx or Ctx()
        if self.wqkv is not None:
            y = self.wqkv(h, actx.sub("wqkv"))
            dq, dk = nh * hd, nkv * hd
            return (y[..., :dq].reshape(b, s, nh, hd),
                    y[..., dq:dq + dk].reshape(b, s, nkv, hd),
                    y[..., dq + dk:].reshape(b, s, nkv, hd))
        return (
            self.wq(h, actx.sub("wq")).reshape(b, s, nh, hd),
            self.wk(h, actx.sub("wk")).reshape(b, s, nkv, hd),
            self.wv(h, actx.sub("wv")).reshape(b, s, nkv, hd),
        )

    def mlp(self, x: torch.Tensor, mctx: Optional[Ctx] = None) -> torch.Tensor:
        mctx = mctx or Ctx()
        if self.gateup is not None:
            y = self.gateup(x, mctx.sub("gateup"))
            gate, up = y[..., :self.cfg.intermediate_size], y[..., self.cfg.intermediate_size:]
        else:
            gate, up = self.gate(x, mctx.sub("gate")), self.up(x, mctx.sub("up"))
        return self.down(F.silu(gate) * up, mctx.sub("down"))

    # The remat loop's entries. Under a mesh they are FSDP2 forward methods
    # (core/partitioning.py), which gather the layer's weights on the way in
    # and free them on the way out, so the layer's own code calls the
    # bodies (_attn_half, _mlp_half) and never these.
    def attn_out(self, x, cos, sin, pad_mask, lctx: Ctx) -> torch.Tensor:
        """The attention half of a training layer: wo(attention(norm(x)))."""
        return self._attn_half(x, cos, sin, pad_mask, lctx)

    def mlp_residual(self, x: torch.Tensor, lctx: Ctx) -> torch.Tensor:
        """The MLP half of a training layer, residual included."""
        return self._mlp_half(x, lctx)

    def _attn_half(self, x, cos, sin, pad_mask, lctx: Ctx) -> torch.Tensor:
        cfg = self.cfg
        actx = lctx.sub("attn")
        h = whole_seq(rms_norm(x, self.input_layernorm.weight, cfg.rms_eps))
        b, s, _ = h.shape
        q, k, v = self.qkv(h, actx)
        q, k = apply_rope(q, k, cos, sin)
        out = train_attention(q, k, v, pad_mask)
        return self.wo(out.reshape(b, s, -1), actx.sub("wo"))

    def _mlp_half(self, x: torch.Tensor, lctx: Ctx) -> torch.Tensor:
        h = whole_seq(rms_norm(x, self.post_attention_layernorm.weight, self.cfg.rms_eps))
        return x + self.mlp(h, lctx.sub("mlp"))

    def forward(self, x, cos, sin, pad_mask, lctx: Ctx) -> torch.Tensor:
        return self._mlp_half(x + self._attn_half(x, cos, sin, pad_mask, lctx), lctx)

    def _attend(self, q, k, v, cos, sin, pad_mask) -> torch.Tensor:
        """rope + attention over (B, S, heads * hd) projections; the output is
        (B, S, nh * hd), `attn_pre_wo`."""
        cfg = self.cfg
        b, s, _ = q.shape
        nh, nkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
        q, k = apply_rope(q.reshape(b, s, nh, hd), k.reshape(b, s, nkv, hd), cos, sin)
        out = train_attention(q, k, v.reshape(b, s, nkv, hd), pad_mask)
        return out.reshape(b, s, nh * hd)

    def _named_forward(self, x, cos, sin, pad_mask, lctx: Ctx, policy: str) -> torch.Tensor:
        """The layer under "mlp1", "mlp" or "acts" (see the module note):
        the same values as `forward`, with only the policy's tensors kept."""
        eps = self.cfg.rms_eps
        actx, mctx = lctx.sub("attn"), lctx.sub("mlp")

        def norm1(t):
            return whole_seq(rms_norm(t, self.input_layernorm.weight, eps))

        def norm2(t):
            return whole_seq(rms_norm(t, self.post_attention_layernorm.weight, eps))

        def act(g, u):
            return F.silu(g) * u

        if policy == "acts":
            q, k, v = _lins([self.wq, self.wk, self.wv], norm1, (x,),
                            [actx.sub(n) for n in ("wq", "wk", "wv")])
            o = _region(self._attend, q, k, v, cos, sin, pad_mask)
            (a,) = _lins([self.wo], None, (o,), [actx.sub("wo")])
        else:
            a = _region(self._attn_half, x, cos, sin, pad_mask, lctx)
        x = x + a
        if policy == "mlp1":  # ffn_up is not kept: down's region recomputes it
            (gate,) = _lins([self.gate], norm2, (x,), [mctx.sub("gate")])

            def up_act(x1, g):
                return act(g, self.up(norm2(x1), mctx.sub("up")))

            (d,) = _lins([self.down], up_act, (x, gate), [mctx.sub("down")])
            return x + d
        gate, up = _lins([self.gate, self.up], norm2, (x,), [mctx.sub("gate"), mctx.sub("up")])
        (d,) = _lins([self.down], act, (gate, up), [mctx.sub("down")])
        return x + d


def _region(fn, *args, **kw):
    """fn(*args) with nothing inside kept for the backward but `args`. No
    region draws from the global RNG (LoRA dropout seeds its own
    generator per call), so its state is not stashed for the recompute."""
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)


def _lins(lins: list, pre, pre_args: tuple, ctxs: list) -> list:
    """[lin(h, ctx) ...] for Linears reading one input h = pre(*pre_args),
    or h = pre_args[0] when pre is None. One region computes h and the
    adapter terms, so only pre_args are kept; the frozen products run on h
    outside it (their backward needs weights only, not h)."""
    on = [i for i, (lin, ctx) in enumerate(zip(lins, ctxs)) if lin.adapted(ctx)]

    def deltas(h):
        return tuple(lins[i].delta(h, ctxs[i]) for i in on)

    def input_and_deltas(*t):
        h = pre(*t)
        return (h, *deltas(h))

    if pre is None:
        h = pre_args[0]
        ds = _region(deltas, h) if on else ()
    else:
        h, *ds = _region(input_and_deltas, *pre_args)
    ys = [lin.base(h) for lin in lins]
    for i, d in zip(on, ds):
        ys[i] = ys[i] + d.to(ys[i].dtype)
    return ys


_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _keep_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of 2-D matmuls (a Linear's
    product and its adapter's two factors), recompute everything else."""
    from torch.utils.checkpoint import CheckpointPolicy

    return CheckpointPolicy.MUST_SAVE if op in _MATMULS else CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_keep_matmuls)


REMAT_POLICIES = ("full", "attn", "dots", "mlp", "mlp1", "acts")


class StageLayers(nn.ModuleList):
    """A pipeline stage's decoder layers, global layers [offset, offset +
    len): registered under their global indices, so parameter names,
    adapter keys and checkpoint keys are the single-process model's;
    indexed and iterated by position."""

    def __init__(self, layers, offset: int):
        super().__init__()
        self.offset = offset
        for i, layer in enumerate(layers):
            self.add_module(str(offset + i), layer)

    def __getitem__(self, idx):
        return list(self._modules.values())[idx]


class LlamaDecoder(nn.Module):
    def __init__(self, cfg: LMConfig, device):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = empty_param((cfg.vocab_size, cfg.hidden_size), device, cfg.dtype)
        self.layers = nn.ModuleList(LlamaLayer(cfg, device) for _ in range(cfg.num_layers))
        self.norm = Norm(cfg.hidden_size, False, device, cfg.dtype)
        self.lm_head = (
            None if cfg.tie_embeddings
            else Linear(cfg.hidden_size, cfg.vocab_size, False, device, cfg.dtype)
        )

    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        return embed(self.embed_tokens, ids, self.cfg.dtype)

    @property
    def layer_span(self) -> tuple[int, int]:
        """[lo, hi): the global indices of the layers this decoder holds
        (all of them, or a pipeline stage's)."""
        lo = getattr(self.layers, "offset", 0)
        return lo, lo + len(self.layers)

    @property
    def holds_every_layer(self) -> bool:
        """Whether the decoder holds the whole stack (always, but on a
        pipeline stage outside core/partitioning.py whole_stack)."""
        return len(self.layers) == self.cfg.num_layers

    @property
    def cache_cfg(self) -> LMConfig:
        """The config KV caches and pending writes are sized by: a layer's,
        whose head counts are this rank's under tensor parallelism
        (core/partitioning.py apply_tensor_parallel_), else the LM's."""
        return self.layers[0].cfg if len(self.layers) else self.cfg

    def head(self, hidden: torch.Tensor, ctx: Optional[Ctx] = None) -> torch.Tensor:
        """Logits; `ctx` is the LM-level context (an lm_head adapter, if
        targeted, applies under ctx.sub("lm_head") as in vlrlhf_tpu)."""
        if self.lm_head is None:
            return F.linear(hidden, self.embed_tokens.to(hidden.dtype))
        return self.lm_head(hidden, ctx.sub("lm_head") if ctx is not None else None)

    def forward(
        self,
        inputs_embeds: torch.Tensor,  # (B, S, H)
        pad_mask: Optional[torch.Tensor] = None,  # (B, S)
        cache_len: Optional[int] = None,
        ctx: Optional[Ctx] = None,
        kv_cache_dtype: str = "bf16",
    ):
        """Causal forward over right-padded rows (positions == arange).
        Returns (final-normed hidden (B, S, H), cache or None). With
        `cache_len` this is the EMPTY-PREFILL mode: each layer's k/v land in
        slots [0, S) of a fresh (L, B, nkv, cache_len, hd) cache; with
        kv_cache_dtype "int8" they are quantized per vector before the write
        (ops/quant.py), so a bf16 cache never exists, and the cache carries
        "k_scale" / "v_scale" (L, B, nkv, cache_len). Without `cache_len`
        this is the training forward: `ctx` switches adapters on or off,
        and under autograd the layers are rematerialized per
        `cfg.remat_policy`; under a sequence-parallel mesh it returns this
        rank's slice of the hidden states (the module note; under the model
        split the layers take the whole pad mask and rope tables)."""
        cfg = self.cfg
        b, s, _ = inputs_embeds.shape
        sp = sp_shard()
        lo, hi = (0, s) if sp is None else sp.span(s)
        if cache_len is not None:
            refuse_split("prefill", self.holds_every_layer)
        ring = sp is not None and sp.axis == "fsdp"  # the layers see the slice's positions alone
        p0, p1 = (lo, hi) if ring else (0, s)
        positions = torch.arange(p0, p1, device=inputs_embeds.device)[None].expand(b, p1 - p0)
        alpha = None
        if cfg.rope_scaling_type == "qwen_dynamic":  # from each row's (whole) real length
            alpha = ntk_alpha(cfg.rope, torch.full((b,), s, device=positions.device)
                              if pad_mask is None else pad_mask.sum(dim=1))
        cos, sin = rope_frequencies(cfg.rope, positions, seq_len=cache_len or s, alpha=alpha)
        if cache_len is None:
            ctx = ctx or Ctx()
            if sp is not None:
                inputs_embeds = inputs_embeds[:, lo:hi]
            if ring:
                pad_mask = None if pad_mask is None else pad_mask[:, lo:hi]
                ctx = ctx.seq_shard(lo, hi, s)
            return self._train_forward(inputs_embeds, pad_mask, cos, sin, ctx), None
        if cache_len < s:
            raise ValueError(f"cache_len {cache_len} < prompt bucket {s}")
        # allocated once and filled layer by layer in place: only the
        # one stacked cache is ever live (no per-layer caches to stack)
        cache = empty_cache(self.cache_cfg, b, cache_len, kv_cache_dtype, inputs_embeds.device)
        if alpha is not None:  # decode and chunks rotate at the prefill's alpha
            cache["ntk_alpha"].copy_(alpha)
        x = inputs_embeds
        layers_ctx = (ctx or Ctx()).sub("layers_scanned")
        for i, layer in enumerate(self.layers):
            lctx = layers_ctx.fold(i)
            actx = lctx.sub("attn")
            h = rms_norm(x, layer.input_layernorm.weight, cfg.rms_eps)
            q, k, v = layer.qkv(h, actx)
            q, k = apply_rope(q, k, cos, sin)
            for key, t in (("k", k), ("v", v)):
                t = t.transpose(1, 2)  # (B, nkv, S, hd)
                if "k_scale" in cache:
                    t, scales = quantize_kv(t)
                    cache[f"{key}_scale"][i, :, :, :s] = scales
                cache[key][i, :, :, :s] = t
            out = multi_head_attention(
                q, k, v, causal=True, pad_mask_q=pad_mask, pad_mask_kv=pad_mask
            )
            x = x + layer.wo(out.reshape(b, s, -1), actx.sub("wo"))
            h = rms_norm(x, layer.post_attention_layernorm.weight, cfg.rms_eps)
            x = x + layer.mlp(h, lctx.sub("mlp"))
        return rms_norm(x, self.norm.weight, cfg.rms_eps), cache

    def _train_forward(self, x, pad_mask, cos, sin, ctx: Ctx) -> torch.Tensor:
        layers_ctx = ctx.sub("layers_scanned")
        pp = pipe_shard()
        if pp is None or self.holds_every_layer:  # the whole stack runs its layers plainly
            x = self.run_layers(x, cos, sin, pad_mask, layers_ctx)
        else:
            from vlrlhf_torch.models.lm.pipeline import pipeline

            x = pipeline(self.run_layers, x, cos, sin, pad_mask, layers_ctx, pp)
        return rms_norm(x, self.norm.weight, self.cfg.rms_eps)

    def run_layers(self, x, cos, sin, pad_mask, layers_ctx: Ctx,
                   span: Optional[tuple[int, int]] = None) -> torch.Tensor:
        """The training layers of global indices [span) (default: every
        layer this decoder holds) on x, rematerialized per the policy under
        autograd; `layers_ctx` is ctx.sub("layers_scanned") and each layer
        folds its global index into it (a distinct dropout stream per
        layer, the same on every pipeline layout)."""
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        policy = cfg.remat_policy
        if policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {policy!r}: expected one of {REMAT_POLICIES}")
        lo, hi = self.layer_span
        first, last = span or (lo, hi)
        for g in range(first, last):
            layer = self.layers[g - lo]
            lctx = layers_ctx.fold(g)
            if not remat:
                x = layer(x, cos, sin, pad_mask, lctx)
            elif policy == "attn":
                a = _region(layer.attn_out, x, cos, sin, pad_mask, lctx)
                x = _region(layer.mlp_residual, x + a, lctx)
            elif policy == "dots":
                x = _region(layer, x, cos, sin, pad_mask, lctx, context_fn=_dots_context)
            elif policy == "full":
                x = _region(layer, x, cos, sin, pad_mask, lctx)
            else:
                x = layer._named_forward(x, cos, sin, pad_mask, lctx, policy)
        return x

    def decode(
        self,
        last_token: torch.Tensor,  # (B,)
        lengths: torch.Tensor,  # (B,) int32 current position == write slot
        cache: dict,  # {"k", "v"[, "k_scale", "v_scale"]}, updated IN PLACE
        pending: Optional[dict] = None,  # previous token's k/v, not yet written
        ctx: Optional[Ctx] = None,  # the LM-level context (adapters on or off)
    ):
        """Single-token decode step. Returns (logits (B, V), new_pending).

        The deferred write: the previous step's k/v (`pending`, rows with
        pos == Sc meaning "nothing pending") land in the cache first, in one
        batched in-place write (quantized there when the cache is int8);
        this step's k/v ride through the decode kernel as its bf16 self term
        and come back as the next pending. The cache is written in place —
        it is the largest buffer on the card."""
        refuse_split("decode", self.holds_every_layer)
        cfg = self.cfg
        b = last_token.shape[0]
        nkv, hd = self.cache_cfg.num_kv_heads, cfg.head_dim_
        sc = cache["k"].shape[3]
        ctx = _text_ctx(ctx)
        if pending is not None:
            flush_pending(cache, pending)
        x = self.embed(last_token[:, None])  # (B, 1, H)
        positions = lengths.long()[:, None]
        cos, sin = rope_frequencies(cfg.rope, positions, seq_len=sc, alpha=cache.get("ntk_alpha"))
        new_k = torch.empty((cfg.num_layers, b, nkv, hd), dtype=cfg.dtype, device=x.device)
        new_v = torch.empty_like(new_k)
        layers_ctx = (ctx or Ctx()).sub("layers_scanned")
        for i, layer in enumerate(self.layers):
            lctx = layers_ctx.fold(i)
            actx = lctx.sub("attn")
            h = rms_norm(x, layer.input_layernorm.weight, cfg.rms_eps)
            q, k, v = layer.qkv(h, actx)
            q, k = apply_rope(q, k, cos, sin)
            new_k[i] = k[:, 0]
            new_v[i] = v[:, 0]
            out = decode_attention(
                q[:, 0], cache["k"], cache["v"], new_k[i], new_v[i], lengths, layer=i,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            )
            x = x + layer.wo(out.reshape(b, 1, -1), actx.sub("wo"))
            h = rms_norm(x, layer.post_attention_layernorm.weight, cfg.rms_eps)
            x = x + layer.mlp(h, lctx.sub("mlp"))
        hidden = rms_norm(x, self.norm.weight, cfg.rms_eps)
        logits = self.head(hidden, ctx)[:, 0]
        return logits, {"k": new_k, "v": new_v, "pos": lengths.clone()}

    def prefill_chunk(
        self,
        input_ids: torch.Tensor,  # (B, C) right-padded chunk
        chunk_lens: torch.Tensor,  # (B,) real tokens in this chunk
        lengths: torch.Tensor,  # (B,) tokens already in the cache (chunk offset)
        cache: dict,  # {"k", "v"[, "k_scale", "v_scale"]}: (L, B, nkv, Sc, hd), IN PLACE
        pending: Optional[dict] = None,  # deferred kv from a prior decode
        return_all_logits: bool = False,
        ctx: Optional[Ctx] = None,  # the LM-level context (adapters on or off)
    ):
        """Prefill a chunk into a NON-EMPTY cache (vlrlhf_tpu `lm_prefill_chunk`,
        llama.py:506-644): the speculative verify chunk and a chat session's
        next turn. `pending` lands first; then per layer the chunk's k/v are
        written at slots lengths + i (quantized for an int8 cache; pad rows
        and slots past Sc write nothing), and the chunk kernel attends the
        stacked cache at the layer's offset, query i seeing slots
        <= lengths + i.

        Returns (logits, new_lengths): logits are the last real position's
        (B, V), or with return_all_logits every position's (B, C, V)."""
        refuse_split("chunk prefill", self.holds_every_layer)
        cfg = self.cfg
        b, c = input_ids.shape
        sc = cache["k"].shape[3]
        dev = input_ids.device
        ctx = _text_ctx(ctx)
        if pending is not None:
            flush_pending(cache, pending)
        lengths = lengths.to(device=dev, dtype=torch.int32)
        chunk_lens = chunk_lens.to(device=dev, dtype=torch.int32)
        positions = lengths.long()[:, None] + torch.arange(c, device=dev)[None]  # (B, C)
        x = self.embed(input_ids)
        cos, sin = rope_frequencies(cfg.rope, positions, seq_len=sc, alpha=cache.get("ntk_alpha"))
        # the write plan, shared by every layer: rows write chunk positions
        # i < n (n = the real chunk length, cut at Sc); every other position
        # repeats row position n - 1 (same slot, same value), or, for a row
        # that writes nothing, rewrites the slot's own value
        n = torch.minimum(chunk_lens.long(), (sc - lengths.long()).clamp(min=0))
        src = torch.minimum(torch.arange(c, device=dev)[None], (n - 1).clamp(min=0)[:, None])
        slot = (lengths.long()[:, None] + src).clamp(0, sc - 1)  # (B, C)
        writes = n > 0
        layers_ctx = (ctx or Ctx()).sub("layers_scanned")
        for i, layer in enumerate(self.layers):
            lctx = layers_ctx.fold(i)
            actx = lctx.sub("attn")
            h = rms_norm(x, layer.input_layernorm.weight, cfg.rms_eps)
            q, k, v = layer.qkv(h, actx)
            q, k = apply_rope(q, k, cos, sin)
            _write_chunk_(cache, i, k, v, src, slot, writes)
            out = chunk_attention(
                q, cache["k"], cache["v"], lengths, layer=i,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
            )
            x = x + layer.wo(out.reshape(b, c, -1), actx.sub("wo"))
            h = rms_norm(x, layer.post_attention_layernorm.weight, cfg.rms_eps)
            x = x + layer.mlp(h, lctx.sub("mlp"))
        hidden = rms_norm(x, self.norm.weight, cfg.rms_eps)
        if return_all_logits:
            logits = self.head(hidden, ctx)
        else:
            # only the chunk's last real position seeds the next token: gather
            # it before the head ((B, 1, H) through the head, not (B, C, H))
            last = (chunk_lens.long() - 1).clamp(min=0)
            logits = self.head(hidden[torch.arange(b, device=dev), last][:, None], ctx)[:, 0]
        return logits, lengths + chunk_lens


def _text_ctx(ctx: Optional[Ctx]) -> Optional[Ctx]:
    """ctx without a PLoRA mask: decode and chunk tokens are text positions
    (vlrlhf_tpu's lm_decode / lm_prefill_chunk drop base_adapters)."""
    if ctx is None or ctx.lora_mask is None:
        return ctx
    return dataclasses.replace(ctx, lora_mask=None)


def empty_cache(cfg: LMConfig, b: int, cache_len: int, kv_cache_dtype: str, device) -> dict:
    """A zeroed (L, B, nkv, cache_len, hd) cache: bf16 (the model dtype), or
    int8 codes with bf16 (L, B, nkv, cache_len) "k_scale" / "v_scale".
    Under QWen's dynamic NTK it also keeps each row's alpha (B,) f32,
    "ntk_alpha", which the prefill sets and decode and chunks reuse."""
    if kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r}: expected 'bf16' or 'int8'")
    if cfg.sliding_window and cache_len > cfg.sliding_window:
        raise ValueError(f"a KV cache of {cache_len} slots is longer than the LM's "
                         f"sliding_window {cfg.sliding_window}: windowed attention is not ported")
    shape = (cfg.num_layers, b, cfg.num_kv_heads, cache_len, cfg.head_dim_)
    dt = torch.int8 if kv_cache_dtype == "int8" else cfg.dtype
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    if kv_cache_dtype == "int8":
        for key in ("k_scale", "v_scale"):
            cache[key] = torch.zeros(shape[:-1], dtype=torch.bfloat16, device=device)
    if cfg.rope_scaling_type == "qwen_dynamic":
        cache["ntk_alpha"] = torch.ones((b,), dtype=torch.float32, device=device)
    return cache


def _write_chunk_(cache: dict, layer: int, k, v, src, slot, writes) -> None:
    """Write one layer's chunk k/v ((B, C, nkv, hd)) into the cache in
    place by the plan of `prefill_chunk`: position i of row b takes chunk
    row src[b, i] at slot[b, i]; rows with writes[b] False keep their old
    values. Every duplicate slot receives identical bytes, so the scatter
    is deterministic (index_put_ does not drop out-of-range writes as
    vlrlhf_tpu's mode="drop" scatter does)."""
    b, c, nkv, _ = k.shape
    dev = k.device
    bi = torch.arange(b, device=dev)[:, None, None]
    hi = torch.arange(nkv, device=dev)[None, :, None]
    si = slot[:, None, :]  # (B, 1, C)
    keep = writes[:, None, None]
    rows = src[:, :, None, None].expand(b, c, nkv, k.shape[-1])
    for key, t in (("k", k), ("v", v)):
        t = torch.gather(t, 1, rows).transpose(1, 2)  # (B, nkv, C, hd)
        buf = cache[key][layer]
        if "k_scale" in cache:
            t, sc_new = quantize_kv(t)
            sbuf = cache[f"{key}_scale"][layer]
            sbuf[bi, hi, si] = torch.where(keep, sc_new, sbuf[bi, hi, si])
        buf[bi, hi, si] = torch.where(keep[..., None], t.to(buf.dtype), buf[bi, hi, si])


def empty_pending(cfg: LMConfig, b: int, cache_len: int, device) -> dict:
    """No-op pending write: pos == cache_len marks "nothing pending"."""
    shape = (cfg.num_layers, b, cfg.num_kv_heads, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.full((b,), cache_len, dtype=torch.int32, device=device),
    }


def flush_pending(cache: dict, pending: dict) -> None:
    """Write deferred k/v rows into the cache in place (vlrlhf_tpu
    `flush_pending`, llama.py:475-503; also the first act of `decode` and
    `prefill_chunk`), quantized per vector when the cache is int8. A row
    whose pos is out of range (== Sc: nothing pending, or a parked free
    slot) is masked out: its slot is clamped in range and rewritten with the
    value already there — vlrlhf_tpu relies on out-of-bounds scatters being
    dropped, which index_put_ does not do."""
    ck = cache["k"]
    n_layers, b, nkv, sc, _ = ck.shape
    dev = ck.device
    pos = pending["pos"].long()
    valid = (pos >= 0) & (pos < sc)
    slot = pos.clamp(0, sc - 1)
    li = torch.arange(n_layers, device=dev)[:, None, None]
    bi = torch.arange(b, device=dev)[None, :, None]
    hi = torch.arange(nkv, device=dev)[None, None, :]
    si = slot[None, :, None]
    keep = valid[None, :, None]
    for key in ("k", "v"):
        buf, new = cache[key], pending[key]  # new: (L, B, nkv, hd)
        if "k_scale" in cache:
            new, sc_new = quantize_kv(new)
            sbuf = cache[f"{key}_scale"]
            sbuf[li, bi, hi, si] = torch.where(keep, sc_new, sbuf[li, bi, hi, si])
        buf[li, bi, hi, si] = torch.where(keep[..., None], new.to(buf.dtype), buf[li, bi, hi, si])
