"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and no network; imports
nothing of JAX. Phases, each raising on failure (non-zero exit):

  1. the card's name and power limit; build the hand-written kernels from
     vlrlhf_torch/csrc/ with nvcc for sm_90a, one nvcc per source, all at
     once (build seconds and ptxas reports printed)
  2. each kernel against its plain PyTorch version on the card, at the
     serving and DPO paths' shapes, bf16 in, plain computed in f32 on the
     same values; max abs error against 2e-2 (times max(1, max |ref|) for
     the backward) and relative Frobenius error against 1e-2, with the
     median |ref| printed; kernel, plain and yardstick times and each
     kernel's bound max(FLOPs / 989.4e12, bytes / 3.35e12); the flash
     forward and backward kernels, the int4 matmuls and the decode and
     chunk attention kernels are timed alone (their C entry points on
     preallocated outputs) and through their wrappers, and each wrapper's
     host microseconds per call are printed. Decode attention on a bf16 and an int8 cache, timed at
     length 640 and at a full cache (1023); chunk attention at the
     speculative verify shape (B=8, C=4) and a chat turn's (B=1, C=64),
     bf16 and int8 caches; the attention timings rotate over cache layers
     so each launch reads device memory (SDPA with an explicit mask over
     the dequantized cache as yardstick);
     the int4 matmul (kernel 6) at decode (T=8), verify (T=32), prefill
     (T=1280) and T=2048 and its transpose (kernel 7) at T=2048,
     LLaVA-1.5-7B's 4096 -> 11008 and 11008 -> 4096 (and, for kernel 7,
     the attention projections' 4096 -> 4096), plus edge shapes (cuBLAS
     bf16 on the dequantized weight as yardstick)
  3. serving at full LLaVA-1.5-7B widths but 2 LM / 2 tower layers: the
     same seeded weights on the card (bf16, kernels) and on the CPU (f32,
     plain path), one image prefill + 8 greedy tokens; logit error and
     token agreement; prefill_chunk logits (C=4, then C=64) into a bf16
     and an int8 cache; speculative (K=3) vs plain greedy continuous
     batching on the card, where any divergence must be a top-2 tie of the
     CPU's teacher-forced logits; then the LM int4 (the same codes on both
     sides): prefill + 8 greedy tokens again, and fused (--fuse_decode)
     against unfused tokens on the card
  4. full-width LLaVA-1.5-7B with seeded random bf16 weights served over
     HTTP through cli.main.build_server (8 slots, cache_len 1024): 8
     concurrent /generate requests with 336x336 images, 32 new tokens;
     kernel launch counts of that run; then prefill ms, decode tokens/s,
     peak device memory, and one profiled prefill and decode step
  4b. the same model served through build_server with --quantize int8
     --kv_cache_dtype int8 --speculative_k 3 --chat_sessions 4: 8
     concurrent /generate requests whose prompts echo their question, then
     a 2-turn /chat, each run's kernel launch counts; then tokens per
     verify iteration, verify ms vs plain decode ms per step, peak memory
  4c. the same model served with --quantize int4 --fuse_decode true (129
     int4 linears): 8 concurrent /generate requests and their launch
     counts, resident weights, decode ms per step beside 4's and 4b's, one
     profiled decode step
  5. DPO at full widths but 2 LM / 2 tower layers, seeded adapters with a
     non-zero b: one loss and backward on the card (bf16, kernels) and on
     the CPU (f32, plain); relative loss error and the cosine of the LoRA
     gradients; again with the LM's linears int4 (QLoRA, the same codes on
     both sides)
  6. full-width LLaVA-1.5-7B DPO through cli.main.build_dpo (LoRA r64/a16
     on all 7 LM linears, 1 pair of 1024 tokens with an image, 'attn'
     remat, logits_chunk 256, precomputed reference logps): 5 steps on one
     batch with their loss / grad-norm checks and kernel launch counts, then
     step ms, pairs/s, MFU, peak device memory and one profiled step
  6b. the same with --q_lora true --bits 4 (224 int4 LM linears): 3 steps
     with their checks and launch counts, then step ms, pairs/s, MFU, peak
     memory beside phase 6's, and one profiled step; then cli.main
     finish_dpo's merged save over the int4 base, checked on sampled
     linears against the dequantized weight plus scale (A B)^T
  7. the `dpo` trainer's functions (cli.main build_dpo, make_eval_hook,
     train_dpo, finish_dpo) at full LLaVA-1.5-7B width and depth on phase
     6's pair: (a) 3 steps under each remat policy (full, attn, dots, mlp,
     mlp1, acts) from the same adapters: step-1 loss ln 2, loss within
     1e-3 and grad norm within 1e-2 of attn's, median step ms and peak
     memory, the peaks ordered full <= attn <= mlp1 <= mlp <= acts; (b)
     --freeze_vision_tower false with LoRA on the LM's 7 linears and the
     tower's wq|wk|wv|wo: 3 steps, every tower adapter of the layers run
     with a non-zero gradient from step 2, the D = 64 backward kernels'
     launches, one profiled step; (c) 16 pairs, --eval_steps 2
     --eval_ratio 0.125 --eval_samples 2: eval/* finite at steps 0 and 2,
     the step-0 policy and reference samples identical; (d) 4 steps
     straight against 2 steps, a checkpoint, --resume_from_checkpoint auto
     and 2 more (losses within 1e-3), checkpoint bytes, save and restore
     ms; (e) --merge_adapter_after_training: the merged file equals
     W + scale (A B)^T on sampled linears
  8. `eval` and the serving leftovers at full LLaVA-1.5-7B width and depth
     (seeded random bf16 weights) over an MME-shaped TSV (32 yes/no rows,
     16 images as base64 blobs that a seeded loader maps to pixels by file
     name) and a SEEDBench json (16 questions x 4 choices): (a) cli.main
     build_eval / run_eval on MME three ways, static batch 16,
     --continuous_batching true with 8 slots and --speculative_k 3, 16 new
     tokens: images/s each, verify_calls and tokens per row verify, the
     three paths' tokens equal up to top-2 ties of the card's
     teacher-forced logits; (b) CE ranking, 64 SEEDBench rows in batches of
     16, every ppl finite, rows/s; the launch counts of (a) + (b) are the
     "eval" path, which must launch kernels 1, 4 and 5; (c) two r64
     adapter sets with a non-zero b, written by train/checkpoint.py and
     served by build_server --adapter a=... --adapter b=...: 8 concurrent
     /generate requests over a, b and the base model, each equal to an
     engine holding only its set (tie rule); /score through
     EndpointRunner.run_vqa_ppl against the in-process run_vqa_ppl (1e-3
     relative); `eval --endpoint` on MME against (a)'s continuous tokens;
     again with --fuse_decode true, the fused adapter layout against the
     unfused tokens; (d) the EvalRunner at 2 LM / 2 tower layers on the
     card (bf16) and the CPU (f32): ppl within PPL_REL_TOL (two broken
     controls, no causal mask and labels one token off, must fail it),
     greedy tokens equal up to top-2 ties of the CPU's logits

A profiled step prints the card's busy and idle time and its kernel time by
group (torch.profiler; the flash groups split by head dim). Phase 2's
backward cases include the tower's (B=2, S=577, H=16, D=64, non-causal)
and take the aten flash backward as yardstick everywhere (under GQA on K
and V expanded to the query heads, without the group sum). Phase 2 also
holds the eval path's shapes: the flash forward on 16 right-padded rows
of S = 640 (the CE ranking forward), decode at B=16 (the static
Generator) and chunk at B=16, C=4 (the static speculative verify). The line
before the last is {"kernels": [...]} (launches summed over the serve,
speculative int8 serve, /chat, int4 serve, DPO, QLoRA, trainer, eval and
multi-adapter serving runs, split in launches_by_path; the eval shapes'
times under "eval");
the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import itertools
import json
import math
import os
import re
import subprocess
import sys
import threading
import time
import urllib.request
import zlib

import numpy as np
import torch

TOL = 2e-2  # bf16 kernel vs f32 plain on identical bf16 inputs
# ||got - ref||_F / ||ref||_F, kernel vs plain: scale-free, so it also holds
# the many small entries that a max-abs tolerance set by the largest misses
# (bf16 rounding of P, dS and the outputs alone gives a few 1e-3)
REL_TOL = 1e-2
LOGIT_REL_TOL = 5e-2  # bf16 model on the card vs the f32 model on the CPU
# eval's mean answer CE, card bf16 vs CPU f32 at 2 layers: 2.5x the gap of
# sound runs (3.919e-4 on an H100, every run). Random weights put every
# row's CE near ln V, so LOGIT_REL_TOL would pass a wrong mask; phase 8d's
# broken controls must fail this limit (no causal mask: 2.648e-3)
PPL_REL_TOL = 1e-3
LOSS_REL_TOL = 5e-2  # bf16 DPO loss on the card vs the f32 loss on the CPU
GRAD_COS_MIN = 0.99  # cosine of the flattened LoRA gradients, card vs CPU
PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
KERNELS = ("flash_fwd", "decode_attention", "flash_bwd", "chunk_attention", "int4_matmul")
# eval's batch of 16 rows: prompt lengths around an image prompt's ~600 tokens
EVAL_LENS = (598, 604, 611, 617, 622, 629, 633, 640, 645, 651, 656, 662, 668, 673, 681, 690)
CE_LENS = tuple(min(n, 640) - 9 * (i % 3) for i, n in enumerate(EVAL_LENS))  # S = 640 bucket


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def seeded_image(path, size, mode="shortest_edge_crop"):
    """Image loader for synthetic requests: the path names a seed."""
    rng = np.random.default_rng(zlib.crc32(str(path).encode()))
    return rng.integers(0, 256, (size, size, 3), dtype=np.uint8)


def phase_build():
    from vlrlhf_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all(KERNELS)
    print("build seconds:", json.dumps(_build.build_seconds), flush=True)
    for name, info in _build.ptxas_info.items():  # nvcc -Xptxas -v, all instantiations
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", info))
        serial = sorted(set(re.findall(r"\((C75\d\d)\)", info)))  # "wgmma ... serialized"
        print(f"ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores, wgmma serialization warnings "
              f"{serial or 'none'}", flush=True)


def check_close(what: str, got: torch.Tensor, ref: torch.Tensor, atol: float) -> tuple:
    """Kernel output vs its f32 plain version: max abs error <= atol and
    relative Frobenius error <= REL_TOL. Returns (max abs err, rel err,
    a report that names the median |ref| beside the tolerances)."""
    got, ref = got.float(), ref.float()
    diff = got - ref
    err = float(diff.abs().max())
    rel = float(diff.norm() / ref.norm())
    med = float(ref.abs().median())
    if not (np.isfinite(err) and np.isfinite(rel)) or err > atol or rel > REL_TOL:
        raise AssertionError(f"{what}: max abs err {err:.3e} (tol {atol:.3e}), rel err "
                             f"{rel:.3e} (tol {REL_TOL}), median |ref| {med:.3e}")
    return err, rel, (f"max_abs_err={err:.3e} (tol {atol:.3e}) rel_err={rel:.3e} "
                      f"(tol {REL_TOL}) median|ref|={med:.3e}")


def _flash_bytes(lens, s, h, hkv, d, grads: str) -> int:
    """Bytes a flash launch must move on rows of valid lengths `lens` padded
    to `s`: each valid row's inputs read once (bf16 tensors, f32 LSE / di),
    the segment ids read in full, each output written in full (a padded
    row's output is 0 or -inf, but is written)."""
    n, n_all = sum(lens), len(lens) * s
    q, kv, row = h * d * 2, hkv * d * 2, h * 4
    seg = 2 * n_all * 4
    if grads == "fwd":  # q, k, v, seg -> o, lse
        return n * (q + 2 * kv) + seg + n_all * (q + row)
    if grads == "dkv":  # q, k, v, do, lse, di, seg -> dk, dv
        return n * (2 * q + 2 * kv + 2 * row) + seg + n_all * 2 * kv
    return n * (2 * q + 2 * kv + 2 * row) + seg + n_all * q  # dq


def _flash_flops(lens, h, d, causal: bool) -> float:
    """Matmul FLOPs of one attention forward (QK^T and PV) on rows of valid
    lengths `lens`: a row of length L attends L(L+1)/2 (query, key) pairs
    when causal, L^2 when not; padded rows and keys need none."""
    return 4.0 * h * d * sum(n * (n + 1) / 2 if causal else n * n for n in lens)


def flash_kernel_call(q, k, v, seg_q, seg_kv, causal: bool, scale: float):
    """A closure that launches the flash kernel's C entry point on outputs
    allocated once: the kernel's own time, without the wrapper's checks,
    allocations and segment ids (host ~10 us; no launch is counted)."""
    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.flash_attention import _FWD_ARGS

    b, sq, h, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    fn = _build.fn("flash_fwd", "flash_fwd_bf16", _FWD_ARGS)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, k.shape[2], sq, k.shape[1], d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    return lambda: _build.check(fn(*args), "flash_fwd_bf16")


def flash_bwd_kernel_call(symbol: str, q, k, v, do, lse, di, seg_q, seg_kv, causal: bool,
                          scale: float):
    """A closure that launches flash backward entry point `symbol`
    (flash_bwd_dkv_bf16 or flash_bwd_dq_bf16) on outputs allocated once: the
    kernel's own time, without the wrapper's checks and allocations (no
    launch is counted)."""
    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.flash_attention import _BWD_ARGS, _bwd_args

    dq = torch.empty_like(q) if symbol == "flash_bwd_dq_bf16" else None
    dk, dv = (torch.empty_like(k), torch.empty_like(v)) if dq is None else (None, None)
    fn = _build.fn("flash_bwd", symbol, _BWD_ARGS)
    args = _bwd_args(q, k, v, do, lse, di, seg_q, seg_kv, dq, dk, dv, causal, scale)
    return lambda: _build.check(fn(*args), symbol)


def int4_kernel_call(name: str, a, d_c: int, d_in: int, d_out: int):
    """A closure (packed, scale) -> None launching int4 kernel `name`'s C
    entry point on an output allocated once (no launch is counted)."""
    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.int4 import _ARGS

    c = torch.empty((a.shape[0], d_c), dtype=torch.bfloat16, device=a.device)
    fn = _build.fn("int4_matmul", name, _ARGS)
    stream = torch.cuda.current_stream().cuda_stream

    def call(packed, scale):
        _build.check(fn(a.data_ptr(), packed.data_ptr(), scale.data_ptr(), c.data_ptr(),
                        a.shape[0], d_in, d_out, packed.shape[1], scale.shape[1], stream), name)
    return call


def phase_kernels():
    import torch.nn.functional as F

    from vlrlhf_torch.ops.flash_attention import (
        KV_PAD_SEG, Q_PAD_SEG, flash_attention, flash_attention_bwd_plain,
        flash_attention_plain, flash_bwd_dkv, flash_bwd_dq, make_segments,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    def segs(b, s, lens):
        lens_t = torch.tensor(lens or (s,) * b, device=dev)
        pad = torch.arange(s, device=dev)[None] < lens_t[:, None]
        return lens_t, pad, make_segments(b, s, dev, None, pad, Q_PAD_SEG), \
            make_segments(b, s, dev, None, pad, KV_PAD_SEG)

    flash_cases = [
        # (label, causal, B, S, H, Hkv, D, prompt lengths or None)
        ("vit_noncausal", False, 2, 577, 16, 16, 64, None),
        ("lm_causal_padded", True, 4, 640, 32, 32, 128, (600, 613, 627, 640)),
        ("lm_causal_gqa", True, 2, 640, 32, 8, 128, (640, 601)),
        ("dpo_lm_causal", True, 2, 1024, 32, 32, 128, (1000, 900)),
        # the CE ranking forward of eval: 16 right-padded rows of uneven length
        ("ce_rows_padded", True, 16, 640, 32, 32, 128, CE_LENS),
    ]
    errs, times = [], {}
    for label, causal, b, s, h, hkv, d, lens in flash_cases:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_t, pad, seg_q, seg_kv = segs(b, s, lens)
        out = flash_attention(q, k, v, causal=causal, pad_mask_q=pad, pad_mask_kv=pad)
        torch.cuda.synchronize()
        ref, _ = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv,
                                       causal, d**-0.5)
        err, _, report = check_close(f"flash {label}", out[pad], ref[pad], TOL)  # valid rows
        # the kernel alone (segment ids built once, outside the timing) and
        # the wrapper as the model calls it (segment ids built per call)
        k_ms = time_ms(flash_kernel_call(q, k, v, seg_q, seg_kv, causal, d**-0.5))
        w_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, pad_mask_q=pad,
                                               pad_mask_kv=pad))
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, seg_q, seg_kv, causal,
                                                     d**-0.5), iters=5)
        # yardstick: PyTorch's SDPA on the same (B, H, S, D) views and the
        # same function: rows with padding take one boolean mask, causal
        # and the keys' pad mask together
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        mask = None
        if lens is not None:
            mask = pad[:, None, None, :]
            if causal:
                mask = mask & torch.ones((s, s), dtype=torch.bool, device=dev).tril()
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=h != hkv))
        flops = _flash_flops(lens or (s,) * b, h, d, causal)
        b_ms, b_by = bound(flops, _flash_bytes(lens or (s,) * b, s, h, hkv, d, "fwd"))
        print(f"flash {label} B={b} S={s} H={h} Hkv={hkv} D={d}: {report}; "
              f"kernel alone {k_ms:.4f} ms ({flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
              f"{k_ms / l_ms:.2f}x sdpa), wrapper {w_ms:.4f} ms "
              f"({flops / (w_ms * 1e-3) / 1e12:.1f} TFLOP/s, {w_ms / l_ms:.2f}x sdpa), "
              f"plain {p_ms:.4f} ms, sdpa {l_ms:.4f} ms "
              f"({flops / (l_ms * 1e-3) / 1e12:.1f} TFLOP/s), bound {b_ms:.4f} ms ({b_by})",
              flush=True)
        errs.append(err)
        times[label] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms, "library_ms": l_ms,
                        "bound_ms": b_ms, "bound_by": b_by}
    main = times["dpo_lm_causal"]
    results["flash_fwd"] = {"max_abs_err": max(errs), **main, "cases": times,
                            "eval": times["ce_rows_padded"]}

    # backward: the DPO path's LM case, a GQA case and an unfrozen tower's
    # (D = 64, non-causal, the 2 tiled rows of one pair)
    bwd_cases = [
        ("dpo_lm_causal", True, 2, 1024, 32, 32, 128, (1000, 900)),
        ("lm_causal_gqa", True, 2, 640, 32, 8, 128, (640, 601)),
        ("vit_noncausal", False, 2, 577, 16, 16, 64, (577, 577)),
    ]
    bwd = {"dkv": {}, "dq": {}}
    bwd_errs = {"dkv": [], "dq": []}
    for label, causal, b, s, h, hkv, d, lens in bwd_cases:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_t, pad, seg_q, seg_kv = segs(b, s, lens)
        do = torch.where(pad[..., None, None], randn(b, s, h, d), 0).contiguous()
        o, lse = flash_attention(q, k, v, causal=causal, pad_mask_q=pad, pad_mask_kv=pad,
                                 return_lse=True)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        scale = d**-0.5
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        torch.cuda.synchronize()
        rq, rk, rv = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                               lse, di, seg_q, seg_kv, causal, scale)
        checks = {"dq": (dq[pad].float(), rq[pad]), "dk": (dk.float(), rk),
                  "dv": (dv.float(), rv)}
        line = []
        for name, (got, ref) in checks.items():
            err, _, report = check_close(f"flash backward {label} {name}", got, ref,
                                         TOL * max(1.0, float(ref.abs().max())))
            bwd_errs["dq" if name == "dq" else "dkv"].append(err)
            line.append(f"{name} {report}")
        args = (q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
        # each kernel alone (its C entry point on outputs allocated once) and
        # through its wrapper, as FlashAttention.backward calls it
        ms = {"dkv": time_ms(flash_bwd_kernel_call("flash_bwd_dkv_bf16", *args)),
              "dq": time_ms(flash_bwd_kernel_call("flash_bwd_dq_bf16", *args))}
        w_ms = {"dkv": time_ms(lambda: flash_bwd_dkv(*args)),
                "dq": time_ms(lambda: flash_bwd_dq(*args))}
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(*args), iters=3, warmup=1)
        # yardsticks: SDPA forward+backward, and its flash backward alone
        # (one aten call computing dQ, dK, dV from O and the LSE). It takes
        # as many K / V heads as query heads, so under GQA K and V are
        # expanded to H heads before the timed call; its dK / dV then come
        # per query head, without the group sum the kernels do
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                 enable_gqa=h != hkv)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        fb_ms = time_ms(sdpa_fwd_bwd)
        ke, ve = (t.detach().repeat_interleave(h // hkv, dim=1) for t in (kt, vt))
        with torch.no_grad():
            fo = torch.ops.aten._scaled_dot_product_flash_attention(
                qt.detach(), ke, ve, 0.0, causal, False, scale=scale)
        lib_bwd_ms = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dot, qt.detach(), ke, ve, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0, causal,
            fo[6], fo[7], scale=scale))
        fwd_flops = _flash_flops(lens, h, d, causal)
        bounds = {"dkv": bound(2.0 * fwd_flops, _flash_bytes(lens, s, h, hkv, d, "dkv")),
                  "dq": bound(1.5 * fwd_flops, _flash_bytes(lens, s, h, hkv, d, "dq"))}
        pair_bound = bound(2.5 * fwd_flops, _flash_bytes(lens, s, h, hkv, d, "dkv") + b * s * h * d * 2)
        flops = {"dkv": 2.0 * fwd_flops, "dq": 1.5 * fwd_flops}
        kern = ", ".join(
            f"{kname} kernel alone / wrapper {ms[kname]:.4f} / {w_ms[kname]:.4f} ms "
            f"({flops[kname] / (ms[kname] * 1e-3) / 1e12:.1f} TFLOP/s alone, bound "
            f"{bounds[kname][0]:.4f} ms ({bounds[kname][1]}), "
            f"{bounds[kname][0] / ms[kname]:.2f} of it)" for kname in ("dkv", "dq"))
        print(f"flash backward {label} causal={causal} B={b} S={s} H={h} Hkv={hkv} D={d}: "
              + ", ".join(line)
              + f"; {kern}; pair alone {ms['dkv'] + ms['dq']:.4f} ms, through the wrappers "
              f"{w_ms['dkv'] + w_ms['dq']:.4f} ms (bound at 2.5x forward "
              f"{pair_bound[0]:.4f} ms); plain {plain_ms:.4f} ms; sdpa fwd+bwd {fb_ms:.4f} ms, "
              f"aten flash backward alone {lib_bwd_ms:.4f} ms"
              + (f" (K / V expanded to {h} heads, no group sum)" if h != hkv else ""),
              flush=True)
        for kname in ("dkv", "dq"):
            bwd[kname][label] = (ms[kname], plain_ms, lib_bwd_ms, *bounds[kname], fb_ms,
                                 w_ms[kname])
        del qt, kt, vt, ke, ve, fo
    for kname in ("dkv", "dq"):
        m = bwd[kname]["dpo_lm_causal"]
        results[f"flash_bwd_{kname}"] = {
            "max_abs_err": max(bwd_errs[kname]), "ms": m[0], "plain_ms": m[1],
            "library_ms": m[2], "bound_ms": m[3], "bound_by": m[4], "sdpa_fwd_bwd_ms": m[5],
            "wrapper_ms": m[6], "cases": bwd[kname],
        }

    results["decode_attention"] = decode_kernel_checks(randn)
    results["chunk_attention"] = chunk_kernel_checks(randn)
    results.update(int4_kernel_checks(gen))
    wrapper_host_us()
    return results


def int4_kernel_checks(gen) -> dict:
    """Kernels 6 and 7 (csrc/int4_matmul.cu) against their plain versions on
    the same bf16 operands, f32 plain: LLaVA-1.5-7B's gate/up (4096 ->
    11008) and down (11008 -> 4096) at decode (T=8), a verify chunk (T=32),
    a B=2 prefill (T=1280; kernel 6 only) and the DPO step (T=2048; for
    kernel 7 also the attention projections, 4096 -> 4096, 125 of its 221
    launches a QLoRA step), and edge shapes (in 384: odd n_lo and a padded
    half; out 200; T=5 on the cluster kernel and the dx kernel's smallest
    tile, T=65 and 129 on the wgmma ones). Operands are scaled so outputs
    have unit variance. Times: the kernel alone (its C entry point on a
    preallocated output) and through its wrapper, plain, and cuBLAS bf16 on the weight dequantized once
    outside the timing (library_ms), beside the bound. At T <= 32 the
    weights rotate over 4 copies (96 MB, more than the 50 MB L2), as a step
    reads 225 distinct weights. The main entries are decode gate/up (kernel
    6, the serving path) and the DPO gate (kernel 7)."""
    import itertools

    from vlrlhf_torch.ops.int4 import (
        dequantize_int4, int4_matmul, int4_matmul_plain, int4_matmul_t, int4_matmul_t_plain,
        quantize_int4,
    )

    dev = torch.device("cuda")
    weights = {}

    def weight(d_in, d_out):
        if (d_in, d_out) not in weights:
            w = torch.randn((d_out, d_in), device=dev, generator=gen) * d_in**-0.5
            packed, scale = quantize_int4(w)
            weights[(d_in, d_out)] = (packed, scale, dequantize_int4(packed, scale))
        return weights[(d_in, d_out)]

    fwd = [("decode_gate", 8, 4096, 11008), ("decode_down", 8, 11008, 4096),
           ("verify_gate", 32, 4096, 11008), ("verify_down", 32, 11008, 4096),
           ("prefill_gate", 1280, 4096, 11008), ("prefill_down", 1280, 11008, 4096),
           ("dpo_gate", 2048, 4096, 11008), ("dpo_down", 2048, 11008, 4096),
           ("edge", 5, 384, 200), ("edge_wgmma", 65, 384, 200)]
    bwd = [("dpo_gate", 2048, 4096, 11008), ("dpo_down", 2048, 11008, 4096),
           ("dpo_attn", 2048, 4096, 4096), ("edge", 5, 384, 200), ("edge_wgmma", 129, 384, 200)]
    results = {}
    for name, cases, kern, plain in (("int4_matmul", fwd, int4_matmul, int4_matmul_plain),
                                     ("int4_matmul_t", bwd, int4_matmul_t, int4_matmul_t_plain)):
        by_case, errs = {}, []
        for label, t, d_in, d_out in cases:
            packed, scale, wdeq = weight(d_in, d_out)
            width, scale_a = (d_in, 1.0) if name == "int4_matmul" else (d_out, (d_in / d_out) ** 0.5)
            a = (torch.randn((t, width), device=dev, generator=gen) * scale_a).to(torch.bfloat16)
            got = kern(a, packed, scale)
            torch.cuda.synchronize()
            err, rel, report = check_close(f"{name} {label}", got, plain(a.float(), packed, scale),
                                           TOL)
            # the kernel alone (its C entry point) and through its wrapper
            alone = int4_kernel_call(name, a, d_out if name == "int4_matmul" else d_in, d_in,
                                     d_out)
            if label.startswith(("decode", "verify")):
                copies = itertools.cycle([(packed, scale)] + [(packed.clone(), scale.clone())
                                                              for _ in range(3)])
                k_ms = time_ms(lambda: alone(*next(copies)), iters=40)
                w_ms = time_ms(lambda: kern(a, *next(copies)), iters=40)
            else:
                k_ms = time_ms(lambda: alone(packed, scale), iters=10)
                w_ms = time_ms(lambda: kern(a, packed, scale), iters=10)
            p_ms = time_ms(lambda: plain(a, packed, scale), iters=3, warmup=1)
            if name == "int4_matmul":
                l_ms = time_ms(lambda: a @ wdeq.T, iters=10)
            else:
                l_ms = time_ms(lambda: a @ wdeq, iters=10)
            w_bytes = packed.numel() + 2 * scale.numel()
            nbytes = w_bytes + 2 * t * (d_in + d_out)
            b_ms, b_by = bound(2.0 * t * d_in * d_out, nbytes)
            print(f"{name} {label} T={t} in={d_in} out={d_out}: {report}; kernel alone "
                  f"{k_ms:.4f} ms ({k_ms / l_ms:.2f}x cublas), wrapper {w_ms:.4f} ms, "
                  f"plain {p_ms:.4f} ms cublas bf16 on the dequantized weight {l_ms:.4f} ms "
                  f"bound {b_ms:.4f} ms ({b_by}; {nbytes / 1e6:.3f} MB, "
                  f"{2.0 * t * d_in * d_out / 1e9:.3f} GFLOP); {nbytes / (k_ms * 1e-3) / 1e9:.1f} "
                  f"GB/s, {2.0 * t * d_in * d_out / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s", flush=True)
            errs.append(err)
            by_case[label] = {"max_abs_err": err, "rel_err": rel, "ms": k_ms, "wrapper_ms": w_ms,
                              "plain_ms": p_ms, "library_ms": l_ms, "bound_ms": b_ms,
                              "bound_by": b_by}
        main = by_case["decode_gate" if name == "int4_matmul" else "dpo_gate"]
        results[name] = {**{k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                                   "bound_by")},
                         "max_abs_err": max(errs), "cases": by_case}
    weights.clear()
    torch.cuda.empty_cache()
    return results


def decode_kernel_checks(randn) -> dict:
    """Decode attention vs its plain version, bf16 and int8 caches, nh =
    nkv = 32, hd 128, a stacked 32-layer cache of 1024 slots read at layer
    17, at two shapes: the serve's B=8 (rows of lengths 0, S - 1, 1 and in
    between; 256 CTAs, S not split) and a /chat session's B=1 (lengths 0
    and 613; S split across a cluster of CTAs, merged with the self term
    in distributed shared memory). Times at every row's length 640 and S - 1
    (B=8) and 613 (B=1): the kernel alone (its C entry point on an output
    allocated once) and through its wrapper, each launch on the next of
    layers 17-20 so the cache comes from device memory as it does on the
    path, beside plain, SDPA of the one query over the live slots (over
    the dequantized cache for int8; the self term has no counterpart
    there) and the bound. The main entry is B=8 bf16 at length 640; "int8"
    holds the B=8 int8 one, "chat" both B=1 ones, "eval" the B=16 bf16 one
    (eval's static Generator; rows of EVAL_LENS, on an 8-layer cache read
    at layers 2-5)."""
    import torch.nn.functional as F

    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.decode_attention import (
        _ARGS, c_args, decode_attention, decode_attention_plain,
    )
    from vlrlhf_torch.ops.quant import dequantize_kv, quantize_kv

    dev = torch.device("cuda")
    nh, nkv, hd, sc = 32, 32, 128, 1024
    fn = _build.fn("decode_attention", "decode_attention", _ARGS)
    results = {}
    for shape, b, L, layer, checked, timed, kinds in (
            ("serve", 8, 32, 17, [(0, sc - 1, 600, 613, 1, 640, 827, 128)], (640, sc - 1),
             ("bf16", "int8")),
            ("chat", 1, 32, 17, [(0,), (613,)], (613,), ("bf16", "int8")),
            # eval's static Generator: 16 rows of ~600-700 tokens
            ("eval", 16, 8, 2, [EVAL_LENS, (0, sc - 1) * 8], (640,), ("bf16",))):
        timed_layers = range(layer, layer + 4)
        q = randn(b, nh, hd)
        kc, vc = randn(L, b, nkv, sc, hd), randn(L, b, nkv, sc, hd)
        k_cur, v_cur = randn(b, nkv, hd), randn(b, nkv, hd)
        o = torch.empty_like(q)
        qs = q[:, :, None]
        for kind in kinds:
            if kind == "int8":
                # the int8 cache of the speculative int8 serve and /chat: the
                # same values quantized per vector; plain and SDPA read the codes
                (kc, ks), (vc, vs) = quantize_kv(kc), quantize_kv(vc)
            else:
                ks = vs = None
            lks = None if ks is None else ks[layer]
            lvs = None if vs is None else vs[layer]
            errs, rels = [], []
            for lens in checked:
                lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
                out = decode_attention(q, kc, vc, k_cur, v_cur, lengths, layer=layer,
                                       k_scale=ks, v_scale=vs)
                torch.cuda.synchronize()
                ref = decode_attention_plain(q.float(), kc[layer].float(), vc[layer].float(),
                                             k_cur.float(), v_cur.float(), lengths, hd**-0.5,
                                             lks, lvs)
                err, rel, report = check_close(f"decode {shape} {kind} lengths {list(lens)}",
                                               out, ref, TOL)
                print(f"decode {shape} {kind} B={b} lengths {list(lens)}: {report}", flush=True)
                errs.append(err)
                rels.append(rel)
            kd = [kc[i] if ks is None else dequantize_kv(kc[i], ks[i], torch.bfloat16)
                  for i in timed_layers]
            vd = [vc[i] if vs is None else dequantize_kv(vc[i], vs[i], torch.bfloat16)
                  for i in timed_layers]
            cases = {}
            for length in timed:
                lengths_t = torch.full((b,), length, dtype=torch.int32, device=dev)
                alone = _build.Rotating(fn, [c_args(q, kc, vc, k_cur, v_cur, lengths_t, o,
                                                    hd**-0.5, i, ks, vs) for i in timed_layers],
                                        "decode_attention")
                k_ms = time_ms(alone, iters=100, warmup=8)
                wrap = itertools.cycle(timed_layers)
                w_ms = time_ms(lambda: decode_attention(q, kc, vc, k_cur, v_cur, lengths_t,
                                                        layer=next(wrap), k_scale=ks, v_scale=vs),
                               iters=100, warmup=8)
                p_ms = time_ms(lambda: decode_attention_plain(q, kc[layer], vc[layer], k_cur,
                                                              v_cur, lengths_t, hd**-0.5, lks, lvs))
                live = (torch.arange(sc, device=dev) < length)[None, None, None, :]
                pairs = itertools.cycle(list(zip(kd, vd)))
                l_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, *next(pairs),
                                                                      attn_mask=live), iters=100)
                row = hd + 2 if ks is not None else 2 * hd  # int8: codes and one bf16 scale
                live_bytes = 2 * b * nkv * length * row
                b_ms, b_by = bound(4.0 * b * nh * (length + 1) * hd,
                                   live_bytes + 2 * b * nkv * hd * 2 + 2 * b * nh * hd * 2 + b * 4)
                print(f"decode {shape} {kind} B={b} L={L} nkv={nkv} hd={hd} Sc={sc} layers "
                      f"{timed_layers[0]}-{timed_layers[-1]} length {length}: kernel alone "
                      f"{k_ms:.4f} ms ({live_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s of live k/v, "
                      f"{k_ms / l_ms:.2f}x sdpa), wrapper {w_ms:.4f} ms, plain {p_ms:.4f} ms, "
                      f"sdpa ({'dequantized ' if ks is not None else ''}cache, masked) "
                      f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})", flush=True)
                cases[f"length_{length}"] = {"ms": k_ms, "wrapper_ms": w_ms, "plain_ms": p_ms,
                                             "library_ms": l_ms, "bound_ms": b_ms,
                                             "bound_by": b_by}
            results[f"{shape}_{kind}"] = {"max_abs_err": max(errs), "rel_err": max(rels),
                                          **cases[f"length_{timed[0]}"], "cases": cases}
            del kd, vd
        del kc, vc, ks, vs
        torch.cuda.empty_cache()
    return {**results["serve_bf16"],
            "max_abs_err": max(r["max_abs_err"] for r in results.values()),
            "int8": results["serve_int8"],
            "chat": {"bf16": results["chat_bf16"], "int8": results["chat_int8"]},
            "eval": results["eval_bf16"]}


def wrapper_host_us() -> dict:
    """Host microseconds per wrapper call: 200 calls enqueued without a
    synchronize on tiny shapes (the card never holds the host back), wall
    clock over the count. Includes the Python checks, allocations and the
    ctypes call; the kernels' prototypes are set once per library."""
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import _launch as flash_launch
    from vlrlhf_torch.ops.flash_attention import flash_attention, make_segments
    from vlrlhf_torch.ops.int4 import int4_matmul, quantize_int4

    dev = torch.device("cuda")
    bf = dict(device=dev, dtype=torch.bfloat16)
    q, k, v = (torch.randn((1, 64, 2, 64), **bf) for _ in range(3))
    pad = torch.ones((1, 64), dtype=torch.bool, device=dev)
    seg = make_segments(1, 64, dev, None, None, 0)
    packed, scale = quantize_int4(torch.randn((256, 1024), device=dev))
    x = torch.randn((8, 1024), **bf)
    kc, vc = torch.randn((2, 1, 2, 64, 64), **bf), torch.randn((2, 1, 2, 64, 64), **bf)
    qd, cur = torch.randn((1, 2, 64), **bf), torch.randn((1, 2, 64), **bf)
    qc = torch.randn((1, 4, 2, 64), **bf)
    lengths = torch.full((1,), 30, dtype=torch.int32, device=dev)
    calls = {
        "flash_fwd wrapper": lambda: flash_attention(q, k, v, causal=True, pad_mask_q=pad,
                                                     pad_mask_kv=pad),
        "flash_fwd _launch": lambda: flash_launch(q, k, v, seg, seg, True, 0.125),
        "int4_matmul": lambda: int4_matmul(x, packed, scale),
        "decode_attention": lambda: decode_attention(qd, kc, vc, cur, cur, lengths, layer=1),
        "chunk_attention": lambda: chunk_attention(qc, kc, vc, lengths, layer=1),
    }
    out = {}
    for name, fn in calls.items():
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        out[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    print("wrapper host us per call (200 calls, no synchronize, tiny shapes): "
          + json.dumps({n: round(us, 2) for n, us in out.items()}), flush=True)
    return out


def _chunk_work(lengths, c, nh, nkv, hd, sc, int8: bool) -> tuple[float, int]:
    """(FLOPs, bytes) one chunk launch needs: QK^T and PV of each query over
    the slots it attends; q read and o written once (bf16), each live k and
    v row read once (int8 codes and a bf16 scale, or bf16), the lengths."""
    attended = sum(min(n + i + 1, sc) for n in lengths for i in range(c))
    live = sum(min(n + c, sc) for n in lengths)
    row = hd + 2 if int8 else 2 * hd
    b = len(lengths)
    return 4.0 * nh * hd * attended, 2 * b * c * nh * hd * 2 + 2 * nkv * live * row + 4 * b


def chunk_kernel_checks(randn) -> dict:
    """Chunk attention vs its plain version at the speculative verify shape
    (B=8, C=4 = K+1; the CUDA-core path, S not split), a chat turn's (B=1,
    C=64; the tensor-core path) and a short chat turn's (B=1, C=16: 16 rows
    on the CUDA cores with S split across a cluster of CTAs), nh = nkv =
    32, hd 128, Sc 1024, lengths ~600-700, on a stacked cache (4 layers
    for verify, 8 for chat) checked at layer 2; bf16 and int8 caches. Times: the kernel alone (its C entry point on
    an output allocated once) and through its wrapper, each launch on the
    next layer (more than the L2 in all), beside plain, SDPA with an
    explicit mask (over the dequantized cache for int8) and the bound. The
    main entry is the int8 verify shape (the speculative int8 serve's);
    "eval" holds B=16, C=4 (the static speculative verify over eval's
    batch), bf16 and int8."""
    import torch.nn.functional as F

    from vlrlhf_torch.ops import _build
    from vlrlhf_torch.ops.chunk_attention import (
        _ARGS, c_args, chunk_attention, chunk_attention_plain,
    )
    from vlrlhf_torch.ops.quant import dequantize_kv, quantize_kv

    dev = torch.device("cuda")
    nh, nkv, hd, sc, layer = 32, 32, 128, 1024, 2
    fn = _build.fn("chunk_attention", "chunk_attention", _ARGS)
    cases, errs = {}, []
    for label, lens, c, L in (("verify", (600, 613, 627, 640, 655, 671, 688, 700), 4, 4),
                              ("chat", (620,), 64, 8), ("chat_short", (620,), 16, 8),
                              # the static SpeculativeGenerator's verify over eval's batch
                              ("eval_verify", EVAL_LENS, 4, 4)):
        b = len(lens)
        q = randn(b, c, nh, hd)
        kc, vc = randn(L, b, nkv, sc, hd), randn(L, b, nkv, sc, hd)
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        limit = lengths[:, None] + torch.arange(c, device=dev)[None]
        attend = torch.arange(sc, device=dev)[None, None, :] <= limit[:, :, None]  # (B, C, Sc)
        qt = q.transpose(1, 2)  # SDPA's (B, nh, C, hd)
        o = torch.empty_like(q)
        (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
        for kind, (kk, vv, ksc, vsc) in (("bf16", (kc, vc, None, None)),
                                         ("int8", (kq, vq, ks, vs))):
            lks = None if ksc is None else ksc[layer]
            lvs = None if vsc is None else vsc[layer]
            out = chunk_attention(q, kk, vv, lengths, layer=layer, k_scale=ksc, v_scale=vsc)
            torch.cuda.synchronize()
            ref = chunk_attention_plain(q.float(), kk[layer], vv[layer], lengths, hd**-0.5,
                                        lks, lvs)
            err, rel, report = check_close(f"chunk {label} {kind}", out, ref, TOL)
            alone = _build.Rotating(fn, [c_args(q, kk, vv, lengths, o, hd**-0.5, i, ksc, vsc)
                                         for i in range(L)], "chunk_attention")
            k_ms = time_ms(alone, iters=100, warmup=8)
            wrap = itertools.cycle(range(L))
            w_ms = time_ms(lambda: chunk_attention(q, kk, vv, lengths, layer=next(wrap),
                                                   k_scale=ksc, v_scale=vsc), iters=100, warmup=8)
            p_ms = time_ms(lambda: chunk_attention_plain(q, kk[layer], vv[layer], lengths,
                                                         hd**-0.5, lks, lvs), iters=10)
            kd = [kk[i] if ksc is None else dequantize_kv(kk[i], ksc[i], torch.bfloat16)
                  for i in range(L)]
            vd = [vv[i] if vsc is None else dequantize_kv(vv[i], vsc[i], torch.bfloat16)
                  for i in range(L)]
            pairs = itertools.cycle(list(zip(kd, vd)))
            l_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, *next(pairs), attn_mask=attend[:, None]), iters=100)
            del kd, vd
            flops, nbytes = _chunk_work(lens, c, nh, nkv, hd, sc, ksc is not None)
            b_ms, b_by = bound(flops, nbytes)
            print(f"chunk {label} {kind} B={b} C={c} L={L} nh=nkv={nkv} hd={hd} Sc={sc} "
                  f"lengths {list(lens)}: {report}; kernel alone {k_ms:.4f} ms "
                  f"({k_ms / l_ms:.2f}x sdpa, {flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                  f"{nbytes / (k_ms * 1e-3) / 1e9:.1f} GB/s), wrapper {w_ms:.4f} ms, plain "
                  f"{p_ms:.4f} ms, sdpa (masked, {'dequantized ' if ksc is not None else ''}cache) "
                  f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.3f} GFLOP, "
                  f"{nbytes / 1e6:.3f} MB)", flush=True)
            errs.append(err)
            cases[f"{label}_{kind}"] = {"max_abs_err": err, "rel_err": rel, "ms": k_ms,
                                        "wrapper_ms": w_ms, "plain_ms": p_ms, "library_ms": l_ms,
                                        "bound_ms": b_ms, "bound_by": b_by}
        del kc, vc, kq, vq, ks, vs
        torch.cuda.empty_cache()
    main = cases["verify_int8"]
    return {"max_abs_err": max(errs), "ms": main["ms"], "plain_ms": main["plain_ms"],
            "library_ms": main["library_ms"], "bound_ms": main["bound_ms"],
            "bound_by": main["bound_by"], "cases": cases,
            "eval": {"bf16": cases["eval_verify_bf16"], "int8": cases["eval_verify_int8"]}}


def make_processor(cfg):
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES

    family = FAMILIES[cfg.family]
    pcfg = ProcessorConfig(
        **{**family.processor_defaults, "image_token_id": 3,  # ToyTokenizer <image>
           "num_image_tokens": cfg.num_image_tokens}
    )
    # word ids below the 32064-row vocabulary
    return VLProcessor(ToyTokenizer(vocab_size=32000), family.template, pcfg)


def phase_reduced_depth():
    import dataclasses

    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device, prefill
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    full = _llava_7b(torch.float32)
    cfg32 = dataclasses.replace(
        full,
        lm=dataclasses.replace(full.lm, num_layers=2),
        vision=dataclasses.replace(full.vision, num_layers=2),
    )
    cfg16 = dataclasses.replace(
        cfg32,
        lm=dataclasses.replace(cfg32.lm, dtype=torch.bfloat16),
        vision=dataclasses.replace(cfg32.vision, dtype=torch.bfloat16),
    )
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    gpu = VLM(cfg16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    proc = make_processor(cfg32)
    prompt = proc.format_multimodal_prompt("describe the picture in detail", 1)
    ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
    batch = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)(
        [{"input_ids": ids, "img_path": "reduced.png"}]
    )
    gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    logits = {}
    tokens = {}
    with torch.inference_mode():
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            _, _, _, _, _, last = prefill(
                model, gen_cfg, 768, t["input_ids"], t["pad_mask"], t["prompt_lens"],
                t["pixel_values"], t["image_positions"], None,
            )
            logits[name] = last.float().cpu()
            tokens[name] = Generator(model, gen_cfg)(batch).cpu()[0].tolist()
    ref, got = logits["cpu"], logits["cuda"]
    if not torch.isfinite(got).all():
        raise AssertionError("reduced-depth logits on the card are not finite")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    agree = sum(int(a == b) for a, b in zip(tokens["cuda"], tokens["cpu"]))
    top2 = torch.topk(ref[0], 2).values
    gap = float(top2[0] - top2[1])
    print(f"reduced depth (2 LM / 2 tower layers, full widths, prompt "
          f"{int(batch['prompt_lens'][0])} tokens): logit max_abs_err={err:.4e} "
          f"rel={rel:.3e} (tol {LOGIT_REL_TOL}); greedy tokens agree {agree}/8; "
          f"cuda {tokens['cuda']} cpu {tokens['cpu']}", flush=True)
    if rel > LOGIT_REL_TOL:
        raise AssertionError(f"reduced-depth logits differ: rel {rel} > {LOGIT_REL_TOL}")
    if gap > 2 * err and tokens["cuda"][0] != tokens["cpu"][0]:
        raise AssertionError("first greedy token differs though its margin exceeds the error")
    with torch.inference_mode():
        reduced_depth_chunks(cpu, gpu, batch)
        reduced_depth_spec(cpu, gpu, proc, err)
    reduced_depth_int4(cpu, gpu, batch)
    del cpu, gpu
    torch.cuda.empty_cache()


def share_int4(cpu, gpu, patterns, what: str) -> int:
    """Quantize the CPU model's linears that match `patterns` to int4 once,
    on the CPU from its f32 weights, and hand the same packed codes and
    scales to the card model (whose bf16 weights are dropped); returns the
    number of int4 linears."""
    from vlrlhf_torch.models.common import Linear
    from vlrlhf_torch.ops.quant import quantize_params

    quantize_params(cpu, patterns, bits=4)
    mods = dict(gpu.named_modules())
    n = 0
    for name, mod in cpu.named_modules():
        if isinstance(mod, Linear) and mod.weight_q4 is not None:
            mods[name].set_quantized4_(mod.weight_q4.cuda(), mod.weight_scale4.cuda())
            n += 1
    print(f"{what}: {n} linears int4, the same codes on the CPU and the card", flush=True)
    return n


def reduced_depth_int4(cpu, gpu, batch) -> None:
    """int4 serving at reduced depth: the LM linears and lm_head int4
    (DEFAULT_QUANT_PATTERNS), the same codes on the card (bf16 activations,
    kernel 6) and the CPU (f32, plain); image prefill + 8 greedy tokens,
    logit error and token agreement; then the card model fused
    (--fuse_decode) must give the same tokens as unfused."""
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator, batch_to_device, prefill
    from vlrlhf_torch.models.lm.fuse import fuse_lm_
    from vlrlhf_torch.ops.quant import DEFAULT_QUANT_PATTERNS

    n4 = share_int4(cpu, gpu, DEFAULT_QUANT_PATTERNS, "reduced-depth int4 serving")
    if n4 != 7 * cpu.cfg.lm.num_layers + 1:
        raise AssertionError(f"expected every LM linear and lm_head int4, got {n4}")
    gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1)
    logits, tokens = {}, {}
    with torch.inference_mode():
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            *_, last = prefill(model, gen_cfg, 768, t["input_ids"], t["pad_mask"],
                               t["prompt_lens"], t["pixel_values"], t["image_positions"], None)
            logits[name] = last.float().cpu()
            tokens[name] = Generator(model, gen_cfg)(batch).cpu()[0].tolist()
    fuse_lm_(gpu.lm)
    with torch.inference_mode():
        fused = Generator(gpu, gen_cfg)(batch).cpu()[0].tolist()
    ref, got = logits["cpu"], logits["cuda"]
    if not torch.isfinite(got).all():
        raise AssertionError("reduced-depth int4 logits on the card are not finite")
    err = float((got - ref).abs().max())
    rel = err / float(ref.abs().max())
    agree = sum(int(a == b) for a, b in zip(tokens["cuda"], tokens["cpu"]))
    top2 = torch.topk(ref[0], 2).values
    print(f"reduced-depth int4 serving (2 LM / 2 tower layers, full widths): logit "
          f"max_abs_err={err:.4e} rel={rel:.3e} (tol {LOGIT_REL_TOL}); greedy tokens agree "
          f"{agree}/8; cuda {tokens['cuda']} cpu {tokens['cpu']}; fused on the card "
          f"{fused} ({'identical' if fused == tokens['cuda'] else 'DIFFERENT'})", flush=True)
    if rel > LOGIT_REL_TOL:
        raise AssertionError(f"reduced-depth int4 logits differ: rel {rel} > {LOGIT_REL_TOL}")
    if float(top2[0] - top2[1]) > 2 * err and tokens["cuda"][0] != tokens["cpu"][0]:
        raise AssertionError("first int4 greedy token differs though its margin exceeds the error")
    if fused != tokens["cuda"]:
        raise AssertionError(f"fused int4 tokens {fused} differ from unfused {tokens['cuda']}")


def reduced_depth_chunks(cpu, gpu, batch) -> None:
    """prefill_chunk after an image prefill, the verify chunk (C=4) and then
    a chat turn (C=64), into a bf16 (f32 on the CPU) and an int8 cache: all
    logits, card bf16 vs CPU f32."""
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill

    rng = np.random.default_rng(3)
    chunks = [rng.integers(16, 31000, (1, 4)), rng.integers(16, 31000, (1, 64))]
    for kv in ("bf16", "int8"):
        gen_cfg = GenerateConfig(max_new_tokens=8, pad_token_id=-1, kv_cache_dtype=kv)
        got = {}
        for name, model in (("cuda", gpu), ("cpu", cpu)):
            t = batch_to_device(batch, model.device)
            cache, lengths, *_ = prefill(model, gen_cfg, 768, t["input_ids"], t["pad_mask"],
                                         t["prompt_lens"], t["pixel_values"],
                                         t["image_positions"], None)
            got[name] = []
            for ids in chunks:
                ids_t = torch.as_tensor(ids, dtype=torch.int32, device=model.device)
                clens = torch.full((1,), ids.shape[1], dtype=torch.int32, device=model.device)
                logits, lengths = model.lm.prefill_chunk(ids_t, clens, lengths, cache,
                                                         return_all_logits=True)
                got[name].append(logits.float().cpu())
        for ids, g, r in zip(chunks, got["cuda"], got["cpu"]):
            if not torch.isfinite(g).all():
                raise AssertionError(f"prefill_chunk logits on the card are not finite ({kv})")
            err = float((g - r).abs().max())
            rel = err / float(r.abs().max())
            print(f"reduced-depth prefill_chunk {kv} cache, C={ids.shape[1]}: logit "
                  f"max_abs_err={err:.4e} rel={rel:.3e} (tol {LOGIT_REL_TOL})", flush=True)
            if rel > LOGIT_REL_TOL:
                raise AssertionError(f"prefill_chunk logits differ ({kv}, C={ids.shape[1]}): "
                                     f"rel {rel} > {LOGIT_REL_TOL}")


def image_requests(proc, questions, max_new_tokens: int, tag: str):
    """Engine Requests for image prompts (the collator expands the image
    token); returns (requests, the unexpanded prompt ids, image paths)."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.generate.continuous import Request

    coll = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)
    reqs, ids_list, paths = [], [], []
    for j, question in enumerate(questions):
        prompt = proc.format_multimodal_prompt(question, 1)
        ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        path = f"{tag}{j}.png"
        b1 = coll([{"input_ids": ids, "img_path": path}])
        n = int(b1["prompt_lens"][0])
        reqs.append(Request(input_ids=b1["input_ids"][0, :n],
                            pixel_values=b1["pixel_values"][0, 0],
                            image_positions=b1["image_positions"][0],
                            max_new_tokens=max_new_tokens))
        ids_list.append(list(ids))
        paths.append(path)
    return reqs, ids_list, paths


def echo_question(i: int) -> str:
    """A prompt that repeats a phrase, so prompt-lookup drafts find it."""
    words = " ".join(f"w{100 + 7 * i + k}" for k in range(6))
    return f"request {i}: repeat after me: {words}. again: {words}. again: {words}. again:"


def reduced_depth_spec(cpu, gpu, proc, logit_err: float) -> None:
    """Speculative (K=3) vs plain greedy continuous batching on the card,
    bf16 and int8 caches. Where the two differ, the first differing
    position must be a top-2 tie under teacher forcing: both tokens are the
    top two of the CPU f32 model's logits after the plain prefix, and their
    gap is within twice the card-vs-CPU logit error measured above."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill

    reqs, ids_list, paths = image_requests(proc, [echo_question(i) for i in range(4)], 24, "spec")
    coll = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)
    ref_cfg = GenerateConfig(max_new_tokens=1, pad_token_id=-1)  # the f32 model's own cache
    for kv in ("bf16", "int8"):
        gen_cfg = GenerateConfig(max_new_tokens=24, pad_token_id=-1, kv_cache_dtype=kv)
        plain = ContinuousEngine(gpu, gen_cfg, n_slots=4, cache_len=768).run(reqs)
        eng = ContinuousEngine(gpu, gen_cfg, n_slots=4, cache_len=768, speculative_k=3,
                               speculative_adaptive=False)
        spec = eng.run(reqs)
        same, ties = 0, []
        for r, (p, s) in enumerate(zip(plain, spec)):
            j = next((i for i in range(max(len(p), len(s)))
                      if i >= min(len(p), len(s)) or p[i] != s[i]), None)
            if j is None:
                same += 1
                continue
            if j >= min(len(p), len(s)):
                raise AssertionError(f"spec {kv} request {r}: lengths differ without a token "
                                     f"difference: plain {p} spec {s}")
            t = batch_to_device(coll([{"input_ids": ids_list[r] + p[:j], "img_path": paths[r]}]),
                                "cpu")
            *_, ref = prefill(cpu, ref_cfg, t["input_ids"].shape[1], t["input_ids"],
                              t["pad_mask"], t["prompt_lens"], t["pixel_values"],
                              t["image_positions"], None)
            top2 = torch.topk(ref[0], 2)
            gap = float(abs(ref[0, p[j]] - ref[0, s[j]]))
            tie = {p[j], s[j]} == set(top2.indices.tolist()) and gap <= 2 * logit_err
            ties.append((r, j, p[j], s[j], round(gap, 5)))
            if not tie:
                raise AssertionError(
                    f"spec {kv} request {r} diverges from plain greedy at {j} ({p[j]} vs {s[j]}) "
                    f"and it is no top-2 tie: reference top-2 {top2.indices.tolist()} "
                    f"{top2.values.tolist()}, gap {gap} > {2 * logit_err} or not the top two")
        n_tok = sum(len(x) for x in spec)
        print(f"reduced-depth speculative greedy ({kv} cache, K=3, 4 requests, 24 tokens): "
              f"{same}/4 token-identical to plain, divergences (request, position, plain, spec, "
              f"reference gap) {ties} all top-2 ties; {n_tok} tokens in "
              f"{eng.last_verify_steps} verify steps", flush=True)


def serve_args(**kw):
    """The `serve` CLI's arguments as build_server reads them: 8 slots,
    cache_len 1024, 32 new tokens, greedy."""
    import argparse

    base = dict(
        max_new_tokens=32, synthetic=0, do_sample=False, temperature=1.0, top_k=None,
        top_p=None, max_length=992, slots=8, seed=0, host="127.0.0.1", port=0,
        quantize="false", kv_cache_dtype="bf16", speculative_k=0, chat_sessions=0,
        fuse_decode=False,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def post_json(url: str, body: dict, timeout: float = 600) -> dict:
    req = urllib.request.Request(url, data=json.dumps(body).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def post_concurrently(url: str, bodies: list) -> list:
    """POST every body to url at once, one thread each; raises on any
    failure or a response without text."""
    results: list = [None] * len(bodies)
    errors: list = []

    def post(i):
        try:
            results[i] = post_json(url, bodies[i])
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    clients = [threading.Thread(target=post, args=(i,)) for i in range(len(bodies))]
    for c in clients:
        c.start()
    for c in clients:
        c.join(timeout=900)
    if errors or any(c.is_alive() for c in clients):
        raise AssertionError(f"serving failed: {errors}")
    if any(not isinstance(r, dict) or "text" not in r for r in results):
        raise AssertionError(f"bad responses: {results}")
    return results


def phase_serve():
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.generate.engine import batch_to_device, prefill
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention

    torch.cuda.reset_peak_memory_stats()
    cfg = _llava_7b(torch.bfloat16)
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"full-width LLaVA-1.5-7B: {n_params / 1e9:.3f} B params bf16, random init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    proc = make_processor(cfg)
    httpd, srv = build_server(cfg, model, proc, serve_args(), seeded_image)
    engine = srv.engine
    assert engine.cache_len == 1024
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    n_req = 8
    bodies = [{"question": f"request {i}: what does this image show? answer in detail",
               "image": f"img{i}.png", "max_new_tokens": 32} for i in range(n_req)]
    try:
        flash_attention.launches = 0
        decode_attention.launches = 0
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash_attention.launches,
                    "decode_attention": decode_attention.launches}
        tokens = [r.get("tokens") for r in results]
        steps = engine.last_decode_steps
        print(f"served {n_req}/{n_req} /generate requests in {wall:.3f} s "
              f"({sum(tokens)} tokens; per request {tokens}); admits "
              f"{engine.last_admits}, bursts {engine.last_bursts}, decode steps {steps}; "
              f"launches {json.dumps(launches)}", flush=True)
        if launches["flash_fwd"] < engine.last_admits * (
            cfg.vision.layers_run + cfg.lm.num_layers
        ):
            raise AssertionError(f"too few flash launches: {launches}")
        if steps == 0 or launches["decode_attention"] < cfg.lm.num_layers * steps:
            raise AssertionError(f"too few decode launches for {steps} steps: {launches}")
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("/health reports the scheduler dead")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError("server threads did not stop")

    # measurements on the same model, outside the counted run
    from vlrlhf_torch.data.processor import make_single_turn_conv

    prompt_ids = []
    for i in range(8):
        prompt = proc.format_multimodal_prompt(f"request {i}: what does this image show?", 1)
        ids = proc.process_conv(make_single_turn_conv(prompt, ""))["input_ids"]
        prompt_ids.append(ids)
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator

    coll = GenerationCollator(proc, CollatorConfig(image_size=336), seeded_image)
    with torch.inference_mode():
        prefill_ms = {}
        for bp in (1, 2):
            batch = batch_to_device(
                coll([{"input_ids": ids, "img_path": f"m{j}.png"}
                      for j, ids in enumerate(prompt_ids[:bp])]), "cuda")
            run = lambda: prefill(  # noqa: E731
                model, engine.gen_cfg, batch["input_ids"].shape[1], batch["input_ids"],
                batch["pad_mask"], batch["prompt_lens"], batch["pixel_values"],
                batch["image_positions"], None,
            )
            _, _, _, _, _, last = run()
            if not torch.isfinite(last).all():
                raise AssertionError("prefill logits are not finite")
            prefill_ms[bp] = time_ms(run, iters=3, warmup=1)
        # decode: all 8 slots active, one 31-step burst
        reqs, _, _ = image_requests(
            proc, [f"request {i}: what does this image show?" for i in range(8)], 32, "d")
        cache, pending, state, hist = engine._fresh_buffers()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)], reqs, gen)
        logits, _ = model.lm.decode(state[1].clone(), state[0].clone(), cache, pending)
        if not torch.isfinite(logits).all():
            raise AssertionError("decode logits are not finite")
        torch.cuda.synchronize()
        engine.last_decode_steps = 0
        t0 = time.perf_counter()
        _, _, packed, _ = engine._burst(cache, pending, state, hist, 0, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = engine.last_decode_steps
        decode_tok_s = 8 * steps / dt
        profile_breakdown(run, f"prefill B=2 ({batch['input_ids'].shape[1]}-token bucket)")
        profile_breakdown(lambda: model.lm.decode(state[1].clone(), state[0].clone(), cache,
                                                  pending), "decode step (8 slots)")
    peak = torch.cuda.max_memory_allocated()
    print(f"prefill (ViT + projector + 32-layer LM, {batch['input_ids'].shape[1]}-token "
          f"bucket): B=1 {prefill_ms[1]:.3f} ms, B=2 {prefill_ms[2]:.3f} ms; "
          f"decode 8 slots x {steps} steps: {dt * 1e3 / steps:.3f} ms/step, "
          f"{decode_tok_s:.2f} tokens/s; peak memory {peak / 2**30:.3f} GiB", flush=True)
    return launches, dt * 1e3 / steps


def phase_serve_spec_int8():
    """Full-width LLaVA-1.5-7B served as `serve --quantize int8
    --kv_cache_dtype int8 --speculative_k 3 --chat_sessions 4`: the bf16
    model is quantized in place by build_server (never a second copy).
    Returns the launch counts of the /generate run and of the /chat run."""
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.generate.continuous import device_draft
    from vlrlhf_torch.models.common import Linear, init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "chunk_attention": chunk_attention}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    args = serve_args(quantize="int8", kv_cache_dtype="int8", speculative_k=3, chat_sessions=4)
    httpd, srv = build_server(cfg, model, proc, args, seeded_image)
    engine = srv.engine
    n_int8 = sum(1 for m in model.modules() if isinstance(m, Linear) and m.weight is None)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"int8 serving model: {n_int8} linears int8 (W8A16), {weights / 2**30:.3f} GiB of "
          f"weights after in-place quantization, {torch.cuda.memory_allocated() / 2**30:.3f} GiB "
          f"allocated ({before / 2**30:.3f} GiB before the model); engine cache "
          f"{engine.gen_cfg.kv_cache_dtype}, "
          f"speculative_k {engine.speculative_k}, adaptive gate {engine.speculative_adaptive}",
          flush=True)
    if n_int8 != 7 * cfg.lm.num_layers + 1 or engine.gen_cfg.kv_cache_dtype != "int8":
        raise AssertionError(f"expected every LM linear and lm_head int8, got {n_int8}")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [{"question": echo_question(i), "image": f"spec{i}.png", "max_new_tokens": 32}
              for i in range(8)]
    try:
        reset()
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        spec_launches = read()
        tokens = [r.get("tokens") for r in results]
        print(f"speculative int8 serve: {len(results)}/8 /generate requests in {wall:.3f} s "
              f"({sum(tokens)} tokens; per request {tokens}); admits {engine.last_admits}, "
              f"bursts {engine.last_bursts} ({engine.last_spec_bursts} speculative), verify "
              f"steps {engine.last_verify_steps}, plain decode steps "
              f"{engine.last_decode_steps}; launches {json.dumps(spec_launches)}", flush=True)
        if spec_launches["chunk_attention"] < cfg.lm.num_layers * max(engine.last_verify_steps, 1):
            raise AssertionError(f"too few chunk launches: {spec_launches}")

        reset()
        t0 = time.perf_counter()
        turn1 = post_json(url + "/chat", {"message": "what does this image show? describe it",
                                          "image": "chat0.png"})
        turn2 = post_json(url + "/chat", {"message": "and what else? repeat: w5 w6 w7",
                                          "session_id": turn1["session_id"]})
        wall = time.perf_counter() - t0
        chat_launches = read()
        print(f"/chat: 2 turns of session {turn1['session_id']} in {wall:.3f} s; turn texts "
              f"{len(turn1['text'])} and {len(turn2['text'])} chars; launches "
              f"{json.dumps(chat_launches)}", flush=True)
        if turn2["session_id"] != turn1["session_id"]:
            raise AssertionError(f"/chat turn 2 opened a new session: {turn1} {turn2}")
        if chat_launches["chunk_attention"] < cfg.lm.num_layers or \
                chat_launches["decode_attention"] < cfg.lm.num_layers:
            raise AssertionError(f"/chat did not run the chunk and int8 decode kernels: "
                                 f"{chat_launches}")
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("/health reports the scheduler dead")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError("server threads did not stop")

    # measurements outside the counted runs: 8 admitted slots, one burst of
    # each kind in turns (plain, spec, spec, plain), each on a fresh admission
    reqs, _, _ = image_requests(proc, [echo_question(i) for i in range(8)], 32, "m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings = {"plain": [], "spec": []}
    with torch.inference_mode():
        for kind in ("plain", "spec", "spec", "plain"):
            cache, pending, state, hist = engine._fresh_buffers()
            for g in range(0, 8, 2):
                engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)],
                                    reqs, gen)
            lengths0 = state[0].cpu().numpy()
            engine.last_decode_steps = engine.last_verify_steps = 0
            burst = engine._spec_burst if kind == "spec" else engine._burst
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, packed, _ = burst(cache, pending, state, hist, 0, gen)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            steps = engine.last_verify_steps if kind == "spec" else engine.last_decode_steps
            emitted = int((packed[:, -1] - lengths0).sum())
            if steps == 0 or emitted == 0:
                raise AssertionError(f"{kind} burst emitted nothing")
            readings[kind].append((dt * 1e3 / steps, emitted / steps, steps, emitted))
            del cache
        peak = torch.cuda.max_memory_allocated()  # before the profiled steps
        # one profiled int8 decode step and one verify chunk on 8 admitted slots
        cache, pending, state, hist = engine._fresh_buffers()
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)], reqs, gen)
        last, lengths = state[1].clone(), state[0].clone()
        chunk = torch.cat([last[:, None], device_draft(hist, lengths + 1, 3, 0)], dim=1)
        clens = torch.full((8,), 4, dtype=torch.int32, device="cuda")
        profile_breakdown(lambda: model.lm.decode(last, lengths, cache, pending),
                          "int8 decode step (8 slots, W8A16 linears, int8 KV)")
        profile_breakdown(lambda: model.lm.prefill_chunk(chunk, clens, lengths, cache,
                                                         return_all_logits=True),
                          "int8 verify step (8 slots x 4 tokens, W8A16 linears, int8 KV)")
        del cache
    for kind, rows in readings.items():
        print(f"int8 {kind} burst, 8 slots: " + "; ".join(
            f"{ms:.3f} ms per {'verify' if kind == 'spec' else 'decode'} step, {tps:.3f} tokens "
            f"per step ({tps / 8:.3f} per slot), {n} steps, {e} tokens" for ms, tps, n, e in rows),
            flush=True)
    print(f"speculative int8 serving peak memory {peak / 2**30:.3f} GiB (the bf16 weights "
          f"before their in-place quantization included)", flush=True)
    del model, engine, srv, httpd
    return spec_launches, chat_launches, [r[0] for r in readings["plain"]]


def phase_serve_int4(bf16_ms: float, int8_ms: list) -> dict:
    """Full-width LLaVA-1.5-7B served as `serve --quantize int4 --fuse_decode
    true`: build_server quantizes the bf16 model's LM linears and lm_head to
    int4 in place, then fuses each layer (129 int4 linears). 8 concurrent
    image /generate requests, 32 new tokens, greedy, with their launch
    counts; resident weights; decode ms per step (8 slots, one burst) beside
    phases 4 and 4b of this run; one profiled decode step. Returns the
    launch counts of the /generate run."""
    from vlrlhf_torch.cli.main import build_server
    from vlrlhf_torch.models.common import Linear, init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention
    from vlrlhf_torch.ops.int4 import int4_matmul

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "int4_matmul": int4_matmul}
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    t0 = time.perf_counter()
    httpd, srv = build_server(cfg, model, proc, serve_args(quantize="int4", fuse_decode=True),
                              seeded_image)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine = srv.engine
    n4 = sum(1 for m in model.modules() if isinstance(m, Linear) and m.weight_q4 is not None)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    lm_bytes = sum(p.numel() * p.element_size() for n, p in model.named_parameters()
                   if n.startswith("lm.") and "embed" not in n)
    print(f"int4 serving model: {n4} int4 linears (fused wqkv / wo / gateup / down per layer and "
          f"lm_head), quantized and fused in place in {setup_s:.2f} s; weights "
          f"{weights / 2**30:.3f} GiB ({lm_bytes / 2**30:.3f} GiB of LM linears, norms and "
          f"lm_head; the rest the bf16 tower, projector and embedding); "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated ({before / 2**30:.3f} GiB "
          f"before the model); peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB",
          flush=True)
    if n4 != 4 * cfg.lm.num_layers + 1 or model.lm.layers[0].wq is not None:
        raise AssertionError(f"expected 129 fused int4 linears, got {n4}")
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    bodies = [{"question": f"request {i}: what does this image show? answer in detail",
               "image": f"img{i}.png", "max_new_tokens": 32} for i in range(8)]
    try:
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        results = post_concurrently(url + "/generate", bodies)
        wall = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counted.items()}
        tokens = [r.get("tokens") for r in results]
        steps = engine.last_decode_steps
        print(f"int4 serve: {len(results)}/8 /generate requests in {wall:.3f} s ({sum(tokens)} "
              f"tokens; per request {tokens}); admits {engine.last_admits}, bursts "
              f"{engine.last_bursts}, decode steps {steps}; launches {json.dumps(launches)}",
              flush=True)
        if steps == 0 or launches["int4_matmul"] < n4 * steps:
            raise AssertionError(f"too few int4 launches for {steps} decode steps: {launches}")
        with urllib.request.urlopen(url + "/health", timeout=60) as r:
            if not json.loads(r.read())["ok"]:
                raise AssertionError("/health reports the scheduler dead")
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.stop()
        http_thread.join(timeout=60)
    if http_thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
        raise AssertionError("server threads did not stop")

    # measurement outside the counted run: 8 admitted slots, one burst
    reqs, _, _ = image_requests(
        proc, [f"request {i}: what does this image show?" for i in range(8)], 32, "q")
    with torch.inference_mode():
        cache, pending, state, hist = engine._fresh_buffers()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, hist, [(g, g), (g + 1, g + 1)], reqs, gen)
        logits, _ = model.lm.decode(state[1].clone(), state[0].clone(), cache, pending)
        if not torch.isfinite(logits).all():
            raise AssertionError("int4 decode logits are not finite")
        torch.cuda.synchronize()
        engine.last_decode_steps = 0
        t0 = time.perf_counter()
        engine._burst(cache, pending, state, hist, 0, gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        steps = engine.last_decode_steps
        profile_breakdown(lambda: model.lm.decode(state[1].clone(), state[0].clone(), cache,
                                                  pending),
                          "int4 decode step (8 slots, fused W4A16 linears)")
        del cache
    print(f"decode ms per step, 8 slots, this run: int4 fused {dt * 1e3 / steps:.3f} "
          f"({steps} steps); bf16 {bf16_ms:.3f} (phase 4); int8 W8A16 + int8 KV plain bursts "
          f"{', '.join(f'{x:.3f}' for x in int8_ms)} (phase 4b)", flush=True)
    del model, engine, srv, httpd
    return launches


def profile_breakdown(fn, label: str):
    """Run fn() once under torch.profiler and print where the card's time
    went: wall ms, busy ms (kernel durations summed; one stream), idle
    share, and kernel time by group and by name. Returns the busy ms (None
    when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"profile {label}: the profiler saw no device time", flush=True)
        return None
    groups = {"flash_fwd": ("flash_fwd_kernel",), "flash_bwd_dkv": ("flash_bwd_dkv_",),
              "flash_bwd_dq": ("flash_bwd_dq_",), "decode": ("decode_split_kernel",),
              "chunk": ("chunk_split_kernel", "chunk_mma_kernel"),  # short / long chunks
              "int4_matmul_t": ("int4_matmul_t_",),  # before int4_matmul: both designs
              "int4_matmul": ("int4_matmul_kernel",),  # T <= 64
              "int4_matmul_wgmma": ("int4_matmul_wgmma_kernel",)}
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        name = e.name
        grp = next((g for g, keys in groups.items() if any(k in name for k in keys)), None)
        dim = re.search(r"kernel<(\d+)", name)
        if grp is not None and grp.startswith("flash") and dim:
            grp += f"[D={dim.group(1)}]"  # the tower's D = 64 apart from the LM's 128
        if grp is None:
            low = name.lower()
            grp = "matmul" if any(t in low for t in ("gemm", "xmma", "nvjet", "cutlass")) \
                else "other"
        n, t = by_group.get(grp, (0, 0.0))
        by_group[grp] = (n + 1, t + us)
        n, t = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, t + us)
    busy = sum(t for _, t in by_group.values()) / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    print(f"profile {label}: wall {wall:.3f} ms (profiled), card busy {busy:.3f} ms, idle "
          f"{max(0.0, 1 - busy / wall):.3f}; {len(kernels)} kernels; by group (count, ms) "
          + json.dumps({g: (n, round(t / 1e3, 3)) for g, (n, t) in
                        sorted(by_group.items(), key=lambda kv: -kv[1][1])})
          + "; top kernels " + json.dumps([(nm[:60], n, round(t / 1e3, 3)) for nm, (n, t) in top]),
          flush=True)
    return busy


def pair_row(i: int, prompt_words: int, chosen_words: int, rejected_words: int) -> dict:
    """A seeded synthetic preference pair with an image."""
    rng = np.random.default_rng(1000 + i)

    def words(n):
        return " ".join(f"w{int(x)}" for x in rng.integers(16, 31000, n))

    return {"prompt": f"pair {i}: {words(prompt_words)}", "img_path": f"pair{i}.png",
            "chosen": words(chosen_words), "rejected": words(rejected_words)}


def dpo_args(**kw):
    """The `dpo` CLI's arguments as build_dpo reads them."""
    import argparse

    base = dict(
        lora_r=64, lora_alpha=16.0, lora_dropout=0.0, seed=0, learning_rate=1e-5,
        warmup_ratio=0.2, max_steps=5, lr_scheduler_type="cosine", weight_decay=0.0,
        max_grad_norm=1.0, gradient_accumulation_steps=1, beta=0.1, label_smoothing=0.0,
        loss_type="sigmoid", reference_free=False, precompute_ref_logps=True,
        logits_chunk=256, max_length=1024, per_device_train_batch_size=1, synthetic=0,
        q_lora=False, bits=8, q_lora_vision=False, use_lora=True, lora_target_modules="auto",
        freeze_vision_tower=True, eval_steps=0, eval_ratio=0.005, eval_samples=0,
        save_steps=500, resume_from_checkpoint=None, merge_adapter_after_training=False,
        output_dir=None, logging_steps=1, num_train_epochs=1.0,
    )
    base.update(kw)
    return argparse.Namespace(**base)


def phase_reduced_depth_dpo(bits: int = 0):
    """One DPO loss + backward at full widths, 2 LM / 2 tower layers, the
    same seeded weights and non-zero adapters on the card (bf16, kernels)
    and on the CPU (f32, plain path). bits=4: QLoRA, the LM's attention and
    MLP linears int4 (TRAIN_QUANT_PATTERNS) with the same codes on both
    before the adapters attach, so kernels 6 and 7 run on the card."""
    import dataclasses

    from vlrlhf_torch.cli.main import with_remat_policy
    from vlrlhf_torch.data.collators import CollatorConfig, DPOCollator
    from vlrlhf_torch.lora.lora import LM_ALL_LINEARS, LoraConfig, init_lora, lora_parameters
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    full = with_remat_policy(_llava_7b(torch.float32), "attn")
    cfg32 = dataclasses.replace(
        full,
        lm=dataclasses.replace(full.lm, num_layers=2),
        vision=dataclasses.replace(full.vision, num_layers=2),
    )
    cfg16 = dataclasses.replace(
        cfg32,
        lm=dataclasses.replace(cfg32.lm, dtype=torch.bfloat16),
        vision=dataclasses.replace(cfg32.vision, dtype=torch.bfloat16),
    )
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    gpu = VLM(cfg16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    label = "DPO"
    if bits:
        from vlrlhf_torch.ops.quant import TRAIN_QUANT_PATTERNS

        label = "QLoRA int4 DPO"
        if share_int4(cpu, gpu, TRAIN_QUANT_PATTERNS, f"reduced-depth {label}") != 14:
            raise AssertionError("expected the 14 LM linears of 2 layers int4")
    lcfg = LoraConfig(r=64, alpha=16.0, dropout=0.0, target_patterns=LM_ALL_LINEARS)
    gen = torch.Generator().manual_seed(2)
    init_lora(cpu, lcfg, gen)
    init_lora(gpu, lcfg, torch.Generator(device="cuda").manual_seed(2))
    with torch.no_grad():
        for (name, pc), (_, pg) in zip(lora_parameters(cpu), lora_parameters(gpu)):
            if name.endswith("lora_b"):  # non-zero b: policy != reference
                pc.normal_(0.0, 0.02, generator=gen)
            pg.copy_(pc)
    proc = make_processor(cfg32)
    coll = DPOCollator(proc, CollatorConfig(image_size=336), seeded_image)
    batch = coll([proc.tokenize_row_dpo(pair_row(0, 12, 40, 30))])
    dcfg = DPOConfig(beta=0.1, lora_scale=lcfg.scale, logits_chunk=256)
    ocfg = OptimizerConfig(learning_rate=1e-5)
    loss, grads = {}, {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        state = init_train_state(adapter_params(model), ocfg)
        m = dpo_step(model, dcfg, ocfg, state, batch_to_device(batch, model.device))
        loss[name] = float(m["loss"])
        grads[name] = torch.cat([p.grad.float().flatten().cpu() for p in state.trainable])
    g, r = grads["cuda"], grads["cpu"]
    if not (np.isfinite(loss["cuda"]) and torch.isfinite(g).all()):
        raise AssertionError(f"reduced-depth {label} on the card is not finite")
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    cos = float(torch.dot(g.double(), r.double()) / (g.double().norm() * r.double().norm()))
    print(f"reduced-depth {label} (2 LM / 2 tower layers, full widths, 1 pair of "
          f"{batch['input_ids'].shape[1]} tokens): loss cuda {loss['cuda']:.6f} cpu "
          f"{loss['cpu']:.6f} rel err {rel:.3e} (tol {LOSS_REL_TOL}); LoRA gradient cosine "
          f"{cos:.6f} (min {GRAD_COS_MIN}) over {g.numel()} entries", flush=True)
    if rel > LOSS_REL_TOL:
        raise AssertionError(f"reduced-depth {label} loss differs: rel {rel} > {LOSS_REL_TOL}")
    if cos < GRAD_COS_MIN:
        raise AssertionError(f"reduced-depth {label} LoRA gradients differ: cosine {cos} < "
                             f"{GRAD_COS_MIN}")
    del cpu, gpu
    torch.cuda.empty_cache()


def phase_dpo():
    """Full-width LLaVA-1.5-7B DPO through cli.main.build_dpo."""
    import math
    import statistics

    from vlrlhf_torch.cli.main import build_dpo, with_remat_policy
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from vlrlhf_torch.train.dpo import batch_to_device, make_ref_logps_fn
    from vlrlhf_torch.train.loop import read_metrics

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    cfg = with_remat_policy(_llava_7b(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    args = dpo_args()
    rows = [pair_row(7, 150, 260, 250)]
    run = build_dpo(cfg, model, proc, args, rows, seeded_image)
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    real = batch_np["pad_mask"].sum(1).tolist()  # the 128-token bucket pads them to 1024
    if batch_np["input_ids"].shape[1] != 1024 or min(real) < 960:
        raise AssertionError(f"DPO rows hold {real} real tokens of "
                             f"{batch_np['input_ids'].shape[1]}; want >= 960 of 1024")
    batch = batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    n_adapter = sum(p.numel() for p in run.state.trainable)
    print(f"full-width DPO: LLaVA-1.5-7B bf16 random init + {n_adapter / 1e6:.1f} M LoRA "
          f"params (r{run.lcfg.r}, alpha {run.lcfg.alpha}, {len(run.state.trainable) // 2} "
          f"linears), reference logps precomputed "
          f"({run.rows[0]['ref_chosen_logp']:.3f}, {run.rows[0]['ref_rejected_logp']:.3f}); "
          f"rows of {real} real tokens padded to 1024; set-up {time.perf_counter() - t0:.1f} s; "
          f"{resident / 2**30:.3f} GiB allocated on the card before the model", flush=True)

    counts = (flash_attention, flash_bwd_dkv, flash_bwd_dq)
    for fn in counts:
        fn.launches = 0
    n_steps = 5
    history, snap = [], None
    for i in range(n_steps):
        if i == 1:
            snap = [p.detach().clone() for p in run.state.trainable]
        m = read_metrics(run.step(batch))
        history.append(m)
        if i == 1:
            changed = any(not torch.equal(p, s) for p, s in zip(run.state.trainable, snap))
            if not changed:
                raise AssertionError("the adapters did not change at step 2")
    launches = {"flash_fwd": flash_attention.launches, "flash_bwd_dkv": flash_bwd_dkv.launches,
                "flash_bwd_dq": flash_bwd_dq.launches}
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    print(f"DPO steps 1-{n_steps}: loss {losses}; grad_norm {norms}; launches "
          f"{json.dumps(launches)}", flush=True)
    if abs(losses[0] - math.log(2.0)) > 1e-3:
        raise AssertionError(f"step-1 loss {losses[0]} is not ln 2 within 1e-3")
    if not all(np.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"non-finite loss or zero/non-finite grad norm: {losses} {norms}")
    per_step_fwd = cfg.vision.layers_run + cfg.lm.num_layers  # tower + the LM's recompute
    if launches["flash_bwd_dkv"] < cfg.lm.num_layers * n_steps or \
            launches["flash_bwd_dq"] < cfg.lm.num_layers * n_steps or \
            launches["flash_fwd"] < per_step_fwd * n_steps:
        raise AssertionError(f"too few kernel launches for {n_steps} steps: {launches}")

    # timing: the steps that follow, each ending in a synchronize
    step_ms = []
    for _ in range(6):
        t1 = time.perf_counter()
        m = run.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    if not np.isfinite(read_metrics(m)["loss"]):
        raise AssertionError("DPO loss is not finite in the timed steps")
    peak = torch.cuda.max_memory_allocated()  # before the profiled step
    profile_breakdown(lambda: run.step(batch), "DPO step")
    med = statistics.median(step_ms)
    tokens = int(np.prod(batch_np["input_ids"].shape))
    flops = run.flops_per_token * tokens + run.flops_per_image * batch_np["pixel_values"].shape[0]

    # the CLI default: the reference forward online, adapters off. Its logps
    # match the precomputed ones (same kernels, same base weights; 1e-3
    # relative) and steps with it stay finite
    online = {k: v for k, v in batch.items() if not k.startswith("ref_")}
    c, r = make_ref_logps_fn(model, run.dcfg)(online)
    want = (run.rows[0]["ref_chosen_logp"], run.rows[0]["ref_rejected_logp"])
    got = (float(c[0]), float(r[0]))
    online_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        m = read_metrics(run.step(online))  # the read synchronizes
        online_ms.append((time.perf_counter() - t1) * 1e3)
    print(f"online reference: logps {got} vs precomputed {want}; 3 steps "
          f"{[round(x, 3) for x in online_ms]} ms, last loss {m['loss']:.6g} grad_norm "
          f"{m['grad_norm']:.6g}", flush=True)
    if any(abs(g - w) > 1e-3 * max(1.0, abs(w)) for g, w in zip(got, want)):
        raise AssertionError(f"online reference logps {got} differ from the precomputed {want}")
    if not (np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"])):
        raise AssertionError("online-reference DPO step is not finite")
    print(f"DPO step (1 pair, seq 1024, attn remat, logits_chunk 256, precomputed ref): "
          f"median {med:.3f} ms over {len(step_ms)} steps {[round(x, 3) for x in step_ms]}; "
          f"{1e3 / med:.4f} pairs/s; MFU {flops / (med * 1e-3) / PEAK_FLOPS:.4f} "
          f"({flops / 1e12:.3f} TFLOP per step, train/flops.py); peak memory "
          f"{peak / 2**30:.3f} GiB", flush=True)
    del run, model, batch
    torch.cuda.empty_cache()
    return launches, {"median_ms": med, "pairs_per_s": 1e3 / med,
                      "mfu": flops / (med * 1e-3) / PEAK_FLOPS, "peak_gib": peak / 2**30}


def phase_dpo_qlora4(bf16: dict) -> dict:
    """Full-width LLaVA-1.5-7B QLoRA DPO through cli.main.build_dpo with
    --q_lora true --bits 4 at phase 6's shape: the bf16 model's 224 LM
    linears go int4 in place before the adapters attach (lm_head stays
    bf16). 3 steps with step-1 loss ln 2, finite norms and adapters that
    change at step 2, and their launch counts (kernel 6 in the forward and
    its recompute, kernel 7 in the backward); then step ms, pairs/s, MFU
    and peak memory beside phase 6's, and one profiled step."""
    import math
    import statistics

    from vlrlhf_torch.cli.main import build_dpo, with_remat_policy
    from vlrlhf_torch.models.common import Linear, init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    import tempfile

    from vlrlhf_torch.ops.int4 import dequantize_int4, int4_matmul, int4_matmul_t
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.loop import read_metrics

    torch.cuda.reset_peak_memory_stats()
    cfg = with_remat_policy(_llava_7b(torch.bfloat16), "attn")
    t0 = time.perf_counter()
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    run = build_dpo(cfg, model, proc, dpo_args(q_lora=True, bits=4, max_steps=3),
                    [pair_row(7, 150, 260, 250)], seeded_image)
    n4 = sum(1 for m in model.modules() if isinstance(m, Linear) and m.weight_q4 is not None)
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    batch = batch_to_device(batch_np, "cuda")
    torch.cuda.synchronize()
    print(f"full-width QLoRA DPO: {n4} LM linears int4 (lm_head bf16), weights "
          f"{weights / 2**30:.3f} GiB with the adapters, set-up {time.perf_counter() - t0:.1f} s; "
          f"rows of {batch_np['pad_mask'].sum(1).tolist()} real tokens padded to "
          f"{batch_np['input_ids'].shape[1]}", flush=True)
    if n4 != 7 * cfg.lm.num_layers:
        raise AssertionError(f"expected 224 int4 LM linears, got {n4}")

    counted = {"flash_fwd": flash_attention, "flash_bwd_dkv": flash_bwd_dkv,
               "flash_bwd_dq": flash_bwd_dq, "int4_matmul": int4_matmul,
               "int4_matmul_t": int4_matmul_t}
    for fn in counted.values():
        fn.launches = 0
    history, snap = [], None
    for i in range(3):
        if i == 1:
            snap = [p.detach().clone() for p in run.state.trainable]
        history.append(read_metrics(run.step(batch)))
        if i == 1 and all(torch.equal(p, q) for p, q in zip(run.state.trainable, snap)):
            raise AssertionError("the adapters did not change at step 2")
    launches = {name: fn.launches for name, fn in counted.items()}
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    print(f"QLoRA int4 DPO steps 1-3: loss {losses}; grad_norm {norms}; launches "
          f"{json.dumps(launches)}", flush=True)
    if abs(losses[0] - math.log(2.0)) > 1e-3:
        raise AssertionError(f"QLoRA step-1 loss {losses[0]} is not ln 2 within 1e-3")
    if not all(np.isfinite(x) for x in losses + norms) or min(norms) <= 0:
        raise AssertionError(f"non-finite loss or zero/non-finite grad norm: {losses} {norms}")
    if launches["int4_matmul"] < 3 * n4 or launches["int4_matmul_t"] <= 0:
        raise AssertionError(f"too few int4 launches for 3 steps: {launches}")

    step_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        m = run.step(batch)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    if not np.isfinite(read_metrics(m)["loss"]):
        raise AssertionError("QLoRA DPO loss is not finite in the timed steps")
    peak = torch.cuda.max_memory_allocated()
    profile_breakdown(lambda: run.step(batch), "QLoRA int4 DPO step")
    med = statistics.median(step_ms)
    tokens = int(np.prod(batch_np["input_ids"].shape))
    flops = run.flops_per_token * tokens + run.flops_per_image * batch_np["pixel_values"].shape[0]
    print(f"QLoRA int4 DPO step (phase 6's shape): median {med:.3f} ms over 3 steps "
          f"{[round(x, 3) for x in step_ms]}; {1e3 / med:.4f} pairs/s; MFU "
          f"{flops / (med * 1e-3) / PEAK_FLOPS:.4f}; peak memory {peak / 2**30:.3f} GiB "
          f"(the bf16 model before its in-place quantization included) | bf16 DPO (phase 6): "
          f"median {bf16['median_ms']:.3f} ms, {bf16['pairs_per_s']:.4f} pairs/s, MFU "
          f"{bf16['mfu']:.4f}, peak {bf16['peak_gib']:.3f} GiB", flush=True)

    # the merged save over the int4 base: W is the dequantized q * s (no gbias
    # in a base quantized here), rounded to bf16 as dequantize_params does
    names = ("lm.layers.0.wq", f"lm.layers.{cfg.lm.num_layers - 1}.down")
    dense = {}
    for n in names:
        lin = model.get_submodule(n)
        if lin.weight_gbias is not None:
            raise AssertionError(f"{n}: an int4 base quantized here holds no gbias")
        dense[n] = dequantize_int4(lin.weight_q4, lin.weight_scale4,
                                   torch.float32).to(torch.bfloat16)
    want = sampled_merges(model, run.lcfg.scale, names, dense)
    with tempfile.TemporaryDirectory() as tmp:
        finish_timed(run, dpo_args(q_lora=True, bits=4, merge_adapter_after_training=True,
                                   output_dir=tmp), want, "phase 7e merge over int4 (6b's run)")
    del run, model, batch
    torch.cuda.empty_cache()
    return launches


TOWER_TARGETS = ("lm/.*attn/(wq|wk|wv|wo)/,lm/.*mlp/(gate|up|down)/,"
                 "vision/.*attn/(wq|wk|wv|wo)/")


def drop_adapters(model) -> None:
    """Detach every LoRA adapter, so the next build_dpo starts clean."""
    from vlrlhf_torch.models.common import Linear

    for m in model.modules():
        if isinstance(m, Linear):
            m.lora_a = m.lora_b = None


def timed_steps(run, batch, n: int):
    """n steps on one batch, each ending in a synchronize: (metrics, ms)."""
    from vlrlhf_torch.train.loop import read_metrics

    hist, ms = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        hist.append(read_metrics(run.step(batch)))  # the read synchronizes
        ms.append((time.perf_counter() - t0) * 1e3)
    return hist, ms


def merged_check(path: str, sampled: dict, what: str) -> None:
    """The saved merged weights of the sampled linears equal the expected
    W + scale (A B)^T, bit for bit (the same expression on the same card)."""
    from vlrlhf_torch.train.checkpoint import load_params

    merged = load_params(path, mmap=True)
    for name, want in sampled.items():
        got = merged[f"{name}.weight"].to("cuda")
        if not torch.equal(got, want):
            err = float((got.float() - want.float()).abs().max())
            raise AssertionError(f"{what}: merged {name} differs from W + s (A B)^T by {err}")
    print(f"{what}: merged weights in {path} ({len(merged)} tensors) equal W + s (A B)^T on "
          f"{', '.join(sampled)}", flush=True)


def sampled_merges(model, scale: float, names, dense: dict) -> dict:
    """W + scale (A B)^T in W's dtype for the named linears; `dense` gives
    each one's W (its dense weight, or its int4 weight dequantized to bf16)."""
    out = {}
    for name in names:
        lin = model.get_submodule(name)
        delta = (lin.lora_a.float() @ lin.lora_b.float()) * scale
        out[name] = (dense[name].float() + delta.T).to(dense[name].dtype)
    return out


def forward_memory(run, batch) -> dict:
    """GiB the policy forward (adapters on) leaves allocated for its
    backward ("kept"), and the peaks of that forward and of the backward
    above what each found: the part of the step the remat policy sets."""
    from vlrlhf_torch.models.common import Ctx
    from vlrlhf_torch.train.dpo import forward_logps, pair_image_features

    feats = pair_image_features(run.model, batch)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logps, _ = forward_logps(run.model, run.dcfg, batch, Ctx(True, run.dcfg.lora_scale), feats)
    kept = torch.cuda.memory_allocated() - base
    fwd_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    after_fwd = torch.cuda.memory_allocated()
    logps.sum().backward()
    bwd_peak = torch.cuda.max_memory_allocated() - after_fwd
    for p in run.state.trainable:
        p.grad = None
    return {"kept": kept / 2**30, "fwd_peak": fwd_peak / 2**30, "bwd_peak": bwd_peak / 2**30}


def finish_timed(run, args, want: dict, what: str) -> None:
    """cli.main.finish_dpo (adapters and merged weights), timed, then the
    merged file checked on the sampled linears."""
    from vlrlhf_torch.cli.main import finish_dpo

    t0 = time.perf_counter()
    finish_dpo(run, args)
    ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(args.output_dir, "merged")
    size = os.path.getsize(os.path.join(path, "params.pt"))
    print(f"{what}: finish_dpo {ms:.3f} ms, merged file {size / 2**30:.3f} GiB", flush=True)
    merged_check(path, want, what)


def trainer_model():
    """Phase 7's model: LLaVA-1.5-7B at full width and depth, bf16, random
    weights from seed 0, on the card; (cfg, model, processor)."""
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    return cfg, model, make_processor(cfg)


def host_grads(run) -> list:
    """This step's gradient of every trainable leaf, f32 on the host (a
    leaf that got none counts as zeros)."""
    return [(p.grad if p.grad is not None else torch.zeros_like(p)).to("cpu", torch.float32,
                                                                        copy=True)
            for p in run.state.trainable]


def worst_leaf_gap(got: list, want: list) -> tuple[float, int]:
    """The largest relative L2 difference |g - w| / |w| over gradient
    leaves, and its leaf's index (a leaf whose w is zero counts 0 if g is
    zero too, else inf)."""
    worst, at = 0.0, -1
    for i, (g, w) in enumerate(zip(got, want)):
        wn, dn = float(w.norm()), float((g - w).norm())
        gap = dn / wn if wn > 0 else (0.0 if dn == 0 else math.inf)
        if gap > worst:
            worst, at = gap, i
    return worst, at


# the worst leaf's relative L2 gradient difference a remat policy may show
# against attn's from the same state, at phase 7a's bf16 shape: about twice
# the largest seen on an H100 (mlp1 0.0229, mlp and acts 0.017; full and
# dots 0), far below a dropped (1) or mis-signed (2) leaf
LEAF_GAP_BOUND = 5e-2


def trainer_remat(cfg, model, proc):
    """Phase 7a: 3 DPO steps under each remat policy, every step from
    attn's state before it (the same adapters, moments, batch and seed), so
    the comparison holds remat alone, not Adam's amplification of bf16
    rounding along a trajectory (its first updates are sign(g) * lr on
    every entry). Each step's loss, and each leaf's gradient, must agree
    with attn's; the forward / backward peaks must be ordered as the
    policies keep more. Returns (per-policy results, the device batch)."""
    import dataclasses
    import statistics

    from vlrlhf_torch.cli.main import build_dpo
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.train_state import load_state_tree_

    def set_policy(policy):
        model.lm.cfg = dataclasses.replace(model.lm.cfg, remat_policy=policy)

    run = build_dpo(cfg, model, proc, dpo_args(max_steps=3), [pair_row(7, 150, 260, 250)],
                    seeded_image)
    batch_np = run.collator([run.tokenize_fn(r) for r in run.rows])
    real = batch_np["pad_mask"].sum(1).tolist()
    batch = batch_to_device(batch_np, "cuda")
    states, ref_grads, res = [], [], {}
    for policy in ("attn", "full", "dots", "mlp", "mlp1", "acts"):
        set_policy(policy)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        hist, ms, gaps = [], [], []
        for k in range(3):
            if policy == "attn":  # held on the host: the card's peaks stay the step's
                states.append({g: {n: t.to("cpu", copy=True) for n, t in v.items()}
                               if isinstance(v, dict) else v
                               for g, v in run.state_tree().items()})
            else:
                load_state_tree_(run.state, run.keys, states[k])
            h, t = timed_steps(run, batch, 1)
            hist += h
            ms += t
            if policy == "attn":
                ref_grads.append(host_grads(run))
            else:
                gaps.append(worst_leaf_gap(host_grads(run), ref_grads[k]))
        peak = torch.cuda.max_memory_allocated() / 2**30
        ms += timed_steps(run, batch, 3)[1]  # 3 more, timed only
        mem = forward_memory(run, batch)
        gap, at = max(gaps, default=(0.0, -1))
        res[policy] = {"loss": [h["loss"] for h in hist], "norm": [h["grad_norm"] for h in hist],
                       "leaf_gaps": [g for g, _ in gaps], "leaf_gap": gap,
                       "leaf": run.keys[at] if at >= 0 else None,
                       "ms": statistics.median(ms), "peak": peak, **mem,
                       "fb_peak": max(mem["fwd_peak"], mem["kept"] + mem["bwd_peak"])}
        print(f"remat {policy}: loss {res[policy]['loss']}; grad_norm {res[policy]['norm']}; "
              f"worst leaf's relative L2 gradient gap to attn per step {res[policy]['leaf_gaps']} "
              f"({res[policy]['leaf']}); "
              f"step ms {[round(x, 3) for x in ms]} (median {res[policy]['ms']:.3f}); step peak "
              f"{peak:.3f} GiB; the policy forward keeps {mem['kept']:.3f} GiB for the backward "
              f"(forward peak +{mem['fwd_peak']:.3f}, backward peak +{mem['bwd_peak']:.3f} over "
              f"what the forward left; forward / backward peak +{res[policy]['fb_peak']:.3f})",
              flush=True)
        res[policy]["busy"] = profile_breakdown(lambda: run.step(batch),
                                                f"DPO step, {policy} remat")
    ref = res["attn"]
    for policy, r in res.items():
        if abs(r["loss"][0] - math.log(2.0)) > 1e-3:
            raise AssertionError(f"remat {policy}: step-1 loss {r['loss'][0]} is not ln 2")
        for a, b in zip(r["loss"], ref["loss"]):
            if abs(a - b) > 1e-3 * abs(b):
                raise AssertionError(f"remat {policy}: loss {r['loss']} vs attn {ref['loss']}")
        for a, b in zip(r["norm"], ref["norm"]):
            if not (np.isfinite(a) and abs(a - b) <= 1e-2 * abs(b)):
                raise AssertionError(f"remat {policy}: grad_norm {r['norm']} vs attn "
                                     f"{ref['norm']}")
        if not r["leaf_gap"] <= LEAF_GAP_BOUND:
            raise AssertionError(f"remat {policy}: leaf {r['leaf']}'s gradient differs from "
                                 f"attn's by {r['leaf_gap']} (relative L2), bound "
                                 f"{LEAF_GAP_BOUND}")
    # the peak a policy sets is its forward / backward's; the step's own
    # peak can sit in the AdamW update (temporaries the size of 2 adapter
    # copies), the same under every policy that keeps less than that
    order = ("full", "attn", "mlp1", "mlp", "acts")
    peaks = [res[p]["fb_peak"] for p in order]
    if peaks != sorted(peaks):
        raise AssertionError(f"forward / backward peaks are not ordered {' <= '.join(order)}: "
                             f"{peaks}")
    print(f"phase 7a remat policies (rows of {real} real tokens padded to 1024): loss within "
          f"1e-3, grad norm within 1e-2 and every leaf's gradient within {LEAF_GAP_BOUND} "
          f"(relative L2) of attn's from the same states, step-1 ln 2, "
          f"forward / backward peaks ordered {' <= '.join(order)}: " + json.dumps(
              {p: {"median_ms": round(r["ms"], 3), "busy_ms": r["busy"] and round(r["busy"], 3),
                   "step_peak_gib": round(r["peak"], 3), "kept_gib": round(r["kept"], 3),
                   "fwd_bwd_peak_gib": round(r["fb_peak"], 3),
                   "worst_leaf_gap": r["leaf_gap"]} for p, r in res.items()}),
          flush=True)
    set_policy("attn")
    return res, batch


def phase_trainer():
    """Phase 7: the `dpo` trainer's functions at full LLaVA-1.5-7B width and
    depth on phase 6's pair (bf16): (a) the remat policies, (b) an unfrozen
    tower with tower LoRA targets, (c) the eval pass and its samples, (d)
    checkpoint, resume and the straight run they must equal, (e) the merged
    save. Returns the kernel launch counts of the phase."""
    import statistics
    import tempfile

    from vlrlhf_torch.cli.main import build_dpo, make_eval_hook, train_dpo
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention, flash_bwd_dkv, flash_bwd_dq
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.metrics import MetricsLogger
    from vlrlhf_torch.train.train_state import load_state_tree_

    cfg, model, proc = trainer_model()
    counted = {"flash_fwd": flash_attention, "flash_bwd_dkv": flash_bwd_dkv,
               "flash_bwd_dq": flash_bwd_dq, "decode_attention": decode_attention}
    for fn in counted.values():
        fn.launches = 0

    # (a) every remat policy from the same states
    res, batch = trainer_remat(cfg, model, proc)

    # (b) unfrozen tower, LoRA on the LM's 7 linears and the tower's 4
    drop_adapters(model)
    run = build_dpo(cfg, model, proc, dpo_args(max_steps=3, freeze_vision_tower=False,
                                               lora_target_modules=TOWER_TARGETS),
                    [pair_row(7, 150, 260, 250)], seeded_image)
    tower = [(n, p) for n, p in model.named_parameters()
             if n.startswith("vision.layers.") and "lora_" in n
             and int(n.split(".")[2]) < cfg.vision.layers_run]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bwd0 = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    hist, ms = [], []
    for i in range(3):
        h, t = timed_steps(run, batch, 1)
        hist += h
        ms += t
        if i >= 1 and not all(p.grad is not None and bool(p.grad.any()) for _, p in tower):
            raise AssertionError(f"unfrozen tower: a tower adapter has no gradient at step {i + 1}")
    bwd = (flash_bwd_dkv.launches - bwd0[0], flash_bwd_dq.launches - bwd0[1])
    losses = [h["loss"] for h in hist]
    peak = torch.cuda.max_memory_allocated() / 2**30
    if abs(losses[0] - math.log(2.0)) > 1e-3 or not all(np.isfinite(losses)):
        raise AssertionError(f"unfrozen tower: losses {losses}")
    want = 3 * (cfg.lm.num_layers + cfg.vision.layers_run)
    if min(bwd) < want:
        raise AssertionError(f"unfrozen tower: {bwd} dK/dV, dQ launches in 3 steps, want {want}")
    print(f"phase 7b unfrozen tower ({len(tower)} tower adapter leaves of {cfg.vision.layers_run} "
          f"layers, all with non-zero gradients at steps 2-3): loss {losses}; grad_norm "
          f"{[h['grad_norm'] for h in hist]}; step ms {[round(x, 3) for x in ms]} (median "
          f"{statistics.median(ms):.3f}; attn remat frozen tower {res['attn']['ms']:.3f}); "
          f"peak {peak:.3f} GiB; flash backward launches (dK/dV, dQ) {bwd}", flush=True)
    profile_breakdown(lambda: run.step(batch), "unfrozen-tower DPO step")

    with tempfile.TemporaryDirectory() as tmp:
        # (c) the eval pass and its samples: 16 pairs, 2 held out
        drop_adapters(model)
        rows = [pair_row(300 + i, 150, 260, 250) for i in range(16)]
        args = dpo_args(max_steps=2, eval_steps=2, eval_ratio=0.125, eval_samples=2,
                        output_dir=os.path.join(tmp, "eval"))
        run = build_dpo(cfg, model, proc, args, rows, seeded_image)
        logger = MetricsLogger(args.output_dir, "dpo")
        dec0 = decode_attention.launches
        make_eval_hook(run, proc, args, logger)(0)  # adapters still zero
        dec = decode_attention.launches - dec0
        train_dpo(run, proc, args, logger)
        logger.close()
        lines = [json.loads(x) for x in open(logger.path).read().splitlines()]
        evals = {r["step"]: r for r in lines if "eval/loss" in r}
        samples = [json.loads(x) for x in
                   open(os.path.join(args.output_dir, "dpo_samples.jsonl")).read().splitlines()]
        at0 = [x for x in samples if x["step"] == 0]
        if sorted(evals) != [0, 2] or not all(np.isfinite(v) for r in evals.values()
                                              for v in r.values()):
            raise AssertionError(f"eval lines: {evals}")
        if len(at0) != 2 or any(x["policy"] != x["ref"] or not x["policy"] for x in at0):
            raise AssertionError(f"step-0 policy and reference samples differ: {at0}")
        if dec < 2 * cfg.lm.num_layers or len(samples) != 4:
            raise AssertionError(f"eval samples: {dec} decode launches, {len(samples)} samples")
        print(f"phase 7c eval ({len(run.eval_rows)} of 16 pairs held out): eval/* at steps 0 "
              f"and 2 {json.dumps({k: {m: round(v, 6) for m, v in r.items() if m != 'step'} for k, r in evals.items()})}; "
              f"step-0 policy == reference samples ({len(at0[0]['policy'].split())} and "
              f"{len(at0[1]['policy'].split())} words); {dec} decode launches at step 0",
              flush=True)

        # (d) 4 steps straight; 2 steps + a checkpoint, a resume, 2 more
        def leg(out, epochs, **kw):
            drop_adapters(model)
            a = dpo_args(max_steps=4, num_train_epochs=epochs, lora_dropout=0.05,
                         output_dir=os.path.join(tmp, out), **kw)
            r = build_dpo(cfg, model, proc, a, [pair_row(7, 150, 260, 250)], seeded_image)
            lg = MetricsLogger(a.output_dir, "dpo")
            last = train_dpo(r, proc, a, lg)
            lg.close()
            losses = {x["step"]: x["loss"] for x in map(json.loads, open(lg.path))}
            return r, a, last, losses

        _, _, _, straight = leg("straight", 100)
        first, a1, last, _ = leg("resumed", 2, save_steps=2)
        ck = os.path.join(tmp, "resumed", "checkpoints")
        nbytes = os.path.getsize(os.path.join(ck, "2", "state.pt"))
        mgr = CheckpointManager(os.path.join(tmp, "timing"))
        t0 = time.perf_counter()
        mgr.save(2, first.state_tree())
        mgr.wait()
        save_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        tree, _ = mgr.restore(2)
        load_state_tree_(first.state, first.keys, tree)
        torch.cuda.synchronize()
        restore_ms = (time.perf_counter() - t0) * 1e3
        del tree
        resumed, a2, last2, losses = leg("resumed", 100, resume_from_checkpoint="auto",
                                         merge_adapter_after_training=True)
        if last != 2 or last2 != 4 or sorted(os.listdir(ck)) != ["2"]:
            raise AssertionError(f"save / resume: legs ended at {last}, {last2}; "
                                 f"checkpoints {os.listdir(ck)}")
        for step in (3, 4):
            if abs(losses[step] - straight[step]) > 1e-3 * abs(straight[step]):
                raise AssertionError(f"resumed step {step} loss {losses[step]} vs straight "
                                     f"{straight[step]}")
        print(f"phase 7d save / resume: straight losses {straight}; resumed "
              f"{ {k: losses[k] for k in (3, 4)} } (within 1e-3); checkpoint "
              f"{nbytes / 2**20:.3f} MiB ({len(first.keys)} adapter leaves with their moments), "
              f"save {save_ms:.3f} ms (host copy and write), restore {restore_ms:.3f} ms",
              flush=True)

        # (e) the merged save of the resumed run
        n_layers = cfg.lm.num_layers
        names = ("lm.layers.0.wq", f"lm.layers.{n_layers // 2}.gate",
                 f"lm.layers.{n_layers - 1}.down")
        want = sampled_merges(model, resumed.lcfg.scale, names,
                              {n: model.get_submodule(n).weight for n in names})
        finish_timed(resumed, a2, want, "phase 7e merge")
    launches = {name: fn.launches for name, fn in counted.items()}
    print(f"phase 7 launches {json.dumps(launches)}", flush=True)
    del run, model, batch
    return launches


EVAL_SLOTS = 8  # phase 8: the continuous path's slots (the static batch is 16)
EVAL_NEW = 16  # phase 8: new tokens per row


def eval_image(path, size, mode="shortest_edge_crop"):
    """Image loader for eval rows: the file name names a seed (each run
    decodes its TSV into a directory of its own)."""
    return seeded_image(os.path.basename(str(path)), size, mode)


def write_eval_data(tmp: str) -> tuple[str, str]:
    """An MME-shaped TSV (32 yes/no rows over 16 images; an image's second
    row names the first's index, as MME's TSV does) and a SEEDBench json
    (16 questions x 4 choices). The images are seeded blobs that
    `eval_image` maps to pixels by file name."""
    import base64

    rng = np.random.default_rng(8)
    cats = ("existence", "count", "position", "color", "OCR", "commonsense_reasoning")
    mme = os.path.join(tmp, "mme.tsv")
    with open(mme, "w") as f:
        f.write("index\timage\tquestion\tanswer\tcategory\n")
        for i in range(16):
            blob = base64.b64encode(rng.integers(0, 256, 96, dtype=np.uint8).tobytes()).decode()
            for j in range(2):
                q = (f"Is there a w{100 + i} {('red', 'blue')[j]} object in the image? "
                     "Please answer yes or no.")
                f.write(f"{i}-{j}\t{blob if j == 0 else f'{i}-0'}\t{q}\t"
                        f"{('Yes', 'No')[(i + j) % 2]}\t{cats[i % len(cats)]}\n")
    seed = os.path.join(tmp, "seed.json")
    with open(seed, "w") as f:
        json.dump({"questions": [
            {"question_id": f"q{i}", "question": f"What does the picture w{200 + i} show?",
             "choice_a": f"a dog w{i}", "choice_b": "a cat on a mat", "choice_c": "two birds",
             "choice_d": f"a fish in water w{3 * i}", "answer": "ABCD"[i % 4],
             "data_id": f"seed{i}.jpg", "question_type_id": 1 + i % 9} for i in range(16)]}, f)
    return mme, seed


def eval_args(**kw):
    """`eval`'s arguments as build_eval / run_eval read them: batch 16,
    EVAL_NEW new tokens, greedy."""
    import argparse

    base = dict(benchmark="mme", data_file="", image_root="", output_dir="", sqlite_db=None,
                tag="phase8", max_new_tokens=EVAL_NEW, per_device_train_batch_size=16,
                quantize="false", fuse_decode=False, kv_cache_dtype="bf16",
                continuous_batching=False, speculative_k=0, do_sample=False, temperature=1.0,
                top_k=None, top_p=None, synthetic=0, seed=0)
    base.update(kw)
    return argparse.Namespace(**base)


def record_tokens(runner, eos: set) -> list:
    """Wrap runner._decode so each row's generated ids, cut at the first
    stop token, are appended (in row order) to the returned list."""
    seen: list = []
    decode = runner._decode

    def wrapped(toks):
        ids = [int(t) for t in toks]
        cut = next((i for i, t in enumerate(ids) if t in eos), len(ids))
        seen.append(ids[:cut])
        return decode(toks)

    runner._decode = wrapped
    return seen


def divergence(ref: list, got: list, eos: int):
    """(position, ref token, got token) where two token lists first differ
    (past the shorter's end its token is the stop token), or None."""
    for j in range(max(len(ref), len(got))):
        a = ref[j] if j < len(ref) else eos
        b = got[j] if j < len(got) else eos
        if a != b:
            return j, a, b
    return None


def tie_or_raise(what: str, model, proc, ids: list, img, ref: list, got: list, eos: int,
                 ctx=None):
    """None when `got` equals `ref`. Else the first divergence must be a
    top-2 tie of `model`'s teacher-forced logits after ref's common
    prefix (under `ctx`'s adapters): both tokens are its top two and their
    gap is within LOGIT_REL_TOL of the largest |logit|. Returns (position,
    ref token, got token, gap)."""
    from vlrlhf_torch.data.collators import CollatorConfig, GenerationCollator
    from vlrlhf_torch.generate.engine import GenerateConfig, batch_to_device, prefill

    d = divergence(ref, got, eos)
    if d is None:
        return None
    j, a, b = d
    coll = GenerationCollator(proc, CollatorConfig(image_size=model.cfg.vision.image_size),
                              eval_image)
    t = batch_to_device(coll([{"input_ids": list(ids) + list(ref[:j]), "img_path": img}]),
                        model.device)
    with torch.inference_mode():
        *_, last = prefill(model, GenerateConfig(max_new_tokens=1, pad_token_id=-1),
                           t["input_ids"].shape[1], t["input_ids"], t["pad_mask"],
                           t["prompt_lens"], t["pixel_values"], t["image_positions"], None, ctx)
    logits = last[0].float().cpu()
    top2 = torch.topk(logits, 2)
    gap = float((logits[a] - logits[b]).abs())
    limit = LOGIT_REL_TOL * float(logits.abs().max())
    if {a, b} != set(top2.indices.tolist()) or gap > limit:
        raise AssertionError(f"{what}: diverges at {j} ({a} vs {b}) and it is no top-2 tie: "
                             f"top-2 {top2.indices.tolist()} {top2.values.tolist()}, gap {gap} "
                             f"(limit {limit})")
    return j, a, b, round(gap, 5)


def text_ids(text: str) -> list:
    """The ids of a ToyTokenizer text (it prints id i >= 16 as "w<i>" and
    drops the specials and reserved ids below 16)."""
    return [int(w[1:]) for w in text.split()]


def visible(ids: list) -> list:
    return [t for t in ids if t >= 16]


def adapter_set(model, seed: int) -> dict:
    """A LoRA r64 set on the LM's 7 linears, keyed as a dpo run's adapters
    file: a ~ N(0, 1/r), b ~ N(0, 0.01^2), so its delta moves the tokens."""
    from vlrlhf_torch.lora.lora import LM_ALL_LINEARS, match_lora_targets, module_path

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for name, mod in match_lora_targets(model, LM_ALL_LINEARS):
        key = module_path(name)[: -len("/kernel")]
        out[f"{key}/a"] = torch.randn((mod.d_in, 64), generator=gen, device="cuda") / 8.0
        out[f"{key}/b"] = 0.01 * torch.randn((64, mod.d_out), generator=gen, device="cuda")
    return out


def phase_eval():
    """Phase 8: `eval` and the serving leftovers at full LLaVA-1.5-7B width
    and depth (seeded random bf16 weights), then the harness at reduced
    depth against the CPU. Returns the launch counts of (a) + (b), the
    "eval" path, and of (c)'s servers, "serve_adapters"; tie checks and
    reference runs are not counted."""
    import tempfile
    from contextlib import nullcontext

    from vlrlhf_torch.cli.main import build_eval, build_server, collator_config, main, run_eval
    from vlrlhf_torch.data.processor import make_single_turn_conv
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.server import EndpointRunner, RequestBuilder
    from vlrlhf_torch.lora.lora import lend_adapters
    from vlrlhf_torch.models.common import Ctx, init_random_
    from vlrlhf_torch.models.config import FAMILIES, _llava_7b
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.ops.chunk_attention import chunk_attention
    from vlrlhf_torch.ops.decode_attention import decode_attention
    from vlrlhf_torch.ops.flash_attention import flash_attention
    from vlrlhf_torch.train.checkpoint import save_params

    counted = {"flash_fwd": flash_attention, "decode_attention": decode_attention,
               "chunk_attention": chunk_attention}

    def reset():
        for fn in counted.values():
            fn.launches = 0

    def read():
        return {name: fn.launches for name, fn in counted.items()}

    cfg = _llava_7b(torch.bfloat16)
    model = VLM(cfg, "cuda")
    init_random_(model, torch.Generator(device="cuda").manual_seed(0))
    proc = make_processor(cfg)
    family = FAMILIES[cfg.family]
    with tempfile.TemporaryDirectory() as tmp:
        mme, seed = write_eval_data(tmp)
        # (a) generation paths, (b) CE ranking: the "eval" path's launches
        reset()
        paths = {"static": {}, "continuous": dict(continuous_batching=True,
                                                  per_device_train_batch_size=EVAL_SLOTS),
                 "speculative": dict(speculative_k=3)}
        toks, texts, prompts = {}, {}, None
        for name, kw in paths.items():
            args = eval_args(data_file=mme, output_dir=os.path.join(tmp, name), **kw)
            runner = build_eval(cfg, model, proc, args, eval_image)
            eos = set(runner.gen_cfg.eos_token_ids)
            toks[name] = record_tokens(runner, eos)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = run_eval(runner, args, progress=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            with open(os.path.join(tmp, name, "mme.json")) as f:
                rows = json.load(f)
            texts[name] = [r["response"] for r in rows]
            if prompts is None:
                prompts = [runner._prompt_row(r["question"], os.path.basename(r["img"]))
                           for r in rows]
            n_tok = sum(len(t) for t in toks[name])
            extra = ""
            if name == "speculative":
                g = runner._gen
                extra = (f"; verify_calls {g.verify_calls}, {g.verify_rows} row verifies, "
                         f"{g.verify_tokens / max(g.verify_rows, 1):.3f} tokens per row "
                         f"verify (K=3)")
            print(f"phase 8a eval mme {name} ({len(rows)} rows, "
                  f"{'8 slots' if name == 'continuous' else 'batch 16'}, {EVAL_NEW} new "
                  f"tokens): {len(rows) / wall:.3f} images/s ({wall:.3f} s, {n_tok} tokens)"
                  f"{extra}; metrics {json.dumps(metrics)}", flush=True)
            if len(rows) != 32 or any(len(t) == 0 for t in toks[name]):
                raise AssertionError(f"eval {name}: {len(rows)} rows, empty responses")
        stop = runner.gen_cfg.eos_token_ids[-1]
        args = eval_args(benchmark="seedbench", data_file=seed, output_dir=os.path.join(tmp, "ce"))
        runner = build_eval(cfg, model, proc, args, eval_image)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = run_eval(runner, args, progress=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "ce", "seedbench.json")) as f:
            ce_rows = json.load(f)
        ppl = np.asarray([r["ppl"] for r in ce_rows])
        print(f"phase 8b CE ranking (seedbench, {len(ce_rows)} rows in batches of 16): "
              f"{len(ce_rows) / wall:.3f} rows/s ({wall:.3f} s); ppl min {ppl.min():.4f} max "
              f"{ppl.max():.4f}; metrics {json.dumps(metrics)}", flush=True)
        if len(ce_rows) != 64 or not np.isfinite(ppl).all():
            raise AssertionError(f"CE ranking: {len(ce_rows)} rows, finite {np.isfinite(ppl).all()}")
        eval_launches = read()
        print(f"phase 8 eval path launches {json.dumps(eval_launches)}", flush=True)
        # the checks below run teacher-forced prefills: after the count
        for name in ("continuous", "speculative"):
            ties = [(i, tie) for i, (p, r, g) in enumerate(zip(prompts, toks["static"],
                                                                 toks[name]))
                    if (tie := tie_or_raise(f"eval {name} row {i}", model, proc,
                                            p["input_ids"], p["img_path"], r, g, stop))]
            print(f"phase 8a {name} vs static: {32 - len(ties)}/32 rows token-identical; "
                  f"divergences (row, (position, static, {name}, gap)) {ties}, all top-2 ties",
                  flush=True)

        # (c) multi-adapter serving, /score, eval --endpoint, the fused layout;
        # the "serve_adapters" path counts what the servers launch, from
        # build to stop, and not the reference engines and tie checks
        adapter_launches = dict.fromkeys(counted, 0)
        sets = {"a": adapter_set(model, 11), "b": adapter_set(model, 12)}
        specs = []
        for name, tree in sets.items():
            save_params(os.path.join(tmp, name, "adapters"), tree)
            specs.append(f"{name}={os.path.join(tmp, name, 'adapters')}")
        questions = [(f"request {i}: what does this image show? answer in detail",
                      f"ad{i}.png", ("a", "b", None)[i % 3]) for i in range(8)]
        http = {}
        for fused in (False, True):
            sargs = serve_args(adapter=specs, lora_r=64, lora_alpha=16.0,
                               max_new_tokens=EVAL_NEW, fuse_decode=fused)
            reset()
            httpd, srv = build_server(cfg, model, proc, sargs, eval_image)
            thread = threading.Thread(target=httpd.serve_forever, daemon=True)
            thread.start()
            url = f"http://127.0.0.1:{httpd.server_address[1]}"
            try:
                bodies = [dict({"question": q, "image": img, "max_new_tokens": EVAL_NEW},
                               **({"adapter": a} if a else {})) for q, img, a in questions]
                t0 = time.perf_counter()
                http[fused] = [text_ids(r["text"]) for r in
                               post_concurrently(url + "/generate", bodies)]
                wall = time.perf_counter() - t0
                print(f"phase 8c {'fused' if fused else 'unfused'} multi-adapter serve: 8 "
                      f"/generate requests over a, b and the base model in {wall:.3f} s",
                      flush=True)
                if not fused:
                    score_rows = [{"question": r["question"], "answer": r["answer"],
                                   "img": os.path.basename(r["img"])} for r in ce_rows[:16]]
                    remote = EndpointRunner(url).run_vqa_ppl(score_rows)
                    main(["eval", "--endpoint", url, "--benchmark", "mme", "--data_file", mme,
                          "--output_dir", os.path.join(tmp, "endpoint")])
            finally:
                httpd.shutdown()
                httpd.server_close()
                srv.stop()
                thread.join(timeout=60)
            if thread.is_alive() or (srv._thread is not None and srv._thread.is_alive()):
                raise AssertionError("server threads did not stop")
            for name, n in read().items():
                adapter_launches[name] += n
            gen_cfg = srv.engine.gen_cfg
            builder = RequestBuilder(proc, collator_config(cfg, family, proc, sargs), eval_image)
            stop = gen_cfg.eos_token_ids[-1]
            ids = [proc.process_conv(make_single_turn_conv(proc.format_multimodal_prompt(q, 1),
                                                           ""))["input_ids"]
                   for q, _, _ in questions]
            ties = []
            if not fused:
                local = EvalRunner(model, proc, gen_cfg, collator_config(cfg, family, proc, sargs),
                                   eval_image).run_vqa_ppl(score_rows)
                rel = max(abs(r["ppl"] - w["ppl"]) / abs(w["ppl"]) for r, w in zip(remote, local))
                print(f"phase 8c /score via EndpointRunner vs in-process run_vqa_ppl (16 rows): "
                      f"max rel diff {rel:.3e} (tol 1e-3)", flush=True)
                if rel > 1e-3:
                    raise AssertionError(f"/score differs from run_vqa_ppl: rel {rel}")
                with open(os.path.join(tmp, "endpoint", "mme.json")) as f:
                    remote_rows = json.load(f)
                eties = [(i, tie) for i, (p, r, row) in enumerate(zip(prompts, toks["continuous"],
                                                                       remote_rows))
                         if (tie := tie_or_raise(f"eval --endpoint row {i}", model, proc,
                                                 p["input_ids"], p["img_path"], visible(r),
                                                 text_ids(row["response"]), stop))]
                print(f"phase 8c eval --endpoint mme vs in-process continuous: "
                      f"{32 - len(eties)}/32 rows identical, divergences {eties}", flush=True)
                for name in ("a", "b", None):
                    idx = [i for i, q in enumerate(questions) if q[2] == name]
                    reqs = [builder.build(questions[i][0], questions[i][1], EVAL_NEW,
                                          adapter_idx=None if name is None else 0) for i in idx]
                    eng = ContinuousEngine(model, gen_cfg, n_slots=EVAL_SLOTS,
                                           cache_len=srv.engine.cache_len,
                                           adapter_sets=None if name is None else [sets[name]],
                                           lora_scale=0.25)
                    want = eng.run(reqs)
                    ctx = None if name is None else Ctx(adapters=True, lora_scale=0.25,
                                                        adapter_mix=torch.ones((1, 1),
                                                                               device="cuda"))
                    # a tie check's prefill runs the engine's set, lent again
                    with (nullcontext() if name is None
                          else lend_adapters(model, eng.adapter_sets)):
                        for i, w in zip(idx, want):
                            tie = tie_or_raise(f"adapter {name} request {i}", model, proc,
                                               ids[i], questions[i][1], visible(w),
                                               http[False][i], stop, ctx)
                            if tie:
                                ties.append((i, name, tie))
                print(f"phase 8c multi-adapter tokens vs one-set engines: {8 - len(ties)}/8 "
                      f"identical, divergences {ties}", flush=True)
            else:
                names = ["a", "b"]
                with lend_adapters(model, srv.engine.adapter_sets):  # the server's fused sets
                    for i, (q, img, name) in enumerate(questions):
                        mix = torch.zeros((1, 2), device="cuda")
                        if name is not None:
                            mix[0, names.index(name)] = 1.0
                        tie = tie_or_raise(f"fused adapter {name} request {i}", model, proc,
                                           ids[i], img, http[False][i], http[True][i], stop,
                                           Ctx(adapters=True, lora_scale=0.25, adapter_mix=mix))
                        if tie:
                            ties.append((i, name, tie))
                print(f"phase 8c fused (--fuse_decode true) vs unfused adapter tokens: "
                      f"{8 - len(ties)}/8 identical, divergences {ties}", flush=True)
        print(f"phase 8c launches {json.dumps(adapter_launches)}", flush=True)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    eval_reduced_depth()
    return eval_launches, adapter_launches


def eval_reduced_depth():
    """Phase 8d: EvalRunner at full widths but 2 LM / 2 tower layers, the
    same seeded weights on the card (bf16, kernels) and the CPU (f32,
    plain): 4 image questions (8 greedy tokens) and 8 CE rows. ppl within
    PPL_REL_TOL relative; greedy tokens equal up to top-2 ties of the
    CPU's teacher-forced logits. Two broken controls on the card must fail
    PPL_REL_TOL, or the check could not catch a wrong path: the LM's
    attention without its causal mask, and the answer labels one token
    off."""
    import dataclasses

    import vlrlhf_torch.models.lm.llama as llama

    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import _llava_7b
    from vlrlhf_torch.models.vlm import VLM

    full = _llava_7b(torch.float32)
    cfg32 = dataclasses.replace(full, lm=dataclasses.replace(full.lm, num_layers=2),
                                vision=dataclasses.replace(full.vision, num_layers=2))
    cfg16 = dataclasses.replace(cfg32, lm=dataclasses.replace(cfg32.lm, dtype=torch.bfloat16),
                                vision=dataclasses.replace(cfg32.vision, dtype=torch.bfloat16))
    cpu = init_random_(VLM(cfg32, "cpu"), torch.Generator().manual_seed(1))
    gpu = VLM(cfg16, "cuda")
    gpu.load_state_dict(cpu.state_dict())
    proc = make_processor(cfg32)
    gen_rows = [{"question": f"Is there a w{300 + i} in the image? Please answer yes or no.",
                 "img": f"d{i}.jpg"} for i in range(4)]
    ce_rows = [{"question": f"What does the picture w{400 + i // 4} show?",
                "answer": f"The answer is: {('a dog', 'a cat', 'two birds', 'a fish')[i % 4]}",
                "img": f"d{i // 4}.jpg"} for i in range(8)]
    out, runners = {}, {}
    for name, model in (("card", gpu), ("host", cpu)):
        runner = runners[name] = EvalRunner(
            model, proc, GenerateConfig(max_new_tokens=8, pad_token_id=0),
            CollatorConfig(image_size=cfg32.vision.image_size), eval_image)
        toks = record_tokens(runner, set())
        runner.run_vqa(gen_rows, batch_size=4)
        ppl = [r["ppl"] for r in runner.run_vqa_ppl(ce_rows, batch_size=8)]
        out[name] = (toks, np.asarray(ppl))

    def rel_err(ppl):
        return float(np.max(np.abs(ppl - out["host"][1]) / np.abs(out["host"][1])))

    def card_ppl():
        return np.asarray([r["ppl"] for r in runners["card"].run_vqa_ppl(ce_rows, batch_size=8)])

    rel = rel_err(out["card"][1])
    controls = {}
    mha = llama.multi_head_attention
    llama.multi_head_attention = lambda q, k, v, causal=True, **kw: mha(q, k, v, causal=False,
                                                                        **kw)
    try:
        controls["no causal mask"] = rel_err(card_ppl())
    finally:
        llama.multi_head_attention = mha
    ce = runners["card"].ce
    runners["card"].ce = lambda batch: ce(dict(batch,
                                               labels=np.roll(np.asarray(batch["labels"]), 1, 1)))
    try:
        controls["labels one token off"] = rel_err(card_ppl())
    finally:
        del runners["card"].ce
    ties = []
    for i, (r, g) in enumerate(zip(out["host"][0], out["card"][0])):
        p = runner._prompt_row(gen_rows[i]["question"], gen_rows[i]["img"])
        tie = tie_or_raise(f"reduced-depth eval row {i}", cpu, proc, p["input_ids"],
                           p["img_path"], r, g, 2)
        if tie:
            ties.append((i, tie))
    print(f"phase 8d reduced-depth EvalRunner (2 LM / 2 tower layers, full widths), card bf16 "
          f"vs CPU f32: ppl max rel err {rel:.3e} (tol {PPL_REL_TOL}), ppl card "
          f"{np.round(out['card'][1], 4).tolist()}; broken controls' max rel err "
          f"{ {k: f'{v:.3e}' for k, v in controls.items()} } (each must exceed the tol); "
          f"greedy tokens {4 - len(ties)}/4 rows identical, divergences {ties}", flush=True)
    if not np.isfinite(out["card"][1]).all() or rel > PPL_REL_TOL:
        raise AssertionError(f"reduced-depth ppl differs: rel {rel} > {PPL_REL_TOL}")
    if min(controls.values()) <= PPL_REL_TOL:
        raise AssertionError(f"a broken control passes PPL_REL_TOL, so the ppl check cannot "
                             f"catch it: {controls}")
    del cpu, gpu
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import vlrlhf_torch  # noqa: F401 — fails here when run without the port

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    kernels = phase_kernels()
    phase_reduced_depth()
    serve_launches, bf16_decode_ms = phase_serve()
    gc.collect()  # the bf16 serving model and cache go before the int8 one
    torch.cuda.empty_cache()
    spec_launches, chat_launches, int8_decode_ms = phase_serve_spec_int8()
    gc.collect()
    torch.cuda.empty_cache()
    int4_launches = phase_serve_int4(bf16_decode_ms, int8_decode_ms)
    gc.collect()  # the serving models and caches go before any training model
    torch.cuda.empty_cache()
    phase_reduced_depth_dpo()
    phase_reduced_depth_dpo(bits=4)
    dpo_launches, dpo_stats = phase_dpo()
    gc.collect()
    torch.cuda.empty_cache()
    qlora_launches = phase_dpo_qlora4(dpo_stats)
    gc.collect()
    torch.cuda.empty_cache()
    trainer_launches = phase_trainer()
    gc.collect()
    torch.cuda.empty_cache()
    eval_launches, adapter_launches = phase_eval()
    runs = {"serve": serve_launches, "serve_int8_spec": spec_launches, "chat_int8": chat_launches,
            "serve_int4": int4_launches, "dpo": dpo_launches, "dpo_qlora4": qlora_launches,
            "dpo_trainer": trainer_launches, "eval": eval_launches,
            "serve_adapters": adapter_launches}
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention", "chunk_attention",
             "int4_matmul", "int4_matmul_t")
    by_path = {name: {path: counts[name] for path, counts in runs.items() if name in counts}
               for name in names}
    launches = {name: sum(paths.values()) for name, paths in by_path.items()}
    sources = {
        "flash_fwd": ("vlrlhf_torch/csrc/flash_fwd.cu",
                      "vlrlhf_tpu/ops/flash_attention.py:51"),
        "flash_bwd_dkv": ("vlrlhf_torch/csrc/flash_bwd.cu",
                          "vlrlhf_tpu/ops/flash_attention.py:195"),
        "flash_bwd_dq": ("vlrlhf_torch/csrc/flash_bwd.cu",
                         "vlrlhf_tpu/ops/flash_attention.py:278"),
        "decode_attention": ("vlrlhf_torch/csrc/decode_attention.cu",
                             "vlrlhf_tpu/ops/decode_attention.py:56"),
        "chunk_attention": ("vlrlhf_torch/csrc/chunk_attention.cu",
                            "vlrlhf_tpu/ops/chunk_attention.py:46"),
        "int4_matmul": ("vlrlhf_torch/csrc/int4_matmul.cu", "vlrlhf_tpu/ops/int4.py:219"),
        "int4_matmul_t": ("vlrlhf_torch/csrc/int4_matmul.cu", "vlrlhf_tpu/ops/int4.py:323"),
    }
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the paths driven")
    if by_path["chunk_attention"].get("serve_int8_spec", 0) <= 0 or \
            by_path["chunk_attention"].get("chat_int8", 0) <= 0:
        raise AssertionError(f"chunk_attention must run in both the speculative serve and /chat: "
                             f"{by_path['chunk_attention']}")
    if any(by_path[name].get("eval", 0) <= 0
           for name in ("flash_fwd", "decode_attention", "chunk_attention")):
        raise AssertionError(f"kernels 1, 4 and 5 must run on the eval path: "
                             f"{ {n: by_path[n].get('eval') for n in by_path} }")
    if by_path["int4_matmul"].get("serve_int4", 0) <= 0 or \
            by_path["int4_matmul"].get("dpo_qlora4", 0) <= 0 or \
            by_path["int4_matmul_t"].get("dpo_qlora4", 0) <= 0:
        raise AssertionError(f"int4 kernels must run in the int4 serve and the QLoRA step: "
                             f"{by_path['int4_matmul']} {by_path['int4_matmul_t']}")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "launches_by_path": by_path[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"],
         **{k: kernels[name][k] for k in ("int8", "chat", "eval") if k in kernels[name]}}
        for name in names
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
