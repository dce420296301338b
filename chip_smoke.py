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
     median |ref| printed; kernel, plain and PyTorch-SDPA times and each kernel's
     bound max(FLOPs / 989.4e12, bytes / 3.35e12)
  3. serving at full LLaVA-1.5-7B widths but 2 LM / 2 tower layers: the
     same seeded weights on the card (bf16, kernels) and on the CPU (f32,
     plain path), one image prefill + 8 greedy tokens; logit error and
     token agreement
  4. full-width LLaVA-1.5-7B with seeded random bf16 weights served over
     HTTP through cli.main.build_server (8 slots, cache_len 1024): 8
     concurrent /generate requests with 336x336 images, 32 new tokens;
     kernel launch counts of that run; then prefill ms, decode tokens/s,
     peak device memory, and one profiled prefill and decode step
  5. DPO at full widths but 2 LM / 2 tower layers, seeded adapters with a
     non-zero b: one loss and backward on the card (bf16, kernels) and on
     the CPU (f32, plain); relative loss error and the cosine of the LoRA
     gradients
  6. full-width LLaVA-1.5-7B DPO through cli.main.build_dpo (LoRA r64/a16
     on all 7 LM linears, 1 pair of 1024 tokens with an image, 'attn'
     remat, logits_chunk 256, precomputed reference logps): 5 steps on one
     batch with their loss / grad-norm checks and kernel launch counts, then
     step ms, pairs/s, MFU, peak device memory and one profiled step

A profiled step prints the card's busy and idle time and its kernel time by
group (torch.profiler). The line before the last is {"kernels": [...]}
(launches summed over the serve and DPO runs, split in launches_by_path);
the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

import gc
import json
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
LOSS_REL_TOL = 5e-2  # bf16 DPO loss on the card vs the f32 loss on the CPU
GRAD_COS_MIN = 0.99  # cosine of the flattened LoRA gradients, card vs CPU
PEAK_FLOPS = 989.4e12  # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
KERNELS = ("flash_fwd", "decode_attention", "flash_bwd")


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
        print(f"ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores", flush=True)


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


def _flash_bytes(b, s, h, hkv, d, grads: str) -> int:
    """Bytes a flash launch must move: each input read once, each output
    written once (bf16 tensors, f32 LSE / di, int32 segment ids)."""
    q, kv, row = b * s * h * d * 2, b * s * hkv * d * 2, b * h * s * 4
    seg = 2 * b * s * 4
    if grads == "fwd":  # q, k, v, seg -> o, lse
        return 2 * q + 2 * kv + row + seg
    if grads == "dkv":  # q, k, v, do, lse, di, seg -> dk, dv
        return 2 * q + 2 * kv + 2 * row + seg + 2 * kv
    return 2 * q + 2 * kv + 2 * row + seg + q  # dq


def _flash_flops(b, s, h, d, causal: bool) -> float:
    """Matmul FLOPs of one attention forward (QK^T and PV), causal tiles at
    half occupancy."""
    return 4.0 * b * h * s * s * d * (0.5 if causal else 1.0)


def phase_kernels():
    import torch.nn.functional as F

    from vlrlhf_torch.ops.decode_attention import decode_attention, decode_attention_plain
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
        k_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, pad_mask_q=pad,
                                               pad_mask_kv=pad))
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, seg_q, seg_kv, causal,
                                                     d**-0.5), iters=5)
        # yardstick: PyTorch's SDPA on the same (B, H, S, D) views, no pad mask
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        l_ms = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=h != hkv))
        b_ms, b_by = bound(_flash_flops(b, s, h, d, causal), _flash_bytes(b, s, h, hkv, d, "fwd"))
        print(f"flash {label} B={b} S={s} H={h} Hkv={hkv} D={d}: {report}; "
              f"kernel {k_ms:.4f} ms plain {p_ms:.4f} ms sdpa {l_ms:.4f} ms "
              f"bound {b_ms:.4f} ms ({b_by})", flush=True)
        errs.append(err)
        times[label] = (k_ms, p_ms, l_ms, b_ms, b_by)
    main = times["dpo_lm_causal"]
    results["flash_fwd"] = {
        "max_abs_err": max(errs), "ms": main[0], "plain_ms": main[1], "library_ms": main[2],
        "bound_ms": main[3], "bound_by": main[4], "cases": times,
    }

    # backward: the DPO path's LM case and a GQA case
    bwd_cases = [
        ("dpo_lm_causal", 2, 1024, 32, 32, 128, (1000, 900)),
        ("lm_causal_gqa", 2, 640, 32, 8, 128, (640, 601)),
    ]
    bwd = {"dkv": {}, "dq": {}}
    bwd_errs = {"dkv": [], "dq": []}
    for label, b, s, h, hkv, d, lens in bwd_cases:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_t, pad, seg_q, seg_kv = segs(b, s, lens)
        do = torch.where(pad[..., None, None], randn(b, s, h, d), 0).contiguous()
        o, lse = flash_attention(q, k, v, causal=True, pad_mask_q=pad, pad_mask_kv=pad,
                                 return_lse=True)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        scale = d**-0.5
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, True, scale)
        dq = flash_bwd_dq(q, k, v, do, lse, di, seg_q, seg_kv, True, scale)
        torch.cuda.synchronize()
        rq, rk, rv = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                               lse, di, seg_q, seg_kv, True, scale)
        checks = {"dq": (dq[pad].float(), rq[pad]), "dk": (dk.float(), rk),
                  "dv": (dv.float(), rv)}
        line = []
        for name, (got, ref) in checks.items():
            err, _, report = check_close(f"flash backward {label} {name}", got, ref,
                                         TOL * max(1.0, float(ref.abs().max())))
            bwd_errs["dq" if name == "dq" else "dkv"].append(err)
            line.append(f"{name} {report}")
        args = (q, k, v, do, lse, di, seg_q, seg_kv, True, scale)
        ms = {"dkv": time_ms(lambda: flash_bwd_dkv(*args)),
              "dq": time_ms(lambda: flash_bwd_dq(*args))}
        plain_ms = time_ms(lambda: flash_attention_bwd_plain(*args), iters=3, warmup=1)
        # yardsticks: SDPA forward+backward, and its flash backward alone
        # (one aten call computing dQ, dK, dV from O and the LSE; MHA only)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
        dot = do.transpose(1, 2)

        def sdpa_fwd_bwd():
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=h != hkv)
            torch.autograd.grad(out, (qt, kt, vt), dot)

        fb_ms = time_ms(sdpa_fwd_bwd)
        lib_bwd_ms, fo = None, None
        if h == hkv:
            with torch.no_grad():
                fo = torch.ops.aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, True, False, scale=scale)
            lib_bwd_ms = time_ms(lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
                dot, qt, kt, vt, fo[0], fo[1], fo[2], fo[3], fo[4], fo[5], 0.0, True, fo[6],
                fo[7], scale=scale))
        fwd_flops = _flash_flops(b, s, h, d, True)
        bounds = {"dkv": bound(2.0 * fwd_flops, _flash_bytes(b, s, h, hkv, d, "dkv")),
                  "dq": bound(1.5 * fwd_flops, _flash_bytes(b, s, h, hkv, d, "dq"))}
        pair_bound = bound(2.5 * fwd_flops, _flash_bytes(b, s, h, hkv, d, "dkv") + b * s * h * d * 2)
        print(f"flash backward {label} B={b} S={s} H={h} Hkv={hkv} D={d}: " + ", ".join(line)
              + f"; dkv kernel {ms['dkv']:.4f} ms (bound {bounds['dkv'][0]:.4f} ms, "
              f"{bounds['dkv'][1]}), dq kernel {ms['dq']:.4f} ms (bound {bounds['dq'][0]:.4f} ms, "
              f"{bounds['dq'][1]}), pair {ms['dkv'] + ms['dq']:.4f} ms (bound at 2.5x forward "
              f"{pair_bound[0]:.4f} ms); plain {plain_ms:.4f} ms; sdpa fwd+bwd {fb_ms:.4f} ms, "
              f"sdpa flash backward alone "
              f"{'n/a (GQA)' if lib_bwd_ms is None else f'{lib_bwd_ms:.4f} ms'}", flush=True)
        for kname in ("dkv", "dq"):
            bwd[kname][label] = (ms[kname], plain_ms, lib_bwd_ms, *bounds[kname], fb_ms)
        del qt, kt, vt, fo
    for kname in ("dkv", "dq"):
        m = bwd[kname]["dpo_lm_causal"]
        results[f"flash_bwd_{kname}"] = {
            "max_abs_err": max(bwd_errs[kname]), "ms": m[0], "plain_ms": m[1],
            "library_ms": m[2], "bound_ms": m[3], "bound_by": m[4], "sdpa_fwd_bwd_ms": m[5],
            "cases": bwd[kname],
        }

    L, b, nh, nkv, hd, sc, layer = 32, 8, 32, 32, 128, 1024, 17
    q = randn(b, nh, hd)
    kc, vc = randn(L, b, nkv, sc, hd), randn(L, b, nkv, sc, hd)
    k_cur, v_cur = randn(b, nkv, hd), randn(b, nkv, hd)
    lengths = torch.tensor([0, sc - 1, 600, 613, 1, 640, 827, 128], dtype=torch.int32,
                           device=dev)
    out = decode_attention(q, kc, vc, k_cur, v_cur, lengths, layer=layer)
    torch.cuda.synchronize()
    ref = decode_attention_plain(q.float(), kc[layer].float(), vc[layer].float(),
                                 k_cur.float(), v_cur.float(), lengths, hd**-0.5)
    err, _, report = check_close("decode", out, ref, TOL)
    # timing at the serving shape: 8 rows mid-generation (~640 live slots)
    lengths_t = torch.full((b,), 640, dtype=torch.int32, device=dev)
    k_ms = time_ms(lambda: decode_attention(q, kc, vc, k_cur, v_cur, lengths_t, layer=layer),
                   iters=50)
    p_ms = time_ms(lambda: decode_attention_plain(q, kc[layer], vc[layer], k_cur, v_cur,
                                                  lengths_t, hd**-0.5), iters=20)
    # yardstick: SDPA of the one query against the layer's cache, masked to
    # the 640 live slots (the kernel's self term has no counterpart there)
    live = (torch.arange(sc, device=dev) < 640)[None, None, None, :]
    qs = q[:, :, None]
    l_ms = time_ms(lambda: F.scaled_dot_product_attention(qs, kc[layer], vc[layer],
                                                          attn_mask=live), iters=50)
    live_bytes = 2 * b * nkv * 640 * hd * 2
    b_ms, b_by = bound(4.0 * b * nh * 641 * hd,
                       live_bytes + 2 * b * nkv * hd * 2 + 2 * b * nh * hd * 2 + b * 4)
    print(f"decode B={b} L={L} nkv={nkv} hd={hd} Sc={sc} layer={layer}: "
          f"{report}; kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
          f"sdpa {l_ms:.4f} ms bound {b_ms:.4f} ms ({b_by}) "
          f"at length 640 ({live_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s of live k/v)", flush=True)
    results["decode_attention"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                                   "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by}
    del kc, vc
    torch.cuda.empty_cache()
    return results


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
    del cpu, gpu
    torch.cuda.empty_cache()


def phase_serve():
    import argparse

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
    args = argparse.Namespace(
        max_new_tokens=32, synthetic=0, do_sample=False, temperature=1.0, top_k=None,
        top_p=None, max_length=992, slots=8, seed=0, host="127.0.0.1", port=0,
    )
    httpd, srv = build_server(cfg, model, proc, args, seeded_image)
    engine = srv.engine
    assert engine.cache_len == 1024
    http_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    http_thread.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    n_req = 8
    results: list = [None] * n_req
    errors: list = []

    def post(i):
        body = json.dumps({
            "question": f"request {i}: what does this image show? answer in detail",
            "image": f"img{i}.png", "max_new_tokens": 32,
        }).encode()
        req = urllib.request.Request(url + "/generate", data=body, method="POST",
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=600) as r:
                results[i] = json.loads(r.read())
        except Exception as e:  # noqa: BLE001 — reported and failed below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    try:
        flash_attention.launches = 0
        decode_attention.launches = 0
        t0 = time.perf_counter()
        clients = [threading.Thread(target=post, args=(i,)) for i in range(n_req)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = {"flash_fwd": flash_attention.launches,
                    "decode_attention": decode_attention.launches}
        if errors or any(c.is_alive() for c in clients):
            raise AssertionError(f"serving failed: {errors}")
        tokens = [r.get("tokens") for r in results]
        if any(not isinstance(r, dict) or "text" not in r for r in results):
            raise AssertionError(f"bad responses: {results}")
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
    from vlrlhf_torch.generate.continuous import Request

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
        reqs = []
        for j, ids in enumerate(prompt_ids):
            b1 = coll([{"input_ids": ids, "img_path": f"d{j}.png"}])
            n = int(b1["prompt_lens"][0])
            reqs.append(Request(input_ids=b1["input_ids"][0, :n],
                                pixel_values=b1["pixel_values"][0, 0],
                                image_positions=b1["image_positions"][0],
                                max_new_tokens=32))
        cache, pending, state = engine._fresh_buffers()
        gen = torch.Generator(device="cuda").manual_seed(0)
        for g in range(0, 8, 2):
            engine._admit_group(cache, pending, state, [(g, g), (g + 1, g + 1)], reqs, gen)
        logits, _ = model.lm.decode(state[1].clone(), state[0].clone(), cache, pending)
        if not torch.isfinite(logits).all():
            raise AssertionError("decode logits are not finite")
        torch.cuda.synchronize()
        engine.last_decode_steps = 0
        t0 = time.perf_counter()
        _, _, packed = engine._burst(cache, pending, state, 0, gen)
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
    return launches


def profile_breakdown(fn, label: str) -> None:
    """Run fn() once under torch.profiler and print where the card's time
    went: wall ms, busy ms (kernel durations summed; one stream), idle
    share, and kernel time by group and by name."""
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
        return
    groups = {"flash_fwd": "flash_fwd_kernel", "flash_bwd_dkv": "flash_bwd_dkv_kernel",
              "flash_bwd_dq": "flash_bwd_dq_kernel", "decode": "decode_attention"}
    by_group, by_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        name = e.name
        grp = next((g for g, key in groups.items() if key in name), None)
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
    )
    base.update(kw)
    return argparse.Namespace(**base)


def phase_reduced_depth_dpo():
    """One DPO loss + backward at full widths, 2 LM / 2 tower layers, the
    same seeded weights and non-zero adapters on the card (bf16, kernels)
    and on the CPU (f32, plain path)."""
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
        raise AssertionError("reduced-depth DPO on the card is not finite")
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    cos = float(torch.dot(g.double(), r.double()) / (g.double().norm() * r.double().norm()))
    print(f"reduced-depth DPO (2 LM / 2 tower layers, full widths, 1 pair of "
          f"{batch['input_ids'].shape[1]} tokens): loss cuda {loss['cuda']:.6f} cpu "
          f"{loss['cpu']:.6f} rel err {rel:.3e} (tol {LOSS_REL_TOL}); LoRA gradient cosine "
          f"{cos:.6f} (min {GRAD_COS_MIN}) over {g.numel()} entries", flush=True)
    if rel > LOSS_REL_TOL:
        raise AssertionError(f"reduced-depth DPO loss differs: rel {rel} > {LOSS_REL_TOL}")
    if cos < GRAD_COS_MIN:
        raise AssertionError(f"reduced-depth LoRA gradients differ: cosine {cos} < {GRAD_COS_MIN}")
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
    return launches


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
    serve_launches = phase_serve()
    gc.collect()  # the serving model and cache go before any training model
    torch.cuda.empty_cache()
    phase_reduced_depth_dpo()
    dpo_launches = phase_dpo()
    launches = {
        "flash_fwd": serve_launches["flash_fwd"] + dpo_launches["flash_fwd"],
        "decode_attention": serve_launches["decode_attention"],
        "flash_bwd_dkv": dpo_launches["flash_bwd_dkv"],
        "flash_bwd_dq": dpo_launches["flash_bwd_dq"],
    }
    by_path = {
        "flash_fwd": {"serve": serve_launches["flash_fwd"], "dpo": dpo_launches["flash_fwd"]},
        "decode_attention": {"serve": serve_launches["decode_attention"]},
        "flash_bwd_dkv": {"dpo": dpo_launches["flash_bwd_dkv"]},
        "flash_bwd_dq": {"dpo": dpo_launches["flash_bwd_dq"]},
    }
    sources = {
        "flash_fwd": ("vlrlhf_torch/csrc/flash_fwd.cu",
                      "vlrlhf_tpu/ops/flash_attention.py:51"),
        "flash_bwd_dkv": ("vlrlhf_torch/csrc/flash_bwd.cu",
                          "vlrlhf_tpu/ops/flash_attention.py:195"),
        "flash_bwd_dq": ("vlrlhf_torch/csrc/flash_bwd.cu",
                         "vlrlhf_tpu/ops/flash_attention.py:278"),
        "decode_attention": ("vlrlhf_torch/csrc/decode_attention.cu",
                             "vlrlhf_tpu/ops/decode_attention.py:56"),
    }
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the paths driven")
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "launches_by_path": by_path[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"], "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"], "library_ms": kernels[name]["library_ms"]}
        for name in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "decode_attention")
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
