"""Quickest proof that the PyTorch port runs on an NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA device, nvcc (CUDA_HOME or PATH) and no network; imports
nothing of JAX. Phases, each raising on failure (non-zero exit):

  1. the card's name and power limit; build both hand-written kernels from
     vlrlhf_torch/csrc/ with nvcc for sm_90a (build seconds printed)
  2. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, bf16 in, plain computed in f32 on the same
     values; max abs error against 2e-2; kernel and plain times
  3. end to end at full LLaVA-1.5-7B widths but 2 LM / 2 tower layers: the
     same seeded weights on the card (bf16, kernels) and on the CPU (f32,
     plain path), one image prefill + 8 greedy tokens; logit error and
     token agreement
  4. full-width LLaVA-1.5-7B with seeded random bf16 weights served over
     HTTP through cli.main.build_server (8 slots, cache_len 1024): 8
     concurrent /generate requests with 336x336 images, 32 new tokens;
     kernel launch counts of that run; then prefill ms, decode tokens/s
     and peak device memory

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero
and prints no result.
"""

from __future__ import annotations

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
LOGIT_REL_TOL = 5e-2  # bf16 model on the card vs the f32 model on the CPU


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
    for name in ("flash_fwd", "decode_attention"):
        _build.load(name)
    print("build seconds:", json.dumps(_build.build_seconds), flush=True)
    for name, info in _build.ptxas_info.items():  # nvcc -Xptxas -v, all instantiations
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", info)]
        spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", info))
        print(f"ptxas {name}: {len(regs)} kernels, max {max(regs, default=0)} registers, "
              f"{spills} bytes of spill stores", flush=True)


def phase_kernels():
    from vlrlhf_torch.ops.decode_attention import decode_attention, decode_attention_plain
    from vlrlhf_torch.ops.flash_attention import (
        KV_PAD_SEG, Q_PAD_SEG, flash_attention, flash_attention_plain, make_segments,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {}

    def randn(*shape):
        return torch.randn(shape, device=dev, generator=gen).to(torch.bfloat16)

    flash_cases = [
        # (label, causal, B, S, H, Hkv, D, prompt lengths or None)
        ("vit_noncausal", False, 2, 577, 16, 16, 64, None),
        ("lm_causal_padded", True, 4, 640, 32, 32, 128, (600, 613, 627, 640)),
        ("lm_causal_gqa", True, 2, 640, 32, 8, 128, (640, 601)),
    ]
    errs, times = [], {}
    for label, causal, b, s, h, hkv, d, lens in flash_cases:
        q, k, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
        lens_t = torch.tensor(lens or (s,) * b, device=dev)
        pad = torch.arange(s, device=dev)[None] < lens_t[:, None]
        seg_q = make_segments(b, s, dev, None, pad, Q_PAD_SEG)
        seg_kv = make_segments(b, s, dev, None, pad, KV_PAD_SEG)
        out = flash_attention(q, k, v, causal=causal, pad_mask_q=pad, pad_mask_kv=pad)
        torch.cuda.synchronize()
        ref, _ = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv,
                                       causal, d**-0.5)
        err = max(
            float((out[i, :n].float() - ref[i, :n]).abs().max())
            for i, n in enumerate(lens_t.tolist())
        )
        if not np.isfinite(err) or err > TOL:
            raise AssertionError(f"flash {label}: max abs err {err} > {TOL}")
        k_ms = time_ms(lambda: flash_attention(q, k, v, causal=causal, pad_mask_q=pad,
                                               pad_mask_kv=pad))
        p_ms = time_ms(lambda: flash_attention_plain(q, k, v, seg_q, seg_kv, causal,
                                                     d**-0.5), iters=5)
        print(f"flash {label} B={b} S={s} H={h} Hkv={hkv} D={d}: max_abs_err={err:.3e} "
              f"(tol {TOL}) kernel {k_ms:.4f} ms plain {p_ms:.4f} ms", flush=True)
        errs.append(err)
        times[label] = (k_ms, p_ms)
    results["flash_fwd"] = {
        "max_abs_err": max(errs),
        "ms": times["lm_causal_padded"][0], "plain_ms": times["lm_causal_padded"][1],
        "cases": times,
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
    err = float((out.float() - ref).abs().max())
    if not np.isfinite(err) or err > TOL:
        raise AssertionError(f"decode: max abs err {err} > {TOL}")
    # timing at the serving shape: 8 rows mid-generation (~640 live slots)
    lengths_t = torch.full((b,), 640, dtype=torch.int32, device=dev)
    k_ms = time_ms(lambda: decode_attention(q, kc, vc, k_cur, v_cur, lengths_t, layer=layer),
                   iters=50)
    p_ms = time_ms(lambda: decode_attention_plain(q, kc[layer], vc[layer], k_cur, v_cur,
                                                  lengths_t, hd**-0.5), iters=20)
    live_bytes = 2 * b * nkv * 640 * hd * 2
    print(f"decode B={b} L={L} nkv={nkv} hd={hd} Sc={sc} layer={layer}: "
          f"max_abs_err={err:.3e} (tol {TOL}) kernel {k_ms:.4f} ms plain {p_ms:.4f} ms "
          f"at length 640 ({live_bytes / (k_ms * 1e-3) / 1e9:.1f} GB/s of live k/v)", flush=True)
    results["decode_attention"] = {"max_abs_err": err, "ms": k_ms, "plain_ms": p_ms}
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
    peak = torch.cuda.max_memory_allocated()
    print(f"prefill (ViT + projector + 32-layer LM, {batch['input_ids'].shape[1]}-token "
          f"bucket): B=1 {prefill_ms[1]:.3f} ms, B=2 {prefill_ms[2]:.3f} ms; "
          f"decode 8 slots x {steps} steps: {dt * 1e3 / steps:.3f} ms/step, "
          f"{decode_tok_s:.2f} tokens/s; peak memory {peak / 2**30:.3f} GiB", flush=True)
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
    launches = phase_serve()
    sources = {
        "flash_fwd": ("vlrlhf_torch/csrc/flash_fwd.cu",
                      "vlrlhf_tpu/ops/flash_attention.py:51"),
        "decode_attention": ("vlrlhf_torch/csrc/decode_attention.cu",
                             "vlrlhf_tpu/ops/decode_attention.py:56"),
    }
    line = {"kernels": [
        {"name": name, "route": "cuda", "source": sources[name][0],
         "replaces": sources[name][1], "launches": launches[name],
         "max_abs_err": kernels[name]["max_abs_err"], "ms": kernels[name]["ms"],
         "plain_ms": kernels[name]["plain_ms"]}
        for name in ("flash_fwd", "decode_attention")
    ]}
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
