"""Time this checkout's flash-forward, flash dK/dV and int4 kernels against
another checkout's, in turns, on one card.

    python -m vlrlhf_torch.ops.ab_kernels OTHER_CSRC_DIR

OTHER_CSRC_DIR holds the other version's `flash_fwd.cu`, `flash_bwd.cu`
and `int4_matmul.cu` (for example `build/parent/vlrlhf_torch/csrc` after
`git archive <commit> | tar -x -C build/parent`). Both are built with the
same nvcc flags into `build/ab/`, and each C entry point is timed on
outputs allocated once (CUDA events, the other version, this one, this one,
the other), with its max abs error against the plain version and the
library call of the same function beside it (SDPA; the aten flash
backward, which computes dQ as well, MHA only; cuBLAS bf16 on the weight
dequantized once). Decode and verify shapes rotate over 4 weight copies
(more than the L2). Prints one line per shape; needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from vlrlhf_torch.ops import _build
from vlrlhf_torch.ops.flash_attention import (
    KV_PAD_SEG, Q_PAD_SEG, _BWD_ARGS, _FWD_ARGS, flash_attention_bwd_plain,
    flash_attention_plain, make_segments,
)
from vlrlhf_torch.ops.int4 import (
    _ARGS as INT4_ARGS, dequantize_int4, int4_matmul_plain, int4_matmul_t_plain, quantize_int4,
)

FLASH_SHAPES = [  # label, causal, B, S, H, Hkv, D, row lengths
    ("vit", False, 2, 577, 16, 16, 64, None),
    ("prefill", True, 4, 640, 32, 32, 128, (600, 613, 627, 640)),
    ("dpo", True, 2, 1024, 32, 32, 128, (1000, 900)),
]
FLASH_BWD_SHAPES = [  # label, B, S, H, Hkv, D, row lengths (causal)
    ("dpo", 2, 1024, 32, 32, 128, (1000, 900)),
    ("gqa", 2, 640, 32, 8, 128, (640, 601)),
]
INT4_SHAPES = [  # label, C symbol, T, in, out
    ("decode gate", "int4_matmul", 8, 4096, 11008),
    ("decode down", "int4_matmul", 8, 11008, 4096),
    ("verify gate", "int4_matmul", 32, 4096, 11008),
    ("verify down", "int4_matmul", 32, 11008, 4096),
    ("verify wqkv", "int4_matmul", 32, 4096, 12288),
    ("prefill gate", "int4_matmul", 1280, 4096, 11008),
    ("prefill down", "int4_matmul", 1280, 11008, 4096),
    ("qlora gate", "int4_matmul", 2048, 4096, 11008),
    ("qlora down", "int4_matmul", 2048, 11008, 4096),
    ("qlora gate dx", "int4_matmul_t", 2048, 4096, 11008),
    ("qlora down dx", "int4_matmul_t", 2048, 11008, 4096),
    ("qlora attn dx", "int4_matmul_t", 2048, 4096, 4096),
]


LIBS = ("flash_fwd", "flash_bwd", "int4_matmul")


def build_other(csrc: Path) -> dict[str, ctypes.CDLL]:
    """The other checkout's libraries, built against its own headers."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in LIBS:
        out = out_dir / f"lib{name}.so"
        proc = subprocess.run(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(csrc), "-o", str(out),
             str(csrc / f"{name}.cu")],
            capture_output=True, text=True,
        )
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the other {name}.cu:\n{proc.stderr}")
        libs[name] = ctypes.CDLL(str(out))
    return libs


def time_ms(fn, iters: int = 40, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(versions: dict, make_call, check) -> str:
    """'other' and 'this' timed as other, this, this, other; each entry is
    (ms, max abs error) per turn."""
    readings: dict[str, list] = {}
    for tag in ("other", "this", "this", "other"):
        call = make_call(versions[tag])
        call()
        torch.cuda.synchronize()
        readings.setdefault(tag, []).append((round(time_ms(call), 4), round(check(), 4)))
    return " ".join(f"{tag} {r}" for tag, r in readings.items())


def flash_lines(versions: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    for label, causal, b, s, h, hkv, d, lens in FLASH_SHAPES:
        q = torch.randn((b, s, h, d), device=dev, generator=gen).bfloat16()
        k, v = (torch.randn((b, s, hkv, d), device=dev, generator=gen).bfloat16()
                for _ in range(2))
        pad = torch.arange(s, device=dev)[None] < torch.tensor(lens or (s,) * b, device=dev)[:, None]
        seg_q = make_segments(b, s, dev, None, pad, Q_PAD_SEG)
        seg_kv = make_segments(b, s, dev, None, pad, KV_PAD_SEG)
        ref, _ = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv, causal,
                                       d**-0.5)
        o, lse = torch.empty_like(q), torch.empty((b, h, s), device=dev)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(),
                o.data_ptr(), lse.data_ptr(), b, h, hkv, s, s, d, *q.stride()[:3],
                *k.stride()[:3], *v.stride()[:3], d**-0.5, int(causal),
                torch.cuda.current_stream().cuda_stream)

        def make_call(lib):
            fn = lib.flash_fwd_bf16
            fn.argtypes, fn.restype = _FWD_ARGS, ctypes.c_int
            return lambda: _build.check(fn(*args), "flash_fwd_bf16")

        turns = in_turns(versions["flash_fwd"], make_call,
                         lambda: float((o[pad].float() - ref[pad]).abs().max()))
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        sdpa = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal))
        print(f"flash {label} B={b} S={s} H={h} Hkv={hkv} D={d}: {turns} sdpa {sdpa:.4f} ms",
              flush=True)


def flash_bwd_lines(versions: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    for label, b, s, h, hkv, d, lens in FLASH_BWD_SHAPES:
        q, do = (torch.randn((b, s, h, d), device=dev, generator=gen).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), device=dev, generator=gen).bfloat16()
                for _ in range(2))
        pad = torch.arange(s, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
        do = torch.where(pad[..., None, None], do, 0).contiguous()
        seg_q = make_segments(b, s, dev, None, pad, Q_PAD_SEG)
        seg_kv = make_segments(b, s, dev, None, pad, KV_PAD_SEG)
        scale = d**-0.5
        o, lse = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv, True,
                                       scale)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        _, rk, rv = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse,
                                              di, seg_q, seg_kv, True, scale)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                di.data_ptr(), seg_q.data_ptr(), seg_kv.data_ptr(), None, dk.data_ptr(),
                dv.data_ptr(), b, h, hkv, s, s, d, *q.stride()[:3], *k.stride()[:3],
                *v.stride()[:3], scale, 1, torch.cuda.current_stream().cuda_stream)

        def make_call(lib):
            fn = lib.flash_bwd_dkv_bf16
            fn.argtypes, fn.restype = _BWD_ARGS, ctypes.c_int
            return lambda: _build.check(fn(*args), "flash_bwd_dkv_bf16")

        turns = in_turns(versions["flash_bwd"], make_call,
                         lambda: max(float((dk.float() - rk).abs().max()),
                                     float((dv.float() - rv).abs().max())))
        lib = "n/a (GQA)"
        if h == hkv:  # one aten call computing dQ, dK and dV from O and the LSE
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            with torch.no_grad():
                fo = torch.ops.aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, True, False, scale=scale)
            lib_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
            lib_ms = time_ms(lambda: lib_bwd(dot, qt, kt, vt, fo[0], fo[1], fo[2], fo[3], fo[4],
                                             fo[5], 0.0, True, fo[6], fo[7], scale=scale))
            lib = f"{lib_ms:.4f} ms"
        print(f"flash_bwd_dkv {label} B={b} S={s} H={h} Hkv={hkv} D={d}: {turns} "
              f"aten flash backward (all grads) {lib}", flush=True)


def int4_lines(versions: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    for label, sym, t, d_in, d_out in INT4_SHAPES:
        w = torch.randn((d_out, d_in), device=dev, generator=gen) * d_in**-0.5
        packed, scale = quantize_int4(w)
        wdeq = dequantize_int4(packed, scale)
        dx = sym == "int4_matmul_t"
        a = torch.randn((t, d_out if dx else d_in), device=dev, generator=gen).bfloat16()
        ref = (int4_matmul_t_plain if dx else int4_matmul_plain)(a.float(), packed, scale)
        c = torch.empty_like(ref, dtype=torch.bfloat16)
        copies = [(packed, scale)] + ([(packed.clone(), scale.clone()) for _ in range(3)]
                                      if t <= 32 else [])

        def make_call(lib):
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = INT4_ARGS, ctypes.c_int
            cycle = itertools.cycle(copies)

            def call():
                p, s = next(cycle)
                _build.check(fn(a.data_ptr(), p.data_ptr(), s.data_ptr(), c.data_ptr(), t, d_in,
                                d_out, p.shape[1], s.shape[1],
                                torch.cuda.current_stream().cuda_stream), sym)
            return call

        turns = in_turns(versions["int4_matmul"], make_call,
                         lambda: float((c.float() - ref).abs().max()))
        cublas = time_ms((lambda: a @ wdeq) if dx else (lambda: a @ wdeq.T))
        print(f"{sym} {label} T={t} in={d_in} out={d_out}: {turns} cublas {cublas:.4f} ms",
              flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other_csrc", type=Path, help="the other version's csrc directory")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    other = build_other(args.other_csrc)
    versions = {name: {"other": other[name], "this": _build.load(name)} for name in LIBS}
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash_lines(versions, gen)
    flash_bwd_lines(versions, gen)
    int4_lines(versions, gen)


if __name__ == "__main__":
    main()
