"""Time this checkout's flash-forward, flash backward (dK/dV and dQ), int4,
decode-attention and chunk-attention kernels against another checkout's, in
turns, on one card.

    python -m vlrlhf_torch.ops.ab_kernels OTHER_CSRC_DIR [--only NAME ...]

OTHER_CSRC_DIR holds the other version's `flash_fwd.cu`, `flash_bwd.cu`,
`int4_matmul.cu`, `decode_attention.cu` and `chunk_attention.cu` with their
headers (for example `build/parent/vlrlhf_torch/csrc` after `git archive
<commit> | tar -x -C build/parent`). Both are built with the same nvcc
flags into `build/ab/`, and each C entry point is timed on outputs
allocated once (CUDA events, the other version, this one, this one, the
other), with its max abs error against the plain version and the library
call of the same function beside it (SDPA, masked to the attended slots
and over the dequantized cache for int8; the aten flash backward, which
computes dQ as well, MHA only; cuBLAS bf16 on the weight dequantized
once). Decode and verify shapes rotate over 4 weight copies or cache
layers (more than the L2), a chat turn over 8 layers. `--only` picks
groups (flash, flash_bwd, int4, decode, chunk). Prints one line per
shape; needs a CUDA card.
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
from vlrlhf_torch.ops import chunk_attention as chunk_mod
from vlrlhf_torch.ops import decode_attention as decode_mod
from vlrlhf_torch.ops.flash_attention import (
    KV_PAD_SEG, Q_PAD_SEG, _BWD_ARGS, _FWD_ARGS, _bwd_args, flash_attention_bwd_plain,
    flash_attention_plain, make_segments,
)
from vlrlhf_torch.ops.int4 import (
    _ARGS as INT4_ARGS, dequantize_int4, int4_matmul_plain, int4_matmul_t_plain, quantize_int4,
)
from vlrlhf_torch.ops.quant import dequantize_kv, quantize_kv

FLASH_SHAPES = [  # label, causal, B, S, H, Hkv, D, row lengths
    ("vit", False, 2, 577, 16, 16, 64, None),
    ("prefill", True, 4, 640, 32, 32, 128, (600, 613, 627, 640)),
    ("dpo", True, 2, 1024, 32, 32, 128, (1000, 900)),
]
FLASH_BWD_SHAPES = [  # label, causal, B, S, H, Hkv, D, row lengths
    ("dpo", True, 2, 1024, 32, 32, 128, (1000, 900)),
    ("gqa", True, 2, 640, 32, 8, 128, (640, 601)),
    ("vit", False, 2, 577, 16, 16, 64, (577, 577)),  # an unfrozen tower's backward
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


DECODE_SHAPES = [  # label, B, nh, nkv, hd, S, live length of every row
    ("decode", 8, 32, 32, 128, 1024, 640),
    ("decode full cache", 8, 32, 32, 128, 1024, 1023),
]
CHUNK_SHAPES = [  # label, lengths, C, nh, nkv, hd, S, layers rotated
    ("verify", (600, 613, 627, 640, 655, 671, 688, 700), 4, 32, 32, 128, 1024, 4),
    ("chat", (620,), 64, 32, 32, 128, 1024, 8),
]

LIBS = ("flash_fwd", "flash_bwd", "int4_matmul", "decode_attention", "chunk_attention")


def build_other(csrc: Path, names=LIBS) -> dict[str, ctypes.CDLL]:
    """The other checkout's libraries, built against its own headers."""
    out_dir = _build.BUILD_DIR / "ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in names:
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
    for label, causal, b, s, h, hkv, d, lens in FLASH_BWD_SHAPES:
        q, do = (torch.randn((b, s, h, d), device=dev, generator=gen).bfloat16() for _ in range(2))
        k, v = (torch.randn((b, s, hkv, d), device=dev, generator=gen).bfloat16()
                for _ in range(2))
        pad = torch.arange(s, device=dev)[None] < torch.tensor(lens, device=dev)[:, None]
        do = torch.where(pad[..., None, None], do, 0).contiguous()
        seg_q = make_segments(b, s, dev, None, pad, Q_PAD_SEG)
        seg_kv = make_segments(b, s, dev, None, pad, KV_PAD_SEG)
        scale = d**-0.5
        o, lse = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv, causal,
                                       scale)
        di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
        rq, rk, rv = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(),
                                               lse, di, seg_q, seg_kv, causal, scale)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

        def make_caller(symbol, outs):
            args = _bwd_args(q, k, v, do, lse, di, seg_q, seg_kv, *outs, causal, scale)

            def make_call(lib):
                fn = getattr(lib, symbol)
                fn.argtypes, fn.restype = _BWD_ARGS, ctypes.c_int
                return lambda: _build.check(fn(*args), symbol)
            return make_call

        turns = in_turns(versions["flash_bwd"], make_caller("flash_bwd_dkv_bf16", (None, dk, dv)),
                         lambda: max(float((dk.float() - rk).abs().max()),
                                     float((dv.float() - rv).abs().max())))
        turns_dq = in_turns(versions["flash_bwd"],
                            make_caller("flash_bwd_dq_bf16", (dq, None, None)),
                            lambda: float((dq[pad].float() - rq[pad]).abs().max()))
        lib = "n/a (GQA)"
        if h == hkv:  # one aten call computing dQ, dK and dV from O and the LSE
            qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
            with torch.no_grad():
                fo = torch.ops.aten._scaled_dot_product_flash_attention(
                    qt, kt, vt, 0.0, causal, False, scale=scale)
            lib_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
            lib_ms = time_ms(lambda: lib_bwd(dot, qt, kt, vt, fo[0], fo[1], fo[2], fo[3], fo[4],
                                             fo[5], 0.0, causal, fo[6], fo[7], scale=scale))
            lib = f"{lib_ms:.4f} ms"
        print(f"flash_bwd_dkv {label} B={b} S={s} H={h} Hkv={hkv} D={d}: {turns} "
              f"aten flash backward (all grads) {lib}", flush=True)
        print(f"flash_bwd_dq {label} B={b} S={s} H={h} Hkv={hkv} D={d} (valid rows): "
              f"{turns_dq}", flush=True)


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


def _cache_kinds(kc, vc):
    """(kind, k, v, k scale, v scale) for a bf16 cache and its int8 codes."""
    (kq, ks), (vq, vs) = quantize_kv(kc), quantize_kv(vc)
    return [("bf16", kc, vc, None, None), ("int8", kq, vq, ks, vs)]


def decode_lines(versions: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    layers = 4
    for label, b, nh, nkv, hd, s, length in DECODE_SHAPES:
        q = torch.randn((b, nh, hd), device=dev, generator=gen).bfloat16()
        kc, vc = (torch.randn((layers, b, nkv, s, hd), device=dev, generator=gen).bfloat16()
                  for _ in range(2))
        cur = [torch.randn((b, nkv, hd), device=dev, generator=gen).bfloat16() for _ in range(2)]
        lengths = torch.full((b,), length, dtype=torch.int32, device=dev)
        live = (torch.arange(s, device=dev) < length)[None, None, None, :]
        o = torch.empty_like(q)
        for kind, kk, vv, ks, vs in _cache_kinds(kc, vc):
            refs = [decode_mod.decode_attention_plain(
                q.float(), kk[i].float(), vv[i].float(), cur[0].float(), cur[1].float(), lengths,
                hd**-0.5, None if ks is None else ks[i], None if vs is None else vs[i])
                for i in range(layers)]
            last = {}

            def make_call(lib):
                fn = lib.decode_attention
                fn.argtypes, fn.restype = decode_mod._ARGS, ctypes.c_int
                last["call"] = _build.Rotating(fn, [decode_mod.c_args(
                    q, kk, vv, cur[0], cur[1], lengths, o, hd**-0.5, layer, ks, vs)
                    for layer in range(layers)], "decode_attention")
                return last["call"]

            def check():
                return float((o.float() - refs[last["call"].index]).abs().max())

            turns = in_turns(versions["decode_attention"], make_call, check)
            kd = [kk[i] if ks is None else dequantize_kv(kk[i], ks[i], torch.bfloat16)
                  for i in range(layers)]
            vd = [vv[i] if vs is None else dequantize_kv(vv[i], vs[i], torch.bfloat16)
                  for i in range(layers)]
            pairs = itertools.cycle(list(zip(kd, vd)))
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], *next(pairs),
                                                                  attn_mask=live))
            print(f"decode_attention {label} {kind} B={b} nh={nh} nkv={nkv} hd={hd} S={s} "
                  f"length {length}: {turns} sdpa {sdpa:.4f} ms", flush=True)
            del kd, vd


def chunk_lines(versions: dict, gen: torch.Generator) -> None:
    dev = torch.device("cuda")
    for label, lens, c, nh, nkv, hd, s, layers in CHUNK_SHAPES:
        b = len(lens)
        q = torch.randn((b, c, nh, hd), device=dev, generator=gen).bfloat16()
        kc, vc = (torch.randn((layers, b, nkv, s, hd), device=dev, generator=gen).bfloat16()
                  for _ in range(2))
        lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
        limit = lengths[:, None] + torch.arange(c, device=dev)[None]
        attend = (torch.arange(s, device=dev)[None, None, :] <= limit[:, :, None])[:, None]
        o = torch.empty_like(q)
        for kind, kk, vv, ks, vs in _cache_kinds(kc, vc):
            refs = [chunk_mod.chunk_attention_plain(
                q.float(), kk[i], vv[i], lengths, hd**-0.5, None if ks is None else ks[i],
                None if vs is None else vs[i]) for i in range(layers)]
            last = {}

            def make_call(lib):
                fn = lib.chunk_attention
                fn.argtypes, fn.restype = chunk_mod._ARGS, ctypes.c_int
                last["call"] = _build.Rotating(fn, [chunk_mod.c_args(
                    q, kk, vv, lengths, o, hd**-0.5, layer, ks, vs) for layer in range(layers)],
                    "chunk_attention")
                return last["call"]

            def check():
                return float((o.float() - refs[last["call"].index]).abs().max())

            turns = in_turns(versions["chunk_attention"], make_call, check)
            kd = [kk[i] if ks is None else dequantize_kv(kk[i], ks[i], torch.bfloat16)
                  for i in range(layers)]
            vd = [vv[i] if vs is None else dequantize_kv(vv[i], vs[i], torch.bfloat16)
                  for i in range(layers)]
            pairs = itertools.cycle(list(zip(kd, vd)))
            qt = q.transpose(1, 2)
            sdpa = time_ms(lambda: F.scaled_dot_product_attention(qt, *next(pairs),
                                                                  attn_mask=attend))
            print(f"chunk_attention {label} {kind} B={b} C={c} nh={nh} nkv={nkv} hd={hd} S={s} "
                  f"lengths {list(lens)}: {turns} sdpa {sdpa:.4f} ms", flush=True)
            del kd, vd


GROUPS = {"flash": (flash_lines, "flash_fwd"), "flash_bwd": (flash_bwd_lines, "flash_bwd"),
          "int4": (int4_lines, "int4_matmul"), "decode": (decode_lines, "decode_attention"),
          "chunk": (chunk_lines, "chunk_attention")}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("other_csrc", type=Path, help="the other version's csrc directory")
    parser.add_argument("--only", nargs="+", choices=sorted(GROUPS), default=list(GROUPS),
                        help="the kernel groups to time (default: all)")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ab_kernels: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = [GROUPS[g][1] for g in args.only]
    other = build_other(args.other_csrc, libs)
    versions = {name: {"other": other[name], "this": _build.load(name)} for name in libs}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for group in args.only:
        GROUPS[group][0](versions, gen)


if __name__ == "__main__":
    main()
