"""CLI: `python -m vlrlhf_torch.cli.main serve` (counterpart of vlrlhf_tpu's
`vlrlhf serve`, cli/main.py cmd_serve).

Continuous-batching engine behind an HTTP endpoint on one device. Flag
names follow vlrlhf_tpu's. Differences: `--device` names the device
explicitly (default cuda; an absent device is an error, never a silent CPU
run), and without a checkpoint importer yet, `--synthetic N` is the only
way to get weights: a scaled-down family model with seeded random weights
and the ToyTokenizer (N is accepted for parity with vlrlhf_tpu and unused).

`build_server` is the body of `serve` minus argument parsing and the
blocking loop; chip_smoke.py drives the same function.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import numpy as np
import torch


def resolve_device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    return dev


def synthetic_bundle(args, device: torch.device):
    """(family, cfg, model, processor) for a scaled-down family model with
    seeded random weights built on `device`."""
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.vlm import VLM

    family = FAMILIES[args.model_family]
    dtype = torch.bfloat16 if args.bf16 else torch.float32
    cfg = scale_down(family.make_config(), dtype=dtype)
    tok = ToyTokenizer()
    # the vocab must cover the tokenizer's id space
    if cfg.lm.vocab_size < tok.vocab_size:
        cfg = dataclasses.replace(
            cfg, lm=dataclasses.replace(cfg.lm, vocab_size=tok.vocab_size)
        )
    model = VLM(cfg, device=device)
    init_random_(model, torch.Generator(device=device).manual_seed(args.seed))
    overrides = dict(family.processor_defaults)
    overrides.update(
        num_image_tokens=cfg.num_image_tokens,
        image_token_id=3,  # ToyTokenizer <image>
    )
    processor = VLProcessor(tok, family.template, ProcessorConfig(**overrides))
    return family, cfg, model, processor


def stop_ids(processor, family, synthetic: bool) -> tuple:
    """Family stop tokens + tokenizer eos as generation stop ids."""
    ids = tuple(
        processor.tokenizer.convert_token_to_id(t) for t in family.stop_tokens
    ) if family.stop_tokens and not synthetic else ()
    eos = processor.tokenizer.eos_token_id
    if eos is not None:
        ids = ids + (eos,)
    return ids


def build_server(cfg, model, processor, args, image_loader=None):
    """Engine + scheduler thread + HTTP front-end for `model`. Returns
    (httpd, server); the caller runs httpd.serve_forever() (or serves from
    a thread) and stops both. `image_loader(path, size, mode)` replaces
    the PIL loader (synthetic runs map paths to seeded arrays)."""
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.generate.server import EngineServer, RequestBuilder, serve_http
    from vlrlhf_torch.models.config import FAMILIES

    family = FAMILIES[cfg.family]
    gen_cfg = GenerateConfig(
        max_new_tokens=args.max_new_tokens,
        eos_token_ids=stop_ids(processor, family, bool(args.synthetic)),
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
    )
    cache_len = -(-(args.max_length + args.max_new_tokens) // 128) * 128
    engine = ContinuousEngine(model, gen_cfg, n_slots=args.slots, cache_len=cache_len)
    ccfg = CollatorConfig(
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        bucket_multiple=32 if args.synthetic else 128,
        image_size=cfg.vision.image_size,
        resize_mode=family.resize_mode,
    )
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    srv = EngineServer(engine, generator=generator).start()
    builder = RequestBuilder(processor, ccfg, image_loader)
    httpd = serve_http(srv, builder, processor.tokenizer, args.host, args.port)
    return httpd, srv


def cmd_serve(args):
    device = resolve_device(args.device)
    if not args.synthetic:
        raise SystemExit(
            "checkpoint import is not ported yet: run with --synthetic N "
            "(random weights) until utils/hf_port.py has its port"
        )
    family, cfg, model, processor = synthetic_bundle(args, device)
    image_loader = lambda p, s, m: np.zeros((s, s, 3), np.uint8)  # noqa: E731
    httpd, srv = build_server(cfg, model, processor, args, image_loader)
    print(
        f"serving {args.model_family} on "
        f"http://{httpd.server_address[0]}:{httpd.server_address[1]} "
        f"({args.slots} slots, device {device})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.stop()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vlrlhf-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    p = sub.add_parser("serve")
    p.add_argument("--model_family", type=str, default="llava", choices=["llava"])
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--max_length", type=int, default=1024,
                   help="longest prompt; the KV cache holds this + max_new_tokens")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--bf16", type=lambda x: x.lower() == "true", default=True)
    p.add_argument("--synthetic", type=int, default=0,
                   help="use a tiny random-weight model (no checkpoint)")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--slots", type=int, default=8,
                   help="continuous-batching cache slots (concurrent requests)")
    p.add_argument("--max_new_tokens", type=int, default=256)
    p.add_argument("--do_sample", type=lambda x: x.lower() == "true", default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv: Optional[list] = None):
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
