"""CLI: `python -m vlrlhf_torch.cli.main serve|dpo` (counterpart of
vlrlhf_tpu's `vlrlhf serve` and `vlrlhf dpo`, cli/main.py).

serve: the continuous-batching engine behind an HTTP endpoint on one device,
with int8 weights (--quantize), an int8 KV cache (--kv_cache_dtype),
speculative decoding (--speculative_k) and /chat sessions (--chat_sessions).
dpo: LoRA DPO training on one device, writing <output_dir>/dpo_metrics.jsonl.

Flag names follow vlrlhf_tpu's. Differences: `--device` names the device
explicitly (default cuda; an absent device is an error, never a silent CPU
run), and without a checkpoint importer yet, `--synthetic N` is the only
way to get weights: a scaled-down family model with seeded random weights
and the ToyTokenizer (for dpo also N synthetic preference pairs). A flag of
vlrlhf_tpu's dpo that the port does not honour yet is refused with an
error, never ignored; dpo saves no adapters until checkpointing is ported.

`build_server` / `build_dpo` are the bodies of serve / dpo minus argument
parsing and the loop; chip_smoke.py drives the same functions.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from vlrlhf_torch.data.collators import DPOCollator
    from vlrlhf_torch.lora.lora import LoraConfig
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.dpo import DPOConfig
    from vlrlhf_torch.train.train_state import OptimizerConfig, TrainState


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
    cfg = with_remat_policy(scale_down(family.make_config(), dtype=dtype),
                            getattr(args, "remat_policy", ""))
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
        max_length=args.max_length,
        max_prompt_length=getattr(args, "max_prompt_length", 512),
    )
    processor = VLProcessor(tok, family.template, ProcessorConfig(**overrides))
    return family, cfg, model, processor


def with_remat_policy(cfg, policy: str):
    """`cfg` with the LM's remat policy replaced ('' keeps the default)."""
    if not policy:
        return cfg
    return dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, remat_policy=policy))


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
    the PIL loader (synthetic runs map paths to seeded arrays). With
    --quantize int8 the LM's linears are quantized in place first
    (vlrlhf_tpu/cli/main.py:1216-1227)."""
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.generate.server import (
        ChatBackend, EngineServer, RequestBuilder, serve_http,
    )
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.ops.quant import DEFAULT_QUANT_PATTERNS, quantize_params

    family = FAMILIES[cfg.family]
    qbits = {"false": 0, "true": 8, "int8": 8, "int4": 4}[str(args.quantize).lower()]
    if qbits == 4:
        raise SystemExit("vlrlhf-torch serve: not ported yet: --quantize int4 "
                         "(vlrlhf_tpu's option; ROADMAP.md lists when it comes)")
    if qbits:
        quantize_params(model, DEFAULT_QUANT_PATTERNS)
    gen_cfg = GenerateConfig(
        max_new_tokens=args.max_new_tokens,
        eos_token_ids=stop_ids(processor, family, bool(args.synthetic)),
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        kv_cache_dtype=args.kv_cache_dtype,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
    )
    cache_len = -(-(args.max_length + args.max_new_tokens) // 128) * 128
    engine = ContinuousEngine(model, gen_cfg, n_slots=args.slots, cache_len=cache_len,
                              speculative_k=args.speculative_k)
    ccfg = CollatorConfig(
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        bucket_multiple=32 if args.synthetic else 128,
        image_size=cfg.vision.image_size,
        resize_mode=family.resize_mode,
    )
    generator = torch.Generator(device=model.device).manual_seed(args.seed)
    srv = EngineServer(engine, generator=generator).start()
    builder = RequestBuilder(processor, ccfg, image_loader)
    chat = None
    if args.chat_sessions > 0:
        chat = ChatBackend(
            model, processor, ccfg, gen_cfg, cache_len=cache_len,
            max_sessions=args.chat_sessions, image_loader=image_loader,
            generator=torch.Generator(device=model.device).manual_seed(args.seed + 1),
        )
    httpd = serve_http(srv, builder, processor.tokenizer, args.host, args.port, chat=chat)
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
        f"({args.slots} slots, cache_len {srv.engine.cache_len}, quantize {args.quantize}, "
        f"kv {args.kv_cache_dtype}, speculative_k {args.speculative_k}, "
        f"chat_sessions {args.chat_sessions}, device {device})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.stop()


def synthetic_rows(n: int) -> list[dict]:
    """N synthetic preference pairs (vlrlhf_tpu's `_synthetic_rows`)."""
    rng = np.random.default_rng(0)
    return [
        {
            "prompt": f"describe item {i} " + " ".join(
                f"w{rng.integers(100)}" for _ in range(int(rng.integers(3, 9)))
            ),
            "img_path": None,
            "chosen": f"a good answer {i} with detail",
            "rejected": f"a bad answer {i}",
        }
        for i in range(n)
    ]


@dataclasses.dataclass
class DPORun:
    """Everything a DPO run holds besides its data iterator."""

    model: VLM
    dcfg: DPOConfig
    ocfg: OptimizerConfig
    lcfg: LoraConfig
    state: TrainState
    collator: DPOCollator
    tokenize_fn: Callable[[dict], dict]
    rows: list
    flops_per_token: float
    flops_per_image: float

    def step(self, batch: dict) -> dict:
        """One update on a device batch; metrics stay on the device."""
        from vlrlhf_torch.train.dpo import dpo_step

        return dpo_step(self.model, self.dcfg, self.ocfg, self.state, batch)


def build_dpo(cfg, model, processor, args, rows: list, image_loader=None) -> DPORun:
    """Adapters (LoRA on every LM attention and MLP linear), optimizer,
    collator and, with --precompute_ref_logps, the reference pass over
    `rows`. `model` holds seeded base weights on its device already."""
    from vlrlhf_torch.data.collators import CollatorConfig, DPOCollator
    from vlrlhf_torch.lora.lora import LM_ALL_LINEARS, LoraConfig, init_lora
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, precompute_ref_logps
    from vlrlhf_torch.train.flops import dpo_flops_per_token, vision_flops_per_image
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    family = FAMILIES[cfg.family]
    lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout,
                      target_patterns=LM_ALL_LINEARS)
    init_lora(model, lcfg, torch.Generator(device=model.device).manual_seed(args.seed))
    ocfg = OptimizerConfig(
        learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
        total_steps=args.max_steps or 1000, schedule=args.lr_scheduler_type,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps,
    )
    dcfg = DPOConfig(
        beta=args.beta, label_smoothing=args.label_smoothing, loss_type=args.loss_type,
        reference_free=args.reference_free, lora_scale=lcfg.scale,
        lora_dropout=args.lora_dropout, dropout_seed=args.seed,
        logits_chunk=args.logits_chunk,
    )
    collator = DPOCollator(processor, CollatorConfig(
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        bucket_multiple=32 if args.synthetic else 128,
        image_size=cfg.vision.image_size, resize_mode=family.resize_mode,
        compute_diff_mask=args.loss_type == "ddpo",
    ), image_loader)
    tokenize_fn = processor.tokenize_row_dpo
    precompute = args.precompute_ref_logps and not dcfg.reference_free
    if precompute:
        rows = precompute_ref_logps(model, dcfg, rows, processor.tokenize_row_dpo, collator,
                                    batch_size=args.per_device_train_batch_size)

        def tokenize_fn(r, _inner=processor.tokenize_row_dpo):
            return dict(_inner(r), ref_chosen_logp=r["ref_chosen_logp"],
                        ref_rejected_logp=r["ref_rejected_logp"])

    return DPORun(
        model=model, dcfg=dcfg, ocfg=ocfg, lcfg=lcfg,
        state=init_train_state(adapter_params(model), ocfg),
        collator=collator, tokenize_fn=tokenize_fn, rows=rows,
        flops_per_token=dpo_flops_per_token(
            cfg, args.max_length, ref_forward=not (dcfg.reference_free or precompute)),
        flops_per_image=vision_flops_per_image(cfg.vision),
    )


def cmd_dpo(args):
    from vlrlhf_torch.train.loop import batch_iterator, run_training
    from vlrlhf_torch.train.metrics import MetricsLogger

    device = resolve_device(args.device)
    if not args.synthetic:
        raise SystemExit(
            "checkpoint import is not ported yet: run with --synthetic N "
            "(random weights, N synthetic pairs) until utils/hf_port.py has its port"
        )
    family, cfg, model, processor = synthetic_bundle(args, device)
    image_loader = lambda p, s, m: np.zeros((s, s, 3), np.uint8)  # noqa: E731
    run = build_dpo(cfg, model, processor, args, synthetic_rows(args.synthetic), image_loader)
    logger = MetricsLogger(args.output_dir, args.run_name or "dpo",
                           flops_per_token=run.flops_per_token,
                           flops_per_image=run.flops_per_image)
    try:
        steps = run_training(
            run.step,
            batch_iterator(run.rows, run.tokenize_fn, run.collator,
                           args.per_device_train_batch_size, args.num_train_epochs, args.seed),
            device, logger, logging_steps=args.logging_steps, max_steps=args.max_steps,
        )
    finally:
        logger.close()
    print(f"dpo: {steps} steps on {device}; metrics in {logger.path} "
          "(adapters are not saved until checkpointing is ported)", flush=True)


def _bool(x: str) -> bool:
    return x.lower() == "true"


def _add_dpo_parser(sub) -> None:
    p = sub.add_parser(
        "dpo",
        help="LoRA DPO training on one device; writes <output_dir>/dpo_metrics.jsonl "
             "(no adapter checkpoints yet)",
    )
    p.add_argument("--model_family", type=str, default="llava", choices=["llava"])
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--synthetic", type=int, default=0,
                   help="a tiny random-weight model + N synthetic pairs (no checkpoint)")
    p.add_argument("--bf16", type=_bool, default=True)
    p.add_argument("--max_length", type=int, default=1024)
    p.add_argument("--max_prompt_length", type=int, default=512)
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine",
                   choices=["cosine", "linear", "constant"])
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--remat_policy", type=str, default="", choices=["", "full", "attn"],
                   help="gradient-checkpoint policy ('' keeps the model default, 'full')")
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--loss_type", type=str, default="sigmoid",
                   choices=["sigmoid", "hinge", "ipo", "kto_pair", "ddpo"])
    p.add_argument("--reference_free", type=_bool, default=False)
    p.add_argument("--precompute_ref_logps", type=_bool, default=False,
                   help="one adapter-off pass caches the reference logps; train steps "
                        "skip the reference forward")
    p.add_argument("--logits_chunk", type=int, default=0,
                   help=">0: chunked lm_head + logp over S-chunks of this size")
    p.set_defaults(fn=cmd_dpo)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vlrlhf-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_dpo_parser(sub)
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
    p.add_argument("--quantize", type=str, default="false",
                   choices=["false", "true", "int8", "int4"],
                   help="weights-only int8 (true/int8) of the LM's linears; int4 is not "
                        "ported yet")
    p.add_argument("--kv_cache_dtype", type=str, default="bf16", choices=["bf16", "int8"],
                   help="int8 halves the KV cache (per-vector scales in the kernels)")
    p.add_argument("--speculative_k", type=int, default=0,
                   help=">0: decode bursts verify K-token prompt-lookup drafts per slot in "
                        "one chunk forward (greedy: same tokens; sampled: same distribution)")
    p.add_argument("--chat_sessions", type=int, default=0,
                   help=">0 enables POST /chat multi-turn sessions, each with its own live "
                        "KV cache, LRU-capped at this many")
    p.set_defaults(fn=cmd_serve)
    return parser


def main(argv: Optional[list] = None):
    args, unknown = build_parser().parse_known_args(argv)
    flags = [a.split("=")[0] for a in unknown if a.startswith("--")]
    if unknown:
        raise SystemExit(
            f"vlrlhf-torch {args.command}: not ported yet: {' '.join(flags or unknown)} "
            "(vlrlhf_tpu's option; ROADMAP.md lists when it comes)"
        )
    args.fn(args)


if __name__ == "__main__":
    main()
