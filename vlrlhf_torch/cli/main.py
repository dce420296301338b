"""CLI: `python -m vlrlhf_torch.cli.main serve|dpo|sft|rm|ppo|eval|merge`
(counterpart of vlrlhf_tpu's `vlrlhf` subcommands of those names,
cli/main.py).

Weights come from an HF LLaVA checkpoint directory (--model_name_or_path:
safetensors or pytorch_model*.bin, config.json, tokenizer.json;
cli/loading.py), quantized while they stream in when the run quantizes
anyway (--quantize, --q_lora), or, with --synthetic N, from a scaled-down
family model with seeded random weights and the ToyTokenizer.

serve: the continuous-batching engine behind an HTTP endpoint on one device,
with int8 or int4 weights (--quantize), the fused qkv / gate-up layout
(--fuse_decode), an int8 KV cache (--kv_cache_dtype), speculative decoding
(--speculative_k), /chat sessions (--chat_sessions), N LoRA adapter sets
chosen per request by name (--adapter NAME=PATH, repeatable; PATH is the
`adapters` directory a `dpo` run writes; scale --lora_alpha / --lora_r)
and /score (the mean CE of answers, for remote CE-ranked benchmarks).
eval: one benchmark (--benchmark mme, mmbench, seedbench, seedbench_gen,
mmvet, mmmu, mathvista, pope, vqa) over --data_file: static batches,
--continuous_batching true or --speculative_k K; or, with --endpoint URL,
against a `serve` daemon over HTTP (no model here). It writes
<output_dir>/<benchmark>.json, its .xlsx twin and, with --sqlite_db, one
row of metrics.
eval --judge_model_path loads a second checkpoint as the LLM judge (its LM
only), wrapped in eval.judge.EngineJudge.
dpo: LoRA DPO training on one device on a dataset (--dataset_name
plain_dpo | vlfeedback_paired | vlquery_json | rlhfv over a local
--data_path .json / .jsonl, --image_root, --data_ratio, --score_margin;
data/datasets.py), over a frozen int8 or int4 base with
--q_lora true --bits {8,4}, with any remat policy (--remat_policy), an
unfrozen vision tower (--freeze_vision_tower false) and LoRA targets in the
tower (--lora_target_modules), a holdout eval pass with greedy policy and
reference samples (--eval_steps, --eval_ratio, --eval_samples), periodic
checkpoints and resume (--save_steps, --resume_from_checkpoint) and a
merged save (--merge_adapter_after_training). It writes
<output_dir>/dpo_metrics.jsonl, checkpoints/<step>/, adapters/,
merged/ and dpo_samples.jsonl, in the port's own format
(train/checkpoint.py), not vlrlhf_tpu's orbax, and, from a checkpoint,
merged_hf/: the merged weights as an HF checkpoint (utils/hf_export.py).
sft: LoRA SFT on the assistant tokens (SFTCollator rows; --logits_chunk).
rm: a reward model, LoRA plus a zero-initialised scalar head on the last
real token, Bradley-Terry over [chosen; rejected] pairs; its adapters/
holds "adapters/<key>" and "rm_head/kernel".
ppo: PPO on one model: rollouts with the policy's adapters (static in
chunks of --rollout_chunk_size, or --rollout_continuous_batching), the
reward of an rm run (--reward_model_path, its adapters held as a named set
on the same base) or with --synthetic a length reward, the adapter-off
reference, the stats pass and --ppo_epochs over --minibatch_size
minibatches, value head on the policy trunk or its own LoRA set
(--use_value_adapter); <output_dir>/ppo_metrics.jsonl, ppo_gamelog.jsonl,
checkpoints/ and adapters/ ("adapters/<key>", "v_head/kernel"[,
"value_adapters/<key>"]). sft, rm and ppo share dpo's training flags
(`setup_training`: --q_lora, --lora_*, the optimizer).
merge: --adapter_path (a training run's adapters/; of an rm or ppo run
only the LoRA adapters) folded into the checkpoint's weights; writes
<output_dir>/merged and, with --export_format hf, <output_dir>/merged_hf.

Multi-GPU (dpo, sft, rm, ppo; eval's rows): launched by torchrun (`torchrun
--standalone --nproc_per_node N -m vlrlhf_torch.cli.main dpo --mesh_fsdp -1
...`), each process takes cuda:LOCAL_RANK (or the CPU with --device cpu,
over gloo), joins the process group and the (data, fsdp, model) mesh of
--mesh_data / --mesh_fsdp / --mesh_model (core/mesh.py), and the model is
placed by core/partitioning.py after quantization and the adapters:
FSDP2 over data x fsdp, tensor parallelism over model.
--per_device_train_batch_size is rows per data-parallel rank: the global
batch is that times data x fsdp, and the ranks of one model group read the
same rows. Metrics are means over the ranks, written by rank 0, which also
writes the checkpoints (the world-1 tensors, so they resume under any
layout) and adapters/, merged/, merged_hf/ (the
files of a single-process run). Generation under the mesh (ppo's
rollouts, dpo's --eval_samples) runs on the gathered FSDP2 units and,
under a pipeline, the whole stack (every stage's layers joined on each
rank for the block, core/partitioning.py whole_stack), with the KV caches
and decode attention at a rank's heads, the sampled tokens of the model x
pipe ranks of one data-parallel coordinate broadcast from their first rank
each step; ppo's data-parallel
ranks roll out their own prompts and its statistics (score moments,
whitening, mean KL, the update's permutation and masked means) are the
global batch's (train/ppo.py), with one vote per outer step on a failed
rollout or reward. eval under torchrun gives each rank a contiguous shard
of the rows and its own whole model; rank 0 gathers, judges, scores and
writes. Without torchrun nothing of this runs. `--sequence_parallel_axis
fsdp` (dpo, sft, rm, ppo under torchrun) splits each sequence over the
fsdp ranks, which then read the same rows: the global batch is
--per_device_train_batch_size x data, every layer runs on a rank's
contiguous slice and attention is a ring over the fsdp group
(ops/ring_attention.py). `--sequence_parallel_axis model` splits it over
the tensor-parallel ranks (Megatron-LM's sequence parallelism: the
sequence gathered before the column linears and scattered after the row
ones, attention on a rank's heads over the whole sequence; the rows ride
data x fsdp as without a split). Either way the collator's bucket (and
ppo's rollout batch, for its stats pass and update: train/ppo.py
pad_to_split) is rounded up to a multiple of the split, and generation
(ppo's rollouts, dpo's --eval_samples) and ppo's reward model run unsplit
(core/dist.py unsplit), the ranks of a ring decoding and scoring their
rows together as a tensor-parallel group does. `--mesh_pipe S` (dpo, sft, rm, ppo under torchrun)
is the GPipe pipeline (models/lm/pipeline.py): each of S stages of data x
fsdp x model ranks holds L / S decoder layers, the rows of each batch
cross the stages as --pipeline_microbatches microbatches (0: S), and the
stages read the same rows, so the global batch is
--per_device_train_batch_size x data x fsdp; ppo's reward, stats pass and
update run through it, its rollouts and dpo's --eval_samples on the whole
stack. Refused by name before anything loads: a layer count S does not
divide, rows per data-parallel rank (dpo's and rm's are 2 x pairs) the
microbatches do not divide, a ppo minibatch share per data-parallel rank
they do not divide or a stats slice of fewer rows than microbatches, the
pipeline with the sequence split, --pipeline_microbatches without a
pipeline, the sequence split over `data` (which holds the rows) or an
unknown axis, a split without torchrun. Refused, as later parts of the
multi-GPU work (ROADMAP.md): eval with mesh flags (serve takes none).

--report_to takes jsonl (the metrics file, as always); wandb and any other
name are refused by name (vlrlhf_tpu drops wandb silently when it cannot
start a run).

Flag names follow vlrlhf_tpu's. Differences: `--device` names the device
explicitly (default cuda; an absent device is an error, never a silent CPU
run). ppo reads --reward_model_path also with --synthetic (vlrlhf_tpu
scores synthetic runs by length whatever the flag says). Images are JPEGs
decoded by the native loader (data/native_image.py; no PIL). --synthetic N
gives a scaled-down family model with seeded random weights and the
ToyTokenizer (for dpo and rm also N synthetic preference pairs, for sft
and ppo N prompts with one answer, for every path all-zero images). Its
widths (hidden 32, intermediate 64) are no multiple of 128, so
--quantize int4 and --q_lora --bits 4 quantize every selected linear to
int8 there, as vlrlhf_tpu does (ops/quant.py). A flag of
vlrlhf_tpu's that the port does not honour is refused with an error,
never ignored (sft, rm and ppo refuse --eval_steps and
--freeze_vision_tower, which vlrlhf_tpu accepts there and ignores; ppo
refuses --num_train_epochs). As in vlrlhf_tpu, --use_lora false still trains
LoRA adapters: it only turns LoRA dropout off and counts 6N training FLOPs.

`load_bundle` / `load_rows` give the model and the dataset rows;
`build_server` / `build_dpo` / `build_sft` / `build_rm` / `build_ppo` /
`build_eval` are the bodies of the commands minus argument parsing and the
loop; `train_steps` is the loop of dpo, sft and rm with its checkpoints and
resume (`train_dpo` adds the eval hook), `train_ppo` the outer loop of ppo,
`finish_run` the final saves, `load_judge` and `run_eval` the benchmark
run. chip_smoke.py drives the same functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from typing import TYPE_CHECKING, Callable, Optional

import numpy as np
import torch

if TYPE_CHECKING:
    from vlrlhf_torch.data.collators import DPOCollator
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.lora.lora import LoraConfig
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.train.dpo import DPOConfig
    from vlrlhf_torch.train.ppo import PPOConfig
    from vlrlhf_torch.train.train_state import OptimizerConfig, TrainState


def resolve_device(name: str) -> torch.device:
    """--device as a torch.device; a bare "cuda" under torchrun is the
    process's cuda:LOCAL_RANK."""
    from vlrlhf_torch.core.dist import launched_by_torchrun, local_device

    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    if dev.type not in ("cuda", "cpu"):
        raise SystemExit(f"--device {name}: only cuda and cpu are supported")
    if dev.type == "cuda" and dev.index is None and launched_by_torchrun():
        dev = local_device("cuda")
    return dev


PART2 = "later multi-GPU work (ROADMAP.md)"
PAIRS = ("dpo", "rm")  # commands whose rows are [chosen; rejected] pairs


def lm_layers(args) -> int:
    """The LM's layer count, from the config alone (no weights load): the
    --synthetic family's scaled-down config or the checkpoint's
    config.json."""
    import json
    import os

    from vlrlhf_torch.models.config import FAMILIES, scale_down

    if args.synthetic or not getattr(args, "model_name_or_path", None):
        return scale_down(FAMILIES[args.model_family].make_config()).lm.num_layers
    from vlrlhf_torch.cli.loading import config_from_hf

    with open(os.path.join(args.model_name_or_path, "config.json")) as f:
        return config_from_hf(json.load(f))[1].lm.num_layers


def check_pipeline_flags(args) -> None:
    """--mesh_pipe / --pipeline_microbatches on dpo, sft, rm or ppo: every
    refusal by name, before anything loads."""
    pipe, micro = args.mesh_pipe, args.pipeline_microbatches
    if micro < 0 or pipe < 1:
        raise SystemExit(f"--mesh_pipe {pipe} --pipeline_microbatches {micro}: expected a stage "
                         "count >= 1 and a microbatch count >= 0")
    if micro and pipe == 1:
        raise SystemExit(f"--pipeline_microbatches {micro}: it splits the rows of a pipeline, "
                         "which needs --mesh_pipe > 1")
    if pipe == 1:
        return
    if args.sequence_parallel_axis:
        raise SystemExit(f"--mesh_pipe {pipe} with --sequence_parallel_axis "
                         f"{args.sequence_parallel_axis}: the pipeline and the sequence split "
                         "are mutually exclusive (as in vlrlhf_tpu, models/lm/pipeline.py:87-91)")
    m = micro or pipe
    if args.command == "ppo":
        check_ppo_microbatches(args, m)
    else:
        rows = args.per_device_train_batch_size * (2 if args.command in PAIRS else 1)
        if rows % m:
            what = (f"{args.per_device_train_batch_size} pairs = {rows} rows"
                    if args.command in PAIRS else f"{rows} rows")
            raise SystemExit(f"--mesh_pipe {pipe}: {what} per data-parallel rank "
                             f"(--per_device_train_batch_size) do not split into {m} pipeline "
                             "microbatches (--pipeline_microbatches)")
    n_layers = lm_layers(args)
    if n_layers % pipe:
        raise SystemExit(f"--mesh_pipe {pipe}: the LM's {n_layers} layers do not split into "
                         f"{pipe} equal stages")


def check_ppo_microbatches(args, m: int) -> None:
    """ppo under a pipeline of `m` microbatches: a data-parallel rank's
    share of each global minibatch (the update's rows, and the stats
    pass's slices) must split into m equal microbatches, as vlrlhf_tpu
    asserts b % m == 0 (models/lm/pipeline.py:101-105); the stats pass's
    last slice of a rank's rows, where the minibatch does not divide them,
    runs uneven microbatches (microbatch_spans) and needs m rows at least.
    The data-parallel ranks are counted at the launch's world size."""
    import os

    from vlrlhf_torch.core.mesh import MeshConfig

    fixed = [n for n in (args.mesh_data, args.mesh_fsdp, args.mesh_model, args.mesh_pipe)
             if n > 0]
    world = int(os.environ.get("WORLD_SIZE", 0)) or math.prod(fixed)
    try:
        data, fsdp, _, _ = MeshConfig(args.mesh_data, args.mesh_fsdp, args.mesh_model,
                                      args.mesh_pipe).resolve(world)
    except ValueError:
        return  # setup_mesh refuses the mesh itself
    dp, per = data * fsdp, args.per_device_train_batch_size
    mb = min(args.minibatch_size, per * dp) if args.minibatch_size else per * dp
    share = mb // dp
    tail = per % share if share else 0
    if share % m:
        raise SystemExit(f"--mesh_pipe {args.mesh_pipe}: a PPO minibatch of {mb} rows gives each "
                         f"of the {dp} data-parallel ranks {share} rows, which do not split into "
                         f"{m} pipeline microbatches (--minibatch_size, "
                         "--per_device_train_batch_size, --pipeline_microbatches)")
    if 0 < tail < m:
        raise SystemExit(f"--mesh_pipe {args.mesh_pipe}: the stats pass's last slice of a rank's "
                         f"{per} rollouts holds {tail} rows, fewer than the {m} pipeline "
                         "microbatches (--minibatch_size, --per_device_train_batch_size)")


def setup_mesh(args, device: torch.device):
    """The process group and the (pipe, data, fsdp, model) mesh of a
    torchrun launch (core/dist.py, core/mesh.py), with
    --sequence_parallel_axis fsdp a sequence-parallel one, with --mesh_pipe
    S a pipeline of S stages, or None for a plain run, which must then ask
    for one device. Refusals come first, by name."""
    from vlrlhf_torch.core import dist
    from vlrlhf_torch.core.mesh import MeshConfig, check_sp_axis, make_mesh

    axis = args.sequence_parallel_axis
    try:
        check_sp_axis(axis)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    check_pipeline_flags(args)
    mcfg = MeshConfig(args.mesh_data, args.mesh_fsdp, args.mesh_model, args.mesh_pipe)
    if not dist.launched_by_torchrun():
        if axis:
            flag = "--mesh_model" if axis == "model" else "--mesh_fsdp"
            raise SystemExit(f"--sequence_parallel_axis {axis}: the sequence is split over the "
                             "ranks of a mesh launched by torchrun (torchrun --nproc_per_node "
                             f"N ... {flag} N)")
        if args.mesh_pipe > 1:
            raise SystemExit(f"--mesh_pipe {args.mesh_pipe}: the pipeline's stages are the ranks "
                             "of a mesh launched by torchrun (torchrun --nproc_per_node N ... "
                             f"--mesh_pipe {args.mesh_pipe})")
        try:
            mcfg.resolve(1)
        except ValueError as e:
            raise SystemExit(f"--mesh_data {args.mesh_data} --mesh_fsdp {args.mesh_fsdp} "
                             f"--mesh_model {args.mesh_model}: {e}; a multi-GPU run is "
                             "launched by torchrun --nproc_per_node N") from None
        return None
    dist.initialize(device.type)
    try:
        return make_mesh(mcfg, device.type, axis, args.pipeline_microbatches)
    except ValueError as e:
        raise SystemExit(str(e)) from None


def refuse_mesh_flags(args, command: str, reason: str) -> None:
    """A command that runs no mesh refuses every mesh flag but the defaults."""
    if args.sequence_parallel_axis:
        raise SystemExit(f"{command} refuses --sequence_parallel_axis "
                         f"{args.sequence_parallel_axis}: it runs no sequence-parallel "
                         f"forward ({PART2})")
    flags = (args.mesh_data, args.mesh_fsdp, args.mesh_model, args.mesh_pipe,
             args.pipeline_microbatches)
    if flags != (1, -1, 1, 1, 0):
        raise SystemExit(f"{command} takes no mesh flags ({reason} {PART2})")


def make_logger(args, name: str, run):
    """The run's MetricsLogger: written by rank 0 only, MFU over every GPU."""
    from vlrlhf_torch.core import dist
    from vlrlhf_torch.train.metrics import MetricsLogger

    return MetricsLogger(args.output_dir, args.run_name or name,
                         report_to=getattr(args, "report_to", "jsonl"),
                         flops_per_token=run.flops_per_token,
                         flops_per_image=run.flops_per_image,
                         n_devices=dist.process_count(), write=dist.is_main_process())


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
        # plain expansion (vlrlhf_tpu's synthetic bundle drops Qwen's wraps)
        image_start_id=None, image_end_id=None, image_pad_id=None,
        max_length=args.max_length,
        max_prompt_length=getattr(args, "max_prompt_length", 512),
    )
    processor = VLProcessor(tok, family.template, ProcessorConfig(**overrides))
    return family, cfg, model, processor


def load_bundle(args, device: torch.device):
    """(family, cfg, model, processor): --synthetic N, or the checkpoint at
    --model_name_or_path (vlrlhf_tpu `_load_bundle`). A run that quantizes
    anyway quantizes while the weights stream in: --quantize takes the LM
    and lm_head (with --judge_model_path also the tower and projector, as
    vlrlhf_tpu plans a co-resident judge), --q_lora the LM's linears (and
    the tower and projector with --q_lora_vision)."""
    if args.synthetic:
        if getattr(args, "model_name_or_path", None):
            raise SystemExit("--synthetic N builds its own model: drop --model_name_or_path")
        return synthetic_bundle(args, device)
    if not getattr(args, "model_name_or_path", None):
        raise SystemExit("give --model_name_or_path (an HF checkpoint directory) or "
                         "--synthetic N")
    from vlrlhf_torch.cli.loading import load_model_bundle
    from vlrlhf_torch.ops import quant

    qbits = QUANT_BITS[str(getattr(args, "quantize", "false")).lower()]
    qpats = None
    if qbits:
        qpats = (quant.SERVE_QUANT_PATTERNS_WIDE if getattr(args, "judge_model_path", None)
                 else quant.DEFAULT_QUANT_PATTERNS)
    elif getattr(args, "q_lora", False) and getattr(args, "use_lora", True):
        qbits = args.bits
        qpats = (quant.TRAIN_QUANT_PATTERNS_WIDE if getattr(args, "q_lora_vision", False)
                 else quant.TRAIN_QUANT_PATTERNS)
    return load_model_bundle(
        args.model_name_or_path, torch.bfloat16 if args.bf16 else torch.float32,
        args.max_length, getattr(args, "max_prompt_length", 512), quantize_patterns=qpats,
        quantize_bits=qbits or 8, device=device, remat_policy=getattr(args, "remat_policy", ""))


def image_loader_for(args):
    """--synthetic runs see all-zero images; a checkpoint run decodes its
    JPEGs with the collators' default (native) loader."""
    if args.synthetic:
        return lambda p, s, m: np.zeros((s, s, 3), np.uint8)
    return None


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


QUANT_BITS = {"false": 0, "true": 8, "int8": 8, "int4": 4}


def serving_weights_(model, args, patterns=None) -> None:
    """--quantize (`patterns`, default the LM's linears and lm_head, in
    place; linears quantized during the load are left as they are) then
    --fuse_decode, the order of vlrlhf_tpu/cli/main.py:1216-1227."""
    from vlrlhf_torch.models.lm.fuse import fuse_lm_
    from vlrlhf_torch.ops.quant import DEFAULT_QUANT_PATTERNS, quantize_params

    patterns = patterns or DEFAULT_QUANT_PATTERNS
    qbits = QUANT_BITS[str(args.quantize).lower()]
    if qbits:
        quantize_params(model, patterns, bits=qbits)
    if getattr(args, "fuse_decode", False):
        fuse_lm_(model.lm)


def generate_config(processor, family, args):
    from vlrlhf_torch.generate.engine import GenerateConfig

    return GenerateConfig(
        max_new_tokens=args.max_new_tokens,
        eos_token_ids=stop_ids(processor, family, bool(args.synthetic)),
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        kv_cache_dtype=args.kv_cache_dtype,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
    )


def collator_config(cfg, family, processor, args, **overrides):
    """The run's CollatorConfig: anyres tiling for a LLaVA-Next checkpoint
    (--synthetic runs keep one image slot, as vlrlhf_tpu's do); under
    sequence parallelism every bucket a multiple of the ring's ranks (the
    padding is masked: the results do not change)."""
    from vlrlhf_torch.core.dist import sp_size
    from vlrlhf_torch.data.collators import CollatorConfig

    return CollatorConfig(
        pad_token_id=processor.tokenizer.pad_token_id or 0,
        # a multiple of the sequence-parallel ring, which splits the bucket
        bucket_multiple=math.lcm(32 if args.synthetic else 128, sp_size()),
        image_size=cfg.vision.image_size,
        resize_mode=family.resize_mode,
        anyres=bool(cfg.grid_pinpoints) and not args.synthetic,
        grid_pinpoints=cfg.grid_pinpoints,
        tile_grid=cfg.vision.image_size // cfg.vision.patch_size,
        sliding_window=cfg.lm.sliding_window or 0,
        **overrides,
    )


def serve_cache_len(ccfg, args) -> int:
    """Slots per sequence of a serving cache: --max_length text tokens plus
    the new tokens, and for anyres images the most image tokens the grid
    can give (one placeholder is in the text already), rounded up to 128."""
    extra = 0
    if ccfg.anyres:
        from vlrlhf_torch.models.anyres import DEFAULT_GRID_PINPOINTS, anyres_max_dims

        extra = anyres_max_dims(ccfg.grid_pinpoints or DEFAULT_GRID_PINPOINTS,
                                ccfg.image_size, ccfg.tile_grid)[1] - 1
    return -(-(args.max_length + extra + args.max_new_tokens) // 128) * 128


def load_adapter_specs(specs) -> tuple[Optional[list], Optional[list]]:
    """--adapter NAME=PATH ... -> (names, adapter sets read from each PATH,
    the `adapters` directory of a training run; an rm or ppo run's LoRA
    adapters only), or (None, None)."""
    from vlrlhf_torch.lora.lora import adapters_of
    from vlrlhf_torch.train.checkpoint import load_params

    if not specs:
        return None, None
    names, sets = [], []
    for spec in specs:
        name, _, path = spec.partition("=")
        if not name or not path:
            raise SystemExit(f"--adapter expects NAME=PATH, got {spec!r}")
        names.append(name)
        sets.append(adapters_of(load_params(path)))
    return names, sets


def build_server(cfg, model, processor, args, image_loader=None):
    """Engine + scheduler thread + HTTP front-end for `model`. Returns
    (httpd, server); the caller runs httpd.serve_forever() (or serves from
    a thread) and stops both. `image_loader(path, size, mode)` replaces
    the native JPEG loader (synthetic runs map paths to seeded arrays). With
    --quantize the LM's linears are quantized in place first
    (vlrlhf_tpu/cli/main.py:1216-1227). --adapter sets are served by name
    (the "adapter" field of /generate), and /score runs the base model's
    CE ranking through an EvalRunner, one request at a time."""
    import threading

    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.server import (
        ChatBackend, EngineServer, RequestBuilder, serve_http,
    )
    from vlrlhf_torch.models.config import FAMILIES

    family = FAMILIES[cfg.family]
    serving_weights_(model, args)
    gen_cfg = generate_config(processor, family, args)
    ccfg = collator_config(cfg, family, processor, args)
    cache_len = serve_cache_len(ccfg, args)
    names, sets = load_adapter_specs(getattr(args, "adapter", None))
    engine = ContinuousEngine(model, gen_cfg, n_slots=args.slots, cache_len=cache_len,
                              speculative_k=args.speculative_k, adapter_sets=sets,
                              lora_scale=getattr(args, "lora_alpha", 16.0)
                              / getattr(args, "lora_r", 64))
    del sets  # the engine keeps only the stacked sets
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
    score_runner = EvalRunner(model, processor, gen_cfg, ccfg, image_loader)
    score_lock = threading.Lock()

    def scorer(rows):
        with score_lock:
            return score_runner.run_vqa_ppl(rows)

    httpd = serve_http(srv, builder, processor.tokenizer, args.host, args.port, chat=chat,
                       scorer=scorer, adapter_names=names)
    return httpd, srv


def cmd_serve(args):
    device = resolve_device(args.device)
    family, cfg, model, processor = load_bundle(args, device)
    httpd, srv = build_server(cfg, model, processor, args, image_loader_for(args))
    print(
        f"serving {family.name} on "
        f"http://{httpd.server_address[0]}:{httpd.server_address[1]} "
        f"({args.slots} slots, cache_len {srv.engine.cache_len}, quantize {args.quantize}, "
        f"fuse_decode {args.fuse_decode}, "
        f"kv {args.kv_cache_dtype}, speculative_k {args.speculative_k}, "
        f"chat_sessions {args.chat_sessions}, adapters {args.adapter or []}, device {device})",
        flush=True,
    )
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        srv.stop()


def load_rows(args) -> list[dict]:
    """--dataset_name's builder over --data_path (a local .json / .jsonl)
    and --image_root; --score_margin for vlfeedback_paired; the first
    --data_ratio of the rows (vlrlhf_tpu `_load_rows`, cli/main.py:219-240)."""
    from vlrlhf_torch.core.dist import main_process_first
    from vlrlhf_torch.data.datasets import DATASET_MAP

    if args.dataset_name not in DATASET_MAP:
        raise SystemExit(f"--dataset_name {args.dataset_name}: expected one of "
                         f"{sorted(DATASET_MAP)}")
    if not args.data_path:
        raise SystemExit(f"--dataset_name {args.dataset_name} needs --data_path (a local .json "
                         "or .jsonl file)")
    kwargs = {"data_path": args.data_path}
    if args.image_root:
        kwargs["image_root"] = args.image_root
    if args.dataset_name == "vlfeedback_paired":
        kwargs["score_margin"] = args.score_margin
    try:
        with main_process_first("dataset_cache"):
            rows = DATASET_MAP[args.dataset_name](**kwargs)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    if args.data_ratio < 1.0:
        rows = rows[: int(len(rows) * args.data_ratio)]
    return rows


def synthetic_rows(n: int, with_pairs: bool = True) -> list[dict]:
    """N synthetic rows (vlrlhf_tpu's `_synthetic_rows`): preference pairs,
    or with `with_pairs` False prompts with one answer (sft, ppo)."""
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        row = {
            "prompt": f"describe item {i} " + " ".join(
                f"w{rng.integers(100)}" for _ in range(int(rng.integers(3, 9)))
            ),
            "img_path": None,
        }
        if with_pairs:
            row["chosen"] = f"a good answer {i} with detail"
            row["rejected"] = f"a bad answer {i}"
        else:
            row["answer"] = f"an answer {i}"
        rows.append(row)
    return rows


@dataclasses.dataclass
class DPORun:
    """Everything a DPO run holds besides its data iterator."""

    model: VLM
    dcfg: DPOConfig
    ocfg: OptimizerConfig
    lcfg: LoraConfig
    state: TrainState
    keys: list  # the adapters' JAX-layout keys, in the optimizer's order
    collator: DPOCollator
    tokenize_fn: Callable[[dict], dict]
    rows: list
    eval_rows: list
    flops_per_token: float
    flops_per_image: float

    def step(self, batch: dict) -> dict:
        """One update on a device batch; metrics stay on the device."""
        from vlrlhf_torch.train.dpo import dpo_step

        return dpo_step(self.model, self.dcfg, self.ocfg, self.state, batch)

    def state_tree(self) -> dict:
        from vlrlhf_torch.train.train_state import state_tree

        return state_tree(self.state, self.keys)


def setup_training(model, args) -> tuple[LoraConfig, OptimizerConfig]:
    """The setup every trainer shares (vlrlhf_tpu `_setup_training`,
    cli/main.py:291-353): with --q_lora the base's linears are quantized in
    place (--bits, TRAIN_QUANT_PATTERNS, or the _WIDE set with
    --q_lora_vision) before the adapters attach (--lora_target_modules; 'auto'
    is the family's default, every LM attention and MLP linear but Qwen's
    MLP down projection, drawn from --seed); under a mesh the plan then
    places the model (core/partitioning.py shard_model_); then the
    optimizer's config. `model` holds its base weights on its device
    already."""
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import shard_model_
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.train.train_state import OptimizerConfig

    if getattr(args, "q_lora", False) and getattr(args, "use_lora", True):
        from vlrlhf_torch.ops.quant import (
            TRAIN_QUANT_PATTERNS, TRAIN_QUANT_PATTERNS_WIDE, quantize_params,
        )

        pats = TRAIN_QUANT_PATTERNS_WIDE if args.q_lora_vision else TRAIN_QUANT_PATTERNS
        quantize_params(model, pats, bits=args.bits)
    # 'auto': the family's LM linears; else comma-separated JAX-layout regexes
    targets = getattr(args, "lora_target_modules", "auto")
    lcfg = LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout,
                      target_patterns=FAMILIES[model.cfg.family].lora_targets
                      if targets == "auto" else tuple(targets.split(",")))
    init_lora(model, lcfg, torch.Generator(device=model.device).manual_seed(args.seed))
    mesh = current_mesh()
    if mesh is not None:
        try:
            shard_model_(model, mesh)
        except ValueError as e:  # a width --mesh_model does not divide
            raise SystemExit(str(e)) from None
    ocfg = OptimizerConfig(
        learning_rate=args.learning_rate, warmup_ratio=args.warmup_ratio,
        total_steps=args.max_steps or 1000, schedule=args.lr_scheduler_type,
        weight_decay=args.weight_decay, max_grad_norm=args.max_grad_norm,
        grad_accum_steps=args.gradient_accumulation_steps,
    )
    return lcfg, ocfg


def mesh_state(state: TrainState, keys: list) -> TrainState:
    """Under a mesh, the state's gradient-norm groups (core/partitioning.py
    attach_norm_groups_); the state itself otherwise."""
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import attach_norm_groups_

    mesh = current_mesh()
    if mesh is not None:
        attach_norm_groups_(state, keys, mesh)
    return state


def build_dpo(cfg, model, processor, args, rows: list, image_loader=None) -> DPORun:
    """`setup_training` (quantization, adapters, optimizer), then the DPO
    config, collator, the holdout split (with --eval_steps) and, with
    --precompute_ref_logps, the reference pass over the training rows."""
    from vlrlhf_torch.data.collators import DPOCollator
    from vlrlhf_torch.data.datasets import train_eval_split
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, precompute_ref_logps
    from vlrlhf_torch.train.flops import dpo_flops_per_token, vision_flops_per_image
    from vlrlhf_torch.train.train_state import init_train_state

    family = FAMILIES[cfg.family]
    use_lora = getattr(args, "use_lora", True)
    eval_rows = []
    if getattr(args, "eval_steps", 0):
        rows, eval_rows = train_eval_split(rows, args.eval_ratio, args.seed)
    lcfg, ocfg = setup_training(model, args)
    dcfg = DPOConfig(
        beta=args.beta, label_smoothing=args.label_smoothing, loss_type=args.loss_type,
        reference_free=args.reference_free, lora_scale=lcfg.scale,
        lora_dropout=args.lora_dropout if use_lora else 0.0, dropout_seed=args.seed,
        frozen_vision=getattr(args, "freeze_vision_tower", True),
        logits_chunk=args.logits_chunk,
    )
    collator = DPOCollator(processor, collator_config(
        cfg, family, processor, args, compute_diff_mask=args.loss_type == "ddpo"), image_loader)
    tokenize_fn = processor.tokenize_row_dpo
    precompute = args.precompute_ref_logps and not dcfg.reference_free
    if precompute:
        rows = precompute_ref_logps(model, dcfg, rows, processor.tokenize_row_dpo, collator,
                                    batch_size=args.per_device_train_batch_size)

        def tokenize_fn(r, _inner=processor.tokenize_row_dpo):
            return dict(_inner(r), ref_chosen_logp=r["ref_chosen_logp"],
                        ref_rejected_logp=r["ref_rejected_logp"])

    keys = lora_keys(model)
    return DPORun(
        model=model, dcfg=dcfg, ocfg=ocfg, lcfg=lcfg,
        state=mesh_state(init_train_state(adapter_params(model), ocfg), keys), keys=keys,
        collator=collator, tokenize_fn=tokenize_fn, rows=rows, eval_rows=eval_rows,
        flops_per_token=dpo_flops_per_token(
            cfg, args.max_length, ref_forward=not (dcfg.reference_free or precompute),
            train_mode="adapter" if use_lora else "full"),
        flops_per_image=vision_flops_per_image(cfg.vision),
    )


def make_eval_hook(run: DPORun, processor, args, logger):
    """The `on_step` of a run with --eval_steps (vlrlhf_tpu/cli/main.py:
    494-586): every eval_steps steps, the eval pass over the holdout
    (eval/* means logged at that step) and, with --eval_samples N, greedy
    64-token generations for the first N holdout prompts with the adapters
    on (policy) and off (reference), appended to
    <output_dir>/dpo_samples.jsonl. None without an eval split. Under a
    mesh every rank runs every eval batch (its metrics are the same on
    each) and rank 0 writes."""
    import json
    import os

    from vlrlhf_torch.core.dist import is_main_process
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import whole_stack
    from vlrlhf_torch.data.collators import GenerationCollator
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.train.dpo import batch_to_device, make_dpo_eval_fn
    from vlrlhf_torch.train.loop import read_metrics

    if not (args.eval_steps and run.eval_rows):
        return None
    eval_fn = make_dpo_eval_fn(run.model, run.dcfg)
    bs = args.per_device_train_batch_size
    batches = [run.collator([processor.tokenize_row_dpo(r) for r in run.eval_rows[i: i + bs]])
               for i in range(0, len(run.eval_rows), bs)]
    pad = processor.tokenizer.pad_token_id or 0
    sample_rows = run.eval_rows[: args.eval_samples]
    sample_gen = sample_batch = None
    if sample_rows:
        gcoll = GenerationCollator(processor, run.collator.cfg, run.collator.image_loader)
        sample_batch = gcoll([processor.generation_row(r["prompt"], r.get("img_path"))
                              for r in sample_rows])
        sample_gen = Generator(run.model, GenerateConfig(max_new_tokens=64, pad_token_id=pad),
                               lora_scale=run.lcfg.scale)

    def on_step(step: int, _metrics=None) -> None:
        if step % args.eval_steps:
            return
        agg: dict = {}
        for eb in batches:
            for k, v in read_metrics(eval_fn(batch_to_device(eb, run.model.device))).items():
                agg.setdefault(k, []).append(v)
        logger.log(step, {k: float(np.mean(v)) for k, v in agg.items()})
        if sample_gen is None:
            return
        outs = {}
        # under a mesh every rank generates the same samples from the
        # gathered units (generation calls module methods outside FSDP2's
        # hooks) and, under a pipeline, every stage's layers joined, a
        # tensor-parallel group on its heads, with the first rank's tokens
        # of its model x pipe ranks
        with whole_stack(run.model, current_mesh()):
            for name, on in (("policy", True), ("ref", False)):
                sample_gen.adapters = on
                outs[name] = sample_gen(sample_batch).cpu().numpy()
        sample_gen.adapters = False
        if not is_main_process():
            return
        with open(os.path.join(args.output_dir, "dpo_samples.jsonl"), "a") as f:
            for i, r in enumerate(sample_rows):
                dec = {k: processor.tokenizer.decode(o[i][o[i] != pad].tolist(),
                                                     skip_special_tokens=True)
                       for k, o in outs.items()}
                f.write(json.dumps({"step": step, "prompt": r["prompt"], **dec}) + "\n")

    return on_step


def maybe_resume(args, run, ckpt, extras: Optional[Callable[[dict], None]] = None) -> int:
    """--resume_from_checkpoint: 'auto' (or 'true') resumes the latest step
    in <output_dir>/checkpoints, a path that manager's latest; `extras`
    takes the checkpoint's extra dict (ppo's KL coefficient). Returns the
    step to count on from (0 for a fresh run)."""
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import shard_full, stage_tree, tp_dim
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.train_state import load_state_tree_

    spec = getattr(args, "resume_from_checkpoint", None)
    if not spec:
        return 0
    mgr = ckpt if spec in ("auto", "true", "True") else CheckpointManager(spec)
    step = mgr.latest_step()
    if step is None:
        print("no checkpoint found; starting fresh", flush=True)
        return 0
    tree, extra = mgr.restore(step)
    if extras is not None and extra:
        extras(extra)
    mesh = current_mesh()
    place = None
    if mesh is not None:
        def place(key, leaf, full):
            return shard_full(full, leaf, tp_dim(key), mesh)

        if mesh.pp is not None:  # a stage restores its layers' leaves
            tree = stage_tree(tree, run.keys)
    load_state_tree_(run.state, run.keys, tree, place=place)
    print(f"resumed from step {step}", flush=True)
    return step


def train_dpo(run: DPORun, processor, args, logger) -> int:
    """The training loop of `dpo`: `train_steps` with the eval hook."""
    return train_steps(run, args, logger, make_eval_hook(run, processor, args, logger))


def train_steps(run, args, logger, on_step=None) -> int:
    """The training loop of dpo, sft and rm: resume, prefetched batches,
    `on_step`, a checkpoint every --save_steps; returns the last step once
    the last checkpoint is on disk."""
    import os

    from vlrlhf_torch.core.dist import data_parallel_slice
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import full_state_tree
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.loop import batch_iterator, prefetch_iterator, run_training

    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"))
    start = maybe_resume(args, run, ckpt)
    global_bs, span = data_parallel_slice(args.per_device_train_batch_size)
    batches = prefetch_iterator(batch_iterator(
        run.rows, run.tokenize_fn, run.collator, args.per_device_train_batch_size,
        args.num_train_epochs, args.seed, global_batch_size=global_bs, process_slice=span))
    mesh = current_mesh()
    state_fn = run.state_tree
    if mesh is not None:  # checkpoints hold the world-1 tensors
        def state_fn():
            return full_state_tree(run.state_tree(), mesh)
    try:
        return run_training(
            run.step, batches, run.model.device, logger, logging_steps=args.logging_steps,
            max_steps=args.max_steps, checkpoint_manager=ckpt, state_fn=state_fn,
            save_steps=args.save_steps, start_step=start, on_step=on_step,
        )
    finally:
        ckpt.close()


def save_merged(model, scale: float, args) -> dict:
    """<output_dir>/merged: every weight with the adapters folded in, a
    quantized base made dense first; from a checkpoint
    (--model_name_or_path) also <output_dir>/merged_hf, the merged weights
    as an HF checkpoint beside the source's config and tokenizer files
    (vlrlhf_tpu `_finish` and `cmd_merge`). Returns the merged state dict.
    Under a mesh the weights are gathered to the world-1 layout and rank 0
    writes the files of a single-process run; the other ranks get {}."""
    import os

    from vlrlhf_torch.core.dist import is_main_process
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import full_model_state
    from vlrlhf_torch.lora.lora import merge_state
    from vlrlhf_torch.train.checkpoint import save_params

    dtype = torch.bfloat16 if getattr(args, "bf16", True) else torch.float32
    merged = merge_state(full_model_state(model, current_mesh(), dtype), scale)
    if not is_main_process():
        return {}
    save_params(os.path.join(args.output_dir, "merged"), merged)
    src = getattr(args, "model_name_or_path", None)
    if src and not args.synthetic and getattr(args, "export_format", "hf") == "hf":
        from vlrlhf_torch.utils.hf_export import export_hf

        export_hf(merged, model.cfg, model.cfg.family, os.path.join(args.output_dir, "merged_hf"),
                  base_dir=src, dtype="bfloat16" if args.bf16 else "float32")
    return merged


def finish_run(run, args) -> None:
    """<output_dir>/adapters (the trained leaves by key: the adapters, and
    for rm / ppo the head and value adapters beside them) and, with
    --merge_adapter_after_training, `save_merged`'s merged (and merged_hf)
    weights, which fold in the policy's adapters only (vlrlhf_tpu
    `_finish`, cli/main.py:366-397). Under a mesh rank 0 writes them from
    the gathered world-1 tensors (every stage's layers under a pipeline):
    the files of a single-process run."""
    import os

    from vlrlhf_torch.core.dist import is_main_process, sync_global_devices
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import full_tensor, gather_stages, tp_dim
    from vlrlhf_torch.train.checkpoint import save_params

    tree = dict(zip(run.keys, run.state.trainable))
    mesh = current_mesh()
    if mesh is not None:
        tree = gather_stages({k: full_tensor(t, tp_dim(k), mesh) for k, t in tree.items()}, mesh)
    if is_main_process():
        save_params(os.path.join(args.output_dir, "adapters"), tree)
    if args.merge_adapter_after_training:
        save_merged(run.model, run.lcfg.scale, args)
    sync_global_devices("finish_run")


def cmd_dpo(args):
    device = resolve_device(args.device)
    if args.synthetic and args.data_path:
        raise SystemExit("--synthetic N makes its own pairs: drop --data_path")
    setup_mesh(args, device)
    rows = synthetic_rows(args.synthetic) if args.synthetic else load_rows(args)
    family, cfg, model, processor = load_bundle(args, device)
    run = build_dpo(cfg, model, processor, args, rows, image_loader_for(args))
    logger = make_logger(args, "dpo", run)
    try:
        step = train_dpo(run, processor, args, logger)
    finally:
        logger.close()
    finish_run(run, args)
    print(f"dpo: step {step} on {device}; metrics in {logger.path}; saved to "
          f"{args.output_dir}", flush=True)


@dataclasses.dataclass
class TrainRun:
    """An sft or rm run besides its data iterator: `step` takes a device
    batch and returns its metrics as 0-dim device tensors."""

    model: VLM
    ocfg: OptimizerConfig
    lcfg: LoraConfig
    state: TrainState
    keys: list  # the trainable leaves' JAX-layout keys, in the optimizer's order
    collator: Callable[[list], dict]
    tokenize_fn: Callable[[dict], dict]
    rows: list
    step: Callable[[dict], dict]
    flops_per_token: float
    flops_per_image: float

    def state_tree(self) -> dict:
        from vlrlhf_torch.train.train_state import state_tree

        return state_tree(self.state, self.keys)


def build_sft(cfg, model, processor, args, rows: list, image_loader=None) -> TrainRun:
    """`setup_training`, then SFT in adapter mode over SFTCollator batches
    of tokenize_row_sft rows (vlrlhf_tpu `cmd_sft`, cli/main.py:600-663)."""
    from vlrlhf_torch.data.collators import SFTCollator
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.train.dpo import adapter_params
    from vlrlhf_torch.train.flops import sft_flops_per_token, vision_flops_per_image
    from vlrlhf_torch.train.sft import SFTConfig, sft_step
    from vlrlhf_torch.train.train_state import init_train_state

    use_lora = getattr(args, "use_lora", True)
    lcfg, ocfg = setup_training(model, args)
    scfg = SFTConfig(lora_scale=lcfg.scale, lora_dropout=args.lora_dropout if use_lora else 0.0,
                     dropout_seed=args.seed, logits_chunk=args.logits_chunk)
    keys = lora_keys(model)
    state = mesh_state(init_train_state(adapter_params(model), ocfg), keys)
    return TrainRun(
        model=model, ocfg=ocfg, lcfg=lcfg, state=state, keys=keys,
        collator=SFTCollator(processor, collator_config(cfg, FAMILIES[cfg.family], processor, args),
                             image_loader),
        tokenize_fn=processor.tokenize_row_sft, rows=rows,
        step=lambda batch: sft_step(model, scfg, ocfg, state, batch),
        flops_per_token=sft_flops_per_token(cfg, args.max_length,
                                            "adapter" if use_lora else "full"),
        flops_per_image=vision_flops_per_image(cfg.vision),
    )


def build_rm(cfg, model, processor, args, rows: list, image_loader=None) -> TrainRun:
    """`setup_training`, then the reward model: the adapters plus a zero
    (H, 1) head, keyed "adapters/<key>" and "rm_head/kernel" as vlrlhf_tpu
    saves {"adapters", "rm_head"}, over RMCollator [chosen; rejected]
    batches (vlrlhf_tpu `cmd_rm`, cli/main.py:666-734)."""
    from vlrlhf_torch.data.collators import RMCollator
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.models.vlm import init_rm_head
    from vlrlhf_torch.train.dpo import adapter_params
    from vlrlhf_torch.train.flops import rm_flops_per_token, vision_flops_per_image
    from vlrlhf_torch.train.rm import RMConfig, rm_step
    from vlrlhf_torch.train.train_state import init_train_state

    use_lora = getattr(args, "use_lora", True)
    lcfg, ocfg = setup_training(model, args)
    rcfg = RMConfig(lora_scale=lcfg.scale, lora_dropout=args.lora_dropout if use_lora else 0.0,
                    dropout_seed=args.seed)
    head = init_rm_head(cfg.lm.hidden_size, model.device)["kernel"]
    keys = [f"adapters/{k}" for k in lora_keys(model)] + ["rm_head/kernel"]
    state = mesh_state(init_train_state(adapter_params(model) + [head], ocfg), keys)
    return TrainRun(
        model=model, ocfg=ocfg, lcfg=lcfg, state=state, keys=keys,
        collator=RMCollator(processor, collator_config(cfg, FAMILIES[cfg.family], processor, args),
                            image_loader),
        tokenize_fn=processor.tokenize_row_dpo, rows=rows,
        step=lambda batch: rm_step(model, rcfg, ocfg, state, head, batch),
        flops_per_token=rm_flops_per_token(cfg, args.max_length,
                                           "adapter" if use_lora else "full"),
        flops_per_image=vision_flops_per_image(cfg.vision),
    )


def _train_cmd(args, name: str, build, with_pairs: bool) -> None:
    """The body of `sft` and `rm`: rows, the model, `build`, the loop, the
    final saves."""
    device = resolve_device(args.device)
    if args.synthetic and args.data_path:
        raise SystemExit("--synthetic N makes its own rows: drop --data_path")
    setup_mesh(args, device)
    rows = synthetic_rows(args.synthetic, with_pairs) if args.synthetic else load_rows(args)
    _, cfg, model, processor = load_bundle(args, device)
    run = build(cfg, model, processor, args, rows, image_loader_for(args))
    logger = make_logger(args, name, run)
    try:
        step = train_steps(run, args, logger)
    finally:
        logger.close()
    finish_run(run, args)
    print(f"{name}: step {step} on {device}; metrics in {logger.path}; saved to "
          f"{args.output_dir}", flush=True)


def cmd_sft(args):
    _train_cmd(args, "sft", build_sft, with_pairs=False)


def cmd_rm(args):
    _train_cmd(args, "rm", build_rm, with_pairs=True)


@dataclasses.dataclass
class PPORun:
    """A ppo run: the policy (the model's adapters), the value head (and
    with --use_value_adapter the named VALUE_SET adapters), the optimizer
    state over all of them, the rollout config and the reward."""

    model: VLM
    pcfg: PPOConfig
    ocfg: OptimizerConfig
    lcfg: LoraConfig
    state: TrainState
    keys: list  # "adapters/<key>", "v_head/kernel"[, "value_adapters/<key>"]
    v_head: dict
    value_adapters: bool
    gen_cfg: GenerateConfig
    gen_collator: Callable[[list], dict]
    rows: list
    # device batch (input_ids, pad_mask, response_mask, pixel_values,
    # image_positions) -> (B,) f32 sequence scores
    reward_fn: Callable[[dict], torch.Tensor]
    flops_per_token: float
    flops_per_image: float

    def state_tree(self) -> dict:
        from vlrlhf_torch.train.train_state import state_tree

        return state_tree(self.state, self.keys)

    def update(self, batch: dict, stats) -> dict:
        """One PPO optimizer step on a minibatch (metrics on the device)."""
        from vlrlhf_torch.train.ppo import ppo_update

        return ppo_update(self.model, self.pcfg, self.ocfg, self.state, self.v_head, batch,
                          stats, self.value_adapters)


REWARD_SET = "reward"  # the named adapter set a --reward_model_path run holds


def reward_model_fn(model, path: str, lora_scale: float):
    """The reward of `ppo --reward_model_path PATH` (an rm run's
    <output_dir>/adapters): its adapters held as the frozen named set
    REWARD_SET on the policy's base and its head, scored under no_grad
    (vlrlhf_tpu cli/main.py:790-807). The policy's adapters are not
    touched. Under a mesh the set is split over --mesh_model like LoRA
    (each rank holds its part of the world-1 adapters) and replicated over
    the data-parallel ranks, as the head is; under a pipeline a stage holds
    its layers' part of the set, and the scores come through the
    schedule. Under a sequence split the scores come from whole sequences
    (core/dist.py unsplit), as the rollouts do: a forward that keeps
    nothing for a backward gains no memory from the split, and the ring's
    bf16 block partials, merged, moved 13e's scores by twice the
    whole-sequence forward's noise on the card (PERF.md §6)."""
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import layer_index, tp_dim, tp_part
    from vlrlhf_torch.lora.lora import adapters_of, set_adapters_
    from vlrlhf_torch.models.common import Ctx
    from vlrlhf_torch.core.dist import unsplit
    from vlrlhf_torch.train.checkpoint import load_params
    from vlrlhf_torch.train.rm import rm_scores

    tree = load_params(path)
    if "rm_head/kernel" not in tree:
        raise SystemExit(f"--reward_model_path {path}: no rm_head/kernel (not an rm run's "
                         "adapters directory)")
    mesh = current_mesh()
    lo, hi = model.lm.layer_span
    held = {k: v for k, v in adapters_of(tree).items()
            if layer_index(k) is None or lo <= layer_index(k) < hi}
    set_adapters_(model, {k: tp_part(v, tp_dim(k), mesh) for k, v in held.items()}, REWARD_SET)
    kernel = tree["rm_head/kernel"].to(model.device, torch.float32)
    ctx = Ctx(adapters=True, lora_scale=lora_scale, adapter_set=REWARD_SET)

    @torch.no_grad()
    def reward_fn(batch: dict) -> torch.Tensor:
        with unsplit():
            return rm_scores(model, kernel, batch, ctx)

    return reward_fn


def synthetic_reward(batch: dict) -> torch.Tensor:
    """--synthetic's reward: the response's share of the row's length
    (vlrlhf_tpu cli/main.py:786-789)."""
    m = batch["response_mask"]
    return (m.sum(dim=1).double() / max(m.shape[1], 1)).float()


def build_ppo(cfg, model, processor, args, rows: list, image_loader=None) -> PPORun:
    """`setup_training`, then PPO's trainables: the policy adapters, a zero
    (H, 1) value head without a bias (cmd_ppo's own), with
    --use_value_adapter a second LoRA set drawn from --seed + 1; the
    sampled rollout config (temperature 1, the family's stop ids) and the
    reward: the rm run at --reward_model_path, else with --synthetic the
    length reward (vlrlhf_tpu `cmd_ppo`, cli/main.py:737-860)."""
    from vlrlhf_torch.data.collators import GenerationCollator
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.lora.lora import init_lora, lora_keys, lora_parameters
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.train.flops import ppo_flops_per_token, vision_flops_per_image
    from vlrlhf_torch.train.ppo import VALUE_SET, PPOConfig
    from vlrlhf_torch.train.train_state import init_train_state

    family = FAMILIES[cfg.family]
    lcfg, ocfg = setup_training(model, args)
    v_head = {"kernel": torch.nn.Parameter(torch.zeros((cfg.lm.hidden_size, 1),
                                                       device=model.device))}
    leaves = [p for _, p in lora_parameters(model)] + [v_head["kernel"]]
    keys = [f"adapters/{k}" for k in lora_keys(model)] + ["v_head/kernel"]
    if args.use_value_adapter:
        init_lora(model, lcfg, torch.Generator(device=model.device).manual_seed(args.seed + 1),
                  adapter_set=VALUE_SET)
        leaves += [p for _, p in lora_parameters(model, VALUE_SET)]
        keys += [f"value_adapters/{k}" for k in lora_keys(model, VALUE_SET)]
    pcfg = PPOConfig(
        lora_scale=lcfg.scale, init_kl_coef=args.init_kl_coef, ppo_epochs=args.ppo_epochs,
        minibatch_size=args.minibatch_size, use_score_scaling=args.use_score_scaling,
        use_score_norm=args.use_score_norm, score_clip=args.score_clip,
        logits_chunk=args.logits_chunk,
    )
    if args.reward_model_path:
        reward_fn = reward_model_fn(model, args.reward_model_path, lcfg.scale)
    elif args.synthetic:
        reward_fn = synthetic_reward
    else:
        raise SystemExit("ppo needs --reward_model_path (an rm run's <output_dir>/adapters) "
                         "or --synthetic N")
    from vlrlhf_torch.core.dist import dp_size

    if args.minibatch_size and args.minibatch_size % dp_size():
        raise SystemExit(f"--minibatch_size {args.minibatch_size}: a global PPO minibatch "
                         f"splits over the {dp_size()} data-parallel ranks")
    pad = processor.tokenizer.pad_token_id or 0
    return PPORun(
        model=model, pcfg=pcfg, ocfg=ocfg, lcfg=lcfg,
        state=mesh_state(init_train_state(leaves, ocfg), keys), keys=keys, v_head=v_head,
        value_adapters=args.use_value_adapter,
        gen_cfg=GenerateConfig(max_new_tokens=args.max_new_tokens, do_sample=True,
                               temperature=1.0, pad_token_id=pad,
                               eos_token_ids=stop_ids(processor, family, bool(args.synthetic))),
        gen_collator=GenerationCollator(processor, collator_config(cfg, family, processor, args),
                                        image_loader),
        rows=rows, reward_fn=reward_fn,
        flops_per_token=ppo_flops_per_token(
            cfg, args.max_length, ppo_epochs=args.ppo_epochs,
            separate_value=args.use_value_adapter,
            train_mode="adapter" if getattr(args, "use_lora", True) else "full"),
        flops_per_image=vision_flops_per_image(cfg.vision),
    )


def prompt_row(processor, row: dict) -> dict:
    """A PPO prompt row for GenerationCollator: the templated prompt with an
    empty assistant turn, and its Q-Former ids for InstructBLIP
    (vlrlhf_tpu cli/main.py:877-893)."""
    return processor.generation_row(row["prompt"], row.get("img_path") or None)


def static_rollouts(gen, pb: dict, chunk_sz: int, generator) -> tuple[np.ndarray, np.ndarray]:
    """(tokens (B, max_new_tokens), resp_lens (B,)) from the static engine in
    chunks of `chunk_sz` rows. An engine length counts decode advances: a
    row that emitted r tokens (its stop token included) advanced r - 1
    times, a first-token stop (masked to empty) 0 times, so resp_len is
    adv + 1 except that 0 stays 0 (vlrlhf_tpu cli/main.py:969-979)."""
    parts, lparts = [], []
    bs = pb["input_ids"].shape[0]
    for cs in range(0, bs, chunk_sz):
        sub = {k: v[cs: cs + chunk_sz] if hasattr(v, "shape") else v for k, v in pb.items()}
        out, st = gen(sub, generator, return_state=True)
        parts.append(out.cpu().numpy())
        lparts.append(st["lengths"].cpu().numpy() - np.asarray(sub["prompt_lens"]))
    tokens = np.concatenate(parts, axis=0)
    adv = np.concatenate(lparts, axis=0)
    if gen.gen_cfg.max_new_tokens == 1:
        return tokens, (tokens != gen.gen_cfg.pad_token_id).sum(axis=1)
    return tokens, np.where(adv == 0, 0, adv + 1)


def continuous_rollouts(engine, pb: dict, prompt_rows: list, generator,
                        max_new_tokens: int, pad_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(tokens, resp_lens) from the continuous engine: one request per
    prompt row, its stop token kept in the response (emit_stop_token)."""
    from vlrlhf_torch.generate.continuous import request_from_batch

    reqs = [request_from_batch(pb, i, row.get("img_path") is not None)
            for i, row in enumerate(prompt_rows)]
    outs = engine.run(reqs, generator)
    tokens = np.full((len(reqs), max_new_tokens), pad_id, np.int32)
    resp_lens = np.zeros((len(reqs),), np.int32)
    for i, toks in enumerate(outs):
        tokens[i, : len(toks)] = toks
        resp_lens[i] = len(toks)
    return tokens, resp_lens


def rows_of(batch: dict, lo: int, hi: int) -> dict:
    """Rows [lo, hi) of a batch (arrays or tensors whose leading axis is its
    rows; anything else as it is)."""
    n = batch["input_ids"].shape[0]
    return {k: v[lo:hi] if hasattr(v, "shape") and len(v.shape) and v.shape[0] == n else v
            for k, v in batch.items()}


def ppo_step(run: PPORun, batch: dict, raw: np.ndarray, moments, kl_ctl, seed: int,
             times: Optional[dict] = None) -> tuple[np.ndarray, float, list]:
    """One outer step after the rollouts and the reward: the global rollout
    batch (host arrays) and its raw scores through preprocess_scores (the
    score moments), the stats pass on this data-parallel rank's rows,
    ppo_update_epochs over the global rows and the KL controller. Returns
    (scores, mean KL, every update's metrics as floats); `times` gets the
    host clock after the stats pass and after the update."""
    import time

    from vlrlhf_torch.core import dist
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.loop import read_metrics
    from vlrlhf_torch.train.ppo import (
        compute_rollout_stats, gather_stats, pad_to_split, ppo_update_epochs, preprocess_scores,
    )

    device = run.model.device
    batch = pad_to_split(batch)  # a sequence split's ranks divide its length
    n = batch["input_ids"].shape[0]
    _, (lo, hi) = dist.data_parallel_slice(n // dist.dp_size())
    tb = batch_to_device(batch, device)
    scores = preprocess_scores(raw, run.pcfg, moments)
    stats = gather_stats(compute_rollout_stats(
        run.model, run.pcfg, run.v_head, rows_of(tb, lo, hi),
        torch.from_numpy(scores[lo:hi]).to(device), kl_ctl.value, run.value_adapters))
    kl = float(stats.kl)
    t_stats = time.perf_counter()
    history: list = []
    ppo_update_epochs(run.update, tb, stats, run.pcfg, seed=seed, history=history)
    history = [read_metrics(m) for m in history]
    kl_ctl.update(kl, n)
    if times is not None:
        times.update(stats=t_stats, update=time.perf_counter())
    return scores, kl, history


def train_ppo(run: PPORun, processor, args, logger, on_step=None) -> int:
    """The outer loop of `ppo` (vlrlhf_tpu cli/main.py:875-1065): per step,
    --per_device_train_batch_size prompt rows per data-parallel rank;
    rollouts from the static engine in chunks of --rollout_chunk_size or,
    with --rollout_continuous_batching, a continuous engine of that many
    slots (one per cache length); the reward, preprocess_scores, the stats
    pass, ppo_update_epochs and the KL controller; the metrics of
    cli/main.py:1011-1024 and <output_dir>/ppo_gamelog.jsonl every 10
    steps. A step whose rollout or reward fails on any rank is skipped by
    every rank, before the score moments see it, and logged as ppo/skipped
    (the vote of vlrlhf_tpu cli/main.py:985-999; here it rides, with the
    SIGTERM flag, the two host gathers the step makes anyway). Checkpoints every --save_steps and at a SIGTERM (the
    world-1 tensors, the KL coefficient and the reward's path beside them);
    resume with --resume_from_checkpoint (the score moments restart, as in
    vlrlhf_tpu; the reward set is read again from --reward_model_path).
    `on_step(step, info)` sees each step's every minibatch metrics and its
    phase times. Returns the last step.

    Under a mesh every rank collates the global batch's prompts and rolls
    out its own rows (the FSDP2 units gathered and, under a pipeline, every
    stage's layers joined for the block, `partitioning.whole_stack`; the
    model x pipe ranks of a data-parallel coordinate decode its rows
    together, their first rank's tokens broadcast each step,
    generate/engine.py), each data-parallel rank
    from its own generator (--seed plus the rank); tokens and rewards meet
    on every rank, so the score moments, the KL controller and the update's
    permutation see the global batch, and the stats pass runs on the rank's
    rows (train/ppo.py). A failure inside a collective (mid-decode, inside
    the reward model's forward) stalls the group rather than skipping: the
    skippable failures are the host-side ones, as in vlrlhf_tpu."""
    import json
    import os
    import time
    import traceback

    from vlrlhf_torch.core import dist
    from vlrlhf_torch.core.mesh import current_mesh
    from vlrlhf_torch.core.partitioning import full_state_tree, whole_stack
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import Generator
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.dpo import batch_to_device
    from vlrlhf_torch.train.loop import PreemptionGuard
    from vlrlhf_torch.train.ppo import AdaptiveKLController, RunningMoments, rollout_to_batch

    model, pcfg = run.model, run.pcfg
    device = model.device
    mesh = current_mesh()
    ckpt = CheckpointManager(os.path.join(args.output_dir, "checkpoints"))
    kl_ctl = AdaptiveKLController(pcfg)
    start = maybe_resume(args, run, ckpt, extras=lambda e: setattr(
        kl_ctl, "value", float(e.get("kl_coef", kl_ctl.value))))
    moments = RunningMoments()
    generator = torch.Generator(device=device).manual_seed(args.seed + dist.process_index())
    pad_id = run.gen_cfg.pad_token_id
    bs = args.per_device_train_batch_size
    global_bs, (lo_r, hi_r) = dist.data_parallel_slice(bs)
    rows = run.rows
    n_steps = args.max_steps or max(len(rows) // global_bs, 1)
    # the engines run the model's own adapters: each step samples with the
    # adapters of the last update
    gen = Generator(model, run.gen_cfg, lora_scale=run.lcfg.scale)
    gen.adapters = True
    chunk_sz = max(1, min(args.rollout_chunk_size, bs))
    engines: dict = {}
    guard = PreemptionGuard().install()
    last_saved = -1
    done = start

    def save(step: int) -> None:
        nonlocal last_saved
        if step != last_saved:
            tree = run.state_tree()
            if mesh is not None:  # checkpoints hold the world-1 tensors
                tree = full_state_tree(tree, mesh)
            ckpt.save(step, tree, extra={"kl_coef": kl_ctl.value,
                                         "reward_model_path": args.reward_model_path or None})
            last_saved = step

    try:
        for it in range(start, n_steps):
            done = it + 1
            lo = (it * global_bs) % len(rows)
            chunk = rows[lo: lo + global_bs]
            if len(chunk) < global_bs:
                chunk = (chunk + rows)[:global_bs]
            prompt_rows = [prompt_row(processor, r) for r in chunk]
            pb = run.gen_collator(prompt_rows)  # the global batch's prompts
            mine = rows_of(pb, lo_r, hi_r)
            t0 = time.perf_counter()
            failed, tokens, resp_lens = False, None, None
            try:
                with whole_stack(model, mesh):
                    if args.rollout_continuous_batching:
                        c_len = -(-(int(np.max(mine["prompt_lens"])) + args.max_new_tokens)
                                  // 128) * 128
                        if c_len not in engines:
                            engines[c_len] = ContinuousEngine(
                                model, run.gen_cfg, n_slots=chunk_sz, cache_len=c_len,
                                adapters=True, lora_scale=run.lcfg.scale, emit_stop_token=True)
                        tokens, resp_lens = continuous_rollouts(
                            engines[c_len], mine, prompt_rows[lo_r:hi_r], generator,
                            args.max_new_tokens, pad_id)
                    else:
                        tokens, resp_lens = static_rollouts(gen, mine, chunk_sz, generator)
            except Exception as e:  # noqa: BLE001 — vlrlhf_tpu's skip, not a crash
                traceback.print_exc()
                print(f"rollout failed at step {it + 1}: {e}", flush=True)
                failed = True
            t_roll = time.perf_counter()
            # the vote rides the two gathers the step makes anyway: the
            # rollouts' tokens, then the rewards (the reward scores the
            # global batch's rows, so it follows the token gather, and a rank
            # whose rollout failed must not leave the others inside the
            # reward model's collectives)
            (failed, preempted), parts = dist.vote_and_gather(
                (failed, guard.flag), (tokens, resp_lens))
            raw = None
            if not failed:
                tokens = np.concatenate([t for t, _ in parts])
                resp_lens = np.concatenate([r for _, r in parts])
                batch = rollout_to_batch(pb, tokens, pad_id, resp_lens=resp_lens)
                try:
                    raw = run.reward_fn(batch_to_device(rows_of(batch, lo_r, hi_r), device))
                    raw = raw.float().cpu().numpy()
                    if not np.all(np.isfinite(raw)):
                        raise ValueError(f"non-finite RM scores: {raw}")
                except Exception as e:  # noqa: BLE001
                    traceback.print_exc()
                    print(f"reward failed at step {it + 1}: {e}", flush=True)
                    failed = True
                (failed, late), parts = dist.vote_and_gather((failed, guard.flag), raw)
                preempted = preempted or late
            if failed:
                logger.log(it + 1, {"ppo/skipped": 1.0})
            else:
                t_reward = time.perf_counter()
                times: dict = {}
                scores, kl, history = ppo_step(run, batch, np.concatenate(parts), moments,
                                               kl_ctl, args.seed + it, times)
                t_stats, t_update = times["stats"], times["update"]
                metrics = dict(history[-1]) if history else {}  # the last update's
                metrics["ppo/mean_score"] = float(np.mean(scores))
                metrics["ppo/kl"] = kl
                metrics["ppo/kl_coef"] = kl_ctl.value
                metrics["perf/interval_tokens"] = float(np.prod(batch["input_ids"].shape))
                metrics["perf/interval_images"] = float(
                    0 if batch.get("pixel_values") is None else batch["pixel_values"].shape[0])
                metrics["ppo/rollout_tok_s"] = float(tokens.size / max(t_roll - t0, 1e-9))
                logger.log(it + 1, metrics)
                if on_step is not None:
                    on_step(it + 1, {"history": history, "resp_lens": resp_lens,
                                     "tokens": tokens, "scores": scores,
                                     "kl_coef": kl_ctl.value,
                                     "moments": (moments.mean, moments.var, moments.count),
                                     "shape": batch["input_ids"].shape, "rollout_s": t_roll - t0,
                                     "reward_s": t_reward - t_roll,
                                     "stats_s": t_stats - t_reward,
                                     "update_s": t_update - t_stats,
                                     "step_s": time.perf_counter() - t0})
                if (it + 1) % args.save_steps == 0:
                    save(it + 1)
                if it % 10 == 0 and dist.is_main_process():
                    toks = tokens[0]
                    resp = processor.tokenizer.decode(toks[toks != pad_id].tolist(),
                                                      skip_special_tokens=True)
                    with open(os.path.join(args.output_dir, "ppo_gamelog.jsonl"), "a") as f:
                        f.write(json.dumps({"step": it + 1, "prompt": chunk[0]["prompt"],
                                            "response": resp,
                                            "score": float(scores[0])}) + "\n")
            if preempted:
                save(it + 1)
                ckpt.wait()
                logger.log(it + 1, {"train/preempted": 1.0})
                print(f"preempted: PPO checkpoint saved at step {it + 1}", flush=True)
                break
    finally:
        guard.uninstall()
        ckpt.close()
    return done


def cmd_ppo(args):
    device = resolve_device(args.device)
    if args.synthetic and args.data_path:
        raise SystemExit("--synthetic N makes its own prompts: drop --data_path")
    setup_mesh(args, device)
    rows = synthetic_rows(args.synthetic, with_pairs=False) if args.synthetic else load_rows(args)
    _, cfg, model, processor = load_bundle(args, device)
    run = build_ppo(cfg, model, processor, args, rows, image_loader_for(args))
    logger = make_logger(args, "ppo", run)
    try:
        step = train_ppo(run, processor, args, logger)
    finally:
        logger.close()
    finish_run(run, args)
    print(f"ppo: step {step} on {device}; metrics in {logger.path}; saved to "
          f"{args.output_dir}", flush=True)


def build_eval(cfg, model, processor, args, image_loader=None):
    """The EvalRunner of `eval` for `model`: --quantize / --fuse_decode
    applied in place (with --judge_model_path the wide pattern set), then
    static, --continuous_batching or --speculative_k generation
    (vlrlhf_tpu/cli/main.py:1070-1144)."""
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.models.config import FAMILIES
    from vlrlhf_torch.ops.quant import SERVE_QUANT_PATTERNS_WIDE

    family = FAMILIES[cfg.family]
    serving_weights_(model, args,
                     SERVE_QUANT_PATTERNS_WIDE if getattr(args, "judge_model_path", None) else None)
    return EvalRunner(
        model, processor, generate_config(processor, family, args),
        collator_config(cfg, family, processor, args), image_loader,
        continuous_batching=args.continuous_batching, speculative_k=args.speculative_k,
        seed=args.seed,
    )


def load_judge(args, device: torch.device):
    """--judge_model_path as an EngineJudge (vlrlhf_tpu/cli/main.py:
    1150-1190): the checkpoint quantized during its load when the eval
    model is (--quantize), its tower and projector dropped (judging is
    text only), 4 greedy tokens per verdict."""
    from vlrlhf_torch.cli.loading import load_model_bundle
    from vlrlhf_torch.data.collators import CollatorConfig
    from vlrlhf_torch.eval.harness import EvalRunner
    from vlrlhf_torch.eval.judge import EngineJudge
    from vlrlhf_torch.generate.engine import GenerateConfig
    from vlrlhf_torch.ops.quant import DEFAULT_QUANT_PATTERNS

    qbits = QUANT_BITS[str(args.quantize).lower()]
    _, jcfg, jmodel, jproc = load_model_bundle(
        args.judge_model_path, torch.bfloat16 if args.bf16 else torch.float32, args.max_length,
        args.max_prompt_length, quantize_patterns=DEFAULT_QUANT_PATTERNS if qbits else None,
        quantize_bits=qbits or 8, device=device)
    jmodel.drop_vision_()
    pad = jproc.tokenizer.pad_token_id or 0
    return EngineJudge(EvalRunner(
        jmodel, jproc, GenerateConfig(max_new_tokens=4, pad_token_id=pad,
                                      kv_cache_dtype=args.kv_cache_dtype),
        CollatorConfig(pad_token_id=pad, bucket_multiple=128,
                       image_size=jcfg.vision.image_size)))


def run_eval(runner, args, progress: bool = True, judge=None) -> dict:
    """run_benchmark with `eval`'s outputs: <output_dir>/<benchmark>.json,
    its .xlsx twin and the --sqlite_db row. Returns the metrics."""
    import os

    from vlrlhf_torch.eval.benchmarks import run_benchmark

    return run_benchmark(
        args.benchmark, runner, args.data_file, args.image_root,
        batch_size=args.per_device_train_batch_size,
        output_json=os.path.join(args.output_dir, f"{args.benchmark}.json"),
        sqlite_db=args.sqlite_db, tag=args.tag, progress=progress, judge=judge,
    )


def cmd_eval(args):
    from vlrlhf_torch.eval.benchmarks import BENCHMARKS

    if args.benchmark not in BENCHMARKS:
        raise SystemExit(f"--benchmark {args.benchmark}: expected one of {sorted(BENCHMARKS)}")
    refuse_mesh_flags(args, "eval", "under torchrun each rank evaluates its shard of the rows "
                                    "with its own whole model; a sharded eval model is")
    if args.endpoint:
        # remote mode: the model lives in a `serve` process; nothing loads here
        from vlrlhf_torch.generate.server import EndpointRunner

        print(run_eval(EndpointRunner(args.endpoint), args), flush=True)
        return
    from vlrlhf_torch.core import dist

    device = resolve_device(args.device)
    dist.initialize(device.type)
    _, cfg, model, processor = load_bundle(args, device)
    runner = build_eval(cfg, model, processor, args, image_loader_for(args))
    # rank 0 alone judges
    judge = load_judge(args, device) if args.judge_model_path and dist.is_main_process() else None
    print(run_eval(runner, args, judge=judge), flush=True)


def cmd_merge(args):
    """--adapter_path (a training run's adapters/) folded into the
    checkpoint's weights: <output_dir>/merged and, with --export_format hf,
    merged_hf (vlrlhf_tpu `cmd_merge`, cli/main.py:1329-1353; the
    reference's merge_peft_model.py). Of an rm or ppo run only the LoRA
    adapters fold in; its rm_head / v_head (and value adapters) stay out."""
    from vlrlhf_torch.lora.lora import adapters_of, set_adapters_
    from vlrlhf_torch.train.checkpoint import load_params

    device = resolve_device(args.device)
    _, _, model, _ = load_bundle(args, device)
    set_adapters_(model, adapters_of(load_params(args.adapter_path)))
    save_merged(model, args.lora_alpha / args.lora_r, args)
    print(f"merged -> {args.output_dir}/merged"
          + (f", HF checkpoint -> {args.output_dir}/merged_hf"
             if args.export_format == "hf" and not args.synthetic else ""), flush=True)


def _bool(x: str) -> bool:
    return x.lower() == "true"


def _add_eval_parser(sub) -> None:
    p = sub.add_parser(
        "eval",
        help="one benchmark in-process (or against a serve daemon with --endpoint); writes "
             "<output_dir>/<benchmark>.json and .xlsx (and a --sqlite_db row)",
    )
    _add_model_args(p, "use a tiny random-weight model (no checkpoint)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--max_prompt_length", type=int, default=512)
    p.add_argument("--benchmark", type=str, required=True)
    p.add_argument("--data_file", type=str, required=True)
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--per_device_train_batch_size", type=int, default=4,
                   help="rows per batch (slots with --continuous_batching true)")
    p.add_argument("--max_new_tokens", type=int, default=64)
    p.add_argument("--sqlite_db", type=str, default=None)
    p.add_argument("--tag", type=str, default=None)
    p.add_argument("--judge_model_path", type=str, default=None,
                   help="an HF checkpoint directory whose LM judges free-form answers (mmvet) "
                        "and unresolved choices")
    p.add_argument("--quantize", type=str, default="false",
                   choices=["false", "true", "int8", "int4"])
    p.add_argument("--kv_cache_dtype", type=str, default="bf16", choices=["bf16", "int8"])
    p.add_argument("--continuous_batching", type=_bool, default=False,
                   help="slot-refill serving of the rows (per_device_train_batch_size slots)")
    p.add_argument("--fuse_decode", type=_bool, default=False)
    p.add_argument("--speculative_k", type=int, default=0,
                   help=">0: prompt-lookup speculative decoding with K-token drafts")
    p.add_argument("--do_sample", type=_bool, default=False)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top_k", type=int, default=None)
    p.add_argument("--top_p", type=float, default=None)
    p.add_argument("--endpoint", type=str, default=None,
                   help="http://host:port of a serve daemon: rows go over /generate and "
                        "/score, no model loads here")
    _add_mesh_args(p)
    p.set_defaults(fn=cmd_eval)


def _add_mesh_args(p) -> None:
    """vlrlhf_tpu's mesh flags. They take effect under torchrun (dpo, sft,
    rm, ppo), and are refused where they are not ported (setup_mesh,
    check_pipeline_flags, ppo, eval)."""
    p.add_argument("--mesh_data", type=int, default=1,
                   help="data-parallel replicas of the sharded model (HSDP)")
    p.add_argument("--mesh_fsdp", type=int, default=-1,
                   help="FSDP2 shards (-1: the ranks the other axes leave)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel ranks (heads and the MLP width split)")
    p.add_argument("--mesh_pipe", type=int, default=1,
                   help="GPipe stages, each holding L / S decoder layers (dpo, sft, rm, ppo "
                        "under torchrun)")
    p.add_argument("--pipeline_microbatches", type=int, default=0,
                   help="microbatches a batch's rows cross the pipeline in (0: one per stage)")
    p.add_argument("--sequence_parallel_axis", type=str, default="",
                   help="fsdp: each sequence split over the fsdp ranks, attention as a ring; "
                        "model: split over the tensor-parallel ranks, gathered around their "
                        "linears (dpo, sft, rm, ppo under torchrun)")


def _add_train_args(p, synthetic_help: str, epochs: bool = True) -> None:
    """The flags dpo, sft, rm and ppo share (vlrlhf_tpu `_common_args`)."""
    _add_model_args(p, synthetic_help)
    _add_mesh_args(p)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--report_to", type=str, default="jsonl",
                   help="comma-separated metric sinks: jsonl (wandb and others are refused)")
    p.add_argument("--max_prompt_length", type=int, default=512)
    p.add_argument("--dataset_name", type=str, default="plain_dpo",
                   help="plain_dpo, vlfeedback_paired, vlquery_json or rlhfv (data/datasets.py)")
    p.add_argument("--data_path", type=str, default=None,
                   help="the dataset as a local .json or .jsonl file")
    p.add_argument("--image_root", type=str, default="",
                   help="directory the rows' image paths are relative to")
    p.add_argument("--data_ratio", type=float, default=1.0,
                   help="train on the first fraction of the rows")
    p.add_argument("--score_margin", type=float, default=-1,
                   help="vlfeedback_paired: keep pairs whose rating gap is at least this; -1 "
                        "keeps each sample's largest-gap pairs")
    p.add_argument("--per_device_train_batch_size", type=int, default=4)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--learning_rate", type=float, default=1e-5)
    if epochs:
        p.add_argument("--num_train_epochs", type=float, default=1.0)
    p.add_argument("--max_steps", type=int, default=0)
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--lr_scheduler_type", type=str, default="cosine",
                   choices=["cosine", "linear", "constant"])
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--logging_steps", type=int, default=10)
    p.add_argument("--run_name", type=str, default=None)
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=16.0)
    p.add_argument("--lora_dropout", type=float, default=0.05)
    p.add_argument("--save_steps", type=int, default=500,
                   help="checkpoint every N steps to <output_dir>/checkpoints (3 kept)")
    p.add_argument("--resume_from_checkpoint", type=str, default=None,
                   help="'auto': the latest step in <output_dir>/checkpoints; or a "
                        "checkpoints directory (its latest step)")
    p.add_argument("--merge_adapter_after_training", action="store_true",
                   help="also save <output_dir>/merged: the weights with the adapters "
                        "folded in (a quantized base dequantized to bf16 first)")
    p.add_argument("--use_lora", type=_bool, default=True,
                   help="false: as vlrlhf_tpu, LoRA dropout off and 6N training FLOPs "
                        "(the adapters still train)")
    p.add_argument("--lora_target_modules", type=str, default="auto",
                   help="'auto' (the LM's attention and MLP linears) or comma-separated "
                        "regexes over JAX-layout paths, e.g. vision/.*attn/(wq|wk|wv|wo)/")
    p.add_argument("--remat_policy", type=str, default="",
                   choices=["", "full", "dots", "attn", "mlp", "mlp1", "acts"],
                   help="gradient-checkpoint policy ('' keeps the model default, 'full'; "
                        "'acts' keeps every named per-layer activation)")
    p.add_argument("--q_lora", type=_bool, default=False,
                   help="LoRA over a frozen quantized base: the LM's attention and MLP "
                        "linears (lm_head stays bf16)")
    p.add_argument("--bits", type=int, default=8, choices=[8, 4],
                   help="--q_lora weight bits: 8 = int8 (W8A16), 4 = group-64 int4 (the "
                        "W4A16 kernel forward, its transpose kernel for the activation "
                        "gradients); in not a multiple of 128 falls back to int8")
    p.add_argument("--q_lora_vision", type=_bool, default=False,
                   help="with --q_lora: also quantize the frozen vision tower and projector")


def _add_logits_chunk(p) -> None:
    p.add_argument("--logits_chunk", type=int, default=0,
                   help=">0: chunked lm_head + logp over S-chunks of this size")


def _add_dpo_parser(sub) -> None:
    p = sub.add_parser(
        "dpo",
        help="LoRA DPO training on one device; writes <output_dir>/dpo_metrics.jsonl, "
             "checkpoints/, adapters/ (and merged/, dpo_samples.jsonl)",
    )
    _add_train_args(p, "a tiny random-weight model + N synthetic pairs (no checkpoint)")
    p.add_argument("--eval_steps", type=int, default=0,
                   help="evaluate on the holdout split every N steps")
    p.add_argument("--eval_ratio", type=float, default=0.005)
    p.add_argument("--eval_samples", type=int, default=0,
                   help="generate N policy + reference samples from the holdout at each "
                        "eval (<output_dir>/dpo_samples.jsonl)")
    p.add_argument("--freeze_vision_tower", type=_bool, default=True,
                   help="false: the tower runs inside every forward (under autograd in "
                        "the policy's), so tower LoRA targets train")
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--label_smoothing", type=float, default=0.0)
    p.add_argument("--loss_type", type=str, default="sigmoid",
                   choices=["sigmoid", "hinge", "ipo", "kto_pair", "ddpo"])
    p.add_argument("--reference_free", type=_bool, default=False)
    p.add_argument("--precompute_ref_logps", type=_bool, default=False,
                   help="one adapter-off pass caches the reference logps; train steps "
                        "skip the reference forward")
    _add_logits_chunk(p)
    p.set_defaults(fn=cmd_dpo)


def _add_sft_rm_ppo_parsers(sub) -> None:
    p = sub.add_parser(
        "sft", help="supervised LoRA fine-tuning on one device; writes "
                    "<output_dir>/sft_metrics.jsonl, checkpoints/, adapters/ (and merged/)")
    _add_train_args(p, "a tiny random-weight model + N synthetic rows (no checkpoint)")
    _add_logits_chunk(p)
    p.set_defaults(fn=cmd_sft)
    p = sub.add_parser(
        "rm", help="reward-model training (LoRA + a scalar head) on one device; writes "
                   "<output_dir>/rm_metrics.jsonl, checkpoints/, adapters/ (the adapters and "
                   "rm_head, ppo's --reward_model_path)")
    _add_train_args(p, "a tiny random-weight model + N synthetic pairs (no checkpoint)")
    p.set_defaults(fn=cmd_rm)
    p = sub.add_parser(
        "ppo", help="PPO: rollouts, reward, reference and update on one model (one device, or "
                    "the mesh of a torchrun launch); "
                    "writes <output_dir>/ppo_metrics.jsonl, ppo_gamelog.jsonl, checkpoints/, "
                    "adapters/")
    _add_train_args(p, "a tiny random-weight model + N synthetic prompts and the length "
                       "reward (no checkpoint)", epochs=False)
    _add_logits_chunk(p)
    p.add_argument("--reward_model_path", type=str, default=None,
                   help="an rm run's <output_dir>/adapters: its adapters and head score the "
                        "rollouts on the policy's base")
    p.add_argument("--init_kl_coef", type=float, default=0.2)
    p.add_argument("--max_new_tokens", type=int, default=32)
    p.add_argument("--ppo_epochs", type=int, default=4)
    p.add_argument("--minibatch_size", type=int, default=0,
                   help="inner-update minibatch (0 = the full batch)")
    p.add_argument("--rollout_chunk_size", type=int, default=32)
    p.add_argument("--rollout_continuous_batching", type=_bool, default=False,
                   help="slot-refill rollouts (rollout_chunk_size slots)")
    p.add_argument("--use_value_adapter", type=_bool, default=False,
                   help="a separate LoRA set for the value function")
    p.add_argument("--use_score_scaling", type=_bool, default=False,
                   help="divide the scores by their running std (TRL)")
    p.add_argument("--use_score_norm", type=_bool, default=False,
                   help="also subtract the running mean (needs --use_score_scaling true)")
    p.add_argument("--score_clip", type=float, default=None)
    p.set_defaults(fn=cmd_ppo)


def _add_model_args(p, synthetic_help: str) -> None:
    """Where the weights come from, and on what device in what dtype."""
    p.add_argument("--model_name_or_path", type=str, default=None,
                   help="an HF checkpoint directory of a supported family (config.json, "
                        "*.safetensors or pytorch_model*.bin, and tokenizer.json, "
                        "tokenizer.model or qwen.tiktoken)")
    p.add_argument("--model_family", type=str, default="llava",
                   choices=["llava", "llava_next_vicuna", "llava_next_mistral", "qwen_vl",
                            "internlm_xc2", "instructblip"],
                   help="the --synthetic model's family (a checkpoint names its own)")
    p.add_argument("--synthetic", type=int, default=0, help=synthetic_help)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--bf16", type=_bool, default=True)
    p.add_argument("--max_length", type=int, default=1024,
                   help="longest prompt; a KV cache holds this + max_new_tokens")
    p.add_argument("--seed", type=int, default=42)


def _add_merge_parser(sub) -> None:
    p = sub.add_parser(
        "merge", help="fold a dpo run's adapters into the checkpoint's weights; writes "
                      "<output_dir>/merged (and merged_hf, an HF checkpoint)")
    _add_model_args(p, "a tiny random-weight model (no checkpoint, no HF export)")
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--adapter_path", type=str, required=True,
                   help="a dpo, sft, rm or ppo run's <output_dir>/adapters")
    p.add_argument("--export_format", type=str, default="hf", choices=["hf", "torch"],
                   help="'hf' also writes merged_hf/ (model.safetensors, config and tokenizer "
                        "files), loadable by HF transformers")
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=16.0,
                   help="the merged delta is lora_alpha / lora_r * A B")
    p.set_defaults(fn=cmd_merge)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="vlrlhf-torch")
    sub = parser.add_subparsers(dest="command", required=True)
    _add_dpo_parser(sub)
    _add_sft_rm_ppo_parsers(sub)
    _add_eval_parser(sub)
    _add_merge_parser(sub)
    p = sub.add_parser("serve")
    _add_model_args(p, "use a tiny random-weight model (no checkpoint)")
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
                   help="weights-only int8 (true/int8) or group-64 int4 (the W4A16 kernel) "
                        "of the LM's linears and lm_head; int4 takes linears whose in is a "
                        "multiple of 128 and int8 the rest")
    p.add_argument("--fuse_decode", type=lambda x: x.lower() == "true", default=False,
                   help="fused wqkv / gateup serving weights: 4 weight products per layer "
                        "instead of 7 (models/lm/fuse.py)")
    p.add_argument("--kv_cache_dtype", type=str, default="bf16", choices=["bf16", "int8"],
                   help="int8 halves the KV cache (per-vector scales in the kernels)")
    p.add_argument("--speculative_k", type=int, default=0,
                   help=">0: decode bursts verify K-token prompt-lookup drafts per slot in "
                        "one chunk forward (greedy: same tokens; sampled: same distribution)")
    p.add_argument("--chat_sessions", type=int, default=0,
                   help=">0 enables POST /chat multi-turn sessions, each with its own live "
                        "KV cache, LRU-capped at this many")
    p.add_argument("--adapter", action="append", default=None,
                   help="NAME=PATH (repeatable): serve the LoRA adapters a dpo run wrote to "
                        "PATH (<output_dir>/adapters) under NAME; a /generate body's "
                        "\"adapter\": NAME picks them. All sets share targets and rank")
    p.add_argument("--lora_r", type=int, default=64)
    p.add_argument("--lora_alpha", type=float, default=16.0,
                   help="the adapters' scale is lora_alpha / lora_r")
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
    from vlrlhf_torch.core.dist import shutdown
    from vlrlhf_torch.train.metrics import check_report_to

    if hasattr(args, "report_to"):
        try:  # before anything loads
            check_report_to(args.report_to)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    try:
        args.fn(args)
    finally:
        # a torchrun rank leaves its process group before the interpreter
        # exits: gloo's threads still running at exit abort the process
        # ("terminate called without an active exception")
        shutdown()


if __name__ == "__main__":
    main()
