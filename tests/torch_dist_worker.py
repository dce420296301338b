"""One rank of the port's multi-process CPU checks (gloo), started by
tests/test_torch_dist_*.py with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT). It imports torch and vlrlhf_torch
only.

    python -m tests.torch_dist_worker JOB OUT
    python -m tests.torch_dist_worker --greedy-ppo ARGS...   (cli.main ARGS
                                                              with greedy_rollouts)

JOB is a torch.save of {"cases": [...]}; each case (but "preempt", a
SIGTERM on one rank during run_training, "ppo", "ppo_cli", "sp_ring",
"sp_lm", "whole_stack" and "reward": see their functions) names a mesh
(data, fsdp, model[, pipe]), a kind ("train" or "checkpoint"), a pickled
port model holding its adapters, a global numpy batch and the step's
configs. Every rank applies the plan (core.partitioning.shard_model_),
reads its data-parallel slice of the batch and steps (with "resume_dir"
from that checkpoint's latest step; with "save_dir" saving the state
before step "save_at" as train_steps does; with "sp" "fsdp" or "model" on
a sequence-parallel mesh, whose fsdp or tensor-parallel ranks read the
same rows; with pipe > 1
a pipeline of "micro" microbatches, whose stages read the same rows); rank
0 writes OUT, a torch.save of {case name: {"metrics": [per step, means
over the ranks], "trainable": {key: world-1 numpy}[, "grads": the first
step's gradients, world-1 numpy][, "stages_equal": {key: whether every
stage holds the same bits of a leaf outside the stack's layers, after the
steps}]}}.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import sys

import numpy as np
import torch

from vlrlhf_torch.core import dist as vdist
from vlrlhf_torch.core.mesh import MeshConfig, make_mesh, set_global_mesh
from vlrlhf_torch.core.partitioning import (
    attach_norm_groups_, full_state_tree, full_tensor, gather_stages, pipe_role, shard_full,
    shard_model_, stage_tree, tp_dim,
)
from vlrlhf_torch.lora.lora import lora_keys
from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
from vlrlhf_torch.train.rm import RMConfig, rm_step
from vlrlhf_torch.train.checkpoint import CheckpointManager
from vlrlhf_torch.train.sft import SFTConfig, sft_step
from vlrlhf_torch.train.train_state import (
    OptimizerConfig, init_train_state, load_state_tree_, state_tree,
)

PAIR_KEYS = ("pixel_values", "ref_chosen_logps", "ref_rejected_logps")


def local_batch(batch: dict, kind: str, rank: int, size: int) -> dict:
    """This data-parallel rank's rows of a global batch: a pair batch
    [chosen (B); rejected (B)] keeps [chosen[lo:hi]; rejected[lo:hi]] and
    the per-pair leaves' [lo:hi]; an sft batch its rows [lo:hi]."""
    out = {}
    n = batch["input_ids"].shape[0]
    pairs = kind in ("dpo", "rm")
    per = (n // 2 if pairs else n) // size
    lo, hi = rank * per, (rank + 1) * per
    for k, v in batch.items():
        if pairs and v.shape[0] == n:
            out[k] = np.concatenate([v[lo:hi], v[n // 2 + lo:n // 2 + hi]])
        else:
            out[k] = v[lo:hi]
    return out


def _numpy_tree(tree: dict) -> dict:
    return {k: v.float().cpu().numpy() for k, v in tree.items()}


def stages_equal(state, keys: list, mesh) -> dict:
    """{key: whether every stage holds the same bits} for each leaf outside
    the stack's layers, its Adam moments included ({} without a
    pipeline)."""
    if mesh.pp is None:
        return {}
    out = {}
    for i, k in enumerate(keys):
        if pipe_role(k) == "stage":
            continue
        mine = [vdist.local_tensor(t[i]).detach().clone() for t in (state.trainable, state.mu,
                                                                    state.nu)]
        every: list = [None] * mesh.pipe
        torch.distributed.all_gather_object(every, mine, group=mesh.pipe_group)
        out[k] = all(torch.equal(a, b) for other in every for a, b in zip(mine, other))
    return out


def run_case(case: dict) -> dict:
    torch.manual_seed(0)
    mesh = make_mesh(MeshConfig(*case["mesh"]), "cpu", case.get("sp", ""), case.get("micro", 0))
    model = copy.deepcopy(case["model"])
    kind = case.get("step", "dpo")
    head = None
    shard_model_(model, mesh)
    keys = lora_keys(model)  # a stage's: its layers' adapters and the rest
    params = adapter_params(model)
    if kind == "rm":
        head = torch.nn.Parameter(torch.as_tensor(case["head"]).clone())
        params, keys = params + [head], [f"adapters/{k}" for k in keys] + ["rm_head/kernel"]
    ocfg = OptimizerConfig(**case["ocfg"])
    state = init_train_state(params, ocfg)
    attach_norm_groups_(state, keys, mesh)
    if case.get("resume_dir"):
        tree, _ = CheckpointManager(case["resume_dir"]).restore()
        if mesh.pp is not None:
            tree = stage_tree(tree, keys)
        load_state_tree_(state, keys, tree,
                         place=lambda k, leaf, full: shard_full(full, leaf, tp_dim(k), mesh))
    batch = batch_to_device(local_batch(case["batch"], kind, mesh.dp_rank, mesh.dp_size), "cpu")
    metrics = []
    ckpt = CheckpointManager(case["save_dir"]) if case.get("save_dir") else None
    for i in range(case["steps"]):
        if ckpt is not None and i == case.get("save_at", 1):
            ckpt.save(i, full_state_tree(state_tree(state, keys), mesh))
        if kind == "dpo":
            m = dpo_step(model, DPOConfig(**case["cfg"]), ocfg, state, batch)
        elif kind == "sft":
            m = sft_step(model, SFTConfig(**case["cfg"]), ocfg, state, batch)
        else:
            m = rm_step(model, RMConfig(**case["cfg"]), ocfg, state, head, batch)
        metrics.append({k: float(v) for k, v in vdist.global_metrics(m).items()})
        if i == 0 and case.get("grads"):
            grads = _numpy_tree(gather_stages(
                {k: full_tensor(p.grad if p.grad is not None else torch.zeros_like(p), tp_dim(k),
                                mesh) for k, p in zip(keys, state.trainable)}, mesh))
    if ckpt is not None:
        ckpt.close()
    tree = full_state_tree(state_tree(state, keys), mesh)
    out = {"metrics": metrics, "trainable": _numpy_tree(tree["trainable"]),
           "stages_equal": stages_equal(state, keys, mesh)}
    set_global_mesh(None)
    if case.get("grads"):
        out["grads"] = grads
    return out


def _sp_gather(t: torch.Tensor, mesh) -> np.ndarray:
    """The ring's slices of `t` (dim 1) joined in ring order."""
    parts = [torch.empty_like(t) for _ in range(mesh.sp_size)]
    torch.distributed.all_gather(parts, t.detach().contiguous(), group=mesh.sp.group)
    return torch.cat(parts, dim=1).numpy()


def sp_ring_case(case: dict) -> dict:
    """ops/ring_attention.py's op over the case's sequence-parallel mesh:
    for each of "inputs" ({name: {"q", "k", "v", "pad", "do", "causal"}},
    whole numpy arrays), every rank takes its slice, runs ring_attention
    and the backward of sum(O * dO); rank 0 returns {name: (O, dQ, dK,
    dV)} joined whole."""
    from vlrlhf_torch.ops.ring_attention import ring_attention

    mesh = make_mesh(MeshConfig(*case["mesh"]), "cpu", "fsdp")
    out = {}
    for name, c in case["inputs"].items():
        lo, hi = mesh.sp.span(c["q"].shape[1])
        q, k, v = (torch.from_numpy(c[n][:, lo:hi].copy()).requires_grad_()
                   for n in ("q", "k", "v"))
        o = ring_attention(q, k, v, torch.from_numpy(c["pad"][:, lo:hi].copy()), mesh.sp,
                           causal=c["causal"])
        (o * torch.from_numpy(c["do"][:, lo:hi].copy())).sum().backward()
        out[name] = tuple(_sp_gather(t, mesh) for t in (o, q.grad, k.grad, v.grad))
    set_global_mesh(None)
    return out


def sp_lm_case(case: dict) -> dict:
    """The pickled port model's LM forward (models/lm/llama.py) on the
    case's "ids" and "pad" under the sequence-parallel mesh (over "sp",
    default "fsdp"; under "model" the LM's layers made tensor-parallel
    first): each rank's slice of the logits, joined whole."""
    from vlrlhf_torch.core.partitioning import apply_tensor_parallel_

    axis = case.get("sp", "fsdp")
    mesh = make_mesh(MeshConfig(*case["mesh"]), "cpu", axis)
    model = case["model"]
    if axis == "model":
        model = copy.deepcopy(model)
        apply_tensor_parallel_(model, mesh)
    lm = model.lm
    with torch.no_grad():
        hidden, _ = lm(lm.embed(torch.from_numpy(case["ids"])), torch.from_numpy(case["pad"]))
        logits = lm.head(hidden)
    set_global_mesh(None)
    return {"logits": _sp_gather(logits, mesh)}


def preempt_case(case: dict) -> dict:
    """train/loop.py run_training over `steps` dummy steps, rank `rank`
    sent SIGTERM during step `at`: the step each rank stopped at and the
    checkpoint steps on disk (rank 0 writes them)."""
    import os
    import signal

    from vlrlhf_torch.train.loop import run_training

    done = []

    def step_fn(batch):
        done.append(1)
        if vdist.process_index() == case["rank"] and len(done) == case["at"]:
            os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
        return {"loss": torch.tensor(float(len(done)))}

    ckpt = CheckpointManager(case["save_dir"])
    batches = ({"input_ids": np.zeros((1, 2), np.int64)} for _ in range(case["steps"]))
    last = run_training(step_fn, batches, "cpu", logging_steps=case["logging_steps"],
                        checkpoint_manager=ckpt, state_fn=lambda: {"step": len(done)},
                        save_steps=case["steps"] + 1)
    ckpt.close()
    return {"stopped": vdist.process_allgather(np.asarray(last)).tolist(),
            "saved": ckpt._steps()}


def ppo_case(case: dict) -> dict:
    """PPO under the case's mesh (data, fsdp, model[, pipe]; with "micro"
    microbatches; with "sp" the sequence split over that axis) on a pickled
    port model holding its adapters: unless
    "rollouts" is False, greedy rollouts of the global prompt batch
    ("prompts"; each data-parallel rank
    its rows, static and continuous, on the gathered units and, under a
    pipeline, every stage's layers: core.partitioning whole_stack), with
    "sampled" a sampled static rollout whose ranks draw from different
    seeds, then cli.main's ppo_step on the global rollout ("batch", raw
    scores "raw") with score scaling and the adaptive KL controller. With
    "value" (a LoraConfig's fields) a value set drawn from "value_seed"
    (b offset 0.01) trains beside the policy; with "resume_dir" the state
    and KL coefficient come from that checkpoint (cli.main maybe_resume);
    with "save_dir" the state after the step is saved there as train_ppo
    saves it. Rank 0 returns the tokens (global; "sampled": every rank's),
    every update's metrics, the KL coefficient, the score moments, the
    world-1 trainable leaves after the step, whether every stage holds the
    same bits of each leaf outside the stack, and the decoder's layer
    count inside and after the whole-stack block."""
    import argparse
    import dataclasses
    import gc
    import weakref

    from vlrlhf_torch.cli.main import PPORun, continuous_rollouts, maybe_resume, ppo_step
    from vlrlhf_torch.cli.main import rows_of, static_rollouts
    from vlrlhf_torch.core.partitioning import whole_stack
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora, lora_parameters
    from vlrlhf_torch.train.ppo import VALUE_SET, AdaptiveKLController, PPOConfig, RunningMoments

    torch.manual_seed(0)
    mesh = make_mesh(MeshConfig(*case["mesh"]), "cpu", case.get("sp", ""),
                     microbatches=case.get("micro", 0))
    model = copy.deepcopy(case["model"])
    shard_model_(model, mesh)
    v_head = {"kernel": torch.nn.Parameter(torch.as_tensor(case["v_head"]).clone())}
    leaves = adapter_params(model) + [v_head["kernel"]]
    keys = [f"adapters/{k}" for k in lora_keys(model)] + ["v_head/kernel"]
    if case.get("value"):
        init_lora(model, LoraConfig(**case["value"]),
                  torch.Generator().manual_seed(case["value_seed"]), adapter_set=VALUE_SET)
        value = lora_parameters(model, VALUE_SET)
        with torch.no_grad():
            for name, p in value:
                if name.endswith("lora_b"):
                    p.add_(0.01)
        leaves += [p for _, p in value]
        keys += [f"value_adapters/{k}" for k in lora_keys(model, VALUE_SET)]
    ocfg, pcfg = OptimizerConfig(**case["ocfg"]), PPOConfig(**case["pcfg"])
    state = init_train_state(leaves, ocfg)
    attach_norm_groups_(state, keys, mesh)
    run = PPORun(model=model, pcfg=pcfg, ocfg=ocfg, lcfg=None, state=state, keys=keys,
                 v_head=v_head, value_adapters=bool(case.get("value")), gen_cfg=None,
                 gen_collator=None, rows=[], reward_fn=None, flops_per_token=0.0,
                 flops_per_image=0.0)
    moments, kl_ctl = RunningMoments(), AdaptiveKLController(pcfg)
    if case.get("resume_dir"):
        ns = argparse.Namespace(resume_from_checkpoint=case["resume_dir"])
        maybe_resume(ns, run, None, extras=lambda e: setattr(kl_ctl, "value", e["kl_coef"]))
    out = {"layers": [len(model.lm.layers)]}
    pb = case["prompts"]
    per = pb["input_ids"].shape[0] // mesh.dp_size
    mine = rows_of(pb, mesh.dp_rank * per, (mesh.dp_rank + 1) * per)
    gcfg = GenerateConfig(max_new_tokens=case["new_tokens"], pad_token_id=0)
    gen = Generator(model, gcfg, lora_scale=pcfg.lora_scale)
    gen.adapters = True
    got = {}
    if case.get("rollouts", True):
        stage = list(model.lm.layers)
        with whole_stack(model, mesh):
            out["layers"].append(len(model.lm.layers))
            joined = [weakref.ref(m) for m in model.lm.layers if all(m is not s for s in stage)]
            got["static"] = static_rollouts(gen, mine, 1, None)
            engine = ContinuousEngine(model, gcfg, n_slots=1, cache_len=128, adapters=True,
                                      lora_scale=pcfg.lora_scale, emit_stop_token=True)
            got["continuous"] = continuous_rollouts(engine, mine, [{"img_path": "x"}] * per,
                                                    None, gcfg.max_new_tokens, 0)
            if case.get("sampled"):
                sgen = Generator(model, dataclasses.replace(gcfg, do_sample=True),
                                 lora_scale=pcfg.lora_scale)
                sgen.adapters = True
                seed = torch.Generator().manual_seed(100 + vdist.process_index())
                out["sampled"] = vdist.gather_objects([static_rollouts(sgen, mine, 1, seed)[0]
                                                       .tolist()])
        out["layers"].append(len(model.lm.layers))
        gc.collect()
        out["joined_alive"] = sum(r() is not None for r in joined)
    for kind, (tokens, lens) in got.items():
        _, parts = vdist.vote_and_gather((False,), (tokens, lens))
        out[kind] = (np.concatenate([t for t, _ in parts]), np.concatenate([n for _, n in parts]))
    scores, kl, history = ppo_step(run, case["batch"], case["raw"], moments, kl_ctl, case["seed"])
    tree = full_state_tree(state_tree(state, keys), mesh)
    if case.get("save_dir"):
        from vlrlhf_torch.train.checkpoint import CheckpointManager

        ckpt = CheckpointManager(case["save_dir"])
        ckpt.save(1, tree, extra={"kl_coef": kl_ctl.value})
        ckpt.close()
    out.update(scores=scores, kl=kl, history=history, kl_coef=kl_ctl.value,
               moments=(moments.mean, moments.var, moments.count),
               trainable=_numpy_tree(tree["trainable"]),
               stages_equal=stages_equal(state, keys, mesh))
    set_global_mesh(None)
    return out


def ppo_cli_case(case: dict) -> dict:
    """cli.main's ppo under torchrun's process group (setup_mesh with the
    case's mesh flags, the synthetic bundle, build_ppo, train_ppo) with a
    reward that raises on rank 1 at the first step: every rank skips that
    step. Rank 0 returns the metrics lines and, per logged step, the score
    moments on_step saw."""
    import json
    import os

    from vlrlhf_torch.cli.main import (
        build_parser, build_ppo, make_logger, setup_mesh, synthetic_bundle, synthetic_rows,
        train_ppo,
    )

    args = build_parser().parse_args(case["argv"])
    setup_mesh(args, torch.device("cpu"))
    _, cfg, model, proc = synthetic_bundle(args, torch.device("cpu"))
    run = build_ppo(cfg, model, proc, args, synthetic_rows(args.synthetic, with_pairs=False))
    run.gen_cfg = dataclasses.replace(run.gen_cfg, do_sample=False)
    calls = []
    reward = run.reward_fn

    def flaky(batch):
        calls.append(1)
        if len(calls) == case["fail_at"] and vdist.process_index() == case["fail_rank"]:
            raise RuntimeError("the reward model's host raised")
        return reward(batch)

    run.reward_fn = flaky
    logger = make_logger(args, "ppo", run)
    seen = {}
    train_ppo(run, proc, args, logger,
              on_step=lambda step, info: seen.update({step: info["moments"]}))
    logger.close()
    set_global_mesh(None)
    path = os.path.join(args.output_dir, "ppo_metrics.jsonl")
    lines = [json.loads(x) for x in open(path)] if vdist.is_main_process() else []
    return {"lines": lines, "moments": seen}


def whole_stack_case(case: dict) -> dict:
    """core.partitioning whole_stack on the pickled port model under the
    case's mesh, placed and given a value set (from "value" / "value_seed",
    build_ppo's init_lora) and the reward set of "reward_path"
    (cli.main reward_model_fn): inside the block, every tensor of every
    decoder layer (its
    registered parameters and each named LoRA set's a and b) gathered over
    the tensor-parallel group to its world-1 value, keyed by parameter name
    ("lm.layers.3.wq.weight_q", "lm.layers.3.wq.reward.lora_a"; bf16 ones
    as f32); and the decoder's layer count before, inside and after it."""
    from vlrlhf_torch.cli.main import reward_model_fn
    from vlrlhf_torch.core.partitioning import linear_tp_dim, whole_stack
    from vlrlhf_torch.lora.lora import LoraConfig, init_lora
    from vlrlhf_torch.models.common import Linear
    from vlrlhf_torch.train.ppo import VALUE_SET

    mesh = make_mesh(MeshConfig(*case["mesh"]), "cpu")
    model = copy.deepcopy(case["model"])
    shard_model_(model, mesh)
    init_lora(model, LoraConfig(**case["value"]),
              torch.Generator().manual_seed(case["value_seed"]), adapter_set=VALUE_SET)
    reward_model_fn(model, case["reward_path"], 0.5)
    counts = [len(model.lm.layers)]
    out = {}
    with whole_stack(model, mesh):
        counts.append(len(model.lm.layers))
        for name, mod in model.lm.layers.named_modules(prefix="lm.layers"):
            mode = mod.tp.mode if isinstance(mod, Linear) and mod.tp is not None else None
            leaves = [(leaf, p) for leaf, p in mod._parameters.items() if p is not None]
            for set_name, pair in getattr(mod, "lora_sets", {}).items():
                leaves += [(f"{set_name}.{leaf}", p) for leaf, p in zip(("lora_a", "lora_b"), pair)]
            for leaf, p in leaves:
                # a copy: an FSDP2 unit's gathered storage is freed after the block
                dim = linear_tp_dim(mode, leaf.rsplit(".", 1)[-1])
                out[f"{name}.{leaf}"] = full_tensor(p, dim, mesh).clone()
    counts.append(len(model.lm.layers))
    set_global_mesh(None)
    return {"tensors": {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
                        for k, v in out.items()}, "layers": counts}


def reward_case(case: dict) -> dict:
    """cli.main's reward_model_fn (the rm run at "reward_path" as the
    named set "reward" on the placed model) scoring the case's "batch"
    under its mesh with the sequence split over "sp": every rank holds
    the rows (data x fsdp or data is 1), rank 0 returns its scores and
    whether the mesh's split reads on again after the scoring."""
    from vlrlhf_torch.cli.main import reward_model_fn

    mesh = make_mesh(MeshConfig(*case["mesh"]), "cpu", case["sp"])
    model = copy.deepcopy(case["model"])
    shard_model_(model, mesh)
    scores = reward_model_fn(model, case["reward_path"], 0.5)(
        batch_to_device(case["batch"], "cpu"))
    out = {"scores": scores.numpy(), "split_after": vdist.sp_shard() is mesh.sp}
    set_global_mesh(None)
    return out


CASES = {"preempt": preempt_case, "ppo": ppo_case, "ppo_cli": ppo_cli_case,
         "sp_ring": sp_ring_case, "sp_lm": sp_lm_case, "whole_stack": whole_stack_case,
         "reward": reward_case}


@contextlib.contextmanager
def greedy_rollouts():
    """cli.main's ppo with greedy rollouts (build_ppo's GenerateConfig with
    do_sample=False, where the CLI samples at temperature 1): each
    data-parallel rank draws its own tokens, so only greedy rollouts repeat
    the single-process run under every layout."""
    from vlrlhf_torch.cli import main as cli

    build = cli.build_ppo

    def greedy(*args, **kw):
        run = build(*args, **kw)
        run.gen_cfg = dataclasses.replace(run.gen_cfg, do_sample=False)
        return run

    cli.build_ppo = greedy
    try:
        yield
    finally:
        cli.build_ppo = build


def main(job_path: str, out_path: str) -> None:
    vdist.initialize("cpu")
    job = torch.load(job_path, weights_only=False)
    results = {}
    import time
    for case in job["cases"]:
        t0 = time.time()
        results[case["name"]] = CASES.get(case.get("step"), run_case)(case)
        print("CASE", case["name"], round(time.time() - t0, 1), flush=True)
    if vdist.is_main_process():
        torch.save(results, out_path)
    vdist.sync_global_devices("done")
    vdist.shutdown()


if __name__ == "__main__":
    if sys.argv[1] == "--greedy-ppo":
        from vlrlhf_torch.cli.main import main as cli_main

        with greedy_rollouts():
            cli_main(sys.argv[2:])
    else:
        main(*sys.argv[1:3])


def on_one_thread(fn):
    """`fn` (a test module's fixture) run with torch on one host thread,
    the count restored after: the references a fixture computes beside its
    job's ranks (one thread each, OMP_NUM_THREADS=1). On a loaded box a
    many-threaded op waits for its slowest thread: a fixture's world-1 runs
    took 186 s on 8 threads under the gate's load where they take 18 s on
    an idle box."""
    import functools

    @functools.wraps(fn)
    def run(*args, **kwargs):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            return fn(*args, **kwargs)
        finally:
            torch.set_num_threads(threads)

    return run


class Job:
    """A job's ranks, started at once as subprocesses with torchrun's
    environment on a free local port; `result()` waits for them and reads
    OUT. The caller's process imports nothing from here but this class and
    `on_one_thread`."""

    def __init__(self, cases: list, world: int, tmp, timeout: float = 300.0):
        import os
        import pathlib
        import socket
        import subprocess

        tmp = pathlib.Path(tmp)
        tmp.mkdir(parents=True, exist_ok=True)
        self.job, self.out, self.timeout = tmp / "job.pt", tmp / "out.pt", timeout
        torch.save({"cases": cases}, self.job)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        root = pathlib.Path(__file__).resolve().parents[1]
        self.logs = [tmp / f"rank{r}.log" for r in range(world)]
        self.procs = []
        for r in range(world):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            with open(self.logs[r], "w") as log:
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-m", "tests.torch_dist_worker", str(self.job),
                     str(self.out)], cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT))

    def result(self) -> dict:
        import subprocess

        try:
            rcs = [p.wait(timeout=self.timeout) for p in self.procs]
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
            raise
        if any(rcs):
            tails = [log.read_text()[-3000:] for log in self.logs]
            raise RuntimeError(f"ranks exited {rcs}:\n" + "\n---\n".join(tails))
        return torch.load(self.out, weights_only=False)
