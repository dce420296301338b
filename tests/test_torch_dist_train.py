"""Multi-GPU SFT, RM, LoRA dropout and checkpoints on the CPU (gloo ranks,
tests/torch_dist_worker.py), f32, on the tiny LLaVA with bridged weights
and non-zero adapters (tests/test_torch_dist_dpo.py has the DPO steps):
  - 2 sft and 2 rm steps under fsdp=2 x model=2 against vlrlhf_tpu's
    jitted steps under the same MeshConfig: losses, ppl / accuracy, the
    adapters and the reward head after them, within 1e-5 (the sft loss is
    the token mean over the global batch, whose rows the ranks split);
  - DPO with LoRA dropout 0.05 under model=2 equals the world-1 port within
    1e-5: a row-parallel rank draws the columns of the single-process mask;
  - a DPO checkpoint (rank 0's state.pt of the world-1 tensors) written
    under fsdp=2 x model=2 after one step resumes at world 1 and under
    fsdp=2, and both continue as the straight 3-step run does: losses
    within 1e-5;
  - a SIGTERM on one rank stops both at the next logging step, the only
    steps where the ranks vote, and rank 0 saves that step.
Adam's eps is 1e-3, as in tests/test_torch_dpo.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch
from tests.test_torch_dist_dpo import OPT, STEPS, TOL, _case, _llava, assert_adapters, jax_steps
from tests.torch_dist_worker import Job

FSDP2_MODEL2 = (1, 2, 2)
DROPOUT = 0.05


def _sft_batch() -> dict:
    """4 rows, each with its own image (the pair batch's images tiled)."""
    b = {k: np.asarray(v) for k, v in tiny_batch(jax.random.PRNGKey(5), n_pairs=2).items()}
    b["pixel_values"] = np.concatenate([b["pixel_values"]] * 2)
    return b


def _jax_sft(llava, batch):
    from vlrlhf_tpu.train.sft import SFTConfig, make_sft_step

    jcfg, params, lcfg, adapters = llava[:4]
    return jax_steps(lambda c, tx: make_sft_step(c, SFTConfig(lora_scale=lcfg.scale), tx),
                     jcfg, params, adapters, batch, FSDP2_MODEL2)


def _jax_rm(llava, batch):
    from vlrlhf_tpu.models.vlm import init_rm_head
    from vlrlhf_tpu.train.rm import RMConfig, make_rm_step

    jcfg, params, lcfg, adapters = llava[:4]
    trainable = {"adapters": adapters, "rm_head": init_rm_head(jcfg.lm.hidden_size, jnp.float32)}
    return jax_steps(lambda c, tx: make_rm_step(c, RMConfig(lora_scale=lcfg.scale), tx),
                     jcfg, params, trainable, batch, FSDP2_MODEL2)


def _world1(model, batch, lcfg, steps, dropout=0.0, resume=None) -> list:
    """The single-process port's DPO metrics (optionally from a restored
    state tree)."""
    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.dpo import DPOConfig, adapter_params, batch_to_device, dpo_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state, load_state_tree_

    ocfg = OptimizerConfig(**OPT)
    state = init_train_state(adapter_params(model), ocfg)
    if resume is not None:
        load_state_tree_(state, lora_keys(model), resume)
    dcfg = DPOConfig(beta=0.1, lora_scale=lcfg.scale, lora_dropout=dropout, dropout_seed=7)
    tb = batch_to_device(batch, "cpu")
    return [{k: float(v) for k, v in dpo_step(model, dcfg, ocfg, state, tb).items()}
            for _ in range(steps)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import copy

    tmp = tmp_path_factory.mktemp("dist_train")
    llava = _llava()
    jcfg, params, lcfg, adapters, model, batch = llava
    sft_batch = _sft_batch()
    ckpt = tmp / "ckpt"
    head = np.zeros((jcfg.lm.hidden_size, 1), np.float32)
    first = Job([
        dict(_case("sft", FSDP2_MODEL2, model, sft_batch, lcfg), step="sft",
             cfg=dict(lora_scale=lcfg.scale)),
        dict(_case("rm", FSDP2_MODEL2, model, batch, lcfg), step="rm", head=head,
             cfg=dict(lora_scale=lcfg.scale)),
        dict(_case("straight", FSDP2_MODEL2, model, batch, lcfg), steps=3,
             save_dir=str(ckpt), save_at=1),
    ], 4, tmp / "w4")
    # vlrlhf_tpu's make_mesh registers its mesh globally, and this module
    # fixture runs outside conftest's per-test restore: put the registry
    # back, or later files of this xdist worker run under the (1, 2, 2) mesh
    # (tests/test_mesh_isolation.py fails there)
    from vlrlhf_tpu.core import mesh as jmesh

    prev = jmesh._GLOBAL_MESH
    try:
        want = {"sft": _jax_sft(llava, sft_batch), "rm": _jax_rm(llava, batch)}
    finally:
        jmesh._GLOBAL_MESH = prev
    got = first.result()
    second = Job([
        dict(_case("dropout", (1, 1, 2), model, batch, lcfg,
                   lora_dropout=DROPOUT, dropout_seed=7)),
        dict(_case("resumed/fsdp2", (1, 2, 1), model, batch, lcfg), resume_dir=str(ckpt)),
        dict(name="preempt", step="preempt", steps=8, rank=1, at=3, logging_steps=2,
             save_dir=str(tmp / "preempt")),
    ], 2, tmp / "w2")
    want["dropout"] = _world1(copy.deepcopy(model), batch, lcfg, STEPS, dropout=DROPOUT)
    from vlrlhf_torch.train.checkpoint import CheckpointManager

    tree, _ = CheckpointManager(str(ckpt)).restore()
    got["resumed/world1"] = {"metrics": _world1(copy.deepcopy(model), batch, lcfg, STEPS,
                                                resume=tree)}
    got.update(second.result())
    return got, want


@pytest.mark.parametrize("kind,keys", [("sft", ("loss", "ppl", "grad_norm")),
                                       ("rm", ("loss", "accuracy", "grad_norm"))])
def test_sft_and_rm_steps_match_jax_under_fsdp2_model2(runs, kind, keys):
    got, want = runs
    (wm, wt), g = want[kind], got[kind]
    assert len(g["metrics"]) == len(wm) == STEPS
    for i, (gm, jm) in enumerate(zip(g["metrics"], wm)):
        for k in keys:
            np.testing.assert_allclose(gm[k], jm[k], atol=TOL, rtol=TOL, err_msg=f"{kind} {i} {k}")
    assert_adapters(g["trainable"], wt["adapters"] if kind == "rm" else wt, what=kind)
    if kind == "rm":
        np.testing.assert_allclose(g["trainable"]["rm_head/kernel"],
                                   np.asarray(wt["rm_head"]["kernel"]), atol=TOL, rtol=TOL)


def test_lora_dropout_under_model2_equals_world1(runs):
    got, want = runs
    for i, (g, w) in enumerate(zip(got["dropout"]["metrics"], want["dropout"])):
        for k in ("loss", "rewards/margins", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], atol=TOL, rtol=TOL, err_msg=f"{i} {k}")


@pytest.mark.parametrize("where", ["world1", "fsdp2"])
def test_checkpoint_from_fsdp2_model2_resumes_as_the_straight_run(runs, where):
    got, _ = runs
    straight = got["straight"]["metrics"]
    resumed = got[f"resumed/{where}"]["metrics"]
    assert len(straight) == 3 and len(resumed) == 2
    for i, (g, w) in enumerate(zip(resumed, straight[1:])):
        np.testing.assert_allclose(g["loss"], w["loss"], atol=TOL, rtol=TOL, err_msg=f"step {i}")
    assert abs(straight[2]["loss"] - straight[0]["loss"]) > 1e-3  # the steps moved the adapters


def test_checkpoint_holds_world1_shapes(runs, tmp_path_factory):
    """Rank 0 wrote the single-process format (state.pt); restored, its
    tensors have the single-process shapes."""
    import pathlib

    from vlrlhf_torch.lora.lora import lora_keys
    from vlrlhf_torch.train.checkpoint import CheckpointManager
    from vlrlhf_torch.train.dpo import adapter_params

    ckpt = next(pathlib.Path(tmp_path_factory.getbasetemp()).glob("dist_train*/ckpt"))
    mgr = CheckpointManager(str(ckpt))
    assert mgr.latest_step() == 1
    files = set(p.name for p in (ckpt / "1").iterdir())
    assert files == {"state.pt"}
    tree, _ = mgr.restore()
    model = _llava()[4]
    keys = lora_keys(model)
    assert list(tree["trainable"]) == keys and tree["step"] == 1 and tree["count"] == 1
    for k, p in zip(keys, adapter_params(model)):
        assert tuple(tree["trainable"][k].shape) == tuple(p.shape)
        assert tree["mu"][k].dtype == torch.float32


def test_sigterm_on_one_rank_stops_both_at_the_next_logging_step(runs):
    got, _ = runs
    assert got["preempt"] == {"stopped": [4, 4], "saved": [4]}
