"""The rest of the `dpo` trainer against vlrlhf_tpu (CPU, f32, unjitted
where it matters): the eval pass (`make_dpo_eval_fn`) on bridged weights
and non-zero adapters (1e-5); `train_eval_split` row for row; the
Generator with the adapters on and off (greedy tokens exact, as the eval
samples decode them); the `dpo` CLI's eval lines and policy / reference
samples; an unfrozen tower with tower LoRA targets, in the step and in
the eval pass; `--use_lora false` (dropout 0, 6N FLOPs).

vlrlhf_tpu's `vit_forward` never applies tower adapters (its linears get
no Ctx), so its `dpo_step_fn` cannot be the oracle for tower-targeted
adapters, which the port trains. The oracle is built from vlrlhf_tpu's
own pieces: its `merge_lora` folds the tower adapters into the tower
kernels (W + s A B), its `_forward_logps` and `dpo_loss` give the loss on
the tiled batch, and jax.grad gives the LM adapters' gradients and the
merged kernels' gradient G, from which the tower adapters' gradients are
s G B^T and s A^T G."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_dpo_step import tiny_batch, tiny_vlm_config
from tests.test_torch_dpo import (
    GRAD_ATOL, GRAD_RTOL, LOSS_TOL, LORA_PATTERNS, _assert_trees, _setup, _tbatch,
    _torch_steps,
)
from vlrlhf_torch.train import dpo as tdpo
from vlrlhf_torch.train.train_state import OptimizerConfig
from vlrlhf_torch.utils.bridge import load_lora_params, load_vlm_params, lora_tree, vlm_config_from

TOWER = r"vision/.*attn/(wq|wk|wv|wo)/"


def test_eval_fn_matches_jax():
    from vlrlhf_tpu.train.dpo import DPOConfig, make_dpo_eval_fn

    jcfg, params, lcfg, adapters, model = _setup()
    batch = tiny_batch(jax.random.PRNGKey(5))
    want = make_dpo_eval_fn(jcfg, DPOConfig(beta=0.1, lora_scale=lcfg.scale))(
        adapters, params, batch)
    got = tdpo.make_dpo_eval_fn(model, tdpo.DPOConfig(beta=0.1, lora_scale=lcfg.scale))(
        _tbatch(batch))
    assert set(got) == set(want) == {"eval/loss", "eval/rewards_accuracies",
                                     "eval/rewards_margins"}
    assert abs(float(want["eval/rewards_margins"])) > 1e-4  # the adapters move the policy
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=LOSS_TOL, rtol=LOSS_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("n,ratio,seed", [(0, 0.1, 42), (7, 0.005, 42), (50, 0.1, 0),
                                          (200, 0.25, 3), (13, 1.0, 7)])
def test_train_eval_split_matches_jax(n, ratio, seed):
    from vlrlhf_tpu.data.datasets import train_eval_split as jsplit

    from vlrlhf_torch.data.datasets import train_eval_split

    rows = [{"i": i} for i in range(n)]
    got, want = train_eval_split(rows, ratio, seed), jsplit(rows, ratio, seed)
    assert got == want
    assert len(got[1]) == (0 if n == 0 else max(1, int(n * ratio)))


def test_generator_adapters_on_and_off_match_jax():
    """The eval samples' switch: vlrlhf_tpu's Generator with its adapters
    set (policy) or None (reference) at a lora_scale, and the port's with
    `adapters` True or False, give the same greedy tokens."""
    from tests.test_torch_models import ported, prompt_batch
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora

    from vlrlhf_torch.generate.engine import GenerateConfig, Generator

    jcfg, params, model = ported(seed=4)
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS)
    adapters = jax.tree.map(lambda x: x + 0.3, init_lora(params, lcfg, jax.random.PRNGKey(6)))
    load_lora_params(model, jax.device_get(adapters))
    ids, pad, lens, px, pos = prompt_batch(seed=9)
    batch = {"input_ids": ids, "pad_mask": pad, "prompt_lens": lens,
             "pixel_values": px, "image_positions": pos}
    jgen = JGenerator(jcfg, JGenerateConfig(max_new_tokens=6, pad_token_id=-1),
                      lora_scale=lcfg.scale)
    gen = Generator(model, GenerateConfig(max_new_tokens=6, pad_token_id=-1),
                    lora_scale=lcfg.scale)
    got, want = {}, {}
    for on in (True, False):
        jgen.adapters = adapters if on else None
        gen.adapters = on
        want[on] = np.asarray(jgen(params, batch))
        got[on] = gen(batch).numpy()
        np.testing.assert_array_equal(got[on], want[on], err_msg=f"adapters {on}")
    assert not np.array_equal(want[True], want[False])  # the adapters change the tokens


def test_cli_eval_lines_and_samples(tmp_path):
    """`dpo --eval_steps 1 --eval_samples 2` logs eval/* at every step and
    appends policy / reference samples; with the adapters held at zero
    (learning rate 0) the two are token for token the same."""
    from vlrlhf_torch.cli.main import main

    main(["dpo", "--synthetic", "8", "--device", "cpu", "--max_steps", "2",
          "--output_dir", str(tmp_path), "--logging_steps", "1", "--eval_steps", "1",
          "--eval_ratio", "0.25", "--eval_samples", "2", "--per_device_train_batch_size", "2",
          "--learning_rate", "0"])
    lines = [json.loads(x) for x in (tmp_path / "dpo_metrics.jsonl").read_text().splitlines()]
    evals = [r for r in lines if "eval/loss" in r]
    assert [r["step"] for r in evals] == [1, 2]
    for r in evals:
        assert set(r) == {"step", "eval/loss", "eval/rewards_accuracies", "eval/rewards_margins"}
        assert round(r["eval/loss"], 4) == 0.6931 and r["eval/rewards_margins"] == 0.0
    samples = [json.loads(x) for x in (tmp_path / "dpo_samples.jsonl").read_text().splitlines()]
    assert [s["step"] for s in samples] == [1, 1, 2, 2]
    for s in samples:
        assert s["prompt"].startswith("describe item") and s["policy"]
        assert s["policy"] == s["ref"]


def _tower_setup(tower_offset: float = 0.01):
    """Bridged tiny weights with LM and tower LoRA adapters (every entry
    offset from init, the tower's by `tower_offset`), the port's model
    holding both, and a batch with images."""
    from vlrlhf_tpu.lora.lora import LoraConfig, init_lora
    from vlrlhf_tpu.models.vlm import init_vlm_params

    from vlrlhf_torch.models.vlm import VLM

    jcfg = tiny_vlm_config()
    params = init_vlm_params(jcfg, jax.random.PRNGKey(0))
    lcfg = LoraConfig(r=4, alpha=8.0, target_patterns=LORA_PATTERNS + (TOWER,))
    adapters = jax.tree.map(lambda x: x + 0.01, init_lora(params, lcfg, jax.random.PRNGKey(1)))
    adapters["vision"] = jax.tree.map(lambda x: x + tower_offset - 0.01, adapters["vision"])
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, jax.device_get(params))
    names = load_lora_params(model, jax.device_get(adapters))
    assert "vision.layers.0.wq" in names and "vision.layers.0.fc1" not in names
    return jcfg, params, lcfg, adapters, model, tiny_batch(jax.random.PRNGKey(2))


def _jax_tower_policy_logps(jcfg, params, adapters, s, batch):
    """vlrlhf_tpu's policy logps with the tower adapters folded into the
    tower kernels by its merge_lora and the LM adapters in the Ctx, on the
    tiled batch."""
    from vlrlhf_tpu.lora.lora import merge_lora
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.train.dpo import DPOConfig as JDPO
    from vlrlhf_tpu.train.dpo import _forward_logps, _tile_pair_images

    merged = merge_lora(params, {"vision": adapters["vision"]}, s)
    jd = JDPO(beta=0.1, lora_scale=s, frozen_vision=False)
    logps, _ = _forward_logps(jcfg, merged, _tile_pair_images(batch),
                              JCtx(adapters={"lm": adapters["lm"]}, lora_scale=s), jd, None)
    return logps


def test_unfrozen_tower_eval_matches_jax_oracle():
    """The eval pass with `frozen_vision=False` runs the tower under each
    forward's ctx, as the step does: the policy with the tower adapters,
    the reference without. Held against the merge oracle at 1e-5, and the
    tower adapters must move the result (the frozen eval, which leaves
    them out, differs)."""
    from vlrlhf_tpu.train.dpo import DPOConfig as JDPO
    from vlrlhf_tpu.train.dpo import make_ref_logps_fn
    from vlrlhf_tpu.train.losses import dpo_loss

    jcfg, params, lcfg, adapters, model, batch = _tower_setup(tower_offset=0.3)
    s = lcfg.scale
    got = {frozen: tdpo.make_dpo_eval_fn(model, tdpo.DPOConfig(
        beta=0.1, lora_scale=s, frozen_vision=frozen))(_tbatch(batch)) for frozen in (True, False)}
    ref_c, ref_r = make_ref_logps_fn(jcfg, JDPO(beta=0.1, lora_scale=s))(params, batch)
    logps = _jax_tower_policy_logps(jcfg, params, adapters, s, batch)
    n = batch["input_ids"].shape[0] // 2
    out = dpo_loss(logps[:n], logps[n:], ref_c, ref_r, beta=0.1)
    want = {"eval/loss": out.loss,
            "eval/rewards_accuracies": jnp.mean((out.chosen_rewards > out.rejected_rewards)
                                                .astype(jnp.float32)),
            "eval/rewards_margins": jnp.mean(out.chosen_rewards - out.rejected_rewards)}
    assert set(got[False]) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[False][k]), float(want[k]), atol=LOSS_TOL,
                                   rtol=LOSS_TOL, err_msg=k)
    assert abs(float(got[False]["eval/rewards_margins"])
               - float(got[True]["eval/rewards_margins"])) > 1e-4


def test_unfrozen_tower_with_tower_targets_matches_jax_oracle():
    from vlrlhf_tpu.lora.lora import merge_lora
    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.train.dpo import DPOConfig as JDPO
    from vlrlhf_tpu.train.dpo import _forward_logps, _tile_pair_images, make_ref_logps_fn
    from vlrlhf_tpu.train.losses import dpo_loss

    jcfg, params, lcfg, adapters, model, batch = _tower_setup()
    # the port's tower rematerializes each block under autograd
    model.vision.cfg = type(model.vision.cfg)(**{**model.vision.cfg.__dict__, "remat": True})
    s = lcfg.scale
    kw = dict(beta=0.1, lora_scale=s, frozen_vision=False)
    _, tm = _torch_steps(model, kw, OptimizerConfig(), _tbatch(batch))
    got = lora_tree(model, grads=True)

    jd = JDPO(beta=0.1, lora_scale=s, frozen_vision=False)
    ref_c, ref_r = make_ref_logps_fn(jcfg, jd)(params, batch)
    merged = merge_lora(params, {"vision": adapters["vision"]}, s)
    tiled = _tile_pair_images(batch)
    n = batch["input_ids"].shape[0] // 2

    def loss_fn(vision, lm_adapters):
        logps, _ = _forward_logps(jcfg, dict(merged, vision=vision), tiled,
                                  JCtx(adapters=lm_adapters, lora_scale=s), jd, None)
        return dpo_loss(logps[:n], logps[n:], ref_c, ref_r, beta=0.1).loss

    loss, (g_vis, g_lm) = jax.value_and_grad(loss_fn, argnums=(0, 1))(
        merged["vision"], {"lm": adapters["lm"]})
    np.testing.assert_allclose(tm["loss"], float(loss), atol=LOSS_TOL, rtol=LOSS_TOL)
    assert abs(tm["rewards/margins"]) > 1e-4
    _assert_trees({"lm": got["lm"]}, jax.device_get(g_lm), GRAD_RTOL, GRAD_ATOL, "lm grad")
    want_vis = {}
    for name in ("wq", "wk", "wv", "wo"):
        g = g_vis["layers_scanned"]["attn"][name]["kernel"]  # (L, in, out)
        ad = adapters["vision"]["layers_scanned"]["attn"][name]
        want_vis[name] = {"a": s * jnp.einsum("lio,lro->lir", g, ad["b"]),
                          "b": s * jnp.einsum("lir,lio->lro", ad["a"], g)}
    assert np.abs(np.asarray(want_vis["wq"]["b"][0])).max() > 0  # the run layer learns
    _assert_trees(got["vision"]["layers_scanned"]["attn"], jax.device_get(want_vis),
                  GRAD_RTOL, GRAD_ATOL, "tower grad")


def _dpo_args(**kw):
    from vlrlhf_torch.cli.main import build_parser

    argv = ["dpo", "--synthetic", "4", "--device", "cpu", "--output_dir", "unused"]
    for k, v in kw.items():
        argv += [f"--{k}", str(v)]
    args, unknown = build_parser().parse_known_args(argv)
    assert not unknown
    return args


def test_use_lora_false_is_dropout_0_and_6n_flops():
    """As in vlrlhf_tpu (cli/main.py:449, :502): adapters still train, LoRA
    dropout goes to 0, and the FLOPs per token count 6N for the policy."""
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.models.registry import scale_down as jscale
    from vlrlhf_tpu.train.flops import dpo_flops_per_token as jflops

    from vlrlhf_torch.cli.main import build_dpo, synthetic_bundle, synthetic_rows

    runs = {}
    for use in ("true", "false"):
        args = _dpo_args(use_lora=use, lora_dropout=0.1, max_length=64)
        _, cfg, model, proc = synthetic_bundle(args, torch.device("cpu"))
        runs[use] = build_dpo(cfg, model, proc, args, synthetic_rows(4))
    assert runs["true"].dcfg.lora_dropout == 0.1 and runs["false"].dcfg.lora_dropout == 0.0
    assert len(runs["false"].state.trainable) == len(runs["true"].state.trainable) > 0
    jcfg = jscale(JF["llava"].make_config())
    jcfg = jcfg.__class__(**{**jcfg.__dict__, "lm": jcfg.lm.__class__(
        **{**jcfg.lm.__dict__, "vocab_size": 4096})})
    for use, mode in (("true", "adapter"), ("false", "full")):
        want = jflops(jcfg, 64, ref_forward=True, train_mode=mode)
        assert runs[use].flops_per_token == pytest.approx(want, rel=1e-12), use
    assert runs["false"].flops_per_token > runs["true"].flops_per_token


def test_cli_unfrozen_tower_targets_train(tmp_path):
    """--freeze_vision_tower false with tower targets through the CLI: the
    step-1 loss is ln 2 and the tower adapters are saved beside the LM's.
    The synthetic rows carry no image (as vlrlhf_tpu's), so the tower's
    features reach no position and its adapters keep b = 0 while the LM's
    move; the tower's gradients are held above, on rows with images."""
    from vlrlhf_torch.cli.main import main
    from vlrlhf_torch.train.checkpoint import load_params

    main(["dpo", "--synthetic", "4", "--device", "cpu", "--max_steps", "2",
          "--output_dir", str(tmp_path), "--logging_steps", "1",
          "--per_device_train_batch_size", "1", "--freeze_vision_tower", "false",
          "--lora_target_modules", ",".join(LORA_PATTERNS + (TOWER,))])
    lines = [json.loads(x) for x in (tmp_path / "dpo_metrics.jsonl").read_text().splitlines()]
    assert round(lines[0]["loss"], 4) == 0.6931 and np.isfinite(lines[1]["loss"])
    saved = load_params(str(tmp_path / "adapters"))
    assert "vision/layers/0/attn/wq/b" in saved and "lm/layers/0/mlp/down/a" in saved
    assert not saved["vision/layers/0/attn/wq/b"].any()
    assert saved["lm/layers/0/mlp/down/b"].any()
