"""The Qwen-VL and InternLM-XC2 training steps in vlrlhf_torch against
vlrlhf_tpu, f32 on the CPU, on the scaled-down family configs with bridged
weights and non-zero LoRA adapters (tests/test_torch_families.py
`family_port`: XC2 with its PLoRA tree, which both packages apply at the
image positions in the policy and the adapter-off reference forwards),
on batches the port's processor and collators build with a ToyTokenizer
(Qwen's ChatML rows with wrapped image ids, XC2's template with its
<ImageHere> placeholder):
  - a DPO step with a frozen tower: loss and metrics 1e-5, LoRA gradients
    rtol 1e-5;
  - two SFT steps and two RM steps: metrics 1e-5.
The PPO update: tests/test_torch_qwen_xc2_ppo.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_torch_families import family_port

TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
FAMILIES = ("qwen_vl", "internlm_xc2")
FEATURES = [
    {"prompt": "What is in the photo?", "chosen": "a dog on the table", "rejected": "a cat",
     "answer": "a dog", "img_path": "a.jpg"},
    {"prompt": "Describe the picture in detail please.", "chosen": "two people",
     "rejected": "a red car in the street", "answer": "people", "img_path": "b.jpg"},
]


def loader(path, size, mode):
    return np.random.default_rng(len(path) + ord(path[0])).integers(
        0, 255, (size, size, 3), np.uint8)


def processor(family: str, jcfg):
    """The port's processor for `family` over a ToyTokenizer of 250 ids:
    Qwen's wrapped expansion on ids 8 / 9 around the <image> id 3, XC2's
    <ImageHere> as the special id 7."""
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.data.tokenizer import ToyTokenizer
    from vlrlhf_torch.models.config import FAMILIES as TF

    fam = TF[family]
    kw = dict(fam.processor_defaults, num_image_tokens=jcfg.num_image_tokens, max_length=96,
              max_prompt_length=64)
    if family == "qwen_vl":
        kw.update(image_token_id=3, image_start_id=8, image_end_id=9, image_pad_id=3)
        tok = ToyTokenizer(vocab_size=250)
    else:
        kw.update(image_token_id=7)
        tok = ToyTokenizer(vocab_size=250, specials={"<ImageHere>": 7})
    return VLProcessor(tok, fam.template, ProcessorConfig(**kw))


def collate(kind: str, proc, rows):
    from vlrlhf_torch.data import collators as TC

    return getattr(TC, kind)(proc, TC.CollatorConfig(pad_token_id=0, bucket_multiple=16,
                                                     image_size=16, resize_mode="squash"),
                             loader)(rows)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("family", FAMILIES)
def test_dpo_step_matches_jax(family):
    from tests.test_torch_dpo import _assert_trees, _capture_grads, _torch_steps
    from vlrlhf_tpu.train.dpo import DPOConfig, dpo_step_fn
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_torch.train import dpo as tdpo
    from vlrlhf_torch.train.train_state import OptimizerConfig
    from vlrlhf_torch.utils.bridge import lora_tree

    jcfg, params, model, lcfg, adapters = family_port(family, seed=8, lora=True)
    proc = processor(family, jcfg)
    batch = collate("DPOCollator", proc, [proc.tokenize_row_dpo(dict(f)) for f in FEATURES])
    assert (batch["image_positions"] >= 0).all()
    if family == "qwen_vl":  # the pads sit between the start and end ids
        pos = batch["image_positions"][0]
        assert batch["input_ids"][0, pos[0] - 1] == 8 and batch["input_ids"][0, pos[-1] + 1] == 9
    kw = dict(beta=0.1, lora_scale=lcfg.scale)
    jstate, jm = jax.jit(lambda st, p, b: dpo_step_fn(jcfg, DPOConfig(**kw), _capture_grads(),
                                                      st, p, b))(
        jinit(adapters, _capture_grads()), params, _jb(batch))
    _, tm = _torch_steps(model, kw, OptimizerConfig(learning_rate=5e-3, warmup_steps=1,
                                                    total_steps=50),
                         tdpo.batch_to_device(batch, "cpu"))
    for k in jm:
        np.testing.assert_allclose(tm[k], float(jm[k]), atol=TOL, rtol=TOL, err_msg=k)
    _assert_trees(lora_tree(model, grads=True), jax.device_get(jstate.opt_state),
                  GRAD_RTOL, GRAD_ATOL, "grad")


@pytest.mark.parametrize("family", FAMILIES)
def test_sft_and_rm_steps_match_jax(family):
    from tests.test_torch_sft_rm import OPT
    from vlrlhf_tpu.models.vlm import init_rm_head
    from vlrlhf_tpu.train.rm import RMConfig as JRM
    from vlrlhf_tpu.train.rm import make_rm_step
    from vlrlhf_tpu.train.sft import SFTConfig as JSFT
    from vlrlhf_tpu.train.sft import make_sft_step
    from vlrlhf_tpu.train.train_state import OptimizerConfig as JOpt
    from vlrlhf_tpu.train.train_state import init_train_state as jinit
    from vlrlhf_tpu.train.train_state import make_optimizer
    from vlrlhf_torch.models.vlm import init_rm_head as tinit_rm_head
    from vlrlhf_torch.train.dpo import adapter_params, batch_to_device
    from vlrlhf_torch.train.rm import RMConfig, rm_step
    from vlrlhf_torch.train.sft import SFTConfig, sft_step
    from vlrlhf_torch.train.train_state import OptimizerConfig, init_train_state

    jcfg, params, model, lcfg, adapters = family_port(family, seed=9, lora=True)
    proc = processor(family, jcfg)
    ocfg = OptimizerConfig(**OPT)
    batch = collate("SFTCollator", proc, [proc.tokenize_row_sft(
        {k: f[k] for k in ("prompt", "answer", "img_path")}) for f in FEATURES])
    tx = make_optimizer(JOpt(**OPT), adapters)
    jstate = jinit(adapters, tx)
    state = init_train_state(adapter_params(model), ocfg)
    jstep = make_sft_step(jcfg, JSFT(lora_scale=lcfg.scale), tx)
    tb = batch_to_device(batch, "cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, params, _jb(batch))
        tm = sft_step(model, SFTConfig(lora_scale=lcfg.scale), ocfg, state, tb)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL,
                                       err_msg=f"sft {k}")
    jcfg, params, model, lcfg, adapters = family_port(family, seed=10, lora=True)
    batch = collate("RMCollator", proc, [proc.tokenize_row_dpo(dict(f)) for f in FEATURES])
    trainable = {"adapters": adapters, "rm_head": init_rm_head(32, jnp.float32)}
    tx = make_optimizer(JOpt(**OPT), trainable)
    jstate = jinit(trainable, tx)
    head = tinit_rm_head(32)["kernel"]
    state = init_train_state(adapter_params(model) + [head], ocfg)
    jstep = make_rm_step(jcfg, JRM(lora_scale=lcfg.scale), tx)
    tb = batch_to_device(batch, "cpu")
    for _ in range(2):
        jstate, jm = jstep(jstate, params, _jb(batch))
        tm = rm_step(model, RMConfig(lora_scale=lcfg.scale), ocfg, state, head, tb)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=TOL, rtol=TOL,
                                       err_msg=f"rm {k}")
