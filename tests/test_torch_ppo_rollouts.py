"""PPO's rollouts and host-side pieces: vlrlhf_torch against vlrlhf_tpu
(CPU, f32, bridged weights; tests/test_torch_ppo.py holds the stats and
the update): greedy rollouts by the static and continuous engines
(emit_stop_token) token for token with equal response lengths, the
first-update invariants after sampled rollouts, rollout_to_batch,
RunningMoments / preprocess_scores and the KL controller (exact)."""

import numpy as np
import pytest
import torch

from tests.test_torch_models import prompt_batch
from tests.test_torch_ppo import OPT, _heads, _port_state
from tests.test_torch_sft_rm import _setup
from vlrlhf_torch.train import ppo as tp
from vlrlhf_torch.train.dpo import batch_to_device
from vlrlhf_torch.train.train_state import OptimizerConfig


@pytest.mark.parametrize("logits_chunk", [0, 16])
def test_first_update_invariants(logits_chunk):
    """Sampled rollouts with the policy's adapters, then the stats and one
    update: nothing changed since the rollout, so ratio = 1, nothing is
    clipped and the policy loss of whitened advantages is ~0."""
    from vlrlhf_torch.cli.main import static_rollouts
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator

    _, _, lcfg, _, model = _setup()
    ids, pad, plens, px, pos = prompt_batch(seed=5, lens=(20, 24, 18, 22))
    pb = {"input_ids": ids, "pad_mask": pad, "prompt_lens": plens, "pixel_values": px,
          "image_positions": pos}
    gen = Generator(model, GenerateConfig(max_new_tokens=6, do_sample=True), lora_scale=lcfg.scale)
    gen.adapters = True
    tokens, resp_lens = static_rollouts(gen, pb, 2, torch.Generator().manual_seed(3))
    batch = batch_to_device(tp.rollout_to_batch(pb, tokens, 0, resp_lens), "cpu")
    pcfg = tp.PPOConfig(lora_scale=lcfg.scale, logits_chunk=logits_chunk)
    _, tv = _heads(False)
    state = _port_state(model, tv, False)
    rng = np.random.default_rng(1)
    stats = tp.compute_rollout_stats(model, pcfg, tv, batch,
                                     torch.from_numpy(rng.normal(size=4).astype(np.float32)),
                                     pcfg.init_kl_coef)
    m = tp.ppo_update(model, pcfg, OptimizerConfig(**OPT), state, tv, batch, stats)
    assert float(m["ppo/ratio_mean"]) == pytest.approx(1.0, abs=1e-4)
    assert float(m["ppo/ratio_max_abs_dev"]) < 1e-4
    assert float(m["ppo/policy/clipfrac"]) == 0.0
    assert float(m["ppo/loss/policy"]) == pytest.approx(0.0, abs=1e-3)
    assert np.isfinite(float(m["ppo/loss/value"]))


def test_rollout_to_batch_explicit_lengths_matches_jax():
    from vlrlhf_tpu.train.ppo import rollout_to_batch

    pb = {"input_ids": np.asarray([[7, 8, 9, 0, 0, 0], [5, 6, 0, 0, 0, 0]], np.int32),
          "prompt_lens": np.asarray([3, 2], np.int32)}
    eos = 99
    # row 0: [5, PAD-as-a-real-token, eos]; row 1: an empty response
    tokens = np.asarray([[5, 0, eos, 0, 0, 0], [0, 0, 0, 0, 0, 0]], np.int32)
    for lens in (None, [3, 0]):
        got = tp.rollout_to_batch(pb, tokens, 0, resp_lens=lens)
        want = rollout_to_batch(pb, tokens, 0, resp_lens=lens)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    exact = tp.rollout_to_batch(pb, tokens, 0, resp_lens=[3, 0])
    assert exact["response_mask"].sum() == 3
    assert list(exact["input_ids"][0, 3:6]) == [5, 0, eos]
    assert tp.rollout_to_batch(pb, tokens, 0)["response_mask"].sum() == 2  # the fallback


def test_running_moments_preprocess_scores_and_kl_controller_match_jax():
    from vlrlhf_tpu.train import ppo as jp

    rng = np.random.default_rng(0)
    for scaling, norm, clip in ((True, False, None), (True, True, 1.5), (False, False, 0.5)):
        kw = dict(use_score_scaling=scaling, use_score_norm=norm, score_clip=clip)
        jm, tm = jp.RunningMoments(), tp.RunningMoments()
        for n in (3, 8, 5):
            xs = (rng.normal(size=n) * 3 + 1).astype(np.float32)
            want = jp.preprocess_scores(xs, jp.PPOConfig(**kw), jm)
            got = tp.preprocess_scores(xs, tp.PPOConfig(**kw), tm)
            np.testing.assert_array_equal(got, want)
            assert (tm.mean, tm.var, tm.std, tm.count) == (jm.mean, jm.var, jm.std, jm.count)
    for adaptive in (True, False):
        jc = jp.AdaptiveKLController(jp.PPOConfig(adaptive_kl=adaptive, kl_horizon=100))
        tc = tp.AdaptiveKLController(tp.PPOConfig(adaptive_kl=adaptive, kl_horizon=100))
        for kl, n in ((0.3, 8), (9.1, 4), (6.2, 16), (0.0, 2), (40.0, 8)):
            assert tc.update(kl, n) == jc.update(kl, n)


def test_greedy_rollouts_match_jax_by_both_engines():
    """Greedy f32 rollouts with two stop ids (one is row 0's first token,
    so its response is empty): the static path's tokens and engine-derived
    resp_lens, and the continuous engine's (emit_stop_token) responses,
    equal vlrlhf_tpu's; both paths put each row's last token (and so the
    reward) at the same position."""
    from vlrlhf_torch.cli.main import continuous_rollouts, static_rollouts
    from vlrlhf_torch.generate.continuous import ContinuousEngine
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator
    from vlrlhf_tpu.generate.continuous import ContinuousEngine as JEngine
    from vlrlhf_tpu.generate.continuous import Request as JRequest
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator

    jcfg, params, lcfg, adapters, model = _setup()
    n_new = 8
    ids, pad, plens, px, pos = prompt_batch(seed=5, lens=(20, 24, 18, 22))
    pb = {"input_ids": ids, "pad_mask": pad, "prompt_lens": plens, "pixel_values": px,
          "image_positions": pos}
    jgen = JGenerator(jcfg, JGenerateConfig(max_new_tokens=n_new, pad_token_id=0),
                      adapters=adapters, lora_scale=lcfg.scale)
    free = np.asarray(jgen(params, pb))
    stops = (int(free[0, 0]), int(free[2, 3]))
    jcfg_gen = JGenerateConfig(max_new_tokens=n_new, pad_token_id=0, eos_token_ids=stops)
    jgen = JGenerator(jcfg, jcfg_gen, adapters=adapters, lora_scale=lcfg.scale)
    want_tokens, st = jgen(params, pb, return_state=True)
    adv = np.asarray(st["lengths"]) - plens
    want_lens = np.where(adv == 0, 0, adv + 1)
    gen_cfg = GenerateConfig(max_new_tokens=n_new, pad_token_id=0, eos_token_ids=stops)
    gen = Generator(model, gen_cfg, lora_scale=lcfg.scale)
    gen.adapters = True
    tokens, lens = static_rollouts(gen, pb, 2, None)
    np.testing.assert_array_equal(tokens, np.asarray(want_tokens))
    np.testing.assert_array_equal(lens, want_lens)
    assert lens[0] == 0 and 0 < lens[2] < n_new and tokens[2, lens[2] - 1] == stops[1]

    reqs = [JRequest(input_ids=ids[i, : plens[i]], pixel_values=px[i, 0],
                     image_positions=pos[i]) for i in range(4)]
    jcb = JEngine(jcfg, jcfg_gen, n_slots=2, cache_len=128, lora_scale=lcfg.scale,
                  adapters=adapters, emit_stop_token=True).run(params, reqs)
    eng = ContinuousEngine(model, gen_cfg, n_slots=2, cache_len=128, adapters=True,
                           lora_scale=lcfg.scale, emit_stop_token=True)
    cb_tokens, cb_lens = continuous_rollouts(eng, pb, [{"img_path": "x"}] * 4, None, n_new, 0)
    assert [list(cb_tokens[i, : cb_lens[i]]) for i in range(4)] == jcb
    np.testing.assert_array_equal(cb_lens, lens)
    for i in range(4):
        assert list(cb_tokens[i, : cb_lens[i]]) == list(tokens[i, : lens[i]])
