"""vlrlhf_torch's static SpeculativeGenerator vs its Generator and
vlrlhf_tpu's, f32 on CPU, the same bridged weights: prompt_lookup_draft
equals vlrlhf_tpu's on fuzzed histories; greedy speculative decoding gives
the plain engines' tokens exactly for K = 1, 3, 7, eos early stop
included; sampled with top_k=1 gives greedy's tokens; sampled marginals
match plain sampling (the total-variation statistic of
tests/test_speculative.py, on 300 rows of one prompt); on a model whose
greedy token never changes, drafts are accepted and verify_calls falls
below max_new_tokens."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tests.test_speculative import _batch as jbatch
from tests.test_torch_models import ported
from vlrlhf_torch.generate.engine import GenerateConfig, Generator
from vlrlhf_torch.generate.speculative import SpeculativeGenerator, prompt_lookup_draft


def _batch(lens, L, seed, with_image=True, n_rows=None):
    return jax.device_get(jbatch(lens, L, seed=seed, with_image=with_image, n_rows=n_rows))


def test_prompt_lookup_draft_matches_jax_on_fuzzed_histories():
    from vlrlhf_tpu.generate.speculative import prompt_lookup_draft as jdraft

    rng = np.random.default_rng(0)
    for _ in range(500):
        src = rng.integers(0, int(rng.integers(2, 6)), int(rng.integers(0, 24))).tolist()
        k, pad = int(rng.integers(1, 8)), int(rng.integers(-3, 2))
        assert prompt_lookup_draft(src, k, pad) == jdraft(src, k, pad), (src, k, pad)
    assert prompt_lookup_draft([1, 2, 3, 4, 5, 6, 7, 8, 3, 4], 3, 0) == [5, 6, 7]


@pytest.mark.parametrize("k", [1, 3, 7])
def test_speculative_greedy_matches_both_generators(k):
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator

    jcfg, params, model = ported()
    batch = _batch([20, 26], 32, seed=7)
    gcfg = GenerateConfig(max_new_tokens=10, pad_token_id=0)
    want = Generator(model, gcfg)(batch).numpy()
    jwant = np.asarray(JGenerator(jcfg, JGenerateConfig(max_new_tokens=10, pad_token_id=0))(
        params, batch))
    np.testing.assert_array_equal(want, jwant)
    spec = SpeculativeGenerator(model, gcfg, k_draft=k)
    np.testing.assert_array_equal(spec(batch).numpy(), want)
    assert spec.verify_calls >= 1 and spec.verify_rows >= spec.verify_calls


def test_speculative_eos_early_stop_matches():
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator

    jcfg, params, model = ported(seed=1)
    batch = _batch([12, 16], 16, seed=3, with_image=False)
    probe = Generator(model, GenerateConfig(max_new_tokens=8, pad_token_id=0))(batch).numpy()
    eos = int(probe[0, 2])
    gcfg = GenerateConfig(max_new_tokens=8, pad_token_id=0, eos_token_ids=(eos,))
    want = np.asarray(JGenerator(jcfg, JGenerateConfig(max_new_tokens=8, pad_token_id=0,
                                                       eos_token_ids=(eos,)))(params, batch))
    np.testing.assert_array_equal(Generator(model, gcfg)(batch).numpy(), want)
    np.testing.assert_array_equal(SpeculativeGenerator(model, gcfg, k_draft=4)(batch).numpy(),
                                  want)
    assert (want[0, 3:] == 0).all()  # the eos row pads out after the eos


def test_speculative_sampled_topk1_matches_greedy():
    """top_k=1 keeps only the argmax, so the whole sampled path (coin
    flips, residual and bonus draws) must reproduce greedy exactly."""
    _, _, model = ported()
    greedy = GenerateConfig(max_new_tokens=10, pad_token_id=0)
    batch = _batch([20, 26], 32, seed=7)
    want = Generator(model, greedy)(batch).numpy()
    sampled = dataclasses.replace(greedy, do_sample=True, top_k=1, temperature=0.7)
    spec = SpeculativeGenerator(model, sampled, k_draft=4)
    got = spec(batch, torch.Generator().manual_seed(123)).numpy()
    np.testing.assert_array_equal(got, want)


def test_speculative_sampled_marginals_match_plain():
    """Each emitted token is distributed as a plain sampled step's: per
    position, the total-variation distance between the two engines'
    histograms over 300 independent rows stays within 1.8x the distance
    between two halves of the plain rows (+0.03), the bound of
    tests/test_speculative.py."""
    _, _, model = ported(seed=4)
    gcfg = GenerateConfig(max_new_tokens=3, pad_token_id=0, do_sample=True, temperature=0.5,
                          top_k=5)
    n = 300
    batch = _batch([14] * n, 16, seed=9, with_image=False)
    batch["input_ids"] = np.broadcast_to(batch["input_ids"][:1], batch["input_ids"].shape).copy()
    plain = Generator(model, gcfg)(batch, torch.Generator().manual_seed(1000)).numpy()
    spec = SpeculativeGenerator(model, gcfg, k_draft=2)
    got = spec(batch, torch.Generator().manual_seed(5000)).numpy()
    v = model.cfg.lm.vocab_size

    def tv(a, b, pos):
        ha = np.bincount(a[:, pos], minlength=v) / len(a)
        hb = np.bincount(b[:, pos], minlength=v) / len(b)
        return 0.5 * np.abs(ha - hb).sum()

    for pos in range(3):
        floor = tv(plain[: n // 2], plain[n // 2:], pos)
        cross = tv(plain, got, pos)
        assert cross < 1.8 * floor + 0.03, f"pos {pos}: cross-tv={cross:.3f} floor={floor:.3f}"
    assert spec.verify_calls >= 1


def test_speculative_accepts_on_repetitive_model():
    """A zero lm_head makes the greedy token constant, so the repeat-last
    draft is always right: 15 post-prefill tokens at up to 8 a verify."""
    _, _, model = ported(seed=2)
    with torch.no_grad():
        model.lm.lm_head.weight.zero_()
    gcfg = GenerateConfig(max_new_tokens=16, pad_token_id=0)
    batch = _batch([10], 16, seed=5, with_image=False)
    want = Generator(model, gcfg)(batch).numpy()
    spec = SpeculativeGenerator(model, gcfg, k_draft=7)
    np.testing.assert_array_equal(spec(batch).numpy(), want)
    assert spec.verify_calls <= 3 < gcfg.max_new_tokens
    assert spec.verify_tokens == 15
