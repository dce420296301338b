"""vlrlhf_torch ops vs their vlrlhf_tpu counterparts on shared numpy inputs
(f32 on CPU, tolerance 1e-5): norms, rope, attention mask, reference
attention, logits warping, greedy sampling, and sampled marginals."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlrlhf_tpu.ops import attention as jattn
from vlrlhf_tpu.ops import norms as jnorms
from vlrlhf_tpu.ops import rope as jrope
from vlrlhf_tpu.ops import sampling as jsampling
from vlrlhf_torch.ops import attention as tattn
from vlrlhf_torch.ops import norms as tnorms
from vlrlhf_torch.ops import rope as trope
from vlrlhf_torch.ops import sampling as tsampling

TOL = 1e-5


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(
        t.detach().cpu().numpy(), np.asarray(j), atol=tol, rtol=tol
    )


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_and_layer_norm():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 16), _rand(rng, 16), _rand(rng, 16)
    _close(tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(tnorms.layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))


@pytest.mark.parametrize("scaling", ["none", "linear", "dynamic"])
def test_rope(scaling):
    rng = np.random.default_rng(1)
    kw = dict(head_dim=8, base=10000.0, scaling_type=scaling,
              scaling_factor=2.0, max_position_embeddings=16)
    pos = rng.integers(0, 40, (2, 7))
    q, k = _rand(rng, 2, 7, 4, 8), _rand(rng, 2, 7, 2, 8)
    jcos, jsin = jrope.rope_frequencies(jrope.RopeConfig(**kw), jnp.asarray(pos), seq_len=40)
    tcos, tsin = trope.rope_frequencies(trope.RopeConfig(**kw), torch.from_numpy(pos), seq_len=40)
    _close(tcos, jcos)
    _close(tsin, jsin)
    jq, jk = jrope.apply_rope(jnp.asarray(q), jnp.asarray(k), jcos, jsin)
    tq, tk = trope.apply_rope(torch.from_numpy(q), torch.from_numpy(k), tcos, tsin)
    _close(tq, jq)
    _close(tk, jk)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_mask_and_reference(causal):
    rng = np.random.default_rng(2)
    b, sq, skv, h, hkv, d = 2, 5, 9, 4, 2, 8
    pq = rng.random((b, sq)) > 0.2
    pkv = rng.random((b, skv)) > 0.2
    seg_q, seg_kv = rng.integers(0, 2, (b, sq)), rng.integers(0, 2, (b, skv))
    jm = jattn.make_attention_mask(jnp.asarray(pq), jnp.asarray(pkv), causal,
                                   jnp.asarray(seg_q), jnp.asarray(seg_kv))
    tm = tattn.make_attention_mask(torch.from_numpy(pq), torch.from_numpy(pkv), causal,
                                   torch.from_numpy(seg_q), torch.from_numpy(seg_kv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    q, k, v = _rand(rng, b, sq, h, d), _rand(rng, b, skv, hkv, d), _rand(rng, b, skv, hkv, d)
    _close(tattn.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), mask=tm),
           jattn.reference_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jm))


def test_multi_head_attention_cpu_dispatch_is_plain():
    """On CPU tensors the dispatch takes the plain path, matching vlrlhf_tpu's
    CPU dispatch (also its plain path) including right-pad rows."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 12, 2, 8
    q, k, v = (_rand(rng, b, s, h, d) for _ in range(3))
    pad = np.arange(s)[None] < np.array([[12], [7]])
    j = jattn.multi_head_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                   causal=True, pad_mask_q=jnp.asarray(pad),
                                   pad_mask_kv=jnp.asarray(pad), impl="xla")
    t = tattn.multi_head_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), causal=True,
                                   pad_mask_q=torch.from_numpy(pad),
                                   pad_mask_kv=torch.from_numpy(pad))
    _close(t, j)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8), (0.5, 10, 0.9),
])
def test_warp_logits(temperature, top_k, top_p):
    rng = np.random.default_rng(4)
    logits = _rand(rng, 3, 50) * 3
    j = np.asarray(jsampling.warp_logits(jnp.asarray(logits), temperature, top_k, top_p))
    t = tsampling.warp_logits(torch.from_numpy(logits), temperature, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(t), np.isinf(j))
    fin = ~np.isinf(j)
    np.testing.assert_allclose(t[fin], j[fin], atol=TOL, rtol=TOL)


def test_greedy_sampling_and_sampled_support():
    rng = np.random.default_rng(5)
    logits = _rand(rng, 6, 40)
    j = np.asarray(jsampling.sample_tokens(jnp.asarray(logits), jax.random.PRNGKey(0),
                                           do_sample=False))
    t = tsampling.sample_tokens(torch.from_numpy(logits), do_sample=False).numpy()
    np.testing.assert_array_equal(t, j)
    # sampled draws stay inside the warped support
    gen = torch.Generator().manual_seed(0)
    warped = tsampling.warp_logits(torch.from_numpy(logits), 0.8, 3, None)
    for _ in range(5):
        draw = tsampling.sample_tokens(torch.from_numpy(logits), gen, 0.8, 3, None)
        assert torch.isfinite(warped[torch.arange(6), draw.long()]).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [(0.7, 5, None), (1.0, None, 0.8)])
def test_sampled_marginals_match_jax_warped_distribution(temperature, top_k, top_p):
    """Sampling is checked by marginals (JAX and torch random streams
    differ): 10000 draws per row match softmax of vlrlhf_tpu's warped
    logits within 0.015 per token."""
    rng = np.random.default_rng(6)
    logits = _rand(rng, 2, 12) * 2
    want = np.asarray(jax.nn.softmax(
        jsampling.warp_logits(jnp.asarray(logits), temperature, top_k, top_p), axis=-1))
    gen = torch.Generator().manual_seed(1)
    rows = torch.from_numpy(np.repeat(logits, 10000, axis=0))
    draws = tsampling.sample_tokens(rows, gen, temperature, top_k, top_p).numpy()
    for i in range(2):
        freq = np.bincount(draws[i * 10000:(i + 1) * 10000], minlength=12) / 10000
        np.testing.assert_allclose(freq, want[i], atol=0.015)
        assert np.all(freq[want[i] == 0] == 0)  # nothing outside the warped support
