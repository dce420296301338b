"""Decode attention: vlrlhf_torch's plain version vs vlrlhf_tpu's Pallas
kernel in interpret mode (f32, tolerance 1e-5) — lengths 0 and S-1, GQA,
the stacked-cache layer index, and int8 caches fed the same codes and
scales (also against the dense XLA oracle) — plus the Hopper
kernel vs the plain version on the card (skips without CUDA)."""

import numpy as np
import pytest
import torch

from vlrlhf_torch.ops.decode_attention import decode_attention as tdecode

TOL = 1e-5


def _inputs(seed, L, b, nh, nkv, hd, s):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa: E731
    return (f(b, nh, hd), f(L, b, nkv, s, hd), f(L, b, nkv, s, hd),
            f(b, nkv, hd), f(b, nkv, hd))


@pytest.mark.parametrize("L,b,nh,nkv,hd,s,lengths", [
    (3, 4, 4, 4, 64, 128, (0, 1, 127, 60)),  # MHA, lengths 0 and S-1
    (2, 3, 8, 2, 128, 256, (255, 0, 100)),  # GQA g=4
    (2, 2, 4, 1, 8, 64, (33, 63)),  # MQA, head_dim 8
])
def test_plain_matches_pallas_interpret(L, b, nh, nkv, hd, s, lengths):
    import jax.numpy as jnp  # the card machine has no jax: run there with -m cuda

    from vlrlhf_tpu.ops.decode_attention import decode_attention as jdecode

    q, k, v, kc, vc = _inputs(hd + s, L, b, nh, nkv, hd, s)
    lens = np.asarray(lengths, np.int32)
    for layer in range(L):
        want = np.asarray(jdecode(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc),
            jnp.asarray(vc), jnp.asarray(lens), layer=layer, block_s=64,
        ))
        got = tdecode(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(lens),
            layer=layer,
        ).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL, err_msg=f"layer {layer}")


def test_empty_cache_returns_current_value_and_scales_raise():
    q, k, v, kc, vc = (torch.from_numpy(a) for a in _inputs(0, 1, 2, 4, 2, 8, 16))
    out = tdecode(q, k[0], v[0], kc, vc, torch.zeros(2, dtype=torch.int32))
    torch.testing.assert_close(out, vc.repeat_interleave(2, dim=1), atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        tdecode(q, k[0], v[0], kc, vc, torch.zeros(2, dtype=torch.int32),
                k_scale=torch.ones(2, 2, 16))


@pytest.mark.cuda
@pytest.mark.parametrize("L,b,nh,nkv,hd,s", [
    (32, 8, 32, 32, 128, 1024), (2, 3, 8, 2, 128, 256), (2, 2, 4, 4, 8, 64),
])
def test_kernel_matches_plain_on_card(L, b, nh, nkv, hd, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from vlrlhf_torch.ops.decode_attention import decode_attention_plain

    q, k, v, kc, vc = (torch.from_numpy(a).cuda().bfloat16()
                       for a in _inputs(3, L, b, nh, nkv, hd, s))
    lens = torch.tensor([[0, s - 1, s // 2, 5][i % 4] for i in range(b)],
                        dtype=torch.int32, device="cuda")
    layer = L - 1
    got = tdecode(q, k, v, kc, vc, lens, layer=layer)
    torch.cuda.synchronize()
    want = decode_attention_plain(q.float(), k[layer].float(), v[layer].float(),
                                  kc.float(), vc.float(), lens, hd**-0.5)
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)


def _int8_inputs(seed, L, b, nkv, s):
    rng = np.random.default_rng(seed)
    ks = rng.uniform(0.002, 0.02, (L, b, nkv, s)).astype(np.float32)
    vs = rng.uniform(0.002, 0.02, (L, b, nkv, s)).astype(np.float32)
    return ks, vs


@pytest.mark.parametrize("L,b,nh,nkv,hd,s,lengths", [
    (2, 3, 4, 4, 64, 128, (0, 127, 64)),  # MHA, block edge
    (2, 2, 8, 2, 16, 256, (255, 100)),  # GQA g=4
])
def test_int8_plain_matches_pallas_interpret(L, b, nh, nkv, hd, s, lengths):
    import jax.numpy as jnp

    from vlrlhf_tpu.ops.decode_attention import decode_attention as jdecode

    q, _, _, kc, vc = _inputs(hd + s, L, b, nh, nkv, hd, s)
    rng = np.random.default_rng(s)
    k = rng.integers(-127, 128, (L, b, nkv, s, hd)).astype(np.int8)
    v = rng.integers(-127, 128, (L, b, nkv, s, hd)).astype(np.int8)
    ks, vs = (np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
              for a in _int8_inputs(s, L, b, nkv, s))
    lens = np.asarray(lengths, np.int32)
    tks, tvs = torch.from_numpy(ks).bfloat16(), torch.from_numpy(vs).bfloat16()
    for layer in range(L):
        got = tdecode(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kc), torch.from_numpy(vc), torch.from_numpy(lens),
            layer=layer, k_scale=tks, v_scale=tvs,
        ).numpy()
        for force_xla in (False, True):
            want = np.asarray(jdecode(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc),
                jnp.asarray(vc), jnp.asarray(lens), layer=layer, block_s=128,
                force_xla=force_xla, k_scale=jnp.asarray(ks, jnp.bfloat16),
                v_scale=jnp.asarray(vs, jnp.bfloat16),
            ))
            np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                       err_msg=f"layer {layer} xla {force_xla}")


@pytest.mark.cuda
@pytest.mark.parametrize("L,b,nh,nkv,hd,s", [
    (32, 8, 32, 32, 128, 1024), (2, 3, 8, 2, 128, 256), (2, 2, 16, 2, 256, 128),
    (2, 2, 4, 4, 8, 64),
])
def test_int8_kernel_matches_plain_on_card(L, b, nh, nkv, hd, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from vlrlhf_torch.ops.decode_attention import decode_attention_plain

    q, _, _, kc, vc = (torch.from_numpy(a).cuda().bfloat16()
                       for a in _inputs(4, 1, b, nh, nkv, hd, 1))
    rng = np.random.default_rng(5)
    k = torch.from_numpy(rng.integers(-127, 128, (L, b, nkv, s, hd)).astype(np.int8)).cuda()
    v = torch.from_numpy(rng.integers(-127, 128, (L, b, nkv, s, hd)).astype(np.int8)).cuda()
    ks, vs = (torch.from_numpy(a).cuda().bfloat16() for a in _int8_inputs(6, L, b, nkv, s))
    lens = torch.tensor([[0, s - 1, s // 2, 5][i % 4] for i in range(b)],
                        dtype=torch.int32, device="cuda")
    layer = L - 1
    got = tdecode(q, k, v, kc, vc, lens, layer=layer, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = decode_attention_plain(q.float(), k[layer], v[layer], kc.float(), vc.float(), lens,
                                  hd**-0.5, ks[layer], vs[layer])
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 1e-2, rel
