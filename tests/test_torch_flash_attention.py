"""Flash attention: vlrlhf_torch's plain version vs vlrlhf_tpu's Pallas
kernel in interpret mode (f32, valid rows only, tolerance 1e-5), plus the
Hopper kernel vs the plain version on the card (skips without CUDA)."""

import numpy as np
import pytest
import torch

from vlrlhf_torch.ops.flash_attention import flash_attention as tflash

TOL = 1e-5


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "causal,b,s,h,hkv,d,lens",
    [
        (True, 2, 128, 2, 2, 64, None),
        (False, 2, 128, 2, 2, 64, None),
        (True, 2, 150, 2, 2, 64, None),  # unaligned S
        (False, 1, 150, 2, 2, 8, None),
        (True, 3, 128, 4, 2, 8, (128, 100, 37)),  # right padding + GQA
        (True, 2, 150, 4, 1, 64, (150, 61)),  # unaligned + GQA + padding
        (False, 2, 128, 2, 2, 8, (128, 90)),  # non-causal with padding
    ],
)
def test_plain_matches_pallas_interpret(causal, b, s, h, hkv, d, lens):
    import jax.numpy as jnp  # the card machine has no jax: run there with -m cuda

    from vlrlhf_tpu.ops.flash_attention import flash_attention as jflash

    q, k, v = _inputs(s + d, b, s, h, hkv, d)
    lens = np.asarray(lens if lens is not None else (s,) * b)
    pad = np.arange(s)[None, :] < lens[:, None]
    kw = {}
    if not (pad.all()):
        kw = dict(pad_mask_q=pad, pad_mask_kv=pad)
    want = np.asarray(jflash(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=128, block_kv=128, **{n: jnp.asarray(a) for n, a in kw.items()},
    ))
    got = tflash(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, **{n: torch.from_numpy(a) for n, a in kw.items()},
    ).numpy()
    for i in range(b):  # fully masked pad rows differ by design; never read
        np.testing.assert_allclose(got[i, : lens[i]], want[i, : lens[i]], atol=TOL, rtol=TOL)


def test_plain_lse_and_masked_rows():
    """LSE equals logsumexp of the masked scaled scores; a fully masked row
    gives output 0 and LSE -inf."""
    q, k, v = _inputs(7, 1, 20, 2, 2, 8)
    pad = torch.arange(20)[None] < 12
    o, lse = tflash(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    causal=True, pad_mask_q=pad, pad_mask_kv=pad, return_lse=True)
    assert torch.all(o[0, 12:] == 0) and torch.all(torch.isneginf(lse[0, :, 12:]))
    s = torch.einsum("qhd,khd->hqk", torch.from_numpy(q[0]), torch.from_numpy(k[0])) * 8**-0.5
    allowed = (torch.arange(20)[None] <= torch.arange(20)[:, None]) & pad[0][None] & pad[0][:, None]
    ref = torch.logsumexp(s.masked_fill(~allowed, float("-inf")), dim=-1)
    torch.testing.assert_close(lse[0, :, :12], ref[:, :12], atol=TOL, rtol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,b,s,h,hkv,d", [
    (False, 2, 577, 16, 16, 64), (True, 2, 640, 32, 32, 128),
    (True, 1, 200, 8, 2, 128), (True, 2, 40, 4, 4, 8),
])
def test_kernel_matches_plain_on_card(causal, b, s, h, hkv, d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from vlrlhf_torch.ops.flash_attention import (
        KV_PAD_SEG, Q_PAD_SEG, flash_attention_plain, make_segments,
    )

    q, k, v = (torch.from_numpy(a).cuda().bfloat16() for a in _inputs(1, b, s, h, hkv, d))
    lens = torch.tensor([s - 3 * i for i in range(b)], device="cuda")
    pad = torch.arange(s, device="cuda")[None] < lens[:, None]
    o, lse = tflash(q, k, v, causal=causal, pad_mask_q=pad, pad_mask_kv=pad, return_lse=True)
    torch.cuda.synchronize()
    seg_q = make_segments(b, s, q.device, None, pad, Q_PAD_SEG)
    seg_kv = make_segments(b, s, q.device, None, pad, KV_PAD_SEG)
    ro, rlse = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv, causal, d**-0.5)
    for i in range(b):
        n = int(lens[i])
        torch.testing.assert_close(o[i, :n].float(), ro[i, :n], atol=2e-2, rtol=2e-2)
        torch.testing.assert_close(lse[i, :, :n], rlse[i, :, :n], atol=2e-2, rtol=2e-2)
