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


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _card_check(q, k, v, causal, seg_q, seg_kv, rows, **kw):
    """One kernel launch (counted) against the plain version on the same
    bf16 values; `rows` (B, Sq) bool selects the rows compared."""
    from vlrlhf_torch.ops.flash_attention import flash_attention_plain

    before = tflash.launches
    o, lse = tflash(q, k, v, causal=causal, return_lse=True, **kw)
    torch.cuda.synchronize()
    assert tflash.launches == before + 1
    ro, rlse = flash_attention_plain(q.float(), k.float(), v.float(), seg_q, seg_kv, causal,
                                     q.shape[-1]**-0.5)
    torch.testing.assert_close(o[rows].float(), ro[rows], atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(lse.transpose(1, 2)[rows], rlse.transpose(1, 2)[rows],
                               atol=2e-2, rtol=2e-2)
    return o, lse


@pytest.mark.cuda
@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens", [
    (False, 2, 577, 16, 16, 64, None), (True, 2, 640, 32, 32, 128, None),
    (True, 1, 200, 8, 2, 128, None), (True, 2, 40, 4, 4, 8, None),
    (True, 2, 1024, 32, 32, 128, (1000, 900)),  # the DPO step
    (True, 2, 640, 32, 8, 128, (640, 601)),  # GQA 32 / 8
    (True, 1, 65, 4, 4, 64, None), (False, 2, 129, 4, 2, 128, None),  # tile edges + 1
    (True, 2, 577, 4, 4, 64, None), (False, 1, 577, 2, 2, 128, None),  # the ragged tower length
    (True, 2, 200, 4, 2, 256, None), (False, 1, 129, 2, 2, 256, None),  # D = 256
    (True, 1, 130, 2, 2, 72, None),  # D padded up to the next instantiated width
    (False, 16, 257, 16, 16, 88, None),  # InstructBLIP's EVA tower: D = 88, S = 257
    (True, 2, 4096, 32, 8, 128, (4096, 3800)),  # LLaVA-Next mistral's anyres DPO pair
])
def test_kernel_matches_plain_on_card(causal, b, s, h, hkv, d, lens):
    from vlrlhf_torch.ops.flash_attention import KV_PAD_SEG, Q_PAD_SEG, make_segments

    dev = _card()
    q, k, v = (torch.from_numpy(a).to(dev).bfloat16() for a in _inputs(1, b, s, h, hkv, d))
    lens = torch.tensor(lens or [s - 3 * i for i in range(b)], device=dev)
    pad = torch.arange(s, device=dev)[None] < lens[:, None]
    seg_q = make_segments(b, s, dev, None, pad, Q_PAD_SEG)
    seg_kv = make_segments(b, s, dev, None, pad, KV_PAD_SEG)
    _card_check(q, k, v, causal, seg_q, seg_kv, pad, pad_mask_q=pad, pad_mask_kv=pad)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_kernel_segments_inside_a_tile_on_card(causal):
    """Packed sequences: several segments inside one key tile (explicit
    segment ids, segment lengths 5-70), so no tile is uniform."""
    dev = _card()
    b, s, h, d = 2, 300, 4, 128
    q, k, v = (torch.from_numpy(a).to(dev).bfloat16() for a in _inputs(2, b, s, h, h, d))
    rng = np.random.default_rng(3)
    seg = np.repeat(np.arange(60), rng.integers(5, 71, 60))[: b * s].reshape(b, s)
    seg = torch.from_numpy(seg).to(dev, torch.int32)
    rows = torch.ones((b, s), dtype=torch.bool, device=dev)
    _card_check(q, k, v, causal, seg, seg, rows, segment_ids_q=seg, segment_ids_kv=seg)


@pytest.mark.cuda
def test_kernel_fully_masked_rows_on_card():
    """A query row that matches no key gives O = 0 and LSE = -inf (the
    backward kernels read the LSE); the other rows match the plain version."""
    dev = _card()
    b, s, h, d = 1, 150, 2, 64
    q, k, v = (torch.from_numpy(a).to(dev).bfloat16() for a in _inputs(4, b, s, h, h, d))
    seg_q = torch.zeros((b, s), dtype=torch.int32, device=dev)
    seg_q[0, 100:] = 7  # no key carries segment 7
    seg_kv = torch.zeros((b, s), dtype=torch.int32, device=dev)
    rows = seg_q == 0
    o, lse = _card_check(q, k, v, True, seg_q, seg_kv, rows, segment_ids_q=seg_q,
                         segment_ids_kv=seg_kv)
    assert torch.all(o[0, 100:] == 0) and torch.all(torch.isneginf(lse[0, :, 100:]))


@pytest.mark.cuda
@pytest.mark.parametrize("causal,sq,skv,d", [
    (False, 100, 300, 128), (True, 300, 100, 128),  # more keys / more queries than the other
    (True, 129, 577, 64), (False, 577, 65, 64),  # ragged tiles on both sides
])
def test_kernel_non_square_on_card(causal, sq, skv, d):
    """Sq != Skv, which the kernel's contract keeps legal (causality by
    absolute index, key <= query) though no caller sends it today: every
    query row sees key 0, so all rows are compared."""
    dev = _card()
    rng = np.random.default_rng(sq + skv)
    b, h, hkv = 2, 4, 2
    q = torch.from_numpy(rng.standard_normal((b, sq, h, d)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, skv, hkv, d)).astype(np.float32))
            for _ in range(2))
    q, k, v = (t.to(dev).bfloat16() for t in (q, k, v))
    seg_q = torch.zeros((b, sq), dtype=torch.int32, device=dev)
    seg_kv = torch.zeros((b, skv), dtype=torch.int32, device=dev)
    _card_check(q, k, v, causal, seg_q, seg_kv, torch.ones((b, sq), dtype=torch.bool, device=dev))
