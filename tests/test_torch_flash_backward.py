"""Flash attention backward: vlrlhf_torch's plain backward and its autograd
path (`FlashAttention`) vs jax.grad through vlrlhf_tpu's Pallas kernels in
interpret mode (f32, atol 5e-5, rtol 5e-4 — the JAX package's own tolerance
for its backward, tests/test_flash_attention.py), plus the Hopper kernels vs
the plain backward on the card (skips without CUDA)."""

import numpy as np
import pytest
import torch

from vlrlhf_torch.ops.flash_attention import (
    KV_PAD_SEG,
    Q_PAD_SEG,
    flash_attention,
    flash_attention_bwd_plain,
    flash_attention_plain,
    make_segments,
)

ATOL, RTOL = 5e-5, 5e-4
CASES = [
    # (causal, b, s, h, hkv, d, lens, with segments)
    (True, 1, 128, 2, 2, 64, None, False),
    (False, 1, 128, 2, 2, 64, None, False),
    (True, 2, 150, 4, 4, 8, (150, 97), True),  # padding + segments, ragged S
    (True, 2, 128, 4, 2, 16, (128, 77), False),  # GQA + padding
    (False, 1, 96, 4, 1, 8, None, True),  # GQA 4:1, non-causal, segments
]


def _inputs(seed, b, s, h, hkv, d, lens, with_seg):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    w = rng.standard_normal((b, s, h, d)).astype(np.float32)  # upstream weights
    lens = np.asarray(lens if lens is not None else (s,) * b)
    pad = np.arange(s)[None, :] < lens[:, None]
    seg = np.broadcast_to((np.arange(s) >= s // 3).astype(np.int32), (b, s)).copy() \
        if with_seg else None
    return q, k, v, w, pad, seg


def _jax_grads(q, k, v, w, pad, seg, causal):
    import jax
    import jax.numpy as jnp

    from vlrlhf_tpu.ops.flash_attention import flash_attention as jflash

    kw = dict(pad_mask_q=jnp.asarray(pad), pad_mask_kv=jnp.asarray(pad))
    if seg is not None:
        kw.update(segment_ids_q=jnp.asarray(seg), segment_ids_kv=jnp.asarray(seg))

    def loss(q, k, v):
        o = jflash(q, k, v, causal=causal, block_q=128, block_kv=128, **kw)
        # padded rows are never read (their forward differs by design)
        return jnp.sum(jnp.where(jnp.asarray(pad)[..., None, None], o, 0.0) * w)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


def _check(got, want, pad, name):
    if name == "dq":  # valid rows only; masked rows get no gradient
        for i in range(pad.shape[0]):
            np.testing.assert_allclose(got[i][pad[i]], want[i][pad[i]], atol=ATOL, rtol=RTOL,
                                       err_msg=name)
    else:  # over all rows: masked keys stay at 0 on both sides
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens,with_seg", CASES)
def test_autograd_matches_pallas_interpret(causal, b, s, h, hkv, d, lens, with_seg):
    q, k, v, w, pad, seg = _inputs(s + d + h, b, s, h, hkv, d, lens, with_seg)
    want = _jax_grads(q, k, v, w, pad, seg, causal)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    kw = dict(pad_mask_q=torch.from_numpy(pad), pad_mask_kv=torch.from_numpy(pad))
    if seg is not None:
        kw.update(segment_ids_q=torch.from_numpy(seg), segment_ids_kv=torch.from_numpy(seg))
    o = flash_attention(tq, tk, tv, causal=causal, **kw)
    (torch.where(torch.from_numpy(pad)[..., None, None], o, 0.0) * torch.from_numpy(w)).sum() \
        .backward()
    for got, ref, name in zip((tq.grad, tk.grad, tv.grad), want, ("dq", "dk", "dv")):
        _check(got.numpy(), ref, pad, name)


@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens,with_seg", CASES[2:4])
def test_plain_backward_matches_pallas_interpret(causal, b, s, h, hkv, d, lens, with_seg):
    """`flash_attention_bwd_plain` called directly, as the card check calls
    it: LSE from the plain forward, di = rowsum(O * dO), dO zero on padded
    rows (what the loss above hands back)."""
    q, k, v, w, pad, seg = _inputs(s + d + h, b, s, h, hkv, d, lens, with_seg)
    want = _jax_grads(q, k, v, w, pad, seg, causal)
    t = torch.from_numpy
    seg_t = None if seg is None else t(seg)
    seg_q = make_segments(b, s, "cpu", seg_t, t(pad), Q_PAD_SEG)
    seg_kv = make_segments(b, s, "cpu", seg_t, t(pad), KV_PAD_SEG)
    o, lse = flash_attention_plain(t(q), t(k), t(v), seg_q, seg_kv, causal, d**-0.5)
    do = torch.where(t(pad)[..., None, None], t(w), 0.0)
    di = (o * do).sum(-1).transpose(1, 2)
    got = flash_attention_bwd_plain(t(q), t(k), t(v), do, lse, di, seg_q, seg_kv, causal,
                                    d**-0.5)
    for g, ref, name in zip(got, want, ("dq", "dk", "dv")):
        _check(g.numpy(), ref, pad, name)


def test_fully_masked_rows_give_zero_and_finite_grads():
    """Right-pad rows have LSE -inf: their p must be 0 before any product,
    so every gradient is finite and the padded keys' dK/dV are exactly 0."""
    q, k, v, w, pad, _ = _inputs(3, 1, 40, 2, 2, 8, (25,), False)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    padt = torch.from_numpy(pad)
    o = flash_attention(tq, tk, tv, causal=True, pad_mask_q=padt, pad_mask_kv=padt)
    (o * torch.from_numpy(w)).sum().backward()  # upstream grads on padded rows too
    for g in (tq.grad, tk.grad, tv.grad):
        assert torch.isfinite(g).all()
    assert torch.all(tq.grad[0, 25:] == 0)
    assert torch.all(tk.grad[0, 25:] == 0) and torch.all(tv.grad[0, 25:] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,b,s,h,hkv,d,lens", [
    (True, 2, 1024, 32, 32, 128, (1000, 900)),  # the DPO path's LM shape
    (True, 2, 640, 32, 8, 128, (640, 601)),  # GQA
    (False, 1, 200, 4, 4, 64, (200,)),
    (True, 2, 40, 4, 2, 8, (40, 33)),  # the synthetic head_dim, ragged tiles
    (True, 1, 130, 4, 2, 256, (130,)),  # the widest head_dim: the mma.sync dK/dV and dQ kernels, by shape
    (True, 1, 65, 4, 4, 64, None),  # one key and one query past a tile
    (False, 2, 129, 4, 2, 128, (129, 100)),
    (True, 2, 577, 4, 4, 64, (577, 500)),  # the tower's ragged length
    (False, 1, 577, 2, 2, 128, None),
    (False, 2, 577, 16, 16, 64, None),  # an unfrozen tower's backward: the D = 64 dQ ring
    (True, 2, 129, 32, 8, 128, (129, 77)),  # GQA 32 / 8 at ragged tiles
    (False, 1, 130, 2, 2, 72, None),  # D read through TMA's zero fill up to 128
    (False, 16, 257, 16, 16, 88, None),  # an unfrozen EVA tower (InstructBLIP): D = 88
    (True, 2, 4096, 32, 8, 128, (4096, 3800)),  # LLaVA-Next mistral's anyres DPO pair
])  # every other case reaches the wgmma dK/dV and dQ kernels
def test_kernels_match_plain_on_card(causal, b, s, h, hkv, d, lens):
    """bf16 kernels vs the plain backward in f32 on the same bf16 values,
    for dQ (valid rows), dK, dV: max abs error <= 2e-2 * max(1, max |ref|),
    and ||got - ref||_F / ||ref||_F <= 1e-2, which holds the many entries
    far below the largest (bf16 rounding alone gives a few 1e-3)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from vlrlhf_torch.ops.flash_attention import flash_attention_bwd

    q, k, v, w, pad, _ = _inputs(5, b, s, h, hkv, d, lens, False)
    q, k, v = (torch.from_numpy(a).cuda().bfloat16() for a in (q, k, v))
    padt = torch.from_numpy(pad).cuda()
    do = torch.where(padt[..., None, None], torch.from_numpy(w).cuda(), 0.0).bfloat16()
    seg_q = make_segments(b, s, q.device, None, padt, Q_PAD_SEG)
    seg_kv = make_segments(b, s, q.device, None, padt, KV_PAD_SEG)
    o, lse = flash_attention(q, k, v, causal=causal, pad_mask_q=padt, pad_mask_kv=padt,
                             return_lse=True)
    from vlrlhf_torch.ops.flash_attention import flash_bwd_dkv, flash_bwd_dq

    before = (flash_bwd_dkv.launches, flash_bwd_dq.launches)
    got = flash_attention_bwd(q, k, v, o, lse, do, seg_q, seg_kv, causal, d**-0.5)
    torch.cuda.synchronize()
    assert (flash_bwd_dkv.launches, flash_bwd_dq.launches) == (before[0] + 1, before[1] + 1)
    di = (o.float() * do.float()).sum(-1).transpose(1, 2)
    want = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse, di,
                                     seg_q, seg_kv, causal, d**-0.5)
    for g, ref, name in zip(got, want, ("dq", "dk", "dv")):
        if name == "dq":
            g, ref = g[padt], ref[padt]
        err = float((g.float() - ref).abs().max())
        tol = 2e-2 * max(1.0, float(ref.abs().max()))
        rel = float((g.float() - ref).norm() / ref.norm())
        assert err <= tol and rel <= 1e-2, (name, err, tol, rel)


def _card_dkv(q, k, v, w, seg_q, seg_kv, causal, rows):
    """The dK/dV kernel (one counted launch) vs the plain backward in f32 on
    the same bf16 values, at the bounds above; dO is `w` on `rows` and 0
    elsewhere. The LSE comes from the forward kernel."""
    from vlrlhf_torch.ops.flash_attention import flash_bwd_dkv

    scale = q.shape[-1] ** -0.5
    o, lse = flash_attention(q, k, v, causal=causal, segment_ids_q=seg_q,
                             segment_ids_kv=seg_kv, return_lse=True)
    do = torch.where(rows[..., None, None], w, 0.0).bfloat16().contiguous()
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    before = flash_bwd_dkv.launches
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
    torch.cuda.synchronize()
    assert flash_bwd_dkv.launches == before + 1
    _, rk, rv = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse, di,
                                          seg_q, seg_kv, causal, scale)
    for g, ref, name in ((dk, rk, "dk"), (dv, rv, "dv")):
        assert torch.isfinite(g.float()).all(), name
        err = float((g.float() - ref).abs().max())
        tol = 2e-2 * max(1.0, float(ref.abs().max()))
        rel = float((g.float() - ref).norm() / ref.norm())
        assert err <= tol and rel <= 1e-2, (name, err, tol, rel)
    return dk, dv


def _card_tensors(seed, b, s, h, hkv, d):
    """bf16 q, k, v and the f32 upstream weights on the card."""
    q, k, v, w, _, _ = _inputs(seed, b, s, h, hkv, d, None, False)
    return [torch.from_numpy(a).cuda().bfloat16() for a in (q, k, v)] + [torch.from_numpy(w).cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_dkv_kernel_segments_inside_a_tile_on_card(causal):
    """Packed sequences: several segments inside one key tile (lengths
    5-70), so no tile is uniform and every one takes the masked path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, d = 2, 300, 4, 128
    q, k, v, w = _card_tensors(8, b, s, h, h, d)
    rng = np.random.default_rng(9)
    seg = np.repeat(np.arange(60), rng.integers(5, 71, 60))[: b * s].reshape(b, s)
    seg = torch.from_numpy(seg).cuda().to(torch.int32)
    _card_dkv(q, k, v, w, seg, seg, causal, torch.ones((b, s), dtype=torch.bool, device="cuda"))


@pytest.mark.cuda
def test_dkv_kernel_fully_masked_rows_on_card():
    """Query rows that match no key (LSE -inf) with a nonzero upstream
    gradient: they contribute nothing, and dK / dV stay finite; keys no
    query sees get exactly 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, d = 1, 150, 2, 128
    q, k, v, w = _card_tensors(10, b, s, h, h, d)
    seg_q = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    seg_q[0, 100:] = 7  # no key carries segment 7
    seg_kv = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    seg_kv[0, 140:] = 5  # and no query carries segment 5
    dk, dv = _card_dkv(q, k, v, w, seg_q, seg_kv, True,
                       torch.ones((b, s), dtype=torch.bool, device="cuda"))
    assert torch.all(dk[0, 140:] == 0) and torch.all(dv[0, 140:] == 0)


def _card_dq(q, k, v, w, seg_q, seg_kv, causal, rows):
    """The dQ kernel (one counted launch) vs the plain backward in f32 on the
    same bf16 values, over every row (a row that matches no key gets 0 on
    both sides), at the bounds above; dO is `w` on `rows` and 0 elsewhere.
    The LSE comes from the forward kernel. Returns (dQ, the launch's
    arguments) so a test can launch again."""
    from vlrlhf_torch.ops.flash_attention import flash_bwd_dq

    scale = q.shape[-1] ** -0.5
    o, lse = flash_attention(q, k, v, causal=causal, segment_ids_q=seg_q,
                             segment_ids_kv=seg_kv, return_lse=True)
    do = torch.where(rows[..., None, None], w, 0.0).bfloat16().contiguous()
    di = (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, di, seg_q, seg_kv, causal, scale)
    before = flash_bwd_dq.launches
    dq = flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert flash_bwd_dq.launches == before + 1
    rq, _, _ = flash_attention_bwd_plain(q.float(), k.float(), v.float(), do.float(), lse, di,
                                         seg_q, seg_kv, causal, scale)
    assert torch.isfinite(dq.float()).all()
    err = float((dq.float() - rq).abs().max())
    tol = 2e-2 * max(1.0, float(rq.abs().max()))
    rel = float((dq.float() - rq).norm() / rq.norm())
    assert err <= tol and rel <= 1e-2, ("dq", err, tol, rel)
    return dq, args


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
def test_dq_kernel_segments_inside_a_tile_on_card(causal):
    """Packed sequences: several segments inside one key tile (lengths
    5-70), so no tile is uniform and every one takes the masked path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, d = 2, 300, 4, 128
    q, k, v, w = _card_tensors(8, b, s, h, h, d)
    rng = np.random.default_rng(9)
    seg = np.repeat(np.arange(60), rng.integers(5, 71, 60))[: b * s].reshape(b, s)
    seg = torch.from_numpy(seg).cuda().to(torch.int32)
    _card_dq(q, k, v, w, seg, seg, causal, torch.ones((b, s), dtype=torch.bool, device="cuda"))


@pytest.mark.cuda
def test_dq_kernel_fully_masked_rows_on_card():
    """Query rows whose segment matches no key (LSE -inf) with a nonzero
    upstream gradient get dQ exactly 0; every other row is finite and
    matches the plain backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, d = 1, 150, 2, 128
    q, k, v, w = _card_tensors(10, b, s, h, h, d)
    seg_q = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    seg_q[0, 100:] = 7  # no key carries segment 7
    seg_kv = torch.zeros((b, s), dtype=torch.int32, device="cuda")
    seg_kv[0, 140:] = 5  # and no query carries segment 5
    dq, _ = _card_dq(q, k, v, w, seg_q, seg_kv, True,
                     torch.ones((b, s), dtype=torch.bool, device="cuda"))
    assert torch.all(dq[0, 100:] == 0)
    assert torch.any(dq[0, :100] != 0)


def _padded_segments(b, s, lens):
    pad = torch.arange(s, device="cuda")[None] < torch.tensor(lens, device="cuda")[:, None]
    return pad, make_segments(b, s, pad.device, None, pad, Q_PAD_SEG), \
        make_segments(b, s, pad.device, None, pad, KV_PAD_SEG)


@pytest.mark.cuda
def test_dq_kernel_long_causal_rows_with_a_short_row_on_card():
    """S = 1024 with a second row of 300 tokens: the query blocks launch
    heaviest first (reversed grid), and for the short row every block past
    token 300 meets the ragged edge of its keys; those rows get dQ 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    b, s, h, d = 2, 1024, 4, 128
    q, k, v, w = _card_tensors(11, b, s, h, h, d)
    pad, seg_q, seg_kv = _padded_segments(b, s, (1024, 300))
    dq, _ = _card_dq(q, k, v, w, seg_q, seg_kv, True, pad)
    assert torch.all(dq[1, 300:] == 0)


@pytest.mark.cuda
def test_dq_kernel_is_deterministic_on_card():
    """No atomics: two launches on the same inputs give bit-identical dQ
    (S = 1024, GQA 32 / 8, ragged rows)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from vlrlhf_torch.ops.flash_attention import flash_bwd_dq

    b, s, h, hkv, d = 2, 1024, 32, 8, 128
    q, k, v, w = _card_tensors(12, b, s, h, hkv, d)
    pad, seg_q, seg_kv = _padded_segments(b, s, (1000, 900))
    first, args = _card_dq(q, k, v, w, seg_q, seg_kv, True, pad)
    second = flash_bwd_dq(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
