"""vlrlhf_torch/ops/ring_attention.py in one process: the per-block
functions looped as a ring of n ranks (`ring_attention_local`) against
vlrlhf_tpu's `ring_attention` under MeshConfig(fsdp=n) on the virtual CPU
devices of tests/conftest.py, at n = 2, 4 and 8, on every case of
tests/test_ring_attention.py (causal and not, padding mid-shard, the
gradients of sum(O ** 2)) and GQA 4 / 2 (vlrlhf_tpu repeats the KV heads
before its ring, as its LM does; the port's blocks take them as they
are), at that file's bounds: forward 2e-5, gradients 5e-5 / 5e-4. Plus the
merge's masked rows and the skipped blocks. The op over a process group:
tests/test_torch_dist_sp.py; the kernels on the card:
`test_ring_on_the_kernels_matches_the_whole_sequence`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlrlhf_torch.ops.ring_attention import merge, ring_attention_local, ring_block_forward

FWD_TOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-5, 5e-4

# name: (b, s / n, h, h_kv, d, causal, padded length or None)
CASES = {
    "causal": (2, 16, 2, 2, 16, True, None),
    "noncausal": (2, 16, 2, 2, 16, False, None),
    "padding": (1, 16, 2, 2, 16, True, 100 / 128),
    "gqa": (2, 16, 4, 2, 8, True, 0.6),
}


@pytest.fixture(autouse=True)
def restore_jax_mesh():
    """vlrlhf_tpu's make_mesh registers its mesh globally; put it back."""
    from vlrlhf_tpu.core import mesh as jmesh

    prev = jmesh._GLOBAL_MESH
    yield
    jmesh._GLOBAL_MESH = prev


def _inputs(case: str, n: int):
    b, c, h, hkv, d, causal, frac = CASES[case]
    s = c * n
    rng = np.random.default_rng(10 * list(CASES).index(case) + n)
    q = rng.standard_normal((b, s, h, d), np.float32)
    k = rng.standard_normal((b, s, hkv, d), np.float32)
    v = rng.standard_normal((b, s, hkv, d), np.float32)
    pad = np.ones((b, s), bool)
    if frac is not None:
        pad[0, int(frac * s):] = False  # ends inside a shard
    return q, k, v, pad, causal


def _jax_ring(q, k, v, pad, causal, n):
    """vlrlhf_tpu's ring under fsdp = n: O and the gradients of the sum of
    the valid rows' O ** 2 in q, k and v (the KV heads repeated inside, so
    dK / dV are per KV head). vlrlhf_tpu masks keys only, so a padded
    query still attends; the port's gives 0, and the loss leaves it out."""
    from vlrlhf_tpu.core.mesh import MeshConfig, make_mesh
    from vlrlhf_tpu.ops.ring_attention import ring_attention

    mesh = make_mesh(MeshConfig(data=1, fsdp=n, model=1))
    rep = q.shape[2] // k.shape[2]
    padj = jnp.asarray(pad)

    def fwd(q, k, v):
        k, v = jnp.repeat(k, rep, axis=2), jnp.repeat(v, rep, axis=2)
        return ring_attention(q, k, v, mesh, axis_name="fsdp", causal=causal, pad_mask=padj)

    def loss(q, k, v):
        out = fwd(q, k, v)
        return jnp.sum((out * padj[:, :, None, None]) ** 2), out

    args = tuple(jnp.asarray(x) for x in (q, k, v))
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_local_ring_matches_vlrlhf_tpu(case, n):
    q, k, v, pad, causal = _inputs(case, n)
    want, want_grads = _jax_ring(q, k, v, pad, causal, n)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = ring_attention_local(*t, torch.from_numpy(pad), n, causal=causal)
    # the gradient of sum(O ** 2) is dO = 2 O; a padded query's O is 0 in both
    got, grads = ring_attention_local(*t, torch.from_numpy(pad), n, causal=causal,
                                      do=2.0 * out)
    valid = pad[:, :, None, None] & np.ones_like(q, bool)
    np.testing.assert_allclose(got.numpy()[valid], want[valid], atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_array_equal(got.numpy()[~valid], 0.0)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name}")


def test_merge_keeps_masked_rows_at_zero_and_blocks_past_the_diagonal_skip():
    from vlrlhf_torch.ops.flash_attention import KV_PAD_SEG, Q_PAD_SEG, make_segments

    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 8, 2, 8), np.float32))
               for _ in range(3))
    pad = torch.ones((1, 8), dtype=torch.bool)
    pad[0, 5:] = False
    seg_q = make_segments(1, 8, "cpu", None, pad, Q_PAD_SEG)
    seg_kv = make_segments(1, 8, "cpu", None, pad, KV_PAD_SEG)
    assert ring_block_forward(q, k, v, seg_q, seg_kv, src=3, idx=1, scale=0.3) is None
    assert ring_block_forward(q, k, v, seg_q, seg_kv, src=3, idx=1, scale=0.3,
                              causal=False) is not None
    a = ring_block_forward(q, k, v, seg_q, seg_kv, src=1, idx=1, scale=0.3)
    o, lse = merge(merge(None, a), a)  # one block twice: O unchanged, LSE + ln 2
    valid = pad[0]
    torch.testing.assert_close(o[:, valid], a[0][:, valid].float(), atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse[..., valid], a[1][..., valid] + np.log(2.0), atol=1e-6,
                               rtol=1e-6)
    assert torch.isinf(lse[..., ~valid]).all() and (o[:, ~valid] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_ring_on_the_kernels_matches_the_whole_sequence(n):
    """The ring's blocks on kernels 1-3 (bf16) against the whole-sequence
    kernels and against the plain ring on the same inputs, at GQA 32 / 8,
    S = 1024, a row padded inside the last shard."""
    from vlrlhf_torch.ops.flash_attention import flash_attention

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(n)
    b, s, h, hkv, d = 2, 1024, 32, 8, 128
    q = torch.randn((b, s, h, d), generator=g, device="cuda").to(torch.bfloat16)
    k = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    v = torch.randn((b, s, hkv, d), generator=g, device="cuda").to(torch.bfloat16)
    do = torch.randn((b, s, h, d), generator=g, device="cuda").to(torch.bfloat16)
    pad = torch.ones((b, s), dtype=torch.bool, device="cuda")
    pad[1, s - 100:] = False
    o, grads = ring_attention_local(q, k, v, pad, n, do=do)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    whole = flash_attention(qr, kr, vr, pad_mask_q=pad, pad_mask_kv=pad)
    whole.backward(do)
    plain_o, plain_grads = ring_attention_local(*(t.cpu().float() for t in (q, k, v)),
                                                pad.cpu(), n, do=do.cpu().float())
    valid = pad[:, :, None, None].expand_as(o)
    for got, want, other in [(o, whole, plain_o), *zip(grads, (qr.grad, kr.grad, vr.grad),
                                                        plain_grads)]:
        m = valid if got.shape == o.shape else torch.ones_like(got, dtype=torch.bool)
        assert (got.float() - want.float())[m].abs().max() < 2e-2
        assert (got.float().cpu() - other)[m.cpu()].abs().max() < 2e-2
