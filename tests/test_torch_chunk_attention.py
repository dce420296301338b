"""Chunk attention: vlrlhf_torch's plain version vs vlrlhf_tpu's Pallas
kernel in interpret mode and its dense XLA oracle (force_xla), on the
valid query rows. f32 and int8 caches (fed the same codes and scales):
tolerance 1e-5; a bf16 cache 2e-2 (the Pallas kernel rounds the softmax
weights to bf16 before the value product, the plain version keeps f32).
Covers the stacked-cache layer index, GQA groups 1, 2 and 4, chunk lengths
C in {1, 4, 17, 64} and lengths on block edges. The Hopper kernel vs the
plain version runs on the card only (-m cuda; skips without CUDA)."""

import numpy as np
import pytest
import torch

from vlrlhf_torch.ops.chunk_attention import chunk_attention as tchunk

TOL = 1e-5
BF16_TOL = 2e-2


def _inputs(seed, L, b, c, nh, nkv, hd, s, int8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, nh, hd)).astype(np.float32)
    if int8:
        kc = rng.integers(-127, 128, (L, b, nkv, s, hd)).astype(np.int8)
        vc = rng.integers(-127, 128, (L, b, nkv, s, hd)).astype(np.int8)
        ks = (rng.uniform(0.002, 0.02, (L, b, nkv, s))).astype(np.float32)
        vs = (rng.uniform(0.002, 0.02, (L, b, nkv, s))).astype(np.float32)
        return q, kc, vc, ks, vs
    kc = rng.standard_normal((L, b, nkv, s, hd)).astype(np.float32)
    vc = rng.standard_normal((L, b, nkv, s, hd)).astype(np.float32)
    return q, kc, vc, None, None


def _valid(out, lengths, chunk_lens):
    return [out[i, :n] for i, n in enumerate(chunk_lens)]


CASES = [
    # L, b, c, nh, nkv, hd, s, lengths (block edges at 64), cache kind
    (2, 2, 4, 4, 4, 16, 128, (63, 64), "f32"),
    (2, 3, 17, 8, 2, 16, 128, (0, 47, 111), "f32"),
    (1, 2, 64, 4, 1, 8, 128, (0, 64), "f32"),
    (2, 2, 1, 4, 2, 16, 128, (127, 5), "f32"),
    (2, 2, 4, 4, 4, 16, 128, (63, 64), "int8"),
    (2, 2, 17, 8, 4, 16, 128, (64, 100), "int8"),
    (1, 2, 64, 4, 2, 8, 128, (63, 0), "int8"),
    (2, 2, 4, 4, 2, 16, 128, (64, 120), "bf16"),
]


@pytest.mark.parametrize("L,b,c,nh,nkv,hd,s,lengths,kind", CASES)
def test_plain_matches_pallas_and_xla(L, b, c, nh, nkv, hd, s, lengths, kind):
    import jax.numpy as jnp  # the card machine has no jax: run there with -m cuda

    from vlrlhf_tpu.ops.chunk_attention import chunk_attention as jchunk

    int8 = kind == "int8"
    q, kc, vc, ks, vs = _inputs(c * 7 + s, L, b, c, nh, nkv, hd, s, int8)
    if int8:  # scales as the cache stores them: bf16
        ks = np.asarray(jnp.asarray(ks, jnp.bfloat16).astype(jnp.float32))
        vs = np.asarray(jnp.asarray(vs, jnp.bfloat16).astype(jnp.float32))
    lens = np.asarray(lengths, np.int32)
    chunk_lens = [min(c, s - n) for n in lengths]
    jdt = jnp.bfloat16 if kind == "bf16" else jnp.float32
    tdt = torch.bfloat16 if kind == "bf16" else torch.float32
    jq = jnp.asarray(q, jdt)
    jkc = jnp.asarray(kc) if int8 else jnp.asarray(kc, jdt)
    jvc = jnp.asarray(vc) if int8 else jnp.asarray(vc, jdt)
    jks = None if ks is None else jnp.asarray(ks, jnp.bfloat16)
    jvs = None if vs is None else jnp.asarray(vs, jnp.bfloat16)
    tq = torch.from_numpy(np.asarray(jq.astype(jnp.float32))).to(tdt)
    tkc = torch.from_numpy(kc) if int8 else torch.from_numpy(kc).to(tdt)
    tvc = torch.from_numpy(vc) if int8 else torch.from_numpy(vc).to(tdt)
    tks = None if ks is None else torch.from_numpy(ks).to(torch.bfloat16)
    tvs = None if vs is None else torch.from_numpy(vs).to(torch.bfloat16)
    tol = BF16_TOL if kind == "bf16" else TOL
    for layer in range(L):
        got = tchunk(tq, tkc, tvc, torch.from_numpy(lens), layer=layer,
                     k_scale=tks, v_scale=tvs).float().numpy()
        for force_xla in (False, True):
            want = np.asarray(jchunk(jq, jkc, jvc, jnp.asarray(lens), layer=layer, block_s=64,
                                     force_xla=force_xla, k_scale=jks, v_scale=jvs)
                              .astype(jnp.float32))
            for g, w in zip(_valid(got, lens, chunk_lens), _valid(want, lens, chunk_lens)):
                np.testing.assert_allclose(g, w, atol=tol, rtol=tol,
                                           err_msg=f"layer {layer} xla {force_xla}")


def test_unstacked_cache_and_scale_pairing():
    q, kc, vc, ks, vs = _inputs(1, 1, 2, 3, 4, 2, 8, 32, True)
    q, kc, vc = torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc)
    ks, vs = torch.from_numpy(ks).bfloat16(), torch.from_numpy(vs).bfloat16()
    lens = torch.tensor([3, 20], dtype=torch.int32)
    stacked = tchunk(q, kc, vc, lens, layer=0, k_scale=ks, v_scale=vs)
    single = tchunk(q, kc[0], vc[0], lens, k_scale=ks[0], v_scale=vs[0])
    torch.testing.assert_close(stacked, single)
    with pytest.raises(ValueError, match="both k_scale and v_scale"):
        tchunk(q, kc[0], vc[0], lens, v_scale=vs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("L,b,c,nh,nkv,hd,s,kind", [
    (4, 8, 4, 32, 32, 128, 1024, "bf16"),  # the speculative verify chunk
    (4, 8, 4, 32, 32, 128, 1024, "int8"),
    (2, 1, 64, 32, 32, 128, 1024, "bf16"),  # a chat turn
    (2, 1, 64, 32, 32, 128, 1024, "int8"),
    (2, 3, 17, 8, 2, 64, 256, "bf16"),  # GQA g=4, two query tiles
    (2, 2, 5, 16, 2, 256, 128, "int8"),  # g=8, head_dim 256
    (1, 2, 1, 4, 4, 8, 64, "bf16"),
])
def test_kernel_matches_plain_on_card(L, b, c, nh, nkv, hd, s, kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from vlrlhf_torch.ops.chunk_attention import chunk_attention_plain

    int8 = kind == "int8"
    q, kc, vc, ks, vs = _inputs(3, L, b, c, nh, nkv, hd, s, int8)
    q = torch.from_numpy(q).cuda().bfloat16()
    if int8:
        kc, vc = torch.from_numpy(kc).cuda(), torch.from_numpy(vc).cuda()
        ks, vs = torch.from_numpy(ks).cuda().bfloat16(), torch.from_numpy(vs).cuda().bfloat16()
    else:
        kc, vc = torch.from_numpy(kc).cuda().bfloat16(), torch.from_numpy(vc).cuda().bfloat16()
    lens = torch.tensor([[0, s - c, s // 2, 5][i % 4] for i in range(b)],
                        dtype=torch.int32, device="cuda")
    layer = L - 1
    got = tchunk(q, kc, vc, lens, layer=layer, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = chunk_attention_plain(q.float(), kc[layer], vc[layer], lens, hd**-0.5,
                                 None if ks is None else ks[layer],
                                 None if vs is None else vs[layer])
    torch.testing.assert_close(got.float(), want, atol=2e-2, rtol=2e-2)
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 1e-2, rel


def _card_chunk_case(kind, b, c, nh, nkv, hd, s, lengths, strided=False):
    from vlrlhf_torch.ops.chunk_attention import chunk_attention_plain

    int8 = kind == "int8"
    L = 2
    q, kc, vc, ks, vs = _inputs(c + hd + nh, L, b, c, nh, nkv, 2 * hd if strided else hd, s,
                                int8)
    q = torch.from_numpy(q[..., :hd].copy()).cuda().bfloat16()
    if int8:
        kc, vc = torch.from_numpy(kc).cuda(), torch.from_numpy(vc).cuda()
        ks, vs = torch.from_numpy(ks).cuda().bfloat16(), torch.from_numpy(vs).cuda().bfloat16()
    else:
        kc, vc = torch.from_numpy(kc).cuda().bfloat16(), torch.from_numpy(vc).cuda().bfloat16()
    kc, vc = kc[..., :hd], vc[..., :hd]  # strided: slots 2 * hd apart
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    layer = L - 1
    got = tchunk(q, kc, vc, lens, layer=layer, k_scale=ks, v_scale=vs)
    torch.cuda.synchronize()
    want = chunk_attention_plain(q.float(), kc[layer], vc[layer], lens, hd**-0.5,
                                 None if ks is None else ks[layer],
                                 None if vs is None else vs[layer])
    # rows whose chunk runs past S are chunk padding: compare the real queries
    for i, n in enumerate(lengths):
        real = min(c, s - n)
        torch.testing.assert_close(got[i, :real].float(), want[i, :real], atol=2e-2, rtol=2e-2)
    rel = float((got.float() - want).norm() / want.norm())
    assert rel <= 1e-2, rel


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("c", [1, 4, 16, 17, 64, 65])
def test_kernel_chunk_lengths_on_card(kind, c):
    """Chunk lengths across the short (g * C <= 16 rows, CUDA cores) / long
    (tensor cores) switch, 65 = two query tiles; row 1's causal window
    crosses the 32-slot tile edge (slots 30..30 + C)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    s = 256
    _card_chunk_case(kind, 4, c, 4, 4, 128, s, [0, 30, 97, s - c])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("c,nh,nkv,hd", [
    (4, 16, 4, 256),  # 16 rows at head_dim 256: tensor cores, 256-wide tile
    (2, 16, 2, 8),  # 16 rows of head_dim 8 on the CUDA cores
    (9, 16, 2, 64),  # 72 rows: two query tiles, g = 8
    (3, 8, 4, 72),  # head_dim 72: zero-padded to the 128-wide tile
    (40, 8, 4, 8),  # 80 rows of head_dim 8 (int8: 8-byte rows)
])
def test_kernel_gqa_and_head_dims_on_card(kind, c, nh, nkv, hd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _card_chunk_case(kind, 3, c, nh, nkv, hd, 128, [0, 31, 128 - c])


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("c,s,strided", [(4, 100, False), (64, 100, False), (4, 128, True),
                                         (20, 128, True)])
def test_kernel_plain_copy_shapes_on_card(kind, c, s, strided):
    """Caches a bulk copy cannot read (S % 8 != 0; slots 2 * hd apart) take
    the producer's plain-load path, on both chunk paths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _card_chunk_case(kind, 3, c, 4, 2, 64, s, [0, 33, s - c], strided)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_verify_over_anyres_length_caches_on_card(kind):
    """LLaVA-Next mistral's speculative verify: C = 4 under GQA 32 / 8, so
    g * C = 16 rows per KV head (the CUDA-core path's limit), 8 slots over
    caches of ~3,000 tokens in 3,200 slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    _card_chunk_case(kind, 8, 4, 32, 8, 128, 3200,
                     [2900, 2930, 2960, 2990, 3020, 3050, 3080, 3196])
