"""Generation at one rank's heads under --mesh_model 2, in one process on
the CPU (the counterpart of tests/test_tp_kernels.py, which holds
vlrlhf_tpu's shard_map re-entry of its decode kernel to the whole call):
  - decode attention (kernel 4's plain version through its wrapper) and
    chunk attention (kernel 5's) on each rank's block of heads (its query
    heads, its KV heads of the stacked cache, its current k / v and int8
    scales), concatenated over the two ranks, equal the whole-head call
    within 1e-6: bf16 and int8 caches, g = 1 (8 / 8 heads) and g = 4 (16 /
    4), rows at lengths 0, 1, mid and Sc - C;
  - after core/partitioning.py apply_tensor_parallel_, the LM's caches
    are sized by the layers' local heads: `cache_cfg`, empty_cache, the
    prefill's cache and decode_step's pending k / v hold each rank's KV
    heads (the collectives stand in as the identity here: the shapes are
    what this holds; tests/test_torch_dist_ppo.py holds the values on two
    gloo ranks)."""

import types

import pytest
import torch

from vlrlhf_torch.ops.chunk_attention import chunk_attention
from vlrlhf_torch.ops.decode_attention import decode_attention
from vlrlhf_torch.ops.quant import quantize_kv

TOL = 1e-6
L, B, SC, HD = 2, 4, 64, 16


def _cache(nkv: int, kind: str, g: torch.Generator):
    k = torch.randn((L, B, nkv, SC, HD), generator=g).to(torch.bfloat16)
    v = torch.randn((L, B, nkv, SC, HD), generator=g).to(torch.bfloat16)
    if kind == "bf16":
        return k, v, None, None
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    return kq, vq, ks, vs


def _half(t, dim: int, rank: int):
    return None if t is None else t.chunk(2, dim=dim)[rank].contiguous()


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (16, 4)])
def test_decode_at_a_ranks_heads_equals_the_whole_call(kind, nh, nkv):
    g = torch.Generator().manual_seed(nh + nkv)
    k, v, ks, vs = _cache(nkv, kind, g)
    q = torch.randn((B, nh, HD), generator=g).to(torch.bfloat16)
    kc, vc = (torch.randn((B, nkv, HD), generator=g).to(torch.bfloat16) for _ in range(2))
    lengths = torch.tensor([0, 1, 37, SC - 1], dtype=torch.int32)
    whole = decode_attention(q, k, v, kc, vc, lengths, layer=1, k_scale=ks, v_scale=vs)
    parts = [decode_attention(_half(q, 1, r), _half(k, 2, r), _half(v, 2, r), _half(kc, 1, r),
                              _half(vc, 1, r), lengths, layer=1, k_scale=_half(ks, 2, r),
                              v_scale=_half(vs, 2, r)) for r in range(2)]
    torch.testing.assert_close(torch.cat(parts, dim=1), whole, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
@pytest.mark.parametrize("nh,nkv", [(8, 8), (16, 4)])
def test_chunk_at_a_ranks_heads_equals_the_whole_call(kind, nh, nkv):
    c = 4
    g = torch.Generator().manual_seed(3 * nh + nkv)
    k, v, ks, vs = _cache(nkv, kind, g)
    q = torch.randn((B, c, nh, HD), generator=g).to(torch.bfloat16)
    lengths = torch.tensor([0, 1, 30, SC - c], dtype=torch.int32)
    whole = chunk_attention(q, k, v, lengths, layer=0, k_scale=ks, v_scale=vs)
    parts = [chunk_attention(_half(q, 2, r), _half(k, 2, r), _half(v, 2, r), lengths, layer=0,
                             k_scale=_half(ks, 2, r), v_scale=_half(vs, 2, r)) for r in range(2)]
    torch.testing.assert_close(torch.cat(parts, dim=2), whole, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("rank", [0, 1])
def test_caches_and_decode_step_hold_a_ranks_heads(rank, monkeypatch):
    import dataclasses

    from vlrlhf_torch.core import dist
    from vlrlhf_torch.core.partitioning import apply_tensor_parallel_
    from vlrlhf_torch.generate.engine import GenerateConfig, decode_step, eos_tensor
    from vlrlhf_torch.models import common
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.lm.llama import empty_cache, empty_pending
    from vlrlhf_torch.models.vlm import VLM

    cfg = scale_down(FAMILIES["llava_next_mistral"].make_config(), dtype=torch.float32)
    cfg = dataclasses.replace(cfg, lm=dataclasses.replace(cfg.lm, num_heads=8, num_kv_heads=4,
                                                          head_dim=4))
    model = init_random_(VLM(cfg, device="cpu"), torch.Generator().manual_seed(rank))
    for mod in (dist, common):  # one process: the group's collectives as the identity
        monkeypatch.setattr(mod, "copy_to_tp", lambda x, group: x)
        monkeypatch.setattr(mod, "reduce_from_tp", lambda y, group: y)
    apply_tensor_parallel_(model, types.SimpleNamespace(model=2, tp_group=None, tp_rank=rank))
    lm = model.lm
    assert (lm.cfg.num_heads, lm.cfg.num_kv_heads) == (8, 4)  # the LM's own stays global
    assert (lm.cache_cfg.num_heads, lm.cache_cfg.num_kv_heads) == (4, 2)
    assert empty_cache(lm.cache_cfg, 3, 32, "int8", "cpu")["k_scale"].shape == (
        cfg.lm.num_layers, 3, 2, 32)
    ids = torch.randint(4, 200, (2, 12), generator=torch.Generator().manual_seed(9))
    pad = torch.ones((2, 12), dtype=torch.bool)
    with torch.no_grad():
        _, cache = lm(lm.embed(ids), pad, cache_len=32)
        assert cache["k"].shape == (cfg.lm.num_layers, 2, 2, 32, 4)
        gcfg = GenerateConfig(max_new_tokens=3, pad_token_id=0)
        pending = empty_pending(lm.cache_cfg, 2, 32, "cpu")
        out = torch.zeros((2, 3), dtype=torch.int32)
        lengths = torch.full((2,), 12, dtype=torch.int32)
        pending, lengths, nxt, _ = decode_step(
            model, gcfg, eos_tensor(gcfg, "cpu"), cache, pending, lengths,
            ids[:, -1].to(torch.int32), torch.zeros(2, dtype=torch.bool), out, 1, None)
    assert pending["k"].shape == (cfg.lm.num_layers, 2, 2, 4) and nxt.shape == (2,)
    assert lengths.tolist() == [13, 13]
