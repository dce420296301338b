"""GPTQ ingestion: vlrlhf_torch/utils/gptq.py vs vlrlhf_tpu/utils/gptq.py on
synthetic AutoGPTQ-layout tensors (pack_gptq_reference), bit-exact:
packed codes, bf16 scales and the zero-point gbias leaf, symmetric and
asymmetric, group sizes 64 and 128, an odd n_lo with a padded half; the
same refusals (act-order, group sizes that are not multiples of 64,
bits != 4); the converted leaf bridged into an int4 Linear reproduces the
textbook dequantization."""

import numpy as np
import pytest
import torch

from tests.test_gptq import _synth
from vlrlhf_torch.utils import gptq as tg


def _f32(a):
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("din,gsz", [(256, 128), (384, 64), (256, 64)])
def test_convert_matches_jax_bit_for_bit(sym, din, gsz):
    from vlrlhf_tpu.utils import gptq as jg

    q, z, s = _synth(din + gsz + sym, sym=sym, gsz=gsz, din=din, dout=200)
    tensors = jg.pack_gptq_reference(q, z, s, gsz)
    for got, want in zip(tg.pack_gptq_reference(q, z, s, gsz), tensors):
        np.testing.assert_array_equal(got, want)
    want = jg.convert_gptq_linear(*tensors)
    got = tg.convert_gptq_linear(*tensors)
    assert set(got) == set(want) and ("kernel_gbias" in got) == (not sym)
    np.testing.assert_array_equal(got["kernel_q4"], want["kernel_q4"])
    for key in set(got) - {"kernel_q4"}:
        np.testing.assert_array_equal(got[key], _f32(want[key]), err_msg=key)
    np.testing.assert_array_equal(tg.dequantize_gptq_reference(*tensors[:3]),
                                  jg.dequantize_gptq_reference(*tensors[:3]))


def test_round_bf16_is_round_to_nearest_even():
    import ml_dtypes

    rng = np.random.default_rng(0)
    a = np.concatenate([rng.standard_normal(4096).astype(np.float32) * 10.0 ** rng.integers(-6, 6, 4096),
                        np.float32([0.0, -0.0, 1.0 + 2**-8, 1.0 + 3 * 2**-8, 65504.0])])
    np.testing.assert_array_equal(tg.round_bf16(a), a.astype(ml_dtypes.bfloat16).astype(np.float32))


def test_refusals_match_jax():
    from vlrlhf_tpu.utils import gptq as jg

    q, z, s = _synth(5, gsz=128, din=256, dout=64)
    qw, qz, sc, gi = tg.pack_gptq_reference(q, z, s, 128)
    perm = np.random.default_rng(1).permutation(gi)
    cases = [
        ((qw, qz, sc, perm), {}, "act-order|desc_act"),
        ((qw, qz, sc, gi), {"bits": 8}, "bits=4"),
    ]
    q32, z32, s32 = _synth(6, gsz=32, din=256, dout=64)
    cases.append((tg.pack_gptq_reference(q32, z32, s32, 32), {}, "group_size=32"))
    for args, kw, match in cases:
        for fn in (tg.convert_gptq_linear, jg.convert_gptq_linear):
            with pytest.raises(ValueError, match=match):
                fn(*args, **kw)


def test_converted_leaf_in_a_linear_rebuilds_the_checkpoint():
    """Bridged into an int4 Linear, the dense weight (codes x bf16 scales +
    gbias, ops/quant.py dequantize_params) equals the textbook GPTQ
    dequantization up to the f16 -> bf16 scale rounding, within the bound
    test_gptq.py states (24 x 2^-7 of the group scale)."""
    from vlrlhf_torch.models.common import Linear
    from vlrlhf_torch.ops.quant import dequantize_params
    from vlrlhf_torch.utils.bridge import _linear

    q, z, s = _synth(7, gsz=128, din=256, dout=64)
    tensors = tg.pack_gptq_reference(q, z, s, 128)
    lin = Linear(256, 64, False, "cpu", torch.float32)
    _linear(lin, tg.convert_gptq_linear(*tensors))
    holder = torch.nn.ModuleDict({"lin": lin})
    assert dequantize_params(holder, torch.float32) == ["lin"]
    got = lin.weight.numpy().T
    want = tg.dequantize_gptq_reference(*tensors[:3])
    rows = np.arange(256) // 128
    assert (np.abs(got - want) <= s[rows] * 2.0**-7 * 24).all()
