"""int4 (W4A16): vlrlhf_torch/ops/int4.py vs vlrlhf_tpu/ops/int4.py on the
CPU, the same numpy inputs, the Pallas kernels in interpret mode.

Quantized codes and scales are bit-exact against quantize_kernel_int4_np and
the jitted quantize_kernel_int4; unpacking and dequantization exact. The
port holds the transposes of the JAX leaves ((out, half_p), (out, S)). The
plain matmuls match the Pallas kernels within 1e-5 relative with f32
operands, and within one bf16 rounding of the output with bf16 operands
(both round x and the weight to bf16 and accumulate in f32; only the
summation order differs). The Int4Matmul backward, the gbias term and an
int4 Linear with bias and LoRA adapter match jax.grad / `linear` at 1e-5.
A whole 128-wide int4 model matches at MODEL_TOL (see there) and greedy
decoding token for token.

The Hopper kernels (csrc/int4_matmul.cu) vs the plain versions run on the
card only (-m cuda; skip without CUDA): max abs error 2e-2 and relative
Frobenius error 1e-2 on bf16 operands, at edge shapes (odd n_lo with a
padded half, ragged T and out) and at both LLaVA-1.5-7B MLP shapes, and the
Function under torch.utils.checkpoint."""

import numpy as np
import pytest
import torch

from vlrlhf_torch.models.common import Ctx, Linear
from vlrlhf_torch.ops import int4 as t4

TOL = 1e-5
# whole-model logits: each int4 linear rounds its input to bf16, so an f32
# difference of ~1e-7 upstream (attention, norms) flips whole bf16 ulps of
# some activations; vlrlhf_tpu's own training forward and empty prefill
# differ by 2.2e-3 relative on the 128-wide int4 model below
MODEL_TOL = 5e-3
CARD_TOL, CARD_REL_TOL = 2e-2, 1e-2


@pytest.fixture(autouse=True)
def no_jax_mesh():
    """vlrlhf_tpu's references without a registered mesh: a file earlier in
    the same xdist worker may leave one registered (vlrlhf_tpu's make_mesh
    registers globally), and under a mesh with model > 1 vlrlhf_tpu's int4
    linears take their model-sharded path, whose rounding moved these
    files' references (tests/test_torch_qwen_xc2_quant.py read 7e-3 of the
    port where it reads 1.5e-3). The card machine has no JAX."""
    try:
        from vlrlhf_tpu.core import mesh as jmesh
    except ImportError:
        yield
        return
    prev = jmesh._GLOBAL_MESH
    jmesh._GLOBAL_MESH = None
    yield
    jmesh._GLOBAL_MESH = prev


QUANT_SHAPES = [(d_in, d_out) for d_in in (128, 256, 384, 640) for d_out in (40, 200)]


def _f32(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _weight(seed, d_in, d_out, scale=0.05):
    """A JAX-layout (in, out) f32 kernel with a few all-zero groups."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal((d_in, d_out)) * scale).astype(np.float32)
    k[:64, 0] = 0.0  # an all-zero group takes scale 1
    return k


def _ported_weight(k):
    """vlrlhf_tpu's quantized leaves and the port's tensors holding them."""
    from vlrlhf_tpu.ops.int4 import quantize_kernel_int4_np

    packed, scale = quantize_kernel_int4_np(k)
    return packed, scale, torch.from_numpy(packed.T.copy()), \
        torch.from_numpy(_f32(scale).T.copy()).to(torch.bfloat16)


def _assert_rel(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: relative error {err:.3e} > {tol}"


@pytest.mark.parametrize("d_in,d_out", QUANT_SHAPES)
def test_quantize_unpack_dequantize_match_jax(d_in, d_out):
    import jax.numpy as jnp

    from vlrlhf_tpu.ops.int4 import (
        dequantize_kernel_int4, quantize_kernel_int4, quantize_kernel_int4_np, unpack_int4,
    )

    k = _weight(d_in + d_out, d_in, d_out)
    packed, scale = t4.quantize_int4(torch.from_numpy(k.T.copy()))
    np_packed, np_scale = quantize_kernel_int4_np(k)
    assert packed.dtype == torch.int8 and scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(packed.numpy(), np_packed.T)  # bit-exact
    np.testing.assert_array_equal(scale.float().numpy(), _f32(np_scale).T)
    j_packed, j_scale = quantize_kernel_int4(jnp.asarray(k))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_packed).T)
    np.testing.assert_array_equal(scale.float().numpy(), _f32(j_scale).T)
    np.testing.assert_array_equal(t4.unpack_int4(packed).numpy(),
                                  np.asarray(unpack_int4(j_packed)).T)
    for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            t4.dequantize_int4(packed, scale, tdt).float().numpy(),
            _f32(dequantize_kernel_int4(j_packed, j_scale, jdt)).T)
    assert t4.din_from_scale_cols(scale.shape[1]) == d_in


MATMUL_CASES = [  # T, in, out: ragged out, odd n_lo with a padded half (384, 640)
    (1, 128, 40), (5, 384, 200), (300, 384, 200), (5, 640, 40), (300, 256, 200),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d_in,d_out", MATMUL_CASES)
def test_plain_matmuls_match_pallas(t, d_in, d_out, dtype):
    import jax.numpy as jnp

    from vlrlhf_tpu.ops.int4 import int4_matmul, int4_matmul_t

    rng = np.random.default_rng(t * 7 + d_in)
    packed, scale, tp, ts = _ported_weight(_weight(t, d_in, d_out))
    x = (rng.standard_normal((t, d_in)) * 0.5).astype(np.float32)
    dy = rng.standard_normal((t, d_out)).astype(np.float32)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    jx, jdy = jnp.asarray(x, jdt), jnp.asarray(dy, jdt)
    tx, tdy = torch.from_numpy(_f32(jx)).to(tdt), torch.from_numpy(_f32(jdy)).to(tdt)
    want_y = _f32(int4_matmul(jx, jnp.asarray(packed), jnp.asarray(scale)))
    want_dx = _f32(int4_matmul_t(jdy, jnp.asarray(packed), jnp.asarray(scale)))
    got_y, got_dx = t4.int4_matmul(tx, tp, ts), t4.int4_matmul_t(tdy, tp, ts)
    assert got_y.dtype == tdt and got_dx.dtype == tdt
    assert t4.int4_matmul.launches == 0 and t4.int4_matmul_t.launches == 0  # plain path
    if dtype == "float32":
        _assert_rel(got_y.numpy(), want_y, TOL, "y")
        _assert_rel(got_dx.numpy(), want_dx, TOL, "dx")
    else:  # one bf16 rounding of an f32 sum taken in another order
        for got, want in ((got_y, want_y), (got_dx, want_dx)):
            np.testing.assert_allclose(got.float().numpy(), want, rtol=2**-7,
                                       atol=TOL * np.abs(want).max())


def test_function_backward_matches_jax_grad():
    import jax
    import jax.numpy as jnp

    from vlrlhf_tpu.ops.int4 import int4_apply

    rng = np.random.default_rng(11)
    k = _weight(12, 384, 200)
    packed, scale, tp, ts = _ported_weight(k)
    x = (rng.standard_normal((2, 3, 384)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((2, 3, 200)).astype(np.float32)
    p4 = {"kernel_q4": jnp.asarray(packed), "kernel_scale": jnp.asarray(scale)}
    want_y = _f32(int4_apply(p4, jnp.asarray(x)))
    want_dx = _f32(jax.grad(lambda v: jnp.sum(int4_apply(p4, v) * cot))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = t4.int4_apply(tx, tp, ts)
    (y * torch.from_numpy(cot)).sum().backward()
    _assert_rel(y.detach().numpy(), want_y, TOL, "y")
    _assert_rel(tx.grad.numpy(), want_dx, TOL, "dx")
    # dx only when asked for it
    ctx_y = t4.Int4Matmul.apply(torch.from_numpy(x[0]), tp, ts)
    assert not ctx_y.requires_grad


def test_function_under_checkpoint_recomputes_the_same():
    from torch.utils.checkpoint import checkpoint

    rng = np.random.default_rng(13)
    _, _, tp, ts = _ported_weight(_weight(14, 256, 40))
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    grads = []
    for remat in (False, True):
        xi = x.clone().requires_grad_()
        f = (lambda v: t4.int4_apply(torch.tanh(v), tp, ts))
        y = checkpoint(f, xi, use_reentrant=False) if remat else f(xi)
        y.square().sum().backward()
        grads.append(xi.grad)
    torch.testing.assert_close(grads[1], grads[0], atol=0, rtol=0)


def test_gbias_linear_matches_int4_apply():
    """A Linear bridged from an asymmetric GPTQ leaf (with kernel_gbias)
    against vlrlhf_tpu's int4_apply: output and dx at 1e-5."""
    import jax
    import jax.numpy as jnp

    from tests.test_gptq import _synth
    from vlrlhf_tpu.ops.int4 import int4_apply
    from vlrlhf_tpu.utils.gptq import convert_gptq_linear, pack_gptq_reference
    from vlrlhf_torch.utils.bridge import _linear

    q, z, s = _synth(3, din=384, dout=200, gsz=128)
    p = convert_gptq_linear(*pack_gptq_reference(q, z, s, 128))
    assert "kernel_gbias" in p
    lin = Linear(384, 200, False, "cpu", torch.float32)
    _linear(lin, p)
    assert lin.weight is None and lin.weight_gbias.shape == (200, 384 // 64)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((5, 384)) * 0.5).astype(np.float32)
    cot = rng.standard_normal((5, 200)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    want = _f32(int4_apply(jp, jnp.asarray(x)))
    want_dx = _f32(jax.grad(lambda v: jnp.sum(int4_apply(jp, v) * cot))(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    got = lin(tx)
    (got * torch.from_numpy(cot)).sum().backward()
    _assert_rel(got.detach().numpy(), want, TOL, "y")
    _assert_rel(tx.grad.numpy(), want_dx, TOL, "dx")


@pytest.mark.parametrize("bias", [False, True])
def test_int4_linear_with_bias_and_lora_matches_jax_linear(bias):
    import jax.numpy as jnp

    from vlrlhf_tpu.models.common import Ctx as JCtx
    from vlrlhf_tpu.models.common import linear
    from vlrlhf_tpu.ops.int4 import quantize_linear_int4

    rng = np.random.default_rng(5)
    d_in, d_out = 128, 64
    k = _weight(6, d_in, d_out, scale=0.1)
    p = {"kernel": jnp.asarray(k)}
    if bias:
        p["bias"] = jnp.asarray(rng.standard_normal((d_out,)).astype(np.float32) * 0.1)
    p4 = {key: np.asarray(v) for key, v in quantize_linear_int4(p).items()}
    a = (rng.standard_normal((d_in, 4)) * 0.1).astype(np.float32)
    b = (rng.standard_normal((4, d_out)) * 0.1).astype(np.float32)
    x = (rng.standard_normal((2, 5, d_in)) * 0.5).astype(np.float32)
    want = _f32(linear({key: jnp.asarray(v) for key, v in p4.items()}, jnp.asarray(x),
                       JCtx(adapters={"a": jnp.asarray(a), "b": jnp.asarray(b)},
                            lora_scale=0.5)))
    lin = Linear(d_in, d_out, bias, "cpu", torch.float32)
    from vlrlhf_torch.utils.bridge import _linear

    _linear(lin, p4)
    lin.lora_a, lin.lora_b = torch.nn.Parameter(torch.from_numpy(a)), \
        torch.nn.Parameter(torch.from_numpy(b))
    got = lin(torch.from_numpy(x), Ctx(adapters=True, lora_scale=0.5))
    _assert_rel(got.detach().numpy(), want, TOL)
    # the port's own quantize_(bits=4) holds the same bytes
    own = Linear(d_in, d_out, bias, "cpu", torch.float32)
    with torch.no_grad():
        own.weight.copy_(torch.from_numpy(k.T.copy()))
    own.quantize_(bits=4)
    torch.testing.assert_close(own.weight_q4, lin.weight_q4, atol=0, rtol=0)
    torch.testing.assert_close(own.weight_scale4, lin.weight_scale4, atol=0, rtol=0)
    with pytest.raises(ValueError, match="divisible by 128"):
        Linear(96, 8, False, "cpu", torch.float32).quantize_(bits=4)


def int4_ported(bits=4, seed=20, patterns=None):
    """(jax cfg, params, port model) of the 128-wide tiny LLaVA
    (tests/test_int4.py `_vlm128`: hidden 128, intermediate 256, so every
    LM linear and lm_head takes int4), its linears quantized by vlrlhf_tpu
    (bits 8 or 4; 0 keeps them f32) and bridged into the port."""
    import jax

    from tests.test_int4 import _vlm128
    from vlrlhf_tpu.models.vlm import init_vlm_params
    from vlrlhf_tpu.ops.quant import DEFAULT_QUANT_PATTERNS, quantize_params
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.bridge import load_vlm_params, vlm_config_from

    jcfg = _vlm128()
    params = init_vlm_params(jcfg, jax.random.PRNGKey(seed))
    if bits:
        params = quantize_params(params, patterns or DEFAULT_QUANT_PATTERNS, bits=bits)
    params = jax.device_get(params)
    model = VLM(vlm_config_from(jcfg), device="cpu")
    load_vlm_params(model, params)
    return jcfg, params, model


def test_int4_vlm_forward_and_greedy_decode_match_jax():
    """The 128-wide model with int4 LM linears and lm_head bridged from
    vlrlhf_tpu's quantized tree: empty-prefill logits at the valid positions
    within MODEL_TOL relative, greedy tokens of the static engine
    identical."""
    import jax.numpy as jnp

    from tests.test_torch_models import prompt_batch
    from vlrlhf_tpu.generate.engine import GenerateConfig as JGenerateConfig
    from vlrlhf_tpu.generate.engine import Generator as JGenerator
    from vlrlhf_tpu.models.vlm import vlm_forward
    from vlrlhf_torch.generate.engine import GenerateConfig, Generator

    jcfg, params, model = int4_ported()
    lm = model.lm
    assert all(getattr(layer, n).weight_q4 is not None for layer in lm.layers
               for n in ("wq", "wk", "wv", "wo", "gate", "up", "down"))
    assert lm.lm_head.weight_q4 is not None and model.projector.fc2.weight is not None
    ids, pad, lens, px, pos = prompt_batch(seed=3)
    s = ids.shape[1]
    want, _ = vlm_forward(
        jcfg, params, input_ids=jnp.asarray(ids), pixel_values=jnp.asarray(px),
        image_positions=jnp.asarray(pos), pad_mask=jnp.asarray(pad),
        positions=jnp.broadcast_to(jnp.arange(s)[None], ids.shape), cache_len=64,
    )
    with torch.no_grad():
        hidden, _ = model(torch.from_numpy(ids), torch.from_numpy(px), torch.from_numpy(pos),
                          torch.from_numpy(pad), cache_len=64)
        got = model.head(hidden).numpy()
    for i, n in enumerate(lens):
        _assert_rel(got[i, :n], _f32(want)[i, :n], MODEL_TOL, f"row {i} logits")
    batch = {"input_ids": ids, "pad_mask": pad, "prompt_lens": lens,
             "pixel_values": px, "image_positions": pos}
    want_tok = np.asarray(JGenerator(jcfg, JGenerateConfig(max_new_tokens=6, pad_token_id=-1))(
        params, batch))
    got_tok = Generator(model, GenerateConfig(max_new_tokens=6, pad_token_id=-1))(batch)
    np.testing.assert_array_equal(got_tok.numpy(), want_tok)
    assert t4.int4_matmul.launches == 0


@pytest.mark.parametrize("bits", [8, 4])
def test_dequantize_params_matches_jax_and_init_refuses_quantized(bits):
    """ops/quant.py dequantize_params restores vlrlhf_tpu's dequantized
    kernels (transposed) exactly; init_random_ refuses a quantized model."""
    import jax
    import jax.numpy as jnp

    from vlrlhf_tpu.ops.quant import dequantize_params as jdequantize
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.ops.quant import dequantize_params

    _, params, model = int4_ported(bits=bits, seed=23)
    with pytest.raises(ValueError, match="before quantization"):
        init_random_(model, torch.Generator().manual_seed(0))
    want = jax.device_get(jdequantize(params, jnp.bfloat16))
    paths = dequantize_params(model)
    assert len(paths) == 7 * 2 + 1 and model.lm.layers[1].down.weight_q4 is None
    for i, layer in enumerate(model.lm.layers):
        for name, group in (("wk", "attn"), ("down", "mlp")):
            np.testing.assert_array_equal(
                getattr(layer, name).weight.float().numpy(),
                _f32(want["lm"]["layers_scanned"][group][name]["kernel"][i]).T)
    np.testing.assert_array_equal(model.lm.lm_head.weight.float().numpy(),
                                  _f32(want["lm"]["lm_head"]["kernel"]).T)


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions

CARD_CASES = [  # T, in, out
    (5, 384, 200),  # odd n_lo, padded half, ragged T and out
    (1, 128, 40),
    (37, 640, 200),
    (300, 256, 136),
    (100, 384, 200),  # the wgmma forward (T > 64) with an odd n_lo and ragged T, out
    (8, 4096, 11008),  # LLaVA-1.5-7B gate/up at decode
    (8, 11008, 4096),  # down at decode (n_lo = 43, no padding)
    (32, 4096, 12288),  # fused wqkv at a verify chunk
    (2048, 4096, 11008),  # the QLoRA step
    (2048, 11008, 4096),
    (65, 384, 200),  # the first T on the wgmma path, odd n_lo, ragged out
    (129, 640, 136),  # T > 128, odd n_lo, ragged out
    (32, 11008, 4096),  # down at a verify chunk: the cluster split of the contraction
    (16, 4224, 40),  # a cluster of 8 whose last CTA has no block
    (129, 384, 200),  # dx: ragged row tiles, a ragged last chunk of `out` (200 = 3 x 64 + 8)
    (300, 384, 200),
    (2048, 4096, 4096),  # the QLoRA step's attention projections wq, wk, wv, wo
]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the int4 kernels have no CPU mode")
    return torch.device("cuda")


def _card_operands(t, d_in, d_out, seed=0):
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((d_out, d_in), device=dev, generator=gen) * d_in**-0.5
    packed, scale = t4.quantize_int4(w)
    x = torch.randn((t, d_in), device=dev, generator=gen).to(torch.bfloat16)
    dy = torch.randn((t, d_out), device=dev, generator=gen).to(torch.bfloat16)
    return packed, scale, x, dy


def _assert_card_close(got, ref, what):
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    rel = float((got - ref).norm() / ref.norm())
    assert np.isfinite(err) and err <= CARD_TOL * max(1.0, float(ref.abs().max())) and \
        rel <= CARD_REL_TOL, f"{what}: max abs err {err:.3e}, rel err {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("t,d_in,d_out", CARD_CASES)
def test_kernels_match_plain_on_card(t, d_in, d_out):
    packed, scale, x, dy = _card_operands(t, d_in, d_out)
    before = (t4.int4_matmul.launches, t4.int4_matmul_t.launches)
    y = t4.int4_matmul(x, packed, scale)
    dx = t4.int4_matmul_t(dy, packed, scale)
    torch.cuda.synchronize()
    assert (t4.int4_matmul.launches, t4.int4_matmul_t.launches) == (before[0] + 1, before[1] + 1)
    assert y.shape == (t, d_out) and dx.shape == (t, d_in) and y.dtype == torch.bfloat16
    _assert_card_close(y, t4.int4_matmul_plain(x.float(), packed, scale), f"y {t}x{d_in}x{d_out}")
    _assert_card_close(dx, t4.int4_matmul_t_plain(dy.float(), packed, scale),
                       f"dx {t}x{d_in}x{d_out}")


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 32, 200])
def test_weights_bit_exact_on_card(t):
    """x (dy) holds rows of the identity, so y (dx) is a set of the weight's
    columns (rows): the kernels' weights must equal bf16(q * s) bit for bit,
    both halves of the packing (forward at T = 8 and 32: the cluster kernel;
    T = 200: the wgmma one)."""
    packed, scale, _, _ = _card_operands(t, 640, 136, seed=2)
    w = t4.dequantize_int4(packed, scale)  # (out, in)
    idx = torch.arange(t, device="cuda") * (640 // t)
    rows = torch.arange(t, device="cuda") % 136
    before = (t4.int4_matmul.launches, t4.int4_matmul_t.launches)
    y = t4.int4_matmul(torch.eye(640, device="cuda", dtype=torch.bfloat16)[idx], packed, scale)
    dx = t4.int4_matmul_t(torch.eye(136, device="cuda", dtype=torch.bfloat16)[rows], packed, scale)
    torch.cuda.synchronize()
    assert (t4.int4_matmul.launches, t4.int4_matmul_t.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(y, w[:, idx].T) and torch.equal(dx, w[rows])


@pytest.mark.cuda
def test_function_under_checkpoint_on_card():
    from torch.utils.checkpoint import checkpoint

    packed, scale, x, _ = _card_operands(64, 384, 200, seed=1)
    grads = []
    n_t = t4.int4_matmul_t.launches
    for remat in (False, True):
        xi = x.float().clone().requires_grad_()
        f = (lambda v: t4.int4_apply(torch.tanh(v).to(torch.bfloat16), packed, scale))
        y = checkpoint(f, xi, use_reentrant=False) if remat else f(xi)
        y.float().square().sum().backward()
        grads.append(xi.grad)
    torch.cuda.synchronize()
    assert t4.int4_matmul_t.launches == n_t + 2
    torch.testing.assert_close(grads[1], grads[0], atol=0, rtol=0)


@pytest.mark.cuda
def test_cuda_refuses_what_the_kernel_does_not_take():
    packed, scale, x, dy = _card_operands(4, 128, 40)
    with pytest.raises(ValueError, match="in-width"):
        t4.int4_matmul(x[:, :64], packed, scale)
    with pytest.raises(ValueError, match="out % 8"):
        t4.int4_matmul_t(dy[:, :36], packed[:36], scale[:36])

