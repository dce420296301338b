"""vlrlhf_torch's losses vs vlrlhf_tpu/train/losses.py on the same numpy
inputs, f32 on CPU, tolerance 1e-5: batch_logps (sum and mean, DDPO mask,
out-of-vocab labels), chunked_logps (value and gradient against the dense
path) and all five dpo_loss types with label smoothing and
reference_free."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlrlhf_tpu.train import losses as J
from vlrlhf_torch.train import losses as T

TOL = 1e-5


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=tol, rtol=tol)


def _logits_labels(seed, b=3, s=20, v=50):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, s, v)).astype(np.float32) * 3
    labels = rng.integers(0, v, (b, s)).astype(np.int64)
    labels[:, :7] = T.LABEL_PAD
    labels[1, 15:] = T.LABEL_PAD
    labels[-1, 9] = v + 5  # out of vocabulary: clamped, never NaN
    mask = rng.integers(0, 2, (b, s)).astype(bool)
    return logits, labels, mask


@pytest.mark.parametrize("average,with_mask", [(False, False), (True, False), (False, True),
                                               (True, True)])
def test_batch_logps(average, with_mask):
    logits, labels, mask = _logits_labels(0)
    lm = mask if with_mask else None
    want = J.batch_logps(jnp.asarray(logits), jnp.asarray(labels), average,
                         None if lm is None else jnp.asarray(lm))
    got = T.batch_logps(torch.from_numpy(logits), torch.from_numpy(labels), average,
                        None if lm is None else torch.from_numpy(lm))
    _close(got, want)


@pytest.mark.parametrize("chunk,average,with_mask", [(5, False, False), (7, True, True),
                                                     (64, False, True)])
def test_chunked_logps_value_and_grad_match_dense(chunk, average, with_mask):
    """Chunked == dense in value and in the gradient wrt hidden and head."""
    rng = np.random.default_rng(1)
    b, s, h, v = 2, 20, 8, 30
    hidden = rng.standard_normal((b, s, h)).astype(np.float32)
    w = rng.standard_normal((v, h)).astype(np.float32)
    _, labels, mask = _logits_labels(2, b, s, v)
    lm = torch.from_numpy(mask) if with_mask else None
    lab = torch.from_numpy(labels)

    def run(chunked):
        ht = torch.tensor(hidden, requires_grad=True)
        wt = torch.tensor(w, requires_grad=True)
        head = lambda x: x @ wt.T  # noqa: E731
        if chunked:
            lp, ls = T.chunked_logps(ht, lab, head, average_log_prob=average, loss_mask=lm,
                                     chunk=chunk)
        else:
            logits = head(ht)
            lp = T.batch_logps(logits, lab, average, lm)
            ls = logits.sum(dim=(1, 2))
        (lp.sum() + 0.01 * ls.sum()).backward()
        return lp, ls, ht.grad, wt.grad

    for got, want in zip(run(True), run(False)):
        _close(got, want.detach().numpy())
    # and against the JAX package's chunked version
    jlp, jls = J.chunked_logps(jnp.asarray(hidden), jnp.asarray(labels),
                               lambda x: x @ jnp.asarray(w).T, average_log_prob=average,
                               loss_mask=None if lm is None else jnp.asarray(mask),
                               chunk=chunk)
    lp, ls, _, _ = run(True)
    _close(lp, jlp)
    _close(ls, jls, 1e-4)  # a sum of 600 logits of size ~3


@pytest.mark.parametrize("loss_type", ["sigmoid", "ddpo", "hinge", "ipo", "kto_pair"])
@pytest.mark.parametrize("label_smoothing,reference_free", [(0.0, False), (0.1, False),
                                                            (0.0, True)])
def test_dpo_loss_family(loss_type, label_smoothing, reference_free):
    rng = np.random.default_rng(3)
    pc, pr, rc, rr = (rng.standard_normal(4).astype(np.float32) * 5 - 20 for _ in range(4))
    kw = dict(beta=0.1, label_smoothing=label_smoothing, loss_type=loss_type,
              reference_free=reference_free)
    want = J.dpo_loss(*(jnp.asarray(x) for x in (pc, pr, rc, rr)), **kw)
    got = T.dpo_loss(*(torch.from_numpy(x) for x in (pc, pr, rc, rr)), **kw)
    for g, w in zip(got, want):
        _close(g, w)


def test_dpo_loss_unknown_type_raises():
    z = torch.zeros(2)
    with pytest.raises(ValueError, match="Unknown loss type"):
        T.dpo_loss(z, z, z, z, loss_type="nope")
