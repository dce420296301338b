"""The DPO slice's host side vs vlrlhf_tpu on the same inputs, exactly:
tokenize_row_dpo (TRL row semantics, truncation included), the DPO
collator (image expansion with labels, padding, reference logps, DDPO diff
masks), the FLOPs model, the batch iterator's order, and the metrics
logger's JSONL."""

import json

import numpy as np
import pytest

from vlrlhf_tpu.data import collators as JC
from vlrlhf_tpu.data import processor as JP
from vlrlhf_tpu.data.chat_templates import TEMPLATES as J_TEMPLATES
from vlrlhf_tpu.data.tokenizer import ToyTokenizer as JToy
from vlrlhf_torch.data import collators as TC
from vlrlhf_torch.data import processor as TP
from vlrlhf_torch.data.chat_templates import TEMPLATES as T_TEMPLATES
from vlrlhf_torch.data.tokenizer import ToyTokenizer as TToy

ROWS = [
    {"prompt": "what is in the picture , exactly ?", "img_path": "a.png",
     "chosen": "a red cat on a mat", "rejected": "a red dog on a mat today"},
    {"prompt": "describe item 3 w1 w2 w3", "img_path": None,
     "chosen": "a good answer 3 with detail", "rejected": "a bad answer 3"},
    {"prompt": " ".join(f"long{i}" for i in range(40)), "img_path": "b.png",
     "chosen": " ".join(f"c{i}" for i in range(30)), "rejected": "short"},
]


def _processors(max_length=1024, max_prompt_length=512, n_img=5):
    kw = dict(num_image_tokens=n_img, image_token_id=3, max_length=max_length,
              max_prompt_length=max_prompt_length)
    return (JP.VLProcessor(JToy(), J_TEMPLATES["llava"], JP.ProcessorConfig(**kw)),
            TP.VLProcessor(TToy(), T_TEMPLATES["llava"], TP.ProcessorConfig(**kw)))


def _loader(path, size, mode):
    return np.full((size, size, 3), len(path), np.uint8)


@pytest.mark.parametrize("max_length,max_prompt_length", [(1024, 512), (40, 20)])
def test_tokenize_row_dpo_matches(max_length, max_prompt_length):
    jp, tp = _processors(max_length, max_prompt_length)
    for row in ROWS:
        want, got = jp.tokenize_row_dpo(row), tp.tokenize_row_dpo(row)
        assert set(got) == set(want)
        for k in want:
            assert got[k] == want[k], k


@pytest.mark.parametrize("diff_mask,pad_to", [(False, 0), (True, 96)])
def test_dpo_collator_matches(diff_mask, pad_to):
    jp, tp = _processors()
    jrows = [jp.tokenize_row_dpo(r) for r in ROWS]
    trows = [tp.tokenize_row_dpo(r) for r in ROWS]
    for i, (jr, tr) in enumerate(zip(jrows, trows)):  # precomputed reference logps ride along
        jr.update(ref_chosen_logp=-1.5 * i, ref_rejected_logp=-2.5 * i)
        tr.update(ref_chosen_logp=-1.5 * i, ref_rejected_logp=-2.5 * i)
    kw = dict(pad_token_id=0, bucket_multiple=32, image_size=8, compute_diff_mask=diff_mask,
              pad_to=pad_to)
    want = JC.DPOCollator(jp, JC.CollatorConfig(**kw), _loader)(jrows)
    got = TC.DPOCollator(tp, TC.CollatorConfig(**kw), _loader)(trows)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
        assert got[k].dtype == np.asarray(want[k]).dtype, k
    assert got["input_ids"].shape[0] == 6 and (not pad_to or got["input_ids"].shape[1] == pad_to)


def test_expand_image_tokens_with_labels_matches():
    jp, tp = _processors(n_img=4)
    ids, labels = [1, 7, 3, 9, 3, 11], [-100, -100, -100, 9, -100, 11]
    for got, want in zip(tp.expand_image_tokens(ids, labels), jp.expand_image_tokens(ids, labels)):
        np.testing.assert_array_equal(got, want)
    got = tp.expand_image_tokens(ids)
    assert got[1] is None and len(got[2]) == 8


def test_flops_model_matches():
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.train import flops as JFl
    from vlrlhf_torch.models.config import FAMILIES as TF
    from vlrlhf_torch.train import flops as TFl

    jcfg, tcfg = JF["llava"].make_config(), TF["llava"].make_config()
    for ref_forward in (True, False):
        assert TFl.dpo_flops_per_token(tcfg, 1024, ref_forward) == \
            JFl.dpo_flops_per_token(jcfg, 1024, ref_forward)
    assert TFl.vision_flops_per_image(tcfg.vision) == JFl.vision_flops_per_image(jcfg.vision)


def test_batch_iterator_order_matches():
    from vlrlhf_tpu.train.loop import batch_iterator as jit_
    from vlrlhf_torch.train.loop import batch_iterator as tit

    rows = [{"i": i} for i in range(10)]
    ident = lambda r: r["i"]  # noqa: E731
    want = list(jit_(rows, ident, list, 3, 2.0, seed=5))
    got = list(tit(rows, ident, list, 3, 2.0, seed=5))
    assert got == want
    assert len(got) == 7  # 3 full batches an epoch, until 2 epochs are covered


def test_metrics_logger_jsonl(tmp_path):
    from vlrlhf_torch.train.metrics import H100_BF16_DENSE_FLOPS, MetricsLogger

    log = MetricsLogger(str(tmp_path), "dpo", flops_per_token=1e9, flops_per_image=1e10)
    log.log(1, {"loss": 0.69, "perf/interval_tokens": 100, "perf/interval_images": 1})
    out = log.log(2, {"loss": 0.5, "perf/interval_tokens": 100, "perf/interval_images": 1})
    log.close()
    lines = [json.loads(x) for x in (tmp_path / "dpo_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in lines] == [1, 2]
    assert "perf/mfu" not in lines[0] and "perf/interval_tokens" not in lines[0]
    dt = 100 / out["perf/tokens_per_sec"]
    assert out["perf/mfu"] == pytest.approx((1e9 * 100 + 1e10) / dt / H100_BF16_DENSE_FLOPS)
    assert H100_BF16_DENSE_FLOPS == 989.4e12
