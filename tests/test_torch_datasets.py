"""The dataset builders of vlrlhf_torch/data/datasets.py against
vlrlhf_tpu's on JSON and JSONL files written here: VLFeedback pairing
(ties skipped, unparseable ratings skipped, score_margin -1 keeping the
largest-gap pairs against 0.5 keeping every pair at or over the margin,
relative image paths joined to image_root), vlquery_json, RLHF-V (its
`text` as a JSON string or an object) and plain_dpo (rows with and without
an image), through DATASET_MAP; a hub name or a directory is refused by
name. The RM collator equals vlrlhf_tpu's on the same rows."""

import json

import numpy as np
import pytest

from vlrlhf_tpu.data import datasets as J
from vlrlhf_torch.data import datasets as T


def _anno(*ratings):
    return {f"judge{i}": {"Rating": r} for i, r in enumerate(ratings)}


VLFEEDBACK = [
    {"prompt": "p0", "img_path": "a.jpg", "completions": {
        "response": ["r0", "r1", "r2", "r3"],
        "annotations": [_anno("5", "4"), _anno("3", "3"), _anno("4.5", "4.5"),
                        _anno("1", "2")]}},
    {"prompt": "p1", "img_path": "/abs/b.jpg", "completions": {  # a tie and a bad rating
        "response": ["x", "y", "z"],
        "annotations": [_anno("3", "3"), _anno("3", "3"), _anno("N/A", "2")]}},
    {"prompt": "p2", "img_path": "c.jpg", "completions": {
        "response": ["u", "v", "w"],
        "annotations": [_anno("2"), _anno("4"), _anno("4.4")]}},
]


def _write(path, rows, jsonl):
    if jsonl:
        path.write_text("\n".join(json.dumps(r) for r in rows) + "\n\n")
    else:
        path.write_text(json.dumps(rows))
    return str(path)


@pytest.mark.parametrize("jsonl", [False, True])
@pytest.mark.parametrize("margin", [-1, 0.5, 2.0])
def test_vlfeedback_pairs_match_jax(tmp_path, jsonl, margin):
    path = _write(tmp_path / ("vlf.jsonl" if jsonl else "vlf.json"), VLFEEDBACK, jsonl)
    got = T.DATASET_MAP["vlfeedback_paired"](data_path=path, image_root="/imgs",
                                             score_margin=margin)
    want = J.DATASET_MAP["vlfeedback_paired"](data_path=path, image_root="/imgs",
                                              score_margin=margin)
    assert got == want and len(got) > 0
    assert all(r["img_path"].startswith("/") for r in got)
    if margin == -1:  # each sample's largest gap (p0 has two); p1's tie and N/A give nothing
        assert [(r["prompt"], r["chosen"], r["rejected"]) for r in got] == [
            ("p0", "r0", "r3"), ("p0", "r2", "r3"), ("p2", "w", "u")]
    assert T.make_vlfeedback_pairs(VLFEEDBACK, margin) == J.make_vlfeedback_pairs(VLFEEDBACK,
                                                                                  margin)


@pytest.mark.parametrize("jsonl", [False, True])
def test_other_builders_match_jax(tmp_path, jsonl):
    ext = ".jsonl" if jsonl else ".json"
    vlquery = [{"image": f"q{i}.jpg", "prompt": f"question {i}", "extra": i} for i in range(3)]
    rlhfv = [{"image_path": "r0.jpg", "text": json.dumps(
                 {"question": "q", "chosen": "good", "rejected": "bad"})},
             {"image_path": "sub/r1.jpg", "text": {"question": "q1", "chosen": "c",
                                                    "rejected": "r"}}]
    plain = [{"prompt": "p", "chosen": "c", "rejected": "r", "image": "x.jpg"},
             {"prompt": "text only", "chosen": "c2", "rejected": "r2"}]
    for name, rows in (("vlquery_json", vlquery), ("rlhfv", rlhfv), ("plain_dpo", plain)):
        path = _write(tmp_path / (name + ext), rows, jsonl)
        for root in ("", "/data/images"):
            got = T.DATASET_MAP[name](data_path=path, image_root=root)
            assert got == J.DATASET_MAP[name](data_path=path, image_root=root), (name, root)
    assert T.DATASET_MAP.keys() == J.DATASET_MAP.keys()


@pytest.mark.parametrize("path", ["MMInstruction/VLFeedback", "HaoyeZhang/RLHF-V-Dataset"])
def test_hub_names_and_directories_are_refused(tmp_path, path):
    with pytest.raises(ValueError, match="local .json / .jsonl files only"):
        T.load_json_rows(path)
    with pytest.raises(ValueError, match="hub dataset name"):
        T.make_vlfeedback_paired_dataset()
    with pytest.raises(ValueError, match="local .json"):
        T.build_plain_dpo_dataset(str(tmp_path))


def test_rm_collator_matches_jax():
    from vlrlhf_tpu.data import collators as JC
    from vlrlhf_tpu.data import processor as JP
    from vlrlhf_tpu.data.chat_templates import TEMPLATES as JT
    from vlrlhf_tpu.data.tokenizer import ToyTokenizer as JToy
    from vlrlhf_torch.data import collators as TC
    from vlrlhf_torch.data import processor as TP
    from vlrlhf_torch.data.chat_templates import TEMPLATES as TT
    from vlrlhf_torch.data.tokenizer import ToyTokenizer as TToy

    kw = dict(num_image_tokens=4, image_token_id=3, max_length=64, max_prompt_length=32)
    jp = JP.VLProcessor(JToy(), JT["llava"], JP.ProcessorConfig(**kw))
    tp = TP.VLProcessor(TToy(), TT["llava"], TP.ProcessorConfig(**kw))
    rows = [{"prompt": "what is it ?", "img_path": "a.jpg", "chosen": "a cat on a mat",
             "rejected": "a dog"},
            {"prompt": "no image here", "img_path": None, "chosen": "yes", "rejected": "no no"}]

    def loader(path, size, mode):
        return np.full((size, size, 3), len(path), np.uint8)

    jb = JC.RMCollator(jp, JC.CollatorConfig(bucket_multiple=16, image_size=8), loader)(
        [jp.tokenize_row_dpo(r) for r in rows])
    tb = TC.RMCollator(tp, TC.CollatorConfig(bucket_multiple=16, image_size=8), loader)(
        [tp.tokenize_row_dpo(r) for r in rows])
    assert tb.keys() == jb.keys()
    for k in tb:
        np.testing.assert_array_equal(tb[k], np.asarray(jb[k]), err_msg=k)
