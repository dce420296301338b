"""Qwen-VL's tokenizer and ChatML rows in vlrlhf_torch:
  - QwenTokenizer (data/tokenizer.py, the port's own `qwen.tiktoken`
    reader) against `tiktoken.Encoding` built over the same rank file with
    Qwen's pre-tokenizer pattern and special tokens: a small rank file
    (the bytes and the corpus's frequent 2-4 byte pieces) for the BPE, over
    CJK, digits, mixed whitespace and newlines, emoji and ChatML markers;
    decode(encode(s)) == s;
  - the full-size synthetic qwen.tiktoken (utils/synthetic_checkpoint.py,
    151,643 ranks): the special tokens on their published ids, "\\n" one
    token;
  - the ChatML rows (DPO, SFT, generation) and the wrapped image expansion
    ("Picture 1: <img>" + n pads + "</img>") of the port's processor against
    vlrlhf_tpu's on one tokenizer: vlrlhf_tpu's ToyTokenizer (the ids
    copied into the port's) and the port's QwenTokenizer handed to both;
    the family's stop ids (<|im_end|>, <|im_start|>, then the eos)."""

import base64
import collections
import os

import numpy as np
import pytest

from vlrlhf_torch.data.tokenizer import QWEN_SPECIALS, QwenTokenizer

# Qwen-VL's tokenization_qwen.py PAT_STR
PAT = (r"""(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}| ?[^\s\p{L}\p{N}]+"""
       r"""[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+""")
CORPUS = [
    "Hello world! It's 2024, and 数字12345 are here.\n\n  Spaces\tand\ttabs\r\n",
    "😀 emoji 🎉 mixed 中文字符测试，还有标点。 <|im_start|>user\nhi<|im_end|>\n",
    "I'LL  we've   they'd\n\n\nend   ", "x" * 50, "naïve café — “quotes” ‹›", "a b　c d",
    "Picture 1: <img>path/to.jpg</img>\n<imgpad><imgpad>", "", " ", "\n", "   \n  \n",
    "<|extra_3|>x<|endoftext|>", "ǅungla Ⅻ ⅷ ٣ ½ 𝟙", "'S 'Ve 'LL", "a b c　d",
]


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(QwenTokenizer, tiktoken.Encoding) over a small rank file."""
    tiktoken = pytest.importorskip("tiktoken")
    ranks = {bytes([b]): b for b in range(256)}
    cnt = collections.Counter()
    for s in CORPUS:
        bs = s.encode()
        for n in (2, 3, 4):
            cnt.update(bs[i:i + n] for i in range(len(bs) - n + 1))
    for tok, _ in cnt.most_common(700):
        if tok[:-1] in ranks and tok not in ranks:
            ranks[tok] = len(ranks)
    d = tmp_path_factory.mktemp("qwen_small")
    (d / "qwen.tiktoken").write_text("".join(f"{base64.b64encode(t).decode()} {r}\n"
                                             for t, r in ranks.items()))
    n = len(ranks)
    enc = tiktoken.Encoding("qwen_small", pat_str=PAT, mergeable_ranks=ranks,
                            special_tokens={t: n + i for i, t in enumerate(QWEN_SPECIALS)})
    return QwenTokenizer(str(d)), enc


def test_encode_and_decode_match_tiktoken(small):
    ours, enc = small
    for text in CORPUS:
        got = ours.encode(text)
        assert got == enc.encode(text, allowed_special="all"), text
        assert ours.decode(got, skip_special_tokens=False) == text
        assert ours.decode(got) == enc.decode([i for i in got if i < ours.eod_id])


@pytest.fixture(scope="module")
def full(tmp_path_factory):
    from vlrlhf_torch.utils.synthetic_checkpoint import QWEN_N_RANKS, write_qwen_tiktoken

    d = tmp_path_factory.mktemp("qwen_full")
    write_qwen_tiktoken(str(d))
    with open(os.path.join(d, "qwen.tiktoken")) as f:
        assert sum(1 for _ in f) == QWEN_N_RANKS
    return QwenTokenizer(str(d))


def test_full_size_specials_on_published_ids(full):
    published = {"<|endoftext|>": 151643, "<|im_start|>": 151644, "<|im_end|>": 151645,
                 "<|extra_0|>": 151646, "<|extra_204|>": 151850, "<ref>": 151851,
                 "<img>": 151857, "</img>": 151858, "<imgpad>": 151859}
    for tok, tid in published.items():
        assert full.convert_token_to_id(tok) == tid
        assert full.encode(tok) == [tid]
    assert full.vocab_size == 151860 and full.eos_token_id == full.pad_token_id == 151643
    assert full.bos_token_id is None and full.encode("x", add_special_tokens=True) == full.encode("x")
    assert len(full.encode("\n")) == 1
    with pytest.raises(KeyError):
        full.convert_token_to_id("<not a token>")


ROWS = [
    {"prompt": "What is shown in the image?", "img_path": "a.jpg",
     "chosen": "A dog is sitting on the table.", "rejected": "A red car",
     "answer": "a dog"},
    {"prompt": "Describe it in detail, 中文 😀", "img_path": None,
     "chosen": "two people standing", "rejected": "no", "answer": "people"},
    {"prompt": "<image> and <image>: which is larger?", "img_path": ["a.jpg", "b.jpg"],
     "chosen": "the first", "rejected": " ".join(["word"] * 40), "answer": "left"},
]


def _processors(jtok, ttok, image_token="<image>", image_token_id=3, wraps=(7, 8, 9)):
    from vlrlhf_tpu.data.chat_templates import TEMPLATES as JT
    from vlrlhf_tpu.data.processor import ProcessorConfig as JPC
    from vlrlhf_tpu.data.processor import VLProcessor as JP
    from vlrlhf_torch.data.chat_templates import TEMPLATES
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor

    kw = dict(num_image_tokens=5, image_token=image_token, image_token_id=image_token_id,
              image_start_id=wraps[0], image_end_id=wraps[1], image_pad_id=wraps[2],
              add_bos=False, max_length=64, max_prompt_length=40)
    return (JP(jtok, JT["qwen_vl"], JPC(**kw)),
            VLProcessor(ttok, TEMPLATES["qwen_vl"], ProcessorConfig(**kw)))


def _check_rows(jp, tp):
    for row in ROWS:
        n_img = 0 if row["img_path"] is None else len(np.atleast_1d(row["img_path"]))
        if n_img != 2:
            sft = {k: row[k] for k in ("prompt", "answer", "img_path")}
            assert tp.tokenize_row_sft(sft) == jp.tokenize_row_sft(sft)
        dpo = {k: row[k] for k in ("prompt", "chosen", "rejected", "img_path")}
        want = jp.tokenize_row_dpo(dpo)
        assert tp.tokenize_row_dpo(dpo) == want
        prompt = jp.format_multimodal_prompt(row["prompt"], n_img)
        assert tp.format_multimodal_prompt(row["prompt"], n_img) == prompt
        gen = jp.process_conv([{"from": "user", "value": prompt},
                               {"from": "assistant", "value": ""}])["input_ids"]
        assert tp.generation_row(row["prompt"], row["img_path"])["input_ids"] == gen
        for ids, labels in ((want["chosen_input_ids"], want["chosen_labels"]), (gen, None)):
            got = tp.expand_image_tokens(ids, labels)
            exp = jp.expand_image_tokens(ids, labels)
            for g, w in zip(got, exp):
                np.testing.assert_array_equal(g, w)
            if n_img:
                cfg = tp.cfg
                pos = got[2]
                assert len(pos) == n_img * cfg.num_image_tokens
                assert all(got[0][p] == cfg.image_pad_id for p in pos)
                assert got[0][pos[0] - 1] == cfg.image_start_id
                assert got[0][pos[cfg.num_image_tokens - 1] + 1] == cfg.image_end_id


def test_chatml_rows_match_jax_with_toy_tokenizer():
    from vlrlhf_tpu.data.tokenizer import ToyTokenizer as JTok
    from vlrlhf_torch.data.tokenizer import ToyTokenizer

    jp, tp = _processors(JTok(), ToyTokenizer())
    _check_rows(jp, tp)
    out = tp.tokenize_row_dpo(dict(ROWS[0]))
    assert out["chosen_input_ids"][0] == 5  # <|im_start|>, no BOS
    assert tp.format_multimodal_prompt("hi", 1) == "Picture 1: <image>\nhi"


def test_chatml_rows_and_stop_ids_match_jax_with_qwen_tokenizer(full):
    from vlrlhf_torch.cli.main import stop_ids
    from vlrlhf_torch.models.config import FAMILIES

    jp, tp = _processors(full, full, "<imgpad>", 151859, (151857, 151858, 151859))
    _check_rows(jp, tp)
    assert stop_ids(tp, FAMILIES["qwen_vl"], False) == (151645, 151644, 151643)
