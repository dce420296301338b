"""JsonTokenizer (vlrlhf_torch/data/tokenizer.py) against the `tokenizers`
library and vlrlhf_tpu's HFTokenizer (transformers' AutoTokenizer) on the
same directory: a llama BPE tokenizer.json built in code with byte
fallback (utils/synthetic_checkpoint.py), in both layouts (the older
Prepend + Replace normalizer, the newer Metaspace pre-tokenizer), over
ASCII, CJK, emoji (byte fallback), runs of spaces, newlines and the added
tokens <image> / <pad>: ids with and without special tokens, decoded text
with and without them, the special ids, the vocabulary size, and unknown
tokens. Then the port's processor on it against vlrlhf_tpu's
make_processor over HFTokenizer on DPO and generation rows (ids, labels,
image positions). Tokenizers the port does not read are refused by name."""

import json
import os

import numpy as np
import pytest
import tokenizers

from vlrlhf_tpu.data.tokenizer import HFTokenizer
from vlrlhf_torch.data.tokenizer import JsonTokenizer
from vlrlhf_torch.utils.synthetic_checkpoint import write_tokenizer

TEXTS = [
    "Hello world", "The dog is sitting on the table.", "  leading spaces and   runs   ",
    "USER: <image>\nWhat is shown in the image? ASSISTANT:", "中文字符测试，还有标点。",
    "emoji 😀🎉 and ü ß é mixed", "<s>hello</s><pad><image>x<image>", "tabs\tand\nnewlines\n\n",
    "", " ", "a", "x<image>y", "don't can't I'm", "<image>", "   <image>   two",
    "12345 + 678 = 7023?!", "qXz unseenword",
]


@pytest.fixture(scope="module", params=["prepend", "metaspace"])
def tok_dir(request, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"tok_{request.param}")
    write_tokenizer(str(d), layout=request.param)
    return str(d)


@pytest.fixture(scope="module")
def toks(tok_dir):
    return (JsonTokenizer(tok_dir), tokenizers.Tokenizer.from_file(
        os.path.join(tok_dir, "tokenizer.json")), HFTokenizer.from_pretrained(tok_dir))


def test_encode_matches_tokenizers_and_hf(toks):
    ours, ref, hf = toks
    for text in TEXTS:
        for special in (False, True):
            got = ours.encode(text, add_special_tokens=special)
            assert got == ref.encode(text, add_special_tokens=special).ids, (text, special)
            assert got == hf.encode(text, add_special_tokens=special), (text, special)


def test_decode_matches_tokenizers_and_hf(toks):
    ours, ref, hf = toks
    rng = np.random.default_rng(0)
    id_lists = [hf.encode(t, add_special_tokens=True) for t in TEXTS]
    # random ids: lone byte tokens (invalid UTF-8 -> U+FFFD), pieces, specials
    id_lists += [rng.integers(0, ours.vocab_size, 12).tolist() for _ in range(8)]
    id_lists += [[3 + 0xE4, 3 + 0xB8, 100, 3 + 0xE4, 3 + 0xB8, 3 + 0xAD]]
    for ids in id_lists:
        for skip in (False, True):
            got = ours.decode(ids, skip_special_tokens=skip)
            assert got == ref.decode(ids, skip_special_tokens=skip), (ids, skip)
            assert got == hf.decode(ids, skip_special_tokens=skip), (ids, skip)


def test_special_ids_vocab_and_lookup_match_hf(toks):
    ours, _, hf = toks
    for attr in ("bos_token_id", "eos_token_id", "pad_token_id", "vocab_size"):
        assert getattr(ours, attr) == getattr(hf, attr), attr
    assert ours.vocab_size == 32002 and ours.pad_token_id == 32001
    for token in ("<image>", "<pad>", "</s>", "<unk>", "▁the", "<0x0A>", "not-a-token"):
        assert ours.convert_token_to_id(token) == hf.convert_token_to_id(token), token


def test_pad_falls_back_to_unk(tmp_path):
    write_tokenizer(str(tmp_path))
    conf = json.loads((tmp_path / "tokenizer_config.json").read_text())
    del conf["pad_token"]
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(conf))
    ours, hf = JsonTokenizer(str(tmp_path)), HFTokenizer.from_pretrained(str(tmp_path))
    assert ours.pad_token_id == hf.pad_token_id == ours.convert_token_to_id("<unk>") == 0


@pytest.mark.parametrize("edit,match", [
    (lambda t, c: t["model"].update(type="Unigram"), "model type 'Unigram'"),
    (lambda t, c: t.update(pre_tokenizer={"type": "ByteLevel"}), "pre-tokenizer 'ByteLevel'"),
    (lambda t, c: t["decoder"]["decoders"].append({"type": "WordPiece"}), "decoder"),
    (lambda t, c: t.update(normalizer={"type": "NFKC"}), "normalizer"),
    (lambda t, c: c.update(tokenizer_class="QWenTokenizer"), "tokenizer_class 'QWenTokenizer'"),
])
def test_unsupported_pieces_are_refused_by_name(tmp_path, edit, match):
    write_tokenizer(str(tmp_path))
    tok = json.loads((tmp_path / "tokenizer.json").read_text())
    conf = json.loads((tmp_path / "tokenizer_config.json").read_text())
    edit(tok, conf)
    (tmp_path / "tokenizer.json").write_text(json.dumps(tok))
    (tmp_path / "tokenizer_config.json").write_text(json.dumps(conf))
    with pytest.raises(ValueError, match=match):
        JsonTokenizer(str(tmp_path))


def test_sentencepiece_only_directory_loads(tmp_path):
    """A llava checkpoint directory with a sentencepiece tokenizer.model and
    no tokenizer.json loads through the same reader (data/tokenizer.py
    `sentencepiece_spec`): its ids equal those of the tokenizer.json that
    `tokenizers` builds from the same pieces, and load_model_bundle reads
    such a checkpoint."""
    import torch
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers

    from vlrlhf_torch.cli.loading import load_model_bundle
    from vlrlhf_torch.data.tokenizer import read_sentencepiece
    from vlrlhf_torch.models.common import init_random_
    from vlrlhf_torch.models.config import FAMILIES, scale_down
    from vlrlhf_torch.models.vlm import VLM
    from vlrlhf_torch.utils.synthetic_checkpoint import (
        write_checkpoint, write_sentencepiece_tokenizer,
    )

    spm_dir, json_dir = tmp_path / "spm", tmp_path / "json"
    write_sentencepiece_tokenizer(str(spm_dir), 2000)
    pieces = read_sentencepiece(str(spm_dir / "tokenizer.model"))["pieces"]
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    merges = sorted((-sc, vocab[p[:i]], vocab[p[i:]], p[:i], p[i:]) for p, sc, _ in pieces
                    for i in range(1, len(p)) if p[:i] in vocab and p[i:] in vocab)
    ref = Tokenizer(models.BPE(vocab, [(a, b) for *_, a, b in merges], unk_token="<unk>",
                               fuse_unk=True, byte_fallback=True))
    ref.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                           normalizers.Replace(" ", "▁")])
    ref.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                     decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    ref.add_tokens([AddedToken(p, normalized=False, special=True) for p in ("<s>", "</s>")])
    json_dir.mkdir()
    ref.save(str(json_dir / "tokenizer.json"))
    (json_dir / "tokenizer_config.json").write_text((spm_dir / "tokenizer_config.json")
                                                    .read_text())
    from_spm, from_json = JsonTokenizer(str(spm_dir)), JsonTokenizer(str(json_dir))
    for text in TEXTS:
        for special in (False, True):
            got = from_spm.encode(text, add_special_tokens=special)
            assert got == from_json.encode(text, add_special_tokens=special), (text, special)
        assert from_spm.decode(got) == from_json.decode(got)
    cfg = scale_down(FAMILIES["llava"].make_config())
    model = init_random_(VLM(cfg), torch.Generator().manual_seed(0))
    ckpt = tmp_path / "ckpt"
    write_checkpoint(str(ckpt), model.state_dict(), cfg, dtype="float32")
    (ckpt / "tokenizer.json").unlink()
    write_sentencepiece_tokenizer(str(ckpt), 2000)
    _, _, _, proc = load_model_bundle(str(ckpt), torch.float32, device="cpu")
    assert proc.tokenizer.encode("the dog") == from_json.encode("the dog")


ROWS = [
    {"prompt": "What is shown in the image?", "img_path": "a.jpg",
     "chosen": "A dog is sitting on the table.", "rejected": "A red car in the street"},
    {"prompt": "Describe it in detail, 中文 😀", "img_path": None,
     "chosen": "two people standing", "rejected": "no"},
    {"prompt": "Describe it in detail", "img_path": None,
     "chosen": "two people standing", "rejected": "a cat"},
    {"prompt": "<image>\nAnswer the question: how many?", "img_path": "b.jpg",
     "chosen": " ".join(["word"] * 40), "rejected": "three"},
]


def test_processor_on_it_matches_jax(tok_dir):
    from vlrlhf_tpu.models.registry import FAMILIES as JF
    from vlrlhf_tpu.models.registry import make_processor as jmake
    from vlrlhf_torch.cli.loading import make_processor
    from vlrlhf_torch.models.config import FAMILIES, _llava_7b

    kw = dict(max_length=96, max_prompt_length=48)
    jp = jmake(JF["llava"], HFTokenizer.from_pretrained(tok_dir), num_image_tokens=5,
               image_token_id=32000, **kw)
    cfg = _llava_7b()
    import dataclasses

    tp = make_processor(FAMILIES["llava"], JsonTokenizer(tok_dir),
                        dataclasses.replace(cfg, num_image_tokens=5), **kw)
    for row in ROWS:
        try:
            want = jp.tokenize_row_dpo(dict(row))
        except ValueError as e:  # TRL's check that the prompt tokens prefix the row's
            with pytest.raises(ValueError, match=str(e)):
                tp.tokenize_row_dpo(dict(row))
            continue
        got = tp.tokenize_row_dpo(dict(row))
        for k in ("prompt_input_ids", "chosen_input_ids", "chosen_labels",
                  "rejected_input_ids", "rejected_labels"):
            assert list(got[k]) == list(want[k]), (row["prompt"], k)
        for side in ("chosen", "rejected"):
            w = jp.expand_image_tokens(want[f"{side}_input_ids"], want[f"{side}_labels"])
            g = tp.expand_image_tokens(got[f"{side}_input_ids"], got[f"{side}_labels"])
            for a, b in zip(g, w):
                assert np.array_equal(np.asarray(a), np.asarray(b)), side
        # generation rows: the prompt with its image placeholder
        n_img = 1 if row["img_path"] else 0
        conv = [{"from": "user", "value": tp.format_multimodal_prompt(row["prompt"], n_img)},
                {"from": "assistant", "value": ""}]
        assert tp.process_conv(conv)["input_ids"] == jp.process_conv(conv)["input_ids"]
