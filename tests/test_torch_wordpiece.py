"""JsonTokenizer on a BERT WordPiece tokenizer.json (InstructBLIP's
qformer_tokenizer/) against the `tokenizers` library, on synthetic
vocabularies: ids equal with and without the [CLS] ... [SEP] template
(TemplateProcessing and BertProcessing), through the BertNormalizer
(lowercase, accents, control characters, Chinese characters), the
BertPreTokenizer (punctuation), greedy subword splits, unknown and
over-long words and added special tokens inside the text; decode equals
transformers' (clean_up_tokenization_spaces) with and without the special
tokens."""

import json

import pytest

from vlrlhf_torch.data.tokenizer import JsonTokenizer

WORDS = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "the", "a", "cat", "dog", "on", "mat",
         "##s", "##ing", "run", "what", "is", "in", "image", "this", "describe", "##e", "photo",
         "?", ".", ",", "!", "'", "t", "don", "n", "##t", "de", "##scribe", "caf", "##é", "é",
         "e", "中", "文", "x", "##x", "ph", "##oto", "-", "(", ")", "$"]
TEXTS = [
    "What is in this image?", "Describe the photo.", "The cats running on a mat!",
    "Café\tdon't  中文 xxxxxxxxxxxxxxxxxxx", "  \x00odd​ text\x1c here [CLS] a [SEP]",
    "Ünïcödé ÉPHOTO'S", "", "photos-(cat)$dog", "describing\nthe\r\nmat",
]


def _write(path, post: str, strip_accents=None):
    from tokenizers import Tokenizer, decoders, models, normalizers, pre_tokenizers, processors

    vocab = {w: i for i, w in enumerate(WORDS)}
    tok = Tokenizer(models.WordPiece(vocab, unk_token="[UNK]", max_input_chars_per_word=12))
    tok.normalizer = normalizers.BertNormalizer(clean_text=True, handle_chinese_chars=True,
                                                strip_accents=strip_accents, lowercase=True)
    tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
    if post == "template":
        tok.post_processor = processors.TemplateProcessing(
            single="[CLS] $A [SEP]", pair="[CLS] $A [SEP] $B:1 [SEP]:1",
            special_tokens=[("[CLS]", 2), ("[SEP]", 3)])
    else:
        tok.post_processor = processors.BertProcessing(("[SEP]", 3), ("[CLS]", 2))
    tok.decoder = decoders.WordPiece(prefix="##")
    tok.add_special_tokens(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"])
    tok.save(str(path / "tokenizer.json"))
    (path / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "BertTokenizer", "unk_token": "[UNK]", "pad_token": "[PAD]",
        "sep_token": "[SEP]", "cls_token": "[CLS]", "mask_token": "[MASK]",
        "clean_up_tokenization_spaces": True, "do_lower_case": True}))
    return tok


@pytest.mark.parametrize("post,strip", [("template", None), ("bert", None), ("template", False)])
def test_encode_matches_tokenizers(tmp_path, post, strip):
    ref = _write(tmp_path, post, strip)
    tok = JsonTokenizer(str(tmp_path))
    assert tok.pad_token_id == 0 and tok.vocab_size == len(WORDS)
    for t in TEXTS:
        assert tok.encode(t, add_special_tokens=True) == ref.encode(t).ids, t
        assert tok.encode(t) == ref.encode(t, add_special_tokens=False).ids, t


def test_decode_matches_transformers(tmp_path):
    from transformers import AutoTokenizer

    _write(tmp_path, "template")
    ref = AutoTokenizer.from_pretrained(str(tmp_path))
    tok = JsonTokenizer(str(tmp_path))
    for t in TEXTS:
        ids = ref(t)["input_ids"]
        assert ids == tok.encode(t, add_special_tokens=True)
        for skip in (True, False):
            assert tok.decode(ids, skip_special_tokens=skip) == ref.decode(
                ids, skip_special_tokens=skip), (t, skip)


def test_synthetic_qformer_tokenizer_round_trips(tmp_path):
    """utils/synthetic_checkpoint.py's seeded BERT tokenizer: the template
    and the added [DEC] id sit where a Q-Former of vocab_size + 1 ids
    expects them, and `tokenizers` reads it as the port does."""
    from tokenizers import Tokenizer

    from vlrlhf_torch.utils.synthetic_checkpoint import write_bert_tokenizer

    write_bert_tokenizer(str(tmp_path), 500)
    tok = JsonTokenizer(str(tmp_path))
    ref = Tokenizer.from_file(str(tmp_path / "tokenizer.json"))
    assert tok.convert_token_to_id("[DEC]") == 500 and tok.vocab_size == 501
    for t in ("What is the color of the car?", "Describe this image in detail.", "zzqx"):
        ids = tok.encode(t, add_special_tokens=True)
        assert ids == ref.encode(t).ids and ids[0] == 2 and ids[-1] == 3
        assert max(ids) < 501
