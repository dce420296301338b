"""The port's sentencepiece `tokenizer.model` reader (data/tokenizer.py
`read_sentencepiece` / `sentencepiece_spec`, fed to JsonTokenizer's BPE
engine) against independent implementations:
  - a ModelProto written with transformers' bundled
    `sentencepiece_model_pb2_new` (protobuf): ids equal to a `tokenizers`
    BPE built from the same pieces (merges of every piece that splits into
    two pieces, by the merged piece's score; byte fallback; control and
    user-defined pieces as added tokens; the dummy prefix as Prepend +
    Replace), hand-checked golden ids, decode(encode(s)) == s on text
    without added tokens;
  - the hand-written ModelProto writer (utils/synthetic_checkpoint.py)
    read back by protobuf piece for piece;
  - XC2's full-size synthetic tokenizer.model (92,544 pieces): the
    user-defined [UNUSED_TOKEN_145] / [UNUSED_TOKEN_146] on 92542 / 92543,
    <ImageHere> added as 92544, the internlm_xc2 template's DPO, SFT and
    generation rows equal vlrlhf_tpu's processor's on the same tokenizer,
    the stop ids; a unigram model is refused by name."""


import numpy as np
import pytest

from vlrlhf_torch.data.tokenizer import JsonTokenizer

pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
tokenizers = pytest.importorskip("tokenizers")

TEXTS = ["the theme", "Hello world, hello there!", "  leading and  double  spaces ",
         "emoji 😀 and ü é", "them the", "tabs\tand\nnewlines\n", "", " ", "a"]
ADDED_TEXTS = ["[UNUSED_TOKEN_146]user\nhi 中文[UNUSED_TOKEN_145]\n", "<s>bos in text</s>",
               "[UNUSED_TOKEN_146]hem"]
WORDS = ["▁t", "he", "▁the", "me", "▁them", "▁theme", "ll", "▁he", "llo", "▁hello", "or",
         "▁w", "▁wor", "ld", "▁world", "▁a", "nd", "▁and", "in", "▁in"]


def _model_proto():
    """<unk>, <s>, </s>, the 256 bytes, one user-defined piece, the
    single characters, then WORDS scored in merge order, [UNUSED_TOKEN_145]
    last."""
    m = pb.ModelProto()

    def add(piece, score, kind):
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, score, kind

    add("<unk>", 0.0, 2)
    add("<s>", 0.0, 3)
    add("</s>", 0.0, 3)
    for b in range(256):
        add(f"<0x{b:02X}>", 0.0, 6)
    add("[UNUSED_TOKEN_146]", 0.0, 4)
    chars = sorted(set("▁".join(TEXTS + WORDS).replace(" ", "▁").replace("\n", "")
                       .replace("\t", "")) - set("😀üé"))
    for c in ["▁"] + [c for c in chars if c != "▁"]:
        add(c, -1000.0, 1)
    for i, w in enumerate(WORDS):
        add(w, -float(i), 1)
    add("[UNUSED_TOKEN_145]", 0.0, 4)
    m.trainer_spec.model_type = 2
    m.trainer_spec.byte_fallback = True
    m.normalizer_spec.name = "identity"
    m.normalizer_spec.add_dummy_prefix = True
    m.normalizer_spec.remove_extra_whitespaces = False
    return m


@pytest.fixture(scope="module")
def spm(tmp_path_factory):
    """(JsonTokenizer over tokenizer.model, tokenizers oracle, proto)."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, normalizers

    m = _model_proto()
    d = tmp_path_factory.mktemp("spm")
    (d / "tokenizer.model").write_bytes(m.SerializeToString())
    vocab = {p.piece: i for i, p in enumerate(m.pieces)}
    merges = sorted((-p.score, vocab[p.piece[:i]], vocab[p.piece[i:]], p.piece[:i], p.piece[i:])
                    for p in m.pieces for i in range(1, len(p.piece))
                    if p.piece[:i] in vocab and p.piece[i:] in vocab)
    oracle = Tokenizer(models.BPE(vocab, [(a, b) for *_, a, b in merges], unk_token="<unk>",
                                  fuse_unk=True, byte_fallback=True))
    oracle.normalizer = normalizers.Sequence([normalizers.Prepend("▁"),
                                              normalizers.Replace(" ", "▁")])
    oracle.decoder = decoders.Sequence([decoders.Replace("▁", " "), decoders.ByteFallback(),
                                        decoders.Fuse(), decoders.Strip(" ", 1, 0)])
    oracle.add_tokens([AddedToken(p.piece, normalized=False, special=p.type == 3)
                       for p in m.pieces if p.type in (3, 4)])
    return JsonTokenizer(str(d)), oracle, m


def test_ids_match_an_independent_bpe(spm):
    ours, oracle, m = spm
    assert ours.vocab_size == len(m.pieces)
    for text in TEXTS + ADDED_TEXTS:
        got = ours.encode(text)
        assert got == oracle.encode(text, add_special_tokens=False).ids, text
        assert ours.decode(got, skip_special_tokens=False) == oracle.decode(
            got, skip_special_tokens=False), text
    for text in TEXTS:
        assert ours.decode(ours.encode(text)) == text


def test_golden_ids(spm):
    ours, _, m = spm
    ids = {p.piece: i for i, p in enumerate(m.pieces)}
    # "▁the▁theme": ▁+t, h+e, ▁t+he, m+e by score; "▁theme" is one piece
    assert ours.encode("the theme") == [ids["▁the"], ids["▁theme"]]
    assert ours.encode("them the") == [ids["▁them"], ids["▁the"]]
    # an added piece is matched whole; the span after it takes its own prefix:
    # "▁hem" merges h+e, then ▁+he (score -7), never he+m (no such piece)
    assert ours.encode("[UNUSED_TOKEN_146]hem") == [259, ids["▁he"], ids["m"]]
    # byte fallback: é is not a piece -> its UTF-8 bytes
    assert ours.encode("é") == [ids["▁"], 3 + 0xC3, 3 + 0xA9]
    # a llama tokenizer (no tokenizer_config.json): BOS with special tokens
    assert ours.encode("a", add_special_tokens=True) == [1, ids["▁a"]]
    assert (ours.bos_token_id, ours.eos_token_id, ours.unk_token_id) == (1, 2, 0)


def test_writer_reads_back_with_protobuf(tmp_path):
    from vlrlhf_torch.data.tokenizer import read_sentencepiece
    from vlrlhf_torch.utils.synthetic_checkpoint import sentencepiece_model, spm_pieces

    pieces = spm_pieces(400, seed=1, user_defined=("[A]", "[B]"))
    raw = sentencepiece_model(pieces)
    m = pb.ModelProto.FromString(raw)
    assert [(p.piece, p.score, p.type) for p in m.pieces] == [
        (p, np.float32(s), t) for p, s, t in pieces]
    assert m.trainer_spec.model_type == 2 and m.trainer_spec.byte_fallback
    assert m.normalizer_spec.add_dummy_prefix and not m.normalizer_spec.remove_extra_whitespaces
    (tmp_path / "tokenizer.model").write_bytes(raw)
    back = read_sentencepiece(str(tmp_path / "tokenizer.model"))
    assert back["pieces"] == [(p.piece, p.score, p.type) for p in m.pieces]


def test_remove_extra_whitespaces(tmp_path):
    """sentencepiece's remove_extra_whitespaces: leading, trailing and
    repeated spaces go before the dummy prefix."""
    m = _model_proto()
    m.normalizer_spec.remove_extra_whitespaces = True
    (tmp_path / "tokenizer.model").write_bytes(m.SerializeToString())
    tok = JsonTokenizer(str(tmp_path))
    assert tok.encode("  the   theme  ") == tok.encode("the theme") == [
        i for i, p in enumerate(m.pieces) if p.piece in ("▁the", "▁theme")]


def test_unigram_is_refused(tmp_path):
    m = _model_proto()
    m.trainer_spec.model_type = 1
    (tmp_path / "tokenizer.model").write_bytes(m.SerializeToString())
    with pytest.raises(ValueError, match="model_type 1"):
        JsonTokenizer(str(tmp_path))


@pytest.fixture(scope="module")
def xc2_tok(tmp_path_factory):
    from vlrlhf_torch.utils.synthetic_checkpoint import write_xc2_tokenizer

    d = tmp_path_factory.mktemp("xc2_tok")
    write_xc2_tokenizer(str(d))
    return str(d)


def test_xc2_tokenizer_rows_and_stop_ids_match_jax(xc2_tok):
    from vlrlhf_tpu.data.chat_templates import TEMPLATES as JT
    from vlrlhf_tpu.data.processor import ProcessorConfig as JPC
    from vlrlhf_tpu.data.processor import VLProcessor as JP
    from vlrlhf_torch.cli.main import stop_ids
    from vlrlhf_torch.data.chat_templates import TEMPLATES
    from vlrlhf_torch.data.processor import ProcessorConfig, VLProcessor
    from vlrlhf_torch.models.config import FAMILIES

    tok = JsonTokenizer(xc2_tok)
    assert tok.vocab_size == 92544
    assert tok.convert_token_to_id("[UNUSED_TOKEN_145]") == 92542
    assert tok.convert_token_to_id("[UNUSED_TOKEN_146]") == 92543
    img = tok.add_special_token("<ImageHere>")
    assert img == 92544 and tok.vocab_size == 92545 and tok.encode("a<ImageHere>b")[1] == img
    kw = dict(num_image_tokens=6, image_token="<ImageHere>", image_token_id=img,
              max_length=600, max_prompt_length=500)
    jp = JP(tok, JT["internlm_xc2"], JPC(**kw))
    tp = VLProcessor(tok, TEMPLATES["internlm_xc2"], ProcessorConfig(**kw))
    for f in ({"prompt": "What is in the image?", "chosen": "a dog", "rejected": "a cat",
               "answer": "a dog", "img_path": "a.jpg"},
              {"prompt": "Describe <ImageHere> in detail.", "chosen": "two people standing",
               "rejected": "no", "answer": "people", "img_path": "b.jpg"}):
        assert tp.tokenize_row_dpo(dict(f)) == jp.tokenize_row_dpo(dict(f))
        sft = {k: f[k] for k in ("prompt", "answer", "img_path")}
        assert tp.tokenize_row_sft(sft) == jp.tokenize_row_sft(sft)
        gen = tp.generation_row(f["prompt"], f["img_path"])["input_ids"]
        assert gen == jp.process_conv([{"from": "user", "value": jp.format_multimodal_prompt(
            f["prompt"], 1)}, {"from": "assistant", "value": ""}])["input_ids"]
        ids, _, pos = tp.expand_image_tokens(gen)
        assert len(pos) == 6 and all(ids[p] == img for p in pos)
    assert stop_ids(tp, FAMILIES["internlm_xc2"], False) == (92542, 2)
