"""Tokenizers: `ToyTokenizer` (a copy of vlrlhf_tpu/data/tokenizer.py's, the
deterministic word-level tokenizer of the hermetic paths), `JsonTokenizer`,
the counterpart of vlrlhf_tpu's `HFTokenizer` for a checkpoint's
llama-style `tokenizer.json` or sentencepiece `tokenizer.model`, and
`QwenTokenizer` for Qwen-VL's `qwen.tiktoken`, all read without
`transformers`, `tokenizers`, `tiktoken`, `sentencepiece` or `protobuf`
(one code path on every machine).

A sentencepiece `tokenizer.model` (llama's, InternLM2's) is a protobuf
ModelProto, parsed here by hand (`read_sentencepiece`) and turned into the
tokenizer.json spec transformers' LlamaConverter writes for it
(`sentencepiece_spec`): the pieces as the BPE vocab, the merges of every
piece that splits into two pieces, ordered by the merged piece's score
(transformers' SentencePieceExtractor), byte fallback as the trainer spec
says, control and user-defined pieces as added tokens matched whole in the
raw text, the dummy prefix as a Prepend normalizer applied to each span
between added tokens (the legacy layout, as the slow sentencepiece
tokenizer encodes each such span alone). So one BPE engine serves both
files.

JsonTokenizer implements what the `tokenizers` library does with the
pieces llama's tokenizer.json is made of, and refuses any other piece by
name rather than guess:
  - added tokens (special or not, `lstrip` / `rstrip`), matched on the raw
    text before anything else, longest first;
  - the normalizer: none, or a Sequence of `Prepend` and `Replace` (the
    older layout: Prepend("▁") + Replace(" ", "▁"), applied to each span
    between added tokens);
  - the pre-tokenizer: none, or `Metaspace` (the newer layout; prepend
    scheme "first" prepends only to the span that starts the text,
    "always" to every span; `split`);
  - a BPE model with `byte_fallback` (<0xXX> tokens for characters outside
    the vocabulary) and `fuse_unk`, merged pair by pair, lowest rank and
    then leftmost first;
  - the `TemplateProcessing` post-processor for add_special_tokens (for a
    llama tokenizer class, the template transformers' LlamaTokenizerFast
    rebuilds from add_bos_token / add_eos_token);
  - the decoder chain `Replace` / `ByteFallback` / `Fuse` / `Strip`.
And the pieces of a BERT WordPiece tokenizer.json (InstructBLIP's
`qformer_tokenizer/`):
  - a `WordPiece` model: greedy longest-match-first with the
    continuing-subword prefix, a word the vocabulary cannot cover (or one
    longer than max_input_chars_per_word) becomes one unk;
  - the `BertNormalizer` (clean_text, handle_chinese_chars, strip_accents
    following lowercase when unset, lowercase) and the `BertPreTokenizer`
    (split on whitespace, every punctuation character its own word);
  - the `[CLS] $A [SEP]` template (TemplateProcessing or BertProcessing);
  - the `WordPiece` decoder (prefix joins, its cleanup).
tokenizer_config.json gives the special tokens, the tokenizer class and
clean_up_tokenization_spaces, as transformers reads them. The pad id falls
back to the unk id when no pad token is set, as HFTokenizer does.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
import zlib
from typing import Optional, Sequence


class ToyTokenizer:
    """Deterministic word-level tokenizer for hermetic runs.

    Splits on whitespace + punctuation; each distinct word hashes into the
    vocab. Special tokens occupy the bottom of the id space."""

    def __init__(self, vocab_size: int = 4096, specials: Optional[dict] = None):
        self.vocab_size = vocab_size
        self.bos_token_id = 1
        self.eos_token_id = 2
        self.pad_token_id = 0
        self._specials = {
            "<image>": 3,
            "<unk>": 4,
            "<|im_start|>": 5,
            "<|im_end|>": 6,
        }
        if specials:
            self._specials.update(specials)
        self._n_reserved = 16
        self._inv = {v: k for k, v in self._specials.items()}

    def _word_id(self, word: str) -> int:
        h = zlib.crc32(word.encode()) % (self.vocab_size - self._n_reserved)
        return h + self._n_reserved

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids = [self.bos_token_id] if add_special_tokens else []
        # split keeping special token strings intact
        pat = "|".join(re.escape(s) for s in self._specials)
        parts = re.split(f"({pat})", text)
        for part in parts:
            if part in self._specials:
                ids.append(self._specials[part])
                continue
            for w in re.findall(r"\w+|[^\w\s]", part):
                ids.append(self._word_id(w))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i in self._inv:
                if not skip_special_tokens:
                    out.append(self._inv[i])
            elif i >= self._n_reserved:
                out.append(f"w{i}")
            elif not skip_special_tokens:
                out.append(f"<{i}>")
        return " ".join(out)

    def convert_token_to_id(self, token: str) -> int:
        return self._specials.get(token, 4)


_LLAMA_CLASSES = ("LlamaTokenizer", "LlamaTokenizerFast", "InternLM2Tokenizer",
                  "InternLMXComposer2Tokenizer")
_CLASSES = _LLAMA_CLASSES + ("BertTokenizer", "BertTokenizerFast", "PreTrainedTokenizerFast",
                             None)
_BYTE = re.compile(r"^<0x([0-9A-Fa-f]{2})>$")
_CACHE_MAX = 65536


def _refuse(path: str, what: str) -> ValueError:
    return ValueError(f"{path}: {what} is not supported by JsonTokenizer (it reads llama's "
                      "BPE and BERT's WordPiece tokenizer.json only)")


def _token_str(v) -> Optional[str]:
    """A special token as tokenizer_config.json writes it: a string or an
    AddedToken dict."""
    return v.get("content") if isinstance(v, dict) else v


class JsonTokenizer:
    """A llama tokenizer.json (BPE, byte fallback) or a BERT one
    (WordPiece) with the interface of vlrlhf_tpu's HFTokenizer: bos / eos /
    pad token ids, vocab_size (every token, added ones included), encode,
    decode, convert_token_to_id."""

    def __init__(self, path: str):
        json_path = os.path.join(path, "tokenizer.json")
        spm_path = os.path.join(path, "tokenizer.model")
        self._from_spm = not os.path.exists(json_path)
        if not self._from_spm:
            with open(json_path, encoding="utf-8") as f:
                spec = json.load(f)
        elif os.path.exists(spm_path):
            spec = sentencepiece_spec(spm_path)
            json_path = spm_path
        else:
            raise FileNotFoundError(f"no tokenizer.json or tokenizer.model under {path}")
        conf: dict = {}
        conf_path = os.path.join(path, "tokenizer_config.json")
        if os.path.exists(conf_path):
            with open(conf_path, encoding="utf-8") as f:
                conf = json.load(f)
        self._read_model(json_path, spec.get("model") or {})
        self._read_added(json_path, spec.get("added_tokens") or [])
        self._normalizers = self._read_normalizer(json_path, spec.get("normalizer"))
        self._metaspace = self._read_pre_tokenizer(json_path, spec.get("pre_tokenizer"))
        self._decoders = self._read_decoder(json_path, spec.get("decoder"))
        # BERT's pieces go with the WordPiece model only, llama's with BPE only
        bert = ({s[0] for s in self._normalizers} | {s[0] for s in self._decoders or []}
                | ({"bert"} if self._metaspace == ("bert",) else set()))
        mixed = (bert - {"bert", "wordpiece"} if self._wordpiece
                 else bert & {"bert", "wordpiece"})
        if mixed:
            raise _refuse(json_path, f"{sorted(mixed)} pieces with a "
                                     f"{'WordPiece' if self._wordpiece else 'BPE'} model "
                                     "(normalizer / pre-tokenizer / decoder)")
        self._read_config(conf_path, conf)
        self._template = self._read_template(json_path, spec.get("post_processor"), conf)
        self._cache: dict[str, list[int]] = {}

    @classmethod
    def from_pretrained(cls, path: str, **_kw) -> "JsonTokenizer":
        return cls(path)

    # -- reading tokenizer.json ------------------------------------------

    def _read_model(self, path: str, m: dict) -> None:
        self._wordpiece = m.get("type") == "WordPiece"
        if self._wordpiece:
            self.vocab = dict(m["vocab"])
            self._unk = m.get("unk_token", "[UNK]")
            self._wp_prefix = m.get("continuing_subword_prefix", "##")
            self._wp_max_chars = int(m.get("max_input_chars_per_word", 100))
            return
        if m.get("type") != "BPE":
            raise _refuse(path, f"model type {m.get('type')!r}")
        for key in ("continuing_subword_prefix", "end_of_word_suffix"):
            if m.get(key):
                raise _refuse(path, f"BPE {key}={m[key]!r}")
        if m.get("dropout") not in (None, 0, 0.0):
            raise _refuse(path, f"BPE dropout={m['dropout']!r}")
        self.vocab: dict[str, int] = dict(m["vocab"])
        self._unk = m.get("unk_token")
        self._fuse_unk = bool(m.get("fuse_unk", False))
        self._byte_fallback = bool(m.get("byte_fallback", False))
        self._ignore_merges = bool(m.get("ignore_merges", False))
        self._ranks: dict[tuple[int, int], tuple[int, int]] = {}
        for rank, merge in enumerate(m.get("merges", [])):
            a, b = merge.split(" ") if isinstance(merge, str) else merge
            self._ranks[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[a + b])

    def _read_added(self, path: str, added: list) -> None:
        self._added: dict[str, int] = {}
        self._special_ids: set[int] = set()
        alts = []
        for t in added:
            if t.get("single_word"):
                raise _refuse(path, f"added token {t['content']!r} with single_word")
            if t.get("normalized") and not t.get("special"):
                raise _refuse(path, f"added token {t['content']!r} matched after normalization")
            self._added[t["content"]] = t["id"]
            if t.get("special"):
                self._special_ids.add(t["id"])
            alts.append((t["content"], t.get("lstrip", False), t.get("rstrip", False)))
        self._set_added_pattern(alts)

    def _set_added_pattern(self, alts: list) -> None:
        self._alts = alts
        pats = [(r"\s*" if ls else "") + f"({re.escape(c)})" + (r"\s*" if rs else "")
                for c, ls, rs in sorted(alts, key=lambda a: -len(a[0]))]
        self._added_re = re.compile("|".join(pats)) if pats else None

    @staticmethod
    def _read_normalizer(path: str, n: Optional[dict]) -> list:
        if n is None:
            return []
        steps = n["normalizers"] if n.get("type") == "Sequence" else [n]
        out = []
        for s in steps:
            if s.get("type") == "BertNormalizer":
                lower = bool(s.get("lowercase", True))
                strip = s.get("strip_accents")
                out.append(("bert", bool(s.get("clean_text", True)),
                            bool(s.get("handle_chinese_chars", True)),
                            lower if strip is None else bool(strip), lower))
            elif s.get("type") == "SentencePieceCollapse":  # written by sentencepiece_spec only
                out.append(("collapse",))
            elif s.get("type") == "Prepend":
                out.append(("prepend", s["prepend"]))
            elif s.get("type") == "Replace" and "String" in s.get("pattern", {}):
                out.append(("replace", s["pattern"]["String"], s["content"]))
            else:
                raise _refuse(path, f"normalizer {s}")
        return out

    @staticmethod
    def _read_pre_tokenizer(path: str, p: Optional[dict]) -> Optional[tuple]:
        if p is None:
            return None
        if p.get("type") == "BertPreTokenizer":
            return ("bert",)
        if p.get("type") != "Metaspace":
            raise _refuse(path, f"pre-tokenizer {p.get('type')!r}")
        scheme = p.get("prepend_scheme")
        if scheme is None:  # the layout before prepend_scheme existed
            scheme = "always" if p.get("add_prefix_space", True) else "never"
        if scheme not in ("first", "always", "never"):
            raise _refuse(path, f"Metaspace prepend_scheme {scheme!r}")
        return p.get("replacement", "▁"), scheme, bool(p.get("split", True))

    @staticmethod
    def _read_decoder(path: str, d: Optional[dict]) -> Optional[list]:
        if d is None:
            return None
        steps = d["decoders"] if d.get("type") == "Sequence" else [d]
        out = []
        for s in steps:
            kind = s.get("type")
            if kind == "Replace" and "String" in s.get("pattern", {}):
                out.append(("replace", s["pattern"]["String"], s["content"]))
            elif kind in ("ByteFallback", "Fuse"):
                out.append((kind.lower(),))
            elif kind == "Strip":
                out.append(("strip", s["content"], int(s["start"]), int(s["stop"])))
            elif kind == "WordPiece":
                out.append(("wordpiece", s.get("prefix", "##"), bool(s.get("cleanup", True))))
            else:
                raise _refuse(path, f"decoder {s}")
        return out

    def _read_config(self, path: str, conf: dict) -> None:
        cls = conf.get("tokenizer_class")
        if cls not in _CLASSES:
            raise _refuse(path, f"tokenizer_class {cls!r}")
        if conf.get("add_prefix_space") is not None:
            raise _refuse(path, "add_prefix_space (transformers rebuilds the tokenizer from "
                                "sentencepiece for it)")
        # a bare tokenizer.model is read as a llama tokenizer would be
        self._llama = cls in _LLAMA_CLASSES or (cls is None and self._from_spm)
        defaults = ({"unk_token": "<unk>", "bos_token": "<s>", "eos_token": "</s>"}
                    if self._llama else {})
        tokens = {k: _token_str(conf.get(k, defaults.get(k)))
                  for k in ("unk_token", "bos_token", "eos_token", "pad_token")}
        extra = [_token_str(t) for t in conf.get("additional_special_tokens") or []]
        # transformers adds a named special token the tokenizer.json lacks
        missing = [t for t in [*tokens.values(), *extra] if t and t not in self._added]
        for t in dict.fromkeys(missing):
            tid = self.vocab.get(t)
            if tid is None:
                tid = len(set(self.vocab.values()) | set(self._added.values()))
                self.vocab[t] = tid
            self._added[t] = tid
            self._special_ids.add(tid)
            self._alts.append((t, False, False))
        if missing:
            self._set_added_pattern(self._alts)
        self._id_to_token = {i: t for t, i in self.vocab.items()}
        self._id_to_token.update({i: t for t, i in self._added.items()})
        self._clean_up = bool(conf.get("clean_up_tokenization_spaces", False))
        self.unk_token_id = self._opt_id(tokens["unk_token"])
        self.bos_token_id = self._opt_id(tokens["bos_token"])
        self.eos_token_id = self._opt_id(tokens["eos_token"])
        pad = self._opt_id(tokens["pad_token"])
        self.pad_token_id = pad if pad is not None else self.unk_token_id
        self.vocab_size = len(self._id_to_token)
        self._add_bos = conf.get("add_bos_token", True)
        self._add_eos = conf.get("add_eos_token", False)

    def _read_template(self, path: str, p: Optional[dict], conf: dict) -> tuple:
        if self._llama:  # LlamaTokenizerFast.update_post_processor's template
            pre = [self.bos_token_id] if self._add_bos else []
            post = [self.eos_token_id] if self._add_eos else []
            return pre, post
        if p is None:
            return [], []
        if p.get("type") == "BertProcessing":
            return [p["cls"][1]], [p["sep"][1]]
        if p.get("type") != "TemplateProcessing":
            raise _refuse(path, f"post-processor {p.get('type')!r}")
        pre: list[int] = []
        post: list[int] = []
        seen_seq = False
        for item in p["single"]:
            if "Sequence" in item:
                seen_seq = True
            else:
                ids = p["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (post if seen_seq else pre).extend(ids)
        return pre, post

    def add_special_token(self, token: str) -> int:
        """Add `token` as a special token matched whole in raw text (an
        existing token keeps its id; a new one takes the next id) and return
        its id (transformers' add_tokens(special_tokens=True))."""
        if token in self._added:
            return self._added[token]
        tid = self.vocab.get(token)
        if tid is None:
            tid = self.vocab_size
        self._added[token] = tid
        self._special_ids.add(tid)
        self._id_to_token[tid] = token
        self._alts.append((token, False, False))
        self._set_added_pattern(self._alts)
        self.vocab_size = len(self._id_to_token)
        return tid

    def _opt_id(self, token: Optional[str]) -> Optional[int]:
        return None if token is None else self.convert_token_to_id(token)

    # -- encode ------------------------------------------------------------

    def _spans(self, text: str):
        """(start offset, text span or None, added id or None) in order."""
        pos = 0
        if self._added_re is not None:
            for m in self._added_re.finditer(text):
                if m.start() > pos:
                    yield pos, text[pos:m.start()], None
                token = next(g for g in m.groups() if g is not None)
                yield m.start(), None, self._added[token]
                pos = m.end()
        if pos < len(text):
            yield pos, text[pos:], None

    def _words(self, span: str, at_start: bool) -> list[str]:
        for step in self._normalizers:
            if step[0] == "bert":
                span = _bert_normalize(span, *step[1:])
            elif step[0] == "collapse":
                span = _collapse_spaces(span)
            elif step[0] == "prepend":
                span = step[1] + span if span else span
            else:
                span = span.replace(step[1], step[2])
        if self._metaspace is None:
            return [span] if span else []
        if self._metaspace == ("bert",):
            return _bert_split(span)
        rep, scheme, split = self._metaspace
        span = span.replace(" ", rep)
        if not span.startswith(rep) and (scheme == "always" or (scheme == "first" and at_start)):
            span = rep + span
        if not split:
            return [span] if span else []
        return [w for w in re.split(f"(?={re.escape(rep)})", span) if w]

    def _wordpiece_ids(self, word: str) -> list[int]:
        """Greedy longest-match-first over the word's characters."""
        unk = [self.vocab[self._unk]]
        if len(word) > self._wp_max_chars:
            return unk
        ids, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                piece = word[start:end] if start == 0 else self._wp_prefix + word[start:end]
                cur = self.vocab.get(piece)
                if cur is not None:
                    break
                end -= 1
            if cur is None:
                return unk
            ids.append(cur)
            start = end
        return ids

    def _bpe(self, word: str) -> list[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self._ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        ids: list[int] = []
        unk_open = False  # the last symbol is a fusable unk
        for ch in word:
            tid = self.vocab.get(ch)
            if tid is not None:
                ids.append(tid)
                unk_open = False
                continue
            if self._byte_fallback:
                bts = [self.vocab.get(f"<0x{b:02X}>") for b in ch.encode("utf-8")]
                if all(b is not None for b in bts):
                    ids.extend(bts)
                    unk_open = False
                    continue
            if self._unk is not None:
                if not (self._fuse_unk and unk_open):
                    ids.append(self.vocab[self._unk])
                unk_open = True
        ranks = self._ranks
        while len(ids) > 1:
            best = None
            for i in range(len(ids) - 1):
                r = ranks.get((ids[i], ids[i + 1]))
                if r is not None and (best is None or r[0] < best[0]):
                    best = (r[0], i, r[1])
            if best is None:
                break
            _, i, new = best
            ids[i: i + 2] = [new]
        if len(self._cache) >= _CACHE_MAX:
            self._cache.clear()
        self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        ids: list[int] = []
        for start, span, added in self._spans(text):
            if added is not None:
                ids.append(added)
                continue
            for word in self._words(span, start == 0):
                ids.extend(self._wordpiece_ids(word) if self._wordpiece else self._bpe(word))
        if add_special_tokens:
            pre, post = self._template
            ids = pre + ids + post
        return ids

    # -- decode ------------------------------------------------------------

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        if isinstance(ids, int):
            ids = [ids]
        tokens = []
        for i in ids:
            i = int(i)
            t = self._id_to_token.get(i)
            if t is None or (skip_special_tokens and i in self._special_ids):
                continue
            tokens.append(t)
        if self._decoders is None:
            text = " ".join(tokens)
        else:
            for step in self._decoders:
                tokens = _DECODE[step[0]](tokens, *step[1:])
            text = "".join(tokens)
        return _clean_up(text) if self._clean_up else text

    def convert_token_to_id(self, token: str) -> int:
        tid = self._added.get(token, self.vocab.get(token))
        return self.unk_token_id if tid is None else tid


def _byte_fallback(tokens: Sequence[str]) -> list[str]:
    """Runs of <0xXX> tokens become their UTF-8 text, or one U+FFFD per
    byte when the run is not valid UTF-8."""
    out: list[str] = []
    run = bytearray()

    def flush():
        if run:
            try:
                out.append(run.decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" * len(run))
            run.clear()

    for t in tokens:
        m = _BYTE.match(t) if len(t) == 6 else None
        if m:
            run.append(int(m.group(1), 16))
        else:
            flush()
            out.append(t)
    flush()
    return out


def _is_control(c: str) -> bool:
    return c not in "\t\n\r" and unicodedata.category(c).startswith("C")


def _is_chinese(c: str) -> bool:
    cp = ord(c)
    return any(lo <= cp <= hi for lo, hi in (
        (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF), (0x2A700, 0x2B73F),
        (0x2B740, 0x2B81F), (0x2B920, 0x2CEAF), (0xF900, 0xFAFF), (0x2F800, 0x2FA1F)))


def _bert_normalize(text: str, clean: bool, chinese: bool, strip_accents: bool,
                    lower: bool) -> str:
    """tokenizers' BertNormalizer, its steps in its order."""
    if clean:
        text = "".join(" " if c.isspace() else c for c in text
                       if not (c in "\x00\ufffd" or _is_control(c)))
    if chinese:
        text = "".join(f" {c} " if _is_chinese(c) else c for c in text)
    if strip_accents:
        text = "".join(c for c in unicodedata.normalize("NFD", text)
                       if unicodedata.category(c) != "Mn")
    return text.lower() if lower else text


def _is_punct(c: str) -> bool:
    o = ord(c)
    ascii_punct = 33 <= o <= 47 or 58 <= o <= 64 or 91 <= o <= 96 or 123 <= o <= 126
    return ascii_punct or unicodedata.category(c).startswith("P")


def _bert_split(text: str) -> list[str]:
    """tokenizers' BertPreTokenizer: whitespace splits and is dropped,
    every punctuation character is a word of its own."""
    words, cur = [], []
    for c in text:
        if c.isspace():
            if cur:
                words.append("".join(cur))
                cur = []
        elif _is_punct(c):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(c)
        else:
            cur.append(c)
    if cur:
        words.append("".join(cur))
    return words


def _wordpiece_decode(tokens: Sequence[str], prefix: str, cleanup: bool) -> list[str]:
    """tokenizers' WordPiece decoder: a continuing piece loses its prefix
    and joins the previous one, any other piece after the first gets a
    space; `cleanup` undoes the tokenization spaces piece by piece."""
    out = []
    for i, t in enumerate(tokens):
        if i:
            t = t.replace(prefix, "", 1) if t.startswith(prefix) else " " + t
        if cleanup:
            for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                         (" n't", "n't"), (" 'm", "'m"), (" do not", " don't"), (" 's", "'s"),
                         (" 've", "'ve"), (" 're", "'re")):
                t = t.replace(a, b)
        out.append(t)
    return out


def _strip(tokens: Sequence[str], content: str, start: int, stop: int) -> list[str]:
    out = []
    for t in tokens:
        lo, hi = 0, len(t)
        while lo < min(start, len(t)) and t[lo] == content:
            lo += 1
        for _ in range(stop):
            if hi > lo and t[hi - 1] == content:
                hi -= 1
            else:
                break
        out.append(t[lo:hi])
    return out


_DECODE = {
    "replace": lambda tokens, a, b: [t.replace(a, b) for t in tokens],
    "bytefallback": _byte_fallback,
    "fuse": lambda tokens: ["".join(tokens)],
    "strip": _strip,
    "wordpiece": _wordpiece_decode,
}


def _clean_up(text: str) -> str:
    """transformers' clean_up_tokenization."""
    for a, b in ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
                 (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
                 (" 're", "'re")):
        text = text.replace(a, b)
    return text


def _collapse_spaces(text: str) -> str:
    """sentencepiece's remove_extra_whitespaces: no leading or trailing
    spaces, runs of spaces as one."""
    return re.sub(" +", " ", text).strip(" ")


# -- sentencepiece tokenizer.model --------------------------------------------

# sentencepiece_model.proto: SentencePiece.Type and TrainerSpec.ModelType
SPM_NORMAL, SPM_UNKNOWN, SPM_CONTROL, SPM_USER_DEFINED, SPM_UNUSED, SPM_BYTE = 1, 2, 3, 4, 5, 6
SPM_UNIGRAM, SPM_BPE = 1, 2


def _varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if b < 0x80:
            return out, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a protobuf message: an int for
    varints, bytes for length-delimited fields and fixed32 / fixed64."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _varint(buf, i)
        elif wire == 2:
            n, i = _varint(buf, i)
            val, i = buf[i:i + n], i + n
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        else:
            raise ValueError(f"protobuf wire type {wire} is not supported")
        yield num, wire, val


def read_sentencepiece(path: str) -> dict:
    """A sentencepiece ModelProto, by hand: {"pieces": [(piece, score,
    type)], "model_type", "byte_fallback", "unk_piece", "add_dummy_prefix",
    "remove_extra_whitespaces", "escape_whitespaces", "normalizer_name",
    "charsmap"} with the proto's defaults for absent fields."""
    import struct

    with open(path, "rb") as f:
        buf = f.read()
    out = {"pieces": [], "model_type": SPM_UNIGRAM, "byte_fallback": False, "unk_piece": "<unk>",
           "add_dummy_prefix": True, "remove_extra_whitespaces": True,
           "escape_whitespaces": True, "normalizer_name": "", "charsmap": b""}
    for num, _, val in _fields(buf):
        if num == 1:  # SentencePiece
            piece, score, kind = "", 0.0, SPM_NORMAL
            for n, _, v in _fields(val):
                if n == 1:
                    piece = v.decode("utf-8")
                elif n == 2:
                    score = struct.unpack("<f", v)[0]
                elif n == 3:
                    kind = v
            out["pieces"].append((piece, score, kind))
        elif num == 2:  # TrainerSpec
            for n, _, v in _fields(val):
                if n == 3:
                    out["model_type"] = v
                elif n == 35:
                    out["byte_fallback"] = bool(v)
                elif n == 45:
                    out["unk_piece"] = v.decode("utf-8")
        elif num == 3:  # NormalizerSpec
            for n, _, v in _fields(val):
                if n == 1:
                    out["normalizer_name"] = v.decode("utf-8")
                elif n == 2:
                    out["charsmap"] = v
                elif n == 3:
                    out["add_dummy_prefix"] = bool(v)
                elif n == 4:
                    out["remove_extra_whitespaces"] = bool(v)
                elif n == 5:
                    out["escape_whitespaces"] = bool(v)
    return out


def sentencepiece_spec(path: str) -> dict:
    """The tokenizer.json spec of a BPE tokenizer.model, as transformers'
    LlamaConverter (legacy layout) writes it; see the module note. A
    unigram model or a normalizer with a precompiled character map is
    refused by name."""
    m = read_sentencepiece(path)
    if m["model_type"] != SPM_BPE:
        raise _refuse(path, f"sentencepiece model_type {m['model_type']} (only BPE, 2)")
    if m["charsmap"] or m["normalizer_name"] not in ("", "identity"):
        raise _refuse(path, f"sentencepiece normalizer {m['normalizer_name']!r} with a "
                            "precompiled character map")
    pieces = m["pieces"]
    vocab = {p: i for i, (p, _, _) in enumerate(pieces)}
    # SentencePieceExtractor.extract: each piece's splits into two pieces,
    # by the parts' ids, then all merges by the merged piece's score
    merges = []
    for piece, score, _ in pieces:
        local = [(piece[:i], piece[i:], score) for i in range(1, len(piece))
                 if piece[:i] in vocab and piece[i:] in vocab]
        local.sort(key=lambda t: (vocab[t[0]], vocab[t[1]]))
        merges.extend(local)
    merges.sort(key=lambda t: t[2], reverse=True)
    normalizers = []
    if m["remove_extra_whitespaces"]:
        normalizers.append({"type": "SentencePieceCollapse"})
    if m["add_dummy_prefix"]:
        normalizers.append({"type": "Prepend", "prepend": "▁"})
    if m["escape_whitespaces"]:
        normalizers.append({"type": "Replace", "pattern": {"String": " "}, "content": "▁"})
    decoders = [{"type": "Replace", "pattern": {"String": "▁"}, "content": " "},
                {"type": "ByteFallback"}, {"type": "Fuse"}]
    if m["add_dummy_prefix"]:
        decoders.append({"type": "Strip", "content": " ", "start": 1, "stop": 0})
    added = [{"id": i, "content": p, "special": t == SPM_CONTROL, "normalized": False}
             for i, (p, _, t) in enumerate(pieces) if t in (SPM_CONTROL, SPM_USER_DEFINED)]
    return {
        "model": {"type": "BPE", "vocab": vocab, "merges": [[a, b] for a, b, _ in merges],
                  "unk_token": m["unk_piece"], "fuse_unk": True,
                  "byte_fallback": m["byte_fallback"]},
        "added_tokens": added,
        "normalizer": {"type": "Sequence", "normalizers": normalizers},
        "pre_tokenizer": None,
        "decoder": {"type": "Sequence", "decoders": decoders},
        "post_processor": None,
    }


# -- Qwen's qwen.tiktoken ------------------------------------------------------

QWEN_VOCAB_FILE = "qwen.tiktoken"
# Qwen-VL's tokenization_qwen.py: the specials follow the mergeable ranks
# (151,643 in the released file): <|endoftext|>, <|im_start|>, <|im_end|>,
# 205 <|extra_i|>, then the image / box / ref tags
QWEN_SPECIALS = (("<|endoftext|>", "<|im_start|>", "<|im_end|>")
                 + tuple(f"<|extra_{i}|>" for i in range(205))
                 + ("<ref>", "</ref>", "<box>", "</box>", "<quad>", "</quad>",
                    "<img>", "</img>", "<imgpad>"))
# Unicode White_Space, the \s of tiktoken's (Rust) regex engine
_WHITE_SPACE = "\t\n\x0b\x0c\r \x85\xa0\u1680\u2000-\u200a\u2028\u2029\u202f\u205f\u3000"


def _class_ranges(pred) -> str:
    """A regex character-class body for the code points where pred(category)."""
    out, start = [], None
    for cp in range(0x110001):
        inside = cp < 0x110000 and pred(unicodedata.category(chr(cp)))
        if inside and start is None:
            start = cp
        elif not inside and start is not None:
            out.append(f"\\U{start:08x}" if start == cp - 1
                       else f"\\U{start:08x}-\\U{cp - 1:08x}")
            start = None
    return "".join(out)


_QWEN_PAT: Optional[re.Pattern] = None


def qwen_pattern() -> re.Pattern:
    """Qwen's pre-tokenizer regex,
      (?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\\r\\n\\p{L}\\p{N}]?\\p{L}+|\\p{N}
      | ?[^\\s\\p{L}\\p{N}]+[\\r\\n]*|\\s*[\\r\\n]+|\\s+(?!\\S)|\\s+
    for Python's `re`, which has no \\p{L} / \\p{N}: the letter and number
    classes are spelled out from unicodedata's categories, and \\s is
    Unicode White_Space. Built once (a pass over every code point)."""
    global _QWEN_PAT
    if _QWEN_PAT is None:
        lt = _class_ranges(lambda c: c[0] == "L")
        nm = _class_ranges(lambda c: c[0] == "N")
        ws = _WHITE_SPACE
        _QWEN_PAT = re.compile(
            rf"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n{lt}{nm}]?[{lt}]+|[{nm}]"
            rf"| ?[^{ws}{lt}{nm}]+[\r\n]*|[{ws}]*[\r\n]+|[{ws}]+(?![^{ws}])|[{ws}]+")
    return _QWEN_PAT


class QwenTokenizer:
    """Qwen-VL's tokenizer from its `qwen.tiktoken` (one "base64-token
    rank" line per mergeable token): NFC normalization, the special
    tokens matched whole in raw text (all allowed, as Qwen's tokenize
    does), Qwen's pre-tokenizer regex, then byte-level BPE by rank
    (tiktoken's: a piece that is a token is one id; otherwise adjacent
    parts merge, lowest rank first, leftmost on ties). No BOS; EOS and pad
    are <|endoftext|> (Qwen's eod); decode drops the specials when asked
    (Qwen's `i < eod_id`) and replaces invalid UTF-8."""

    def __init__(self, path: str):
        import base64

        vocab_path = os.path.join(path, QWEN_VOCAB_FILE) if os.path.isdir(path) else path
        self.ranks: dict[bytes, int] = {}
        with open(vocab_path, "rb") as f:
            for line in f:
                if line.strip():
                    tok, rank = line.split()
                    self.ranks[base64.b64decode(tok)] = int(rank)
        self._bytes = {r: t for t, r in self.ranks.items()}
        n = len(self.ranks)
        self.specials = {t: n + i for i, t in enumerate(QWEN_SPECIALS)}
        self._inv_specials = {i: t for t, i in self.specials.items()}
        self.vocab_size = n + len(self.specials)
        self.eod_id = self.specials["<|endoftext|>"]
        self.bos_token_id = None
        self.eos_token_id = self.eod_id
        self.pad_token_id = self.eod_id
        self._special_re = re.compile(
            "|".join(re.escape(t) for t in sorted(self.specials, key=len, reverse=True)))
        self._cache: dict[bytes, list[int]] = {}

    @classmethod
    def from_pretrained(cls, path: str, **_kw) -> "QwenTokenizer":
        return cls(path)

    def _bpe(self, piece: bytes) -> list[int]:
        hit = self.ranks.get(piece)
        if hit is not None:
            return [hit]
        cached = self._cache.get(piece)
        if cached is not None:
            return cached
        parts = [piece[i:i + 1] for i in range(len(piece))]
        ranks = self.ranks
        while len(parts) > 1:
            best, at = None, -1
            for i in range(len(parts) - 1):
                r = ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best is None or r < best):
                    best, at = r, i
            if best is None:
                break
            parts[at: at + 2] = [parts[at] + parts[at + 1]]
        ids = [ranks[p] for p in parts]
        if len(self._cache) >= _CACHE_MAX:
            self._cache.clear()
        self._cache[piece] = ids
        return ids

    def _encode_ordinary(self, text: str) -> list[int]:
        ids: list[int] = []
        for m in qwen_pattern().finditer(text):
            ids.extend(self._bpe(m.group().encode("utf-8")))
        return ids

    def encode(self, text: str, add_special_tokens: bool = False) -> list[int]:
        del add_special_tokens  # Qwen adds no BOS / EOS
        text = unicodedata.normalize("NFC", text)
        ids: list[int] = []
        pos = 0
        for m in self._special_re.finditer(text):
            ids.extend(self._encode_ordinary(text[pos:m.start()]))
            ids.append(self.specials[m.group()])
            pos = m.end()
        ids.extend(self._encode_ordinary(text[pos:]))
        return ids

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        if isinstance(ids, int):
            ids = [ids]
        out = bytearray()
        for i in ids:
            i = int(i)
            if i in self._inv_specials:
                if not skip_special_tokens:
                    out += self._inv_specials[i].encode("utf-8")
            elif i in self._bytes:
                out += self._bytes[i]
        return out.decode("utf-8", errors="replace")

    def convert_token_to_id(self, token: str) -> int:
        if token in self.specials:
            return self.specials[token]
        rank = self.ranks.get(token.encode("utf-8"))
        if rank is None:
            raise KeyError(f"{token!r} is not a token of this qwen.tiktoken")
        return rank


def load_tokenizer(path: str):
    """A checkpoint directory's tokenizer: tokenizer.json or a
    sentencepiece tokenizer.model (JsonTokenizer), or qwen.tiktoken
    (QwenTokenizer)."""
    if not os.path.exists(os.path.join(path, "tokenizer.json")) and os.path.exists(
            os.path.join(path, QWEN_VOCAB_FILE)):
        return QwenTokenizer(path)
    return JsonTokenizer(path)
