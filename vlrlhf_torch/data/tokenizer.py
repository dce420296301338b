"""Tokenizer seam (copy of vlrlhf_tpu/data/tokenizer.py's ToyTokenizer — the
deterministic word-level tokenizer the hermetic paths use)."""

from __future__ import annotations

import re
import zlib


class ToyTokenizer:
    """Deterministic word-level tokenizer for hermetic runs.

    Splits on whitespace + punctuation; each distinct word hashes into the
    vocab. Special tokens occupy the bottom of the id space."""

    def __init__(self, vocab_size: int = 4096):
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
