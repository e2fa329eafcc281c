"""Byte-level BPE tokenizer for CLIP text inputs.

Re-implements the tokenizer behavior CLIP expects (parity target:
reference ``models/clip/tokenizer.py:62-140``): byte-level BPE over the
standard OpenAI merge table, word-final ``</w>`` marker, special tokens
``<|startoftext|>`` / ``<|endoftext|>``, lowercased whitespace-cleaned text.

The merge table is shipped as ``assets/clip_bpe_merges.txt.gz`` (the public
OpenAI CLIP merge list — data, not code). Unlike the reference this module
caches encodes, exposes a vectorized ``tokenize_batch`` returning a numpy
int32 array ready for device upload, and has no ftfy dependency (graceful
fallback when unavailable).
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Iterable, List, Union

import numpy as np

try:  # pragma: no cover - optional dependency
    import regex as _re
except ImportError:  # pragma: no cover
    import re as _re  # type: ignore

try:  # pragma: no cover - optional dependency
    import ftfy as _ftfy
except ImportError:  # pragma: no cover
    _ftfy = None

_ASSET = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "clip_bpe_merges.txt.gz")

SOT_TOKEN = "<|startoftext|>"
EOT_TOKEN = "<|endoftext|>"
CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408


@functools.lru_cache()
def bytes_to_unicode():
    """Standard GPT-2 reversible byte <-> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _clean_text(text: str) -> str:
    if _ftfy is not None:
        text = _ftfy.fix_text(text)
    text = html.unescape(html.unescape(text))
    text = _re.sub(r"\s+", " ", text)
    return text.strip().lower()


def _word_pairs(word):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


class ClipTokenizer:
    """Encoder/decoder over the CLIP BPE vocabulary."""

    def __init__(self, merges_path: str = None):
        merges_path = merges_path or _ASSET
        with gzip.open(merges_path, "rt", encoding="utf-8") as f:
            merge_lines = [ln for ln in f.read().split("\n") if ln]
        merges = [tuple(ln.split()) for ln in merge_lines]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}

        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for merge in merges:
            vocab.append("".join(merge))
        vocab.extend([SOT_TOKEN, EOT_TOKEN])
        assert len(vocab) == VOCAB_SIZE, len(vocab)

        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._bpe_cache = {SOT_TOKEN: SOT_TOKEN, EOT_TOKEN: EOT_TOKEN}
        self.sot = self.encoder[SOT_TOKEN]
        self.eot = self.encoder[EOT_TOKEN]

        self._pat = _re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
            if _re.__name__ == "regex" else
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+""",
            _re.IGNORECASE,
        )

    # -- BPE core ----------------------------------------------------------
    def _bpe(self, token: str) -> str:
        cached = self._bpe_cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _word_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1 << 30))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _word_pairs(word)
        out = " ".join(word)
        self._bpe_cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens: List[int] = []
        for token in self._pat.findall(_clean_text(text)):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self._bpe(token).split(" "))
        return bpe_tokens

    def decode(self, tokens: Iterable[int]) -> str:
        text = "".join(self.decoder[int(t)] for t in tokens)
        raw = bytearray(self.byte_decoder[c] for c in text)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")


_DEFAULT: ClipTokenizer = None


def default_tokenizer() -> ClipTokenizer:
    global _DEFAULT
    if _DEFAULT is None:
        _DEFAULT = ClipTokenizer()
    return _DEFAULT


def tokenize(texts: Union[str, List[str]],
             context_length: int = CONTEXT_LENGTH,
             truncate: bool = True) -> np.ndarray:
    """Tokenize text(s) into a fixed-shape ``(N, context_length)`` int32 array.

    Matches the reference framing (``models/adapter_clip.py:43-74``):
    ``<sot> tokens... <eot>`` zero-padded to the context length, truncating
    overlong inputs while keeping the trailing ``<eot>``.
    """
    if isinstance(texts, str):
        texts = [texts]
    tk = default_tokenizer()
    out = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        toks = [tk.sot] + tk.encode(text) + [tk.eot]
        if len(toks) > context_length:
            if not truncate:
                raise RuntimeError(
                    f"input {text!r} too long for context {context_length}")
            toks = toks[:context_length]
            toks[-1] = tk.eot
        out[i, :len(toks)] = toks
    return out
