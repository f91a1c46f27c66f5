"""CLIP byte-level BPE tokenizer over the repository's vocabulary file.

Counterpart of ``cris_tpu.utils.tokenizer`` with the standard library
only: the word pattern uses ``re`` in place of the ``regex`` package.
CLIP's ``[\\p{L}]+`` becomes ``[^\\W\\d_]+`` (letters), ``[\\p{N}]``
becomes ``\\d`` and ``[^\\s\\p{L}\\p{N}]+`` becomes ``(?:[^\\s\\w]|_)+``;
these agree on the corpora's text (letters, decimal digits, punctuation
and symbols) and differ only on rare non-decimal numerals such as
superscripts. Text is NFC-normalized, as ``cris_tpu`` does without ftfy.
"""

from __future__ import annotations

import functools
import gzip
import html
import re
import unicodedata
from pathlib import Path
from typing import List, Sequence, Union

import numpy as np

# read by path; importing the JAX package would import jax
VOCAB_PATH = (Path(__file__).resolve().parents[2] / "cris_tpu" / "utils"
              / "bpe_simple_vocab_16e6.txt.gz")

_WORD_PATTERN = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
    re.IGNORECASE,
)


@functools.lru_cache()
def byte_unicode_table():
    """Invertible byte -> printable unicode character mapping (GPT-2/CLIP):
    printable latin bytes map to themselves, the others to 256 + n."""
    keep = (list(range(ord("!"), ord("~") + 1))
            + list(range(ord("\xa1"), ord("\xac") + 1))
            + list(range(ord("\xae"), ord("\xff") + 1)))
    out = {b: chr(b) for b in keep}
    shifted = 0
    for b in range(256):
        if b not in out:
            out[b] = chr(256 + shifted)
            shifted += 1
    return out


def _clean_text(text: str) -> str:
    text = unicodedata.normalize("NFC", text)
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


class ClipBPETokenizer:
    SOT = "<|startoftext|>"
    EOT = "<|endoftext|>"

    def __init__(self):
        self.byte_encoder = byte_unicode_table()
        with gzip.open(VOCAB_PATH) as f:
            merge_lines = f.read().decode("utf-8").split("\n")
        # CLIP's slice: skip the header, keep the merges of a 49,408 vocab
        merges = [tuple(line.split())
                  for line in merge_lines[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab += [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [self.SOT, self.EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {self.SOT: self.SOT, self.EOT: self.EOT}

    @property
    def sot_token(self) -> int:
        return self.encoder[self.SOT]

    @property
    def eot_token(self) -> int:
        return self.encoder[self.EOT]

    def _bpe(self, token: str) -> str:
        cached = self._cache.get(token)
        if cached is not None:
            return cached
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        result = " ".join(word)
        self._cache[token] = result
        return result

    def encode(self, text: str) -> List[int]:
        tokens: List[int] = []
        for word in _WORD_PATTERN.findall(_clean_text(text).lower()):
            word = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            tokens.extend(self.encoder[p] for p in self._bpe(word).split(" "))
        return tokens


@functools.lru_cache()
def get_tokenizer() -> ClipBPETokenizer:
    return ClipBPETokenizer()


def tokenize(texts: Union[str, Sequence[str]], context_length: int = 77,
             truncate: bool = False) -> np.ndarray:
    """Texts -> (N, context_length) int32 ids: SOT + BPE + EOT, zero-padded;
    when truncating, the last kept token is forced to EOT."""
    if isinstance(texts, str):
        texts = [texts]
    tk = get_tokenizer()
    result = np.zeros((len(texts), context_length), dtype=np.int32)
    for i, text in enumerate(texts):
        tokens = [tk.sot_token] + tk.encode(text) + [tk.eot_token]
        if len(tokens) > context_length:
            if not truncate:
                raise ValueError(f"Input {text!r} is too long for context "
                                 f"length {context_length}")
            tokens = tokens[:context_length]
            tokens[-1] = tk.eot_token
        result[i, : len(tokens)] = tokens
    return result
