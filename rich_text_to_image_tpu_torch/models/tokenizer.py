"""Self-contained CLIP BPE tokenizer (the port's own copy).

Implements the CLIP tokenization algorithm (byte-level BPE with ``</w>``
end-of-word markers, lowercasing, whitespace normalization) from scratch so
the framework has zero dependency on downloaded tokenizer assets. Vocab and
merges load from the ``vocab.json`` / ``merges.txt`` files inside any Stable
Diffusion checkpoint directory; a deterministic built-in byte-level vocab
(zero merges) backs the test suite.

API parity notes: the rich-text front end maps span tokens into base-prompt
positions via the sub-word token list (reference:
utils/richtext_utils.py:146 uses ``tokenizer._tokenize``); we expose the same
``_tokenize`` plus a ``__call__`` that pads to ``model_max_length`` (77).
"""

from __future__ import annotations

import functools
import json
import os
from typing import Sequence

import re

import numpy as np

# The CLIP pattern ``[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+`` rewritten for the
# stdlib ``re`` module, which has no Unicode property classes: a letter is a
# word character that is neither a digit nor ``_`` (``[^\W\d_]``), a number
# is ``\d``, and the rest is anything neither space nor word character, or
# ``_``. The two agree on every letter and decimal digit; they differ only on
# non-decimal numerics such as ``²`` or ``½``, which ``\p{N}`` counts as
# numbers and ``\w`` as letters.
_PAT = re.compile(
    r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+""",
    re.IGNORECASE,
)
_WHITESPACE = re.compile(r"\s+")


@functools.lru_cache()
def bytes_to_unicode() -> dict[int, str]:
    """GPT-2/CLIP reversible byte → printable-unicode mapping."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple[str, ...]) -> set[tuple[str, str]]:
    return set(zip(word[:-1], word[1:]))


class CLIPTokenizer:
    """Byte-level BPE with ``</w>`` end-of-word closure, CLIP-style."""

    bos_token = "<|startoftext|>"
    eos_token = "<|endoftext|>"
    model_max_length = 77

    def __init__(
        self,
        vocab: dict[str, int],
        merges: Sequence[tuple[str, str]],
        pad_token: str | None = None,
        use_native: bool = True,
    ):
        self.encoder = dict(vocab)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        # the C++ merge loop (native/), built at first use; where it cannot
        # be built the Python loop below runs, with the same ids
        self._native = None
        if use_native and merges:
            from ..native import NativeBPE, load_bpe_lib

            if load_bpe_lib() is not None:
                self._native = NativeBPE([tuple(m) for m in merges])
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.cache: dict[str, str] = {
            self.bos_token: self.bos_token,
            self.eos_token: self.eos_token,
        }
        self.bos_token_id = self.encoder[self.bos_token]
        self.eos_token_id = self.encoder[self.eos_token]
        pad_token = pad_token if pad_token is not None else self.eos_token
        self.pad_token_id = self.encoder[pad_token]

    # ------------------------------------------------------------ construction
    @classmethod
    def from_pretrained(cls, path: str, pad_token: str | None = None) -> "CLIPTokenizer":
        """Load from a directory holding vocab.json + merges.txt.

        Accepts either the tokenizer subfolder itself or a checkpoint root
        containing ``tokenizer/``.
        """
        for sub in ("", "tokenizer"):
            d = os.path.join(path, sub)
            if os.path.exists(os.path.join(d, "vocab.json")):
                path = d
                break
        with open(os.path.join(path, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(path, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        # First line is the "#version" header; trailing blanks dropped.
        merges = [
            tuple(line.split()) for line in lines[1:] if line and not line.isspace()
        ]
        return cls(vocab, merges, pad_token=pad_token)

    @classmethod
    def byte_level(cls, pad_token: str | None = None) -> "CLIPTokenizer":
        """Deterministic built-in vocab: all byte units ± </w>, zero merges.

        Valid CLIP-BPE behavior (every word splits into characters, last one
        carrying ``</w>``); used for tests and weight-free smoke runs.
        """
        units = list(bytes_to_unicode().values())
        vocab: dict[str, int] = {}
        for u in units:
            vocab[u] = len(vocab)
        for u in units:
            vocab[u + "</w>"] = len(vocab)
        vocab[cls.bos_token] = len(vocab)
        vocab[cls.eos_token] = len(vocab)
        return cls(vocab, [], pad_token=pad_token)

    # -------------------------------------------------------------------- bpe
    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        if self._native is not None:
            out = self._native(token)
            self.cache[token] = out
            return out
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: list[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    # ------------------------------------------------------------------- api
    def _tokenize(self, text: str) -> list[str]:
        """Sub-word token strings (HF ``CLIPTokenizer._tokenize`` parity)."""
        text = _WHITESPACE.sub(" ", text).strip().lower()
        bpe_tokens: list[str] = []
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            bpe_tokens.extend(self._bpe(token).split(" "))
        return bpe_tokens

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> list[int]:
        return [self.encoder[t] for t in tokens]

    def encode(self, text: str) -> list[int]:
        """BOS + bpe ids + EOS, truncated to model_max_length."""
        ids = self.convert_tokens_to_ids(self._tokenize(text))
        ids = ids[: self.model_max_length - 2]
        return [self.bos_token_id, *ids, self.eos_token_id]

    def __call__(self, texts: str | Sequence[str]) -> np.ndarray:
        """Tokenize + pad to (batch, 77) int32, HF padding='max_length' parity."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full(
            (len(texts), self.model_max_length), self.pad_token_id, dtype=np.int32
        )
        for row, text in enumerate(texts):
            ids = self.encode(text)
            out[row, : len(ids)] = ids
        return out

    def decode(self, ids: Sequence[int]) -> str:
        tokens = [self.decoder[int(i)] for i in ids]
        text = "".join(
            t for t in tokens if t not in (self.bos_token, self.eos_token)
        )
        data = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return (
            data.decode("utf-8", errors="replace").replace("</w>", " ").strip()
        )
