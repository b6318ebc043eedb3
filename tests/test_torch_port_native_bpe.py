"""The port's C++ merge loop (``native/bpe.cpp``) against its Python one,
the JAX test's three cases (``tests/test_native_bpe.py``), and the port's
token ids against the JAX package's tokenizer on one merge table. The
library is built with ``g++`` at first use; where the compiler is missing
the tests skip, as the JAX package's do.
"""

import random
import shutil

import pytest

from rich_text_to_image_tpu.models.tokenizer import (
    CLIPTokenizer as JTokenizer)
from rich_text_to_image_tpu_torch import native
from rich_text_to_image_tpu_torch.models.tokenizer import (CLIPTokenizer,
                                                           bytes_to_unicode)


@pytest.fixture(autouse=True)
def needs_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the native merge loop cannot build")
    assert native.load_bpe_lib() is not None, native.load_error()


def _vocab(merges):
    units = list(bytes_to_unicode().values())
    vocab = {}
    for u in units:
        vocab[u] = len(vocab)
    for u in units:
        vocab[u + "</w>"] = len(vocab)
    for m in merges:
        vocab.setdefault("".join(m), len(vocab))
    vocab["<|startoftext|>"] = len(vocab)
    vocab["<|endoftext|>"] = len(vocab)
    return vocab


def _tokenizers(merges):
    vocab = _vocab(merges)
    nat = CLIPTokenizer(vocab, merges, use_native=True)
    py = CLIPTokenizer(vocab, merges, use_native=False)
    assert nat._native is not None and py._native is None
    return nat, py


def _random_merges(rng, letters, n=40):
    symbols = letters + [c + "</w>" for c in letters]
    merges = []
    for _ in range(n):
        a, b = rng.choice(symbols), rng.choice(symbols)
        if (a, b) not in merges and not a.endswith("</w>"):
            merges.append((a, b))
            if not b.endswith("</w>"):
                symbols.append(a + b)
    return merges


def test_simple_merges():
    merges = [("c", "a"), ("ca", "t</w>"), ("t", "h"), ("th", "e</w>")]
    nat, py = _tokenizers(merges)
    for text in ["the cat", "cats that chat", "ca ca ca"]:
        assert nat._tokenize(text) == py._tokenize(text), text


def test_random_merge_tables():
    rng = random.Random(0)
    letters = list("abcdefgh")
    nat, py = _tokenizers(_random_merges(rng, letters))
    for _ in range(60):
        word = "".join(rng.choice(letters) for _ in range(rng.randint(1, 12)))
        assert nat._tokenize(word) == py._tokenize(word), word


def test_multibyte_utf8():
    nat, py = _tokenizers([("c", "a")])
    for text in ["école", "ça va", "naïve"]:
        assert nat._tokenize(text) == py._tokenize(text), text


def test_ids_equal_the_jax_tokenizer():
    rng = random.Random(1)
    letters = list("abcdefghij")
    merges = _random_merges(rng, letters, 60)
    vocab = _vocab(merges)
    nat = CLIPTokenizer(vocab, merges)  # native by default
    jax_tok = JTokenizer(vocab, merges, use_native=False)
    texts = ["".join(rng.choice(letters + [" "]) for _ in range(30))
             for _ in range(20)] + ["a cat, école 42!"]
    assert (nat(texts) == jax_tok(texts)).all()
