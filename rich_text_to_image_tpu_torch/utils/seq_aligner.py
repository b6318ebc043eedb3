"""Token-sequence alignment for the prompt-to-prompt baseline (numpy).

A copy of ``rich_text_to_image_tpu/utils/seq_aligner.py``; the tests hold
the two equal.

Builds the Refine mapper: for each position of the *edited* prompt's token
sequence, the position of the matching token in the *base* sequence (and an
alpha of 1), or its own position (alpha 0) for tokens that only exist in the
edit. Matches the behavioral contract of the vendored Needleman-Wunsch
aligner the reference benchmarks use (utils/seq_aligner.py /
ptp_utils.py:30-142); implemented here with difflib's longest-contiguous-
match alignment, which agrees on the word-insertion/replacement edits the
benchmarks perform.
"""

from __future__ import annotations

import difflib

import numpy as np


def get_word_inds(prompt: str, word: str, tokenizer) -> np.ndarray:
    """Token positions (1-based, after BOS) of every occurrence of ``word``
    in ``prompt`` (ptp_utils.get_word_inds contract)."""
    words = prompt.replace(",", " ,").split(" ")
    out = []
    pos = 1  # BOS occupies 0
    for w in words:
        toks = tokenizer._tokenize(w)
        if w.strip(".,!?").lower() == word.strip(".,!?").lower():
            out.extend(range(pos, pos + len(toks)))
        pos += len(toks)
    return np.asarray(out, dtype=np.int32)


def _word_inds_by_place(prompt: str, place: int, tokenizer) -> np.ndarray:
    """Token positions (1-based, after BOS) of the ``place``-th
    whitespace-word of ``prompt`` (ptp seq_aligner.get_word_inds with an int
    word_place, utils/seq_aligner.py:130-150)."""
    words = prompt.split(" ")
    out = []
    pos = 1  # BOS occupies 0
    for i, w in enumerate(words):
        n = len(tokenizer._tokenize(w))
        if i == place:
            out.extend(range(pos, pos + n))
        pos += n
    return np.asarray(out, dtype=np.int64)


def get_replacement_mapper(
    base_prompt: str, edited_prompt: str, tokenizer, max_len: int = 77
) -> np.ndarray:
    """AttentionReplace mapper for word-swap edits.

    Returns a ``[max_len, max_len]`` float32 matrix ``M`` with
    ``edited_probs = base_probs @ M`` — the semantics of the reference's
    vendored ptp mapper (utils/seq_aligner.py:153-187): positions outside
    swapped words map identically; an equal-length swap maps source tokens to
    target tokens pairwise; an *unequal*-length swap redistributes every
    source token's column fractionally, weight ``1/len(target)`` per target
    token. The post-swap tail reproduces the reference's ``mapper[j, j] = 1``
    indexing verbatim (quirk parity: rows stay diagonal-aligned to the edited
    index even when lengths diverged).
    """
    words_x = base_prompt.split(" ")
    words_y = edited_prompt.split(" ")
    if len(words_x) != len(words_y):
        raise ValueError("AttentionReplace requires equal word counts; "
                         "use AttentionRefine for insertions/deletions")
    inds_replace = [i for i in range(len(words_y)) if words_y[i] != words_x[i]]
    inds_source = [_word_inds_by_place(base_prompt, i, tokenizer)
                   for i in inds_replace]
    inds_target = [_word_inds_by_place(edited_prompt, i, tokenizer)
                   for i in inds_replace]
    mapper = np.zeros((max_len, max_len), dtype=np.float32)
    i = j = 0
    cur = 0
    while i < max_len and j < max_len:
        if cur < len(inds_source) and inds_source[cur][0] == i:
            src, tgt = inds_source[cur], inds_target[cur]
            # clamp to the matrix (long prompts can place a swapped word's
            # tokens past max_len; the reference's 1-D path bounds writes
            # by range(min(len, max_len - pos)) — seq_aligner.py:96-142)
            src_c = [s for s in src if s < max_len]
            tgt_c = [t for t in tgt if t < max_len]
            if src_c and tgt_c:
                if len(src_c) == len(tgt_c):
                    mapper[src_c, tgt_c] = 1.0
                else:
                    ratio = 1.0 / len(tgt_c)
                    for t in tgt_c:
                        mapper[src_c, t] = ratio
            cur += 1
            i += len(src)
            j += len(tgt)
        elif cur < len(inds_source):
            mapper[i, j] = 1.0
            i += 1
            j += 1
        else:
            mapper[j, j] = 1.0
            i += 1
            j += 1
    return mapper


def get_refinement_mapper(
    base_ids: np.ndarray, edited_ids: np.ndarray, max_len: int = 77
) -> tuple[np.ndarray, np.ndarray]:
    """(mapper [max_len] int32, alphas [max_len] float32).

    mapper[j] = index into the base sequence whose attention column the
    edited position j should inherit; alphas[j] = 1 where inherited.
    """
    base = np.asarray(base_ids).reshape(-1).tolist()[:max_len]
    edit = np.asarray(edited_ids).reshape(-1).tolist()[:max_len]
    sm = difflib.SequenceMatcher(a=base, b=edit, autojunk=False)
    mapper = np.arange(max_len, dtype=np.int32)
    alphas = np.zeros(max_len, dtype=np.float32)
    for block in sm.get_matching_blocks():
        for k in range(block.size):
            j = block.b + k
            if j < max_len:
                mapper[j] = block.a + k
                alphas[j] = 1.0
    return mapper, alphas
