"""T5 v1.1's encoder (FLUX.1's ``text_encoder_2``, google/t5-v1_1-xxl) in
PyTorch, with the layout of transformers' ``T5EncoderModel``
(``shared``, ``encoder.block.{i}.layer.0.SelfAttention.{q,k,v,o}``,
``encoder.block.0.layer.0.SelfAttention.relative_attention_bias``,
``encoder.block.{i}.layer.1.DenseReluDense.{wi_0,wi_1,wo}``, RMS
``layer_norm``s, ``encoder.final_layer_norm``).

As FluxPipeline runs it: 512 tokens, padded, no attention mask. The first
layer's bucketed relative position bias is added to the scores of every
layer, which are not scaled by 1/sqrt(d). The attention is plain (a score
bias is no input of the package's kernels); it runs once a prompt.

The stand-in tokenizer (:class:`T5ByteTokenizer`) is the package's
byte-level BPE units (no vocabulary file is in the repository), each unit's
id moved past T5's pad (0), end (1) and unknown (2) ids; a row is the
units, the end id, then pads.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .config import T5EncoderConfig
from .tokenizer import CLIPTokenizer

PAD_ID, EOS_ID, UNIT_OFFSET = 0, 1, 3


class T5ByteTokenizer:
    """The T5 stand-in: ``_tokenize`` is the byte-level BPE's (every byte
    a unit), with no start token, so a 1-based span id i is position i - 1
    of the row."""

    first_token = 0  # the row position of the first unit

    def __init__(self, max_length: int = 512):
        self.units = CLIPTokenizer.byte_level()
        self.model_max_length = max_length

    def _tokenize(self, text: str) -> list[str]:
        return self.units._tokenize(text)

    def encode(self, text: str) -> list[int]:
        ids = [i + UNIT_OFFSET for i in
               self.units.convert_tokens_to_ids(self._tokenize(text))]
        return ids[: self.model_max_length - 1] + [EOS_ID]

    def __call__(self, texts) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), self.model_max_length), PAD_ID, np.int64)
        for row, text in enumerate(texts):
            ids = self.encode(text)
            out[row, :len(ids)] = ids
        return out


class T5LayerNorm(nn.Module):
    """RMS norm without a mean or bias, computed in float32, cast to the
    weight's dtype before the scale (transformers' ``T5LayerNorm``)."""

    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(self.weight.dtype)


def relative_buckets(q_len: int, k_len: int, num_buckets: int,
                     max_distance: int, device) -> torch.Tensor:
    """The bidirectional bucket of each (query, key) offset, [q, k]."""
    rel = (torch.arange(k_len, device=device)[None, :]
           - torch.arange(q_len, device=device)[:, None])
    nb = num_buckets // 2
    out = (rel > 0).long() * nb
    rel = rel.abs()
    exact = nb // 2
    large = exact + (torch.log(rel.float() / exact)
                     / math.log(max_distance / exact)
                     * (nb - exact)).long()
    large = torch.clamp(large, max=nb - 1)
    return out + torch.where(rel < exact, rel, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5EncoderConfig, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.heads, self.d_kv = cfg.num_heads, cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        self.cfg = cfg
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads,
                _weight=torch.empty(cfg.relative_attention_num_buckets,
                                    cfg.num_heads))

    def position_bias(self, s: int, device) -> torch.Tensor:
        c = self.cfg
        b = relative_buckets(s, s, c.relative_attention_num_buckets,
                             c.relative_attention_max_distance, device)
        return self.relative_attention_bias(b).permute(2, 0, 1)[None]

    def forward(self, x, bias):
        B, S, _ = x.shape

        def split(t):
            return t.view(B, S, self.heads, self.d_kv).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() + bias.float()
        p = torch.softmax(s, dim=-1).to(v.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        return self.o(o.transpose(1, 2).reshape(B, S, -1))


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg, has_bias):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _DenseGatedGelu(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        return self.wo(F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x))


class _FFLayer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.DenseReluDense = _DenseGatedGelu(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg, has_bias):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias),
                                    _FFLayer(cfg)])

    def forward(self, x, bias):
        a, f = self.layer
        x = x + a.SelfAttention(a.layer_norm(x), bias)
        return x + f.DenseReluDense(f.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon)


class T5EncoderModel(nn.Module):
    def __init__(self, cfg: T5EncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model,
                                   _weight=torch.empty(cfg.vocab_size,
                                                       cfg.d_model))
        self.encoder = _Stack(cfg)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        """ids [B, S] -> the last hidden states [B, S, d_model]."""
        x = self.shared(input_ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(
            input_ids.shape[1], input_ids.device)
        for blk in blocks:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
