"""CLIP text encoders (SD-1.5's ViT-L/14 text tower, SDXL's two) in PyTorch.

Counterpart of ``rich_text_to_image_tpu/models/clip.py``, with the module
names of the transformers ``CLIPTextModel`` state dict
(``text_model.encoder.layers.{i}.self_attn.q_proj`` ...; the projected
tower's ``text_projection`` beside ``text_model``, as in
``CLIPTextModelWithProjection``). Runs in float32, by the precision policy.

Output of ``forward``:
  last_hidden_state [B, 77, D] — after the final layer norm,
  penultimate       [B, 77, D] — the input of the last layer,
  pooled            [B, D]     — the last hidden state at each row's EOS,
  projected         [B, P]     — with ``projection_dim`` set (SDXL's second
                                 tower), ``pooled`` through the bias-free
                                 ``text_projection``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .config import CLIPTextConfig

_ACTS = {
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "gelu": lambda x: F.gelu(x),  # HF "gelu" = exact erf
}


class CLIPAttention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x, mask):
        B, S, D = x.shape
        hd = D // self.heads

        def split(t):
            return t.view(B, S, self.heads, hd).transpose(1, 2)

        q = split(self.q_proj(x) * hd ** -0.5)
        k = split(self.k_proj(x))
        v = split(self.v_proj(x))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k).float() + mask
        p = torch.softmax(s, dim=-1).to(x.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", p, v)
        return self.out_proj(o.transpose(1, 2).reshape(B, S, D))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.act = _ACTS[cfg.hidden_act]
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.layer_norm1 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(d, cfg.num_attention_heads)
        self.layer_norm2 = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, mask):
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class CLIPEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList(
            [CLIPEncoderLayer(cfg) for _ in range(cfg.num_hidden_layers)])


class CLIPEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class CLIPTextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = CLIPEmbeddings(cfg)
        self.encoder = CLIPEncoder(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)


class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.cfg = cfg
        self.text_model = CLIPTextTransformer(cfg)
        if cfg.projection_dim is not None:
            self.text_projection = nn.Linear(cfg.hidden_size,
                                             cfg.projection_dim, bias=False)

    def forward(self, input_ids: torch.Tensor,
                eos_token_id: int | None = None) -> dict:
        tm = self.text_model
        B, S = input_ids.shape
        x = (tm.embeddings.token_embedding(input_ids)
             + tm.embeddings.position_embedding.weight[None, :S])
        # causal mask (CLIP text towers are causal)
        mask = torch.triu(torch.full((S, S), float("-inf"),
                                     device=input_ids.device), diagonal=1)
        penultimate = None
        layers = tm.encoder.layers
        for i, layer in enumerate(layers):
            if i == len(layers) - 1:
                penultimate = x
            x = layer(x, mask[None, None])
        last = tm.final_layer_norm(x)
        # pooled = hidden at EOS: first argmax of ids == eos, else the ids'
        # max value (original CLIP)
        if eos_token_id is None:
            eos_pos = input_ids.argmax(dim=-1)
        else:
            eos_pos = (input_ids == eos_token_id).int().argmax(dim=-1)
        pooled = last[torch.arange(B, device=last.device), eos_pos]
        out = {"last_hidden_state": last, "penultimate": penultimate,
               "pooled": pooled}
        if self.cfg.projection_dim is not None:
            out["projected"] = self.text_projection(pooled)
        return out
