"""CLIP vision transformer (ViT-B/32) in PyTorch, for the style
benchmark's CLIP score.

Counterpart of ``rich_text_to_image_tpu/models/clip_vision.py``, with the
module names of the transformers ``CLIPVisionModelWithProjection`` state
dict (``vision_model.embeddings.patch_embedding``,
``vision_model.pre_layrnorm``, ``vision_model.encoder.layers.{i}...``,
``visual_projection``), so that a CLIP checkpoint loads as it is. The encoder layers are the text tower's
(``models/clip.py``) without the causal mask. Runs in float32; its
attention is plain PyTorch, as the JAX tower's is outside any Pallas
kernel.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.resize import resize_bicubic
from .clip import CLIPEncoder
from .config import CLIPTextConfig, CLIPVisionConfig

# OpenAI CLIP preprocessing constants (reference clip_utils.py:15-17)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


class CLIPVisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.position_embedding = nn.Embedding(
            (cfg.image_size // cfg.patch_size) ** 2 + 1, d)


class CLIPVisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = CLIPVisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size,
                                         eps=cfg.layer_norm_eps)
        self.encoder = CLIPEncoder(CLIPTextConfig(
            hidden_size=cfg.hidden_size,
            intermediate_size=cfg.intermediate_size,
            num_hidden_layers=cfg.num_hidden_layers,
            num_attention_heads=cfg.num_attention_heads,
            hidden_act=cfg.hidden_act, layer_norm_eps=cfg.layer_norm_eps))
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size,
                                           eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_model = CLIPVisionTransformer(cfg)
        self.visual_projection = nn.Linear(cfg.hidden_size,
                                           cfg.projection_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> dict:
        """pixels: normalized NHWC [B, H, W, 3] -> {"pooled" [B, D],
        "projected" [B, P]}."""
        vm = self.vision_model
        emb = vm.embeddings
        x = emb.patch_embedding(pixels.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2)  # [B, patches, D], row-major
        cls = emb.class_embedding[None, None].expand(x.shape[0], 1, -1)
        x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None]
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x, 0.0)
        pooled = vm.post_layernorm(x[:, 0])
        return {"pooled": pooled, "projected": self.visual_projection(pooled)}


def preprocess_images(images, image_size: int = 224,
                      device=None) -> torch.Tensor:
    """uint8 or float [B, H, W, 3] -> CLIP-normalized float32 [B, S, S, 3]
    (S = ``image_size``): values above 2 are taken as 0..255, a bicubic
    antialiased resize to S² where the size differs (the reference resizes
    then center-crops; for square inputs the crop is the identity), then
    the CLIP mean and std."""
    x = torch.as_tensor(np.asarray(images), dtype=torch.float32,
                        device=device)
    if x.max() > 2.0:
        x = x / 255.0
    if x.shape[1] != image_size or x.shape[2] != image_size:
        x = resize_bicubic(x.permute(0, 3, 1, 2),
                           (image_size, image_size)).permute(0, 2, 3, 1)
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std
