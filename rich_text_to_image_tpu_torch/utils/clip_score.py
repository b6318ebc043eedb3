"""CLIP image-text scorer (reference utils/clip_utils.py:46-81).

Counterpart of ``rich_text_to_image_tpu/utils/clip_score.py``: the cosine
similarity of CLIP's projected image and text embeddings, which the style
benchmark takes on mask-composited region crops.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import weights
from ..models.clip import CLIPTextModel
from ..models.clip_vision import CLIPVisionModel, preprocess_images
from ..models.config import (CLIP_VIT_B32_VISION, CLIPTextConfig,
                             CLIPVisionConfig)
from ..models.tokenizer import CLIPTokenizer

# the text tower of CLIP ViT-B/32
CLIP_VIT_B32_TEXT = CLIPTextConfig(
    hidden_size=512, intermediate_size=2048, num_hidden_layers=12,
    num_attention_heads=8, projection_dim=512)


class CLIPScorer:
    """``get_clip_score(image, text)`` -> cosine similarity (float32)."""

    def __init__(self, text_model: CLIPTextModel,
                 vision_model: CLIPVisionModel, tokenizer: CLIPTokenizer,
                 device="cuda"):
        self.device = torch.device(device)
        self.text_model = text_model.to(self.device).eval().requires_grad_(
            False)
        self.vision_model = vision_model.to(self.device).eval(
        ).requires_grad_(False)
        self.tokenizer = tokenizer
        self.image_size = vision_model.cfg.image_size

    @classmethod
    def from_pretrained(cls, clip_dir: str, device="cuda"):
        """Load a local directory in the layout of HF's
        ``clip-vit-base-patch32``: ``*.safetensors`` holding both towers
        and their projections (``text_model.*``, ``text_projection``,
        ``vision_model.*``, ``visual_projection``), and the tokenizer's
        ``vocab.json`` / ``merges.txt``."""
        sd = weights.load_safetensors_dir(clip_dir)
        text = CLIPTextModel(CLIP_VIT_B32_TEXT)
        vision = CLIPVisionModel(CLIP_VIT_B32_VISION)
        for mod, prefixes in ((text, ("text_model.", "text_projection.")),
                              (vision, ("vision_model.",
                                        "visual_projection."))):
            part = {k: v for k, v in sd.items() if k.startswith(prefixes)
                    and not k.endswith("position_ids")}
            mod.load_state_dict(part, strict=True)
        return cls(text, vision, CLIPTokenizer.from_pretrained(clip_dir),
                   device)

    @classmethod
    def random_init(cls, seed: int = 0,
                    text_cfg: CLIPTextConfig | None = None,
                    vision_cfg: CLIPVisionConfig | None = None,
                    tokenizer: CLIPTokenizer | None = None, device="cuda"):
        """Random weights (``weights.random_init``), at the JAX package's
        default sizes: a ViT-B/32 vision tower and a ViT-L-width text
        tower projected to 512."""
        tokenizer = tokenizer or CLIPTokenizer.byte_level()
        text_cfg = text_cfg or CLIPTextConfig(
            vocab_size=max(1000, len(tokenizer.encoder)), projection_dim=512)
        vision_cfg = vision_cfg or CLIPVisionConfig()
        text = weights.random_init(CLIPTextModel(text_cfg), seed)
        vision = weights.random_init(CLIPVisionModel(vision_cfg), seed + 1)
        return cls(text, vision, tokenizer, device)

    @torch.no_grad()
    def get_clip_score(self, image, text: str) -> float:
        """image: [H,W,3] or [B,H,W,3], uint8 or float; the mean cosine
        over the batch."""
        img = np.asarray(image)
        if img.ndim == 3:
            img = img[None]
        pixels = preprocess_images(img, self.image_size, self.device)
        ids = torch.from_numpy(self.tokenizer([text] * pixels.shape[0])
                               .astype(np.int64)).to(self.device)
        v = self.vision_model(pixels)["projected"]
        t = self.text_model(ids, eos_token_id=self.tokenizer.eos_token_id)
        t = t.get("projected", t["pooled"])
        v = v / v.norm(dim=-1, keepdim=True)
        t = t / t.norm(dim=-1, keepdim=True)
        return float((v * t).sum(-1).mean())
