"""Model architecture configs (SD-1.5, SDXL, FLUX.1-dev, and tiny test
variants).

Config values mirror the HF checkpoint configs the reference loads
(runwayml/stable-diffusion-v1-5, stabilityai/stable-diffusion-xl-base-1.0 —
reference: models/region_diffusion.py:24-37,
models/region_diffusion_sdxl.py:105-127); the module code is architected
fresh for TPU (NHWC layouts, functional controls).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


# --------------------------------------------------------------------- UNet
@dataclasses.dataclass(frozen=True)
class UNetConfig:
    sample_size: int = 64
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    # per-level block kinds, bottom of the U last
    down_block_types: Sequence[str] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Sequence[str] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    layers_per_block: int = 2
    # transformer depth per level (index-aligned with down_block_types)
    transformer_layers_per_block: Sequence[int] = (1, 1, 1, 1)
    attention_head_dim: Sequence[int] = (8, 8, 8, 8)  # SD1.5: heads, not dim
    num_attention_heads: Sequence[int] | None = None  # if set, overrides
    cross_attention_dim: int = 768
    use_linear_projection: bool = False
    norm_num_groups: int = 32
    freq_shift: int = 0
    flip_sin_to_cos: bool = True
    # SDXL micro-conditioning
    addition_embed_type: str | None = None  # "text_time" for SDXL
    addition_time_embed_dim: int = 256
    projection_class_embeddings_input_dim: int = 2816
    # dual cross-attention (versatile-diffusion-style): every attention
    # block runs TWO transformer streams over a concatenated condition
    # sequence, mixing their residual deltas. Mirrors the reference's
    # DualTransformer2DModel capability (models/dual_transformer_2d.py:21-151)
    # — unused by the SD-1.5/SDXL configs, kept for checkpoint families
    # that set diffusers' ``dual_cross_attention=True``.
    dual_cross_attention: bool = False
    dual_condition_lengths: Sequence[int] = (77, 257)
    dual_transformer_index: Sequence[int] = (1, 0)
    dual_mix_ratio: float = 0.5

    @property
    def heads_per_level(self) -> tuple[int, ...]:
        """Number of attention heads at each level.

        diffusers quirk: SD-1.5 stores heads in ``attention_head_dim``;
        SDXL sets ``num_attention_heads`` implicitly via head_dim=64.
        """
        if self.num_attention_heads is not None:
            return tuple(self.num_attention_heads)
        return tuple(self.attention_head_dim)

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


SD15_UNET = UNetConfig()

SDXL_UNET = UNetConfig(
    sample_size=128,
    block_out_channels=(320, 640, 1280),
    down_block_types=(
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ),
    up_block_types=(
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ),
    transformer_layers_per_block=(0, 2, 10),
    attention_head_dim=(5, 10, 20),
    num_attention_heads=(5, 10, 20),
    cross_attention_dim=2048,
    use_linear_projection=True,
    addition_embed_type="text_time",
)

# Tiny config for fast tests: same topology as SD-1.5, minimal widths.
TINY_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(32, 64, 64, 64),
    attention_head_dim=(2, 2, 2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
)

# Slimmer TINY variant for the committed *trained* color fixture
# (tests/fixtures/color_fixture): same topology/depths as TINY_UNET so the
# layer registry and capture resolutions line up, quarter the params so the
# fp16 checkpoint stays ~2 MB in git and trains in minutes.
FIXTURE_UNET = UNetConfig(
    sample_size=8,
    block_out_channels=(16, 32, 32, 32),
    attention_head_dim=(2, 2, 2, 2),
    cross_attention_dim=32,
    norm_num_groups=8,
)

# Tiny SDXL-topology config (text_time conditioning, linear projections).
TINY_XL_UNET = UNetConfig(
    sample_size=16,
    block_out_channels=(32, 64, 64),
    down_block_types=(
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    ),
    up_block_types=(
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "UpBlock2D",
    ),
    transformer_layers_per_block=(0, 1, 2),
    attention_head_dim=(2, 2, 2),
    num_attention_heads=(2, 2, 2),
    cross_attention_dim=64,
    use_linear_projection=True,
    norm_num_groups=8,
    addition_embed_type="text_time",
    addition_time_embed_dim=8,
    projection_class_embeddings_input_dim=8 * 6 + 64,
)


# ---------------------------------------------------------------------- VAE
@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Sequence[int] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215
    # FLUX.1's VAE: latents are (z - shift) * scale, and it has no 1x1
    # quant convs around the latent
    shift_factor: float = 0.0
    use_quant_conv: bool = True
    use_post_quant_conv: bool = True


SD15_VAE = VAEConfig()
SDXL_VAE = VAEConfig(scaling_factor=0.13025)
TINY_VAE = VAEConfig(
    block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=8,
    scaling_factor=0.18215,
)
FLUX_VAE = VAEConfig(latent_channels=16, scaling_factor=0.3611,
                     shift_factor=0.1159, use_quant_conv=False,
                     use_post_quant_conv=False)
TINY_FLUX_VAE = dataclasses.replace(
    FLUX_VAE, block_out_channels=(16, 32), layers_per_block=1,
    norm_num_groups=8)


# --------------------------------------------------------------------- CLIP
@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int | None = None  # set → WithProjection variant


SD15_TEXT = CLIPTextConfig()
SDXL_TEXT = SD15_TEXT  # OpenAI ViT-L/14 text tower
SDXL_TEXT_2 = CLIPTextConfig(
    hidden_size=1280,
    intermediate_size=5120,
    num_hidden_layers=32,
    num_attention_heads=20,
    hidden_act="gelu",
    projection_dim=1280,
)
TINY_TEXT = CLIPTextConfig(
    vocab_size=1000,
    hidden_size=32,
    intermediate_size=64,
    num_hidden_layers=2,
    num_attention_heads=2,
)


# --------------------------------------------------------------- CLIP vision
@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 32
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    hidden_act: str = "quick_gelu"
    layer_norm_eps: float = 1e-5
    projection_dim: int = 512


CLIP_VIT_B32_VISION = CLIPVisionConfig()


# -------------------------------------------------------------------- FLUX.1
@dataclasses.dataclass(frozen=True)
class FluxConfig:
    """``FluxTransformer2DModel`` (black-forest-labs/FLUX.1-dev,
    transformer/config.json): 19 double-stream blocks (image and text with
    their own weights, one joint attention), 38 single-stream blocks, 24
    heads of 128, 2x2 patches of the 16-channel latent (64 inputs)."""

    in_channels: int = 64
    num_layers: int = 19
    num_single_layers: int = 38
    attention_head_dim: int = 128
    num_attention_heads: int = 24
    joint_attention_dim: int = 4096
    pooled_projection_dim: int = 768
    guidance_embeds: bool = True
    axes_dims_rope: Sequence[int] = (16, 56, 56)

    @property
    def inner_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim


FLUX_DEV = FluxConfig()
TINY_FLUX = FluxConfig(num_layers=1, num_single_layers=2,
                       attention_head_dim=32, num_attention_heads=2,
                       joint_attention_dim=32, pooled_projection_dim=32,
                       axes_dims_rope=(8, 12, 12))


@dataclasses.dataclass(frozen=True)
class T5EncoderConfig:
    """T5 v1.1's encoder (google/t5-v1_1-xxl, FLUX.1's text_encoder_2):
    gated GELU (tanh) feed-forward, RMS layer norms, a bucketed relative
    position bias computed by the first layer and shared by all, no 1/sqrt(d)
    on the scores, untied head (the encoder has none)."""

    vocab_size: int = 32128
    d_model: int = 4096
    d_kv: int = 64
    d_ff: int = 10240
    num_layers: int = 24
    num_heads: int = 64
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    max_length: int = 512  # FluxPipeline's max_sequence_length


T5_XXL = T5EncoderConfig()
TINY_T5 = T5EncoderConfig(vocab_size=600, d_model=32, d_kv=8, d_ff=64,
                          num_layers=2, num_heads=4, max_length=128)
# FLUX.1's text_encoder: CLIP ViT-L/14's text tower, read for its pooled row
FLUX_CLIP = SD15_TEXT
TINY_FLUX_CLIP = dataclasses.replace(TINY_TEXT, hidden_size=32)
