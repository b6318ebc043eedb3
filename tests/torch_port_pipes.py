"""The JAX package's tiny SD pipeline and the port's on the same parameters
(float32, CPU), shared by the ``test_torch_port_*`` files that hold whole
passes against each other."""

import jax
import jax.numpy as jnp
import numpy as np

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.pipelines import region_sd as JP
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
from rich_text_to_image_tpu_torch.models.unet import UNet2DCondition
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL
from rich_text_to_image_tpu_torch.pipelines import region_sd as TP


def port_of(jp, **kw):
    """The port's RegionDiffusion on the JAX pipeline ``jp``'s parameters."""
    tree = lambda p: jax.tree.map(np.asarray, p)
    return TP.RegionDiffusion(
        weights.load_flax(UNet2DCondition(jp.unet_cfg),
                          tree(jp.unet_params), "unet"),
        weights.load_flax(AutoencoderKL(jp.vae_cfg),
                          tree(jp.vae_params), "vae"),
        weights.load_flax(CLIPTextModel(jp.text_encoder.cfg),
                          tree(jp.text_params), "text"),
        CLIPTokenizer.byte_level(), jp.unet_cfg, jp.vae_cfg, device="cpu",
        **kw)


def tiny_pipes(agg_start_step: int = 3):
    """(JAX pipeline, port pipeline) at TINY_UNET / TINY_VAE / TINY_TEXT."""
    jp = JP.RegionDiffusion.random_init(
        seed=0, unet_cfg=C.TINY_UNET, vae_cfg=C.TINY_VAE,
        text_cfg=C.TINY_TEXT, dtype=jnp.float32,
        agg_start_step=agg_start_step)
    return jp, port_of(jp, agg_start_step=agg_start_step)


def close(got, want, rel=1e-4):
    """|got - want| <= rel * max|want| everywhere."""
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))
