"""The port's tiled and sliced VAE decodes against the JAX package's.

Both packages decode the same latents with the same tiny VAE (the JAX
parameters mapped into the port) and the same tile sizes: the tiles, the
edge padding, the seam blending and the crop must agree. Tolerance: 1e-4
of the image's scale, float32 decodes whose sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models import vae_tiling as J
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu.models.vae import AutoencoderKL as JVae
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models import vae_tiling as T
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL as TVae
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

SCALE = 2  # TINY_VAE halves once


@pytest.fixture(scope="module")
def decoders():
    jv = JVae(C.TINY_VAE)
    params = fast_init(jv, 7, jnp.zeros((1, 16, 16, 3)))
    tv = weights.load_flax(TVae(C.TINY_VAE), jax.tree.map(np.asarray, params),
                           "vae")
    jdec = jax.jit(lambda z: jv.apply(params, z, method=jv.decode))

    def tdec(z):
        with torch.no_grad():
            return tv.decode(z)

    return (lambda z: np.asarray(jdec(jnp.asarray(z)))), tdec


def _close(got, want, rel=1e-4):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("h,w,tile", [(20, 20, 8), (13, 22, 8), (8, 8, 8),
                                      (17, 9, 12)])
def test_tiled_decode_matches_jax(decoders, h, w, tile):
    jdec, tdec = decoders
    z = np.random.default_rng(h * w).standard_normal((2, h, w, 4)).astype(
        np.float32)
    want = J.tiled_decode(jdec, z, tile_latent=tile, scale=SCALE)
    got = T.tiled_decode(tdec, torch.from_numpy(z), tile_latent=tile,
                         scale=SCALE)
    assert got.shape == want.shape == (2, h * SCALE, w * SCALE, 3)
    _close(got.numpy(), want)


def test_sliced_decode_matches_jax(decoders):
    jdec, tdec = decoders
    z = np.random.default_rng(3).standard_normal((3, 8, 8, 4)).astype(
        np.float32)
    want = J.sliced_decode(jdec, z)
    got = T.sliced_decode(tdec, torch.from_numpy(z))
    _close(got.numpy(), want)
    _close(T.sliced_decode(tdec, torch.from_numpy(z[:1])).numpy(), want[:1])
