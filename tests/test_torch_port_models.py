"""The port's CLIP text encoder and VAE against the JAX package's, through
the parameter bridge, plus the colour-guidance gradient against
``jax.grad``. Both sides float32 on the CPU; tolerances relative to the
output's scale, 1e-4 (float32 through the network, sums in another order;
max |d| seen ~1e-6 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from rich_text_to_image_tpu.models import config as C
from rich_text_to_image_tpu.models.clip import CLIPTextModel as JClip
from rich_text_to_image_tpu.models.init_utils import fast_init
from rich_text_to_image_tpu.models.vae import AutoencoderKL as JVae
from rich_text_to_image_tpu_torch import weights
from rich_text_to_image_tpu_torch.models.clip import CLIPTextModel as TClip
from rich_text_to_image_tpu_torch.models.vae import AutoencoderKL as TVae
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


def _close(got, want, rel=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rel * max(np.abs(want).max(), 1e-6))


def _vae_pair(seed=1):
    jv = JVae(C.TINY_VAE)
    params = fast_init(jv, seed, jnp.zeros((1, 16, 16, 3)))
    tv = weights.load_flax(TVae(C.TINY_VAE),
                           jax.tree.map(np.asarray, params), "vae")
    return jv, params, tv


def test_clip_text_matches_jax():
    jc = JClip(C.TINY_TEXT)
    params = fast_init(jc, 2, jnp.zeros((1, 77), jnp.int32))
    tc = weights.load_flax(TClip(C.TINY_TEXT),
                           jax.tree.map(np.asarray, params), "text")
    ids = np.random.default_rng(0).integers(0, 1000, (2, 77)).astype(np.int32)
    want = jc.apply(params, jnp.asarray(ids))
    with torch.no_grad():
        got = tc(torch.from_numpy(ids).long())
    for key in ("last_hidden_state", "penultimate", "pooled"):
        _close(got[key], want[key])


def test_vae_decode_and_encode_match_jax():
    jv, params, tv = _vae_pair()
    rng = np.random.default_rng(1)
    z = rng.standard_normal((2, 8, 8, 4)).astype(np.float32)
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    with torch.no_grad():
        dec, enc = tv.decode(torch.from_numpy(z)), tv.encode(
            torch.from_numpy(img))
    _close(dec, jv.apply(params, jnp.asarray(z), method=jv.decode))
    _close(enc, jv.apply(params, jnp.asarray(img), method=jv.encode))


def test_color_loss_gradient_matches_jax_grad():
    """The colour-guidance gradient through the VAE decode: the port's
    ``torch.autograd.grad`` against ``jax.grad`` of the same loss
    (region_sd.py's ``color_loss``), on the same latent, noise and masks."""
    from rich_text_to_image_tpu_torch.pipelines.region_sd import RegionDiffusion

    jv, params, tv = _vae_pair(4)
    rng = np.random.default_rng(5)
    lat = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    masks = (rng.random((2, 16, 16)) > 0.5).astype(np.float32)
    target = np.array([[1.0, 0.0, 0.0], [0.1, 0.2, 0.9]], np.float32)
    a, sf = 0.3, C.TINY_VAE.scaling_factor

    def loss_j(l):
        x0 = (l - noise * jnp.sqrt(1 - a)) / jnp.sqrt(a)
        imgs = jv.apply(params, x0 / sf, method=jv.decode)
        imgs = jnp.clip(imgs / 2 + 0.5, 0.0, 1.0)
        num = jnp.einsum("bhwc,nhw->nc", imgs, masks)
        den = masks.sum(axis=(1, 2))[:, None] + 1e-12
        return (jnp.mean((num / den - target) ** 2, axis=1) * 100.0).sum()

    want = jax.grad(loss_j)(jnp.asarray(lat))

    pipe = RegionDiffusion.__new__(RegionDiffusion)  # only the VAE is used
    pipe.vae, pipe.vae_cfg = tv.requires_grad_(False), C.TINY_VAE
    color = dict(masks_px=torch.from_numpy(masks),
                 target_rgb=torch.from_numpy(target),
                 all=torch.ones((1, 8, 8, 1)), weight=1.0, ds=1, vae=tv)
    got = lat - pipe._guided(torch.from_numpy(lat), torch.from_numpy(noise),
                             a, color).numpy()
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0
