"""The port's bfloat16 guidance VAE against the JAX package's, on the
trained colour fixture's VAE and the same numpy inputs: the decode, and
the colour-guidance gradient through it (the port's ``_color_loss``
against the JAX loss of ``region_sd.py``'s guided step).

The port decodes through a bfloat16 copy of the VAE
(``RegionDiffusion._guidance_vae(True)``: bf16 weights and activations);
the JAX package through ``AutoencoderKL(dtype=bfloat16)`` (float32
parameters, bf16 compute). The float32 decodes agree within 1e-4 of scale.
In bfloat16 each side rounds in its own order, so the bound is what bf16
itself moves the JAX package's outputs: the port's bf16 against JAX's bf16
within 1.5 times JAX's own bf16-against-float32 gap, for the decode and for
the gradient. On these inputs (the CPU): JAX's gap 8.6e-3 (decode) and
9.0e-2 (gradient) of scale, the port against JAX 1.2e-2 and 5.2e-2; the
same VAE under ``torch.autocast`` (float32 weights, bf16 compute, as JAX
computes) gave 9.8e-3 and 5.2e-2, no closer, so the copy stays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.evaluation.fixtures import load_color_fixture
from rich_text_to_image_tpu.models.vae import AutoencoderKL as JVAE
from torch_port_pipes import port_of
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

A = 0.5
TARGET = np.asarray([1.0, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def setup():
    jp = load_color_fixture()
    h = jp.unet_cfg.sample_size
    px = h * jp.vae_scale_factor
    rng = np.random.default_rng(0)
    lat, noise = rng.standard_normal((2, 1, h, h, 4)).astype(np.float32)
    mask = (rng.uniform(size=(px, px)) > 0.5).astype(np.float32)
    return jp, port_of(jp), lat, noise, mask


def _jax(jp, bf16, lat, noise, mask):
    """(images, gradient of the colour loss) of the JAX package's VAE."""
    vae = JVAE(jp.vae_cfg, dtype=jnp.bfloat16 if bf16 else jnp.float32)

    def decode(z):
        imgs = vae.apply(jp.vae_params, z.astype(jnp.float32)
                         / jp.vae_cfg.scaling_factor, method=vae.decode)
        return jnp.clip(imgs / 2 + 0.5, 0.0, 1.0)

    def loss(x):
        x0 = (x - jnp.asarray(noise) * jnp.sqrt(1 - A)) / jnp.sqrt(A)
        m = jnp.asarray(mask)
        avg = jnp.einsum("bhwc,hw->c", decode(x0), m) / (m.sum() + 1e-12)
        return jnp.mean((avg - TARGET) ** 2) * 100.0

    return (np.asarray(decode(jnp.asarray(lat)), np.float32),
            np.asarray(jax.grad(loss)(jnp.asarray(lat))))


def _port(tp, bf16, lat, noise, mask, autocast=False):
    """(images, gradient of the colour loss) of the port's guidance VAE;
    with ``autocast`` the float32 VAE under ``torch.autocast`` to bfloat16
    (float32 weights, bf16 compute: the JAX package's way), for
    comparison."""
    h, w = lat.shape[1:3]
    px = mask.shape[0]
    color = tp._color_inputs(
        {"color_obj_atten": [mask], "target_RGB": [TARGET],
         "color_obj_atten_all": np.ones((h, w), np.float32)},
        px, px, h, w, 1, bf16, 1.0)
    with torch.autocast("cpu", dtype=torch.bfloat16, enabled=autocast):
        with torch.no_grad():
            img = tp._decode_imgs(torch.from_numpy(lat), color["vae"]).float()
        x = torch.from_numpy(lat).requires_grad_(True)
        (grad,) = torch.autograd.grad(
            tp._color_loss(x, torch.from_numpy(noise), A, color), x)
    return img.numpy(), grad.numpy()


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_fp32_guidance_vae_matches_jax(setup):
    jp, tp, *inp = setup
    for got, want in zip(_port(tp, False, *inp), _jax(jp, False, *inp)):
        assert _rel(got, want) <= 1e-4


def test_bf16_guidance_vae_within_bf16_rounding_of_jax(setup):
    jp, tp, *inp = setup
    want32, want16 = _jax(jp, False, *inp), _jax(jp, True, *inp)
    got16 = _port(tp, True, *inp)
    auto = _port(tp, False, *inp, autocast=True)
    assert tp._guidance_vae(True).decoder.conv_in.weight.dtype == (
        torch.bfloat16)
    for what, g, a, w16, w32 in zip(("decode", "gradient"), got16, auto,
                                    want16, want32):
        gap, diff = _rel(w16, w32), _rel(g, w16)
        print(f"{what}: port bf16 against JAX bf16 {diff:.3e} of scale "
              f"(under autocast {_rel(a, w16):.3e}); JAX bf16 against JAX "
              f"fp32 {gap:.3e}")
        assert 0 < diff <= 1.5 * gap, (what, diff, gap)
