"""The port's batched text-to-image path (``RegionDiffusion
.text_to_images``) against the JAX package's, after
``tests/test_batched.py``.

Both tiny pipelines in float32 on the CPU. The port draws its latents with
``draw_latents`` (a torch generator); here that function is patched to
return the JAX package's draw for the seed, so both sides start from the
same N latents. Both decodes are replaced by the identity, so that the
final latents [N, h, w, 4] are compared, within 1e-4 of their scale (PNDM,
5 UNet calls of 2N rows).
"""

import jax
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu_torch.pipelines import region_sd as TP
from torch_port_pipes import close, tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

PROMPTS = ["a cat", "a dog on a hill", "a bird"]
STEPS, PX, SEED = 4, 16, 4


def jax_draw(shape, seed, device):
    return torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(seed), tuple(shape)))).to(device)


@pytest.fixture(scope="module")
def pipes():
    jp, tp = tiny_pipes()
    jp.decode_latents = lambda lat: np.asarray(lat)
    tp.decode_latents = lambda lat: lat.numpy()
    return jp, tp


@pytest.mark.parametrize("stride,schedule", [(1, "early"), (2, "early"),
                                             (2, "uniform")])
def test_text_to_images_matches_jax(pipes, monkeypatch, stride, schedule):
    jp, tp = pipes
    monkeypatch.setattr(TP, "draw_latents", jax_draw)
    kw = dict(height=PX, width=PX, num_inference_steps=STEPS, seed=SEED,
              guidance_scale=7.5, encoder_reuse=stride,
              encoder_schedule=schedule)
    want = jp.text_to_images(PROMPTS, **kw)
    got = tp.text_to_images(PROMPTS, **kw)
    assert got.shape == want.shape == (3, 8, 8, 4)
    close(got, want)
    assert np.abs(got[0] - got[1]).max() > 1e-3


def test_batch_row_matches_plain_pass(pipes, monkeypatch):
    """Row i of the batch is the plain CFG loop of prompt i from row i's
    latent (``_plain_loop``)."""
    _, tp = pipes
    monkeypatch.setattr(TP, "draw_latents", jax_draw)
    got = tp.text_to_images(PROMPTS, height=PX, width=PX,
                            num_inference_steps=STEPS, seed=SEED,
                            guidance_scale=7.5)
    lat = jax_draw((3, 8, 8, 4), SEED, "cpu")
    for i in (0, 2):
        single, *_ = tp._plain_loop(lat[i:i + 1], tp.get_text_embeds(
            [PROMPTS[i]], [""]), STEPS, 7.5)
        close(got[i:i + 1], single.numpy())
