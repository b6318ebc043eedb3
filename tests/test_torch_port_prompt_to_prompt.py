"""The prompt-to-prompt baseline in the port against the JAX package: the
token aligner (``utils/seq_aligner.py``) and ``PromptToPromptPipeline
.generate`` under Refine, Replace, the equalizer (AttentionReweight) and
LocalBlend, after ``tests/test_prompt_to_prompt.py`` and
``test_local_blend.py``. The UNet controls it runs on (``inject_cross`` with
a gather and a matrix ``cross_mapper``, ``cross_mix``, ``cross_full``, with
the font-size weights and signs) are held against JAX's in
``test_torch_port_injection.py``, ``test_torch_port_unet.py`` and
``test_torch_port_pipeline.py``.

The aligner is numpy on both sides: equal arrays. ``generate`` runs both
tiny pipelines in float32 on the CPU from the same numpy latent; both
decodes are replaced by the identity so that the final latents [2, h, w, 4]
(base, edited) are compared, within 1e-4 of their scale (5 PNDM calls of
two forwards each).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.pipelines import prompt_to_prompt as JPP
from rich_text_to_image_tpu.utils import seq_aligner as JSA
from rich_text_to_image_tpu_torch.models.tokenizer import CLIPTokenizer
from rich_text_to_image_tpu_torch.pipelines import prompt_to_prompt as TPP
from rich_text_to_image_tpu_torch.utils import seq_aligner as TSA
from torch_port_pipes import close, tiny_pipes
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

PAIRS = [
    ("a cat on a table", "a dog on a table"),
    ("a cat on a table", "a tiger on a table"),
    ("a zebra in snow", "a ox in snow"),
    ("a cat and a dog here", "a pig and a hen here"),
    ("same words here", "same words here"),
]


@pytest.mark.parametrize("base,edit", PAIRS)
def test_replacement_mapper_equals_jax(base, edit):
    tok = CLIPTokenizer.byte_level()
    np.testing.assert_array_equal(TSA.get_replacement_mapper(base, edit, tok),
                                  JSA.get_replacement_mapper(base, edit, tok))


@pytest.mark.parametrize("base,edit", PAIRS + [
    ("a cat", "a red cat"), ("a photo of a car", "a photo of a red car"),
    ("a cat on a mat", "a big red dog on a mat")])
def test_refinement_mapper_and_word_inds_equal_jax(base, edit):
    tok = CLIPTokenizer.byte_level()
    b, e = tok(base)[0], tok(edit)[0]
    for got, want in zip(TSA.get_refinement_mapper(b, e),
                         JSA.get_refinement_mapper(b, e)):
        np.testing.assert_array_equal(got, want)
    for word in set(base.split()) | set(edit.split()) | {"cat."}:
        np.testing.assert_array_equal(TSA.get_word_inds(edit, word, tok),
                                      JSA.get_word_inds(edit, word, tok))


STEPS, PX = 4, 16


@pytest.fixture(scope="module")
def pipes():
    jp, tp = tiny_pipes()
    # the final latents, not the images: both decodes become the identity
    jp.decode_latents = lambda lat: np.asarray(lat)
    tp.decode_latents = lambda lat: lat.numpy()
    lat = np.random.default_rng(2).standard_normal((1, 8, 8, 4)).astype(
        np.float32)
    return jp, tp, lat


EQ = np.ones(77, np.float32)
EQ[[3, 4, 5]] = [2.0, 0.5, -1.0]


@pytest.mark.parametrize("base,edit,kw", [
    ("a cat on a mat", "a red cat on a mat", {}),
    ("a cat runs", "a tiger runs", dict(controller="replace")),
    ("a cat on a mat", "a red cat on a mat", dict(equalizer=EQ)),
    ("a cat on a mat", "a red cat on a mat",
     dict(blend_words=("cat", "cat"), blend_threshold=0.3)),
], ids=["refine", "replace", "equalizer", "local_blend"])
def test_generate_matches_jax(pipes, base, edit, kw):
    jp, tp, lat = pipes
    common = dict(num_inference_steps=STEPS, height=PX, width=PX, seed=1)
    want = JPP.PromptToPromptPipeline(jp).generate(
        base, edit, latents=jnp.asarray(lat), **common, **kw)
    got = TPP.PromptToPromptPipeline(tp).generate(
        base, edit, latents=lat, **common, **kw)
    assert got.shape == want.shape == (2, 8, 8, 4)
    close(got, want)
    # the edit moved the edited row away from the base row
    assert np.abs(got[1] - got[0]).max() > 1e-3


def test_blend_mask_matches_jax_nearest_resize():
    """LocalBlend's mask at a level coarser than the latent: the 3x3
    max-pool and JAX's nearest resize (half-pixel centres) on a 4x4 map
    taken to 8x8 and to 12x12."""
    import jax

    rng = np.random.default_rng(0)
    probs = rng.uniform(size=(1, 2, 16, 77)).astype(np.float32)
    alpha = np.zeros(77, np.float32)
    alpha[[2, 3]] = 1.0
    for hw in ((8, 8), (12, 12)):
        got = TPP._blend_mask([torch.from_numpy(probs)],
                              torch.from_numpy(alpha), 4, hw).numpy()
        sel = (probs.mean(1)[0] * alpha).sum(-1).reshape(1, 4, 4, 1)
        pooled = jax.lax.reduce_window(sel, -jnp.inf, jax.lax.max,
                                       (1, 3, 3, 1), (1, 1, 1, 1), "SAME")
        want = jax.image.resize(pooled, (1, *hw, 1), method="nearest")
        want = want / (jnp.max(want) + 1e-12)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)
