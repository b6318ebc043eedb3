"""Loader for the committed trained colour fixture.

Counterpart of ``rich_text_to_image_tpu/evaluation/fixtures.py``. The
fixture (``tests/fixtures/color_fixture``) is a tiny VAE and UNet trained on
synthetic coloured squares, so that decode(latent) is colour-faithful: the
precondition for the colour-guidance gates to measure steering, not noise.
Its ``.npz`` files hold the JAX package's parameter trees (fp16, keys are
the flax paths ``params/down_blocks_0/...``); they are read straight into
the port's modules through ``weights.py``'s bridge rules. The text encoder
is not stored: it is the port's ``random_init(seed=0)``, which is not the
JAX package's draw for that seed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .. import weights

FIXTURE_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), "..", "..", "tests", "fixtures",
    "color_fixture",
))


def _tree(npz) -> dict:
    """The nested {name: ...: array} tree of an ``.npz`` keyed by flax
    paths, in float32."""
    out: dict = {}
    for key in npz.files:
        node = out
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(npz[key], np.float32)
    return out


def load_color_fixture(fixture_dir: str = FIXTURE_DIR, device="cuda",
                       **pipeline_kw):
    """The trained tiny ``RegionDiffusion`` pipeline, float32."""
    from ..models import config as cfgs
    from ..pipelines.region_sd import RegionDiffusion

    model = RegionDiffusion.random_init(
        seed=0, unet_cfg=cfgs.FIXTURE_UNET, vae_cfg=cfgs.TINY_VAE,
        text_cfg=cfgs.TINY_TEXT, dtype=torch.float32, device=device,
        **pipeline_kw)
    for mod, fn, which in ((model.unet, "unet_params.npz", "unet"),
                           (model.vae, "vae_params.npz", "vae")):
        with np.load(os.path.join(fixture_dir, fn)) as z:
            weights.load_flax(mod, _tree(z), which)
    return model


def fixture_meta(fixture_dir: str = FIXTURE_DIR) -> dict:
    with open(os.path.join(fixture_dir, "fixture_meta.json")) as f:
        return json.load(f)
