"""Checkpoints of a pipeline's parameters: save once, restore in seconds.

Counterpart of ``rich_text_to_image_tpu/models/checkpoint.py``, which
writes the param trees through orbax. The trees are the same, keyed
``unet``, ``vae``, ``text`` and, for SDXL, ``text2``; each is one
safetensors file ``<path>/params/<tree>.safetensors`` of the module's
state dict in its own dtypes (``weights.save_safetensors``), so a restore
is exact and no pickle is read. The two packages' checkpoints are not each
other's: orbax's format against safetensors, flax's names and layouts
against diffusers' (``weights.from_flax`` maps a restored JAX tree).
"""

from __future__ import annotations

import os

from .. import weights

# tree name -> the pipeline's attribute holding its module
_TREES = {"unet": "unet", "vae": "vae", "text": "text_encoder",
          "text2": "text_encoder_2"}


def save_pipeline(path: str, pipeline) -> int:
    """Write a RegionDiffusion(XL) pipeline's trees under ``path/params``;
    returns the bytes written."""
    out = os.path.join(os.path.abspath(path), "params")
    os.makedirs(out, exist_ok=True)
    total = 0
    for tree, attr in _TREES.items():
        module = getattr(pipeline, attr, None)
        if module is not None:
            total += weights.save_safetensors(
                os.path.join(out, f"{tree}.safetensors"), module.state_dict())
    return total


def load_params(path: str, device="cuda") -> dict[str, dict]:
    """{tree: state dict} of a checkpoint of :func:`save_pipeline`, on
    ``device`` in the stored dtypes; each loads into its module with
    ``load_state_dict(strict=True)``."""
    src = os.path.join(os.path.abspath(path), "params")
    trees = {}
    for tree in _TREES:
        f = os.path.join(src, f"{tree}.safetensors")
        if os.path.exists(f):
            trees[tree] = {k: v.to(device) for k, v in
                           weights.read_safetensors(f).items()}
    if not trees:
        raise FileNotFoundError(f"no checkpoint under {src}")
    return trees
