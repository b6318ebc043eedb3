"""LoRA merging into the port's state dicts.

Counterpart of ``apply_lora_unet`` / ``apply_lora_text`` in
``rich_text_to_image_tpu/models/convert.py`` (the flax bridge itself is
``weights.py``). The reference keeps LoRA attention processors that add
``scale · up(down(x))`` to every attention projection; here, as in the JAX
package, the rank-r pair is merged into the projection's weight when it is
loaded, ``W' = W + scale · up @ down``, which is the same function for
inference and costs no extra product at run time. The port's modules carry
diffusers' names and torch's ``[out, in]`` layout, so the pair merges as it
is stored, with no transpose.

Both functions take a state dict of the port (``module.state_dict()``) and
a LoRA state dict of numpy arrays or tensors, and return a new dict: the
merged projections are new tensors, every other entry is the input's own
tensor. The merge is computed in float32 on the weight's device and cast
once to the weight's dtype. They raise ``ValueError`` on a pair with only
one half, a product whose shape is not the weight's, a LoRA tensor that
matched no projection, and a dict with no LoRA tensor at all.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch

# the UNet's attention projections: {state-dict stem: diffusers' processor
# name of its LoRA pair}
_UNET_PROJ = {"to_q": "to_q_lora", "to_k": "to_k_lora", "to_v": "to_v_lora",
              "to_out.0": "to_out_lora"}
_UNET_KEY = re.compile(r"^(.*)\.(to_q|to_k|to_v|to_out\.0)\.weight$")
_TEXT_KEY = re.compile(r"^(.*_proj)\.weight$")
_TEXT_INFIXES = ("lora_linear_layer", "lora")


def _merged(w: torch.Tensor, down, up, scale: float, where: str):
    down = torch.as_tensor(down, device=w.device, dtype=torch.float32)
    up = torch.as_tensor(up, device=w.device, dtype=torch.float32)
    delta = up @ down  # [out, r] @ [r, in]: the weight's own layout
    if delta.shape != w.shape:
        raise ValueError(f"{where}: LoRA shape mismatch, up @ down is "
                         f"{tuple(delta.shape)}, the weight "
                         f"{tuple(w.shape)}")
    return (w.float() + scale * delta).to(w.dtype)


def _pair(lora: Mapping, down_k: str, up_k: str, what: str):
    """(down, up) of a pair, None where neither half is there."""
    if down_k not in lora and up_k not in lora:
        return None
    if down_k not in lora or up_k not in lora:
        have = "down" if down_k in lora else "up"
        raise ValueError(f"{what}: half-present pair at "
                         f"{down_k.rsplit('.down.', 1)[0]} (have {have} only: "
                         "a truncated or corrupt checkpoint?)")
    return lora[down_k], lora[up_k]


def _finish(out: dict, lora: Mapping, used: set, n_merged: int,
            what: str, target: str) -> dict:
    unused = sorted(set(lora) - used)
    if unused:
        raise ValueError(f"{what}: {len(unused)} tensors matched no "
                         f"{target} (key-mapping drift?): {unused[:6]}")
    if n_merged == 0:
        raise ValueError(f"{what}: the state dict holds no LoRA tensors")
    return out


def apply_lora_unet(state_dict: Mapping[str, torch.Tensor],
                    lora_sd: Mapping, scale: float = 1.0) -> dict:
    """Merge a diffusers UNet LoRA (``<attn>.processor.<proj>_lora.{down,
    up}.weight``, a leading ``unet.`` accepted) into the UNet's
    ``to_q/to_k/to_v/to_out.0`` weights."""
    lora = {k.removeprefix("unet."): v for k, v in lora_sd.items()}
    out, used, n = dict(state_dict), set(), 0
    for key, w in state_dict.items():
        m = _UNET_KEY.match(key)
        if m is None:
            continue
        stem = f"{m.group(1)}.processor.{_UNET_PROJ[m.group(2)]}"
        down_k, up_k = f"{stem}.down.weight", f"{stem}.up.weight"
        pair = _pair(lora, down_k, up_k, "LoRA")
        if pair is None:
            continue
        out[key] = _merged(w, *pair, scale, key)
        used.update((down_k, up_k))
        n += 1
    return _finish(out, lora, used, n, "LoRA", "UNet projection")


def apply_lora_text(state_dict: Mapping[str, torch.Tensor],
                    lora_sd: Mapping, scale: float = 1.0) -> dict:
    """Merge a diffusers CLIP text-encoder LoRA (``...self_attn.<p>_proj
    .lora_linear_layer.{down,up}.weight``, or the older ``.lora.`` infix; a
    leading ``text_encoder.`` accepted) into the ``q/k/v/out_proj``
    weights."""
    lora = {k.removeprefix("text_encoder."): v for k, v in lora_sd.items()}
    out, used, n = dict(state_dict), set(), 0
    for key, w in state_dict.items():
        m = _TEXT_KEY.match(key)
        if m is None:
            continue
        for infix in _TEXT_INFIXES:
            down_k = f"{m.group(1)}.{infix}.down.weight"
            up_k = f"{m.group(1)}.{infix}.up.weight"
            pair = _pair(lora, down_k, up_k, "text LoRA")
            if pair is not None:
                out[key] = _merged(w, *pair, scale, key)
                used.update((down_k, up_k))
                n += 1
                break
    return _finish(out, lora, used, n, "text LoRA", "projection")
