"""Token-map segmentation: aggregated attention maps -> per-span soft masks.

Counterpart of ``rich_text_to_image_tpu/utils/token_maps.py`` (the
reference's ``get_token_maps``, utils/attention_utils.py:233-341). The plain
pass hands over one [N, N] self-attention sum over the N tokens of the
segmentation level (the 32^2 registry layers at 512^2, at the last step)
and one cross-attention sum per resolution; the
spectral clustering runs on the affinity's device, the rest on the host in
numpy. Figures (the JAX package's ``utils/viz.py``) are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from ..ops.resize import resize_bicubic
from ..ops.spectral import spectral_cluster

SEG_RESOLUTION = 32  # the reference's segmentation grid


@dataclasses.dataclass
class AttnAggregates:
    """Aggregated attention maps from the plain pass.

    self_sum: [N, N] — sum over the segmentation level's registry layers
        of the cond row's head-averaged self-attention probabilities (a
        tensor, left on the device that produced it). N = rows x columns of
        that level's grid, which has the latent's aspect.
    self_count: number of layers in self_sum.
    cross_sums: {rows r: [r * columns, 77]} — per-resolution sums over
        (registry layers x steps >= agg_start_step) of the cond row's
        head-averaged cross-attention probabilities (numpy).
    cross_layer_count: number of cross layers contributing.
    """

    self_sum: torch.Tensor | np.ndarray
    self_count: int
    cross_sums: Mapping[int, np.ndarray]
    cross_layer_count: int
    # (seed, num_segments, n_init) -> labels: the reference flow segments
    # the same affinity twice per sample (colour spans, then region spans)
    cluster_cache: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False)


def _resize_np(x: np.ndarray, out_hw) -> np.ndarray:
    return resize_bicubic(torch.from_numpy(np.ascontiguousarray(x)), out_hw,
                          antialias=True).numpy()


def get_token_maps(
    agg: AttnAggregates,
    obj_tokens: Sequence[np.ndarray],  # per-span 1-based token ids
    latent_hw: tuple[int, int],
    seed: int = 0,
    segment_threshold: float = 0.3,
    num_segments: int = 5,
    n_init: int = 100,
    return_segments: bool = False,
    clusters: np.ndarray | None = None,
):
    """Per-span soft masks [1, h, w] (background last), summing to 1.

    The segmentation grid has the aspect of ``latent_hw``. ``clusters``
    ([rows, columns] labels) skips the clustering; the parity tests pass the
    JAX package's labels through it.
    """
    affinity = torch.as_tensor(agg.self_sum)
    lat_h, lat_w = latent_hw
    res = int(round(np.sqrt(affinity.shape[0] * lat_h / lat_w)))  # rows
    res_w = res * lat_w // lat_h
    if tuple(affinity.shape) != (res * res_w, res * res_w):
        raise ValueError(f"self_sum must be square over a grid of the "
                         f"latent's aspect {tuple(latent_hw)}, got "
                         f"{tuple(affinity.shape)}")
    if clusters is None:
        key = (seed, num_segments, n_init)
        clusters = agg.cluster_cache.get(key)
        if clusters is None:
            gen = torch.Generator(device=affinity.device).manual_seed(seed)
            clusters = spectral_cluster(
                affinity, num_segments, n_init=n_init, generator=gen,
            ).cpu().numpy().reshape(res, res_w)
            agg.cluster_cache[key] = clusters

    # ---- cross-attention maps -> res^2, averaged over layers
    cross = np.zeros((res, res_w, 77), dtype=np.float32)
    for r, m in agg.cross_sums.items():
        m = np.asarray(m, dtype=np.float32).reshape(r, -1, 77)
        if r != res:
            m = _resize_np(m.transpose(2, 0, 1),
                           (res, res_w)).transpose(1, 2, 0)
        cross += m
    cross /= max(agg.cross_layer_count, 1)

    # ---- per-span min-max normalisation (attention_utils.py:296-304)
    span_maps = []
    for token_ids in obj_tokens:
        span = cross[:, :, np.asarray(token_ids)]
        lo = span.min(axis=(0, 1), keepdims=True)
        hi = span.max(axis=(0, 1), keepdims=True)
        span_maps.append((span - np.abs(lo)) / (hi - lo + 1e-12))

    # ---- cluster -> span assignment (attention_utils.py:308-322)
    foreground = [np.zeros((res, res_w), np.float32) for _ in obj_tokens]
    background = np.zeros((res, res_w), np.float32)
    for c in range(num_segments):
        cmask = (clusters == c).astype(np.float32)
        csum = max(cmask.sum(), 1e-12)
        is_fg = False
        for span_map, fg in zip(span_maps, foreground):
            scores = (cmask[:, :, None] * span_map).sum(axis=(0, 1)) / csum
            if scores.max() > segment_threshold:
                fg += cmask
                is_fg = True
        if not is_fg:
            background += cmask
    foreground.append(background)

    # ---- resize to the latent grid, clamp, normalise to sum 1
    resized = _resize_np(np.stack(foreground), tuple(latent_hw))
    resized = np.clip(resized, 0.0, 1.0)
    resized = resized / (resized.sum(axis=0, keepdims=True) + 1e-8)
    masks = [resized[i][None] for i in range(resized.shape[0])]
    if return_segments:
        return masks, clusters
    return masks
