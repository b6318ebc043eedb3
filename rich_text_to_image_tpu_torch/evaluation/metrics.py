"""Benchmark metrics (protocol parity with the reference), numpy only.

A copy of ``rich_text_to_image_tpu/evaluation/metrics.py``.

Color: min / region-averaged L2 RGB distance to a target color
(evaluation/benchmark_color.py:283-331). Style: CLIP similarity of
mask-composited region crops (evaluation/benchmark_style.py:146-167).
"""

from __future__ import annotations

import numpy as np


def color_distances(
    image: np.ndarray,  # [H, W, 3] uint8
    region_mask: np.ndarray,  # [H, W] float in [0, 1]
    target_rgb: np.ndarray,  # (3,) float in [0, 1]
    color_name: str = "",
) -> tuple[float, float]:
    """(min_dis, avg_dis) for one image/region/target.

    min: composite the region onto a plain background (black, or white when
    the target itself is black), then min over pixels of the euclidean
    distance. avg: mask-weighted mean distance over the raw image.
    """
    img = np.asarray(image, dtype=np.float64)
    mask = np.asarray(region_mask, dtype=np.float64)
    target = np.asarray(target_rgb, dtype=np.float64).reshape(1, 1, 3)

    background = (
        np.ones_like(img) * 255 if color_name == "black" else np.zeros_like(img)
    )
    composed = (mask[..., None] * img + (1 - mask[..., None]) * background)
    composed = composed.round() / 255.0
    min_dis = float(np.sqrt(((composed - target) ** 2).sum(-1)).min())

    euc = np.sqrt(((img / 255.0 - target) ** 2).sum(-1))
    avg_dis = float((euc * mask).sum() / max(mask.sum(), 1e-12))
    return min_dis, avg_dis


def compose_region(image: np.ndarray, region_mask: np.ndarray) -> np.ndarray:
    """Region crop on black background for CLIP scoring (style bench)."""
    img = np.asarray(image, dtype=np.float64)
    mask = np.asarray(region_mask, dtype=np.float64)[..., None]
    return (mask * img).round().astype(np.uint8)


class RunningStats:
    def __init__(self):
        self.values: list[float] = []

    def add(self, v: float):
        self.values.append(float(v))

    def __len__(self):
        return len(self.values)

    @property
    def mean(self):
        return float(np.mean(self.values)) if self.values else float("nan")

    @property
    def std(self):
        return float(np.std(self.values)) if self.values else float("nan")

    def fmt(self):
        return f"{self.mean:.3f}±{self.std:.3f}"
