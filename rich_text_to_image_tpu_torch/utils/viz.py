"""Figures of the segmentation and the token maps, written as PNG.

Counterpart of ``rich_text_to_image_tpu/utils/viz.py`` (the reference's
always-on visual debugging, utils/attention_utils.py:96-149 and :266-277),
without matplotlib: the arrays are coloured through colormaps held here as
tables and written by ``utils/png.py``. The files take the JAX package's
names, with ``.png`` where it writes ``.jpg``:

  * ``segmentation_k{K}_seed{S}.png`` — the cluster labels, one colour each
    (viridis over 0..K-1, as matplotlib's ``imshow`` default shows them);
  * ``average_seed{S}_attn{i}.png`` — for each list of maps, the maps side
    by side on one OrRd scale from the smallest to the largest value of
    the list, and that scale as a bar at the right. The span names the
    JAX figure prints over each map are not drawn (no font here).
"""

from __future__ import annotations

import os

import numpy as np

from .png import write_png

# matplotlib's OrRd: ColorBrewer's nine sequential colours, linearly
# interpolated
ORRD = ((255, 247, 236), (254, 232, 200), (253, 212, 158), (253, 187, 132),
        (252, 141, 89), (239, 101, 72), (215, 48, 31), (179, 0, 0),
        (127, 0, 0))
# viridis at 0, 1/16, ..., 1 (matplotlib's listed map, sampled; linearly
# interpolated it stays within 6 uint8 steps of the full map)
VIRIDIS = ((68, 1, 84), (72, 24, 106), (71, 45, 123), (66, 64, 134),
           (59, 82, 139), (51, 99, 141), (44, 114, 142), (38, 130, 142),
           (33, 145, 140), (31, 160, 136), (40, 174, 128), (63, 188, 115),
           (94, 201, 98), (132, 212, 75), (173, 220, 48), (216, 226, 25),
           (253, 231, 37))
CELL = 128  # pixels a side of one map in a heat grid
GAP = 4
BAR = 16


def colorize(x: np.ndarray, table, vmin: float, vmax: float) -> np.ndarray:
    """uint8 RGB [..., 3] of ``x`` through a colour table linearly
    interpolated over [vmin, vmax] (values outside are clipped)."""
    t = np.asarray(table, np.float64)
    span = vmax - vmin
    u = (np.asarray(x, np.float64) - vmin) / (span if span > 0 else 1.0)
    pos = np.clip(u, 0.0, 1.0) * (len(t) - 1)
    i = np.minimum(pos.astype(np.int64), len(t) - 2)
    f = (pos - i)[..., None]
    return np.round(t[i] * (1 - f) + t[i + 1] * f).astype(np.uint8)


def _upscale(img: np.ndarray, size: int) -> np.ndarray:
    """Nearest-neighbour resize of [h, w, 3] to ``size`` rows (and the
    columns in proportion)."""
    h, w = img.shape[:2]
    rows = np.arange(size) * h // size
    cols = np.arange(max(size * w // h, 1)) * w // max(size * w // h, 1)
    return img[rows][:, cols]


def save_segmentation(clusters: np.ndarray, save_dir: str, num_segments: int,
                      seed: int) -> np.ndarray:
    """Write ``segmentation_k{K}_seed{S}.png``; returns its RGB array."""
    os.makedirs(save_dir, exist_ok=True)
    labels = np.asarray(clusters)
    img = _upscale(colorize(labels, VIRIDIS, float(labels.min()),
                            float(labels.max())), 8 * labels.shape[0])
    write_png(os.path.join(
        save_dir, f"segmentation_k{num_segments}_seed{seed}.png"), img)
    return img


def plot_attention_maps(map_lists, obj_tokens, save_dir: str, seed: int,
                        tokens_vis=None) -> np.ndarray | None:
    """Write ``average_seed{S}_attn{i}.png`` for each list of maps (each map
    [1, h, w] or [h, w]); returns the last figure's RGB array.
    ``obj_tokens`` and ``tokens_vis`` (the span token ids and the
    tokenizer's tokens, which label the JAX figure's maps) are taken for
    the JAX package's signature and not drawn."""
    os.makedirs(save_dir, exist_ok=True)
    img = None
    for i, maps in enumerate(map_lists):
        maps = [np.asarray(m, np.float32).squeeze() for m in maps]
        vmin = min(float(m.min()) for m in maps)
        vmax = max(float(m.max()) for m in maps)
        tiles = [_upscale(colorize(m, ORRD, vmin, vmax), CELL) for m in maps]
        ramp = np.linspace(vmax, vmin, CELL)[:, None].repeat(BAR, axis=1)
        tiles.append(colorize(ramp, ORRD, vmin, vmax))
        gap = np.full((CELL, GAP, 3), 255, np.uint8)
        row = [gap]
        for t in tiles:
            row += [t, gap]
        img = np.concatenate(row, axis=1)
        write_png(os.path.join(save_dir, f"average_seed{seed}_attn{i}.png"),
                  img)
    return img
