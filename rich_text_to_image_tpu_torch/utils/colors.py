"""Color helpers for gradient color guidance.

Behavioral parity with the reference color table and nearest-color lookup
(reference: utils/richtext_utils.py:7-56), re-expressed in numpy — color math
is host-side control logic, not device compute.
"""

from __future__ import annotations

import numpy as np

# The 11-entry color-name table (reference: utils/richtext_utils.py:7-19).
COLORS: dict[str, list[int]] = {
    "brown": [165, 42, 42],
    "red": [255, 0, 0],
    "pink": [253, 108, 158],
    "orange": [255, 165, 0],
    "yellow": [255, 255, 0],
    "purple": [128, 0, 128],
    "green": [0, 128, 0],
    "blue": [0, 0, 255],
    "white": [255, 255, 255],
    "gray": [128, 128, 128],
    "black": [0, 0, 0],
}

_COLOR_NAMES = list(COLORS.keys())
_COLOR_VALUES = np.asarray(list(COLORS.values()), dtype=np.float32) / 255.0


def hex_to_rgb(hex_string: str) -> np.ndarray:
    """Convert ``#rrggbb`` to a float RGB triplet in [0, 1], shape (3,).

    Reference: utils/richtext_utils.py:30-44 (which returns (1, 3, 1, 1);
    we keep a flat (3,) and broadcast at the use site).
    """
    h = hex_string.lstrip("#")
    return np.asarray(
        [int(h[0:2], 16), int(h[2:4], 16), int(h[4:6], 16)], dtype=np.float32
    ) / 255.0


def find_nearest_color(rgb) -> str:
    """Name of the table color nearest (L2) to ``rgb``.

    Accepts a (3,) float array in [0,1] or a list/tuple of 0-255 ints
    (reference: utils/richtext_utils.py:47-56).
    """
    rgb = np.asarray(rgb, dtype=np.float32).reshape(-1)
    if rgb.max() > 1.0:
        rgb = rgb / 255.0
    dists = np.linalg.norm(_COLOR_VALUES - rgb[None, :], axis=1)
    return _COLOR_NAMES[int(np.argmin(dists))]
