"""Bicubic resize with torch/PIL-parity numerics, as two matrix products.

Counterpart of ``rich_text_to_image_tpu/ops/resize.py``: the dense 1-D
resampling matrices are built on the host with numpy, following torch's
upsample kernels (aten UpSampleKernel.cpp), and applied along the last two
axes.

  * antialias=True: PIL-style windowed cubic, A=-0.5, support widened by the
    downsampling factor, weights renormalised over the clipped window;
  * antialias=False: the classic 4-tap cubic convolution, A=-0.75, border
    taps clamped to the edge.

Both use the align_corners=False convention ``src = (dst + 0.5) * scale -
0.5``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


@functools.lru_cache(maxsize=256)
def _resize_matrix(in_size: int, out_size: int, antialias: bool) -> np.ndarray:
    """(out_size, in_size) float32 row-stochastic resampling matrix."""
    scale = in_size / out_size
    W = np.zeros((out_size, in_size), dtype=np.float64)
    if antialias:
        a = -0.5
        filterscale = max(scale, 1.0)
        support = 2.0 * filterscale
        for i in range(out_size):
            center = scale * (i + 0.5)
            xmin = max(0, int(center - support + 0.5))
            xmax = min(in_size, int(center + support + 0.5))
            xs = np.arange(xmin, xmax, dtype=np.float64)
            w = _cubic((xs - center + 0.5) / filterscale, a)
            s = w.sum()
            if s != 0:
                w = w / s
            W[i, xmin:xmax] = w
    else:
        a = -0.75
        for i in range(out_size):
            src = (i + 0.5) * scale - 0.5
            f = np.floor(src)
            taps = np.arange(f - 1, f + 3, dtype=np.int64)
            w = _cubic(src - taps, a)
            taps = np.clip(taps, 0, in_size - 1)
            for t, wt in zip(taps, w):
                W[i, t] += wt
    return W.astype(np.float32)


def resize_bicubic(img: torch.Tensor, out_hw: tuple[int, int],
                   antialias: bool = True) -> torch.Tensor:
    """Bicubic-resize the last two axes of ``img`` to ``out_hw``, with any
    number of leading axes, accumulating in float32."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    out_h, out_w = out_hw
    x = img.float()
    if in_h != out_h:
        Wh = torch.from_numpy(_resize_matrix(in_h, out_h, antialias)).to(x.device)
        x = torch.einsum("oh,...hw->...ow", Wh, x)
    if in_w != out_w:
        Ww = torch.from_numpy(_resize_matrix(in_w, out_w, antialias)).to(x.device)
        x = torch.einsum("ow,...hw->...ho", Ww, x)
    return x.to(img.dtype)
