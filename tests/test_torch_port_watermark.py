"""The port's SDXL watermark against the JAX package's.

The same uint8 images go through ``apply_watermark`` of both packages. The
port's embedding must carry the same 48 bits (each package's decoder reads
them from the other's image too), and its images must lie within 1 uint8
step of the JAX package's everywhere: both compute the same float32 chroma
shift, and only the rounding of values that land within float32 noise of
a half step can differ. Images under 256 px pass through unchanged, bit for
bit, in both.
"""

import numpy as np
import pytest
import torch

from rich_text_to_image_tpu.utils import watermark as J
from rich_text_to_image_tpu_torch.utils import watermark as T
from torch_port_threads import one_torch_thread  # noqa: F401 (autouse)


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([120 + 80 * np.sin(yy / 37.0), 90 + 70 * np.cos(xx / 53.0),
                     140 + 60 * np.sin((xx + yy) / 71.0)], axis=-1)
    img = base + rng.normal(0, 6, size=(h, w, 3))
    return np.clip(np.round(img), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("h,w", [(256, 320), (264, 260), (512, 512)])
def test_watermark_matches_jax(h, w):
    imgs = np.stack([_image(h, w, 0), np.full((h, w, 3), (200, 40, 40),
                                              np.uint8)])
    want = np.asarray(J.apply_watermark(imgs))
    got = T.apply_watermark(torch.from_numpy(imgs))
    assert got.dtype == torch.uint8 and got.shape == imgs.shape
    got = got.numpy()
    assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
    for i in range(2):
        assert T.decode_watermark(got[i])[0] == T.WATERMARK_BITS
        assert J.decode_watermark(got[i])[0] == J.WATERMARK_BITS
        assert T.decode_watermark(want[i]) == J.decode_watermark(want[i])
    assert T.WATERMARK_BITS == J.WATERMARK_BITS


def test_watermark_takes_numpy_and_passes_small_images_through():
    img = _image(256, 256, 3)[None]
    got = T.apply_watermark(img)
    assert isinstance(got, np.ndarray)
    bits, margin = T.decode_watermark(got[0])
    assert bits == T.WATERMARK_BITS and margin > 0.5
    small = _image(128, 192, 4)[None]
    np.testing.assert_array_equal(T.apply_watermark(small), small)
    np.testing.assert_array_equal(
        T.apply_watermark(torch.from_numpy(small)).numpy(),
        np.asarray(J.apply_watermark(small)))
