"""The port's PNG reader (``utils/png.py``): what its writer wrote, and a
file whose rows use every filter type, built here from the PNG
specification (§9.2), read back to the same array."""

import struct
import zlib

import numpy as np
import pytest

from rich_text_to_image_tpu_torch.utils import png


@pytest.mark.parametrize("shape", [(1, 1, 3), (7, 5, 3), (64, 48, 3)])
def test_write_then_read_is_the_identity(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    path = str(tmp_path / "a.png")
    png.write_png(path, img)
    back = png.read_png(path)
    assert back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(img, kinds):
    """Scanlines of ``img`` [H, W, 3], row y filtered with kinds[y]."""
    h = img.shape[0]
    rows = img.reshape(h, -1).astype(np.int64)
    out = b""
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        f = []
        for x in range(len(cur)):
            a = int(cur[x - 3]) if x >= 3 else 0
            b, c = int(up[x]), (int(up[x - 3]) if x >= 3 else 0)
            pred = {0: 0, 1: a, 2: b, 3: (a + b) // 2,
                    4: _paeth(a, b, c)}[kinds[y]]
            f.append((int(cur[x]) - pred) % 256)
        out += bytes([kinds[y]]) + bytes(f)
    return out


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def test_reads_rows_of_every_filter_type():
    img = np.random.default_rng(1).integers(0, 256, (10, 9, 3),
                                            dtype=np.uint8)
    img[4:7] = img[3]  # rows that the Up filter predicts exactly
    kinds = [1, 2, 3, 4, 0, 4, 3, 2, 1, 4]
    data = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", 9, 10, 8, 2, 0, 0, 0))
            + _chunk(b"tEXt", b"Comment\x00made in a test")
            + _chunk(b"IDAT", zlib.compress(_filtered(img, kinds))[:40])
            + _chunk(b"IDAT", zlib.compress(_filtered(img, kinds))[40:])
            + _chunk(b"IEND", b""))
    np.testing.assert_array_equal(png.decode_png(data), img)


def test_refuses_what_it_does_not_read():
    grey = png.encode_png(np.zeros((2, 2), np.uint8))
    with pytest.raises(ValueError, match="8-bit RGB"):
        png.decode_png(grey)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode_png(b"GIF89a")
