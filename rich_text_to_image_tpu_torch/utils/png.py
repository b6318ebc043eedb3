"""A minimal PNG writer and reader (stdlib ``zlib`` + ``struct``): writes
8-bit RGB or grey, reads 8-bit RGB that is not interlaced, with any of the
five row filters."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] or [H, W] -> PNG bytes (no filtering per row)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"want uint8 [H,W,3] or [H,W], got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = np.ascontiguousarray(img).reshape(h, -1)
    raw = b"".join(b"\x00" + rows[y].tobytes() for y in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, row: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """One scanline's bytes from its filtered bytes and the line above
    (PNG spec §9.2: None, Sub, Up, Average, Paeth)."""
    if kind == 0:
        return row
    if kind == 2:
        return (row + prev).astype(np.uint8)
    if kind == 1:  # a running sum per channel
        return (np.cumsum(row.reshape(-1, bpp).astype(np.int64), axis=0)
                % 256).astype(np.uint8).reshape(-1)
    out = bytearray(row.tobytes())
    up = prev.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        if kind == 3:
            out[x] = (out[x] + ((a + up[x]) >> 1)) & 0xFF
        elif kind == 4:
            c = up[x - bpp] if x >= bpp else 0
            out[x] = (out[x] + _paeth(a, up[x], c)) & 0xFF
        else:
            raise ValueError(f"PNG: unknown filter type {kind}")
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes (8-bit RGB, not interlaced) -> uint8 [H, W, 3]."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    w, h, depth, color_type, _, _, interlace = hdr
    if depth != 8 or color_type != 2 or interlace != 0:
        raise ValueError(f"PNG: only 8-bit RGB without interlacing is read, "
                         f"got depth {depth}, colour type {color_type}, "
                         f"interlace {interlace}")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = 3 * w
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    rows, prev = [], np.zeros(stride, np.uint8)
    for y in range(h):
        prev = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, 3)
        rows.append(prev)
    return np.stack(rows).reshape(h, w, 3)


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())
