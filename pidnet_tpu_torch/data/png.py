"""Read and write 8-bit PNG images with zlib and numpy alone.

The machine that serves the port has neither cv2 nor PIL. `read_png`
decodes non-interlaced 8-bit greyscale (colour type 0) and RGB (colour
type 2) images with any of the five PNG row filters and returns (H, W)
or (H, W, 3) uint8, RGB in RGB order (not cv2's BGR). `write_png` writes
(H, W) uint8 greyscale or (H, W, 3) uint8 RGB with filter 0.

Filters 3 (Average) and 4 (Paeth) make each byte depend on its left,
upper and upper-left neighbours, so `_unfilter` walks the anti-diagonals
of the pixel grid: the pixels of one anti-diagonal depend only on earlier
ones and are reconstructed together, whatever each row's filter.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_GREY, _RGB = 0, 2  # colour types: 1 and 3 samples a pixel
_SAMPLES = {_GREY: 1, _RGB: 3}


def _chunks(data: bytes):
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """(H, W, bpp) filtered bytes + (H,) filter types -> (H, W, bpp) uint8."""
    h, w, bpp = raw.shape
    if not np.isin(filters, (0, 1, 2, 3, 4)).all():
        raise ValueError(f"bad PNG filter types {sorted(set(filters.tolist()))}")
    # out[r+1, i+1] is pixel (r, i); row 0 and column 0 are the zero border
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    raw = raw.astype(np.int32)
    rows = np.arange(h)
    for d in range(h + w - 1):
        r = rows[max(0, d - w + 1):min(h, d + 1)]
        i = d - r
        x = raw[r, i]
        a = out[r + 1, i]  # left
        b = out[r, i + 1]  # up
        c = out[r, i]  # up-left
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filters[r][:, None]
        pred = np.select(
            [f == 1, f == 2, f == 3, f == 4], [a, b, (a + b) >> 1, paeth], default=0
        )
        out[r + 1, i + 1] = (x + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG: greyscale -> (H, W) uint8, RGB
    -> (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _SAMPLES or interlace != 0:
        raise ValueError(
            f"{path}: only 8-bit non-interlaced greyscale or RGB PNGs are supported "
            f"(bit depth {depth}, colour type {ctype}, interlace {interlace})"
        )
    bpp = _SAMPLES[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[: h * (w * bpp + 1)].reshape(h, w * bpp + 1)
    image = _unfilter(rows[:, 1:].reshape(h, w, bpp), rows[:, 0])
    return image[:, :, 0] if ctype == _GREY else image


def write_png(path: str, image: np.ndarray) -> None:
    """Write (H, W) uint8 greyscale or (H, W, 3) uint8 RGB, filter 0."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        ctype = _GREY
    elif image.ndim == 3 and image.shape[2] == 3:
        ctype = _RGB
    else:
        raise ValueError(f"write_png: expected (H,W) greyscale or (H,W,3) RGB uint8, got "
                         f"{image.shape}")
    h, w = image.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(kind + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))
