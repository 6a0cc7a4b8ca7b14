"""A PNG writer from the standard library (zlib and struct): 8-bit RGB
and 16-bit greyscale, no image package needed. The eval grid, the
trajectory frames and the generated dataset layouts are written with it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG, or an (H, W)
    uint16 one as a 16-bit greyscale PNG (zlib and struct from the
    standard library; no image package needed)."""
    if rgb.dtype == np.uint16 and rgb.ndim == 2:
        h, w = rgb.shape
        depth, colour, rows = 16, 0, rgb.astype(">u2")
    else:
        h, w, _ = rgb.shape
        depth, colour, rows = 8, 2, np.ascontiguousarray(rgb, np.uint8)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    raw = b"".join(b"\x00" + row.tobytes() for row in rows)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 6))
                + chunk(b"IEND", b""))
