"""RGB PNG files and a small rasteriser, in numpy and the standard library.

The port's analysis tools draw without matplotlib (the card's machine has
none): ``Canvas`` maps an xy range onto a white RGB image and draws points
(one pixel each) and polylines (the pixels Bresenham's algorithm picks
between consecutive vertices); ``write_png`` stores an (H, W, 3) uint8
image as an 8-bit RGB PNG (one IDAT chunk, filter 0 on every row, zlib),
and ``read_png`` reads such a file back.

    canvas = Canvas(600, 600, (-54, 54), (-54, 54))
    canvas.points(xy, GRAY)
    canvas.polyline(corners, RED)
    write_png("bev.png", canvas.rgb)

Pixel (row, col) covers x in [x0 + col * sx, x0 + (col + 1) * sx) and
y in (y1 - (row + 1) * sy, y1 - row * sy]: x grows to the right and y
upward, as on a plot. Whatever maps outside the image is not drawn.
"""
from __future__ import annotations

import struct
import zlib
from typing import Sequence, Tuple

import numpy as np

WHITE = (255, 255, 255)
GRAY = (128, 128, 128)
RED = (255, 0, 0)
# analyze_logs' curves, one colour a key, in this order
PALETTE = (("blue", (31, 119, 180)), ("orange", (255, 127, 14)),
           ("green", (44, 160, 44)), ("red", (214, 39, 40)),
           ("purple", (148, 103, 189)), ("brown", (140, 86, 75)),
           ("pink", (227, 119, 194)), ("olive", (188, 189, 34)),
           ("cyan", (23, 190, 207)), ("gray", (127, 127, 127)))
SIGNATURE = b"\x89PNG\r\n\x1a\n"


class Canvas:
    """A white (height, width, 3) uint8 image over ``xlim`` x ``ylim``."""

    def __init__(self, width: int, height: int, xlim: Sequence[float],
                 ylim: Sequence[float]):
        if width < 1 or height < 1:
            raise ValueError(f"canvas {width} x {height}")
        if not (xlim[1] > xlim[0] and ylim[1] > ylim[0]):
            raise ValueError(f"empty range {xlim} x {ylim}")
        self.width, self.height = int(width), int(height)
        self.xlim = (float(xlim[0]), float(xlim[1]))
        self.ylim = (float(ylim[0]), float(ylim[1]))
        self.rgb = np.full((self.height, self.width, 3), 255, np.uint8)

    def to_pixel(self, xy) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) int64 of points (N, 2); may lie outside the
        image."""
        xy = np.asarray(xy, np.float64).reshape(-1, 2)
        (x0, x1), (y0, y1) = self.xlim, self.ylim
        cols = np.floor((xy[:, 0] - x0) / (x1 - x0) * self.width)
        rows = np.floor((y1 - xy[:, 1]) / (y1 - y0) * self.height)
        return rows.astype(np.int64), cols.astype(np.int64)

    def inside(self, rows, cols) -> np.ndarray:
        rows, cols = np.asarray(rows), np.asarray(cols)
        return ((rows >= 0) & (rows < self.height) & (cols >= 0)
                & (cols < self.width))

    def set(self, rows, cols, color) -> None:
        """Colour the pixels (rows, cols) that lie inside the image."""
        rows, cols = np.asarray(rows), np.asarray(cols)
        keep = self.inside(rows, cols)
        self.rgb[rows[keep], cols[keep]] = color

    def points(self, xy, color=GRAY) -> None:
        self.set(*self.to_pixel(xy), color)

    def polyline(self, xy, color=RED) -> None:
        """Segments between consecutive vertices of ``xy`` (N, 2)."""
        rows, cols = self.to_pixel(xy)
        for i in range(len(rows) - 1):
            r, c = line_pixels(rows[i], cols[i], rows[i + 1], cols[i + 1])
            if len(r) > 0:
                self.set(r, c, color)


def line_pixels(r0: int, c0: int, r1: int, c1: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """The pixels Bresenham's algorithm draws from (r0, c0) to (r1, c1),
    both ends included: one pixel per step along the longer axis, the
    other coordinate the exact line's rounded to the nearest integer
    (halves away from the start), in integer arithmetic. A segment whose
    bounding box misses every pixel of a 2^20-pixel square about the
    origin is returned empty, so a far vertex costs no long loop."""
    r0, c0, r1, c1 = int(r0), int(c0), int(r1), int(c1)
    lim = 1 << 20
    if (max(r0, r1) < -lim or min(r0, r1) > lim or max(c0, c1) < -lim
            or min(c0, c1) > lim):
        empty = np.zeros(0, np.int64)
        return empty, empty
    dr, dc = r1 - r0, c1 - c0
    n = max(abs(dr), abs(dc))
    if n == 0:
        return np.array([r0]), np.array([c0])
    i = np.arange(n + 1, dtype=np.int64)

    def along(d):  # d * i / n rounded, halves away from the start
        q = (2 * abs(d) * i + n) // (2 * n)
        return q if d >= 0 else -q

    return r0 + along(dr), c0 + along(dc)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(rgb: np.ndarray) -> bytes:
    """The bytes of an 8-bit RGB PNG of ``rgb`` (H, W, 3) uint8."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"need (H, W, 3) uint8, got {rgb.dtype} "
                         f"{rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(rgb).reshape(h, 3 * w)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(rgb))


def read_png(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB, non-interlaced PNG whose rows all
    use filter 0, as ``write_png`` stores them; raises on anything else
    (a bad signature or CRC, another colour type, another filter)."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG")
    pos, header, idat = 8, None, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG ({header})")
    w, h = header[:2]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    if raw.size != h * (3 * w + 1):
        raise ValueError(f"{path}: {raw.size} bytes for {w} x {h}")
    raw = raw.reshape(h, 3 * w + 1)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row uses a filter other than 0")
    return raw[:, 1:].reshape(h, w, 3).copy()
