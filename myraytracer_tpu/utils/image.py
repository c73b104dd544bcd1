"""Image IO: float [H, W, 3] arrays <-> PNG files.

Replaces the missing framework ``Image`` class of the reference (resize /
pixel access / PNG writer — evidence: mytracer.cpp:131,155, outputs/*.png).
8-bit RGB/RGBA PNGs are encoded and decoded with ``zlib`` alone, so the
package has no imaging dependency; other PNG formats are handed to PIL
when it is installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp float [0,1] image to uint8."""
    arr = np.asarray(img, dtype=np.float32)
    return (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray) -> None:
    """Write a float [H, W, 3] (or uint8) image to an RGB8 PNG file."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = to_uint8(arr)
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    png = (
        _SIGNATURE
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )
    with open(path, "wb") as f:
        f.write(png)


def read_png(path: str) -> np.ndarray:
    """Read a PNG file into a float32 [H, W, 3] array in [0, 1].

    Non-interlaced 8-bit RGB and RGBA (alpha dropped) decode with zlib;
    any other format needs PIL.
    """
    with open(path, "rb") as f:
        data = f.read()
    arr = _decode_rgb8(data)
    if arr is None:
        from PIL import Image as PILImage

        with PILImage.open(path) as im:
            arr = np.asarray(im.convert("RGB"))
    return arr.astype(np.float32) / 255.0


def _decode_rgb8(data: bytes):
    """uint8 [H, W, 3] from an 8-bit RGB/RGBA PNG; None for other formats."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        return None
    bpp = 3 if ctype == 2 else 4
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        out[y] = prev = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out.reshape(h, w, bpp)[:, :, :3]


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter (types 0-4, PNG spec §9)."""
    if ftype == 0:
        return line.copy()
    if ftype == 2:
        return line + prev  # uint8 arithmetic wraps mod 256
    if ftype == 1:
        # recon[x] = filt[x] + recon[x - bpp]: a running sum per channel
        px = line.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(px, axis=0) % 256).astype(np.uint8).ravel()
    if ftype not in (3, 4):
        raise ValueError(f"bad PNG filter type {ftype}")
    cur = line.astype(np.int64)
    up = prev.astype(np.int64)
    for i in range(len(cur)):
        a = int(cur[i - bpp]) if i >= bpp else 0
        b = int(up[i])
        if ftype == 3:
            cur[i] = (cur[i] + (a + b) // 2) & 0xFF
        else:
            c = int(up[i - bpp]) if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[i] = (cur[i] + pred) & 0xFF
    return cur.astype(np.uint8)
