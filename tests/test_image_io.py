"""PNG IO without an imaging library: 8-bit RGB and RGBA files with each
of the five PNG scanline filters decode with zlib alone."""

import struct
import sys
import zlib

import numpy as np
import pytest

from myraytracer_tpu.utils.image import read_png, write_png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _encode(img: np.ndarray, ftype: int) -> bytes:
    """PNG bytes with every scanline filtered by ``ftype`` (PNG spec §9),
    written independently of the decoder under test."""
    h, w, ch = img.shape
    bpp = ch
    rows = img.reshape(h, w * ch).astype(int)
    out = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        out.append(ftype)
        for i in range(len(cur)):
            a = cur[i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[ftype]
            out.append((cur[i] - pred) % 256)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ctype = 2 if ch == 3 else 6
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out)))
            + chunk(b"IEND", b""))


@pytest.fixture
def no_pil(monkeypatch):
    """Make ``import PIL`` fail, as on a machine without it."""
    monkeypatch.setitem(sys.modules, "PIL", None)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels", [3, 4])
def test_read_png_without_pil(tmp_path, no_pil, channels, ftype):
    rng = np.random.default_rng(channels * 10 + ftype)
    img = rng.integers(0, 256, (7, 11, channels), dtype=np.uint8)
    path = tmp_path / "x.png"
    path.write_bytes(_encode(img, ftype))
    got = read_png(str(path))
    assert got.dtype == np.float32 and got.shape == (7, 11, 3)
    np.testing.assert_array_equal(got * 255.0, img[:, :, :3].astype(np.float32))


def test_write_read_roundtrip_without_pil(tmp_path, no_pil):
    img = np.random.default_rng(0).random((9, 13, 3)).astype(np.float32)
    path = str(tmp_path / "r.png")
    write_png(path, img)
    np.testing.assert_allclose(read_png(path), img, atol=0.5 / 255 + 1e-6)


def test_read_png_rejects_non_png(tmp_path):
    path = tmp_path / "x.png"
    path.write_bytes(b"not a png at all")
    with pytest.raises(ValueError, match="not a PNG"):
        read_png(str(path))
