"""The port's PNG codec and Lanczos resize (ed3dgs_torch/data/image_io.py)
against PIL, which only the tests import.

Bounds: decoding is bit-exact on PIL-written PNGs of every colour type and
on streams that force each of the five row filters and mixes of them;
PIL decodes the port's PNGs bit-exactly; the C++ unfilter
(csrc/png_unfilter.cpp, built with g++) equals its numpy version
`unfilter_plain` byte for byte; the resize is within 1/255 of PIL's on at
least 99% of values and within 2/255 on all of them (it runs PIL's
fixed-point arithmetic)."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from ed3dgs_torch.data import image_io

MODES = {1: "L", 2: "LA", 3: "RGB", 4: "RGBA"}


def smooth_image(rng, h, w, c):
    """Gradients plus noise: PIL's adaptive encoder then picks every filter."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x[..., None] * 3 + y[..., None] * 2 + np.arange(c) * 40) % 256
    img = (base + rng.integers(0, 24, (h, w, c))) % 256
    if c in (2, 4):   # alpha: transparent, partial and opaque pixels
        img[..., -1] = rng.choice([0, 1, 60, 128, 254, 255], (h, w))
    img = img.astype(np.uint8)
    return img[..., 0] if c == 1 else img


def pil_png(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="png")
    return buf.getvalue()


def apply_filter(f, cur, prev, bpp):
    """Forward PNG filter f of one row (int64 arrays), PNG spec section 9."""
    out = np.zeros_like(cur)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (cur[i] - pred) % 256
    return out


def forced_filter_png(arr, filters):
    """A PNG of arr whose row y uses filters[y % len(filters)]."""
    a = arr[..., None] if arr.ndim == 2 else arr
    h, w, c = a.shape
    rows = a.reshape(h, w * c).astype(np.int64)
    raw = bytearray()
    prev = np.zeros(w * c, np.int64)
    for y in range(h):
        f = filters[y % len(filters)]
        raw.append(f)
        raw.extend(apply_filter(f, rows[y], prev, c).astype(np.uint8).tobytes())
        prev = rows[y]
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    return (image_io.SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_decode_matches_pil_on_pil_pngs(channels):
    rng = np.random.default_rng(channels)
    arr = smooth_image(rng, 45, 67, channels)
    data = pil_png(arr)
    w, h, c, raw = image_io.read_png_stream(data)
    used = set(np.frombuffer(raw, np.uint8).reshape(h, -1)[:, 0].tolist())
    assert len(used) >= 3, used        # PIL's adaptive encoder mixes filters
    got = image_io.decode_png(data)
    want = np.asarray(Image.open(io.BytesIO(data)))
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("filters", [(0,), (1,), (2,), (3,), (4,), (3, 4, 1, 2, 0)])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_decode_every_row_filter(filters, channels):
    """Streams that use one filter throughout, or all five in turn (the
    Average and Paeth rows are the ones the helper exists for)."""
    rng = np.random.default_rng(7 * channels + len(filters))
    arr = smooth_image(rng, 23, 31, channels)
    data = forced_filter_png(arr, filters)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), arr)
    np.testing.assert_array_equal(image_io.decode_png(data), arr)


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_encode_is_read_by_pil(channels, tmp_path):
    rng = np.random.default_rng(10 + channels)
    arr = rng.integers(0, 256, (19, 29, channels), dtype=np.uint8)
    arr = arr[..., 0] if channels == 1 else arr
    path = str(tmp_path / "x.png")
    image_io.write_png(path, arr)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), arr)
    np.testing.assert_array_equal(image_io.read_png(path), arr)


def test_unfilter_helper_matches_numpy():
    """The C++ unfilter against `unfilter_plain` on random filtered streams
    (random filter bytes and data, so every predictor sees wrap-around)."""
    rng = np.random.default_rng(3)
    for h, row_bytes, bpp in ((17, 3 * 41, 3), (9, 4 * 13, 4), (33, 1 * 50, 1), (5, 2 * 7, 2)):
        raw = rng.integers(0, 256, (h, row_bytes + 1), dtype=np.uint8)
        raw[:, 0] = rng.integers(0, 5, h)
        got = image_io.unfilter(raw.tobytes(), h, row_bytes, bpp)
        want = image_io.unfilter_plain(raw.reshape(-1), h, row_bytes, bpp)
        np.testing.assert_array_equal(got, want)


def test_decode_refuses_what_it_does_not_take():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 256, (4, 13), dtype=np.uint8)
    raw[:, 0] = [0, 1, 9, 2]                      # an unknown filter type
    with pytest.raises(ValueError, match="filter"):
        image_io.unfilter(raw.tobytes(), 4, 12, 3)
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, format="png")
    with pytest.raises(ValueError, match="bit depth"):
        image_io.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        image_io.decode_png(b"GIF89a....")


@pytest.mark.parametrize("channels", [1, 2, 3, 4])
@pytest.mark.parametrize("size", [(20, 15), (120, 90), (53, 20), (67, 45), (31, 77)])
def test_resize_matches_pil_lanczos(channels, size):
    """Shrinking, enlarging, one axis only, the same size (a copy), and
    mixed; alpha images are resized premultiplied, as PIL does."""
    rng = np.random.default_rng(channels)
    arr = smooth_image(rng, 45, 67, channels)
    im = Image.fromarray(arr)
    assert im.mode == MODES[channels]
    want = np.asarray(im.resize(size, Image.LANCZOS))
    got = image_io.resize_lanczos(arr, *size)
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert (diff <= 1).mean() >= 0.99 and diff.max() <= 2


def test_load_image_resizes_only_when_the_size_differs(tmp_path):
    rng = np.random.default_rng(5)
    arr = smooth_image(rng, 30, 40, 3)
    path = str(tmp_path / "a.png")
    Image.fromarray(arr).save(path)
    np.testing.assert_array_equal(image_io.load_image(path, 40, 30), arr)
    want = np.asarray(Image.open(path).resize((20, 15), Image.LANCZOS))
    diff = np.abs(image_io.load_image(path, 20, 15).astype(int) - want.astype(int))
    assert diff.max() <= 2 and (diff <= 1).mean() >= 0.99
