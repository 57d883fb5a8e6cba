"""The port's own PNG codec and Lanczos resize: what the JAX package asks of
PIL (data/readers.py, data/synthetic.py, utils/tb_writer.py), in numpy,
`zlib` and one small host C++ helper, so that the port reads and writes
images on a machine without Pillow.

- `encode_png`: 8-bit gray, gray+alpha, RGB or RGBA, every row filter 0
  (None), one IDAT chunk deflated by `zlib`.
- `decode_png`: 8-bit, non-interlaced PNGs of colour types 0, 2, 4 and 6.
  The IDAT stream is inflated by `zlib` and its row filters undone by
  csrc/png_unfilter.cpp (built with g++ at first use, ops/cuda_lib.py):
  Average and Paeth predict each byte from the decoded byte to its left,
  so they do not vectorise, and a Python loop over every pixel would
  outlast the training step.
  `unfilter_plain` is the numpy version the tests hold the helper to. A
  helper that does not build raises; decoding never falls back to the
  slow loop.
- `resize_lanczos`: PIL's `Image.resize(size, Image.LANCZOS)` on uint8
  arrays: the same separable filter (support 3, stretched by the scale
  when shrinking), the same fixed-point coefficients (22 fraction bits)
  and rounding, horizontal pass first, each pass rounded to 8 bits, and
  RGBA / gray+alpha resized premultiplied by alpha as PIL does. Each pass
  runs in csrc/png_unfilter.cpp (`ed3dgs_resample_axis`), exact integer
  sums as `_resample_axis_plain`, the numpy version the tests hold it to;
  numpy takes seconds for a DyNeRF frame (2704x2028 -> 1600x1200).
- `resize_bilinear`: `Image.resize(size, Image.BILINEAR)` through the
  same fixed-point passes with PIL's triangle filter (support 1).
- `load_image`: a PNG as PIL's `np.asarray(Image.open(path).resize(...))`
  gives it: [H, W] for gray, [H, W, C] otherwise, uint8.
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (8-bit samples)
CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in CHANNELS.items()}


# --- encode -----------------------------------------------------------------

def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W] (gray) or [H, W, C] with C in 1..4 -> PNG bytes."""
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        raise TypeError(f"encode_png takes uint8 arrays, got {arr.dtype}")
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.ndim != 3 or arr.shape[2] not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes [H, W] or [H, W, 1..4], got {arr.shape}")
    h, w, c = arr.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)       # filter byte 0 before each row
    rows[:, 1:] = arr.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes())) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


# --- decode -----------------------------------------------------------------

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter_plain(raw: np.ndarray, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """Plain numpy version of csrc/png_unfilter.cpp: raw is the inflated
    stream (a filter byte before each row); returns [height, row_bytes]
    uint8. Sub and Up are whole-row operations (a cumulative sum mod 256,
    an add); Average and Paeth walk the row a pixel at a time."""
    rows = np.asarray(raw, np.uint8).reshape(height, row_bytes + 1)
    out = np.zeros((height, row_bytes), np.uint8)
    prev = np.zeros(row_bytes, np.int64)
    for y in range(height):
        f, src = int(rows[y, 0]), rows[y, 1:].astype(np.int64)
        if f == 0:
            cur = src
        elif f == 1:
            cur = np.cumsum(src.reshape(-1, bpp), axis=0).reshape(-1) % 256
        elif f == 2:
            cur = (src + prev) % 256
        elif f in (3, 4):
            cur = np.zeros(row_bytes, np.int64)
            left = np.zeros(bpp, np.int64)
            up_left = np.zeros(bpp, np.int64)
            for x in range(0, row_bytes, bpp):
                up = prev[x:x + bpp]
                pred = (left + up) >> 1 if f == 3 else _paeth(left, up, up_left)
                cur[x:x + bpp] = (src[x:x + bpp] + pred) % 256
                left, up_left = cur[x:x + bpp], up
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {f}")
        out[y] = cur
        prev = cur
    return out


def unfilter(raw: bytes, height: int, row_bytes: int, bpp: int) -> np.ndarray:
    """csrc/png_unfilter.cpp on the inflated stream: [height, row_bytes]
    uint8, as `unfilter_plain` gives it. Builds the helper at first use and
    raises if it does not build."""
    from ..ops import cuda_lib

    if len(raw) < height * (row_bytes + 1):
        raise ValueError(f"PNG data too short: {len(raw)} bytes for {height} rows of "
                         f"{row_bytes + 1}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = cuda_lib.lib("png_unfilter").ed3dgs_png_unfilter(
        src.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        height, row_bytes, bpp)
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    return out


def read_png_stream(data: bytes):
    """PNG bytes -> (width, height, channels, inflated IDAT stream)."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {color}, "
                         f"interlace {interlace} (8-bit, non-interlaced, colour types "
                         f"0/2/4/6 only)")
    return w, h, CHANNELS[color], zlib.decompress(b"".join(idat))


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W] (gray) or [H, W, C]."""
    w, h, c, raw = read_png_stream(data)
    img = unfilter(raw, h, w * c, c).reshape(h, w, c)
    return img[..., 0] if c == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


# --- PIL's resampling: Lanczos and bilinear ---------------------------------

PRECISION_BITS = 32 - 8 - 2        # PIL's fixed-point fraction bits for 8-bit images
LANCZOS_SUPPORT = 3.0
BILINEAR_SUPPORT = 1.0


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: float) -> float:
    return _sinc(x) * _sinc(x / 3.0) if -3.0 <= x < 3.0 else 0.0


def _bilinear(x: float) -> float:
    x = abs(x)
    return 1.0 - x if x < 1.0 else 0.0


@functools.lru_cache(maxsize=32)
def _coefficients(in_size: int, out_size: int, kernel=_lanczos, support=LANCZOS_SUPPORT):
    """PIL's precompute_coeffs + normalize_coeffs_8bpc, in its operation
    order (scalar libm arithmetic, sequential sums), for the filter
    `kernel` of half-width `support`: per output index, the first input
    index and the integer weights [out_size, ksize] (zeros past each
    window). Cached: a loader resizes every frame of a camera alike; the
    arrays are read-only."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    one = float(1 << PRECISION_BITS)
    xmins = np.zeros(out_size, np.int64)
    fixed = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        k = [kernel((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = 0.0
        for v in k:
            ww += v
        for x, v in enumerate(k):
            v = v / ww if ww != 0.0 else v
            # C's (int) cast truncates toward zero
            fixed[xx, x] = int(-0.5 + v * one) if v < 0 else int(0.5 + v * one)
        xmins[xx] = xmin
    xmins.flags.writeable = fixed.flags.writeable = False
    return xmins, fixed


def _resample_axis(img: np.ndarray, out_size: int, axis: int, kernel, support) -> np.ndarray:
    """One 8-bit pass along `axis` of a uint8 [H, W, C] image, in
    csrc/png_unfilter.cpp: `_resample_axis_plain`'s integers, byte for
    byte. Builds the helper at first use and raises if it does not build."""
    from ..ops import cuda_lib

    src = np.ascontiguousarray(img, np.uint8)
    h, w, c = src.shape
    outer, in_size, inner = (1, h, w * c) if axis == 0 else (h, w, c)
    xmins, k = _coefficients(in_size, out_size, kernel, support)
    shape = (out_size, w, c) if axis == 0 else (h, out_size, c)
    out = np.empty(shape, np.uint8)
    cuda_lib.lib("png_unfilter").ed3dgs_resample_axis(
        src.ctypes.data_as(ctypes.c_void_p), out.ctypes.data_as(ctypes.c_void_p),
        outer, in_size, inner, out_size, xmins.ctypes.data_as(ctypes.c_void_p),
        k.ctypes.data_as(ctypes.c_void_p), k.shape[1], PRECISION_BITS)
    return out


def _resample_axis_plain(img: np.ndarray, out_size: int, axis: int, kernel,
                         support) -> np.ndarray:
    """One 8-bit pass along `axis` of an int64 [H, W, C] image (numpy:
    every tap of every output gathered at once)."""
    in_size = img.shape[axis]
    xmins, k = _coefficients(in_size, out_size, kernel, support)
    taps = np.clip(xmins[:, None] + np.arange(k.shape[1])[None, :], 0, in_size - 1)
    src = np.take(img, taps, axis=axis)           # [..., out, ksize, ...]
    if axis == 0:
        acc = np.einsum("okwc,ok->owc", src, k)
    else:
        acc = np.einsum("hokc,ok->hoc", src, k)
    acc = acc + (1 << (PRECISION_BITS - 1))
    return np.clip(acc >> PRECISION_BITS, 0, 255)


def _premultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBA -> RGBa (LA -> La): colour * alpha / 255, rounded as
    MULDIV255."""
    a = img[..., -1:]
    t = img[..., :-1] * a + 128
    return np.concatenate([((t >> 8) + t) >> 8, a], axis=-1)


def _unpremultiply(img: np.ndarray) -> np.ndarray:
    """PIL's RGBa -> RGBA: colour * 255 / alpha (integer division, clipped),
    colour kept where alpha is 0 or 255."""
    a = img[..., -1:]
    div = np.clip(img[..., :-1] * 255 // np.maximum(a, 1), 0, 255)
    keep = (a == 0) | (a == 255)
    return np.concatenate([np.where(keep, img[..., :-1], div), a], axis=-1)


def _resize(img: np.ndarray, width: int, height: int, kernel, support,
            resample=_resample_axis) -> np.ndarray:
    """`resample` is one pass: `_resample_axis` (the C++ helper, on uint8)
    or `_resample_axis_plain` (numpy, on int64); both give the same bytes."""
    arr = np.asarray(img)
    if arr.shape[0] == height and arr.shape[1] == width:
        return arr
    gray = arr.ndim == 2
    x = arr[..., None] if gray else arr
    alpha = x.shape[2] in (2, 4)
    if alpha:
        x = _premultiply(x.astype(np.int64))
    dtype = np.int64 if resample is _resample_axis_plain else np.uint8
    x = x.astype(dtype, copy=False)     # premultiplied values lie in [0, 255]
    if x.shape[1] != width:
        x = resample(x, width, 1, kernel, support)
    if x.shape[0] != height:
        x = resample(x, height, 0, kernel, support)
    if alpha:
        x = _unpremultiply(x.astype(np.int64))
    out = x.astype(np.uint8)
    return out[..., 0] if gray else out


def resize_lanczos(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [height, width(, C)] as PIL's
    `Image.resize((width, height), Image.LANCZOS)` gives it; the array
    itself at the same size."""
    return _resize(img, width, height, _lanczos, LANCZOS_SUPPORT)


def resize_lanczos_plain(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`resize_lanczos` through the numpy passes (`_resample_axis_plain`)."""
    return _resize(img, width, height, _lanczos, LANCZOS_SUPPORT, _resample_axis_plain)


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> [height, width(, C)] as PIL's
    `Image.resize((width, height), Image.BILINEAR)` gives it: the same
    fixed-point passes with the triangle filter (support 1, stretched by
    the scale when shrinking)."""
    return _resize(img, width, height, _bilinear, BILINEAR_SUPPORT)


def resize_bilinear_plain(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """`resize_bilinear` through the numpy passes (`_resample_axis_plain`)."""
    return _resize(img, width, height, _bilinear, BILINEAR_SUPPORT, _resample_axis_plain)


def load_image(path: str, width: int, height: int) -> np.ndarray:
    """A PNG as uint8 [H, W] or [H, W, C], resized with Lanczos to
    (width, height) where it differs."""
    return resize_lanczos(read_png(path), width, height)


# --- other formats, through packages the card machine may lack ---------------

def _pillow(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path}: only PNG is read and written without a package; "
                          "this file needs Pillow (pip install pillow)") from e
    return Image


def read_image(path: str) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] of a PNG (the codec above) or, through
    Pillow, of any other format Pillow reads (JPEG); without Pillow a
    non-PNG raises an ImportError that names the file."""
    if path.lower().endswith(".png"):
        return read_png(path)
    return np.asarray(_pillow(path).open(path))


def write_image(path: str, img: np.ndarray) -> None:
    """A uint8 image to `path`: PNG through the codec above, any other
    extension (JPEG) through Pillow's `Image.save` defaults."""
    if path.lower().endswith(".png"):
        write_png(path, img)
    else:
        _pillow(path).fromarray(img).save(path)


def to_gray(img: np.ndarray) -> np.ndarray:
    """PIL's `convert("L")` of a decoded image: gray and gray+alpha keep
    their gray channel, RGB(A) takes the ITU-R 601-2 luma in PIL's
    fixed point, (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    if img.ndim == 2:
        return img
    if img.shape[2] <= 2:
        return img[..., 0]
    rgb = img[..., :3].astype(np.int64)
    return ((rgb[..., 0] * 19595 + rgb[..., 1] * 38470 + rgb[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)
