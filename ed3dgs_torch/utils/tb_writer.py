"""Dependency-free TensorBoard event-file writer (the port's own copy of
ed3dgs_tpu/utils/tb_writer.py; images are encoded by the port's PNG codec,
data/image_io.py, instead of PIL).

The reference logs ~18 scalars per step through torch's SummaryWriter
(reference train.py:505-524, periodic test PSNR :389). This image ships no
tensorboard package, so the tfevents container is written directly: each
record is `uint64 length | masked crc32c(length) | Event protobuf | masked
crc32c(payload)`, with the Event/Summary protos hand-encoded (only
wall_time/step/file_version/summary{tag, simple_value, image} fields are
needed). Files are readable by standard TensorBoard.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Optional

# --- crc32c (Castagnoli), table-driven ---------------------------------------

_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --- minimal protobuf encoding ------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _pb_double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _pb_int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(v)) + v


def _pb_str(field: int, v: str) -> bytes:
    return _pb_bytes(field, v.encode("utf-8"))


# --- Event / Summary messages -------------------------------------------------

def _event(payload: bytes, step: Optional[int] = None,
           wall_time: Optional[float] = None) -> bytes:
    msg = _pb_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        msg += _pb_int64(2, step)
    return msg + payload


def _scalar_summary(tag: str, value: float) -> bytes:
    val = _pb_str(1, tag) + _pb_float(2, float(value))
    return _pb_bytes(5, _pb_bytes(1, val))          # Event.summary.value


def _image_summary(tag: str, png_bytes: bytes, height: int, width: int) -> bytes:
    img = (_pb_int64(1, height) + _pb_int64(2, width) + _pb_int64(3, 3)
           + _pb_bytes(4, png_bytes))               # Summary.Image
    val = _pb_str(1, tag) + _pb_bytes(4, img)       # Value.image = field 4
    return _pb_bytes(5, _pb_bytes(1, val))


class SummaryWriter:
    """add_scalar/add_image subset of torch.utils.tensorboard.SummaryWriter."""

    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        fname = "events.out.tfevents.%010d.%s.%d" % (
            int(time.time()), socket.gethostname(), os.getpid())
        self._path = os.path.join(log_dir, fname)
        self._f = open(self._path, "wb")
        self._lock = threading.Lock()
        self._write_record(_event(_pb_str(3, "brain.Event:2")))  # file_version
        self.flush()

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        with self._lock:
            self._f.write(header)
            self._f.write(struct.pack("<I", _masked_crc(header)))
            self._f.write(payload)
            self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value, step: int):
        self._write_record(_event(_scalar_summary(tag, float(value)), step=step))

    def add_image(self, tag: str, img, step: int):
        """img: [3,H,W] or [H,W,3] float in [0,1] or uint8 numpy array."""
        import numpy as np

        from ..data.image_io import encode_png
        arr = np.asarray(img)
        if arr.ndim == 3 and arr.shape[0] in (1, 3):
            arr = arr.transpose(1, 2, 0)
        if arr.dtype != np.uint8:
            arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
        if arr.shape[-1] == 1:
            arr = arr[..., 0]
        h, w = arr.shape[:2]
        self._write_record(_event(_image_summary(tag, encode_png(arr), h, w),
                                  step=step))

    def flush(self):
        with self._lock:
            self._f.flush()

    def close(self):
        self.flush()
        self._f.close()


def read_events(path: str):
    """Parse a tfevents file back into [(step, tag, value)] — the test-side
    inverse (scalars only; also validates both record CRCs)."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "header crc mismatch"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "payload crc mismatch"
            out.extend(_parse_event(payload))
    return out


def _read_varint(buf, i):
    shift = n = 0
    while True:
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def _fields(buf):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            v, i = _read_varint(buf, i)
        elif wire == 1:
            v, i = buf[i:i + 8], i + 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            v, i = buf[i:i + ln], i + ln
        elif wire == 5:
            v, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"wire type {wire}")
        yield field, wire, v


def _parse_event(payload):
    step = 0
    rows = []
    for field, wire, v in _fields(payload):
        if field == 2 and wire == 0:
            step = v
        elif field == 5 and wire == 2:                    # summary
            for f2, w2, v2 in _fields(v):
                if f2 == 1 and w2 == 2:                   # value
                    tag, val = None, None
                    for f3, w3, v3 in _fields(v2):
                        if f3 == 1 and w3 == 2:
                            tag = v3.decode("utf-8")
                        elif f3 == 2 and w3 == 5:
                            (val,) = struct.unpack("<f", v3)
                    if tag is not None and val is not None:
                        rows.append((step, tag, val))
    return rows
