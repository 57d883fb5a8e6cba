"""The port's tfevents writer (ed3dgs_torch/utils/tb_writer.py) against
ed3dgs_tpu's: the port's events are read back by the JAX package's
`read_events` and the JAX package's by the port's, scalars bit-exactly
(both store float32) and every record's two CRC32Cs checked; the image
event's PNG decodes (PIL) to the image written."""

import glob
import io
import os
import struct

import numpy as np
from PIL import Image

from ed3dgs_tpu.utils import tb_writer as jtb

from ed3dgs_torch.utils import tb_writer as ttb


def write_events(mod, log_dir):
    w = mod.SummaryWriter(str(log_dir))
    rng = np.random.default_rng(0)
    rows = []
    for step in range(1, 30):
        for tag in ("train_loss_patches/total_loss", "train_loss_patches/psnr", "iter_time"):
            v = float(np.float32(rng.normal()))
            w.add_scalar(tag, v, step)
            rows.append((step, tag, v))
    w.add_scalar("test/psnr", 31.25, 1 << 40)          # a step past 32 bits
    rows.append((1 << 40, "test/psnr", 31.25))
    w.close()
    (path,) = glob.glob(os.path.join(str(log_dir), "events.out.tfevents.*"))
    return path, rows


def test_port_events_read_by_jax(tmp_path):
    path, rows = write_events(ttb, tmp_path)
    assert jtb.read_events(path) == rows
    assert ttb.read_events(path) == rows


def test_jax_events_read_by_port(tmp_path):
    path, rows = write_events(jtb, tmp_path)
    assert ttb.read_events(path) == rows


def test_crc32c_and_image_event(tmp_path):
    """CRC32C against the JAX package's on random payloads (and the
    standard check value), and an image event whose PNG is the port's."""
    assert ttb.crc32c(b"123456789") == 0xE3069283
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 300):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert ttb.crc32c(data) == jtb.crc32c(data)
    img = rng.uniform(0, 1, (3, 12, 17)).astype(np.float32)
    w = ttb.SummaryWriter(str(tmp_path))
    w.add_image("render", img, 5)
    w.close()
    (path,) = glob.glob(os.path.join(str(tmp_path), "events.out.tfevents.*"))
    assert jtb.read_events(path) == []                 # no scalars; both CRCs pass
    raw = open(path, "rb").read()
    start = raw.index(b"\x89PNG")
    png = Image.open(io.BytesIO(raw[start:]))
    want = (np.clip(img, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    np.testing.assert_array_equal(np.asarray(png), want)
    assert struct.unpack("<Q", raw[:8])[0] > 0
