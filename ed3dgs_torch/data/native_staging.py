"""Asynchronous image staging for the training loop (the port's counterpart
of ed3dgs_tpu/data/native_staging.py).

    stager = Stager()
    stager.submit(cam)          # decode on a worker thread
    stager.fetch_into(cam)      # blocks only if the decode is not done yet

The training tool submits iteration i+1's cameras while the card runs step
i, so the host's PNG decode hides behind the step. The JAX package decodes
on C++ threads through libpng (native/staging.cpp); the port decodes each
camera through its own `image_loader` (data/readers.py: `zlib` inflate, the
C++ unfilter of data/image_io.py, the float conversion), on a small Python
thread pool: `zlib` and the ctypes call release the GIL, so the workers run
beside the training loop's own Python. It records the host milliseconds each
decode took and how long `fetch_into` waited for one.
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor


WORKERS = 2     # a batch's frames decode side by side (the JAX tool's count)


class Stager:
    """Prefetching image loader over a thread pool; one per training run."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=WORKERS,
                                        thread_name_prefix="ed3dgs-stage")
        self._pending = {}
        self.decode_ms = []     # host ms of each decode, on its worker
        self.wait_ms = []       # ms each fetch_into waited for its decode

    def submit(self, cam) -> bool:
        """Queue the decode of a Camera's image (and masks); returns False if
        it has no loader, its image is already loaded or it is queued."""
        if cam.image_loader is None or cam._image is not None or id(cam) in self._pending:
            return False
        self._pending[id(cam)] = self._pool.submit(self._decode, cam)
        return True

    def _decode(self, cam):
        t0 = time.perf_counter()
        out = cam.image_loader(cam)
        self.decode_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def fetch_into(self, cam) -> bool:
        """Complete a pending decode and install its arrays on the camera.
        Returns False if nothing was pending (the camera then loads lazily);
        re-raises a decode's error."""
        fut = self._pending.pop(id(cam), None)
        if fut is None:
            return False
        t0 = time.perf_counter()
        cam._image, cam._mask, cam._tongue_mask = fut.result()
        self.wait_ms.append((time.perf_counter() - t0) * 1e3)
        return True

    def close(self):
        self._pool.shutdown(wait=True, cancel_futures=True)
        self._pending.clear()
