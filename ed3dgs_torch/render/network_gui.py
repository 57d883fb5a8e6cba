"""Interactive viewer socket server, SIBR remote-viewer protocol (port of
ed3dgs_tpu/render/network_gui.py; the reference
gaussian_renderer/network_gui.py).

A little-endian length-prefixed JSON request carries a camera (resolution,
fovs, view and view-projection matrices in the viewer's GL convention); the
reply is the raw RGB bytes of the render plus a length-prefixed
verification string. The image is quantised on its device (clip to [0, 1],
x * 255 truncated to uint8) and only the bytes cross to the host.

    python -m ed3dgs_torch.tools.viewer -m <model_dir> -s <scene_dir> ...
"""

from __future__ import annotations

import json
import socket
import time
from typing import Callable, Optional

import numpy as np
import torch


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read_request(self) -> Optional[dict]:
        """One length-prefixed JSON message -> camera dict (None = empty)."""
        n = int.from_bytes(self._recv_exact(4), "little")
        msg = json.loads(self._recv_exact(n).decode("utf-8"))
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None
        view = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        proj = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        # the viewer sends GL-convention column-flipped transposed matrices
        # (network_gui.py:73-76): flip Y/Z columns, then un-transpose to the
        # math convention this framework uses everywhere
        view[:, 1] *= -1
        view[:, 2] *= -1
        proj[:, 1] *= -1
        return {
            "width": width, "height": height,
            "fovx": msg["fov_x"], "fovy": msg["fov_y"],
            "znear": msg["z_near"], "zfar": msg["z_far"],
            "train": bool(msg.get("train", False)),
            "keep_alive": bool(msg.get("keep_alive", True)),
            "scaling_modifier": msg.get("scaling_modifier", 1.0),
            "world_view": view.T,       # -> math convention
            "full_proj": proj.T,
        }

    def send_image(self, image_chw, verify: str):
        """Raw RGB bytes (H*W*3 uint8) + length-prefixed verify string.
        `image_chw` is a [3, H, W] float tensor (on any device) or array."""
        if image_chw is not None:
            img = torch.clamp(torch.as_tensor(image_chw), 0, 1)
            payload = (img.permute(1, 2, 0) * 255).to(torch.uint8).cpu().numpy().tobytes()
            self.conn.sendall(payload)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def serve_forever(self, render_fn: Callable[[dict], object],
                      verify: str = "ok", max_requests: Optional[int] = None):
        """Blocking loop: accept one client, answer render requests.
        render_fn(camera_dict) -> [3, H, W] float image."""
        served = 0
        while max_requests is None or served < max_requests:
            if not self.try_connect():
                time.sleep(0.05)
                continue
            try:
                cam = self.read_request()
                img = render_fn(cam) if cam is not None else None
                self.send_image(img, verify)
                served += 1
            except (ConnectionError, OSError):
                self.conn.close()
                self.conn = None

    def close(self):
        if self.conn is not None:
            self.conn.close()
        self.listener.close()
