"""The viewer of the port (render/network_gui.py, tools/viewer.py) against
the JAX package on the CPU.

The protocol round trip of tests/test_network_gui.py through both servers:
each parsed request equal to the JAX package's field for field (GL column
flips and transposes included), each reply's bytes equal for the same
render function, an empty request (resolution 0) answered with the verify
string alone. The viewer's image on a hermetic model, at 64x64 and at a
resolution that is not a multiple of 16, within 1 LSB of the JAX viewer's
`handle` quantised the same way (the renders agree at the raster bound of
1e-5).
"""

import json
import socket
import threading

import numpy as np
import pytest

from ed3dgs_tpu.render import network_gui as jgui
from ed3dgs_tpu.tools import viewer as jviewer

from ed3dgs_torch.render import network_gui as tgui
from ed3dgs_torch.tools import viewer as tviewer
from test_torch_threads import one_torch_thread  # noqa: F401  (autouse)
from torch_offline_model import SET, make_model


def message(w, h, seed):
    rng = np.random.default_rng(seed)
    return {"resolution_x": w, "resolution_y": h, "fov_x": 1.0, "fov_y": 0.8,
            "z_near": 0.01, "z_far": 100.0, "train": False, "shs_python": False,
            "rot_scale_python": False, "keep_alive": True, "scaling_modifier": 1.0,
            "view_matrix": list(rng.normal(size=16)),
            "view_projection_matrix": list(rng.normal(size=16))}


def recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk
        buf += chunk
    return buf


def exchange(server_cls, messages, render_fn):
    """Serve `messages` through one server; returns (requests the render
    function saw, each reply's bytes)."""
    server = server_cls("127.0.0.1", 0)
    port = server.listener.getsockname()[1]
    seen = []

    def fn(cam):
        seen.append(cam)
        return render_fn(cam)
    t = threading.Thread(target=server.serve_forever, args=(fn,),
                         kwargs={"verify": "model-x", "max_requests": len(messages)})
    t.start()
    replies = []
    try:
        client = socket.create_connection(("127.0.0.1", port), timeout=10)
        for msg in messages:
            payload = json.dumps(msg).encode()
            client.sendall(len(payload).to_bytes(4, "little") + payload)
            w, h = msg["resolution_x"], msg["resolution_y"]
            img = recv_exact(client, w * h * 3)
            n = recv_exact(client, 4)
            replies.append(img + n + recv_exact(client, int.from_bytes(n, "little")))
        client.close()
    finally:
        t.join(timeout=10)
        server.close()
    assert not t.is_alive()
    return seen, replies


def test_protocol_round_trip_matches_jax():
    msgs = [message(32, 24, 0), message(0, 0, 1), message(17, 9, 2)]

    def render_fn(cam):
        rng = np.random.default_rng(cam["width"])
        return rng.uniform(-0.2, 1.2, (3, cam["height"], cam["width"])).astype(np.float32)
    jseen, jreplies = exchange(jgui.ViewerServer, msgs, render_fn)
    tseen, treplies = exchange(tgui.ViewerServer, msgs, render_fn)
    assert treplies == jreplies
    assert treplies[1] == (7).to_bytes(4, "little") + b"model-x"
    assert len(tseen) == len(jseen) == 2
    for t, j in zip(tseen, jseen):
        assert t.keys() == j.keys()
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
            assert np.asarray(t[k]).dtype == np.asarray(j[k]).dtype
    img = np.frombuffer(treplies[0][:32 * 24 * 3], np.uint8).reshape(24, 32, 3)
    assert img.min() == 0 and img.max() == 255


@pytest.fixture(scope="module")
def offline_model(tmp_path_factory):
    return make_model(str(tmp_path_factory.mktemp("viewer")), n_points=150)


def captured_handler(monkeypatch, module, main, argv):
    """Run a viewer's main with a server that records its handler and
    returns at once."""
    got = {}

    class Server:
        def __init__(self, *a):
            pass

        def serve_forever(self, handle, verify="ok", max_requests=None):
            got["handle"], got["verify"] = handle, verify

        def close(self):
            pass
    monkeypatch.setattr(module, "ViewerServer", Server)
    main(argv)
    return got


def quantised(img):
    return (np.clip(np.asarray(img), 0, 1).transpose(1, 2, 0) * 255).astype(np.uint8)


def test_viewer_renders_as_jax(offline_model, monkeypatch):
    scene, model, flags = offline_model
    argv = flags + ["--iteration", "10", "--time", "0.5", "--set", *SET]
    jgot = captured_handler(monkeypatch, jgui, jviewer.main, argv)
    tgot = captured_handler(monkeypatch, tgui, tviewer.main, argv + ["--device", "cpu"])
    assert tgot["verify"] == jgot["verify"] == model
    from ed3dgs_torch.data.cameras import look_at_camera
    for w, h in ((64, 64), (70, 45)):
        cam = look_at_camera((0.1, -0.1, 0.0), (0.0, 0.0, 2.0), (0.0, -1.0, 0.0),
                             1.0, 1.0 * h / w, w, h).matrices()
        req = {"width": w, "height": h, "fovx": 1.0, "fovy": 1.0 * h / w,
               "world_view": cam.world_view, "full_proj": cam.full_proj}
        want = quantised(jgot["handle"](req))
        got = tgot["handle"](req)
        assert tuple(got.shape) == (3, h, w)
        got = quantised(got)
        assert np.abs(got.astype(int) - want).max() <= 1
        assert (got != want).mean() < 0.01 and want.std() > 5


def test_viewer_keeps_the_first_fov_of_a_resolution_as_jax(offline_model, monkeypatch):
    """Carried over from the JAX tool: the raster setup of a resolution is
    made at its first request, so a later request at that size with another
    fov (a zoom) renders with the first request's focals. Both packages
    answer the second request alike, and the port's answer equals its
    answer to that request sent with the first fov."""
    scene, model, flags = offline_model
    argv = flags + ["--iteration", "10", "--time", "0.5", "--set", *SET]
    jgot = captured_handler(monkeypatch, jgui, jviewer.main, argv)
    tgot = captured_handler(monkeypatch, tgui, tviewer.main, argv + ["--device", "cpu"])
    from ed3dgs_torch.data.cameras import look_at_camera
    w, h = 64, 48

    def request(fovx):
        cam = look_at_camera((0.1, -0.1, 0.0), (0.0, 0.0, 2.0), (0.0, -1.0, 0.0),
                             fovx, fovx * h / w, w, h).matrices()
        return {"width": w, "height": h, "fovx": fovx, "fovy": fovx * h / w,
                "world_view": cam.world_view, "full_proj": cam.full_proj}
    for got in (jgot, tgot):
        got["handle"](request(1.0))
    zoom = request(0.6)
    want = quantised(jgot["handle"](zoom))
    got = tgot["handle"](zoom)
    q = quantised(got)
    assert np.abs(q.astype(int) - want).max() <= 1 and (q != want).mean() < 0.01
    # a fresh handler: the zoom's matrices with the first fov give the same
    # image; the zoom sent first (its own focals) gives another
    fresh = captured_handler(monkeypatch, tgui, tviewer.main, argv + ["--device", "cpu"])
    np.testing.assert_array_equal(
        np.asarray(fresh["handle"](dict(zoom, fovx=1.0, fovy=1.0 * h / w))), np.asarray(got))
    own = captured_handler(monkeypatch, tgui, tviewer.main, argv + ["--device", "cpu"])
    assert np.abs(np.asarray(own["handle"](zoom)) - np.asarray(got)).max() > 0.05
