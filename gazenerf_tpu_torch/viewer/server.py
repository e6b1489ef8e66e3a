"""GazeNeRF viewer: a browser page over the no-grad render.

The stdlib ``http.server`` serves a page with sliders for gaze (pitch,
yaw) and a look-at orbit camera (azimuth, elevation, distance); each move
requests ``/render``, which renders one 512x512 image on the card and
returns it as a PNG.
"""

from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Mapping, Optional
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from gazenerf_tpu_torch.config import ModelConfig
from gazenerf_tpu_torch.data.cameras import base_inv_inmat
from gazenerf_tpu_torch.models.gaze_nerf import GazeNeRF, resolve_device
from gazenerf_tpu_torch.ops.rays import pixel_grid
from gazenerf_tpu_torch.utils.png import encode_png

_PAGE = """<!doctype html>
<html><head><title>GazeNeRF viewer</title><style>
body { font-family: sans-serif; margin: 2em; background: #111; color: #eee; }
.row { margin: 0.4em 0; }
label { display: inline-block; width: 10em; }
input[type=range] { width: 22em; vertical-align: middle; }
img { margin-top: 1em; border: 1px solid #444; image-rendering: auto; }
#status { color: #8c8; margin-left: 1em; }
</style></head><body>
<h2>GazeNeRF viewer</h2>
<div class="row"><label>gaze pitch</label>
  <input type="range" id="pitch" min="-0.5" max="0.5" step="0.02" value="0">
  <span id="pitch_v">0</span></div>
<div class="row"><label>gaze yaw</label>
  <input type="range" id="yaw" min="-0.8" max="0.8" step="0.02" value="0">
  <span id="yaw_v">0</span></div>
<div class="row"><label>camera azimuth</label>
  <input type="range" id="az" min="-60" max="60" step="2" value="0">
  <span id="az_v">0</span></div>
<div class="row"><label>camera elevation</label>
  <input type="range" id="el" min="-40" max="40" step="2" value="0">
  <span id="el_v">0</span></div>
<div class="row"><label>camera distance</label>
  <input type="range" id="dist" min="9" max="16" step="0.5" value="12">
  <span id="dist_v">12</span><span id="status"></span></div>
<img id="view" width="512" height="512">
<script>
const ids = ["pitch", "yaw", "az", "el", "dist"];
let inflight = false, dirty = false;
function refresh() {
  if (inflight) { dirty = true; return; }
  inflight = true;
  document.getElementById("status").textContent = "rendering…";
  const q = ids.map(i => i + "=" + document.getElementById(i).value).join("&");
  const img = document.getElementById("view");
  const next = new Image();
  next.onload = () => {
    img.src = next.src;
    document.getElementById("status").textContent = "";
    inflight = false;
    if (dirty) { dirty = false; refresh(); }
  };
  next.src = "/render?" + q + "&t=" + Date.now();
}
ids.forEach(i => {
  const el = document.getElementById(i);
  el.addEventListener("input", () => {
    document.getElementById(i + "_v").textContent = el.value;
    refresh();
  });
});
refresh();
</script></body></html>"""


def lookat_camera(az_deg: float, el_deg: float, dist: float, featmap_size: int):
    """Orbit look-at camera at (azimuth, elevation, distance): ``(R [1,3,3],
    T [1,3,1], inv_inmat [1,3,3])`` as float32 numpy arrays."""
    az = math.radians(az_deg)
    el = math.radians(el_deg)
    vp = np.array(
        [
            dist * math.sin(az) * math.cos(el),
            dist * math.sin(el),
            dist * math.cos(az) * math.cos(el),
        ]
    )
    d1 = -vp
    d2 = np.cross([0.0, -1.0, 0.0], d1)
    d3 = np.cross(d1, d2)
    d1, d2, d3 = (v / np.linalg.norm(v) for v in (d1, d2, d3))
    R = np.stack([d2, d3, d1], axis=1).astype(np.float32)
    return (
        R[None],
        vp.astype(np.float32)[None, :, None],
        base_inv_inmat(featmap_size)[None],
    )


class ViewerApp:
    """Owns the model, the codes and the render; one render at a time."""

    def __init__(
        self,
        cfg: ModelConfig,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        shape_code: Optional[np.ndarray] = None,
        appea_code: Optional[np.ndarray] = None,
        seed: int = 0,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        # without weights the model keeps its seeded random initialisation
        self.model = GazeNeRF(cfg, device=self.device, seed=seed).eval()
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)

        def code(v, dims):
            a = np.zeros((1, dims), np.float32) if v is None else v.reshape(1, -1)
            return torch.as_tensor(a, dtype=torch.float32, device=self.device)

        self.shape_code = code(shape_code, cfg.shape_code_dims)
        self.appea_code = code(appea_code, cfg.appea_code_dims)
        self.xy = pixel_grid(cfg.featmap_size, device=self.device)[None]
        self._lock = threading.Lock()  # one render on the card at a time

    def render_image(self, pitch: float, yaw: float, az: float, el: float,
                     dist: float) -> torch.Tensor:
        """The rendered ``[H, W, 3]`` image on the card, in the renderer's
        dtype, values in [0, 1]: ``merge_img`` of the model's forward, with
        the one renderer pass that makes it (the other three images of the
        forward are not shown)."""
        R, T, K = (
            torch.from_numpy(a).to(self.device)
            for a in lookat_camera(az, el, dist, self.cfg.featmap_size)
        )
        gaze = torch.tensor([[pitch, yaw]], dtype=torch.float32, device=self.device)
        with self._lock, torch.no_grad():
            fm = self.model.render_featmaps(
                self.xy, self.shape_code, self.appea_code, gaze, R, T, K
            )["featmaps"]
            img = self.model.neural_render(fm["merge"])
        return img[0]

    def render(self, pitch: float, yaw: float, az: float, el: float,
               dist: float) -> np.ndarray:
        """``uint8 [H, W, 3]`` RGB."""
        img = self.render_image(pitch, yaw, az, el, dist)
        return torch.clamp(img * 255.0, 0.0, 255.0).to(torch.uint8).cpu().numpy()

    def render_png(self, pitch: float, yaw: float, az: float, el: float,
                   dist: float) -> bytes:
        return encode_png(self.render(pitch, yaw, az, el, dist))


def make_handler(app: ViewerApp):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif u.path == "/render":
                q = {k: float(v[0]) for k, v in parse_qs(u.query).items()
                     if k != "t"}
                png = app.render_png(
                    q.get("pitch", 0.0), q.get("yaw", 0.0), q.get("az", 0.0),
                    q.get("el", 0.0), q.get("dist", 12.0),
                )
                self._send(200, "image/png", png)
            elif u.path == "/health":
                self._send(200, "application/json", json.dumps({"ok": True}).encode())
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


def serve(app: ViewerApp, host: str = "127.0.0.1", port: int = 8631,
          block: bool = True) -> ThreadingHTTPServer:
    """Serve the viewer page and ``/render``: until interrupted, or with
    ``block=False`` from a daemon thread, returning the server at once (the
    caller stops it with ``shutdown()``; port 0 takes a free port, which
    ``server.server_address`` names)."""
    server = ThreadingHTTPServer((host, port), make_handler(app))
    if block:
        print(f"GazeNeRF viewer on http://{host}:{server.server_address[1]}")
        with server:
            server.serve_forever()
    else:
        threading.Thread(target=server.serve_forever, daemon=True).start()
    return server
