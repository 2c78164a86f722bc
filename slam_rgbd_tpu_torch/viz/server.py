"""Web point-cloud viewer: a Three.js page and a stdlib HTTP backend.

Counterpart of `slam_rgbd_tpu/viz/server.py`. A `http.server` thread serves
`/` (the Three.js page), `/pointcloud` (the JSON payload of the current
cloud), `/healthz`, and over the native C++ rasterizer (`viz.native`, on
the host) `/native` (page), `/native/frame` (a PNG of the current cloud),
`/native/orbit` and `/native/zoom` (the viewer's mouse verbs). The cloud
comes from a callable evaluated a request, so a live session streams its
current map.
"""

from __future__ import annotations

import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional
from urllib.parse import parse_qs, urlparse

from slam_rgbd_tpu_torch.viz.pointcloud import pointcloud_json


def encode_png(rgb) -> bytes:
    """Minimal RGB8 PNG encoder (filter-0 rows, one zlib IDAT) — enough to
    stream native-viewer frames to a browser with no image library."""
    import numpy as np

    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    raw = b"".join(
        b"\x00" + rgb[y].tobytes() for y in range(h)
    )

    def chunk(tag: bytes, payload: bytes) -> bytes:
        return (
            struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )

INDEX_HTML = """<!DOCTYPE html>
<html>
<head>
  <title>slam_rgbd_tpu — point cloud</title>
  <style>body { margin: 0; background: #0b0e14; } #hud { position: fixed;
    top: 8px; left: 10px; color: #9fb2c8; font: 12px monospace; }</style>
</head>
<body>
<div id="hud">slam_rgbd_tpu viewer — drag: orbit, wheel: zoom, r: reload</div>
<script src="https://cdn.jsdelivr.net/npm/three@0.128.0/build/three.min.js"></script>
<script>
const scene = new THREE.Scene();
const camera = new THREE.PerspectiveCamera(60, innerWidth/innerHeight, 0.01, 100);
camera.position.set(0, 0, -2);
const renderer = new THREE.WebGLRenderer({antialias: true});
renderer.setSize(innerWidth, innerHeight);
document.body.appendChild(renderer.domElement);
let cloud = null, theta = 0, phi = 0, dist = 2, dragging = false, px = 0, py = 0;

async function load() {
  const r = await fetch('/pointcloud');
  const data = await r.json();
  const geo = new THREE.BufferGeometry();
  geo.setAttribute('position', new THREE.Float32BufferAttribute(data.positions, 3));
  let mat;
  if (data.colors) {
    geo.setAttribute('color', new THREE.Float32BufferAttribute(data.colors, 3));
    mat = new THREE.PointsMaterial({size: 0.01, vertexColors: true});
  } else {
    mat = new THREE.PointsMaterial({size: 0.01, color: 0x88bbff});
  }
  if (cloud) scene.remove(cloud);
  cloud = new THREE.Points(geo, mat);
  // match the native viewer's (-x, -y, -z) presentation (viewerModule.c:351)
  cloud.scale.set(-1, -1, -1);
  scene.add(cloud);
}
addEventListener('mousedown', e => { dragging = true; px = e.clientX; py = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', e => {
  if (!dragging) return;
  theta += (e.clientX - px) * 0.005; phi += (e.clientY - py) * 0.005;
  px = e.clientX; py = e.clientY;
});
addEventListener('wheel', e => { dist *= e.deltaY > 0 ? 1.1 : 0.9; });
addEventListener('keydown', e => { if (e.key === 'r') load(); });
function animate() {
  requestAnimationFrame(animate);
  camera.position.set(dist*Math.sin(theta)*Math.cos(phi),
                      dist*Math.sin(phi), -dist*Math.cos(theta)*Math.cos(phi));
  camera.lookAt(0, 0, 0);
  renderer.render(scene, camera);
}
load(); animate();
</script>
</body>
</html>
"""


NATIVE_HTML = """<!DOCTYPE html>
<html>
<head>
  <title>slam_rgbd_tpu — native viewer</title>
  <style>body { margin: 0; background: #0b0e14; overflow: hidden; }
    #hud { position: fixed; top: 8px; left: 10px; color: #9fb2c8;
      font: 12px monospace; } img { display: block; margin: auto; }</style>
</head>
<body>
<div id="hud">native viewer (C++ rasterizer) — drag: orbit, wheel: zoom</div>
<img id="view" src="/native/frame" draggable="false">
<script>
// Live interactive loop over the NATIVE renderer: mouse deltas are
// forwarded to viewer_orbit/viewer_zoom (the reference's GLFW input
// semantics, viewerModule.c:416-440) and the freshly rasterized frame
// streams back. The map is re-fetched per frame, so it is LIVE.
const img = document.getElementById('view');
let dragging = false, px = 0, py = 0, inflight = false, gen = 0;
function refresh() {
  if (inflight) return; inflight = true;
  img.onload = () => { inflight = false; };
  img.onerror = () => { inflight = false; };
  img.src = '/native/frame?g=' + (gen++);
}
addEventListener('mousedown', e => { dragging = true; px = e.clientX; py = e.clientY; });
addEventListener('mouseup', () => dragging = false);
addEventListener('mousemove', async e => {
  if (!dragging) return;
  const dx = e.clientX - px, dy = e.clientY - py;
  px = e.clientX; py = e.clientY;
  await fetch(`/native/orbit?dx=${dx}&dy=${dy}`);
  refresh();
});
addEventListener('wheel', async e => {
  await fetch(`/native/zoom?steps=${e.deltaY > 0 ? -1 : 1}`);
  refresh();
});
setInterval(refresh, 1000);  // live map updates even without input
</script>
</body>
</html>
"""


class PointCloudServer:
    """Serves `/` (Three.js page), `/pointcloud` (JSON payload), and — when
    the native library is available — a LIVE interactive loop over the C++
    rasterizer: `/native` (page), `/native/frame` (PNG of the current map
    through `NativeViewer`), `/native/orbit` + `/native/zoom` (mouse verbs
    with the reference viewer's input semantics, `viewerModule.c:416-440`).

    `source` is a zero-arg callable returning (pts (N,3), colors (N,3)|None)
    — evaluated per request so a live session streams its current map.
    """

    def __init__(self, source: Callable, host: str = "127.0.0.1", port: int = 8080):
        self.source = source
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._native = None  # lazily-created NativeViewer (+lock)
        self._native_lock = threading.Lock()

    def _native_viewer(self):
        from slam_rgbd_tpu_torch.viz import native as nviz

        if self._native is None and nviz.native_available():
            self._native = nviz.NativeViewer(960, 720)
        return self._native

    def _render_native_frame(self) -> Optional[bytes]:
        import numpy as np

        with self._native_lock:
            viewer = self._native_viewer()
            if viewer is None:
                return None
            pts, colors = self.source()
            pts = np.asarray(pts, np.float32).reshape(-1, 3)
            if colors is None:
                colors = np.full((len(pts), 3), 200, np.uint8)
            else:
                colors = np.asarray(colors)
                if colors.dtype != np.uint8:  # float [0,1] -> u8
                    colors = np.clip(colors * 255.0, 0, 255).astype(np.uint8)
            frame = viewer.render(pts, colors)
            return encode_png(frame)

    def start(self) -> "PointCloudServer":
        source = self.source
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                url = urlparse(self.path)
                q = parse_qs(url.query)
                if url.path == "/":
                    body = INDEX_HTML.encode()
                    ctype = "text/html"
                elif url.path == "/pointcloud":
                    pts, colors = source()
                    body = pointcloud_json(pts, colors).encode()
                    ctype = "application/json"
                elif url.path == "/healthz":
                    body = b'{"ok": true}'
                    ctype = "application/json"
                elif url.path == "/native":
                    body = NATIVE_HTML.encode()
                    ctype = "text/html"
                elif url.path == "/native/frame":
                    png = outer._render_native_frame()
                    if png is None:
                        self.send_response(503)
                        self.end_headers()
                        self.wfile.write(b"native viewer unavailable")
                        return
                    body = png
                    ctype = "image/png"
                elif url.path == "/native/orbit":
                    with outer._native_lock:
                        v = outer._native_viewer()
                        if v is not None:
                            v.orbit(float(q.get("dx", ["0"])[0]),
                                    float(q.get("dy", ["0"])[0]))
                    body = b'{"ok": true}'
                    ctype = "application/json"
                elif url.path == "/native/zoom":
                    with outer._native_lock:
                        v = outer._native_viewer()
                        if v is not None:
                            v.zoom(int(float(q.get("steps", ["0"])[0])))
                    body = b'{"ok": true}'
                    ctype = "application/json"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet
                pass

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]  # resolve port 0
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="slam-viz-http"
        )
        self._thread.start()
        return self

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
        with self._native_lock:
            if self._native is not None:
                self._native.close()
                self._native = None
