"""Interactive viewer: the L7 display layer.

The reference opens a GLFW window and blits the backend render target
through a swapchain (main.cpp:29-271, vulkan/vkdisplay.cpp,
util/display/gldisplay.cpp) with WASD/mouse camera movement
(libapp/camera_state.h:48-98) and accumulation reset on camera change
(app.cpp:312-336). Accelerator hosts are often headless, so the display here is a
dependency-free localhost web viewer: a background HTTP server streams
PNG-encoded frames of ``readback_framebuffer()`` to a browser canvas and
feeds key/mouse input back into the frame loop. The loop itself mirrors
``run_app``: input -> camera update -> reset-on-change -> render ->
display -> imstate persistence, with the relaunch-on-rebuild watcher
(app_state.cpp:537-555) wired in.

Usage: default CLI mode (no --validation/--profiling/--data-capture)
starts the viewer unless --disable-ui is given.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from realtimepathtracingresearchframework_tpu.utils import image_io
from realtimepathtracingresearchframework_tpu.utils.error_io import info

_PAGE = """<!DOCTYPE html>
<html><head><title>rptr</title><style>
body { margin:0; background:#111; color:#ccc; font:12px monospace; }
#hud { position:fixed; top:4px; left:6px; }
canvas { display:block; margin:0 auto; image-rendering:pixelated; }
#panel { position:fixed; top:0; right:0; bottom:0; width:290px;
  overflow-y:auto; background:#1b1b1bee; padding:8px; display:none; }
#panel h3 { margin:10px 0 2px; font-size:12px; color:#8ac; }
#panel h4 { margin:6px 0 2px; font-size:11px; color:#a98; }
#panel label { display:block; margin:2px 0; }
#panel input, #panel select { background:#222; color:#ddd;
  border:1px solid #444; font:11px monospace; width:60px; }
#panel input[type=checkbox] { width:auto; }
#panel select { width:180px; }
#panel .v3 input { width:52px; }
#gear { position:fixed; top:4px; right:8px; cursor:pointer; }
</style></head><body>
<div id="hud"></div><div id="gear">[settings]</div>
<div id="panel"></div><canvas id="c"></canvas>
<script>
const canvas = document.getElementById('c'), hud = document.getElementById('hud');
const panel = document.getElementById('panel');
const ctx = canvas.getContext('2d');
let keys = {}, drag = null, wheel = 0, seq = 0;
const typing = () => ['INPUT', 'SELECT'].includes(document.activeElement.tagName);
onkeydown = e => { if (!typing()) keys[e.key.toLowerCase()] = true; };
onkeyup = e => { keys[e.key.toLowerCase()] = false; };
document.getElementById('gear').onclick = () => {
  panel.style.display = panel.style.display === 'block' ? 'none' : 'block';
  if (panel.style.display === 'block') loadSettings();
};
function sendEdit(target, path, attr, value) {
  fetch('/set', {method:'POST',
    body: JSON.stringify({target, path, attr, value})});
}
async function loadSettings() {
  const s = await (await fetch('/settings')).json();
  panel.innerHTML = '';
  const sel = document.createElement('select');
  for (const v of s.variants) {
    const o = document.createElement('option');
    o.value = o.textContent = v;
    if (v === s.variant) o.selected = true;
    sel.appendChild(o);
  }
  sel.onchange = () => sendEdit('Renderer', [], 'variant', sel.value);
  const vl = document.createElement('label');
  vl.textContent = 'variant ';
  vl.appendChild(sel);
  panel.appendChild(vl);
  for (const t of s.targets) {
    const h = document.createElement('h3');
    h.textContent = t.target;
    panel.appendChild(h);
    for (const g of t.groups) {
      if (g.path.length) {
        const h4 = document.createElement('h4');
        h4.textContent = g.path.join('.');
        panel.appendChild(h4);
      }
      for (const a of g.attrs) {
        const lab = document.createElement('label');
        lab.textContent = a.name + ' ';
        const send = vals => sendEdit(t.target, g.path, a.name, vals);
        if (a.kind === 'bool') {
          const inp = document.createElement('input');
          inp.type = 'checkbox';
          inp.checked = a.value.trim() === '1';
          inp.onchange = () => send(inp.checked ? '1' : '0');
          lab.appendChild(inp);
        } else if (a.kind.startsWith('vec')) {
          lab.className = 'v3';
          const parts = a.value.split(/\\s+/);
          const inputs = parts.map(p => {
            const inp = document.createElement('input');
            inp.type = 'number'; inp.step = 'any';
            inp.value = parseFloat(p);
            lab.appendChild(inp);
            return inp;
          });
          const fire = () => send(inputs.map(i => i.value || '0').join(' '));
          inputs.forEach(i => i.onchange = fire);
        } else if (a.kind === 'int' || a.kind === 'float') {
          const inp = document.createElement('input');
          inp.type = 'number';
          inp.step = a.kind === 'int' ? '1' : 'any';
          inp.value = parseFloat(a.value);
          inp.onchange = () => send(inp.value);
          lab.appendChild(inp);
        } else {
          const inp = document.createElement('input');
          inp.type = 'text'; inp.style.width = '160px';
          inp.value = a.value;
          inp.onchange = () => send(inp.value);
          lab.appendChild(inp);
        }
        panel.appendChild(lab);
      }
    }
  }
}
canvas.onmousedown = e => { drag = {x:e.clientX, y:e.clientY, b:e.button}; };
onmouseup = () => { drag = null; };
let dragDelta = [0,0,0];
onmousemove = e => {
  if (drag) { dragDelta[0] += e.movementX; dragDelta[1] += e.movementY; dragDelta[2] = drag.b; }
};
onwheel = e => { wheel += e.deltaY > 0 ? -1 : 1; };
canvas.oncontextmenu = e => e.preventDefault();
async function pump() {
  const input = { keys: Object.keys(keys).filter(k => keys[k]),
                  drag: dragDelta, wheel: wheel };
  dragDelta = [0,0,0]; wheel = 0;
  try {
    await fetch('/input', {method:'POST', body: JSON.stringify(input)});
    const img = new Image();
    img.onload = () => {
      canvas.width = img.width; canvas.height = img.height;
      ctx.drawImage(img, 0, 0);
      requestAnimationFrame(pump);
    };
    img.onerror = () => setTimeout(pump, 250);
    img.src = '/frame?seq=' + (seq++);
    const s = await (await fetch('/stats')).json();
    hud.textContent = `${s.width}x${s.height}  spp ${s.spp}  ` +
                      `${s.render_ms.toFixed(1)} ms  ${s.mrays.toFixed(2)} Mray/s`;
  } catch (err) { setTimeout(pump, 500); }
}
pump();
</script></body></html>"""


def _encode_png(px: np.ndarray) -> bytes:
    """uint8/float (H, W, 3|4) -> PNG bytes (fast compression for the
    live frame stream)."""
    return image_io.encode_png(px, compress_level=1)


class _ViewerState:
    """Shared between the HTTP handler threads and the frame loop."""

    def __init__(self):
        self.lock = threading.Lock()
        self.frame_png: bytes = b""
        self.stats = {"width": 0, "height": 0, "spp": 0, "render_ms": 0.0,
                      "mrays": 0.0}
        self.pressed: set = set()
        self.drag = np.zeros(3)
        self.wheel = 0.0
        self.quit = False
        self.edits: list = []  # queued widget edits for the frame loop
        self.settings_json: bytes = b"{}"  # refreshed by the frame loop


def _make_handler(state: _ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, _PAGE.encode(), "text/html")
            elif path == "/frame":
                with state.lock:
                    png = state.frame_png
                self._send(200, png, "image/png")
            elif path == "/stats":
                with state.lock:
                    body = json.dumps(state.stats).encode()
                self._send(200, body, "application/json")
            elif path == "/settings":
                with state.lock:
                    body = state.settings_json
                self._send(200, body, "application/json")
            else:
                self._send(404, b"", "text/plain")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(n) if n else b"{}"
            path = self.path.split("?")[0]
            if path == "/input":
                try:
                    ev = json.loads(body)
                except json.JSONDecodeError:
                    ev = {}
                with state.lock:
                    state.pressed = set(ev.get("keys", []))
                    d = ev.get("drag", [0, 0, 0])
                    state.drag += np.asarray(d[:3], np.float64)
                    state.wheel += float(ev.get("wheel", 0.0))
                self._send(200, b"{}", "application/json")
            elif path == "/set":
                try:
                    ev = json.loads(body)
                except json.JSONDecodeError:
                    ev = {}
                with state.lock:
                    state.edits.append(ev)
                self._send(200, b"{}", "application/json")
            elif path == "/quit":
                with state.lock:
                    state.quit = True
                self._send(200, b"{}", "application/json")
            else:
                self._send(404, b"", "text/plain")

    return Handler


class InteractiveViewer:
    """run_app's interactive frame loop over a web display."""

    # key -> camera-local movement axis (-z forward; camera_state.h:67-84)
    _MOVE_KEYS = {
        "w": (0, 0, -1), "s": (0, 0, 1), "d": (1, 0, 0), "a": (-1, 0, 0),
        " ": (0, 1, 0), "q": (0, -1, 0),
    }

    def __init__(self, renderer, bundle, ims, host: str = "127.0.0.1",
                 port: int = 8421, speed: float = 1.5,
                 sensitivity: float = 0.005, watch_rebuild: bool = True,
                 app_ini: Optional[str] = None):
        self.renderer = renderer
        self.bundle = bundle
        self.ims = ims
        self.speed = speed
        self.sensitivity = sensitivity
        self.app_ini = app_ini
        self.state = _ViewerState()
        self.server = ThreadingHTTPServer((host, port), _make_handler(self.state))
        self.port = self.server.server_address[1]
        self._watcher = None
        if watch_rebuild:
            from realtimepathtracingresearchframework_tpu.app.relaunch import (
                RebuildWatcher,
            )

            self._watcher = RebuildWatcher()

    # -- input -> camera (default_camera_movement, camera_state.h:48-98) --

    def _apply_input(self, dt: float) -> bool:
        st = self.state
        with st.lock:
            pressed = set(st.pressed)
            drag = st.drag.copy()
            st.drag[:] = 0.0
            wheel = st.wheel
            st.wheel = 0.0
        cam_state = self.bundle.scene.camera
        cam = cam_state.to_camera()
        changed = False
        for key, axis in self._MOVE_KEYS.items():
            if key in pressed:
                cam.move_local(axis, dt, self.speed)
                changed = True
        if drag[0] or drag[1]:
            if int(drag[2]) == 2:  # right button: pan
                cam.pan((drag[0] * self.sensitivity, drag[1] * self.sensitivity))
            else:  # left: rotate
                cam.rotate(
                    yaw_rad=-drag[0] * self.sensitivity,
                    pitch_rad=-drag[1] * self.sensitivity,
                )
            changed = True
        if wheel:
            cam.zoom(wheel * 0.1, self.speed)
            changed = True
        if changed:
            cam_state.position = np.asarray(cam.pos, np.float64)
            cam_state.direction = np.asarray(cam.dir, np.float64)
            cam_state.up = np.asarray(cam.up, np.float64)
        return changed

    def _persist_state(self):
        if self.app_ini:
            self.ims.save_ini(self.app_ini)

    # -- settings widgets (the ImGui half of imstate dual-mode) --

    def _settings_payload(self) -> bytes:
        r = self.renderer
        return json.dumps({
            "targets": self.ims.describe(),
            "variant": r.active_variant,
            "variants": r.supported_variants(),
        }).encode()

    def _apply_edits(self) -> bool:
        """Drain queued widget edits on the frame-loop thread (renderer
        mutation + state writes stay single-threaded, like the reference
        app's UI pass before rendering, app.cpp:262-270). Returns True
        if anything changed (caller restarts accumulation)."""
        with self.state.lock:
            edits, self.state.edits = self.state.edits, []
        changed = False
        for ev in edits:
            target = str(ev.get("target", ""))
            attr = str(ev.get("attr", ""))
            value = str(ev.get("value", ""))
            path = tuple(str(p) for p in ev.get("path", []))
            if target == "Renderer" and attr == "variant":
                if self.renderer.set_variant(value):
                    # keep the selection an ini attribute too
                    # (app_state.cpp:117-143 stores it in app state)
                    self.bundle.app.variant = self.renderer.active_variant
                    changed = True
                continue
            if self.ims.apply_raw(target, path, attr, value):
                changed = True
        return changed

    def run(self, max_frames: Optional[int] = None) -> int:
        """The interactive loop (app.cpp:243-585). Returns rendered frame
        count; exits on /quit, max_frames, or relaunch."""
        threading.Thread(target=self.server.serve_forever, daemon=True).start()
        info("viewer: http://127.0.0.1:%d/ (POST /quit to exit)", self.port)
        r = self.renderer
        frames = 0
        last_t = time.perf_counter()
        try:
            while True:
                with self.state.lock:
                    if self.state.quit:
                        break
                now = time.perf_counter()
                dt, last_t = now - last_t, now
                changed = self._apply_input(min(dt, 0.1))
                changed = self._apply_edits() or changed
                if changed:
                    r.reset_accumulation()  # app.cpp:312-336
                r.render(self.bundle.frame_config())
                frames += 1
                fb = r.readback_framebuffer()
                stats = r.stats(force_rays=True)
                png = _encode_png(fb[..., :3])
                settings_json = self._settings_payload()
                with self.state.lock:
                    self.state.frame_png = png
                    self.state.settings_json = settings_json
                    self.state.stats = {
                        "width": r.fb_width, "height": r.fb_height,
                        "spp": int(stats.spp),
                        "render_ms": float(stats.render_time),
                        "mrays": float(stats.rays_per_second) / 1e6
                        if stats.rays_per_second > 0 else 0.0,
                    }
                if self._watcher is not None and self._watcher.changed():
                    from realtimepathtracingresearchframework_tpu.app.relaunch import (
                        relaunch,
                    )

                    self._persist_state()
                    self.server.shutdown()
                    relaunch()  # no return
                if max_frames is not None and frames >= max_frames:
                    break
        finally:
            self._persist_state()
            self.server.shutdown()
        return frames
