"""Live web viewer: the interactive System over HTTP (port of
arkoserenderer_tpu/system/webviewer.py).

The machine with the card has no display server, so the interactive
surface the reference builds on GLFW + Dear ImGui (SystemGlfw.cpp,
Input.h:179-251, the per-node timing plot against the 16.667 ms budget in
RenderPipeline.cpp:76-108, EditorGizmo.h:10-28 and the scene-hierarchy
panel) is a local web page: a stdlib ``ThreadingHTTPServer`` serves the
latest frame as a PNG (``/frame.png``), the per-pass ms table
(``/stats``) and the hierarchy rows (``/hierarchy``), and takes keyboard,
click and select events (``POST /event``) into a queue.

The renderer stays single-threaded: the handler threads touch only the
lock-protected PNG bytes, stats and rows and the event queue, never a
tensor; the render loop (``apps/viewer.py``) drains the events through
``WebSystem.new_frame()`` as a windowing event pump does, dropping an event
whose fields do not parse (the reference's loop raises on one). ``present`` copies
the LDR image to the host once and encodes it with ``utils/imageio``.
"""

from __future__ import annotations

import json
import queue
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from arkoserenderer_torch.system.system import System, host_image

_PAGE = """<!DOCTYPE html>
<html><head><title>arkoserenderer_torch viewer</title><style>
body { background:#14161a; color:#cfd3da; font:13px monospace; margin:16px }
#cols { display:flex; gap:16px; align-items:flex-start }
#frame { image-rendering:pixelated; border:1px solid #333; cursor:crosshair }
#stats { white-space:pre; margin-top:8px }
#hier { border:1px solid #333; padding:6px; min-width:220px }
#hier .row { cursor:pointer; padding:1px 4px }
#hier .row:hover { background:#222832 }
#hier .sel { background:#2d4a6d }
.over { color:#ff7b72 }
</style></head><body>
<div>arkoserenderer_torch — live viewer. WASD+QE fly, click = pick,
g = gizmo mode (translate/rotate/scale), arrows/PgUp/PgDn = manipulate
selection, Esc = deselect.</div>
<div id="cols">
<div><img id="frame" width="%W%" height="%H%"/><div id="stats"></div></div>
<div id="hier">hierarchy</div>
</div>
<script>
const img = document.getElementById('frame');
const stats = document.getElementById('stats');
const hier = document.getElementById('hier');
let selected = -1;
function post(ev) { fetch('/event', {method:'POST', body:JSON.stringify(ev)}); }
async function tick() {
  img.src = '/frame.png?' + Date.now();
  try {
    const s = await (await fetch('/stats')).json();
    selected = s.selected;
    let txt = 'frame ' + s.frame + '   ' + s.ms.toFixed(2) + ' ms/frame' +
              (s.ms > s.budget_ms ? '  OVER ' + s.budget_ms + ' ms budget' : '') + '\\n';
    txt += 'gizmo: ' + (s.gizmo || 'translate') + '\\n';
    if (s.selected >= 0) txt += 'selected instance ' + s.selected + '\\n';
    for (const [k, v] of Object.entries(s.timings || {}))
      txt += k.padEnd(24) + v.toFixed(3) + ' ms\\n';
    stats.textContent = txt;
  } catch (e) {}
  setTimeout(tick, 100);
}
async function hierTick() {
  try {
    const h = await (await fetch('/hierarchy')).json();
    hier.innerHTML = '<b>scene hierarchy</b>';
    for (const e of h) {
      const d = document.createElement('div');
      d.className = 'row' + (e.instance === selected ? ' sel' : '');
      d.textContent = '#' + e.instance + ' ' + e.name +
                      ' [seg ' + e.segment + ' mat ' + e.material + ']';
      d.onclick = () => post({type:'select', instance:e.instance});
      hier.appendChild(d);
    }
  } catch (e) {}
  setTimeout(hierTick, 1000);
}
tick();
hierTick();
window.addEventListener('keydown', e => post({type:'keydown', key:e.key}));
window.addEventListener('keyup',   e => post({type:'keyup', key:e.key}));
img.addEventListener('click', e => {
  const r = img.getBoundingClientRect();
  post({type:'click', x:(e.clientX-r.left)*%W%/r.width|0,
        y:(e.clientY-r.top)*%H%/r.height|0});
});
</script></body></html>"""


class WebSystem(System):
    """System implementation backed by a local HTTP viewer."""

    def __init__(self, port: int = 8666, host: str = "127.0.0.1"):
        super().__init__()
        self._size = (640, 480)
        self.port = port
        self.host = host
        self.events: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._png: bytes = b""
        self._stats: dict = {"frame": 0, "ms": 0.0, "budget_ms": 16.667}
        self._server: ThreadingHTTPServer | None = None
        self._running = True
        self.clicks: list[tuple[int, int]] = []   # drained by the app loop
        self.selects: list[int] = []              # hierarchy-panel picks
        self._hierarchy: list[dict] = []

    # -- System interface ------------------------------------------------------

    def create_window(self, width: int, height: int, title: str) -> None:
        self._size = (width, height)
        sys_ref = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def _send(self, code, ctype, body: bytes):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path.startswith("/frame.png"):
                    with sys_ref._lock:
                        png = sys_ref._png
                    self._send(200, "image/png", png or b"")
                elif self.path.startswith("/stats"):
                    with sys_ref._lock:
                        body = json.dumps(sys_ref._stats).encode()
                    self._send(200, "application/json", body)
                elif self.path.startswith("/hierarchy"):
                    with sys_ref._lock:
                        body = json.dumps(sys_ref._hierarchy).encode()
                    self._send(200, "application/json", body)
                else:
                    page = (_PAGE.replace("%W%", str(width))
                            .replace("%H%", str(height)))
                    self._send(200, "text/html", page.encode())

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                try:
                    ev = json.loads(self.rfile.read(n) or b"{}")
                except json.JSONDecodeError:
                    ev = {}
                sys_ref.events.put(ev if isinstance(ev, dict) else {})
                self._send(200, "application/json", b"{}")

        self._server = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def framebuffer_size(self) -> tuple[int, int]:
        return self._size

    def new_frame(self) -> bool:
        """Drain HTTP events into the Input singleton (the event pump)."""
        self.input.new_frame()
        while True:
            try:
                ev = self.events.get_nowait()
            except queue.Empty:
                break
            t = ev.get("type")
            try:
                if t == "keydown":
                    self.input.push_key_down(str(ev.get("key", "")))
                elif t == "keyup":
                    self.input.push_key_up(str(ev.get("key", "")))
                elif t == "click":
                    self.clicks.append((int(ev.get("x", 0)), int(ev.get("y", 0))))
                elif t == "select":
                    self.selects.append(int(ev.get("instance", -1)))
                elif t == "quit":
                    self._running = False
            except (TypeError, ValueError):
                continue  # a malformed event from the page is dropped
        return self._running

    def present(self, ldr_image) -> None:
        """Encode + publish the frame (swapchain present analogue)."""
        from arkoserenderer_torch.utils.imageio import encode_png

        png = encode_png(host_image(ldr_image))
        with self._lock:
            self._png = png

    # -- viewer extras ---------------------------------------------------------

    def publish_stats(self, **kw) -> None:
        with self._lock:
            self._stats.update(kw)

    def publish_hierarchy(self, entries: list) -> None:
        """Scene-hierarchy panel rows: [{instance, name, segment, material,
        position}] (the EditorScene.h scene outliner analogue)."""
        with self._lock:
            self._hierarchy = entries

    def stop(self) -> None:
        self._running = False
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
