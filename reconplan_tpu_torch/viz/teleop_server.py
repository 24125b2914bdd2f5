"""Pointer-driven teleop in the browser — the TransformPoser twin.

Port of ``reconplan_tpu.viz.teleop_server``. The reference's interactive
surface is a Klampt OpenGL widget: drag a TransformPoser and watch
``resolution.teleop_solve`` track it each idle tick
(``Expansion-GRR/visualization/klampt_vis.py:369-426``). A headless host
has no display, so the equivalent here is a tiny local HTTP bridge:

  * ``GET /``  — a self-contained orbit viewer (same vanilla-JS renderer
    family as :mod:`reconplan_tpu_torch.viz.html_export`) showing the roadmap,
    the arm as a link polyline, and a draggable target marker;
  * ``POST /tick`` — the browser streams target poses while you drag
    (camera-parallel plane, like Klampt's widget); each request runs ONE
    ``teleop_solve`` tick server-side and returns the new link positions
    + tracking status (track / plan-follow / fallback / stuck).

Run over ssh with ``-L 8008:127.0.0.1:8008`` and open
``http://127.0.0.1:8008``. Single-threaded by design: one solve loop, one
authoritative robot state. The solve runs on the resolution's device
from the server's thread, which torch allows from any thread.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np

from reconplan_tpu_torch.utils.device import robot_device

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>reconplan teleop</title>
<style>
 body { margin: 0; background: #101318; color: #dfe5ec;
        font: 13px system-ui, sans-serif; }
 #hud { position: fixed; top: 8px; left: 10px; opacity: .9; white-space: pre;
        pointer-events: none; }
 canvas { display: block; }
</style></head>
<body>
<div id="hud">reconplan teleop
drag target (yellow): move it · drag elsewhere: orbit · wheel: zoom · shift-drag: pan
status: <span id="st">-</span></div>
<canvas id="c"></canvas>
<script>
const DATA = %(data)s;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
const stEl = document.getElementById('st');
let W, H; const resize = () => { W = cv.width = innerWidth; H = cv.height = innerHeight; };
addEventListener('resize', resize); resize();

const pts = DATA.points;
let cx=0, cy=0, cz=0;
for (const p of pts) { cx+=p[0]; cy+=p[1]; cz+=p[2]; }
cx/=pts.length; cy/=pts.length; cz/=pts.length;
let rad = 0;
for (const p of pts) rad = Math.max(rad, Math.hypot(p[0]-cx, p[1]-cy, p[2]-cz));
if (!rad) rad = 1;

let yaw = 0.7, pitch = 0.5, dist = 2.8, panX = 0, panY = 0;
let target = DATA.target.slice();
let links = DATA.links;
let status = 'idle';

function basis() {
  // camera basis vectors in world coords (rows of the view rotation)
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  // screen-x axis and screen-y axis (world directions)
  return {
    ex: [cyw, syw, 0],
    ey: [-syw*cp, cyw*cp, -sp],
  };
}

function project(p) {
  const x = (p[0]-cx)/rad, y = (p[1]-cy)/rad, z = (p[2]-cz)/rad;
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cyw*x + syw*y, y1 = -syw*x + cyw*y;
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;
  const zc = z2 + dist;
  if (zc < .05) return null;
  const s = .9 * Math.min(W, H) / zc;
  return [W/2 + panX + x1*s, H/2 + panY - y2*s, zc, s];
}

let drag = null;
cv.onmousedown = e => {
  const t = project(target);
  if (t && Math.hypot(e.clientX - t[0], e.clientY - t[1]) < 14) {
    drag = {mode: 'target', x: e.clientX, y: e.clientY, s: t[3]};
  } else {
    drag = {mode: 'orbit', x: e.clientX, y: e.clientY, shift: e.shiftKey};
  }
};
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.mode === 'target') {
    const b = basis();
    const k = rad / drag.s;  // px -> world at the target's depth scale
    for (let i = 0; i < 3; i++)
      target[i] += (dx * b.ex[i] - dy * b.ey[i]) * k;
    sendTick();
  } else if (drag.shift) { panX += dx; panY += dy; }
  else { yaw += dx * .008; pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * .008)); }
  drag.x = e.clientX; drag.y = e.clientY; draw();
});
cv.onwheel = e => { dist *= Math.exp(e.deltaY * .001); draw(); e.preventDefault(); };

let inflight = false, pendingT = null;
function sendTick() {
  if (inflight) { pendingT = target.slice(); return; }
  inflight = true;
  fetch('/tick', {method: 'POST', body: JSON.stringify({target: target})})
    .then(r => r.json()).then(js => {
      links = js.links; status = js.status;
      stEl.textContent = status;
      inflight = false; draw();
      if (pendingT) { pendingT = null; sendTick(); }
    }).catch(() => { inflight = false; });
}
// idle ticks keep the arm converging when the mouse rests (reference
// idle-loop semantics)
setInterval(() => { if (!drag || drag.mode !== 'target') sendTick(); }, 250);

function draw() {
  ctx.fillStyle = '#101318'; ctx.fillRect(0, 0, W, H);
  for (let i = 0; i < pts.length; i++) {
    const q = project(pts[i]);
    if (!q) continue;
    const r = Math.max(1, 3.5 / q[2]);
    ctx.fillStyle = DATA.colors[i];
    ctx.fillRect(q[0]-r/2, q[1]-r/2, r, r);
  }
  // arm polyline
  ctx.strokeStyle = '#6fc3ff'; ctx.lineWidth = 3;
  ctx.beginPath();
  let started = false;
  for (const lp of links) {
    const q = project(lp);
    if (!q) { started = false; continue; }
    if (!started) { ctx.moveTo(q[0], q[1]); started = true; }
    else ctx.lineTo(q[0], q[1]);
  }
  ctx.stroke();
  for (const lp of links) {
    const q = project(lp);
    if (q) { ctx.fillStyle = '#a5d8ff'; ctx.fillRect(q[0]-2, q[1]-2, 4, 4); }
  }
  // target
  const t = project(target);
  if (t) {
    ctx.strokeStyle = status === 'stuck' ? '#e03131' : '#ffd166';
    ctx.lineWidth = 2;
    ctx.beginPath(); ctx.arc(t[0], t[1], 9, 0, 7); ctx.stroke();
    ctx.beginPath(); ctx.moveTo(t[0]-13, t[1]); ctx.lineTo(t[0]+13, t[1]);
    ctx.moveTo(t[0], t[1]-13); ctx.lineTo(t[0], t[1]+13); ctx.stroke();
  }
}
draw();
sendTick();
</script></body></html>
"""


class TeleopSession:
    """Server-side teleop state: one robot config tracked by
    ``resolution.teleop_solve`` ticks (``klampt_vis.py:369-426``
    idle-loop semantics, minus the display)."""

    def __init__(self, resolution, q0=None, max_change=0.03):
        self.resolution = resolution
        self.robot = resolution.robot
        self.max_change = float(max_change)
        if q0 is None:
            # start from the first configured roadmap node
            q0 = np.asarray(resolution.configs[0], dtype=np.float64)
        self.q = np.asarray(q0, dtype=np.float64)
        self._target_quat = None

    def state(self):
        pos, rot = self.robot.solve_fk(self.q)
        ee_pt = pos[-1]
        if self._target_quat is None:
            self._target_quat = np.asarray(rot[-1], dtype=np.float64)
        base = np.zeros((1, 3))
        return {
            "links": np.concatenate([base, pos], axis=0).tolist(),
            "ee": ee_pt.tolist(),
            "config": self.q.tolist(),
        }

    def tick(self, target_xyz):
        """One teleop_solve step toward target position. Returns status."""
        res = self.resolution
        target = np.asarray(target_xyz, dtype=np.float64)[:3]
        if res.points.shape[1] > 3:
            # variable-rotation roadmap: hold the current tool orientation
            # (the Klampt widget drags position and rotation; a pointer
            # has 2 DoF, so rotation tracks the arm's own quaternion)
            quat = self._target_quat
            if quat is None:
                _, rot = self.robot.solve_fk(self.q)
                quat = rot[-1]
            target = np.concatenate([target, np.asarray(quat)])
        had_plan = res.plan_path is not None
        q = res.teleop_solve(target, self.q, max_change=self.max_change)
        if q is None:
            return "stuck"
        moved = not np.allclose(q, self.q)
        self.q = np.asarray(q, dtype=np.float64)
        if res.plan_path is not None or had_plan:
            return "plan-follow"
        return "track" if moved else "converged"


def make_handler(session, page_data):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code, body, ctype="application/json"):
            raw = body.encode() if isinstance(body, str) else body
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                st = session.state()
                data = dict(page_data)
                data["links"] = st["links"]
                data["target"] = st["ee"]
                self._send(200, _PAGE % {"data": json.dumps(data)},
                           "text/html")
            else:
                self._send(404, "{}")

        def do_POST(self):
            if self.path != "/tick":
                self._send(404, "{}")
                return
            n = int(self.headers.get("Content-Length", 0))
            try:
                req = json.loads(self.rfile.read(n) or b"{}")
                status = session.tick(req["target"])
            except Exception as e:  # keep the UI alive on a bad solve
                self._send(200, json.dumps(
                    {"status": f"error: {e}",
                     "links": session.state()["links"]}))
                return
            st = session.state()
            self._send(200, json.dumps(
                {"status": status, "links": st["links"], "ee": st["ee"]}))

    return Handler


def roadmap_page_data(resolution, max_nodes=4000):
    """Roadmap nodes (subsampled) colored by configured state."""
    pts = np.asarray(resolution.workspace.points[:, :3], dtype=float)
    has = np.asarray(resolution.solver.has_config, dtype=bool)
    if len(pts) > max_nodes:
        sel = np.linspace(0, len(pts) - 1, max_nodes).astype(int)
        pts, has = pts[sel], has[sel]
    colors = ["#2f9e44" if h else "#533" for h in has]
    return {"points": pts.tolist(), "colors": colors}


def serve_teleop(resolution, host="127.0.0.1", port=8008, q0=None,
                 max_change=0.03, background=False, device=None):
    """Serve the pointer-teleop UI. ``background=True`` returns the
    server (daemon thread) for tests; otherwise blocks. The solves run on
    the resolution's device, which ``device`` names (``None``: the
    card)."""
    robot_device(resolution.robot, device)
    session = TeleopSession(resolution, q0=q0, max_change=max_change)
    handler = make_handler(session, roadmap_page_data(resolution))
    srv = HTTPServer((host, port), handler)
    srv.session = session
    if background:
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        return srv
    print(f"teleop UI: http://{host}:{srv.server_address[1]}  "
          "(ssh -L to forward; drag the yellow target)")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
    return srv
