"""Interactive HTML export of point clouds: a self-contained HTML file
with an embedded vanilla-JS orbit viewer (no CDN or network dependency):
drag to orbit, wheel to zoom, shift-drag to pan.

Copy of ``export_cloud_html`` and what it uses (``_TEMPLATE``,
``_write``) from ``reconplan_tpu.viz.html_export``, numpy only, so a page
written here is the page the JAX package writes.
"""

from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>%(title)s</title>
<style>
 body { margin: 0; background: #101318; color: #dfe5ec;
        font: 13px system-ui, sans-serif; }
 #hud { position: fixed; top: 8px; left: 10px; opacity: .85;
        white-space: pre; pointer-events: none; }
 canvas { display: block; }
</style></head>
<body>
<div id="hud">%(title)s
drag: orbit &#183; wheel: zoom &#183; shift-drag: pan
%(legend)s</div>
<canvas id="c"></canvas>
<script>
const DATA = %(data)s;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
let W, H; const resize = () => { W = cv.width = innerWidth; H = cv.height = innerHeight; };
addEventListener('resize', resize); resize();

// center + scale
const pts = DATA.points;
let cx=0, cy=0, cz=0;
for (const p of pts) { cx+=p[0]; cy+=p[1]; cz+=p[2]; }
cx/=pts.length; cy/=pts.length; cz/=pts.length;
let rad = 0;
for (const p of pts) rad = Math.max(rad, Math.hypot(p[0]-cx, p[1]-cy, p[2]-cz));
if (!rad) rad = 1;

let yaw = 0.7, pitch = 0.5, dist = 2.8, panX = 0, panY = 0;
let drag = null;
cv.onmousedown = e => drag = {x: e.clientX, y: e.clientY, shift: e.shiftKey};
addEventListener('mouseup', () => drag = null);
addEventListener('mousemove', e => {
  if (!drag) return;
  const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
  if (drag.shift) { panX += dx; panY += dy; }
  else { yaw += dx * .008; pitch = Math.max(-1.55, Math.min(1.55, pitch + dy * .008)); }
  drag.x = e.clientX; drag.y = e.clientY; draw();
});
cv.onwheel = e => { dist *= Math.exp(e.deltaY * .001); draw(); e.preventDefault(); };

function project(p) {
  const x = (p[0]-cx)/rad, y = (p[1]-cy)/rad, z = (p[2]-cz)/rad;
  const cyw = Math.cos(yaw), syw = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const x1 = cyw*x + syw*y, y1 = -syw*x + cyw*y;
  const y2 = cp*y1 - sp*z, z2 = sp*y1 + cp*z;
  const zc = z2 + dist;
  if (zc < .05) return null;
  const s = .9 * Math.min(W, H) / zc;
  return [W/2 + panX + x1*s, H/2 + panY - y2*s, zc];
}

function draw() {
  ctx.fillStyle = '#101318'; ctx.fillRect(0, 0, W, H);
  if (DATA.edges) {
    ctx.lineWidth = 1;
    for (const [i, j, kind] of DATA.edges) {
      const a = project(pts[i]), b = project(pts[j]);
      if (!a || !b) continue;
      ctx.strokeStyle = DATA.edge_colors[kind];
      ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
    }
  }
  if (DATA.tris) {
    ctx.strokeStyle = '#3d6ea5'; ctx.lineWidth = .5;
    for (const [i, j, k] of DATA.tris) {
      const a = project(pts[i]), b = project(pts[j]), c = project(pts[k]);
      if (!a || !b || !c) continue;
      ctx.beginPath(); ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
      ctx.lineTo(c[0], c[1]); ctx.closePath(); ctx.stroke();
    }
  }
  const n = pts.length;
  for (let i = 0; i < n; i++) {
    const q = project(pts[i]);
    if (!q) continue;
    const r = Math.max(1, 4.5 / q[2]);
    ctx.fillStyle = DATA.colors ? DATA.colors[i] : '#6fc3ff';
    ctx.fillRect(q[0]-r/2, q[1]-r/2, r, r);
  }
  if (DATA.marker) {
    const m = project(DATA.marker);
    if (m) {
      ctx.strokeStyle = '#ffd166'; ctx.lineWidth = 2;
      ctx.beginPath(); ctx.arc(m[0], m[1], 8, 0, 7); ctx.stroke();
    }
  }
}
draw();
</script></body></html>
"""


def _write(path, title, data, legend=""):
    with open(path, "w") as f:
        f.write(
            _TEMPLATE
            % {
                "title": title,
                "data": json.dumps(data),
                "legend": legend,
            }
        )
    return path


def export_cloud_html(points, path, colors=None, valid=None, max_points=60000):
    """Point-cloud viewer (e.g. a stitched scan)."""
    pts = np.asarray(points, dtype=float)
    if valid is not None:
        pts = pts[np.asarray(valid)]
        if colors is not None:
            colors = np.asarray(colors)[np.asarray(valid)]
    if len(pts) > max_points:
        sel = np.linspace(0, len(pts) - 1, max_points).astype(int)
        pts = pts[sel]
        colors = None if colors is None else np.asarray(colors)[sel]
    data = {"points": pts.tolist()}
    if colors is not None:
        c255 = np.clip(np.asarray(colors, dtype=float) * 255, 0, 255).astype(int)
        data["colors"] = [f"rgb({r},{g},{b})" for r, g, b in c255]
    return _write(path, "reconplan point cloud", data,
                  f"{len(pts)} points")
