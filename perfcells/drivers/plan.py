"""Plan cells: the scan arc planned by ``apps/scan.grr_plan`` on the
committed roadmap, with its IK fallback, arc after arc.

Set-up loads the roadmap, builds the arc from the seed (frozen arc
generator, its azimuth turned within the cell's range) and plans it
once, which captures every IK graph the arc needs. The window plans the
arc again and again; ``plan_wps`` is every waypoint planned over the
window's whole time. The judge holds every configuration of the last
arc against the plain forward kinematics of the robot file.
"""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np

from perfcells.common import bf16, chain_of, load_roadmap
from perfcells.reference import kinematics as kin
from perfcells.traffic import arcs
from reconplan_tpu_torch.apps.scan import grr_plan


def setup(cell, config, seed, device):
    res = load_roadmap(config, device)
    az = arcs.seeded_azimuth(seed, cell["azimuth_turn"])
    a = config["arc"]
    arc = arcs.scan_arc(arcs.OBJECT_POINT, radius=a["radius"],
                        height=a["height"], num_points=a["waypoints"],
                        azimuth=az)
    s = SimpleNamespace(cell=cell, config=config, device=device, res=res,
                        arc=arc, path=None)
    grr_plan(res, arc)
    return s


def window(s, seconds, spans):
    arcs_done = 0
    t0 = time.perf_counter()
    while True:
        with spans("plan.arc"):
            path = grr_plan(s.res, s.arc)
        arcs_done += 1
        if time.perf_counter() - t0 >= seconds:
            break
    elapsed = time.perf_counter() - t0
    s.path = path
    n = len(s.arc)
    unsolved = sum(q is None for q in path)
    return {"metrics": {"plan_wps": arcs_done * n / elapsed},
            "attempted": arcs_done * n, "failed": arcs_done * unsolved,
            "counts": {"arcs": arcs_done, "waypoints": arcs_done * n,
                       "unsolved_per_arc": unsolved}}


def release(s):
    s.res = None


def readings(s, path, chain, rounding=None):
    """The judge's numbers over the planned configurations: the largest
    position gap to their waypoints (m), and the share whose pose misses
    the waypoint beyond the IK's tolerance (the stacked norm of m and rad;
    the IK fallback solves positions alone)."""
    idx = [i for i, q in enumerate(path) if q is not None]
    q = np.stack([np.asarray(path[i], dtype=np.float64) for i in idx])
    if rounding is not None:
        q = rounding(q)
    pos, rot = kin.pose_errors(chain, q, s.arc[idx])
    miss = np.hypot(pos, rot) > s.config["ik_tolerance"]
    return {"max_pos_gap_m": float(pos.max()),
            "pose_miss_share": float(miss.mean())}


def judge(s, out, control=False):
    r = readings(s, s.path, chain_of(s.config),
                 rounding=bf16 if control else None)
    limits = s.cell["limits"]
    checks = [{"name": k, "value": r[k], "limit": limits[k]} for k in limits]
    return checks, {"readings": r}
