"""Teleop cells: ``RedundancyResolution.teleop_solve`` ticked along target
circles, each tick seeded from the circle's last answer, as a servo loop
drives it. A circle starts with the arm at rest on the committed
roadmap, at the configuration of its node nearest to the circle's first
target, as ``apps/teleop`` starts the arm at a roadmap node: every tick
has a current configuration, and the start is read from the roadmap's
file, not made by the system under test.

Set-up loads the roadmap, draws the trajectories (frozen ``circle_random``
generator, from the cell's ``trajectory_seed``: every seed gets the same
circles and starts, in its own order), and ticks a warm trajectory, which
captures the IK's CUDA graphs. In the window every circle is an
operator's session from its start; the sessions tick in turn, so that
every window covers the same ticks of every circle whatever the seed,
and a circle that is hard to follow weighs on every run alike. Every
tick is synchronised and timed on the host clock; ``tick_p95_ms`` is the
95th percentile of all of them. A tick answered ``None`` keeps the arm
where it is, as the source's loop does, and counts as failed.

The judge holds the answers to what ``teleop_solve`` guarantees and to
the plain kinematics of the robot file (``reference/kinematics.py``):
no joint moves more than ``max_change`` a tick and every answer lies
within the joint limits (``guarantee_excess_rad``), and on every tick at
which the plain IK, started from the tick's current configuration,
reaches the target within one such step, the answer is at the target
(``reached_miss_share``; a tick answered ``None`` there misses); and few
ticks go unanswered or miss (``warm_off_share``).
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace

import numpy as np

from perfcells.common import (ROOT, bf16, chain_of, load_roadmap, no_span,
                              sync)
from perfcells.reference import kinematics as kin
from perfcells.traffic import trajectories


def make_trajectories(cell, config, seed):
    """The window's circles in the seed's order, and one warm circle, each
    a (targets, start configuration) pair. Every seed gets the same
    circles and starts, drawn from the cell's ``trajectory_seed``, so that
    every run does the same work: which stretches of a circle are hard
    turns on millimetres of its targets."""
    trajs = trajectories.circle_random(
        chain_of(config), config["domain"], config["fixed_rpy"],
        cell["trajectories"] + 1, cell["trajectory_seed"],
        duration=config["duration_s"], hz=config["hz"],
        floor_z=config["floor_z"])
    circles = list(zip(trajs, roadmap_starts(
        config, np.stack([t[0] for t in trajs]))))
    order = np.random.default_rng(seed).permutation(len(trajs) - 1)
    return [circles[i] for i in order], circles[-1]


def roadmap_starts(config, points):
    """(N, A) float64: for each of ``points`` (N, 7) the configuration of
    the committed roadmap's node nearest to it (position distance in m and
    rotation angle in rad, stacked), read from the roadmap's file: the arm
    rests on the roadmap, as ``apps/teleop`` starts it at a roadmap node."""
    with np.load(os.path.join(ROOT, config["roadmap"],
                              "resolution.npz")) as g:
        nodes, configs = g["points"].astype(np.float64), g["configs"]
    pts = np.asarray(points, dtype=np.float64)
    pos = np.linalg.norm(pts[:, None, :3] - nodes[None, :, :3], axis=-1)
    dot = np.abs(np.einsum("nk,mk->nm", pts[:, 3:7], nodes[:, 3:7]))
    rot = 2 * np.arccos(np.clip(dot, 0.0, 1.0))
    return configs[np.hypot(pos, rot).argmin(axis=1)].astype(np.float64)


def setup(cell, config, seed, device):
    res = load_roadmap(config, device)
    circles, (warm, warm_q) = make_trajectories(cell, config, seed)
    s = SimpleNamespace(cell=cell, config=config, device=device, res=res,
                        circles=circles, records=None)
    session = Session(warm[:cell["warm_ticks"]], warm_q)
    while session.k < len(session.targets):
        tick(s, session, [], [], no_span)
    return s


class Session:
    """One operator's circle: the next target, the arm's configuration and
    the roadmap's plan state between its ticks."""

    def __init__(self, targets, start):
        self.targets, self.start = targets, start
        self.restart()

    def restart(self):
        self.k, self.q = 0, np.array(self.start, dtype=np.float64)
        self.plan_path, self.path_index = None, 0


def tick(s, session, lat, records, spans):
    """One tick of ``session``; appends its seconds to ``lat`` and (target,
    q_in, q_out) to ``records``. A session at the end of its circle starts
    it again from its start. Returns the host clock at the tick's end."""
    res = s.res
    if session.k == len(session.targets):
        session.restart()
    target, q = session.targets[session.k], session.q
    res.plan_path, res.path_index = session.plan_path, session.path_index
    sync(s.device)
    t0 = time.perf_counter()
    with spans("teleop.tick"):
        q_new = res.teleop_solve(target, q, s.config["max_change"])
        sync(s.device)
    t1 = time.perf_counter()
    lat.append(t1 - t0)
    session.plan_path, session.path_index = res.plan_path, res.path_index
    if q_new is not None:
        q_new = np.asarray(q_new, dtype=np.float64)
        session.q = q_new
    records.append((target, q, q_new))
    session.k += 1
    return t1


def window(s, seconds, spans):
    """Every circle is a session, and the sessions tick in turn, so that
    each window covers the same share of every circle whatever the seed."""
    lat, records = [], []
    sessions = [Session(t, q) for t, q in s.circles]
    t_end = time.perf_counter() + seconds
    done = False
    while not done:
        for session in sessions:
            if tick(s, session, lat, records, spans) >= t_end:
                done = True
                break
    s.records = records
    failed = sum(r[2] is None for r in records)
    return {"metrics": {"tick_p95_ms": float(np.percentile(lat, 95)) * 1e3},
            "attempted": len(records), "failed": failed,
            "counts": {"ticks": len(records),
                       "ticks_per_circle": len(records) / len(sessions),
                       "tick_median_ms": float(np.median(lat)) * 1e3}}


def release(s):
    s.res = None


def readings(s, records, chain, rounding=None):
    """The judge's numbers over ``records`` (target, q_in, q_out):

    - ``guarantee_excess_rad``: how far the answers go past what
      ``teleop_solve`` guarantees, the largest of a tick's joint step
      beyond ``max_change`` (ticks with a current configuration) and an
      answer's distance outside the joint limits; 0 when none does;
    - ``reached_miss_share``: of the ticks at which the plain IK from the
      current configuration reaches the target within the joint limits
      and one step of ``max_change``, the share whose answer misses the
      target by more than the IK's tolerance (position m and rotation rad
      stacked) or is ``None``; 1 when no tick is reached;
    - ``warm_off_share``: of the ticks with a current configuration
      (every tick of the window), the share answered ``None`` or reached
      and missed; 1 when there is none. This holds the discontinuity
      fallback's answers too, where the plain IK does not reach.

    ``rounding`` maps every answer before it is judged (the control)."""
    max_change = s.config["max_change"]
    tol = s.config["ik_tolerance"]

    def judged(q):
        if q is None:
            return None
        q = np.asarray(q, dtype=np.float64)[None]
        return (rounding(q) if rounding is not None else q)[0]

    recs = [(t, judged(a), judged(b)) for t, a, b in records]
    excess = 0.0
    answers = [b for _, _, b in recs if b is not None]
    if answers:
        ans = np.stack(answers)
        outside = np.maximum(chain.qmin - ans, ans - chain.qmax)
        excess = float(np.where(chain.cyclic, 0.0, outside).max())
    moved = [(a, b) for _, a, b in recs if a is not None and b is not None]
    if moved:
        q_in, q_out = (np.stack(x) for x in zip(*moved))
        excess = max(excess, float(
            (chain.step(q_in, q_out) - max_change).max()))

    warm = [(t, a, b) for t, a, b in recs if a is not None]
    reached = misses = off = 0
    if warm:
        tgt = np.stack([t for t, _, _ in warm]).astype(np.float64)
        q_in = np.stack([a for _, a, _ in warm])
        q_ref, conv = chain.ik(q_in, tgt)
        inside = np.all(chain.cyclic | ((q_ref >= chain.qmin)
                                        & (q_ref <= chain.qmax)), axis=1)
        hit = conv & inside & (chain.step(q_in, q_ref) <= max_change)
        answered = np.array([b is not None for _, _, b in warm])
        miss = hit & ~answered
        rows = np.flatnonzero(hit & answered)
        if len(rows):
            q_out = np.stack([warm[i][2] for i in rows])
            pos, rot = kin.pose_errors(chain, q_out, tgt[rows])
            miss[rows] = np.hypot(pos, rot) > tol
        reached, misses = int(hit.sum()), int(miss.sum())
        off = int((miss | ~answered).sum())
    return {"guarantee_excess_rad": max(excess, 0.0),
            "reached_miss_share": misses / reached if reached else 1.0,
            "warm_off_share": off / len(warm) if warm else 1.0,
            "reached_ticks": reached, "warm_ticks": len(warm),
            "judged_ticks": len(recs)}


def judge(s, out, control=False):
    r = readings(s, s.records, chain_of(s.config),
                 rounding=bf16 if control else None)
    limits = s.cell["limits"]
    checks = [{"name": k, "value": r[k], "limit": limits[k]} for k in limits]
    return checks, {"readings": r}
