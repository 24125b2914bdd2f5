"""``reconplan_tpu_torch.benchmarks.bench_stitch`` and ``diag_posefree``
against the repo's JAX scripts (``benchmarks/``, loaded by path) on the
CPU. Every nearest-neighbour pass of the stitch is a (slots x slots)
product, so the CPU runs keep the slots small: 8,192 model and 4,096
frame slots where the defaults have 65,536 and 16,384.
"""

import numpy as np
import pytest
import torch

from reconplan_tpu_torch.benchmarks import bench_stitch, diag_posefree
from test_torch_bench_scripts import load_jax_script, result_lines

torch.set_num_threads(2)


def test_bench_stitch_pose_seeded_matches_jax(capsys):
    """Pose-seeded, 4 frames of one arc over the lone banana (8,192 model
    slots, 4,096 frame slots; the quadratic passes keep the CPU run
    short): the Chamfer and its directions within 2% (measured: equal to
    the printed digit), the same point count within 1%."""
    argv = ["--frames", "4", "--arcs", "1", "--no-floor", "--capacity",
            "8192", "--frame-capacity", "4096", "--arms", "pose-seeded"]
    load_jax_script("bench_stitch").main(argv + ["--platform", "cpu"])
    want = result_lines(capsys.readouterr().out, "captured", "pose-seeded")
    got_arms = bench_stitch.main(argv + ["--device", "cpu"])
    got = result_lines(capsys.readouterr().out, "captured", "pose-seeded")
    assert [w for w, _ in got] == [w for w, _ in want]
    (_, gc), (_, gs) = got
    (_, wc), (_, ws) = want
    assert gc == wc  # frames and coverage
    # chamfer, cloud->gt, gt->cloud, points, seconds
    assert np.allclose(gs[:3], ws[:3], rtol=0.02, atol=0)
    assert abs(gs[3] - ws[3]) <= 0.01 * ws[3]
    assert got_arms["pose-seeded"]["chamfer_mm"] == pytest.approx(gs[0],
                                                                  abs=1e-3)


def test_diag_posefree_by_outcome(capsys):
    """The pose-free diagnosis on 2 frames of one arc over the tabletop
    (4,096 / 2,048 slots; the CPU's quadratic passes): RANSAC draws
    another stream in the port, so the two are held by outcome. The two
    views are 118 degrees apart, and neither package registers frame 1
    (frame 0 starts the model and has no row): each prints one line with
    fit 0 and the same true step, its estimate left at the start, so its
    error is the whole true motion (measured in both: 118.07 deg, 500.00
    mm). The error arithmetic is held exactly by the next test; the
    registration's accuracy where the views overlap, at the default
    slots, by phase 18 of chip_smoke.py and the card's twin of this test
    (measured on the card: at most 0.94 deg and 5.14 mm over 8 frames of
    one arc)."""
    argv = ["--frames", "2", "--arcs", "1", "--capacity", "4096",
            "--frame-capacity", "2048"]
    load_jax_script("diag_posefree").main(argv + ["--platform", "cpu"])
    want = result_lines(capsys.readouterr().out, "frame")
    rows = diag_posefree.main(argv + ["--device", "cpu"])
    got = result_lines(capsys.readouterr().out, "frame")
    assert [r["frame"] for r in rows] == [1]
    assert [w for w, _ in got] == [w for w, _ in want]
    for nums in (got[0][1], want[0][1]):
        # frame, fit, the 1 of "s1", s1, sb, rot, trans, step
        assert nums[1] == 0
        assert nums[5] == pytest.approx(nums[7], abs=0.011)
    assert np.allclose(got[0][1][5:], want[0][1][5:], rtol=0, atol=0.011)
    assert rows[0]["rot_deg"] == pytest.approx(rows[0]["step_deg"], abs=1e-3)


def _offsets(n, seed=0):
    """``n`` rigid offsets (4, 4) f64, rotations of 2-30 degrees about
    random axes and translations of 5-50 mm, with their angles (deg) and
    translation lengths (mm)."""
    rng = np.random.default_rng(seed)
    deg = rng.uniform(2, 30, n)
    mm = rng.uniform(5, 50, n)
    out = np.tile(np.eye(4), (n, 1, 1))
    for D, a, t in zip(out, np.radians(deg), mm):
        k = rng.normal(size=3)
        k /= np.linalg.norm(k)
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        D[:3, :3] = np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K
        v = rng.normal(size=3)
        D[:3, 3] = v / np.linalg.norm(v) * t / 1000
    return out, deg, mm


def _stub_capture_and_stitch(monkeypatch, render, stitcher, offsets):
    """Render nothing (each picture blank, its camera pose the real one)
    and replace the stitch by estimates that are ``offsets`` away from
    the truth: frame i's estimate is offsets[i - 1] @ inv(T_0) @ T_i."""
    shot = []

    def take_picture(self, eye, target):
        shot.append(np.asarray(render.camera_look_at(eye, target)))
        return (np.zeros((480, 640), np.float32),
                np.zeros((480, 640, 3), np.uint8), shot[-1])

    def stitch_sequence(self, colors, depths, poses=None):
        P = np.stack(shot).astype(np.float32)
        gt_rel = np.linalg.inv(P[0]) @ P[1:]
        n = len(gt_rel)
        self.last_transforms = (offsets[:n] @ gt_rel).astype(np.float32)
        self.last_fits = np.full(n, 0.5, np.float32)
        self.last_scores = np.tile(np.float32([0.25, 0.75]), (n, 1))

    monkeypatch.setattr(render.SplatCamera, "take_picture", take_picture)
    monkeypatch.setattr(stitcher.RGBDStitcher, "stitch_sequence",
                        stitch_sequence)


def test_diag_posefree_error_arithmetic(capsys, monkeypatch):
    """The pose error arithmetic on known estimates: with the capture
    blank and the stitch replaced by estimates a known rigid offset away
    from the truth (8 frames of 4 arcs), both scripts print the same
    lines, the arc jumps where they fall, and each frame's error is its
    offset's angle and length: within the print's 0.005 deg / mm, the
    port's returned rows within 1e-3 (measured: 4.0e-5 deg, 3.4e-5 mm)."""
    from reconplan_tpu.io import render as jrender
    from reconplan_tpu.recon import stitcher as jstitcher
    from reconplan_tpu_torch.io import render as trender
    from reconplan_tpu_torch.recon import stitcher as tstitcher

    offsets, deg, mm = _offsets(7)
    argv = ["--frames", "8", "--arcs", "4"]
    _stub_capture_and_stitch(monkeypatch, jrender, jstitcher, offsets)
    load_jax_script("diag_posefree").main(argv + ["--platform", "cpu"])
    want = result_lines(capsys.readouterr().out, "frame")
    _stub_capture_and_stitch(monkeypatch, trender, tstitcher, offsets)
    rows = diag_posefree.main(argv + ["--device", "cpu"])
    got = result_lines(capsys.readouterr().out, "frame")

    assert [r["frame"] for r in rows] == list(range(1, 8))
    assert [r["arc_jump"] for r in rows] == [False, True] * 3 + [False]
    assert [w for w, _ in got] == [w for w, _ in want]
    g, w = np.array([n for _, n in got]), np.array([n for _, n in want])
    # frame, fit, the 1 of "s1", s1, sb, rot, trans, step
    assert np.array_equal(g[:, :5], w[:, :5])
    for nums in (g, w):
        assert np.abs(nums[:, 5] - deg).max() <= 0.005 + 1e-9
        assert np.abs(nums[:, 6] - mm).max() <= 0.005 + 1e-9
    assert np.abs(g[:, 7] - w[:, 7]).max() <= 0.011
    assert np.abs([r["rot_deg"] for r in rows] - deg).max() <= 1e-3
    assert np.abs([r["trans_mm"] for r in rows] - mm).max() <= 1e-3
