"""The harness on the CPU: found by name, the trace arithmetic, the
tick tail, the roofline count on a hand-worked grid, the import rules,
and no result without a card."""

import ast
import itertools
import json
import os
import shutil
import subprocess
import sys
import textwrap
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from perfcells import peaks, trace
from perfcells import run as harness
from perfcells.reference import tsdf as ref

ROOT = harness.ROOT
FORBIDDEN_PROGRAM = {"jax", "jaxlib", "flax", "reconplan_tpu"}
FORBIDDEN_REFERENCE = FORBIDDEN_PROGRAM | {"reconplan_tpu_torch"}


def _top_levels(code, cwd=ROOT):
    """The top-level names of every module loaded after running ``code``
    in a fresh interpreter."""
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
        cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def _files(sub):
    base = os.path.join(ROOT, "perfcells", sub)
    return sorted(os.path.join(base, f) for f in os.listdir(base)
                  if f.endswith(".py"))


def test_command_side_imports_no_jax():
    """Everything the command loads: the harness, every driver, every
    metric reader and the control tool, with the port they import."""
    loads = "\n".join(
        f"harness.load_module({p!r}, 'm{i}')"
        for i, p in enumerate(_files("drivers") + _files("metrics")))
    code = ("from perfcells import run as harness, control, trace\n" + loads)
    names = _top_levels(code)
    assert "reconplan_tpu_torch" in names
    assert not names & FORBIDDEN_PROGRAM, names & FORBIDDEN_PROGRAM


def test_reference_side_imports_nothing_of_the_program():
    mods = [os.path.splitext(os.path.basename(p))[0]
            for p in _files("reference")]
    code = "\n".join(f"import perfcells.reference.{m}" for m in mods)
    names = _top_levels(code)
    assert not names & FORBIDDEN_REFERENCE, names & FORBIDDEN_REFERENCE
    # and no import statement anywhere in the files names one, even one
    # inside a function
    for path in _files("reference"):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".", 1)[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".", 1)[0]}
            else:
                continue
            assert not tops & FORBIDDEN_REFERENCE, (path, tops)


def test_forbidden_names_compare_whole_words(monkeypatch):
    monkeypatch.setitem(sys.modules, "reconplan_tpu_torch_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "reconplan_tpu.ops", sys)
    assert harness.forbidden_modules() == ["reconplan_tpu"]


def test_no_card_no_result():
    """Without a card the command exits nonzero and prints no line."""
    out = subprocess.run(
        [sys.executable, "-m", "perfcells.run", "--workload",
         "fuse.banana512", "--seed", str(2**31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_bare_folder_no_result(tmp_path):
    """In a folder with only BENCHMARK.json and the harness the command
    fails: the program is not there."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfcells"), tmp_path / "perfcells",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    code = ("import sys; from perfcells import run\n"
            "code, res = run.run(sys.argv[1:], require_card=False)\n"
            "print(res); sys.exit(code)")
    out = subprocess.run(
        [sys.executable, "-c", code, "--workload", "fuse.banana512",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True,
        text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_idle_share_is_a_union_of_intervals():
    # two overlapping kernels and one apart: busy 0-20 and 30-40 of 0-50
    busy = trace.merge([(5, 20), (0, 10), (30, 40), (32, 35)])
    assert busy.tolist() == [[0, 20], [30, 40]]
    t = trace.Trace(window_ns=50, device=busy, launches=4)
    assert t.busy_ns == 30
    ctx = SimpleNamespace(trace=t, out={"counts": {"frames": 2}}, work={})
    metrics = harness.Bench()
    idle = metrics.reader("device_idle.fuse").read(ctx)
    assert idle == pytest.approx(40.0)
    assert metrics.reader("launches_per_frame.fuse").read(ctx) == 2.0
    # the device time inside spans, clipped to them
    t.spans = {"fuse.integrate": np.array([[15, 35]])}
    assert t.span_busy_ns("fuse.integrate") == 10


def test_idle_gaps_go_to_the_innermost_open_span():
    busy = trace.merge([(0, 20), (30, 40)])
    spans = {"outer": np.array([[0, 100]]), "inner": np.array([[25, 45]])}
    gaps = trace._idle_gaps(busy, spans, 0, 50)
    # 20-30 opens under outer only; 40-50 under inner (the shorter)
    assert gaps == {"outer": 10, "inner": 10}


def test_p95_over_all_ticks(monkeypatch):
    """``tick_p95_ms`` is the 95th percentile of every tick of the window,
    over circles ticked in turn, each from its start."""
    drv = harness.Bench().driver("teleop")
    sleeps = itertools.cycle([0.001] * 40 + [0.02] * 3 + [0.001] * 17)

    class Res:
        plan_path = path_index = None

        def teleop_solve(self, target, q, max_change):
            time.sleep(next(sleeps))
            return np.zeros(6)

    s = SimpleNamespace(res=Res(), device=torch.device("cpu"),
                        config={"max_change": 0.04},
                        circles=[(np.full((20, 7), i), np.zeros(6))
                                 for i in range(3)])
    lat = []
    real = drv.tick

    def spy(s_, session, lat_, records, spans):
        end = real(s_, session, lat_, records, spans)
        lat[:] = lat_
        return end

    monkeypatch.setattr(drv, "tick", spy)
    out = drv.window(s, 0.2, trace.Spans(False))
    assert out["counts"]["ticks"] == len(lat) == len(s.records)
    assert out["metrics"]["tick_p95_ms"] == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    # the circles take turns: tick k went to circle k % 3
    assert [int(r[0][0]) for r in s.records] == [
        k % 3 for k in range(len(s.records))]


def test_roofline_count_on_a_hand_worked_grid():
    """A 16^3 grid of 4 bricks seen by one camera looking down +z at a
    plane 7.45 voxels into it: every brick holds voxels in band (z 6, 7
    and 8), voxels z <= 8 are observed, the rest lie behind the plane."""
    dims, voxel, trunc = (16, 16, 16), 0.01, 0.015
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.08, 0.08, -1.0)
    depth = torch.full((1, 64, 64), 1074.5)
    intr = (100.0, 100.0, 32.0, 32.0)
    T = ref.world_to_camera(pose[None]).astype(np.float32)
    (z0, cm, sm, cp, band), = ref.reference_slabs(
        depth, T, intr, dims, (0.0, 0.0, 0.0), voxel, trunc, slab=16)
    assert band.shape == (1, 2, 2, 1) and bool(band.all())
    assert (cm[:9] == 1).all() and (cm[9:] == 0).all() and (cp == 0).all()
    tsdf = ((1.0745 - (1.0 + 0.01 * np.arange(9))) / trunc).clip(-1, 1)
    np.testing.assert_allclose(sm[:9, 0, 0].numpy(), tsdf, atol=1e-5)
    judge = ref.GridJudge()
    w, s = ref.control_grid(cm, sm, 64.0)
    judge.add(w, s, cm, sm, cp, band)
    assert (judge.bricks, judge.brick_frames) == (4, 4)
    assert judge.shares() == (0.0, 0.0)
    # the fusion driver's bound from these counts: 4 bricks x 2 planes
    # x 4 KiB read and written, one 64 x 64 depth frame, one pose; 4
    # brick-frames of 1,024 voxels at 42 operations
    nbytes = 4 * 2 * 4096 * 2 + 64 * 64 * 4 + 64
    b, by = peaks.bound_s(nbytes, 4 * 1024 * peaks.TSDF_VOXEL_FRAME_OPS)
    assert by == "bytes" and b == pytest.approx(nbytes / 3.35e12)
    # a grid left empty fails every touched voxel
    judge = ref.GridJudge()
    judge.add(torch.zeros_like(w), torch.ones_like(s), cm, sm, cp, band)
    assert judge.shares()[0] == 1.0


def test_roofline_reader():
    t = trace.Trace(window_ns=10**9, device=np.array([[0, 4 * 10**8]]),
                    launches=0,
                    spans={"fuse.integrate": np.array([[0, 2 * 10**8],
                                                       [3 * 10**8, 10**9]])})
    ctx = SimpleNamespace(trace=t, out={}, work={"bound_s": 0.001})
    r = harness.Bench().reader("integrate_roofline.fuse").read(ctx)
    # 2 scans of 1 ms bound over 0.3 s busy inside the spans
    assert r == pytest.approx(100 * 0.002 / 0.3)
    t.spans = {}
    assert harness.Bench().reader("integrate_roofline.fuse").read(ctx) is None


TOY_DRIVER = textwrap.dedent('''
    """A throwaway driver: counts to the window's end."""
    import time


    def setup(cell, config, seed, device):
        return {"n": 0, "step": cell["step"] * config["scale"]}


    def window(s, seconds, spans):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            with spans("toy.step"):
                s["n"] += s["step"]
        return {"metrics": {"toy_rate": s["n"] / seconds},
                "attempted": 1, "failed": 0, "counts": {"steps": s["n"]}}


    def release(s):
        pass


    def judge(s, out):
        return [{"name": "toy_gap", "value": 0.0,
                 "limit": 1.0}], {"readings": {"toy_gap": 0.0}}
''')
TOY_METRIC = textwrap.dedent('''
    def read(ctx):
        return ctx.out["counts"]["steps"] / max(len(ctx.trace.spans), 1)
''')


def test_new_cell_metric_and_config_are_found_by_name(tmp_path):
    """A cell, a configuration, a driver and a per-layer metric added as
    new files and manifest entries alone run, with no existing file
    edited."""
    shutil.copytree(os.path.join(ROOT, "perfcells"), tmp_path / "perfcells",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    before = {p: open(p, "rb").read() for p in
              map(str, (tmp_path / "perfcells").rglob("*")) if os.path.isfile(p)}
    pc = tmp_path / "perfcells"
    (pc / "configs" / "toy_config.json").write_text(json.dumps({"scale": 2}))
    (pc / "cells" / "toy.cell.json").write_text(json.dumps(
        {"driver": "toy", "config": "toy_config", "step": 3,
         "limits": {"toy_gap": 1.0}}))
    (pc / "drivers" / "toy.py").write_text(TOY_DRIVER)
    (pc / "metrics" / "toy_steps.toy.py").write_text(TOY_METRIC)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "toy_config", "source": "a test",
                             "file": "perfcells/configs/toy_config.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy_config",
                               "traffic": "toy", "chips": 1, "why": "a test"})
    bench["end_to_end"].insert(0, {"name": "toy_rate", "unit": "steps/s",
                                   "better": "higher", "bound": 0.05,
                                   "source": "host_clock",
                                   "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "toy_steps.toy", "unit": "steps",
                               "better": "higher", "source": "program_span",
                               "layer": "toy", "moves": "toy_rate",
                               "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    argv = ["--workload", "toy.cell", "--seed", str(2**31 + 7),
            "--seconds", "0.2"]
    code, res = harness.run(argv + ["--trace", "0"], root=str(tmp_path),
                            require_card=False)
    assert code == 0 and res["correct"]
    assert set(res["metrics"]) == {"toy_rate", "setup_s"}
    assert res["metrics"]["toy_rate"]["unit"] == "steps/s"
    assert list(res)[-1] == "checks"
    code, res = harness.run(argv + ["--trace", "1"], root=str(tmp_path),
                            require_card=False)
    assert code == 0 and set(res["metrics"]) == {"toy_steps.toy"}
    assert res["device"]["window_s"] > 0 and "breakdown" in res
    after = {p: open(p, "rb").read() for p in before}
    assert after == before
