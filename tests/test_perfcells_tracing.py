"""The benchmark's readers of the program's spans and counters, on the
CPU: the program's ranges leave the harness's reduction as it was, an
idle gap goes to the innermost open program span, each new reader gives
its hand-reckoned value on a synthetic traced window and None without
the program's recording, and ``BENCHMARK.json`` keeps its schema.
"""

import importlib.util
import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
from torch.autograd import DeviceType

from perfcells import program, trace
from perfcells import run as harness
from reconplan_tpu_torch.utils import profiling

ROOT = harness.ROOT
NEW = {
    "mask_idle.fuse": "fuse.banana512",
    "host_reads_per_tick.teleop": "teleop.rvy_circle",
    "ik_calls_per_tick.teleop": "teleop.rvy_circle",
    "tail_plan_share.teleop": "teleop.rvy_circle",
    "host_reads_per_waypt.plan": "plan.arc500",
    "ik_chunks_per_waypt.plan": "plan.arc500",
}


class Event:
    """One raw profiler event, as ``reduce`` reads it."""

    def __init__(self, name, start, duration, cuda=False, annotation=False):
        self._args = name, start, duration, cuda, annotation

    def name(self):
        return self._args[0]

    def start_ns(self):
        return self._args[1]

    def duration_ns(self):
        return self._args[2]

    def device_type(self):
        return DeviceType.CUDA if self._args[3] else DeviceType.CPU

    def is_user_annotation(self):
        return self._args[4]


def profiler_of(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


HARNESS_EVENTS = [
    Event("perfcells:fuse.integrate", 100, 800),
    Event("cudaLaunchKernel", 150, 5),
    Event("cudaMemcpyAsync", 600, 5),
    Event("aten::add", 140, 20),
    Event("kernel_a", 200, 100, cuda=True),
    Event("kernel_b", 700, 50, cuda=True),
    Event("perfcells:fuse.integrate", 100, 800, cuda=True, annotation=True),
]
PROGRAM_EVENTS = [
    Event("reconplan:tsdf.integrate", 110, 780),
    Event("reconplan:tsdf.active_set", 120, 300),
    Event("reconplan:tsdf.k1", 500, 150),
    Event("reconplan:tsdf.active_set", 120, 300, cuda=True, annotation=True),
]


def test_reduce_ignores_the_program_ranges():
    alone = trace.reduce(profiler_of(HARNESS_EVENTS), 0, 1000)
    both = trace.reduce(profiler_of(HARNESS_EVENTS + PROGRAM_EVENTS), 0,
                        1000)
    assert alone.device.tolist() == [[200, 300], [700, 750]]
    assert both.device.tolist() == alone.device.tolist()
    assert both.launches == alone.launches == 2
    assert both.ops == alone.ops
    assert set(both.spans) == set(alone.spans) == {"fuse.integrate"}
    assert both.spans["fuse.integrate"].tolist() == [[100, 900]]
    assert both.gaps == alone.gaps


def recording(spans=(), counters=None):
    rec = profiling.Recording()
    rec.spans.extend(spans)
    rec.counters.update(counters or {})
    return rec


@pytest.fixture
def recorded(monkeypatch):
    """Puts a recording in the program's place for the readers."""
    def put(rec):
        monkeypatch.setattr(profiling, "UNDER_PROFILER", rec)
    put(profiling.Recording())
    return put


def test_idle_gap_goes_to_the_innermost_program_span():
    # busy 0-20 and 30-40 of 0-60, under a harness span 0-60; the gap
    # 20-30 opens inside the program's refine (25-28 is its child), the
    # gap 40-60 inside active_set alone
    t = trace.Trace(window_ns=60, device=trace.merge([(0, 20), (30, 40)]),
                    launches=0, spans={"fuse.integrate": np.array([[0, 60]])})
    rec = recording([("tsdf.refine_part", 25, 28), ("tsdf.refine", 15, 35),
                     ("tsdf.active_set", 10, 60)])
    gaps = program.stage_gaps(t, rec, 0, 60)
    assert gaps == {"tsdf.refine": 10, "tsdf.active_set": 20}
    table = program.table(t, rec, launch_ns=[5, 12, 16, 26, 50])
    assert table["tsdf.refine"] == pytest.approx(
        {"calls": 1, "host_s": 20e-9, "self_s": 17e-9, "idle_s": 7e-9,
         "launches": 2})
    assert table["tsdf.active_set"] == pytest.approx(
        {"calls": 1, "host_s": 50e-9, "self_s": 30e-9, "idle_s": 20e-9,
         "launches": 4})
    assert table["tsdf.refine_part"]["idle_s"] == pytest.approx(3e-9)


def test_busy_between_and_nesting():
    busy = trace.merge([(0, 20), (30, 40)])
    got = program.busy_between(busy, [0, 10, 25, 35, 45, -5],
                               [50, 35, 28, 36, 60, 5])
    assert got.tolist() == [30, 15, 0, 1, 0, 5]
    assert program.busy_between(busy[:0], [0], [9]).tolist() == [0]
    spans = [("c", 2, 3), ("b", 1, 4), ("d", 5, 6), ("a", 0, 10)]
    assert program.nesting(spans) == [1, 3, 3, -1]
    # the spans wholly inside windows 0-4 and 5-7
    rec = recording(spans)
    assert program.inside(rec, np.array([[5, 7], [0, 4]])) == spans[:3]


def ctx_of(t, counts):
    return SimpleNamespace(trace=t, out={"counts": counts}, work={})


def read(metric, ctx):
    return harness.Bench().reader(metric).read(ctx)


def test_mask_idle(recorded):
    # busy 0-20, 30-40 of a 100 ns window; active_set 10-50 and 60-70
    t = trace.Trace(window_ns=100, device=trace.merge([(0, 20), (30, 40)]),
                    launches=0)
    ctx = ctx_of(t, {"frames": 8})
    assert read("mask_idle.fuse", ctx) is None
    recorded(recording([("tsdf.k2", 12, 18), ("tsdf.active_set", 10, 50),
                        ("tsdf.active_set", 60, 70), ("tsdf.k1", 50, 60)],
                       {"tsdf.chunks": 2}))
    # idle inside: 20-30 and 40-50 and 60-70
    assert read("mask_idle.fuse", ctx) == pytest.approx(30.0)


def test_tail_plan_share(recorded):
    # 19 ticks of 10 ns, one of 50 and one of 100 holding a plan of 40 ns
    ticks = [(100 * i, 100 * i + 10) for i in range(19)] + [
        (3000, 3050), (5000, 5100)]
    t = trace.Trace(window_ns=6000, device=np.zeros((0, 2), np.int64),
                    launches=0, spans={"teleop.tick": np.array(ticks)})
    ctx = ctx_of(t, {"ticks": 21})
    assert read("tail_plan_share.teleop", ctx) is None
    recorded(recording([("grr.plan", 5020, 5060), ("grr.plan", 3, 7)]))
    # the 95th percentile of the 21 durations is the 20th smallest, 50:
    # the tail is the two long ticks, 150 ns, and the plan outside it
    # does not count
    assert read("tail_plan_share.teleop", ctx) == pytest.approx(
        100 * 40 / 150)
    recorded(recording([("grr.solve", 5020, 5060)]))
    assert read("tail_plan_share.teleop", ctx) == 0.0


@pytest.mark.parametrize("metric,counter,unit,n,value", [
    ("host_reads_per_tick.teleop", "host.reads", "ticks", 40, 900),
    ("ik_calls_per_tick.teleop", "ik.calls", "ticks", 40, 120),
    ("host_reads_per_waypt.plan", "host.reads", "waypoints", 500, 3000),
    ("ik_chunks_per_waypt.plan", "ik.chunks", "waypoints", 500, 6500),
])
def test_counter_readers(recorded, metric, counter, unit, n, value):
    t = trace.Trace(window_ns=10, device=np.zeros((0, 2), np.int64),
                    launches=0)
    ctx = ctx_of(t, {unit: n})
    assert read(metric, ctx) is None
    recorded(recording([("ik.solve", 1, 2)], {"other": 1}))
    assert read(metric, ctx) is None
    recorded(recording([], {counter: value}))
    assert read(metric, ctx) == pytest.approx(value / n)
    assert read(metric, ctx_of(t, {unit: 0})) is None


def test_readers_without_the_program(monkeypatch):
    """A program with no recording at all (one older than its spans)."""
    monkeypatch.delattr(profiling, "UNDER_PROFILER")
    t = trace.Trace(window_ns=10, device=np.zeros((0, 2), np.int64),
                    launches=3, spans={"teleop.tick": np.array([[0, 5]])})
    ctx = ctx_of(t, {"ticks": 1, "waypoints": 1, "frames": 1})
    for metric in NEW:
        assert read(metric, ctx) is None, metric


# the stitch cell's metrics, appended after NEW
STITCH = ["launches_per_frame.stitch", "device_idle.stitch",
          "icp_idle.stitch", "icp_steps_per_frame.stitch",
          "host_reads_per_frame.stitch"]


def _manifest_tests():
    spec = importlib.util.spec_from_file_location(
        "perfcells_manifest_checks",
        os.path.join(ROOT, "perfcells", "tests", "test_perfcells_manifest.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("check", ["test_top_level_keys", "test_configs",
                                   "test_workloads", "test_metrics"])
def test_manifest_accepts_the_new_entries(check):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    getattr(_manifest_tests(), check)(bench)
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name, cell in NEW.items():
        assert per_layer[name]["workloads"] == [cell]
    # appended after the metrics the benchmark had, and followed only by
    # the stitch cell's metrics
    tail = list(NEW) + STITCH
    assert [m["name"] for m in bench["per_layer"][-len(tail):]] == tail


def test_stages_tool_on_a_small_plan_cell(monkeypatch, capsys):
    """``perfcells.stages`` end to end on the CPU: a 24-waypoint arc, the
    run's line with the program's counters, spans table and stage gaps,
    and the plan readers' values from a real recording."""
    from perfcells import stages

    config = harness.Bench.config

    def small_config(self, name):
        c = config(self, name)
        c["arc"] = dict(c["arc"], waypoints=24)
        return c

    run = harness.run
    monkeypatch.setattr(harness.Bench, "config", small_config)
    monkeypatch.setattr(harness, "run",
                        lambda argv: run(argv, require_card=False))
    # this lane's conftest loads jax; the run's own check would refuse it
    monkeypatch.setattr(harness, "forbidden_modules", lambda: [])
    profiling.UNDER_PROFILER.clear()
    assert stages.main(["--workload", "plan.arc500", "--seed",
                        str(2**31 + 5), "--seconds", "1"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    profiling.UNDER_PROFILER.clear()
    assert line["correct"]
    assert line["counters"]["ik.calls"] >= 24
    assert line["counters"]["ik.graph_captures"] == 0
    assert {"scan.grr_plan", "grr.solve_batch", "grr.seeds", "ik.solve",
            "grr.select"} <= set(line["spans"])
    waypoints = line["attempted"]
    assert line["spans"]["grr.seeds"]["calls"] == waypoints
    assert line["metrics"]["host_reads_per_waypt.plan"]["value"] == \
        pytest.approx(line["counters"]["host.reads"] / waypoints)
    assert line["metrics"]["ik_chunks_per_waypt.plan"]["value"] == \
        pytest.approx(line["counters"]["ik.chunks"] / waypoints)
    assert line["idle_gaps_by_stage"] and line["clock_skew_ns"][0] >= 0
