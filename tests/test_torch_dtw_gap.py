"""``reconplan_tpu_torch.benchmarks.dtw_gap`` against the repo's
``benchmarks/dtw_gap.py`` (loaded by path) on the CPU, on the committed
``graph/ur10/rot_variable_yaw`` roadmap.

Both scripts track the first 2 circle_random trajectories of seed 7,
cut to their first 24 samples, with 6 converge steps (in both packages,
through their ``generate_trajectories`` and ``grr_teleop_batch``): the
full 201 samples and 100 converge steps take minutes a GRR arm on this
CPU. The JAX engine runs with its batch padding off (``_pow2`` the
identity; its padded ``write_rows`` loses one host repair a tick, ROADMAP
Queue 3), as ``tests/test_torch_teleop_batch.py`` runs it.
"""

import functools
import json
import os

import pytest
import torch

from reconplan_tpu.grr import experiment as jexperiment
from reconplan_tpu.grr import teleop_batch as jtb
from reconplan_tpu_torch.benchmarks import dtw_gap
from reconplan_tpu_torch.grr import experiment as texperiment
from reconplan_tpu_torch.grr import teleop_batch as ttb
from test_torch_bench_scripts import load_jax_script
from torch_parity import jax_ik_lanes

torch.set_num_threads(2)

SAMPLES, CONVERGE = 24, 6


def _shorter(monkeypatch, experiment, teleop_batch):
    gen = experiment.generate_trajectories
    monkeypatch.setattr(experiment, "generate_trajectories",
                        lambda *a, **k: [t[:SAMPLES] for t in gen(*a, **k)])
    monkeypatch.setattr(teleop_batch, "grr_teleop_batch", functools.partial(
        teleop_batch.grr_teleop_batch, converge_steps=CONVERGE))


def test_dtw_gap_matches_jax(tmp_path, monkeypatch, capsys):
    """Both arms (roadmap seeds, greedy re-seed): the same success rate
    and deviation tick counts by regime, the mean DTW and ratio within
    1e-3 relative and the deviation a tick within 2e-3 mm (f32 LM
    iterates; measured below 1e-5 relative); the JSON document has the
    JAX script's keys plus ``"device"`` (and ``device`` in its config)."""
    _shorter(monkeypatch, jexperiment, jtb)
    _shorter(monkeypatch, texperiment, ttb)
    monkeypatch.setattr(jtb, "_pow2", lambda n, lo=4: n)
    argv = ["--per-kind", "2", "--kinds", "circle_random"]
    with jax_ik_lanes():
        load_jax_script("dtw_gap").main(
            argv + ["--out", str(tmp_path / "jax.json")])
    got = dtw_gap.main(argv + ["--out", str(tmp_path / "port.json"),
                               "--device", "cpu"])
    capsys.readouterr()
    want = json.loads((tmp_path / "jax.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == json.loads(
        json.dumps(got))
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert set(got["config"]) == set(want["config"]) | {"device"}
    rows_t = got["kinds"]["circle_random"]
    rows_j = want["kinds"]["circle_random"]
    assert set(rows_t) == set(rows_j) == {"roadmap_seeds", "greedy_seed"}
    for arm, r in rows_j.items():
        t = rows_t[arm]
        assert set(t) == set(r)
        assert t["success_rate"] == r["success_rate"]
        assert t["deviation_ticks"] == r["deviation_ticks"]
        for key in ("mean_dtw", "mean_ratio"):
            assert t[key] == pytest.approx(r[key], rel=1e-3), (arm, key)
        for cls, value in r["deviation_by_class_mm"].items():
            assert (t["deviation_by_class_mm"][cls] is None) == (
                value is None)
            if value is not None:
                assert t["deviation_by_class_mm"][cls] == pytest.approx(
                    value, abs=2e-3)


def test_dtw_gap_refuses_the_committed_tables(tmp_path):
    """``--out`` under ``benchmarks/results/`` raises before anything
    runs, and writes nothing."""
    from reconplan_tpu_torch.benchmarks import REPO

    out = f"{REPO}/benchmarks/results/dtw_gap_port_test.json"
    with pytest.raises(ValueError, match="benchmarks/results"):
        dtw_gap.main(["--out", out, "--device", "cpu"])
    dotted = os.path.join(REPO, "benchmarks", "results", "x", "..", "y.json")
    with pytest.raises(ValueError, match="benchmarks/results"):
        dtw_gap.main(["--out", dotted, "--device", "cpu"])
    assert not os.path.exists(out)
