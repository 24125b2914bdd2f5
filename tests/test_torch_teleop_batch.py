"""``reconplan_tpu_torch.grr.teleop_batch``'s GRR arm against the JAX
package on the CPU: the whole arm with its 16-tick blocks, a block
replay and the host fallbacks; and the port's engine on its own (the
step clamp, the four-arm benchmark, its checkpoint).

The roadmap is ``tests/test_grr.py``'s ``small_roadmap`` recipe, built
by the port and loaded into both packages
(``torch_parity.small_roadmap_pair``). The batched tick itself is held
in ``tests/test_torch_grr_tick.py``.

Tolerance: the fallback statistics equal, histories within 1e-3 rad
(f32 LM iterates through many ticks; measured max below).
"""

import numpy as np
import pytest
import torch

from reconplan_tpu.grr import teleop_batch as jtb
from reconplan_tpu_torch.grr import teleop_batch as ttb
from torch_parity import jax_ik_lanes, small_roadmap_pair, wrapped

torch.set_num_threads(2)

STAT_KEYS = ("ticks", "continuous", "plan_follow", "rescue", "stuck",
             "deep_recheck", "blocks", "block_replays")


@pytest.fixture(scope="module")
def small_roadmap(tmp_path_factory):
    """(JAX, port) RedundancyResolution of the same small roadmap."""
    pair = small_roadmap_pair(str(tmp_path_factory.mktemp("small")))
    assert len(pair[1].points) == 40
    return pair


def spiked_trajectories(res):
    """Three 29-tick lines between points a few mm off roadmap nodes (see
    ``tick_inputs``); row 1 jumps to an unreachable point at ticks 1-2, so
    the first 16-tick block has a non-smooth tick and is replayed, and a
    later block is accepted; row 2 is not alive."""
    rng = np.random.default_rng(5)
    trajs = []
    for a, b in ((0, 2), (5, 9), (12, 14)):
        pa, pb = (res.points[i][:3] + rng.uniform(-0.005, 0.005, 3)
                  for i in (a, b))
        u = np.linspace(0, 1, 29)[:, None]
        trajs.append(pa[None] * (1 - u) + pb[None] * u)
    trajs = np.stack(trajs).astype(np.float64)
    trajs[1, 1:3] = [2.0, 2.0, 2.0]
    return trajs


@pytest.fixture(scope="module")
def port_arm(small_roadmap):
    """The port's GRR arm over ``spiked_trajectories`` + 6 converge steps:
    (trajectories, q0s, alive, histories, stats)."""
    port = small_roadmap[1]
    trajs = spiked_trajectories(port)
    q0s, alive = ttb.cold_starts(port, trajs)
    assert alive.all()
    alive[2] = False
    tc, tstats = ttb.grr_teleop_batch(port, trajs, q0s, alive,
                                      max_change=0.04, converge_steps=6)
    return trajs, q0s, alive, tc, tstats


def test_grr_teleop_batch_replays_a_block_like_jax(small_roadmap, port_arm,
                                                   monkeypatch):
    """The GRR arm over 29 ticks + 6 converge steps with a rejected first
    block and an accepted later one: the replay starts from the pre-block
    state, so the histories agree with the JAX package's (whose state is
    immutable) within 1e-3 rad (measured max 4.8e-7), and every fallback
    statistic is equal.

    The JAX engine runs with its batch padding off (``_pow2`` the
    identity): padded, its ``write_rows`` scatters the last repaired row
    twice, the repair and its old value, and the old value wins, so one
    host repair a tick is lost (ROADMAP Queue 3). The port writes every
    repair."""
    ref = small_roadmap[0]
    trajs, q0s, alive, tc, tstats = port_arm
    monkeypatch.setattr(jtb, "_pow2", lambda n, lo=4: n)
    with jax_ik_lanes():
        jc, jstats = jtb.grr_teleop_batch(ref, trajs, q0s, alive,
                                          converge_steps=6)
    assert {k: tstats[k] for k in STAT_KEYS} == {k: jstats[k]
                                                 for k in STAT_KEYS}
    assert tstats["block_replays"] == 1 and tstats["blocks"] == 2
    assert tstats["rescue"] == 2
    assert [len(c) for c in tc] == [len(c) for c in jc] == [36, 36, 0]
    for a, b in zip(tc, jc):
        if len(a):
            assert wrapped(a, b).max() <= 1e-3
    # the rescue moved row 1 (a replay from the post-block state, or a
    # lost repair, would show here first)
    assert wrapped(tc[1][2], tc[1][1]).max() > 0.03
    for key, value in jstats["deviation_by_class_mm"].items():
        got = tstats["deviation_by_class_mm"][key]
        assert (got is None) == (value is None)
        if value is not None:
            assert got == pytest.approx(value, abs=2e-3)


def test_grr_tick_clamp(port_arm):
    """Twin of ``TestTeleopAndBatch.test_grr_engine_tick_clamp``: every
    consecutive pair of the GRR arm's history obeys the 0.04 max joint
    change (cyclic-aware), through blocks and host surgery alike."""
    c_trajs = port_arm[3]
    for c in c_trajs[:2]:
        assert len(c) == 29 + 6 + 1
        assert wrapped(c[1:], c[:-1]).max() <= 0.04 + 1e-4


def test_reference_benchmark_engine(small_roadmap):
    """Twin of ``TestTeleopAndBatch.test_reference_benchmark_engine``: all
    arms on two short lines, reference-shaped summaries."""
    port = small_roadmap[1]
    trajs = []
    for a, b in ((0, 1), (1, 2)):
        pa, pb = port.points[a][:3], port.points[b][:3]
        u = np.linspace(0, 1, 12)[:, None]
        trajs.append((pa[None] * (1 - u) + pb[None] * u).astype(np.float64))
    results, stats = ttb.run_reference_benchmark(
        port, {"line": trajs}, include_relaxed=True, converge_steps=10,
        verbose=False, device="cpu")
    row = results["line"]
    assert set(row) >= {"grr", "newton", "relaxed"}
    for arm, summary in row.items():
        assert summary["n"] == 2, (arm, summary)
        assert 0.0 <= summary["success_rate"] <= 1.0
    assert stats["line"]["grr"]["ticks"] > 0


def test_reference_benchmark_checkpoint_and_resume(small_roadmap, tmp_path):
    """A finished kind lands in the checkpoint; a resumed run skips it and
    runs only the kinds it lacks."""
    import json

    port = small_roadmap[1]
    pa, pb = port.points[0][:3], port.points[1][:3]
    u = np.linspace(0, 1, 6)[:, None]
    line = [(pa[None] * (1 - u) + pb[None] * u).astype(np.float64)]
    ck = str(tmp_path / "ck.json")
    first, _ = ttb.run_reference_benchmark(
        port, {"a": line}, arms=("newton",), converge_steps=2,
        verbose=False, checkpoint_path=ck, device="cpu")
    saved = json.load(open(ck))
    assert saved == {"results": first, "complete": False}
    second, stats = ttb.run_reference_benchmark(
        port, {"a": line, "b": line}, arms=("newton",), converge_steps=2,
        verbose=False, initial_results=saved["results"], device="cpu")
    assert second["a"] == first["a"] and set(second) == {"a", "b"}
    assert list(stats) == ["b"]


def test_step_toward_matches_numpy_twin(small_roadmap):
    """The device step (``_step_toward_j``) and the host step
    (``step_toward_batch``) clamp alike, across the cyclic wrap."""
    robot = small_roadmap[1].robot
    rng = np.random.default_rng(3)
    qs = rng.uniform(-np.pi, np.pi, (64, 6))
    tg = qs + rng.normal(0, 0.5, (64, 6))
    tg[:8, 0] = qs[:8, 0] + 2 * np.pi - 0.01
    host = ttb.step_toward_batch(robot, qs, tg, 0.04)
    dev = ttb._step_toward_j(robot, torch.as_tensor(qs, dtype=torch.float32),
                             torch.as_tensor(tg, dtype=torch.float32), 0.04)
    assert wrapped(dev.numpy(), host).max() <= 1e-5
    assert wrapped(host, qs).max() <= 0.04 + 1e-9
