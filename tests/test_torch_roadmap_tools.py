"""The port's roadmap writers (``reconplan_tpu_torch.benchmarks.
expand_coverage`` and ``refine_roadmap``) against the repo's JAX scripts
(``benchmarks/``, loaded by path) on the CPU, on ``tests/test_grr.py``'s
small roadmap (``torch_parity.small_roadmap_pair``: 40 rot_free arc
nodes, built by the port and loaded into both packages), writing into
``tmp_path``. As the solver tests hold expansions, by outcome: f32 LM
iterates part the packages by up to 5.3e-4 rad when a seed starts far
off (ROADMAP Queue 3), so configured counts and the disconnection ratio
are compared, not configurations.
"""

import os

import numpy as np
import pytest
import torch

import reconplan_tpu.grr as jgrr
from reconplan_tpu.grr import resolution as jres
from reconplan_tpu_torch.benchmarks import REPO, expand_coverage, \
    refine_roadmap
from reconplan_tpu_torch.grr import census_reachability, evaluate_roadmap
from reconplan_tpu_torch.grr import resolution as tres
from test_torch_bench_scripts import load_jax_script
from torch_parity import jax_ik_lanes, small_roadmap_pair, ur10_pair

torch.set_num_threads(2)

NAMES = ("workspace", "solver", "resolution")


# nodes whose configurations the fixture takes out, so that the census
# finds reachable gaps to seed and the anneal has nodes to re-adopt
GAPS = (3, 11, 19, 27, 35)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """A folder holding the small roadmap with the ``GAPS`` nodes
    unconfigured, and the two packages' robots."""
    built = str(tmp_path_factory.mktemp("small_roadmap"))
    _, port = small_roadmap_pair(built)
    solver = port.solver
    solver.has_config[list(GAPS)] = False
    edges = np.asarray(port.workspace.edges)
    solver.edge_connected[np.isin(edges, GAPS).any(axis=1)] = False
    folder = str(tmp_path_factory.mktemp("gapped_roadmap"))
    port.build_resolution_graph_and_nn()
    for name in NAMES:
        getattr(port, f"save_{name}_graph")(
            os.path.join(folder, f"{name}.npz"))
    return folder, ur10_pair("rot_free")


def _loaded(small):
    folder, (jr, tr) = small
    pair = (jres.RedundancyResolution(jr),
            tres.RedundancyResolution(tr, device="cpu"))
    for res in pair:
        for name in NAMES:
            getattr(res, f"load_{name}_graph")(
                os.path.join(folder, f"{name}.npz"))
    return pair


def test_seed_islands_matches_jax(small):
    """The same census (the port's, 2 restarts) given to both scripts'
    ``seed_islands``: the same adopted nodes in the same order, the same
    configurations, and the same configured edges by outcome."""
    ref, port = _loaded(small)
    census = census_reachability(port, restarts=2, seed=0, verbose=False)
    want = load_jax_script("expand_coverage").seed_islands(
        ref, census, spacing=1, verbose=False)
    got = expand_coverage.seed_islands(port, census, spacing=1,
                                       verbose=False)
    assert got == want and len(got) > 0
    assert np.array_equal(port.solver.has_config, ref.solver.has_config)
    assert np.array_equal(port.solver.configs, np.asarray(ref.solver.configs))
    assert abs(int(port.solver.edge_connected.sum())
               - int(np.asarray(ref.solver.edge_connected).sum())) <= 1


def test_anneal_matches_jax(small):
    """Both scripts' ``anneal`` from the same roadmap: 0% disconnection
    in both, configured counts within one node (measured: equal)."""
    ref, port = _loaded(small)
    with jax_ik_lanes():
        load_jax_script("refine_roadmap").anneal(ref, verbose=False)
    refine_roadmap.anneal(port, verbose=False)
    m_j = jgrr.evaluate_roadmap(ref, verbose=False)
    m_t = evaluate_roadmap(port, verbose=False)
    assert m_j["disconnection_ratio"] == m_t["disconnection_ratio"] == 0
    assert abs(m_j["n_configured"] - m_t["n_configured"]) <= 1


@pytest.mark.parametrize("tool,flags", [
    ("expand_coverage", ["--rounds", "1", "--restarts", "2",
                         "--smooth-iters", "1"]),
    ("refine_roadmap", ["--smooth-iters", "1"]),
])
def test_main_matches_jax(small, tmp_path, monkeypatch, tool, flags):
    """The whole pipeline into ``tmp_path``: the three graph files written
    in both outputs, ``evaluate_roadmap`` of the result with the same node
    and edge counts, configured counts within two nodes and the
    disconnection ratio within 2 points (refine: 0 in both; measured:
    equal counts)."""
    folder = small[0]
    seen = []
    jax_eval = jgrr.evaluate_roadmap

    def recorded(*a, **k):
        seen.append(jax_eval(*a, **k))
        return seen[-1]

    monkeypatch.setattr(jgrr, "evaluate_roadmap", recorded)
    argv = [folder, "--rotation-type", "rot_free", *flags]
    with jax_ik_lanes():
        load_jax_script(tool).main(
            argv + ["--out", str(tmp_path / "jax"), "--platform", "cpu"])
    port_main = {"expand_coverage": expand_coverage.main,
                 "refine_roadmap": refine_roadmap.main}[tool]
    got = port_main(argv + ["--out", str(tmp_path / "port"), "--device",
                            "cpu"])
    metrics = got[0] if tool == "expand_coverage" else got
    want = seen[0]
    for side in ("jax", "port"):
        assert sorted(os.listdir(tmp_path / side)) == [
            f"{n}.npz" for n in sorted(NAMES)]
    assert (metrics["n_nodes"], metrics["n_edges"]) == (want["n_nodes"],
                                                        want["n_edges"])
    assert abs(metrics["n_configured"] - want["n_configured"]) <= 2
    assert abs(metrics["disconnection_ratio"]
               - want["disconnection_ratio"]) <= 2.0
    if tool == "refine_roadmap":
        assert metrics["disconnection_ratio"] == 0


@pytest.mark.parametrize("tool", ["expand_coverage", "refine_roadmap"])
def test_writers_need_out_and_refuse_graph(small, tool, capsys):
    """Without ``--out`` the parser exits; an ``--out`` under the
    committed ``graph/`` (also through ``..``) raises before anything is
    loaded or written."""
    mod = {"expand_coverage": expand_coverage,
           "refine_roadmap": refine_roadmap}[tool]
    folder = small[0]
    with pytest.raises(SystemExit):
        mod.main([folder, "--device", "cpu"])
    assert "--out" in capsys.readouterr().err
    for out in (os.path.join(REPO, "graph", "ur10", "port_test_out"),
                os.path.join(REPO, "graph", "x", "..", "ur10", "rot_free")):
        with pytest.raises(ValueError, match="graph/"):
            mod.main([folder, "--out", out, "--device", "cpu"])
    assert not os.path.exists(os.path.join(REPO, "graph", "ur10",
                                           "port_test_out"))
