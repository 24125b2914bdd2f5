"""The port's measurement tools (``reconplan_tpu_torch/benchmarks/``)
against the repo's JAX scripts (``benchmarks/``, loaded by path: the
folder is no package) on the same inputs at small sizes, the port with
``device="cpu"``. Each test compares the two scripts' output lines (or
their JSON keys) and states its tolerance and the largest difference
measured. ``bench_fusion`` is in ``test_torch_bench_fusion.py``,
``bench_stitch`` and ``diag_posefree`` in ``test_torch_bench_stitch.py``,
``dtw_gap`` in ``test_torch_dtw_gap.py`` and the roadmap writers in
``test_torch_roadmap_tools.py``.
"""

import argparse
import importlib.util
import inspect
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from reconplan_tpu_torch.benchmarks import (
    bench_fusion,
    bench_grr,
    bench_nn,
    bench_poisson,
    bench_stitch,
    diag_posefree,
    dtw_gap,
    eval_poisson_fidelity,
    eval_scan_coverage,
    expand_coverage,
    refine_roadmap,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NUM = re.compile(r"-?\d+\.?\d*(?:[eE][+-]?\d+)?")
PORTS = {m.__name__.rsplit(".", 1)[1]: m for m in (
    bench_fusion, bench_grr, bench_nn, bench_poisson, bench_stitch,
    diag_posefree, dtw_gap, eval_poisson_fidelity, eval_scan_coverage,
    expand_coverage, refine_roadmap)}
# the tools whose main takes keywords, not flags
KEYWORD_TOOLS = ("bench_fusion", "bench_grr", "bench_nn", "bench_poisson")
# flags each port leaves behind: --fpb set the JAX stitcher's lax.scan
# block, which the port's stitcher does not have
LEFT_BEHIND = {"bench_stitch": {"platform", "fpb"}}


def load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_benchmarks_{name}", os.path.join(REPO, "benchmarks",
                                               f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def json_rows(text):
    return [json.loads(line) for line in text.splitlines()
            if line.startswith("{")]


def result_lines(text, *starts):
    """The output lines that begin with one of ``starts`` (stripped), each
    as (its words, its numbers)."""
    out = []
    for line in text.splitlines():
        s = line.strip()
        if s.startswith(starts):
            out.append((NUM.sub("#", s), [float(x) for x in NUM.findall(s)]))
    return out


class _Parsed(Exception):
    pass


def parser_actions(main, monkeypatch):
    """{dest: action} of the parser ``main`` builds, stopped at its
    ``parse_args``."""
    got = {}

    def grab(self, args=None, namespace=None):
        got.update({a.dest: a for a in self._actions if a.dest != "help"})
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main() if not inspect.signature(main).parameters else main([])
    monkeypatch.undo()
    return got


@pytest.mark.parametrize("name", sorted(PORTS))
def test_flags_match_the_jax_script(name, monkeypatch):
    """The port's arguments are the JAX script's, less ``--platform`` (and
    ``--fpb`` for bench_stitch), plus ``--device`` (``device=None`` for
    the tools called with keywords): the same names, defaults, types and
    actions; only the roadmap writers' ``--out`` differs (required)."""
    jax_main = load_jax_script(name).main
    port_main = PORTS[name].main
    if name in KEYWORD_TOOLS:
        want = dict(inspect.signature(jax_main).parameters)
        got = dict(inspect.signature(port_main).parameters)
        assert list(got) == list(want) + ["device"]
        assert got.pop("device").default is None
        assert {k: p.default for k, p in got.items()} == {
            k: p.default for k, p in want.items()}
        return
    want = parser_actions(jax_main, monkeypatch)
    got = parser_actions(port_main, monkeypatch)
    # dtw_gap and eval_poisson_fidelity have no --platform (they forced
    # the CPU)
    dropped = (LEFT_BEHIND.get(name, set()) | {"platform"}) & set(want)
    assert LEFT_BEHIND.get(name, set()) <= dropped
    assert set(got) == (set(want) - dropped) | {"device"}
    assert got["device"].default is None
    for dest in set(want) - dropped:
        a, b = want[dest], got[dest]
        assert (a.option_strings, a.type, type(a), a.nargs) == (
            b.option_strings, b.type, type(b), b.nargs), dest
        if name in ("expand_coverage", "refine_roadmap") and dest == "out":
            assert b.required and not a.required
        else:
            assert a.default == b.default, dest


def test_bench_poisson_matches_jax(capsys):
    """20,000 banana samples at depth 32: the same triangle count; the
    Chamfer and its two directions within 0.01 mm (measured: 0.001, the
    printed last digit; the iso level is held at 1e-5 of chi's peak in
    test_torch_poisson.py)."""
    load_jax_script("bench_poisson").main(n_points=20_000, depth=32)
    (want,) = json_rows(capsys.readouterr().out)
    got = bench_poisson.main(n_points=20_000, depth=32, device="cpu")
    assert json_rows(capsys.readouterr().out) == [got]
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for key in ("config", "depth", "input_points", "triangles"):
        assert got[key] == want[key], key
    for key in ("chamfer_mm", "mesh_to_gt_mm", "gt_to_mesh_mm"):
        assert abs(got[key] - want[key]) <= 0.01, key


def test_bench_nn_matches_jax(capsys, monkeypatch):
    """20,000 SE3 points, 1,024 queries, k = 5: the neighbours equal the
    JAX script's, the distances within 1e-6 (measured: 6e-8); the JSON
    keys are the JAX script's with ``tpu_`` read as ``device_`` and
    ``balltree_`` as ``tree_``, plus ``tree`` and ``device``."""
    from reconplan_tpu.ops import nn as jnn

    seen = []
    jax_knn = jnn.se3_knn

    def recorded(*a, **k):
        seen.append(jax_knn(*a, **k))
        return seen[-1]

    monkeypatch.setattr(jnn, "se3_knn", recorded)
    load_jax_script("bench_nn").main(n_points=20_000, n_queries=1024)
    (want,) = json_rows(capsys.readouterr().out)
    got, d, idx = bench_nn.main(n_points=20_000, n_queries=1024,
                                device="cpu")
    jd, jidx = (np.asarray(x) for x in seen[-1])
    assert np.array_equal(idx.numpy(), jidx)
    assert np.abs(d.numpy() - jd).max() <= 1e-6
    assert set(got) == {k.replace("tpu_", "device_").replace(
        "balltree_", "tree_") for k in want} | {"tree", "device"}
    assert got["tree"] == "sklearn BallTree"
    for key in ("n_points", "n_queries", "k"):
        assert got[key] == want[key]
    assert got["device_exact"] is want["tpu_exact"] is True


def test_bench_nn_without_sklearn(capsys, monkeypatch):
    """With scikit-learn hidden, as on a machine without it, the tree is
    scipy's cKDTree under the same keys, and the neighbours are the same
    as with it."""
    with_sk, _, idx = bench_nn.main(n_points=2_000, n_queries=64,
                                    device="cpu")
    monkeypatch.setitem(sys.modules, "sklearn.neighbors", None)
    got, _, idx_kd = bench_nn.main(n_points=2_000, n_queries=64,
                                   device="cpu")
    assert json_rows(capsys.readouterr().out)[-1] == got
    assert set(got) == set(with_sk)
    assert got["tree"] == "scipy cKDTree"
    assert got["tree_build_seconds"] >= 0 and got["tree_query_seconds"] >= 0
    assert torch.equal(idx_kd, idx)


def test_eval_poisson_fidelity_matches_jax(capsys, monkeypatch):
    """The bumpy fixture drawn from the same generator equals the JAX
    script's (points within 1e-7, normals within 1e-6); the exact
    residual |G| / |grad G| on the same vertices within 1e-6 of the
    fixture's radius R0 = 0.2 m, 2e-7 m (measured: 3.0e-8 m, two ulps of
    R0: the libraries' sin and cos part by an ulp; autograd against
    jax.grad); then both scripts at
    depth 32: the same lines and triangle counts, every number within
    0.01 mm or 0.02 percentage points (measured: 0.006 mm)."""
    jm = load_jax_script("eval_poisson_fidelity")
    monkeypatch.setattr(jm, "RNG", np.random.default_rng(0))
    jp, jn = jm.bumpy_exact(5000)
    tp, tn = eval_poisson_fidelity.bumpy_exact(np.random.default_rng(0),
                                               5000, "cpu")
    assert np.abs(tp - jp).max() <= 1e-7
    assert np.abs(tn - jn).max() <= 1e-6

    import jax
    import jax.numpy as jnp

    verts = (jp * np.random.default_rng(1).uniform(
        0.9, 1.1, (len(jp), 1))).astype(np.float32)
    res = np.abs(np.asarray(jm.G(jnp.asarray(verts))))
    gmag = np.asarray(jnp.linalg.norm(
        jax.vmap(jax.grad(jm.G))(jnp.asarray(verts)), axis=-1))
    want = res / np.maximum(gmag, 1e-6)
    got = eval_poisson_fidelity.exact_distance(torch.as_tensor(verts))
    assert np.abs(got - want).max() <= 1e-6 * jm.R0

    monkeypatch.setattr(jm, "RNG", np.random.default_rng(0))
    monkeypatch.setattr(sys, "argv", ["eval_poisson_fidelity", "--depth",
                                      "32"])
    jm.main()
    want = result_lines(capsys.readouterr().out, "bumpy", "banana",
                        "coverage")
    eval_poisson_fidelity.main(["--depth", "32", "--device", "cpu"])
    got = result_lines(capsys.readouterr().out, "bumpy", "banana",
                       "coverage")
    assert len(got) == len(want) == 8
    for (gw, g), (ww, w) in zip(got, want):
        assert gw == ww
        if gw.startswith(("bumpy", "banana")):
            assert g[:2] == w[:2]  # the depth and the triangle count
        # the numbers, less the trailing seconds of the result lines
        g, w = (np.array(x[:-1] if len(x) > 4 else x) for x in (g, w))
        assert np.abs(g - w).max() <= 0.02, (gw, g, w)


def test_eval_scan_coverage_matches_jax(tmp_path, capsys, monkeypatch):
    """A scan-like mesh (the ground truth at the scan's object point, its
    vertices moved up to 1 mm and every seventh face cut out): the
    per-sample exact distances within 1e-6 m of the JAX script's
    (measured: 2.4e-7 m), and the same table, its numbers within 1e-3 mm
    and one unit of their printed last digit."""
    from reconplan_tpu.recon import metrics as jmetrics
    from reconplan_tpu_torch.apps.scan import BANANA_MESH, OBJECT_POINT
    from reconplan_tpu_torch.io.meshio import load_mesh, save_ply

    v, f = load_mesh(BANANA_MESH)
    rng = np.random.default_rng(3)
    v = v + np.asarray(OBJECT_POINT) + rng.uniform(-1e-3, 1e-3, v.shape)
    f = np.delete(f, np.s_[::7], axis=0)
    mesh = str(tmp_path / "mesh.ply")
    save_ply(mesh, vertices=v.astype(np.float32), faces=f)

    seen = []
    jax_dist = jmetrics.points_to_mesh_distance

    def recorded(*a, **k):
        seen.append(np.asarray(jax_dist(*a, **k)))
        return seen[-1]

    monkeypatch.setattr(jmetrics, "points_to_mesh_distance", recorded)
    argv = ["--mesh", mesh, "--samples", "8000"]
    load_jax_script("eval_scan_coverage").main(argv + ["--platform", "cpu"])
    want = result_lines(capsys.readouterr().out, "mesh", "gt->mesh", "z",
                        "az")
    d, table = eval_scan_coverage.main(argv + ["--device", "cpu"])
    got = result_lines(capsys.readouterr().out, "mesh", "gt->mesh", "z",
                       "az")
    assert np.abs(d / 1000.0 - seen[-1]).max() <= 1e-6
    assert len(table["height"]) == 4 and len(got) == len(want) > 12
    for (gw, g), (ww, w) in zip(got, want):
        assert gw == ww
        assert np.allclose(g, w, rtol=0, atol=1e-3 + 0.1 + 1e-9) if \
            "%" in gw else np.allclose(g, w, rtol=0, atol=2e-3), (gw, g, w)


def test_bench_grr_matches_jax(tmp_path, capsys, monkeypatch):
    """16 roadmap nodes, 24 waypoints, 3 pictures, 64^3: the counts held
    as test_torch_scan.py holds run_scan's (the same roadmap size and
    waypoint count, the waypoints solved within one). The JAX script's
    roadmap goes to ``tmp_path`` (the script names a fixed folder), and
    its fusion runs its Pallas kernels under the TPU interpreter. At
    64^3 a brick's footprint at the scan's 0.3 m passes the JAX kernel's
    sampling window (57 rows x 128 lanes), which drops the outer voxels,
    so the meshes are not compared here: test_torch_bench_fusion.py
    holds the fusion where the window covers every brick."""
    from reconplan_tpu.apps import redundancy as jredundancy
    from torch_parity import jax_ik_lanes, pallas_tpu_interpret

    build = jredundancy.build_roadmap

    def into_tmp(*a, **k):
        return build(*a, **{**k, "out_dir": str(tmp_path / "jax_roadmap")})

    monkeypatch.setattr(jredundancy, "build_roadmap", into_tmp)
    kw = dict(n_nodes=16, n_waypoints=24, n_images=3, grid_dim=64)
    with jax_ik_lanes(), pallas_tpu_interpret():
        load_jax_script("bench_grr").main(**kw)
    (want,) = json_rows(capsys.readouterr().out)
    got, res, tris = bench_grr.main(**kw, device="cpu")
    assert os.listdir(tmp_path / "jax_roadmap")
    assert set(got) == set(want) | {"device"}
    for key in ("config", "roadmap_nodes", "waypoints_total"):
        assert got[key] == want[key]
    assert abs(got["waypoints_solved"] - want["waypoints_solved"]) <= 1
    assert got["waypoints_solved"] >= 22
    assert got["triangles"] == len(tris) > 0
    assert 0 < got["chamfer_mm"] < 20
    assert res.configs_t.device.type == "cpu"
