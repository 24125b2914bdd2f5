"""The port's io helpers and ``utils.profiling`` against the JAX package's:
``save_ply``, the frame feeds, ``load_problem`` / ``safe_eval`` and the
roadmap checkpoints are numpy and stdlib on both sides, so results are
held equal, not close. The mesh and config cases follow ``TestMeshIO``
and ``TestConfig`` of ``tests/test_recon_io.py``.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from reconplan_tpu.io import checkpoint as jcheckpoint
from reconplan_tpu.io import config as jconfig
from reconplan_tpu.io import frames as jframes
from reconplan_tpu.io import meshio as jmeshio
from reconplan_tpu_torch.io import (
    ArrayFrameFeed,
    DirectoryFrameFeed,
    FrameSet,
    checkpoint,
    config,
    load_mesh,
    load_rgbd_folder,
    sample_mesh_surface,
    save_ply,
)
from reconplan_tpu_torch.utils.profiling import StageTimer, maybe_trace, trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANANA = os.path.join(REPO, "data/objects/011_banana/tsdf/nontextured.ply")
RNG = np.random.default_rng(0)


class TestMeshIO:
    def test_banana_meshes_load(self):
        v, f = load_mesh(BANANA)
        assert len(v) > 1000 and len(f) > 1000
        extent = v.max(0) - v.min(0)
        assert 0.1 < extent.max() < 0.3  # the YCB banana is ~20 cm long

    def test_ply_roundtrip(self, tmp_path):
        tris = RNG.normal(size=(10, 3, 3))
        p = str(tmp_path / "m.ply")
        save_ply(p, triangles=tris)
        v, f = load_mesh(p)
        np.testing.assert_allclose(v.reshape(-1, 3), tris.reshape(-1, 3),
                                   atol=1e-5)
        assert len(f) == 10

    def test_surface_sampling_on_surface(self):
        v, f = load_mesh(BANANA)
        pts, nrm = sample_mesh_surface(v, f, 2000)
        np.testing.assert_allclose(np.linalg.norm(nrm, axis=-1), 1.0,
                                   atol=1e-9)
        ref_pts, ref_nrm = jmeshio.sample_mesh_surface(v, f, 2000)
        np.testing.assert_array_equal(pts, ref_pts)
        np.testing.assert_array_equal(nrm, ref_nrm)

    @pytest.mark.parametrize("kind", ["triangles", "indexed", "colored",
                                      "points"])
    def test_save_ply_writes_the_jax_packages_file(self, tmp_path, kind):
        verts = RNG.normal(size=(12, 3)).astype(np.float32)
        faces = RNG.integers(0, 12, size=(7, 3))
        colors = RNG.uniform(size=(12, 3))
        kwargs = {
            "triangles": dict(triangles=verts.reshape(4, 3, 3)),
            "indexed": dict(vertices=verts, faces=faces),
            "colored": dict(triangles=verts.reshape(4, 3, 3), colors=colors),
            "points": dict(vertices=verts),
        }[kind]
        ours, theirs = str(tmp_path / "a.ply"), str(tmp_path / "b.ply")
        save_ply(ours, **kwargs)
        jmeshio.save_ply(theirs, **kwargs)
        with open(ours) as a, open(theirs) as b:
            assert a.read() == b.read()
        if kind != "points":
            v, f = load_mesh(ours)
            np.testing.assert_allclose(v, verts, atol=1e-6)
            assert len(f) == (7 if kind == "indexed" else 4)

    def test_save_ply_takes_tensors(self, tmp_path):
        tris = torch.as_tensor(RNG.normal(size=(5, 3, 3)), dtype=torch.float32)
        cols = torch.rand(15, 3)
        a, b = str(tmp_path / "t.ply"), str(tmp_path / "n.ply")
        save_ply(a, triangles=tris, colors=cols)
        save_ply(b, triangles=tris.numpy(), colors=cols.numpy())
        with open(a) as fa, open(b) as fb:
            assert fa.read() == fb.read()


class TestConfig:
    def test_safe_eval_pi_expressions(self):
        assert config.safe_eval("pi / 2") == pytest.approx(np.pi / 2)
        assert config.safe_eval("-0.7 - pi/2") == pytest.approx(
            -0.7 - np.pi / 2)
        assert config.safe_eval("3 * pi / 4") == pytest.approx(3 * np.pi / 4)

    def test_safe_eval_rejects_code(self):
        for bad in ["__import__('os')", "open('x')", "pi.__class__", "x + 1",
                    "(lambda: 1)()"]:
            with pytest.raises((NameError, SyntaxError)):
                config.safe_eval(bad)

    def test_load_problem_schema(self):
        opts = config.load_problem("ur10", "rot_variable_yaw")
        assert opts["robot_class"] == "UR10"
        assert len(opts["init_configs"]) == 8
        assert opts["init_configs"][1][0] == pytest.approx(np.pi / 4)
        assert "_comments" not in opts
        assert opts["robot_name"] == "ur10"

    @pytest.mark.parametrize("robot,problem", [
        ("ur10", "rot_free"), ("ur10", "rot_fixed"),
        ("ur10", "rot_variable_yaw")])
    def test_load_problem_equals_jax_package(self, robot, problem):
        assert config.load_problem(robot, problem) == jconfig.load_problem(
            robot, problem)

    def test_missing_problem_names_the_repos_folder_only(self):
        with pytest.raises(FileNotFoundError) as err:
            config.load_problem("ur10", "no_such_problem")
        assert os.path.join(REPO, "data", "problems") in str(err.value)
        assert config._PROBLEM_DIRS == (os.path.join(REPO, "data",
                                                     "problems"),)


def _write_capture(folder, n=5, npy=False, meta=None):
    """A recorded capture as ``load_rgbd_folder`` reads it: rgb/*.png and
    depth/*.png (u16) or depth/*.npy (f32)."""
    import PIL.Image

    os.makedirs(folder / "rgb")
    os.makedirs(folder / "depth")
    rng = np.random.default_rng(1)
    rgbs = rng.integers(0, 256, size=(n, 6, 8, 3), dtype=np.uint8)
    depths = rng.integers(300, 2000, size=(n, 6, 8)).astype(np.uint16)
    for i in range(n):
        PIL.Image.fromarray(rgbs[i]).save(folder / "rgb" / f"{i:04d}.png")
        if npy:
            np.save(folder / "depth" / f"{i:04d}.npy",
                    depths[i].astype(np.float32))
        else:
            PIL.Image.fromarray(depths[i]).save(
                folder / "depth" / f"{i:04d}.png")
    if meta is not None:
        with open(folder / "metadata.json", "w") as f:
            json.dump(meta, f)
    return rgbs, depths.astype(np.float32)


class TestFrames:
    @pytest.mark.parametrize("npy", [False, True], ids=["png", "npy"])
    def test_load_rgbd_folder(self, tmp_path, npy):
        meta = {"camera_intrinsics": {"fx": 600.0, "fy": 601.0, "ppx": 320.0,
                                      "ppy": 240.0}}
        rgbs, depths = _write_capture(tmp_path / "cap", npy=npy, meta=meta)
        fs = load_rgbd_folder(str(tmp_path / "cap"))
        ref = jframes.load_rgbd_folder(str(tmp_path / "cap"))
        assert isinstance(fs, FrameSet) and len(fs) == 5
        np.testing.assert_array_equal(fs.depth, depths)
        np.testing.assert_array_equal(fs.color, rgbs)
        assert fs.depth.dtype == np.float32
        assert fs.intrinsics == ref.intrinsics == (600.0, 601.0, 320.0, 240.0)
        np.testing.assert_array_equal(fs.depth, ref.depth)
        np.testing.assert_array_equal(fs.color, ref.color)
        cut = load_rgbd_folder(str(tmp_path / "cap"), truncate_to_multiple=2)
        assert len(cut) == 4 and cut.intrinsics == fs.intrinsics

    def test_folder_without_metadata_and_cx_cy_keys(self, tmp_path):
        _write_capture(tmp_path / "a", n=2)
        assert load_rgbd_folder(str(tmp_path / "a")).intrinsics is None
        _write_capture(tmp_path / "b", n=2, meta={"intrinsics": {
            "fx": 1.0, "fy": 2.0, "cx": 3.0, "cy": 4.0}})
        assert load_rgbd_folder(str(tmp_path / "b")).intrinsics == (
            1.0, 2.0, 3.0, 4.0)

    def test_feeds_batch_like_the_jax_packages(self, tmp_path):
        _write_capture(tmp_path / "cap", n=5)
        ours = list(DirectoryFrameFeed(str(tmp_path / "cap"), batch_size=2))
        theirs = list(jframes.DirectoryFrameFeed(str(tmp_path / "cap"),
                                                 batch_size=2))
        assert [len(b) for b in ours] == [len(b) for b in theirs] == [2, 2, 1]
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a.depth, b.depth)
            np.testing.assert_array_equal(a.color, b.color)
        whole = FrameSet(depth=np.arange(7 * 4).reshape(7, 2, 2).astype(
            np.float32), poses=np.tile(np.eye(4, dtype=np.float32), (7, 1, 1)),
            depth_scale=500.0, intrinsics=(1, 2, 3, 4))
        batches = list(ArrayFrameFeed(whole, batch_size=3))
        assert [len(b) for b in batches] == [3, 3, 1]
        assert all(b.color is None and b.depth_scale == 500.0
                   and b.intrinsics == (1, 2, 3, 4) for b in batches)
        np.testing.assert_array_equal(
            np.concatenate([b.depth for b in batches]), whole.depth)
        assert batches[2].poses.shape == (1, 4, 4)

    def test_array_feed_takes_tensors(self):
        fs = FrameSet(depth=torch.ones(5, 2, 2), color=torch.zeros(5, 2, 2, 3))
        batches = list(ArrayFrameFeed(fs, batch_size=4))
        assert [len(b) for b in batches] == [4, 1]
        assert isinstance(batches[0].depth, torch.Tensor)


class TestCheckpoint:
    def test_roundtrip_and_cross_package(self, tmp_path):
        arrays = dict(points=RNG.normal(size=(9, 7)).astype(np.float32),
                      edges=RNG.integers(0, 9, size=(20, 2)),
                      flags=RNG.integers(0, 2, size=9).astype(bool))
        ours, theirs = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
        checkpoint.save_roadmap_npz(ours, **arrays)
        jcheckpoint.save_roadmap_npz(theirs, **arrays)
        for load, path in ((checkpoint.load_roadmap_npz, ours),
                           (checkpoint.load_roadmap_npz, theirs),
                           (jcheckpoint.load_roadmap_npz, ours)):
            back = load(path)
            assert sorted(back) == sorted(arrays)
            for k, v in arrays.items():
                np.testing.assert_array_equal(back[k], v)
        assert checkpoint.FORMAT_VERSION == jcheckpoint.FORMAT_VERSION

    def test_newer_format_is_refused(self, tmp_path):
        path = str(tmp_path / "new.npz")
        np.savez_compressed(path, __version__=checkpoint.FORMAT_VERSION + 1,
                            points=np.zeros(3))
        with pytest.raises(ValueError, match="newer format"):
            checkpoint.load_roadmap_npz(path)


class TestProfiling:
    def test_stage_timer_on_the_cpu_is_a_wall_clock(self, tmp_path):
        timer = StageTimer()
        x = torch.zeros(4)
        with timer.stage("sleep"):
            time.sleep(0.02)
        with timer.stage("fenced", fence=lambda: x):
            x = x + 1
        with timer.stage("device", fence="cpu"):
            pass
        timer.add("given", 1.5)
        names = [n for n, _ in timer.stages]
        assert names == ["sleep", "fenced", "device", "given"]
        assert timer.stages[0][1] >= 0.02 and timer.total >= 1.52
        assert timer.as_dict()["given"] == 1.5 and "sleep=" in timer.report()
        timer.dump(str(tmp_path / "t.json"))
        with open(tmp_path / "t.json") as f:
            assert json.load(f) == timer.as_dict()

    def test_stage_is_recorded_when_the_body_raises(self):
        timer = StageTimer()
        with pytest.raises(KeyError):
            with timer.stage("boom"):
                raise KeyError("x")
        assert [n for n, _ in timer.stages] == ["boom"]

    def test_trace_writes_a_chrome_trace(self, tmp_path, capsys, monkeypatch):
        with trace(tmp_path / "tr") as prof:
            torch.ones(8).sum()
        assert os.path.getsize(tmp_path / "tr" / "trace.json") > 0
        assert len(prof.key_averages()) > 0
        monkeypatch.delenv("RECONPLAN_TRACE_DIR", raising=False)
        with maybe_trace():
            pass
        assert capsys.readouterr().out == ""
        monkeypatch.setenv("RECONPLAN_TRACE_DIR", str(tmp_path / "env"))
        with maybe_trace():
            torch.ones(2).sum()
        assert "trace written" in capsys.readouterr().out
        assert os.path.exists(tmp_path / "env" / "trace.json")
