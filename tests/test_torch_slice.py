"""The whole fusion slice through the port against the JAX package.

An 8-frame banana orbit at 128x256, rendered once by the port's splat
camera, goes through the port's ``FusionPipeline(engine="brick")`` (the
kernels' plain versions on the CPU) and the JAX ``FusionPipeline(
engine="dense")``; both meshes are scored by ``chamfer_to_mesh`` against
the YCB banana. Also: the port runs in a process where JAX cannot be
imported, it counts no kernel launch on the CPU, and the kernel build
refuses clearly without ``nvcc``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from reconplan_tpu.io.frames import FrameSet as JFrameSet
from reconplan_tpu.recon import fusion as jfusion
from reconplan_tpu.recon import metrics as jmetrics
from reconplan_tpu_torch.io.frames import FrameSet
from reconplan_tpu_torch.io.meshio import load_mesh
from reconplan_tpu_torch.io.render import SplatCamera
from reconplan_tpu_torch.ops.kernels import build
from reconplan_tpu_torch.recon import fusion as tfusion
from reconplan_tpu_torch.recon import metrics as tmetrics
from reconplan_tpu_torch.utils import profiling

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANANA = os.path.join(REPO, "data/objects/011_banana/tsdf/nontextured.ply")
GRID = dict(dims=(64, 64, 64), origin=(-0.2, -0.2, -0.15),
            voxel_size=0.4 / 63)
N_SURFACE = 50_000


def render_orbit(n_frames=8, H=128, W=256, samples=200_000, device="cpu"):
    """Frames of the banana from an orbit of radius 0.35 m, height 0.25 m."""
    cam = SplatCamera(width=W, height=H, fx=200.0, fy=200.0, cx=W / 2,
                      cy=H / 2, samples_per_mesh=samples, device=device)
    cam.add_mesh_file(BANANA)
    d, c, p = [], [], []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        eye = [0.35 * np.cos(ang), 0.35 * np.sin(ang), 0.25]
        depth, color, T = cam.take_picture(eye, [0.0, 0.0, 0.0])
        d.append(depth.cpu().numpy())
        c.append(color.cpu().numpy())
        p.append(T)
    return np.stack(d), np.stack(c), np.stack(p), cam.intrinsics


@pytest.fixture(scope="module")
def orbit():
    return render_orbit()


@pytest.fixture(scope="module")
def port_result(orbit):
    d, c, p, K = orbit
    pipe = tfusion.FusionPipeline(engine="brick", with_color=True,
                                  device="cpu", **GRID)
    with profiling.recording() as rec:
        pipe.integrate(FrameSet(depth=d, color=c, poses=p, intrinsics=K))
        tris, cols = pipe.extract_mesh(with_colors=True)
    v, f = load_mesh(BANANA)
    ch = tmetrics.chamfer_to_mesh(tris.reshape(-1, 3), v, f,
                                  n_surface_samples=N_SURFACE)
    launched = {k: n for k, n in rec.counters.items()
                if k.startswith("kernel.")}
    return tris.numpy(), cols.numpy(), ch, (rec.counters, launched)


def test_slice_matches_jax_dense_pipeline(orbit, port_result):
    d, c, p, K = orbit
    pipe = jfusion.FusionPipeline(engine="dense", **GRID)
    pipe.integrate(JFrameSet(depth=d, color=c, poses=p, intrinsics=K))
    tris_j = pipe.extract_mesh()
    v, f = load_mesh(BANANA)
    ch_j = jmetrics.chamfer_to_mesh(tris_j.reshape(-1, 3), v, f,
                                    n_surface_samples=N_SURFACE)
    tris, _, ch, _ = port_result
    print(f"triangles port {len(tris)} jax {len(tris_j)}; Chamfer port "
          f"{ch[0] * 1e3:.4f} mm jax {ch_j[0] * 1e3:.4f} mm")
    assert len(tris_j) > 500
    assert abs(len(tris) - len(tris_j)) <= 0.005 * len(tris_j)
    assert abs(ch[0] - ch_j[0]) <= 0.01 * ch_j[0]


def test_slice_outputs_are_sane(port_result):
    tris, cols, ch, _ = port_result
    assert tris.shape[1:] == (3, 3) and np.isfinite(tris).all()
    assert cols.shape == tris.shape
    assert 0.0 <= cols.min() and cols.max() <= 1.0 and cols.max() > 0.1
    # a 6.3 mm voxel bounds the accuracy at this size
    assert ch[0] < 8e-3


def test_launch_counters_stay_zero_on_cpu(port_result):
    counters, launched = port_result[3]
    assert counters["tsdf.chunks"] > 0 and launched == {}


def test_port_runs_with_jax_blocked():
    """A process in which ``import jax`` and ``import reconplan_tpu`` fail
    imports the port and runs a tiny slice."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["reconplan_tpu"] = None
import numpy as np, torch
torch.set_num_threads(2)
import reconplan_tpu_torch
from reconplan_tpu_torch.bench import make_frames
from reconplan_tpu_torch.io import FrameSet
from reconplan_tpu_torch.recon import FusionPipeline, chamfer_distance
d, p, K = make_frames(4, H=48, W=64, fx=60.0, fy=60.0)
pipe = FusionPipeline(dims=(32, 32, 32), origin=(-0.16,) * 3,
                      voxel_size=0.32 / 31, device="cpu")
pipe.integrate(FrameSet(depth=d, poses=p, intrinsics=K))
tris = pipe.extract_mesh()
assert len(tris) > 50, len(tris)
r = tris.reshape(-1, 3).norm(dim=-1)
assert (r - 0.12).abs().mean() < 0.01, (r - 0.12).abs().mean()
ch, _, _ = chamfer_distance(tris.reshape(-1, 3), tris.reshape(-1, 3))
assert float(ch) == 0.0
from reconplan_tpu_torch.ops import tsdf_brick as tb
from reconplan_tpu_torch.parallel import (
    gather_brick_grid, make_mesh, make_sharded_brick_grid,
    sharded_integrate_frames_bricked)
g, n = tb.integrate_frames_bricked(
    tb.make_brick_grid((32,) * 3, (-0.16,) * 3, 0.32 / 31, device="cpu"),
    d, p, *K, dilate_active=False)
s, _ = sharded_integrate_frames_bricked(
    make_sharded_brick_grid((32,) * 3, (-0.16,) * 3, 0.32 / 31,
                            mesh=make_mesh(devices=["cpu"] * 2)),
    d, p, *K)
assert n > 0 and torch.equal(gather_brick_grid(s).sdf, g.sdf)
assert not [m for m in sys.modules if m.startswith("jax")
            and sys.modules[m] is not None]
print("ok", len(tris))
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from torch.utils import cpp_extension

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
    assert not list(tmp_path.iterdir())


def test_build_runs_one_nvcc_per_source_then_links(monkeypatch, tmp_path):
    """Each source compiles in its own process, all started together, and
    one more process links the objects; a failing compile raises with its
    output after every process has ended."""
    calls = tmp_path / "calls.txt"
    fake = tmp_path / "nvcc"
    fake.write_text(
        "#!/bin/sh\n"
        f'echo "$*" >> {calls}\n'
        'case "$*" in *bad.cu*) echo "bad.cu: error" >&2; exit 2;; esac\n'
        'while [ "$1" != "-o" ]; do shift; done; touch "$2"\n')
    fake.chmod(0o755)
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for name in ("a.cu", "b.cu", "c.cu"):
        (csrc / name).write_text("// " + name)
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    lib = build.build()
    lines = calls.read_text().splitlines()
    assert lib.is_file() and len(lines) == 4
    assert all(" -c " in line for line in lines[:3])
    assert "-fmad=false" in lines[3] and "-shared" in lines[3]
    assert build.build() == lib  # up to date: nothing runs
    assert len(calls.read_text().splitlines()) == 4
    (csrc / "bad.cu").write_text("// bad")
    with pytest.raises(RuntimeError, match="bad.cu: error"):
        build.build()


@pytest.mark.parametrize("mangled, name", [
    # a hash in the anonymous namespace ends in digits ("...630d8b90") that
    # read as a length prefix of "d8b9023occupancy_dilate_kernel"
    ("_ZN50_GLOBAL__N__c3a181b3_17_occupancy_bits_cu_630d8b9023occupancy_"
     "dilate_kernelEPKiPiiiiii", "occupancy_dilate_kernel"),
    ("_ZN50_GLOBAL__N__c3a181b3_17_occupancy_bits_cu_630d8b9022occupancy_"
     "cells_kernelILi32EEEvPKfS2_PiPfiiiiiff", "occupancy_cells_kernel<32>"),
    ("_ZN12_GLOBAL__N_122brick_integrate_kernelILb0ELi4EEEvPKf",
     "brick_integrate_kernel<0,4>"),
    ("_ZN2at6native4rollEv", "_ZN2at6native4rollEv"),
    ("refine_count_kernel", "refine_count_kernel"),
])
def test_kernel_names_are_read_by_their_length_prefixes(mangled, name):
    """ptxas's and cuobjdump's mangled names -> the kernel's name and its
    template arguments, as ``resource_usage`` and ``sass_counts`` key
    them; names that are not kernels come back as they are."""
    assert build._kernel_name(mangled) == name


def test_fuse_frameset_autofits_the_grid(orbit):
    d, c, p, K = orbit
    pipe = tfusion.fuse_frameset(
        FrameSet(depth=d[:2], poses=p[:2], intrinsics=K), dims=(32, 32, 32),
        device="cpu")
    assert pipe.engine == "brick"
    pts = pipe.extract_points()
    assert len(pts) > 50 and torch.isfinite(pts).all()
