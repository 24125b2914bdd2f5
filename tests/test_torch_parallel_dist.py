"""The port's mesh across processes: the twin of ``tests/test_dcn.py``.

Two processes of 4 CPU shards each join one ``torch.distributed`` group
under gloo (``init_method="file://"`` in the test's own directory, so no
port is fixed and parallel test workers do not meet), and each builds
``make_mesh(devices=["cpu"] * 4)``: an 8-shard mesh over two ranks. The
workers import torch and the port only. They run

  1. a cross-process gather and reduce over the 8 shards: rank ``pid``
     holds rows ``[0, 1, 2, 3] + 10 * pid``; the gather gives all eight
     in mesh order and the sum is 52 per row, as the JAX test's psum;
  2. the z-sharded dense grid at 32^3, gathered on both ranks;
  3. sharded IK of 16 rows (two a shard) on the UR10;
  4. the brick-sharded path at 32^3 (4 bricks a shard), its active count
     all-reduced and its planes gathered;

and write what they got. The parent holds each result bit for bit
against the same call in one process over ``["cpu"] * 8`` (measured: 0
apart), and the dense grid against the JAX package's dense result op by
op (weights equal, sdf within 1e-6; measured: 0). Each worker runs under
a 120 s timeout and is killed on expiry, which fails the test.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np

from reconplan_tpu.ops import tsdf as jtsdf
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin.robot import make_robot
from reconplan_tpu_torch.parallel import (
    gather_brick_grid,
    gather_grid,
    make_mesh,
    make_sharded_brick_grid,
    make_sharded_grid,
    sharded_brick_grid_to_numpy,
    sharded_ik_solve,
    sharded_integrate_frames,
    sharded_integrate_frames_bricked,
)
from test_parallel import _sphere_frames
from torch_parity import jax_eager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIMS, VOX, ORIGIN = (32, 32, 32), 0.3 / 31, (-0.15, -0.15, -0.15)

_WORKER = r"""
import sys

import numpy as np
import torch
import torch.distributed as dist

from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin.robot import make_robot
from reconplan_tpu_torch.parallel import (
    gather_brick_grid, gather_grid, make_mesh, make_sharded_brick_grid,
    make_sharded_grid, sharded_brick_grid_to_numpy, sharded_ik_solve,
    sharded_integrate_frames, sharded_integrate_frames_bricked)
from reconplan_tpu_torch.parallel.mesh import all_gather, all_sum

torch.set_num_threads(1)
pid, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store",
                        rank=pid, world_size=2)
mesh = make_mesh(devices=["cpu"] * 4)
assert (mesh.size, mesh.first_shard, mesh.world_size) == (8, 4 * pid, 2)
inp = np.load(f"{tmp}/inputs.npz")
dims, vox, origin = tuple(inp["dims"]), float(inp["vox"]), inp["origin"]
K = tuple(float(v) for v in inp["K"])
out = {}

# 1. cross-process gather and reduce over the 8 shards
rows = torch.arange(4, dtype=torch.float32)[:, None] + 10 * pid
out["gathered"] = all_gather(mesh, rows).numpy()
out["reduced"] = all_sum(mesh, rows.sum(0, keepdim=True)).expand(4, 1).numpy()

# 2. the z-sharded dense grid
g = make_sharded_grid(dims, origin, vox, mesh=mesh)
g = sharded_integrate_frames(g, inp["depths"], inp["poses"], *K, mesh=mesh)
assert g.slabs[0].shape[0] == dims[0] // 8
full = gather_grid(g)
out["sdf"], out["weight"] = full.sdf.numpy(), full.weight.numpy()

# 3. sharded IK of 16 rows
robot = make_robot(load_problem("ur10", "rot_free"), device="cpu")
q, ok = sharded_ik_solve(robot, inp["targets"], inp["seeds"], mesh=mesh)
out["q"], out["ok"] = q.numpy(), ok.numpy()

# 4. the brick-sharded path
gb = make_sharded_brick_grid(dims, origin, vox, mesh=mesh)
gb, n_active = sharded_integrate_frames_bricked(
    gb, inp["depths"], inp["poses"], *K, mesh=mesh, max_active_per_device=64)
bg = gather_brick_grid(gb)
out["n_active"] = int(n_active)
out["brick_sdf"], out["brick_weight"] = bg.sdf.numpy(), bg.weight.numpy()
out["brick_planes"] = sharded_brick_grid_to_numpy(gb)["weight"]

# the mesh and the grids hold the process group: dropped first, it is
# torn down here and not at interpreter exit, where gloo's teardown
# aborted about one worker in 70
del mesh, g, gb
dist.destroy_process_group()
assert "jax" not in sys.modules and "reconplan_tpu" not in sys.modules
np.savez(f"{tmp}/out{pid}.npz", **out)
print(f"proc {pid}: done")
"""


def _one_process(inp, robot):
    """The same four calls in this process over ``["cpu"] * 8``."""
    mesh = make_mesh(devices=["cpu"] * 8)
    K = tuple(float(v) for v in inp["K"])
    g = sharded_integrate_frames(make_sharded_grid(DIMS, ORIGIN, VOX,
                                                   mesh=mesh),
                                 inp["depths"], inp["poses"], *K)
    full = gather_grid(g)
    q, ok = sharded_ik_solve(robot, inp["targets"], inp["seeds"], mesh=mesh)
    gb, n_active = sharded_integrate_frames_bricked(
        make_sharded_brick_grid(DIMS, ORIGIN, VOX, mesh=mesh), inp["depths"],
        inp["poses"], *K, max_active_per_device=64)
    bg = gather_brick_grid(gb)
    return {"sdf": full.sdf.numpy(), "weight": full.weight.numpy(),
            "q": q.numpy(), "ok": ok.numpy(), "n_active": int(n_active),
            "brick_sdf": bg.sdf.numpy(), "brick_weight": bg.weight.numpy(),
            "brick_planes": sharded_brick_grid_to_numpy(gb)["weight"]}


def test_two_process_mesh(tmp_path):
    depths, poses, K = _sphere_frames()
    robot = make_robot(load_problem("ur10", "rot_free"), device="cpu")
    seeds = robot.sample(16, rng=np.random.default_rng(3))
    targets = robot.fk_point_batch(seeds)[:, :3].numpy()
    inp = dict(depths=depths, poses=poses, K=np.array(K), seeds=seeds,
               targets=targets, dims=np.array(DIMS), vox=VOX,
               origin=np.array(ORIGIN))
    np.savez(tmp_path / "inputs.npz", **inp)
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(pid),
         str(tmp_path)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=str(tmp_path), text=True) for pid in range(2)]
    try:
        ref = _one_process(inp, robot)
        with jax_eager():
            dense = jtsdf.integrate_frames(
                jtsdf.make_grid(DIMS, ORIGIN, VOX), jnp.asarray(depths),
                jnp.asarray(poses), *K)
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=120)[0])
            except subprocess.TimeoutExpired:
                p.kill()
                outs.append(p.communicate()[0])
                raise AssertionError("a worker timed out:\n" + outs[-1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), "\n".join(outs)[-3000:]

    np.testing.assert_array_equal(ref["weight"], np.asarray(dense.weight))
    assert np.abs(ref["sdf"] - np.asarray(dense.sdf)).max() <= 1e-6
    assert (ref["weight"] > 0).sum() > 100 and ref["ok"].mean() > 0.8
    assert ref["n_active"] > 0 and (ref["brick_weight"] > 0).any()
    for pid in range(2):
        got = np.load(tmp_path / f"out{pid}.npz")
        np.testing.assert_array_equal(
            got["gathered"][:, 0], [0, 1, 2, 3, 10, 11, 12, 13])
        np.testing.assert_array_equal(got["reduced"], np.full((4, 1), 52.0))
        for k, v in ref.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
