"""Data-parallel IK over a device mesh.

Port of ``reconplan_tpu.parallel.ik``. A batch of independent DLS-IK
problems splits along the batch axis over the mesh; the kinematic model
is small and goes to every shard's device. The shards run
``kin.ik.dls_ik_batch`` in turn (never on concurrent streams: on a card
the solver replays CUDA graphs on static buffers), and each lane's
answer is its own, so the result does not depend on the split.
"""

from __future__ import annotations

import torch

from reconplan_tpu_torch.kin.chain import KinematicModel
from reconplan_tpu_torch.kin.ik import dls_ik_batch
from reconplan_tpu_torch.parallel.mesh import (
    all_gather,
    make_mesh,
    shard_batch,
)


def _model_on(robot, device):
    """The robot's kinematic model and rest vector on ``device``: the
    robot's own where it lives there, else a copy."""
    if robot._q_rest.device == device:
        return robot.model, robot._q_rest
    model = KinematicModel(*(x.to(device) if isinstance(x, torch.Tensor)
                             else x for x in robot.model))
    return model, robot._q_rest.to(device)


def sharded_ik_solve(robot, points, seeds, mesh=None, max_iters=100,
                     tolerance=1e-3):
    """Solve a batch of IK problems sharded over the mesh (default:
    ``make_mesh()``).

    ``points`` (B, 3|7) and ``seeds`` (B, A) shard along B (B must divide
    by the mesh size). Returns (configs (B, A), converged (B,)) on the
    first shard's device, the whole batch on every rank under a process
    group.
    """
    mesh = mesh or make_mesh()
    B = len(points)
    if B % mesh.size:
        raise ValueError(f"batch {B} not divisible by mesh size {mesh.size}")
    sb = shard_batch(mesh, mesh.axis_name)
    pos, rotm, use_rot = robot._ik_targets(points)
    pos, rotm, seeds = (sb.put(x) for x in (pos, rotm, robot._tensor(seeds)))
    models = {}
    configs, success = [], []
    for i, dev in enumerate(mesh.devices):
        if dev not in models:
            models[dev] = _model_on(robot, dev)
        model, q_rest = models[dev]
        res = dls_ik_batch(model, robot._active_tuple, robot.ee_link, pos[i],
                           rotm[i], seeds[i], q_rest, max_iters=max_iters,
                           tolerance=tolerance, use_rotation=use_rot)
        configs.append(res.config)
        success.append(res.success)
    first = mesh.devices[0]
    return tuple(all_gather(mesh, torch.cat([x.to(first) for x in xs]))
                 for xs in (configs, success))
