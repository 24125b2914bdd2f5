"""Helpers the drivers share: the checkout's root, the card's fence, a
span that does nothing, the UR10 roadmap and its plain kinematics."""

from __future__ import annotations

import contextlib
import os

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def no_span(name):
    return contextlib.nullcontext()


def load_roadmap(config, device):
    """The configuration's robot and its committed roadmap, loaded into the
    program's ``RedundancyResolution``."""
    from reconplan_tpu_torch.grr import RedundancyResolution
    from reconplan_tpu_torch.io.config import load_problem
    from reconplan_tpu_torch.kin.robot import make_robot

    robot = make_robot(load_problem(config["robot"], config["problem"]),
                       device=device)
    res = RedundancyResolution(robot, device)
    folder = os.path.join(ROOT, config["roadmap"])
    res.load_workspace_graph(os.path.join(folder, "workspace.npz"))
    res.load_resolution_graph(os.path.join(folder, "resolution.npz"))
    res.load_solver_graph(os.path.join(folder, "solver.npz"))
    return res


def chain_of(config):
    """The plain forward kinematics of the configuration's robot file."""
    from perfcells.reference.kinematics import Chain

    return Chain(os.path.join(ROOT, config["robot_file"]), config["ee_link"],
                 config["active_joints"])


def bf16(q):
    """Joint answers rounded to bfloat16, the control's precision."""
    return torch.as_tensor(q, dtype=torch.float32).to(
        torch.bfloat16).double().numpy()
