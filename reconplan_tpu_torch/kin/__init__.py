"""Kinematics: chain models, FK/Jacobian, batched DLS-IK, collision.

Port of ``reconplan_tpu.kin``, with the servo model (``kin.dynamics``)
and the RelaxedIK solver (``kin.relaxed``). One kinematic core on torch tensors stands in for Klampt and PyBullet:
FK and Jacobians are closed-form over the parsed ``.rob`` chain, IK is
damped least squares in one batched loop, and every function is
batch-first, so thousands of solves run per call on the device.
"""

from reconplan_tpu_torch.kin.rob_parser import RobModel, parse_rob
from reconplan_tpu_torch.kin.chain import (
    KinematicModel,
    fk_all,
    fk_link,
    geometric_jacobian,
    kinematic_model_from_numpy,
    model_from_rob,
)
from reconplan_tpu_torch.kin.ik import IKResult, dls_ik, dls_ik_batch
from reconplan_tpu_torch.kin.collision import (
    Capsule,
    fit_capsule_off,
    capsule_group_collision,
    fit_spheres_off,
    sphere_group_clearance,
    sphere_group_collision,
)
from reconplan_tpu_torch.kin.robot import (
    UR10,
    KinematicChain,
    Kinova,
    Planar,
    Robot,
    make_robot,
)
from reconplan_tpu_torch.kin.dynamics import ServoExecutor
from reconplan_tpu_torch.kin.relaxed import RelaxedIK

__all__ = [
    "ServoExecutor",
    "RelaxedIK",
    "RobModel",
    "parse_rob",
    "KinematicModel",
    "fk_all",
    "fk_link",
    "geometric_jacobian",
    "kinematic_model_from_numpy",
    "model_from_rob",
    "IKResult",
    "dls_ik",
    "dls_ik_batch",
    "Capsule",
    "fit_capsule_off",
    "capsule_group_collision",
    "fit_spheres_off",
    "sphere_group_clearance",
    "sphere_group_collision",
    "Robot",
    "UR10",
    "Kinova",
    "KinematicChain",
    "Planar",
    "make_robot",
]
