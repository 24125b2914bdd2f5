"""The robot protocol: sampling, metrics, FK/IK, collision.

Port of ``reconplan_tpu.kin.robot``: the duck-typed robot protocol that
all the planning code consumes,

    workspace_sample, workspace_distance, workspace_interpolate,
    sample, distance, interpolate, average,
    solve_fk, solve_ik, check_self_collision

and a batched twin of every kernel (``solve_ik_batch``,
``solve_fk_batch``, ``distance_batch``): roadmap construction and the online
solver run thousands of these per call on the device.

A robot lives on one device: ``Robot(..., device=None)`` means the card
(``"cpu"`` asks for the CPU). Methods that return numpy in the JAX
package (``solve_fk``, ``interpolate``, ``average``, ``workspace_*``,
``solve_ik``) return numpy here; those that return device arrays there
(``solve_fk_batch``, ``fk_point_batch``, ``solve_ik_batch``,
``distance_batch``, ``_validate_batch``) return tensors on the robot's
device. FK, validity and collision are batch-first plain methods (the
JAX package jits them with a static ``self``).

Behavioral notes:
  * ``rotation`` follows the problem: "fixed" / "variable" with a
    ``fixed_rotation``, else "free"; pass ``rotation=`` to override.
  * On IK failure the floor check never reads an unsolved configuration:
    failure is a value, never an exception (``none_on_fail`` threading).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.kin import collision as coll
from reconplan_tpu_torch.kin.chain import _index, fk_all, model_from_rob
from reconplan_tpu_torch.kin.ik import dls_ik_batch
from reconplan_tpu_torch.kin.rob_parser import load_off_vertices, parse_rob
from reconplan_tpu_torch.utils.device import resolve_device
from reconplan_tpu_torch.utils.profiling import to_host

_DEFAULT_DATA_DIRS = (
    os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "data", "robots"),
)


def _find_rob_file(name: str) -> str:
    for d in _DEFAULT_DATA_DIRS:
        p = os.path.join(d, name + ".rob")
        if os.path.exists(p):
            return p
    raise FileNotFoundError(
        f"robot file {name}.rob not found in {_DEFAULT_DATA_DIRS}")


class Robot:
    """A kinematic-chain robot with workspace/config-space operations.

    Args: ``name`` (.rob basename), ``domain`` ([min,max] per position
    axis), ``rot_domain`` ([0/1] per euler axis), ``fixed_rotation`` (euler
    xyz, radians), ``device`` (default: the card).
    """

    # subclasses override
    ACTIVE_JOINTS: list[int] | None = None
    EE_LINK_NAME: str | None = None
    SELF_GEOMETRY_LINKS: list = ()
    EE_GEOMETRY_LINKS: list = ()
    FLOOR_CHECK = False

    def __init__(self, name, domain, rot_domain, fixed_rotation=None,
                 rotation=None, device=None):
        self.name = name
        self.device = resolve_device(device)
        self.rob = parse_rob(_find_rob_file(name), name=name)
        self.model = model_from_rob(self.rob, device=self.device)

        self.domain = [tuple(map(float, d)) for d in domain]
        self.rot_domain = list(rot_domain)
        self.fixed_rotation = (
            self._numpy(maths.euler_to_quat(
                self._tensor(fixed_rotation), seq=maths.PROBLEM_EULER_SEQ))
            if fixed_rotation is not None
            else None
        )
        if rotation is not None:
            self.rotation = rotation
        else:
            # Forcing "variable" unconditionally (as the original GRR
            # code later did for the UR10 scan flow) breaks every
            # fixed-rotation build: uniform workspace sampling then
            # attaches random quaternions that a fixed-orientation
            # problem (kinova rot_fixed, planar_5) can never reach, so no
            # IK converges. The UR10 arc flow is unaffected (its 7D
            # look-at arc points drive IK regardless of mode).
            if self.fixed_rotation is not None:
                self.rotation = (
                    "fixed" if float(np.sum(rot_domain)) == 0 else "variable"
                )
            else:
                self.rotation = "free"

        limits = np.stack([self.rob.qmin, self.rob.qmax], axis=-1)
        if self.ACTIVE_JOINTS is not None:
            self.active_joints = list(self.ACTIVE_JOINTS)
        else:
            self.active_joints = [
                i for i, (lo, hi) in enumerate(limits) if lo != hi
            ]
        self.joint_limits = limits[self.active_joints]
        self.num_joints = len(self.active_joints)
        self.cyclic_joints = np.array(
            [
                i
                for i, (lo, hi) in enumerate(self.joint_limits)
                if np.isinf(lo) or np.isinf(hi)
            ],
            dtype=np.int64,
        )
        cyclic = np.zeros(self.num_joints, dtype=bool)
        cyclic[self.cyclic_joints] = True
        self._cyclic_mask = torch.as_tensor(cyclic, device=self.device)

        ee_name = self.EE_LINK_NAME or self.rob.link_names[-1]
        try:
            self.ee_link = self.rob.link_index(ee_name)
        except ValueError:
            self.ee_link = self.rob.num_links - 1
        # link list exposed by solve_fk: active links + ee
        self.fk_links = list(self.active_joints) + [self.ee_link]

        self._active_tuple = tuple(self.active_joints)
        self._active_idx = _index(self._active_tuple, self.device)
        self._fk_idx = _index(tuple(self.fk_links), self.device)
        self._q_rest = torch.zeros(self.rob.num_links, dtype=torch.float32,
                                   device=self.device)

        self._spheres = self._load_spheres()
        # numpy, so that sample() draws the same seeds as the JAX package
        self._rng = np.random.default_rng(0)

    def _tensor(self, x):
        """``x`` (array-like or tensor) as an f32 tensor on the robot's
        device."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(x, dtype=np.float32),
                               device=self.device)

    @staticmethod
    def _numpy(t):
        return to_host(t.detach()).numpy()

    # ------------------------------------------------------------------
    # geometry setup
    # ------------------------------------------------------------------
    def _load_spheres(self, n_spheres: int = 32):
        """Fit covering sphere clouds for the self / ee geometry groups.
        Returns None when the robot declares no collision groups.

        Single capsules over-approximate long links so coarsely that
        wrist-folded camera poses with ~6 cm of true mesh clearance are
        rejected on the ur10 scan-arc workload. A 32-sphere k-means cloud
        per link covers every mesh vertex (no false negatives) with ~1 cm
        local slack.
        """
        if not self.SELF_GEOMETRY_LINKS or not self.EE_GEOMETRY_LINKS:
            return None

        def group(links):
            idx, cs, rs = [], [], []
            for ln in links:
                li = ln if isinstance(ln, int) else self.rob.link_index(ln)
                geom = self.rob.geometry[li]
                if not geom or not geom.endswith(".off"):
                    continue
                path = os.path.join(self.rob.source_dir, geom)
                if not os.path.exists(path):
                    continue
                c, r = coll.fit_spheres_off(
                    load_off_vertices(path), n_spheres=n_spheres
                )
                # pad to the common S so groups stack into one array
                pad = n_spheres - len(r)
                if pad:
                    c = np.concatenate([c, np.zeros((pad, 3), np.float32)])
                    r = np.concatenate(
                        [r, np.full(pad, coll.PAD_RADIUS, np.float32)]
                    )
                idx.append(li)
                cs.append(c)
                rs.append(r)
            if not idx:
                return None
            return (
                _index(tuple(idx), self.device),
                torch.as_tensor(np.stack(cs), device=self.device),
                torch.as_tensor(np.stack(rs), device=self.device),
            )

        g_self = group(self.SELF_GEOMETRY_LINKS)
        g_ee = group(self.EE_GEOMETRY_LINKS)
        if g_self is None or g_ee is None:
            return None
        sph = {"self": g_self, "ee": g_ee}
        sph["thresholds"] = self._calibrate_collision_thresholds(sph)
        return sph

    def _calibrate_collision_thresholds(self, sph):
        """Per-link-pair clearance thresholds, calibrated at home.

        A pair collides when its sphere-cloud signed clearance drops below
        its threshold. The default is 0 (actual cloud overlap); pairs that
        are already adjacent at the home configuration (wrist <-> gripper
        base, which stay close in every configuration) get a
        slightly-below-home threshold instead — the sphere analogue of
        MoveIt's allowed-collision matrix, computed automatically instead
        of hand-listed like the `noselfcollision` entries of ur10.rob."""
        gs, ge = sph["self"], sph["ee"]
        R, t = fk_all(self.model, self._q_rest)
        clr_home = self._group_clearance(R, t, gs, ge)
        return torch.clamp(clr_home - 0.005, max=0.0)

    @staticmethod
    def _group_clearance(R, t, gs, ge):
        """(..., La, Lb) sphere-cloud clearances of the two geometry
        groups under link transforms ``R`` (..., L, 3, 3), ``t``."""
        ca = coll.transform_spheres(R[..., gs[0], :, :], t[..., gs[0], :],
                                    gs[1])
        cb = coll.transform_spheres(R[..., ge[0], :, :], t[..., ge[0], :],
                                    ge[1])
        return coll.sphere_group_clearance(ca, gs[2], cb, ge[2])

    # ------------------------------------------------------------------
    # workspace ops
    # ------------------------------------------------------------------
    def workspace_sample(self, generator=None, rng=None):
        """Sample a workspace point ([x,y,z] or [x,y,z,qx,qy,qz,qw]).

        ``rng``: optional caller-local numpy Generator (see
        :meth:`sample`). ``generator`` stands where the JAX method has an
        unused ``key``: the draws are numpy's, so that both packages
        sample the same points."""
        gen = self._rng if rng is None else rng
        point = [gen.uniform(a, b) for (a, b) in self.domain]
        if self.rotation == "variable":
            if int(np.sum(self.rot_domain)) == 1:
                angle = gen.uniform(-np.pi, np.pi)
                euler = self._numpy(maths.quat_to_euler(
                    self._tensor(self.fixed_rotation),
                    seq=maths.PROBLEM_EULER_SEQ))
                euler[self.rot_domain.index(1)] = angle
                quat = self._numpy(maths.euler_to_quat(
                    self._tensor(euler), seq=maths.PROBLEM_EULER_SEQ))
            else:
                g = gen.normal(size=4)
                quat = g / np.linalg.norm(g)
            point = np.concatenate([point, quat])
        return np.asarray(point)

    def workspace_distance(self, p1, p2):
        return float(maths.se3_distance(self._tensor(p1), self._tensor(p2)))

    def workspace_interpolate(self, p1, p2, u):
        """Mixed 3D/7D endpoints are allowed (rot_free teleop targets are
        position-only while roadmap nodes carry poses): the single
        available quaternion rides along unchanged."""
        p1 = self._tensor(p1)
        p2 = self._tensor(p2)
        pos = p1[:3] + u * (p2[:3] - p1[:3])
        if p1.shape[0] > 3 and p2.shape[0] > 3:
            quat = maths.slerp(p1[3:7], p2[3:7], u)
            return self._numpy(torch.cat([pos, quat]))
        if p1.shape[0] > 3 or p2.shape[0] > 3:
            quat = p1[3:7] if p1.shape[0] > 3 else p2[3:7]
            return self._numpy(torch.cat([pos, quat]))
        return self._numpy(pos)

    # ------------------------------------------------------------------
    # config-space ops
    # ------------------------------------------------------------------
    def sample(self, n=None, rng=None):
        """Random configuration(s); cyclic joints sample [-pi, pi).

        ``rng`` (optional numpy Generator) draws from a caller-local
        stream instead of the robot's shared ``_rng`` — use it when a
        deterministic draw must not perturb other users of the robot."""
        shape = (self.num_joints,) if n is None else (n, self.num_joints)
        lo = np.where(np.isinf(self.joint_limits[:, 0]), -np.pi,
                      self.joint_limits[:, 0])
        hi = np.where(np.isinf(self.joint_limits[:, 1]), np.pi,
                      self.joint_limits[:, 1])
        gen = self._rng if rng is None else rng
        return gen.uniform(lo, hi, size=shape).astype(np.float32)

    def _config_diff(self, q1, q2):
        diff = self._tensor(q1) - self._tensor(q2)
        return torch.where(self._cyclic_mask, maths.wrap_to_pi(diff), diff)

    def distance(self, q1, q2):
        """Config distance with cyclic wrap."""
        return float(to_host(torch.linalg.norm(self._config_diff(q1, q2))))

    def distance_batch(self, q1, q2):
        """(..., A) vs (..., A) -> (...,) distances on device."""
        return torch.linalg.norm(self._config_diff(q1, q2), dim=-1)

    def interpolate(self, q1, q2, u):
        """Shortest-path config interpolation."""
        q1 = self._tensor(q1)
        q2 = self._tensor(q2)
        lin = q1 + u * (q2 - q1)
        cyc = maths.wrap_to_pi(q1 + u * maths.wrap_to_pi(q2 - q1))
        return self._numpy(torch.where(self._cyclic_mask, cyc, lin))

    def average(self, configs, weights=None):
        """Weighted average; circular mean on cyclic joints."""
        configs = self._tensor(configs)
        if weights is None or float(np.sum(weights)) == 0.0:
            weights = torch.ones(
                configs.shape[0], device=self.device) / configs.shape[0]
        else:
            weights = self._tensor(weights)
            weights = weights / torch.sum(weights)
        lin = torch.sum(configs * weights[:, None], dim=0)
        circ = maths.circular_mean(configs, weights[:, None], axis=0)
        return self._numpy(torch.where(self._cyclic_mask, circ, lin))

    # ------------------------------------------------------------------
    # FK
    # ------------------------------------------------------------------
    def _full_config(self, config):
        """(..., A) active-joint configs -> (..., L) full joint vectors
        (a fresh tensor a call)."""
        q = self._q_rest.expand(config.shape[:-1] + (-1,))
        return q.index_copy(-1, self._active_idx, config)

    def _fk_device(self, config):
        """(..., A) -> positions (..., len(fk_links), 3) and quaternions
        (..., len(fk_links), 4) of the active links + ee."""
        R, t = fk_all(self.model, self._full_config(config))
        return (t[..., self._fk_idx, :],
                maths.matrix_to_quat(R[..., self._fk_idx, :, :]))

    def solve_fk(self, config, index=None):
        """Positions and rotations (quats) of active links + ee.

        ``index`` selects into that list, -1 being the end effector."""
        pos, rot = self._fk_device(self._tensor(config))
        pos, rot = self._numpy(pos), self._numpy(rot)
        if index is not None:
            pos, rot = pos[index], rot[index]
        return pos, rot

    def solve_fk_batch(self, configs):
        """(B, A) -> (B, len(fk_links), 3), (B, len(fk_links), 4) on device."""
        return self._fk_device(self._tensor(configs))

    def fk_point_batch(self, configs):
        """(B, A) -> (B, 7) end-effector workspace points [pos, quat]."""
        pos, rot = self.solve_fk_batch(configs)
        return torch.cat([pos[:, -1], rot[:, -1]], dim=-1)

    # ------------------------------------------------------------------
    # IK
    # ------------------------------------------------------------------
    def _ik_targets(self, points):
        """points (B, 3|7) -> (pos (B,3), rotm (B,3,3), use_rotation)."""
        points = self._tensor(points)
        if points.ndim == 1:
            points = points[None]
        pos = points[:, :3]
        if self.rotation in ("variable", "free") and points.shape[1] >= 7:
            quat = maths.quat_normalize(points[:, 3:7])
            return pos, maths.quat_to_matrix(quat), True
        if self.rotation == "fixed" and self.fixed_rotation is not None:
            quat = self._tensor(self.fixed_rotation).expand(pos.shape[0], 4)
            return pos, maths.quat_to_matrix(quat), True
        eye = torch.eye(3, dtype=torch.float32, device=self.device).expand(
            pos.shape[0], 3, 3)
        return pos, eye, False

    def solve_ik_batch(
        self, points, init_configs=None, max_iters=100, tolerance=1e-3
    ):
        """Batched IK: (B, 3|7) points -> (configs (B, A), success (B,)).

        success folds in Klampt-style convergence AND the robot's validity
        checks (floor, self-collision)."""
        pos, rotm, use_rot = self._ik_targets(points)
        B = pos.shape[0]
        if init_configs is None:
            init_configs = self.sample(B)
        init = self._tensor(init_configs)
        if init.ndim == 1:
            init = init.expand(B, self.num_joints)
        res = dls_ik_batch(
            self.model,
            self._active_tuple,
            self.ee_link,
            pos,
            rotm,
            init,
            self._q_rest,
            max_iters=max_iters,
            tolerance=tolerance,
            use_rotation=use_rot,
        )
        q = torch.where(self._cyclic_mask, maths.wrap_to_pi(res.config),
                        res.config)
        valid = self._validate_batch(q)
        return q, res.success & valid

    def solve_ik(
        self, point, init_config=None, max_iters=100, tolerance=1e-3,
        none_on_fail=True
    ):
        """Single-solve API.

        Returns the config ndarray, or None on failure when
        ``none_on_fail`` (failure = no convergence OR floor/self-collision,
        as Klampt's UR10 / Kinova overrides report it)."""
        if init_config is None:
            init_config = self.sample()
        q, ok = self.solve_ik_batch(
            self._tensor(point)[None],
            self._tensor(init_config)[None],
            max_iters=max_iters,
            tolerance=tolerance,
        )
        if none_on_fail and not bool(to_host(ok[0])):
            return None
        return self._numpy(q[0])

    # ------------------------------------------------------------------
    # validity (floor + self collision)
    # ------------------------------------------------------------------
    def _collides(self, R, t):
        """(...,) bool: the arm's sphere clouds against the end
        effector's, under link transforms ``R`` / ``t``."""
        clr = self._group_clearance(R, t, self._spheres["self"],
                                    self._spheres["ee"])
        return (clr < self._spheres["thresholds"]).any(dim=-1).any(dim=-1)

    def _validate_device(self, config):
        """(..., A) configs -> (...,) bool: above the floor (when
        ``FLOOR_CHECK``) and free of self collision."""
        R, t = fk_all(self.model, self._full_config(config))
        ok = torch.ones(config.shape[:-1], dtype=torch.bool,
                        device=self.device)
        if self.FLOOR_CHECK:
            # reject when any active link origin z <= 0
            zs = t[..., self._active_idx, 2]
            ok = ok & (zs > 0.0).all(dim=-1)
        if self._spheres is not None:
            ok = ok & ~self._collides(R, t)
        return ok

    def _validate_batch(self, configs):
        return self._validate_device(self._tensor(configs))

    def _self_collision_device(self, config):
        R, t = fk_all(self.model, self._full_config(config))
        return self._collides(R, t)

    def check_self_collision_batch(self, qs):
        """(B, A) -> (B,) bool numpy; the batched validity-scan primitive
        of the teleop benchmark."""
        if self._spheres is None:
            return np.zeros(len(qs), dtype=bool)
        return self._numpy(self._self_collision_device(self._tensor(qs)))

    def check_self_collision(self, q):
        """True when the arm links collide with the end-effector group."""
        if self._spheres is None:
            return False
        return bool(to_host(self._self_collision_device(self._tensor(q))))


class KinematicChain(Robot):
    """Plain serial chain."""


class Planar(Robot):
    """Planar N-R chains (planar_3.rob / planar_5.rob)."""

    EE_LINK_NAME = None  # last link


class Kinova(Robot):
    """Kinova Gen3 7-DoF."""

    ACTIVE_JOINTS = [1, 2, 3, 4, 5, 6, 7]
    EE_LINK_NAME = "Tool_Frame"
    SELF_GEOMETRY_LINKS = [0, 1, 2]
    EE_GEOMETRY_LINKS = [
        "gripper:Link_0",
        "gripper:Link_1",
        "gripper:Link_2",
        "gripper:Link_3",
        "gripper:Link_4",
        "gripper:Link_5",
        "gripper:Link_6",
        "gripper:Link_7",
        "gripper:Link_8",
    ]


class UR10(Robot):
    """UR10 + Robotis RH-P12-RN gripper + D435."""

    ACTIVE_JOINTS = [1, 2, 3, 4, 5, 6]
    EE_LINK_NAME = "ee_link"
    SELF_GEOMETRY_LINKS = [0, 1, 2, 3, 4, 5]
    EE_GEOMETRY_LINKS = [
        "rh_p12_rn_base",
        "rh_p12_rn_l1",
        "rh_p12_rn_l2",
        "rh_p12_rn_r1",
        "rh_p12_rn_r2",
        "d435_link",
    ]
    FLOOR_CHECK = True

    @property
    def camera_link(self):
        """The d435_color_frame link index (URDF link 15 == .rob link
        12)."""
        return self.rob.link_index("d435_color_frame")


_ROBOT_CLASSES = {
    "UR10": UR10,
    "Kinova": Kinova,
    "KinematicChain": KinematicChain,
    "Planar": Planar,
}


def make_robot(opts: dict, floor_check: bool | None = None,
               device=None) -> Robot:
    """Instantiate from a problem dict (see io.config.load_problem) on
    ``device`` (default: the card).

    ``floor_check`` (or an opts key of the same name) overrides the
    class default. The UR10's floor check is younger than the shipped
    ``graph/ur10/rot_fixed`` roadmap (whose own configs put wrist links
    below z=0), so artifact-parity builds pass ``floor_check=False``."""
    cls = _ROBOT_CLASSES[opts["robot_class"]]
    robot = cls(
        opts["robot_name"],
        opts["domain"],
        opts["rotation_domain"],
        opts.get("fixed_rotation"),
        device=device,
    )
    if floor_check is None:
        floor_check = opts.get("floor_check")
    if floor_check is not None:
        # instance attr shadows the class default
        robot.FLOOR_CHECK = bool(floor_check)
    return robot
