"""``reconplan_tpu_torch.kin`` and ``grr.paths`` against the JAX package on
the CPU.

Inputs are made from a seed with numpy and go through the JAX function
(jitted as the package jits it, on the CPU) and its port with
``device="cpu"``. The robots are built once a module: the JAX package
compiles its IK loop once a static signature.

Tolerances and why:
* FK, Jacobians and camera positions: 2e-6 (metres, unit-scale entries).
  A chain of up to 14 f32 3x3 products; the two packages order the three
  terms of a product differently.
* distances and clearances: 1e-6.
* ``dls_ik_batch`` in lock step (``max_iters`` 1, 2, 3): configurations to
  1e-5 rad, ``iters`` and ``success`` equal. An iterative solver in f32
  does not stay bit-equal across packages: each step solves 6x6 normal
  equations whose rounding differs. The seeds lie 0.1 rad from a solution;
  from 0.3 rad one lane of 32 passes an ill-conditioned step and the
  packages part by 2.8e-5 in three iterations (either one is as far from
  an f64 run of the same loop).
* at ``max_iters=100`` the outcome is compared, not the path: success
  flags equal on at least 90% of the lanes, and every configuration the
  port calls solved reaches its target by the port's own FK within the
  solver's tolerance.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.grr import paths as jpaths
from reconplan_tpu.io.config import load_problem as jax_load_problem
from reconplan_tpu.kin import chain as jchain
from reconplan_tpu.kin import collision as jcoll
from reconplan_tpu.kin import ik as jik
from reconplan_tpu.kin import rob_parser as jrob
from reconplan_tpu.kin import robot as jrobot
from reconplan_tpu_torch.core import maths
from reconplan_tpu_torch.grr import paths
from reconplan_tpu_torch.io.config import load_problem
from reconplan_tpu_torch.kin import chain, collision, ik, rob_parser, robot

torch.set_num_threads(2)

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "data")
FK_TOL = 2e-6
DIST_TOL = 1e-6
IK_LOCKSTEP_TOL = 1e-5
IK_TOLERANCE = 1e-3  # the solver's own default


def _parse_nums(s):
    return [float(x) for x in re.findall(r"-?\d+\.?\d*(?:[eE][+-]?\d+)?", s)]


def load_golden():
    def rows(name):
        with open(os.path.join(DATA, "golden", name)) as f:
            return np.array([_parse_nums(line.split(",", 1)[1]) for line in f])

    return rows("ctraj.txt").astype(np.float32), rows("wtraj.txt")


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


@pytest.fixture(scope="module")
def ur10s():
    """(JAX UR10, port UR10 on the CPU) of the scan problem."""
    opts = load_problem("ur10", "rot_free")
    assert opts == jax_load_problem("ur10", "rot_free")
    return jrobot.make_robot(opts), robot.make_robot(opts, device="cpu")


PLANAR_ARGS = ("planar_5", [[-0.5, 0.5], [-0.5, 0.5], [0, 0]], [0, 0, 1])


@pytest.fixture(scope="module")
def planars():
    return jrobot.Planar(*PLANAR_ARGS), robot.Planar(*PLANAR_ARGS,
                                                     device="cpu")


def _full(rob, configs):
    q = np.zeros((len(configs), rob.rob.num_links), np.float32)
    q[:, rob.active_joints] = configs
    return q


# ---------------------------------------------------------------------------
# parser, model, FK, Jacobian
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ur10", "planar_5", "planar_3", "kinova"])
def test_rob_parser_equals_jax_package(name):
    path = os.path.join(DATA, "robots", name + ".rob")
    a, b = rob_parser.parse_rob(path), jrob.parse_rob(path)
    assert a.link_names == b.link_names and a.joint_types == b.joint_types
    assert a.geometry == b.geometry
    for f in ("parents", "axes", "R_parent", "t_parent", "qmin", "qmax"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_model_carries_over_from_jax_arrays(ur10s):
    jr, tr = ur10s
    m = jr.model
    carried = chain.kinematic_model_from_numpy(
        m.parents, m.prismatic, *(np.asarray(a) for a in m[2:]),
        device="cpu")
    assert carried.parents == tr.model.parents
    assert carried.prismatic == tr.model.prismatic
    for a, b in zip(carried[2:], tr.model[2:]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    assert float(tr.model.qmin[1]) == -1e9 and float(tr.model.qmax[1]) == 1e9


def test_golden_fk_gate(ur10s):
    """The port's FK of the 500 golden configurations against Klampt's
    poses (wtraj.txt), at the limits ``tests/test_kin.py`` holds the JAX
    package to."""
    _, tr = ur10s
    ctraj, wtraj = load_golden()
    pos, rot = tr.solve_fk_batch(ctraj)
    assert isinstance(pos, torch.Tensor) and pos.shape == (500, 7, 3)
    pos, quat = pos[:, -1].numpy(), rot[:, -1].numpy()
    assert np.linalg.norm(pos - wtraj[:, :3], axis=-1).max() < 5e-5
    # wtraj.txt stores the quaternion of R^T (the conjugate)
    conj = quat * np.array([-1.0, -1.0, -1.0, 1.0])
    assert np.abs(np.sum(conj * wtraj[:, 3:7], axis=-1)).min() > 1 - 1e-5


def _fk_and_jacobian_both(jr, tr, configs):
    q = _full(tr, configs)
    R, p = chain.fk_all(tr.model, t(q))
    J = chain.geometric_jacobian(tr.model, t(q), tr.ee_link, tr._active_tuple)
    Rj, pj = jax.vmap(lambda x: jchain.fk_all(jr.model, x))(jnp.asarray(q))
    Jj = jax.vmap(lambda x: jchain.geometric_jacobian(
        jr.model, x, jr.ee_link, jr._active_tuple))(jnp.asarray(q))
    return (R, p, J), (Rj, pj, Jj)


def test_fk_and_jacobian_on_the_golden_configs(ur10s):
    got, ref = _fk_and_jacobian_both(*ur10s, load_golden()[0])
    assert got[0].shape == (500, 18, 3, 3) and got[2].shape == (500, 6, 6)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=FK_TOL)


def test_fk_and_jacobian_on_planar_5(planars):
    jr, tr = planars
    configs = tr.sample(64, rng=np.random.default_rng(0))
    got, ref = _fk_and_jacobian_both(jr, tr, configs)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=FK_TOL)
    # a planar chain: the angular rows are the z axis for every joint
    assert torch.allclose(got[2][:, 5], torch.ones(64, 5))


def test_fk_serves_one_config_and_any_batch_shape(ur10s):
    _, tr = ur10s
    q = t(_full(tr, load_golden()[0][:6]))
    R, p = chain.fk_all(tr.model, q)
    R1, p1 = chain.fk_all(tr.model, q[2])
    R23, p23 = chain.fk_all(tr.model, q.reshape(2, 3, -1))
    assert R1.shape == (18, 3, 3) and p23.shape == (2, 3, 18, 3)
    assert torch.equal(R1, R[2]) and torch.equal(p1, p[2])
    assert torch.equal(R23.reshape(6, 18, 3, 3), R)
    Rl, pl = chain.fk_link(tr.model, q, tr.ee_link)
    assert torch.equal(Rl, R[:, tr.ee_link]) and torch.equal(
        pl, p[:, tr.ee_link])


def test_jacobian_matches_finite_differences(ur10s):
    """The geometric Jacobian's linear rows are d(position)/dq (f64)."""
    _, tr = ur10s
    m = tr.model
    m64 = type(m)(m.parents, m.prismatic, *(a.double() for a in m[2:]))
    q = t(_full(tr, load_golden()[0][:4])).double()
    J = chain.geometric_jacobian(m64, q, tr.ee_link, tr._active_tuple)
    h = 1e-6
    for col, j in enumerate(tr.active_joints):
        dq = torch.zeros_like(q)
        dq[:, j] = h
        hi = chain.fk_all(m64, q + dq)[1][:, tr.ee_link]
        lo = chain.fk_all(m64, q - dq)[1][:, tr.ee_link]
        np.testing.assert_allclose(J[:, :3, col].numpy(),
                                   ((hi - lo) / (2 * h)).numpy(), atol=1e-8)


# ---------------------------------------------------------------------------
# collision
# ---------------------------------------------------------------------------


def test_fits_equal_jax_package():
    rng = np.random.default_rng(2)
    verts = rng.normal(size=(400, 3)) * [0.3, 0.05, 0.05] + [0.1, 0.2, 0.3]
    c, r = collision.fit_spheres_off(verts, n_spheres=16)
    cj, rj = jcoll.fit_spheres_off(verts, n_spheres=16)
    np.testing.assert_array_equal(c, cj)
    np.testing.assert_array_equal(r, rj)
    cap = collision.fit_capsule_off(verts, device="cpu")
    capj = jcoll.fit_capsule_off(verts)
    for a, b in zip(cap, capj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert collision.PAD_RADIUS == jcoll.PAD_RADIUS


def test_segment_segment_distance():
    rng = np.random.default_rng(3)
    seg = rng.normal(size=(4, 200, 3)).astype(np.float32)
    seg[1, :20] = seg[0, :20]  # degenerate first segments
    seg[3, 20:40] = seg[2, 20:40]  # degenerate second segments
    seg[3, 40:60] = seg[2, 40:60] + (seg[1, 40:60] - seg[0, 40:60])  # parallel
    got = collision.segment_segment_distance(*t(seg))
    ref = jax.vmap(jcoll.segment_segment_distance)(*jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=DIST_TOL)


def test_capsule_groups():
    rng = np.random.default_rng(4)
    R = np.array(jax.vmap(lambda q: jnp.eye(3))(jnp.zeros(5)))
    R = R + 0.0  # identity rotations, moved by t
    tr_ = rng.normal(size=(5, 3)).astype(np.float32) * 0.3
    a, b = (rng.normal(size=(5, 3)).astype(np.float32) * 0.2 for _ in "ab")
    caps = collision.transform_capsules(t(R), t(tr_), t(a), t(b))
    capsj = jcoll.transform_capsules(jnp.asarray(R), jnp.asarray(tr_),
                                     jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(caps.numpy(), np.asarray(capsj), rtol=0,
                               atol=DIST_TOL)
    d = collision.pairwise_segment_distances(caps[:3], caps[3:])
    dj = jcoll.pairwise_segment_distances(capsj[:3], capsj[3:])
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=0,
                               atol=DIST_TOL)
    for radius in (0.01, 0.2, 1.0):
        ra, rb = np.full(3, radius, np.float32), np.full(2, radius, np.float32)
        hit = collision.capsule_group_collision(caps[:3], t(ra), caps[3:],
                                                t(rb))
        hitj = jcoll.capsule_group_collision(capsj[:3], jnp.asarray(ra),
                                             capsj[3:], jnp.asarray(rb))
        assert bool(hit) == bool(hitj)


def test_sphere_group_clearance_on_the_robot(ur10s):
    jr, tr = ur10s
    configs = tr.sample(64, rng=np.random.default_rng(5))
    R, p = chain.fk_all(tr.model, t(_full(tr, configs)))
    gs, ge = tr._spheres["self"], tr._spheres["ee"]
    clr = tr._group_clearance(R, p, gs, ge)
    assert clr.shape == (64, 6, 6)

    def one(q):
        Rj, pj = jchain.fk_all(jr.model, q)
        js, je = jr._spheres["self"], jr._spheres["ee"]
        return jcoll.sphere_group_clearance(
            jcoll.transform_spheres(Rj[js[0]], pj[js[0]], js[1]), js[2],
            jcoll.transform_spheres(Rj[je[0]], pj[je[0]], je[1]), je[2])

    ref = jax.vmap(one)(jnp.asarray(_full(tr, configs)))
    np.testing.assert_allclose(clr.numpy(), np.asarray(ref), rtol=0,
                               atol=DIST_TOL)
    np.testing.assert_allclose(tr._spheres["thresholds"].numpy(),
                               np.asarray(jr._spheres["thresholds"]),
                               rtol=0, atol=DIST_TOL)
    hit = collision.sphere_group_collision(
        collision.transform_spheres(R[:, gs[0]], p[:, gs[0]], gs[1]), gs[2],
        collision.transform_spheres(R[:, ge[0]], p[:, ge[0]], ge[1]), ge[2])
    assert hit.shape == (64,) and torch.equal(
        hit, (clr < 0).any(-1).any(-1))


def test_validate_batch_flags_equal(ur10s):
    jr, tr = ur10s
    configs = tr.sample(256, rng=np.random.default_rng(1))
    got = tr._validate_batch(configs)
    ref = jr._validate_batch(jnp.asarray(configs))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0.05 < got.float().mean() < 0.95  # both outcomes occur
    np.testing.assert_array_equal(
        tr.check_self_collision_batch(configs[:32]),
        jr.check_self_collision_batch(configs[:32]))
    assert tr.check_self_collision(configs[0]) == \
        jr.check_self_collision(configs[0])


def test_floor_check_is_set_on_the_instance(ur10s):
    _, tr = ur10s
    opts = load_problem("ur10", "rot_free")
    free = robot.make_robot(opts, floor_check=False, device="cpu")
    assert tr.FLOOR_CHECK and not free.FLOOR_CHECK and robot.UR10.FLOOR_CHECK
    configs = tr.sample(128, rng=np.random.default_rng(6))
    strict, loose = tr._validate_batch(configs), free._validate_batch(configs)
    assert (loose | ~strict).all() and (loose & ~strict).any()


# ---------------------------------------------------------------------------
# IK
# ---------------------------------------------------------------------------


def _reachable_problems(tr, n, noise, seed=0):
    """FK-made reachable poses and seeds ``noise`` rad (std) from their
    solutions."""
    rng = np.random.default_rng(seed)
    qs = tr.sample(n, rng=rng)
    pts = tr.fk_point_batch(qs).numpy()
    seeds = (qs + rng.normal(0, noise, qs.shape)).astype(np.float32)
    rot = maths.quat_to_matrix(t(pts[:, 3:7])).numpy()
    return pts[:, :3], rot, seeds


def _ik_both(jr, tr, pos, rot, seeds, **kw):
    got = ik.dls_ik_batch(tr.model, tr._active_tuple, tr.ee_link, t(pos),
                          t(rot), t(seeds), tr._q_rest, **kw)
    ref = jik.dls_ik_batch(jr.model, jr._active_tuple, jr.ee_link,
                           jnp.asarray(pos), jnp.asarray(rot),
                           jnp.asarray(seeds), jr._q_rest, **kw)
    return got, ref


@pytest.mark.parametrize("use_rotation", [True, False],
                         ids=["rotation", "position_only"])
@pytest.mark.parametrize("max_iters", [1, 2, 3])
def test_ik_lock_step(ur10s, max_iters, use_rotation):
    jr, tr = ur10s
    got, ref = _ik_both(jr, tr, *_reachable_problems(tr, 32, 0.1),
                        max_iters=max_iters, use_rotation=use_rotation)
    np.testing.assert_allclose(got.config.numpy(), np.asarray(ref.config),
                               rtol=0, atol=IK_LOCKSTEP_TOL)
    np.testing.assert_array_equal(got.iters.numpy(), np.asarray(ref.iters))
    np.testing.assert_array_equal(got.success.numpy(),
                                  np.asarray(ref.success))
    assert got.iters.dtype == torch.int32 and got.success.dtype == torch.bool
    np.testing.assert_allclose(got.pos_err.numpy(), np.asarray(ref.pos_err),
                               rtol=0, atol=IK_LOCKSTEP_TOL)
    np.testing.assert_allclose(got.rot_err.numpy(), np.asarray(ref.rot_err),
                               rtol=0, atol=4 * IK_LOCKSTEP_TOL)


@pytest.mark.parametrize("use_rotation", [True, False],
                         ids=["rotation", "position_only"])
def test_ik_outcome_at_100_iterations(ur10s, use_rotation):
    jr, tr = ur10s
    pos, rot, seeds = _reachable_problems(tr, 32, 0.5, seed=1)
    got, ref = _ik_both(jr, tr, pos, rot, seeds, max_iters=100,
                        use_rotation=use_rotation)
    ok = got.success.numpy()
    assert (ok == np.asarray(ref.success)).mean() >= 0.9
    assert ok.mean() > 0.5
    # a lane stops when it converges: solved lanes used fewer iterations
    assert (got.iters.numpy()[ok] < 100).all()
    assert (got.iters.numpy()[~ok] == 100).all()
    # what the port calls solved reaches its target by the port's own FK
    R, p = chain.fk_link(tr.model, t(_full(tr, got.config.numpy())),
                         tr.ee_link)
    err = (p - t(pos)).norm(dim=-1).numpy()
    assert err[ok].max() < IK_TOLERANCE
    if use_rotation:
        ang = maths.quaternion_angle(maths.matrix_to_quat(R),
                                     maths.matrix_to_quat(t(rot))).numpy()
        assert ang[ok].max() < 2 * IK_TOLERANCE


def test_ik_lanes_freeze_when_they_stop(ur10s):
    """A lane that has converged keeps its configuration while others go
    on: running longer changes only the lanes that were still active."""
    _, tr = ur10s
    pos, rot, seeds = _reachable_problems(tr, 32, 0.5, seed=2)
    args = (tr.model, tr._active_tuple, tr.ee_link, t(pos), t(rot), t(seeds),
            tr._q_rest)
    short = ik.dls_ik_batch(*args, max_iters=4)
    longer = ik.dls_ik_batch(*args, max_iters=100)
    done = short.success
    assert done.any() and not done.all()
    assert torch.equal(short.config[done], longer.config[done])
    assert torch.equal(short.iters[done], longer.iters[done])


def test_ik_singular_system_is_a_rejected_step(ur10s):
    """Zero damping on a position-only problem whose Jacobian has lost a
    row's rank (the arm stretched straight up, target along it): the 3x3
    solve is singular. ``solve_ex`` returns instead of raising, and the
    lane comes back finite with no step taken or a valid one."""
    _, tr = ur10s
    q0 = np.zeros((2, 6), np.float32)
    q0[:, 1] = -np.pi / 2
    pos = tr.fk_point_batch(q0)[:, :3] + torch.tensor([0.0, 0.0, 0.5])
    res = ik.dls_ik_batch(
        tr.model, tr._active_tuple, tr.ee_link, pos,
        torch.eye(3).expand(2, 3, 3), t(q0), tr._q_rest, max_iters=5,
        use_rotation=False, damping=0.0)
    assert torch.isfinite(res.config).all() and not res.success.any()
    assert (res.iters == 5).all()


def test_dls_ik_single_equals_a_batch_of_one(ur10s):
    jr, tr = ur10s
    pos, rot, seeds = _reachable_problems(tr, 3, 0.1, seed=3)
    batch = ik.dls_ik_batch(tr.model, tr._active_tuple, tr.ee_link, t(pos),
                            t(rot), t(seeds), tr._q_rest, max_iters=3)
    one = ik.dls_ik(tr.model, tr._active_tuple, tr.ee_link, t(pos[1]),
                    t(rot[1]), t(seeds[1]), tr._q_rest, max_iters=3)
    assert one.config.shape == (6,) and one.success.shape == ()
    for a, b in zip(one, batch):
        assert torch.equal(a, b[1])
    ref = jik.dls_ik(jr.model, jr._active_tuple, jr.ee_link,
                     jnp.asarray(pos[1]), jnp.asarray(rot[1]),
                     jnp.asarray(seeds[1]), jr._q_rest, max_iters=3)
    np.testing.assert_allclose(one.config.numpy(), np.asarray(ref.config),
                               rtol=0, atol=IK_LOCKSTEP_TOL)


# ---------------------------------------------------------------------------
# the Robot protocol
# ---------------------------------------------------------------------------


def test_robot_structure_and_draws(ur10s, planars):
    for jr, tr in (ur10s, planars):
        assert tr.active_joints == jr.active_joints
        assert tr.fk_links == jr.fk_links and tr.ee_link == jr.ee_link
        assert tr.rotation == jr.rotation and tr.num_joints == jr.num_joints
        np.testing.assert_array_equal(tr.cyclic_joints, jr.cyclic_joints)
        np.testing.assert_array_equal(tr._cyclic_mask.numpy(),
                                      np.asarray(jr._cyclic_mask))
        # the numpy generators draw the same configurations and points
        np.testing.assert_array_equal(tr.sample(5), jr.sample(5))
        np.testing.assert_array_equal(tr.sample(), jr.sample())
        for seed in (0, 1):
            np.testing.assert_allclose(
                tr.workspace_sample(rng=np.random.default_rng(seed)),
                jr.workspace_sample(rng=np.random.default_rng(seed)),
                rtol=0, atol=DIST_TOL)
    assert ur10s[1].camera_link == ur10s[0].camera_link == 12


@pytest.mark.parametrize("which", ["ur10", "planar_5"])
def test_config_ops(ur10s, planars, which):
    jr, tr = ur10s if which == "ur10" else planars
    rng = np.random.default_rng(7)
    a, b = tr.sample(2, rng=rng) * 1.5
    assert tr.distance(a, b) == pytest.approx(jr.distance(a, b), abs=DIST_TOL)
    batch = tr.sample(16, rng=rng)
    d = tr.distance_batch(batch, a)
    assert isinstance(d, torch.Tensor)
    np.testing.assert_allclose(
        d.numpy(), np.asarray(jr.distance_batch(jnp.asarray(batch), a)),
        rtol=0, atol=DIST_TOL)
    for u in (0.0, 0.3, 1.0):
        got = tr.interpolate(a, b, u)
        assert isinstance(got, np.ndarray)
        np.testing.assert_allclose(got, jr.interpolate(a, b, u), rtol=0,
                                   atol=DIST_TOL)
    w = rng.uniform(size=16)
    for weights in (None, w, np.zeros(16)):
        np.testing.assert_allclose(tr.average(batch, weights),
                                   jr.average(batch, weights), rtol=0,
                                   atol=2 * DIST_TOL)


def test_workspace_ops(ur10s):
    jr, tr = ur10s
    rng = np.random.default_rng(8)
    p = [np.concatenate([rng.uniform(-1, 1, 3),
                         (lambda q: q / np.linalg.norm(q))(rng.normal(size=4))])
         for _ in range(2)]
    for p1, p2 in ((p[0], p[1]), (p[0][:3], p[1]), (p[0], p[1][:3]),
                   (p[0][:3], p[1][:3])):
        assert tr.workspace_distance(p1, p2) == pytest.approx(
            jr.workspace_distance(p1, p2), abs=DIST_TOL)
        for u in (0.0, 0.25, 1.0):
            got = tr.workspace_interpolate(p1, p2, u)
            ref = jr.workspace_interpolate(p1, p2, u)
            assert isinstance(got, np.ndarray) and got.shape == ref.shape
            np.testing.assert_allclose(got, ref, rtol=0, atol=DIST_TOL)


def test_solve_fk_and_fk_point(ur10s):
    jr, tr = ur10s
    configs = load_golden()[0][::50]
    pos, rot = tr.solve_fk(configs[0])
    posj, rotj = jr.solve_fk(configs[0])
    assert isinstance(pos, np.ndarray) and pos.shape == (7, 3)
    np.testing.assert_allclose(pos, posj, rtol=0, atol=FK_TOL)
    np.testing.assert_allclose(rot, rotj, rtol=0, atol=FK_TOL)
    ee, _ = tr.solve_fk(configs[0], index=-1)
    np.testing.assert_array_equal(ee, pos[-1])
    pts = tr.fk_point_batch(configs)
    assert isinstance(pts, torch.Tensor) and pts.shape == (10, 7)
    np.testing.assert_allclose(pts.numpy(),
                               np.asarray(jr.fk_point_batch(configs)),
                               rtol=0, atol=FK_TOL)


def test_solve_ik_returns_numpy_or_none(ur10s):
    _, tr = ur10s
    q = load_golden()[0][100]
    point = tr.fk_point_batch(q[None])[0].numpy()
    sol = tr.solve_ik(point, init_config=q + 0.05)
    assert isinstance(sol, np.ndarray) and sol.shape == (6,)
    reached, _ = tr.solve_fk(sol, index=-1)
    assert np.linalg.norm(reached - point[:3]) < IK_TOLERANCE
    far = np.array([5.0, 5.0, 5.0], np.float32)  # outside the arm's reach
    assert tr.solve_ik(far, init_config=q, max_iters=5) is None
    assert isinstance(tr.solve_ik(far, init_config=q, max_iters=5,
                                  none_on_fail=False), np.ndarray)


# ---------------------------------------------------------------------------
# paths, and the slice as a whole
# ---------------------------------------------------------------------------


def test_scan_arc():
    for kw in ({}, {"max_horiz": 0.9, "azimuth": 0.3}):
        got = paths.scan_arc([0.75, 0.75, 0.0], num_points=64,
                             device="cpu", **kw)
        ref = jpaths.scan_arc([0.75, 0.75, 0.0], num_points=64, **kw)
        assert got.shape == ref.shape == (64, 7) and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=DIST_TOL)


def test_arc_and_linear_paths():
    start = np.array([0.4, 0.1, 0.3, 0.0, 0.0, 0.0, 1.0])
    goal = np.array([0.1, 0.5, 0.2, 0.0, 0.7071068, 0.0, 0.7071068])
    axis = np.array([0.0, 0.0, 0.0, 0.0, 0.0, np.pi / 2])
    for a, b in ((paths.get_arc_path(start, axis, 2.0, 5, device="cpu"),
                  jpaths.get_arc_path(start, axis, 2.0, 5)),
                 (paths.get_linear_path(start, goal, 2.0, 5, device="cpu"),
                  jpaths.get_linear_path(start, goal, 2.0, 5)),
                 (paths.get_arc_path(start[:3], axis, 1.0, 4, device="cpu"),
                  jpaths.get_arc_path(start[:3], axis, 1.0, 4))):
        assert [x[0] for x in a] == [x[0] for x in b]
        np.testing.assert_allclose(np.stack([x[1] for x in a]),
                                   np.stack([x[1] for x in b]), rtol=0,
                                   atol=DIST_TOL)
    np.testing.assert_allclose(
        paths.linear_interpolate(start[:3], goal[:3], 0.5, device="cpu"),
        jpaths.linear_interpolate(start[:3], goal[:3], 0.5), atol=DIST_TOL)


def test_slice_scan_arc_to_camera_positions(ur10s):
    """The slice as a whole: ``scan_arc`` -> seeded ``solve_ik_batch`` with
    4 restarts a waypoint -> camera-link positions by FK."""
    jr, tr = ur10s
    arc = paths.scan_arc([0.75, 0.75, 0.0], radius=0.3, height=0.15,
                         num_points=8, device="cpu")
    restarts = 4
    targets = np.repeat(arc[:, :3], restarts, axis=0)
    seeds = tr.sample(len(targets), rng=np.random.default_rng(0))
    np.testing.assert_array_equal(
        seeds, jr.sample(len(targets), rng=np.random.default_rng(0)))
    q, ok = tr.solve_ik_batch(targets, seeds)
    qj, okj = jr.solve_ik_batch(targets, seeds)
    assert isinstance(q, torch.Tensor) and q.device.type == "cpu"
    ok, okj, qj = ok.numpy(), np.asarray(okj), np.asarray(qj)
    assert (ok == okj).mean() >= 0.9
    assert ok.reshape(8, restarts).any(axis=1).sum() >= 4
    # solved by the port: reached by the port's FK, valid by its checks
    reach = (tr.fk_point_batch(q)[:, :3] - t(targets)).norm(dim=-1).numpy()
    assert reach[ok].max() < IK_TOLERANCE
    assert tr._validate_batch(q)[torch.as_tensor(ok)].all()

    def cam_pos(rob_, configs):
        return chain.fk_all(rob_.model, rob_._full_config(t(configs)))[1][
            :, rob_.camera_link]

    def cam_pos_jax(configs):
        def one(c):
            full = jr._q_rest.at[jr._active_idx].set(c)
            return jchain.fk_all(jr.model, full)[1][jr.camera_link]

        return np.asarray(jax.vmap(one)(jnp.asarray(configs)))

    # the camera where both packages ended at the same configuration
    same = ok & okj & (np.abs(q.numpy() - qj).max(axis=1) < 1e-4)
    assert same.sum() >= 4
    np.testing.assert_allclose(cam_pos(tr, qj[same]).numpy(),
                               cam_pos_jax(qj[same]), rtol=0, atol=FK_TOL)
    # and the camera stays above the table
    assert (cam_pos(tr, q.numpy()[ok])[:, 2] > 0.0).all()
