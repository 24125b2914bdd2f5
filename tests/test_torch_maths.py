"""``reconplan_tpu_torch.core`` against ``reconplan_tpu.core`` on the CPU,
and against scipy.

Inputs are made from a seed with numpy and go through the JAX function and
its port (``device="cpu"``). Tolerances: 1e-6 absolute on unit-scale
values (quaternions, matrices, distances: a few f32 ulps, the two
packages order their sums differently), 2e-6 on angles in radians
(``atan2`` / ``acos`` of such values). Quaternions are compared as they
come, sign included: both packages take the same branches.

The second half holds the port to scipy with the cases and limits of
``tests/test_core_maths.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation as R
from scipy.spatial.transform import Slerp

from reconplan_tpu.core import grids as jgrids
from reconplan_tpu.core import maths as jm
from reconplan_tpu_torch.core import grids, maths

torch.set_num_threads(2)

ATOL = 1e-6
ANGLE_ATOL = 2e-6


def quats(rng, n):
    q = rng.normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


def rotations(rng, n):
    return R.from_quat(quats(rng, n)).as_matrix().astype(np.float32)


def f32(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def _poses(rng, n):
    return np.array(jm.pose_to_matrix(jnp.asarray(f32(rng, n, 3)),
                                      jnp.asarray(quats(rng, n))))


# name -> (function making the arguments from a numpy Generator,
# tolerance, kwargs)
CASES = {
    "quat_normalize": (lambda r: (f32(r, 32, 4),), ATOL, {}),
    "quat_mul": (lambda r: (quats(r, 32), quats(r, 32)), ATOL, {}),
    "quat_conj": (lambda r: (quats(r, 32),), 0.0, {}),
    "quat_rotate": (lambda r: (quats(r, 32), f32(r, 32, 3)), 2e-6, {}),
    "quat_to_matrix": (lambda r: (quats(r, 32),), ATOL, {}),
    "matrix_to_quat": (lambda r: (rotations(r, 64),), ATOL, {}),
    "euler_to_quat": (lambda r: (f32(r, 32, 3),), ATOL, {"seq": "xyz"}),
    "euler_to_matrix": (lambda r: (f32(r, 32, 3),), ATOL, {"seq": "ZYX"}),
    "quat_to_euler": (lambda r: (quats(r, 32),), ANGLE_ATOL, {"seq": "zyx"}),
    "rotvec_to_quat": (lambda r: (f32(r, 32, 3),), ATOL, {}),
    "quat_to_rotvec": (lambda r: (quats(r, 32),), ANGLE_ATOL, {}),
    "quaternion_angle": (lambda r: (quats(r, 32), quats(r, 32)),
                         ANGLE_ATOL, {}),
    "quaternion_close": (lambda r: (quats(r, 32), quats(r, 32)), 0.0, {}),
    "slerp": (lambda r: (quats(r, 32), quats(r, 32),
                         r.uniform(size=32).astype(np.float32)), ATOL, {}),
    "interpolate_quat": (lambda r: (quats(r, 8), quats(r, 8), 0.3), ATOL, {}),
    "se3_distance": (lambda r: (
        np.concatenate([f32(r, 32, 3), quats(r, 32)], -1),
        np.concatenate([f32(r, 32, 3), quats(r, 32)], -1)), ATOL, {}),
    "se3_metric": (lambda r: (f32(r, 32, 3), np.concatenate(
        [f32(r, 32, 3), quats(r, 32)], -1)), ATOL, {}),
    "wrap_to_pi": (lambda r: (f32(r, 64, scale=10.0),), ANGLE_ATOL, {}),
    "interpolate_angle": (lambda r: (f32(r, 64, scale=3.0),
                                     f32(r, 64, scale=3.0), 0.4),
                          ANGLE_ATOL, {}),
    "circular_mean": (lambda r: (f32(r, 8, 6, scale=3.0),
                                 r.uniform(size=(8, 1)).astype(np.float32)),
                      ANGLE_ATOL, {}),
    "pose_to_matrix": (lambda r: (f32(r, 16, 3), quats(r, 16)), ATOL, {}),
    "transform_points": (lambda r: (_poses(r, 4), f32(r, 4, 50, 3)),
                         2e-6, {}),
    "look_at_quat": (lambda r: (f32(r, 32, 3), f32(r, 3) + 3.0), ATOL, {}),
}


def _run_both(name, seed=0):
    build, atol, kwargs = CASES[name]
    args = build(np.random.default_rng(seed))
    got = getattr(maths, name)(
        *(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
          for a in args), **kwargs)
    ref = getattr(jm, name)(
        *(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args),
        **kwargs)
    return got, ref, atol


@pytest.mark.parametrize("name", sorted(CASES))
def test_function_matches_jax(name):
    got, ref, atol = _run_both(name)
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype
    if got.dtype == bool:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


def test_every_public_function_has_a_case():
    """The table above covers the functions ``core/__init__`` exports, but
    for the three that take no array (below)."""
    import reconplan_tpu_torch.core as core

    covered = set(CASES) | {"quat_identity", "matrix_to_pose", "sample_quat",
                            "get_staggered_grid", "get_so3_grid",
                            "super_fibonacci_so3"}
    assert set(core.__all__) <= covered
    import reconplan_tpu.core as jcore

    assert set(core.__all__) == set(jcore.__all__)


def test_quat_identity_and_matrix_to_pose():
    np.testing.assert_array_equal(maths.quat_identity(device="cpu").numpy(),
                                  np.asarray(jm.quat_identity()))
    T = _poses(np.random.default_rng(3), 8)
    p, q = maths.matrix_to_pose(torch.as_tensor(T))
    pj, qj = jm.matrix_to_pose(jnp.asarray(T))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_allclose(q.numpy(), np.asarray(qj), rtol=0, atol=ATOL)


def test_wrap_to_pi_takes_the_divisors_sign():
    """``jnp.mod`` and ``torch.remainder`` give a result in [0, 2 pi) for
    a negative angle; ``torch.fmod`` would leave it negative."""
    a = np.array([-7.0, -3.5, -np.pi, 3.5, 7.0, 100.0, -100.0], np.float32)
    got = maths.wrap_to_pi(torch.as_tensor(a)).numpy()
    np.testing.assert_allclose(got, np.asarray(jm.wrap_to_pi(jnp.asarray(a))),
                               rtol=0, atol=ANGLE_ATOL)
    assert (got >= -np.pi).all() and (got < np.pi).all()


def test_matrix_to_quat_ties_go_to_the_first_pivot():
    """Rotations by 120 degrees about (1, 1, 1)-like axes and by 180
    degrees about a diagonal make pivots exactly equal: the pick must be
    ``jnp.argmax``'s, the first."""
    mats = np.stack([
        np.array([[0, 0, 1], [1, 0, 0], [0, 1, 0]], np.float32),
        np.array([[0, 1, 0], [0, 0, 1], [1, 0, 0]], np.float32),
        np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1]], np.float32),
        np.array([[-1, 0, 0], [0, 0, 1], [0, 1, 0]], np.float32),
        np.eye(3, dtype=np.float32),
    ])
    got = maths.matrix_to_quat(torch.as_tensor(mats)).numpy()
    ref = np.asarray(jm.matrix_to_quat(jnp.asarray(mats)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("name,arg", [
    ("rotvec_to_quat", np.array([[1e-10, 0, 0], [0, 0, 0], [0, 5e-9, 0],
                                 [2e-8, 0, 0]], np.float32)),
    ("quat_to_rotvec", np.array([[0, 0, 0, 1], [1e-9, 0, 0, 1],
                                 [0, 3e-8, 0, -1], [0, 0, 0, -1]],
                                np.float32)),
])
def test_small_angle_branches(name, arg):
    got = getattr(maths, name)(torch.as_tensor(arg)).numpy()
    ref = np.asarray(getattr(jm, name)(jnp.asarray(arg)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_slerp_tiny_arc_and_scalar_u():
    q = quats(np.random.default_rng(5), 4)
    near = q + np.float32(1e-8)
    for u in (0.0, 0.5, 1.0):
        got = maths.slerp(torch.as_tensor(q), torch.as_tensor(near), u)
        ref = jm.slerp(jnp.asarray(q), jnp.asarray(near), u)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                                   atol=ATOL)


def test_sample_quat_unit_norm_and_distribution():
    """Same distribution, not the same draws: unit norm, a mean near zero
    and E|w| = 4 / (3 pi) on the 3-sphere, for both packages."""
    gen = torch.Generator(device="cpu").manual_seed(0)
    q = maths.sample_quat(gen, (4096,), device="cpu").numpy()
    qj = np.asarray(jm.sample_quat(jax.random.PRNGKey(0), (4096,)))
    assert q.shape == qj.shape == (4096, 4) and q.dtype == qj.dtype
    for s in (q, qj):
        np.testing.assert_allclose(np.linalg.norm(s, axis=-1), 1.0, atol=1e-5)
        assert np.abs(s.mean(axis=0)).max() < 0.05
        assert abs(np.abs(s[:, 3]).mean() - 4 / (3 * np.pi)) < 0.02


def test_transform_points_ignores_the_tf32_flag():
    """No matmul inside: the global TF32 switch cannot reach it."""
    rng = np.random.default_rng(7)
    T, pts = torch.as_tensor(_poses(rng, 2)), torch.as_tensor(f32(rng, 2, 9, 3))
    before = maths.transform_points(T, pts)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        after = maths.transform_points(T, pts)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    assert torch.equal(before, after)


def test_list_input_needs_a_device():
    """A list is made into a tensor on ``device``: the card by default,
    which this machine may lack."""
    q = maths.euler_to_quat([0.1, 0.2, 0.3], seq="xyz", device="cpu")
    assert q.device.type == "cpu" and q.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            maths.euler_to_quat([0.1, 0.2, 0.3])
        with pytest.raises(RuntimeError, match="cuda"):
            maths.sample_quat(None, (2,))


# ---------------------------------------------------------------------------
# grids (numpy, copied): equal to the JAX package's
# ---------------------------------------------------------------------------


def test_staggered_grid_equals_jax_package():
    domain = [[-1.0, 1.0], [0.5, 0.5], [-0.5, 1.0]]
    p, e = grids.get_staggered_grid(200, domain)
    pj, ej = jgrids.get_staggered_grid(200, domain)
    np.testing.assert_array_equal(p, pj)
    np.testing.assert_array_equal(e, ej)
    np.testing.assert_allclose(p[:, 1], 0.5)


@pytest.mark.parametrize("rot_domain,n", [([0, 0, 1], 8), ([1, 1, 1], 64)])
def test_so3_grid_equals_jax_package(rot_domain, n):
    q, e = grids.get_so3_grid(n, rot_domain, [-np.pi, 0.0, 0.0], 3,
                               device="cpu")
    qj, ej = jgrids.get_so3_grid(n, rot_domain, [-np.pi, 0.0, 0.0], 3)
    np.testing.assert_allclose(q, qj, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(e, ej)
    np.testing.assert_array_equal(grids.super_fibonacci_so3(n),
                                  jgrids.super_fibonacci_so3(n))


# ---------------------------------------------------------------------------
# the scipy cases of tests/test_core_maths.py, on the port
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(0)


def random_quats(n):
    q = RNG.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float32))


def assert_quat_close(q1, q2, atol=1e-5):
    """Quaternions equal up to sign."""
    q1, q2 = np.asarray(q1), np.asarray(q2)
    np.testing.assert_allclose(np.abs(np.sum(q1 * q2, axis=-1)), 1.0,
                               atol=atol)


class TestQuaternionBasics:
    def test_mul_matches_matrix_product(self):
        q1, q2 = random_quats(2)
        m = maths.quat_to_matrix(maths.quat_mul(t(q1), t(q2))).numpy()
        expected = R.from_quat(q1).as_matrix() @ R.from_quat(q2).as_matrix()
        np.testing.assert_allclose(m, expected, atol=1e-6)

    def test_rotate_matches_scipy_apply(self):
        q = random_quats(8)
        v = RNG.normal(size=(8, 3))
        out = maths.quat_rotate(t(q), t(v)).numpy()
        expected = np.stack([R.from_quat(qi).apply(vi)
                             for qi, vi in zip(q, v)])
        np.testing.assert_allclose(out, expected, atol=1e-5)

    def test_quat_to_matrix(self):
        q = random_quats(16)
        np.testing.assert_allclose(maths.quat_to_matrix(t(q)).numpy(),
                                   R.from_quat(q).as_matrix(), atol=1e-6)

    def test_matrix_to_quat_roundtrip(self):
        q = random_quats(64)
        out = maths.matrix_to_quat(t(R.from_quat(q).as_matrix())).numpy()
        assert_quat_close(out, q)

    def test_matrix_to_quat_degenerate_cases(self):
        # 180-degree rotations hit every Shepperd pivot branch
        for axis in np.eye(3):
            m = R.from_rotvec(np.pi * axis).as_matrix()
            assert_quat_close(maths.matrix_to_quat(t(m)).numpy(),
                              R.from_matrix(m).as_quat())
        assert_quat_close(maths.matrix_to_quat(torch.eye(3)).numpy(),
                          [0, 0, 0, 1])


class TestEuler:
    @pytest.mark.parametrize("seq", ["zyx", "ZYX", "xyz", "XYZ"])
    def test_euler_to_quat(self, seq):
        eulers = RNG.uniform(-np.pi, np.pi, size=(32, 3))
        out = maths.euler_to_quat(t(eulers), seq=seq).numpy()
        assert_quat_close(out, R.from_euler(seq, eulers).as_quat())

    @pytest.mark.parametrize("seq", ["zyx", "ZYX", "xyz", "XYZ"])
    def test_quat_to_euler_roundtrip(self, seq):
        q = random_quats(32)
        eulers = maths.quat_to_euler(t(q), seq=seq).numpy()
        np.testing.assert_allclose(eulers, R.from_quat(q).as_euler(seq),
                                   atol=1e-4)

    def test_euler_to_matrix(self):
        eulers = RNG.uniform(-np.pi, np.pi, size=(8, 3))
        out = maths.euler_to_matrix(t(eulers), seq="zyx").numpy()
        np.testing.assert_allclose(
            out, R.from_euler("zyx", eulers).as_matrix(), atol=1e-5)


class TestRotvec:
    def test_rotvec_to_quat(self):
        rv = RNG.normal(size=(32, 3))
        assert_quat_close(maths.rotvec_to_quat(t(rv)).numpy(),
                          R.from_rotvec(rv).as_quat())

    def test_rotvec_to_quat_small_angle(self):
        rv = np.array([[1e-10, 0, 0], [0.0, 0.0, 0.0]])
        assert_quat_close(maths.rotvec_to_quat(t(rv)).numpy(),
                          R.from_rotvec(rv).as_quat())

    def test_quat_to_rotvec_roundtrip(self):
        q = random_quats(32)
        np.testing.assert_allclose(maths.quat_to_rotvec(t(q)).numpy(),
                                   R.from_quat(q).as_rotvec(), atol=1e-4)


class TestMetricsAndInterp:
    def test_quaternion_angle(self):
        q = random_quats(10)
        for i in range(5):
            q1, q2 = q[2 * i], q[2 * i + 1]
            got = float(maths.quaternion_angle(t(q1), t(q2)))
            expected = 2 * np.arccos(min(abs(np.dot(q1, q2)), 1.0))
            assert abs(got - expected) < 1e-5

    def test_se3_distance_position_only(self):
        p1 = np.array([0.0, 0.0, 0.0])
        p2 = np.array([1.0, 2.0, 2.0])
        assert float(maths.se3_distance(p1, p2, device="cpu")) == \
            pytest.approx(3.0)

    def test_se3_distance_full(self):
        q1, q2 = random_quats(2)
        p1 = np.concatenate([[0.1, 0.2, 0.3], q1])
        p2 = np.concatenate([[0.4, 0.2, 0.3], q2])
        got = float(maths.se3_distance(t(p1), t(p2)))
        expected = 1.0 * 0.3 + 0.3 * (1 - abs(np.dot(q1, q2)))
        assert got == pytest.approx(expected, abs=1e-6)

    def test_slerp_matches_scipy(self):
        q = random_quats(2)
        sl = Slerp([0, 1], R.from_quat(q))
        for u in [0.0, 0.25, 0.5, 0.99, 1.0]:
            got = maths.slerp(t(q[0]), t(q[1]), u).numpy()
            assert_quat_close(got, sl([u]).as_quat()[0], atol=1e-4)

    def test_wrap_to_pi(self):
        angles = np.array([0.0, np.pi + 0.1, -np.pi - 0.1, 4 * np.pi + 0.3])
        got = maths.wrap_to_pi(t(angles)).numpy()
        expected = (angles + np.pi) % (2 * np.pi) - np.pi
        np.testing.assert_allclose(got, expected, atol=1e-6)

    def test_interpolate_angle_shortest_path(self):
        # crossing the -pi/pi boundary
        mid = float(maths.interpolate_angle(t(3.0), t(-3.0), 0.5))
        assert abs(abs(mid) - np.pi) < 0.15  # midway across the seam

    def test_circular_mean(self):
        m = float(maths.circular_mean(t([3.1, -3.1]), t([0.5, 0.5])))
        assert abs(abs(m) - np.pi) < 1e-5  # mean wraps at the seam, not 0


class TestTransforms:
    def test_pose_matrix_roundtrip(self):
        q = random_quats(4)
        p = RNG.normal(size=(4, 3))
        T = maths.pose_to_matrix(t(p), t(q))
        p2, q2 = maths.matrix_to_pose(T)
        np.testing.assert_allclose(p2.numpy(), p, atol=1e-6)
        assert_quat_close(q2.numpy(), q)

    def test_transform_points(self):
        q = random_quats(1)[0]
        p = np.array([1.0, 2.0, 3.0])
        pts = RNG.normal(size=(10, 3))
        T = maths.pose_to_matrix(t(p), t(q))
        got = maths.transform_points(T, t(pts)).numpy()
        expected = pts @ R.from_quat(q).as_matrix().T + p
        np.testing.assert_allclose(got, expected, atol=1e-5)

    def test_look_at_quat_matches_the_arc_construction(self):
        eye = np.array([0.3, 0.4, 0.5])
        target = np.array([0.75, 0.75, 0.0])
        v = target - eye
        z_axis = v / np.linalg.norm(v)
        x_axis = np.cross(np.array([1, 0, 0]), z_axis)
        x_axis /= np.linalg.norm(x_axis)
        y_axis = np.cross(z_axis, x_axis)
        rotation_matrix = np.column_stack((x_axis, y_axis, z_axis)).T
        euler_calc = R.from_matrix(rotation_matrix).as_euler("ZYX")
        expected = R.from_euler(
            "ZYX", [0, euler_calc[1], euler_calc[2]]).as_quat()
        got = maths.look_at_quat(t(eye), t(target)).numpy()
        assert_quat_close(got, expected, atol=1e-5)


class TestSampling:
    def test_sample_quat_uniform_unit(self):
        gen = torch.Generator(device="cpu").manual_seed(0)
        q = maths.sample_quat(gen, (256,), device="cpu").numpy()
        np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, atol=1e-5)
        # rough uniformity: mean should be near zero
        assert np.abs(q.mean(axis=0)).max() < 0.15


class TestGrids:
    def test_so3_grid_yaw_axis(self):
        """rot_domain [0,0,1] varies the rotation about +z."""
        q, _ = grids.get_so3_grid(8, [0, 0, 1], [0.0, 0.0, 0.0], 2,
                                  device="cpu")
        np.testing.assert_allclose(q[:, 0], 0.0, atol=1e-7)
        np.testing.assert_allclose(q[:, 1], 0.0, atol=1e-7)
        assert np.abs(q[:, 2]).max() > 0.9

    def test_problem_euler_seq_tool_down(self):
        """``fixed_rotation`` [-pi, 0, pi/2] realizes tool-z-DOWN."""
        q = maths.euler_to_quat(t([-np.pi, 0.0, np.pi / 2]),
                                seq=maths.PROBLEM_EULER_SEQ)
        np.testing.assert_allclose(
            maths.quat_to_matrix(q).numpy(),
            [[0, 1, 0], [1, 0, 0], [0, 0, -1]], atol=1e-6)
