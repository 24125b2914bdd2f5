"""``ops.nn._smallest`` against ``jax.lax.top_k(-d, k)``, the selection the
JAX package's k-NN, IK seeds and teleop seeds make: the ``k`` smallest of
each row ascending by (value, index), also where equal values straddle
the ``k``-th place (``torch.topk`` alone may pick any of them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reconplan_tpu.ops import nn as jnn
from reconplan_tpu_torch.ops import nn as tnn
from reconplan_tpu_torch.ops.nn import _smallest

torch.set_num_threads(2)


def _top_k(d, k):
    return np.asarray(jax.lax.top_k(-jnp.asarray(d), k)[1])


def _port(d, k):
    return _smallest(torch.as_tensor(d), k).numpy()


@pytest.mark.parametrize("k", [1, 4, 8])
def test_all_zero_rows_pick_the_lowest_indices(k):
    """An all-zero row of 8: every entry ties, so the first k win."""
    d = np.zeros((3, 8), np.float32)
    assert np.array_equal(_port(d, k), _top_k(d, k))
    assert np.array_equal(_port(d, k)[0], np.arange(k))


def test_inf_padded_row_with_fewer_valid_entries_than_k():
    """A masked row as ``_knn_chunked`` builds it: two valid entries, the
    rest ``inf``; the fill takes the first ``inf`` columns."""
    d = np.array([[np.inf] * 40 + [0.5] * 2], np.float32)
    assert _port(d, 4).tolist() == [[40, 41, 0, 1]]
    assert np.array_equal(_port(d, 4), _top_k(d, 4))


@pytest.mark.parametrize("width", [8, 33, 257, 5000])
def test_integer_rows_tie_as_lax_top_k(width):
    """Rows of integers drawn from 0-3, k from 1 to 8: ties straddle the
    k-th place in most rows."""
    rng = np.random.default_rng(width)
    d = rng.integers(0, 4, (60, width)).astype(np.float32)
    for k in range(1, 9):
        assert np.array_equal(_port(d, k), _top_k(d, k)), k


@pytest.mark.parametrize("width", [8, 100, 5000])
def test_distinct_rows_are_unchanged(width):
    """Distinct values: the order of the plain ascending sort, as before
    the repair."""
    rng = np.random.default_rng(width + 1)
    d = rng.normal(size=(40, width)).astype(np.float32)
    for k in (1, 5, 8):
        got = _port(d, k)
        assert np.array_equal(got, np.argsort(d, axis=1, kind="stable")[:, :k])
        assert np.array_equal(got, _top_k(d, k))


def test_se3_knn_on_tied_points_matches_jax():
    """Duplicate workspace points tie exactly in both metrics: the
    neighbours come back in the JAX package's index order."""
    rng = np.random.default_rng(5)
    base = rng.normal(size=(50, 7)).astype(np.float32)
    base[:, 3:] /= np.linalg.norm(base[:, 3:], axis=1, keepdims=True)
    pts = np.repeat(base, 6, axis=0)
    queries = base[:7]
    dj, ij = jnn.se3_knn(jnp.asarray(queries), jnp.asarray(pts), 8)
    dt, it = tnn.se3_knn(torch.as_tensor(queries), torch.as_tensor(pts), 8)
    assert np.array_equal(it.numpy(), np.asarray(ij))
    assert np.abs(dt.numpy() - np.asarray(dj)).max() <= 1e-6
