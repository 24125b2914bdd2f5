"""Benchmark: SE3 nearest-neighbor search vs sklearn BallTree (C9 parity).

The reference's GNAT shipped a self-benchmark against BallTree on 1M random
SE3 points (``grr/gnat.py:558-653``). This is the rebuild's equivalent:
exact dense top-k on the device vs BallTree build+query on the CPU. The
dense search has ZERO build time — the quantity the reference's NN
structures pay minutes for (``workspace.py:89-93``).

Port of the repo's ``benchmarks/bench_nn.py``: the same points (numpy,
seed 0), one warm and one timed ``se3_knn``, and the BallTree timed as
there. The JAX script's ``tpu_*`` keys are ``device_*`` here
(``device_dense_seconds``, ``device_build_seconds``, ``device_exact``):
the search runs on the device this run names in ``"device"``, the CUDA
card unless ``--device cpu`` is given, and a key naming the TPU would
name a chip that did not run it. The timed search ends in a
``torch.cuda.synchronize()``. The tree's times are ``tree_build_seconds``
and ``tree_query_seconds`` (the JAX script's ``balltree_*``) and
``"tree"`` names the tree: sklearn's ``BallTree`` where scikit-learn is
installed, else scipy's ``cKDTree`` (the card's machine has no
scikit-learn) on the same euclidean 7D proxy, so the keys are the same
on every machine.

    python -m reconplan_tpu_torch.benchmarks.bench_nn [--device cpu]
"""

import argparse
import json
import time

import numpy as np

from reconplan_tpu_torch.benchmarks import device_label, sync


def make_points(n_points, n_queries):
    """The benchmark's seeded data: (points (n_points, 7), queries
    (n_queries, 7)) f32 [position, unit quaternion], the queries drawn
    from the points."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(-1, 1, (n_points, 3))
    q = rng.normal(size=(n_points, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pts = np.concatenate([pos, q], -1).astype(np.float32)
    queries = pts[rng.choice(n_points, n_queries, replace=False)]
    return pts, queries


def main(n_points=1_000_000, n_queries=4096, k=5, device=None):
    """Print the row; return it with the timed search's (distances,
    indices), each (n_queries, k) on the device."""
    import torch

    from reconplan_tpu_torch.ops.nn import se3_knn
    from reconplan_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    label = device_label(dev)
    pts, queries = make_points(n_points, n_queries)
    pts_d = torch.as_tensor(pts, device=dev)
    queries_d = torch.as_tensor(queries, device=dev)

    # dense top-k on the device (build time: none)
    se3_knn(queries_d, pts_d, k)
    sync(dev)
    t0 = time.perf_counter()
    d, idx = se3_knn(queries_d, pts_d, k)
    sync(dev)
    t_dense = time.perf_counter() - t0

    # BallTree reference (euclidean proxy on 7D, like gnat.py's baseline)
    try:
        from sklearn.neighbors import BallTree as Tree
    except ImportError:
        # a machine without scikit-learn: scipy's k-d tree, the same
        # euclidean 7D proxy
        from scipy.spatial import cKDTree as Tree

    t0 = time.perf_counter()
    tree = Tree(pts)
    t_build = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree.query(queries, k)
    t_query = time.perf_counter() - t0

    row = {
        "config": "SE3 kNN, 1M points",
        "n_points": n_points,
        "n_queries": n_queries,
        "k": k,
        "device_dense_seconds": round(t_dense, 3),
        "device_build_seconds": 0.0,
        "tree": f"{Tree.__module__.split('.')[0]} {Tree.__name__}",
        "tree_build_seconds": round(t_build, 2),
        "tree_query_seconds": round(t_query, 3),
        "device_exact": True,
        "note": f"{Tree.__name__} uses euclidean 7D (no custom SE3 metric "
                "support at speed); the dense search is the exact "
                "reference SE3 metric",
        "device": label,
    }
    print(json.dumps(row), flush=True)
    return row, d, idx


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the cuda card)")
    main(device=ap.parse_args().device)
