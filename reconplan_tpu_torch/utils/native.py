"""ctypes bindings to the native graph runtime (``native/graphcore.cpp``).

Port of ``reconplan_tpu.utils.native``. The library is built from the
repository's own ``native/graphcore.cpp`` with ``g++ -O3 -fPIC -std=c++17
-shared`` into ``reconplan_tpu_torch/_build/`` at first use, under the
file lock and source-hash stamp of ``ops/kernels/build.py``: processes
that start together build it once, and an edit of the source rebuilds
it. ``native/`` itself is only read. Every query has a pure-Python
fallback with the same answers, taken when the library cannot be built
or loaded (``GraphCore.native`` says which). This is host code: the
graphs are small next to the device arrays.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from reconplan_tpu_torch.ops.kernels.build import (
    BUILD_DIR,
    build_lock,
    up_to_date,
)

SOURCE = Path(__file__).resolve().parents[2] / "native" / "graphcore.cpp"
LIB_NAME = "libgraphcore.so"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return h.hexdigest()


def build() -> Path:
    """Compile ``native/graphcore.cpp`` into ``_build/`` unless an
    up-to-date library is there. Returns its path; raises without a C++
    compiler or on a compile error."""
    lib = BUILD_DIR / LIB_NAME
    digest = source_hash()
    if up_to_date(lib, digest):
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler: graphcore cannot be built")
    with build_lock():
        # another process may have built it while this one waited
        if not up_to_date(lib, digest):
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                out = Path(tmp) / LIB_NAME
                proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(out),
                                       str(SOURCE)], capture_output=True,
                                      text=True)
                if proc.returncode != 0:
                    raise RuntimeError(f"{cxx} failed on {SOURCE}:\n"
                                       f"{proc.stdout}\n{proc.stderr}")
                os.replace(out, lib)
            lib.with_name(LIB_NAME + ".sha256").write_text(digest)
    return lib


@functools.cache
def _load():
    lib = ctypes.CDLL(str(build()))
    lib.graphcore_dijkstra.restype = ctypes.c_int64
    lib.graphcore_dijkstra.argtypes = [
        _I64P, _I64P, _F32P,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64P, ctypes.c_int64,
    ]
    lib.graphcore_bfs_distances.restype = None
    lib.graphcore_bfs_distances.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, _I64P,
    ]
    lib.graphcore_components.restype = ctypes.c_int64
    lib.graphcore_components.argtypes = [_I64P, _I64P, ctypes.c_int64, _I64P]
    lib.graphcore_k_layers.restype = ctypes.c_int64
    lib.graphcore_k_layers.argtypes = [
        _I64P, _I64P, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _I64P, ctypes.c_int64,
    ]
    return lib


class GraphCore:
    """CSR graph with native queries (Python fallbacks built in)."""

    def __init__(self, n_nodes, edges, weights=None):
        """edges (E, 2) undirected; weights (E,) optional."""
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        if weights is None:
            weights = np.ones(len(edges), dtype=np.float32)
        weights = np.asarray(weights, dtype=np.float32)
        # symmetrize
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        w = np.concatenate([weights, weights])
        order = np.argsort(src, kind="stable")
        src, dst, w = src[order], dst[order], w[order]
        self.n_nodes = int(n_nodes)
        self.indptr = np.zeros(self.n_nodes + 1, dtype=np.int64)
        np.add.at(self.indptr, src + 1, 1)
        self.indptr = np.cumsum(self.indptr)
        self.indices = np.ascontiguousarray(dst)
        self.weights = np.ascontiguousarray(w)
        try:
            self._lib = _load()
        except (OSError, RuntimeError):  # no compiler, or no loadable .so
            self._lib = None  # pure-python fallback

    @property
    def native(self):
        return self._lib is not None

    # ------------------------------------------------------------------
    def shortest_path(self, source, target):
        """Weighted shortest path node list, or None if unreachable."""
        if self._lib is not None:
            out = np.zeros(self.n_nodes, dtype=np.int64)
            n = self._lib.graphcore_dijkstra(
                self.indptr, self.indices, self.weights,
                self.n_nodes, int(source), int(target), out, self.n_nodes,
            )
            if n <= 0:
                return None
            return out[:n].tolist()
        import heapq

        dist = {source: 0.0}
        prev = {}
        pq = [(0.0, source)]
        while pq:
            d, u = heapq.heappop(pq)
            if u == target:
                break
            if d > dist.get(u, np.inf):
                continue
            for e in range(self.indptr[u], self.indptr[u + 1]):
                v = int(self.indices[e])
                nd = d + float(self.weights[e])
                if nd < dist.get(v, np.inf):
                    dist[v] = nd
                    prev[v] = u
                    heapq.heappush(pq, (nd, v))
        if target not in dist:
            return None
        path = [target]
        while path[-1] != source:
            path.append(prev[path[-1]])
        return path[::-1]

    def bfs_distances(self, source):
        """(N,) hop counts from source (-1 unreachable)."""
        if self._lib is not None:
            out = np.zeros(self.n_nodes, dtype=np.int64)
            self._lib.graphcore_bfs_distances(
                self.indptr, self.indices, self.n_nodes, int(source), out
            )
            return out
        from collections import deque

        out = np.full(self.n_nodes, -1, dtype=np.int64)
        out[source] = 0
        q = deque([source])
        while q:
            u = q.popleft()
            for e in range(self.indptr[u], self.indptr[u + 1]):
                v = int(self.indices[e])
                if out[v] < 0:
                    out[v] = out[u] + 1
                    q.append(v)
        return out

    def components(self):
        """(labels (N,), n_components)."""
        if self._lib is not None:
            out = np.zeros(self.n_nodes, dtype=np.int64)
            k = self._lib.graphcore_components(
                self.indptr, self.indices, self.n_nodes, out
            )
            return out, int(k)
        labels = np.full(self.n_nodes, -1, dtype=np.int64)
        label = 0
        for s in range(self.n_nodes):
            if labels[s] >= 0:
                continue
            stack = [s]
            labels[s] = label
            while stack:
                u = stack.pop()
                for e in range(self.indptr[u], self.indptr[u + 1]):
                    v = int(self.indices[e])
                    if labels[v] < 0:
                        labels[v] = label
                        stack.append(v)
            label += 1
        return labels, label

    def k_layer_neighbors(self, source, k):
        """Nodes within k hops of source, excluding source."""
        if self._lib is not None:
            out = np.zeros(self.n_nodes, dtype=np.int64)
            n = self._lib.graphcore_k_layers(
                self.indptr, self.indices, self.n_nodes,
                int(source), int(k), out, self.n_nodes,
            )
            return out[:n] if n >= 0 else out
        d = self.bfs_distances(source)
        return np.flatnonzero((d > 0) & (d <= k))


_GLOBAL = {}


def get_graphcore(n_nodes, edges, weights=None, cache_key=None):
    """Build (and optionally cache) a GraphCore for a roadmap."""
    if cache_key is not None and cache_key in _GLOBAL:
        return _GLOBAL[cache_key]
    g = GraphCore(n_nodes, edges, weights)
    if cache_key is not None:
        _GLOBAL[cache_key] = g
    return g
