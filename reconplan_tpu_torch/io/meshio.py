"""Mesh IO without Open3D: PLY/STL/OFF readers and surface sampling.

A numpy copy of ``reconplan_tpu.io.meshio`` (``load_mesh``, ``save_ply``
and ``sample_mesh_surface``): the port imports nothing from the JAX package,
whose ``__init__`` imports jax. Used for the YCB ground-truth meshes
(``data/objects/011_banana``) that anchor the Chamfer checks, and as the
input of the splat renderer (``io.render``).
"""

from __future__ import annotations

import struct

import numpy as np


def load_mesh(path: str):
    """Load a triangle mesh -> (vertices (V, 3) f64, faces (F, 3) int64).

    Supports binary/ascii PLY, binary STL, and OFF.
    """
    lower = path.lower()
    if lower.endswith(".ply"):
        return _load_ply(path)
    if lower.endswith(".stl"):
        return _load_stl_binary(path)
    if lower.endswith(".off"):
        return _load_off(path)
    raise ValueError(f"unsupported mesh format: {path}")


def _load_ply(path: str):
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l.split()[1] for l in header if l.startswith("format"))
        elems = []  # (name, count, [(type, prop_name), ...])
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elems.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    cur[2].append(("list", parts[2], parts[3], parts[4]))
                else:
                    cur[2].append((parts[1], parts[2]))

        type_map = {
            "float": ("f", 4), "float32": ("f", 4),
            "double": ("d", 8), "float64": ("d", 8),
            "uchar": ("B", 1), "uint8": ("B", 1),
            "char": ("b", 1), "int8": ("b", 1),
            "short": ("h", 2), "int16": ("h", 2),
            "ushort": ("H", 2), "uint16": ("H", 2),
            "int": ("i", 4), "int32": ("i", 4),
            "uint": ("I", 4), "uint32": ("I", 4),
        }

        verts = None
        faces = None
        if fmt == "ascii":
            for name, count, props in elems:
                rows = [f.readline().split() for _ in range(count)]
                if name == "vertex":
                    idx = [i for i, p in enumerate(props) if p[0] != "list"][:3]
                    names = [p[1] for p in props if p[0] != "list"]
                    xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                    arr = np.array(
                        [[float(r[xi]), float(r[yi]), float(r[zi])] for r in rows]
                    )
                    verts = arr
                elif name == "face":
                    faces = np.array(
                        [[int(v) for v in r[1:4]] for r in rows], dtype=np.int64
                    )
        else:
            little = fmt == "binary_little_endian"
            endian = "<" if little else ">"
            for name, count, props in elems:
                if name == "vertex":
                    fmt_str = endian + "".join(type_map[p[0]][0] for p in props)
                    size = struct.calcsize(fmt_str)
                    raw = f.read(size * count)
                    names = [p[1] for p in props]
                    data = np.array(
                        [struct.unpack_from(fmt_str, raw, i * size) for i in range(count)]
                    )
                    verts = data[:, [names.index("x"), names.index("y"), names.index("z")]]
                elif name == "face":
                    # assume one list property (vertex_indices)
                    lp = props[0]
                    cnt_fmt, cnt_size = type_map[lp[1]]
                    idx_fmt, idx_size = type_map[lp[2]]
                    out = []
                    for _ in range(count):
                        (n,) = struct.unpack(endian + cnt_fmt, f.read(cnt_size))
                        vals = struct.unpack(
                            endian + idx_fmt * n, f.read(idx_size * n)
                        )
                        out.append(vals[:3])
                    faces = np.array(out, dtype=np.int64)
                else:
                    # skip unknown fixed-size elements
                    fmt_str = endian + "".join(
                        type_map[p[0]][0] for p in props if p[0] != "list"
                    )
                    f.read(struct.calcsize(fmt_str) * count)
    if verts is None:
        raise ValueError(f"no vertex element in {path}")
    if faces is None:
        faces = np.zeros((0, 3), dtype=np.int64)
    return np.asarray(verts, dtype=np.float64), faces


def _load_stl_binary(path: str):
    with open(path, "rb") as f:
        f.read(80)
        (n_tri,) = struct.unpack("<I", f.read(4))
        data = np.frombuffer(f.read(n_tri * 50), dtype=np.uint8).reshape(n_tri, 50)
    tri = data[:, 12:48].copy().view("<f4").reshape(n_tri, 3, 3).astype(np.float64)
    verts = tri.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    return verts, faces


def _load_off(path: str):
    with open(path) as f:
        header = f.readline().strip()
        counts = header[3:].split() if header != "OFF" else f.readline().split()
        nv, nf = int(counts[0]), int(counts[1])
        verts = np.loadtxt(f, max_rows=nv)[:, :3]
        faces = np.loadtxt(f, max_rows=nf, dtype=np.int64)[:, 1:4]
    return verts, faces


def _to_numpy(a):
    """numpy view of an array or of a tensor on any device."""
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_ply(path: str, triangles=None, vertices=None, faces=None,
             colors=None):
    """Write an ascii PLY from either a triangle soup (T, 3, 3) or an
    indexed (vertices, faces) mesh, or a bare point cloud (vertices only)."""
    if triangles is not None:
        vertices = _to_numpy(triangles).reshape(-1, 3)
        faces = np.arange(len(vertices), dtype=np.int64).reshape(-1, 3)
    vertices = _to_numpy(vertices)
    if faces is not None:
        faces = _to_numpy(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(vertices)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\n"
                    "property uchar blue\n")
        if faces is not None:
            f.write(f"element face {len(faces)}\n")
            f.write("property list uchar int vertex_indices\n")
        f.write("end_header\n")
        if colors is not None:
            c255 = np.clip(_to_numpy(colors) * 255, 0, 255).astype(np.uint8)
            for v, c in zip(vertices, c255):
                f.write(f"{v[0]} {v[1]} {v[2]} {c[0]} {c[1]} {c[2]}\n")
        else:
            for v in vertices:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def sample_mesh_surface(vertices, faces, n_points, seed=0):
    """Uniform surface sampling by triangle-area-weighted barycentric draws.

    Ground-truth point sets for Chamfer metrics and the input to the
    synthetic splat renderer (io.render).
    Returns (points (n, 3), normals (n, 3)).
    """
    rng = np.random.default_rng(seed)
    v0 = vertices[faces[:, 0]]
    v1 = vertices[faces[:, 1]]
    v2 = vertices[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    area = 0.5 * np.linalg.norm(cross, axis=-1)
    prob = area / area.sum()
    tri = rng.choice(len(faces), size=n_points, p=prob)
    u = rng.uniform(size=(n_points, 1))
    v = rng.uniform(size=(n_points, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    pts = v0[tri] + u * (v1[tri] - v0[tri]) + v * (v2[tri] - v0[tri])
    nrm = cross[tri]
    nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True), 1e-12)
    return pts, nrm
