"""Host-side parser for Klampt ``.rob`` robot description files.

Copy of ``reconplan_tpu.kin.rob_parser`` (numpy and stdlib only). Klampt
loads these files through its C++ ``WorldModel``; they are parsed here
directly, so the kinematic ground truth (``data/robots/*.rob``) is kept
without that dependency. Only the kinematics-relevant subset of the format
is parsed: links / parents / axis / jointtype / Tparent / qmin / qmax /
geometry.

Format notes (from the data files themselves):
  * ``key<ws>values`` lines; ``\\`` continues onto the next line; ``#``
    starts a comment; keys are case-insensitive (``TParent``/``Tparent``,
    ``qMin``/``qmin``).
  * ``Tparent`` packs, per link, a 3x3 rotation in row-major order
    followed by a translation.
  * If ``parents`` is absent the file describes a serial chain
    (parent of link i is i-1), e.g. ``planar_5.rob``.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np


@dataclass
class RobModel:
    """Raw kinematic description of one robot file."""

    name: str
    link_names: list[str]
    parents: np.ndarray  # (L,) int, -1 for root
    axes: np.ndarray  # (L, 3) unit joint axes in link frame
    joint_types: list[str]  # 'r' (revolute) or 'p' (prismatic)
    R_parent: np.ndarray  # (L, 3, 3) fixed rotation to parent frame
    t_parent: np.ndarray  # (L, 3) fixed translation in parent frame
    qmin: np.ndarray  # (L,)
    qmax: np.ndarray  # (L,)
    geometry: list[str] = field(default_factory=list)  # per-link mesh path ('' if none)
    geomscale: np.ndarray | None = None
    source_dir: str = ""

    @property
    def num_links(self) -> int:
        return len(self.parents)

    def link_index(self, name: str) -> int:
        return self.link_names.index(name)


def _logical_lines(text: str):
    """Yield backslash-joined, comment-stripped logical lines."""
    buf = ""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0]
        if line.rstrip().endswith("\\"):
            buf += line.rstrip()[:-1] + " "
            continue
        buf += line
        if buf.strip():
            yield buf.strip()
        buf = ""
    if buf.strip():
        yield buf.strip()


_TOKEN_RE = re.compile(r'"([^"]*)"|(\S+)')


def _tokens(s: str):
    return [m.group(1) if m.group(1) is not None else m.group(2) for m in _TOKEN_RE.finditer(s)]


def _floats(toks):
    out = []
    for t in toks:
        tl = t.lower()
        if tl in ("inf", "+inf"):
            out.append(np.inf)
        elif tl == "-inf":
            out.append(-np.inf)
        else:
            out.append(float(t))
    return np.array(out, dtype=np.float64)


def parse_rob(path: str, name: str | None = None) -> RobModel:
    """Parse a ``.rob`` file into a :class:`RobModel`."""
    with open(path) as f:
        text = f.read()

    fields: dict[str, list[str]] = {}
    for line in _logical_lines(text):
        toks = _tokens(line)
        if not toks:
            continue
        key = toks[0].lower()
        # repeated keys (joint, noselfcollision and the like) accumulate
        fields.setdefault(key, []).append(toks[1:])

    def first(key):
        return fields.get(key, [None])[0]

    joint_types = [t.lower() for t in first("jointtype")]
    L = len(joint_types)

    link_names = first("links") or [f"link{i}" for i in range(L)]
    parents_f = first("parents")
    parents = (
        np.array([int(p) for p in parents_f], dtype=np.int64)
        if parents_f is not None
        else np.arange(-1, L - 1, dtype=np.int64)
    )

    axes = _floats(first("axis")).reshape(L, 3)

    tp = _floats(first("tparent")).reshape(L, 12)
    # 9 rotation entries in ROW-major order, then translation. (Verified
    # against the golden ctraj.txt -> wtraj.txt FK pairs: row-major matches
    # Klampt's getTransform() to 4e-8; column-major is wrong by ~1.6 m.)
    R_parent = tp[:, :9].reshape(L, 3, 3)
    t_parent = tp[:, 9:12]

    qmin = _floats(first("qmin")) if first("qmin") else np.full(L, -np.inf)
    qmax = _floats(first("qmax")) if first("qmax") else np.full(L, np.inf)

    geometry = list(first("geometry") or [""] * L)
    geomscale = _floats(first("geomscale")) if first("geomscale") else None

    return RobModel(
        name=name or os.path.splitext(os.path.basename(path))[0],
        link_names=list(link_names),
        parents=parents,
        axes=axes,
        joint_types=joint_types,
        R_parent=R_parent,
        t_parent=t_parent,
        qmin=qmin,
        qmax=qmax,
        geometry=geometry,
        geomscale=geomscale,
        source_dir=os.path.dirname(os.path.abspath(path)),
    )


def load_off_vertices(path: str) -> np.ndarray:
    """Load vertex positions from an OFF mesh (collision-capsule fitting)."""
    with open(path) as f:
        header = f.readline().strip()
        if header != "OFF":
            # some files put counts on the same line as OFF
            if not header.startswith("OFF"):
                raise ValueError(f"not an OFF file: {path}")
            counts = header[3:].split()
        else:
            counts = f.readline().split()
        n_verts = int(counts[0])
        verts = np.loadtxt(f, max_rows=n_verts, dtype=np.float64)
    return verts[:, :3]
