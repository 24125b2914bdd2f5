"""Expansion-GRR: global redundancy resolution.

Port of ``reconplan_tpu.grr``:
  - :mod:`workspace`          sampled workspace graph (arrays + dense NN)
  - :mod:`solver`             BFS expansion in batched IK waves
  - :mod:`resolution`         the online API: solve / solve_batch /
                              teleop_solve / plan
  - :mod:`paths`              Cartesian path generators
  - :mod:`quality`            roadmap quality metrics and census
  - :mod:`nearest_neighbors`  the GNAT interface over dense top-k
  - :mod:`experiment`         trajectory generation, the per-trajectory
                              teleop solvers and their metrics
  - :mod:`teleop_batch`       the teleop benchmark with the ticks of all
                              trajectories batched

Roadmaps are flat arrays checkpointed as .npz (``io.checkpoint``); the
JAX package's files load as they are.
"""

from reconplan_tpu_torch.grr import nearest_neighbors
from reconplan_tpu_torch.grr.paths import (
    arc_interpolate,
    get_arc_path,
    get_linear_path,
    linear_interpolate,
    scan_arc,
)
from reconplan_tpu_torch.grr.quality import (
    census_reachability,
    evaluate_roadmap,
)
from reconplan_tpu_torch.grr.resolution import RedundancyResolution
from reconplan_tpu_torch.grr.solver import ExpansionSolver
from reconplan_tpu_torch.grr.workspace import RoadmapWorkspace
from reconplan_tpu_torch.grr import experiment

__all__ = [
    "RoadmapWorkspace",
    "ExpansionSolver",
    "RedundancyResolution",
    "arc_interpolate",
    "census_reachability",
    "evaluate_roadmap",
    "experiment",
    "get_arc_path",
    "get_linear_path",
    "linear_interpolate",
    "nearest_neighbors",
    "scan_arc",
]
