"""The port's measurement tools, beside ``reconplan_tpu_torch.bench``.

Each keeps the name, the arguments and the output (lines and JSON keys)
of its counterpart in the repo's ``benchmarks/`` folder, and runs as
``python -m reconplan_tpu_torch.benchmarks.<name>``. ``--device`` (or
``device=`` of ``main``) takes the place of ``--platform``: by default
the CUDA card, which must be there (a run never falls back to the CPU);
``--device cpu`` asks for the CPU. Each output names the device it ran
on: ``nvidia-smi``'s name and power limit of the card, or ``cpu``.

Kernel tools (need the card; exit nonzero without one):

* ``profile_brick``: the bench scene's time split by stage, and the
  ablation arms of K1.
* ``probe_sublane_ops``: the depth-sampling microprobe (K6).

Benchmarks (BASELINE.json configs):

* ``bench_fusion``: the banana orbit fused at 256^3 and 512^3 (K2, K1):
  frames/s, active bricks, triangles, Chamfer.
* ``bench_grr``: a UR10 rot_free roadmap built into a temporary
  directory, the 500-waypoint scan arc solved, 16 pictures fused at
  256^3 (K2, K1), Chamfer.
* ``bench_stitch``: the pose-seeded and pose-free ICP stitch of a
  four-arc orbit over a tabletop.
* ``bench_poisson``: Poisson of 60k banana surface samples, Chamfer.
* ``bench_nn``: exact ``se3_knn`` over 1M SE3 points against sklearn's
  ``BallTree``.
* ``bench_teleop``: the four-arm teleop trajectory-quality benchmark.

Diagnostics (read-only):

* ``diag_posefree``: the pose-free stitch's per-frame pose error.
* ``eval_poisson_fidelity``: the exact analytic residual of the three
  Poisson variants, and the banana Chamfer.
* ``eval_scan_coverage``: where a scan mesh's gt -> mesh error lies, by
  height and azimuth.
* ``dtw_gap``: GRR's DTW deficit with and without the greedy re-seed
  (``--out`` refuses the committed ``benchmarks/results/``).

Roadmap writers (``--out`` required; a folder under the committed
``graph/`` is refused):

* ``expand_coverage``: census, island seeding, re-expansion, repair.
* ``refine_roadmap``: smooth, repair and anneal to 0% disconnection.
"""

import os

import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_label(device) -> str:
    """The ``"device"`` field of a tool's output: ``nvidia-smi``'s name
    and power limit of the card (every time stands beside it), or
    ``"cpu"``."""
    if torch.device(device).type == "cpu":
        return "cpu"
    from reconplan_tpu_torch.utils.device import card_summary

    return card_summary()


def sync(device):
    """Wait for ``device``'s queued work: a host clock read after it
    times the work, not its enqueue."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def refuse_under(path, *folders):
    """Raise when ``path`` lies in one of the repo's ``folders`` (relative
    to the repo's root): a tool's output never rewrites a committed
    roadmap or table."""
    real = os.path.realpath(path)
    for folder in folders:
        root = os.path.realpath(os.path.join(REPO, folder))
        if os.path.commonpath([real, root]) == root:
            raise ValueError(f"{path} lies under the committed {folder}/; "
                             "write elsewhere")
