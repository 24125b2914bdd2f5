"""On-card measurement tools of the port, beside ``reconplan_tpu_torch.bench``.

* :mod:`~reconplan_tpu_torch.benchmarks.profile_brick`: the bench scene's
  time split by stage, and the ablation arms of K1
  (``python -m reconplan_tpu_torch.benchmarks.profile_brick``).
* :mod:`~reconplan_tpu_torch.benchmarks.probe_sublane_ops`: the
  depth-sampling microprobe
  (``python -m reconplan_tpu_torch.benchmarks.probe_sublane_ops``).
* :mod:`~reconplan_tpu_torch.benchmarks.bench_teleop`: the four-arm teleop
  trajectory-quality benchmark
  (``python -m reconplan_tpu_torch.benchmarks.bench_teleop``).

Each keeps the name of its counterpart in the repo's ``benchmarks/``
folder. The first two need a CUDA card and exit nonzero without one;
``bench_teleop`` runs on the card unless ``--device cpu`` is given.
"""
