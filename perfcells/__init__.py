"""perfcells: the benchmark of ``reconplan_tpu_torch`` on one CUDA card.

One command runs one cell once and prints one JSON line:

    python3 -m perfcells.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own, found by the name in ``BENCHMARK.json``:

- ``configs/<config>.json``: a deployment, with its source and the sizes
  it fixes;
- ``cells/<cell>.json``: the traffic mix, and the driver that runs it;
- ``drivers/<driver>.py``: ``setup``, ``window``, ``release`` and
  ``judge`` of one kind of cell;
- ``metrics/<metric>.py``: a reader ``read(ctx)`` of one per-layer metric.

The yardstick lives here too: the frozen traffic generators
(``traffic/``), the plain references that decide ``correct``
(``reference/``), the profiler reduction (``trace.py``) and the table of
peaks (``peaks.py``). From the port the benchmark takes only the system
under test. Nothing here imports ``jax`` or the JAX package.
"""
