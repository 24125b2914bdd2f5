"""Application entry points, mirroring the JAX package's CLIs:

  python -m reconplan_tpu_torch.apps.redundancy ur10 rot_variable_yaw
      build a GRR roadmap (reference: ``python redundancy.py ...``)
  python -m reconplan_tpu_torch.apps.scan
      the scan-plan-capture-reconstruct loop (reference: ``python main.py``)
  python -m reconplan_tpu_torch.apps.stitch <capture_dir>
      stitch a recorded RGBD capture (reference: ``python stitcher.py``)

Each takes ``--device`` (default: the card).
"""
