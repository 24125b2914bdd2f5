"""Application entry points, mirroring the JAX package's CLIs:

  python -m reconplan_tpu_torch.apps.redundancy ur10 rot_variable_yaw
      build a GRR roadmap (reference: ``python redundancy.py ...``)
  python -m reconplan_tpu_torch.apps.scan
      the scan-plan-capture-reconstruct loop (reference: ``python main.py``)
  python -m reconplan_tpu_torch.apps.stitch <capture_dir>
      stitch a recorded RGBD capture (reference: ``python stitcher.py``)
  python -m reconplan_tpu_torch.apps.eval_roadmap ur10 rot_variable_yaw
      roadmap quality (reference: ``python experiment/roadmap_quality.py``)
  python -m reconplan_tpu_torch.apps.teleop [--mode rtde|grr|html]
      keyboard / joystick / browser teleop (reference:
      ``UR10_RTDE/examples/teleop_keyboard.py``)
  python -m reconplan_tpu_torch.apps.record [ctraj]
      drive the arm through a trajectory and record RGBD frames
      (reference: ``python data_recorder.py``)

Each takes ``--device`` (default: the card).
"""
