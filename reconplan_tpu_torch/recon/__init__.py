"""Fusion pipeline and Chamfer metrics."""

from reconplan_tpu_torch.recon.fusion import FusionPipeline, fuse_frameset
from reconplan_tpu_torch.recon.metrics import chamfer_distance, chamfer_to_mesh

__all__ = [
    "FusionPipeline",
    "chamfer_distance",
    "chamfer_to_mesh",
    "fuse_frameset",
]
