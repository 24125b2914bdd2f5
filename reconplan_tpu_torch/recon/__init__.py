"""Reconstruction pipelines: stitching, TSDF fusion, Poisson, metrics."""

from reconplan_tpu_torch.recon.metrics import chamfer_distance, chamfer_to_mesh
from reconplan_tpu_torch.recon.stitcher import RGBDStitcher
from reconplan_tpu_torch.recon.fusion import FusionPipeline, fuse_frameset
from reconplan_tpu_torch.recon.poisson import poisson_reconstruct

__all__ = [
    "chamfer_distance",
    "chamfer_to_mesh",
    "RGBDStitcher",
    "FusionPipeline",
    "fuse_frameset",
    "poisson_reconstruct",
]
