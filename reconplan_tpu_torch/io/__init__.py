"""Frame sets, mesh IO and the splat renderer."""

from reconplan_tpu_torch.io.frames import FrameSet
from reconplan_tpu_torch.io.meshio import load_mesh, sample_mesh_surface
from reconplan_tpu_torch.io.render import (
    SplatCamera,
    camera_look_at,
    splat_depth_color,
)

__all__ = [
    "FrameSet",
    "SplatCamera",
    "camera_look_at",
    "load_mesh",
    "sample_mesh_surface",
    "splat_depth_color",
]
