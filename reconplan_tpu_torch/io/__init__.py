"""Frame sets and feeds, mesh IO, problem configs, roadmap checkpoints and
the splat renderer."""

from reconplan_tpu_torch.io.checkpoint import (
    load_roadmap_npz,
    save_roadmap_npz,
)
from reconplan_tpu_torch.io.config import load_problem, safe_eval
from reconplan_tpu_torch.io.frames import (
    ArrayFrameFeed,
    DirectoryFrameFeed,
    FrameSet,
    load_rgbd_folder,
)
from reconplan_tpu_torch.io.meshio import (
    load_mesh,
    sample_mesh_surface,
    save_ply,
)
from reconplan_tpu_torch.io.render import (
    SplatCamera,
    camera_look_at,
    splat_depth_color,
)

__all__ = [
    "ArrayFrameFeed",
    "DirectoryFrameFeed",
    "FrameSet",
    "SplatCamera",
    "camera_look_at",
    "load_mesh",
    "load_problem",
    "load_rgbd_folder",
    "load_roadmap_npz",
    "safe_eval",
    "sample_mesh_surface",
    "save_ply",
    "save_roadmap_npz",
    "splat_depth_color",
]
