"""Host-side visualization exports.

Port of ``reconplan_tpu.viz``: self-contained interactive HTML viewers
(:mod:`html_export`), the pointer-teleop HTTP bridge
(:mod:`teleop_server`) and PNG plots (:mod:`plots`). Divergence: the JAX
package imports ``plots`` (and so matplotlib) with the package; here
``plots`` is imported only where it is used
(``from reconplan_tpu_torch.viz.plots import plot_workspace_graph``),
and matplotlib inside its functions.
"""

from reconplan_tpu_torch.viz.html_export import (
    export_cloud_html,
    export_mesh_html,
    export_roadmap_html,
)

__all__ = [
    "export_cloud_html",
    "export_mesh_html",
    "export_roadmap_html",
]
