"""Headless matplotlib exports for roadmaps and trajectories.

Port of ``reconplan_tpu.viz.plots`` (numpy in, PNG out). Divergence: the
JAX module imports matplotlib (Agg backend) when it is imported, and the
JAX ``viz`` package imports it eagerly; here matplotlib is imported inside
each function, and ``reconplan_tpu_torch.viz`` does not import this
module, so the package and every entry point import on a machine without
matplotlib.
"""

from __future__ import annotations

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the headless Agg backend."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_workspace_graph(workspace, path=None, show_edges=True):
    """3D scatter of workspace nodes + edges
    (``grr/workspace.py:460-481`` equivalent, saved to PNG)."""
    plt = _pyplot()
    pts = np.asarray(workspace.points)[:, :3]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(*pts.T, s=8, c="g", edgecolors="w", linewidths=0.2)
    if show_edges and len(workspace.edges):
        for i, j in workspace.edges:
            seg = pts[[int(i), int(j)]]
            ax.plot(*seg.T, color="y", linewidth=0.5)
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    ax.grid(True)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_roadmap_disconnections(resolution, path=None):
    """Roadmap with connected edges in green and disconnected boundaries in
    red (the information the Klampt GUI rendered,
    ``klampt_vis.py:60-153``)."""
    plt = _pyplot()
    solver = resolution.solver
    ws = solver.workspace
    pts = np.asarray(ws.points)[:, :3]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    configured = solver.has_config
    ax.scatter(*pts[configured].T, s=8, c="g")
    if (~configured).any():
        ax.scatter(*pts[~configured].T, s=8, c="0.6")
    for e, (i, j) in enumerate(ws.edges):
        if not (configured[i] and configured[j]):
            continue
        seg = pts[[int(i), int(j)]]
        color = "g" if solver.edge_connected[e] else "r"
        lw = 0.5 if solver.edge_connected[e] else 1.5
        ax.plot(*seg.T, color=color, linewidth=lw)
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_trajectory_tracking(target_traj, achieved_traj, path=None):
    """Input vs achieved workspace trajectories (the experiment
    visualizers, ``experiment/visualize_trajectory*.py`` equivalent)."""
    plt = _pyplot()
    t = np.asarray(target_traj)[:, :3]
    a = np.asarray(achieved_traj)[:, :3]
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(*t.T, "b-", label="target")
    ax.plot(*a.T, "r--", label="achieved")
    ax.legend()
    ax.set_xlabel("X"); ax.set_ylabel("Y"); ax.set_zlabel("Z")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
