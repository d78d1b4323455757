"""Centerline / parse-map renders without VTK.

The reference renders branch centerlines and colored parse maps with
pyvista (reference ours_skel_parse.py:1047-1204 `sub_model` /
`show_line1`, tree_parsing.py drivers). VTK is not available in this
environment; these matplotlib equivalents emit the same artifacts
(`*_line.png` per-branch-colored 3-D centerlines, `*_parse.png`
scatter of the parse map, `*_parse.gif` rotating view).

A copy of the JAX package's `post/render.py`; matplotlib is imported
when a figure is drawn, so a host without it runs everything else.
"""

from __future__ import annotations

import numpy as np


def _colors(n: int):
    import matplotlib

    matplotlib.use("Agg")
    cmap = matplotlib.colormaps["tab20"]
    return [cmap(i % 20) for i in range(n)]


def render_centerlines(branches, path: str, title: str = ""):
    """Per-branch colored 3-D centerline plot (show_line1 analog)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    colors = _colors(len(branches))
    for b, c in zip(branches, colors):
        pts = np.asarray(b.points() if hasattr(b, "points") else b, np.float64)
        if pts.size == 0:
            continue
        ax.plot(pts[:, 1], pts[:, 2], pts[:, 0], color=c, linewidth=1.0)
    ax.set_title(title or f"{len(branches)} branches")
    ax.set_axis_off()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def render_parse_map(parse: np.ndarray, path: str, max_points: int = 120_000,
                     gif_path: str | None = None, seed: int = 0):
    """Colored voxel scatter of a branch-id map (sub_model render
    analog); optional rotating GIF."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx = np.argwhere(parse > 0)
    if len(idx) == 0:
        return
    if len(idx) > max_points:
        sel = np.random.default_rng(seed).choice(len(idx), max_points, replace=False)
        idx = idx[sel]
    ids = parse[idx[:, 0], idx[:, 1], idx[:, 2]].astype(int)
    colors = np.asarray(_colors(int(ids.max()) + 1))
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(idx[:, 1], idx[:, 2], idx[:, 0], c=colors[ids % len(colors)],
               s=0.3, linewidths=0)
    ax.set_axis_off()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    if gif_path is not None:
        try:
            from matplotlib.animation import FuncAnimation, PillowWriter

            def rotate(angle):
                ax.view_init(elev=10, azim=angle)

            anim = FuncAnimation(fig, rotate, frames=range(0, 360, 30))
            anim.save(gif_path, writer=PillowWriter(fps=6))
        except Exception:
            pass  # GIF is best-effort
    plt.close(fig)
