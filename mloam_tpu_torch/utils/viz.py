"""Offline visualization: trajectories and maps to PNG, maps to PCD. The
port's own copy of ``mloam_tpu/utils/viz.py`` (numpy in, files out; an
exported PCD is byte for byte the JAX package's). matplotlib is imported
inside each plot, so the package imports without it.

Headless counterpart of the reference's rviz outputs (paths, maps,
CameraPoseVisualization markers) and the PCL cloud_visualizer — matplotlib
figures written to disk instead of live topics.
"""

from __future__ import annotations

import numpy as np


def plot_trajectory(path_png: str, est_t: np.ndarray,
                    gt_t: np.ndarray | None = None,
                    loops: list[tuple[int, int]] | None = None,
                    title: str = "trajectory"):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(
        1, 2, figsize=(11, 5), gridspec_kw={"width_ratios": [2, 1]}
    )
    est_t = np.asarray(est_t)
    ax1.plot(est_t[:, 0], est_t[:, 1], "-", lw=1.5, label="estimate")
    if gt_t is not None:
        gt_t = np.asarray(gt_t)
        ax1.plot(gt_t[:, 0], gt_t[:, 1], "--", lw=1.0, label="ground truth")
    if loops:
        for i, j in loops:
            ax1.plot(est_t[[i, j], 0], est_t[[i, j], 1], "r-", lw=0.8)
    ax1.set_aspect("equal")
    ax1.set_xlabel("x [m]")
    ax1.set_ylabel("y [m]")
    ax1.legend()
    ax1.set_title(title)
    ax2.plot(est_t[:, 2], label="est z")
    if gt_t is not None:
        ax2.plot(gt_t[:, 2], "--", label="gt z")
    ax2.set_xlabel("frame")
    ax2.set_ylabel("z [m]")
    ax2.legend()
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def plot_map(path_png: str, xyz: np.ndarray, mask: np.ndarray | None = None,
             traj_t: np.ndarray | None = None, title: str = "map",
             max_points: int = 60000):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xyz = np.asarray(xyz)
    if mask is not None:
        xyz = xyz[np.asarray(mask)]
    if xyz.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(
            xyz.shape[0], max_points, replace=False
        )
        xyz = xyz[sel]
    fig, ax = plt.subplots(figsize=(9, 9))
    sc = ax.scatter(xyz[:, 0], xyz[:, 1], c=xyz[:, 2], s=0.5, cmap="viridis")
    if traj_t is not None:
        traj_t = np.asarray(traj_t)
        ax.plot(traj_t[:, 0], traj_t[:, 1], "r-", lw=1.5)
    ax.set_aspect("equal")
    fig.colorbar(sc, label="z [m]")
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def export_map_pcd(path: str, xyz: np.ndarray, mask: np.ndarray | None = None):
    """Write an ascii PCD (the reference's SIGINT map dump counterpart)."""
    xyz = np.asarray(xyz)
    if mask is not None:
        xyz = xyz[np.asarray(mask)]
    with open(path, "w") as f:
        f.write(
            "VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
            f"COUNT 1 1 1\nWIDTH {len(xyz)}\nHEIGHT 1\n"
            f"VIEWPOINT 0 0 0 1 0 0 0\nPOINTS {len(xyz)}\nDATA ascii\n"
        )
        for p in xyz:
            f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")


def plot_plane_normals(path_png: str, points: np.ndarray,
                       normals: np.ndarray, mask: np.ndarray | None = None,
                       stride: int = 8, title: str = "plane normals"):
    """Headless counterpart of the reference's PlaneNormalVisualizer
    (utility/cloud_visualizer.{h,cpp}: a PCL viewer thread drawing the
    correspondence plane normals): top-down scatter of the matched points
    with their fitted normals as arrows, written to PNG."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.asarray(points)
    normals = np.asarray(normals)
    if mask is not None:
        keep = np.asarray(mask).astype(bool)
        points, normals = points[keep], normals[keep]
    fig, ax = plt.subplots(figsize=(7, 7))
    ax.scatter(points[:, 0], points[:, 1], s=2, c=points[:, 2],
               cmap="viridis", alpha=0.6)
    sub = points[::stride], normals[::stride]
    ax.quiver(sub[0][:, 0], sub[0][:, 1], sub[1][:, 0], sub[1][:, 1],
              color="tab:red", width=0.002, scale=30)
    ax.set_aspect("equal")
    ax.set_title(title)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def plot_scan_context(path_png: str, descriptor: np.ndarray,
                      title: str = "scan context"):
    """Render a scan-context descriptor [rings, sectors] as an image —
    the headless counterpart of the reference's scan-context image topic
    (pose_graph.cpp:50 publishes the descriptor via cv_bridge)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    d = np.asarray(descriptor)
    fig, ax = plt.subplots(figsize=(8, 3))
    im = ax.imshow(d, aspect="auto", origin="lower", cmap="viridis")
    ax.set_xlabel("sector (azimuth bin)")
    ax.set_ylabel("ring (radial bin)")
    ax.set_title(title)
    fig.colorbar(im, ax=ax, label="max height [m]")
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)


def plot_pose_graph(path_png: str, node_t: np.ndarray,
                    loop_edges: list[tuple[int, int]] | None = None,
                    corrected_t: np.ndarray | None = None,
                    title: str = "pose graph"):
    """Pose-graph overview: sequential chain + loop edges (+ optionally the
    post-PGO corrected trajectory) — the CameraPoseVisualization rviz-marker
    counterpart (mloam_loop/src/utility/CameraPoseVisualization.cpp)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = np.asarray(node_t)
    fig, ax = plt.subplots(figsize=(7, 6))
    ax.plot(t[:, 0], t[:, 1], "o-", ms=2, lw=0.8, label="keyframes")
    for i, j in loop_edges or []:
        ax.plot(t[[i, j], 0], t[[i, j], 1], "r-", lw=1.2)
    if corrected_t is not None:
        c = np.asarray(corrected_t)
        ax.plot(c[:, 0], c[:, 1], "g--", lw=1.0, label="after PGO")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path_png, dpi=120)
    plt.close(fig)
