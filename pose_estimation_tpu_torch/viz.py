"""Offline trajectory and landmark plots.

Counterpart of `pose_estimation_tpu/viz.py`, a copy (csv and numpy;
matplotlib imported by the plotting functions): the offline stand-in for
the reference's Pangolin viewer thread (`src/viewer.cpp`: raw and
optimized trajectories, pose, landmark cloud), drawn from `states.csv` or
arrays in memory.
"""

from __future__ import annotations

import csv

import numpy as np


def load_states_csv(path: str) -> dict:
    """Parse a states.csv written by `VisualInertialSLAM.save_results`."""
    with open(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        rows = np.array([[float(v) for v in r] for r in reader])
    cols = {name: i for i, name in enumerate(header)}
    return {
        "ts": rows[:, cols["timestamp"]],
        "q": rows[:, cols["qw"] : cols["qz"] + 1],
        "p": rows[:, cols["px"] : cols["pz"] + 1],
        "v": rows[:, cols["vx"] : cols["vz"] + 1],
        "bg": rows[:, cols["bgx"] : cols["bgz"] + 1],
        "ba": rows[:, cols["bax"] : cols["baz"] + 1],
    }


def plot_trajectory(
    est: np.ndarray,
    gt: np.ndarray | None = None,
    landmarks: np.ndarray | None = None,
    out_path: str = "trajectory.png",
    title: str = "trajectory",
):
    """est/gt: [N, 4] (ts, x, y, z); landmarks: [L, 3]. Writes a 2-panel
    figure (top-down + altitude profile)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    ax1.plot(est[:, 2], est[:, 3], "-", label="estimate", lw=1.5)
    if gt is not None and len(gt):
        ax1.plot(gt[:, 2], gt[:, 3], "--", label="ground truth", lw=1.0)
    if landmarks is not None and len(landmarks):
        ax1.scatter(landmarks[:, 1], landmarks[:, 2], s=2, alpha=0.3,
                    label="landmarks")
    ax1.set_xlabel("y [m]")
    ax1.set_ylabel("z [m]")
    ax1.set_title(title)
    ax1.axis("equal")
    ax1.legend()

    t0 = est[0, 0]
    ax2.plot((est[:, 0] - t0) / 1e9, est[:, 1], label="x (est)")
    if gt is not None and len(gt):
        ax2.plot((gt[:, 0] - t0) / 1e9, gt[:, 1], "--", label="x (gt)")
    ax2.set_xlabel("t [s]")
    ax2.set_ylabel("x [m]")
    ax2.legend()

    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def project_points(
    pos_w: np.ndarray,
    R_wb: np.ndarray, p_wb: np.ndarray,
    r_cb: np.ndarray, p_cb: np.ndarray,
    fx: float, fy: float, cx: float, cy: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Project world landmarks into the (rectified) left camera.

    Returns (px [L, 2], in_front [L]). Same chain the BA reprojection
    residual uses: X_cam = R_cb (R_wb^T (X - p)) + p_cb."""
    x_body = (pos_w - p_wb[None]) @ R_wb  # R_wb^T X, row-vector form
    x_cam = x_body @ np.asarray(r_cb).T + np.asarray(p_cb)[None]
    z = x_cam[:, 2]
    in_front = z > 1e-6
    zs = np.where(in_front, z, 1.0)
    px = np.stack([fx * x_cam[:, 0] / zs + cx, fy * x_cam[:, 1] / zs + cy], -1)
    return px, in_front


def plot_ba_overlay(
    img: np.ndarray,
    obs_px: np.ndarray,        # [L, 2] measured pixels (current frame)
    before_px: np.ndarray,     # [L, 2] landmark reprojections pre-solve
    after_px: np.ndarray,      # [L, 2] reprojections post-solve
    valid: np.ndarray,         # [L]
    out_path: str = "ba_overlay.png",
):
    """Before/after BA reprojection overlay — the offline analog of the
    reference's primary BA debugging view (`optimizer.cpp:140-180`, which
    cv::circle's measured vs reprojected points on the live frame)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    v = np.asarray(valid, bool)
    fig, ax = plt.subplots(figsize=(10, 7))
    ax.imshow(np.asarray(img), cmap="gray", vmin=0, vmax=255)
    o, b, a = obs_px[v], before_px[v], after_px[v]
    for pp, qq in zip(o, a):
        ax.plot([pp[0], qq[0]], [pp[1], qq[1]], "-", color="tab:blue",
                lw=0.8, alpha=0.6)
    ax.scatter(o[:, 0], o[:, 1], s=26, facecolors="none",
               edgecolors="tab:green", label="measured")
    ax.scatter(b[:, 0], b[:, 1], s=18, marker="x", color="tab:red",
               label="reprojected (pre-solve)")
    ax.scatter(a[:, 0], a[:, 1], s=18, marker="+", color="tab:blue",
               label="reprojected (post-solve)")
    err_b = np.linalg.norm(b - o, axis=1)
    err_a = np.linalg.norm(a - o, axis=1)
    ax.set_title(
        f"BA reprojection: mean err {err_b.mean():.2f}px -> {err_a.mean():.2f}px"
        f"  (n={v.sum()})"
    )
    ax.legend(loc="upper right")
    ax.set_xlim(0, img.shape[1])
    ax.set_ylim(img.shape[0], 0)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path


def plot_states(states: dict, out_path: str = "states.png"):
    """Velocity and bias time series from a parsed states.csv."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t = (states["ts"] - states["ts"][0]) / 1e9
    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True)
    for i, lbl in enumerate("xyz"):
        axes[0].plot(t, states["v"][:, i], label=f"v{lbl}")
        axes[1].plot(t, states["bg"][:, i], label=f"bg{lbl}")
        axes[2].plot(t, states["ba"][:, i], label=f"ba{lbl}")
    axes[0].set_ylabel("velocity [m/s]")
    axes[1].set_ylabel("gyro bias [rad/s]")
    axes[2].set_ylabel("accel bias [m/s^2]")
    axes[2].set_xlabel("t [s]")
    for ax in axes:
        ax.legend(ncol=3, fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)
    return out_path
