"""Offline map/trajectory visualization + structured metrics.

Port of ``orb_line_slam_tpu/eval/viewer.py`` (numpy; matplotlib and cv2
imported lazily).  Replaces the reference's Pangolin
Viewer/FrameDrawer/MapDrawer threads (src/{Viewer,FrameDrawer,MapDrawer}.cc,
SURVEY.md §2.1 row 20, §5 observability) with offline artifacts for
headless runs: a matplotlib map/trajectory figure, a per-frame overlay
image, and a CSV metrics dump (inliers, state, timing) instead of the
live GL view.  A frame's ``xy`` and ``valid`` may be tensors on any
device: they are copied to the host.
"""

from __future__ import annotations

import csv

import numpy as np


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else np.asarray(a)


def save_map_figure(store, trajectory, path, lines: bool = True):
    """Top-down (x-z) view of landmarks, keyframes and the trajectory."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 8))
    pts = store.pt_pos[store.pt_valid]
    if len(pts):
        ax.scatter(pts[:, 0], pts[:, 2], s=1, c="#888888", label="map points")
    if lines and store.ln_valid.any():
        for s, e in zip(store.ln_start[store.ln_valid], store.ln_end[store.ln_valid]):
            ax.plot([s[0], e[0]], [s[2], e[2]], c="#cc4444", lw=0.8)
    kf_centers = []
    for k in np.nonzero(store.kf_valid[: store._next_kf])[0]:
        kf_centers.append(-store.kf_R[k].T @ store.kf_t[k])
    if kf_centers:
        kc = np.stack(kf_centers)
        ax.scatter(kc[:, 0], kc[:, 2], s=18, c="#2255cc", marker="s",
                   label="keyframes")
    if trajectory:
        centers = np.stack([-R.T @ t for (_, _, R, t, _) in trajectory])
        ax.plot(centers[:, 0], centers[:, 2], c="#11aa55", lw=1.5,
                label="trajectory")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.set_aspect("equal")
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    plt.close(fig)


def draw_frame_overlay(img, frame, assoc, path=None):
    """Current-frame overlay: tracked features green, untracked red
    (FrameDrawer analog). Returns the BGR image; writes it if `path`."""
    import cv2

    vis = cv2.cvtColor(_host(img), cv2.COLOR_GRAY2BGR)
    xy = _host(frame.xy)
    valid = _host(frame.valid)
    assoc = None if assoc is None else _host(assoc)
    for i in np.nonzero(valid)[0]:
        p = (int(xy[i, 0]), int(xy[i, 1]))
        color = (0, 200, 0) if assoc is not None and assoc[i] >= 0 else (0, 0, 220)
        cv2.circle(vis, p, 2, color, -1)
    if path is not None:
        cv2.imwrite(str(path), vis)
    return vis


def save_metrics_csv(stats: list[dict], path):
    """Per-frame structured metrics (the cout-replacement)."""
    if not stats:
        return
    keys = sorted({k for s in stats for k in s})
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=keys)
        w.writeheader()
        for s in stats:
            w.writerow(s)
