"""Map checkpoint / resume: the whole map store in one compressed npz.

Port of ``orb_line_slam_tpu/slam_map/checkpoint.py:20-68``, numpy as
there: the same ``_ARRAYS``, ``_LINE_ARRAYS`` and scalar keys (``_next_kf``,
the three free lists, ``_caps``), so that a file written by either
package's ``save_map`` loads in the other's ``load_map``.  The reference
persists only trajectories (System::SaveTrajectory*); here the SoA map
store is the state (no pointer graph to walk), which allows
relocalization-only runs against a prebuilt map and the restart of long
global-BA jobs.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..config import MapConfig
from .map_store import MapStore

_ARRAYS = [
    "kf_valid", "kf_R", "kf_t", "kf_frame_id", "kf_timestamp", "kf_parent",
    "kf_xy", "kf_ur", "kf_depth", "kf_oct", "kf_angle", "kf_desc",
    "kf_feat_valid", "kf_obs_lm", "kf_gen",
    "pt_valid", "pt_pos", "pt_desc", "pt_normal", "pt_min_dist",
    "pt_max_dist", "pt_oct", "pt_first_kf", "pt_visible", "pt_found",
    "pt_gen",
    "ln_valid", "ln_start", "ln_end", "ln_desc", "ln_first_kf",
    "ln_visible", "ln_found", "ln_gen",
]
_LINE_ARRAYS = ["kf_ln_p0", "kf_ln_p1", "kf_ln_desc", "kf_ln_valid", "kf_ln_obs"]


def save_map(store: MapStore, path: str | Path) -> None:
    data = {name: getattr(store, name) for name in _ARRAYS}
    if store.Lf:
        data.update({name: getattr(store, name) for name in _LINE_ARRAYS})
    data["_next_kf"] = np.asarray(store._next_kf)
    data["_free_pts"] = np.asarray(store._free_pts, np.int64)
    data["_free_lines"] = np.asarray(store._free_lines, np.int64)
    data["_free_kfs"] = np.asarray(store._free_kfs, np.int64)
    data["_caps"] = np.asarray(
        [store.K, store.P, store.F, store.L, store.Lf], np.int64
    )
    np.savez_compressed(path, **data)


def load_map(path: str | Path) -> MapStore:
    z = np.load(path)
    K, P, F, L, Lf = (int(v) for v in z["_caps"])
    cfg = MapConfig(max_keyframes=K, max_points=P, max_lines=L)
    store = MapStore(cfg, F, n_lines=Lf)
    # Arrays absent from older checkpoints keep their constructor
    # defaults (kf_parent=-1, counters 0): forward-compatible load.
    for name in _ARRAYS:
        if name in z.files:
            getattr(store, name)[...] = z[name]
    if Lf:
        for name in _LINE_ARRAYS:
            if name in z.files:
                getattr(store, name)[...] = z[name]
    store._next_kf = int(z["_next_kf"])
    store._free_pts = [int(i) for i in z["_free_pts"]]
    store._free_lines = [int(i) for i in z["_free_lines"]]
    if "_free_kfs" in z.files:
        store._free_kfs = [int(i) for i in z["_free_kfs"]]
    store.mark_all_pts_dirty()
    store.touch_obs()
    return store
