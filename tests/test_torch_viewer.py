"""The port's offline viewer (eval/viewer.py): tests/test_aux_subsystems.py
TestViewer's artifacts from the port's map store, held to the JAX
package's viewer on the same inputs (the overlay pixel for pixel, the CSV
byte for byte), and the overlay of a frame whose arrays are tensors."""

import numpy as np
import torch

from orb_line_slam_tpu.eval import viewer as jax_viewer
from orb_line_slam_tpu_torch.config import MapConfig
from orb_line_slam_tpu_torch.eval.viewer import draw_frame_overlay, save_map_figure, save_metrics_csv
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore


class _FakeFrame:
    def __init__(self, n, rng):
        self.xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
        self.u_right = rng.uniform(-1, 100, n).astype(np.float32)
        self.depth = rng.uniform(-1, 30, n).astype(np.float32)
        self.octave = rng.integers(0, 4, n).astype(np.int32)
        self.angle = rng.uniform(0, 6, n).astype(np.float32)
        self.desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        self.valid = np.ones(n, bool)


def make_store():
    """tests/test_aux_subsystems.py::make_store on the port's MapStore."""
    rng = np.random.default_rng(0)
    store = MapStore(MapConfig(max_keyframes=8, max_points=256, max_lines=16), 64, n_lines=8)
    f = _FakeFrame(64, rng)
    kf = store.add_keyframe(f, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0)
    store.add_points(rng.normal(size=(20, 3)).astype(np.float32), rng.integers(0, 256, (20, 32), dtype=np.uint8),
                     np.zeros(20, np.int32), kf, np.arange(20))
    store.add_lines(rng.normal(size=(4, 3)).astype(np.float32), rng.normal(size=(4, 3)).astype(np.float32),
                    rng.integers(0, 256, (4, 32), dtype=np.uint8), kf, np.arange(4))
    return store


def test_artifacts(tmp_path):
    store = make_store()
    traj = [(0, 0.0, np.eye(3), np.zeros(3), False), (1, 0.1, np.eye(3), np.array([0.0, 0.0, -0.5]), False)]
    fig = tmp_path / "map.png"
    save_map_figure(store, traj, fig)
    assert fig.stat().st_size > 5000
    jfig = tmp_path / "jax_map.png"
    jax_viewer.save_map_figure(store, traj, jfig)
    assert jfig.stat().st_size > 5000

    rng = np.random.default_rng(1)
    f = _FakeFrame(64, rng)
    img = rng.integers(0, 255, (320, 640), dtype=np.uint8)
    assoc = np.where(np.arange(64) % 3 == 0, 5, -1)
    ov = tmp_path / "overlay.png"
    vis = draw_frame_overlay(img, f, np.full(64, -1), ov)
    assert ov.stat().st_size > 5000
    np.testing.assert_array_equal(vis, jax_viewer.draw_frame_overlay(img, f, np.full(64, -1)))
    vis = draw_frame_overlay(img, f, assoc)
    np.testing.assert_array_equal(vis, jax_viewer.draw_frame_overlay(img, f, assoc))
    assert (vis[..., 1] == 200).any() and (vis[..., 2] == 220).any()   # tracked green, untracked red

    # A frame of the port holds tensors: they are read on the host.
    tf = _FakeFrame(64, np.random.default_rng(1))
    tf.xy, tf.valid = torch.from_numpy(f.xy), torch.from_numpy(f.valid)
    np.testing.assert_array_equal(draw_frame_overlay(torch.from_numpy(img), tf, torch.from_numpy(assoc)), vis)

    stats = [{"frame": 0, "inliers": 12}, {"frame": 1, "inliers": 40, "state": "OK"}]
    csvp, jcsv = tmp_path / "metrics.csv", tmp_path / "jax_metrics.csv"
    save_metrics_csv(stats, csvp)
    jax_viewer.save_metrics_csv(stats, jcsv)
    assert "inliers" in csvp.read_text()
    assert csvp.read_bytes() == jcsv.read_bytes()
    save_metrics_csv([], tmp_path / "none.csv")
    assert not (tmp_path / "none.csv").exists()
