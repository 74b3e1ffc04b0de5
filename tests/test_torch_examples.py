"""The port's example drivers (orb_line_slam_tpu_torch/examples/), each
run as ``python -m orb_line_slam_tpu_torch.examples.<driver> SETTINGS SEQ
--device cpu`` in a subprocess on a sequence folder the test writes with
cv2 (KITTI, EuRoC and TUM layouts; 6 frames of a synthetic scene from the
port's renderer) and a small settings YAML: each exits 0 and writes one
trajectory row per tracked frame (the monocular drivers, as the
reference's, one per keyframe)."""

import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest

from orb_line_slam_tpu_torch.config import CameraIntrinsics
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene

REPO = Path(__file__).resolve().parents[1]
N = 6
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
SETTINGS = """%YAML:1.0
Camera.fx: 400.0
Camera.fy: 400.0
Camera.cx: 320.0
Camera.cy: 160.0
Camera.bf: 160.0
Camera.width: 640
Camera.height: 320
Camera.fps: 10.0
ThDepth: 35
DepthMapFactor: 5000.0
ORBextractor.nFeatures: 512
ORBextractor.nLevels: 3
ORBextractor.scaleFactor: 1.2
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""


def _poses():
    """Forward with a sideways drift: parallax for the monocular initializer."""
    return [(np.eye(3), -np.array([0.12 * i, 0.0, 0.2 * i])) for i in range(N)]


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """KITTI (image_0/1, times.txt), EuRoC (mav0/cam0|cam1/data/<ns>.png)
    and TUM (rgb/, depth/, rgb.txt, depth.txt) folders of the same frames."""
    root = tmp_path_factory.mktemp("sequences")
    # Every point within 13.1 m, where uint16 depth at factor 5000 saturates.
    scene = SyntheticScene(CAM, n_points=600, n_lines=24, seed=12, extent=((-8, 8), (-4, 4), (5, 12)))
    kitti, mav0, tum = root / "kitti", root / "mav0", root / "tum"
    for d in (kitti / "image_0", kitti / "image_1", mav0 / "cam0" / "data", mav0 / "cam1" / "data",
              tum / "rgb", tum / "depth"):
        d.mkdir(parents=True)
    rgb_rows, depth_rows = ["# rgb"], ["# depth"]
    for i, (R, t) in enumerate(_poses()):
        l, r = scene.render_stereo(R, t)
        img, depth = scene.render_rgbd(R, t)
        cv2.imwrite(str(kitti / "image_0" / f"{i:06d}.png"), l)
        cv2.imwrite(str(kitti / "image_1" / f"{i:06d}.png"), r)
        ns = 1403636579763555584 + 100_000_000 * i
        cv2.imwrite(str(mav0 / "cam0" / "data" / f"{ns}.png"), l)
        cv2.imwrite(str(mav0 / "cam1" / "data" / f"{ns}.png"), r)
        ts = 10.0 + 0.1 * i
        cv2.imwrite(str(tum / "rgb" / f"{ts:.6f}.png"), img)
        cv2.imwrite(str(tum / "depth" / f"{ts + 0.004:.6f}.png"), (depth * 5000.0).astype(np.uint16))
        rgb_rows.append(f"{ts:.6f} rgb/{ts:.6f}.png")
        depth_rows.append(f"{ts + 0.004:.6f} depth/{ts + 0.004:.6f}.png")
    np.savetxt(kitti / "times.txt", 0.1 * np.arange(N))
    (tum / "rgb.txt").write_text("\n".join(rgb_rows) + "\n")
    (tum / "depth.txt").write_text("\n".join(depth_rows) + "\n")
    settings = root / "settings.yaml"
    settings.write_text(SETTINGS)
    return {"kitti": kitti, "euroc": mav0, "tum": tum, "settings": settings}


@pytest.mark.parametrize("driver, data, fmt", [
    ("stereo_kitti", "kitti", "kitti"),
    ("stereo_euroc", "euroc", "tum"),
    ("rgbd_tum", "tum", "tum"),
    ("mono_kitti", "kitti", "keyframes"),
    ("mono_euroc", "euroc", "keyframes"),
    ("mono_tum", "tum", "keyframes"),
])
def test_driver(folders, tmp_path, driver, data, fmt):
    out = tmp_path / "trajectory.txt"
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    proc = subprocess.run(
        [sys.executable, "-m", f"orb_line_slam_tpu_torch.examples.{driver}", str(folders["settings"]),
         str(folders[data]), "--out", str(out), "--device", "cpu", "--max-frames", str(N)],
        capture_output=True, text=True, timeout=600, env=env, cwd=str(REPO),
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-3000:]
    assert "tracking time: median" in proc.stdout and f"written to {out}" in proc.stdout
    rows = np.loadtxt(out, ndmin=2)
    truth = np.stack([-R.T @ t for (R, t) in _poses()])
    if fmt == "keyframes":
        # Initialised: the two-view pair and any later keyframes, in TUM
        # format (timestamp, position, quaternion), scale-free.
        assert rows.shape[1] == 8 and 2 <= len(rows) <= N, rows
        assert np.isfinite(rows).all()
        return
    assert len(rows) == N, rows
    centres = rows[:, [3, 7, 11]] if fmt == "kitti" else rows[:, 1:4]
    assert rows.shape[1] == (12 if fmt == "kitti" else 8)
    # The stereo and RGB-D drivers recover the metric motion.
    assert np.abs(centres - truth).max() < 0.05, centres
