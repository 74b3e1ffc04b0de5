"""The port's KITTI and EuRoC loaders (data/kitti.py, data/euroc.py)
against the JAX package's, on sequence folders the tests write with cv2:
the same images, timestamps and ground truth.  The EuRoC pairs are
rectified with examples/configs/EuRoC.yaml's LEFT/RIGHT blocks."""

from pathlib import Path

import cv2
import numpy as np
import pytest

from orb_line_slam_tpu.config import load_settings as jax_load_settings
from orb_line_slam_tpu.data.euroc import EurocStereoSequence as JaxEuroc, load_euroc_gt as jax_euroc_gt
from orb_line_slam_tpu.data.kitti import KittiStereoSequence as JaxKitti, load_kitti_gt_poses as jax_kitti_gt
from orb_line_slam_tpu_torch.config import load_settings
from orb_line_slam_tpu_torch.data.euroc import EurocStereoSequence, load_euroc_gt
from orb_line_slam_tpu_torch.data.kitti import KittiStereoSequence, load_kitti_gt_poses

REPO = Path(__file__).resolve().parents[1]


def _noise_images(n, h, w, seed):
    rng = np.random.default_rng(seed)
    # Smooth texture, so that a rectification resample is not all aliasing.
    imgs = []
    for _ in range(n):
        small = rng.integers(0, 256, (h // 8, w // 8), dtype=np.uint8)
        imgs.append(cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR))
    return imgs


def write_kitti(d: Path, n=4, h=48, w=96, times=True):
    (d / "image_0").mkdir(parents=True)
    (d / "image_1").mkdir()
    lefts, rights = _noise_images(n, h, w, 1), _noise_images(n, h, w, 2)
    for i in range(n):
        cv2.imwrite(str(d / "image_0" / f"{i:06d}.png"), lefts[i])
        cv2.imwrite(str(d / "image_1" / f"{i:06d}.png"), rights[i])
    if times:
        np.savetxt(d / "times.txt", 0.103 * np.arange(n) + 1.5e-3)
    poses = np.random.default_rng(3).normal(size=(n, 12))
    np.savetxt(d / "poses.txt", poses)
    return lefts, rights, poses


def write_euroc(mav0: Path, n=3, h=480, w=752):
    for cam in ("cam0", "cam1"):
        (mav0 / cam / "data").mkdir(parents=True)
    stamps = [1403636579763555584 + 50_000_000 * i for i in range(n)]
    lefts, rights = _noise_images(n, h, w, 4), _noise_images(n, h, w, 5)
    for s, l, r in zip(stamps, lefts, rights):
        cv2.imwrite(str(mav0 / "cam0" / "data" / f"{s}.png"), l)
        cv2.imwrite(str(mav0 / "cam1" / "data" / f"{s}.png"), r)
    # A left image with no right partner is dropped.
    cv2.imwrite(str(mav0 / "cam0" / "data" / f"{stamps[-1] + 25_000_000}.png"), lefts[0])
    gt_dir = mav0 / "state_groundtruth_estimate0"
    gt_dir.mkdir()
    rows = np.column_stack([np.asarray(stamps, np.float64), np.random.default_rng(6).normal(size=(n, 7))])
    header = "#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z []"
    np.savetxt(gt_dir / "data.csv", rows, delimiter=",", header=header, comments="", fmt="%.9f")
    return stamps, lefts, rights, rows


@pytest.mark.parametrize("times", [True, False])
def test_kitti_loader_matches_jax(tmp_path, times):
    lefts, rights, poses = write_kitti(tmp_path, times=times)
    seq, ref = KittiStereoSequence(tmp_path), JaxKitti(tmp_path)
    assert len(seq) == len(ref) == len(lefts)
    np.testing.assert_array_equal(seq.timestamps, ref.timestamps)
    for i in range(len(seq)):
        l, r, ts = seq[i]
        jl, jr, jts = ref[i]
        np.testing.assert_array_equal(l, lefts[i])
        np.testing.assert_array_equal(r, rights[i])
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(r, jr)
        assert ts == jts and isinstance(ts, float)
    gt = load_kitti_gt_poses(tmp_path / "poses.txt")
    assert gt.shape == (len(lefts), 3, 4)
    np.testing.assert_array_equal(gt, jax_kitti_gt(tmp_path / "poses.txt"))
    np.testing.assert_allclose(gt.reshape(len(lefts), 12), poses, rtol=1e-15)


def test_euroc_loader_matches_jax(tmp_path):
    mav0 = tmp_path / "mav0"
    stamps, lefts, rights, rows = write_euroc(mav0)
    seq, ref = EurocStereoSequence(mav0), JaxEuroc(mav0)
    assert len(seq) == len(ref) == len(stamps)
    assert seq.timestamps == ref.timestamps == [s * 1e-9 for s in stamps]
    for i in range(len(seq)):
        l, r, ts = seq[i]
        np.testing.assert_array_equal(l, lefts[i])
        np.testing.assert_array_equal(r, rights[i])
        assert ts == ref[i][2]
    t, pos = load_euroc_gt(mav0)
    jt, jpos = jax_euroc_gt(mav0)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_array_equal(pos, jpos)
    np.testing.assert_allclose(pos, rows[:, 1:4], atol=1e-9)


def test_euroc_rectified_matches_jax(tmp_path):
    """EuRoC.yaml's rectification: the port's settings and loader give the
    JAX package's rectified pairs bit for bit, and the maps move pixels."""
    mav0 = tmp_path / "mav0"
    _, lefts, rights, _ = write_euroc(mav0, n=2)
    yaml = REPO / "examples" / "configs" / "EuRoC.yaml"
    rect, jrect = load_settings(yaml).rectify, jax_load_settings(yaml).rectify
    for side in ("LEFT", "RIGHT"):
        for key in ("K", "D", "R", "P"):
            np.testing.assert_array_equal(rect[side][key], jrect[side][key])
    seq, ref = EurocStereoSequence(mav0, rectify=rect), JaxEuroc(mav0, rectify=jrect)
    for side in ("LEFT", "RIGHT"):
        for a, b in zip(seq.maps[side], ref.maps[side]):
            np.testing.assert_array_equal(a, b)
    for i in range(len(seq)):
        l, r, _ = seq[i]
        jl, jr, _ = ref[i]
        assert l.shape == (480, 752) and l.dtype == np.uint8
        np.testing.assert_array_equal(l, jl)
        np.testing.assert_array_equal(r, jr)
        assert not np.array_equal(l, lefts[i]) and not np.array_equal(r, rights[i])
