"""Tests that need a CUDA card: the hand-written patch-tile kernel
against its plain version, and the point and line front ends on the card
against the CPU.  They skip where no card is present; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only, and --noconftest skips
tests/conftest.py, which imports jax (the card's machine has no jax).
"""

import numpy as np
import pytest
import torch

from orb_line_slam_tpu_torch.ops import patches

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernel has no CPU or interpret mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("h,w,n", [(1731, 1241, 2000), (100, 300, 40), (32, 32, 7), (64, 96, 0)])
def test_kernel_matches_plain_exactly(cuda, h, w, n):
    rng = np.random.default_rng(h + n)
    img = torch.from_numpy((rng.random((h, w)) * 255).astype(np.float32)).to(cuda)
    xy = np.stack([rng.integers(-40, w + 40, n), rng.integers(-40, h + 40, n)], -1).astype(np.int32)
    xy = torch.from_numpy(xy.reshape(n, 2)).to(cuda)
    before = patches.launches
    out = patches.gather_patch_tiles(img, xy)
    torch.cuda.synchronize()
    assert patches.launches == before + 1
    assert out.device.type == "cuda" and out.shape == (n, 32, 32)
    assert torch.equal(out, patches.patch_tiles_reference(img, xy))


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        patches.gather_patch_tiles(torch.zeros((40, 40), device=cuda), torch.zeros((2, 2), dtype=torch.int32))


def test_frame_on_card_matches_cpu(cuda):
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame

    cam = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=False))
    l, r = SyntheticScene(cam, n_points=900, seed=5, extent=((-24, 40), (-4, 4), (-32, 32))).render_stereo(
        np.eye(3), np.zeros(3))
    fc = build_stereo_frame(torch.from_numpy(l), torch.from_numpy(r), cfg).numpy()
    before = patches.launches
    fg = build_stereo_frame(torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda), cfg).numpy()
    assert patches.launches == before + 3
    assert (fc.valid == fg.valid).mean() > 0.98
    both = fc.valid & fg.valid
    assert np.abs(fc.xy[both] - fg.xy[both]).max() < 0.51
    assert np.median(np.unpackbits(fc.desc[both] ^ fg.desc[both], axis=1).sum(1)) <= 1
    hit = (fc.depth[both] > 0) & (fg.depth[both] > 0)
    assert ((fc.depth[both] > 0) == (fg.depth[both] > 0)).mean() > 0.95
    assert (np.abs(fc.depth[both][hit] - fg.depth[both][hit]) / fg.depth[both][hit] < 0.01).mean() > 0.95


def test_line_frontend_on_card_matches_cpu(cuda):
    """build_line_features on the card vs the CPU plain path: the line
    contract of tests/test_tpu_parity.py:213-250."""
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory
    from orb_line_slam_tpu_torch.frontend.line_extractor import build_line_features

    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = LineConfig(enabled=True, n_lines=64)
    scene = SyntheticScene(cam, n_points=500, n_lines=40, seed=9, extent=((-14, 14), (-6, 6), (6, 60)))
    l, r = scene.render_stereo(*circular_trajectory(12, step=0.3)[6])
    lc = build_line_features(torch.from_numpy(l), torch.from_numpy(r), cam, cfg).numpy()
    lg = build_line_features(torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda), cam, cfg)
    assert lg.p0.device.type == "cuda"
    lg = lg.numpy()
    both = lc.valid & lg.valid
    assert (lc.valid == lg.valid).mean() > 0.9 and both.sum() >= 8
    d_ep = np.maximum(np.abs(lc.p0 - lg.p0).max(-1), np.abs(lc.p1 - lg.p1).max(-1))[both]
    assert np.median(d_ep) < 1.0
    assert np.median(np.unpackbits(lc.desc[both] ^ lg.desc[both], axis=1).sum(1)) <= 8
    for dc, dg in ((lc.depth0[both], lg.depth0[both]), (lc.depth1[both], lg.depth1[both])):
        hit = (dc > 0) & (dg > 0)
        if hit.sum() >= 3:
            assert np.median(np.abs(dc[hit] - dg[hit]) / dg[hit]) < 0.02
