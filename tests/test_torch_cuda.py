"""Tests that need a CUDA card: the hand-written kernels (patch tiles,
fused describe, fused stereo SAD) against their plain versions, and the
point and line front ends on the card against the CPU.  They skip where no card is present; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports torch and the port only, and --noconftest skips
tests/conftest.py, which imports jax (the card's machine has no jax).
"""

import numpy as np
import pytest
import torch

from orb_line_slam_tpu_torch.ops import describe, patches, stereo_sad

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
    assert patches.launches == before + (1 if n else 0)    # no keypoints, no launch
    assert out.device.type == "cuda" and out.shape == (n, 32, 32)
    assert torch.equal(out, patches.patch_tiles_reference(img, xy))


def test_kernel_rejects_mixed_devices(cuda):
    with pytest.raises(ValueError):
        patches.gather_patch_tiles(torch.zeros((40, 40), device=cuda), torch.zeros((2, 2), dtype=torch.int32))


def _atlas_and_keypoints(cuda, h, w, n, seed):
    """A low-passed random [2, h, w] atlas, keypoints with border and
    out-of-range ones among them, sub-pixel offsets in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy((rng.random((2, 1, h, w)) * 255).astype(np.float32)).to(cuda)
    atlas = (torch.nn.functional.avg_pool2d(noise, 5, 1, 2, count_include_pad=False) * 0.7 + noise * 0.3)[:, 0].contiguous()
    xy = np.stack([rng.integers(-20, w + 20, (2, n)), rng.integers(-20, h + 20, (2, n))], -1)
    border = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [w + 3, h + 3], [15, 15], [w - 17, h - 17]])
    xy[:, : min(n, len(border))] = border[:n]
    delta = rng.uniform(-0.5, 0.5, (2, n, 2)).astype(np.float32)
    return atlas, torch.from_numpy(xy.astype(np.int32)).to(cuda), torch.from_numpy(delta).to(cuda)


@pytest.mark.parametrize("h,w,n", [(1731, 1241, 2000), (100, 300, 40)])
def test_describe_kernel_matches_plain(cuda, h, w, n):
    """Angles within 1e-4 rad on >= 99.5% of keypoints, >= 99% of
    descriptors identical, median 0 bits, none above 8 (the blurred tile is
    a float32 sum in another order than the matrix-product library's)."""
    atlas, axy, delta = _atlas_and_keypoints(cuda, h, w, n, h + n)
    before = describe.launches
    ang, desc = describe.describe_keypoints(atlas, axy, delta)
    torch.cuda.synchronize()
    assert describe.launches == before + 1
    assert ang.shape == (2 * n,) and desc.shape == (2 * n, 32) and desc.dtype == torch.uint8
    ang_p, desc_p = describe.describe_reference(atlas, axy, delta)
    d = (ang - ang_p).abs()
    d = torch.minimum(d, 2 * np.pi - d)
    assert float((d < 1e-4).float().mean()) >= 0.995
    bits = np.unpackbits((desc ^ desc_p).cpu().numpy(), axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and np.median(bits) == 0 and bits.max() <= 8


@pytest.mark.parametrize("h,w,n,fractional", [(1731, 1241, 2000, False), (100, 300, 40, True)])
def test_stereo_sad_kernel_matches_plain(cuda, h, w, n, fractional):
    """|sad - plain| <= 1e-5 plain + 1e-2 and the same best slide on
    >= 99.9% of rows (a 121-term float32 sum in another order)."""
    atlas, axy, _ = _atlas_and_keypoints(cuda, h, w, n, h + n + 1)
    rng = np.random.default_rng(n)
    cx = axy[0, :, 0].float() - torch.from_numpy(rng.uniform(0, 60, n).astype(np.float32)).to(cuda)
    cy = axy[0, :, 1].float() + (torch.from_numpy(rng.uniform(0, 1, n).astype(np.float32)).to(cuda) if fractional else 0.0)
    cx = cx if fractional else torch.floor(cx)
    before = stereo_sad.launches
    sad = stereo_sad.stereo_sad(atlas[0], axy[0], atlas[1], cx.contiguous(), cy.contiguous())
    torch.cuda.synchronize()
    assert stereo_sad.launches == before + 1 and sad.shape == (n, 11)
    ref = stereo_sad.stereo_sad_reference(atlas[0], axy[0], atlas[1], cx, cy)
    assert bool(((sad - ref).abs() <= 1e-5 * ref + 1e-2).all())
    assert float((sad.argmin(1) == ref.argmin(1)).float().mean()) >= 0.999


def test_fused_wrappers_reject_mixed_devices(cuda):
    atlas, axy, delta = _atlas_and_keypoints(cuda, 64, 64, 8, 0)
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas, axy.cpu(), delta)
    with pytest.raises(ValueError):
        stereo_sad.stereo_sad(atlas[0], axy[0], atlas[1].cpu(), torch.zeros(8, device=cuda), torch.zeros(8, device=cuda))


def test_frame_on_card_matches_cpu(cuda):
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame

    cam = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=False))
    l, r = SyntheticScene(cam, n_points=900, seed=5, extent=((-24, 40), (-4, 4), (-32, 32))).render_stereo(
        np.eye(3), np.zeros(3))
    fc = build_stereo_frame(torch.from_numpy(l), torch.from_numpy(r), cfg).numpy()
    before = (patches.launches, describe.launches, stereo_sad.launches)
    fg = build_stereo_frame(torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda), cfg).numpy()
    # Two fused kernels per stereo pair, and no tile gather.
    assert (patches.launches, describe.launches, stereo_sad.launches) == (before[0], before[1] + 1, before[2] + 1)
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
