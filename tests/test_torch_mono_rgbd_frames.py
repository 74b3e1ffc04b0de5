"""The monocular and RGB-D frames of the torch port against the JAX
package's on the CPU, on rendered 640x320 images, under the frame
contract of tests/test_tpu_parity.py (valid agreement > 0.98, keypoints
within 0.51 px, median descriptor distance <= 1 bit, > 95% of depths
within 1%); and the single-image extraction that both frames run, which
describes its keypoints through ``describe_keypoints`` on a batch of one,
against the tile path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import LineConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.frontend.frame import build_mono_frame as jax_build_mono_frame
from orb_line_slam_tpu.frontend.frame import build_rgbd_frame as jax_build_rgbd_frame
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu_torch.convert import config_from_jax
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
from orb_line_slam_tpu_torch.frontend import orb_extractor as torb
from orb_line_slam_tpu_torch.frontend.frame import build_mono_frame, build_rgbd_frame

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)

CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=False))
TCFG = config_from_jax(CFG)


def _rgbd(seed=11, z=0.0):
    """A rendered image and its depth map (m): a room-to-street volume
    inside the renderer's range."""
    scene = SyntheticScene(TCFG.camera, n_points=900, seed=seed, extent=((-14, 14), (-6, 6), (4, 30)))
    return scene.render_rgbd(np.eye(3), -np.array([0.1, 0.0, z]))


def _hold_to_contract(fj, ft):
    agree = (fj.valid == ft.valid).mean()
    assert agree > 0.98, agree
    both = fj.valid & ft.valid
    assert both.sum() > 500
    assert np.abs(fj.xy[both] - ft.xy[both]).max() < 0.51
    assert np.median(np.unpackbits(fj.desc[both] ^ ft.desc[both], axis=1).sum(1)) <= 1
    assert ft.desc.dtype == np.uint8 and ft.desc.shape == (1000, 32)
    assert ft.xy.dtype == np.float32 and ft.octave.dtype == np.int32 and ft.depth.dtype == np.float32
    return both


@pytest.mark.parametrize("levels", [4, 8])
def test_extract_orb_equals_the_tile_path_bit_for_bit(levels):
    """On the CPU, extract_orb (keypoints described by describe_keypoints
    on a [1, H, W] atlas) equals extract_orb_with_tiles(...)[0] bit for
    bit, at the frames' 4 levels and at TUM's 8."""
    img, _ = _rgbd()
    cfg = config_from_jax(SlamConfig(orb=OrbConfig(n_features=1000, n_levels=levels))).orb
    got = torb.extract_orb(T(img), cfg)
    want, tiles = torb.extract_orb_with_tiles(T(img), cfg)
    assert tiles.shape == (1000, 32, 32)
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_build_mono_frame_contract():
    """The frame contract against JAX's mono frame; no depth: u_right and
    depth are -1 everywhere."""
    img, _ = _rgbd(seed=12)
    fj = jax.device_get(jax_build_mono_frame(jnp.asarray(img), CFG))
    ft = build_mono_frame(T(img), TCFG).numpy()
    _hold_to_contract(fj, ft)
    assert (ft.u_right == -1).all() and (ft.depth == -1).all()
    np.testing.assert_array_equal(ft.octave[fj.valid & ft.valid], fj.octave[fj.valid & ft.valid])


@pytest.mark.parametrize("seed,z", [(11, 0.0), (13, 0.4)])
def test_build_rgbd_frame_contract(seed, z):
    """The frame contract against JAX's RGB-D frame on the same image and
    depth map, with holes (zero depth) cut into it: the depth-hit masks
    agree on > 95% of the common keypoints, > 95% of the depths within 1%,
    and u_right = u - bf / depth from the distorted x within 1e-3 px of
    JAX's where both have a depth."""
    img, depth = _rgbd(seed, z)
    depth = depth.copy()
    depth[::7] = 0.0                              # rows the sensor did not see
    depth[:, 300:340] = 0.0
    fj = jax.device_get(jax_build_rgbd_frame(jnp.asarray(img), jnp.asarray(depth), CFG))
    ft = build_rgbd_frame(T(img), T(depth), TCFG).numpy()
    both = _hold_to_contract(fj, ft)
    dj, dt = fj.depth[both], ft.depth[both]
    assert ((dj > 0) == (dt > 0)).mean() > 0.95
    hit = (dj > 0) & (dt > 0)
    assert hit.sum() > 300 and (dj <= 0).sum() > 20
    assert (np.abs(dj[hit] - dt[hit]) / dj[hit] < 0.01).mean() > 0.95
    uj, ut = fj.u_right[both][hit], ft.u_right[both][hit]
    same_px = np.abs(fj.xy[both][hit] - ft.xy[both][hit]).max(1) < 1e-4
    np.testing.assert_allclose(ut[same_px], uj[same_px], atol=1e-3)
    assert ((ft.depth > 0) == (ft.u_right != -1)).all()
    assert (ft.depth[~ft.valid] == -1).all()
