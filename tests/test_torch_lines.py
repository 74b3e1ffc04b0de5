"""Line front end of the torch port against the JAX package on the CPU:
image ops, line detection and merging, LBD, the stereo line features,
and the port's numpy line rasteriser against cv2, on the same seeded
inputs, with the tolerances stated per test."""

import math

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import LineConfig as JaxLineConfig
from orb_line_slam_tpu.data.synthetic import SyntheticScene as JaxScene
from orb_line_slam_tpu.frontend.line_extractor import build_line_features as jax_build_line_features
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics as JaxCam
from orb_line_slam_tpu.ops import image as jimage
from orb_line_slam_tpu.ops.lbd import lbd_descriptors as jax_lbd
from orb_line_slam_tpu.ops.lines import detect_lines as jax_detect, merge_collinear as jax_merge
from orb_line_slam_tpu.ops.topk_grid import select_topk_grid as jax_topk
from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory, draw_line
from orb_line_slam_tpu_torch.frontend.line_extractor import build_line_features
from orb_line_slam_tpu_torch.ops import image
from orb_line_slam_tpu_torch.ops.lbd import _band_stats, _comparison_pattern, lbd_descriptors, lbd_features
from orb_line_slam_tpu_torch.ops.lines import (
    _fields, detect_lines, linspace_f32, merge_collinear, segments_from_candidates,
)
from orb_line_slam_tpu_torch.ops.topk_grid import select_topk_grid

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)

# The configuration of tests/test_tracking_with_lines.py:12-21.
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
LCFG = LineConfig(enabled=True, n_lines=64)
SCENE = dict(n_points=500, n_lines=40, seed=9, extent=((-14, 14), (-6, 6), (6, 60)))


def _frames(idx=(0, 6, 11)):
    scene = SyntheticScene(CAM, **SCENE)
    poses = circular_trajectory(12, step=0.3)
    return [scene.render_stereo(*poses[i]) for i in idx]


def _image(seed=0, h=96, w=128):
    return np.random.default_rng(seed).integers(0, 256, (h, w)).astype(np.float32)


# ---------------------------------------------------------------------------
# Image ops: within 1e-4 abs on 0-255 images.

def test_filters_match_jax():
    img = _image(1)
    gx, gy = image.sobel_gradients(T(img))
    jgx, jgy = jimage.sobel_gradients(jnp.asarray(img))
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(gy.numpy(), np.asarray(jgy), atol=1e-4, rtol=0)
    for sigma, radius in ((2.0, 3), (2.0, 4)):
        b = image.gaussian_blur(T(img), sigma, radius).numpy()
        np.testing.assert_allclose(b, np.asarray(jimage.gaussian_blur(jnp.asarray(img), sigma, radius)),
                                   atol=1e-4, rtol=0)
    # A batch of two goes through as two images.
    pair = np.stack([img, _image(2)])
    bx, _ = image.sobel_gradients(T(pair))
    np.testing.assert_array_equal(bx[0].numpy(), gx.numpy())


def test_sampling_matches_jax():
    img = _image(3)
    rng = np.random.default_rng(4)
    xy = np.stack([rng.uniform(-5, 133, (50, 7)), rng.uniform(-5, 101, (50, 7))], -1).astype(np.float32)
    xy[0, :4] = [[0, 0], [127, 95], [127.6, 95.6], [63.5, 40.5]]   # borders and round-half ties
    np.testing.assert_allclose(image.bilinear_sample(T(img), T(xy)).numpy(),
                               np.asarray(jimage.bilinear_sample(jnp.asarray(img), jnp.asarray(xy))),
                               atol=1e-4, rtol=0)
    np.testing.assert_array_equal(image.nearest_sample(T(img), T(xy)).numpy(),
                                  np.asarray(jimage.nearest_sample(jnp.asarray(img), jnp.asarray(xy))))
    # Multi-channel fields gather all channels at once.
    field = np.stack([img, _image(5), _image(6)], -1)
    np.testing.assert_allclose(image.bilinear_sample(T(field), T(xy)).numpy(),
                               np.asarray(jimage.bilinear_sample(jnp.asarray(field), jnp.asarray(xy))),
                               atol=1e-4, rtol=0)
    # batch=1: sample b reads image b.
    two = np.stack([img, _image(7)])
    out = image.bilinear_sample(T(two), T(np.stack([xy, xy])), batch=1).numpy()
    np.testing.assert_array_equal(out[1], image.bilinear_sample(T(two[1]), T(xy)).numpy())


def test_constants_and_floor_mod_match_jax():
    """jnp.linspace's fp32 construction within one ulp, and jnp.mod's
    floor semantics bit for bit (the walk positions feed rounding)."""
    for a, b, n in ((0.02, 0.98, 32), (0.0, 1.0, 24)):
        ref = np.asarray(jnp.linspace(a, b, n))
        np.testing.assert_allclose(linspace_f32(a, b, n).numpy(), ref, rtol=0, atol=1.2e-7)
    x = np.random.default_rng(0).normal(0, 5, 20000).astype(np.float32)
    np.testing.assert_array_equal(torch.remainder(T(x), math.pi).numpy(), np.asarray(jnp.mod(jnp.asarray(x), jnp.pi)))


# ---------------------------------------------------------------------------
# Detection and LBD.

def _jax_candidates(img, n_lines, min_mag=30.0, cell=24):
    """Stages 1-3 of orb_line_slam_tpu/ops/lines.py:79-110, as written there."""
    x = jnp.asarray(img, jnp.float32)
    hi = jax.lax.Precision.HIGH
    gx, gy = jimage.sobel_gradients(x, precision=hi)
    mag2 = gx * gx + gy * gy
    hh, ww = x.shape
    ys, xs = jnp.arange(hh)[:, None], jnp.arange(ww)[None, :]
    mag2 = jnp.where((ys >= 4) & (ys < hh - 4) & (xs >= 4) & (xs < ww - 4), mag2, 0.0)
    edge = (mag2 > min_mag * min_mag).astype(jnp.float32)
    inv = edge / jnp.maximum(mag2, 1e-9)
    c2b = jimage.gaussian_blur(-(gx * gx - gy * gy) * inv, sigma=2.0, radius=4, precision=hi)
    s2b = jimage.gaussian_blur(-(2.0 * gx * gy) * inv, sigma=2.0, radius=4, precision=hi)
    xy, _, valid = jax_topk(edge * jnp.sqrt(c2b * c2b + s2b * s2b), cell, 2, n_lines, 0.06)
    return np.asarray(xy), np.asarray(valid)


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_detect_and_merge_match_jax(frame):
    """Started from identical candidate xy (the JAX package's), valid
    agreement > 0.9 and median endpoint error < 1 px (the line contract
    of tests/test_tpu_parity.py).  The port's own candidates are the JAX
    ones except where two scores tie to within float rounding (the blur
    sums in another order)."""
    img = _frames()[frame][0].astype(np.float32)
    jxy, jvalid = _jax_candidates(img, 64)
    score, fields = _fields(T(img)[None], 30.0)
    xy, _, valid = (a[0].numpy() for a in select_topk_grid(score, 24, 2, 64, 0.06))
    np.testing.assert_array_equal(valid, jvalid)
    same = (xy == jxy).all(1)
    assert same.mean() > 0.9, same.mean()
    s = score[0].numpy()
    np.testing.assert_allclose(s[xy[~same, 1], xy[~same, 0]], s[jxy[~same, 1], jxy[~same, 0]], rtol=1e-5)

    lt = segments_from_candidates(fields, T(jxy)[None], T(jvalid)[None])
    lt = merge_collinear(type(lt)(*(a[0] for a in lt)))
    lj = jax.device_get(jax_merge(jax_detect(jnp.asarray(img), n_lines=64)))
    agree = (lt.valid.numpy() == lj.valid).mean()
    both = lt.valid.numpy() & lj.valid
    d_ep = np.maximum(np.abs(lt.p0.numpy() - lj.p0).max(-1), np.abs(lt.p1.numpy() - lj.p1).max(-1))[both]
    assert agree > 0.9 and both.sum() >= 8, (agree, both.sum())
    assert np.median(d_ep) < 1.0, np.median(d_ep)
    # From its own candidates the port still holds the contract.
    lo = merge_collinear(detect_lines(T(img), n_lines=64))
    assert (lo.valid.numpy() == lj.valid).mean() > 0.9


def test_merge_collinear_tie_break_matches_jax():
    """Equal-length duplicates: the lower index survives, as in JAX."""
    p0 = np.array([[10, 10], [10, 11], [50, 50], [200, 20]], np.float32)
    p1 = np.array([[60, 10], [60, 11], [90, 50], [240, 60]], np.float32)
    d = p1 - p0
    ang = np.mod(np.arctan2(d[:, 1], d[:, 0]), np.pi).astype(np.float32)
    length = np.linalg.norm(d, axis=-1).astype(np.float32)
    fields = [p0, p1, ang, length, length, np.ones(4, bool)]
    from orb_line_slam_tpu.ops.lines import DetectedLines as JD
    from orb_line_slam_tpu_torch.ops.lines import DetectedLines as TD

    vj = np.asarray(jax_merge(JD(*(jnp.asarray(f) for f in fields))).valid)
    vt = merge_collinear(TD(*(T(f) for f in fields))).valid.numpy()
    np.testing.assert_array_equal(vt, vj)
    assert vt.tolist() == [True, False, True, True]


def test_band_std_is_population_std():
    g = T(np.random.default_rng(0).normal(0, 3, (5, 24, 9)).astype(np.float32))
    _, _, s_pos, s_neg = _band_stats(g)
    pos = np.maximum(g.numpy(), 0)
    np.testing.assert_allclose(s_pos.numpy(), pos.std(axis=1, ddof=0), rtol=1e-5, atol=1e-6)
    assert np.abs(s_pos.numpy() - pos.std(axis=1, ddof=1)).max() > 1e-3
    np.testing.assert_allclose(s_neg.numpy(), np.maximum(-g.numpy(), 0).std(axis=1, ddof=0), rtol=1e-5, atol=1e-6)


def test_lbd_matches_jax():
    """Median <= 8 bits on detected lines; bit-exact where the compared
    band statistics have no near-ties (every compared pair differs by
    more than 1e-5, far above the two packages' rounding differences)."""
    img = _frames()[1][0].astype(np.float32)
    lj = jax.device_get(jax_detect(jnp.asarray(img), n_lines=64))
    dj = np.asarray(jax_lbd(jnp.asarray(img), jnp.asarray(lj.p0), jnp.asarray(lj.p1), jnp.asarray(lj.valid)))
    dt = lbd_descriptors(T(img)[None], T(lj.p0)[None], T(lj.p1)[None], T(lj.valid)[None])[0].numpy()
    bits = np.unpackbits(dj ^ dt, axis=1).sum(1)[lj.valid]
    assert lj.valid.sum() >= 8 and np.median(bits) <= 8, bits

    # Smooth random texture and random segments: keep those whose compared
    # statistics are separated by more than 1e-5.
    rng = np.random.default_rng(11)
    tex = jimage.gaussian_blur(jnp.asarray(rng.uniform(0, 255, (160, 240)).astype(np.float32)), 3.0, 6)
    tex = np.asarray(tex)
    p0 = np.stack([rng.uniform(40, 200, 64), rng.uniform(40, 120, 64)], -1).astype(np.float32)
    p1 = (p0 + rng.normal(0, 25, (64, 2))).astype(np.float32)
    v = lbd_features(T(tex)[None], T(p0)[None], T(p1)[None])[0].numpy()
    pat = _comparison_pattern()
    clear = np.abs(v[:, pat[:, 0]] - v[:, pat[:, 1]]).min(1) > 1e-5
    assert clear.sum() >= 10, clear.sum()
    ones = np.ones(64, bool)
    dj = np.asarray(jax_lbd(jnp.asarray(tex), jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(ones)))
    dt = lbd_descriptors(T(tex)[None], T(p0)[None], T(p1)[None], T(ones)[None])[0].numpy()
    np.testing.assert_array_equal(dt[clear], dj[clear])


# ---------------------------------------------------------------------------
# Stereo line features: the line contract.

@pytest.mark.parametrize("frame", [0, 1, 2])
def test_build_line_features_match_jax(frame):
    """valid agreement > 0.9, >= 8 common lines, median endpoint
    divergence < 1 px, median LBD divergence <= 8 bits, endpoint depths
    within 2% (median) where both sides have one."""
    l, r = _frames()[frame]
    lt = build_line_features(T(l), T(r), CAM, LCFG).numpy()
    lj = jax.device_get(jax_build_line_features(jnp.asarray(l), jnp.asarray(r), JaxCam(*CAM),
                                                JaxLineConfig(enabled=True, n_lines=64)))
    agree = (lt.valid == lj.valid).mean()
    both = lt.valid & lj.valid
    assert agree > 0.9 and both.sum() >= 8, (agree, both.sum())
    d_ep = np.maximum(np.abs(lt.p0 - lj.p0).max(-1), np.abs(lt.p1 - lj.p1).max(-1))[both]
    assert np.median(d_ep) < 1.0
    assert np.median(np.unpackbits(lt.desc[both] ^ lj.desc[both], axis=1).sum(1)) <= 8
    n_hits = 0
    for dt_, dj_ in ((lt.depth0[both], lj.depth0[both]), (lt.depth1[both], lj.depth1[both])):
        hit = (dt_ > 0) & (dj_ > 0)
        n_hits += hit.sum()
        assert ((dt_ > 0) == (dj_ > 0)).mean() > 0.9
        if hit.sum() >= 3:
            assert np.median(np.abs(dt_[hit] - dj_[hit]) / dj_[hit]) < 0.02
    assert n_hits >= 3


# ---------------------------------------------------------------------------
# The numpy line rasteriser against cv2.line(..., 2, cv2.LINE_8).

def test_rasteriser_matches_cv2():
    """Pixel for pixel where the segment lies inside the image; >= 99% of
    the image's pixels where it leaves it (OpenCV clips at the border)."""
    rng = np.random.default_rng(0)
    for k in range(400):
        lo, hi = (2, 300) if k % 2 else (-60, 380)
        p0 = tuple(int(v) for v in rng.integers(lo, hi, 2))
        p1 = tuple(int(v) for v in rng.integers(lo, hi, 2)) if k % 5 else (p0[0] + 3, p0[1] - 2)
        a = np.full((320, 320), 110, np.uint8)
        b = a.copy()
        cv2.line(a, p0, p1, 30, 2, cv2.LINE_8)
        draw_line(b, p0, p1, 30)
        if k % 2:
            np.testing.assert_array_equal(b, a, err_msg=f"{p0} {p1}")
        else:
            assert (a == b).mean() >= 0.99, (p0, p1)


def test_rendered_lines_match_cv2_renderer():
    """The same scene's line landmarks, rendered by the port (numpy) and
    by the JAX package (cv2): the line pixels agree on >= 99% of the
    image and overlap by >= 90%."""
    jscene = JaxScene(JaxCam(*CAM), **SCENE)
    tscene = SyntheticScene(CAM, **SCENE)
    assert np.array_equal(jscene.lines, tscene.lines)
    for R, t in circular_trajectory(12, step=0.3)[::5]:
        for a, b in zip(jscene.render_stereo(R, t), tscene.render_stereo(R, t)):
            la, lb = a == 30, b == 30
            assert (la == lb).mean() >= 0.99
            assert lb.sum() > 1000 and (la & lb).sum() >= 0.9 * (la | lb).sum()


def test_sad_refine_ties_take_first_index():
    """On a flat pair every SAD ties: the minimum is the first candidate
    (as jnp.argmin), pinned to the search boundary, so no depth."""
    from orb_line_slam_tpu_torch.frontend.line_extractor import _sad_refine

    imgs = torch.full((2, 64, 96), 80.0)
    pe = T(np.array([[40.0, 30.0], [60.5, 20.25]], np.float32))
    disp, interior = _sad_refine(imgs, pe, T(np.array([5.0, 7.0], np.float32)))
    assert not interior.any()
    np.testing.assert_array_equal(disp.numpy(), [5.0 + 3.5, 7.0 + 3.5])   # cand[1] = -3.5, no parabola shift
