"""Front end of the torch port against the JAX package on the CPU: the
same numpy inputs through both, with the tolerances stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import LineConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.frontend import orb_extractor as jorb
from orb_line_slam_tpu.frontend.frame import build_stereo_frame as jax_build_stereo_frame
from orb_line_slam_tpu.ops import brief as jbrief, fast as jfast, hamming as jham, image as jimage
from orb_line_slam_tpu.ops.topk_grid import select_topk_grid as jax_topk
from orb_line_slam_tpu_torch.convert import config_from_jax
from orb_line_slam_tpu_torch.frontend import orb_extractor as torb
from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame
from orb_line_slam_tpu_torch.frontend.stereo import nanmedian_linear
from orb_line_slam_tpu_torch.ops import brief as tbrief, detect as tdetect, fast as tfast, hamming as tham, image as timage
from orb_line_slam_tpu_torch.ops.topk_grid import select_topk_grid

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)


def _img(seed, h=96, w=160):
    return np.random.default_rng(seed).integers(0, 255, (h, w)).astype(np.float32)


def test_pyramid_and_atlas():
    """Max abs error <= 1e-3 (fp32 matmul summation order)."""
    img = _img(0, 120, 200)
    lj = jimage.build_pyramid(jnp.asarray(img), 4, 1.2)
    lt = timage.build_pyramid(T(img), 4, 1.2)
    for a, b in zip(lj, lt):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-3)
    aj, oj = jimage.pyramid_atlas(lj)
    at, ot = timage.pyramid_atlas(lt)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), atol=1e-3)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_and_nms_exact(seed):
    img = _img(seed)
    sj = jfast.fast_score_map(jnp.asarray(img))
    st = tfast.fast_score_map(T(img))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(tfast.nms3x3(st).numpy(), np.asarray(jfast.nms3x3(sj)))


def test_nms_plateau_keeps_first_pixel():
    s = np.zeros((8, 8), np.float32)
    s[2:5, 2:5] = 7.0
    np.testing.assert_array_equal(
        tfast.nms3x3(T(s)).numpy(), np.asarray(jfast.nms3x3(jnp.asarray(s)))
    )
    assert (tfast.nms3x3(T(s)).numpy() > 0).sum() == 1


@pytest.mark.parametrize("ties", [False, True])
def test_select_topk_grid_exact(ties):
    rng = np.random.default_rng(4)
    if ties:  # integer scores on a few values: ties everywhere
        score = rng.integers(0, 4, (70, 100)).astype(np.float32) * 10.0
    else:
        score = rng.random((70, 100)).astype(np.float32) * 50
    for cell, k, n, ms in ((16, 3, 60, 7.0), (32, 16, 200, 7.0), (16, 1, 10, 25.0)):
        xj, rj, vj = jax_topk(jnp.asarray(score), cell, k, n, ms)
        xt, rt, vt = select_topk_grid(T(score), cell, k, n, ms)
        np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
        np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))


def test_detect_level_exact():
    cfg = OrbConfig(n_features=300, n_levels=1)
    img = _img(5, 128, 192)
    xj, dj, rj, vj = jorb._detect_level(jnp.asarray(img), 300, cfg)
    xt, dt, rt, vt = tdetect.detect_level(T(img), 300, config_from_jax(SlamConfig(orb=cfg)).orb)
    np.testing.assert_array_equal(xt.numpy(), np.asarray(xj))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-6)


def _tiles(seed, n=300):
    rng = np.random.default_rng(seed)
    base = rng.random((n, 1, 1)) * 200
    grad = rng.normal(0, 3, (n, 2, 1, 1))
    yy, xx = np.mgrid[0:32, 0:32]
    tiles = base + grad[:, 0] * xx + grad[:, 1] * yy + rng.normal(0, 8, (n, 32, 32))
    delta = rng.uniform(-0.5, 0.5, (n, 2))
    return np.clip(tiles, 0, 255).astype(np.float32), delta.astype(np.float32)


def test_shift_tiles_and_shift_blur_tiles():
    """Within 1e-4 (fp32 summation order)."""
    tiles, delta = _tiles(6)
    np.testing.assert_allclose(
        torb.shift_tiles(T(tiles), T(delta)).numpy(),
        np.asarray(jorb.shift_tiles(jnp.asarray(tiles), jnp.asarray(delta))), atol=1e-4)
    np.testing.assert_allclose(
        torb.shift_blur_tiles(T(tiles), T(delta)).numpy(),
        np.asarray(jorb.shift_blur_tiles(jnp.asarray(tiles), jnp.asarray(delta))), atol=1e-4)


def test_ic_angle_bins_and_brief():
    """Equal angle bins on equal tiles; BRIEF >= 99% of rows identical
    and median 0 bits on each package's own blurred tiles."""
    tiles, delta = _tiles(7, 500)
    bj = jorb.shift_blur_tiles(jnp.asarray(tiles), jnp.asarray(delta))
    bt = torb.shift_blur_tiles(T(tiles), T(delta))
    aj = jbrief.ic_angle_from_tiles(bj)
    at = tbrief.ic_angle_from_tiles(T(np.asarray(bj)))
    np.testing.assert_array_equal(tbrief.quantize_angle(at).numpy(), np.asarray(jbrief.quantize_angle(aj)))
    dj = np.asarray(jbrief.brief_descriptors_from_tiles(bj, aj))
    dt = tbrief.brief_descriptors_from_tiles(bt, tbrief.ic_angle_from_tiles(bt)).numpy()
    bits = np.unpackbits(dj ^ dt, axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and np.median(bits) == 0
    # Equal tiles give equal descriptors bit for bit.
    np.testing.assert_array_equal(
        tbrief.brief_descriptors_from_tiles(T(np.asarray(bj)), T(np.asarray(aj))).numpy(), dj)


def test_bits_hamming_knn2_exact():
    rng = np.random.default_rng(8)
    a = rng.integers(0, 256, (37, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (53, 32), dtype=np.uint8)
    b[5] = a[3]
    np.testing.assert_array_equal(tham.unpack_bits(T(a)).numpy(), np.asarray(jham.unpack_bits(jnp.asarray(a))))
    np.testing.assert_array_equal(tham.pack_bits(tham.unpack_bits(T(a))).numpy(), a)
    dj = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    dt = tham.hamming_matrix(T(a), T(b))
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(tham.hamming_pairwise(T(a), T(b[:37])).numpy(),
                                  np.asarray(jham.hamming_pairwise(jnp.asarray(a), jnp.asarray(b[:37]))))
    valid = rng.random((37, 53)) > 0.3
    for got, want in zip(tham.knn2(dt, T(valid)), jham.knn2(jnp.asarray(dj), jnp.asarray(valid))):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(tham.mutual_best(dt).numpy(), np.asarray(jham.mutual_best(jnp.asarray(dj))))


def test_nanmedian_averages_middle_values():
    for x in ([1.0, 2.0, np.nan, 4.0, 8.0], [3.0, np.nan, 1.0], [np.nan, np.nan], [5.0]):
        want = np.asarray(jnp.nanmedian(jnp.asarray(np.array(x, np.float32))))
        got = nanmedian_linear(T(np.array(x, np.float32))).numpy()
        np.testing.assert_allclose(got, want, equal_nan=True)


def _rendered_pair():
    """The rendered pair of tests/test_tpu_parity.py:163-173."""
    from orb_line_slam_tpu.data.synthetic import SyntheticScene
    from orb_line_slam_tpu.geometry.camera import CameraIntrinsics

    vcam = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    scene = SyntheticScene(vcam, n_points=900, seed=5, extent=((-24, 40), (-4, 4), (-32, 32)))
    scene.noise_sigma = 6.0
    iml, imr = scene.render_stereo(np.eye(3), np.zeros(3))
    return vcam, iml, imr


def test_extract_orb_contract():
    """Single-image extraction (extract_orb / extract_orb_with_tiles) under
    the frame contract: valid agreement > 0.98, keypoints < 0.51 px,
    median descriptor distance <= 1 bit; the shifted tiles of rows with
    the same keypoint within 1e-3."""
    _, iml, _ = _rendered_pair()
    ocfg = OrbConfig(n_features=1000, n_levels=4)
    fj, tj = jax.device_get(jax.jit(jorb.extract_orb_with_tiles, static_argnames="cfg")(jnp.asarray(iml), ocfg))
    tcfg = config_from_jax(SlamConfig(orb=ocfg)).orb
    ft, tt = torb.extract_orb_with_tiles(T(iml), tcfg)
    np.testing.assert_array_equal(torb.extract_orb(T(iml), tcfg).desc.numpy(), ft.desc.numpy())
    assert (fj.valid == ft.valid.numpy()).mean() > 0.98
    both = fj.valid & ft.valid.numpy()
    d_xy = np.abs(fj.xy[both] - ft.xy.numpy()[both])
    assert d_xy.max() < 0.51
    assert np.median(np.unpackbits(fj.desc[both] ^ ft.desc.numpy()[both], axis=1).sum(1)) <= 1
    same = both & (np.abs(fj.xy - ft.xy.numpy()).max(1) < 1e-4)
    assert same.sum() > 0.9 * both.sum()
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tj)[same], atol=1e-3)


def test_build_stereo_frame_contract():
    """The test_tpu_parity frame contract: valid agreement > 0.98,
    keypoints < 0.51 px, median descriptor distance <= 1 bit, stereo-hit
    agreement > 0.95, > 95% of depths within 1%."""
    vcam, iml, imr = _rendered_pair()
    cfg = SlamConfig(camera=vcam, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=False))
    fj = jax.device_get(jax_build_stereo_frame(jnp.asarray(iml), jnp.asarray(imr), cfg))
    ft = build_stereo_frame(T(iml), T(imr), config_from_jax(cfg)).numpy()
    agree = (fj.valid == ft.valid).mean()
    assert agree > 0.98, agree
    both = fj.valid & ft.valid
    assert np.abs(fj.xy[both] - ft.xy[both]).max() < 0.51
    assert np.median(np.unpackbits(fj.desc[both] ^ ft.desc[both], axis=1).sum(1)) <= 1
    dj, dt = fj.depth[both], ft.depth[both]
    assert ((dj > 0) == (dt > 0)).mean() > 0.95
    hit = (dj > 0) & (dt > 0)
    assert hit.sum() > 100
    assert (np.abs(dj[hit] - dt[hit]) / dj[hit] < 0.01).mean() > 0.95
    assert ft.desc.dtype == np.uint8 and ft.desc.shape == (1000, 32)
    assert ft.xy.dtype == np.float32 and ft.octave.dtype == np.int32
