"""The fused describe and stereo-SAD wrappers of the torch port on the
CPU: their plain versions against the JAX package on the same numpy
inputs, the kernels' arithmetic (banded products in ascending order,
ballot packing, lane-ordered SAD sums) emulated in numpy against the plain
versions, input checks, launch counting, and the kernel loader with a
stand-in compiler.  Tolerances are stated per test."""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.frontend import orb_extractor as jorb
from orb_line_slam_tpu.frontend import stereo as jstereo
from orb_line_slam_tpu.ops import brief as jbrief
from orb_line_slam_tpu.ops.pallas_patches import gather_patch_tiles as jax_gather
from orb_line_slam_tpu_torch.ops import _build, brief as tbrief, describe, patches, stereo_sad as tsad

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)


def _atlas(seed, b=2, h=200, w=160):
    """A smooth-ish random atlas: low-pass noise plus a gradient, so that
    intensity centroids are not all at the snap threshold."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w)) * 255
    for _ in range(2):
        img = (img + np.roll(img, 1, 1) + np.roll(img, 1, 2) + np.roll(img, (1, 1), (1, 2))) / 4
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.6 * img + 0.2 * xx[None] + 0.2 * yy[None] + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def _keypoints(seed, b, h, w, n):
    """Random keypoints with border, corner, out-of-range and first/last
    unclamped ones among them, and sub-pixel offsets in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(-20, w + 20, (b, n)), rng.integers(-20, h + 20, (b, n))], -1)
    border = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [5, -7], [w + 3, h + 3],
                       [w // 2, h - 3], [w - 1, h // 2], [15, 15], [16, 16], [w - 17, h - 17]])
    xy[:, : len(border)] = border
    delta = rng.uniform(-0.5, 0.5, (b, n, 2))
    delta[:, :4] = [[0.0, 0.0], [0.5, -0.5], [-0.5, 0.5], [0.25, 0.0]]
    return xy.astype(np.int32), delta.astype(np.float32)


def _jax_describe(atlas, xy, delta):
    tiles = jnp.concatenate([jax_gather(jnp.asarray(atlas[i]), jnp.asarray(xy[i])) for i in range(atlas.shape[0])])
    blur = jorb.shift_blur_tiles(tiles, jnp.asarray(delta.reshape(-1, 2)))
    angles = jbrief.ic_angle_from_tiles(blur)
    return np.asarray(blur), np.asarray(angles), np.asarray(jbrief.brief_descriptors_from_tiles(blur, angles))


def _angle_diff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("seed,h,w,n", [(0, 200, 160, 300), (1, 64, 96, 120), (2, 32, 32, 40)])
def test_describe_reference_matches_jax(seed, h, w, n):
    """Angles within 1e-4 rad on >= 99.5% of keypoints, >= 99% of
    descriptors identical and median distance 0 bits (the two packages'
    float32 matrix products round the blurred tile differently, and a
    flipped rounding of round(16 tile) can flip a comparison)."""
    atlas = _atlas(seed, 2, h, w)
    xy, delta = _keypoints(seed + 10, 2, h, w, n)
    _, aj, dj = _jax_describe(atlas, xy, delta)
    at, dt = describe.describe_keypoints(T(atlas), T(xy), T(delta))
    assert at.shape == (2 * n,) and at.dtype == torch.float32
    assert dt.shape == (2 * n, 32) and dt.dtype == torch.uint8
    assert (_angle_diff(at.numpy(), aj) < 1e-4).mean() >= 0.995
    bits = np.unpackbits(dt.numpy() ^ dj, axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and np.median(bits) == 0


def test_describe_reference_is_exact_on_equal_blurred_tiles(monkeypatch):
    """With the JAX package's blurred tiles in place of its own, the plain
    version gives the JAX package's angle bins and descriptors bit for bit
    (integer moments, integer comparisons)."""
    atlas = _atlas(3)
    xy, delta = _keypoints(13, 2, 200, 160, 250)
    blur, aj, dj = _jax_describe(atlas, xy, delta)
    monkeypatch.setattr(describe, "shift_blur_tiles", lambda tiles, d: T(blur))
    at, dt = describe.describe_reference(T(atlas), T(xy), T(delta))
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_allclose(at.numpy(), aj, atol=1e-6)
    np.testing.assert_array_equal(tbrief.quantize_angle(at).numpy(), np.asarray(jbrief.quantize_angle(jnp.asarray(aj))))


def test_describe_is_the_stereo_extractors_composition():
    """describe_keypoints on the CPU is the composition the extractor ran
    before the fusion, unchanged in arithmetic: equality."""
    atlas = T(_atlas(4))
    xy, delta = (T(a) for a in _keypoints(14, 2, 200, 160, 100))
    tiles = torch.cat([patches.gather_patch_tiles(atlas[i], xy[i]) for i in range(2)])
    blur = describe.shift_blur_tiles(tiles, delta.reshape(-1, 2))
    angles = tbrief.ic_angle_from_tiles(blur)
    desc = tbrief.brief_descriptors_from_tiles(blur, angles)
    got_a, got_d = describe.describe_keypoints(atlas, xy, delta)
    assert torch.equal(got_a, angles) and torch.equal(got_d, desc)


def test_shift_blur_bands_hold_the_whole_matrices():
    bands = describe.shift_blur_bands()
    assert bands.shape == (3, 32, 9) and bands.dtype == np.float32
    for m, mat in enumerate(describe._shift_blur_mats()):
        rebuilt = np.zeros((32, 32), np.float32)
        for i in range(32):
            for o in range(9):
                if 0 <= i - 4 + o < 32:
                    rebuilt[i, i - 4 + o] = bands[m, i, o]
        np.testing.assert_array_equal(rebuilt, mat)
        np.testing.assert_allclose(mat.sum(1), 1.0, atol=1e-6)
    rows = describe.band_rows()          # the kernel's layout: [i, m * 9 + o], one float of padding
    assert rows.shape == (32, 28) and rows.dtype == np.float32 and not rows[:, 27].any()
    np.testing.assert_array_equal(rows[:, :27].reshape(32, 3, 9).transpose(1, 0, 2), bands)


def _emulate_describe_kernel(atlas, xy, delta):
    """csrc/orb_describe.cu step by step in numpy float32: banded products
    in ascending column order, the weighted sums rounded term by term,
    integer moments, the angle bin by the reciprocal product, and bits
    packed as little-endian 32-bit ballot words."""
    f32 = np.float32
    bands = describe.shift_blur_bands()
    rot = tbrief._rotated_flat_indices()
    b, n = xy.shape[:2]
    h, w = atlas.shape[1:]
    angles = np.zeros(b * n, f32)
    desc = np.zeros((b * n, 8), np.uint32)
    vv, uu = np.mgrid[0:32, 0:32] - 15
    disk = (uu * uu + vv * vv <= 225) & (uu <= 15) & (vv <= 15)
    for k in range(b * n):
        x, y = xy.reshape(-1, 2)[k]
        x0, y0 = min(max(x - 15, 0), w - 32), min(max(y - 15, 0), h - 32)
        tile = atlas[k // n, y0:y0 + 32, x0:x0 + 32]
        dx, dy = delta.reshape(-1, 2)[k]
        wx = (max(-dx, f32(0)), f32(1) - abs(dx), max(dx, f32(0)))
        wy = (max(-dy, f32(0)), f32(1) - abs(dy), max(dy, f32(0)))

        def banded(src):                       # out[m][i, :] = sum_j A_m[i, j] src[j, :]
            out = np.zeros((3, 32, 32), f32)
            for i in range(32):
                for o in range(9):
                    j = i - 4 + o
                    if 0 <= j < 32:
                        out[:, i, :] += bands[:, i, o, None] * src[j][None, :]
            return out

        pm, p0, pp = banded(tile)
        ty = (wy[0] * pm + wy[1] * p0) + wy[2] * pp
        pm, p0, pp = banded(ty.T)              # out[i, r] = sum_j A[i, j] ty[r, j]
        tb = ((wx[0] * pm + wx[1] * p0) + wx[2] * pp).T
        q = np.rint(tb * f32(16)).astype(np.int32)
        m10, m01, m00 = (int((q * uu)[disk].sum()), int((q * vv)[disk].sum()), int(q[disk].sum()))
        f10, f01, f00 = f32(m10), f32(m01), f32(m00)
        offset = np.sqrt(f10 * f10 + f01 * f01) / max(f00, f32(1e-6))
        a = np.arctan2(f01, f10) if offset >= 0.5 else f32(0)
        angles[k] = a
        bin_ = int(np.rint(f32(a) * f32(describe._INV_BIN))) % 30
        flat = q.reshape(-1)
        test = flat[rot[bin_, 256:]] > flat[rot[bin_, :256]]
        for g in range(8):
            desc[k, g] = sum(1 << lane for lane in range(32) if test[g * 32 + lane])
    return angles, desc.astype("<u4").view(np.uint8).reshape(b * n, 32)


def test_kernel_arithmetic_emulated_matches_plain_version():
    """The kernel's order of operations, emulated in numpy, against the
    plain version: the tolerance the card's comparison uses (angles within
    1e-4 rad on >= 99.5%, >= 99% of descriptors identical, median 0, none
    above 8 bits)."""
    atlas = _atlas(5, 2, 96, 128)
    xy, delta = _keypoints(15, 2, 96, 128, 60)
    ae, de = _emulate_describe_kernel(atlas, xy, delta)
    ap, dp = describe.describe_reference(T(atlas), T(xy), T(delta))
    assert (_angle_diff(ae, ap.numpy()) < 1e-4).mean() >= 0.995
    bits = np.unpackbits(de ^ dp.numpy(), axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and np.median(bits) == 0 and bits.max() <= 8


def _jax_sad(atlas_l, xy_l, atlas_r, cx, cy):
    """The SAD block of orb_line_slam_tpu/frontend/stereo.py:153-165."""
    W, S = jstereo.SAD_W, jstereo.SAD_SLIDE
    tiles = jax_gather(jnp.asarray(atlas_l), jnp.asarray(xy_l))
    patch = tiles[:, 15 - W:15 + W + 1, 15 - W:15 + W + 1]
    patch = patch - patch[:, W:W + 1, W:W + 1]
    strip = jstereo._gather_window(jnp.asarray(atlas_r), jnp.asarray(cx), jnp.asarray(cy), W, extra=S)
    sads = []
    for k in range(2 * S + 1):
        win = jax.lax.dynamic_slice_in_dim(strip, k, 2 * W + 1, axis=2)
        win = win - win[:, W:W + 1, W:W + 1]
        sads.append(jnp.sum(jnp.abs(patch - win), axis=(1, 2)))
    return np.asarray(jnp.stack(sads, axis=1))


def _sad_inputs(seed, h, w, n, fractional):
    atlas = _atlas(seed, 2, h, w)
    xy, _ = _keypoints(seed + 20, 1, h, w, n)
    rng = np.random.default_rng(seed + 30)
    cx = rng.uniform(-10, w + 10, n)
    cy = rng.uniform(-10, h + 10, n)
    cx[:6] = [0, w - 1, 15, w - 17, -3, w + 4]
    cy[:6] = [0, h - 1, 15, h - 17, h + 2, -5]
    if not fractional:           # the stereo matcher's centres are whole numbers
        cx, cy = np.floor(cx), np.floor(cy)
    return atlas[0], xy[0], atlas[1], cx.astype(np.float32), cy.astype(np.float32)


@pytest.mark.parametrize("seed,h,w,n,fractional", [(0, 200, 160, 300, False), (1, 64, 96, 150, True),
                                                   (2, 32, 32, 40, True)])
def test_stereo_sad_reference_matches_jax(seed, h, w, n, fractional):
    """Within 1e-3 absolute + 1e-5 relative (float32 sums of 121 terms in
    another order; a SAD of this noisy atlas is ~3000, where one float32
    step is 2.4e-4), and the same best slide."""
    args = _sad_inputs(seed, h, w, n, fractional)
    want = _jax_sad(*args)
    got = tsad.stereo_sad(*(T(a) for a in args))
    assert got.shape == (n, 11) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.numpy().argmin(1), want.argmin(1))


def _emulate_sad_kernel(atlas_l, xy_l, atlas_r, cx, cy):
    """csrc/stereo_sad.cu in numpy float32: windows addressed through the
    clamped tile origins, the blend term by term, each lane summing
    elements lane, lane + 32, ... and a butterfly over the 32 lanes."""
    f32 = np.float32
    h, w = atlas_l.shape
    n = len(cx)
    out = np.zeros((n, 11), f32)
    for k in range(n):
        x0 = min(max(xy_l[k, 0] - 15, 0), w - 32) + 10
        y0 = min(max(xy_l[k, 1] - 15, 0), h - 32) + 10
        left = atlas_l[y0:y0 + 11, x0:x0 + 11]
        left = (left - left[5, 5]).reshape(-1)
        xi, yi = np.floor(cx[k]), np.floor(cy[k])
        fx, fy = f32(cx[k] - xi), f32(cy[k] - yi)
        gx, gy = f32(1) - fx, f32(1) - fy
        x0 = min(max(int(xi) - 15, 0), w - 32) + 5
        y0 = min(max(int(yi) - 15, 0), h - 32) + 10
        src = atlas_r[y0:y0 + 12, x0:x0 + 22]
        strip = (gy * gx) * src[:-1, :-1]
        strip = strip + (gy * fx) * src[:-1, 1:]
        strip = strip + (fy * gx) * src[1:, :-1]
        strip = strip + (fy * fx) * src[1:, 1:]
        for s in range(11):
            win = (strip[:, s:s + 11] - strip[5, s + 5]).reshape(-1)
            term = np.abs(left - win)
            lanes = np.zeros(32, f32)
            for e in range(121):
                lanes[e % 32] += term[e]
            for m in (16, 8, 4, 2, 1):
                lanes = lanes + lanes[np.arange(32) ^ m]
            out[k, s] = lanes[0]
    return out


@pytest.mark.parametrize("fractional", [False, True])
def test_sad_kernel_arithmetic_emulated_matches_plain_version(fractional):
    """|sad - plain| <= 1e-5 plain + 1e-2 and equal argmin: the tolerance
    the card's comparison uses."""
    args = _sad_inputs(7, 80, 120, 80, fractional)
    emu = _emulate_sad_kernel(*args)
    ref = tsad.stereo_sad_reference(*(T(a) for a in args)).numpy()
    assert (np.abs(emu - ref) <= 1e-5 * ref + 1e-2).all()
    np.testing.assert_array_equal(emu.argmin(1), ref.argmin(1))


def test_cpu_tensors_take_plain_versions_without_counting():
    atlas = T(_atlas(8, 2, 64, 64))
    xy, delta = (T(a) for a in _keypoints(18, 2, 64, 64, 20))
    before = (describe.launches, tsad.launches, patches.launches)
    a, d = describe.describe_keypoints(atlas, xy, delta)
    sad = tsad.stereo_sad(atlas[0], xy[0], atlas[1], torch.full((20,), 30.0), torch.full((20,), 31.0))
    assert a.shape == (40,) and d.shape == (40, 32) and sad.shape == (20, 11)
    assert (describe.launches, tsad.launches, patches.launches) == before


def test_describe_rejects_bad_inputs():
    atlas = torch.zeros((2, 40, 48))
    xy = torch.zeros((2, 5, 2), dtype=torch.int32)
    delta = torch.zeros((2, 5, 2))
    describe.describe_keypoints(atlas, xy, delta)
    with pytest.raises(TypeError):
        describe.describe_keypoints(atlas.double(), xy, delta)
    with pytest.raises(TypeError):
        describe.describe_keypoints(atlas, xy.long(), delta)
    with pytest.raises(TypeError):
        describe.describe_keypoints(atlas, xy, delta.double())
    with pytest.raises(ValueError):
        describe.describe_keypoints(torch.zeros((2, 20, 48)), xy, delta)          # smaller than a tile
    with pytest.raises(ValueError):
        describe.describe_keypoints(torch.zeros((2, 40, 96))[:, :, ::2], xy, delta)  # not contiguous
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas[0], xy, delta)                          # no batch axis
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas, xy, delta[:, :4])                      # delta / keypoint mismatch
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas, xy, delta.to("meta"))                  # device mix


def test_stereo_sad_rejects_bad_inputs():
    al, ar = torch.zeros((40, 48)), torch.zeros((40, 48))
    xy = torch.zeros((5, 2), dtype=torch.int32)
    cx, cy = torch.zeros(5), torch.zeros(5)
    tsad.stereo_sad(al, xy, ar, cx, cy)
    with pytest.raises(TypeError):
        tsad.stereo_sad(al.double(), xy, ar, cx, cy)
    with pytest.raises(TypeError):
        tsad.stereo_sad(al, xy.long(), ar, cx, cy)
    with pytest.raises(TypeError):
        tsad.stereo_sad(al, xy, ar, cx.double(), cy)
    with pytest.raises(ValueError):
        tsad.stereo_sad(torch.zeros((20, 48)), xy, torch.zeros((20, 48)), cx, cy)  # smaller than a tile
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, torch.zeros((40, 50)), cx, cy)                     # atlas shapes differ
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, ar, torch.zeros(10)[::2], cy)                      # not contiguous
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, ar, cx[:4], cy)                                    # centre count
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, ar.to("meta"), cx, cy)                             # device mix


def test_stereo_path_makes_no_tile_tensor():
    """extract_orb_stereo hands the stereo matcher atlases and integer
    keypoints: nothing it returns has a 32x32 tile axis."""
    from orb_line_slam_tpu_torch.config import OrbConfig
    from orb_line_slam_tpu_torch.frontend.orb_extractor import extract_orb_stereo

    rng = np.random.default_rng(9)
    l, r = (T(rng.integers(0, 255, (96, 160)).astype(np.uint8)) for _ in range(2))
    cfg = OrbConfig(n_features=200, n_levels=2)
    featL, atlasL, axyL, deltaL, featR, atlasR, offs = extract_orb_stereo(l, r, cfg)
    assert atlasL.shape == atlasR.shape and atlasL.dim() == 2
    assert axyL.shape == (200, 2) and axyL.dtype == torch.int32 and deltaL.shape == (200, 2)
    for t in (*featL, *featR, axyL, deltaL, offs):
        assert tuple(t.shape[-2:]) != (32, 32)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_loader_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no such thing' >&2\nexit 2\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build(("stereo_sad",))
    assert not (tmp_path / "build" / "libstereo_sad.so").exists()


def test_loader_builds_every_source_once(tmp_path, monkeypatch):
    """One compiler process per source; a library newer than its source is
    not rebuilt."""
    log = tmp_path / "calls.log"
    script = f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, script)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    _build.build()
    for name in _build.SOURCES:
        assert _build.library_path(name).exists() and (_build.CSRC / f"{name}.cu").exists()
    calls = log.read_text().splitlines()
    assert len(calls) == len(_build.SOURCES) == 4
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    _build.build()
    assert len(log.read_text().splitlines()) == 4
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")]
