"""Tests that need a CUDA card: the hand-written kernels (patch tiles,
ORB detection over every level of one image, a pair or a batch, equal to
its plain version, fused describe, fused stereo SAD, one pair or a batch
of pairs, the two
front-end kernels bit for bit against the numpy emulation of their
order of operations in tests/torch_kernel_emulation.py, the pose
solve at the three cells' shapes, one solve or a batch in one launch)
against their plain versions, and the point front end (one pair or a
batch), the line front end and the frames of mono and RGB-D images on
the card against the CPU, and the tracer's spans holding the blocking
CUDA calls they issue.  They skip where no card is present; run them on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

This file imports torch, the port and the benchmark's span readers
(``slambench/spans.py``) only, and --noconftest skips
tests/conftest.py, which imports jax (the card's machine has no jax).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from orb_line_slam_tpu_torch.backend import pose_opt
from orb_line_slam_tpu_torch.ops import describe, detect, patches, stereo_sad

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


def _detect_images(seed, b, h, w, kind="smooth"):
    """[b, h, w] float32 images: low-passed noise with corners and flats,
    or quantised plateaus beside a checkerboard (equal scores everywhere),
    or a blank image."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy((rng.random((b, 1, h, w)) * 255).astype(np.float32))
    img = (torch.nn.functional.avg_pool2d(noise, 5, 1, 2, count_include_pad=False) * 0.6 + noise * 0.4)[:, 0]
    if kind == "ties":
        img = torch.floor(img / 48) * 48
        yy, xx = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
        img[:, :, w // 2:] = (((yy // 5 + xx // 5) % 2) * 120.0 + 40.0)[:, w // 2:]
    if kind == "blank":
        img = torch.full((b, h, w), 77.0)
    return img.contiguous()


def _detect_both(cuda, img, cfg):
    """The kernel's and the plain version's outputs on the same card
    pyramid and atlas, and the kernel's launches."""
    from orb_line_slam_tpu_torch.ops.image import build_pyramid, pyramid_atlas

    levels = build_pyramid(img.to(cuda), cfg.n_levels, cfg.scale_factor)
    atlas, _ = pyramid_atlas(levels)
    before = detect.launches
    got = detect.detect_keypoints(levels, atlas, cfg)
    torch.cuda.synchronize()
    ran = detect.launches - before
    return got, detect.detect_reference(levels, cfg), ran


def _assert_detect_equal(got, want):
    for name, g, w in zip(("xy", "axy", "resp", "octave", "valid", "delta"), got, want):
        assert g.device.type == "cuda" and g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), f"{name}: {(g != w).sum().item()} elements differ"


@pytest.mark.parametrize("b", [1, 2, 8])
@pytest.mark.parametrize("cell", [(376, 1241, 2000), (480, 752, 1200), (480, 640, 1000)])
def test_detect_kernel_equals_plain_version(cuda, cell, b):
    """orb_detect at the KITTI, EuRoC and TUM shapes, on one image ([H, W]),
    a stereo pair and a batch of 8: all six outputs equal the plain
    version's on the same card pyramid, in two launches whatever the batch."""
    from orb_line_slam_tpu_torch.config import OrbConfig

    h, w, n = cell
    cfg = OrbConfig(n_features=n)
    img = _detect_images(h + b, b, h, w)
    got, want, ran = _detect_both(cuda, img[0] if b == 1 else img, cfg)
    assert ran == detect.LAUNCHES_PER_CALL
    assert got[0].shape == ((n, 2) if b == 1 else (b, n, 2))
    _assert_detect_equal(got, want)
    assert (want[4].sum(-1) > 0.5 * n).all()


@pytest.mark.parametrize("kind,h,w,n", [("ties", 240, 320, 800), ("blank", 120, 160, 300), ("smooth", 40, 48, 300)])
def test_detect_kernel_equals_plain_version_on_ties_blanks_and_padding(cuda, kind, h, w, n):
    """Equal scores everywhere (plateaus, a checkerboard), a blank pair
    (every row invalid), and a small pair whose levels hold fewer
    candidate slots than their quota (the padded rows)."""
    from orb_line_slam_tpu_torch.config import OrbConfig
    from orb_line_slam_tpu_torch.ops.image import pyramid_shapes

    cfg = OrbConfig(n_features=n, n_levels=3)
    got, want, ran = _detect_both(cuda, _detect_images(h * w, 2, h, w, kind), cfg)
    assert ran == detect.LAUNCHES_PER_CALL
    _assert_detect_equal(got, want)
    if kind == "blank":
        assert not want[4].any()
    if kind == "smooth":
        t = detect.level_table(pyramid_shapes(h, w, cfg.n_levels, cfg.scale_factor), cfg)
        assert any(c * k < q for c, k, q in zip(t["n_cells"], t["k"], t["quota"]))


def test_detect_kernel_rejects_mixed_devices(cuda):
    from orb_line_slam_tpu_torch.config import OrbConfig
    from orb_line_slam_tpu_torch.ops.image import build_pyramid, pyramid_atlas

    cfg = OrbConfig(n_features=100, n_levels=2)
    levels = build_pyramid(_detect_images(1, 1, 64, 64)[0], 2, cfg.scale_factor)
    atlas, _ = pyramid_atlas(levels)
    with pytest.raises(ValueError):
        detect.detect_keypoints(levels, atlas.to(cuda), cfg)


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


def test_batched_stereo_sad_kernel_matches_plain_in_one_launch(cuda):
    """Three pairs in one launch: the same tolerances as one pair, against
    the batched plain version and against the kernel on each pair alone."""
    b, h, w, n = 3, 200, 300, 120
    rng = np.random.default_rng(b)
    noise = torch.from_numpy((rng.random((2 * b, 1, h, w)) * 255).astype(np.float32)).to(cuda)
    atlas = torch.nn.functional.avg_pool2d(noise, 5, 1, 2, count_include_pad=False)[:, 0].contiguous()
    xy = np.stack([rng.integers(-20, w + 20, (b, n)), rng.integers(-20, h + 20, (b, n))], -1).astype(np.int32)
    axy = torch.from_numpy(xy).to(cuda)
    cx = (axy[..., 0].float() - torch.from_numpy(rng.uniform(0, 60, (b, n)).astype(np.float32)).to(cuda)).contiguous()
    cy = (axy[..., 1].float() + torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32)).to(cuda)).contiguous()
    before = stereo_sad.launches
    sad = stereo_sad.stereo_sad(atlas[:b], axy, atlas[b:], cx, cy)
    torch.cuda.synchronize()
    assert stereo_sad.launches == before + 1 and sad.shape == (b, n, 11)
    ref = stereo_sad.stereo_sad_reference(atlas[:b], axy, atlas[b:], cx, cy)
    assert bool(((sad - ref).abs() <= 1e-5 * ref + 1e-2).all())
    assert float((sad.argmin(-1) == ref.argmin(-1)).float().mean()) >= 0.999
    for i in range(b):
        assert torch.equal(sad[i], stereo_sad.stereo_sad(atlas[i], axy[i], atlas[b + i], cx[i], cy[i]))


def _emulation():
    """tests/torch_kernel_emulation.py: the numpy emulations of the two
    front-end kernels' order of operations (no jax)."""
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_emulation", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_kernel_emulation.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _card_atan2(y, x):
    """The card's float32 atan2 (the kernel's atan2f) on numpy arrays."""
    yt, xt = (torch.from_numpy(np.ascontiguousarray(a, np.float32)).cuda() for a in (y, x))
    return torch.atan2(yt, xt).cpu().numpy()


@pytest.mark.parametrize("h,w,n", [(100, 300, 40), (40, 40, 24)])
def test_describe_kernel_is_the_emulations_bits(cuda, h, w, n):
    """The kernel's angles and descriptors equal, bit for bit, the numpy
    emulation of the first design's order (three 9-tap products per
    output, fused multiply-adds in ascending columns; the card's atan2f),
    on border, clamped and +-0.5-offset keypoints; a rerun gives the same
    bits."""
    atlas, axy, delta = _atlas_and_keypoints(cuda, h, w, n, 3 * n + h)
    delta[:, :4] = torch.tensor([[0.5, 0.5], [-0.5, -0.5], [0.5, -0.5], [0.0, 0.0]], device=cuda)
    ang, desc = describe.describe_keypoints(atlas, axy, delta)
    torch.cuda.synchronize()
    want_a, want_d = _emulation().describe_todays_order(atlas.cpu().numpy(), axy.cpu().numpy(), delta.cpu().numpy(),
                                                        atan2=_card_atan2)
    np.testing.assert_array_equal(desc.cpu().numpy(), want_d)
    np.testing.assert_array_equal(ang.cpu().numpy().view(np.uint32), want_a.view(np.uint32))
    again_a, again_d = describe.describe_keypoints(atlas, axy, delta)
    assert torch.equal(again_d, desc) and torch.equal(again_a.view(torch.int32), ang.view(torch.int32))


@pytest.mark.parametrize("fractional", [False, True])
def test_stereo_sad_kernel_is_the_emulations_bits(cuda, fractional):
    """The kernel's sums equal, bit for bit, the numpy emulation of the
    first design's order (lane partials in ascending elements, one
    butterfly per slide), at whole and fractional centres, border and
    clamped windows among them; a rerun gives the same bits."""
    h, w, n = 100, 300, 48
    atlas, axy, _ = _atlas_and_keypoints(cuda, h, w, n, 5 + fractional)
    rng = np.random.default_rng(11 + fractional)
    cx = np.floor(axy[0, :, 0].cpu().numpy() - rng.uniform(0, 60, n)).astype(np.float32)
    cy = axy[0, :, 1].cpu().numpy().astype(np.float32)
    cx[:4], cy[:4] = [0, w - 1, -3, w + 4], [0, h - 1, h + 2, -5]
    if fractional:
        cx, cy = cx + rng.uniform(0, 1, n).astype(np.float32), cy + rng.uniform(0, 1, n).astype(np.float32)
    args = (atlas[0], axy[0], atlas[1], torch.from_numpy(cx).to(cuda), torch.from_numpy(cy).to(cuda))
    sad = stereo_sad.stereo_sad(*args)
    torch.cuda.synchronize()
    want = _emulation().sad_todays_order(*(a.cpu().numpy() for a in args))
    np.testing.assert_array_equal(sad.cpu().numpy().view(np.uint32), want.view(np.uint32))
    assert torch.equal(stereo_sad.stereo_sad(*args).view(torch.int32), sad.view(torch.int32))


def test_batch_of_eight_pairs_is_one_launch_of_each_front_end_kernel(cuda):
    """orb_detect over the 16 images of 8 stereo pairs (its two launches),
    orb_describe over the 16 images and stereo_sad over the 8 pairs: one
    launch each, and each image's or pair's outputs the bits of its own
    launch."""
    from orb_line_slam_tpu_torch.config import OrbConfig
    from orb_line_slam_tpu_torch.ops.image import build_pyramid, pyramid_atlas

    b, h, w, n = 8, 120, 200, 64
    rng = np.random.default_rng(8)
    noise = torch.from_numpy((rng.random((2 * b, 1, h, w)) * 255).astype(np.float32)).to(cuda)
    atlas = torch.nn.functional.avg_pool2d(noise, 5, 1, 2, count_include_pad=False)[:, 0].contiguous()
    xy = np.stack([rng.integers(-20, w + 20, (2 * b, n)), rng.integers(-20, h + 20, (2 * b, n))], -1)
    axy = torch.from_numpy(xy.astype(np.int32)).to(cuda)
    delta = torch.from_numpy(rng.uniform(-0.5, 0.5, (2 * b, n, 2)).astype(np.float32)).to(cuda)
    cx = (axy[:b, :, 0].float() - torch.from_numpy(rng.uniform(0, 60, (b, n)).astype(np.float32)).to(cuda)).contiguous()
    cy = (axy[:b, :, 1].float() + torch.from_numpy(rng.uniform(0, 1, (b, n)).astype(np.float32)).to(cuda)).contiguous()
    cfg = OrbConfig(n_features=300, n_levels=4)
    levels = build_pyramid(noise[:, 0].contiguous(), cfg.n_levels, cfg.scale_factor)
    pyr, _ = pyramid_atlas(levels)
    before = (describe.launches, stereo_sad.launches, detect.launches)
    found = detect.detect_keypoints(levels, pyr, cfg)
    ang, desc = describe.describe_keypoints(atlas, axy, delta)
    sad = stereo_sad.stereo_sad(atlas[:b], axy[:b].contiguous(), atlas[b:], cx, cy)
    torch.cuda.synchronize()
    assert (describe.launches, stereo_sad.launches, detect.launches) == (
        before[0] + 1, before[1] + 1, before[2] + detect.LAUNCHES_PER_CALL)
    assert ang.shape == (2 * b * n,) and sad.shape == (b, n, 11) and found[0].shape == (2 * b, 300, 2)
    for i in range(2 * b):
        a1, d1 = describe.describe_keypoints(atlas[i:i + 1], axy[i:i + 1], delta[i:i + 1])
        assert torch.equal(d1, desc[i * n:(i + 1) * n]) and torch.equal(a1, ang[i * n:(i + 1) * n])
        one = detect.detect_keypoints([l[i:i + 1] for l in levels], pyr[i:i + 1].contiguous(), cfg)
        assert all(torch.equal(o[0], f[i]) for o, f in zip(one, found))
    for i in range(b):
        assert torch.equal(stereo_sad.stereo_sad(atlas[i], axy[i], atlas[b + i], cx[i], cy[i]), sad[i])


def test_batched_frames_on_card_launch_each_kernel_once(cuda):
    """build_stereo_frames on three pairs: one orb_describe over the six
    images and one stereo_sad over the three pairs, no tile gather; each
    pair's frame held to the CPU frame under the frame contract."""
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frames

    cam = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=False))
    scene = SyntheticScene(cam, n_points=900, seed=5, extent=((-24, 40), (-4, 4), (-32, 32)))
    pairs = [scene.render_stereo(np.eye(3), np.array([0.0, 0.0, -z])) for z in (0.0, 0.4, 0.8)]
    left = torch.from_numpy(np.stack([p[0] for p in pairs]))
    right = torch.from_numpy(np.stack([p[1] for p in pairs]))
    fc = build_stereo_frames(left, right, cfg).numpy()
    before = (patches.launches, describe.launches, stereo_sad.launches)
    fg = build_stereo_frames(left.to(cuda), right.to(cuda), cfg).numpy()
    assert (patches.launches, describe.launches, stereo_sad.launches) == (before[0], before[1] + 1, before[2] + 1)
    assert fg.xy.shape == (3, 1000, 2) and fg.depth.shape == (3, 1000)
    for i in range(3):
        assert (fc.valid[i] == fg.valid[i]).mean() > 0.98
        both = fc.valid[i] & fg.valid[i]
        assert np.abs(fc.xy[i][both] - fg.xy[i][both]).max() < 0.51
        dc, dg = fc.depth[i][both], fg.depth[i][both]
        assert ((dc > 0) == (dg > 0)).mean() > 0.95
        hit = (dc > 0) & (dg > 0)
        assert hit.sum() > 100 and (np.abs(dc[hit] - dg[hit]) / dc[hit] < 0.01).mean() > 0.95


def test_batched_frame_track_on_card_has_no_vmap_fallback(cuda):
    """One batched_frame_track of two sequences on the card, lines on, with
    functorch's per-sample fallback warning raised as an error (an operator
    without a batching rule in this torch release would multiply the
    launches by B); each sequence's TrackOut equals the unbatched
    track_step on the same tensors within 1e-4 (rad, m), assoc_gid on
    >= 99% of rows."""
    import warnings

    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
    from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frames
    from orb_line_slam_tpu_torch.frontend.line_extractor import build_line_features
    from orb_line_slam_tpu_torch.geometry.host import nbackproject
    from orb_line_slam_tpu_torch.parallel.multi_sequence import _stack, _take
    from orb_line_slam_tpu_torch.pipeline.track_step import MapMirror, batched_frame_track, track_step
    from orb_line_slam_tpu_torch.slam_map.map_store import MapStore

    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=512, n_levels=4), lines=LineConfig(n_lines=32),
                     map=MapConfig(max_keyframes=16, max_points=4096, local_points=1024))
    per_seq, imgs = [], []
    for seed in (3, 9):
        scene = SyntheticScene(cam, n_points=700, n_lines=30, seed=seed, extent=((-14, 14), (-6, 6), (8, 60)))
        pairs = [scene.render_stereo(np.eye(3), -np.array([0.0, 0.0, z])) for z in (0.0, 0.3)]
        imgs.append(pairs[1])
        left0 = torch.from_numpy(pairs[0][0])[None].to(cuda)
        f0 = _take(build_stereo_frames(left0, torch.from_numpy(pairs[0][1])[None].to(cuda), cfg), 0)
        lf = build_line_features(left0[0], torch.from_numpy(pairs[0][1]).to(cuda), cam, cfg.lines).numpy()
        fh = f0.numpy()
        store = MapStore(cfg.map, cfg.orb.n_features, n_lines=32)
        kf = store.add_keyframe(fh, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0, 0.0)
        idx = np.nonzero(fh.valid & (fh.depth > 0))[0]
        ids = store.add_points(nbackproject(cam, fh.xy, fh.depth)[idx], fh.desc[idx], fh.octave[idx], kf, idx)
        snap = np.full(cfg.map.local_points, -1, np.int32)
        snap[: len(ids)] = ids
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
        mir = MapMirror(*(t(a) for a in (store.pt_pos, store.pt_desc, store.pt_oct, store.pt_valid,
                                         store.pt_max_dist, store.pt_min_dist, store.pt_normal)))
        zeros = lambda n: torch.zeros(n, dtype=torch.int32, device=cuda)  # noqa: E731
        s = nbackproject(cam, lf.p0, np.where(lf.depth0 > 0, lf.depth0, 10.0)).astype(np.float32)
        e = nbackproject(cam, lf.p1, np.where(lf.depth1 > 0, lf.depth1, 10.0)).astype(np.float32)
        per_seq.append((f0, mir, torch.full((512,), -1, dtype=torch.int32, device=cuda),
                        torch.eye(3, device=cuda), torch.zeros(3, device=cuda), torch.eye(3, device=cuda),
                        torch.zeros(3, device=cuda), torch.tensor(False, device=cuda), f0.xy, f0.desc, f0.angle,
                        t(store.kf_obs_lm[kf].astype(np.int32)), t(snap), zeros(1024), zeros(1024), zeros(32),
                        zeros(32), t(s), t(e), t(lf.desc), t(lf.valid)))
    stacked = tuple(_stack(list(items)) for items in zip(*per_seq))
    left = torch.from_numpy(np.stack([p[0] for p in imgs])).to(cuda)
    right = torch.from_numpy(np.stack([p[1] for p in imgs])).to(cuda)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            before = (describe.launches, stereo_sad.launches, pose_opt.launches)
            frames, lfs, outs = batched_frame_track(left, right, stacked, cfg, has_lines=True)
            torch.cuda.synchronize()
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    # One launch of each front-end kernel and three pose solves (paths A
    # and B, the final solve), each one launch for both sequences.
    assert (describe.launches, stereo_sad.launches, pose_opt.launches) == (before[0] + 1, before[1] + 1, before[2] + 3)
    last_frame, mir, *rest = stacked
    for b in range(2):
        want = track_step(_take(frames, b), _take(last_frame, b), _take(mir, b), *(x[b] for x in rest[:15]),
                          _take(lfs, b), *(x[b] for x in rest[15:]), cfg=cfg, has_lines=True)
        got = _take(outs, b)
        assert int(want.n_inliers) > 50
        assert float((got.R - want.R).abs().max()) <= 1e-4 and float((got.t - want.t).abs().max()) <= 1e-4
        assert float((got.assoc_gid == want.assoc_gid).float().mean()) >= 0.99


def _chip_smoke():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pose_inputs(cs, cfg, seed, M, L, dev):
    """pose_optimize's arguments (positional, line keywords) for one of
    chip_smoke.py's seeded pose problems, on dev."""
    t = [torch.from_numpy(a).to(dev) for a in cs.pose_problem(cfg.camera, seed, M, L)]
    keys = ("line_start_w", "line_end_w", "line_obs", "line_octave", "line_valid")
    return t[:6], dict(zip(keys, t[6:]))


@pytest.mark.parametrize("cell", ["point", "point+line", "loop"])
@pytest.mark.parametrize("rounds,iters", [(4, 10), (2, 8)])
def test_pose_solve_kernel_matches_plain(cuda, cell, rounds, iters):
    """pose_optimize on CUDA tensors is one launch of csrc/pose_solve.cu,
    held to its plain version on the same tensors at the cell's points and
    (final solve) lines: 1e-3 rad, 5e-3 m, n_inliers within 3, the inlier
    masks equal on >= 99.5% of rows."""
    cs = _chip_smoke()
    cfg = {"point": cs.kitti_config, "point+line": cs.euroc_config, "loop": cs.loop_config}[cell]()
    M = cfg.orb.n_features
    L = cfg.lines.n_lines if cfg.lines.enabled and (rounds, iters) == (4, 10) else 0
    for seed in range(3):
        args, kw = _pose_inputs(cs, cfg, seed, M, L, cuda)
        before = pose_opt.launches
        got = pose_opt.pose_optimize(*args, cfg.camera, cfg.orb.scale_factor, rounds=rounds, iters=iters, **kw)
        torch.cuda.synchronize()
        assert pose_opt.launches == before + 1
        want = pose_opt.pose_optimize_reference(*args, cfg.camera, cfg.orb.scale_factor, rounds=rounds, iters=iters,
                                                **kw)
        assert got.R.is_cuda and got.inliers.shape == (M,) and got.line_inliers.shape == (L,)
        assert cs.rotation_gap(got.R.cpu().numpy()[None], want.R.cpu().numpy()[None]) < 1e-3
        assert float((got.t - want.t).abs().max()) < 5e-3
        assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 3
        assert float((got.inliers == want.inliers).float().mean()) >= 0.995
        if L:
            assert float((got.line_inliers == want.line_inliers).float().mean()) >= 0.995
        assert int(got.n_inliers) == int(got.inliers.sum()) + int(got.line_inliers.sum())


def test_pose_solve_batch_of_four_is_one_launch(cuda):
    """torch.func.vmap of pose_optimize over 4 problems (the batched step's
    shape: 2000 points, 128 lines, 4x10) is one launch of 4 clusters, each
    solve bit-identical to the kernel on that problem alone."""
    cs = _chip_smoke()
    cfg = cs.bench_pipeline_config()
    per = [_pose_inputs(cs, cfg, 10 + b, cfg.orb.n_features, cfg.lines.n_lines, cuda) for b in range(4)]
    args = [torch.stack([p[0][i] for p in per]) for i in range(6)]
    kw = {k: torch.stack([p[1][k] for p in per]) for k in per[0][1]}
    before = pose_opt.launches
    got = torch.func.vmap(lambda a, k: pose_opt.pose_optimize(*a, cfg.camera, cfg.orb.scale_factor, **k))(args, kw)
    torch.cuda.synchronize()
    assert pose_opt.launches == before + 1 and got.R.shape == (4, 3, 3)
    for b, (a, k) in enumerate(per):
        one = pose_opt.pose_optimize(*a, cfg.camera, cfg.orb.scale_factor, **k)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)


def test_pose_solve_reruns_give_the_same_bits(cuda):
    """Two launches on the same inputs (the point cell's 4x10 with the
    bench pipeline's lines: a cluster of 8 CTAs) give the same bits: the
    sums are taken in a fixed order within and across the CTAs."""
    cs = _chip_smoke()
    cfg = cs.bench_pipeline_config()
    args = cs.pose_op_args(cfg, 5, cfg.orb.n_features, cfg.lines.n_lines)
    assert pose_opt.cluster_size(cfg.orb.n_features, cfg.lines.n_lines) == 8
    first = pose_opt.pose_solve_cuda(*args, 4, 10)
    second = pose_opt.pose_solve_cuda(*args, 4, 10)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


def test_pose_solve_batch_of_eight_is_one_launch(cuda):
    """A batch of 8 solves at the point cell's shape (2000 points, 4x10) is
    one launch of 8 clusters, and each solve is bit-identical to itself
    launched alone."""
    cs = _chip_smoke()
    cfg = cs.kitti_config()
    args = cs.pose_batch_args(cfg, 30, cfg.orb.n_features, 0, B=8)
    before = pose_opt.launches
    got = pose_opt.pose_solve_cuda(*args, 4, 10)
    torch.cuda.synchronize()
    assert pose_opt.launches == before + 1 and got[0].shape == (8, 3, 3)
    for b in range(8):
        one = pose_opt.pose_solve_cuda(*(x[b] for x in args[:11]), *args[11:], 4, 10)
        for x, y in zip(got, one):
            assert torch.equal(x[b], y)


def test_pose_solve_beyond_the_shared_memory_cap_raises(cuda):
    """A CTA's share of the rows must fit in its shared memory: 70,000
    points (8,750 a CTA) do not, and the wrapper raises before launching."""
    cs = _chip_smoke()
    cfg = cs.kitti_config()
    M = 70000
    assert pose_opt.shared_bytes(M, 0, 4, 10) > pose_opt.MAX_SHARED_BYTES
    args = cs.pose_op_args(cfg, 7, M, 0)
    before = pose_opt.launches
    with pytest.raises(ValueError, match="shared memory"):
        pose_opt.pose_solve_cuda(*args, 4, 10)
    assert pose_opt.launches == before


def test_pose_solve_rejects_mixed_devices(cuda):
    cs = _chip_smoke()
    cfg = cs.loop_config()
    args, _ = _pose_inputs(cs, cfg, 0, 100, 0, cuda)
    args[3] = args[3].cpu()
    with pytest.raises((ValueError, RuntimeError)):
        pose_opt.pose_optimize(*args, cfg.camera)


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
    before = (patches.launches, describe.launches, stereo_sad.launches, detect.launches)
    fg = build_stereo_frame(torch.from_numpy(l).to(cuda), torch.from_numpy(r).to(cuda), cfg).numpy()
    # Two fused kernels per stereo pair, the detection's two launches, and no tile gather.
    assert (patches.launches, describe.launches, stereo_sad.launches, detect.launches) == (
        before[0], before[1] + 1, before[2] + 1, before[3] + detect.LAUNCHES_PER_CALL)
    assert (fc.valid == fg.valid).mean() > 0.98
    both = fc.valid & fg.valid
    assert np.abs(fc.xy[both] - fg.xy[both]).max() < 0.51
    assert np.median(np.unpackbits(fc.desc[both] ^ fg.desc[both], axis=1).sum(1)) <= 1
    hit = (fc.depth[both] > 0) & (fg.depth[both] > 0)
    assert ((fc.depth[both] > 0) == (fg.depth[both] > 0)).mean() > 0.95
    assert (np.abs(fc.depth[both][hit] - fg.depth[both][hit]) / fg.depth[both][hit] < 0.01).mean() > 0.95


@pytest.mark.parametrize("kind", ["mono", "rgbd"])
def test_mono_and_rgbd_frames_on_card_match_cpu(cuda, kind):
    """build_mono_frame / build_rgbd_frame on the card launch one
    orb_describe (a batch of one) and no patch_tiles, and hold to the CPU
    plain path under the frame contract."""
    from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
    from orb_line_slam_tpu_torch.frontend.frame import build_mono_frame, build_rgbd_frame

    cam = CameraIntrinsics(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989, bf=40.0, width=640, height=480)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=8), lines=LineConfig(enabled=False))
    img, depth = SyntheticScene(cam, n_points=1500, seed=7, extent=((-4, 4), (-3, 3), (1, 8))).render_rgbd(
        np.eye(3), np.zeros(3))
    args = (torch.from_numpy(img),) if kind == "mono" else (torch.from_numpy(img), torch.from_numpy(depth))
    build = build_mono_frame if kind == "mono" else build_rgbd_frame
    fc = build(*args, cfg).numpy()
    before = (patches.launches, describe.launches, stereo_sad.launches)
    fg = build(*(a.to(cuda) for a in args), cfg)
    assert fg.xy.device.type == "cuda"
    fg = fg.numpy()
    assert (patches.launches, describe.launches, stereo_sad.launches) == (before[0], before[1] + 1, before[2])
    assert (fc.valid == fg.valid).mean() > 0.98
    both = fc.valid & fg.valid
    assert np.abs(fc.xy[both] - fg.xy[both]).max() < 0.51
    assert np.median(np.unpackbits(fc.desc[both] ^ fg.desc[both], axis=1).sum(1)) <= 1
    dc, dg = fc.depth[both], fg.depth[both]
    if kind == "mono":
        assert (dg == -1).all() and (fg.u_right == -1).all()
    else:
        hit = (dc > 0) & (dg > 0)
        assert hit.sum() > 300 and ((dc > 0) == (dg > 0)).mean() > 0.95
        assert (np.abs(dc[hit] - dg[hit]) / dc[hit] < 0.01).mean() > 0.95


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


def test_worker_runs_its_jobs_on_its_own_stream_after_the_submitters_work(cuda):
    """utils/worker.py on the card: a job runs on the worker's stream, not
    the submitting thread's, and sees what the submitting thread queued on
    its stream before the submit (a long kernel chain still in flight)."""
    from orb_line_slam_tpu_torch.utils.worker import Worker

    w = Worker("cuda-test-worker", cuda)
    try:
        x = torch.zeros(4096, 4096, device=cuda)
        for _ in range(50):                  # queued on the current stream, not finished at submit
            x.add_(1.0)
        main = torch.cuda.current_stream(cuda).cuda_stream

        def job():
            return torch.cuda.current_stream(cuda).cuda_stream, float(x[0, 0] + x[-1, -1])

        stream, total = w.submit(job).result(timeout=60)
        assert stream != main and total == 100.0
    finally:
        w.stop()
    assert not w.is_alive()


def _small_gba(n_shards, device):
    """multihost_worker's problem (12 cameras, 512 landmarks, 3,072
    observations, 5 + 10 LM x 48 CG) solved on n_shards slots of device."""
    from orb_line_slam_tpu_torch.parallel.multihost import device_mesh
    from orb_line_slam_tpu_torch.parallel.multihost_worker import SMALL_ITERS, small_problem
    from orb_line_slam_tpu_torch.parallel.sharded_ba import distributed_ba_cg, shard_gba_pack, unshard_result

    cam, pack = small_problem()
    args, meta = shard_gba_pack(pack, n_shards)
    i1, i2, ncg = SMALL_ITERS
    R, t, pts, inl, chi2 = (x.cpu().numpy() for x in distributed_ba_cg(
        device_mesh(device, n_shards), cam, *args, iters1=i1, iters2=i2, cg_iters=ncg))
    return (R, t) + unshard_result(pts, inl, meta, len(pack["obs_cam"])) + (chi2,)


def _within_pose_contract(a, b):
    d = np.einsum("cij,ckj->cik", a[0].astype(np.float64), b[0].astype(np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], -1)
    angle = np.arcsin(np.clip(np.linalg.norm(w, axis=1) / 2, 0, 1)).max()     # the skew part: exact near 0
    assert angle < 1e-3 and np.abs(a[1] - b[1]).max() < 5e-3
    assert np.median(np.linalg.norm(a[2] - b[2], axis=1)) < 1e-4
    assert abs(int(a[3].sum()) - int(b[3].sum())) <= 3
    assert abs(float(a[4]) - float(b[4])) < 1e-3 * abs(float(b[4])) + 1e-2


def test_sharded_gba_on_card_matches_single_solver_and_cpu(cuda):
    """Four shards on cuda:0 against bundle_adjust_cg on the card (the same
    gauge) and against the same sharded call on CPU tensors."""
    from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg
    from orb_line_slam_tpu_torch.parallel.multihost_worker import SMALL_ITERS, small_problem

    cam, pack = small_problem()
    i1, i2, ncg = SMALL_ITERS
    keys = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")
    ref = bundle_adjust_cg(*(torch.from_numpy(np.array(pack[k])).to(cuda) for k in keys), cam, iters1=i1,
                           iters2=i2, cg_iters=ncg)
    card = _small_gba(4, cuda)
    _within_pose_contract(card, tuple(x.cpu().numpy() for x in ref))
    _within_pose_contract(card, _small_gba(4, "cpu"))


def test_sharded_gba_on_card_is_reproducible(cuda):
    """One and four shards on cuda:0: two calls give bit-identical
    replicated outputs, and the two shard counts agree within the pose
    contract."""
    runs = {n: (_small_gba(n, cuda), _small_gba(n, cuda)) for n in (1, 4)}
    for a, b in runs.values():
        for x, y in zip((a[0], a[1], a[4]), (b[0], b[1], b[4])):
            assert np.array_equal(x, y)
    _within_pose_contract(runs[4][0], runs[1][0])


def test_tracer_puts_blocking_calls_down_to_their_span(cuda):
    """Under a torch.profiler, a span of the port's tracer holding three
    ``.item()`` calls and one ``.cpu()`` reads four blocking CUDA calls,
    each put down to that span; the launches before it go to its parent."""
    from torch.profiler import ProfilerActivity, profile

    from orb_line_slam_tpu_torch.utils.timing import StageTimer
    from slambench import spans

    timer = StageTimer()
    timer.tracer.enable()
    x = torch.arange(1024, dtype=torch.float32, device=cuda)
    with timer.stage("warm"):
        (x * 2).sum().item()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with timer.stage("frame"):
            y = x * 3 + 1
            with timer.stage("reads"):
                values = [y.sum().item(), y.max().item(), y.min().item()]
                host = y[:8].cpu()
    assert values[1] == 3 * 1023 + 1 and host.shape == (8,)
    program, syncs, launches = spans.read_events(prof)
    window = spans.window(program, syncs, launches, [], frames=1)
    assert window.syncs[("frame", "reads")][0] == 4
    assert sum(n for chain, (n, _) in window.syncs.items() if chain) == 4
    assert window.launches[("frame",)][0] >= 1 and window.launches[("frame", "reads")][0] >= 3
