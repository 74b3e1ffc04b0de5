"""Tests that need a CUDA card: the hand-written kernels (patch tiles,
fused describe, fused stereo SAD, one pair or a batch of pairs) against
their plain versions, and the point front end (one pair or a batch), the
line front end and the frames of mono and RGB-D images on the card
against the CPU.  They skip where no card is present; run them on the card with

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
            before = (describe.launches, stereo_sad.launches)
            frames, lfs, outs = batched_frame_track(left, right, stacked, cfg, has_lines=True)
            torch.cuda.synchronize()
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert (describe.launches, stereo_sad.launches) == (before[0] + 1, before[1] + 1)
    last_frame, mir, *rest = stacked
    for b in range(2):
        want = track_step(_take(frames, b), _take(last_frame, b), _take(mir, b), *(x[b] for x in rest[:15]),
                          _take(lfs, b), *(x[b] for x in rest[15:]), cfg=cfg, has_lines=True)
        got = _take(outs, b)
        assert int(want.n_inliers) > 50
        assert float((got.R - want.R).abs().max()) <= 1e-4 and float((got.t - want.t).abs().max()) <= 1e-4
        assert float((got.assoc_gid == want.assoc_gid).float().mean()) >= 0.99


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
