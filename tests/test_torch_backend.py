"""Back end of the torch port against the JAX package on the CPU: pose
solve, EPnP-RANSAC, local BA and one tracking step, on the same numpy
inputs, with the tolerances stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.backend.local_ba import bundle_adjust as jax_ba
from orb_line_slam_tpu.backend.pnp import solve_pnp_ransac as jax_pnp
from orb_line_slam_tpu.backend.pose_opt import pose_optimize as jax_pose_opt
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust
from orb_line_slam_tpu_torch.backend.pnp import solve_pnp_ransac
from orb_line_slam_tpu_torch.backend.pose_opt import pose_optimize
from orb_line_slam_tpu_torch.backend.residuals import point_residual_and_jacobians
from orb_line_slam_tpu_torch.config import CameraIntrinsics as TorchCam

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)


def _pose_problem(outliers=0, mono_every=0):
    """The pose problem of tests/test_tpu_parity.py:140-160."""
    rng = np.random.default_rng(7)
    _ = rng.integers(0, 255, (240, 320), dtype=np.uint8)
    cam = CameraIntrinsics(fx=300.0, fy=300.0, cx=160.0, cy=120.0, bf=60.0, width=320, height=240)
    N = 256
    pts = np.stack([rng.uniform(-4, 4, N), rng.uniform(-3, 3, N), rng.uniform(4, 15, N)], -1).astype(np.float32)
    xc = pts + np.array([0.1, -0.05, 0.02], np.float32)
    obs = np.stack(
        [cam.fx * xc[:, 0] / xc[:, 2] + cam.cx, cam.fy * xc[:, 1] / xc[:, 2] + cam.cy,
         cam.fx * xc[:, 0] / xc[:, 2] + cam.cx - cam.bf / xc[:, 2]], -1).astype(np.float32)
    if outliers:
        obs[:outliers, :2] += rng.uniform(20, 40, (outliers, 2)).astype(np.float32)
    if mono_every:
        obs[::mono_every, 2] = -1.0
    return cam, pts, obs


@pytest.mark.parametrize("outliers,mono_every", [(0, 0), (25, 3)])
def test_pose_optimize_parity(outliers, mono_every):
    """dR < 1e-3, dt < 5e-3, inlier counts within 3 (test_tpu_parity)."""
    cam, pts, obs = _pose_problem(outliers, mono_every)
    N = pts.shape[0]
    oct_ = np.random.default_rng(1).integers(0, 3, N).astype(np.int32)
    rj = jax_pose_opt(jnp.eye(3), jnp.zeros(3), jnp.asarray(pts), jnp.asarray(obs),
                      jnp.asarray(oct_), jnp.ones(N, bool), cam)
    rt = pose_optimize(torch.eye(3), torch.zeros(3), T(pts), T(obs), T(oct_),
                       torch.ones(N, dtype=torch.bool), TorchCam(*cam))
    assert np.abs(rt.R.numpy() - np.asarray(rj.R)).max() < 1e-3
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 5e-3
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 3


def test_jacobians_match_jacfwd():
    """Analytic Jacobians vs the JAX package's jacfwd (local_ba)."""
    from orb_line_slam_tpu.backend.local_ba import _residuals_and_jacs
    from orb_line_slam_tpu.backend.residuals import make_point_residual_fn

    cam, pts, obs = _pose_problem(0, 4)
    rng = np.random.default_rng(2)
    R = np.asarray(jax.vmap(lambda p: __import__("orb_line_slam_tpu.geometry.se3", fromlist=["so3_exp"]).so3_exp(p))(
        jnp.asarray(rng.normal(0, 0.1, (pts.shape[0], 3)).astype(np.float32))))
    t = rng.normal(0, 0.3, (pts.shape[0], 3)).astype(np.float32)
    st = obs[:, 2] > 0
    rj, Jcj, Jpj = _residuals_and_jacs(make_point_residual_fn(cam), jnp.asarray(R), jnp.asarray(t), jnp.asarray(pts),
                                       jnp.arange(len(pts)), jnp.arange(len(pts)), jnp.asarray(obs), jnp.asarray(st))
    r, Jc, Jp = point_residual_and_jacobians(TorchCam(*cam), T(R), T(t), T(pts), T(obs), T(st))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), atol=1e-3)
    np.testing.assert_allclose(Jc.numpy(), np.asarray(Jcj), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(Jpj), rtol=1e-4, atol=1e-3)


def test_pnp_ransac_same_samples():
    """The same key draws the same hypotheses in both packages -> the
    same best hypothesis: identical inlier mask and count.  The JAX
    package's float32 EPnP is itself off the ground truth by up to ~2 mm
    on this problem, so the port (float64 null vector) is held to 1e-4
    of the ground truth, and to the JAX pose within the JAX pose's own
    error + 1e-4."""
    cam, pts, obs = _pose_problem(0, 0)
    R_true, t_true = np.eye(3), np.array([0.1, -0.05, 0.02])
    N = pts.shape[0]
    valid = np.ones(N, bool)
    valid[::7] = False
    obs[::11, :2] += 25.0  # outliers, so the best hypothesis is a choice
    sigma2 = np.ones(N, np.float32)
    Rj, tj, okj, nj = (np.asarray(a) for a in jax_pnp(
        jnp.asarray(pts), jnp.asarray(obs[:, :2]), jnp.asarray(valid), jax.random.PRNGKey(17), cam,
        jnp.asarray(sigma2)))
    Rt, tt, okt, nt = (a.numpy() for a in solve_pnp_ransac(
        T(pts), T(obs[:, :2]), T(valid), 17, TorchCam(*cam), T(sigma2)))
    assert abs(int(nt) - int(nj)) <= 1 and (okt == okj).mean() > 0.99
    assert np.abs(Rt - R_true).max() < 1e-4 and np.abs(tt - t_true).max() < 1e-4
    assert np.abs(Rt - Rj).max() <= np.abs(Rj - R_true).max() + 1e-4
    assert np.abs(tt - tj).max() <= np.abs(tj - t_true).max() + 1e-4


@pytest.mark.parametrize("seed", [0, 17, 49, 123457])
def test_jax_uniform_bit_exact(seed):
    """The port's threefry uniforms are jax.random.uniform's, bit for bit."""
    from orb_line_slam_tpu_torch.backend.pnp import jax_uniform

    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (128, 6))).ravel()
    assert np.array_equal(jax_uniform(seed, 768).view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n,frac,seed", [(1200, 0.3, 17), (1200, 0.03, 17), (777, 0.9, 17), (16, 0.5, 3),
                                         (13, 1.0, 17), (1200, 0.0, 17), (300, 0.5, 101)])
def test_draw_hypotheses_matches_jax_choice(n, frac, seed):
    """Path B's hypotheses are jax.random.choice's, index for index, on
    valid masks of the tracking step's size and on short and empty ones:
    the cumulative sum is associated as XLA's (torch.cumsum is not)."""
    from orb_line_slam_tpu_torch.backend.pnp import draw_hypotheses, xla_cumsum

    rng = np.random.default_rng(n + seed)
    valid = rng.random(n) < frac
    p = valid.astype(np.float32) / np.float32(max(valid.sum(), 1))
    want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, shape=(128, 6), replace=True,
                                        p=jnp.asarray(p)))
    got = draw_hypotheses(T(valid), seed).numpy()
    assert np.array_equal(got, want)
    cum = np.asarray(jnp.cumsum(jnp.asarray(p)))
    assert np.array_equal(xla_cumsum(T(p)).numpy(), cum)


# ---------------------------------------------------------------------------
# Local BA: the cases of tests/test_local_ba.py.

BA_CAM = CameraIntrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=250.0, width=640, height=480)


def _ba_problem(C=6, P=120, stereo=True, seed=0, noise_px=0.0):
    from tests.test_local_ba import CAM, make_ba_problem

    assert CAM == BA_CAM
    return [np.asarray(a) for a in make_ba_problem(C=C, P=P, stereo=stereo, seed=seed, noise_px=noise_px)]


def _run_both(R0, t0, fixed, pts0, obs_cam, obs_lm, obs, octv, **kw):
    P, O = pts0.shape[0], obs.shape[0]
    rj = jax_ba(jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(fixed), jnp.asarray(pts0), jnp.ones(P, bool),
                jnp.asarray(obs_cam), jnp.asarray(obs_lm), jnp.asarray(obs), jnp.asarray(octv),
                jnp.ones(O, bool), BA_CAM, **kw)
    rt = bundle_adjust(T(R0), T(t0), T(fixed), T(pts0), torch.ones(P, dtype=torch.bool), T(obs_cam), T(obs_lm),
                       T(obs), T(octv), torch.ones(O, dtype=torch.bool), TorchCam(*BA_CAM), **kw)
    return rj, rt


def _assert_ba_close(rj, rt):
    """Poses within 1e-3, points within 1e-3 relative."""
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-3)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-3)
    pj = np.asarray(rj.points)
    rel = np.linalg.norm(rt.points.numpy() - pj, axis=-1) / np.linalg.norm(pj, axis=-1)
    assert rel.max() < 1e-3, rel.max()


def _perturbed_init(R_gt, t_gt, seed):
    from orb_line_slam_tpu.geometry import se3_compose, se3_exp

    rng = np.random.default_rng(seed)
    R0, t0 = [], []
    for c in range(R_gt.shape[0]):
        if c < 2:
            R0.append(R_gt[c]); t0.append(t_gt[c])
            continue
        dxi = np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.01, 3)]).astype(np.float32)
        dR, dt = se3_exp(jnp.asarray(dxi))
        Rp, tp = se3_compose(dR, dt, jnp.asarray(R_gt[c]), jnp.asarray(t_gt[c]))
        R0.append(np.asarray(Rp)); t0.append(np.asarray(tp))
    return np.stack(R0), np.stack(t0), rng


@pytest.mark.parametrize("case", ["noisy_init", "outliers", "mono"])
def test_bundle_adjust_parity(case):
    if case == "noisy_init":
        R_gt, t_gt, pts_gt, obs_cam, obs_lm, obs, octv = _ba_problem()
        R0, t0, rng = _perturbed_init(R_gt, t_gt, 1)
        pts0 = pts_gt + rng.normal(0, 0.1, pts_gt.shape).astype(np.float32)
    elif case == "outliers":
        R_gt, t_gt, pts_gt, obs_cam, obs_lm, obs, octv = _ba_problem(noise_px=0.3)
        rng = np.random.default_rng(2)
        obs = obs.copy()
        out_idx = rng.choice(len(obs), len(obs) // 10, replace=False)
        obs[out_idx, :2] += rng.uniform(15, 60, (len(out_idx), 2))
        R0, t0 = R_gt, t_gt
        pts0 = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    else:
        R_gt, t_gt, pts_gt, obs_cam, obs_lm, obs, octv = _ba_problem(stereo=False)
        rng = np.random.default_rng(3)
        R0, t0 = R_gt, t_gt
        pts0 = pts_gt + rng.normal(0, 0.08, pts_gt.shape).astype(np.float32)
    fixed = np.array([True, True] + [False] * (R_gt.shape[0] - 2))
    rj, rt = _run_both(R0, t0, fixed, pts0, obs_cam, obs_lm, obs, octv)
    _assert_ba_close(rj, rt)
    agree = (rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)).mean()
    assert agree > 0.99, agree


def test_schur_step_matches_dense_joint_solve():
    """One LM step through the port's Schur solve vs a dense joint
    Gauss-Newton solve (cos > 0.99, as tests/test_local_ba.py), and the
    same step in the JAX package (within 1e-3 relative)."""
    R_gt, t_gt, pts_gt, obs_cam, obs_lm, obs, octv = _ba_problem(C=3, P=30)
    rng = np.random.default_rng(4)
    pts0 = pts_gt + rng.normal(0, 0.05, pts_gt.shape).astype(np.float32)
    C, P = 3, 30
    r, Jc, Jp = (x.numpy().astype(np.float64) for x in point_residual_and_jacobians(
        TorchCam(*BA_CAM), T(R_gt[obs_cam]), T(t_gt[obs_cam]), T(pts0[obs_lm]), T(obs), T(obs[:, 2] > 0)))
    O = r.shape[0]
    n = 6 * C + 3 * P
    J = np.zeros((3 * O, n))
    for o in range(O):
        J[3 * o:3 * o + 3, 6 * obs_cam[o]:6 * obs_cam[o] + 6] = Jc[o]
        J[3 * o:3 * o + 3, 6 * C + 3 * obs_lm[o]:6 * C + 3 * obs_lm[o] + 3] = Jp[o]
    H = J.T @ J
    g = J.T @ r.reshape(-1)
    free = np.ones(n, bool)
    free[:6] = False
    dx = np.zeros(n)
    dx[free] = np.linalg.solve(H[np.ix_(free, free)] + 1e-8 * np.eye(free.sum()), -g[free])
    rj, rt = _run_both(R_gt, t_gt, np.array([True, False, False]), pts0, obs_cam, obs_lm, obs, octv,
                       iters1=1, iters2=0)
    dp_dense = dx[6 * C:].reshape(P, 3)
    dp = rt.points.numpy() - pts0
    cos = np.sum(dp_dense * dp) / (np.linalg.norm(dp_dense) * np.linalg.norm(dp) + 1e-12)
    assert cos > 0.99, cos
    _assert_ba_close(rj, rt)


# ---------------------------------------------------------------------------
# One tracking step from identical Frame / map inputs.

def test_track_step_parity():
    """Two steps (cold start, then with the motion model) of the JAX
    track_step and the port's, from the same frames and map (carried
    over with convert.py): pose within dR < 1e-3, dt < 5e-3, and at
    least 99% of features with the same landmark association."""
    from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu.data.synthetic import SyntheticScene
    from orb_line_slam_tpu.frontend.frame import build_stereo_frame as jax_frame
    from orb_line_slam_tpu.geometry.host import nbackproject
    from orb_line_slam_tpu.pipeline.track_step import MapMirror as JMirror, track_step as jax_track_step
    from orb_line_slam_tpu.slam_map.map_store import MapStore
    from orb_line_slam_tpu_torch.convert import config_from_jax, frame_from_numpy, map_store_from_numpy
    from orb_line_slam_tpu_torch.pipeline.track_step import MapMirror, track_step

    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=768, n_levels=4), lines=LineConfig(enabled=False),
                     map=MapConfig(max_keyframes=16, max_points=4096, max_lines=64, local_window=8,
                                   local_points=2048))
    tcfg = config_from_jax(cfg)
    scene = SyntheticScene(cam, n_points=700, seed=21, extent=((-14, 14), (-6, 6), (8, 60)))
    frames = []
    for z in (0.0, 0.3, 0.6):
        l, r = scene.render_stereo(np.eye(3), -np.array([0.0, 0.0, z]))
        frames.append(jax.device_get(jax_frame(jnp.asarray(l), jnp.asarray(r), cfg)))

    # Map: stereo initialization on frame 0 (Tracker._stereo_initialize).
    store = MapStore(cfg.map, cfg.orb.n_features)
    f0 = frames[0]
    kf = store.add_keyframe(f0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0, 0.0)
    idx = np.nonzero(f0.valid & (f0.depth > 0))[0]
    ids = store.add_points(nbackproject(cam, f0.xy, f0.depth)[idx], f0.desc[idx], f0.octave[idx], kf, idx)
    assert len(ids) > 100
    tstore = map_store_from_numpy(store)
    np.testing.assert_array_equal(tstore.pt_pos, store.pt_pos)
    cap = cfg.map.local_points
    snap = np.full(cap, -1, np.int32)
    snap[: len(ids)] = ids
    fields = lambda s: (s.pt_pos, s.pt_desc, s.pt_oct, s.pt_valid, s.pt_max_dist, s.pt_min_dist, s.pt_normal)  # noqa: E731
    jmir = JMirror(*(jnp.asarray(a) for a in fields(store)))
    tmir = MapMirror(*(T(a) for a in fields(tstore)))
    ref = (f0.xy, f0.desc, f0.angle, store.kf_obs_lm[kf])
    dummy8 = (jnp.zeros((8, 3)), jnp.ones((8, 3)), jnp.zeros((8, 32), jnp.uint8), jnp.zeros(8, bool))
    tframes = [frame_from_numpy(f._asdict(), "cpu") for f in frames]

    # Step 1: cold start (no velocity); step 2: motion model from step 1.
    jcarry = (jnp.full(768, -1, jnp.int32), jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3), jnp.asarray(False))
    tcarry = (torch.full((768,), -1, dtype=torch.int32), torch.eye(3), torch.zeros(3), torch.eye(3), torch.zeros(3),
              torch.tensor(False))
    jacc = (jnp.zeros(cap, jnp.int32),) * 2
    tacc = (torch.zeros(cap, dtype=torch.int32),) * 2
    for step in (1, 2):
        oj = jax_track_step(
            frames[step], frames[step - 1], jmir, *jcarry, *(jnp.asarray(a) for a in ref), jnp.asarray(snap),
            *jacc, jnp.zeros(8, jnp.int32), jnp.zeros(8, jnp.int32), None, *dummy8, cfg=cfg, has_lines=False,
        )
        ot = track_step(
            tframes[step], tframes[step - 1], tmir, *tcarry, *(T(a) for a in ref), T(snap), *tacc,
            torch.zeros(8, dtype=torch.int32), torch.zeros(8, dtype=torch.int32), None,
            *(T(np.asarray(a)) for a in dummy8), cfg=tcfg, has_lines=False,
        )
        assert bool(ot.ok) and bool(oj.ok)
        assert np.abs(ot.R.numpy() - np.asarray(oj.R)).max() < 1e-3
        assert np.abs(ot.t.numpy() - np.asarray(oj.t)).max() < 5e-3
        gj, gt = np.asarray(oj.assoc_gid), ot.assoc_gid.numpy()
        assert (gj >= 0).sum() > 100
        assert (gj == gt).mean() >= 0.99, (gj == gt).mean()
        assert abs(int(ot.n_inliers) - int(oj.packed[13])) <= 3
        assert bool(ot.used_motion) == bool(oj.packed[14] > 0.5)
        np.testing.assert_array_equal(ot.vis_acc.numpy(), np.asarray(oj.vis_acc))
        jcarry = (oj.assoc_gid, oj.Rv, oj.tv, oj.R, oj.t, oj.ok)
        tcarry = (ot.assoc_gid, ot.Rv, ot.tv, ot.R, ot.t, ot.ok)
        jacc = (oj.found_acc, oj.vis_acc)
        tacc = (ot.found_acc, ot.vis_acc)
