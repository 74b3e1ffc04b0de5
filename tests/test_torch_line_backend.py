"""Line back end of the torch port against the JAX package on the CPU:
3D line geometry, line residuals and Jacobians, the pose solve with line
terms, line matching, line map maintenance and the joint point+line BA,
on the same seeded numpy inputs, with the tolerances stated per test."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.backend import line_ba as jline_ba
from orb_line_slam_tpu.backend.pose_opt import pose_optimize as jax_pose_opt
from orb_line_slam_tpu.backend.residuals import make_line_residual_fn, pose_jacobian
from orb_line_slam_tpu.config import LineConfig as JaxLineConfig, MapConfig as JaxMapConfig
from orb_line_slam_tpu.frontend.line_extractor import build_line_features as jax_build_line_features
from orb_line_slam_tpu.geometry import lines3d as jl3
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics as JaxCam
from orb_line_slam_tpu.geometry.se3 import se3_exp as jse3_exp
from orb_line_slam_tpu.matching.line_matcher import (
    match_lines as jax_match_lines, search_lines_by_projection as jax_search_lines,
)
from orb_line_slam_tpu.slam_map import line_mapping as jline_mapping
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.backend.line_ba import bundle_adjust_pl, line_residual
from orb_line_slam_tpu_torch.backend.pose_opt import pose_optimize
from orb_line_slam_tpu_torch.backend.residuals import line_obs_coeffs, line_residual_and_jacobian
from orb_line_slam_tpu_torch.config import CameraIntrinsics
from orb_line_slam_tpu_torch.convert import line_features_from_numpy, map_store_from_numpy
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory
from orb_line_slam_tpu_torch.geometry import lines3d
from orb_line_slam_tpu_torch.geometry.host import nbackproject
from orb_line_slam_tpu_torch.matching.line_matcher import match_lines, search_lines_by_projection
from orb_line_slam_tpu_torch.slam_map import line_mapping

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)
J = lambda a: jnp.asarray(np.array(a))  # noqa: E731

CAM = CameraIntrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=250.0, width=640, height=480)
JCAM = JaxCam(*CAM)


def _segments(n, seed):
    rng = np.random.default_rng(seed)
    p1 = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n), rng.uniform(6, 25, n)], -1).astype(np.float32)
    p2 = (p1 + rng.normal(0, 1.5, (n, 3))).astype(np.float32)
    return p1, p2


def _poses(n, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    out = [jse3_exp(J(np.concatenate([rng.normal(0, scale, 3), rng.normal(0, scale, 3)]).astype(np.float32)))
           for _ in range(n)]
    return np.stack([np.asarray(R) for R, _ in out]), np.stack([np.asarray(t) for _, t in out])


def _project(R, t, p):
    xc = np.einsum("...ij,...j->...i", R, p) + t
    return np.stack([CAM.fx * xc[..., 0] / xc[..., 2] + CAM.cx, CAM.fy * xc[..., 1] / xc[..., 2] + CAM.cy], -1)


# ---------------------------------------------------------------------------
# Geometry and residuals.

def test_lines3d_matches_jax():
    """Every function of geometry/lines3d.py within 1e-5."""
    p1, p2 = _segments(32, 0)
    R, t = _poses(32, 1)
    xi = np.random.default_rng(2).normal(0, 0.2, (32, 4)).astype(np.float32)
    pts = np.random.default_rng(3).normal(0, 4, (32, 3)).astype(np.float32)
    close = lambda a, b: np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-5)  # noqa: E731
    n, v = lines3d.pluecker_from_endpoints(T(p1), T(p2))
    jn, jv = jl3.pluecker_from_endpoints(J(p1), J(p2))
    close(n, jn), close(v, jv)
    U, w = lines3d.orthonormal_from_pluecker(n, v)
    jU, jw = jl3.orthonormal_from_pluecker(jn, jv)
    close(U, jU), close(w, jw)
    for a, b in zip(lines3d.pluecker_from_orthonormal(U, w), jl3.pluecker_from_orthonormal(jU, jw)):
        close(a, b)
    for a, b in zip(lines3d.orthonormal_retract(U, w, T(xi)), jl3.orthonormal_retract(jU, jw, J(xi))):
        close(a, b)
    for a, b in zip(lines3d.pluecker_transform(T(R), T(t), n, v), jl3.pluecker_transform(J(R), J(t), jn, jv)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-4)  # |n| ~ 100
    close(lines3d.closest_points_on_line(n, v, T(pts)), jl3.closest_points_on_line(jn, jv, J(pts)))
    close(lines3d.line_projection_matrix(*CAM[:4]), jl3.line_projection_matrix(*CAM[:4]))


def _assert_jac(a, b, rtol=1e-4):
    """Within rtol relative to the Jacobian's scale."""
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


def test_pose_line_jacobian_matches_jacfwd():
    """The pose solve's line residual (endpoint distances to the observed
    line) and its analytic pose Jacobian vs jax.jacfwd."""
    p1, p2 = _segments(40, 4)
    R, t = (np.asarray(a) for a in jse3_exp(J(np.array([0.1, -0.2, 0.05, 0.02, -0.03, 0.01], np.float32))))
    rng = np.random.default_rng(5)
    a = (_project(R, t, p1) + rng.normal(0, 2, (40, 2))).astype(np.float32)
    b = (_project(R, t, p2) + rng.normal(0, 2, (40, 2))).astype(np.float32)
    obs = np.asarray(line_obs_coeffs(T(a), T(b)))
    rj, Jj = pose_jacobian(make_line_residual_fn(JCAM), J(R), J(t), J(p1), J(p2), J(obs))
    r, Jt = line_residual_and_jacobian(CAM, T(R), T(t), T(p1), T(p2), T(obs))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-4, atol=1e-3)
    _assert_jac(Jt.numpy(), Jj)


def test_ba_line_jacobians_match_jacfwd():
    """The joint BA's Plücker line residual and its analytic Jacobians
    (pose tangent and orthonormal line update) vs jax.jacfwd."""
    C, L, Ol = 4, 12, 40
    p1, p2 = _segments(L, 6)
    R, t = _poses(C, 7)
    U, w = (np.asarray(a) for a in jl3.orthonormal_from_pluecker(*jl3.pluecker_from_endpoints(J(p1), J(p2))))
    rng = np.random.default_rng(8)
    lc, ll = rng.integers(0, C, Ol).astype(np.int32), rng.integers(0, L, Ol).astype(np.int32)
    a = (_project(R[lc], t[lc], p1[ll]) + rng.normal(0, 1.5, (Ol, 2))).astype(np.float32)
    b = (_project(R[lc], t[lc], p2[ll]) + rng.normal(0, 1.5, (Ol, 2))).astype(np.float32)
    rj, Jcj, Jlj = jline_ba._line_res_jacs(jline_ba._line_residual_fn(JCAM), J(R), J(t), J(U), J(w),
                                           J(lc), J(ll), J(a), J(b))
    KL = lines3d.line_projection_matrix(*CAM[:4])
    r, Jc, Jl = line_residual(KL, T(R)[lc], T(t)[lc], T(U)[ll], T(w)[ll], T(a), T(b))
    np.testing.assert_allclose(r.numpy(), np.asarray(rj), rtol=1e-4, atol=1e-3)
    _assert_jac(Jc.numpy(), Jcj)
    _assert_jac(Jl.numpy(), Jlj)


# ---------------------------------------------------------------------------
# Pose solve with line terms.

@pytest.mark.parametrize("line_outliers", [0, 6])
def test_pose_optimize_with_lines_matches_jax(line_outliers):
    """Poses within 1e-3 rad / 5e-3 m; point and line inlier counts
    within 3 (tests/test_tpu_parity.py's pose contract)."""
    rng = np.random.default_rng(9)
    M, L = 200, 30
    pts = np.stack([rng.uniform(-4, 4, M), rng.uniform(-3, 3, M), rng.uniform(4, 15, M)], -1).astype(np.float32)
    R_gt, t_gt = (np.asarray(x) for x in jse3_exp(J(np.array([0.05, -0.02, 0.1, 0.01, 0.02, -0.01], np.float32))))
    xc = pts @ R_gt.T + t_gt
    obs = np.stack([CAM.fx * xc[:, 0] / xc[:, 2] + CAM.cx, CAM.fy * xc[:, 1] / xc[:, 2] + CAM.cy,
                    CAM.fx * xc[:, 0] / xc[:, 2] + CAM.cx - CAM.bf / xc[:, 2]], -1).astype(np.float32)
    obs[:, :2] += rng.normal(0, 0.5, (M, 2)).astype(np.float32)
    obs[:20, :2] += rng.uniform(15, 30, (20, 2)).astype(np.float32)       # point outliers
    obs[::4, 2] = -1.0                                                    # some mono points
    oct_ = rng.integers(0, 3, M).astype(np.int32)
    s, e = _segments(L, 10)
    a, b = _project(R_gt, t_gt, s) + rng.normal(0, 0.5, (L, 2)), _project(R_gt, t_gt, e) + rng.normal(0, 0.5, (L, 2))
    a[:line_outliers] += 40.0
    lobs = np.asarray(line_obs_coeffs(T(a.astype(np.float32)), T(b.astype(np.float32))))
    lval = np.ones(L, bool)
    lval[-3:] = False
    kw = lambda f: dict(line_start_w=f(s), line_end_w=f(e), line_obs=f(lobs),  # noqa: E731
                        line_octave=f(np.zeros(L, np.int32)), line_valid=f(lval))
    rj = jax_pose_opt(jnp.eye(3), jnp.zeros(3), J(pts), J(obs), J(oct_), jnp.ones(M, bool), JCAM, **kw(J))
    rt = pose_optimize(torch.eye(3), torch.zeros(3), T(pts), T(obs), T(oct_), torch.ones(M, dtype=torch.bool),
                       CAM, **kw(T))
    assert np.abs(rt.R.numpy() - np.asarray(rj.R)).max() < 1e-3
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 5e-3
    assert abs(int(rt.inliers.sum()) - int(np.asarray(rj.inliers).sum())) <= 3
    assert abs(int(rt.line_inliers.sum()) - int(np.asarray(rj.line_inliers).sum())) <= 3
    assert int(rt.n_inliers) == int(rt.inliers.sum()) + int(rt.line_inliers.sum())
    assert int(np.asarray(rj.line_inliers).sum()) >= L - 3 - line_outliers - 2


# ---------------------------------------------------------------------------
# Matching and map maintenance, from the JAX package's line features.

SCAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
SCENE = dict(n_points=500, n_lines=40, seed=9, extent=((-14, 14), (-6, 6), (6, 60)))


@pytest.fixture(scope="module")
def jax_lines():
    """(poses, [JAX LineFeatures on host]) of frames 0, 3 and 6."""
    scene = SyntheticScene(SCAM, **SCENE)
    poses = circular_trajectory(12, step=0.3)
    out = []
    for i in (0, 3, 6):
        l, r = scene.render_stereo(*poses[i])
        out.append(jax.device_get(jax_build_line_features(J(l), J(r), JaxCam(*SCAM),
                                                          JaxLineConfig(enabled=True, n_lines=64))))
    return [poses[i] for i in (0, 3, 6)], out


def test_line_matching_identical(jax_lines):
    """match_lines and search_lines_by_projection: identical indices."""
    poses, (la, lb, lc) = jax_lines
    for x, y in ((la, lb), (lb, lc), (la, lc)):
        mj = jax_match_lines(x, y)
        mt = match_lines(line_features_from_numpy(x, "cpu"), line_features_from_numpy(y, "cpu"))
        np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
        np.testing.assert_array_equal(mt.mask.numpy(), np.asarray(mj.mask))
    # Map lines: frame 0's stereo lines in the world (frame 0 is at the origin).
    ok = la.valid & (la.depth0 > 0) & (la.depth1 > 0)
    assert ok.sum() >= 3
    s_w = nbackproject(SCAM, la.p0, np.where(ok, la.depth0, 10.0)).astype(np.float32)
    e_w = nbackproject(SCAM, la.p1, np.where(ok, la.depth1, 10.0)).astype(np.float32)
    n_found = 0
    for (R, t), lf in zip(poses[1:], (lb, lc)):
        R, t = R.astype(np.float32), t.astype(np.float32)
        mj = jax_search_lines(J(s_w), J(e_w), J(la.desc), J(ok), J(R), J(t), lf, JaxCam(*SCAM))
        mt = search_lines_by_projection(T(s_w), T(e_w), T(la.desc), T(ok), T(R), T(t),
                                        line_features_from_numpy(lf, "cpu"), SCAM)
        np.testing.assert_array_equal(mt.idx.numpy(), np.asarray(mj.idx))
        n_found += int(mt.mask.sum())
    assert n_found >= 2


def test_line_mapping_identical(jax_lines):
    """fuse_lines_into_keyframe and create_lines_two_view on a JAX-package
    MapStore and on its port copy (map_store_from_numpy): identical
    results and identical line tables."""
    poses, feats = jax_lines
    mcfg = JaxMapConfig(max_keyframes=16, max_points=256, max_lines=128)
    store = JaxMapStore(mcfg, 64, n_lines=64)
    fake = types.SimpleNamespace(
        xy=np.zeros((64, 2), np.float32), u_right=np.full(64, -1, np.float32), depth=np.full(64, -1, np.float32),
        octave=np.zeros(64, np.int32), angle=np.zeros(64, np.float32), desc=np.zeros((64, 32), np.uint8),
        valid=np.zeros(64, bool))
    for k, ((R, t), lf) in enumerate(zip(poses, feats)):
        kf = store.add_keyframe(fake, R, t, k)
        store.set_kf_lines(kf, lf, np.full(64, -1, np.int32))
        if k == 0:   # stereo lines of the first keyframe (at the origin)
            new = np.nonzero(lf.valid & (lf.depth0 > 0) & (lf.depth1 > 0))[0]
            store.add_lines(nbackproject(SCAM, lf.p0[new], lf.depth0[new]),
                            nbackproject(SCAM, lf.p1[new], lf.depth1[new]), lf.desc[new], kf, new)
    port = map_store_from_numpy(store)
    for kf in (1, 2):
        assert (line_mapping.fuse_lines_into_keyframe(port, kf, SCAM)
                == jline_mapping.fuse_lines_into_keyframe(store, kf, JaxCam(*SCAM)))
    ct = line_mapping.create_lines_two_view(port, 2, 0, SCAM)
    cj = jline_mapping.create_lines_two_view(store, 2, 0, JaxCam(*SCAM))
    np.testing.assert_array_equal(ct, cj)
    assert store.ln_valid.sum() >= 3
    for name in ("ln_valid", "ln_start", "ln_end", "ln_desc", "kf_ln_obs", "ln_found", "ln_visible"):
        np.testing.assert_array_equal(getattr(port, name), getattr(store, name), err_msg=name)


# ---------------------------------------------------------------------------
# Joint point+line BA.

def test_bundle_adjust_pl_matches_jax():
    """C = 6, P = 200, L = 20, perturbed points, lines and free cameras,
    with point and line outliers: poses within 1e-3 rad / 5e-3 m, inlier
    masks agreeing on >= 98%."""
    from tests.test_line_ba import make_pl_problem

    R_gt, t_gt, pts, l1, l2, oc, ol, ouv, oo, lc, ll, la, lb = (np.asarray(a) for a in make_pl_problem(C=6, P=200, L=20))
    rng = np.random.default_rng(12)
    C, P, L, O, Ol = 6, 200, 20, len(oc), len(lc)
    pts0 = (pts + rng.normal(0, 0.05, (P, 3))).astype(np.float32)
    l1p = (l1 + rng.normal(0, 0.05, (L, 3))).astype(np.float32)
    l2p = (l2 + rng.normal(0, 0.05, (L, 3))).astype(np.float32)
    U0, w0 = (np.asarray(a) for a in jl3.orthonormal_from_pluecker(*jl3.pluecker_from_endpoints(J(l1p), J(l2p))))
    R0, t0 = R_gt.copy(), t_gt.copy()
    for c in range(2, C):
        dR, dt = jse3_exp(J(np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]).astype(np.float32)))
        R0[c], t0[c] = np.asarray(dR) @ R_gt[c], np.asarray(dR) @ t_gt[c] + np.asarray(dt)
    ouv = ouv + rng.normal(0, 0.3, ouv.shape).astype(np.float32)
    ouv[::25, :2] += 30.0                                                   # point outliers
    la = la + rng.normal(0, 0.3, la.shape).astype(np.float32)
    la[::17] += 25.0                                                        # line outliers
    cam_fixed = np.array([True, True] + [False] * (C - 2))
    args = [R0, t0, cam_fixed, pts0, np.ones(P, bool), oc, ol, ouv, oo, np.ones(O, bool),
            U0, w0, np.ones(L, bool), lc, ll, la, lb, np.zeros(Ol, np.int32), np.ones(Ol, bool)]
    rj = jline_ba.bundle_adjust_pl(*(J(a) for a in args), JaxCam(*CAM))
    rt = bundle_adjust_pl(*(T(a) for a in args), CAM)
    Rj, tj = np.asarray(rj.R), np.asarray(rj.t)
    assert np.abs(rt.R.numpy() - Rj).max() < 1e-3
    assert np.abs(rt.t.numpy() - tj).max() < 5e-3
    assert (rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)).mean() >= 0.98
    assert (rt.lobs_inlier.numpy() == np.asarray(rj.lobs_inlier)).mean() >= 0.98
    assert np.asarray(rj.lobs_inlier).sum() >= 0.8 * Ol and np.abs(Rj - R_gt).max() < 3e-3


@pytest.mark.parametrize("views", [1, 2])
def test_bundle_adjust_pl_matches_jax_few_views(views):
    """Lines seen from only one or two of the six cameras leave their 4x4
    blocks near-singular (held by the 1e-5 damping), as on the tracker's
    windows; the line table is padded to 128 rows as the tracker pads it.
    Both packages invert and factor those blocks in float32: poses within
    1e-3 rad / 5e-3 m, point inlier masks agreeing on >= 98%, chi2 within
    5%.  A line seen from one view is not determined in 3D (two
    constraints on four degrees of freedom), so its final residual, and
    with it its inlier flag, follows each package's float32 rounding:
    line inlier masks are held to >= 98% only with two views."""
    from tests.test_line_ba import make_pl_problem

    R_gt, t_gt, pts, l1, l2, oc, ol, ouv, oo, lc, ll, la, lb = (np.asarray(a) for a in make_pl_problem(C=6, P=200, L=20))
    C, P, L, pad = 6, 200, 20, 108
    keep = np.zeros(len(lc), bool)
    for i in range(L):
        keep |= (ll == i) & np.isin(lc, [(i + k) % C for k in range(views)])
    lc, ll, la, lb = lc[keep], ll[keep], la[keep], lb[keep]
    rng = np.random.default_rng(views)
    O, Ol = len(oc), len(lc)
    pts0 = (pts + rng.normal(0, 0.05, (P, 3))).astype(np.float32)
    l1p = np.concatenate([l1 + rng.normal(0, 0.05, (L, 3)), np.zeros((pad, 3))]).astype(np.float32)
    l2p = np.concatenate([l2 + rng.normal(0, 0.05, (L, 3)), np.ones((pad, 3))]).astype(np.float32)
    U0, w0 = (np.asarray(a) for a in jl3.orthonormal_from_pluecker(*jl3.pluecker_from_endpoints(J(l1p), J(l2p))))
    R0, t0 = R_gt.copy(), t_gt.copy()
    for c in range(2, C):
        dR, dt = jse3_exp(J(np.concatenate([rng.normal(0, 0.01, 3), rng.normal(0, 0.005, 3)]).astype(np.float32)))
        R0[c], t0[c] = np.asarray(dR) @ R_gt[c], np.asarray(dR) @ t_gt[c] + np.asarray(dt)
    ouv = ouv + rng.normal(0, 0.3, ouv.shape).astype(np.float32)
    la = la + rng.normal(0, 0.3, la.shape).astype(np.float32)
    args = [R0, t0, np.array([True, True] + [False] * (C - 2)), pts0, np.ones(P, bool), oc, ol, ouv, oo,
            np.ones(O, bool), U0, w0, np.arange(L + pad) < L, lc, ll, la, lb, np.zeros(Ol, np.int32), np.ones(Ol, bool)]
    rj = jline_ba.bundle_adjust_pl(*(J(a) for a in args), JaxCam(*CAM))
    rt = bundle_adjust_pl(*(T(a) for a in args), CAM)
    assert np.abs(rt.R.numpy() - np.asarray(rj.R)).max() < 1e-3
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 5e-3
    assert (rt.obs_inlier.numpy() == np.asarray(rj.obs_inlier)).mean() >= 0.98
    if views > 1:
        assert (rt.lobs_inlier.numpy() == np.asarray(rj.lobs_inlier)).mean() >= 0.98
    assert abs(float(rt.chi2) - float(rj.chi2)) <= 0.05 * float(rj.chi2)
