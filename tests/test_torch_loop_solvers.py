"""Loop-closing solvers of the torch port against the JAX package on the
CPU, on the same numpy inputs: Sim3 RANSAC (hypothesis draw exact),
Sim3 refinement, pose graph, CG bundle adjustment, the Sim3-guided
search and the loop fuse.  Tolerances are stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.backend.global_ba import bundle_adjust_cg as jax_ba_cg
from orb_line_slam_tpu.backend.pose_graph import optimize_pose_graph as jax_pose_graph
from orb_line_slam_tpu.backend.sim3_opt import _residuals as jax_sim3_residuals
from orb_line_slam_tpu.backend.sim3_opt import optimize_sim3 as jax_optimize_sim3
from orb_line_slam_tpu.backend.sim3_solver import solve_sim3_ransac as jax_sim3_ransac
from orb_line_slam_tpu.config import MapConfig as JaxMapConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.geometry.sim3 import sim3_retract as jax_sim3_retract
from orb_line_slam_tpu.matching.point_matcher import search_by_sim3_dir as jax_search_by_sim3_dir
from orb_line_slam_tpu.slam_map.fuse import fuse_into_keyframe as jax_fuse_into_keyframe
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg
from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust
from orb_line_slam_tpu_torch.backend.pnp import draw_hypotheses
from orb_line_slam_tpu_torch.backend.pose_graph import edge_residuals_and_jacobians, optimize_pose_graph
from orb_line_slam_tpu_torch.backend.sim3_opt import optimize_sim3, sim3_residual_jacobian
from orb_line_slam_tpu_torch.backend.sim3_solver import horn_alignment, solve_sim3_ransac
from orb_line_slam_tpu_torch.config import CameraIntrinsics as TorchCam
from orb_line_slam_tpu_torch.convert import map_store_from_numpy
from orb_line_slam_tpu_torch.matching.point_matcher import search_by_sim3_dir
from orb_line_slam_tpu_torch.slam_map.fuse import fuse_into_keyframe

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
TCAM = TorchCam(*CAM)


def _rot(axis_angle):
    from scipy.spatial.transform import Rotation

    return Rotation.from_rotvec(axis_angle).as_matrix().astype(np.float32)


def _angle(Ra, Rb):
    """Rotation angle between [..., 3, 3] rotations, from the skew part
    (arccos of the trace resolves no finer than 3e-4 rad in fp32)."""
    d = np.asarray(Ra, np.float64) @ np.swapaxes(np.asarray(Rb, np.float64), -1, -2)
    w = np.stack([d[..., 2, 1] - d[..., 1, 2], d[..., 0, 2] - d[..., 2, 0], d[..., 1, 0] - d[..., 0, 1]], -1)
    return np.arcsin(np.clip(np.linalg.norm(w, axis=-1) / 2, 0, 1))


def _project(p):
    return np.stack([CAM.fx * p[:, 0] / p[:, 2] + CAM.cx, CAM.fy * p[:, 1] / p[:, 2] + CAM.cy], -1).astype(np.float32)


def _sim3_pair(n, n_valid, outlier_frac, seed, scale=1.0):
    """Matched 3D points of two cameras related by a known Sim3 (p1 =
    s R p2 + t), with noise, gross outliers and masked padding rows."""
    rng = np.random.default_rng(seed)
    p2 = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(5, 20, n)], -1).astype(np.float32)
    R = _rot(np.array([0.03, -0.12, 0.02]))
    t = np.array([0.6, -0.1, 0.3], np.float32)
    p1 = (scale * p2 @ R.T + t + rng.normal(0, 0.01, p2.shape)).astype(np.float32)
    out = rng.random(n) < outlier_frac
    p1[out] += rng.normal(0, 1.5, (int(out.sum()), 3)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:n_valid] = True
    p1[~valid] = 0
    p2[~valid] = 0
    return p1, p2, valid, out, (scale, R, t)


@pytest.mark.parametrize("seed", [0, 7, 41])
@pytest.mark.parametrize("n_valid", [256, 93])
def test_sim3_hypothesis_draw_matches_jax_choice(seed, n_valid):
    """The (256, 3) draw is jax.random.choice's, index for index."""
    valid = np.zeros(256, bool)
    valid[np.random.default_rng(seed).permutation(256)[:n_valid]] = True
    p = valid.astype(np.float32)
    p = p / max(p.sum(), 1.0)
    want = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), 256, shape=(256, 3), replace=True, p=jnp.asarray(p)))
    got = draw_hypotheses(T(valid), seed, 256, 3).numpy()
    assert got.shape == (256, 3) and np.array_equal(got, want)


@pytest.mark.parametrize("fix_scale,scale", [(True, 1.0), (False, 1.07)])
def test_solve_sim3_ransac_parity(fix_scale, scale):
    """Same best hypothesis (same inlier mask and count), Sim3 within 1e-5."""
    p1, p2, valid, _, _ = _sim3_pair(256, 180, 0.3, seed=3, scale=scale)
    ones = np.ones(256, np.float32)
    sj, Rj, tj, inlj, cj = jax_sim3_ransac(
        jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid), jax.random.PRNGKey(11), CAM, CAM,
        jnp.asarray(ones), jnp.asarray(ones), fix_scale=fix_scale, n_hyps=256)
    s, R, t, inl, c = solve_sim3_ransac(T(p1), T(p2), T(valid), 11, TCAM, TCAM, T(ones), T(ones),
                                        fix_scale=fix_scale, n_hyps=256)
    assert int(c) == int(cj) and int(c) > 60
    assert np.array_equal(inl.numpy(), np.asarray(inlj))
    assert abs(float(s) - float(sj)) < 1e-5
    assert np.abs(R.numpy() - np.asarray(Rj)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(tj)).max() < 1e-5
    assert horn_alignment is __import__("orb_line_slam_tpu_torch.backend.pnp", fromlist=["x"]).horn_alignment


def _sim3_opt_problem(seed=5):
    p1, p2, valid, out, (s, R, t) = _sim3_pair(512, 300, 0.15, seed=seed)
    obs1 = _project(np.where(valid[:, None], p1, [0, 0, 1.0]).astype(np.float32))
    obs2 = _project(np.where(valid[:, None], p2, [0, 0, 1.0]).astype(np.float32))
    rng = np.random.default_rng(seed + 1)
    # the observations are of the TRUE geometry: p1 for the outliers is
    # wrong in 3D, so their reprojections disagree
    true_p1 = (s * p2 @ R.T + t).astype(np.float32)
    obs1 = np.where(valid[:, None], _project(np.where(valid[:, None], true_p1, [0, 0, 1.0]).astype(np.float32)), obs1)
    obs1 += rng.normal(0, 0.3, obs1.shape).astype(np.float32)
    obs2 += rng.normal(0, 0.3, obs2.shape).astype(np.float32)
    sig = (1.2 ** rng.integers(0, 4, 512) ** 2).astype(np.float32)
    R0 = (_rot(np.array([0.01, -0.02, 0.015])) @ R).astype(np.float32)
    t0 = t + np.array([0.05, -0.04, 0.06], np.float32)
    return p1, p2, obs1, obs2, sig, valid, R0, t0


def test_sim3_jacobian_matches_jacfwd():
    """[2N, 2, 7] Jacobian against jax.jacfwd, 1e-4 relative."""
    p1, p2, obs1, obs2, _, valid, R0, t0 = _sim3_opt_problem()
    n = 64
    p1, p2, obs1, obs2 = (a[:n] for a in (p1, p2, obs1, obs2))

    def resid_flat(xi):
        s2, R2, t2 = jax_sim3_retract(jnp.float32(1.02), jnp.asarray(R0), jnp.asarray(t0), xi)
        e1, e2, _, _ = jax_sim3_residuals(s2, R2, t2, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(obs1),
                                          jnp.asarray(obs2), CAM, CAM)
        return jnp.concatenate([e1, e2], axis=0)

    Jj = np.asarray(jax.jacfwd(resid_flat)(jnp.zeros(7)))
    rj = np.asarray(resid_flat(jnp.zeros(7)))
    r, J = sim3_residual_jacobian(torch.tensor(1.02), T(R0), T(t0), T(p1), T(p2), T(obs1), T(obs2), TCAM, TCAM)
    assert J.shape == (2 * n, 2, 7)
    assert np.abs(r.numpy() - rj).max() < 1e-3
    assert np.abs(J.numpy() - Jj).max() <= 1e-4 * np.abs(Jj).max()


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_parity(fix_scale):
    """Result within 1e-4 rad, 1e-3 m, scale 1e-4; inlier counts within 2."""
    p1, p2, obs1, obs2, sig, valid, R0, t0 = _sim3_opt_problem()
    a = (p1, p2, obs1, obs2, sig, sig, valid)
    rj = jax_optimize_sim3(jnp.float32(1.0), jnp.asarray(R0), jnp.asarray(t0), *(jnp.asarray(x) for x in a),
                           CAM, CAM, fix_scale=fix_scale)
    rt = optimize_sim3(torch.tensor(1.0), T(R0), T(t0), *(T(x) for x in a), TCAM, TCAM, fix_scale=fix_scale)
    assert _angle(rt.R.numpy(), rj.R) < 1e-4
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 1e-3
    assert abs(float(rt.s) - float(rj.s)) < 1e-4
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2 and int(rt.n_inliers) > 150
    if fix_scale:
        assert float(rt.s) == 1.0
    assert not rt.inliers.numpy()[~valid].any()


# ----------------------------------------------------------------------
def _ring(K=24, n_live=16, seed=0):
    """A drifted ring of n_live keyframes in a table of K slots, odometry
    edges measured from the true poses, one loop edge closing it."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_live, endpoint=False)
    R_true = np.stack([_rot(np.array([0.0, a, 0.0])) for a in ang])
    c = np.stack([5 * np.cos(ang), np.zeros(n_live), 5 * np.sin(ang)], -1).astype(np.float32)
    t_true = -np.einsum("kij,kj->ki", R_true, c).astype(np.float32)

    def rel(Rb, tb, Ra, ta):  # T_b o T_a^-1
        Rr = Rb @ Ra.T
        return Rr, tb - Rr @ ta

    R0 = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    t0 = np.zeros((K, 3), np.float32)
    R0[0], t0[0] = R_true[0], t_true[0]
    ei, ej, eR, et = [], [], [], []
    for k in range(1, n_live):
        Rm, tm = rel(R_true[k], t_true[k], R_true[k - 1], t_true[k - 1])
        ei.append(k - 1), ej.append(k), eR.append(Rm), et.append(tm)
        Rd = _rot(rng.normal(0, 0.01, 3)) @ Rm          # drifted odometry
        td = tm + rng.normal(0, 0.03, 3).astype(np.float32)
        R0[k], t0[k] = Rd @ R0[k - 1], Rd @ t0[k - 1] + td
    Rm, tm = rel(R_true[0], t_true[0], R_true[n_live - 1], t_true[n_live - 1])
    ei.append(n_live - 1), ej.append(0), eR.append(Rm), et.append(tm)
    valid = np.zeros(K, bool)
    valid[:n_live] = True
    fixed = ~valid
    fixed[0] = True
    E = len(ei)
    return dict(s0=np.ones(K, np.float32), R0=R0, t0=t0, valid=valid, fixed=fixed,
                ei=np.array(ei, np.int32), ej=np.array(ej, np.int32), es=np.ones(E, np.float32),
                eR=np.stack(eR).astype(np.float32), et=np.stack(et).astype(np.float32),
                ev=np.ones(E, bool), ew=np.ones(E, np.float32)), t_true


_PG_KEYS = ("s0", "R0", "t0", "valid", "fixed", "ei", "ej", "es", "eR", "et", "ev", "ew")


def test_pose_graph_jacobians_match_jax():
    """Per-edge residuals and 7x7 Jacobians against vmap(jacfwd) of the
    JAX package's edge function, 1e-4 absolute."""
    from orb_line_slam_tpu.backend.pose_graph import _edge_residual
    from orb_line_slam_tpu.geometry.sim3 import sim3_compose, sim3_exp

    g, _ = _ring()
    s, R, t = jnp.asarray(g["s0"]), jnp.asarray(g["R0"]), jnp.asarray(g["t0"])

    def per_edge(i, j, sm, Rm, tm):
        def f(xi_i, xi_j):
            a = sim3_compose(*sim3_exp(xi_i), s[i], R[i], t[i])
            b = sim3_compose(*sim3_exp(xi_j), s[j], R[j], t[j])
            return _edge_residual(*a, *b, sm, Rm, tm)

        z = jnp.zeros(7)
        return (f(z, z), *jax.jacfwd(f, argnums=(0, 1))(z, z))

    rj, Jij, Jjj = jax.vmap(per_edge)(jnp.asarray(g["ei"]), jnp.asarray(g["ej"]), jnp.asarray(g["es"]),
                                      jnp.asarray(g["eR"]), jnp.asarray(g["et"]))
    r, Ji, Jj = edge_residuals_and_jacobians(T(g["s0"]), T(g["R0"]), T(g["t0"]), T(g["ei"]).long(), T(g["ej"]).long(),
                                             T(g["es"]), T(g["eR"]), T(g["et"]))
    assert np.abs(r.numpy() - np.asarray(rj)).max() < 1e-4
    assert np.abs(Ji.numpy() - np.asarray(Jij)).max() < 1e-4
    assert np.abs(Jj.numpy() - np.asarray(Jjj)).max() < 1e-4


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_pose_graph_parity(fix_scale):
    """Poses within 1e-3 m and 1e-4 rad of JAX's; fixed vertices and
    empty slots do not move; scales stay 1 when pinned."""
    g, t_true = _ring()
    sj, Rj, tj = jax_pose_graph(*(jnp.asarray(g[k]) for k in _PG_KEYS), n_iters=20, fix_scale=fix_scale)
    s, R, t = optimize_pose_graph(*(T(g[k]) for k in _PG_KEYS), n_iters=20, fix_scale=fix_scale)
    s, R, t = s.numpy(), R.numpy(), t.numpy()
    assert np.abs(t - np.asarray(tj)).max() < 1e-3
    assert _angle(R, Rj).max() < 1e-4
    assert np.abs(s - np.asarray(sj)).max() < 1e-4
    still = g["fixed"]
    assert np.array_equal(R[still], g["R0"][still]) and np.array_equal(t[still], g["t0"][still])
    if fix_scale:
        assert np.array_equal(s, np.ones_like(s))
    # the loop edge pulled the drifted tail back
    live = g["valid"]
    before = np.linalg.norm(g["t0"][live] - t_true, axis=1).max()
    after = np.linalg.norm(t[live] / s[live, None] - t_true, axis=1).max()
    assert after < 0.5 * before


def test_pose_graph_ignores_masked_edges():
    """Masked padding edges (the JAX package's edge buckets) do not
    change the solve."""
    g, _ = _ring()
    s, R, t = optimize_pose_graph(*(T(g[k]) for k in _PG_KEYS))
    pad = 7
    g2 = dict(g)
    g2["ei"] = np.concatenate([g["ei"], np.zeros(pad, np.int32)])
    g2["ej"] = np.concatenate([g["ej"], np.zeros(pad, np.int32)])
    g2["es"] = np.concatenate([g["es"], np.ones(pad, np.float32)])
    g2["eR"] = np.concatenate([g["eR"], np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])
    g2["et"] = np.concatenate([g["et"], np.zeros((pad, 3), np.float32)])
    g2["ev"] = np.concatenate([g["ev"], np.zeros(pad, bool)])
    g2["ew"] = np.concatenate([g["ew"], np.zeros(pad, np.float32)])
    s2, R2, t2 = optimize_pose_graph(*(T(g2[k]) for k in _PG_KEYS))
    assert np.abs(t.numpy() - t2.numpy()).max() < 1e-5 and np.abs(R.numpy() - R2.numpy()).max() < 1e-5


# ----------------------------------------------------------------------
BA_CAM = CameraIntrinsics(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=200.0, width=640, height=480)


def _ba_problem(C=10, P=600, seed=0, noise=0.0):
    """The problem of tests/test_global_ba_cg.py."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-10, 10, P), rng.uniform(-4, 4, P), rng.uniform(6, 40, P)], -1).astype(np.float32)
    R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
    t = np.zeros((C, 3), np.float32)
    t[:, 0] = -np.arange(C) * 0.4
    obs_cam, obs_lm, obs_uvur = [], [], []
    for c in range(C):
        sel = np.arange(P)[(np.arange(P) + c) % 3 != 0]
        xc = pts[sel] @ R[c].T + t[c]
        z = xc[:, 2]
        u = BA_CAM.fx * xc[:, 0] / z + BA_CAM.cx
        v = BA_CAM.fy * xc[:, 1] / z + BA_CAM.cy
        inside = (z > 1.0) & (u > 0) & (u < 640) & (v > 0) & (v < 480)
        obs_cam.append(np.full(inside.sum(), c))
        obs_lm.append(sel[inside])
        obs_uvur.append(np.stack([u[inside], v[inside], (u - BA_CAM.bf / z)[inside]], -1))
    obs_cam = np.concatenate(obs_cam).astype(np.int32)
    obs_lm = np.concatenate(obs_lm).astype(np.int32)
    obs_uvur = np.concatenate(obs_uvur).astype(np.float32)
    if noise:
        obs_uvur += rng.normal(0, noise, obs_uvur.shape).astype(np.float32)
    return pts, R, t, obs_cam, obs_lm, obs_uvur


def _ba_args(noise, seed):
    pts, R, t, oc, ol, ouv = _ba_problem(noise=noise)
    rng = np.random.default_rng(seed)
    C, P, O = len(R), len(pts), len(oc)
    pts0 = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)
    t0 = t + rng.normal(0, 0.02, t.shape).astype(np.float32)
    t0[0] = t[0]
    fixed = np.zeros(C, bool)
    fixed[0] = True
    octv = rng.integers(0, 3, O).astype(np.int32)
    return (R, t0, fixed, pts0, np.ones(P, bool), oc, ol, ouv, octv, np.ones(O, bool)), pts, t


@pytest.mark.parametrize("schedule", [(5, 10), (12, 0)])
def test_bundle_adjust_cg_parity(schedule):
    """Points within 1e-3 m (those nearer than 15 m; farther ones within
    0.02 px of stereo disparity, 1e-4 z^2 m at bf = 200: rounding moves a
    far point along its ray), poses within 1e-3 rad and 5e-3 m, inlier
    counts within 3 of the JAX package's; (12, 0) is the loop closer's
    single robust stage."""
    args, pts, t = _ba_args(noise=0.4, seed=1)
    i1, i2 = schedule
    rj = jax_ba_cg(*(jnp.asarray(a) for a in args), BA_CAM, iters1=i1, iters2=i2, cg_iters=48)
    rt = bundle_adjust_cg(*(T(a) for a in args), TorchCam(*BA_CAM), iters1=i1, iters2=i2, cg_iters=48)
    d = np.linalg.norm(rt.points.numpy() - np.asarray(rj.points), axis=1)
    z = pts[:, 2]
    assert d[z < 15].max() < 1e-3 and (d / z ** 2).max() < 1e-4 and np.median(d) < 1e-4
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 5e-3
    assert np.abs(rt.R.numpy() - np.asarray(rj.R)).max() < 1e-3
    assert abs(int(rt.obs_inlier.sum()) - int(np.asarray(rj.obs_inlier).sum())) <= 3
    assert abs(float(rt.chi2) - float(rj.chi2)) < 1e-3 * float(rj.chi2) + 1e-2
    assert np.array_equal(rt.t.numpy()[0], args[1][0])       # the fixed camera stays


def test_bundle_adjust_cg_matches_dense():
    """The port's CG and dense solvers reach the same optimum."""
    args, pts, t = _ba_args(noise=0.4, seed=2)
    targs = tuple(T(a) for a in args)
    rd = bundle_adjust(*targs, TorchCam(*BA_CAM))
    rc = bundle_adjust_cg(*targs, TorchCam(*BA_CAM))
    assert float(rc.chi2) < float(rd.chi2) * 1.05 + 1.0
    assert np.abs(rc.t.numpy() - rd.t.numpy()).max() < 5e-3
    assert (rc.obs_inlier.numpy() == rd.obs_inlier.numpy()).mean() > 0.99
    assert np.abs(rc.t.numpy() - t).max() < 2e-2


def test_bundle_adjust_cg_ignores_padding():
    """Masked padding (cameras, landmarks, observations beyond the live
    counts) does not change the solve: the live-size global BA equals
    the capacity-size one."""
    args, pts, _ = _ba_args(noise=0.4, seed=3)
    R, t0, fixed, pts0, pv, oc, ol, ouv, octv, ov = args
    pc, pp, po = 6, 200, 900
    padded = (
        np.concatenate([R, np.tile(np.eye(3, dtype=np.float32), (pc, 1, 1))]),
        np.concatenate([t0, np.zeros((pc, 3), np.float32)]),
        np.concatenate([fixed, np.ones(pc, bool)]),
        np.concatenate([pts0, np.zeros((pp, 3), np.float32)]),
        np.concatenate([pv, np.zeros(pp, bool)]),
        np.concatenate([oc, np.zeros(po, np.int32)]), np.concatenate([ol, np.zeros(po, np.int32)]),
        np.concatenate([ouv, np.zeros((po, 3), np.float32)]), np.concatenate([octv, np.zeros(po, np.int32)]),
        np.concatenate([ov, np.zeros(po, bool)]),
    )
    cam = TorchCam(*BA_CAM)
    a = bundle_adjust_cg(*(T(x) for x in args), cam, iters1=12, iters2=0)
    b = bundle_adjust_cg(*(T(x) for x in padded), cam, iters1=12, iters2=0)
    C, P, O = len(R), len(pts0), len(oc)
    assert np.abs(a.t.numpy() - b.t.numpy()[:C]).max() < 1e-4
    d = np.linalg.norm(a.points.numpy() - b.points.numpy()[:P], axis=1)
    assert d[pts[:, 2] < 15].max() < 1e-3 and (d / pts[:, 2] ** 2).max() < 1e-4    # as in the parity test
    assert np.array_equal(a.obs_inlier.numpy(), b.obs_inlier.numpy()[:O]) and not b.obs_inlier.numpy()[O:].any()


# ----------------------------------------------------------------------
def test_search_by_sim3_dir_identical():
    """Identical match indices, distances and masks."""
    rng = np.random.default_rng(8)
    M = N = 300
    pts = np.stack([rng.uniform(-5, 5, M), rng.uniform(-2.5, 2.5, M), rng.uniform(3, 20, M)], -1).astype(np.float32)
    pts[:10, 2] = -1.0                       # behind the camera
    desc_src = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    perm = rng.permutation(N)
    xy_dst = (_project(np.where(pts[:, 2:3] > 0, pts, [0, 0, 1.0]).astype(np.float32))[perm]
              + rng.normal(0, 2.5, (N, 2))).astype(np.float32)
    desc_dst = desc_src[perm].copy()
    noise = rng.random((N, 32)) < 0.08
    desc_dst[noise] ^= rng.integers(1, 256, int(noise.sum()), dtype=np.uint8)
    oct_dst = rng.integers(0, 4, N).astype(np.int32)
    valid_src = rng.random(M) > 0.1
    valid_dst = rng.random(N) > 0.1
    scales = tuple(float(1.2 ** i) for i in range(4))
    mj = jax_search_by_sim3_dir(jnp.asarray(pts), jnp.asarray(desc_src), jnp.asarray(valid_src), jnp.asarray(xy_dst),
                                jnp.asarray(desc_dst), jnp.asarray(oct_dst), jnp.asarray(valid_dst), CAM, scales)
    mt = search_by_sim3_dir(T(pts), T(desc_src), T(valid_src), T(xy_dst), T(desc_dst), T(oct_dst), T(valid_dst),
                            TCAM, scales)
    assert np.array_equal(mt.mask.numpy(), np.asarray(mj.mask)) and 50 < int(mt.mask.sum()) < M
    assert np.array_equal(mt.idx.numpy(), np.asarray(mj.idx))
    assert np.array_equal(mt.dist.numpy()[mt.mask.numpy()], np.asarray(mj.dist)[np.asarray(mj.mask)])


class _Frame:
    def __init__(self, descs, pts_cam, octave):
        u, v = _project(pts_cam).T
        self.xy = np.stack([u, v], -1).astype(np.float32)
        self.u_right = (u - CAM.bf / pts_cam[:, 2]).astype(np.float32)
        self.depth = pts_cam[:, 2].astype(np.float32)
        self.octave = octave
        self.angle = np.zeros(len(descs), np.float32)
        self.desc = descs
        self.valid = np.ones(len(descs), bool)


def _fuse_store():
    """Two keyframes of one place 0.3 m apart, each with its own copy of
    the landmarks (duplicates), the second observing only half of its
    features."""
    rng = np.random.default_rng(9)
    F = 200
    store = JaxMapStore(JaxMapConfig(max_keyframes=8, max_points=2048, max_lines=8, local_window=4,
                                     local_points=512), F)
    pts_w = np.stack([rng.uniform(-4, 4, F), rng.uniform(-2, 2, F), rng.uniform(5, 18, F)], -1).astype(np.float32)
    desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    octv = rng.integers(0, 2, F).astype(np.int32)
    ids = []
    for k, tx in enumerate((0.0, -0.3)):
        t = np.array([tx, 0, 0], np.float32)
        kf = store.add_keyframe(_Frame(desc, pts_w + t, octv), np.eye(3, dtype=np.float32), t, frame_id=k)
        n = F if k == 0 else F // 2
        ids.append(store.add_points(pts_w[:n] + rng.normal(0, 0.01, (n, 3)).astype(np.float32), desc[:n], octv[:n],
                                    kf, np.arange(n)))
    store.update_point_stats(np.concatenate(ids))
    return store, ids


def test_fuse_into_keyframe_identical():
    """Identical kf_obs_lm and merged-landmark sets after the fuse."""
    store_j, ids = _fuse_store()
    store_t = map_store_from_numpy(store_j)
    scales = tuple(float(1.2 ** i) for i in range(4))
    before = store_j.kf_obs_lm.copy()
    nj = jax_fuse_into_keyframe(store_j, ids[0].astype(np.int64), 1, CAM, scales, radius=4.0)
    nt = fuse_into_keyframe(store_t, ids[0].astype(np.int64), 1, TCAM, scales, radius=4.0, device="cpu")
    assert nj == nt and nt > 100
    assert np.array_equal(store_j.kf_obs_lm, store_t.kf_obs_lm) and not np.array_equal(before, store_t.kf_obs_lm)
    assert np.array_equal(store_j.pt_valid, store_t.pt_valid)
    assert int(store_t.pt_valid.sum()) < len(ids[0]) + len(ids[1])      # duplicates merged
    assert np.array_equal(store_j.pt_pos[store_j.pt_valid], store_t.pt_pos[store_t.pt_valid])
