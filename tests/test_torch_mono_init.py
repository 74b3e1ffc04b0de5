"""The monocular initializer of the torch port against the JAX package on
the CPU: the hypothesis draws (bit for bit), the Hartley normalisation,
the DLT and eight-point solvers (up to sign), the per-hypothesis H and F
scores, ``initialize_two_view`` on tests/test_pnp_init.py's planar and
general fixtures and on one with 20% outliers, and ``match_in_window``
on two rendered frames."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import LineConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.frontend import initializer as jinit
from orb_line_slam_tpu.frontend.frame import build_mono_frame as jax_build_mono_frame
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics, project
from orb_line_slam_tpu.geometry.se3 import se3_apply, se3_exp
from orb_line_slam_tpu.matching.point_matcher import match_in_window as jax_match_in_window
from orb_line_slam_tpu_torch.backend.pnp import draw_hypotheses, fold_in, jax_uniform, prng_key
from orb_line_slam_tpu_torch.config import CameraIntrinsics as TorchCam
from orb_line_slam_tpu_torch.convert import frame_from_numpy
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
from orb_line_slam_tpu_torch.frontend import initializer as tinit
from orb_line_slam_tpu_torch.matching.point_matcher import match_in_window

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)

# tests/test_pnp_init.py's camera and two-view fixtures.
CAM = CameraIntrinsics(fx=450.0, fy=450.0, cx=320.0, cy=240.0, bf=90.0, width=640, height=480)
TCAM = TorchCam(*CAM)


def _two_view(kind, seed=55, n=150):
    """Pixel matches of n points seen from (I|0) and from
    se3_exp([0.4, 0.05, 0.1, 0.02, -0.06, 0.01]), as tests/test_pnp_init.py
    builds them: a plane at z = 10 m ('planar'), a 6-25 m volume
    ('general'), or the volume with 20% of the second view's points moved
    30-120 px ('outliers')."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 10.0) if kind == "planar" else rng.uniform(6, 25, n)
    pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-3, 3, n), z], -1).astype(np.float32)
    R_gt, t_gt = se3_exp(jnp.asarray([0.4, 0.05, 0.1, 0.02, -0.06, 0.01]))
    p1 = np.asarray(project(CAM, jnp.asarray(pts)))
    p2 = np.array(project(CAM, se3_apply(R_gt, t_gt, jnp.asarray(pts))))
    if kind == "outliers":
        n_out = n // 5
        p2[:n_out] += rng.uniform(30, 120, (n_out, 2)).astype(np.float32)
    ok = ((p1[:, 0] > 0) & (p1[:, 0] < 640) & (p1[:, 1] > 0) & (p1[:, 1] < 480)
          & (p2[:, 0] > 0) & (p2[:, 0] < 640) & (p2[:, 1] > 0) & (p2[:, 1] < 480))
    return p1.astype(np.float32), p2.astype(np.float32), ok, np.asarray(R_gt), np.asarray(t_gt)


def _jax_draws(valid, key, n_hyps=200):
    """JAX initializer.py:180-189: the H and F sample indices."""
    valid = jnp.asarray(valid)
    prob = valid.astype(jnp.float32)
    prob = prob / jnp.maximum(prob.sum(), 1.0)
    idxH = jax.random.choice(key, valid.shape[0], shape=(n_hyps, 4), replace=True, p=prob)
    idxF = jax.random.choice(jax.random.fold_in(key, 1), valid.shape[0], shape=(n_hyps, 8), replace=True, p=prob)
    return np.asarray(idxH), np.asarray(idxF)


def _jax_hypotheses(p1, p2, valid, idxH, idxF, sigma2=1.0):
    """JAX initializer.py:191-205 as written, on given sample indices, in
    the dtype of p1 and p2: (sH, Hs, sF, Fs)."""
    p1, p2, valid, idxH, idxF = (jnp.asarray(a) for a in (p1, p2, valid, idxH, idxF))
    p1n, T1 = jinit._normalize(p1)
    p2n, T2 = jinit._normalize(p2)

    def hypH(i):
        Hp = jnp.linalg.inv(T2) @ jinit._dlt_homography(p1n[idxH[i]], p2n[idxH[i]]) @ T1
        s, _ = jinit._homography_score(Hp, p1, p2, sigma2)
        return jnp.sum(jnp.where(valid, s, 0.0)), Hp

    def hypF(i):
        Fp = T2.T @ jinit._eight_point(p1n[idxF[i]], p2n[idxF[i]]) @ T1
        s, _ = jinit._fundamental_score(Fp, p1, p2, sigma2)
        return jnp.sum(jnp.where(valid, s, 0.0)), Fp

    sH, Hs = jax.vmap(hypH)(jnp.arange(idxH.shape[0]))
    sF, Fs = jax.vmap(hypF)(jnp.arange(idxF.shape[0]))
    return [np.asarray(a) for a in (sH, Hs, sF, Fs)]


def _sample_conditioning(p1, p2, idx, model):
    """lambda_2 / lambda_max of each sample's DLT ('H') or eight-point
    ('F') normal matrix, float64: how well the sample fixes its null
    vector (0 for a degenerate sample, e.g. one that repeats a match)."""
    n1, n2 = (np.asarray(jinit._normalize(jnp.asarray(p))[0], np.float64)[idx] for p in (p1, p2))
    x, y, u, v = n1[..., 0], n1[..., 1], n2[..., 0], n2[..., 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    if model == "H":
        A = np.concatenate([np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1),
                            np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)], 1)
    else:
        A = np.stack([u * x, u * y, u, v * x, v * y, v, x, y, o], -1)
    w = np.linalg.eigvalsh(np.swapaxes(A, 1, 2) @ A)
    return w[:, 1] / w[:, -1]


def _same_up_to_sign(a, b, atol):
    """a ~ +-b per leading index (matrices scaled alike)."""
    a, b = a.reshape(len(a), -1), b.reshape(len(b), -1)
    sign = np.sign(np.sum(a * b, axis=1, keepdims=True))
    return np.abs(a - sign * b).max() <= atol


@pytest.mark.parametrize("seed", [0, 3, 17, 2**31 + 5])
def test_fold_in_and_hypothesis_draws_bit_exact(seed):
    """fold_in is jax.random.fold_in's key; the 200x4 draw from the key and
    the 200x8 draw from fold_in(key, 1) are jax.random.choice's, index for
    index, and so are the uniforms beneath them, bit for bit."""
    key = jax.random.PRNGKey(seed)
    assert prng_key(seed) == tuple(int(v) for v in np.asarray(key))
    kf = jax.random.fold_in(key, 1)
    assert fold_in(seed, 1) == tuple(int(v) for v in np.asarray(kf))
    assert fold_in(prng_key(seed), 7) == tuple(int(v) for v in np.asarray(jax.random.fold_in(key, 7)))
    want_u = np.asarray(jax.random.uniform(kf, (200, 8))).ravel()
    assert np.array_equal(jax_uniform(fold_in(seed, 1), 1600).view(np.uint32), want_u.view(np.uint32))
    rng = np.random.default_rng(seed % 1000)
    valid = rng.random(1000) < 0.4
    p = jnp.asarray(valid.astype(np.float32) / np.float32(valid.sum()))
    wantH = np.asarray(jax.random.choice(key, 1000, shape=(200, 4), replace=True, p=p))
    wantF = np.asarray(jax.random.choice(kf, 1000, shape=(200, 8), replace=True, p=p))
    np.testing.assert_array_equal(draw_hypotheses(T(valid), seed, 200, 4).numpy(), wantH)
    np.testing.assert_array_equal(draw_hypotheses(T(valid), fold_in(seed, 1), 200, 8).numpy(), wantF)


def test_normalize_dlt_and_eight_point():
    """Hartley normalisation within 1e-5.  The DLT homographies and
    eight-point fundamental matrices of 64 samples each: on every sample
    that fixes its null vector (conditioning > 1e-8), a float64 numpy
    solve of the same normal matrix up to sign within 1e-8; on the
    well-conditioned DLT samples (> 1e-4), JAX's float32 solve up to sign
    within 2e-3; each F of rank 2 and satisfying its eight constraints."""
    p1, p2, ok, _, _ = _two_view("general")
    n1j, T1j = jinit._normalize(jnp.asarray(p1))
    n1t, T1t = tinit._normalize(T(p1))
    np.testing.assert_allclose(n1t.numpy(), np.asarray(n1j), atol=1e-5)
    np.testing.assert_allclose(T1t.numpy(), np.asarray(T1j), rtol=1e-6, atol=1e-5)
    n2j, _ = jinit._normalize(jnp.asarray(p2))
    n1, n2 = np.asarray(n1j), np.asarray(n2j)
    rng = np.random.default_rng(2)
    idx4 = np.stack([rng.choice(len(p1), 4, replace=False) for _ in range(64)])
    idx8 = np.stack([rng.choice(len(p1), 8, replace=False) for _ in range(64)])
    Ht = tinit._dlt_homography(T(n1[idx4]), T(n2[idx4])).numpy()
    Ft = tinit._eight_point(T(n1[idx8]), T(n2[idx8])).numpy()
    assert Ht.dtype == Ft.dtype == np.float64 and Ht.shape == Ft.shape == (64, 3, 3)
    a, b = n1[idx4].astype(np.float64), n2[idx4].astype(np.float64)
    x, y, u, v = a[..., 0], a[..., 1], b[..., 0], b[..., 1]
    z, o = np.zeros_like(x), np.ones_like(x)
    A = np.concatenate([np.stack([z, z, z, -x, -y, -o, v * x, v * y, v], -1),
                        np.stack([x, y, o, z, z, z, -u * x, -u * y, -u], -1)], 1)
    H64 = np.linalg.eigh(np.swapaxes(A, 1, 2) @ A)[1][..., 0].reshape(64, 3, 3)
    condH = _sample_conditioning(p1, p2, idx4, "H")
    assert (condH > 1e-8).sum() >= 60
    assert _same_up_to_sign(Ht[condH > 1e-8], H64[condH > 1e-8], 1e-8)
    well = condH > 1e-4
    assert well.sum() >= 16
    Hj = np.stack([np.asarray(jinit._dlt_homography(n1j[i], n2j[i])) for i in idx4[well]])
    assert _same_up_to_sign(Ht[well], Hj, 2e-3)
    np.testing.assert_allclose(np.linalg.svd(Ft, compute_uv=False)[:, 2], 0.0, atol=1e-9)
    h1 = np.concatenate([n1[idx8], np.ones((64, 8, 1))], -1)
    h2 = np.concatenate([n2[idx8], np.ones((64, 8, 1))], -1)
    assert np.abs(np.einsum("bki,bij,bkj->bk", h2, Ft, h1)).max() < 1e-3


@pytest.mark.parametrize("kind", ["general", "planar"])
def test_hypothesis_scores_match_jax(kind):
    """The 200 H and 200 F hypotheses of one initialization, with 0.5 px of
    noise on the second view.  Against the JAX package's own functions run
    in float64 on the same samples: of the hypotheses whose sample fixes its
    null vector (conditioning > 1e-8), 99% score within 1e-3 relative + 1
    (a point at a score threshold may cross it) and all agree up to sign
    within 1e-3 of their norm; the best of each model is the same clear
    winner.  Against JAX as it runs (float32 null vectors): the H
    hypotheses of well-conditioned samples (> 1e-4) score within 2e-2
    relative + 1.  The F samples are all worse conditioned than that: a
    float32 eigensolver returns noise for them, which is why the port
    solves them in float64."""
    p1, p2, ok, _, _ = _two_view(kind)
    p2 = p2 + np.random.default_rng(1).normal(0, 0.5, p2.shape).astype(np.float32)
    idxH, idxF = _jax_draws(ok, jax.random.PRNGKey(3))
    sHt, Hst, sFt, Fst = (x.numpy() for x in tinit.hypothesis_scores(T(p1), T(p2), T(ok), 3))
    with jax.enable_x64(True):
        sH64, Hs64, sF64, Fs64 = _jax_hypotheses(p1.astype(np.float64), p2.astype(np.float64), ok, idxH, idxF)
    assert sH64.dtype == np.float64
    unit = lambda M: M / np.linalg.norm(M, axis=(1, 2), keepdims=True)  # noqa: E731
    for model, st, s64, Mt, M64, idx in (("H", sHt, sH64, Hst, Hs64, idxH), ("F", sFt, sF64, Fst, Fs64, idxF)):
        fixed = _sample_conditioning(p1, p2, idx, model) > 1e-8
        assert fixed.sum() >= 140, (model, fixed.sum())
        assert (np.abs(st - s64)[fixed] <= 1e-3 * np.abs(s64[fixed]) + 1.0).mean() >= 0.99, model
        assert abs(st.max() - s64.max()) <= 1e-3 * s64.max(), model
        assert _same_up_to_sign(unit(Mt)[fixed], unit(M64)[fixed], 1e-3), model
        assert np.argmax(st) == np.argmax(s64) and np.sort(s64)[-2] < (1 - 1e-3) * s64.max(), model
    sHj, _, _, _ = _jax_hypotheses(p1, p2, ok, idxH, idxF)
    good = _sample_conditioning(p1, p2, idxH, "H") > 1e-4
    assert good.sum() >= 50
    np.testing.assert_allclose(sHt[good], sHj[good], rtol=2e-2, atol=1.0)


def _rot_angle(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    return float(np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1)))


@pytest.mark.parametrize("kind,seed", [("general", 3), ("planar", 3), ("outliers", 11)])
def test_initialize_two_view_matches_jax(kind, seed):
    """The same success and model, R within 1e-3 rad, the unit t within
    5e-3, inlier counts within 3; and both near the truth."""
    p1, p2, ok, R_gt, t_gt = _two_view(kind)
    rj = jax.device_get(jinit.initialize_two_view(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ok),
                                                  jax.random.PRNGKey(seed), CAM))
    rt = tinit.initialize_two_view(T(p1), T(p2), T(ok), seed, TCAM)
    assert bool(rj.success) and bool(rt.success)
    assert bool(rt.used_homography) == bool(rj.used_homography) == (kind == "planar")
    assert _rot_angle(rt.R.numpy(), rj.R) < 1e-3
    assert np.abs(rt.t.numpy() - rj.t).max() < 5e-3
    assert abs(int(rt.inliers.sum()) - int(rj.inliers.sum())) <= 3
    assert _rot_angle(rt.R.numpy(), R_gt) < 2e-2
    assert abs(float(np.dot(rt.t.numpy(), t_gt / np.linalg.norm(t_gt)))) > 0.995
    both = rt.inliers.numpy() & rj.inliers
    np.testing.assert_allclose(rt.points3d.numpy()[both], rj.points3d[both], rtol=5e-3, atol=5e-3)
    if kind == "outliers":
        assert rt.inliers.numpy()[: len(p1) // 5].mean() < 0.1


def test_initialize_two_view_fails_without_parallax():
    """A pure rotation gives no parallax: neither package initialises."""
    p1, _, ok, _, _ = _two_view("general")
    R, _ = se3_exp(jnp.asarray([0.0, 0.0, 0.0, 0.01, -0.02, 0.005]))
    K = np.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1.0]])
    h = np.concatenate([p1, np.ones((len(p1), 1), np.float32)], 1) @ (K @ np.asarray(R) @ np.linalg.inv(K)).T
    p2 = (h[:, :2] / h[:, 2:]).astype(np.float32)
    rj = jinit.initialize_two_view(jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(ok), jax.random.PRNGKey(5), CAM)
    rt = tinit.initialize_two_view(T(p1), T(p2), T(ok), 5, TCAM)
    assert not bool(rj.success) and not bool(rt.success)


def test_match_in_window_matches_jax():
    """On two rendered frames (one feature table for both packages), with
    the tracker's window and a tighter one: the same indices, distances
    and mask."""
    cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
    cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=False))
    scene = SyntheticScene(TorchCam(*cam), n_points=1000, seed=12, extent=((-10, 10), (-5, 5), (4, 25)))
    fa, fb = (jax.device_get(jax_build_mono_frame(jnp.asarray(scene.render(np.eye(3), -np.array([x, 0.0, z]))), cfg))
              for x, z in ((0.0, 0.0), (0.4, 0.16)))
    for kw, least in ((dict(radius=100.0, max_dist=50, ratio=0.9), 100), (dict(radius=30.0, max_dist=40, ratio=0.8), 20)):
        mj = jax.device_get(jax_match_in_window(fa, fb, **kw))
        mt = match_in_window(frame_from_numpy(fa._asdict(), "cpu"), frame_from_numpy(fb._asdict(), "cpu"), **kw)
        np.testing.assert_array_equal(mt.idx.numpy(), mj.idx)
        np.testing.assert_array_equal(mt.dist.numpy(), mj.dist)
        np.testing.assert_array_equal(mt.mask.numpy(), mj.mask)
        assert mj.mask.sum() > least
