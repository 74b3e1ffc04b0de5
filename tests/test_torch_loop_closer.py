"""LoopCloser of the torch port against the JAX package's on a synthetic
drifted map (the fixture of tests/test_loop_closing.py): the same
keyframe closes the loop, the accepted Sim3 agrees within 1e-3 rad and
5e-3 m, and after the correction (and after global BA) keyframe
positions agree within 1e-2 m and meet the JAX test's own bounds.  The
global BA is held to the JAX package's twice: on the just-corrected map
with identical inputs (``test_global_ba_on_corrected_map_follows_jax``),
and through ``run_global_ba`` on a perturbed copy of the map, where the
problem is well posed (see ``test_corrected_map_agrees`` for why not
through ``run_global_ba`` on the corrected one)."""

import copy

import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.loop.loop_closing import LoopCloser as JaxLoopCloser
from orb_line_slam_tpu.loop.vocabulary import Vocabulary as JaxVocabulary
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.convert import config_from_jax, map_store_from_numpy, vocabulary_from_numpy
from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser, LoopEdge

torch.set_num_threads(1)
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
F = 256  # features per KF


class _F:
    """Duck-typed Frame for MapStore.add_keyframe."""

    def __init__(self, descs, pts_cam, mono=False):
        n = len(descs)
        u = CAM.fx * pts_cam[:, 0] / pts_cam[:, 2] + CAM.cx
        va = CAM.fy * pts_cam[:, 1] / pts_cam[:, 2] + CAM.cy
        self.xy = np.stack([u, va], -1).astype(np.float32)
        # A monocular keyframe has no right-image coordinate and no depth.
        self.u_right = np.full(n, -1.0, np.float32) if mono else (u - CAM.bf / pts_cam[:, 2]).astype(np.float32)
        self.depth = np.full(n, -1.0, np.float32) if mono else pts_cam[:, 2].astype(np.float32)
        self.octave = np.zeros(n, np.int32)
        self.angle = np.zeros(n, np.float32)
        self.desc = descs
        self.valid = np.ones(n, bool)


def build_drifted_map(n_lines=0, scale_drift=0.0, mono=False):
    """tests/test_loop_closing.py::build_drifted_map (a local generator
    and a 4096-point capacity): 12 keyframes out along z and back, the
    return leg drifting up to 1.8 m, each keyframe re-observing part of
    the previous one's landmarks.

    ``scale_drift`` adds the drift of a monocular map: along the return
    leg the map's scale grows to 1 + scale_drift at the last keyframe,
    each step between keyframes and each keyframe's own landmarks
    (their depths in its camera) scaled by its keyframe's factor, so the
    Sim3 from the loop keyframe's camera to the closing one's has scale
    1 + scale_drift.  ``mono`` stores the observations without a right
    coordinate or depth (u_right = depth = -1).  With neither, the map is
    the original one bit for bit."""
    rng = np.random.default_rng(33)
    cfg = SlamConfig(
        camera=CAM,
        orb=OrbConfig(n_features=F, n_levels=4),
        map=MapConfig(max_keyframes=32, max_points=4096, max_lines=64, local_window=6, local_points=2048),
    )
    store = JaxMapStore(cfg.map, F, n_lines=n_lines)

    n_kf = 12
    drift = np.array([1.5, 0.4, 0.8], np.float32)  # accumulated at return
    n_own = 156  # own landmarks per KF; the remaining slots reobserve
    n_shared = F - n_own  # the previous KF's landmarks (covisibility)

    place_desc = {k: rng.integers(0, 256, (F, 32), dtype=np.uint8) for k in range(9)}
    pts_cam = np.stack([rng.uniform(-4, 4, F), rng.uniform(-2, 2, F), rng.uniform(5, 25, F)], -1).astype(np.float32)

    true_t = []
    prev_ids = None
    prev_place = None
    scale_offset = np.zeros(3, np.float32)   # what the scale drift adds to the path
    for k in range(n_kf):
        place = k if k < 9 else 11 - k
        t_true = np.array([0.0, 0.0, 1.0 * place], np.float32)
        frac = max(0, (k - 6) / (n_kf - 7))
        sc = np.float32(1.0 + scale_drift * frac)
        if k:
            scale_offset = scale_offset + (sc - 1) * (t_true - true_t[-1])
        true_t.append(t_true)
        t_est = t_true + drift * frac + scale_offset     # drifted for the return keyframes
        R = np.eye(3, dtype=np.float32)

        descs = place_desc[place].copy()
        if prev_place is not None:
            descs[n_own:] = place_desc[prev_place][:n_shared]
        kf = store.add_keyframe(_F(descs, pts_cam, mono), R, t_est, frame_id=k, timestamp=k * 0.1)
        # own landmarks from the DRIFTED pose (self-consistent map)
        ids = store.add_points(pts_cam[:n_own] * sc - t_est, descs[:n_own], np.zeros(n_own, np.int32), kf,
                               np.arange(n_own))
        # shared observations of the previous KF's landmarks, at their
        # true projections into this camera
        if prev_ids is not None:
            store.kf_obs_lm[kf, n_own:] = prev_ids[:n_shared]
            p_cam = store.pt_pos[prev_ids[:n_shared]] @ R.T + t_est
            u = CAM.fx * p_cam[:, 0] / p_cam[:, 2] + CAM.cx
            v = CAM.fy * p_cam[:, 1] / p_cam[:, 2] + CAM.cy
            store.kf_xy[kf, n_own:] = np.stack([u, v], -1)
            if not mono:
                store.kf_ur[kf, n_own:] = u - CAM.bf / p_cam[:, 2]
                store.kf_depth[kf, n_own:] = p_cam[:, 2]
        prev_ids = ids
        prev_place = place
    return cfg, store, np.stack(true_t), drift


def _drive(lc, store):
    closed_at = None
    for k in range(store._next_kf):
        if lc.process_keyframe(k, run_gba=False):
            closed_at = lc.last_closed_kf
    if closed_at is None and lc.flush(run_gba=False):
        closed_at = lc.last_closed_kf
    return closed_at


def _angle(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    w = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return np.arcsin(min(np.linalg.norm(w) / 2, 1.0))


@pytest.fixture(scope="module")
def closed():
    """Both packages' LoopCloser over copies of one drifted map with one
    vocabulary: the state after the correction, and after global BA."""
    cfg, store_j, true_t, _ = build_drifted_map()
    voc_j = JaxVocabulary.train(store_j.kf_desc[store_j.kf_valid].reshape(-1, 32)[:8000], k=8, depth=3)
    store_t = map_store_from_numpy(store_j)
    start_t = store_j.kf_t.copy()
    lc_j = JaxLoopCloser(cfg, store_j, voc_j)
    lc_t = LoopCloser(config_from_jax(cfg), store_t, vocabulary_from_numpy(voc_j), device="cpu")
    out = {"true_t": true_t, "start_t": start_t, "lc_j": lc_j, "lc_t": lc_t}
    out["closed_j"] = _drive(lc_j, store_j)
    out["closed_t"] = _drive(lc_t, store_t)
    out["after_correct"] = (copy.deepcopy((store_j.kf_R, store_j.kf_t, store_j.pt_pos, store_j.pt_valid)),
                            copy.deepcopy((store_t.kf_R, store_t.kf_t, store_t.pt_pos, store_t.pt_valid)))
    lc_j.run_global_ba()
    lc_t.run_global_ba()
    out["after_gba"] = ((store_j.kf_R.copy(), store_j.kf_t.copy(), store_j.pt_pos.copy(), store_j.pt_valid.copy()),
                        (store_t.kf_R.copy(), store_t.kf_t.copy(), store_t.pt_pos.copy(), store_t.pt_valid.copy()))
    return out


def test_loop_closes_at_the_same_keyframe(closed):
    assert closed["closed_j"] is not None, "the JAX package never closed the loop"
    assert closed["closed_t"] == closed["closed_j"] and closed["closed_t"] >= 10
    lc_j, lc_t = closed["lc_j"], closed["lc_t"]
    assert len(lc_t.loop_edges) == len(lc_j.loop_edges) == 1
    ej, et = lc_j.loop_edges[0], lc_t.loop_edges[0]
    assert (et.kf_a, et.kf_b, et.gen_a, et.gen_b) == (ej.kf_a, ej.kf_b, ej.gen_a, ej.gen_b)
    # the accepted Sim3: 1e-3 rad, 5e-3 m, and the pinned scale
    assert _angle(et.R, ej.R) < 1e-3
    assert np.abs(np.asarray(et.t) - np.asarray(ej.t)).max() < 5e-3
    assert float(et.s) == float(ej.s) == 1.0
    # the databases saw the same words
    assert lc_t.db.bow.keys() == lc_j.db.bow.keys()
    for k in lc_t.db.bow:
        assert np.array_equal(lc_t.db.bow[k][0], lc_j.db.bow[k][0])
    for name in ("detect", "sim3", "correct", "essential_graph"):
        assert lc_t.timing.cnt[name] >= 1


@pytest.mark.parametrize("stage", ["after_correct", "after_gba"])
def test_corrected_map_agrees(closed, stage):
    """After the correction: keyframe positions within 1e-2 m of the JAX
    package's.  At both stages the JAX test's bounds: the loop keyframe
    within 0.4 m of truth, the mid-chain keyframe within 0.8 m.

    After global BA the two maps are not held to each other here: the
    corrected fixture is far from consistent (its reduced camera system
    is indefinite in float32 and the first LM steps move landmarks by
    tens of metres), so the 5e-4 m by which the two corrected maps
    differ grows to decimetres over the twelve iterations.
    ``test_global_ba_on_corrected_map_follows_jax`` holds the solver to
    the JAX package's on this very map with identical inputs, and
    ``test_global_ba_parity_on_perturbed_map`` holds ``run_global_ba``
    where the problem is well posed."""
    (Rj, tj, pj, vj), (Rt, tt, pt, vt) = closed[stage]
    n = 12
    true_t, c = closed["true_t"], closed["closed_t"]
    for t_est in (tt, tj):
        assert np.linalg.norm(t_est[c] - true_t[c]) < 0.4
        assert np.linalg.norm(t_est[8] - true_t[8]) < 0.8
    # it was drifted by more than that before
    assert np.linalg.norm(closed["start_t"][c] - true_t[c]) > 1.0
    assert np.array_equal(vt, vj)
    if stage == "after_correct":
        assert np.abs(tt[:n] - tj[:n]).max() < 1e-2
        assert max(_angle(Rt[k], Rj[k]) for k in range(n)) < 1e-3
        assert np.median(np.linalg.norm(pt[vt] - pj[vj], axis=1)) < 1e-2
    else:
        lc_t = closed["lc_t"]
        assert lc_t.n_gba_applied == 1 and lc_t.last_gba_solver == "dense"
        assert np.isfinite(tt).all() and np.isfinite(pt[vt]).all()
        assert np.array_equal(tt[0], closed["after_correct"][1][1][0])      # the gauge keyframe stays


def test_global_ba_on_corrected_map_follows_jax():
    """The global BA problem of the just-corrected map, the same arrays
    into both packages' ``bundle_adjust``.  Its reduced camera system is
    indefinite in float32: the JAX package's LU solve still returns a
    step, rejects the first and accepts the second, and the port must
    follow (a Cholesky factorisation fails there and rejects all twelve).
    Keyframes within 5e-2 m after two iterations and 2e-2 m after twelve,
    landmarks within 2e-2 m in the median."""
    import jax.numpy as jnp

    from orb_line_slam_tpu.backend.local_ba import bundle_adjust as jax_bundle_adjust
    from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust

    lc, store, _ = _closer()
    assert _drive(lc, store) == 11
    pack, _ = lc._dispatch_gba(0, 0)
    n_c, n_p, n_o = len(pack["cam_ids"]), len(pack["lm_ids"]), int(pack["n_obs"])
    cut = {"R": n_c, "t": n_c, "cam_fixed": n_c, "points": n_p, "point_valid": n_p}
    keys = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")
    args = [pack[k][: cut.get(k, n_o)] for k in keys]
    cam, sf = lc.cfg.camera, lc.cfg.orb.scale_factor
    for iters, tol_t in ((1, 1e-6), (2, 5e-2), (12, 2e-2)):
        rj = jax_bundle_adjust(*(jnp.asarray(a) for a in args), CAM, sf, iters1=iters, iters2=0, fix_first=True)
        rt = bundle_adjust(*(torch.from_numpy(a) for a in args), cam, sf, iters1=iters, iters2=0, fix_first=True)
        moved_j = float(np.abs(np.asarray(rj.t) - args[1]).max())
        moved_t = float(np.abs(rt.t.numpy() - args[1]).max())
        assert (moved_j > 0.1) == (moved_t > 0.1) == (iters > 1), (iters, moved_j, moved_t)
        assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < tol_t
        assert np.median(np.linalg.norm(rt.points.numpy() - np.asarray(rj.points), axis=1)) < 2e-2


def test_global_ba_parity_on_perturbed_map():
    """run_global_ba of both packages on the same perturbed map (2 cm on
    the keyframes, 3 cm on the landmarks): keyframes within 1e-2 m and
    1e-3 rad, landmarks within 1e-2 m in the median, and the
    keyframes stay within 5 cm of the unperturbed ones."""
    cfg, store_j, _, _ = build_drifted_map()
    rng = np.random.default_rng(5)
    clean_t = store_j.kf_t.copy()
    store_j.kf_t[1:12] += rng.normal(0, 0.02, (11, 3)).astype(np.float32)
    ids = np.nonzero(store_j.pt_valid)[0]
    store_j.pt_pos[ids] += rng.normal(0, 0.03, (len(ids), 3)).astype(np.float32)
    store_t = map_store_from_numpy(store_j)
    voc_j = JaxVocabulary.synthesize(k=4, depth=2)
    JaxLoopCloser(cfg, store_j, voc_j).run_global_ba()
    lc_t = LoopCloser(config_from_jax(cfg), store_t, vocabulary_from_numpy(voc_j), device="cpu")
    lc_t.run_global_ba()
    assert lc_t.n_gba_applied == 1 and lc_t.last_gba_solver == "dense"
    assert np.abs(store_t.kf_t[:12] - store_j.kf_t[:12]).max() < 1e-2
    assert max(_angle(store_t.kf_R[k], store_j.kf_R[k]) for k in range(12)) < 1e-3
    assert np.median(np.linalg.norm(store_t.pt_pos[ids] - store_j.pt_pos[ids], axis=1)) < 1e-2
    assert np.abs(store_t.kf_t[:12] - clean_t[:12]).max() < 0.05


def test_global_ba_live_size_equals_capacity_size():
    """The global BA that LoopCloser packs at the live counts and the
    same problem padded to the map's capacity (as the JAX package pads
    it) solve to the same map."""
    from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust

    cfg, store_j, _, _ = build_drifted_map()
    tcfg = config_from_jax(cfg)
    store = map_store_from_numpy(store_j)
    lc = LoopCloser(tcfg, store, vocabulary_from_numpy(JaxVocabulary.synthesize(k=4, depth=2)), device="cpu")
    pack, live = lc._dispatch_gba(12, 0)
    n_c, n_p, n_o = len(pack["cam_ids"]), len(pack["lm_ids"]), int(pack["n_obs"])
    assert (live.R.shape[0], live.points.shape[0], live.obs_inlier.shape[0]) == (n_c, n_p, n_o) and (n_c, n_p) == (12, 1872)
    assert pack["R"].shape[0] == cfg.map.max_keyframes and pack["points"].shape[0] == cfg.map.max_points
    keys = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")
    padded = bundle_adjust(*(torch.from_numpy(pack[k]) for k in keys), tcfg.camera, tcfg.orb.scale_factor,
                           iters1=12, iters2=0, fix_first=True)
    assert np.abs(live.t - padded.t.numpy()[:n_c]).max() < 1e-4
    assert np.abs(live.points - padded.points.numpy()[:n_p]).max() < 1e-3
    assert np.array_equal(live.obs_inlier, padded.obs_inlier.numpy()[:n_o])
    assert abs(float(live.chi2) - float(padded.chi2)) < 1e-3 * float(padded.chi2) + 1e-3


def test_cg_solver_chosen_from_capacity():
    """Past 256 MB of dense coupling at the configured capacity the
    global BA runs matrix-free CG, as in the JAX package."""
    cfg, store_j, true_t, _ = build_drifted_map()
    tcfg = config_from_jax(cfg)
    big = type(tcfg.map)(**{**vars(tcfg.map), "max_keyframes": 512, "max_points": 65536})
    tcfg = type(tcfg)(**{**vars(tcfg), "map": big})
    store = map_store_from_numpy(store_j)
    lc = LoopCloser(tcfg, store, vocabulary_from_numpy(JaxVocabulary.synthesize(k=4, depth=2)), device="cpu")
    before = store.kf_t.copy()
    lc.run_global_ba()
    assert lc.last_gba_solver == "cg" and lc.n_gba_applied == 1
    assert np.isfinite(store.kf_t).all() and np.abs(store.kf_t[:12] - before[:12]).max() < 0.5


def _closer(n_lines=0):
    cfg, store_j, true_t, _ = build_drifted_map(n_lines)
    voc_j = JaxVocabulary.train(store_j.kf_desc[store_j.kf_valid].reshape(-1, 32)[:8000], k=8, depth=3)
    store = map_store_from_numpy(store_j)
    return LoopCloser(config_from_jax(cfg), store, vocabulary_from_numpy(voc_j), device="cpu"), store, true_t


def test_culled_keyframe_leaves_database_and_groups():
    lc, store, _ = _closer()
    for k in range(8):
        lc.process_keyframe(k, run_gba=False)
    assert 3 in lc.db.bow and any(3 in ids for ids in lc.db.inverted.values())
    lc.consistent_groups = [({2, 3}, 1), ({3}, 2)]
    store.erase_keyframe(3)
    assert 3 not in lc.db.bow and not any(3 in ids for ids in lc.db.inverted.values())
    assert lc.consistent_groups == [({2}, 1)]
    # a keyframe culled while its words are pending is dropped, not indexed
    assert lc._pending_bow[0] == 7
    store.erase_keyframe(7)
    assert lc._pending_bow is None and lc.flush(run_gba=False) is False and 7 not in lc.db.bow


def test_stale_loop_edge_is_ignored():
    """A loop edge whose endpoint slot was recycled (generation changed)
    must not constrain the essential graph."""
    lc, store, _ = _closer()
    wild = LoopEdge(11, 2, 1.0, np.eye(3, dtype=np.float32), np.array([5.0, 0, 0], np.float32),
                    gen_a=int(store.kf_gen[11]), gen_b=int(store.kf_gen[2]) + 1)
    lc.loop_edges.append(wild)
    before = store.kf_t.copy()
    lc._optimize_essential_graph(11, 2)
    # every remaining edge is satisfied by the current poses: nothing moves
    assert np.abs(store.kf_t - before).max() < 1e-3
    lc.loop_edges[0] = LoopEdge(11, 2, 1.0, wild.R, wild.t, gen_a=wild.gen_a, gen_b=int(store.kf_gen[2]))
    lc._optimize_essential_graph(11, 2)
    assert np.abs(store.kf_t - before).max() > 0.5      # the live edge does pull


def test_line_endpoints_move_with_the_correction():
    lc, store, true_t = _closer(n_lines=8)
    # three map lines first seen by the last keyframe, one by keyframe 2
    s_w = np.array([[0, 0, 8.0], [1, 0, 9.0], [-1, 1, 7.0], [0, 1, 6.0]], np.float32) - store.kf_t[11]
    e_w = s_w + np.array([0.5, 0.2, 0.0], np.float32)
    desc = np.zeros((4, 32), np.uint8)
    ids_cur = store.add_lines(s_w[:3], e_w[:3], desc[:3], 11, np.arange(3))
    ids_old = store.add_lines(s_w[3:], e_w[3:], desc[3:], 2, np.arange(1))
    cam_before = store.ln_start[ids_cur] @ store.kf_R[11].T + store.kf_t[11]
    old_before = store.ln_start[ids_old] @ store.kf_R[2].T + store.kf_t[2]
    closed_at = _drive(lc, store)
    assert closed_at == 11
    # the corrected keyframe still sees its lines where it saw them ...
    cam_after = store.ln_start[ids_cur] @ store.kf_R[11].T + store.kf_t[11]
    assert np.abs(cam_after - cam_before).max() < 2e-2
    # ... so in the world they moved with it, by about the drift
    moved = np.linalg.norm(store.ln_start[ids_cur] - (s_w[:3]), axis=1)
    assert moved.min() > 1.0
    assert np.linalg.norm(store.ln_end[ids_cur] - store.ln_start[ids_cur], axis=1) == pytest.approx(
        np.linalg.norm(e_w[:3] - s_w[:3], axis=1), abs=1e-3)
    # a line outside the corrected group rides its first keyframe
    # through the essential graph
    old_after = store.ln_start[ids_old] @ store.kf_R[2].T + store.kf_t[2]
    assert np.abs(old_after - old_before).max() < 1e-3


def test_async_switches_raise():
    """With the switches on, a worker's failure is raised on the calling
    thread, not swallowed: a detection job's at the next keyframe, a
    global BA solve's at poll_global_ba.  Off, nothing starts a thread."""
    lc, store, _ = _closer()
    assert lc.gba_async is False and lc.async_detect is False
    lc.process_keyframe(0)
    lc.run_global_ba()
    assert lc._worker is None and lc._gba_worker is None and lc.n_gba_applied == 1
    lc.async_detect = lc.gba_async = True

    def failing_detection(kf_id, gen, count):
        raise ValueError(f"detection of keyframe {kf_id} failed")

    lc._detect_job = failing_detection
    lc.process_keyframe(1)
    lc._worker.join()
    with pytest.raises(ValueError, match="keyframe 1"):
        lc.process_keyframe(2)

    def failing_solve(problem):
        raise ValueError("global BA solve failed")

    lc._solve_gba = failing_solve
    lc.dispatch_global_ba()
    with pytest.raises(ValueError, match="global BA"):
        lc.poll_global_ba(force=True)
    assert lc._pending_gba is None and lc.n_gba_applied == 1
    lc.stop()
    assert not lc._worker.is_alive() and not lc._gba_worker.is_alive()
