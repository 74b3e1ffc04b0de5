"""The torch port's System with loop closing on, on the CPU: a small
closed circuit from pixels (the loop closes, global BA runs, the ATE
meets the inequality of tests/test_loop_closure_e2e.py), relocalization
candidates from the keyframe database, the pose-epoch guard of the
mapping jobs, the circuit generator against the JAX package's, and both
packages' loop correction (group rewrite and fuse, essential graph,
global BA) started from the one map the port had built when its loop
closed."""

import copy
import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

import orb_line_slam_tpu.config as jax_config
from orb_line_slam_tpu.data.synthetic import loop_circuit_trajectory as jax_loop_circuit_trajectory
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics as JaxCameraIntrinsics
from orb_line_slam_tpu.loop.loop_closing import LoopCloser as JaxLoopCloser
from orb_line_slam_tpu.loop.vocabulary import Vocabulary as JaxVocabulary
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, loop_circuit_trajectory
from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser
from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore
from orb_line_slam_tpu_torch.pipeline import tracking
from orb_line_slam_tpu_torch.pipeline.system import System
from orb_line_slam_tpu_torch.pipeline.track_step import TrackOut, remap_stats

torch.set_num_threads(1)

# bench.py's loop circuit scaled down: half the image size (the same 90
# degree field of view and 0.5 m baseline), a 3 m circle, 70 frames.
CAM = CameraIntrinsics(fx=160.0, fy=160.0, cx=160.0, cy=80.0, bf=80.0, width=320, height=160)
CFG = SlamConfig(
    camera=CAM, orb=OrbConfig(n_features=400, n_levels=3), lines=LineConfig(enabled=True, n_lines=32),
    map=MapConfig(max_keyframes=48, max_points=6144, max_lines=256, local_window=8, local_points=2048),
)
N_FRAMES, RADIUS, LAPS = 70, 3.0, 1.15

# bench.py::_bench_ate's circuit itself (bench.py:251-285), for the slow case.
BENCH_CAM = CameraIntrinsics(fx=320.0, fy=320.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
BENCH_CFG = SlamConfig(
    camera=BENCH_CAM, orb=OrbConfig(n_features=1000, n_levels=4), lines=LineConfig(enabled=True, n_lines=64),
    map=MapConfig(max_keyframes=128, max_points=16384, max_lines=1024, local_window=8, local_points=4096),
)


def _scene():
    scene = SyntheticScene(CAM, n_points=500, seed=5, extent=((-9.0, 15.0), (-3.0, 3.0), (-12.0, 12.0)))
    scene.noise_sigma = 6.0
    return scene


def _gap_error(store, poses, kf_id, cand):
    """Error (m) of the closing keyframe's position seen from the loop
    keyframe's camera, against the ground truth: the drift across the loop."""
    def centre_in(Ra, ta, Rb, tb):
        return Ra @ (-Rb.T @ tb) + ta

    est = centre_in(store.kf_R[cand], store.kf_t[cand], store.kf_R[kf_id], store.kf_t[kf_id])
    (Rg, tg), (Rh, th) = poses[int(store.kf_frame_id[cand])], poses[int(store.kf_frame_id[kf_id])]
    return float(np.linalg.norm(est - centre_in(Rg, tg, Rh, th)))


class _ClosureReached(Exception):
    pass


def _run(use_loop, monkeypatch=None, cfg=CFG, scene=None, poses=None, stop_at_closure=False):
    """Drive the port's System over the circuit.  With a monkeypatch, each
    loop correction is recorded: the drift across the loop before and
    after it, and the map and accepted Sim3 it started from."""
    poses = loop_circuit_trajectory(N_FRAMES, radius=RADIUS, laps=LAPS) if poses is None else poses
    scene = _scene() if scene is None else scene
    slam = System(cfg, use_loop_closing=use_loop, async_loop=False, device="cpu")
    slam.gba_async = False
    slam.tracker.async_mapping = False
    slam.closure_gaps, slam.closure_snapshots = [], []
    if monkeypatch is not None:
        correct = LoopCloser._correct

        def recorded_correct(self, kf_id, cand, sim, run_gba=True):
            if self.pre_correct_hook is not None:
                self.pre_correct_hook()
            state = {k: v for k, v in vars(self.map).items() if k not in ("lock", "on_kf_culled", "cfg")}
            slam.closure_snapshots.append({"state": copy.deepcopy(state), "kf": int(kf_id), "cand": int(cand),
                                           "sim": (float(sim[0]), np.array(sim[1]), np.array(sim[2]))})
            if stop_at_closure:
                raise _ClosureReached
            before = _gap_error(self.map, poses, kf_id, cand)
            correct(self, kf_id, cand, sim, run_gba)
            slam.closure_gaps.append((before, _gap_error(self.map, poses, kf_id, cand)))

        monkeypatch.setattr(LoopCloser, "_correct", recorded_correct)
    try:
        for i, (R, t) in enumerate(poses):
            slam.track_stereo(*scene.render_stereo(R, t), timestamp=0.1 * i)
    except _ClosureReached:
        return None, slam
    slam.shutdown()
    est = np.stack([-R.T @ t for (_, _, R, t, _) in slam.tracker.final_trajectory()])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    return float(ate_rmse(est, gt, align=True)), slam


@pytest.fixture(scope="module")
def circuit():
    with pytest.MonkeyPatch.context() as mp:
        ate_loop, slam = _run(True, mp)
    ate_off, slam_off = _run(False)
    return ate_loop, slam, ate_off, slam_off


def test_loop_closes_from_pixels(circuit):
    ate_loop, slam, ate_off, slam_off = circuit
    assert slam.tracking_state() == "OK"
    assert slam.n_loops_closed >= 1, "no loop closed on a genuine revisit"
    assert slam_off.n_loops_closed == 0 and slam_off.loop_closer is None
    lc = slam.loop_closer
    assert lc.n_gba_applied >= 1 and lc.last_gba_solver == "dense+lines"
    assert len(lc.loop_edges) == slam.n_loops_closed
    assert all(lc.timing.cnt[k] >= 1 for k in ("detect", "sim3", "correct", "essential_graph", "gba"))
    assert slam.tracker.timing.cnt["loop_closing"] == slam.tracker.timing.cnt["kf_event_total"]
    # the vocabulary was trained on the fly (k=10, depth=4) and every
    # live keyframe is in the database after shutdown's flush
    assert slam.voc is not None and (slam.voc.k, slam.voc.depth) == (10, 4)
    live = set(np.nonzero(slam.map.kf_valid)[0].tolist())
    assert lc._pending_bow is None and live - set(lc.db.bow) <= {0, 1, 2}
    assert set(lc.db.bow) <= live


def test_closed_loop_ate(circuit):
    """tests/test_loop_closure_e2e.py's inequality: closing the loop must
    never materially hurt."""
    ate_loop, _, ate_off, _ = circuit
    assert ate_loop < max(1.25 * ate_off, ate_off + 0.02), f"{ate_loop:.3f} vs {ate_off:.3f}"
    if ate_off > 0.1:
        assert ate_loop < ate_off
    assert ate_loop < 0.35


def test_closure_reduces_the_drift_across_the_loop(circuit):
    """The correction, essential graph and global BA together bring the
    closing keyframe nearer to where the ground truth puts it relative to
    the loop keyframe: a closure that did nothing, or harm, fails here."""
    _, slam, _, _ = circuit
    assert len(slam.closure_gaps) == slam.n_loops_closed >= 1
    for before, after in slam.closure_gaps:
        assert after < before, f"drift across the loop {before:.4f} -> {after:.4f} m"


def _closure_parity(snap, cfg, poses):
    """Both packages' ``LoopCloser._correct`` from copies of one
    pre-closure map with the same accepted Sim3.  Returns, per stage, the
    largest distance between the two packages' keyframe centres and the
    median distance between their landmarks (m), and each package's
    keyframe ATE and drift across the loop."""
    jcfg = jax_config.SlamConfig(
        camera=JaxCameraIntrinsics(**cfg.camera._asdict()),
        orb=jax_config.OrbConfig(n_features=cfg.orb.n_features, n_levels=cfg.orb.n_levels),
        lines=jax_config.LineConfig(enabled=cfg.lines.enabled, n_lines=cfg.lines.n_lines),
        map=jax_config.MapConfig(**dataclasses.asdict(cfg.map)),
    )
    gt = np.stack([-R.T @ t for (R, t) in poses])
    stages = {}
    for name, store_cls, closer_cls, voc_cls, c, kw in (
            ("jax", JaxMapStore, JaxLoopCloser, JaxVocabulary, jcfg, {}),
            ("torch", MapStore, LoopCloser, Vocabulary, cfg, {"device": "cpu"})):
        store = store_cls.__new__(store_cls)
        store.__dict__.update(copy.deepcopy(snap["state"]))
        store.cfg, store.lock, store.on_kf_culled = c.map, threading.RLock(), []
        lc = closer_cls(c, store, voc_cls.synthesize(k=4, depth=2), **kw)

        def record(tag, store=store, name=name):
            ids = np.nonzero(store.kf_valid)[0]
            centres = -np.einsum("kji,kj->ki", store.kf_R[ids], store.kf_t[ids])
            stages.setdefault(tag, {})[name] = {
                "centres": centres, "points": store.pt_pos[store.pt_valid].copy(),
                "kf_ate": float(ate_rmse(centres, gt[store.kf_frame_id[ids]], align=True)),
                "gap": _gap_error(store, poses, snap["kf"], snap["cand"])}

        essential_graph = lc._optimize_essential_graph

        def recorded_graph(*a, essential_graph=essential_graph, record=record, **k):
            record("rewrite_and_fuse")
            essential_graph(*a, **k)
            record("essential_graph")

        lc._optimize_essential_graph = recorded_graph
        record("before")
        lc._correct(snap["kf"], snap["cand"], snap["sim"], run_gba=True)
        record("global_ba")
    out = {}
    for tag, both in stages.items():
        j, t = both["jax"], both["torch"]
        assert j["points"].shape == t["points"].shape, f"{tag}: the packages kept different landmarks"
        out[tag] = {"kf_m": float(np.linalg.norm(j["centres"] - t["centres"], axis=1).max()),
                    "pts_median_m": float(np.median(np.linalg.norm(j["points"] - t["points"], axis=1))),
                    "kf_ate": (j["kf_ate"], t["kf_ate"]), "gap": (j["gap"], t["gap"])}
    return out


def _check_closure_parity(par, tol_graph, tol_gba):
    """Rewrite and fuse exact, essential graph and global BA within the
    given keyframe distances; the global BA's keyframe ATEs within 5 mm
    of each other.  The global BA's tolerance is centimetres, not
    rounding: the joint point+line solve inverts nearly singular float32
    line blocks (a line seen from two views); the point-only solve of the
    same problem agrees to 1e-4 m
    (``test_point_only_global_ba_of_the_closure_matches_jax``)."""
    assert par["before"]["kf_m"] == 0.0 and par["rewrite_and_fuse"]["kf_m"] == 0.0
    assert par["rewrite_and_fuse"]["pts_median_m"] == 0.0
    assert par["essential_graph"]["kf_m"] < tol_graph
    assert par["global_ba"]["kf_m"] < tol_gba and par["global_ba"]["pts_median_m"] < tol_gba
    assert abs(par["global_ba"]["kf_ate"][0] - par["global_ba"]["kf_ate"][1]) < 5e-3
    # both packages remove the drift across the loop
    assert max(par["global_ba"]["gap"]) < 0.5 * min(par["before"]["gap"])


def test_closure_matches_jax_from_one_map(circuit):
    """The small circuit's closure: from the map the port had on entry to
    the correction, both packages end with keyframes within 1e-4 m after
    the essential graph and 6e-2 m after the global BA (twelve float32 LM
    iterations of the joint point+line solve; 4.3e-2 m measured)."""
    _, slam, _, _ = circuit
    par = _closure_parity(slam.closure_snapshots[0], CFG, loop_circuit_trajectory(N_FRAMES, radius=RADIUS, laps=LAPS))
    print("closure parity (small circuit): " + json.dumps(par))
    _check_closure_parity(par, 1e-4, 6e-2)


def test_point_only_global_ba_of_the_closure_matches_jax(circuit):
    """The closure's global BA problem without its line landmarks, the
    same arrays into both packages' dense ``bundle_adjust``: keyframes
    and landmarks within 1e-3 m after the twelve iterations (1e-4 m
    measured), where the joint point+line solve of the same map ends
    centimetres apart.  The line blocks, not the port, make the
    difference."""
    import jax.numpy as jnp

    from orb_line_slam_tpu.backend.local_ba import bundle_adjust as jax_bundle_adjust
    from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust

    _, slam, _, _ = circuit
    snap = slam.closure_snapshots[0]
    store = MapStore.__new__(MapStore)
    store.__dict__.update(copy.deepcopy(snap["state"]))
    store.cfg, store.lock, store.on_kf_culled = CFG.map, threading.RLock(), []
    lc = LoopCloser(CFG, store, Vocabulary.synthesize(k=4, depth=2), device="cpu")
    lc._correct(snap["kf"], snap["cand"], snap["sim"], run_gba=False)
    pack, _ = lc._dispatch_gba(0, 0)
    n_c, n_p, n_o = len(pack["cam_ids"]), len(pack["lm_ids"]), int(pack["n_obs"])
    cut = {"R": n_c, "t": n_c, "cam_fixed": n_c, "points": n_p, "point_valid": n_p}
    keys = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")
    args = [pack[k][: cut.get(k, n_o)] for k in keys]
    sf = CFG.orb.scale_factor
    rj = jax_bundle_adjust(*(jnp.asarray(a) for a in args), JaxCameraIntrinsics(**CAM._asdict()), sf,
                           iters1=12, iters2=0, fix_first=True)
    rt = bundle_adjust(*(torch.from_numpy(a) for a in args), CAM, sf, iters1=12, iters2=0, fix_first=True)
    d_kf = float(np.abs(rt.t.numpy() - np.asarray(rj.t)).max())
    d_pts = float(np.median(np.linalg.norm(rt.points.numpy() - np.asarray(rj.points), axis=1)))
    moved = float(np.abs(rt.t.numpy() - args[1]).max())
    print(f"point-only global BA of the closure: keyframes within {d_kf:.2e} m, landmarks {d_pts:.2e} m, moved {moved:.3f} m")
    assert moved > 0.01 and d_kf < 1e-3 and d_pts < 1e-3


@pytest.mark.slow
def test_closure_matches_jax_from_one_map_bench_circuit():
    """The same on bench.py's 170-frame circuit at its own map capacity
    (7-20 minutes and 11 GB: the JAX package pads its global BA to
    128 keyframes x 16,384 points), held to the same tolerances (1.4e-2
    and 2.4e-2 m measured after the global BA at two closures: where the
    loop closes moves with the CPU thread count).  Run with -s for the
    numbers."""
    scene = SyntheticScene(BENCH_CAM, n_points=1600, seed=5, extent=((-24, 40), (-4, 4), (-32, 32)))
    scene.noise_sigma = 6.0
    poses = loop_circuit_trajectory(170, radius=8.0, laps=1.12)
    torch.set_num_threads(4)
    try:
        with pytest.MonkeyPatch.context() as mp:
            _, slam = _run(True, mp, cfg=BENCH_CFG, scene=scene, poses=poses, stop_at_closure=True)
        assert slam.closure_snapshots, "no loop closed on the bench circuit"
        snap = slam.closure_snapshots[0]
        par = _closure_parity(snap, BENCH_CFG, poses)
    finally:
        torch.set_num_threads(1)
    print(f"closure parity (bench circuit, closing keyframe {snap['kf']} of frame "
          f"{int(snap['state']['kf_frame_id'][snap['kf']])}): " + json.dumps(par))
    _check_closure_parity(par, 1e-4, 6e-2)


def test_relocalization_candidates_come_from_the_database(circuit):
    _, slam, _, slam_off = circuit
    tr = slam.tracker
    assert tr.reloc_candidates_fn is not None and slam_off.tracker.reloc_candidates_fn is None
    scene = _scene()
    R, t = loop_circuit_trajectory(N_FRAMES, radius=RADIUS, laps=LAPS)[20]
    left, right = (torch.from_numpy(x) for x in scene.render_stereo(R, t))
    frame = tracking.build_stereo_frame(left, right, CFG)
    cands = slam._reloc_candidates(frame)
    assert len(cands) >= 1 and all(slam.map.kf_valid[k] for k in cands[:5])
    # the best candidate is a keyframe made near frame 20, not one of the newest
    fid = int(slam.map.kf_frame_id[cands[0]])
    assert abs(fid - 20) <= 6 or abs(fid - 20 - N_FRAMES / LAPS) <= 6
    seen = []
    tr.reloc_candidates_fn = lambda f: seen.append(1) or cands
    tr.frame_id += 1
    ok, _, n_inl = tr._relocalize(frame)
    assert seen and ok and n_inl >= 15
    Rgt, tgt = R.astype(np.float32), t.astype(np.float32)
    assert np.linalg.norm((-tr.R.T @ tr.t) - (-Rgt.T @ tgt)) < 0.3


def test_stale_map_job_is_discarded_after_a_correction(monkeypatch):
    """A mapping job dispatched before a loop correction (which bumps the
    map's pose epoch) is dropped when polled; one dispatched after it is
    applied."""
    calls = []
    monkeypatch.setattr(tracking, "apply_triangulation", lambda m, j: calls.append("tri") or np.zeros(0, np.int32))
    monkeypatch.setattr(tracking, "apply_fuse", lambda m, j: calls.append("fuse") or 0)
    tr = tracking.Tracker(CFG, "cpu")
    tr.async_mapping = False
    monkeypatch.setattr(tr, "_local_ba", lambda kf, defer=False: calls.append("ba"))
    scene = _scene()
    for i, (R, t) in enumerate(loop_circuit_trajectory(N_FRAMES, radius=RADIUS, laps=LAPS)[:3]):
        tr.process_stereo(*scene.render_stereo(R, t), timestamp=0.1 * i)
    assert tr.map.n_keyframes() >= 2
    kf = tr.ref_kf
    calls.clear()
    tr._map_jobs.append((kf, {"job": 1}, {"job": 1}, None, getattr(tr.map, "pose_epoch", 0)))
    tr.map.mark_all_pts_dirty()                  # what a loop correction does
    tr.poll_map_jobs()
    assert "tri" not in calls and "fuse" not in calls and not tr._map_jobs
    calls.clear()
    tr._map_jobs.append((kf, {"job": 2}, {"job": 2}, None, tr.map.pose_epoch))
    tr.poll_map_jobs()
    assert calls[:2] == ["tri", "fuse"]


def test_on_keyframe_correction_reanchors_the_tracker():
    """A hook that moves the new keyframe's pose (as a loop correction
    does) leaves the tracker riding the corrected pose with a cold
    carry; a hook that moves nothing leaves the carry alone."""
    scene = _scene()
    poses = loop_circuit_trajectory(N_FRAMES, radius=RADIUS, laps=LAPS)[:4]
    shift = np.array([0.5, 0.0, -0.25], np.float32)
    for move in (False, True):
        tr = tracking.Tracker(CFG, "cpu")
        tr.async_mapping = False
        seen = []

        def hook(kf, tr=tr, move=move, seen=seen):
            seen.append(kf)
            if move:
                tr.map.kf_t[kf] = tr.map.kf_t[kf] + shift
                tr.map.mark_all_pts_dirty()

        tr.on_keyframe = hook
        tr._local_ba = lambda kf, defer=False: None      # keep the moved pose as it is
        after = []
        for i, (R, t) in enumerate(poses):
            tr.process_stereo(*scene.render_stereo(R, t), timestamp=0.1 * i)
            after.append((tr._carry is None, tr.t.copy(), tr.last_t.copy(), tr.map.kf_t[tr.ref_kf].copy()))
        assert seen and tr.timing.cnt["loop_closing"] == len(seen)
        kf_frames = [s["frame"] for s in tr.stats if s["is_kf"]]
        assert kf_frames
        cold, t_now, t_last, t_kf = after[kf_frames[-1]]
        assert cold is move
        # the pose rides the (possibly moved) keyframe, and so does the anchor of the next track step
        assert np.array_equal(t_now, t_kf) and np.array_equal(t_last, t_kf)


def test_remap_stats_restarts_line_carries_on_a_capacity_switch():
    """The line accumulators of a track step run at 32 line rows, remapped
    after the mirror fell back to 8 rows (every map line culled), restart
    at zero at the new size; the point accumulators are re-indexed."""
    z = torch.zeros(())
    out = TrackOut(R=z, t=z, Rv=z, tv=z, ok=z, assoc_gid=z, inliers=z,
                   found_acc=torch.tensor([5, 6, 7, 8], dtype=torch.int32), vis_acc=torch.tensor([1, 2, 3, 4], dtype=torch.int32),
                   n_inliers=z, used_motion=z, stage1_ok=z, n_stage1=z, tracked_close=z, untracked_close=z,
                   n_line_inliers=z, ln_found_acc=torch.arange(32, dtype=torch.int32),
                   ln_vis_acc=torch.arange(32, dtype=torch.int32), ln_match_idx=z, ln_match_mask=z)
    remap = torch.tensor([2, -1, 0, 3], dtype=torch.int32)
    got = remap_stats(out, remap, torch.full((8,), -1, dtype=torch.int32))
    assert got.found_acc.tolist() == [7, 0, 5, 8] and got.vis_acc.tolist() == [3, 0, 1, 4]
    assert got.ln_found_acc.shape == (8,) and not got.ln_found_acc.any() and not got.ln_vis_acc.any()
    same = remap_stats(out, remap, torch.arange(31, -1, -1, dtype=torch.int32))
    assert same.ln_found_acc.tolist() == list(range(31, -1, -1))


def test_loop_circuit_trajectory_matches_jax():
    for n, radius, laps in ((170, 8.0, 1.12), (70, 3.0, 1.15), (5, 10.0, 1.08)):
        a = loop_circuit_trajectory(n, radius=radius, laps=laps)
        b = jax_loop_circuit_trajectory(n, radius=radius, laps=laps)
        assert len(a) == len(b) == n
        for (Ra, ta), (Rb, tb) in zip(a, b):
            assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)
