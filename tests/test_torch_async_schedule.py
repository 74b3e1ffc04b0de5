"""The deferred local-mapping schedule (``async_mapping``, the JAX
System's default) of the port's Tracker against the JAX package's, on
the CPU, on the same frames.

The schedule is made deterministic on both sides.  The JAX tracker's
polls are throttled by ``time.monotonic``: its module's clock is
replaced by one that advances one second per frame, so the throttles
never hold a poll back, and between frames the test waits for the JAX
package's outstanding device work (the mapping chains' and the deferred
BA's result buffers), with pipeline depth 0.  The port's mapping worker
is replaced by one that runs its jobs between frames (or when a result
is waited for), so a deferred BA is never found finished in the frame
that dispatched it, as the JAX package's throttle also ensures.  Then
both take the same keyframes, apply, skip and discard the same local
BAs, and track the same poses.

Also held to the JAX package on the same state: the guards of the
deferred BA (re-anchoring at ``flush_pending_ba``, the pose-epoch
discard, the mbAbortBA skip limit, and ``_need_keyframe``'s
mapping-idle gate), and the localization mode."""

import time
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.backend.local_ba import BAResult as JaxBAResult
from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.pipeline import tracking as jax_tracking
from orb_line_slam_tpu.pipeline.system import System as JaxSystem
from orb_line_slam_tpu_torch.backend.local_ba import BAResult
from orb_line_slam_tpu_torch.convert import config_from_jax, map_store_from_numpy
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory
from orb_line_slam_tpu_torch.pipeline import tracking
from orb_line_slam_tpu_torch.pipeline.system import System
from tests.test_torch_loop_closer import build_drifted_map

torch.set_num_threads(1)

CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
# tests/test_torch_system.py's point configuration and its 20 frames; the
# last LOCALIZE frames run in localization mode.
POINT_CFG = SlamConfig(
    camera=CAM, orb=OrbConfig(n_features=768, n_levels=4), lines=LineConfig(enabled=False),
    map=MapConfig(max_keyframes=96, max_points=16384, max_lines=64, local_window=8, local_points=2048),
)
POINT_FRAMES, LOCALIZE = 20, 6
# tests/test_torch_system_lines.py's configuration and its 12 frames.
LINE_CFG = SlamConfig(
    camera=CAM, orb=OrbConfig(n_features=768, n_levels=4), lines=LineConfig(enabled=True, n_lines=64),
    map=MapConfig(max_keyframes=64, max_points=8192, max_lines=512, local_window=8, local_points=2048),
)
LINE_FRAMES = 12
# Poses: tests/test_tpu_parity.py's contract.  With lines, per-frame
# camera centres are held within 2 cm, the bound of the pinned schedule's
# tests/test_torch_system_lines.py: there the two packages' joint
# point+line BAs end up to 1.2 cm apart on either schedule (float32 line
# blocks, ROADMAP Queue 3).
ROT_TOL, POS_TOL, INLIER_TOL, LINE_POS_TOL = 1e-3, 5e-3, 3, 2e-2


class _FrameClock:
    """Stands in for the JAX tracking module's ``time``: the monotonic
    clock advances only when the test says a frame has passed."""

    perf_counter = staticmethod(time.perf_counter)

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


class _StepFuture(Future):
    def __init__(self, worker):
        super().__init__()
        self._worker = worker

    def result(self, timeout=None):
        self._worker.run_all()
        return super().result(timeout)


class _SteppedWorker:
    """Stands in for utils.worker.Worker: jobs run in order when the
    test steps the worker between frames, or when a result is waited
    for."""

    def __init__(self, name, device):
        self.name, self.busy_s, self._queue, self._alive = name, 0.0, [], True

    def submit(self, fn, *args):
        fut = _StepFuture(self)
        self._queue.append((fut, fn, args))
        return fut

    def run_all(self):
        while self._queue:
            fut, fn, args = self._queue.pop(0)
            fut.set_running_or_notify_cancel()
            try:
                fut.set_result(fn(*args))
            except Exception as exc:
                fut.set_exception(exc)

    def is_alive(self):
        return self._alive

    def stop(self):
        self.run_all()
        self._alive = False


def _wait_jax(tr):
    """Block until the JAX tracker's outstanding mapping work is done."""
    for _kf, tri_job, fuse_job, *_ in tr._map_jobs:
        for job in (tri_job, fuse_job):
            if job is not None:
                jax.block_until_ready(job["packed"])
    if tr._pending_ba is not None:
        jax.block_until_ready(tr._pending_ba[2][0])


def _count_jax_ba(tr):
    """Count the JAX tracker's local-BA dispatches, applications and
    mbAbortBA skips."""
    counts = {"dispatched": 0, "applied": 0, "skipped": 0}

    class Counting(type(tr)):
        @property
        def _ba_skips(self):
            return self.__dict__.get("_skips_now", 0)

        @_ba_skips.setter
        def _ba_skips(self, v):
            if v > self.__dict__.get("_skips_now", 0):
                counts["skipped"] += 1
            self.__dict__["_skips_now"] = v

    tr.__class__ = Counting
    for name in ("_local_ba", "_apply_ba"):
        orig = getattr(tr, name)

        def counted(*a, _orig=orig, _key={"_local_ba": "dispatched", "_apply_ba": "applied"}[name], **k):
            counts[_key] += 1
            return _orig(*a, **k)

        setattr(tr, name, counted)
    return counts


def _rot_err(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    w = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.arcsin(min(np.linalg.norm(w) / 2, 1.0)))


def _run_both(cfg, frames, localize_from=None):
    """Both Systems (loop closing off, the default deferred mapping) over
    the frames on the deterministic schedule.  Returns per-frame records
    of each and the JAX BA counts."""
    mp = pytest.MonkeyPatch()
    clock = _FrameClock()
    mp.setattr(jax_tracking, "time", clock)
    mp.setattr(tracking, "Worker", _SteppedWorker)
    try:
        jsys = JaxSystem(cfg, use_loop_closing=False)
        jsys.tracker.pipeline_depth = 0
        tsys = System(config_from_jax(cfg), use_loop_closing=False, device="cpu")
        assert jsys.tracker.async_mapping and tsys.tracker.async_mapping
        jcounts = _count_jax_ba(jsys.tracker)
        rec = {"jax": [], "torch": []}
        for i, (left, right) in enumerate(frames):
            if i == localize_from:
                jsys.activate_localization_mode()
                tsys.activate_localization_mode()
            for name, sysm in (("jax", jsys), ("torch", tsys)):
                sysm.track_stereo(left, right, timestamp=0.1 * i)
                tr = sysm.tracker
                rec[name].append({
                    "R": tr.R.copy(), "t": tr.t.copy(), "n_kf": int(sysm.map.n_keyframes()),
                    "jobs": len(tr._map_jobs), "pending_ba": tr._pending_ba is not None,
                    "inliers": tr.stats[-1]["inliers"] if tr.stats else 0,
                    "is_kf": tr.stats[-1]["is_kf"] if tr.stats else True,
                })
            clock.now += 1.0
            _wait_jax(jsys.tracker)
            if tsys.tracker._mapping_worker is not None:
                tsys.tracker._mapping_worker.run_all()
        jsys.shutdown()
        tsys.shutdown()
    finally:
        mp.undo()
    return rec, jcounts, jsys, tsys


def _check_parity(rec, jcounts, tsys, pos_tol=POS_TOL):
    j, t = rec["jax"], rec["torch"]
    assert [r["is_kf"] for r in t] == [r["is_kf"] for r in j]
    assert [r["n_kf"] for r in t] == [r["n_kf"] for r in j]
    assert [(r["jobs"], r["pending_ba"]) for r in t] == [(r["jobs"], r["pending_ba"]) for r in j]
    for i, (a, b) in enumerate(zip(j, t)):
        ca, cb = -a["R"].T @ a["t"], -b["R"].T @ b["t"]
        assert _rot_err(a["R"], b["R"]) < ROT_TOL and np.linalg.norm(ca - cb) < pos_tol, i
        assert abs(a["inliers"] - b["inliers"]) <= INLIER_TOL, i
    tr = tsys.tracker
    assert (tr.n_local_ba, tr.n_ba_skipped, tr.n_local_ba + tr.n_ba_stale) == (
        jcounts["applied"], jcounts["skipped"], jcounts["dispatched"])


@pytest.fixture(scope="module")
def point_run():
    scene = SyntheticScene(config_from_jax(POINT_CFG).camera, n_points=700, seed=21,
                           extent=((-14, 14), (-6, 6), (8, 60)))
    frames = [scene.render_stereo(R, t) for R, t in circular_trajectory(POINT_FRAMES, step=0.3)]
    return _run_both(POINT_CFG, frames, localize_from=POINT_FRAMES - LOCALIZE)


def test_async_mapping_matches_jax_on_the_point_sequence(point_run):
    """Same keyframes, mapping chains and deferred BAs frame by frame,
    the same counts of local BAs applied, skipped and discarded, poses
    within 1e-3 rad and 5e-3 m and inliers within 3; at least one
    deferred BA was applied, so the schedule was exercised."""
    rec, jcounts, _, tsys = point_run
    _check_parity(rec, jcounts, tsys)
    assert tsys.tracker.n_local_ba >= 1 and any(r["pending_ba"] for r in rec["torch"])


def test_localization_mode_matches_jax(point_run):
    """After activate_localization_mode neither package makes a
    keyframe or a mapping chain, and they track the same poses."""
    rec, _, jsys, tsys = point_run
    first = POINT_FRAMES - LOCALIZE
    for name in ("jax", "torch"):
        after = rec[name][first:]
        assert {r["n_kf"] for r in after} == {rec[name][first - 1]["n_kf"]}
        assert not any(r["jobs"] or r["is_kf"] for r in after)
    assert jsys.tracker.localization_only and tsys.tracker.localization_only
    assert tsys.tracking_state() == jsys.tracking_state() == "OK"
    tsys.deactivate_localization_mode()
    assert not tsys.tracker.localization_only and not tsys.localization_only


def test_async_mapping_matches_jax_with_lines():
    """The same on the point+line sequence (joint point+line BAs), camera
    centres within 2 cm."""
    scene = SyntheticScene(config_from_jax(LINE_CFG).camera, n_points=500, n_lines=40, seed=9,
                           extent=((-14, 14), (-6, 6), (6, 60)))
    frames = [scene.render_stereo(R, t) for R, t in circular_trajectory(LINE_FRAMES, step=0.3)]
    rec, jcounts, _, tsys = _run_both(LINE_CFG, frames)
    _check_parity(rec, jcounts, tsys, pos_tol=LINE_POS_TOL)
    assert len(tsys.tracker.joint_ba_lobs) >= 1


def test_deferred_mapping_lands_at_the_same_frames_however_slow_the_worker():
    """The port's deferred schedule does not depend on the mapping
    worker's speed: with a worker that finishes each job before the next
    frame and one that runs a job only when its result is waited for, the
    System takes the same keyframes and tracks the same poses bit for
    bit, and each deferred BA lands one frame after its pack (the last
    in its own frame, joined by the shutdown)."""
    scene = SyntheticScene(config_from_jax(POINT_CFG).camera, n_points=700, seed=21,
                           extent=((-14, 14), (-6, 6), (8, 60)))
    frames = [scene.render_stereo(R, t) for R, t in circular_trajectory(POINT_FRAMES, step=0.3)]
    runs = {}
    for eager in (True, False):
        mp = pytest.MonkeyPatch()
        mp.setattr(tracking, "Worker", _SteppedWorker)
        try:
            tsys = System(config_from_jax(POINT_CFG), use_loop_closing=False, device="cpu")
            tr = tsys.tracker
            per_frame = []
            for i, (left, right) in enumerate(frames):
                tsys.track_stereo(left, right, timestamp=0.1 * i)
                per_frame.append((tr.R.copy(), tr.t.copy(), int(tsys.map.n_keyframes()), tr._pending_ba is not None))
                if eager and tr._mapping_worker is not None:
                    tr._mapping_worker.run_all()
            tsys.shutdown()
        finally:
            mp.undo()
        runs[eager] = (per_frame, list(tr.ba_lag_frames), tr.n_local_ba)
    (fast, fast_lags, fast_n), (slow, slow_lags, slow_n) = runs[True], runs[False]
    assert fast_n == slow_n >= 3 and fast_lags == slow_lags and set(fast_lags[:-1]) == {1}
    assert [f[2:] for f in fast] == [f[2:] for f in slow]
    assert all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]) for a, b in zip(fast, slow))


# ----------------------------------------------------------------------
# the guards, on one state given to both packages
# ----------------------------------------------------------------------
def _trackers():
    """A JAX and a port Tracker over copies of one drifted 12-keyframe map
    (tests/test_torch_loop_closer.py's fixture), tracking OK off keyframe
    11 with a current pose near it."""
    cfg, store_j, _, _ = build_drifted_map()
    jtr = jax_tracking.Tracker(cfg)
    ttr = tracking.Tracker(config_from_jax(cfg), "cpu")
    jtr.map, ttr.map = store_j, map_store_from_numpy(store_j)
    rng = np.random.default_rng(4)
    R = (_small_rotation(rng, 0.05) @ store_j.kf_R[11]).astype(np.float32)
    t = (store_j.kf_t[11] + np.array([0.05, -0.02, -0.3], np.float32)).astype(np.float32)
    for tr in (jtr, ttr):
        tr.state, tr.ref_kf = "OK", 11
        tr.R, tr.t = R.copy(), t.copy()
        tr.last_R = R.copy()
        tr.last_t = (t + np.array([0.0, 0.0, 0.1], np.float32)).astype(np.float32)
    return jtr, ttr, rng


def _defer_same_ba(jtr, ttr, rng):
    """The same local-BA result pending in both trackers: the window
    around keyframe 11 with its free poses and landmarks moved."""
    pack_j = jtr.map.pack_local_ba(11, max_cams=24, max_points=2048, max_obs=24 * 512)
    pack_t = ttr.map.pack_local_ba(11, max_cams=24, max_points=2048, max_obs=24 * 512)
    C, P, O = pack_j["R"].shape[0], pack_j["points"].shape[0], pack_j["obs_cam"].shape[0]
    Rn = np.einsum("ij,cjk->cik", _small_rotation(rng), pack_j["R"]).astype(np.float32)
    tn = (pack_j["t"] + rng.normal(0, 0.05, (C, 3))).astype(np.float32)
    pn = (pack_j["points"] + rng.normal(0, 0.02, (P, 3))).astype(np.float32)
    inl = np.ones(O, bool)
    res_t = BAResult(R=Rn, t=tn, points=pn, obs_inlier=inl, chi2=np.float32(1.0))
    res_j = JaxBAResult(R=jnp.asarray(Rn), t=jnp.asarray(tn), points=jnp.asarray(pn),
                        obs_inlier=jnp.asarray(inl), chi2=jnp.float32(1.0))
    for pack, tr in ((pack_j, jtr), (pack_t, ttr)):
        pack["pose_epoch"] = getattr(tr.map, "pose_epoch", 0)
    pack_t["frame_id"] = ttr.frame_id
    jtr._pending_ba = (pack_j, None, jax_tracking._pack_for_fetch(res_j), 11)
    jtr._pending_ba_t = 0.0
    fut = Future()
    fut.set_result((res_t, "local_ba", 0.0))
    ttr._pending_ba = (pack_t, None, fut, 11)


def _small_rotation(rng, sigma=0.01):
    w = rng.normal(0, sigma, 3)
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def test_flush_pending_ba_reanchors_like_jax():
    """Applying the same deferred BA: the same map, and the current and
    last poses re-anchored by the reference keyframe's BA delta, within
    float32 rounding."""
    jtr, ttr, rng = _trackers()
    before = ttr.t.copy()
    _defer_same_ba(jtr, ttr, rng)
    jtr.flush_pending_ba()
    ttr.flush_pending_ba()
    assert jtr._pending_ba is None and ttr._pending_ba is None and ttr.n_local_ba == 1
    assert np.abs(ttr.map.kf_t - jtr.map.kf_t).max() < 1e-6
    assert np.abs(ttr.map.pt_pos - jtr.map.pt_pos).max() < 1e-6
    for name in ("R", "t", "last_R", "last_t"):
        assert np.abs(getattr(ttr, name) - getattr(jtr, name)).max() < 1e-5, name
    assert np.abs(ttr.t - before).max() > 1e-3       # the pose moved with its keyframe


def test_pose_epoch_change_discards_the_deferred_ba():
    """A loop correction (pose-epoch bump) between pack and apply: both
    packages drop the solve and leave map and pose as they were."""
    jtr, ttr, rng = _trackers()
    _defer_same_ba(jtr, ttr, rng)
    kf_t, R, t = ttr.map.kf_t.copy(), ttr.R.copy(), ttr.t.copy()
    for tr in (jtr, ttr):
        tr.map.mark_all_pts_dirty()
        tr.flush_pending_ba()
        assert tr._pending_ba is None
        assert np.array_equal(tr.map.kf_t, kf_t) and np.array_equal(tr.R, R) and np.array_equal(tr.t, t)
    assert (ttr.n_local_ba, ttr.n_ba_stale) == (0, 1)


def test_ba_skip_limit_matches_jax():
    """Four mapping chains joined at once (a forced poll): with a newer
    chain queued, a keyframe's BA is skipped, never twice in a row, and
    the last chain's BA runs; the pinned schedule never skips."""
    seqs = {}
    for async_mapping in (True, False):
        jtr, ttr, _ = _trackers()
        for name, tr in (("jax", jtr), ("torch", ttr)):
            tr.async_mapping = async_mapping
            seq = seqs.setdefault((name, async_mapping), [])
            tr._local_ba = lambda kf, defer=False, seq=seq: seq.append(("ba", int(kf), defer))
            for kf in (8, 9, 10, 11):
                epoch = getattr(tr.map, "pose_epoch", 0)
                tr._map_jobs.append((kf, None, None, 0.0, epoch) if name == "jax" else (kf, None, None, epoch))
            tr.poll_map_jobs(**({"force": True} if name == "jax" else {}))
            assert not tr._map_jobs
        assert ttr.n_ba_skipped == (2 if async_mapping else 0)
    assert seqs[("torch", True)] == seqs[("jax", True)] == [("ba", 9, True), ("ba", 11, True)]
    assert seqs[("torch", False)] == seqs[("jax", False)] == [("ba", k, False) for k in (8, 9, 10, 11)]


def test_mapping_is_not_idle_while_a_ba_is_pending():
    """_need_keyframe's c1b ("LocalMapping idle") is off while a
    deferred BA is pending or a chain is queued, in both packages."""
    jtr, ttr, rng = _trackers()
    got = {}
    for name, tr in (("jax", jtr), ("torch", ttr)):
        tr.ref_kf_matches = 200
        tr.frames_since_kf = max(tr.cfg.tracking.min_frames_between_kf, 1)
        idle = tr._need_keyframe(120, 200, 0)           # c1b and c2 hold, c1a and c1c do not
        tr._pending_ba = ("pending",)
        busy_ba = tr._need_keyframe(120, 200, 0)
        tr._pending_ba = None
        tr._map_jobs.append(("chain",))
        busy_job = tr._need_keyframe(120, 200, 0)
        tr._map_jobs.clear()
        got[name] = (idle, busy_ba, busy_job)
    assert got["torch"] == got["jax"] == (True, False, False)
