"""Batched multi-sequence tracking (BASELINE config #4) in the torch port
on the CPU: MultiSequenceTracker against the port's and the JAX
package's single Tracker on tests/test_multi_sequence.py's two sequences,
one batched_frame_track step against both packages' per-sequence
track_step on the same stacked inputs, full SLAM on two circuits (one
run backwards) with a loop closing, and (slow) the JAX package's own
MultiSequenceTracker.  Frames come from one renderer (the port's) for
both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.frontend.frame import build_stereo_frame as jax_build_stereo_frame
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.geometry.host import nbackproject
from orb_line_slam_tpu.pipeline.track_step import MapMirror as JaxMapMirror, track_step as jax_track_step
from orb_line_slam_tpu.pipeline.tracking import Tracker as JaxTracker
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.config import (
    CameraIntrinsics as TCameraIntrinsics, LineConfig as TLineConfig, MapConfig as TMapConfig,
    OrbConfig as TOrbConfig, SlamConfig as TSlamConfig,
)
from orb_line_slam_tpu_torch.convert import config_from_jax, frame_from_numpy, track_out_from_numpy
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene, circular_trajectory, loop_circuit_trajectory
from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
from orb_line_slam_tpu_torch.parallel.multi_sequence import MultiSequenceTracker, _take
from orb_line_slam_tpu_torch.pipeline.system import System
from orb_line_slam_tpu_torch.pipeline.track_step import MapMirror, batched_frame_track, track_step
from orb_line_slam_tpu_torch.pipeline.tracking import Tracker

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)

# tests/test_multi_sequence.py:18-39's configuration and sequences.
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
CFG = SlamConfig(
    camera=CAM, orb=OrbConfig(n_features=512, n_levels=4), lines=LineConfig(enabled=False),
    map=MapConfig(max_keyframes=64, max_points=8192, local_window=8, local_points=2048),
)
TCFG = config_from_jax(CFG)
N_FRAMES = 16
SEEDS = (3, 9)


def _sequences():
    poses = circular_trajectory(N_FRAMES, step=0.3)
    out = []
    for seed in SEEDS:
        scene = SyntheticScene(TCFG.camera, n_points=500, seed=seed, extent=((-14, 14), (-6, 6), (6, 60)))
        out.append([scene.render_stereo(R, t) for R, t in poses])
    return out, poses


@pytest.fixture(scope="module")
def sequences():
    return _sequences()


def _rot_angle(Ra, Rb):
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    w = np.array([d[2, 1] - d[1, 2], d[0, 2] - d[2, 0], d[1, 0] - d[0, 1]])
    return float(np.arcsin(np.clip(np.linalg.norm(w) / 2, 0, 1)))


def _pose_gaps(traj_a, traj_b):
    """Largest rotation (rad) and translation (m) difference per frame of
    two final trajectories."""
    assert len(traj_a) == len(traj_b)
    d_rot = max(_rot_angle(a[2], b[2]) for a, b in zip(traj_a, traj_b))
    d_t = max(float(np.abs(np.asarray(a[3]) - np.asarray(b[3])).max()) for a, b in zip(traj_a, traj_b))
    return d_rot, d_t


def _run_batched(seqs, host_threads=False):
    mst = MultiSequenceTracker(TCFG, len(seqs), full_slam=False, host_threads=host_threads, device="cpu")
    for t in mst.trackers:
        t.async_mapping = False
    n_ready = 0
    for i in range(N_FRAMES):
        n_ready += mst._ready()
        mst.process_stereo([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * len(seqs))
    mst.shutdown()
    assert n_ready == mst.n_batched_frames and mst.n_mixed_line_frames == 0
    return mst


def test_batched_tracker_matches_single_trackers_of_both_packages(sequences):
    """MultiSequenceTracker(full_slam=False, host_threads=False), pinned:
    at least 8 of the 16 frames run batched; each sequence's per-frame
    poses equal the port's single Tracker on the same frames within 1e-4
    rad and 1e-4 m (measured: 1e-5 rad, 4e-5 m), and the JAX package's
    single Tracker within the pose contract (1e-3 rad, 5e-3 m, inliers
    within 3 on every frame)."""
    seqs, poses = sequences
    mst = _run_batched(seqs)
    assert mst.n_batched_frames >= 8, mst.n_batched_frames
    for b, frames in enumerate(seqs):
        ref = Tracker(TCFG, "cpu")
        ref.async_mapping = False
        jref = JaxTracker(CFG)
        jref.async_mapping = False
        jref.pipeline_depth = 0
        for i, (left, right) in enumerate(frames):
            ref.process_stereo(left, right, 0.1 * i)
            jref.process_stereo(left, right, timestamp=0.1 * i)
        ref.flush()
        jref.flush()
        got = mst.trackers[b]
        assert got.state == ref.state == jref.state == "OK"
        d_rot, d_t = _pose_gaps(got.final_trajectory(), ref.final_trajectory())
        assert d_rot <= 1e-4 and d_t <= 1e-4, (b, d_rot, d_t)
        d_rot, d_t = _pose_gaps(got.final_trajectory(), jref.final_trajectory())
        assert d_rot <= 1e-3 and d_t <= 5e-3, (b, d_rot, d_t)
        inl, jinl = [s["inliers"] for s in got.stats], [s["inliers"] for s in jref.stats]
        assert len(inl) == len(jinl) and max(abs(a - c) for a, c in zip(inl, jinl)) <= 3, (inl, jinl)
        gt = np.stack([-R.T @ t for R, t in poses])
        est = np.stack([-R.T @ t for (_, _, R, t, _) in got.final_trajectory()])
        assert np.linalg.norm(est - gt, axis=1).max() < 0.2


def _stacked_step_inputs(seqs):
    """Per sequence: the JAX frame of pair 0, a stereo-initialised JAX map
    on it, and the cold-start inputs; returned for both packages."""
    cap = CFG.map.local_points
    jax_side, per_seq = [], []
    for frames in seqs:
        f0 = jax.device_get(jax_build_stereo_frame(jnp.asarray(frames[0][0]), jnp.asarray(frames[0][1]), CFG))
        store = JaxMapStore(CFG.map, CFG.orb.n_features)
        kf = store.add_keyframe(f0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0, 0.0)
        idx = np.nonzero(f0.valid & (f0.depth > 0))[0]
        ids = store.add_points(nbackproject(CAM, f0.xy, f0.depth)[idx], f0.desc[idx], f0.octave[idx], kf, idx)
        snap = np.full(cap, -1, np.int32)
        snap[: len(ids)] = ids
        fields = (store.pt_pos, store.pt_desc, store.pt_oct, store.pt_valid, store.pt_max_dist, store.pt_min_dist,
                  store.pt_normal)
        ref = (f0.xy, f0.desc, f0.angle, store.kf_obs_lm[kf].astype(np.int32))
        jax_side.append((f0, fields, ref, snap))
        per_seq.append((f0._asdict(), fields, ref, snap))
    stack = lambda xs: np.stack([np.asarray(x) for x in xs])  # noqa: E731
    last = frame_from_numpy({k: stack([p[0][k] for p in per_seq]) for k in per_seq[0][0]}, "cpu")
    mir = MapMirror(*(T(stack(f)) for f in zip(*(p[1] for p in per_seq))))
    ref = tuple(T(stack(r)) for r in zip(*(p[2] for p in per_seq)))
    snap = T(stack([p[3] for p in per_seq]))
    return jax_side, last, mir, ref, snap


def test_batched_frame_track_matches_both_packages_track_step(sequences):
    """Two steps of batched_frame_track on two sequences (a cold start,
    then the motion model), the second carrying the JAX step's own
    first outputs (convert.track_out_from_numpy with a leading [B]): each
    sequence's TrackOut equals the port's unbatched track_step on the same
    tensors (poses within 1e-4, measured 2e-5: vmap sums in another
    order; assoc_gid on >= 99.9% of rows), and the
    JAX package's track_step on the same frames and map within the pose
    contract (1e-3 rad, 5e-3 m, assoc_gid on >= 99% of rows, inliers
    within 3)."""
    seqs, _ = sequences
    B, n, cap = len(seqs), CFG.orb.n_features, CFG.map.local_points
    jax_side, last, mir, ref, snap = _stacked_step_inputs(seqs)
    dummy = (np.zeros((B, 8, 3), np.float32), np.ones((B, 8, 3), np.float32), np.zeros((B, 8, 32), np.uint8),
             np.zeros((B, 8), bool))
    jcarry = [(jnp.full(n, -1, jnp.int32), jnp.eye(3), jnp.zeros(3), jnp.eye(3), jnp.zeros(3), jnp.asarray(False),
               jnp.zeros(cap, jnp.int32), jnp.zeros(cap, jnp.int32)) for _ in range(B)]
    jlast = [js[0] for js in jax_side]
    tcarry = (T(np.full((B, n), -1, np.int32)), T(np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))),
              T(np.zeros((B, 3), np.float32)), T(np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))),
              T(np.zeros((B, 3), np.float32)), T(np.zeros(B, bool)), T(np.zeros((B, cap), np.int32)),
              T(np.zeros((B, cap), np.int32)))
    for step in (1, 2):
        left = T(np.stack([s[step][0] for s in seqs]))
        right = T(np.stack([s[step][1] for s in seqs]))
        g, Rv, tv, R, t, ok, found, vis = tcarry
        stacked = (last, mir, g, Rv, tv, R, t, ok, *ref, snap, found, vis,
                   T(np.zeros((B, 8), np.int32)), T(np.zeros((B, 8), np.int32)), *(T(a) for a in dummy))
        frames, lfs, outs = batched_frame_track(left, right, stacked, TCFG, has_lines=False)
        assert lfs is None and outs.R.shape == (B, 3, 3) and frames.xy.shape == (B, n, 2)
        jouts = []
        for b in range(B):
            rest = stacked[2:]
            want = track_step(_take(frames, b), _take(last, b), _take(mir, b), *(x[b] for x in rest[:15]), None,
                              *(x[b] for x in rest[15:]), cfg=TCFG, has_lines=False)
            got = _take(outs, b)
            assert bool(got.ok) and int(got.n_inliers) > 50
            assert float((got.R - want.R).abs().max()) <= 1e-4 and float((got.t - want.t).abs().max()) <= 1e-4
            assert float((got.assoc_gid == want.assoc_gid).float().mean()) >= 0.999
            frame_np = type(jlast[b])(**{k: v.numpy() for k, v in _take(frames, b)._asdict().items()})
            fs, rf, sn = jax_side[b][1], jax_side[b][2], jax_side[b][3]
            jg, jRv, jtv, jR, jt, jok, jfound, jvis = jcarry[b]
            oj = jax_track_step(
                frame_np, jlast[b], JaxMapMirror(*(jnp.asarray(a) for a in fs)), jg, jRv, jtv, jR, jt, jok,
                *(jnp.asarray(a) for a in rf), jnp.asarray(sn), jfound, jvis, jnp.zeros(8, jnp.int32),
                jnp.zeros(8, jnp.int32), None, *(jnp.asarray(a[b]) for a in dummy), cfg=CFG, has_lines=False)
            oj = jax.device_get(oj)
            assert _rot_angle(got.R.numpy(), oj.R) <= 1e-3 and np.abs(got.t.numpy() - oj.t).max() <= 5e-3
            assert (got.assoc_gid.numpy() == oj.assoc_gid).mean() >= 0.99
            assert abs(int(got.n_inliers) - int(oj.packed[13])) <= 3
            jouts.append(oj)
            jcarry[b] = (oj.assoc_gid, oj.Rv, oj.tv, oj.R, oj.t, oj.ok, oj.found_acc, oj.vis_acc)
            jlast[b] = frame_np
        # The next step carries the JAX step's outputs, batched and converted.
        jb = track_out_from_numpy({k: np.stack([np.asarray(getattr(o, k)) for o in jouts])
                                   for k in jouts[0]._fields}, "cpu")
        assert jb.n_inliers.shape == (B,) and jb.assoc_gid.shape == (B, n)
        np.testing.assert_array_equal(jb.n_inliers.numpy(), [int(o.packed[13]) for o in jouts])
        tcarry = (jb.assoc_gid, jb.Rv, jb.tv, jb.R, jb.t, jb.ok, jb.found_acc, jb.vis_acc)
        last = frames


def test_forward_mode_derivatives_from_many_threads():
    """B sequences' loop workers refine Sim3s and the consume pool corrects
    loops side by side, and torch's forward-mode AD levels are
    process-wide: the package's jacfwd sites (the Sim3 refinement's and
    the pose graph's Jacobians) hold one lock, so 12 threads calling them
    10 times each, with a short switch interval, get exactly the
    single-thread results (without the lock most calls raise)."""
    import sys
    import threading

    from orb_line_slam_tpu_torch.backend.pose_graph import edge_residuals_and_jacobians
    from orb_line_slam_tpu_torch.backend.sim3_opt import sim3_residual_jacobian
    from orb_line_slam_tpu_torch.geometry.sim3 import sim3_exp

    rng = np.random.default_rng(11)
    K, n = 6, 40
    s, R, t = sim3_exp(T(rng.normal(0, 0.2, (K, 7)).astype(np.float32)))
    ei, ej = T(np.arange(K - 1)), T(np.arange(1, K))
    es, eR, et = sim3_exp(T(rng.normal(0, 0.2, (K - 1, 7)).astype(np.float32)))
    pts = T(rng.uniform([-2, -2, 4], [2, 2, 9], (n, 3)).astype(np.float32))
    obs = T(rng.uniform(0, 300, (n, 2)).astype(np.float32))
    cam = TCFG.camera

    def jobs():
        return (edge_residuals_and_jacobians(s, R, t, ei, ej, es, eR, et),
                sim3_residual_jacobian(s[1], R[1], t[1], pts, pts + 0.1, obs, obs + 1.0, cam, cam))

    want = jobs()
    errors = []

    def run():
        try:
            for _ in range(10):
                got = jobs()
                for a, b in zip([*want[0], *want[1]], [*got[0], *got[1]]):
                    assert torch.equal(a, b)
        except Exception as e:  # recorded for the main thread's assert
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run) for _ in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors[:2]


# tests/test_torch_loop_system.py's circuit: bench.py's loop scaled to
# 320x160, a 3 m circle, 70 frames.
LOOP_CAM = TCameraIntrinsics(fx=160.0, fy=160.0, cx=160.0, cy=80.0, bf=80.0, width=320, height=160)
LOOP_CFG = TSlamConfig(
    camera=LOOP_CAM, orb=TOrbConfig(n_features=400, n_levels=3), lines=TLineConfig(enabled=True, n_lines=32),
    map=TMapConfig(max_keyframes=48, max_points=6144, max_lines=256, local_window=8, local_points=2048),
)


def _pin(slam):
    slam.async_loop = False
    slam.gba_async = False
    slam.tracker.async_mapping = False


def _ate(tracker, poses):
    est = np.stack([-R.T @ t for (_, _, R, t, _) in tracker.final_trajectory()])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    return float(ate_rmse(est, gt, align=True))


def test_batched_full_slam_on_the_pool(sequences):
    """full_slam=True on the two sequences: a System per sequence (its
    vocabulary trained on the fly, its LoopCloser made at the keyframe
    events), the consume on the thread pool, pinned: at least 8 frames
    batched, every sequence OK within 0.2 m of the ground truth, and
    shutdown ends the pool and every worker."""
    seqs, poses = sequences
    mst = MultiSequenceTracker(TCFG, len(seqs), full_slam=True, host_threads=True, device="cpu")
    for s in mst.systems:
        _pin(s)
    for i in range(N_FRAMES):
        mst.process_stereo([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * len(seqs))
    mst.shutdown()
    assert mst.n_batched_frames >= 8 and mst._pool._shutdown
    gt = np.stack([-R.T @ t for R, t in poses])
    for s in mst.systems:
        assert s.tracking_state() == "OK" and s.loop_closer is not None
        assert s.loop_closer._worker is None or not s.loop_closer._worker.is_alive()
        est = np.stack([-R.T @ t for (_, _, R, t, _) in s.tracker.final_trajectory()])
        assert np.linalg.norm(est - gt, axis=1).max() < 0.2


@pytest.mark.slow
def test_batched_full_slam_closes_a_loop():
    """Full SLAM per sequence (a System each, loop closing on, lines on,
    the consume on the thread pool), pinned, on the loop circuit forward
    and backward: most frames run batched, a loop closes in at least one
    sequence, and each ATE is within max(1.25 x, + 2 cm) of the port's
    single System on the same frames (tests/test_loop_closure_e2e.py's
    inequality).  Slow: ~5 min on one worker, most of it the two single
    Systems."""
    poses = loop_circuit_trajectory(70, radius=3.0, laps=1.15)
    scene = SyntheticScene(LOOP_CAM, n_points=500, seed=5, extent=((-9.0, 15.0), (-3.0, 3.0), (-12.0, 12.0)))
    scene.noise_sigma = 6.0
    frames = [scene.render_stereo(R, t) for R, t in poses]
    seqs, gts = [frames, frames[::-1]], [poses, poses[::-1]]
    mst = MultiSequenceTracker(LOOP_CFG, 2, full_slam=True, host_threads=True, device="cpu")
    for s in mst.systems:
        _pin(s)
    for i in range(len(frames)):
        mst.process_stereo([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * 2)
    mst.shutdown()
    assert mst.n_batched_frames >= len(frames) // 2, mst.n_batched_frames
    assert mst.n_loops_closed >= 1
    for b, (seq, gt) in enumerate(zip(seqs, gts)):
        single = System(LOOP_CFG, device="cpu")
        _pin(single)
        for i, (left, right) in enumerate(seq):
            single.track_stereo(left, right, timestamp=0.1 * i)
        single.shutdown()
        ate, ref = _ate(mst.trackers[b], gt), _ate(single.tracker, gt)
        assert mst.trackers[b].state == "OK"
        assert ate <= max(1.25 * ref, ref + 0.02), (b, ate, ref)


@pytest.mark.slow
def test_batched_tracker_follows_jax_multi_sequence_tracker(sequences):
    """The JAX package's own MultiSequenceTracker (slow in its suite) and
    the port's, full_slam=False, host_threads=False, pinned, on the same
    frames: the same frames batched, per-frame poses within the pose
    contract (1e-3 rad, 5e-3 m)."""
    from orb_line_slam_tpu.parallel.multi_sequence import MultiSequenceTracker as JaxMultiSequenceTracker

    seqs, _ = sequences
    jmst = JaxMultiSequenceTracker(CFG, len(seqs), full_slam=False, host_threads=False)
    for t in jmst.trackers:
        t.async_mapping = False
        t.pipeline_depth = 0
    j_ready = 0
    for i in range(N_FRAMES):
        j_ready += jmst._ready()
        jmst.process_stereo([s[i][0] for s in seqs], [s[i][1] for s in seqs], [0.1 * i] * len(seqs))
    for t in jmst.trackers:
        t.flush()
    mst = _run_batched(seqs)
    assert mst.n_batched_frames == j_ready >= 8
    for b in range(len(seqs)):
        d_rot, d_t = _pose_gaps(mst.trackers[b].final_trajectory(), jmst.trackers[b].final_trajectory())
        assert d_rot <= 1e-3 and d_t <= 5e-3, (b, d_rot, d_t)
