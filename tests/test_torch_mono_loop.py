"""Monocular loop closing with a free scale (``fix_scale=False``, what the
System sets for a monocular tracker) in the port against the JAX package.

On a scale-drifted monocular map (tests/test_torch_loop_closer.py's
drifted map, its return leg also growing in scale to 1.1 and its
observations without a right coordinate or depth): both LoopClosers
close at the same keyframe with the same Sim3, its scale that of the
imposed drift; the group rewrite with s != 1, the loop fuse and the
essential graph give the same map under the pose contract (1e-3 rad,
5e-3 m); the global BA on the mono observations follows the JAX
package's where its problem is well posed; and the same map closed with
a fixed scale keeps a larger gap across the loop.

Slow: the port's System.track_monocular on chip_smoke.py's loop circuit
(170 frames, 640x320, the left images) until its free-scale loop closes,
then both packages' ``_correct`` from the port's map at that closure;
and the JAX-CPU constants of chip_smoke.py's phase 17.

    JAX_PLATFORMS=cpu python -m pytest -m slow tests/test_torch_mono_loop.py -s
"""

import copy
import json
import threading

import numpy as np
import pytest
import torch

from orb_line_slam_tpu.eval.trajectory import ate_rmse as jax_ate_rmse
from orb_line_slam_tpu.loop.loop_closing import LoopCloser as JaxLoopCloser
from orb_line_slam_tpu.loop.vocabulary import Vocabulary as JaxVocabulary
from orb_line_slam_tpu.pipeline.system import System as JaxSystem
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.convert import config_from_jax, map_store_from_numpy, vocabulary_from_numpy
from orb_line_slam_tpu_torch.eval.trajectory import ate_rmse
from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser
from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary
from orb_line_slam_tpu_torch.pipeline.system import System
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore
from tests.test_torch_loop_closer import CAM, _angle, _drive, build_drifted_map
from tests.test_torch_tum_references import _chip_smoke, _jax_config

torch.set_num_threads(1)

SCALE_DRIFT = 0.1          # the return leg's map grows to 1.1 x
ROT_TOL, POS_TOL = 1e-3, 5e-3
STAGES = ("before", "rewrite_and_fuse", "essential_graph", "global_ba")


def _state(store):
    return store.kf_R.copy(), store.kf_t.copy(), store.pt_pos.copy(), store.pt_valid.copy()


def _close_both(fix_scale):
    """Both packages' LoopCloser over the scale-drifted mono map, recording
    the map before the closure, after the group rewrite and fuse, after
    the essential graph and after global BA: the JAX package's here, the
    port's through chip_smoke.py's close_fixture on CPU tensors (its map
    is this one array by array, and its vocabulary, trained on the same
    descriptors, the JAX package's: test_chip_smoke_fixture_is_this_fixture
    and tests/test_torch_loop_geometry.py hold both)."""
    cfg, store_j, true_t, _ = build_drifted_map(scale_drift=SCALE_DRIFT, mono=True)
    voc_j = JaxVocabulary.train(store_j.kf_desc[store_j.kf_valid].reshape(-1, 32)[:8000], k=8, depth=3)
    lc_j = JaxLoopCloser(cfg, store_j, voc_j)
    lc_j.fix_scale = fix_scale
    stages = {}

    def record(tag):
        stages[tag] = _state(store_j)

    graph = lc_j._optimize_essential_graph

    def recorded_graph(*a, **k):
        record("rewrite_and_fuse")
        graph(*a, **k)
        record("essential_graph")

    lc_j._optimize_essential_graph = recorded_graph
    record("before")
    closed_j = _drive(lc_j, store_j)
    if closed_j is not None:
        lc_j.run_global_ba()
        record("global_ba")
    lc_t, closed_t, stages_t, _, _ = _chip_smoke().close_fixture("cpu", fix_scale)
    return {"true_t": true_t, "closers": {"jax": lc_j, "torch": lc_t},
            "closed": {"jax": closed_j, "torch": closed_t},
            "stages": {tag: {"jax": stages[tag], "torch": stages_t[tag]} for tag in stages if tag in stages_t}}


@pytest.fixture(scope="module")
def free():
    return _close_both(fix_scale=False)


@pytest.fixture(scope="module")
def fixed():
    return _close_both(fix_scale=True)


def _gaps(run, tag):
    """Each package's gap across its loop at a stage."""
    out = {}
    for name, lc in run["closers"].items():
        R, t, _, _ = run["stages"][tag][name]
        edge = lc.loop_edges[0]
        out[name] = _chip_smoke().fixture_gap(R, t, run["true_t"], edge.kf_a, edge.kf_b)
    return out


def test_free_scale_loop_closes_at_the_same_keyframe(free):
    """The same keyframes close the loop, and the accepted Sim3 agrees:
    rotation 1e-3 rad, translation 5e-3 m, scale 1e-4 (2e-6 measured),
    and the scale is the imposed drift's within 5e-3 (1.1008 measured)."""
    lc_j, lc_t = free["closers"]["jax"], free["closers"]["torch"]
    assert not lc_j.fix_scale and not lc_t.fix_scale
    assert free["closed"]["jax"] is not None, "the JAX package never closed the loop"
    assert free["closed"]["torch"] == free["closed"]["jax"] == 11
    assert len(lc_t.loop_edges) == len(lc_j.loop_edges) == 1
    ej, et = lc_j.loop_edges[0], lc_t.loop_edges[0]
    assert (et.kf_a, et.kf_b, et.gen_a, et.gen_b) == (ej.kf_a, ej.kf_b, ej.gen_a, ej.gen_b)
    assert _angle(et.R, ej.R) < ROT_TOL
    assert np.abs(np.asarray(et.t) - np.asarray(ej.t)).max() < POS_TOL
    assert abs(float(et.s) - float(ej.s)) < 1e-4
    assert abs(float(et.s) - (1 + SCALE_DRIFT)) < 5e-3, float(et.s)


@pytest.mark.parametrize("stage", ["before", "rewrite_and_fuse", "essential_graph"])
def test_free_scale_corrected_map_agrees(free, stage):
    """Stage by stage, under the pose contract: every keyframe's rotation
    within 1e-3 rad and its centre within 5e-3 m of the JAX package's, the
    landmarks within 5e-3 m in the median, the same landmarks alive.  The
    group rewrite scales the closing group's translations by 1/s
    (loop_closing.py's ``tk2 / sk``)."""
    (Rj, tj, pj, vj), (Rt, tt, pt, vt) = (free["stages"][stage][k] for k in ("jax", "torch"))
    n = 12
    assert np.array_equal(vt, vj)
    assert max(_angle(Rt[k], Rj[k]) for k in range(n)) < ROT_TOL
    cj = -np.einsum("kji,kj->ki", Rj[:n], tj[:n])
    ct = -np.einsum("kji,kj->ki", Rt[:n], tt[:n])
    assert np.linalg.norm(ct - cj, axis=1).max() < POS_TOL
    assert np.median(np.linalg.norm(pt[vt] - pj[vj], axis=1)) < POS_TOL


def test_free_scale_closure_removes_the_drift(free):
    """The correction takes the gap across the loop from 1.59 m to below
    0.1 m in both packages (0.052 m after the rewrite and fuse, 0.071 m
    after the essential graph), and the global BA that follows on the
    mono observations keeps it below 0.2 m (0.12 and 0.07 m measured),
    leaves the gauge keyframe where it was and the map finite.  After the
    global BA the two maps are not held to each other: the free-scale BA
    fixes one keyframe, so its scale direction is held only by the
    damping, and float32 rounding moves it by decimetres over twelve
    iterations (``test_mono_global_ba_on_corrected_map_follows_jax`` holds
    the solver where it is determined)."""
    before = _gaps(free, "before")
    assert min(before.values()) > 1.5
    for tag, bound in (("rewrite_and_fuse", 0.1), ("essential_graph", 0.1), ("global_ba", 0.2)):
        assert max(_gaps(free, tag).values()) < bound, (tag, _gaps(free, tag))
    assert free["closers"]["torch"].n_gba_applied == 1
    for name in ("jax", "torch"):
        R, t, p, v = free["stages"]["global_ba"][name]
        assert np.isfinite(t).all() and np.isfinite(p[v]).all()
        assert np.array_equal(t[0], free["stages"]["essential_graph"][name][1][0])


def test_fixed_scale_leaves_a_larger_gap(free, fixed):
    """The same map closed with s pinned to 1 (the stereo setting): both
    packages accept a rigid Sim3 and, after the rewrite and after the
    essential graph, leave a gap across the loop at least five times the
    free-scale run's (0.57 m against 0.052 m after the rewrite, 0.56
    against 0.071 m after the essential graph)."""
    assert fixed["closed"]["torch"] == fixed["closed"]["jax"]
    for name, lc in fixed["closers"].items():
        assert all(float(e.s) == 1.0 for e in lc.loop_edges)
    for tag in ("rewrite_and_fuse", "essential_graph"):
        f, g = _gaps(free, tag), _gaps(fixed, tag)
        for name in ("jax", "torch"):
            assert g[name] > 5 * f[name], (tag, name, g[name], f[name])


def _corrected_gba_args():
    """The global BA problem of the just-corrected scale-drifted mono map,
    at its live size."""
    cfg, store_j, _, _ = build_drifted_map(scale_drift=SCALE_DRIFT, mono=True)
    voc_j = JaxVocabulary.train(store_j.kf_desc[store_j.kf_valid].reshape(-1, 32)[:8000], k=8, depth=3)
    store = map_store_from_numpy(store_j)
    lc = LoopCloser(config_from_jax(cfg), store, vocabulary_from_numpy(voc_j), device="cpu")
    lc.fix_scale = False
    assert _drive(lc, store) == 11
    pack, _ = lc._dispatch_gba(0, 0)
    n_c, n_p, n_o = len(pack["cam_ids"]), len(pack["lm_ids"]), int(pack["n_obs"])
    cut = {"R": n_c, "t": n_c, "cam_fixed": n_c, "points": n_p, "point_valid": n_p}
    keys = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")
    return lc, [pack[k][: cut.get(k, n_o)] for k in keys]


def test_mono_global_ba_on_corrected_map_follows_jax():
    """The global BA of the free-scale closure, the same arrays into both
    packages' ``bundle_adjust``: every observation monocular (uR < 0);
    the first two LM steps are rejected by both (nothing moves), the third
    is accepted by both and moves keyframes by about a metre, and there
    the packages agree within 5e-3 m on keyframes and landmarks (6e-4 m
    measured).  Past it the scale direction is held only by the damping
    (one keyframe fixed), and float32 rounding decides where it goes."""
    import jax.numpy as jnp

    from orb_line_slam_tpu.backend.local_ba import bundle_adjust as jax_bundle_adjust
    from orb_line_slam_tpu_torch.backend.local_ba import bundle_adjust

    lc, args = _corrected_gba_args()
    obs_uvur, obs_valid = args[7], args[9]
    assert obs_valid.all() and (obs_uvur[:, 2] < 0).all()
    sf = lc.cfg.orb.scale_factor
    for iters, tol in ((1, 1e-6), (2, 1e-6), (3, POS_TOL)):
        rj = jax_bundle_adjust(*(jnp.asarray(a) for a in args), CAM, sf, iters1=iters, iters2=0, fix_first=True)
        rt = bundle_adjust(*(torch.from_numpy(a) for a in args), lc.cfg.camera, sf, iters1=iters, iters2=0,
                           fix_first=True)
        moved_j = float(np.abs(np.asarray(rj.t) - args[1]).max())
        moved_t = float(np.abs(rt.t.numpy() - args[1]).max())
        assert (moved_j > 0.1) == (moved_t > 0.1) == (iters == 3), (iters, moved_j, moved_t)
        assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < tol
        assert max(_angle(rt.R.numpy()[k], np.asarray(rj.R)[k]) for k in range(len(args[0]))) < ROT_TOL
        assert np.median(np.linalg.norm(rt.points.numpy() - np.asarray(rj.points), axis=1)) < max(tol, 1e-5)


def test_mono_global_ba_parity_on_perturbed_map():
    """run_global_ba of both packages on the scale-drifted mono map with
    2 cm on the keyframes and 3 cm on the landmarks: keyframes within
    5e-3 m and 1e-3 rad (2e-3 m measured), landmarks within 5e-3 m in the
    median."""
    cfg, store_j, _, _ = build_drifted_map(scale_drift=SCALE_DRIFT, mono=True)
    rng = np.random.default_rng(5)
    store_j.kf_t[1:12] += rng.normal(0, 0.02, (11, 3)).astype(np.float32)
    ids = np.nonzero(store_j.pt_valid)[0]
    store_j.pt_pos[ids] += rng.normal(0, 0.03, (len(ids), 3)).astype(np.float32)
    store_t = map_store_from_numpy(store_j)
    voc_j = JaxVocabulary.synthesize(k=4, depth=2)
    lc_j = JaxLoopCloser(cfg, store_j, voc_j)
    lc_t = LoopCloser(config_from_jax(cfg), store_t, vocabulary_from_numpy(voc_j), device="cpu")
    lc_j.fix_scale = lc_t.fix_scale = False
    lc_j.run_global_ba()
    lc_t.run_global_ba()
    assert lc_t.n_gba_applied == 1 and lc_t.last_gba_solver == "dense"
    assert np.abs(store_t.kf_t[:12] - store_j.kf_t[:12]).max() < POS_TOL
    assert max(_angle(store_t.kf_R[k], store_j.kf_R[k]) for k in range(12)) < ROT_TOL
    assert np.median(np.linalg.norm(store_t.pt_pos[ids] - store_j.pt_pos[ids], axis=1)) < POS_TOL


def test_chip_smoke_fixture_is_this_fixture(free, fixed):
    """chip_smoke.py's phase 17 (c) builds the same scale-drifted mono map
    in the port's MapStore, array by array, and its CPU closure (the
    port's vocabulary trained on the map; the port's half of ``free`` and
    ``fixed``) is the JAX package's: keyframe 11, the same loop keyframe,
    the scale within 1e-4, the gaps across the loop that phase 17 (c)
    checks on the card."""
    cs = _chip_smoke()
    assert cs.FIXTURE_SCALE_DRIFT == SCALE_DRIFT
    _, store_j, true_j, _ = build_drifted_map(scale_drift=SCALE_DRIFT, mono=True)
    _, store_t, true_t = cs.scale_drifted_mono_map()
    assert np.array_equal(true_t, true_j)
    for name, value in vars(store_j).items():
        if isinstance(value, np.ndarray):
            assert np.array_equal(getattr(store_t, name), value), name
    lc, lc_j = free["closers"]["torch"], free["closers"]["jax"]
    assert free["closed"]["torch"] == fixed["closed"]["torch"] == 11
    assert lc.loop_edges[0].kf_b == lc_j.loop_edges[0].kf_b
    assert abs(float(lc.loop_edges[0].s) - float(lc_j.loop_edges[0].s)) < 1e-4
    gaps, gaps_fixed = (_gaps(run, "before")["torch"] for run in (free, fixed))
    assert gaps > 1.5 and gaps_fixed > 1.5
    gaps = {tag: _gaps(free, tag)["torch"] for tag in ("rewrite_and_fuse", "essential_graph", "global_ba")}
    assert max(gaps["rewrite_and_fuse"], gaps["essential_graph"]) < 0.1 and gaps["global_ba"] < 0.2
    assert _gaps(fixed, "essential_graph")["torch"] > 5 * gaps["essential_graph"]


# ---------------------------------------------------------------------------
# slow: chip_smoke.py's loop circuit from pixels, monocular


def _mono_circuit(cs):
    """chip_smoke.py's loop cell: its configuration, the circuit's poses
    and the left images of the stereo pairs it renders."""
    ccfg = cs.loop_config()
    poses, frames = cs.render_loop_sequence(ccfg)
    return ccfg, poses, [left for left, _ in frames]


def _mono_ate(tracker, poses):
    traj = tracker.final_trajectory()
    tracked = np.array([not e[4] for e in traj])
    est = np.stack([-R.T @ t for (_, _, R, t, _) in traj])
    gt = np.stack([-R.T @ t for (R, t) in poses])
    return est, gt, tracked


@pytest.mark.slow
def test_mono_circuit_closes_and_matches_jax():
    """The port's System.track_monocular over chip_smoke.py's loop circuit
    on the pinned schedule until its loop closes (with a free scale),
    then both packages' ``LoopCloser._correct`` from copies of the map the
    port had on entry to the correction, with its accepted Sim3: the
    group rewrite and fuse agree exactly, the essential graph and the
    global BA under the pose contract (6e-7 m and 3.5e-4 m measured at
    the closure of frame 151's keyframe, s 1.1113), and both remove most
    of the drift across the loop (0.170 -> 0.032 map units)."""
    cs = _chip_smoke()
    ccfg, poses, lefts = _mono_circuit(cs)
    torch.set_num_threads(4)
    snaps = []

    class Reached(Exception):
        pass

    def recorded_correct(self, kf_id, cand, sim, run_gba=True):
        if self.pre_correct_hook is not None:
            self.pre_correct_hook()
        state = {k: v for k, v in vars(self.map).items() if k not in ("lock", "on_kf_culled", "cfg")}
        snaps.append({"state": copy.deepcopy(state), "kf": int(kf_id), "cand": int(cand), "fix_scale": self.fix_scale,
                      "sim": (float(sim[0]), np.array(sim[1]), np.array(sim[2]))})
        raise Reached

    slam = System(ccfg, use_loop_closing=True, async_loop=False, device="cpu")
    slam.gba_async = False
    slam.tracker.async_mapping = False
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(LoopCloser, "_correct", recorded_correct)
            try:
                for i, img in enumerate(lefts):
                    slam.track_monocular(img, timestamp=0.1 * i)
                slam.shutdown()
            except Reached:
                pass
    finally:
        torch.set_num_threads(1)
    assert snaps, "no loop closed on the monocular circuit"
    snap = snaps[0]
    assert slam.tracker.is_mono and not snap["fix_scale"] and snap["sim"][0] != 1.0
    par = _mono_closure_parity(snap, ccfg, poses)
    print(f"monocular closure (closing keyframe {snap['kf']} of frame "
          f"{int(snap['state']['kf_frame_id'][snap['kf']])}, loop keyframe {snap['cand']}, s {snap['sim'][0]:.5f}): "
          + json.dumps(par))
    assert par["before"]["rot"] == 0.0 and par["before"]["kf_m"] == 0.0
    assert par["rewrite_and_fuse"]["kf_m"] < 1e-5 and par["rewrite_and_fuse"]["rot"] < 1e-6
    for tag in ("essential_graph", "global_ba"):
        assert par[tag]["kf_m"] < POS_TOL and par[tag]["rot"] < ROT_TOL and par[tag]["pts_median_m"] < POS_TOL
        assert max(par[tag]["gap"]) < 0.5 * min(par["before"]["gap"]), (tag, par[tag]["gap"])


def _mono_closure_parity(snap, cfg, poses):
    """Both packages' ``_correct`` from copies of one pre-closure map:
    per stage the largest keyframe rotation (rad) and centre (m) gap
    between them, the landmarks' median gap (m), each package's keyframe
    ATE (similarity-aligned) and drift across the loop (m)."""
    from tests.test_torch_loop_system import _gap_error

    jcfg = _jax_config(cfg)
    gt = np.stack([-R.T @ t for (R, t) in poses])
    stages = {}
    for name, store_cls, closer_cls, voc_cls, c, kw in (
            ("jax", JaxMapStore, JaxLoopCloser, JaxVocabulary, jcfg, {}),
            ("torch", MapStore, LoopCloser, Vocabulary, cfg, {"device": "cpu"})):
        store = store_cls.__new__(store_cls)
        store.__dict__.update(copy.deepcopy(snap["state"]))
        store.cfg, store.lock, store.on_kf_culled = c.map, threading.RLock(), []
        lc = closer_cls(c, store, voc_cls.synthesize(k=4, depth=2), **kw)
        lc.fix_scale = False

        def record(tag, store=store, name=name):
            ids = np.nonzero(store.kf_valid)[0]
            centres = -np.einsum("kji,kj->ki", store.kf_R[ids], store.kf_t[ids])
            ate = jax_ate_rmse if name == "jax" else ate_rmse
            stages.setdefault(tag, {})[name] = {
                "R": store.kf_R[ids].copy(), "centres": centres, "points": store.pt_pos[store.pt_valid].copy(),
                "kf_ate": float(ate(centres, gt[store.kf_frame_id[ids]], align=True, with_scale=True)),
                "gap": _gap_error(store, poses, snap["kf"], snap["cand"])}

        graph = lc._optimize_essential_graph

        def recorded_graph(*a, graph=graph, record=record, **k):
            record("rewrite_and_fuse")
            graph(*a, **k)
            record("essential_graph")

        lc._optimize_essential_graph = recorded_graph
        record("before")
        lc._correct(snap["kf"], snap["cand"], snap["sim"], run_gba=True)
        record("global_ba")
    out = {}
    for tag, both in stages.items():
        j, t = both["jax"], both["torch"]
        assert j["points"].shape == t["points"].shape, f"{tag}: the packages kept different landmarks"
        out[tag] = {"rot": max(_angle(a, b) for a, b in zip(j["R"], t["R"])),
                    "kf_m": float(np.linalg.norm(j["centres"] - t["centres"], axis=1).max()),
                    "pts_median_m": float(np.median(np.linalg.norm(j["points"] - t["points"], axis=1))),
                    "kf_ate": (j["kf_ate"], t["kf_ate"]), "gap": (j["gap"], t["gap"])}
    return out


@pytest.mark.slow
@pytest.mark.parametrize("use_loop", [True, False], ids=["on", "off"])
@pytest.mark.parametrize("draw", range(9))
def test_chip_smoke_mono_loop_jax_cpu_reference(draw, use_loop):
    """Where chip_smoke.py's phase-17 constants come from: the JAX
    package's System.track_monocular on the left images of the loop
    circuit under sensor-noise draw `draw` (draw 0 is phase 10's frames),
    the loop cell's configuration carried across field by field, on the
    pinned schedule (async_loop=False, gba_async = False,
    tracker.async_mapping = False, pipeline_depth = 0), on the CPU, with
    loop closing on and off: the first tracked frame, the frames tracked,
    the similarity-aligned ATE over them and the loops closed.  Over the
    draws the frames tracked run from about a third of the circuit to all
    of it, and loop closing on tracks fewer frames than off on some draws
    (ROADMAP Queue 3).  About 70 s a case on one worker."""
    cs = _chip_smoke()
    assert sorted(cs.JAX_CPU_MONO_LOOP) == list(range(9))
    ccfg = cs.loop_config()
    scene, poses, kind = cs.loop_job(ccfg, draw)
    lefts = [left for left, _ in cs.render_jobs([(scene, poses, kind)])[0]]
    s = JaxSystem(_jax_config(ccfg), use_loop_closing=use_loop, async_loop=False)
    s.gba_async = False
    s.tracker.async_mapping = False
    s.tracker.pipeline_depth = 0
    for i, img in enumerate(lefts):
        s.track_monocular(img, timestamp=0.1 * i)
    s.shutdown()
    est, gt, tracked = _mono_ate(s.tracker, poses)
    ate = float(jax_ate_rmse(est[tracked], gt[tracked], align=True, with_scale=True))
    got = (int(np.argmax(tracked)), int(tracked.sum()), ate, s.n_loops_closed)
    scales = [float(e.s) for e in s.loop_closer.loop_edges] if s.loop_closer is not None else []
    print(f"mono loop circuit, draw {draw}, loop closing {'on' if use_loop else 'off'}: JAX-CPU (first tracked "
          f"frame, frames tracked, ATE m, loops) {got!r}, scales {scales}, {int(s.map.n_keyframes())} keyframes, "
          f"state {s.tracking_state()}")
    want = cs.JAX_CPU_MONO_LOOP[draw]["on" if use_loop else "off"]
    assert (got[0], got[1], got[3]) == (want[0], want[1], want[3])
    assert got[2] == pytest.approx(want[2], rel=1e-3)
