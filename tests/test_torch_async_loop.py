"""The loop closer's two workers, on the drifted-map fixture of
tests/test_torch_loop_closer.py: the detection worker (``async_detect``)
against the JAX package's, its generation guards and snapshot, its
exceptions; and the asynchronous global BA (``gba_async``:
``dispatch_global_ba``/``poll_global_ba``, the propagation to what was
added while it was solved, and the supersession by a newer loop) against
the JAX package's.  Every wait on a worker is bounded."""

import numpy as np
import pytest
import torch

from orb_line_slam_tpu.loop.loop_closing import LoopCloser as JaxLoopCloser
from orb_line_slam_tpu.loop.vocabulary import Vocabulary as JaxVocabulary
from orb_line_slam_tpu_torch.convert import config_from_jax, map_store_from_numpy, vocabulary_from_numpy
from orb_line_slam_tpu_torch.loop import loop_closing
from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser
from tests.test_torch_loop_closer import F, _angle, _F, build_drifted_map

torch.set_num_threads(1)
CLOSING_KF = 11


def _closers(async_detect=True):
    """Both packages' LoopCloser over copies of one drifted map with one
    vocabulary; the switches on."""
    cfg, store_j, true_t, _ = build_drifted_map()
    voc_j = JaxVocabulary.train(store_j.kf_desc[store_j.kf_valid].reshape(-1, 32)[:8000], k=8, depth=3)
    store_t = map_store_from_numpy(store_j)
    lc_j = JaxLoopCloser(cfg, store_j, voc_j)
    lc_t = LoopCloser(config_from_jax(cfg), store_t, vocabulary_from_numpy(voc_j), device="cpu")
    for lc in (lc_j, lc_t):
        lc.async_detect = async_detect
        lc.gba_async = True
    return lc_j, lc_t, true_t


def _join(lc):
    if isinstance(lc, JaxLoopCloser):
        lc._jobs.join()
    else:
        lc._worker.join()


def _drive(lc, upto=CLOSING_KF):
    """Keyframes 0..upto through process_keyframe, the worker joined after
    each; returns whether any call applied a loop."""
    applied = False
    for k in range(upto + 1):
        applied |= lc.process_keyframe(k, run_gba=False)
        _join(lc)
    return applied


def _add_copy_of(store, k, frame_id=99):
    """A new keyframe with keyframe k's features, pose and landmarks."""
    f = _F(store.kf_desc[k].copy(), np.ones((F, 3), np.float32))
    f.xy, f.u_right, f.depth = store.kf_xy[k].copy(), store.kf_ur[k].copy(), store.kf_depth[k].copy()
    return store.add_keyframe(f, store.kf_R[k].copy(), store.kf_t[k].copy(), frame_id=frame_id,
                              timestamp=frame_id * 0.1, lm_assoc=store.kf_obs_lm[k].copy(), parent=k)


def _stop(*closers):
    for lc in closers:
        lc.stop()
        for w in (lc._worker, getattr(lc, "_gba_worker", None)):
            assert w is None or not w.is_alive()


def test_detection_worker_parks_and_applies_the_loop_like_jax():
    """With the worker joined after each keyframe, both packages park the
    same (kf, gen, cand, cand_gen) with Sim3s within 1e-3 rad and 5e-3 m
    and correct nothing yet; the next keyframe's process_keyframe applies
    it on the calling thread, and the corrected keyframes agree within
    1e-2 m and lie within the JAX test's bounds of the truth."""
    lc_j, lc_t, true_t = _closers()
    start_t = lc_t.map.kf_t.copy()
    assert not _drive(lc_j) and not _drive(lc_t)
    pj, pt = lc_j._pending_loop, lc_t._pending_loop
    assert pj is not None and pt is not None and pt[:4] == pj[:4] and pt[0] == CLOSING_KF
    (s_j, R_j, t_j), (s_t, R_t, t_t) = pj[4], pt[4]
    assert _angle(R_t, R_j) < 1e-3 and np.abs(np.asarray(t_t) - np.asarray(t_j)).max() < 5e-3 and s_t == s_j == 1.0
    assert np.array_equal(lc_t.map.kf_t, start_t) and not lc_t.loop_edges
    new = [_add_copy_of(lc.map, CLOSING_KF) for lc in (lc_j, lc_t)]
    assert new[0] == new[1]
    assert lc_j.process_keyframe(new[0], run_gba=False) and lc_t.process_keyframe(new[1], run_gba=False)
    assert lc_t.last_closed_kf == lc_j.last_closed_kf == CLOSING_KF and lc_t._pending_loop is None
    assert len(lc_t.loop_edges) == 1 and lc_t.closure_ms[0]["kf"] == CLOSING_KF
    assert {"detect", "sim3", "correct", "essential_graph"} <= set(lc_t.closure_ms[0])
    n = 12
    assert np.abs(lc_t.map.kf_t[:n] - lc_j.map.kf_t[:n]).max() < 1e-2
    for t_est in (lc_t.map.kf_t, lc_j.map.kf_t):
        assert np.linalg.norm(t_est[CLOSING_KF] - true_t[CLOSING_KF]) < 0.4
        assert np.linalg.norm(t_est[8] - true_t[8]) < 0.8
    _join(lc_j)
    _join(lc_t)
    _stop(lc_j, lc_t)


@pytest.mark.parametrize("culled", ["closing keyframe", "loop candidate"])
def test_loop_of_a_keyframe_culled_in_flight_is_not_applied(culled):
    """Either keyframe of the parked loop culled and its slot recycled
    before the next keyframe event: neither package applies the loop."""
    closers = _closers()[:2]
    for lc in closers:
        _drive(lc)
        kf, _, cand, _, _, _ = lc._pending_loop
        k = kf if culled == "closing keyframe" else cand
        store = lc.map
        before = store.kf_t.copy()
        gen = int(store.kf_gen[k])
        store.erase_keyframe(k)
        assert _add_copy_of(store, (k + 1) % 12, frame_id=98) == k and store.kf_gen[k] == gen + 1
        assert lc.process_keyframe(k, run_gba=False) is False
        assert lc._pending_loop is None and not lc.loop_edges
        assert np.array_equal(np.delete(store.kf_t, k, 0), np.delete(before, k, 0))
        _join(lc)
    _stop(*closers)


def test_map_mutation_after_the_snapshot_does_not_change_the_sim3(monkeypatch):
    """The Sim3 chain reads only its _MapSnapshot: moving every landmark
    and keyframe of the live map right after the snapshot was taken
    leaves the parked Sim3 bit for bit as it is without the move."""
    _, lc_ref, _ = _closers()
    _drive(lc_ref)
    _, lc, _ = _closers()
    taken = []

    class MovedAfterSnapshot(loop_closing._MapSnapshot):
        def __init__(self, store, ids):
            super().__init__(store, ids)
            store.pt_pos += np.float32(5.0)
            store.kf_t += np.float32(3.0)
            taken.append(ids)

    monkeypatch.setattr(loop_closing, "_MapSnapshot", MovedAfterSnapshot)
    _drive(lc)
    assert taken and lc._pending_loop is not None
    assert lc._pending_loop[:4] == lc_ref._pending_loop[:4]
    for a, b in zip(lc._pending_loop[4], lc_ref._pending_loop[4]):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    _stop(lc, lc_ref)


def test_worker_exception_surfaces_in_flush_after_the_parked_loop():
    """A detection job that fails after parking a loop: flush() applies
    the parked loop first (the detection succeeded), then raises the
    job's exception on the calling thread."""
    _, lc, true_t = _closers()
    _drive(lc, upto=CLOSING_KF - 1)
    real_job = lc._detect_job

    def parks_then_fails(kf_id, gen, count):
        real_job(kf_id, gen, count)
        raise RuntimeError("the detection worker failed")

    lc._detect_job = parks_then_fails
    lc.process_keyframe(CLOSING_KF, run_gba=False)
    with pytest.raises(RuntimeError, match="detection worker failed"):
        lc.flush(run_gba=False)
    assert lc.last_closed_kf == CLOSING_KF and len(lc.loop_edges) == 1
    assert np.linalg.norm(lc.map.kf_t[CLOSING_KF] - true_t[CLOSING_KF]) < 0.4
    assert lc.flush(run_gba=False) is False       # raised once, nothing left
    _stop(lc)


def _in_flight_keyframe_and_landmark(store, rng):
    """tests/test_loop_closing.py:145-165: a keyframe 1 m ahead of the
    newest one and a landmark first seen by it."""
    parent = store._next_kf - 1
    t_rel = np.array([0.0, 0.0, -1.0], np.float32)
    descs = rng.integers(0, 256, (F, 32), dtype=np.uint8)
    pts_cam = np.stack([rng.uniform(-4, 4, F), rng.uniform(-2, 2, F), rng.uniform(5, 25, F)], -1).astype(np.float32)
    kf_new = store.add_keyframe(_F(descs, pts_cam), store.kf_R[parent].copy(), store.kf_t[parent] + t_rel,
                                frame_id=99, timestamp=9.9)
    x_w = np.array([[1.0, 0.5, 12.0]], np.float32)
    x_cam = store.kf_R[kf_new] @ x_w[0] + store.kf_t[kf_new]
    ids = store.add_points(x_w, descs[:1], np.zeros(1, np.int32), kf_new, np.array([0]))
    return parent, kf_new, t_rel, int(ids[0]), x_cam


def test_async_gba_dispatch_poll_and_propagation():
    """tests/test_loop_closing.py's slow test at the fixture's size, both
    packages: dispatch_global_ba returns with the solve pending; a
    keyframe and a landmark are added while it is solved; the poll
    applies it, the new keyframe keeps its pose relative to its parent
    and the landmark its position in its first keyframe's camera; both
    packages' maps agree within 1e-2 m.  The map is perturbed first (2 cm
    on the keyframes, 3 cm on the landmarks, as in
    test_global_ba_parity_on_perturbed_map), so the solve has work to do."""
    lc_j, lc_t, _ = _closers(async_detect=False)
    rng = np.random.default_rng(5)
    d_kf = rng.normal(0, 0.02, (11, 3)).astype(np.float32)
    d_pt = rng.normal(0, 0.03, (lc_t.map.P, 3)).astype(np.float32)
    got = []
    for lc in (lc_j, lc_t):
        lc.map.kf_t[1:12] += d_kf
        lc.map.pt_pos[lc.map.pt_valid] += d_pt[lc.map.pt_valid]
        lc.dispatch_global_ba(iters1=2, iters2=3)
        assert lc._pending_gba is not None
        parent, kf_new, t_rel, lm, x_cam = _in_flight_keyframe_and_landmark(lc.map, np.random.default_rng(7))
        before = lc.map.kf_t[:12].copy()
        assert lc.poll_global_ba(force=True) and lc._pending_gba is None
        store = lc.map
        R_rel = store.kf_R[kf_new] @ store.kf_R[parent].T
        np.testing.assert_allclose(R_rel, np.eye(3), atol=1e-4)
        np.testing.assert_allclose(store.kf_t[kf_new] - R_rel @ store.kf_t[parent], t_rel, atol=1e-3)
        np.testing.assert_allclose(store.kf_R[kf_new] @ store.pt_pos[lm] + store.kf_t[kf_new], x_cam, atol=1e-3)
        assert np.abs(store.kf_t[:12] - before).max() > 1e-3       # the solve moved the map
        got.append((store.kf_t.copy(), store.pt_pos[store.pt_valid].copy()))
    assert lc_t.n_gba_applied == 1 and lc_t.timing.cnt["gba_worker"] == 1
    (tj, pj), (tt, pt) = got
    assert np.abs(tt[:13] - tj[:13]).max() < 1e-2
    assert np.median(np.linalg.norm(pt - pj, axis=1)) < 1e-2
    _stop(lc_t)


def test_newer_loop_supersedes_the_pending_gba():
    """A global BA pending from before a loop closure is superseded by the
    closure's own: it is never applied (the map ends corrected, not
    dragged back to the drifted poses it was packed from), and only the
    new solve is."""
    _, lc, true_t = _closers()
    _drive(lc)
    lc.dispatch_global_ba()
    stale = lc._pending_gba
    assert lc.process_keyframe(_add_copy_of(lc.map, CLOSING_KF), run_gba=True)
    assert lc.n_gba_superseded == 1 and lc._pending_gba is not None and lc._pending_gba is not stale
    assert lc.poll_global_ba(force=True) and lc.n_gba_applied == 1 and not lc._superseded_gba
    assert stale[1].done()
    assert np.linalg.norm(lc.map.kf_t[CLOSING_KF] - true_t[CLOSING_KF]) < 0.4
    assert not lc.poll_global_ba(force=True)
    _join(lc)
    _stop(lc)
