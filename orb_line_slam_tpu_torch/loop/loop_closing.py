"""Loop detection + correction orchestration.

Port of ``orb_line_slam_tpu/loop/loop_closing.py``: per-keyframe BoW
candidate detection with the 3-consecutive-keyframe covisibility
consistency, Sim3 computation (batched RANSAC + guided matching +
refinement), CorrectLoop (Sim3 propagation over the covisible group,
landmark fuse, essential-graph optimization, global BA).  Ported:
``_RowView`` and ``_MapSnapshot`` (71-93), ``LoopEdge`` (96-107),
``__init__`` with the cull listener (110-168, 270-277),
``process_keyframe`` (280-302), the detection worker (``_detect_job``,
``_apply_pending``, ``stop``, 305-384), ``flush``
(386-401), ``_process_resolved`` (403-426), ``_covisible_set``/``_detect``
(429-474), ``_compute_sim3`` (477-544), ``_refine_sim3`` (547-643),
``_correct`` (646-769), ``_optimize_essential_graph`` (772-939),
``run_global_ba``, ``dispatch_global_ba``, ``poll_global_ba``,
``_apply_gba``, ``_ride_first_kf`` and ``_dispatch_gba`` (942-1180).
Host math is numpy (``geometry/host.py``); the device programs run on
the closer's ``device``.

Two switches, both off here and on in ``System``'s default schedule, as
in the JAX package.  ``async_detect``: the BoW transform, detection and
the Sim3 chain of each keyframe run on a worker thread
(``utils/worker.py``) that never mutates the map (it reads a
``_MapSnapshot`` taken under ``map.lock``); a loop it accepts is parked
and corrected on the tracking thread at the next keyframe event, after
both keyframes' generations are checked again.  ``gba_async``: the
global BA of a correction is packed on the tracking thread, solved on a
second worker, and applied by a later ``poll_global_ba`` with
spanning-chain propagation to what was made meanwhile; a newer loop
supersedes a pending solve, which is then never applied.  A worker's
exception is raised on the tracking thread: a detection's at the next
keyframe event or at ``flush`` (after a parked loop is applied), a
global BA's at ``poll_global_ba``.

Shape policy: the JAX package pads every device problem to a fixed
bucket (256 / 512 matches, edges to a multiple of 256, global BA to the
map's capacity) so that XLA compiles each program once.  The match
problems keep their fixed N (the hypothesis draw depends on it); the
pose graph takes the live edges and the global BA the live keyframe,
landmark and observation counts.  Masked padding does not change a
solve.  Which global solver runs is still decided from the configured
capacity, as in the JAX package, so both take the same branch.

Multi-device global BA (JAX ``_dispatch_gba_sharded``, 1182-1203, and
``_ShardedGBAResult``, 42-68): the closer holds a ``ShardMesh``
(``parallel/multihost.py``; by default ``global_mesh()`` over its device
type, which on one card or on the CPU has one shard).  When the global BA
takes the CG solver and the mesh has more than one shard, the solve runs
landmark-sharded over the mesh (``parallel/sharded_ba.py``), as the JAX
package routes it when ``jax.device_count() > 1``; its result is mapped
back to pack order.  A one-shard mesh never routes.

Not ported: the jit warmups.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from ..backend.global_ba import bundle_adjust_cg
from ..backend.line_ba import bundle_adjust_pl
from ..backend.local_ba import BAResult, bundle_adjust
from ..backend.pose_graph import optimize_pose_graph
from ..backend.sim3_opt import optimize_sim3
from ..backend.sim3_solver import solve_sim3_ransac
from ..config import SlamConfig
from ..geometry.host import (
    northonormal_from_pluecker,
    npluecker_from_endpoints,
    nse3_apply,
    nse3_compose,
    nse3_inverse,
    nse3_relative,
    nsim3_apply,
    nsim3_compose,
    nsim3_inverse,
)
from ..matching.point_matcher import match_descriptors, search_by_sim3_dir
from ..parallel import multihost
from ..parallel.sharded_ba import distributed_ba_cg, shard_gba_pack, unshard_result
from ..slam_map.fuse import fuse_into_keyframe
from ..slam_map.keyframe_db import KeyFrameDatabase
from ..slam_map.map_store import MapStore
from ..utils.timing import StageTimer
from ..utils.worker import Worker
from .vocabulary import Vocabulary

_POINT_KEYS = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur",
               "obs_oct", "obs_valid")


class _RowView:
    """Per-keyframe row copies with the source's indexing interface."""

    def __init__(self, src, ids):
        self._d = {int(k): np.array(src[int(k)], copy=True) for k in ids}

    def __getitem__(self, k):
        return self._d[int(k)]


class _MapSnapshot:
    """Consistent copy of everything the Sim3 chain reads for two
    keyframes, taken under map.lock by the detection worker: the tracking
    thread keeps mutating the keyframe and landmark arrays in place, and
    a Sim3 fit on torn state can pass its inlier gates and rewrite the
    whole map with a wrong similarity."""

    def __init__(self, store, ids):
        for name in ("kf_desc", "kf_obs_lm", "kf_feat_valid", "kf_xy", "kf_oct", "kf_R", "kf_t"):
            setattr(self, name, _RowView(getattr(store, name), ids))
        self.pt_pos = store.pt_pos.copy()
        self.pt_valid = store.pt_valid.copy()


@dataclasses.dataclass
class LoopEdge:
    kf_a: int
    kf_b: int
    s: float
    R: np.ndarray
    t: np.ndarray
    # Slot generations at creation: a culled+recycled slot is a
    # different keyframe, and a stale edge must not constrain it.
    gen_a: int = 0
    gen_b: int = 0


def sharded_gauge(cam_fixed: np.ndarray) -> np.ndarray:
    """The gauge of the sharded global BA (JAX ``loop_closing.py:1197-1199``):
    the first fixed camera of the pack, or camera 0 if none is, held
    fixed.  ``fix_first`` would fix camera 0 in every case."""
    fixed = np.asarray(cam_fixed, bool).copy()
    fixed[0 if not fixed.any() else int(np.argmax(fixed))] = True
    return fixed


class LoopCloser:
    def __init__(self, cfg: SlamConfig, store: MapStore, voc: Vocabulary, *, device, mesh=None):
        self.cfg = cfg
        self.map = store
        self.voc = voc
        self.device = torch.device(device)
        # The shard mesh of the global BA: a CG-sized solve runs sharded
        # over it when it has more than one shard.
        self.mesh = mesh if mesh is not None else multihost.global_mesh(self.device.type)
        self.db = KeyFrameDatabase(voc)
        self.consistent_groups: list[tuple[set[int], int]] = []
        self.loop_edges: list[LoopEdge] = []
        # Temporal recency gate in processed-keyframe counts (slot ids
        # are recycled and non-monotonic).
        self.kf_counter = 0
        self.last_loop_count = -100
        self.last_closed_kf = -1
        # Called right before a correction rewrites poses (System wires
        # it to apply the tracker's outstanding mapping jobs).
        self.pre_correct_hook = None
        # One-keyframe BoW lag: the word transform for keyframe k is
        # dispatched when k arrives and resolved when k+1 arrives;
        # detection then runs for k.
        self._pending_bow = None
        # Cull listener: drop dead keyframes from the inverted index and
        # the consistency state before their slot is recycled.
        store.on_kf_culled.append(self._on_kf_culled)
        # Monocular maps drift in scale, so the loop Sim3 must estimate
        # it; stereo/RGB-D pin s=1.
        self.fix_scale = True
        # Host time of the stages (detect, sim3, correct, essential_graph,
        # gba): totals in `timing`, and the split of each closing
        # keyframe's event in `closure_ms`; and what the global BAs were.
        self.timing = StageTimer()
        self.closure_ms: list[dict] = []
        self.n_gba_applied = 0
        self.last_gba_solver = None   # "dense", "dense+lines", "cg" or "sharded_cg"
        # Asynchronous global BA (the reference's detached global-BA
        # thread): (pack, future, kf_valid at pack time) of the one solve
        # whose result will be applied; superseded solves' futures are
        # kept until read.
        self.gba_async = False
        self._pending_gba = None
        self._superseded_gba: list = []
        self.n_gba_superseded = 0
        self._gba_worker: Worker | None = None
        # Asynchronous detection (the reference's LoopClosing thread): a
        # loop the worker accepts is parked in _pending_loop as (kf, gen,
        # cand, cand_gen, sim, count) and corrected on the tracking thread.
        self.async_detect = False
        self._worker: Worker | None = None
        self._detections: list = []          # futures of the submitted detection jobs
        self._pending_loop = None
        self._pending_loop_ms: dict = {}     # the parked loop's detect and sim3 ms
        self._db_lock = threading.Lock()     # the keyframe database and consistency groups

    def _t(self, a) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # ------------------------------------------------------------------
    def _on_kf_culled(self, k: int, parent: int):
        with self._db_lock:
            self.db.erase(k)
            self.consistent_groups = [
                (g - {k}, c) for g, c in self.consistent_groups if g - {k}
            ]
        if self._pending_bow is not None and self._pending_bow[0] == k:
            self._pending_bow = None

    # ------------------------------------------------------------------
    def process_keyframe(self, kf_id: int, run_gba: bool = True) -> bool:
        """Dispatch kf_id's BoW transform; detect + close a loop ending
        at the PREVIOUS keyframe (whose words were dispatched one
        keyframe ago).  With ``async_detect``, apply a loop the worker has
        parked, then hand kf_id to the worker.  Returns True if a loop was
        closed (the map was rewritten); `last_closed_kf` then names the
        corrected keyframe."""
        store = self.map
        self.kf_counter += 1
        if self.async_detect:
            # Map mutation stays on this thread.
            applied = self._apply_pending(run_gba)
            self._check_detections()
            if self._worker is None or not self._worker.is_alive():
                self._worker = Worker("loop-closing", self.device)
            self._detections.append(
                self._worker.submit(self._detect_job, kf_id, int(store.kf_gen[kf_id]), self.kf_counter))
            return applied
        valid = store.kf_feat_valid[kf_id] & (store.kf_obs_lm[kf_id] >= 0)
        prev = self._pending_bow
        self._pending_bow = (
            kf_id, int(store.kf_gen[kf_id]),
            self.voc.dispatch_transform(self._t(store.kf_desc[kf_id])), valid,
        )
        return self._process_resolved(prev, run_gba)

    # ------------------------------------------------------------------
    # the detection worker (the reference's LoopClosing thread)
    # ------------------------------------------------------------------
    def _detect_job(self, kf_id: int, gen: int, count: int):
        """Worker side: BoW transform, index insert, detection and the
        Sim3 chain.  Read-only on the map; parks an accepted loop."""
        store = self.map
        with store.lock:
            if not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen:
                return
            valid = store.kf_feat_valid[kf_id] & (store.kf_obs_lm[kf_id] >= 0)
            desc = store.kf_desc[kf_id].copy()
        words = self.voc.dispatch_transform(self._t(desc)).cpu().numpy()
        with self._db_lock:
            if not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen:
                return
            self.db.add_words(kf_id, words, valid)
        if (
            store.n_keyframes() < 6
            or count - self.last_loop_count < 10
            or self._pending_loop is not None
        ):
            return
        t0 = time.perf_counter()
        with store.lock, self._db_lock:
            cand = self._detect(kf_id)
        t1 = time.perf_counter()
        self.timing.add("detect", t1 - t0)
        if cand is None or not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen:
            return
        with store.lock:
            cand_gen = int(store.kf_gen[cand])
            view = _MapSnapshot(store, (kf_id, cand))
        ok, sim = self._compute_sim3(kf_id, cand, view=view)
        t2 = time.perf_counter()
        self.timing.add("sim3", t2 - t1)
        if ok:
            self._pending_loop_ms = {"detect": (t1 - t0) * 1e3, "sim3": (t2 - t1) * 1e3}
            self._pending_loop = (kf_id, gen, cand, cand_gen, sim, count)

    def _check_detections(self):
        """Read the finished detection jobs' futures in order: a job's
        exception is raised here, on the tracking thread."""
        while self._detections and self._detections[0].done():
            self._detections.pop(0).result()

    def _apply_pending(self, run_gba: bool) -> bool:
        """Tracking-thread side: correct a worker-detected loop (the
        map-rewriting half of CorrectLoop), unless either keyframe was
        culled or its slot recycled since the detection."""
        p = self._pending_loop
        if p is None:
            return False
        self._pending_loop = None
        kf_id, gen, cand, cand_gen, sim, _count = p
        store = self.map
        if (
            not store.kf_valid[kf_id] or store.kf_gen[kf_id] != gen
            or not store.kf_valid[cand] or store.kf_gen[cand] != cand_gen
        ):
            return False
        before = dict(self.timing.acc)
        with store.lock:
            self._correct(kf_id, cand, sim, run_gba=run_gba)
        self.closure_ms.append({"kf": int(kf_id), **self._pending_loop_ms, **{
            k: (self.timing.acc[k] - before.get(k, 0.0)) * 1e3 for k in ("correct", "essential_graph", "gba")
            if k in self.timing.acc}})
        self.last_loop_count = self.kf_counter
        self.last_closed_kf = kf_id
        return True

    def stop(self):
        """End the worker threads (each finishes its queued jobs first)."""
        for worker in (self._worker, self._gba_worker):
            if worker is not None:
                worker.stop()

    def flush(self, run_gba: bool = True) -> bool:
        """Drain the pending keyframe's detection (shutdown / end of
        sequence).  With ``async_detect``: wait for the worker, apply a
        parked loop, then raise a detection job's exception, if any."""
        if self.async_detect:
            if self._worker is not None:
                self._worker.join()
            applied = self._apply_pending(run_gba)
            self._check_detections()
            return applied
        prev = self._pending_bow
        self._pending_bow = None
        return self._process_resolved(prev, run_gba)

    def _process_resolved(self, prev, run_gba: bool) -> bool:
        store = self.map
        if prev is None:
            return False
        pkf, pgen, words_dev, pvalid = prev
        if not store.kf_valid[pkf] or store.kf_gen[pkf] != pgen:
            return False  # culled while pending
        self.db.add_words(pkf, words_dev.cpu().numpy(), pvalid)
        if (
            store.n_keyframes() < 6
            or self.kf_counter - self.last_loop_count < 10
        ):
            return False

        before = dict(self.timing.acc)
        with self.timing.stage("detect"):
            cand = self._detect(pkf)
        if cand is None:
            return False
        with self.timing.stage("sim3"):
            ok, sim = self._compute_sim3(pkf, cand)
        if not ok:
            return False
        self._correct(pkf, cand, sim, run_gba=run_gba)
        self.closure_ms.append({"kf": int(pkf), **{
            k: (v - before.get(k, 0.0)) * 1e3 for k, v in self.timing.acc.items()}})
        self.last_loop_count = self.kf_counter
        self.last_closed_kf = pkf
        return True

    # ------------------------------------------------------------------
    def _covisible_set(self, kf_id, min_w=15):
        W = self.map.covisibility()
        ids = np.nonzero(W[kf_id] >= min_w)[0]
        return set(int(i) for i in ids)

    def _detect(self, kf_id):
        """BoW candidates + consistency over 3 consecutive keyframes."""
        covis = self._covisible_set(kf_id)
        # minScore: lowest BoW similarity among covisible KFs.
        min_score = 0.008
        scores = [
            self.db.score(kf_id, k) for k in covis if k in self.db.bow
        ]
        if scores:
            min_score = max(min(scores), 0.001)
        group_cache: dict[int, set] = {}

        def covis_group(k):
            if k not in group_cache:
                group_cache[k] = self._covisible_set(k) | {k}
            return group_cache[k]

        cands = self.db.detect_loop_candidates(
            kf_id, min_score, covis | {kf_id}, covis_group
        )
        if not cands:
            self.consistent_groups = []
            return None

        # Covisibility-consistency over 3 consecutive KFs
        # (LoopClosing::DetectLoop's mvConsistentGroups logic).
        new_groups = []
        winner = None
        for c in cands:
            group = covis_group(c)
            consistency = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    consistency = prev_count + 1
                    break
            new_groups.append((group, consistency))
            if consistency >= 2 and winner is None:
                winner = c
        self.consistent_groups = new_groups
        return winner

    # ------------------------------------------------------------------
    def _compute_sim3(self, kf_id, cand, view=None):
        """Match landmarks between the two keyframes, RANSAC a Sim3
        T_{cur<-cand} in camera frames.  `view` (the detection worker) is
        a _MapSnapshot, so every read sees one consistent map state."""
        store = view if view is not None else self.map
        dev = self.device
        cur_lm = store.kf_obs_lm[kf_id]
        cand_lm = store.kf_obs_lm[cand]
        v_cur = (cur_lm >= 0) & store.kf_feat_valid[kf_id]
        v_cand = (cand_lm >= 0) & store.kf_feat_valid[cand]
        m = match_descriptors(
            self._t(store.kf_desc[kf_id]), self._t(v_cur),
            self._t(store.kf_desc[cand]), self._t(v_cand),
            max_dist=50, ratio=0.75,
        )
        mask, idx = m.mask.cpu().numpy(), m.idx.cpu().numpy()
        if mask.sum() < 20:
            return False, None

        rows = np.nonzero(mask)[0]
        lm1 = cur_lm[rows]
        lm2 = cand_lm[idx[rows]]
        ok = (lm1 >= 0) & (lm2 >= 0) & store.pt_valid[lm1] & store.pt_valid[lm2]
        rows, lm1, lm2 = rows[ok], lm1[ok], lm2[ok]
        if len(rows) < 20:
            return False, None

        # 3D points in each camera frame (host math).
        R1, t1 = store.kf_R[kf_id], store.kf_t[kf_id]
        R2, t2 = store.kf_R[cand], store.kf_t[cand]
        p1 = nse3_apply(R1, t1, store.pt_pos[lm1])
        p2 = nse3_apply(R2, t2, store.pt_pos[lm2])

        N = 256
        pts1 = np.zeros((N, 3), np.float32)
        pts2 = np.zeros((N, 3), np.float32)
        valid = np.zeros(N, bool)
        n = min(len(p1), N)
        pts1[:n] = p1[:n]
        pts2[:n] = p2[:n]
        valid[:n] = True

        ones = torch.ones(N, dtype=torch.float32, device=dev)
        s, R, t, inl, count = solve_sim3_ransac(
            self._t(pts1), self._t(pts2), self._t(valid), int(kf_id),
            self.cfg.camera, self.cfg.camera, ones, ones,
            fix_scale=self.fix_scale, n_hyps=256,
        )
        if int(count) < 20:
            return False, None

        # Guided SearchBySim3 + OptimizeSim3: grow the match set by
        # projecting each keyframe's landmarks into the other with the
        # RANSAC Sim3, then refine.  Only RANSAC inlier matches seed the
        # refinement.
        keep = np.zeros(len(rows), bool)
        keep[:n] = inl.cpu().numpy()[:n]
        refined = self._refine_sim3(
            kf_id, cand, float(s), R.cpu().numpy(), t.cpu().numpy(),
            rows[keep], lm1[keep], lm2[keep], view=view,
        )
        if refined is None:
            return False, None
        return True, refined

    # ------------------------------------------------------------------
    def _refine_sim3(self, kf_id, cand, s, R, t, rows_bow, lm1_bow, lm2_bow, view=None):
        """SearchBySim3 (mutual guided matching) + optimize_sim3.
        Returns the refined (s, R, t) of T_{cur<-cand} or None if fewer
        than 20 inliers survive (the reference's acceptance bar)."""
        store = view if view is not None else self.map
        cam = self.cfg.camera
        scales = self.cfg.orb.level_scales
        T = self._t

        R1, t1 = store.kf_R[kf_id], store.kf_t[kf_id]
        R2, t2 = store.kf_R[cand], store.kf_t[cand]
        lm_cur = store.kf_obs_lm[kf_id]
        lm_cand = store.kf_obs_lm[cand]
        m_cur = (
            store.kf_feat_valid[kf_id] & (lm_cur >= 0)
            & store.pt_valid[np.clip(lm_cur, 0, None)]
        )
        m_cand = (
            store.kf_feat_valid[cand] & (lm_cand >= 0)
            & store.pt_valid[np.clip(lm_cand, 0, None)]
        )
        # Landmarks in each keyframe's own camera frame.
        p_cur = nse3_apply(R1, t1, store.pt_pos[np.clip(lm_cur, 0, None)])
        p_cand = nse3_apply(R2, t2, store.pt_pos[np.clip(lm_cand, 0, None)])
        # cand landmarks into cur's frame via S12; cur's into cand via S21.
        si, Ri, ti = nsim3_inverse(s, R, t)
        p_cand_in_cur = nsim3_apply(s, R, t, p_cand)
        p_cur_in_cand = nsim3_apply(si, Ri, ti, p_cur)

        desc_cur, desc_cand = T(store.kf_desc[kf_id]), T(store.kf_desc[cand])
        mc_cur, mc_cand = T(m_cur), T(m_cand)
        mA = search_by_sim3_dir(
            T(p_cand_in_cur.astype(np.float32)), desc_cand, mc_cand,
            T(store.kf_xy[kf_id]), desc_cur, T(store.kf_oct[kf_id]), mc_cur, cam, scales,
        )
        mB = search_by_sim3_dir(
            T(p_cur_in_cand.astype(np.float32)), desc_cur, mc_cur,
            T(store.kf_xy[cand]), desc_cand, T(store.kf_oct[cand]), mc_cand, cam, scales,
        )
        idxA, idxB, maskA = mA.idx.cpu().numpy(), mB.idx.cpu().numpy(), mA.mask.cpu().numpy()
        cand_rows = np.nonzero(maskA)[0]
        cur_of = idxA[cand_rows]
        mutual = (cur_of >= 0) & (idxB[np.clip(cur_of, 0, None)] == cand_rows)
        pairs_cur = cur_of[mutual]
        pairs_cand = cand_rows[mutual]

        # Union with the BoW/RANSAC matches (cur row, cand landmark),
        # keyed by cur feature row to avoid duplicates.
        cand_row_of_lm = np.full(store.pt_pos.shape[0], -1, np.int64)
        cand_row_of_lm[lm_cand[m_cand]] = np.nonzero(m_cand)[0]
        seen = set(pairs_cur.tolist())
        add_cur, add_cand = [], []
        for r_cur, l2 in zip(rows_bow, lm2_bow):
            rc = cand_row_of_lm[l2]
            if rc >= 0 and int(r_cur) not in seen:
                add_cur.append(int(r_cur))
                add_cand.append(int(rc))
                seen.add(int(r_cur))
        all_cur = np.concatenate([pairs_cur, np.asarray(add_cur, np.int64)])
        all_cand = np.concatenate([pairs_cand, np.asarray(add_cand, np.int64)])
        if len(all_cur) < 20:
            return None

        N = 512
        n = min(len(all_cur), N)
        pts1 = np.zeros((N, 3), np.float32)
        pts2 = np.zeros((N, 3), np.float32)
        obs1 = np.zeros((N, 2), np.float32)
        obs2 = np.zeros((N, 2), np.float32)
        s2_1 = np.ones(N, np.float32)
        s2_2 = np.ones(N, np.float32)
        valid = np.zeros(N, bool)
        sc = np.asarray(scales, np.float32)
        pts1[:n] = p_cur[all_cur[:n]]
        pts2[:n] = p_cand[all_cand[:n]]
        obs1[:n] = store.kf_xy[kf_id][all_cur[:n]]
        obs2[:n] = store.kf_xy[cand][all_cand[:n]]
        s2_1[:n] = sc[np.clip(store.kf_oct[kf_id][all_cur[:n]], 0, len(sc) - 1)] ** 2
        s2_2[:n] = sc[np.clip(store.kf_oct[cand][all_cand[:n]], 0, len(sc) - 1)] ** 2
        valid[:n] = True

        res = optimize_sim3(
            torch.tensor(s, dtype=torch.float32, device=self.device),
            T(np.asarray(R, np.float32)), T(np.asarray(t, np.float32)),
            T(pts1), T(pts2), T(obs1), T(obs2), T(s2_1), T(s2_2), T(valid),
            cam, cam, fix_scale=self.fix_scale,
        )
        if int(res.n_inliers) < 20:
            return None
        return float(res.s), res.R.cpu().numpy(), res.t.cpu().numpy()

    # ------------------------------------------------------------------
    def _correct(self, kf_id, cand, sim, run_gba=True):
        """Propagate the Sim3 correction, fuse, optimize the essential
        graph, optionally run global BA."""
        # Land outstanding mapping work first (the reference pauses
        # LocalMapping and drains its queue before CorrectLoop): jobs
        # dispatched against pre-correction poses would otherwise be
        # discarded by the pose-epoch guard.
        if self.pre_correct_hook is not None:
            self.pre_correct_hook()
        with self.timing.stage("correct"):
            pre_R, pre_t, W_pre = self._correct_group(kf_id, cand, sim)
        # --- essential-graph optimization over all valid KFs ---
        with self.timing.stage("essential_graph"):
            self._optimize_essential_graph(kf_id, cand, pre_R=pre_R, pre_t=pre_t, W_pre=W_pre)
        if run_gba:
            with self.timing.stage("gba"):
                if self.gba_async:
                    # A newer loop supersedes the pending global BA (the
                    # reference's mbStopGBA): its result is never applied.
                    if self._pending_gba is not None:
                        self._superseded_gba.append(self._pending_gba[1])
                        self._pending_gba = None
                        self.n_gba_superseded += 1
                    self.dispatch_global_ba()
                else:
                    self.run_global_ba()

    def _correct_group(self, kf_id, cand, sim):
        """The group rewrite, search-and-fuse and the loop edge of
        ``_correct``.  Returns the pre-correction poses and covisibility
        the essential graph measures its edges from."""
        store = self.map
        s_lc, R_lc, t_lc = sim  # T_cur<-cand (camera frames)

        # Corrected pose of current KF: Scw_corr = S_cur<-cand o Tcand_w
        Rc, tc = store.kf_R[cand], store.kf_t[cand]
        s_corr, R_corr, t_corr = nsim3_compose(s_lc, R_lc, t_lc, 1.0, Rc, tc)

        # World-side correction for the current covisible group: the
        # current KF moves from its drifted Tcw to the corrected Sim3;
        # x_cam = T_old x_w ; x_w_new = S_corr^-1 x_cam.
        R_old, t_old = store.kf_R[kf_id].copy(), store.kf_t[kf_id].copy()
        # Pre-correction pose snapshot for the essential graph's edge
        # measurements (the reference's NonCorrectedSim3): tree/covis
        # edges must be measured from the drifted poses; measuring a
        # boundary edge after the group rewrite bakes the correction
        # discontinuity into the measurement and the graph optimizes to
        # a no-op.
        pre_R = store.kf_R.copy()
        pre_t = store.kf_t.copy()
        group = self._covisible_set(kf_id, min_w=10) | {kf_id}
        s_ci, R_ci, t_ci = nsim3_inverse(s_corr, R_corr, t_corr)

        lm_ids = np.unique(
            np.concatenate(
                [store.kf_obs_lm[k][store.kf_obs_lm[k] >= 0] for k in group]
            ).astype(np.int64)
        )
        lm_ids = lm_ids[store.pt_valid[lm_ids]] if len(lm_ids) else lm_ids
        if len(lm_ids):
            x_cam = nse3_apply(R_old, t_old, store.pt_pos[lm_ids])
            store.pt_pos[lm_ids] = nsim3_apply(s_ci, R_ci, t_ci, x_cam)
        # Line landmarks of the group move with the same correction.
        kf_ln_obs = getattr(store, "kf_ln_obs", None)
        if kf_ln_obs is not None:
            ln_ids = np.unique(
                np.concatenate(
                    [kf_ln_obs[k][kf_ln_obs[k] >= 0] for k in group]
                ).astype(np.int64)
            )
            ln_ids = ln_ids[store.ln_valid[ln_ids]] if len(ln_ids) else ln_ids
            for attr in ("ln_start", "ln_end"):
                if not len(ln_ids):
                    break
                arr = getattr(store, attr)
                arr[ln_ids] = nsim3_apply(
                    s_ci, R_ci, t_ci, nse3_apply(R_old, t_old, arr[ln_ids])
                )
        # poses: Tkw_new = Tk_old o T_old^-1 o S_corr
        Roi, toi = nse3_inverse(R_old, t_old)
        for k in group:
            Rrel, trel = nse3_compose(store.kf_R[k], store.kf_t[k], Roi, toi)
            sk, Rk2, tk2 = nsim3_compose(1.0, Rrel, trel, s_corr, R_corr, t_corr)
            store.kf_R[k] = Rk2
            store.kf_t[k] = tk2 / sk  # renormalize scale into t

        store.mark_all_pts_dirty()

        # --- SearchAndFuse: project the loop side's landmarks into the
        # corrected current-group keyframes and merge duplicates.  This
        # is what puts the loop constraint INTO the bundle-adjustment
        # problem: without shared observations across the loop, global
        # BA is an open-chain problem that re-introduces the drift the
        # essential graph just removed.
        #
        # Covisibility snapshot BEFORE the fuse: edges that exist only
        # because of the fusion below are cross-loop connections and
        # must be measured from CORRECTED poses in the essential graph;
        # measuring them from the drifted pre-poses bakes the loop
        # discontinuity into those measurements and the graph fights its
        # own loop edge.
        W_pre = self.map.covisibility().copy()
        cand_group = self._covisible_set(cand, min_w=5) | {cand}
        loop_lm = np.unique(
            np.concatenate(
                [store.kf_obs_lm[k][store.kf_obs_lm[k] >= 0] for k in cand_group]
            ).astype(np.int64)
        )
        loop_lm = loop_lm[store.pt_valid[loop_lm]]
        if len(loop_lm):
            scales = self.cfg.orb.level_scales
            for k in group:
                fuse_into_keyframe(
                    store, loop_lm, k, self.cfg.camera, scales, radius=4.0, device=self.device
                )

        # Record the loop edge (measurement = corrected relative pose).
        self.loop_edges.append(
            LoopEdge(
                kf_id, cand, s_lc, np.asarray(R_lc), np.asarray(t_lc),
                gen_a=int(store.kf_gen[kf_id]), gen_b=int(store.kf_gen[cand]),
            )
        )
        return pre_R, pre_t, W_pre

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, cur_kf, loop_kf, pre_R=None,
                                  pre_t=None, W_pre=None):
        """Sim3 pose graph over the essential graph: parent-child
        spanning tree + strong covisibility (>=100 shared landmarks) +
        validated loop edges.  Slot ids carry no temporal meaning
        (recycling), so tree fallbacks order by kf_frame_id, never by
        slot index."""
        store = self.map
        Kn = store._next_kf
        valid = store.kf_valid[:Kn].copy()
        ids = np.nonzero(valid)[0]
        if len(ids) < 3:
            return
        W = store.covisibility()

        edges_i, edges_j = [], []
        # Spanning-tree edges: each keyframe to its parent.  Orphans
        # chain to the temporally previous keyframe so the graph stays
        # connected.
        order = ids[np.argsort(store.kf_frame_id[ids], kind="stable")]
        pos_in_order = {int(k): i for i, k in enumerate(order)}
        for b in ids:
            a = int(store.kf_parent[b])
            if a < 0 or a == b or not (0 <= a < Kn) or not valid[a]:
                i = pos_in_order[int(b)]
                if i == 0:
                    continue  # the temporal root has no parent edge
                a = int(order[i - 1])
            edges_i.append(a)
            edges_j.append(int(b))
        n_tree = len(edges_i)
        # strong covisibility edges (dedup against the tree)
        tree = set(zip(edges_i, edges_j))
        sub = W[np.ix_(ids, ids)] >= 100
        ai, bi = np.nonzero(np.triu(sub, k=1))
        for a, b in zip(ids[ai], ids[bi]):
            a, b = int(a), int(b)
            if (a, b) not in tree and (b, a) not in tree:
                edges_i.append(a)
                edges_j.append(b)
        # Loop edges, generation-validated: an edge whose endpoint slot
        # was recycled would constrain an unrelated keyframe.
        live_edges = [
            e for e in self.loop_edges
            if 0 <= e.kf_a < Kn and 0 <= e.kf_b < Kn
            and valid[e.kf_a] and valid[e.kf_b]
            and store.kf_gen[e.kf_a] == e.gen_a
            and store.kf_gen[e.kf_b] == e.gen_b
        ]
        for e in live_edges:
            edges_i.append(e.kf_b)
            edges_j.append(e.kf_a)

        E = len(edges_i)
        es = np.ones(E, np.float32)
        eR = np.zeros((E, 3, 3), np.float32)
        et = np.zeros((E, 3), np.float32)
        n_loop = len(live_edges)
        for n, (a, b) in enumerate(zip(edges_i, edges_j)):
            if n >= E - n_loop:
                le = live_edges[n - (E - n_loop)]
                eR[n] = le.R
                et[n] = le.t
                es[n] = le.s
                continue
            # Measurements from the PRE-correction poses when given;
            # within the corrected group the rigid rewrite preserves
            # relatives, so only boundary edges differ.  Covisibility
            # edges NEW since the loop fuse measure from the CORRECTED
            # poses instead.
            mR = store.kf_R if pre_R is None else pre_R
            mt = store.kf_t if pre_t is None else pre_t
            if (
                W_pre is not None
                and a < W_pre.shape[0] and b < W_pre.shape[0]
                and W_pre[a, b] < 100
                and n >= n_tree
            ):
                mR, mt = store.kf_R, store.kf_t
            Rm, tm = nse3_relative(mR[b], mt[b], mR[a], mt[a])
            eR[n] = Rm
            et[n] = tm

        # K is the keyframe table's capacity: slot ids index it.
        K = store.kf_R.shape[0]
        valid = store.kf_valid[:K].copy()
        fixed = np.zeros(K, bool)
        fixed[loop_kf] = True
        fixed[~valid] = True
        old_R = store.kf_R[:K].copy()
        old_t = store.kf_t[:K].copy()

        T = self._t
        s, R, t = (x.cpu().numpy() for x in optimize_pose_graph(
            T(np.ones(K, np.float32)), T(store.kf_R[:K]), T(store.kf_t[:K]),
            T(valid), T(fixed),
            T(np.array(edges_i, np.int64)), T(np.array(edges_j, np.int64)),
            T(es), T(eR), T(et),
            torch.ones(E, dtype=torch.bool, device=self.device),
            torch.ones(E, dtype=torch.float32, device=self.device),
            n_iters=20,
        ))

        # Correct landmarks via their reference keyframe's motion, one
        # batched einsum over all landmarks.
        pt_ids = np.nonzero(store.pt_valid)[0]
        fk = store.pt_first_kf[pt_ids]
        ok = (fk >= 0) & (fk < K) & valid[np.clip(fk, 0, K - 1)]
        pt_ids, fk = pt_ids[ok], fk[ok]
        if len(pt_ids):
            x_cam = (
                np.einsum("pij,pj->pi", old_R[fk], store.pt_pos[pt_ids])
                + old_t[fk]
            )
            t_new = t[fk] / s[fk][:, None]
            store.pt_pos[pt_ids] = np.einsum(
                "pi,pij->pj", x_cam - t_new, R[fk]
            ).astype(np.float32)
        # Line endpoints ride their first keyframe's motion likewise.
        ln_ids = np.nonzero(store.ln_valid)[0]
        lfk = store.ln_first_kf[ln_ids]
        ok = (lfk >= 0) & (lfk < K) & valid[np.clip(lfk, 0, K - 1)]
        ln_ids, lfk = ln_ids[ok], lfk[ok]
        if len(ln_ids):
            t_new = t[lfk] / s[lfk][:, None]
            for attr in ("ln_start", "ln_end"):
                arr = getattr(store, attr)
                x_cam = (
                    np.einsum("pij,pj->pi", old_R[lfk], arr[ln_ids])
                    + old_t[lfk]
                )
                arr[ln_ids] = np.einsum(
                    "pi,pij->pj", x_cam - t_new, R[lfk]
                ).astype(np.float32)

        store.kf_R[:K] = R
        store.kf_t[:K] = t / s[:, None]
        store.mark_all_pts_dirty()

    # ------------------------------------------------------------------
    def run_global_ba(self, iters1: int = 12, iters2: int = 0):
        """Full-map bundle adjustment, synchronous.  Like the
        reference's loop-closure global BA this is a SINGLE robust stage
        (Huber throughout, no mid-way chi2 erasure): the post-loop map
        has honest large residuals in the drifted region, and the
        local-BA two-stage gate strips low-support keyframes bare there
        and lets them diverge.  Outlier observations are NOT erased at
        apply for the same reason."""
        out = self._dispatch_gba(iters1, iters2)
        if out is None:
            return
        pack, res = out
        self._apply_gba(pack, res, snap_valid=self.map.kf_valid.copy())
        self.n_gba_applied += 1

    def dispatch_global_ba(self, iters1: int = 12, iters2: int = 0):
        """Pack the global BA here and solve it on the global-BA worker;
        a later poll_global_ba() applies it."""
        out = self._pack_gba(iters1, iters2)
        if out is None:
            return
        pack, problem = out
        if self._gba_worker is None or not self._gba_worker.is_alive():
            self._gba_worker = Worker("global-ba", self.device)
        self._pending_gba = (pack, self._gba_worker.submit(self._solve_gba, problem), self.map.kf_valid.copy())

    def poll_global_ba(self, force: bool = False) -> bool:
        """Apply the pending global BA if its solve has finished (waiting
        for it with force=True).  Returns True if applied; a solve's
        exception, superseded solves' included, is raised here."""
        while self._superseded_gba and (force or self._superseded_gba[0].done()):
            self._superseded_gba.pop(0).result()
        if self._pending_gba is None:
            return False
        pack, fut, snap_valid = self._pending_gba
        if not force and not fut.done():
            return False
        self._pending_gba = None
        res, seconds = fut.result()
        self.timing.add("gba_worker", seconds)
        with self.map.lock:
            self._apply_gba(pack, res, snap_valid)
        self.n_gba_applied += 1
        return True

    def _apply_gba(self, pack, res, snap_valid: np.ndarray):
        """Write back the global-BA solution; keyframes that were not in
        the solved snapshot are corrected through the spanning chain, and
        landmarks outside the problem through their first keyframe's
        motion."""
        store = self.map
        Kn = store._next_kf
        if snap_valid.shape[0] < Kn:  # keyframe axis grew since the snapshot
            snap_valid = np.pad(snap_valid, (0, Kn - snap_valid.shape[0]))
        old_R = store.kf_R[:Kn].copy()
        old_t = store.kf_t[:Kn].copy()
        store.apply_ba_result(pack, res, erase_outliers=False)
        # Keyframes valid now but not at the snapshot: T_k_new = (T_k_old
        # o T_p_old^-1) o T_p_new with p the spanning-tree parent (falls
        # back to the nearest live earlier KF).
        fresh = np.nonzero(
            store.kf_valid[:Kn] & ~snap_valid[:Kn]
        )[0]
        solved = np.nonzero(store.kf_valid[:Kn] & snap_valid[:Kn])[0]
        solved_fids = store.kf_frame_id[solved]
        for k in fresh:
            p = int(store.kf_parent[k])
            if p < 0 or not store.kf_valid[p] or snap_valid.shape[0] <= p or not snap_valid[p]:
                # Temporally previous SOLVED keyframe (order by frame id).
                earlier = solved[solved_fids < store.kf_frame_id[k]]
                if len(earlier) == 0:
                    continue
                p = int(earlier[np.argmax(store.kf_frame_id[earlier])])
            R_rel = old_R[k] @ old_R[p].T
            t_rel = old_t[k] - R_rel @ old_t[p]
            store.kf_R[k] = (R_rel @ store.kf_R[p]).astype(np.float32)
            store.kf_t[k] = (R_rel @ store.kf_t[p] + t_rel).astype(np.float32)
        # Joint point+line solves carry optimized line geometry.
        lpack = pack.get("_lpack")
        skip_lines = None
        if lpack is not None and hasattr(res, "line_U"):
            store.apply_line_ba_result(lpack, res.line_U, res.line_w, res.lobs_inlier)
            skip_lines = np.zeros(store.L, bool)
            skip_lines[lpack["ln_ids"]] = True
        # Landmarks outside the solved problem ride their first KF.
        in_pack = np.zeros(store.P, bool)
        in_pack[pack["lm_ids"]] = True
        self._ride_first_kf(
            old_R, old_t, Kn, skip_points=in_pack, skip_lines=skip_lines
        )
        store.mark_all_pts_dirty()

    def _ride_first_kf(self, old_R, old_t, Kn, skip_points=None,
                       skip_lines=None):
        """Re-anchor landmarks to their first keyframe's corrected pose:
        x_new = T_fk_new^-1 (T_fk_old x_old).  Applied to points (unless
        masked) and to all line endpoints not masked (lines are not
        variables in the point-only global problems)."""
        store = self.map

        def ride(arr, ids, fk):
            x_cam = np.einsum("pij,pj->pi", old_R[fk], arr[ids]) + old_t[fk]
            # R^T (x - t) per row
            arr[ids] = np.einsum(
                "pji,pj->pi", store.kf_R[fk], x_cam - store.kf_t[fk]
            ).astype(np.float32)

        pt_ids = np.nonzero(store.pt_valid)[0]
        if skip_points is not None:
            pt_ids = pt_ids[~skip_points[pt_ids]]
        fk = store.pt_first_kf[pt_ids]
        ok = (fk >= 0) & (fk < Kn) & store.kf_valid[np.clip(fk, 0, Kn - 1)]
        if ok.any():
            ride(store.pt_pos, pt_ids[ok], fk[ok])

        ln_ids = np.nonzero(store.ln_valid)[0]
        if skip_lines is not None:
            ln_ids = ln_ids[~skip_lines[ln_ids]]
        lfk = store.ln_first_kf[ln_ids]
        ok = (lfk >= 0) & (lfk < Kn) & store.kf_valid[np.clip(lfk, 0, Kn - 1)]
        if ok.any():
            ride(store.ln_start, ln_ids[ok], lfk[ok])
            ride(store.ln_end, ln_ids[ok], lfk[ok])

    def _dispatch_gba(self, iters1: int = 5, iters2: int = 10):
        """Pack and solve the full-map BA problem; returns (pack, host
        result), or None with fewer than two keyframes."""
        out = self._pack_gba(iters1, iters2)
        if out is None:
            return None
        pack, problem = out
        return pack, self._solve_gba(problem)[0]

    def _pack_gba(self, iters1: int, iters2: int):
        """The full-map BA problem, on the host: (pack, problem), where
        the problem holds the solver's numpy inputs.

        Small maps use the dense-block Schur solver (jointly with the
        line landmarks when the map has any); past the point where its
        [P, C, 6, 3] coupling tensor would exceed 256 MB at the
        configured capacity, matrix-free CG on the Schur complement
        (backend/global_ba.py) takes over, so the full map is optimized
        with no landmark or observation truncation; on a mesh of more
        than one shard the CG runs landmark-sharded ("sharded_cg").  The
        problem is packed at capacity (which fixes what is selected) and
        trimmed to the live counts for the device."""
        store = self.map
        Kn = store._next_kf
        ids = np.nonzero(store.kf_valid[:Kn])[0]
        if len(ids) < 2:
            return None
        mc = self.cfg.map
        n_cams = max(mc.max_keyframes, -(-len(ids) // 32) * 32)
        n_pts = mc.max_points
        n_obs = n_cams * 1024
        use_cg = n_cams * n_pts * 18 * 4 > 256 * 1024 * 1024
        pack = store.pack_local_ba(
            int(ids[-1]), max_cams=n_cams, max_points=n_pts, max_obs=n_obs, all_free=True,
        )
        if use_cg and self.mesh.n_shards > 1:
            return pack, self._sharded_problem(pack, iters1, iters2)
        C = len(pack["cam_ids"])
        problem = {"iters": (iters1, iters2), "args": self._live_args(pack)}
        if use_cg:
            self.last_gba_solver = problem["solver"] = "cg"
            problem["cg_iters"] = min(6 * n_cams, 64)
            return pack, problem
        # Dense path: when the map carries line landmarks, global BA
        # optimizes them jointly; the CG path rides lines on their first
        # keyframe's motion.
        lpack = None
        if store.Lf and bool(store.ln_valid.any()):
            lpack = store.pack_line_obs(
                pack["cam_ids"], max_lines=mc.max_lines, max_lobs=mc.max_lines * 8,
            )
        if lpack is not None:
            ids_l = lpack["ln_ids"]
            Lc, Ol = len(ids_l), max(int(lpack["n_lobs"]), 1)
            s_w = np.zeros((Lc, 3), np.float32)
            e_w = np.ones((Lc, 3), np.float32)
            lval = np.zeros(Lc, bool)
            s_w[: len(ids_l)] = store.ln_start[ids_l]
            e_w[: len(ids_l)] = store.ln_end[ids_l]
            lval[: len(ids_l)] = True
            U0, w0 = northonormal_from_pluecker(*npluecker_from_endpoints(s_w, e_w))
            fixed0 = pack["cam_fixed"][:C].copy()
            fixed0[0] = True
            self.last_gba_solver = problem["solver"] = "dense+lines"
            problem["fixed0"] = fixed0
            problem["lines"] = (U0.astype(np.float32), w0.astype(np.float32), lval,
                                *(lpack[k][:Ol] for k in ("lobs_cam", "lobs_ln", "lobs_a", "lobs_b")),
                                np.zeros(Ol, np.int32), lpack["lobs_valid"][:Ol])
            pack["_lpack"] = lpack
            return pack, problem
        self.last_gba_solver = problem["solver"] = "dense"
        return pack, problem

    @staticmethod
    def _live_args(pack):
        """The point solvers' inputs of a capacity pack, trimmed to its
        live keyframe, landmark and observation counts."""
        C, P, O = len(pack["cam_ids"]), max(len(pack["lm_ids"]), 1), max(int(pack["n_obs"]), 1)
        cut = {"R": C, "t": C, "cam_fixed": C, "points": P, "point_valid": P}
        return tuple(pack[k][: cut.get(k, O)] for k in _POINT_KEYS)

    def _sharded_problem(self, pack, iters1: int, iters2: int):
        """The landmark-sharded CG problem of a capacity pack: live counts,
        the sharded solver's gauge (``sharded_gauge`` of the capacity
        pack's fixed flags) and its CG iterations, min(6 C, 64) at the
        pack's camera capacity."""
        args = list(self._live_args(pack))
        args[2] = sharded_gauge(pack["cam_fixed"])[: len(pack["cam_ids"])]
        self.last_gba_solver = "sharded_cg"
        return {"solver": "sharded_cg", "iters": (iters1, iters2), "args": tuple(args),
                "cg_iters": min(6 * pack["R"].shape[0], 64)}

    def _dispatch_gba_sharded(self, pack, iters1: int, iters2: int):
        """Solve a capacity pack's global BA landmark-sharded over the
        closer's mesh, here; returns the host result in pack order (live
        counts)."""
        return self._solve_gba(self._sharded_problem(pack, iters1, iters2))[0]

    def _solve_sharded(self, args, iters1: int, iters2: int, cg_iters: int) -> BAResult:
        """``sharded_ba.distributed_ba_cg`` over the mesh, its result mapped
        back to the order of ``args`` (the live pack)."""
        sharded, meta = shard_gba_pack(dict(zip(_POINT_KEYS, args)), self.mesh.n_shards)
        R, t, pts, inl, chi2 = distributed_ba_cg(
            self.mesh, self.cfg.camera, *sharded, scale_factor=self.cfg.orb.scale_factor,
            iters1=iters1, iters2=iters2, cg_iters=cg_iters)
        points, obs_inlier = unshard_result(pts.cpu().numpy(), inl.cpu().numpy(), meta, len(args[5]))
        return BAResult(R.cpu().numpy(), t.cpu().numpy(), points, obs_inlier, chi2.cpu().numpy())

    def _solve_gba(self, problem):
        """Upload, solve and fetch a packed full-map BA problem, on the
        calling thread (the global-BA worker when asynchronous).  Returns
        (host result, seconds)."""
        t0 = time.perf_counter()
        iters1, iters2 = problem["iters"]
        if problem["solver"] == "sharded_cg":
            return self._solve_sharded(problem["args"], iters1, iters2, problem["cg_iters"]), time.perf_counter() - t0
        T = self._t
        args = tuple(T(a) for a in problem["args"])
        cam, sf = self.cfg.camera, self.cfg.orb.scale_factor
        if problem["solver"] == "cg":
            res = bundle_adjust_cg(*args, cam, sf, iters1=iters1, iters2=iters2, fix_first=True,
                                   cg_iters=problem["cg_iters"])
        elif problem["solver"] == "dense+lines":
            res = bundle_adjust_pl(args[0], args[1], T(problem["fixed0"]), *args[3:10],
                                   *(T(a) for a in problem["lines"]), cam, sf, iters1=iters1, iters2=iters2)
        else:
            res = bundle_adjust(*args, cam, sf, iters1=iters1, iters2=iters2, fix_first=True)
        return type(res)(*(x.cpu().numpy() for x in res)), time.perf_counter() - t0
