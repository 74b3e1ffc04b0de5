"""System facade — the embedder-facing API.

Port of ``orb_line_slam_tpu/pipeline/system.py``: the constructor and
its schedule (31-69), ``track_stereo``, ``track_monocular`` and
``track_rgbd`` (116-134), ``_on_keyframe`` (137-206: the vocabulary
trained on the fly from the first keyframes' descriptors, the
``LoopCloser`` with its switches, a free scale on a monocular map, and
``pre_correct_hook``, the pending global BA polled before each keyframe,
the tracker's pose reset after a closure), ``_reloc_candidates``
(208-217), the localization mode (220-228), ``reset`` (230-235),
``shutdown`` (237-247), the trajectory writers (250-271),
``tracking_state`` and ``map`` (274-279).

``System(settings)`` runs the JAX package's default schedule: deferred
local mapping (``tracker.async_mapping``), loop detection and the Sim3
chain on a worker thread (``async_loop``) and the global BA solved on
another (``gba_async``), on the CUDA card.  Every comparison with the
pinned JAX schedule (``bench.py:269-276``) pins all three:
``System(..., async_loop=False)``, ``gba_async = False``,
``tracker.async_mapping = False``.  Stereo tracking runs with points and,
under the default ``LineConfig(enabled=True)``, lines; monocular and
RGB-D tracking with points only, as in the reference.  Not ported: the
warmups (there is nothing to compile ahead of time).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig, load_settings
from ..eval.trajectory import save_trajectory_kitti, save_trajectory_tum
from ..frontend.frame import build_rgbd_frame
from ..loop.loop_closing import LoopCloser
from ..loop.vocabulary import Vocabulary
from ..utils.timing import Tracer
from .tracking import Tracker, checked_device


class System:
    def __init__(self, settings: SlamConfig | str | Path,
                 vocabulary: Vocabulary | str | Path | None = None,
                 use_loop_closing: bool = True, async_loop: bool = True, *,
                 device: str | torch.device = "cuda"):
        self.cfg = settings if isinstance(settings, SlamConfig) else load_settings(settings)
        self.device = checked_device(device)
        # The one tracer of the tracker's and the loop closer's timers:
        # spans while enabled, counters of the System's life.
        self.tracer = Tracer()
        self.tracker = Tracker(self.cfg, self.device, self.tracer)
        self.voc: Optional[Vocabulary] = None
        if isinstance(vocabulary, Vocabulary):
            self.voc = vocabulary
        elif vocabulary is not None:
            self.voc = Vocabulary.parse_orbvoc_txt(vocabulary)
        self.use_loop_closing = use_loop_closing
        # Loop detection + Sim3 on a worker thread; corrections apply at
        # keyframe events on the tracking thread.
        self.async_loop = async_loop
        self.loop_closer: Optional[LoopCloser] = None
        self.localization_only = False
        self.n_loops_closed = 0
        # Global BA packed at the closure, solved on a worker and applied
        # at a later keyframe event (the reference's detached GBA thread).
        self.gba_async = True
        self._voc_corpus: list[np.ndarray] = []
        self.tracker.on_keyframe = self._on_keyframe

    def track_stereo(self, img_left, img_right, timestamp: float = 0.0) -> np.ndarray:
        """Feed a rectified stereo pair (uint8 [H, W]); returns the 4x4 Tcw."""
        return self.tracker.process_stereo(img_left, img_right, timestamp)

    def track_monocular(self, img, timestamp: float = 0.0) -> np.ndarray:
        """Feed one grayscale image (uint8 [H, W]); returns the 4x4 Tcw,
        the identity until monocular initialization succeeds
        (System::TrackMonocular)."""
        return self.tracker.process_mono(img, timestamp)

    def track_rgbd(self, img, depth, timestamp: float = 0.0) -> np.ndarray:
        """Feed a grayscale image (uint8 [H, W]) and its registered depth
        map (float32 [H, W], m); returns the 4x4 Tcw (System::TrackRGBD)."""
        tr = self.tracker
        with tr._next_frame():
            with tr.timing.stage("upload"):
                img, depth = tr._to_device(img), tr._to_device(depth)
            with tr.timing.stage("frontend"):
                frame = build_rgbd_frame(img, depth, self.cfg)
            return tr._track(frame, None, timestamp)

    # ------------------------------------------------------------------
    def _on_keyframe(self, kf_id: int):
        if self.localization_only or not self.use_loop_closing:
            return
        if self.voc is None:
            # Train a vocabulary on the fly: accumulate the first few
            # keyframes' descriptors so the tree sees real appearance
            # diversity instead of one view.
            store = self.tracker.map
            descs = store.kf_desc[kf_id][store.kf_feat_valid[kf_id]]
            if len(descs):
                self._voc_corpus.append(descs)
            total = sum(len(d) for d in self._voc_corpus)
            if total < 600 and len(self._voc_corpus) < 3:
                return
            corpus = np.concatenate(self._voc_corpus)[:20000]
            # depth 4 -> 10^4 leaves: a 10^3-word tree aliases heavily on
            # self-similar scenes (a failing Sim3 attempt at nearly every
            # keyframe, wrong winners at true revisits).
            with self.tracker.timing.stage("vocab_train"):
                self.voc = Vocabulary.train(corpus, k=10, depth=4, seed=0)
            self._voc_corpus = []
        if self.loop_closer is None:
            self.loop_closer = LoopCloser(self.cfg, self.tracker.map, self.voc, device=self.device,
                                          tracer=self.tracer)
            self.loop_closer.gba_async = self.gba_async
            self.loop_closer.async_detect = self.async_loop
            # A monocular map drifts in scale: the loop's Sim3 estimates it
            # (the reference's bFixScale = sensor != MONOCULAR).
            self.loop_closer.fix_scale = not self.tracker.is_mono
            self.tracker.reloc_candidates_fn = self._reloc_candidates
            self.loop_closer.pre_correct_hook = self._drain_mapping
        # Apply a finished global BA before touching the map.
        self.loop_closer.poll_global_ba()
        closed = self.loop_closer.process_keyframe(kf_id)
        if closed:
            self.n_loops_closed += 1
            # Tracking continues from the corrected keyframe pose, with no
            # motion carried across the correction.
            self.tracker.R = self.tracker.map.kf_R[kf_id].copy()
            self.tracker.t = self.tracker.map.kf_t[kf_id].copy()
            self.tracker._carry = None

    def _drain_mapping(self):
        # Reference CorrectLoop order: local mapping is drained before the
        # pose rewrite, so outstanding triangulation, fuse and BA land
        # instead of being discarded by the epoch guard.
        self.tracker.poll_map_jobs()
        self.tracker.flush_pending_ba()

    def _reloc_candidates(self, frame):
        if self.loop_closer is None:
            return []
        # The detection worker writes the inverted index concurrently.
        with self.loop_closer._db_lock:
            return self.loop_closer.db.detect_relocalization_candidates(frame.desc, frame.valid)

    # ------------------------------------------------------------------
    def activate_localization_mode(self):
        """Tracking only: no new keyframes or landmarks (the reference's
        ActivateLocalizationMode)."""
        self.localization_only = True
        self.tracker.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False
        self.tracker.localization_only = False

    def reset(self):
        self.tracker.stop()
        if self.loop_closer is not None:
            self.loop_closer.stop()
        self.tracker = Tracker(self.cfg, self.device, self.tracer)
        self.tracker.on_keyframe = self._on_keyframe
        self.loop_closer = None

    def shutdown(self):
        """Join outstanding work (mapping chains, the deferred local BA,
        the pending loop detection, the global BA in flight) and end the
        worker threads."""
        self.tracker.flush()
        if self.loop_closer is not None:
            if self.loop_closer.flush():
                self.n_loops_closed += 1
            self.loop_closer.poll_global_ba(force=True)
            self.loop_closer.stop()
        self.tracker.stop()

    def worker_busy_s(self) -> dict[str, float]:
        """Seconds each worker thread made so far has spent in its jobs."""
        workers = [self.tracker._mapping_worker]
        if self.loop_closer is not None:
            workers += [self.loop_closer._worker, self.loop_closer._gba_worker]
        return {w.name: w.busy_s for w in workers if w is not None}

    # ------------------------------------------------------------------
    def save_trajectory_kitti(self, path):
        self.shutdown()
        save_trajectory_kitti(path, self.tracker.final_trajectory())

    def save_trajectory_tum(self, path):
        self.shutdown()
        save_trajectory_tum(path, self.tracker.final_trajectory())

    def save_keyframe_trajectory_tum(self, path):
        store = self.tracker.map
        traj = [
            (int(store.kf_frame_id[k]), float(store.kf_timestamp[k]), store.kf_R[k], store.kf_t[k], False)
            for k in np.nonzero(store.kf_valid[: store._next_kf])[0]
        ]
        save_trajectory_tum(path, traj)

    @property
    def map(self):
        return self.tracker.map

    def tracking_state(self) -> str:
        return self.tracker.state
