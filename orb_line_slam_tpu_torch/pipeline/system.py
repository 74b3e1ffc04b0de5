"""System facade — the embedder-facing API of the stereo path.

Port of ``orb_line_slam_tpu/pipeline/system.py``: ``track_stereo``
(116-119), ``_on_keyframe`` (137-206: the vocabulary trained on the fly
from the first keyframes' descriptors, the ``LoopCloser`` with its
``pre_correct_hook``, the tracker's pose reset after a closure),
``_reloc_candidates`` (208-217), ``reset`` (230-235), ``shutdown``
(237-247), the trajectory writers (250-271), ``tracking_state`` and
``map`` (274-279).  The device is an explicit, required argument;
nothing falls back to the CPU.  Stereo tracking runs with points and,
under the default ``LineConfig(enabled=True)``, lines; mapping is
synchronous.  Loop closing runs at each keyframe event on the calling
thread (``async_loop=False``) with a synchronous global BA
(``gba_async=False``): the detection worker thread and the asynchronous
global BA are not ported, and asking for either raises.  Neither are
monocular and RGB-D input, localization-only mode, or the warmups (there
is nothing to compile ahead of time).
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import SlamConfig, load_settings
from ..eval.trajectory import save_trajectory_kitti, save_trajectory_tum
from ..loop.loop_closing import LoopCloser
from ..loop.vocabulary import Vocabulary
from .tracking import Tracker


class System:
    def __init__(self, settings: SlamConfig | str | Path,
                 vocabulary: Vocabulary | str | Path | None = None,
                 use_loop_closing: bool = True, async_loop: bool = False, *,
                 device: str | torch.device):
        if async_loop:
            raise NotImplementedError(
                "async_loop=True (loop detection on a worker thread) is not ported to the "
                "torch package yet; loop closing runs synchronously at keyframe events")
        self.cfg = settings if isinstance(settings, SlamConfig) else load_settings(settings)
        self.device = torch.device(device)
        self.tracker = Tracker(self.cfg, self.device)
        self.voc: Optional[Vocabulary] = None
        if isinstance(vocabulary, Vocabulary):
            self.voc = vocabulary
        elif vocabulary is not None:
            self.voc = Vocabulary.parse_orbvoc_txt(vocabulary)
        self.use_loop_closing = use_loop_closing
        self.async_loop = False
        self.loop_closer: Optional[LoopCloser] = None
        self.n_loops_closed = 0
        self._gba_async = False
        self._voc_corpus: list[np.ndarray] = []
        self.tracker.on_keyframe = self._on_keyframe

    @property
    def gba_async(self) -> bool:
        return self._gba_async

    @gba_async.setter
    def gba_async(self, value: bool):
        if value:
            raise NotImplementedError(
                "gba_async=True (global BA applied at a later keyframe) is not ported to the "
                "torch package yet; global BA runs synchronously inside the loop correction")
        self._gba_async = False

    def track_stereo(self, img_left, img_right, timestamp: float = 0.0) -> np.ndarray:
        """Feed a rectified stereo pair (uint8 [H, W]); returns the 4x4 Tcw."""
        return self.tracker.process_stereo(img_left, img_right, timestamp)

    # ------------------------------------------------------------------
    def _on_keyframe(self, kf_id: int):
        if not self.use_loop_closing:
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
            self.voc = Vocabulary.train(corpus, k=10, depth=4, seed=0)
            self._voc_corpus = []
        if self.loop_closer is None:
            self.loop_closer = LoopCloser(self.cfg, self.tracker.map, self.voc, device=self.device)
            self.loop_closer.fix_scale = True   # stereo: the map has metric scale
            self.tracker.reloc_candidates_fn = self._reloc_candidates
            # Reference CorrectLoop order: local mapping is drained
            # before the pose rewrite, so outstanding triangulation, fuse
            # and BA land instead of being discarded by the epoch guard.
            self.loop_closer.pre_correct_hook = self.tracker.poll_map_jobs
        closed = self.loop_closer.process_keyframe(kf_id)
        if closed:
            self.n_loops_closed += 1
            # Tracking continues from the corrected keyframe pose.
            self.tracker.R = self.tracker.map.kf_R[kf_id].copy()
            self.tracker.t = self.tracker.map.kf_t[kf_id].copy()

    def _reloc_candidates(self, frame):
        if self.loop_closer is None:
            return []
        return self.loop_closer.db.detect_relocalization_candidates(frame.desc, frame.valid)

    # ------------------------------------------------------------------
    def reset(self):
        self.tracker = Tracker(self.cfg, self.device)
        self.tracker.on_keyframe = self._on_keyframe
        self.loop_closer = None

    def shutdown(self):
        """Finish outstanding work: apply every pending mapping job, then
        run the detection of the last keyframe, whose words were still
        pending (a loop may close here)."""
        self.tracker.poll_map_jobs()
        if self.loop_closer is not None and self.loop_closer.flush():
            self.n_loops_closed += 1

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
