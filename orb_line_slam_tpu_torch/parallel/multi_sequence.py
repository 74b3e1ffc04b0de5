"""Batched multi-sequence SLAM on one card (BASELINE config #4).

Port of ``orb_line_slam_tpu/parallel/multi_sequence.py``:
``make_batched_frontend`` (25-42) is ``frontend/frame.py::build_stereo_frames``
(the JAX function puts one sequence on each device of a mesh; here the B
pairs share one card, one pyramid and one launch of each kernel),
``track_sequences_frontend`` (45-54), ``_batched_frame_track`` (60-69) is
``pipeline/track_step.py::batched_frame_track``, and
``MultiSequenceTracker`` (72-228).  B sequences are tracked with one
batched frame per time step: the front end of the B pairs, the line front
end and the tracking step under ``torch.func.vmap``, so the launches per
frame do not grow with B.  Each sequence keeps its own host state: map,
mirror, keyframe policy, mapping worker and, with ``full_slam``, a whole
``System`` with its keyframe database, ``LoopCloser`` and relocalization.
Each sequence consumes its slice of the batched outputs exactly as the
single tracker consumes its own (``_dispatch_inputs``, ``_consume``);
the slices are views, and nothing downstream writes a tracked output in
place (``remap_stats``, ``zero_stats`` and ``override_carry`` build new
tuples).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..config import SlamConfig
from ..frontend.frame import Frame, build_stereo_frames
from ..pipeline.system import System
from ..pipeline.track_step import batched_frame_track
from ..pipeline.tracking import Tracker, _Entry, checked_device
from ..utils.timing import StageTimer

__all__ = ["MultiSequenceTracker", "batched_frame_track", "build_stereo_frames", "track_sequences_frontend"]


def track_sequences_frontend(cfg: SlamConfig, seqs_left, seqs_right, *, device="cuda") -> list[Frame]:
    """The batched front end over B sequences of equal length (lists of
    [H, W] images): one ``build_stereo_frames`` per time step; returns the
    batched Frames in time order."""
    device = checked_device(device)
    out = []
    for t in range(len(seqs_left[0])):
        left = torch.from_numpy(np.stack([np.asarray(s[t]) for s in seqs_left])).to(device)
        right = torch.from_numpy(np.stack([np.asarray(s[t]) for s in seqs_right])).to(device)
        out.append(build_stereo_frames(left, right, cfg))
    return out


def _stack(items):
    """Stack B per-sequence values: tensors, or NamedTuples of tensors."""
    if isinstance(items[0], tuple):
        return type(items[0])(*(_stack(field) for field in zip(*items)))
    return torch.stack(items)


def _take(tree, b: int):
    """Sequence b's slice (views) of a NamedTuple with a leading [B]."""
    return None if tree is None else type(tree)(*(x[b] for x in tree))


class MultiSequenceTracker:
    """Track B stereo sequences with one batched frame per time step.

    With ``full_slam`` (the default, BASELINE config #4: full stereo
    point+line SLAM per sequence) each sequence is a
    ``System(cfg, use_loop_closing=True, async_loop=True)`` on the card,
    the JAX defaults; otherwise a plain ``Tracker``.  Until every tracker
    is OK with a device carry (``_ready``), and on a frame whose line
    mirrors differ in capacity (8 rows against ``n_lines``), each sequence
    takes its own ``process_stereo``; the counts of such frames are kept
    beside ``n_batched_frames``.  With ``host_threads`` each sequence's
    consume (keyframe events, map maintenance, loop closing) runs on a
    thread pool.  ``device="cpu"`` runs the plain versions (tests)."""

    def __init__(self, cfg: SlamConfig, n_seq: int, full_slam: bool = True, host_threads: bool = True, *,
                 device="cuda"):
        self.cfg = cfg
        self.n_seq = n_seq
        self.full_slam = full_slam
        self.device = checked_device(device)
        if full_slam:
            self.systems = [System(cfg, use_loop_closing=True, async_loop=True, device=self.device)
                            for _ in range(n_seq)]
            self.trackers = [s.tracker for s in self.systems]
        else:
            self.systems = None
            self.trackers = [Tracker(cfg, self.device) for _ in range(n_seq)]
        self._pool = ThreadPoolExecutor(max_workers=n_seq, thread_name_prefix="mseq-host") \
            if host_threads and n_seq > 1 else None
        self.n_batched_frames = 0          # frames tracked as one batched step
        self.n_bootstrap_frames = 0        # per sequence: some tracker not OK or without a carry
        self.n_mixed_line_frames = 0       # per sequence: line mirrors of different capacities
        self.timing = StageTimer()

    def _ready(self) -> bool:
        return all(t.state == "OK" and t._carry is not None for t in self.trackers)

    def _per_sequence(self, imgs_left, imgs_right, timestamps):
        return [t.process_stereo(imgs_left[b], imgs_right[b], timestamps[b]) for b, t in enumerate(self.trackers)]

    def process_stereo(self, imgs_left, imgs_right, timestamps):
        """One frame of every sequence: imgs_* [B, H, W] arrays (or lists
        of B images), timestamps B floats.  Returns the B 4x4 Tcw."""
        if not self._ready():
            self.n_bootstrap_frames += 1
            return self._per_sequence(imgs_left, imgs_right, timestamps)
        # This frame's mapping poll, then refresh every mirror, so that
        # the capacity check below sees this frame's shapes (and
        # _dispatch_inputs does not refresh again).
        with self.timing.stage("poll_refresh"):
            for t in self.trackers:
                t.poll_mapping(t.frame_id + 1)
                if t._mirror_dirty or t._mir is None or t._mir["ref_kf"] != t.ref_kf:
                    t._refresh_mirror(t.cur_lines)
        if len({t._mir["ln_valid"].shape[0] for t in self.trackers}) > 1:
            self.n_mixed_line_frames += 1
            return self._per_sequence(imgs_left, imgs_right, timestamps)
        # One flag for the whole batch: lines in the step only when every
        # map holds one (the same config makes the flags agree once it does).
        has_lines = all(bool(t._mir["has_lines"]) for t in self.trackers) and self.cfg.lines.enabled

        with self.timing.stage("gather_inputs"):
            per_seq, last_frames = [], []
            for t in self.trackers:
                t.frame_id += 1
                mir, last_frame, args = t._dispatch_inputs(t.cur_lines)
                last_frames.append(last_frame)
                per_seq.append((last_frame, mir["pt"], *args,
                                mir["ln_start"], mir["ln_end"], mir["ln_desc"], mir["ln_valid"]))
            stacked = tuple(_stack(list(items)) for items in zip(*per_seq))
            left = torch.from_numpy(np.stack([np.asarray(x) for x in imgs_left])).to(self.device)
            right = torch.from_numpy(np.stack([np.asarray(x) for x in imgs_right])).to(self.device)
        with self.timing.stage("batched_track"):
            frames, lfs, outs = batched_frame_track(left, right, stacked, self.cfg, has_lines)
        self.n_batched_frames += 1

        def consume_one(b, t):
            frame_b, lf_b, out_b = _take(frames, b), _take(lfs, b), _take(outs, b)
            t._prev_for_dispatch = last_frames[b]
            t.cur_lines = lf_b
            t._carry = (frame_b, out_b)
            t._consume(_Entry(
                fid=t.frame_id, ts=timestamps[b], frame=frame_b, prev_frame=last_frames[b], lines=lf_b,
                out=out_b, snap_host=t._mir["snap_host"], ln_ids=t._mir["ln_ids"],
            ))
            return t.current_pose()

        with self.timing.stage("consume"):
            if self._pool is not None:
                return list(self._pool.map(consume_one, range(self.n_seq), self.trackers))
            return [consume_one(b, t) for b, t in enumerate(self.trackers)]

    def final_trajectories(self):
        return [t.final_trajectory() for t in self.trackers]

    def shutdown(self):
        """Join every sequence's outstanding work and end the worker
        threads and the pool."""
        if self.systems is not None:
            for s in self.systems:
                s.shutdown()
        else:
            for t in self.trackers:
                t.flush()
                t.stop()
        if self._pool is not None:
            self._pool.shutdown(wait=True)

    @property
    def n_loops_closed(self) -> int:
        return 0 if self.systems is None else sum(s.n_loops_closed for s in self.systems)
