# Frozen copy of the loop detection of orb_line_slam_tpu_torch/loop/loop_closing.py at commit d30c4f7
# (the benchmark's plain reference): LoopCloser._covisible_set and LoopCloser._detect, as functions of a
# covisibility matrix, a keyframe database and the consistency groups they read and write.
"""Loop candidates of one keyframe: BoW candidates from the keyframe
database (covisible keyframes excluded, the minimum score the lowest among
them), then covisibility consistency over 3 consecutive keyframes
(LoopClosing::DetectLoop's mvConsistentGroups)."""

from __future__ import annotations

import numpy as np


def covisible_set(W: np.ndarray, kf_id: int, min_w: int = 15) -> set[int]:
    ids = np.nonzero(W[kf_id] >= min_w)[0]
    return set(int(i) for i in ids)


def detect(db, W: np.ndarray, kf_id: int, consistent_groups):
    """(candidates, winner or None, the consistency groups after) of
    ``kf_id`` against the database ``db``."""
    covis = covisible_set(W, kf_id)
    # minScore: lowest BoW similarity among covisible KFs.
    min_score = 0.008
    scores = [
        db.score(kf_id, k) for k in covis if k in db.bow
    ]
    if scores:
        min_score = max(min(scores), 0.001)
    group_cache: dict[int, set] = {}

    def covis_group(k):
        if k not in group_cache:
            group_cache[k] = covisible_set(W, k) | {k}
        return group_cache[k]

    cands = db.detect_loop_candidates(
        kf_id, min_score, covis | {kf_id}, covis_group
    )
    if not cands:
        return cands, None, []

    new_groups = []
    winner = None
    for c in cands:
        group = covis_group(c)
        consistency = 0
        for prev_group, prev_count in consistent_groups:
            if group & prev_group:
                consistency = prev_count + 1
                break
        new_groups.append((group, consistency))
        if consistency >= 2 and winner is None:
            winner = c
    return cands, winner, new_groups
