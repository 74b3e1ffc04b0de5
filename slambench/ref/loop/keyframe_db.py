# Frozen copy of orb_line_slam_tpu_torch/slam_map/keyframe_db.py at commit d30c4f7 (the benchmark's plain reference).
"""Keyframe database: inverted word index for loop/relocalization
candidates.

Port of ``orb_line_slam_tpu/slam_map/keyframe_db.py`` (numpy and dicts,
copied because that module imports the JAX vocabulary): word -> keyframe
inverted index; ``detect_loop_candidates`` with shared-word counting,
the 0.8 * max-common-words gate, covisibility-group score accumulation
and the 0.75 relative-score threshold.  Descriptors are tensors and are
transformed to words on their own device.
"""

from __future__ import annotations

import numpy as np

from ..loop.vocabulary import Vocabulary


class KeyFrameDatabase:
    def __init__(self, voc: Vocabulary):
        self.voc = voc
        self.inverted: dict[int, list[int]] = {}
        self.bow: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def add(self, kf_id: int, descs, valid):
        ids, w = self.voc.bow_vector(descs, valid)
        self.add_bow(kf_id, ids, w)

    def add_words(self, kf_id: int, words, valid):
        """Insert from pre-resolved leaf words (async BoW transform)."""
        ids, w = self.voc.bow_from_words(words, valid, self.voc.word_weight)
        self.add_bow(kf_id, ids, w)

    def add_bow(self, kf_id: int, ids, w):
        if kf_id in self.bow:
            self.erase(kf_id)  # recycled slot: drop the dead KF's words
        self.bow[kf_id] = (ids, w)
        for word in ids:
            self.inverted.setdefault(int(word), []).append(kf_id)

    def erase(self, kf_id: int):
        ids, _ = self.bow.pop(kf_id, (np.zeros(0, np.int32), None))
        for word in ids:
            lst = self.inverted.get(int(word), [])
            if kf_id in lst:
                lst.remove(kf_id)

    def score(self, a: int, b: int) -> float:
        ia, wa = self.bow[a]
        ib, wb = self.bow[b]
        return Vocabulary.score_l1(ia, wa, ib, wb)

    # ------------------------------------------------------------------
    def detect_loop_candidates(self, kf_id: int, min_score: float,
                               covisible: set[int], covis_groups=None):
        """KFs sharing words with kf_id, excluding its covisible set,
        gated and ranked as the reference does."""
        ids, w = self.bow[kf_id]
        shared = {}
        for word in ids:
            for k in self.inverted.get(int(word), []):
                if k == kf_id or k in covisible:
                    continue
                shared[k] = shared.get(k, 0) + 1
        if not shared:
            return []
        max_common = max(shared.values())
        min_common = 0.8 * max_common
        scored = [
            (k, self.score(kf_id, k))
            for k, c in shared.items()
            if c >= min_common
        ]
        scored = [(k, s) for k, s in scored if s >= min_score]
        if not scored:
            return []
        # Accumulate scores over each candidate's covisibility group.
        # covis_groups may be a callable k -> set (computed lazily for
        # the surviving candidates only — building groups for every
        # database keyframe is O(K^2) host work per detection).
        if covis_groups is None:
            covis_groups = {k: {k} for k, _ in scored}
        elif callable(covis_groups):
            fn = covis_groups
            covis_groups = {k: fn(k) for k, _ in scored}
        acc = []
        for k, s in scored:
            group = covis_groups.get(k, {k})
            total = s
            best_k, best_s = k, s
            for k2 in group:
                if k2 == k or k2 not in self.bow:
                    continue
                if k2 in dict(scored):
                    s2 = dict(scored)[k2]
                    total += s2
                    if s2 > best_s:
                        best_k, best_s = k2, s2
            acc.append((best_k, total))
        best_total = max(t for _, t in acc)
        out = sorted(
            {k for k, t in acc if t >= 0.75 * best_total},
            key=lambda k: -dict(acc).get(k, 0),
        )
        return out

    def detect_relocalization_candidates(self, descs, valid):
        """Candidates for a lost frame (no covisibility exclusion)."""
        ids, w = self.voc.bow_vector(descs, valid)
        shared = {}
        for word in ids:
            for k in self.inverted.get(int(word), []):
                shared[k] = shared.get(k, 0) + 1
        if not shared:
            return []
        max_common = max(shared.values())
        cands = [k for k, c in shared.items() if c >= 0.8 * max_common]
        scores = []
        for k in cands:
            ib, wb = self.bow[k]
            scores.append((k, Vocabulary.score_l1(ids, w, ib, wb)))
        scores.sort(key=lambda x: -x[1])
        return [k for k, _ in scores]
