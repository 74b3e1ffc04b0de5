# Frozen copy of orb_line_slam_tpu_torch/loop/vocabulary.py at commit d30c4f7 (the benchmark's plain reference):
# the tree, its training and the word transform, without the ORBvoc.txt readers and writers.
"""DBoW2-compatible binary vocabulary: parse, train, batched transform.

Port of ``orb_line_slam_tpu/loop/vocabulary.py``.  The host parts
(``train`` 55, ``synthesize`` 117, ``save_orbvoc_txt`` /
``parse_orbvoc_txt`` / ``_from_node_list`` 141-226, ``bow_from_words``,
``bow_vector``, ``score_l1`` 280-318) are numpy, copied line for line so
that the same descriptors and seed give the same tree; the parse takes
the native parser of ``utils/native.py`` when it builds, as JAX's does
(173-204).  The word descent
(``transform_words`` 228-264) is the device part: ``depth`` levels of a
[D, k, 32] XOR + popcount against the current nodes' children, a masked
argmin (dead children at 1 << 16, first minimum wins, as ``jnp.argmin``)
and the dead-end guard, then ``word_id[node]``.  The tree tables go to a
device once, at first use there.

Scoring: L1 on tf-idf weighted, L1-normalized sparse BoW vectors.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.hamming import hamming_pairwise


def descend_words(children: torch.Tensor, node_desc: torch.Tensor, word_id: torch.Tensor,
                  depth: int, d: torch.Tensor) -> torch.Tensor:
    """Leaf word of each descriptor: children int64 [n, k] (-1 padding),
    node_desc uint8 [n, 32], word_id int32 [n], d uint8 [D, 32] -> int32 [D]."""
    node = torch.zeros(d.shape[0], dtype=torch.int64, device=d.device)
    for _ in range(depth):
        ch = children[node]                                          # [D, k]
        dist = hamming_pairwise(node_desc[ch.clamp(min=0)], d[:, None, :])
        dist = torch.where(ch >= 0, dist, torch.full_like(dist, 1 << 16))
        nxt = torch.gather(ch, 1, torch.argmin(dist, dim=1, keepdim=True))[:, 0]
        node = torch.where(nxt >= 0, nxt, node)                      # dead-end guard
    return word_id[node]


class Vocabulary:
    """Packed hierarchical binary vocabulary.

    Arrays (numpy, on the host):
      children: int32 [n_nodes, k] child node ids (-1 padding)
      node_desc: uint8 [n_nodes, 32]
      word_id: int32 [n_nodes] leaf word index (-1 for internal)
      word_weight: float32 [n_words] idf weights
    """

    def __init__(self, children, node_desc, word_id, word_weight, k, depth):
        self.children = np.asarray(children, np.int32)
        self.node_desc = np.asarray(node_desc, np.uint8)
        self.word_id = np.asarray(word_id, np.int32)
        self.word_weight = np.asarray(word_weight, np.float32)
        self.k = int(k)
        self.depth = int(depth)
        self.n_words = len(word_weight)
        self._tables: dict[torch.device, tuple] = {}

    # ------------------------------------------------------------------
    @staticmethod
    def train(descriptors: np.ndarray, k: int = 8, depth: int = 4, seed: int = 0):
        """Hierarchical k-majority clustering of packed descriptors."""
        rng = np.random.default_rng(seed)
        bits_all = np.unpackbits(np.asarray(descriptors, np.uint8), axis=1)  # [N,256]

        children_list = [[]]  # node 0 = root
        desc_list = [np.zeros(32, np.uint8)]
        word_of_node = {}

        def kmajority(bits, n_clusters, iters=8):
            n = len(bits)
            if n <= n_clusters:
                return np.arange(n) % max(n_clusters, 1), bits[
                    np.arange(n_clusters) % max(n, 1)
                ]
            centers = bits[rng.choice(n, n_clusters, replace=False)]
            for _ in range(iters):
                d = (bits[:, None, :] != centers[None, :, :]).sum(-1)
                assign = d.argmin(1)
                for c in range(n_clusters):
                    sel = bits[assign == c]
                    if len(sel):
                        centers[c] = (sel.mean(0) > 0.5).astype(np.uint8)
                    else:
                        centers[c] = bits[rng.integers(n)]
            d = (bits[:, None, :] != centers[None, :, :]).sum(-1)
            return d.argmin(1), centers

        def build(node, bits, level):
            if level == depth or len(bits) <= 1:
                word_of_node[node] = True
                return
            n_c = min(k, max(1, len(bits)))
            assign, centers = kmajority(bits, n_c)
            for c in range(n_c):
                child = len(children_list)
                children_list.append([])
                desc_list.append(np.packbits(centers[c]))
                children_list[node].append(child)
                build(child, bits[assign == c], level + 1)

        # subsample for tractability
        if len(bits_all) > 20000:
            bits_all = bits_all[rng.choice(len(bits_all), 20000, replace=False)]
        build(0, bits_all, 0)

        n_nodes = len(children_list)
        children = np.full((n_nodes, k), -1, np.int32)
        for i, ch in enumerate(children_list):
            children[i, : len(ch)] = ch
        node_desc = np.stack(desc_list)
        word_id = np.full(n_nodes, -1, np.int32)
        leaves = sorted(word_of_node.keys())
        for w, node in enumerate(leaves):
            word_id[node] = w
        # idf weights: uniform at training time (DBoW2 computes idf from
        # the training corpus; uniform keeps scores comparable).
        word_weight = np.ones(len(leaves), np.float32)
        return Vocabulary(children, node_desc, word_id, word_weight, k, depth)

    # ------------------------------------------------------------------
    def _device_tables(self, device: torch.device):
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = (
                torch.from_numpy(self.children.astype(np.int64)).to(device),
                torch.from_numpy(self.node_desc).to(device),
                torch.from_numpy(self.word_id).to(device),
            )
        return self._tables[device]

    def dispatch_transform(self, descs: torch.Tensor) -> torch.Tensor:
        """Leaf word of every descriptor (uint8 [D, 32] tensor), on the
        descriptors' device, as an int32 [D] tensor there: no copy to
        the host, so the caller decides when to wait for it."""
        children, node_desc, word_id = self._device_tables(descs.device)
        return descend_words(children, node_desc, word_id, self.depth, descs)

    def transform_words(self, descs: torch.Tensor, valid) -> np.ndarray:
        """Map each descriptor (uint8 [D, 32] tensor, transformed on its
        own device) to its leaf word id, -1 for invalid; on the host."""
        words = self.dispatch_transform(descs).cpu().numpy()
        if isinstance(valid, torch.Tensor):
            valid = valid.cpu().numpy()
        return np.where(np.asarray(valid), words, -1)

    @staticmethod
    def bow_from_words(words: np.ndarray, valid: np.ndarray,
                       word_weight: np.ndarray):
        """(sorted word ids, L1-normalized tf-idf weights) from resolved
        leaf words (the host half of bow_vector)."""
        words = np.where(valid, words, -1)
        words = words[words >= 0]
        if len(words) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        ids, counts = np.unique(words, return_counts=True)
        w = counts.astype(np.float32) * word_weight[ids]
        n = w.sum()
        if n > 0:
            w = w / n
        return ids.astype(np.int32), w

    def bow_vector(self, descs: torch.Tensor, valid):
        """Sparse tf-idf BoW: (sorted word ids [W], L1-normalized weights)."""
        words = self.transform_words(descs, valid)
        return self.bow_from_words(words, words >= 0, self.word_weight)

    @staticmethod
    def score_l1(ids_a, wa, ids_b, wb) -> float:
        """DBoW2 L1 score 1 - 0.5*|a-b|_1, which for L1-normalized
        vectors equals sum_i min(a_i, b_i) over shared words; 1.0 for
        identical vectors, 0.0 for disjoint."""
        if len(ids_b) == 0 or len(ids_a) == 0:
            return 0.0
        ia = np.searchsorted(ids_b, ids_a)
        ia = np.clip(ia, 0, len(ids_b) - 1)
        match = ids_b[ia] == ids_a
        return float(np.minimum(wa[match], wb[ia[match]]).sum())
