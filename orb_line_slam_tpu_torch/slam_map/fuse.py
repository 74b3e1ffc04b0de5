"""Cross-keyframe landmark fusion (SearchInNeighbors).

Port of ``orb_line_slam_tpu/slam_map/fuse.py`` — the semantics of
``_fuse_program_mirror`` (155-197) and ``_fuse_program`` (240-277), and
``dispatch_fuse``/``apply_fuse`` (288-393) with ``_apply_matches``
(106-138): project the new keyframe's landmarks into its covisible
neighbours (forward) and the neighbours' landmarks into the new
keyframe (reverse); a hit on a free feature adds an observation, a hit
on a feature bound to another landmark merges the two into the
better-observed one.  Landmark tables are gathered from the device map
mirror by id.  The uint32 "flat" upload variant is not ported.
``fuse_into_keyframe`` (44-103) is the loop corrector's search-and-fuse
of one landmark set into one keyframe, from the host arrays (the
correction has just rewritten them); its power-of-two padding kept
XLA's compiled shapes stable and is dropped.
"""

from __future__ import annotations

import numpy as np
import torch

from ..matching.point_matcher import resolve_duplicates, search_by_projection

FUSE_OWN_CAP = 2048
FUSE_POOL_CAP = 4096
FUSE_NN = 3


def _kf_view(store, k, device):
    """Frame of tensors over keyframe k's stored feature slots."""
    from ..frontend.frame import Frame

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return Frame(
        xy=t(store.kf_xy[k]),
        response=torch.zeros(store.F, dtype=torch.float32, device=device),
        angle=t(store.kf_angle[k]),
        octave=t(store.kf_oct[k]),
        desc=t(store.kf_desc[k]),
        valid=t(store.kf_feat_valid[k]),
        u_right=t(store.kf_ur[k]),
        depth=t(store.kf_depth[k]),
    )


def _apply_matches(store, k: int, lm_ids, mask, idx, lm_gens=None) -> int:
    """Apply projection-search matches into keyframe k: bind free slots,
    batch-merge duplicates into the better-observed landmark."""
    rows = np.nonzero(mask)[0]
    if len(rows) == 0:
        return 0
    counts = store.obs_counts()
    lm = lm_ids[rows].astype(np.int64)
    feat = idx[rows].astype(np.int64)
    live = store.pt_valid[lm] & store.kf_valid[k]
    if lm_gens is not None:
        live &= store.pt_gen[lm] == lm_gens[rows]
    lm, feat = lm[live], feat[live]
    existing = store.kf_obs_lm[k, feat].astype(np.int64)
    changed = existing != lm
    lm, feat, existing = lm[changed], feat[changed], existing[changed]
    if len(lm) == 0:
        return 0
    is_dup = (existing >= 0) & store.pt_valid[np.clip(existing, 0, None)]
    free = ~is_dup
    if free.any():
        store.kf_obs_lm[k, feat[free]] = lm[free].astype(np.int32)
    if is_dup.any():
        a, b = lm[is_dup], existing[is_dup]
        keep_existing = counts[b] >= counts[a]
        src = np.where(keep_existing, a, b)
        dst = np.where(keep_existing, b, a)
        # Rebind the slot first so replace_points' remap settles it.
        store.kf_obs_lm[k, feat[is_dup]] = src.astype(np.int32)
        store.replace_points(src, dst)
    store.touch_obs()
    return int(len(lm))


def fuse_into_keyframe(store, lm_ids: np.ndarray, k: int, cam, level_scales,
                       radius: float = 3.0, *, device):
    """Project landmarks into keyframe k; add observations / merge
    duplicates. Returns number of fused observations."""
    lm_ids = lm_ids[store.pt_valid[lm_ids]]
    if len(lm_ids) == 0:
        return 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    m = search_by_projection(
        t(store.pt_pos[lm_ids]), t(store.pt_desc[lm_ids]),
        torch.ones(len(lm_ids), dtype=torch.bool, device=device), t(store.pt_oct[lm_ids]),
        t(store.kf_R[k]), t(store.kf_t[k]), _kf_view(store, k, device), cam, level_scales,
        radius=radius, max_dist=50, ratio=1.0, check_ur=True,
        max_dist_p=t(store.pt_max_dist[lm_ids]), min_dist_p=t(store.pt_min_dist[lm_ids]),
        normal_p=t(store.pt_normal[lm_ids]),
        oct_tol=2,  # PredictScale is calibrated +1 for this detector
    )
    m = resolve_duplicates(m, store.F)
    mask, idx = m.mask.cpu().numpy(), m.idx.cpu().numpy()
    return _apply_matches(store, k, lm_ids, mask, idx)


def _gather(mir, ids: np.ndarray):
    """Landmark tables for ids from the device mirror."""
    P = mir.pos.shape[0]
    r = torch.from_numpy(ids.astype(np.int64)).to(mir.pos.device).clamp(0, P - 1)
    return (mir.pos[r], mir.desc[r], mir.oct[r], mir.valid[r], mir.maxd[r], mir.mind[r], mir.normal[r])


def _search(tables, R, t, frame, cam, level_scales):
    pos, desc, octv, valid, maxd, mind, normal = tables
    m = search_by_projection(
        pos, desc, valid, octv, R, t, frame, cam, level_scales,
        radius=3.0, max_dist=50, ratio=1.0, check_ur=True,
        max_dist_p=maxd, min_dist_p=mind, normal_p=normal,
        oct_tol=2,  # PredictScale is calibrated +1 for this detector
    )
    m = resolve_duplicates(m, frame.n)
    return torch.where(m.mask, m.idx, torch.full_like(m.idx, -1))


def dispatch_fuse(store, kf: int, neighbor_ids, cam, level_scales, mirror):
    """Run the forward and reverse projection searches for keyframe kf
    and up to FUSE_NN neighbours.  Returns a job for apply_fuse, or None."""
    neighbor_ids = [int(k) for k in neighbor_ids][:FUSE_NN]
    if not neighbor_ids:
        return None
    own = store.kf_obs_lm[kf]
    own = np.unique(own[own >= 0])
    own = own[store.pt_valid[own]][:FUSE_OWN_CAP]
    nb_obs = store.kf_obs_lm[neighbor_ids]
    pooled = np.unique(nb_obs[nb_obs >= 0])
    pooled = pooled[store.pt_valid[pooled]][:FUSE_POOL_CAP]
    if len(own) == 0 and len(pooled) == 0:
        return None
    dev = mirror.pos.device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    own_tab = _gather(mirror, own)
    fwd = [
        _search(own_tab, t(store.kf_R[k2]), t(store.kf_t[k2]), _kf_view(store, k2, dev), cam, level_scales)
        for k2 in neighbor_ids
    ]
    rev = _search(_gather(mirror, pooled), t(store.kf_R[kf]), t(store.kf_t[kf]),
                  _kf_view(store, kf, dev), cam, level_scales)
    return {
        "kf": kf, "neighbors": neighbor_ids, "own": own, "pool": pooled,
        "fwd": fwd, "rev": rev,
        "kf_gen": int(store.kf_gen[kf]),
        "nb_gens": [int(store.kf_gen[k2]) for k2 in neighbor_ids],
        "own_gens": store.pt_gen[own].copy(),
        "pool_gens": store.pt_gen[pooled].copy(),
    }


def apply_fuse(store, job) -> int:
    """Apply a fuse job; rows whose keyframe or landmark slot was recycled
    since dispatch are skipped.  Returns the number of fused observations."""
    if job is None:
        return 0
    total = 0
    for i, k2 in enumerate(job["neighbors"]):
        if not store.kf_valid[k2] or store.kf_gen[k2] != job["nb_gens"][i]:
            continue
        idx = job["fwd"][i].cpu().numpy()
        total += _apply_matches(store, k2, job["own"], idx >= 0, idx, job["own_gens"])
    kf = job["kf"]
    if store.kf_valid[kf] and store.kf_gen[kf] == job["kf_gen"]:
        idx = job["rev"].cpu().numpy()
        total += _apply_matches(store, kf, job["pool"], idx >= 0, idx, job["pool_gens"])
        if total:
            own2 = store.kf_obs_lm[kf]
            store.update_point_stats(np.unique(own2[own2 >= 0]))
    return total
