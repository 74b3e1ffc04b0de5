"""Line landmark maintenance: cross-keyframe fuse + two-view creation.

Completes the MapLine lifecycle the reference has in
LocalMapping::SearchInNeighbors / CreateNewMapLines and
MapLine::Replace ([E] src/LocalMapping.cc, src/MapLine.cc;
SURVEY.md §2.1 rows 3, 8; VERDICT r2 'next round' #4):

- fuse_lines_into_keyframe: project unbound 3D lines into a fresh
  keyframe's detected segments, bind free slots, and merge duplicate
  landmarks (replace_lines) when a slot is already bound to a
  different line.
- create_lines_two_view: mono-capable 3D line creation — each matched
  segment pair defines two back-projection planes; their intersection
  is the 3D line (Plücker dual of the plane wedge), endpoints recovered
  by intersecting the first view's endpoint rays with the line's
  closest points.  This is how mono gets 3D lines (stereo-depth
  creation only covers segments with valid disparity).

Host numpy throughout: line counts are <= n_lines (128) per keyframe —
device dispatch overhead would dominate any kernel here.

A copy of ``orb_line_slam_tpu/slam_map/line_mapping.py``: that module is
numpy, but it imports ``geometry.host``, and the JAX package's
``geometry/__init__.py`` imports jax.  A fix to either copy goes into
the other.
"""

from __future__ import annotations

import numpy as np

from ..geometry.host import nse3_apply, nse3_inverse


def _project_lines(store, ln_ids, R, t, cam):
    """Project 3D line endpoints into a camera; returns (p0, p1, valid)."""
    s_c = nse3_apply(R, t, store.ln_start[ln_ids])
    e_c = nse3_apply(R, t, store.ln_end[ln_ids])
    ok = (s_c[:, 2] > 0.2) & (e_c[:, 2] > 0.2)
    z0 = np.maximum(s_c[:, 2], 0.2)
    z1 = np.maximum(e_c[:, 2], 0.2)
    p0 = np.stack(
        [cam.fx * s_c[:, 0] / z0 + cam.cx, cam.fy * s_c[:, 1] / z0 + cam.cy], -1
    )
    p1 = np.stack(
        [cam.fx * e_c[:, 0] / z1 + cam.cx, cam.fy * e_c[:, 1] / z1 + cam.cy], -1
    )
    inb = (
        (p0 >= 0).all(1) & (p1 >= 0).all(1)
        & (p0[:, 0] < cam.width) & (p1[:, 0] < cam.width)
        & (p0[:, 1] < cam.height) & (p1[:, 1] < cam.height)
    )
    return p0.astype(np.float32), p1.astype(np.float32), ok & inb


def fuse_lines_into_keyframe(store, kf: int, cam, max_dist: int = 60,
                             ang_tol: float = 0.15, perp_tol: float = 6.0):
    """Project map lines into keyframe kf's detected segments; bind free
    slots, merge duplicates into the better-observed landmark."""
    if not store.Lf or not store.kf_valid[kf]:
        return 0
    ln_ids = np.nonzero(store.ln_valid)[0]
    if len(ln_ids) == 0:
        return 0
    feat_v = store.kf_ln_valid[kf]
    if not feat_v.any():
        return 0
    p0m, p1m, vis = _project_lines(
        store, ln_ids, store.kf_R[kf], store.kf_t[kf], cam
    )
    ln_ids, p0m, p1m = ln_ids[vis], p0m[vis], p1m[vis]
    if len(ln_ids) == 0:
        return 0

    # Hamming + geometry gates against the keyframe's stored segments.
    fd = store.kf_ln_desc[kf]
    md = store.ln_desc[ln_ids]
    dist = np.unpackbits(
        md[:, None, :] ^ fd[None, :, :], axis=-1
    ).sum(-1)
    am = np.arctan2(p1m[:, 1] - p0m[:, 1], p1m[:, 0] - p0m[:, 0]) % np.pi
    f0 = store.kf_ln_p0[kf]
    f1 = store.kf_ln_p1[kf]
    af = np.arctan2(f1[:, 1] - f0[:, 1], f1[:, 0] - f0[:, 0]) % np.pi
    dang = np.abs(((am[:, None] - af[None, :] + np.pi / 2) % np.pi) - np.pi / 2)
    midm = 0.5 * (p0m + p1m)
    nrm = np.stack([-np.sin(af), np.cos(af)], -1)
    midf = 0.5 * (f0 + f1)
    perp = np.abs(np.einsum("mfj,fj->mf", midm[:, None] - midf[None], nrm))
    gate = (dang < ang_tol) & (perp < perp_tol) & feat_v[None, :]
    dist = np.where(gate, dist, 999)
    best = dist.argmin(axis=1)
    ok = dist[np.arange(len(ln_ids)), best] < max_dist
    n_fused = 0
    counts = store.line_obs_counts()
    for m in np.nonzero(ok)[0]:
        lid = int(ln_ids[m])
        slot = int(best[m])
        existing = int(store.kf_ln_obs[kf, slot])
        if existing == lid:
            continue
        if existing < 0 or not store.ln_valid[existing]:
            store.kf_ln_obs[kf, slot] = lid
        else:
            a, b = (lid, existing) if counts[existing] >= counts[lid] else (
                existing, lid)
            store.kf_ln_obs[kf, slot] = a
            store.replace_lines(np.asarray([a]), np.asarray([b]))
        n_fused += 1
    return n_fused


def create_lines_two_view(store, kf1: int, kf2: int, cam, min_parallax_deg=1.0,
                          max_new: int = 32):
    """Triangulate 3D lines from segment matches between two keyframes
    (CreateNewMapLines for mono — no stereo depth needed).

    Each observed segment back-projects to a plane through the camera
    center; the 3D line is the intersection of the two planes.  Accept
    when the plane normals subtend enough parallax and both endpoint
    reconstructions land in front of both cameras."""
    if not store.Lf:
        return np.asarray([], np.int32)
    v1 = store.kf_ln_valid[kf1] & (store.kf_ln_obs[kf1] < 0)
    v2 = store.kf_ln_valid[kf2] & (store.kf_ln_obs[kf2] < 0)
    if not v1.any() or not v2.any():
        return np.asarray([], np.int32)

    d1 = store.kf_ln_desc[kf1]
    d2 = store.kf_ln_desc[kf2]
    dist = np.unpackbits(d1[:, None, :] ^ d2[None, :, :], axis=-1).sum(-1)
    dist = np.where(v1[:, None] & v2[None, :], dist, 999)
    best = dist.argmin(axis=1)
    ok = dist[np.arange(len(best)), best] < 60

    def plane(kf, p0, p1):
        """World plane through the camera center and the segment."""
        K = np.array(
            [[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float64
        )
        Kinv = np.linalg.inv(K)
        r0 = Kinv @ np.array([p0[0], p0[1], 1.0])
        r1 = Kinv @ np.array([p1[0], p1[1], 1.0])
        n_c = np.cross(r0, r1)
        n_c /= np.linalg.norm(n_c) + 1e-12
        Rwc, twc = nse3_inverse(store.kf_R[kf], store.kf_t[kf])
        n_w = Rwc @ n_c
        c_w = twc  # camera center in world
        d = -float(n_w @ c_w)
        return n_w, d, Rwc, c_w, (r0, r1)

    created = []
    rows = np.nonzero(ok)[0][:max_new]
    for i in rows:
        j = int(best[i])
        n1, dd1, Rwc1, c1, rays1 = plane(
            kf1, store.kf_ln_p0[kf1, i], store.kf_ln_p1[kf1, i]
        )
        n2, dd2, _, c2, _ = plane(
            kf2, store.kf_ln_p0[kf2, j], store.kf_ln_p1[kf2, j]
        )
        cosp = abs(float(n1 @ n2))
        if cosp > np.cos(np.deg2rad(min_parallax_deg)):
            continue  # planes nearly parallel: no depth information
        # Line direction and a point on the plane intersection.
        v = np.cross(n1, n2)
        vn = np.linalg.norm(v)
        if vn < 1e-9:
            continue
        v = v / vn
        A = np.stack([n1, n2, v])
        b = np.array([-dd1, -dd2, 0.0])
        try:
            x0 = np.linalg.solve(A, b)
        except np.linalg.LinAlgError:
            continue
        # Endpoints: intersect view-1 endpoint rays with the 3D line
        # (closest point on the line to each ray).
        eps = []
        good = True
        for r in rays1:
            rw = Rwc1 @ r
            rw = rw / (np.linalg.norm(rw) + 1e-12)
            # min over (s, u): || c1 + s rw - (x0 + u v) ||
            M = np.array([[rw @ rw, -rw @ v], [rw @ v, -v @ v]])
            rhs = np.array([(x0 - c1) @ rw, (x0 - c1) @ v])
            try:
                su = np.linalg.solve(M, rhs)
            except np.linalg.LinAlgError:
                good = False
                break
            s = float(su[0])
            if s < 0.2:  # behind camera 1
                good = False
                break
            eps.append(x0 + float(su[1]) * v)
        if not good:
            continue
        s_w, e_w = eps
        # Both endpoints must be in front of camera 2 as well.
        for p in (s_w, e_w):
            pc2 = store.kf_R[kf2] @ p + store.kf_t[kf2]
            if pc2[2] < 0.2:
                good = False
        if not good or np.linalg.norm(e_w - s_w) < 0.05:
            continue
        ids = store.add_lines(
            s_w[None].astype(np.float32), e_w[None].astype(np.float32),
            d1[i][None], kf1, np.asarray([i]),
        )
        if len(ids):
            store.kf_ln_obs[kf2, j] = ids[0]
            created.append(int(ids[0]))
    return np.asarray(created, np.int32)
