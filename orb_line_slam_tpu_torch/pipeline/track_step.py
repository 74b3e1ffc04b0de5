"""The per-frame tracking step.

Port of ``orb_line_slam_tpu/pipeline/track_step.py`` — ``MapMirror``
(65-75), ``_invert_matches`` (104-109), ``track_step`` (112-371),
``remap_stats`` (410-426), ``zero_stats`` (429-438) and ``override_carry``
(442-446):

  motion-model projection search -> pose opt 2x8 (path A)
  reference-KF descriptor match -> EPnP-RANSAC seed -> pose opt 2x8 (path B)
  pick the better-supported pose; local-map projection search at it
  with lines: map-line projection search at it (287-304)
  final joint point(+line) pose opt 4x10, inlier gating, keyframe-decision
  counts, per-mirror-line found/visible counts (341-356).

Everything stays on the device and no value is read back; the host
reads what it needs from the returned ``TrackOut``.
``batched_frame_track`` is the batched multi-sequence frame
(``parallel/multi_sequence.py:60-69`` over ``fused_frame_track_step``,
``track_step.py:374-407``): the front end of B pairs with one launch of
each kernel, the line front end and ``track_step`` under
``torch.func.vmap``, so the launches per frame do not grow with B; the
step writes nothing in place, so vmap can batch every operator.  The
rest of the TPU-tunnel machinery (``pack_kf_event``, the packed float
buffer) is not ported.  Path B's EPnP hypotheses are the JAX
step's own draw from ``PRNGKey(17)`` on every frame
(``backend/pnp.py::draw_hypotheses``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..backend.pnp import solve_pnp_ransac
from ..backend.pose_opt import pose_optimize
from ..backend.residuals import line_obs_coeffs
from ..config import SlamConfig
from ..frontend.frame import build_stereo_frames
from ..frontend.line_extractor import build_line_features
from ..geometry.camera import project_stereo
from ..geometry.se3 import se3_apply, se3_compose
from ..matching.line_matcher import search_lines_by_projection
from ..matching.point_matcher import (
    match_descriptors,
    resolve_duplicates,
    rotation_consistency,
    search_by_projection,
)

PNP_SEED = 17


class MapMirror(NamedTuple):
    """Device copy of the MapStore point table (refreshed per map mutation)."""

    pos: torch.Tensor     # float32 [P, 3]
    desc: torch.Tensor    # uint8 [P, 32]
    oct: torch.Tensor     # int32 [P]
    valid: torch.Tensor   # bool [P]
    maxd: torch.Tensor    # float32 [P]
    mind: torch.Tensor    # float32 [P]
    normal: torch.Tensor  # float32 [P, 3]


class TrackOut(NamedTuple):
    """Per-frame outputs (tensors on the frame's device)."""

    R: torch.Tensor               # float32 [3,3] final pose
    t: torch.Tensor               # float32 [3]
    Rv: torch.Tensor              # float32 [3,3] velocity T_k<-k-1
    tv: torch.Tensor              # float32 [3]
    ok: torch.Tensor              # bool — tracking succeeded
    assoc_gid: torch.Tensor       # int32 [N] global landmark id per feature (-1)
    inliers: torch.Tensor         # bool [N] final pose-opt inliers
    found_acc: torch.Tensor       # int32 [cap] per-snapshot found counter
    vis_acc: torch.Tensor         # int32 [cap] per-snapshot visible counter
    n_inliers: torch.Tensor       # int32
    used_motion: torch.Tensor     # bool — stage 1 picked path A
    stage1_ok: torch.Tensor       # bool
    n_stage1: torch.Tensor        # int32
    tracked_close: torch.Tensor   # int32
    untracked_close: torch.Tensor  # int32
    n_line_inliers: torch.Tensor  # int32 — line inliers of the final solve
    ln_found_acc: torch.Tensor    # int32 [Lcap] per-mirror-line found counter
    ln_vis_acc: torch.Tensor      # int32 [Lcap] per-mirror-line visible counter
    ln_match_idx: torch.Tensor    # int32 [Lcap] map line -> frame line row (-1)
    ln_match_mask: torch.Tensor   # bool [Lcap]


def _invert_matches(m_idx, m_mask, n_rows: int, n_feats: int):
    """Per-landmark-row matches -> per-frame-feature source row (-1)."""
    dev = m_idx.device
    tgt = torch.where(m_mask, m_idx, torch.full_like(m_idx, n_feats)).long()
    out = torch.full((n_feats + 1,), -1, dtype=torch.int32, device=dev)
    return out.scatter(0, tgt, torch.arange(n_rows, dtype=torch.int32, device=dev))[:n_feats]


def _pick(cond, a, b):
    return torch.where(cond, a, b)


def track_step(
    frame, last_frame, mir: MapMirror, last_gid,
    Rv, tv, R_last, t_last, has_velocity,
    ref_xy, ref_desc, ref_angle, ref_slots,
    snap_ids, found_acc, vis_acc,
    ln_found_acc, ln_vis_acc,
    lf, ln_start, ln_end, ln_desc, ln_valid,
    cfg: SlamConfig,
    has_lines: bool = False,
) -> TrackOut:
    """One frame against the map mirror.  ln_* are the mirror's line
    table [Lcap] (dummies when has_lines is False) and lf the frame's
    LineFeatures (unused when has_lines is False)."""
    cam = cfg.camera
    scales = cfg.orb.level_scales
    dev = frame.xy.device
    N = frame.xy.shape[0]
    P = mir.pos.shape[0]
    cap = snap_ids.shape[0]
    neg1 = lambda x: torch.full_like(x, -1)  # noqa: E731

    # ---- Landmark tables: gathers from the mirror -----------------------
    lr = torch.clamp(last_gid, 0, P - 1).long()
    last_sel = (last_gid >= 0) & mir.valid[lr]
    last_pos, last_desc, last_maxd = mir.pos[lr], mir.desc[lr], mir.maxd[lr]

    rr = torch.clamp(ref_slots, 0, P - 1).long()
    ref_has_lm = (ref_slots >= 0) & mir.valid[rr]
    ref_pos = mir.pos[rr]
    ref_gid = _pick(ref_has_lm, ref_slots, neg1(ref_slots))

    sr = torch.clamp(snap_ids, 0, P - 1).long()
    snap_valid = (snap_ids >= 0) & mir.valid[sr]
    snap_pos, snap_desc, snap_oct = mir.pos[sr], mir.desc[sr], mir.oct[sr]
    snap_maxd = _pick(snap_valid, mir.maxd[sr], torch.ones_like(mir.maxd[sr]))
    snap_mind = _pick(snap_valid, mir.mind[sr], torch.zeros_like(mir.mind[sr]))
    snap_normal = mir.normal[sr]
    snap_gid = _pick(snap_valid, snap_ids, neg1(snap_ids))

    # ---- Path A: motion model ------------------------------------------
    Rp, tp = se3_compose(Rv, tv, R_last, t_last)
    mA = search_by_projection(
        last_pos, last_desc, last_sel & has_velocity, last_frame.octave,
        Rp, tp, frame, cam, scales,
        radius=cfg.tracking.motion_search_radius, ratio=0.9, check_ur=True,
        max_dist_p=last_maxd,
    )
    mA = resolve_duplicates(mA, N)
    keepA = rotation_consistency(last_frame.angle, frame.angle[mA.idx.long()], mA.mask)
    n_mm = keepA.sum()
    rowA = _invert_matches(mA.idx, keepA, N, N)
    selA = rowA >= 0
    rA = _pick(selA, rowA, torch.zeros_like(rowA)).long()
    ptsA = last_pos[rA]
    gidA = _pick(selA & last_sel[rA], last_gid[rA], neg1(rowA))
    selA = gidA >= 0

    obs = torch.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], dim=-1)
    resA = pose_optimize(Rp, tp, ptsA, obs, frame.octave, selA & frame.valid,
                         cam, cfg.orb.scale_factor, rounds=2, iters=8)
    okA = has_velocity & (n_mm >= 20) & (resA.n_inliers >= 10)

    # ---- Path B: reference keyframe -------------------------------------
    du = frame.xy[:, 0:1] - ref_xy[None, :, 0]
    dv = frame.xy[:, 1:2] - ref_xy[None, :, 1]
    window = (du * du + dv * dv) < 150.0**2
    mB = match_descriptors(frame.desc, frame.valid, ref_desc, ref_has_lm,
                           max_dist=50, ratio=0.75, extra_mask=window)
    keepB = rotation_consistency(frame.angle, ref_angle[mB.idx.long()], mB.mask)
    n_ref = keepB.sum()
    selB = keepB
    rB = _pick(selB, mB.idx, torch.zeros_like(mB.idx)).long()
    ptsB = ref_pos[rB]
    gidB = _pick(selB, ref_gid[rB], neg1(ref_gid[rB]))

    sigma2B = (cfg.orb.scale_factor ** frame.octave.to(torch.float32)) ** 2
    Rr, tr, _, n_r = solve_pnp_ransac(ptsB, frame.xy, selB & frame.valid, PNP_SEED, cam, sigma2B)
    use_r = n_r >= 10
    resB = pose_optimize(_pick(use_r, Rr, R_last), _pick(use_r, tr, t_last), ptsB, obs,
                         frame.octave, selB & frame.valid, cam, cfg.orb.scale_factor,
                         rounds=2, iters=8)
    okB = (n_ref >= 15) & (resB.n_inliers >= 10)

    # ---- Stage-1 select --------------------------------------------------
    m1 = torch.full_like(resA.n_inliers, -1)
    scoreA = _pick(okA, resA.n_inliers, m1)
    scoreB = _pick(okB, resB.n_inliers, m1)
    use_mm = okA & (scoreA >= scoreB)
    stage1_ok = okA | okB
    R1 = _pick(use_mm, resA.R, resB.R)
    t1 = _pick(use_mm, resA.t, resB.t)
    n1 = _pick(use_mm, resA.n_inliers, resB.n_inliers)
    selA_in = selA & resA.inliers & okA
    selB_in = selB & resB.inliers & okB
    sel1 = selA_in | selB_in
    gid1 = _pick(selA_in, gidA, _pick(selB_in, gidB, neg1(gidA)))
    pts1 = _pick(selA_in[:, None], ptsA, ptsB)

    # ---- Local map search at the selected pose --------------------------
    already = torch.any((snap_gid[:, None] == gid1[None, :]) & (gid1 >= 0)[None, :], dim=1)
    m5 = search_by_projection(
        snap_pos, snap_desc, snap_valid & ~already & stage1_ok, snap_oct,
        R1, t1, frame, cam, scales,
        radius=4.0, max_dist=50, ratio=0.8, check_ur=True,
        max_dist_p=snap_maxd, min_dist_p=snap_mind, normal_p=snap_normal,
    )
    m5 = resolve_duplicates(m5, N)
    row5 = _invert_matches(m5.idx, m5.mask, cap, N)
    sel5 = (row5 >= 0) & ~sel1
    r5 = _pick(sel5, row5, torch.zeros_like(row5)).long()
    gid_merged = _pick(sel1, gid1, _pick(sel5, snap_gid[r5], neg1(gid1)))
    pts_merged = _pick(sel1[:, None], pts1, snap_pos[r5])
    sel_merged = (sel1 | sel5) & frame.valid

    # Visibility (SearchLocalPoints' "visible" counter) at the stage-1 pose.
    xc = se3_apply(R1, t1, snap_pos)
    uvr = project_stereo(cam, xc)
    view = snap_pos - (-(R1.T @ t1))
    vdist = torch.linalg.norm(view, dim=-1)
    cosang = torch.sum(view * snap_normal, dim=-1) / torch.clamp(vdist, min=1e-6)
    visible_snap = (
        snap_valid & (xc[:, 2] > 0.1)
        & (uvr[:, 0] >= 0) & (uvr[:, 0] < cam.width)
        & (uvr[:, 1] >= 0) & (uvr[:, 1] < cam.height)
        & (vdist >= 0.8 * snap_mind) & (vdist <= 1.2 * snap_maxd)
        & (cosang > 0.5)
    )

    # ---- Map lines: projection search at the selected pose -------------
    Lcap = ln_start.shape[0]
    line_kw = {}
    ln_match_idx = torch.full((Lcap,), -1, dtype=torch.int32, device=dev)
    ln_match_mask = torch.zeros(Lcap, dtype=torch.bool, device=dev)
    if has_lines:
        mL = search_lines_by_projection(ln_start, ln_end, ln_desc, ln_valid, R1, t1, lf, cam)
        ri = mL.idx.long()   # -1 (unmatched) reads the last row, as in the JAX code
        line_kw = dict(
            line_start_w=ln_start, line_end_w=ln_end, line_obs=line_obs_coeffs(lf.p0[ri], lf.p1[ri]),
            line_octave=torch.zeros(Lcap, dtype=torch.int32, device=dev), line_valid=mL.mask & ln_valid,
        )
        ln_match_idx, ln_match_mask = mL.idx, mL.mask

    # ---- Final joint pose opt ------------------------------------------
    res2 = pose_optimize(R1, t1, pts_merged, obs, frame.octave, sel_merged,
                         cam, cfg.orb.scale_factor, **line_kw)
    gid_out = _pick(res2.inliers & sel_merged, gid_merged, neg1(gid_merged))

    close = frame.valid & (frame.depth > 0) & (frame.depth < cfg.tracking.th_depth * cam.baseline)
    tracked_close = (close & (gid_out >= 0)).sum().to(torch.int32)
    untracked_close = (close & (gid_out < 0)).sum().to(torch.int32)

    ok = stage1_ok & (res2.n_inliers >= 10)
    R_out = _pick(ok, res2.R, R_last)
    t_out = _pick(ok, res2.t, t_last)
    Ri, ti = R_last.T, -(R_last.T @ t_last)
    Rv_out, tv_out = se3_compose(R_out, t_out, Ri, ti)
    found_hit = torch.any((snap_gid[:, None] == gid_out[None, :]) & (gid_out >= 0)[None, :], dim=1)
    # Line landmark statistics (MapLine IncreaseFound / IncreaseVisible):
    # visible = midpoint in front of the final pose and inside the image;
    # found = matched this frame and a line inlier of the final solve.
    if has_lines:
        xm = se3_apply(res2.R, res2.t, 0.5 * (ln_start + ln_end))
        uvm = project_stereo(cam, xm)
        ln_visible = (ln_valid & (xm[:, 2] > 0.1) & (uvm[:, 0] >= 0) & (uvm[:, 0] < cam.width)
                      & (uvm[:, 1] >= 0) & (uvm[:, 1] < cam.height))
        ln_found_acc = ln_found_acc + (ln_match_mask & ln_valid & res2.line_inliers).to(torch.int32)
        ln_vis_acc = ln_vis_acc + ln_visible.to(torch.int32)
    return TrackOut(
        R=R_out, t=t_out, Rv=Rv_out, tv=tv_out, ok=ok,
        assoc_gid=gid_out, inliers=res2.inliers,
        found_acc=found_acc + found_hit.to(torch.int32),
        vis_acc=vis_acc + visible_snap.to(torch.int32),
        n_inliers=res2.n_inliers, used_motion=use_mm, stage1_ok=stage1_ok,
        n_stage1=n1, tracked_close=tracked_close, untracked_close=untracked_close,
        n_line_inliers=res2.line_inliers.sum().to(torch.int32),
        ln_found_acc=ln_found_acc, ln_vis_acc=ln_vis_acc,
        ln_match_idx=ln_match_idx, ln_match_mask=ln_match_mask,
    )


def batched_frame_track(imgs_l: torch.Tensor, imgs_r: torch.Tensor, stacked_inputs, cfg: SlamConfig,
                        has_lines: bool):
    """One frame of B sequences: imgs_l / imgs_r [B, H, W] and
    stacked_inputs, ``track_step``'s arguments from ``last_frame`` to
    ``ln_valid`` without ``lf`` (Frame, MapMirror, 15 carry and reference
    tensors, the 4 line-table tensors), each with a leading [B].  The
    front ends run on the batch (the kernels are launched outside the
    vmap, once each); ``track_step`` runs under ``torch.func.vmap``, where
    Path B's EPnP draw (``PNP_SEED``) is the same for every sequence, as
    under ``jax.vmap``.  Returns (frames, line features or None,
    TrackOut), each with a leading [B]."""
    frames = build_stereo_frames(imgs_l, imgs_r, cfg)
    lfs = build_line_features(imgs_l, imgs_r, cfg.camera, cfg.lines) if cfg.lines.enabled else None
    last_frame, mir, *rest = stacked_inputs
    carry, table = rest[:15], rest[15:]

    def one(frame, lf, last_frame, mir, carry, table):
        return track_step(frame, last_frame, mir, *carry, lf, *table, cfg=cfg, has_lines=has_lines)

    lf_in = lfs if has_lines else None
    outs = torch.func.vmap(one, in_dims=(0, 0 if has_lines else None, 0, 0, 0, 0))(
        frames, lf_in, last_frame, mir, tuple(carry), tuple(table))
    return frames, lfs, outs


def remap_stats(out: TrackOut, remap: torch.Tensor, ln_remap: torch.Tensor) -> TrackOut:
    """Re-index the found/visible accumulators (points and lines) when the
    local-map snapshot changes: new slot j takes old slot remap[j]'s
    count (-1 -> 0).  Line accumulators written at another line capacity
    (the mirror switched between 8 and n_lines rows since) restart at
    zero, as they do in the next track step."""
    def take(a, r):
        if a.shape[0] != r.shape[0]:
            return torch.zeros(r.shape[0], dtype=a.dtype, device=a.device)
        return torch.where(r >= 0, a[torch.clamp(r, min=0).long()], torch.zeros_like(a))

    return out._replace(
        found_acc=take(out.found_acc, remap), vis_acc=take(out.vis_acc, remap),
        ln_found_acc=take(out.ln_found_acc, ln_remap), ln_vis_acc=take(out.ln_vis_acc, ln_remap),
    )


def zero_stats(out: TrackOut) -> TrackOut:
    """Reset the found/visible accumulators after the host consumed them."""
    z = torch.zeros_like
    return out._replace(found_acc=z(out.found_acc), vis_acc=z(out.vis_acc),
                        ln_found_acc=z(out.ln_found_acc), ln_vis_acc=z(out.ln_vis_acc))


def override_carry(out: TrackOut, R: torch.Tensor, t: torch.Tensor) -> TrackOut:
    """Rewrite the pose carry after a host-side pose correction (a
    deferred BA's re-anchoring).  The velocity is frame-relative and
    survives a rigid re-anchoring, so it is kept."""
    return out._replace(R=R, t=t)
