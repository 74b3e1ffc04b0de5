"""Line features of a stereo pair: detection, LBD, stereo endpoint depth.

Port of ``orb_line_slam_tpu/frontend/line_extractor.py:27-164``
(``LineFeatures``, ``_row_intersect``, ``build_line_features``).  The
left and right images go through Sobel, detection, duplicate merging and
LBD as one batch of 2 (the JAX package vmaps).  Left lines are then
associated with right lines (Hamming + angle + vertical overlap, knn2
ratio test); each endpoint's disparity comes from intersecting the
matched right segment at the endpoint's row, refined by a 17-candidate
1D SAD search against the right image (first minimum on ties, as
``jnp.argmin``) with a parabola fit.  Everything stays on the device of
the input images.  B pairs run as the pair's function under
``torch.func.vmap`` (``ops/lines.py`` and ``ops/lbd.py`` have no in-place
write and no read-back, and every operator they use has a batching rule).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..config import CameraIntrinsics, LineConfig
from ..ops.hamming import hamming_matrix, knn2
from ..ops.image import bilinear_sample, sobel_gradients
from ..ops.lbd import lbd_descriptors
from ..ops.lines import detect_lines, merge_collinear
from ..utils.timing import span


class LineFeatures(NamedTuple):
    p0: torch.Tensor      # float32 [L, 2]
    p1: torch.Tensor      # float32 [L, 2]
    angle: torch.Tensor   # float32 [L]
    length: torch.Tensor  # float32 [L]
    desc: torch.Tensor    # uint8 [L, 32]
    valid: torch.Tensor   # bool [L]
    depth0: torch.Tensor  # float32 [L] endpoint-0 depth (-1 invalid)
    depth1: torch.Tensor  # float32 [L]

    @property
    def n(self) -> int:
        return self.p0.shape[0]

    def numpy(self) -> "LineFeatures":
        """Host copy with numpy leaves."""
        return LineFeatures(*(t.cpu().numpy() for t in self))


def _row_intersect(p0, p1, v):
    """x where segment (p0, p1) crosses image row v, and whether v lies
    within the segment's extent (5% slack)."""
    y0, y1 = p0[..., 1], p1[..., 1]
    dy = y1 - y0
    tt = (v - y0) / torch.where(torch.abs(dy) < 1e-6, torch.full_like(dy, 1e-6), dy)
    x = p0[..., 0] + (p1[..., 0] - p0[..., 0]) * tt
    return x, (tt >= -0.05) & (tt <= 1.05)


def _sad_refine(imgs, pe, disp0):
    """Sub-pixel disparity at endpoints pe [K, 2] (initial disparity
    disp0 [K]) by 1D SAD of a 9-px row against 17 right-image offsets
    in half-pixel steps, with a parabola through the minimum.  Returns
    (refined disparity, minimum away from the search boundary)."""
    dev = pe.device
    dx = torch.arange(-4.0, 5.0, device=dev)                       # [9]
    cand = torch.arange(-4.0, 4.5, 0.5, device=dev)                # [17]
    k = pe.shape[0]
    rowL = torch.stack([pe[:, 0:1] + dx, pe[:, 1:2].expand(k, 9)], dim=-1)
    patchL = bilinear_sample(imgs[0], rowL)                        # [K, 9]
    xs = (pe[:, 0] - disp0)[:, None, None] + cand[:, None] + dx
    ysr = pe[:, 1][:, None, None].expand(xs.shape)
    patchR = bilinear_sample(imgs[1], torch.stack([xs, ysr], dim=-1))   # [K, 17, 9]
    sad = torch.sum(torch.abs(patchR - patchL[:, None, :]), dim=-1)    # [K, 17]
    best = torch.argmin(sad, dim=1)
    bc = torch.clamp(best, 1, cand.shape[0] - 2)
    sm = sad.gather(1, (bc - 1)[:, None])[:, 0]
    s0 = sad.gather(1, bc[:, None])[:, 0]
    sp = sad.gather(1, (bc + 1)[:, None])[:, 0]
    denom = sm + sp - 2.0 * s0
    frac = torch.where(torch.abs(denom) > 1e-6, 0.5 * (sm - sp) / torch.clamp(denom, min=1e-6),
                       torch.zeros_like(denom))
    frac = torch.clamp(frac, -0.5, 0.5)
    off = cand[bc] + frac * 0.5
    interior = (best > 0) & (best < cand.shape[0] - 1)
    return disp0 - off, interior


def build_line_features(img_left: torch.Tensor, img_right: torch.Tensor, cam: CameraIntrinsics,
                        cfg: LineConfig) -> LineFeatures:
    """Lines of the left image with LBD descriptors and stereo endpoint
    depths from the matched right-image segment (rectified [H, W] pair).
    B pairs [B, H, W] give a leading [B] on every leaf: the pair's function
    under ``torch.func.vmap``, as ``jax.vmap`` batches it in the JAX
    package's batched frame (``pipeline/track_step.py:392-395``), so the
    launches do not grow with B."""
    if img_left.dim() == 3:
        return torch.func.vmap(lambda l, r: build_line_features(l, r, cam, cfg))(img_left, img_right)
    with span("line_detect"):
        imgs = torch.stack([img_left, img_right]).to(torch.float32)
        gxs, gys = sobel_gradients(imgs)
        det = merge_collinear(detect_lines(imgs, n_lines=cfg.n_lines, grads=(gxs, gys)))
    with span("line_describe"):
        descs = lbd_descriptors(imgs, det.p0, det.p1, det.valid, grads=(gxs, gys))
    with span("line_stereo"):
        return _stereo_lines(imgs, det, descs, cam)


def _stereo_lines(imgs, det, descs, cam: CameraIntrinsics) -> LineFeatures:
    """The left lines of ``det`` (a batch of left and right detections)
    with endpoint depths from their matched right segments."""
    ll = type(det)(*(a[0] for a in det))
    lr = type(det)(*(a[1] for a in det))
    descL, descR = descs[0], descs[1]

    # Stereo association: Hamming + angle + vertical overlap.
    dist = hamming_matrix(descL, descR)
    dang = torch.abs(torch.remainder(ll.angle[:, None] - lr.angle[None, :] + math.pi / 2, math.pi)
                     - math.pi / 2)
    yl0 = torch.minimum(ll.p0[:, 1], ll.p1[:, 1])
    yl1 = torch.maximum(ll.p0[:, 1], ll.p1[:, 1])
    yr0 = torch.minimum(lr.p0[:, 1], lr.p1[:, 1])
    yr1 = torch.maximum(lr.p0[:, 1], lr.p1[:, 1])
    ov = torch.minimum(yl1[:, None], yr1[None, :]) - torch.maximum(yl0[:, None], yr0[None, :])
    ov_ok = ov > 0.5 * torch.clamp(yl1 - yl0 + 1.0, max=8.0)[:, None]
    gate = (dang < 0.15) & ov_ok & lr.valid[None, :]
    idx, d1, d2 = knn2(dist, gate)
    # TH_HIGH: LBD swings ~15 bits under sub-pixel endpoint shifts; the
    # geometric gates and the SAD interior check are the verifiers.
    matched = ll.valid & (d1 < 100) & (d1.to(torch.float32) < 0.9 * d2.to(torch.float32))

    # Endpoint depths: intersect the matched right segment at each left
    # endpoint's row; near-horizontal lines (|dx| >= 2 |dy|) are rejected.
    ri = idx.long()
    rp0, rp1 = lr.p0[ri], lr.p1[ri]
    max_disp = cam.bf / max(cam.baseline, 1e-6)
    rd = rp1 - rp0
    steep = torch.abs(rd[:, 0]) < 2.0 * torch.abs(rd[:, 1])
    L = ll.p0.shape[0]
    pe = torch.cat([ll.p0, ll.p1])                                  # both endpoints as one batch
    xr, inside = _row_intersect(torch.cat([rp0, rp0]), torch.cat([rp1, rp1]), pe[:, 1])
    disp = pe[:, 0] - xr
    ok = torch.cat([matched & steep] * 2) & inside & (disp > 0.3) & (disp < max_disp)
    disp_r, interior = _sad_refine(imgs, pe, disp)
    # A boundary-pinned SAD minimum marks an occluding contour or a bad match.
    ok = ok & interior & (disp_r > 0.3) & (disp_r < max_disp)
    depth = torch.where(ok, cam.bf / torch.clamp(disp_r, min=0.3), torch.full_like(disp_r, -1.0))
    return LineFeatures(
        p0=ll.p0, p1=ll.p1, angle=ll.angle, length=ll.length,
        desc=descL, valid=ll.valid, depth0=depth[:L], depth1=depth[L:],
    )
