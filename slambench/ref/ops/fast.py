# Frozen copy of orb_line_slam_tpu_torch/ops/fast.py at commit d30c4f7 (the benchmark's plain reference).
"""FAST-9/16 corner score and 3x3 non-maximum suppression as dense
stencils.

Port of ``orb_line_slam_tpu/ops/fast.py:34-86``.  The score is the
classical FAST score, max over the 16 circle starts of the min over a
9-pixel arc of (neighbour - centre), for bright and dark arcs; the 3-px
border where the rolls wrap is forced to 0 (``fast.py:59-65``).  The arc
minimum is taken with a doubling min-window over the 16 stacked
differences instead of 128 pairwise minimums: min and max are exact, so
the result is the same.  Images may carry leading batch dims.
"""

from __future__ import annotations

import torch

# Bresenham circle of radius 3, OpenCV pixel order (dx, dy).
CIRCLE_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

ARC_LEN = 9
BORDER = 3


def _arc_windows(d: torch.Tensor, op) -> torch.Tensor:
    """op-reduction over every circular 9-long window of d [16, ...]:
    out[s] = op(d[s], ..., d[(s + 8) % 16])."""
    e = torch.cat([d, d[: ARC_LEN - 1]], dim=0)   # [24, ...]
    m2 = op(e[:-1], e[1:])                          # e[j .. j+1]
    m4 = op(m2[:-2], m2[2:])                        # e[j .. j+3]
    m8 = op(m4[:-4], m4[4:])                        # e[j .. j+7]
    return op(m8[:16], e[8:24])                     # e[j .. j+8]


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9 score of a float32 [..., H, W] image; <= 0 means no
    corner at any threshold; the 3-px border is 0."""
    h, w = img.shape[-2], img.shape[-1]
    d = torch.stack(
        [torch.roll(img, shifts=(-dy, -dx), dims=(-2, -1)) - img for dx, dy in CIRCLE_OFFSETS]
    )
    bright = _arc_windows(d, torch.minimum).amax(dim=0)
    dark = -_arc_windows(d, torch.maximum).amin(dim=0)
    score = torch.maximum(bright, dark)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= BORDER) & (ys < h - BORDER) & (xs >= BORDER) & (xs < w - BORDER)
    return torch.where(interior, score, torch.zeros((), device=img.device))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression; ties go to the lexically first pixel
    (strict win against raster-earlier neighbours, ``fast.py:80-85``)."""
    keep = torch.ones_like(score, dtype=torch.bool)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = torch.roll(score, shifts=(-dy, -dx), dims=(-2, -1))
            keep &= (score > neigh) if (dy, dx) < (0, 0) else (score >= neigh)
    return torch.where(keep, score, torch.zeros((), device=score.device))
