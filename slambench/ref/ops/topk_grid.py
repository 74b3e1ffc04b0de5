# Frozen copy of orb_line_slam_tpu_torch/ops/topk_grid.py at commit d30c4f7 (the benchmark's plain reference).
"""Spatially distributed keypoint selection: per-cell top-K + global
top-N.

Port of ``orb_line_slam_tpu/ops/topk_grid.py:18-76``.  ``lax.top_k``
breaks ties toward the lower index; ``torch.topk`` does not, and FAST
scores on integer images tie constantly, so selection here is a stable
descending sort truncated to k, which keeps the lower index first.
Scores may carry a leading batch dim.
"""

from __future__ import annotations

import torch


def _topk_stable(x: torch.Tensor, k: int):
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_topk_grid(
    score: torch.Tensor,
    cell: int,
    k_per_cell: int,
    n_total: int,
    min_score: float,
):
    """Up to n_total keypoints from a dense [..., H, W] score map.

    Returns (xy int32 [..., n_total, 2] (x, y), resp float32 [..., n_total],
    valid bool [..., n_total]); invalid rows are zero."""
    squeeze = score.dim() == 2
    s = score[None] if squeeze else score
    b, h, w = s.shape
    hc, wc = -(-h // cell), -(-w // cell)
    s = torch.nn.functional.pad(s, (0, wc * cell - w, 0, hc * cell - h))
    cells = s.reshape(b, hc, cell, wc, cell).permute(0, 1, 3, 2, 4).reshape(b, hc * wc, cell * cell)
    vals, idx = _topk_stable(cells, k_per_cell)          # [b, ncells, k]

    cell_ids = torch.arange(hc * wc, device=s.device)[:, None]
    gy = (cell_ids // wc) * cell + idx // cell
    gx = (cell_ids % wc) * cell + idx % cell
    flat_vals = vals.reshape(b, -1)
    flat_x = gx.reshape(b, -1)
    flat_y = gy.reshape(b, -1)
    flat_valid = (flat_vals > min_score) & (flat_x < w) & (flat_y < h)
    keyed = torch.where(flat_valid, flat_vals, torch.full_like(flat_vals, -torch.inf))
    n_cand = keyed.shape[1]
    if n_cand < n_total:
        padn = n_total - n_cand
        keyed = torch.nn.functional.pad(keyed, (0, padn), value=-torch.inf)
        flat_x = torch.nn.functional.pad(flat_x, (0, padn))
        flat_y = torch.nn.functional.pad(flat_y, (0, padn))
        flat_vals = torch.nn.functional.pad(flat_vals, (0, padn))
    top_vals, top_idx = _topk_stable(keyed, n_total)
    xy = torch.stack([flat_x.gather(1, top_idx), flat_y.gather(1, top_idx)], dim=-1)
    resp = flat_vals.gather(1, top_idx)
    valid = torch.isfinite(top_vals)
    xy = torch.where(valid[..., None], xy, torch.zeros_like(xy)).to(torch.int32)
    resp = torch.where(valid, resp, torch.zeros_like(resp))
    if squeeze:
        return xy[0], resp[0], valid[0]
    return xy, resp, valid
