"""Sim3 pose-graph (essential-graph) optimization.

Port of ``orb_line_slam_tpu/backend/pose_graph.py:43-127``
(``optimize_pose_graph``): 7-DoF Sim3 vertices per keyframe slot, edges
from the spanning tree, strong covisibility and loops; fixed vertices
pinned; 20 Levenberg-Marquardt iterations.

Residual of edge (i, j) with measurement S_ji (j <- i):
    r = log( S_ji_meas^-1 o S_j o S_i^-1 )   in R^7
The per-edge 7x7 Jacobians are forward-mode derivatives through the
retraction (``torch.func.jacfwd``), as in the JAX package.
The normal system [7K, 7K] is assembled from the edges by one sorted
segment sum over block indices (no atomics, so the solve is the same
from run to run) and solved densely with ``torch.linalg.solve``.  Only
the live edges are passed; K stays the keyframe table's capacity
because slot ids index it.
"""

from __future__ import annotations

import torch

from ..geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log
from ..utils.worker import FORWARD_AD_LOCK
from .local_ba import _segment_sum


def _edge_residual(s_i, R_i, t_i, s_j, R_j, t_j, sm, Rm, tm):
    """r = log(S_meas^-1 o S_j o S_i^-1), measurement S_meas = S_j S_i^-1."""
    s_ji, R_ji, t_ji = sim3_compose(s_j, R_j, t_j, *sim3_inverse(s_i, R_i, t_i))
    return sim3_log(*sim3_compose(*sim3_inverse(sm, Rm, tm), s_ji, R_ji, t_ji))


def edge_residuals_and_jacobians(s, R, t, edge_i, edge_j, edge_s, edge_R, edge_t):
    """(r [E, 7], Ji [E, 7, 7], Jj [E, 7, 7]): each edge's residual and its
    Jacobians w.r.t. the left tangents of vertices i and j at zero.  The
    edges are independent, so one tangent direction shared by all edges
    gives that column of every edge's Jacobian: ``jacfwd`` runs over one
    14-vector and the edge axis stays an ordinary batch axis."""
    E = edge_i.shape[0]
    Si = (s[edge_i], R[edge_i], t[edge_i])
    Sj = (s[edge_j], R[edge_j], t[edge_j])

    def f(d):
        a = sim3_compose(*sim3_exp(d[:7].expand(E, 7)), *Si)
        b = sim3_compose(*sim3_exp(d[7:].expand(E, 7)), *Sj)
        return _edge_residual(*a, *b, edge_s, edge_R, edge_t)

    d0 = torch.zeros(14, dtype=R.dtype, device=R.device)
    with FORWARD_AD_LOCK:
        J = torch.func.jacfwd(f)(d0)                                 # [E, 7, 14]
    return f(d0), J[..., :7], J[..., 7:]


def optimize_pose_graph(
    s0: torch.Tensor,           # [K] initial scales
    R0: torch.Tensor,           # [K, 3, 3]
    t0: torch.Tensor,           # [K, 3]
    kf_valid: torch.Tensor,     # [K]
    fixed: torch.Tensor,        # [K] bool (loop keyframe and any anchors)
    edge_i: torch.Tensor,       # [E] int
    edge_j: torch.Tensor,       # [E]
    edge_s: torch.Tensor,       # [E] measured relative Sim3 (j <- i)
    edge_R: torch.Tensor,       # [E, 3, 3]
    edge_t: torch.Tensor,       # [E, 3]
    edge_valid: torch.Tensor,   # [E]
    edge_weight: torch.Tensor,  # [E]
    n_iters: int = 20,
    fix_scale: bool = True,
):
    """Returns optimized (s, R, t). fix_scale=True pins every scale DoF
    (stereo/RGB-D mode)."""
    K = s0.shape[0]
    dt_, dev = R0.dtype, R0.device
    ei, ej = edge_i.long(), edge_j.long()
    w = torch.where(edge_valid, edge_weight, torch.zeros((), dtype=dt_, device=dev))
    block = torch.cat([ei * K + ei, ej * K + ej, ei * K + ej, ej * K + ei])
    vert = torch.cat([ei, ej])

    m = ((~fixed) & kf_valid).to(dt_).repeat_interleave(7)
    if fix_scale:
        # pin the sigma (log-scale) coordinate of every vertex
        m = m * torch.tensor([1, 1, 1, 1, 1, 1, 0], dtype=dt_, device=dev).repeat(K)
    eye = torch.eye(7 * K, dtype=dt_, device=dev)

    def error(r):
        return torch.sum(torch.sum(r * r, -1) * w)

    def residuals(s, R, t):
        return _edge_residual(s[ei], R[ei], t[ei], s[ej], R[ej], t[ej], edge_s, edge_R, edge_t)

    s, R, t = s0, R0, t0
    lam = torch.tensor(1e-6, dtype=dt_, device=dev)
    for _ in range(n_iters):
        r, Ji, Jj = edge_residuals_and_jacobians(s, R, t, ei, ej, edge_s, edge_R, edge_t)
        JiT = Ji.transpose(-1, -2) * w[:, None, None]
        JjT = Jj.transpose(-1, -2) * w[:, None, None]
        JiTJj = JiT @ Jj
        blocks = torch.cat([JiT @ Ji, JjT @ Jj, JiTJj, JiTJj.transpose(-1, -2)])
        Hf = _segment_sum(block, blocks, K * K).reshape(K, K, 7, 7).permute(0, 2, 1, 3).reshape(7 * K, 7 * K)
        g = _segment_sum(vert, torch.cat([JiT @ r[..., None], JjT @ r[..., None]])[..., 0], K)

        Hf = Hf + lam * torch.diag(torch.diag(Hf)) + 1e-8 * eye
        Hf = Hf * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        dx = -torch.linalg.solve(Hf, g.reshape(-1) * m).reshape(K, 7)

        s2, R2, t2 = sim3_compose(*sim3_exp(dx), s, R, t)
        accept = error(residuals(s2, R2, t2)) < error(r)
        s = torch.where(accept, s2, s)
        R = torch.where(accept, R2, R)
        t = torch.where(accept, t2, t)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-10, 1e5)
    return s, R, t
