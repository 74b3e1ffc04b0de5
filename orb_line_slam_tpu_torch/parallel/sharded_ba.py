"""Distributed bundle adjustment: landmark-sharded Schur reduction.

Port of ``orb_line_slam_tpu/parallel/sharded_ba.py``: ``_ba_shard_body``
(34-124) with ``make_distributed_ba`` (339-366), ``_cg_shard_body``
(127-261) with ``make_distributed_ba_cg`` (264-289), and
``shard_gba_pack`` (292-336).  Keyframes are replicated; landmarks and
their observations are split over the slots of a ``ShardMesh``
(``parallel/multihost.py``), and each shard computes the partial camera
Hessian and Schur terms of its own landmark block.  The partials are
summed with ``ShardMesh.psum`` at exactly the JAX package's ``psum``
sites, so the camera system, never the observations, crosses devices
and processes:

    S = psum_d( Hcc_d - B_d Hpp_d^-1 B_d^T ),   dc = S^-1 rhs (replicated)
    dp_d = -Hpp_d^-1 (gp_d + B_d^T dc)          (local, no communication)

The JAX shard bodies run under ``shard_map`` on every device at once;
here a Python loop issues each local shard's work in turn.  Replicated
values (poses, the LM damping, the camera system and its solve, the CG
vectors) are computed once per process on the mesh's home device from
reduced values that are identical on every rank, so every rank takes the
same accept branch and issues the same collectives.  The math is
``backend/local_ba.py`` and ``backend/global_ba.py``'s (same residuals,
weights and gating, segment sums by ``index_put_``); the CG has a fixed
iteration count and no data-dependent exit, so no rank can leave a
collective early.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend.assembly import inv33
from ..backend.local_ba import _segment_sum
from ..backend.residuals import inv_level_sigma2, point_residual, point_residual_and_jacobians
from ..backend.robust import CHI2_MONO, CHI2_STEREO, huber_weight
from ..config import CameraIntrinsics
from ..geometry.se3 import se3_compose, se3_exp
from .multihost import ShardMesh, make_global_array


class _Shard:
    """One local landmark shard: its observations (``ol`` indexes the
    shard's own points) and the per-observation constants."""

    def __init__(self, points, point_valid, obs_cam, obs_lm, obs_uvur, obs_oct, obs_valid, scale_factor):
        self.dev = points.device
        self.points0 = points
        self.point_valid = point_valid
        self.n_points = points.shape[0]
        self.oc = obs_cam.long()
        self.ol = obs_lm.long()
        self.uvur = obs_uvur
        self.is_stereo = obs_uvur[:, 2] > 0
        self.info = inv_level_sigma2(obs_oct, scale_factor)
        self.chi2_th = torch.where(self.is_stereo, CHI2_STEREO, CHI2_MONO)
        self.obs_valid = obs_valid & point_valid[self.ol]
        self.zero = torch.zeros((), dtype=points.dtype, device=self.dev)
        self.eye3 = torch.eye(3, dtype=points.dtype, device=self.dev)


def _shards(mesh: ShardMesh, args, scale_factor) -> list[_Shard]:
    """The local shards of the sharded inputs, each a whole array (numpy
    or a tensor) identical in every process, split here by slot."""
    per = [make_global_array(mesh, a) for a in args]
    return [_Shard(*(p[i] for p in per), scale_factor) for i in range(mesh.n_local)]


def _replicated(mesh: ShardMesh, *xs):
    return tuple((x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))).to(mesh.home) for x in xs)


def _mv(A, x):
    return (A @ x[..., None])[..., 0]


def _chi2(cam, R, t, points, sh: _Shard, use_huber):
    """Per-observation chi2 of one shard and its Huber weights."""
    r = point_residual(cam, R.to(sh.dev)[sh.oc], t.to(sh.dev)[sh.oc], points[sh.ol], sh.uvur, sh.is_stereo)
    c = torch.sum(r * r, dim=-1) * sh.info
    return c, (huber_weight(c, CHI2_STEREO) if use_huber else torch.ones_like(c))


def _total_chi2(mesh, cam, R, t, points, shards, o_valid, use_huber):
    """(psum of the shards' weighted chi2, each shard's chi2)."""
    parts, cs = [], []
    for sh, p, ov in zip(shards, points, o_valid):
        c, w = _chi2(cam, R, t, p, sh, use_huber)
        parts.append(torch.sum(torch.where(ov, c * w, sh.zero)))
        cs.append(c)
    return mesh.psum(parts), cs


def _accept(accept, R, t, points, R2, t2, points2):
    R = torch.where(accept, R2, R)
    t = torch.where(accept, t2, t)
    points = [torch.where(accept.to(p.device), p2, p) for p, p2 in zip(points, points2)]
    return R, t, points


def distributed_ba(mesh: ShardMesh, cam: CameraIntrinsics, R, t, cam_fixed, points, point_valid, obs_cam,
                   obs_lm_local, obs_uvur, obs_oct, obs_valid, scale_factor=1.2, n_iters=10):
    """One robust stage of n_iters LM iterations of the dense-Schur BA over
    the mesh (``_ba_shard_body``).  Returns (R, t, points), the points of
    the local shards concatenated."""
    R, t, cam_fixed = _replicated(mesh, R, t, cam_fixed)
    shards = _shards(mesh, (points, point_valid, obs_cam, obs_lm_local, obs_uvur, obs_oct, obs_valid), scale_factor)
    home, dt_ = mesh.home, R.dtype
    C = R.shape[0]
    free_c = (~cam_fixed).to(dt_)[:, None]
    m = free_c[:, 0].repeat_interleave(6)
    eye6 = torch.eye(6, dtype=dt_, device=home)
    o_valid = [sh.obs_valid for sh in shards]
    pts = [sh.points0 for sh in shards]
    lam = torch.tensor(1e-4, dtype=dt_, device=home)
    for _ in range(n_iters):
        S_parts, rhs_parts, per = [], [], []
        for sh, p in zip(shards, pts):
            Pl, dev = sh.n_points, sh.dev
            r, Jc, Jp = point_residual_and_jacobians(cam, R.to(dev)[sh.oc], t.to(dev)[sh.oc], p[sh.ol], sh.uvur,
                                                     sh.is_stereo)
            c = torch.sum(r * r, dim=-1) * sh.info
            w = torch.where(sh.obs_valid, sh.info * huber_weight(c, CHI2_STEREO), sh.zero)[:, None, None]
            JcT = Jc.transpose(-1, -2) * w                   # [O,6,3]
            JpT = Jp.transpose(-1, -2) * w                   # [O,3,3]
            Hcc = _segment_sum(sh.oc, JcT @ Jc, C)
            Hpp = _segment_sum(sh.ol, JpT @ Jp, Pl)
            B = _segment_sum(sh.ol * C + sh.oc, JcT @ Jp, Pl * C).reshape(Pl, C, 6, 3)
            gc = _segment_sum(sh.oc, _mv(JcT, r), C)
            gp = _segment_sum(sh.ol, _mv(JpT, r), Pl)
            lam_d = lam.to(dev)
            Hcc = Hcc + lam_d * Hcc * eye6.to(dev)
            Hpp = Hpp + lam_d * Hpp * sh.eye3
            Hpp = Hpp + (1e-6 + (~sh.point_valid).to(dt_)[:, None, None]) * sh.eye3
            V = inv33(Hpp)
            Wp = torch.einsum("pcij,pjk->pcik", B, V)
            A1 = Wp.permute(1, 2, 0, 3).reshape(C * 6, Pl * 3)
            A2 = B.permute(1, 2, 0, 3).reshape(C * 6, Pl * 3)
            S_parts.append(torch.block_diag(*Hcc) - A1 @ A2.T)
            rhs_parts.append(-(gc - torch.einsum("pcik,pk->ci", Wp, gp)).reshape(C * 6))
            per.append((V, B, gp))
        # The only cross-shard communication: reduce the camera system.
        S = mesh.psum(S_parts)
        rhs = mesh.psum(rhs_parts)
        S = S + 1e-8 * torch.eye(C * 6, dtype=dt_, device=home)
        S = S * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        rhs = rhs * m
        dc = torch.linalg.solve_ex(S, rhs)[0].reshape(C, 6)    # LU, as jnp.linalg.solve
        pts2 = []
        for sh, p, (V, B, gp) in zip(shards, pts, per):
            dc_d = dc.to(sh.dev)
            dp = -_mv(V, gp + torch.einsum("pcij,ci->pj", B, dc_d)) * sh.point_valid[:, None]
            pts2.append(p + dp)
        dR, dt = se3_exp(dc * free_c)
        R2, t2 = se3_compose(dR, dt, R, t)
        err0, _ = _total_chi2(mesh, cam, R, t, pts, shards, o_valid, True)
        err1, _ = _total_chi2(mesh, cam, R2, t2, pts2, shards, o_valid, True)
        accept = err1 < err0
        R, t, pts = _accept(accept, R, t, pts, R2, t2, pts2)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
    return R, t, torch.cat([p.to(home) for p in pts])


def distributed_ba_cg(mesh: ShardMesh, cam: CameraIntrinsics, R, t, cam_fixed, points, point_valid, obs_cam,
                      obs_lm_local, obs_uvur, obs_oct, obs_valid, scale_factor=1.2, iters1=5, iters2=10,
                      cg_iters=48):
    """Landmark-sharded matrix-free CG-on-Schur LM over the mesh
    (``_cg_shard_body``): the distributed ``bundle_adjust_cg``.  Per LM
    iteration one psum of Hcc [C,6,6], one of gc [C,6], one [C,6] psum of
    ``b_z`` for the rhs and one per CG step, and one per chi2; ``bt_x``,
    Hpp, gp and the back-substitution stay on their shard.  Returns
    (R, t, points, obs_inlier, chi2); points and obs_inlier are the local
    shards' concatenated."""
    R0, t0, cam_fixed = _replicated(mesh, R, t, cam_fixed)
    shards = _shards(mesh, (points, point_valid, obs_cam, obs_lm_local, obs_uvur, obs_oct, obs_valid), scale_factor)
    home, dt_ = mesh.home, R0.dtype
    C = R0.shape[0]
    m = (~cam_fixed).to(dt_)[:, None]                    # [C,1] 1 = free
    eye6 = torch.eye(6, dtype=dt_, device=home)
    zero = torch.zeros((), dtype=dt_, device=home)

    def lm_iteration(R, t, pts, lam, o_valid, use_huber):
        Hcc_p, gc_p, per = [], [], []
        for sh, p, ov in zip(shards, pts, o_valid):
            dev = sh.dev
            r, Jc, Jp = point_residual_and_jacobians(cam, R.to(dev)[sh.oc], t.to(dev)[sh.oc], p[sh.ol], sh.uvur,
                                                     sh.is_stereo)
            c = torch.sum(r * r, dim=-1) * sh.info
            hw = huber_weight(c, CHI2_STEREO) if use_huber else torch.ones_like(c)
            w = torch.where(ov, sh.info * hw, sh.zero)[:, None, None]
            JcT = Jc.transpose(-1, -2) * w               # [O,6,3]
            JpT = Jp.transpose(-1, -2) * w               # [O,3,3]
            Hcc_p.append(_segment_sum(sh.oc, JcT @ Jc, C))
            gc_p.append(_segment_sum(sh.oc, _mv(JcT, r), C))
            Hpp = _segment_sum(sh.ol, JpT @ Jp, sh.n_points)
            gp = _segment_sum(sh.ol, _mv(JpT, r), sh.n_points)
            lam_d = lam.to(dev)
            Hpp = Hpp + lam_d * Hpp * sh.eye3
            Hpp = Hpp + (1e-6 + (~sh.point_valid).to(dt_)[:, None, None]) * sh.eye3
            per.append((JcT @ Jp, inv33(Hpp), gp, torch.sum(torch.where(ov, c * hw, sh.zero))))
        # Camera blocks: local partials reduced over the mesh.
        Hcc = mesh.psum(Hcc_p)
        gc = mesh.psum(gc_p)
        Hcc = Hcc + lam * Hcc * eye6 + 1e-8 * eye6

        def bt_x(x):
            """B^T x per shard: [C,6] -> [Pl,3], one local observation sweep."""
            out = []
            for sh, (JcT_Jp, _, _, _) in zip(shards, per):
                x_d = x.to(sh.dev)
                out.append(_segment_sum(sh.ol, (x_d[sh.oc][:, None, :] @ JcT_Jp)[:, 0], sh.n_points))
            return out

        def b_z(zs):
            """B z: the shards' [Pl,3] -> [C,6], reduced over the mesh."""
            return mesh.psum([_segment_sum(sh.oc, _mv(JcT_Jp, z[sh.ol]), C)
                              for sh, (JcT_Jp, _, _, _), z in zip(shards, per, zs)])

        def s_matvec(x):
            """Schur product S x with fixed cameras as identity rows."""
            xm = x * m
            zs = [_mv(V, y) for (_, V, _, _), y in zip(per, bt_x(xm))]
            sx = (_mv(Hcc, xm) - b_z(zs)) * m
            return sx + x * (1.0 - m)

        rhs = -(gc - b_z([_mv(V, gp) for _, V, gp, _ in per])) * m
        Minv = torch.linalg.inv(Hcc + 1e-6 * eye6)

        def precond(v):
            return _mv(Minv, v * m) * m + v * (1.0 - m)

        x = torch.zeros_like(rhs)
        rr = rhs
        p = precond(rhs)
        rz = torch.sum(rhs * p)
        for _ in range(cg_iters):
            Ap = s_matvec(p)
            pAp = torch.sum(p * Ap)
            alpha = torch.where(pAp > 1e-20, rz / pAp, zero)
            x = x + alpha * p
            rr = rr - alpha * Ap
            z = precond(rr)
            rz_new = torch.sum(rr * z)
            beta = torch.where(rz > 1e-20, rz_new / rz, zero)
            p = z + beta * p
            rz = rz_new
        dc = x * m

        # Landmark back-substitution, per shard: dp = -V (gp + B^T dc).
        pts2 = [q - _mv(V, gp + y) * sh.point_valid[:, None]
                for q, sh, (_, V, gp, _), y in zip(pts, shards, per, bt_x(dc))]
        dR, dt = se3_exp(dc * m)
        R2, t2 = se3_compose(dR, dt, R, t)
        err0 = mesh.psum([e for _, _, _, e in per])
        err1, _ = _total_chi2(mesh, cam, R2, t2, pts2, shards, o_valid, use_huber)
        accept = err1 < err0
        R, t, pts = _accept(accept, R, t, pts, R2, t2, pts2)
        lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 5.0), 1e-9, 1e5)
        return R, t, pts, lam

    def run_stage(R, t, pts, o_valid, n_iters, use_huber):
        lam = torch.tensor(1e-4, dtype=dt_, device=home)
        for _ in range(n_iters):
            R, t, pts, lam = lm_iteration(R, t, pts, lam, o_valid, use_huber)
        return R, t, pts

    o_valid = [sh.obs_valid for sh in shards]
    R, t, pts = run_stage(R0, t0, [sh.points0 for sh in shards], o_valid, iters1, True)
    _, cs = _total_chi2(mesh, cam, R, t, pts, shards, o_valid, False)
    o_valid = [sh.obs_valid & (c <= sh.chi2_th) for sh, c in zip(shards, cs)]
    R, t, pts = run_stage(R, t, pts, o_valid, iters2, False)
    err, cs = _total_chi2(mesh, cam, R, t, pts, shards, o_valid, False)
    o_valid = [sh.obs_valid & (c <= sh.chi2_th) for sh, c in zip(shards, cs)]
    # The local shards' concatenated on the home device (in a one-process
    # mesh: the whole sharded arrays).
    return (R, t, torch.cat([p.to(home) for p in pts]), torch.cat([o.to(home) for o in o_valid]), err)


def make_distributed_ba(mesh: ShardMesh, cam: CameraIntrinsics, scale_factor=1.2, n_iters=10):
    """The landmark-sharded dense BA over ``mesh`` as a function of the
    ten solver inputs (R, t, cam_fixed replicated; points, point_valid
    and the observation arrays sharded, obs_lm LOCAL to each shard)."""
    return lambda *args: distributed_ba(mesh, cam, *args, scale_factor=scale_factor, n_iters=n_iters)


def make_distributed_ba_cg(mesh: ShardMesh, cam: CameraIntrinsics, scale_factor=1.2, iters1=5, iters2=10,
                           cg_iters=48):
    """The landmark-sharded CG-Schur BA over ``mesh`` as a function of the
    ten solver inputs, laid out as ``make_distributed_ba``'s.  Returns
    (R, t, points, obs_inlier, chi2)."""
    return lambda *args: distributed_ba_cg(mesh, cam, *args, scale_factor=scale_factor, iters1=iters1,
                                           iters2=iters2, cg_iters=cg_iters)


def shard_gba_pack(pack, n_shards: int):
    """Regroup a ``pack_local_ba(all_free=True)`` problem for the sharded
    adjusters: pad the landmarks to a multiple of n_shards (shard d holds
    landmarks d * p_per .. (d + 1) * p_per - 1, p_per = ceil(P / n)),
    route each valid observation to its landmark's shard, and pad every
    shard's observation list to the largest shard's count (the JAX
    package pads to a power-of-two bucket for its compiler).  Returns
    (args, meta): numpy arrays in the order of the solvers' inputs, and
    what maps the results back to the pack (``unshard_result``)."""
    P_tot = pack["points"].shape[0]
    p_per = -(-P_tot // n_shards)
    P_pad = p_per * n_shards
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:P_tot] = pack["points"]
    pval = np.zeros(P_pad, bool)
    pval[:P_tot] = pack["point_valid"]

    ov = np.asarray(pack["obs_valid"], bool)
    shard_of = np.asarray(pack["obs_lm"]) // p_per
    counts = np.bincount(shard_of[ov], minlength=n_shards)
    o_per = max(int(counts.max()), 1)
    oc = np.zeros((n_shards, o_per), np.int32)
    ol = np.zeros((n_shards, o_per), np.int32)
    ouv = np.zeros((n_shards, o_per, 3), np.float32)
    ooct = np.zeros((n_shards, o_per), np.int32)
    oval = np.zeros((n_shards, o_per), bool)
    order = np.zeros((n_shards, o_per), np.int64)
    for d in range(n_shards):
        rows = np.nonzero(ov & (shard_of == d))[0]
        n = len(rows)
        oc[d, :n] = pack["obs_cam"][rows]
        ol[d, :n] = pack["obs_lm"][rows] - d * p_per
        ouv[d, :n] = pack["obs_uvur"][rows]
        ooct[d, :n] = pack["obs_oct"][rows]
        oval[d, :n] = True
        order[d, :n] = rows
    args = (np.asarray(pack["R"], np.float32), np.asarray(pack["t"], np.float32), np.asarray(pack["cam_fixed"], bool),
            pts, pval, oc.reshape(-1), ol.reshape(-1), ouv.reshape(-1, 3), ooct.reshape(-1), oval.reshape(-1))
    meta = {"P_tot": P_tot, "p_per": p_per, "order": order, "oval": oval, "o_per": o_per}
    return args, meta


def unshard_result(points, obs_inlier, meta, n_obs: int):
    """The sharded solve's points without the shard padding, and its
    inlier flags back in pack order (``_ShardedGBAResult`` of the JAX
    ``loop_closing.py:42-68``), as numpy; observations that were not
    valid in the pack are False."""
    grid = np.asarray(obs_inlier).reshape(meta["order"].shape)
    out = np.zeros(n_obs, bool)
    ok = meta["oval"]
    out[meta["order"][ok]] = grid[ok]
    return np.asarray(points)[: meta["P_tot"]], out
