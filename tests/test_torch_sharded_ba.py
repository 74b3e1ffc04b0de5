"""The port's landmark-sharded bundle adjusters and the LoopCloser's
sharded route against the JAX package's, in one process: JAX on the
8-device CPU mesh of tests/conftest.py (``Mesh(jax.devices()[:n])``
where a case needs n < 8), the port on a CPU ``ShardMesh`` of the same
count, both fed the same numpy arrays.

Pose contract (tests/test_tpu_parity.py's): poses within 1e-3 rad and
5e-3 m; points as tests/test_torch_loop_solvers.py's CG parity (within
1e-3 m nearer than 15 m, median within 1e-4 m); inlier counts within 3;
chi2 within 1e-3 relative + 1e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orb_line_slam_tpu.loop.loop_closing import LoopCloser as JaxLoopCloser
from orb_line_slam_tpu.loop.loop_closing import _ShardedGBAResult
from orb_line_slam_tpu.parallel import sharded_ba as jax_sharded
from orb_line_slam_tpu_torch.backend.global_ba import bundle_adjust_cg
from orb_line_slam_tpu_torch.config import CameraIntrinsics as TorchCam
from orb_line_slam_tpu_torch.convert import config_from_jax, map_store_from_numpy, vocabulary_from_numpy
from orb_line_slam_tpu_torch.loop.loop_closing import LoopCloser, sharded_gauge
from orb_line_slam_tpu_torch.parallel.multihost import ShardMesh, device_mesh, make_global_array
from orb_line_slam_tpu_torch.parallel.sharded_ba import (
    distributed_ba,
    distributed_ba_cg,
    make_distributed_ba,
    make_distributed_ba_cg,
    shard_gba_pack,
    unshard_result,
)
from tests.test_local_ba import CAM, make_ba_problem

torch.set_num_threads(1)
TCAM = TorchCam(*CAM)
KEYS = ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam", "obs_lm", "obs_uvur", "obs_oct", "obs_valid")


def jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("dp",))


def rot_angle(Ra, Rb):
    """Largest rotation angle (rad) between matching rotations of two stacks."""
    d = np.einsum("cij,ckj->cik", np.asarray(Ra, np.float64), np.asarray(Rb, np.float64))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], -1)
    return float(np.arcsin(np.clip(np.linalg.norm(w, axis=1) / 2, 0, 1)).max())


def assert_pose_contract(a, b, z=None, pose_tol=(1e-3, 5e-3)):
    """a, b: (R, t, points, obs_inlier, chi2) as numpy.  Points are held
    to the CG parity bound when their depths z are given."""
    rad, m = pose_tol
    assert rot_angle(a[0], b[0]) < rad
    assert np.abs(a[1] - b[1]).max() < m
    if z is not None:
        d = np.linalg.norm(a[2] - b[2], axis=1)
        assert d[z < 15].max() < 1e-3 and np.median(d) < 1e-4, (d.max(), np.median(d))
    if a[3] is not None:
        assert abs(int(a[3].sum()) - int(b[3].sum())) <= 3
        assert abs(float(a[4]) - float(b[4])) < 1e-3 * abs(float(b[4])) + 1e-2


def numpy_out(out):
    return tuple(None if x is None else np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x) for x in out)


def cg_problem(C=6, P=128, seed=1, noise_px=0.4):
    """make_ba_problem with pixel noise, perturbed landmarks and two fixed
    cameras, as a pack dict."""
    R, t, pts, oc, ol, obs, octv = (np.asarray(a) for a in make_ba_problem(C=C, P=P, seed=seed, noise_px=noise_px))
    rng = np.random.default_rng(seed)
    pts0 = (pts + rng.normal(0, 0.08, pts.shape)).astype(np.float32)
    fixed = np.zeros(C, bool)
    fixed[:2] = True
    pack = dict(R=R, t=t, cam_fixed=fixed, points=pts0, point_valid=np.ones(P, bool), obs_cam=oc, obs_lm=ol,
                obs_uvur=obs, obs_oct=octv, obs_valid=np.ones(len(oc), bool))
    return pack, pts


def dropped_pack(n_points=101, seed=7):
    """A pack with invalid observations, an invalid landmark and P not a
    multiple of the shard counts."""
    R, t, pts, oc, ol, obs, octv = (np.asarray(a) for a in make_ba_problem(C=5, P=n_points, seed=seed))
    rng = np.random.default_rng(seed)
    O = len(oc)
    ov = rng.random(O) > 0.15
    pv = np.ones(n_points, bool)
    pv[3] = False
    return dict(R=R, t=t, cam_fixed=np.array([True] + [False] * 4), points=pts, point_valid=pv, obs_cam=oc,
                obs_lm=ol, obs_uvur=obs, obs_oct=rng.integers(0, 3, O).astype(np.int32), obs_valid=ov)


@pytest.mark.parametrize("n", [1, 3, 4, 8])
def test_shard_gba_pack_matches_jax(n):
    """The same landmark split (p_per), the same valid rows on each shard
    in the same order, and the same remap back to pack order as the JAX
    package's shard_gba_pack; the JAX observation bucket is a power of
    two, the port's the largest shard's count."""
    pack = dropped_pack()
    args, meta = shard_gba_pack(pack, n)
    jargs, jmeta = jax_sharded.shard_gba_pack(pack, n)
    jargs = [np.asarray(a) for a in jargs]
    assert meta["P_tot"] == jmeta["P_tot"] == 101
    assert meta["p_per"] == len(jargs[3]) // n == -(-101 // n)
    for a, b in zip(args[:5], jargs[:5]):
        assert np.array_equal(a, b)
    counts = meta["oval"].sum(1)
    assert meta["o_per"] == counts.max() and np.array_equal(counts, jmeta["oval"].sum(1))
    for d in range(n):
        k = counts[d]
        assert np.array_equal(meta["order"][d, :k], jmeta["order"][d, :k])
        assert meta["oval"][d, :k].all() and not meta["oval"][d, k:].any()
        for i in range(5, 10):
            a = args[i].reshape(n, meta["o_per"], -1)[d, :k]
            b = jargs[i].reshape(n, jmeta["o_per"], -1)[d, :k]
            assert np.array_equal(a, b)
    # The remap: one flag per pack row, read through each package's grid.
    flag = np.arange(len(pack["obs_cam"])) % 3 != 0
    grid = np.where(meta["oval"], flag[meta["order"]], False)
    jgrid = np.where(jmeta["oval"], flag[jmeta["order"]], False)
    pts, inl = unshard_result(np.zeros((len(args[3]), 3)), grid.reshape(-1), meta, len(flag))
    jres = _ShardedGBAResult(None, None, np.zeros((len(jargs[3]), 3)), jgrid.reshape(-1), None, pack, jmeta)
    assert np.array_equal(inl, jres.obs_inlier) and np.array_equal(inl, flag & pack["obs_valid"])
    assert pts.shape == jres.points.shape == (101, 3)


def test_sharded_dense_ba_matches_jax():
    """make_distributed_ba on 8 shards against the JAX package's on its
    8-device mesh (tests/test_distributed_ba.py's problem: C = 5, P = 96,
    8 iterations of one robust stage); both converge to the truth as that
    test asserts."""
    R_gt, t_gt, pts_gt, oc, ol, obs, octv = (np.asarray(a) for a in make_ba_problem(C=5, P=96))
    rng = np.random.default_rng(0)
    pts0 = (pts_gt + rng.normal(0, 0.08, pts_gt.shape)).astype(np.float32)
    pack = dict(R=R_gt, t=t_gt, cam_fixed=np.array([True, True, False, False, False]), points=pts0,
                point_valid=np.ones(96, bool), obs_cam=oc, obs_lm=ol, obs_uvur=obs, obs_oct=octv,
                obs_valid=np.ones(len(oc), bool))
    args, _ = shard_gba_pack(pack, 8)
    Rj, tj, pj = (np.asarray(x) for x in jax_sharded.make_distributed_ba(jax_mesh(8), CAM, n_iters=8)(
        *(jnp.asarray(a) for a in args)))
    Rt, tt, pt = (x.numpy() for x in make_distributed_ba(device_mesh("cpu", 8), TCAM, n_iters=8)(*args))
    assert_pose_contract((Rt, tt, pt, None, None), (Rj, tj, pj, None, None), z=args[3][:, 2])
    for R2, t2, p2 in ((Rt, tt, pt), (Rj, tj, pj)):
        np.testing.assert_allclose(R2, R_gt, atol=5e-3)
        np.testing.assert_allclose(t2, t_gt, atol=3e-2)
        assert np.median(np.linalg.norm(p2 - pts_gt, axis=-1)) < 0.03


def test_sharded_cg_matches_jax_and_single_solver():
    """make_distributed_ba_cg on 8 shards (C = 6, P = 128, 3 LM x 36 CG,
    one robust stage as tests/test_distributed_ba.py) against the JAX
    package's on its 8-device mesh, and against the port's single-device
    bundle_adjust_cg (cameras within 2e-3 m, points within 5e-3 m, as
    that test holds the JAX pair)."""
    pack, _ = cg_problem()
    args, meta = shard_gba_pack(pack, 8)
    out_j = numpy_out(jax_sharded.make_distributed_ba_cg(jax_mesh(8), CAM, iters1=3, iters2=0, cg_iters=36)(
        *(jnp.asarray(a) for a in args)))
    out_t = numpy_out(make_distributed_ba_cg(device_mesh("cpu", 8), TCAM, iters1=3, iters2=0, cg_iters=36)(*args))
    assert_pose_contract(out_t, out_j, z=args[3][:, 2])
    ref = numpy_out(bundle_adjust_cg(*(torch.from_numpy(np.array(pack[k])) for k in KEYS), TCAM, iters1=3,
                                     iters2=0, cg_iters=36))
    np.testing.assert_allclose(out_t[1], ref[1], atol=2e-3)
    pts, inl = unshard_result(out_t[2], out_t[3], meta, len(pack["obs_cam"]))
    np.testing.assert_allclose(pts, ref[2], atol=5e-3)
    assert np.isfinite(out_t[4]) and abs(int(inl.sum()) - int(ref[3].sum())) <= 3


@pytest.fixture(scope="module")
def by_shards():
    """The two-stage CG (3 + 2 LM x 36 CG) of one noisy problem on 1, 2,
    4 and 8 CPU shards, unsharded to pack order."""
    pack, _ = cg_problem(C=6, P=128, seed=4)
    out = {}
    for n in (1, 2, 4, 8):
        args, meta = shard_gba_pack(pack, n)
        R, t, pts, inl, chi2 = numpy_out(distributed_ba_cg(device_mesh("cpu", n), TCAM, *args, iters1=3, iters2=2,
                                                           cg_iters=36))
        pts, inl = unshard_result(pts, inl, meta, len(pack["obs_cam"]))
        out[n] = (R, t, pts, inl, chi2)
    return pack, out


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_counts_agree(by_shards, n):
    pack, out = by_shards
    assert_pose_contract(out[n], out[1], z=pack["points"][:, 2])


def test_one_shard_equals_single_solver(by_shards):
    """One shard is bundle_adjust_cg with the same gauge, to 1e-5."""
    pack, out = by_shards
    ref = numpy_out(bundle_adjust_cg(*(torch.from_numpy(np.array(pack[k])) for k in KEYS), TCAM, iters1=3,
                                     iters2=2, cg_iters=36))
    for a, b in zip(out[1], ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=1e-6)


def test_reductions_sit_at_the_psum_sites():
    """One psum per JAX psum site, none crossing processes in a one-process
    mesh.  CG, per LM iteration: Hcc, gc, the rhs, one per CG step and two
    chi2s; one chi2 after each stage.  Dense LM, per iteration: S, the rhs
    and two chi2s."""
    pack, _ = cg_problem(C=5, P=64, seed=2)
    args, _ = shard_gba_pack(pack, 4)
    mesh = device_mesh("cpu", 4)
    distributed_ba_cg(mesh, TCAM, *args, iters1=2, iters2=0, cg_iters=12)
    assert mesh.n_reductions == 2 * (2 + 1 + 12 + 2) + 2 and mesh.n_collectives == 0
    mesh.reset_counts()
    distributed_ba(mesh, TCAM, *args, n_iters=3)
    assert mesh.n_reductions == 3 * 4 and mesh.n_collectives == 0


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal on a machine with no CUDA device")
def test_cuda_mesh_without_a_card_raises(tmp_path):
    """The CUDA mesh is the default and is never replaced by a CPU one: with
    no card, global_mesh(), initialize() and the worker raise before any
    process group is joined."""
    from orb_line_slam_tpu_torch.parallel import multihost, multihost_worker

    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("127.0.0.1:1", 1, 0)
    n_threads = torch.get_num_threads()
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            multihost_worker.main(["127.0.0.1:1", "1", "0", str(tmp_path / "gba")])
    finally:
        torch.set_num_threads(n_threads)     # the worker takes one thread
    assert multihost.global_mesh("cpu").n_shards == 1


def route_map():
    """tests/test_distributed_ba.py::test_gba_routes_to_sharded_on_multidevice's
    map: 64 landmarks seen by 6 keyframes with drifted poses."""
    from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
    from orb_line_slam_tpu.loop.vocabulary import Vocabulary
    from orb_line_slam_tpu.slam_map.map_store import MapStore

    rng = np.random.default_rng(2)
    F = 64
    cfg = SlamConfig(camera=CAM, orb=OrbConfig(n_features=F), lines=LineConfig(enabled=False),
                     map=MapConfig(max_keyframes=16, max_points=4096))
    store = MapStore(cfg.map, n_features=F)
    voc = Vocabulary.train(rng.integers(0, 256, (600, 32), dtype=np.uint8), k=4, depth=2)
    pts_w = np.stack([rng.uniform(-3, 3, F), rng.uniform(-2, 2, F), rng.uniform(6, 14, F)], -1).astype(np.float32)

    class _F:
        pass

    ids = None
    for k in range(6):
        t_gt = np.array([0.35 * k, 0.0, 0.0], np.float32)
        t_est = t_gt + rng.normal(0, 0.02, 3).astype(np.float32) * (k > 0)
        p_cam = pts_w + t_gt
        u = CAM.fx * p_cam[:, 0] / p_cam[:, 2] + CAM.cx
        v = CAM.fy * p_cam[:, 1] / p_cam[:, 2] + CAM.cy
        fr = _F()
        fr.xy = np.stack([u, v], -1).astype(np.float32)
        fr.u_right = (u - CAM.bf / p_cam[:, 2]).astype(np.float32)
        fr.depth = p_cam[:, 2].astype(np.float32)
        fr.octave = np.zeros(F, np.int32)
        fr.angle = np.zeros(F, np.float32)
        fr.desc = rng.integers(0, 256, (F, 32), dtype=np.uint8)
        fr.valid = np.ones(F, bool)
        kf = store.add_keyframe(fr, np.eye(3, dtype=np.float32), t_est, k)
        if k == 0:
            ids = store.add_points(pts_w, fr.desc, fr.octave, kf, np.arange(F))
        else:
            store.kf_obs_lm[kf, :] = ids
    store.touch_obs()
    return cfg, store, voc, F


def big_closer(mesh):
    """A port LoopCloser on the route map with the default map capacity
    (512 keyframes, 65,536 points: past 256 MB of dense coupling)."""
    cfg, store, voc, _ = route_map()
    tcfg = config_from_jax(cfg)
    big = type(tcfg.map)(**{**vars(tcfg.map), "max_keyframes": 512, "max_points": 65536})
    tcfg = type(tcfg)(**{**vars(tcfg), "map": big})
    return LoopCloser(tcfg, map_store_from_numpy(store), vocabulary_from_numpy(voc), device="cpu", mesh=mesh)


def test_sharded_dispatch_matches_jax():
    """The port's _dispatch_gba_sharded against the JAX package's on the
    same map (JAX packs at capacity, the port at the live counts, so the
    shard layouts differ): inlier flags equal on >= 99% of the pack's
    rows, >= 5F inliers, finite landmarks, poses within the contract."""
    cfg, store, voc, F = route_map()
    store_t = map_store_from_numpy(store)
    lc_j = JaxLoopCloser(cfg, store, voc)
    pack_j = store.pack_local_ba(5, max_cams=8, max_points=256, max_obs=1024, all_free=True)
    out_j = lc_j._dispatch_gba_sharded(pack_j, len(jax.devices()), 3, 0)
    lc_t = LoopCloser(config_from_jax(cfg), store_t, vocabulary_from_numpy(voc), device="cpu",
                      mesh=device_mesh("cpu", 8))
    pack_t = store_t.pack_local_ba(5, max_cams=8, max_points=256, max_obs=1024, all_free=True)
    res = lc_t._dispatch_gba_sharded(pack_t, 3, 0)
    assert lc_t.last_gba_solver == "sharded_cg"
    n_c, n_o = len(pack_t["cam_ids"]), int(pack_t["n_obs"])
    assert res.obs_inlier.shape == (n_o,) and res.points.shape == (len(pack_t["lm_ids"]), 3)
    inl_j = out_j.obs_inlier
    assert (res.obs_inlier == inl_j[:n_o]).mean() >= 0.99 and not inl_j[n_o:].any()
    assert res.obs_inlier.sum() >= 5 * F and np.isfinite(res.points).all()
    assert rot_angle(res.R, np.asarray(out_j.R)[:n_c]) < 1e-3
    assert np.abs(res.t - np.asarray(out_j.t)[:n_c]).max() < 5e-3
    assert np.median(np.linalg.norm(res.points - out_j.points[: len(res.points)], axis=1)) < 1e-3
    # The gauge: the pack's first fixed camera, not fix_first.
    assert np.array_equal(sharded_gauge(np.array([False, False, True, True])), [False, False, True, True])
    assert np.array_equal(sharded_gauge(np.zeros(3, bool)), [True, False, False])


@pytest.mark.parametrize("n,solver", [(8, "sharded_cg"), (1, "cg")])
def test_pack_gba_routes_by_mesh(n, solver):
    """Past 256 MB of coupling the global BA goes sharded exactly when the
    closer's mesh has more than one shard, as the JAX package's
    jax.device_count() > 1."""
    lc = big_closer(device_mesh("cpu", n))
    pack, problem = lc._pack_gba(3, 0)
    assert problem["solver"] == lc.last_gba_solver == solver
    assert problem["cg_iters"] == 64
    if n > 1:
        assert np.array_equal(problem["args"][2], sharded_gauge(pack["cam_fixed"])[: len(pack["cam_ids"])])


def test_async_sharded_gba_equals_pinned():
    """The sharded global BA solved on the global-BA worker and applied by
    poll_global_ba writes the same map as the pinned run_global_ba."""
    pinned, shipped = big_closer(device_mesh("cpu", 8)), big_closer(device_mesh("cpu", 8))
    pinned.run_global_ba(3, 0)
    shipped.gba_async = True
    shipped.dispatch_global_ba(3, 0)
    try:
        assert shipped.poll_global_ba(force=True)
    finally:
        shipped.stop()
    assert pinned.last_gba_solver == shipped.last_gba_solver == "sharded_cg"
    assert pinned.n_gba_applied == shipped.n_gba_applied == 1
    a, b = pinned.map, shipped.map
    for name in ("kf_R", "kf_t", "pt_pos"):
        assert np.array_equal(getattr(a, name), getattr(b, name)), name
    assert np.abs(a.kf_t[:6] - route_map()[1].kf_t[:6]).max() < 0.1


def test_mesh_layout():
    """Slots, the home device and the shard slices of a one-process mesh."""
    mesh = ShardMesh(["cpu"] * 3)
    assert (mesh.n_shards, mesh.first, mesh.n_local, mesh.rank) == (3, 0, 3, 0)
    parts = make_global_array(mesh, np.arange(12).reshape(6, 2))
    assert [p[:, 0].tolist() for p in parts] == [[0, 2], [4, 6], [8, 10]]
    total = mesh.psum([torch.ones(2), 2 * torch.ones(2), 3 * torch.ones(2)])
    assert total.tolist() == [6.0, 6.0] and (mesh.n_reductions, mesh.reduced_bytes) == (1, 8)
    with pytest.raises(ValueError):
        make_global_array(mesh, np.zeros(4))
