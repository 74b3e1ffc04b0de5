"""The port's distributed global BA across processes (BASELINE config #5).

``orb_line_slam_tpu_torch.parallel.multihost_worker`` runs in separate OS
processes joined by ``torch.distributed`` with gloo on the CPU: two
processes of 4 shards each (the JAX test's 8-device, 2-process mesh) and
four processes of one shard each.  Each child runs with ``jax`` blocked
(as tests/test_torch_system.py::test_package_never_imports_jax), one torch
thread, its own free port, a process-group timeout, and the test kills
them all if they outlast theirs.  The result is held to the port's
single-process dense solve (camera centres within 5e-2 m, the JAX
worker's bound), to the JAX package's 8-device ``make_distributed_ba_cg``
and to the port's in-process 8-shard solve (the pose contract of
tests/test_torch_sharded_ba.py), and the replicated outputs must be
bit-identical on every rank."""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from orb_line_slam_tpu.parallel.sharded_ba import make_distributed_ba_cg as jax_distributed_ba_cg
from orb_line_slam_tpu.parallel.sharded_ba import shard_gba_pack as jax_shard_gba_pack
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu_torch.parallel.multihost import device_mesh
from orb_line_slam_tpu_torch.parallel.multihost_worker import SMALL_ITERS, small_problem
from orb_line_slam_tpu_torch.parallel.sharded_ba import distributed_ba_cg, shard_gba_pack, unshard_result
from tests.test_torch_sharded_ba import assert_pose_contract

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = textwrap.dedent(f"""
    import runpy, sys
    class _Block:
        def find_spec(self, name, path=None, target=None):
            if name == "jax" or name.startswith(("jax.", "jaxlib", "orb_line_slam_tpu.")) \\
                    or name == "orb_line_slam_tpu":
                raise ImportError("blocked: " + name)
            return None
    sys.meta_path.insert(0, _Block())
    sys.path.insert(0, {ROOT!r})
    sys.argv = ["multihost_worker"] + sys.argv[1:]
    runpy.run_module("orb_line_slam_tpu_torch.parallel.multihost_worker", run_name="__main__")
    assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
""")


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(tmp_path, nprocs, local_shards, timeout=240):
    """Start nprocs workers, wait for all (killing every one on a timeout
    or a failure), and return each rank's arrays."""
    coord = f"127.0.0.1:{free_port()}"
    out = str(tmp_path / "gba")
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, coord, str(nprocs), str(pid), out,
                               "--local-shards", str(local_shards), "--device", "cpu"],
                              cwd=str(tmp_path), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for pid in range(nprocs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {pid} failed:\n{log[-3000:]}"
    return [dict(np.load(f"{out}.rank{pid}.npz")) for pid in range(nprocs)]


def centres(R, t):
    return -np.einsum("cji,cj->ci", R, t)


@pytest.fixture(scope="module")
def references():
    """The small problem solved by the JAX package on its 8-device mesh and
    by the port on an in-process 8-shard mesh, both unsharded to pack
    order."""
    cam, pack = small_problem()
    i1, i2, ncg = SMALL_ITERS
    args, meta = shard_gba_pack(pack, 8)
    R, t, pts, inl, chi2 = (x.numpy() for x in distributed_ba_cg(device_mesh("cpu", 8), cam, *args, iters1=i1,
                                                                 iters2=i2, cg_iters=ncg))
    port = (R, t) + unshard_result(pts, inl, meta, len(pack["obs_cam"])) + (chi2,)
    jargs, jmeta = jax_shard_gba_pack(pack, 8)
    jcam = CameraIntrinsics(*cam)
    ba = jax_distributed_ba_cg(Mesh(np.array(jax.devices()), ("dp",)), jcam, iters1=i1, iters2=i2, cg_iters=ncg)
    Rj, tj, pj, ij, cj = (np.asarray(x) for x in ba(*jargs))
    grid = ij.reshape(jmeta["order"].shape)
    inl_j = np.zeros(len(pack["obs_cam"]), bool)
    inl_j[jmeta["order"][jmeta["oval"]]] = grid[jmeta["oval"]]
    jax_out = (Rj, tj, pj[: jmeta["P_tot"]], inl_j, cj)
    return pack, port, jax_out


@pytest.mark.parametrize("nprocs,local_shards", [(2, 4), (4, 1)])
def test_multiprocess_gba(tmp_path, references, nprocs, local_shards):
    pack, port, jax_out = references
    ranks = run_workers(tmp_path, nprocs, local_shards)
    n = nprocs * local_shards
    assert all(int(r["n_shards"]) == n and int(r["first"]) == i * local_shards for i, r in enumerate(ranks))
    for r in ranks[1:]:
        for k in ("R", "t", "chi2"):
            assert np.array_equal(r[k], ranks[0][k]), k
    # Every rank issued the same collectives: one per reduction.
    assert all(int(r["collectives"]) == int(r["reductions"]) == int(ranks[0]["reductions"]) for r in ranks)
    _, meta = shard_gba_pack(pack, n)
    pts, inl = unshard_result(np.concatenate([r["points_local"] for r in ranks]),
                              np.concatenate([r["inlier_local"] for r in ranks]), meta, len(pack["obs_cam"]))
    out = (ranks[0]["R"], ranks[0]["t"], pts, inl, ranks[0]["chi2"])
    z = pack["points"][:, 2]
    assert_pose_contract(out, port, z=z)
    assert_pose_contract(out, jax_out, z=z)
    diff = np.abs(centres(out[0], out[1]) - centres(ranks[0]["R_dense"], ranks[0]["t_dense"])).max()
    assert diff < 5e-2, diff
