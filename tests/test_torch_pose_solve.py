"""The pose solve of the torch port (``backend/pose_opt.py``: the
``orb_line_slam::pose_solve`` operator, its plain version and the kernel
source ``csrc/pose_solve.cu``) on the CPU:

- the port's ``pose_optimize`` against the JAX package's, at both
  schedules the tracker runs (2x8 on paths A and B, 4x10 on the final
  solve and relocalization), on seeded problems with stereo and mono
  points, 20% outliers, with and without 64 lines, held to the pose
  contract of tests/test_tpu_parity.py (1e-3 rad, 5e-3 m, inlier counts
  within 3);
- the operator under ``torch.func.vmap`` (B = 3, batched and unbatched
  arguments mixed) against a loop of single calls, through its vmap rule;
- the kernel source itself, compiled for the host with each CUDA thread
  a host thread (each CTA its own shared state, ``__syncthreads``, the
  workers' barrier and the cluster barrier host barriers, the warp
  shuffles through a shared array), in clusters of 1, 2 and 4 CTAs,
  against the plain version on a batch of two solves, and its rerun bit
  for bit; the wrapper's copy of the launch rule against the source's.
"""

import importlib.util
import os
import shutil
import subprocess
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.backend.pose_opt import pose_optimize as jax_pose_opt
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics as JaxCam
from orb_line_slam_tpu_torch.backend import pose_opt
from orb_line_slam_tpu_torch.backend.pose_opt import pose_optimize, pose_optimize_reference, pose_solve
from orb_line_slam_tpu_torch.config import CameraIntrinsics

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
LINE_KEYS = ("line_start_w", "line_end_w", "line_obs", "line_octave", "line_valid")


def pose_problem(seed, M, L, mono_frac):
    """chip_smoke.py's seeded pose problem (20% outliers) at CAM."""
    return chip_smoke.pose_problem(CAM, seed, M, L, mono_frac)


def _split(arrays, f):
    """(positional arguments, line keyword arguments) of pose_optimize."""
    args = [f(x) for x in arrays[:6]]
    return args, {k: f(x) for k, x in zip(LINE_KEYS, arrays[6:])}


def _torch(x):
    return torch.from_numpy(np.array(x))


def _rotation_gap(Ra, Rb):
    return chip_smoke.rotation_gap(np.asarray(Ra)[None], np.asarray(Rb)[None])


@pytest.mark.parametrize("rounds,iters", [(2, 8), (4, 10)])
@pytest.mark.parametrize("mono_frac", [0.0, 0.4])
@pytest.mark.parametrize("n_lines", [0, 64])
def test_pose_optimize_matches_jax(rounds, iters, mono_frac, n_lines):
    """The port's dispatching pose_optimize on the CPU against the JAX
    package's: rotation within 1e-3 rad, translation within 5e-3 m, point
    and line inlier counts within 3 each."""
    arrays = pose_problem(11 + n_lines + int(10 * mono_frac), 300, n_lines, mono_frac)
    jargs, jkw = _split(arrays, jnp.asarray)
    targs, tkw = _split(arrays, _torch)
    rj = jax_pose_opt(*jargs, JaxCam(*CAM), rounds=rounds, iters=iters, **jkw)
    before = pose_opt.launches
    rt = pose_optimize(*targs, CAM, rounds=rounds, iters=iters, **tkw)
    assert pose_opt.launches == before          # CPU tensors: the plain version, no kernel
    assert _rotation_gap(rt.R.numpy(), np.asarray(rj.R)) < 1e-3
    assert np.abs(rt.t.numpy() - np.asarray(rj.t)).max() < 5e-3
    assert abs(int(rt.inliers.sum()) - int(np.asarray(rj.inliers).sum())) <= 3
    assert abs(int(rt.line_inliers.sum()) - int(np.asarray(rj.line_inliers).sum())) <= 3
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 3
    assert int(rt.n_inliers) == int(rt.inliers.sum()) + int(rt.line_inliers.sum())
    assert rt.line_inliers.shape == (n_lines,)
    # The solve found the truth's inliers: most of the 95% valid, 80% clean rows.
    assert int(rt.inliers.sum()) >= 0.6 * 300


def test_pose_optimize_is_the_plain_version_on_cpu():
    """On CPU tensors the operator runs pose_solve_plain: the same bits as
    pose_optimize_reference."""
    targs, tkw = _split(pose_problem(3, 200, 16, 0.3), _torch)
    a = pose_optimize(*targs, CAM, rounds=2, iters=8, **tkw)
    b = pose_optimize_reference(*targs, CAM, rounds=2, iters=8, **tkw)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _assert_same_solve(got, want):
    """Two results of one solve (R, t, point and line inliers, n_inliers):
    the CPU runs B solves as vmap of the plain version, whose batched
    operators round like the single ones but for the sums' order."""
    assert _rotation_gap(got[0].numpy(), want[0].numpy()) < 1e-5
    assert float((got[1] - want[1]).abs().max()) < 1e-5
    assert torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]) and int(got[4]) == int(want[4])


def _op_args(seed, M, L, mono_frac):
    targs, tkw = _split(pose_problem(seed, M, L, mono_frac), _torch)
    return pose_opt.solve_args(*targs, CAM, 1.2, *tkw.values())


@pytest.mark.parametrize("n_lines", [0, 24])
def test_pose_solve_under_vmap_equals_a_loop(n_lines):
    """torch.func.vmap of the operator over B = 3 solves of one problem,
    with batched and unbatched tensors mixed (the observations and their
    weights shared; start poses and valid masks per solve), equals a loop
    of single calls, through the vmap rule (functorch's per-sample
    fallback is an error here)."""
    B, M = 3, 160
    base = _op_args(20, M, n_lines, 0.3)
    rng = np.random.default_rng(21)
    per = []
    for b in range(B):
        a = list(base)
        a[0] = (_torch(chip_smoke._rodrigues(rng.normal(0, 0.01, 3)).astype(np.float32)) @ base[0]).contiguous()
        a[1] = base[1] + _torch(rng.normal(0, 0.05, 3).astype(np.float32))
        a[5] = base[5] & _torch(rng.random(M) < 0.9)
        a[10] = base[10] & _torch(rng.random(n_lines) < 0.9)
        per.append(a)
    batched = {0, 1, 5, 10}    # R0, t0, valid, l_valid
    in_dims = tuple(0 if i in batched else None for i in range(16)) + (None, None)
    stacked = [per[0][i] if d is None else torch.stack([p[i] for p in per]) for i, d in enumerate(in_dims[:16])]
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            got = torch.func.vmap(pose_solve, in_dims=in_dims)(*stacked, 2, 8)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    assert [tuple(x.shape) for x in got] == [(B, 3, 3), (B, 3), (B, M), (B, n_lines), (B,), (B, 16)]
    for b in range(B):
        want = pose_solve(*per[b], 2, 8)
        _assert_same_solve([x[b] for x in got], want)


def test_pose_optimize_under_vmap_equals_a_loop():
    """pose_optimize as the batched tracking step calls it: every argument
    batched, the octaves turned into weights inside the vmap."""
    B = 2
    problems = [pose_problem(40 + b, 120, 0, 0.2) for b in range(B)]
    stacked = [_torch(np.stack(xs)) for xs in zip(*problems)]
    cam = CAM
    got = torch.func.vmap(lambda *a: pose_optimize(*a, cam, rounds=2, iters=8))(*stacked)
    for b in range(B):
        want = pose_optimize(*(x[b] for x in stacked), cam, rounds=2, iters=8)
        _assert_same_solve([x[b] for x in got], want)


def test_pose_solve_rejects_bad_inputs():
    args = list(_op_args(5, 40, 0, 0.0))
    with pytest.raises(ValueError):
        pose_solve(*args, 0, 8)
    bad = list(args)
    bad[3] = bad[3][:, :2].contiguous()
    with pytest.raises(ValueError):
        pose_solve(*bad, 2, 8)
    bad = list(args)
    bad[5] = bad[5].to(torch.uint8)
    with pytest.raises(TypeError):
        pose_solve(*bad, 2, 8)


# ---------------------------------------------------------------------------
# The kernel source on host threads.

_HOST_SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstring>
#include <memory>
#include <optional>
#include <thread>
#include <vector>
#define POSE_SOLVE_HOST 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __restrict__
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
thread_local Dim3 threadIdx, blockIdx;
// A warp: its barrier and two exchange buffers, used in turn (a thread
// writes one only after all have passed the barrier that follows their
// read of it).
struct HostWarp {
  std::barrier<> bar{32};
  alignas(8) unsigned char ex[2][32 * 8];
};
// A CTA: its own shared memory (filled with NaN bytes: nothing may read
// what it did not write), its barrier, its workers' barrier and its warps.
struct HostCta {
  HostCta(int bytes, int threads, int workers, int rank_)
      : smem(bytes, 0xff), block(threads), workers(workers), warps(threads / 32), rank(rank_) {}
  std::vector<unsigned char> smem;
  std::barrier<> block, workers;
  std::vector<HostWarp> warps;
  int rank;
};
struct HostCluster {
  std::barrier<>* all;
  std::vector<HostCta*> ctas;
};
thread_local HostCta* t_cta = nullptr;
thread_local HostCluster* t_cluster = nullptr;
thread_local int t_phase = 0;
thread_local std::optional<std::barrier<>::arrival_token> t_arrival;
inline void __syncthreads() { t_cta->block.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { t_cta->warps[threadIdx.x >> 5].bar.arrive_and_wait(); }
template <class T> T host_exchange(T v, int src_lane) {
  HostWarp& w = t_cta->warps[threadIdx.x >> 5];
  unsigned char* ex = w.ex[t_phase];
  t_phase ^= 1;
  std::memcpy(ex + 8 * (threadIdx.x & 31), &v, sizeof(T));
  w.bar.arrive_and_wait();
  T r;
  std::memcpy(&r, ex + 8 * src_lane, sizeof(T));
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int lane) { return host_exchange(v, lane & 31); }
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) { return host_exchange(v, (threadIdx.x & 31) ^ mask); }
// The CTA's shared state, the workers' barrier and the cluster primitives.
inline unsigned char* shared_base() { return t_cta->smem.data(); }
inline void worker_barrier() { t_cta->workers.arrive_and_wait(); }
inline int cluster_rank() { return t_cta->rank; }
inline void cluster_arrive() { t_arrival.emplace(t_cluster->all->arrive()); }
inline void cluster_wait() {
  t_cluster->all->wait(std::move(*t_arrival));
  t_arrival.reset();
}
template <class T> T* peer_state(T* p, int rank) {
  const long off = reinterpret_cast<unsigned char*>(p) - t_cta->smem.data();
  return reinterpret_cast<T*>(t_cluster->ctas[rank]->smem.data() + off);
}
"""

_HOST_LAUNCH = r"""
// B clusters of C CTAs (C = 0: the launcher's rule), one after the other;
// each cluster's C x kThreads CUDA threads are host threads.
extern "C" void host_pose_solve(const float* R0, const float* t0, const float* points, const float* obs,
    const float* p_info, const unsigned char* valid, const float* line_start, const float* line_end,
    const float* line_obs, const float* l_info, const unsigned char* l_valid, int B, int M, int L, float fx,
    float fy, float cx, float cy, float bf, int rounds, int iters, float* R, float* t, unsigned char* p_in,
    unsigned char* l_in, int* n_in, unsigned char* steps, int C) {
  if (C == 0) C = cluster_size(M, L);
  const int bytes = shared_bytes(M, L, C, rounds, iters);
  const Cam cam{fx, fy, cx, cy, bf};
  for (int b = 0; b < B; ++b) {
    std::barrier<> all(C * kThreads);
    std::vector<std::unique_ptr<HostCta>> ctas;
    HostCluster cluster{&all, {}};
    for (int r = 0; r < C; ++r) {
      ctas.push_back(std::make_unique<HostCta>(bytes, kThreads, kWorkers, r));
      cluster.ctas.push_back(ctas.back().get());
    }
    std::vector<std::thread> threads;
    for (int r = 0; r < C; ++r) {
      for (int i = 0; i < kThreads; ++i) {
        threads.emplace_back([&, r, i] {
          t_cta = ctas[r].get();
          t_cluster = &cluster;
          threadIdx.x = i;
          blockIdx.x = b * C + r;
          pose_solve_kernel(R0, t0, points, obs, p_info, valid, line_start, line_end, line_obs, l_info, l_valid,
                            M, L, cam, rounds, iters, R, t, p_in, l_in, n_in, steps, C);
        });
      }
    }
    for (auto& th : threads) th.join();
  }
}
extern "C" int host_cluster_size(int M, int L) { return cluster_size(M, L); }
extern "C" int host_shared_bytes(int M, int L, int C, int rounds, int iters) {
  return shared_bytes(M, L, C, rounds, iters);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """csrc/pose_solve.cu compiled for the host (its kernel and device
    functions as written; the cluster primitives, the warp shuffles and
    the C launcher replaced by the shim's)."""
    import ctypes

    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to compile the kernel source for the host")
    src = (pose_opt._build.CSRC / "pose_solve.cu").read_text()
    body = _HOST_SHIM + src[: src.index("}  // namespace")]
    d = tmp_path_factory.mktemp("pose_solve_host")
    (d / "host.cpp").write_text(body + "}  // namespace\n" + _HOST_LAUNCH)
    built = subprocess.run([cxx, "-std=c++20", "-O2", "-pthread", "-shared", "-fPIC", "-o", str(d / "libhost.so"),
                            str(d / "host.cpp")], capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr[-2000:]
    lib = ctypes.CDLL(str(d / "libhost.so"))
    lib.host_pose_solve.argtypes = [*pose_opt._ARGTYPES, ctypes.c_int]
    lib.host_pose_solve.restype = None
    for name in ("host_cluster_size", "host_shared_bytes"):
        getattr(lib, name).restype = ctypes.c_int
    return lib


def _host_solve(lib, per, rounds, iters, C):
    """The kernel source on host threads over the solves `per` (one
    launch of len(per) clusters of C CTAs); its outputs as tensors."""
    B, M, L = len(per), per[0][2].shape[0], per[0][6].shape[0]
    T = [torch.stack([p[i] for p in per]).contiguous() for i in range(11)]
    R, t = torch.empty(B, 3, 3), torch.empty(B, 3)
    p_in, l_in = torch.empty(B, M, dtype=torch.bool), torch.empty(B, L, dtype=torch.bool)
    n_in, steps = torch.empty(B, dtype=torch.int32), torch.empty(B, rounds * iters, dtype=torch.uint8)
    lib.host_pose_solve(*(x.data_ptr() for x in T), B, M, L, *per[0][11:], rounds, iters, R.data_ptr(), t.data_ptr(),
                        p_in.data_ptr(), l_in.data_ptr(), n_in.data_ptr(), steps.data_ptr(), C)
    return R, t, p_in, l_in, n_in, steps


def _host_cases():
    """C = 1, 2 and 4 CTAs a cluster, with and without lines, at 2x8 and
    4x10; the C = 1 cases keep the ids they had before clusters."""
    for C in (1, 2, 4):
        for n_lines in (0, 16):
            for rounds, iters in ((2, 8), (4, 10)):
                yield pytest.param(n_lines, rounds, iters, C,
                                   id=f"{n_lines}-{rounds}-{iters}" + (f"-C{C}" if C > 1 else ""))


@pytest.mark.parametrize("n_lines,rounds,iters,cluster", list(_host_cases()))
def test_kernel_source_on_host_threads_matches_plain(host_kernel, n_lines, rounds, iters, cluster):
    """Two solves in one launch of the kernel source, each a cluster of
    `cluster` CTAs: each within 1e-5 rad and 5e-5 m of the plain version
    (the same arithmetic, sums in another order), the inlier masks on >=
    99% of rows, n_inliers within 3; a second launch gives the same bits."""
    B, M = 2, 200
    per = [_op_args(60 + b, M, n_lines, 0.3) for b in range(B)]
    R, t, p_in, l_in, n_in, steps = got = _host_solve(host_kernel, per, rounds, iters, cluster)
    for b in range(B):
        want = pose_opt.pose_solve_plain(*per[b], rounds, iters)
        assert _rotation_gap(R[b].numpy(), want[0].numpy()) < 1e-5
        assert float((t[b] - want[1]).abs().max()) < 5e-5
        assert float((p_in[b] == want[2]).float().mean()) >= 0.99
        if n_lines:
            assert float((l_in[b] == want[3]).float().mean()) >= 0.99
        assert abs(int(n_in[b]) - int(want[4])) <= 3
        assert int(n_in[b]) == int(p_in[b].sum()) + int(l_in[b].sum())
    again = _host_solve(host_kernel, per, rounds, iters, cluster)
    for x, y in zip(got, again):
        assert torch.equal(x, y)


def test_launch_rule_of_the_wrapper_is_the_sources(host_kernel):
    """pose_opt's copy of the launcher's rule (CTAs a cluster, shared bytes
    a CTA) equals the source's own, compiled, over shapes from empty to
    past the shared-memory cap; the cells' shapes get C >= 2."""
    for M in (0, 1, 200, 255, 256, 257, 1000, 1200, 2000, 2048, 2049, 4096, 5000, 60000, 70000):
        for L in (0, 16, 64, 128, 3000):
            C = host_kernel.host_cluster_size(M, L)
            assert pose_opt.cluster_size(M, L) == C
            assert pose_opt.shared_bytes(M, L, 4, 10) == host_kernel.host_shared_bytes(M, L, C, 4, 10)
    assert [pose_opt.cluster_size(M, L) for M, L in ((2000, 0), (1200, 128), (1000, 64), (1200, 0), (1000, 0))] \
        == [8, 6, 5, 5, 4]
