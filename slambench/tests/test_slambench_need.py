"""The benchmark's needed-work arithmetic reproduces the bounds PERF.md
holds for the hand-written kernels (the card's chip_smoke.py phase 3)."""

import numpy as np
import torch

from slambench import need
from slambench.ref.backend import pose_opt as ref_pose_opt
from slambench.ref.config import CameraIntrinsics
from slambench.ref.ops.image import pyramid_shapes

KITTI = CameraIntrinsics(fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448, width=1241, height=376)


def border_keypoints(h, w):
    return np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [5, -7],
                     [w + 3, h + 3], [w // 2, h - 3], [w - 1, h // 2], [15, 15], [16, 16], [w - 17, h - 17]])


def test_orb_describe_bound_of_the_point_cell():
    """Phase 3's inputs at the point cell ([2, 1731, 1241], N = 2 x 2000,
    keypoints drawn by numpy's generator seeded 1 after the atlas noise):
    3.21 us by bytes, 2.37 us by operations."""
    h = sum(s[0] for s in pyramid_shapes(376, 1241, 8, 1.2))
    w, b, n = 1241, 2, 2000
    assert h == 1731
    rng = np.random.default_rng(1)
    rng.random((b, 1, h, w))
    xy = np.stack([rng.integers(-20, w + 20, (b, n)), rng.integers(-20, h + 20, (b, n))], -1)
    xy[:, : len(border_keypoints(h, w))] = border_keypoints(h, w)
    axy = torch.from_numpy(xy.astype(np.int32))
    n_bytes, flops = need.describe_need(h, w, axy, torch.ones((b, n), dtype=torch.bool))
    assert round(n_bytes / need.H100_BYTES_PER_S * 1e6, 2) == 3.21
    assert round(flops / need.H100_FP32_FLOPS * 1e6, 2) == 2.37
    # Keypoints left out by the detector need nothing.
    half = torch.zeros((b, n), dtype=torch.bool)
    half[:, : n // 2] = True
    b2, f2 = need.describe_need(h, w, axy, half)
    assert f2 * 2 == flops and b2 < n_bytes


def pose_problem(cam, seed, M, L, mono_frac=0.3, outlier_frac=0.2):
    """chip_smoke.py::pose_problem at commit d30c4f7 (the seeded problems of
    phase 3), points only."""
    rng = np.random.default_rng(seed)

    def rodrigues(v):
        th = float(np.linalg.norm(v))
        k = v / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K

    R_gt, t_gt = rodrigues(rng.normal(0, 0.3, 3)), rng.normal(0, 1, 3)
    uv = np.stack([rng.uniform(0, cam.width, M), rng.uniform(0, cam.height, M)], -1)
    z = rng.uniform(2, 30, M)
    xc = np.stack([(uv[:, 0] - cam.cx) / cam.fx * z, (uv[:, 1] - cam.cy) / cam.fy * z, z], -1)
    pts = (xc - t_gt) @ R_gt
    octave = rng.integers(0, 8, M)
    obs = np.concatenate([uv, (uv[:, 0] - cam.bf / z)[:, None]], -1) + rng.normal(0, 1, (M, 3)) * (
        0.5 * 1.2 ** octave)[:, None]
    obs[rng.random(M) < mono_frac, 2] = -1.0
    out = rng.random(M) < outlier_frac
    obs[out, :2] += rng.uniform(15, 40, (out.sum(), 2)) * rng.choice([-1, 1], (out.sum(), 2))
    arrays = [rodrigues(rng.normal(0, 0.02, 3)) @ R_gt, t_gt + rng.normal(0, 0.1, 3), pts, obs,
              octave.astype(np.int32), rng.random(M) < 0.95]
    return [torch.from_numpy(x.astype(np.float32) if x.dtype.kind == "f" else x) for x in arrays]


def test_pose_solve_need_arithmetic():
    """Every row an inlier in every round: the count in closed form."""
    args = ref_pose_opt.solve_args(*pose_problem(KITTI, 900, 2000, 0), KITTI, 1.2)
    tensors = args[:11]
    valid = torch.ones(2000, dtype=torch.bool)
    masks = [(valid, tensors[10])] * 4
    n_bytes, ops = need.pose_solve_need(tensors, 4, 10, masks)
    stereo = int((tensors[3][:, 2] > 0).sum())
    mono = 2000 - stereo
    f = need.POSE_FLOP
    per_round = 10 * (stereo * (f["pass1_stereo"] + f["pass2_stereo"]) + mono * (f["pass1_mono"] + f["pass2_mono"])
                      + f["iteration"]) + stereo * f["gate_stereo"] + mono * f["gate_mono"]
    assert ops == 4 * per_round
    assert n_bytes == sum(x.numel() * x.element_size() for x in tensors) + 36 + 12 + 2000 + 0 + 4 + 40


def test_pose_solve_bound_of_the_point_cell():
    """Phase 3's first pose problem (seed 900, M = 2000, L = 0, 4x10):
    PERF.md's 18,962,496 operations (0.283 us at 67 TFLOP/s) were counted
    over the card kernel's own round masks; the benchmark counts over its
    plain solve's masks, which gate a few rows otherwise: within 1.5%."""
    args = ref_pose_opt.solve_args(*pose_problem(KITTI, 900, 2000, 0), KITTI, 1.2)
    masks = []
    ref_pose_opt.pose_solve_plain(*args, 4, 10, round_masks=masks)
    n_bytes, ops = need.pose_solve_need(args[:11], 4, 10, masks)
    assert len(masks) == 4 and masks[0][0] is args[5]
    assert abs(ops - 18_962_496) / 18_962_496 < 0.015
    assert round(need.least_seconds(n_bytes, ops) * 1e6, 2) in (0.28, 0.27)


def test_a_batched_launch_needs_b_times_one_solve():
    """One launch of B identical solves (a leading [B] on every tensor and
    mask, as the vmapped tracking step launches them) needs exactly B
    times one solve, with and without lines; a single solve's count is
    the one above."""
    for L in (0, 16):
        one = list(ref_pose_opt.solve_args(*pose_problem(KITTI, 901, 500, 0), KITTI, 1.2))
        if L:
            g = torch.Generator().manual_seed(5)
            one[6:11] = [torch.rand(L, 3, generator=g), torch.rand(L, 3, generator=g) + 1,
                         torch.rand(L, 3, generator=g), torch.ones(L), torch.rand(L, generator=g) < 0.7]
        masks = []
        ref_pose_opt.pose_solve_plain(*one, 4, 10, round_masks=masks)
        single = need.pose_solve_need(one[:11], 4, 10, masks)
        for B in (1, 3, 8):
            batched = [x.expand(B, *x.shape).contiguous() for x in one[:11]]
            bmasks = [tuple(m.expand(B, *m.shape) for m in pair) for pair in masks]
            n_bytes, ops = need.pose_solve_need(batched, 4, 10, bmasks)
            assert (n_bytes, ops) == (B * single[0], B * single[1]), (L, B)
