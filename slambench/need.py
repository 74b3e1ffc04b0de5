# Frozen copy of the kernels' needed-work arithmetic of chip_smoke.py at
# commit d30c4f7: phase 3's bytes and operations of orb_describe
# (phase_fused_kernels, covered_pixels) and pose_solve_need with its
# POSE_FLOP table, and the H100 peaks the smoke divides by.  The inlier
# masks of a pose solve's rounds come from the benchmark's own plain
# solve (slambench/ref), not from the program's kernel.
"""Needed bytes and float32 operations of the hand-written kernels' launches,
and the least time the card could take for them."""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 bandwidth (bytes/s), float32 rate
# outside the tensor cores (FLOP/s).  Both assume the card's full 700 W.
H100_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

# orb_describe: a 32x32 tile per keypoint and 9-tap bands.  The float
# operations one keypoint needs: the shift+blur is A(dy) T A(dx)^T with
# A(d) = wm Am + w0 A0 + wp Ap, one 9-tap band per axis: building the two
# bands (32 rows x 9 taps, 3 products and 2 sums each), then two passes of
# 1024 outputs x 9 multiply-adds.  Quantisation, moments and comparisons
# are integer work beside it.
PATCH, BAND_TAPS = 32, 9
DESCRIBE_FLOP = 2 * (PATCH * BAND_TAPS * 5) + 2 * (PATCH ** 2 * BAND_TAPS * 2)
# The kernel's tables, read once a launch: band rows float32 [32, 28] and
# rotated test-point indices int16 [30, 512].
DESCRIBE_TABLE_BYTES = 32 * 28 * 4 + 30 * 512 * 2
# Written per keypoint: a float32 angle and 32 descriptor bytes.
DESCRIBE_OUT_BYTES = 36

# pose_solve: float32 operations per observation of the function the solve
# computes (a multiply-add 2, a division, square root, sine or cosine 1):
# per LM iteration H, g and the error at the pose and at the candidate,
# then one damped 6x6 solve and exponential map (~480); per round the
# gating.  How a kernel sums across threads is its own affair.
POSE_FLOP = {"pass1_stereo": 266, "pass1_mono": 189, "pass2_stereo": 45, "pass2_mono": 42, "gate_stereo": 39,
             "gate_mono": 36, "line_pass1": 227, "line_pass2": 65, "line_gate": 65, "iteration": 480}


def least_seconds(n_bytes: float, flops: float) -> float:
    """The least time the card could take: needed bytes at the HBM rate or
    needed operations at the float32 rate, whichever is longer."""
    return max(n_bytes / H100_BYTES_PER_S, flops / H100_FP32_FLOPS)


def covered_pixels(h: int, w: int, x0: torch.Tensor, y0: torch.Tensor, rows: int, cols: int) -> int:
    """Number of [h, w] pixels under some rows x cols window with top-left
    corner (x0[i], y0[i]) (int64 tensors on any device)."""
    dev = x0.device
    covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
    ys = y0[:, None, None] + torch.arange(rows, device=dev)[None, :, None]
    xs = x0[:, None, None] + torch.arange(cols, device=dev)[None, None, :]
    covered[ys.expand(-1, rows, cols), xs.expand(-1, rows, cols)] = True
    return int(covered.sum())


def describe_need(h: int, w: int, axy: torch.Tensor, valid: torch.Tensor) -> tuple[int, int]:
    """(bytes, float32 operations) one orb_describe launch needs on an
    atlas [b, h, w] for int [b, n, 2] atlas keypoints of which ``valid``
    [b, n] are kept: each needed atlas pixel (under some keypoint's
    clamped 32x32 tile) read once, each kept keypoint's coordinates and
    sub-pixel offset read and its angle and descriptor written once."""
    n_pix, n_kept = 0, 0
    for i in range(axy.shape[0]):
        xy = axy[i][valid[i]].long()
        n_kept += xy.shape[0]
        if xy.shape[0]:
            x0 = torch.clamp(xy[:, 0] - 15, 0, w - PATCH)
            y0 = torch.clamp(xy[:, 1] - 15, 0, h - PATCH)
            n_pix += covered_pixels(h, w, x0, y0, PATCH, PATCH)
    n_bytes = n_pix * 4 + n_kept * (8 + 8) + DESCRIBE_TABLE_BYTES + n_kept * DESCRIBE_OUT_BYTES
    return n_bytes, n_kept * DESCRIBE_FLOP


def pose_solve_need(tensors, rounds: int, iters: int, masks) -> tuple[int, int]:
    """(bytes, float32 operations) one pose-solve launch needs: ``tensors``
    are the launch's 11 tensor arguments (R0, t0, points, obs, p_info,
    valid, line start, line end, line obs, l_info, l_valid), of one solve
    or, with a leading [B] on each, of B solves; ``masks`` the (point,
    line) inlier masks each round starts from (round 0: the valid masks),
    with the same leading dimensions.  Each input is read once and each
    output written once; the operations of POSE_FLOP over the rows each
    round visits, and each solve's own terms (its outputs, an LM
    iteration's solve, the line gate) once a solve."""
    M, L = tensors[2].shape[-2], tensors[6].shape[-2]
    solves = tensors[0].numel() // 9
    n_bytes = sum(x.numel() * x.element_size() for x in tensors) + solves * (36 + 12 + M + L + 4 + rounds * iters)
    stereo = tensors[3][..., 2] > 0
    f = POSE_FLOP
    ops = 0
    for p_in, l_in in masks:
        n_st, n_mo, n_l = int((p_in & stereo).sum()), int((p_in & ~stereo).sum()), int(l_in.sum())
        ops += iters * (n_st * (f["pass1_stereo"] + f["pass2_stereo"]) + n_mo * (f["pass1_mono"] + f["pass2_mono"])
                        + n_l * (f["line_pass1"] + f["line_pass2"]) + solves * f["iteration"])
        ops += (int(stereo.sum()) * f["gate_stereo"] + int((~stereo).sum()) * f["gate_mono"]
                + solves * L * f["line_gate"])
    return n_bytes, ops


def roofline_percent(needs, own_seconds: float):
    """Sum of the launches' least times over their own device time, in %;
    None when no launch was timed."""
    if own_seconds <= 0 or not needs:
        return None
    return 100.0 * sum(least_seconds(b, f) for b, f in needs) / own_seconds
