"""Each cell's rendered sequence, in every noise draw of its pool, tracks
to the end of a pass with the program on the CPU (every frame tracked, on
the cell's pinned schedule), and its ground truth is the trajectory the
configuration file states.  The ATE is printed and held to nothing: it is
a float draw.  A cell whose scene lost tracking here would be repaired in
its scene parameters, never by choosing seeds.  Minutes a draw."""

import time

import numpy as np
import pytest
import torch

from slambench import check, harness
from slambench.drivers import stereo

SEED = 2**31 + 11


@pytest.mark.parametrize("name", ["kitti_stereo.seq", "euroc_stereo.seq"])
def test_every_noise_draw_tracks_to_the_end_of_a_pass_on_the_cpu(name):
    torch.set_num_threads(4)
    cell = harness.load_cell(name)
    config, traffic, n = cell["config"], cell["traffic"], int(cell["n_frames"])
    poses, sequences = harness.render_sequence(config, traffic, n, SEED)
    assert len(sequences) == len(traffic["noise_pool"])

    gt = check.centres(np.stack([R for R, _ in poses]), np.stack([t for _, t in poses]))
    step = np.linalg.norm(np.diff(gt, axis=0), axis=1)
    assert np.allclose(step, config["trajectory"]["step_m"], rtol=1e-9)
    assert np.allclose(gt[:, 2], config["trajectory"]["step_m"] * np.arange(n))

    prog = harness.load_program("cpu")
    cfg = harness.slam_config(prog.config, config)
    for k, frames in enumerate(sequences):
        assert len(frames) == n
        t0 = time.perf_counter()
        with stereo.Probes() as probes:
            _, frame_ms, passes, failed = stereo.replay(prog, cfg, cell, [frames], probes, 0.0, "cpu",
                                                        whole_passes=True)
        ate = check.worst_ate(passes, gt)
        print(f"{name}, noise draw {k}: {len(frame_ms)} frames in {time.perf_counter() - t0:.1f} s on the CPU, "
              f"{failed} not tracked, ATE {ate:.5f} m")
        assert len(passes) == 1 and len(passes[0]) == n
        assert failed == 0


def solve_args(seed=5, n=64):
    g = torch.Generator().manual_seed(seed)
    R0 = torch.linalg.qr(torch.randn(3, 3, generator=g))[0].contiguous()
    return {"R0": R0, "t0": torch.randn(3, generator=g), "points_w": torch.randn(n, 3, generator=g),
            "obs_uvur": 600 * torch.rand(n, 3, generator=g), "octave": torch.randint(0, 8, (n,), generator=g),
            "valid": torch.rand(n, generator=g) < 0.8, "rounds": 4, "iters": 10}


@pytest.mark.parametrize("entry", ["R0", "t0"])
def test_an_initial_pose_one_ulp_apart_counts_every_slot_unless_the_capture_sets_a_tolerance(entry):
    """The stereo cells compare a solve's initial pose bit for bit; only a
    capture that sets ``pose0_tol`` (the batched step's) lets it move."""
    a = solve_args()
    b = dict(a, **{entry: a[entry].clone()})
    b[entry].view(-1)[0] = torch.nextafter(b[entry].view(-1)[0], torch.tensor(2.0))
    n = int(a["valid"].sum())
    assert check.solve_mismatch(a, dict(a)) == (0, n)
    assert check.solve_mismatch(a, b) == (n, n)
    assert check.solve_mismatch(a, b, check.POSE0_TOL) == (0, n)
    far = dict(a, **{entry: a[entry] + 1e-3})
    assert check.solve_mismatch(a, far, check.POSE0_TOL) == (n, n)
