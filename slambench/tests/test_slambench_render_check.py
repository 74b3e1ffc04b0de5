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
        with harness.Probes() as probes:
            _, frame_ms, passes, failed = harness.replay(prog, cfg, cell, [frames], probes, 0.0, "cpu",
                                                         whole_passes=True)
        ate = check.worst_ate(passes, gt)
        print(f"{name}, noise draw {k}: {len(frame_ms)} frames in {time.perf_counter() - t0:.1f} s on the CPU, "
              f"{failed} not tracked, ATE {ate:.5f} m")
        assert len(passes) == 1 and len(passes[0]) == n
        assert failed == 0
