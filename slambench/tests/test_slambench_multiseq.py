"""The multi-sequence driver and its check on the CPU: B = 2 sequences of a
small camera batched through MultiSequenceTracker read ``correct``, and a
run with the batched path broken underneath does not: the two sequences'
slices of a batched step swapped before they are consumed, half of the
batch left out, the batched pose solves returning their state unchanged.
(The cell runs on one chip: no exchange between chips to leave out.)  The
harness's look for a card is skipped (the program runs its plain versions
on CPU tensors); minutes a case."""

import time

import pytest
import torch

from slambench import harness


def small_cell(steps=14):
    cell = harness.load_cell("kitti_stereo.multiseq8")
    cfg = cell["config"]
    cfg["camera"] = {"fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 120.0, "bf": 40.0, "width": 320, "height": 240}
    cfg["orb"].update(n_features=500, n_levels=4)
    cfg["scene"] = {"points": 500, "seed": 3, "extent": [[-6, 6], [-3, 3], [2, 20]]}
    cfg["trajectory"]["step_m"] = 0.1
    traffic = cell["traffic"]
    traffic.update(sequences=2, steps=steps)
    traffic["trace"]["steps"] = 4
    traffic["check"].update(steps=3, sequences=2, ba_calls=2)
    cell["n_frames"] = traffic["stagger"] + steps
    return cell


def run(seconds=1.0):
    """A window of whole passes: the first, here (~2.5 s a step)."""
    torch.set_num_threads(4)
    cell = small_cell()
    rec = harness.run_cell(cell, 2**31 + 93, seconds, False, time.perf_counter(), device="cpu", log=print)
    correct, checks = harness.decide(rec["numbers"], harness.cell_limits(cell))
    return correct, {k: v["value"] for k, v in checks.items()}, rec


@pytest.fixture
def multi_sequence():
    from orb_line_slam_tpu_torch.parallel import multi_sequence as mod

    saved = mod.batched_frame_track
    yield mod
    mod.batched_frame_track = saved


@pytest.fixture
def pose_opt():
    from orb_line_slam_tpu_torch.backend import pose_opt as mod

    saved = mod.pose_solve
    yield mod
    mod.pose_solve = saved


def test_the_sound_batched_program_is_correct():
    correct, numbers, rec = run()
    assert correct, numbers
    batched, bootstrap, mixed = rec["numbers"]["step_counts"]
    assert batched > bootstrap + mixed and rec["numbers"]["vmap_fallbacks"] == 0
    assert rec["run"].attempted == 2 * len(rec["run"].frame_ms)
    # The window holds whole passes of the traffic's steps.
    assert len(rec["run"].frame_ms) == rec["run"].passes * 14


@pytest.mark.parametrize("fault", ["two_sequences_swapped", "half_the_batch_left_out"])
def test_a_batched_step_whose_slices_are_wrong(multi_sequence, fault):
    """The batched step's outputs, before the sequences consume them: the
    two sequences' slices swapped, or the second half of the batch handed
    the first half's (left out of the step)."""
    track = multi_sequence.batched_frame_track

    def broken(*a, **k):
        frames, lfs, outs = track(*a, **k)
        B = outs.R.shape[0]
        if fault == "two_sequences_swapped":
            index = torch.arange(B - 1, -1, -1)
        else:
            index = torch.arange(B) % max(B // 2, 1)
        return frames, lfs, type(outs)(*(x[index] for x in outs))

    multi_sequence.batched_frame_track = broken
    correct, numbers, _ = run()
    assert not correct, numbers
    assert numbers["track_match_mismatch"] > 0.1


def test_a_batched_pose_solve_that_returns_its_state_unchanged(pose_opt):
    """The B solves of a batched launch (the operator called with a
    leading [B]) return their initial poses."""
    solve = pose_opt.pose_solve

    def unchanged(R0, t0, *rest):
        out = solve(R0, t0, *rest)
        if torch._C._functorch.is_functorch_wrapped_tensor(R0) or R0.dim() != 3:
            return out
        return (R0.clone(), t0.clone(), *out[2:])

    pose_opt.pose_solve = unchanged
    correct, numbers, _ = run()
    assert not correct, numbers
