"""A run of the harness with the timed path broken underneath comes out not
correct, once for each fault a stereo cell can have: a step that returns
its state unchanged, half of the batch left out, an answer altered where
it is produced.  (Both cells run on one chip: no exchange between chips to
leave out.)  The harness's look for a card is skipped: the program runs on
the CPU, at a small camera and feature budget, against the kitti cell's
limits.  A short run there makes too few keyframes for a loop query to be
due, so the emptied loop query is run on the card, in the kitti cell itself
(python -m pytest -m cuda slambench/tests/test_slambench_faults.py)."""

import time

import pytest
import torch

from slambench import harness


def small_cell(n_frames=24):
    cell = harness.load_cell("kitti_stereo.seq")
    cfg = cell["config"]
    cfg["camera"] = {"fx": 200.0, "fy": 200.0, "cx": 160.0, "cy": 120.0, "bf": 40.0, "width": 320, "height": 240}
    cfg["orb"].update(n_features=500, n_levels=4)
    cfg["scene"] = {"points": 500, "seed": 3, "extent": [[-6, 6], [-3, 3], [2, 20]]}
    cfg["trajectory"]["step_m"] = 0.1
    cell["n_frames"] = n_frames
    cell["traffic"]["check"] = {"frames": 3, "ba_calls": 2}
    return cell


def run(seconds=14.0):
    torch.set_num_threads(4)
    cell = small_cell()
    rec = harness.run_cell(cell, 2**31 + 77, seconds, False, time.perf_counter(), device="cpu", log=lambda s: None)
    correct, checks = harness.decide(rec["numbers"], harness.cell_limits(cell))
    return correct, {k: v["value"] for k, v in checks.items()}


@pytest.fixture
def pose_opt():
    from orb_line_slam_tpu_torch.backend import pose_opt as mod

    saved = mod.pose_solve
    yield mod
    mod.pose_solve = saved


@pytest.fixture
def step():
    from orb_line_slam_tpu_torch.pipeline import track_step as mod

    saved = mod.search_by_projection
    yield mod
    mod.search_by_projection = saved


@pytest.fixture
def vocabulary():
    from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary

    saved = vars(Vocabulary)["dispatch_transform"]
    yield Vocabulary
    Vocabulary.dispatch_transform = saved


@pytest.fixture
def keyframe_db():
    from orb_line_slam_tpu_torch.slam_map.keyframe_db import KeyFrameDatabase

    saved = vars(KeyFrameDatabase)["detect_loop_candidates"]
    yield KeyFrameDatabase
    KeyFrameDatabase.detect_loop_candidates = saved


@pytest.fixture
def orb():
    from orb_line_slam_tpu_torch.frontend import orb_extractor as mod

    saved = mod.describe_keypoints
    yield mod
    mod.describe_keypoints = saved


def test_the_sound_program_is_correct():
    correct, numbers = run()
    assert correct, numbers


@pytest.mark.parametrize("rounds", [None, 4], ids=["every_solve", "the_final_solve_alone"])
def test_a_pose_solve_that_returns_its_state_unchanged(pose_opt, rounds):
    """Every solve, or only the final 4x10 one (paths A and B solve 2x8)."""
    solve = pose_opt.pose_solve

    def unchanged(R0, t0, *rest):
        out = solve(R0, t0, *rest)
        if rounds is not None and rest[-2] != rounds:
            return out
        return (R0.clone(), t0.clone(), *out[2:])

    pose_opt.pose_solve = unchanged
    correct, numbers = run()
    assert not correct, numbers


def test_a_pose_solve_that_leaves_out_half_of_its_observations(pose_opt):
    solve = pose_opt.pose_solve

    def half(R0, t0, points, obs, p_info, valid, *rest):
        kept = valid.clone()
        kept[valid.shape[0] // 2:] = False
        return solve(R0, t0, points, obs, p_info, kept, *rest)

    pose_opt.pose_solve = half
    correct, numbers = run()
    assert not correct, numbers


def test_descriptors_altered_where_they_are_made(orb):
    describe = orb.describe_keypoints

    def altered(atlas, axy, delta):
        angle, desc = describe(atlas, axy, delta)
        desc = desc.clone()
        desc[::7, 0] ^= 1
        return angle, desc

    orb.describe_keypoints = altered
    correct, numbers = run()
    assert not correct, numbers
    assert numbers["frontend_mismatch"] > 0.1


def test_half_of_the_matches_left_out(step):
    search = step.search_by_projection

    def half(*a, **k):
        m = search(*a, **k)
        keep = m.mask.clone()
        keep[keep.shape[0] // 2:] = False
        return type(m)(torch.where(keep, m.idx, torch.full_like(m.idx, -1)), m.dist, keep)

    step.search_by_projection = half
    correct, numbers = run()
    assert not correct, numbers
    assert numbers["track_match_mismatch"] > 0.1


def test_loop_words_altered_where_they_are_made(vocabulary):
    transform = vocabulary.dispatch_transform

    def altered(self, descs):
        return (transform(self, descs) + 1) % self.n_words

    vocabulary.dispatch_transform = altered
    correct, numbers = run()
    assert not correct, numbers
    assert numbers["loop_mismatch"] == 1.0


@pytest.mark.cuda
def test_a_loop_query_emptied_on_the_card(keyframe_db):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    keyframe_db.detect_loop_candidates = lambda self, *a, **k: []
    cell = harness.load_cell("kitti_stereo.seq")
    rec = harness.run_cell(cell, 2**31 + 79, 9.0, False, time.perf_counter(), log=print)
    correct, checks = harness.decide(rec["numbers"], harness.cell_limits(cell))
    print(rec["numbers"])
    assert rec["numbers"]["loop_queries"][1] > 0
    assert not correct, checks
    assert checks["loop_mismatch"]["value"] > checks["loop_mismatch"]["limit"]
