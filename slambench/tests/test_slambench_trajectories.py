"""Trajectory kinds are files found by name: ``forward`` is the drive the
configurations have always rendered, and ``circuit`` (the closed circuit of
chip_smoke.py's loop slice) comes back to its start."""

import numpy as np
import pytest

from slambench import check, harness, render


def centres(poses):
    return check.centres(np.stack([R for R, _ in poses]), np.stack([t for _, t in poses]))


def test_forward_is_the_drive_rendered_before_kinds_had_files():
    for n, step in ((80, 0.25), (100, 0.025)):
        got = harness.load_trajectory("forward")(n, {"kind": "forward", "step_m": step})
        want = render.circular_trajectory(n, step=step)
        assert len(got) == n
        for (Ra, ta), (Rb, tb) in zip(got, want):
            assert np.array_equal(Ra, Rb) and np.array_equal(ta, tb)


def test_a_circuit_returns_to_within_one_step_of_its_start():
    """170 frames, radius 8 m, 1.12 laps: past one lap a frame lies within
    one step of frame 0, and the path never strays from its circle."""
    spec = {"kind": "circuit", "radius_m": 8.0, "laps": 1.12}
    poses = harness.load_trajectory("circuit")(170, spec)
    c = centres(poses)
    step = np.linalg.norm(np.diff(c, axis=0), axis=1)
    assert np.allclose(step, step[0], rtol=1e-9)
    assert np.allclose(np.linalg.norm(c - np.array([8.0, 0.0, 0.0]), axis=1), 8.0, atol=1e-9)
    back = np.linalg.norm(c[100:] - c[0], axis=1)
    assert back.min() <= step[0]
    assert np.linalg.norm(c[85] - c[0]) > 10.0       # it went away first
    for R, _ in poses:
        assert np.allclose(R @ R.T, np.eye(3), atol=1e-12)


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError):
        harness.load_trajectory("nowhere")
