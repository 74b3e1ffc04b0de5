"""The control comes out not correct: the reference computed in the nearest
precision below the configurations' float32 with TF32 off, in the program's
place, reads above the cell's limits, on the card, at the cell's own size
(one pass and its samples, ``harness.pass_numbers``).  Run on the card:
python -m pytest -m cuda slambench/tests/test_slambench_control.py"""

import pytest

from slambench import harness

SEED = 2**31 + 301


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kitti_stereo.seq", "euroc_stereo.seq", "kitti_stereo.multiseq8"])
def test_the_control_fails_the_limits(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(name)
    rendered = harness.render_sequence(cell["config"], cell["traffic"], int(cell["n_frames"]), SEED)
    prog = harness.load_program("cuda")
    cfg = harness.slam_config(prog.config, cell["config"])
    row = harness.pass_numbers(prog, cfg, cell, SEED, rendered, "cuda", control=True)
    print(name, row)
    limits = harness.cell_limits(cell)
    assert harness.decide(row["program"], limits)[0]
    assert not harness.decide(row["control"], limits)[0]
