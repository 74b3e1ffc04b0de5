"""The batched multi-sequence step's check (the ``multiseq`` driver's
captures), against the plain reference:

- ``frontend_mismatch``: each sampled sequence's slice of the batched front
  end against the reference's ``build_stereo_frame`` on that sequence's
  raw pair;
- ``track_match_mismatch`` and the pose gaps (``pose_rotation_gap_rad``,
  ``pose_centre_gap_m``): the slice of the vmapped step's ``TrackOut``
  against the reference's ``track_step`` on the slice of the program's
  stacked state and the sequence's slice of the program's frame (held by
  ``frontend_mismatch`` by itself), its three solves replaced in order by
  the program's own results for that sequence, and each of those solves
  against the reference's plain solve on the same inputs;
- ``ba_centre_gap_m``: local BAs of the pass drawn over all sequences;
- ``loop_mismatch``: every keyframe insertion into each sequence's loop
  detector and its query, against the reference on that sequence's
  vocabulary corpus and state.

The samples, drawn from the seed over what the window's first pass ran:
``check.steps`` of its batched steps and ``check.sequences`` of the B
sequences in each, ``check.ba_calls`` of its local BAs over all sequences
(each a seeded reservoir: the items of lowest seeded priority).  The
numbers and the control (``control=True``) are ``check.py``'s, computed on
these captures; printed beside them: ``step_counts`` (the steps of the
window's passes that ran batched, per sequence while bootstrapping, and per
sequence for line mirrors of different capacities) and ``vmap_fallbacks``
(operators that vmap ran sample by sample)."""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from slambench import check
from slambench.ref.backend import pose_opt as ref_pose_opt
from slambench.ref.backend.residuals import inv_level_sigma2


def install(probes, cell: dict, seed: int) -> None:
    chk, n_seq, s = cell["traffic"]["check"], int(cell["traffic"]["sequences"]), int(seed) % 2 ** 63

    def step_priority(k):
        return np.random.default_rng((s, 2, k)).random()

    def sequences(k):
        rng = np.random.default_rng((s, 3, k))
        return sorted(rng.choice(n_seq, size=int(chk["sequences"]), replace=False).tolist())

    def ba_priority(key):
        return np.random.default_rng((s, 1, *key)).random()

    probes.sample(check.Reservoir(int(chk["steps"]), step_priority), sequences,
                  check.Reservoir(int(chk["ba_calls"]), ba_priority))


def octaves(info: torch.Tensor, scale_factor: float, n_levels: int) -> torch.Tensor:
    """The pyramid levels whose information weight is ``info`` (the pose
    solve operator takes the weights, ``pose_optimize`` the levels); -1
    where none is."""
    levels = torch.arange(n_levels, dtype=torch.int32, device=info.device)
    hit = info[..., None] == inv_level_sigma2(levels, scale_factor)
    return torch.where(hit.any(-1), hit.int().argmax(-1).to(torch.int32), torch.full_like(levels[:1], -1))


def pose_call(solve: dict, rec: dict, i: int) -> dict:
    """One captured solve of a sampled sequence as ``check.py`` holds a
    pose_optimize call: its arguments by name, its result, its path."""
    R0, t0, pts, obs, p_info, valid, ls, le, lobs, l_info, l_valid = solve["op"][:11]
    sf, n_levels = rec["scale_factor"], rec["n_levels"]
    lines = ls.shape[-2] > 0
    kw = {"R0": R0, "t0": t0, "points_w": pts, "obs_uvur": obs, "octave": octaves(p_info, sf, n_levels),
          "valid": valid, "cam": rec["cam"], "scale_factor": sf,
          "line_start_w": ls if lines else None, "line_end_w": le if lines else None,
          "line_obs": lobs if lines else None, "line_octave": octaves(l_info, sf, n_levels) if lines else None,
          "line_valid": l_valid if lines else None, "rounds": solve["rounds"], "iters": solve["iters"]}
    return {"args": kw, "result": ref_pose_opt.PoseOptResult(*solve["result"]),
            "path": check.SOLVE_PATHS[i] if i < len(check.SOLVE_PATHS) else "extra"}


def captures(probes):
    """``check.py``'s view of the batched captures, keyed by (batched-step
    ordinal, sequence), and the raw pairs under the same keys."""
    frontend, lines, pairs, steps, pose = {}, {}, {}, [], []
    for k, b, rec in probes.batched_steps:
        key = (k, b)
        frontend[key], pairs[key] = rec["frame"], rec["pair"]
        if rec["lf"] is not None:
            lines[key] = rec["lf"]
        solves = [pose_call(s, rec, i) for i, s in enumerate(rec["solves"])]
        steps.append((key, {"args": rec["args"], "solves": solves, "out": rec["out"]}))
        pose += solves
    # The steps run on the program's frames: the batched front end's float
    # outputs differ from the single frame's in the last bits (its own
    # comparison holds them to XY_TOL), and an exact comparison of the
    # solves' observations would count that detail as matching.  Path A's
    # initial pose, composed under vmap, is held to check.POSE0_TOL.
    step_frames = {(k, b): (rec["frame"], rec["lf"]) for k, b, rec in probes.batched_steps}
    cap = SimpleNamespace(frontend=frontend, lines=lines, steps=steps, pose=pose, step_frames=step_frames,
                          pose0_tol=check.POSE0_TOL, ba=[rec for _, rec in probes.ba_sample.items()],
                          loop_events=[], voc_train=None)
    return cap, pairs


def loop_numbers(probes, device, control: bool) -> dict:
    """The keyframe insertions of every sequence's loop detector against
    the reference's, sequence by sequence."""
    bad = total = due = with_cands = 0
    for b, events in sorted(probes.loop_by_seq.items()):
        train = probes.voc_by_seq.get(b)
        ref = check.ref_loop_outcomes(events, train, device)
        side = (check.ref_loop_outcomes(events, train, device, check._Bfloat16Database) if control
                else check.program_loop_outcomes(events))
        x, n = check.loop_mismatch(side, ref, events)
        bad, total = bad + x, total + n
        due += sum(o["queried"] for o in ref)
        with_cands += sum(bool(o["cands"]) for o in ref)
    if total == 0:
        return {}
    return {"loop_mismatch": bad / total, "loop_queries": [due, with_cands, total]}


def numbers(probes, ctx, control: bool = False) -> dict:
    chk = ctx.cell["traffic"]["check"]
    cap, pairs = captures(probes)
    produce = check.control_numbers if control else check.program_numbers
    out = produce(cap, pairs, ctx.cfg, ctx.device)
    with check.precision(False):
        out.update(loop_numbers(probes, ctx.device, control))
    if len(cap.steps) != int(chk["steps"]) * int(chk["sequences"]):
        # Fewer batched steps than the sample: the layers it samples read
        # nothing.
        out["frontend_mismatch"] = out["track_match_mismatch"] = None
    steps = probes.spans["steps"]
    out["step_counts"] = [sum(s[i] for s in steps) for i in range(3)]
    out["vmap_fallbacks"] = len(probes.vmap_fallbacks)
    return out
