"""What decides ``correct``: the program's outputs in the window against the
benchmark's plain reference (``slambench/ref``, a frozen copy of the
program's plain versions that imports nothing of the program), and the
replayed trajectory against the ground truth the benchmark rendered.

Each number is a gap between what the program produced and what the
reference makes of the same inputs:

- ``frontend_mismatch``: share of keypoint slots (valid on either side)
  whose validity, position, level, descriptor or stereo depth differ
  between the program's ``build_stereo_frame`` and the reference's, over
  the sampled frames' raw image pairs.
- ``line_mismatch``: the same for ``build_line_features`` (segments, LBD
  descriptors, endpoint depths), where the configuration has lines.
- ``pose_rotation_gap_rad``, ``pose_centre_gap_m``: the largest, over the
  solve paths (A, B, the final solve), of the median over the path's
  sampled solves of the gap between the pose the program's pose solve
  returned and the reference solve's on the same inputs (the points and
  observations the program's tracking step gathered: the reference follows
  the program's state there).  The median, not the widest gap: the kernel
  sums in another order than the plain solve, so now and then one solve's
  gating decision flips and its pose moves by up to the pose contract
  (1e-3 rad, 5e-3 m), further than the control moves a typical solve.
  The widest gaps are printed beside them.
- ``track_match_mismatch``: share of slots (valid on either side) where
  the tracking step's matching differs: the reference's tracking step runs
  on the sampled frame (its own front end's output; where the capture
  gives ``step_frames``, the program's frame and line features, whose
  front end the mismatch shares above hold by themselves) and the
  program's state before the step (last frame, map mirror, carry), its
  three pose solves replaced by the program's results in order; each
  solve's inputs (the selected observations and landmarks, the initial
  pose) are held to the program's, then the frame's final associations
  and line matches.
- ``loop_mismatch``: share of the sampled pass's keyframe insertions into
  the loop detector whose outcome differs from the reference's: the
  keyframe's BoW words (vocabulary retrained from the same corpus), whether
  a query was due and made, and its candidates and winner, on the
  program's covisibility and its database's keyframes at query time.
- ``ba_centre_gap_m``: the widest gap between the free keyframes' centres
  of the program's local BA and the reference BA on the same packed window.
- ``frames_not_tracked``: frames of the window that did not return a
  tracked pose (held to 0).
- ``ate_m``: the worst pass's absolute trajectory error (m, aligned) of
  the poses ``track_stereo`` returned against the rendered ground truth.
  It is printed but decides nothing: which keyframes a run makes moves it
  by a factor of ten from seed to seed, and the TF32 control reads inside
  that spread.

The control is the reference computed in the nearest precision below the
configuration's float32 with TF32 off, in the program's place
(``control_numbers``): TF32 matrix products and convolutions, and for the
line front end, which runs neither, bfloat16 elementwise arithmetic.
"""

from __future__ import annotations

import contextlib
import inspect

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import trajectory
from .ref import config as ref_config
from .ref.backend import line_ba as ref_line_ba
from .ref.backend import local_ba as ref_local_ba
from .ref.backend import pose_opt as ref_pose_opt
from .ref.frontend import frame as ref_frame
from .ref.frontend import line_extractor as ref_lines
from .ref.loop import detect as ref_detect
from .ref.loop import keyframe_db as ref_kfdb
from .ref.loop import vocabulary as ref_voc
from .ref.pipeline import track_step as ref_track

# Passes shorter than this many frames have no ATE of their own.
MIN_ATE_FRAMES = 20
# Tolerances of "the same" inside the mismatch shares: a keypoint position
# (px), a segment endpoint (px), a depth (relative).
XY_TOL_PX, LINE_TOL_PX, DEPTH_TOL = 1e-3, 1e-2, 1e-3
# The tracking step's pose solves, in the order it makes them.
SOLVE_PATHS = ("A", "B", "final")
# The initial-pose tolerance of a capture that sets ``pose0_tol`` (the
# batched step's: it composes path A's pose under vmap, whose 3x3 products
# sum in another order and move the last bit or two); R0 absolute, t0
# relative to its size.  Every other capture compares the pose exactly.
POSE0_TOL = 1e-6


class Bfloat16Rounding(TorchDispatchMode):
    """While entered, every float32 result an operation writes to memory of
    its own is rounded to bfloat16 in place (views share their base's,
    rounded where it was made): elementwise float32 arithmetic computed in
    bfloat16, the nearest precision below float32 where TF32 (which only
    matrix products and convolutions take) does not reach."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        returns = func._schema.returns
        for i, x in enumerate(out if isinstance(out, (tuple, list)) else (out,)):
            alias = returns[i].alias_info if i < len(returns) else None
            if alias is not None and not alias.is_write:      # a view: no value of its own
                continue
            if isinstance(x, torch.Tensor) and x.dtype == torch.float32:
                x.copy_(x.to(torch.bfloat16))
        return out


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convolutions in TF32 (tf32=True) or in
    full float32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres -R^T t of world-to-camera poses [..., 3, 3], [..., 3]."""
    R, t = np.asarray(R, np.float64), np.asarray(t, np.float64)
    return -np.einsum("...ji,...j->...i", R, t)


def rotation_gap(Ra, Rb) -> float:
    """Largest angle (rad) between matching rotations of two stacks, from
    the skew part of Ra Rb^T (the trace's arccos loses ~1e-3 rad to float32
    rounding near 0)."""
    d = np.einsum("cij,ckj->cik", np.asarray(Ra, np.float64).reshape(-1, 3, 3),
                  np.asarray(Rb, np.float64).reshape(-1, 3, 3))
    w = np.stack([d[:, 2, 1] - d[:, 1, 2], d[:, 0, 2] - d[:, 2, 0], d[:, 1, 0] - d[:, 0, 1]], -1)
    return float(np.arcsin(np.clip(np.linalg.norm(w, axis=1) / 2, 0, 1)).max())


class Reservoir:
    """The ``size`` items of lowest priority among those offered, the
    priority a function of the item's key (drawn from the run's seed): a
    sample of fixed size, drawn from the seed, of however many items a
    window produces, that holds at most ``size`` of them at a time."""

    def __init__(self, size: int = 0, priority=None):
        self.size, self.priority, self.kept = size, priority, {}

    def wants(self, key) -> bool:
        if self.size <= 0:
            return False
        if len(self.kept) < self.size:
            return True
        return self.priority(key) < max(p for p, _ in self.kept.values())

    def offer(self, key, item) -> None:
        self.kept[key] = (self.priority(key), item)
        while len(self.kept) > self.size:
            del self.kept[max(self.kept, key=lambda k: self.kept[k][0])]

    def items(self) -> list:
        """(key, item) in key order."""
        return [(k, self.kept[k][1]) for k in sorted(self.kept)]


# ---------------------------------------------------------------------------
# The reference's side of each layer, on the inputs the program was given.

def ref_slam_config(config: dict):
    c = config
    return ref_config.SlamConfig(
        camera=ref_config.CameraIntrinsics(**c["camera"]), orb=ref_config.OrbConfig(**c["orb"]),
        lines=ref_config.LineConfig(**c["lines"]), tracking=ref_config.TrackingConfig(**c["tracking"]),
        map=ref_config.MapConfig(**c["map"]), fps=float(c["fps"]))


def ref_point_frame(pair, cfg, device):
    left, right = (torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in pair)
    return ref_frame.build_stereo_frame(left, right, cfg)


def ref_line_frame(pair, cfg, device):
    left, right = (torch.from_numpy(np.ascontiguousarray(x)).to(device) for x in pair)
    return ref_lines.build_line_features(left, right, cfg.camera, cfg.lines)


def ref_pose(call: dict, cfg):
    """The reference solve of one captured pose_optimize call (its bound
    arguments, the camera converted)."""
    kw = dict(call)
    kw["cam"] = ref_config.CameraIntrinsics(*kw["cam"])
    return ref_pose_opt.pose_optimize(**kw)


def ref_ba(call: dict, cfg, device):
    """The reference local BA of one captured window, uploaded as the
    program's tracker uploads it (``_solve_local_ba``)."""
    pack, lpack, line0 = call["pack"], call["lpack"], call["line0"]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    point_args = tuple(t(pack[k]) for k in ("R", "t", "cam_fixed", "points", "point_valid", "obs_cam",
                                             "obs_lm", "obs_uvur", "obs_oct", "obs_valid"))
    if lpack is None:
        return ref_local_ba.bundle_adjust(*point_args, cfg.camera, cfg.orb.scale_factor)
    U0, w0, lval = line0
    return ref_line_ba.bundle_adjust_pl(
        *point_args, t(U0), t(w0), t(lval),
        *(t(lpack[k]) for k in ("lobs_cam", "lobs_ln", "lobs_a", "lobs_b")),
        torch.zeros(len(lpack["lobs_cam"]), dtype=torch.int32, device=device), t(lpack["lobs_valid"]),
        cfg.camera, cfg.orb.scale_factor)


# ---------------------------------------------------------------------------
# Gaps between two outputs of one layer.

def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def point_mismatch(a, b) -> tuple[int, int]:
    """(mismatched slots, slots valid on either side) of two Frames."""
    va, vb = _np(a.valid), _np(b.valid)
    either, both = va | vb, va & vb
    bad = either & ~both
    xy = np.abs(_np(a.xy) - _np(b.xy)).max(-1) > XY_TOL_PX
    octv = _np(a.octave) != _np(b.octave)
    desc = (_np(a.desc) != _np(b.desc)).any(-1)
    da, db = _np(a.depth), _np(b.depth)
    depth = ((da > 0) != (db > 0)) | ((da > 0) & (db > 0) & (np.abs(da - db) > DEPTH_TOL * np.abs(db)))
    bad |= both & (xy | octv | desc | depth)
    return int(bad.sum()), int(either.sum())


def line_mismatch(a, b) -> tuple[int, int]:
    """(mismatched slots, slots valid on either side) of two LineFeatures."""
    va, vb = _np(a.valid), _np(b.valid)
    either, both = va | vb, va & vb
    bad = either & ~both
    ends = np.maximum(np.abs(_np(a.p0) - _np(b.p0)).max(-1), np.abs(_np(a.p1) - _np(b.p1)).max(-1)) > LINE_TOL_PX
    desc = (_np(a.desc) != _np(b.desc)).any(-1)
    depth = np.zeros_like(va)
    for key in ("depth0", "depth1"):
        da, db = _np(getattr(a, key)), _np(getattr(b, key))
        depth |= ((da > 0) != (db > 0)) | ((da > 0) & (db > 0) & (np.abs(da - db) > DEPTH_TOL * np.abs(db)))
    bad |= both & (ends | desc | depth)
    return int(bad.sum()), int(either.sum())


def pose_gaps(a, b) -> tuple[float, float]:
    """(rotation gap rad, centre gap m) of two pose-solve results."""
    Ra, ta, Rb, tb = _np(a.R), _np(a.t), _np(b.R), _np(b.t)
    return rotation_gap(Ra, Rb), float(np.linalg.norm(centres(Ra, ta) - centres(Rb, tb)))


def ba_gap(a, b, cam_fixed) -> float:
    """Largest centre gap (m) of the free cameras of two BA results."""
    free = ~np.asarray(cam_fixed, bool)
    if not free.any():
        return 0.0
    ca, cb = centres(_np(a.R)[free], _np(a.t)[free]), centres(_np(b.R)[free], _np(b.t)[free])
    return float(np.linalg.norm(ca - cb, axis=-1).max())


def worst_ate(passes, gt_centres: np.ndarray):
    """Largest ATE (m) over the passes with at least MIN_ATE_FRAMES frames;
    ``passes`` are lists of the 4x4 Tcw each frame returned."""
    worst = None
    for poses in passes:
        if len(poses) < MIN_ATE_FRAMES:
            continue
        T = np.asarray(poses, np.float64)
        est = centres(T[:, :3, :3], T[:, :3, 3])
        ate = trajectory.ate_rmse(est, gt_centres[: len(poses)], align=True)
        worst = ate if worst is None else max(worst, ate)
    return worst


# ---------------------------------------------------------------------------
# The tracking step's matching, held to the reference's on the same state.

def _bind(fn, args, kwargs) -> dict:
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    return dict(bound.arguments)


def _same(a, b) -> bool:
    if a is None or b is None:
        return a is None and b is None
    return bool(np.array_equal(_np(a), _np(b)))


def _same_pose(a: dict, b: dict, tol: float) -> bool:
    """The two solves start from the same pose: bit for bit, or with a
    ``tol`` above 0 to within it."""
    if tol <= 0:
        return _same(a.get("R0"), b.get("R0")) and _same(a.get("t0"), b.get("t0"))
    Ra, ta, Rb, tb = (_np(x.get(k)).astype(np.float64) for x in (a, b) for k in ("R0", "t0"))
    return (Ra.shape == Rb.shape and ta.shape == tb.shape and np.abs(Ra - Rb).max() <= tol
            and np.abs(ta - tb).max() <= tol * max(1.0, np.abs(tb).max()))


def solve_mismatch(a: dict, b: dict, pose0_tol: float = 0.0) -> tuple[int, int]:
    """(mismatched, valid on either side) observation slots of two pose
    solves' inputs: a slot selected on one side only, or whose landmark or
    observation differs; every slot where the initial pose (exactly, or
    beyond ``pose0_tol``) or the schedule differs."""
    moved = not (_same_pose(a, b, pose0_tol) and all(_same(a.get(k), b.get(k)) for k in ("rounds", "iters")))
    bad = total = 0
    for valid, fields in (("valid", ("points_w", "obs_uvur", "octave")),
                          ("line_valid", ("line_start_w", "line_end_w", "line_obs"))):
        va, vb = a.get(valid), b.get(valid)
        if va is None and vb is None:
            continue
        va = _np(va).astype(bool) if va is not None else np.zeros(_np(vb).shape, bool)
        vb = _np(vb).astype(bool) if vb is not None else np.zeros(va.shape, bool)
        if va.shape != vb.shape:
            n = int(va.sum() + vb.sum())
            bad, total = bad + n, total + n
            continue
        either, both = va | vb, va & vb
        diff = va ^ vb
        for f in fields:
            d = _np(a[f]) != _np(b[f])
            diff |= both & (d.reshape(len(d), -1).any(-1) if d.ndim > 1 else d)
        if moved:
            diff = either
        bad, total = bad + int(diff.sum()), total + int(either.sum())
    return bad, total


def _selected(kw: dict) -> int:
    return sum(int(_np(kw[k]).sum()) for k in ("valid", "line_valid") if kw.get(k) is not None)


class SolveReplay:
    """Stands in for the pose solves of a reference tracking step: each
    call's inputs are held to the side's call of the same order, whose
    result is returned; a call the side did not make is solved plainly
    and counts every slot it selects as mismatched."""

    def __init__(self, calls, pose0_tol: float = 0.0):
        self.calls, self.i, self.bad, self.total = calls, 0, 0, 0
        self.pose0_tol = pose0_tol

    def __call__(self, *args, **kwargs):
        kw = _bind(ref_pose_opt.pose_optimize, args, kwargs)
        if self.i >= len(self.calls):
            n = _selected(kw)
            self.bad, self.total, self.i = self.bad + n, self.total + n, self.i + 1
            return ref_pose_opt.pose_optimize(**kw)
        call = self.calls[self.i]
        self.i += 1
        b, n = solve_mismatch(call["args"], kw, self.pose0_tol)
        self.bad, self.total = self.bad + b, self.total + n
        return ref_pose_opt.PoseOptResult(*call["result"])

    def finish(self) -> tuple[int, int]:
        """(mismatched, total) slots, the side's solves beyond the
        reference's counted whole."""
        n = sum(_selected(call["args"]) for call in self.calls[self.i:])
        return self.bad + n, self.total + n


def track_out_mismatch(a, b) -> tuple[int, int]:
    """(mismatched, total) of two tracking steps' outputs: each feature's
    landmark association (associated on either side), each map line's
    matched frame line (matched on either side), and the success flag."""
    ga, gb = _np(a.assoc_gid), _np(b.assoc_gid)
    either = (ga >= 0) | (gb >= 0)
    bad, total = int((either & (ga != gb)).sum()), int(either.sum())
    ma, mb = _np(a.ln_match_mask).astype(bool), _np(b.ln_match_mask).astype(bool)
    if ma.shape == mb.shape:
        e = ma | mb
        bad += int((e & ((ma != mb) | (_np(a.ln_match_idx) != _np(b.ln_match_idx)))).sum())
        total += int(e.sum())
    else:
        n = int(ma.sum() + mb.sum())
        bad, total = bad + n, total + n
    bad += bool(_np(a.ok)) != bool(_np(b.ok))
    return bad, total + 1


def track_mismatch(side: dict, args: dict, frame, lf, cfg, pose0_tol: float = 0.0) -> tuple[int, int]:
    """(mismatched, total) slots of one tracking step of ``side`` (its
    TrackOut and its pose solves in order) against the reference's step on
    ``args`` (the program's state before the step) with the reference's
    ``frame`` and ``lf``, the solves replayed from ``side`` (their initial
    poses compared exactly, or to ``pose0_tol``)."""
    replay = SolveReplay(side["solves"], pose0_tol)
    with torch.no_grad():
        out = ref_track.track_step(**step_inputs(args, frame, lf, cfg), solve=replay)
    b, n = track_out_mismatch(side["out"], out)
    rb, rn = replay.finish()
    return b + rb, n + rn


def step_inputs(args: dict, frame, lf, cfg) -> dict:
    return dict(args, frame=frame, lf=lf if args["has_lines"] else None, cfg=cfg)


def ref_track_side(args: dict, frame, lf, cfg) -> dict:
    """The reference's own tracking step on ``args`` with its plain pose
    solves, as a side: its TrackOut and its solves' inputs and results."""
    calls = []

    def solve(*a, **k):
        kw = _bind(ref_pose_opt.pose_optimize, a, k)
        res = ref_pose_opt.pose_optimize(**kw)
        calls.append({"args": kw, "result": res})
        return res

    with torch.no_grad():
        out = ref_track.track_step(**step_inputs(args, frame, lf, cfg), solve=solve)
    return {"out": out, "solves": calls}


# ---------------------------------------------------------------------------
# Loop detection, held to the reference's on the same state.

class _Bfloat16Database(ref_kfdb.KeyFrameDatabase):
    """The keyframe database with its BoW weights stored in bfloat16."""

    def add_bow(self, kf_id, ids, w):
        super().add_bow(kf_id, ids, torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16).float().numpy())


def ref_loop_outcomes(events, train, device, database=ref_kfdb.KeyFrameDatabase) -> list[dict]:
    """The reference's outcome of each captured keyframe insertion into the
    loop detector (``events``, in order; ``train`` the captured vocabulary
    training call): the keyframe's words, whether a query was due, and its
    candidates and winner.  The vocabulary is retrained from the same
    corpus; the covisibility, the database's keyframes at query time and the
    consistency groups are the program's state."""
    voc = None if train is None else ref_voc.Vocabulary.train(
        train["descriptors"], k=train["k"], depth=train["depth"], seed=train["seed"])
    db = None if voc is None else database(voc)
    out = []
    for e in events:
        o = {"words": None, "queried": bool(e["gen_ok"] and e["gate"]), "cands": None, "winner": None}
        if voc is not None:
            o["words"] = voc.dispatch_transform(torch.from_numpy(np.ascontiguousarray(e["desc"])).to(device)).cpu().numpy()
            if e["gen_ok"]:
                db.add_words(e["kf"], o["words"], e["valid"])
            q = e["query"]
            if o["queried"] and q is not None:
                for k in [k for k in db.bow if k not in q["db_keys"]]:
                    db.erase(k)
                cands, o["winner"], _ = ref_detect.detect(db, q["W"], e["kf"], q["groups"])
                o["cands"] = list(cands)
        out.append(o)
    return out


def program_loop_outcomes(events) -> list[dict]:
    out = []
    for e in events:
        q = e["query"]
        out.append({"words": e["words"], "queried": q is not None,
                    "cands": None if q is None or q["cands"] is None else list(q["cands"]),
                    "winner": None if q is None else q["winner"]})
    return out


def loop_mismatch(side: list[dict], ref: list[dict], events) -> tuple[int, int]:
    """(mismatched, total) keyframe insertions: the words of a valid slot
    differ, a due query was not made (or one was made that was not due), or
    the candidates (in order) or the winner differ."""
    bad = 0
    for a, b, e in zip(side, ref, events):
        v = np.asarray(e["valid"], bool)
        words = a["words"] is not None and b["words"] is not None and np.array_equal(
            np.asarray(a["words"])[v], np.asarray(b["words"])[v])
        query = a["queried"] == b["queried"] and (
            not b["queried"] or (a["cands"] == b["cands"] and a["winner"] == b["winner"]))
        bad += not (words and query)
    return bad, len(events)


# ---------------------------------------------------------------------------

def _layer_numbers(cap, frames, cfg, device, produce) -> dict:
    """The gap numbers of every captured layer; ``produce(kind, item)`` is
    the side held to the reference (the program's capture, or the
    control)."""
    out = {}
    ref_frames, ref_lfs = {}, {}

    def point_ref(i):
        if i not in ref_frames:
            ref_frames[i] = ref_point_frame(frames[i], cfg, device)
        return ref_frames[i]

    def line_ref(i):
        if i not in ref_lfs:
            ref_lfs[i] = ref_line_frame(frames[i], cfg, device)
        return ref_lfs[i]

    with precision(False):
        if cap.frontend:
            bad = total = 0
            for i, prog in cap.frontend.items():
                b, n = point_mismatch(produce("frontend", (i, prog)), point_ref(i))
                bad, total = bad + b, total + n
            out["frontend_mismatch"] = bad / max(total, 1)
        if cap.lines:
            bad = total = 0
            for i, prog in cap.lines.items():
                b, n = line_mismatch(produce("lines", (i, prog)), line_ref(i))
                bad, total = bad + b, total + n
            out["line_mismatch"] = bad / max(total, 1)
        if cap.steps:
            bad = total = 0
            on, tol = getattr(cap, "step_frames", None), getattr(cap, "pose0_tol", 0.0)
            for i, step in cap.steps:
                lines = step["args"]["has_lines"]
                frame, lf = on[i] if on else (point_ref(i), line_ref(i) if lines else None)
                lf = lf if lines else None
                side = produce("track", (step, frame, lf))
                b, n = track_mismatch(side, step["args"], frame, lf, cfg, tol)
                bad, total = bad + b, total + n
            out["track_match_mismatch"] = bad / max(total, 1)
        paths = [call for call in cap.pose if call["path"] in SOLVE_PATHS]
        if paths:
            gaps = {}
            for call in paths:
                gaps.setdefault(call["path"], []).append(
                    pose_gaps(produce("pose", call), ref_pose(call["args"], cfg)))
            medians = {p: np.median(np.array(g), axis=0) for p, g in gaps.items()}
            widest = np.max([np.max(np.array(g), axis=0) for g in gaps.values()], axis=0)
            out["pose_rotation_gap_rad"] = float(max(m[0] for m in medians.values()))
            out["pose_centre_gap_m"] = float(max(m[1] for m in medians.values()))
            out["pose_gap_medians"] = {p: [float(m[0]), float(m[1]), len(gaps[p])] for p, m in medians.items()}
            out["pose_rotation_gap_max_rad"], out["pose_centre_gap_max_m"] = (float(x) for x in widest)
        if cap.ba:
            out["ba_centre_gap_m"] = max(
                ba_gap(produce("ba", call), ref_ba(call, cfg, device), call["pack"]["cam_fixed"]) for call in cap.ba)
        if cap.loop_events:
            ref = ref_loop_outcomes(cap.loop_events, cap.voc_train, device)
            b, n = loop_mismatch(produce("loop", cap), ref, cap.loop_events)
            out["loop_mismatch"] = b / n
            out["loop_queries"] = [sum(o["queried"] for o in ref), sum(bool(o["cands"]) for o in ref), n]
    return out


def program_numbers(cap, frames, cfg, device) -> dict:
    """The program's captured outputs against the reference."""
    def produce(kind, item):
        if kind in ("frontend", "lines"):
            return item[1]
        if kind == "track":
            return item[0]
        if kind == "loop":
            return program_loop_outcomes(item.loop_events)
        return item["result"]

    return _layer_numbers(cap, frames, cfg, device, produce)


def control_numbers(cap, frames, cfg, device) -> dict:
    """The control: the reference computed in the nearest precision below
    the configuration's in the program's place, on the same inputs, against
    the reference: TF32 matrix products and convolutions; for the line
    front end, which has neither, its elementwise float32 in bfloat16; the
    loop detector's BoW weights stored in bfloat16."""
    def produce(kind, item):
        if kind == "lines":
            with Bfloat16Rounding():
                return ref_line_frame(frames[item[0]], cfg, device)
        if kind == "loop":
            return ref_loop_outcomes(item.loop_events, item.voc_train, device, _Bfloat16Database)
        with precision(True):
            if kind == "frontend":
                return ref_point_frame(frames[item[0]], cfg, device)
            if kind == "track":
                return ref_track_side(item[0]["args"], item[1], item[2], cfg)
            if kind == "pose":
                return ref_pose(item["args"], cfg)
            return ref_ba(item, cfg, device)

    return _layer_numbers(cap, frames, cfg, device, produce)


def bind_pose_call(fn, args, kwargs) -> dict:
    """pose_optimize's arguments by name, tensors cloned (the tracker
    writes some of its inputs in place later)."""
    return {k: (v.detach().clone() if isinstance(v, torch.Tensor) else v) for k, v in _bind(fn, args, kwargs).items()}
