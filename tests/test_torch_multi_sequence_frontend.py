"""The batched multi-sequence front end of the torch port on the CPU: the
batched plain stereo SAD against per-pair calls, ``build_stereo_frames``
against the JAX package's ``make_batched_frontend`` over a CPU mesh and
against the port's own single-pair frames, and ``torch.func.vmap`` of the
tracking step and of the line front end with functorch's per-sample
fallback turned into an error (an operator without a batching rule would
multiply the launches by B on the card)."""

import os
import subprocess
import sys
import textwrap
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orb_line_slam_tpu.config import LineConfig, MapConfig, OrbConfig, SlamConfig
from orb_line_slam_tpu.geometry.camera import CameraIntrinsics
from orb_line_slam_tpu.parallel.multi_sequence import make_batched_frontend
from orb_line_slam_tpu_torch.convert import config_from_jax
from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
from orb_line_slam_tpu_torch.frontend.frame import build_stereo_frame, build_stereo_frames
from orb_line_slam_tpu_torch.frontend.line_extractor import build_line_features
from orb_line_slam_tpu_torch.geometry.host import nbackproject
from orb_line_slam_tpu_torch.ops import stereo_sad
from orb_line_slam_tpu_torch.parallel.multi_sequence import track_sequences_frontend
from orb_line_slam_tpu_torch.pipeline.track_step import MapMirror, track_step
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731

# tests/test_aux_subsystems.py:197-219's camera and budgets.
CAM = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
CFG = SlamConfig(camera=CAM, orb=OrbConfig(n_features=256, n_levels=3))
B = 3


def _pairs(n=B, seed=21):
    """n rendered stereo pairs of one scene, 0.3 m apart along the view axis."""
    scene = SyntheticScene(config_from_jax(CFG).camera, n_points=700, n_lines=30, seed=seed,
                           extent=((-14, 14), (-6, 6), (8, 60)))
    pairs = [scene.render_stereo(np.eye(3), -np.array([0.0, 0.0, 0.3 * i])) for i in range(n)]
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _no_fallback(fn, *args):
    """fn(*args) with functorch's per-sample fallback warning on and raised
    as an error."""
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            return fn(*args)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)


def test_batched_stereo_sad_reference_equals_per_pair_calls():
    """The plain SAD of B pairs along a leading axis equals B one-pair
    calls exactly, at whole-number and fractional centres."""
    rng = np.random.default_rng(3)
    h, w, n = 90, 140, 50
    atlas = T((rng.random((2 * B, h, w)) * 255).astype(np.float32))
    axy = T(np.stack([rng.integers(-10, w + 10, (B, n)), rng.integers(-10, h + 10, (B, n))], -1).astype(np.int32))
    cx = T((axy[..., 0].numpy() - rng.uniform(0, 40, (B, n))).astype(np.float32))
    cy = T(axy[..., 1].numpy().astype(np.float32))
    for cxs in (torch.floor(cx), cx):
        got = stereo_sad.stereo_sad(atlas[:B], axy, atlas[B:], cxs.contiguous(), cy)
        assert got.shape == (B, n, 11)
        for b in range(B):
            assert torch.equal(got[b], stereo_sad.stereo_sad(atlas[b], axy[b], atlas[B + b], cxs[b].contiguous(), cy[b]))
    with pytest.raises(ValueError):
        stereo_sad.stereo_sad(atlas[:B], axy[:2], atlas[B:], cx[:2], cy[:2])   # batch sizes differ
    with pytest.raises(ValueError):
        stereo_sad.stereo_sad(atlas[:B], axy, atlas[B:], cx[0], cy[0])        # centres without the batch axis


def test_build_stereo_frames_matches_jax_batched_frontend():
    """Each pair's frame from build_stereo_frames against the JAX
    package's make_batched_frontend over a 3-device CPU mesh, under the
    frame contract of tests/test_torch_frontend.py: valid agreement > 0.98,
    keypoints < 0.51 px, median descriptor distance <= 1 bit, stereo-hit
    agreement > 0.95, > 95% of depths within 1% (over > 60 depths: the
    budget is 256 features, not the contract's 1000)."""
    left, right = _pairs()
    mesh = Mesh(np.array(jax.devices()[:B]), ("dp",))
    fj = jax.device_get(make_batched_frontend(mesh, CFG)(jnp.asarray(left), jnp.asarray(right)))
    ft = build_stereo_frames(T(left), T(right), config_from_jax(CFG)).numpy()
    assert ft.xy.shape == np.asarray(fj.xy).shape == (B, 256, 2)
    for b in range(B):
        agree = (fj.valid[b] == ft.valid[b]).mean()
        assert agree > 0.98, (b, agree)
        both = fj.valid[b] & ft.valid[b]
        assert np.abs(fj.xy[b][both] - ft.xy[b][both]).max() < 0.51
        assert np.median(np.unpackbits(fj.desc[b][both] ^ ft.desc[b][both], axis=1).sum(1)) <= 1
        dj, dt = fj.depth[b][both], ft.depth[b][both]
        assert ((dj > 0) == (dt > 0)).mean() > 0.95
        hit = (dj > 0) & (dt > 0)
        assert hit.sum() > 60, (b, hit.sum())
        assert (np.abs(dj[hit] - dt[hit]) / dj[hit] < 0.01).mean() > 0.95


def test_build_stereo_frames_equals_single_frames():
    """On the CPU the batched frames equal the single-pair frames bit for
    bit, and track_sequences_frontend gives one batched frame per time step."""
    cfg = config_from_jax(CFG)
    left, right = _pairs()
    fb = build_stereo_frames(T(left), T(right), cfg)
    for b in range(B):
        fs = build_stereo_frame(T(left[b]), T(right[b]), cfg)
        for name, a, c in zip(fs._fields, fs, fb):
            assert torch.equal(a, c[b]), (b, name)
    seqs_l = [[left[b], left[(b + 1) % B]] for b in range(B)]
    seqs_r = [[right[b], right[(b + 1) % B]] for b in range(B)]
    steps = track_sequences_frontend(cfg, seqs_l, seqs_r, device="cpu")
    assert len(steps) == 2
    for name, a, c in zip(fb._fields, fb, steps[0]):
        assert torch.equal(a, c), name
    assert torch.equal(steps[1].xy[0], fb.xy[1])
    with pytest.raises(ValueError):
        build_stereo_frames(T(left[0]), T(right[0]), cfg)


def _step_inputs(cfg, n_lines):
    """A stereo-initialised map and the cold-start inputs of one tracking
    step (test_torch_backend.py::test_track_step_parity's fixture)."""
    left, right = _pairs(2)
    frames = [build_stereo_frame(T(left[i]), T(right[i]), cfg) for i in range(2)]
    lines = build_line_features(T(left[1]), T(right[1]), cfg.camera, cfg.lines)
    store = MapStore(cfg.map, cfg.orb.n_features, n_lines=n_lines)
    f0 = frames[0].numpy()
    kf = store.add_keyframe(f0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32), 0, 0.0)
    idx = np.nonzero(f0.valid & (f0.depth > 0))[0]
    ids = store.add_points(nbackproject(cfg.camera, f0.xy, f0.depth)[idx], f0.desc[idx], f0.octave[idx], kf, idx)
    cap = cfg.map.local_points
    snap = np.full(cap, -1, np.int32)
    snap[: len(ids)] = ids
    mir = MapMirror(*(T(a) for a in (store.pt_pos, store.pt_desc, store.pt_oct, store.pt_valid,
                                     store.pt_max_dist, store.pt_min_dist, store.pt_normal)))
    n = cfg.orb.n_features
    carry = (torch.full((n,), -1, dtype=torch.int32), torch.eye(3), torch.zeros(3), torch.eye(3), torch.zeros(3),
             torch.tensor(False), frames[0].xy, frames[0].desc, frames[0].angle,
             T(store.kf_obs_lm[kf].astype(np.int32)), T(snap), torch.zeros(cap, dtype=torch.int32),
             torch.zeros(cap, dtype=torch.int32), torch.zeros(n_lines, dtype=torch.int32),
             torch.zeros(n_lines, dtype=torch.int32))
    # A line table of n_lines map lines: the frame's lines lifted to 3D by
    # their stereo depths where they have them.
    lf = lines.numpy()
    s = nbackproject(cfg.camera, lf.p0, np.where(lf.depth0 > 0, lf.depth0, 10.0))
    e = nbackproject(cfg.camera, lf.p1, np.where(lf.depth1 > 0, lf.depth1, 10.0))
    table = (T(s.astype(np.float32)), T(e.astype(np.float32)), T(lf.desc), T(lf.valid))
    return frames, lines, mir, carry, table


@pytest.mark.parametrize("has_lines", [False, True])
def test_vmap_of_track_step_has_no_fallback(has_lines):
    """torch.func.vmap of track_step over B copies of one step's inputs
    runs without a per-sample fallback, and each sequence's output equals
    the unbatched step's (poses within 1e-5, every other field exactly)."""
    cfg = config_from_jax(SlamConfig(camera=CAM, orb=OrbConfig(n_features=512, n_levels=4),
                                     lines=LineConfig(enabled=True, n_lines=32),
                                     map=MapConfig(max_keyframes=16, max_points=4096, local_points=1024)))
    frames, lines, mir, carry, table = _step_inputs(cfg, 32)
    lf = lines if has_lines else None
    want = track_step(frames[1], frames[0], mir, *carry, lf, *table, cfg=cfg, has_lines=has_lines)
    assert int(want.n_inliers) > 50 and (int(want.ln_match_mask.sum()) > 0) == has_lines

    stack = lambda x: torch.stack([x] * B)  # noqa: E731
    tree = lambda t: type(t)(*(stack(x) for x in t))  # noqa: E731

    def one(frame, last, mir, carry, lf, table):
        return track_step(frame, last, mir, *carry, lf, *table, cfg=cfg, has_lines=has_lines)

    fn = torch.func.vmap(one, in_dims=(0, 0, 0, 0, 0 if has_lines else None, 0))
    got = _no_fallback(fn, tree(frames[1]), tree(frames[0]), tree(mir), tuple(stack(x) for x in carry),
                       tree(lines) if has_lines else None, tuple(stack(x) for x in table))
    for name, a, c in zip(want._fields, want, got):
        for b in range(B):
            if name in ("R", "t", "Rv", "tv"):
                assert (c[b] - a).abs().max() <= 1e-5, name
            else:
                assert torch.equal(c[b], a), name


def test_vmap_of_build_line_features_has_no_fallback():
    """build_line_features on B pairs (the pair's function under
    torch.func.vmap) runs without a per-sample fallback and equals B
    single-pair calls exactly."""
    cfg = config_from_jax(SlamConfig(camera=CAM, lines=LineConfig(enabled=True, n_lines=32)))
    left, right = _pairs()
    got = _no_fallback(build_line_features, T(left), T(right), cfg.camera, cfg.lines)
    assert got.p0.shape == (B, 32, 2) and int(got.valid.sum()) > 0
    for b in range(B):
        want = build_line_features(T(left[b]), T(right[b]), cfg.camera, cfg.lines)
        for name, a, c in zip(want._fields, want, got):
            assert torch.equal(c[b], a), (b, name)


def test_multi_sequence_never_imports_jax(tmp_path):
    """The parallel package imports and runs batched steps with `import
    jax` and the JAX package made to fail."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = textwrap.dedent(f"""
        import sys
        class _Block:
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "orb_line_slam_tpu") or name.startswith(("jax.", "jaxlib", "orb_line_slam_tpu.")):
                    raise ImportError("blocked: " + name)
                return None
        sys.meta_path.insert(0, _Block())
        sys.path.insert(0, {root!r})
        import numpy as np, torch
        torch.set_num_threads(1)
        from orb_line_slam_tpu_torch.config import CameraIntrinsics, LineConfig, OrbConfig, SlamConfig
        from orb_line_slam_tpu_torch.data.synthetic import SyntheticScene
        from orb_line_slam_tpu_torch.parallel.multi_sequence import MultiSequenceTracker
        cam = CameraIntrinsics(fx=400.0, fy=400.0, cx=320.0, cy=160.0, bf=160.0, width=640, height=320)
        cfg = SlamConfig(camera=cam, orb=OrbConfig(n_features=512, n_levels=3), lines=LineConfig(n_lines=32))
        scene = SyntheticScene(cam, n_points=300, n_lines=30, seed=4, extent=((-14, 14), (-6, 6), (6, 60)))
        mst = MultiSequenceTracker(cfg, 2, full_slam=False, device="cpu")
        for i, z in enumerate((0.0, 0.2, 0.4)):
            pair = scene.render_stereo(np.eye(3), np.array([0.0, 0.0, -z]))
            mst.process_stereo([pair[0]] * 2, [pair[1]] * 2, [0.1 * i] * 2)
        mst.shutdown()
        assert mst.n_batched_frames == 1 and all(t.state == "OK" for t in mst.trackers)
        assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
        print("ok")
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path), env=env)
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stderr[-3000:]
