"""The port's map checkpoint (slam_map/checkpoint.py) against the JAX
package's: a round trip, the forward-compatible load of an older file,
and a file written by either package loaded by the other, every array
and scalar key equal.  Both maps are built by the same MapStore calls
(keyframe growth past capacity, culling with slot reuse, points and lines
erased) from one seed."""

import numpy as np
import pytest

from orb_line_slam_tpu.config import MapConfig as JaxMapConfig
from orb_line_slam_tpu.slam_map import checkpoint as jax_checkpoint
from orb_line_slam_tpu.slam_map.map_store import MapStore as JaxMapStore
from orb_line_slam_tpu_torch.config import MapConfig
from orb_line_slam_tpu_torch.slam_map import checkpoint
from orb_line_slam_tpu_torch.slam_map.map_store import MapStore

F, LF = 24, 6
SCALARS = ("_next_kf", "_free_pts", "_free_lines", "_free_kfs", "K", "P", "F", "L", "Lf")


class _Feats:
    def __init__(self, rng, n, lines=False):
        if lines:
            self.p0 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
            self.p1 = rng.uniform(0, 300, (n, 2)).astype(np.float32)
        else:
            self.xy = rng.uniform(0, 300, (n, 2)).astype(np.float32)
            self.u_right = rng.uniform(-1, 300, n).astype(np.float32)
            self.depth = rng.uniform(2, 20, n).astype(np.float32)
            self.octave = rng.integers(0, 4, n).astype(np.int32)
            self.angle = rng.uniform(-3, 3, n).astype(np.float32)
        self.desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
        self.valid = rng.uniform(size=n) > 0.1


def build_map(store_cls, cfg_cls, n_lines, seed=0):
    """Six keyframes into a 4-slot table (one growth), 5 points and 2 lines
    each, then keyframe 2 culled and re-used, points and a line erased."""
    rng = np.random.default_rng(seed)
    s = store_cls(cfg_cls(max_keyframes=4, max_points=64, max_lines=16), n_features=F, n_lines=n_lines)
    k = -1
    for i in range(7):
        if i == 6:
            s.erase_keyframe(2)     # the seventh keyframe takes its slot
        f = _Feats(rng, F)
        w = rng.normal(size=3) * 0.1
        R = np.asarray(np.eye(3) + np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]), np.float32)
        k = s.add_keyframe(f, R, rng.normal(size=3).astype(np.float32), i, timestamp=0.1 * i, parent=k)
        s.add_points(rng.normal(size=(5, 3)).astype(np.float32) + [0, 0, 8], f.desc[:5], f.octave[:5], k,
                     np.arange(5))
        if n_lines:
            s.set_kf_lines(k, _Feats(rng, n_lines, lines=True))
        s.add_lines(rng.normal(size=(2, 3)).astype(np.float32), rng.normal(size=(2, 3)).astype(np.float32),
                    rng.integers(0, 256, (2, 32), dtype=np.uint8), k, np.arange(2))
    s.erase_point(np.array([0, 3, 7], np.int32))
    s.erase_lines([1])
    return s


def assert_same_map(a, b):
    names = checkpoint._ARRAYS + (checkpoint._LINE_ARRAYS if a.Lf else [])
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name


def test_key_lists_match_jax():
    assert checkpoint._ARRAYS == jax_checkpoint._ARRAYS
    assert checkpoint._LINE_ARRAYS == jax_checkpoint._LINE_ARRAYS


@pytest.mark.parametrize("n_lines", [0, LF])
def test_round_trip(tmp_path, n_lines):
    s = build_map(MapStore, MapConfig, n_lines)
    assert s.K > 4 and s._free_kfs == [] and s.kf_valid.sum() == 6
    p = tmp_path / "map.npz"
    checkpoint.save_map(s, p)
    back = checkpoint.load_map(p)
    assert isinstance(back, MapStore)
    assert_same_map(s, back)
    # The loaded map works: its observation caches are rebuilt, and it
    # takes new landmarks from the saved free list.
    np.testing.assert_array_equal(back.obs_counts(), s.obs_counts())
    k = int(np.flatnonzero(back.kf_valid)[0])
    ids = back.add_points(np.zeros((3, 3), np.float32), np.zeros((3, 32), np.uint8), np.zeros(3, np.int32), k,
                          np.arange(20, 23))
    assert list(ids) == s._free_pts[-1:-4:-1]


def test_forward_compat(tmp_path):
    """A checkpoint written before kf_gen/pt_gen/ln_gen/kf_parent and the
    keyframe free list existed loads with their defaults."""
    s = build_map(MapStore, MapConfig, LF)
    p = tmp_path / "map.npz"
    checkpoint.save_map(s, p)
    z = dict(np.load(p))
    for name in ("kf_gen", "pt_gen", "ln_gen", "kf_parent", "_free_kfs"):
        z.pop(name)
    np.savez_compressed(p, **z)
    back = checkpoint.load_map(p)
    assert int(back.kf_valid.sum()) == int(s.kf_valid.sum())
    assert int(back.pt_valid.sum()) == int(s.pt_valid.sum())
    assert (back.kf_parent == -1).all()
    assert not back.kf_gen.any() and not back.pt_gen.any() and not back.ln_gen.any()
    assert back._free_kfs == []
    np.testing.assert_array_equal(back.kf_obs_lm, s.kf_obs_lm)


@pytest.mark.parametrize("n_lines", [0, LF])
def test_port_file_loads_in_jax(tmp_path, n_lines):
    s = build_map(MapStore, MapConfig, n_lines)
    p = tmp_path / "port.npz"
    checkpoint.save_map(s, p)
    assert_same_map(s, jax_checkpoint.load_map(p))


@pytest.mark.parametrize("n_lines", [0, LF])
def test_jax_file_loads_in_port(tmp_path, n_lines):
    j = build_map(JaxMapStore, JaxMapConfig, n_lines)
    assert_same_map(j, build_map(MapStore, MapConfig, n_lines))   # the same calls build the same map
    p = tmp_path / "jax.npz"
    jax_checkpoint.save_map(j, p)
    back = checkpoint.load_map(p)
    assert isinstance(back, MapStore)
    assert_same_map(j, back)
