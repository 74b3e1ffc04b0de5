"""Sim3 manifold, vocabulary and keyframe database of the torch port
against the JAX package on the CPU, on the same numpy inputs.  Sim3:
1e-5 absolute.  Vocabulary arrays, words, BoW vectors and candidate
lists: exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.geometry import sim3 as jsim3
from orb_line_slam_tpu.loop.vocabulary import Vocabulary as JaxVocabulary
from orb_line_slam_tpu.slam_map.keyframe_db import KeyFrameDatabase as JaxKeyFrameDatabase
from orb_line_slam_tpu_torch.convert import vocabulary_from_numpy
from orb_line_slam_tpu_torch.geometry import sim3
from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary
from orb_line_slam_tpu_torch.slam_map.keyframe_db import KeyFrameDatabase

torch.set_num_threads(1)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)


def _tangents():
    """Random tangents plus the branch points of _sim3_W: phi = 0,
    sigma = 0, both, tiny values either side of the 1e-5 switches, and
    a rotation near pi."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.4, (24, 7)).astype(np.float32)
    xi[0, 3:6] = 0.0
    xi[1, 6] = 0.0
    xi[2, 3:] = 0.0
    xi[3, 3:6] = [2e-6, -1e-6, 3e-6]
    xi[4, 6] = 5e-6
    xi[5, 3:6] = [3e-5, 0.0, 0.0]
    xi[6, 6] = 3e-5
    xi[7, 3:6] = np.array([0.6, -0.64, 0.48], np.float32) * (np.pi - 1e-2)
    xi[8, 3:] = [1e-6, 0.0, 0.0, 2e-6]
    return xi


def test_sim3_exp_log_match_jax():
    xi = _tangents()
    sj, Rj, tj = jsim3.sim3_exp(jnp.asarray(xi))
    s, R, t = sim3.sim3_exp(T(xi))
    assert np.abs(s.numpy() - np.asarray(sj)).max() < 1e-5
    assert np.abs(R.numpy() - np.asarray(Rj)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(tj)).max() < 1e-5
    assert np.isfinite(t.numpy()).all()
    back = sim3.sim3_log(s, R, t).numpy()
    assert np.abs(back - np.asarray(jsim3.sim3_log(sj, Rj, tj))).max() < 1e-5
    # log(exp(xi)) = xi to the accuracy of the fp32 series (not near pi, where so3_log clamps)
    ok = np.linalg.norm(xi[:, 3:6], axis=1) < 3.0
    assert np.abs(back[ok] - xi[ok]).max() < 5e-4


def test_sim3_compose_inverse_apply_retract_match_jax():
    xi = _tangents()
    rng = np.random.default_rng(1)
    x = rng.normal(0, 3, (xi.shape[0], 3)).astype(np.float32)
    a = sim3.sim3_exp(T(xi))
    b = sim3.sim3_exp(T(xi[::-1].copy()))
    aj = jsim3.sim3_exp(jnp.asarray(xi))
    bj = jsim3.sim3_exp(jnp.asarray(xi[::-1].copy()))
    pairs = [
        (sim3.sim3_compose(*a, *b), jsim3.sim3_compose(*aj, *bj)),
        (sim3.sim3_inverse(*a), jsim3.sim3_inverse(*aj)),
        (sim3.sim3_retract(*a, T(xi[::-1].copy() * 0.1)), jsim3.sim3_retract(*aj, jnp.asarray(xi[::-1].copy() * 0.1))),
    ]
    for got, want in pairs:
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() < 1e-5
    assert np.abs(sim3.sim3_apply(*a, T(x)).numpy() - np.asarray(jsim3.sim3_apply(*aj, jnp.asarray(x)))).max() < 1e-5
    # S^-1 o S = identity
    s, R, t = sim3.sim3_compose(*sim3.sim3_inverse(*a), *a)
    assert np.abs(s.numpy() - 1).max() < 1e-5 and np.abs(t.numpy()).max() < 1e-5
    assert np.abs(R.numpy() - np.eye(3)).max() < 1e-5


# ----------------------------------------------------------------------
def _descs(n, seed):
    return np.random.default_rng(seed).integers(0, 256, (n, 32), dtype=np.uint8)


def _clustered_descs(n, n_centers, seed):
    """Descriptors around a few centres (a few flipped bits each), so a
    trained tree has structure."""
    rng = np.random.default_rng(seed)
    centers = rng.integers(0, 2, (n_centers, 256), dtype=np.uint8)
    bits = centers[rng.integers(0, n_centers, n)] ^ (rng.random((n, 256)) < 0.06).astype(np.uint8)
    return np.packbits(bits, axis=1)


def _same_arrays(a, b):
    return all(np.array_equal(getattr(a, f), getattr(b, f))
               for f in ("children", "node_desc", "word_id", "word_weight")) and (a.k, a.depth) == (b.k, b.depth)


def test_vocabulary_train_identical_arrays():
    d = _clustered_descs(1500, 40, 2)
    vj = JaxVocabulary.train(d, k=8, depth=3, seed=0)
    vt = Vocabulary.train(d, k=8, depth=3, seed=0)
    assert _same_arrays(vj, vt) and vt.n_words == vj.n_words > 8
    assert _same_arrays(vt, vocabulary_from_numpy(vj))


def test_vocabulary_synthesize_identical_arrays():
    assert _same_arrays(JaxVocabulary.synthesize(k=10, depth=3, seed=4), Vocabulary.synthesize(k=10, depth=3, seed=4))


@pytest.mark.parametrize("kind", ["trained", "synthetic_dead_end"])
def test_transform_words_identical(kind):
    if kind == "trained":
        d = _clustered_descs(1500, 40, 2)
        vj = JaxVocabulary.train(d, k=8, depth=3, seed=0)
        q = np.concatenate([d[:300], _descs(212, 5)])
    else:
        vj = JaxVocabulary.synthesize(k=10, depth=3, seed=4)
        # A dead end: an internal node loses all its children, and one of
        # the root's children is removed outright.
        vj.children[3, :] = -1
        vj.children[0, 7] = -1
        q = _descs(512, 6)
    vt = vocabulary_from_numpy(vj)
    valid = np.random.default_rng(7).random(len(q)) > 0.2
    wj = vj.transform_words(q, valid)
    wt = vt.transform_words(T(q), T(valid))
    assert np.array_equal(wj, wt)
    assert (wt[~valid] == -1).all()
    if kind == "synthetic_dead_end":
        assert (wt[valid] == -1).any()       # descents that stop at the childless node
    dev_words = vt.dispatch_transform(T(q))
    assert isinstance(dev_words, torch.Tensor) and dev_words.dtype == torch.int32
    ij, wj_ = vj.bow_vector(q, valid)
    it, wt_ = vt.bow_vector(T(q), T(valid))
    assert np.array_equal(ij, it) and np.array_equal(wj_, wt_)
    it2, wt2 = Vocabulary.bow_from_words(wt, valid, vt.word_weight)
    assert np.array_equal(it, it2) and np.array_equal(wt_, wt2)
    a = vt.bow_vector(T(q[:200]), T(valid[:200]))
    b = vt.bow_vector(T(q[100:400]), T(valid[100:400]))
    assert Vocabulary.score_l1(*a, *b) == JaxVocabulary.score_l1(*a, *b)
    assert abs(Vocabulary.score_l1(*a, *a) - 1.0) < 1e-6


def test_orbvoc_text_round_trip(tmp_path):
    d = _clustered_descs(800, 20, 3)
    vt = Vocabulary.train(d, k=6, depth=3, seed=1)
    vt.word_weight[:] = np.random.default_rng(0).uniform(0.5, 4.0, vt.n_words).astype(np.float32)
    path = tmp_path / "voc.txt"
    vt.save_orbvoc_txt(path)
    back = Vocabulary.parse_orbvoc_txt(path)
    assert (back.k, back.depth, back.n_words) == (vt.k, vt.depth, vt.n_words)
    q = _descs(256, 9)
    ok = np.ones(256, bool)
    assert np.array_equal(back.transform_words(T(q), T(ok)), vt.transform_words(T(q), T(ok)))
    np.testing.assert_allclose(back.word_weight, vt.word_weight, rtol=1e-5)
    # and the JAX package reads the port's file to the same tree
    vj = JaxVocabulary.parse_orbvoc_txt(path)
    assert _same_arrays(vj, back)


# ----------------------------------------------------------------------
def test_keyframe_db_same_candidates():
    """The same insert / erase / recycle / detect sequence through both
    databases gives the same candidate lists."""
    place = [_clustered_descs(200, 12, 100 + p) for p in range(6)]
    vj = JaxVocabulary.train(np.concatenate(place), k=6, depth=3, seed=0)
    vt = vocabulary_from_numpy(vj)
    dj, dt = JaxKeyFrameDatabase(vj), KeyFrameDatabase(vt)
    rng = np.random.default_rng(11)

    def view(p):
        d = place[p].copy()
        flip = rng.random(d.shape[0]) < 0.15
        d[flip] = _descs(int(flip.sum()), int(rng.integers(1 << 30)))
        return d, rng.random(d.shape[0]) > 0.1

    seq = [0, 1, 2, 3, 4, 5, 1, 0]
    for kf, p in enumerate(seq):
        d, v = view(p)
        dj.add(kf, d, v)
        dt.add(kf, T(d), T(v))
    assert dj.bow.keys() == dt.bow.keys()
    for kf in dj.bow:
        assert np.array_equal(dj.bow[kf][0], dt.bow[kf][0]) and np.array_equal(dj.bow[kf][1], dt.bow[kf][1])
    groups = {k: {k, max(k - 1, 0)} for k in range(len(seq))}
    for kf, covis in ((7, {6, 7}), (6, {5, 6, 7}), (3, {2, 3, 4})):
        for g in (None, groups, lambda k: groups[k]):
            cj = dj.detect_loop_candidates(kf, 0.01, covis, g)
            ct = dt.detect_loop_candidates(kf, 0.01, covis, g)
            assert cj == ct
    assert 0 in dt.detect_loop_candidates(7, 0.01, {6, 7})
    # erase, then recycle slot 2 with another place's view
    dj.erase(0)
    dt.erase(0)
    d, v = view(0)
    dj.add(2, d, v)
    dt.add(2, T(d), T(v))
    assert dj.inverted == dt.inverted
    cj = dj.detect_loop_candidates(7, 0.01, {6, 7})
    ct = dt.detect_loop_candidates(7, 0.01, {6, 7})
    assert cj == ct and 0 not in ct and 2 in ct
    q, qv = view(1)
    rj = dj.detect_relocalization_candidates(q, qv)
    rt = dt.detect_relocalization_candidates(T(q), T(qv))
    assert rj == rt and rt[0] in (1, 6)
    assert dt.score(1, 6) == dj.score(1, 6)
