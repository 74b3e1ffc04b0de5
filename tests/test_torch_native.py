"""The port's native bridge (utils/native.py): tests/test_native.py's
three tests against the port (the ORBvoc parser against the pure-Python
parse, the prefetching stereo loader, the OpenCV LBD oracle's agreement
with the port's ops/lines.py + ops/lbd.py), and the port's vocabulary
parse against the JAX package's.  They skip where the library or the
oracle cannot be built, as JAX's do."""

import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from orb_line_slam_tpu.loop.vocabulary import Vocabulary as JaxVocabulary
from orb_line_slam_tpu_torch.loop.vocabulary import Vocabulary
from orb_line_slam_tpu_torch.utils.native import NativeStereoLoader, get_native_lib, parse_orbvoc_native
from tests.test_native import make_fake_orbvoc

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
VOC_ARRAYS = ("children", "node_desc", "word_id", "word_weight")


class TestVocabParser:
    def test_native_matches_python(self):
        if get_native_lib() is None:
            pytest.skip("native lib unavailable")
        with tempfile.TemporaryDirectory() as d:
            p = os.path.join(d, "voc.txt")
            make_fake_orbvoc(p)
            parsed = parse_orbvoc_native(p)
            assert parsed is not None
            k, L, parents, leafs, descs, weights = parsed
            assert k == 3 and L == 2
            assert len(parents) == 3 + 9
            py = Vocabulary.parse_orbvoc_nodes(p)
            assert py[:2] == (k, L)
            for a, b in zip(parsed[2:], py[2:]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            voc = Vocabulary.parse_orbvoc_txt(p)
            assert voc.n_words == 9
            # transform works end-to-end
            dd = np.random.default_rng(1).integers(0, 256, (16, 32), dtype=np.uint8)
            words = voc.transform_words(torch.from_numpy(dd), np.ones(16, bool))
            assert ((words >= 0) & (words < 9)).all()

    def test_parse_matches_jax(self, tmp_path):
        """A synthesized vocabulary written by save_orbvoc_txt parses to the
        JAX package's tree, natively and in Python."""
        p = tmp_path / "voc.txt"
        Vocabulary.synthesize(k=4, depth=3, seed=2).save_orbvoc_txt(p)
        ref = JaxVocabulary.parse_orbvoc_txt(p)
        for voc in (Vocabulary.parse_orbvoc_txt(p), Vocabulary._from_node_list(*Vocabulary.parse_orbvoc_nodes(p))):
            assert (voc.k, voc.depth, voc.n_words) == (ref.k, ref.depth, ref.n_words) == (4, 3, 64)
            for name in VOC_ARRAYS:
                np.testing.assert_array_equal(getattr(voc, name), getattr(ref, name), err_msg=name)


class TestNativeLoader:
    def test_prefetch_loader(self):
        if get_native_lib() is None:
            pytest.skip("native lib unavailable")
        import cv2

        rng = np.random.default_rng(0)
        with tempfile.TemporaryDirectory() as d:
            lefts, rights, gts = [], [], []
            for i in range(6):
                img_l = rng.integers(0, 255, (64, 96), dtype=np.uint8)
                img_r = rng.integers(0, 255, (64, 96), dtype=np.uint8)
                lp = os.path.join(d, f"l{i}.png")
                rp = os.path.join(d, f"r{i}.png")
                cv2.imwrite(lp, img_l)
                cv2.imwrite(rp, img_r)
                lefts.append(lp)
                rights.append(rp)
                gts.append((img_l, img_r))
            loader = NativeStereoLoader(lefts, rights, 64, 96, n_workers=2, ring=4)
            assert len(loader) == 6
            for i in range(6):
                l, r = loader.get(i)
                np.testing.assert_array_equal(l, gts[i][0])
                np.testing.assert_array_equal(r, gts[i][1])
            loader.close()


class TestLBDOracle:
    def test_matching_agreement_with_opencv(self):
        """The port's LBD and OpenCV's must mostly agree on which line pairs
        match between two shifted views, and the port's descriptors stay
        within the line contract (median <= 8 bits) of the JAX package's on
        the oracle's segments; the port's own detector finds lines there."""
        oracle = NATIVE_DIR / "build" / "lbd_oracle"
        if not oracle.exists():
            subprocess.run(["make"], cwd=NATIVE_DIR, capture_output=True)
            if not oracle.exists():
                pytest.skip("lbd_oracle not buildable")
        import cv2
        import jax.numpy as jnp

        from orb_line_slam_tpu.ops.lbd import lbd_descriptors as jax_lbd
        from orb_line_slam_tpu_torch.ops.lbd import lbd_descriptors
        from orb_line_slam_tpu_torch.ops.lines import detect_lines, merge_collinear
        from tests.test_lines import draw_scene

        img1, _ = draw_scene(seed=6)
        img2 = np.roll(img1, 7, axis=1)

        def oracle_lines(img):
            with tempfile.NamedTemporaryFile(suffix=".png", delete=False) as f:
                cv2.imwrite(f.name, img)
                out = subprocess.run(
                    [str(oracle), f.name, "25"], capture_output=True, text=True
                ).stdout
            os.unlink(f.name)
            segs, descs = [], []
            for line in out.strip().splitlines():
                vals = line.split()
                segs.append([float(v) for v in vals[:4]])
                descs.append([int(v) for v in vals[4:]])
            return np.asarray(segs), np.asarray(descs, np.uint8)

        s1, d1 = oracle_lines(img1)
        s2, d2 = oracle_lines(img2)
        if len(s1) < 3 or len(s2) < 3:
            pytest.skip("oracle found too few lines")

        # OpenCV LBD matching (hamming brute force)
        def best_match(da, db):
            bits_a = np.unpackbits(da, axis=1)
            bits_b = np.unpackbits(db, axis=1)
            dist = (bits_a[:, None] != bits_b[None, :]).sum(-1)
            return dist.argmin(1)

        cv_match = best_match(d1, d2)

        # The port's LBD on the oracle's own segments (same geometry!)
        def ours(img, segs):
            p0 = torch.from_numpy(segs[:, :2].astype(np.float32))[None]
            p1 = torch.from_numpy(segs[:, 2:].astype(np.float32))[None]
            return lbd_descriptors(torch.from_numpy(img.astype(np.float32))[None], p0, p1,
                                   torch.ones(1, len(segs), dtype=torch.bool))[0].numpy()

        def theirs(img, segs):
            return np.asarray(jax_lbd(
                jnp.asarray(img.astype(np.float32)), jnp.asarray(segs[:, :2].astype(np.float32)),
                jnp.asarray(segs[:, 2:].astype(np.float32)), jnp.ones(len(segs), bool),
            ))

        o1 = ours(img1, s1)
        o2 = ours(img2, s2)
        our_match = best_match(o1, o2)

        agree = (cv_match == our_match).mean()
        assert agree > 0.6, f"LBD matching agreement {agree:.2f}"
        bits = np.unpackbits(o1 ^ theirs(img1, s1), axis=1).sum(1)
        assert np.median(bits) <= 8, bits

        lines = merge_collinear(detect_lines(torch.from_numpy(img1.astype(np.float32))[None], n_lines=64))
        assert int(lines.valid.sum()) >= 3
