"""ORB keypoint detection of the torch port on the CPU
(``ops/detect.py``): the kernel's per-level table against the values the
plain version's level loop uses, the table's words against the struct in
``csrc/orb_detect.cu``, the device dispatch and its refusals, and the CUDA
source itself compiled for the host by g++ (a std::thread per CUDA
thread) and held to the plain version with equality on every output, at
image, stereo-pair and batch shapes, on ties, on a blank image and where
a level has fewer candidates than its quota.  The plain version is held
to the JAX package in tests/test_torch_frontend.py."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from orb_line_slam_tpu_torch.config import OrbConfig
from orb_line_slam_tpu_torch.frontend import orb_extractor
from orb_line_slam_tpu_torch.ops import _build, detect
from orb_line_slam_tpu_torch.ops.image import build_pyramid, pyramid_atlas, pyramid_shapes

torch.set_num_threads(1)

# (h, w, n_features) of the KITTI, EuRoC and TUM cells and of OrbConfig's defaults.
CELLS = {"kitti": (376, 1241, 2000), "euroc": (480, 752, 1200), "tum": (480, 640, 1000),
         "default": (376, 1241, OrbConfig().n_features)}


def _image(seed, b, h, w, kind="smooth"):
    rng = np.random.default_rng(seed)
    noise = rng.random((b, h + 4, w + 4)) * 255
    img = sum(noise[:, i:i + h, j:j + w] for i in range(5) for j in range(5)) / 25  # 5x5 box: corners and flats
    img = img * 0.6 + noise[:, 2:h + 2, 2:w + 2] * 0.4
    if kind == "ties":      # quantised plateaus, and a checkerboard over half of it: equal scores everywhere
        img = np.floor(img / 48) * 48
        yy, xx = np.mgrid[0:h, 0:w]
        img[:, :, w // 2:] = (((yy // 5 + xx // 5) % 2) * 120 + 40)[:, w // 2:]
    if kind == "blank":
        img = np.full((b, h, w), 77.0)
    return torch.from_numpy(img.astype(np.float32))


def _pyramid(img, cfg):
    levels = build_pyramid(img, cfg.n_levels, cfg.scale_factor)
    atlas, _ = pyramid_atlas(levels)
    return levels, atlas.contiguous()


def _reference_levels(h, w, n_features, monkeypatch):
    """The per-level values the plain version's level loop uses on an image
    of the cell's size, recorded from its calls of select_topk_grid, its
    outputs and the atlas's own offsets."""
    cfg = OrbConfig(n_features=n_features)
    calls = []

    def recording(score, cell, k, n_total, min_score):
        calls.append({"h": score.shape[-2], "w": score.shape[-1], "cell": cell, "k": k, "quota": n_total,
                      "min_score": min_score})
        return select(score, cell, k, n_total, min_score)

    select = detect.select_topk_grid
    monkeypatch.setattr(detect, "select_topk_grid", recording)
    levels, atlas = _pyramid(_image(7, 1, h, w), cfg)
    out = detect.detect_reference(levels, cfg)
    monkeypatch.setattr(detect, "select_topk_grid", select)
    _, offs = pyramid_atlas(levels)
    return cfg, levels, calls, offs.tolist(), [o[0] for o in out]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_level_table_is_the_reference_loops_values(cell, monkeypatch):
    h, w, n = CELLS[cell]
    cfg, levels, calls, offs, (xy, axy, resp, octv, valid, delta) = _reference_levels(h, w, n, monkeypatch)
    t = detect.level_table([tuple(l.shape[-2:]) for l in levels], cfg)
    assert t["n_levels"] == len(calls) == cfg.n_levels
    assert [(c["h"], c["w"]) for c in calls] == list(zip(t["h"], t["w"])) == pyramid_shapes(h, w, cfg.n_levels,
                                                                                             cfg.scale_factor)
    assert t["row_off"] == offs
    assert t["k"] == [c["k"] for c in calls] and all(c["cell"] == detect.CELL for c in calls)
    assert t["quota"] == [c["quota"] for c in calls] == list(cfg.level_quotas)
    assert t["n_out"] == xy.shape[0] == cfg.n_features
    octv = octv.numpy()
    assert t["col_start"] == [int(np.argmax(octv == lvl)) for lvl in range(cfg.n_levels)]
    assert t["quota"] == [int((octv == lvl).sum()) for lvl in range(cfg.n_levels)]
    # The padded grid select_topk_grid reshapes the level into.
    assert t["n_cells"] == [-(-c["h"] // c["cell"]) * -(-c["w"] // c["cell"]) for c in calls]
    assert t["wc"] == [-(-c["w"] // c["cell"]) for c in calls]
    assert t["first_cell"] == np.cumsum([0] + t["n_cells"][:-1]).tolist()
    slots = [c * k for c, k in zip(t["n_cells"], t["k"])]
    assert t["cand_start"] == np.cumsum([0] + slots[:-1]).tolist() and t["total_cand"] == sum(slots)
    assert all(s >= n and s & (s - 1) == 0 and s < 2 * max(n, 1) for s, n in zip(t["sort_len"], slots))
    assert t["margin"] == cfg.edge_margin and t["min_score"] == np.float32(calls[0]["min_score"])
    # float32(scale ** level), as torch applied it to the level's coordinates.
    assert t["scale"] == [np.float32(s) for s in cfg.level_scales]
    v = valid.numpy()
    lvl = octv[v]
    want = (axy.numpy()[v].astype(np.float32) - np.stack([0 * lvl, np.array(offs)[lvl]], -1).astype(np.float32)
            + delta.numpy()[v]) * np.array(t["scale"], np.float32)[lvl][:, None]
    assert v.sum() > 100
    np.testing.assert_array_equal(xy.numpy()[v], want)


def test_table_words_follow_the_kernels_struct():
    src = (_build.CSRC / "orb_detect.cu").read_text()
    body = src[src.index("struct Levels {"):]
    body = body[: body.index("};")]
    fields = re.findall(r"^\s*(int|float) (\w+)(\[kMaxLevels\])?;", body, re.M)
    assert [f[1] for f in fields if not f[2]] == list(detect._HEADER)
    assert [f[1] for f in fields if f[2]] == list(detect._FIELDS)
    assert {f[1] for f in fields if f[0] == "float"} == {"min_score", "scale"}
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert (int(consts["kMaxLevels"]), int(consts["kMaxSort"]), int(consts["kCell"])) == (
        detect.MAX_LEVELS, detect.MAX_SORT, detect.CELL)
    cfg = OrbConfig(n_features=1200)
    t = detect.level_table(pyramid_shapes(480, 752, 8, 1.2), cfg)
    words = detect.pack_table(t)
    assert words.shape == (len(detect._HEADER) + detect.MAX_LEVELS * len(detect._FIELDS),)
    assert words[:5].tolist() == [8, t["total_cells"], t["total_cand"], 1200, cfg.edge_margin]
    assert words.view(np.float32)[5] == np.float32(7.0)
    at = len(detect._HEADER) + detect._FIELDS.index("scale") * detect.MAX_LEVELS
    assert words.view(np.float32)[at:at + 8].tolist() == t["scale"] and not words[at + 8:at + 16].any()


def test_cpu_tensors_take_the_plain_version_without_counting():
    cfg = OrbConfig(n_features=300, n_levels=3)
    levels, atlas = _pyramid(_image(3, 2, 96, 128), cfg)
    before = detect.launches
    got = detect.detect_keypoints(levels, atlas, cfg)
    want = detect.detect_reference(levels, cfg)
    assert detect.launches == before
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # The extractor's detection is this dispatch.
    for g, w in zip(orb_extractor._detect_all_levels(levels, atlas, cfg), want):
        assert torch.equal(g, w)


def test_detection_refuses_what_the_kernel_does_not_take():
    cfg = OrbConfig(n_features=300, n_levels=3)
    levels, atlas = _pyramid(_image(3, 2, 96, 128), cfg)
    with pytest.raises(ValueError):
        detect.detect_keypoints(levels[:2], atlas, cfg)
    meta = [l.to("meta") for l in levels]
    with pytest.raises(ValueError):
        detect.detect_keypoints(meta, atlas.to("meta"), cfg)
    shapes = [tuple(l.shape[-2:]) for l in levels]
    for bad in (OrbConfig(n_features=300, n_levels=3, cell_size=16), OrbConfig(n_features=300, n_levels=3,
                                                                               min_th_fast=-1.0)):
        with pytest.raises(ValueError):
            detect._check_table(detect.level_table(shapes, bad), bad)
    big = OrbConfig(n_features=300, n_levels=17, scale_factor=1.05)
    with pytest.raises(ValueError):
        detect._check_table(detect.level_table(pyramid_shapes(400, 400, 17, 1.05), big), big)


# ---------------------------------------------------------------------------
# The CUDA source on host threads.

_HOST_SHIM = r"""
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define ORB_DETECT_HOST 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
struct float4 { float x, y, z, w; };
thread_local Dim3 threadIdx, blockIdx;
// A CTA: its own shared memory (filled with NaN bytes: nothing may read
// what it did not write) and its barrier.
struct HostCta {
  HostCta(int bytes, int threads) : smem(bytes, 0xff), block(threads) {}
  std::vector<unsigned char> smem;
  std::barrier<> block;
};
thread_local HostCta* t_cta = nullptr;
inline void __syncthreads() { t_cta->block.arrive_and_wait(); }
inline unsigned char* shared_base() { return t_cta->smem.data(); }
inline int shared_add(int* counter, int v) { return std::atomic_ref<int>(*counter).fetch_add(v); }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __int2float_rn(int a) { return static_cast<float>(a); }
inline float __int_as_float(int a) { float f; std::memcpy(&f, &a, 4); return f; }
inline int __float_as_int(float a) { int i; std::memcpy(&i, &a, 4); return i; }
inline unsigned __float_as_uint(float a) { unsigned i; std::memcpy(&i, &a, 4); return i; }
"""

# Both passes as the launcher runs them, one CTA at a time, each CUDA
# thread a host thread.
_HOST_LAUNCH = r"""
template <class F> void run_cta(int bytes, int threads, unsigned bx, unsigned by, F body) {
  HostCta cta(bytes, threads);
  std::vector<std::thread> pool;
  for (int i = 0; i < threads; ++i) {
    pool.emplace_back([&, i] {
      t_cta = &cta;
      threadIdx.x = i;
      blockIdx.x = bx;
      blockIdx.y = by;
      body();
    });
  }
  for (auto& th : pool) th.join();
}

extern "C" void host_launch(const float* atlas, int b, int atlas_h, int atlas_w, const void* levels, float* cand,
                            float* xy, int* axy, float* resp, int* octave, unsigned char* valid, float* delta) {
  Levels L;
  memcpy(&L, levels, sizeof(Levels));
  float4* c4 = reinterpret_cast<float4*>(cand);
  for (int img = 0; img < b; ++img)
    for (int g = 0; g < L.total_cells; ++g)
      run_cta(kCellShared, kCellThreads, g, img, [&] { orb_detect_cells(atlas, atlas_h, atlas_w, L, c4); });
  int select_shared = 0;
  for (int l = 0; l < L.n_levels; ++l) select_shared = L.sort_len[l] * 8 > select_shared ? L.sort_len[l] * 8 : select_shared;
  for (int img = 0; img < b; ++img)
    for (int l = 0; l < L.n_levels; ++l)
      run_cta(select_shared, kSelectThreads, l, img,
              [&] { orb_detect_select(L, c4, xy, axy, resp, octave, valid, delta); });
}
"""


@pytest.fixture(scope="module")
def host_detect(tmp_path_factory):
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to compile the kernel source for the host")
    src = (_build.CSRC / "orb_detect.cu").read_text()
    d = tmp_path_factory.mktemp("orb_detect_host")
    (d / "host.cpp").write_text(_HOST_SHIM + src[: src.index("}  // namespace")] + "}  // namespace\n" + _HOST_LAUNCH)
    built = subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
                            "-shared", "-fPIC", "-o", str(d / "libhost.so"), str(d / "host.cpp")],
                           capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "libhost.so"))
    lib.host_launch.argtypes = list(detect._ARGTYPES)
    lib.host_launch.restype = None
    return lib


def _host_detect(lib, levels, atlas, cfg):
    """detect_cuda's buffers and table, the host build's launch; outputs
    start as garbage, so every element must be written."""
    t = detect.level_table([tuple(l.shape[-2:]) for l in levels], cfg)
    detect._check_table(t, cfg)
    b, n = atlas.shape[0], t["n_out"]
    out = (torch.full((b, n, 2), np.nan), torch.full((b, n, 2), -7, dtype=torch.int32), torch.full((b, n), np.nan),
           torch.full((b, n), -7, dtype=torch.int32), torch.full((b, n), 3, dtype=torch.uint8),
           torch.full((b, n, 2), np.nan))
    cand = torch.full((b, t["total_cand"], 4), np.nan)
    words = detect.pack_table(t)
    lib.host_launch(atlas.data_ptr(), b, atlas.shape[1], atlas.shape[2], words.ctypes.data, cand.data_ptr(),
                    *(o.data_ptr() for o in out))
    xy, axy, resp, octv, valid, delta = out
    assert ((valid == 0) | (valid == 1)).all()
    return xy, axy, resp, octv, valid.bool(), delta


def _assert_equal_outputs(got, want):
    for name, g, w in zip(("xy", "axy", "resp", "octave", "valid", "delta"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g, w), f"{name}: {(g != w).sum().item()} elements differ"


@pytest.mark.parametrize("b,h,w,n_features,n_levels,kind", [
    (1, 120, 200, 400, 3, "smooth"),      # one image
    (2, 140, 180, 500, 4, "smooth"),      # a stereo pair
    (4, 72, 96, 150, 2, "smooth"),        # a batch
    (2, 150, 170, 600, 3, "ties"),        # plateaus and a checkerboard: equal scores
    (1, 90, 110, 200, 2, "blank"),        # no corner: every row invalid
    (1, 40, 48, 300, 2, "smooth"),        # fewer candidate slots than the quota
])
def test_kernel_source_on_host_threads_equals_the_plain_version(host_detect, b, h, w, n_features, n_levels, kind):
    cfg = OrbConfig(n_features=n_features, n_levels=n_levels)
    levels, atlas = _pyramid(_image(b * h + w, b, h, w, kind), cfg)
    want = detect.detect_reference(levels, cfg)
    got = _host_detect(host_detect, levels, atlas, cfg)
    _assert_equal_outputs(got, want)
    n_valid = int(want[4].sum())
    if kind == "blank":
        assert n_valid == 0
    else:
        assert n_valid > 0
    if (h, w) == (40, 48):
        t = detect.level_table([tuple(l.shape[-2:]) for l in levels], cfg)
        assert any(c * k < q for c, k, q in zip(t["n_cells"], t["k"], t["quota"]))


def test_cuda_wrapper_drives_the_kernel_source_through_the_loader(host_detect, monkeypatch):
    """detect_cuda's buffers, table and argument order, with the loader
    handing it the host build: the plain version's outputs, and
    LAUNCHES_PER_CALL launches counted per call whatever the batch."""
    monkeypatch.setattr(_build, "kernel", lambda name, argtypes: host_detect.host_launch)
    monkeypatch.setattr(_build, "launch", lambda fn, name, device, *args: fn(*args))
    cfg = OrbConfig(n_features=250, n_levels=3)
    for b in (1, 3):
        levels, atlas = _pyramid(_image(11 + b, b, 80, 104), cfg)
        before = detect.launches
        got = detect.detect_cuda(atlas, [tuple(l.shape[-2:]) for l in levels], cfg)
        assert detect.launches == before + detect.LAUNCHES_PER_CALL
        _assert_equal_outputs(got, detect.detect_reference(levels, cfg))
