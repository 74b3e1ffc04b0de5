"""The fused describe and stereo-SAD wrappers of the torch port on the
CPU: their plain versions against the JAX package on the same numpy
inputs, the kernels' arithmetic (banded products in ascending order,
ballot packing, lane-ordered SAD sums) emulated in numpy against the plain
versions, the current kernels' order of operations against the first
design's bit for bit, both CUDA sources compiled for the host and run on
host threads, input checks, launch counting, and the kernel loader with a
stand-in compiler.  Tolerances are stated per test."""

import ctypes
import ctypes.util
import importlib.util
import os
import shutil
import stat
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_line_slam_tpu.frontend import orb_extractor as jorb
from orb_line_slam_tpu.frontend import stereo as jstereo
from orb_line_slam_tpu.ops import brief as jbrief
from orb_line_slam_tpu.ops.pallas_patches import gather_patch_tiles as jax_gather
from orb_line_slam_tpu_torch.ops import _build, brief as tbrief, describe, patches, stereo_sad as tsad

torch.set_num_threads(1)
_spec = importlib.util.spec_from_file_location(
    "torch_kernel_emulation", os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_kernel_emulation.py"))
emulation = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(emulation)
T = lambda a: torch.from_numpy(np.array(a))  # noqa: E731  (writable copy)


def _atlas(seed, b=2, h=200, w=160):
    """A smooth-ish random atlas: low-pass noise plus a gradient, so that
    intensity centroids are not all at the snap threshold."""
    rng = np.random.default_rng(seed)
    img = rng.random((b, h, w)) * 255
    for _ in range(2):
        img = (img + np.roll(img, 1, 1) + np.roll(img, 1, 2) + np.roll(img, (1, 1), (1, 2))) / 4
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.6 * img + 0.2 * xx[None] + 0.2 * yy[None] + rng.normal(0, 6, img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


def _keypoints(seed, b, h, w, n):
    """Random keypoints with border, corner, out-of-range and first/last
    unclamped ones among them, and sub-pixel offsets in [-0.5, 0.5]."""
    rng = np.random.default_rng(seed)
    xy = np.stack([rng.integers(-20, w + 20, (b, n)), rng.integers(-20, h + 20, (b, n))], -1)
    border = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [-7, 5], [5, -7], [w + 3, h + 3],
                       [w // 2, h - 3], [w - 1, h // 2], [15, 15], [16, 16], [w - 17, h - 17]])
    xy[:, : len(border)] = border
    delta = rng.uniform(-0.5, 0.5, (b, n, 2))
    delta[:, :4] = [[0.0, 0.0], [0.5, -0.5], [-0.5, 0.5], [0.25, 0.0]]
    return xy.astype(np.int32), delta.astype(np.float32)


def _jax_describe(atlas, xy, delta):
    tiles = jnp.concatenate([jax_gather(jnp.asarray(atlas[i]), jnp.asarray(xy[i])) for i in range(atlas.shape[0])])
    blur = jorb.shift_blur_tiles(tiles, jnp.asarray(delta.reshape(-1, 2)))
    angles = jbrief.ic_angle_from_tiles(blur)
    return np.asarray(blur), np.asarray(angles), np.asarray(jbrief.brief_descriptors_from_tiles(blur, angles))


def _angle_diff(a, b):
    d = np.abs(a - b)
    return np.minimum(d, 2 * np.pi - d)


@pytest.mark.parametrize("seed,h,w,n", [(0, 200, 160, 300), (1, 64, 96, 120), (2, 32, 32, 40)])
def test_describe_reference_matches_jax(seed, h, w, n):
    """Angles within 1e-4 rad on >= 99.5% of keypoints, >= 99% of
    descriptors identical and median distance 0 bits (the two packages'
    float32 matrix products round the blurred tile differently, and a
    flipped rounding of round(16 tile) can flip a comparison)."""
    atlas = _atlas(seed, 2, h, w)
    xy, delta = _keypoints(seed + 10, 2, h, w, n)
    _, aj, dj = _jax_describe(atlas, xy, delta)
    at, dt = describe.describe_keypoints(T(atlas), T(xy), T(delta))
    assert at.shape == (2 * n,) and at.dtype == torch.float32
    assert dt.shape == (2 * n, 32) and dt.dtype == torch.uint8
    assert (_angle_diff(at.numpy(), aj) < 1e-4).mean() >= 0.995
    bits = np.unpackbits(dt.numpy() ^ dj, axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and np.median(bits) == 0


def test_describe_reference_is_exact_on_equal_blurred_tiles(monkeypatch):
    """With the JAX package's blurred tiles in place of its own, the plain
    version gives the JAX package's angle bins and descriptors bit for bit
    (integer moments, integer comparisons)."""
    atlas = _atlas(3)
    xy, delta = _keypoints(13, 2, 200, 160, 250)
    blur, aj, dj = _jax_describe(atlas, xy, delta)
    monkeypatch.setattr(describe, "shift_blur_tiles", lambda tiles, d: T(blur))
    at, dt = describe.describe_reference(T(atlas), T(xy), T(delta))
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_allclose(at.numpy(), aj, atol=1e-6)
    np.testing.assert_array_equal(tbrief.quantize_angle(at).numpy(), np.asarray(jbrief.quantize_angle(jnp.asarray(aj))))


def test_describe_is_the_stereo_extractors_composition():
    """describe_keypoints on the CPU is the composition the extractor ran
    before the fusion, unchanged in arithmetic: equality."""
    atlas = T(_atlas(4))
    xy, delta = (T(a) for a in _keypoints(14, 2, 200, 160, 100))
    tiles = torch.cat([patches.gather_patch_tiles(atlas[i], xy[i]) for i in range(2)])
    blur = describe.shift_blur_tiles(tiles, delta.reshape(-1, 2))
    angles = tbrief.ic_angle_from_tiles(blur)
    desc = tbrief.brief_descriptors_from_tiles(blur, angles)
    got_a, got_d = describe.describe_keypoints(atlas, xy, delta)
    assert torch.equal(got_a, angles) and torch.equal(got_d, desc)


def test_shift_blur_bands_hold_the_whole_matrices():
    bands = describe.shift_blur_bands()
    assert bands.shape == (3, 32, 9) and bands.dtype == np.float32
    for m, mat in enumerate(describe._shift_blur_mats()):
        rebuilt = np.zeros((32, 32), np.float32)
        for i in range(32):
            for o in range(9):
                if 0 <= i - 4 + o < 32:
                    rebuilt[i, i - 4 + o] = bands[m, i, o]
        np.testing.assert_array_equal(rebuilt, mat)
        np.testing.assert_allclose(mat.sum(1), 1.0, atol=1e-6)
    rows = describe.band_rows()          # the kernel's layout: [i, m * 9 + o], one float of padding
    assert rows.shape == (32, 28) and rows.dtype == np.float32 and not rows[:, 27].any()
    np.testing.assert_array_equal(rows[:, :27].reshape(32, 3, 9).transpose(1, 0, 2), bands)


def _emulate_describe_kernel(atlas, xy, delta):
    """csrc/orb_describe.cu's first design step by step in numpy float32
    (tests/torch_kernel_emulation.py): banded products in ascending column
    order with fused multiply-adds, the weighted sums rounded term by
    term, integer moments, the angle bin by the reciprocal product, and
    bits packed as little-endian 32-bit ballot words."""
    return emulation.describe_todays_order(atlas, xy, delta)


def test_kernel_arithmetic_emulated_matches_plain_version():
    """The kernel's order of operations, emulated in numpy, against the
    plain version: the tolerance the card's comparison uses (angles within
    1e-4 rad on >= 99.5%, >= 99% of descriptors identical, median 0, none
    above 8 bits)."""
    atlas = _atlas(5, 2, 96, 128)
    xy, delta = _keypoints(15, 2, 96, 128, 60)
    ae, de = _emulate_describe_kernel(atlas, xy, delta)
    ap, dp = describe.describe_reference(T(atlas), T(xy), T(delta))
    assert (_angle_diff(ae, ap.numpy()) < 1e-4).mean() >= 0.995
    bits = np.unpackbits(de ^ dp.numpy(), axis=1).sum(1)
    assert (bits == 0).mean() >= 0.99 and np.median(bits) == 0 and bits.max() <= 8


def _jax_sad(atlas_l, xy_l, atlas_r, cx, cy):
    """The SAD block of orb_line_slam_tpu/frontend/stereo.py:153-165."""
    W, S = jstereo.SAD_W, jstereo.SAD_SLIDE
    tiles = jax_gather(jnp.asarray(atlas_l), jnp.asarray(xy_l))
    patch = tiles[:, 15 - W:15 + W + 1, 15 - W:15 + W + 1]
    patch = patch - patch[:, W:W + 1, W:W + 1]
    strip = jstereo._gather_window(jnp.asarray(atlas_r), jnp.asarray(cx), jnp.asarray(cy), W, extra=S)
    sads = []
    for k in range(2 * S + 1):
        win = jax.lax.dynamic_slice_in_dim(strip, k, 2 * W + 1, axis=2)
        win = win - win[:, W:W + 1, W:W + 1]
        sads.append(jnp.sum(jnp.abs(patch - win), axis=(1, 2)))
    return np.asarray(jnp.stack(sads, axis=1))


def _sad_inputs(seed, h, w, n, fractional):
    atlas = _atlas(seed, 2, h, w)
    xy, _ = _keypoints(seed + 20, 1, h, w, n)
    rng = np.random.default_rng(seed + 30)
    cx = rng.uniform(-10, w + 10, n)
    cy = rng.uniform(-10, h + 10, n)
    cx[:6] = [0, w - 1, 15, w - 17, -3, w + 4]
    cy[:6] = [0, h - 1, 15, h - 17, h + 2, -5]
    if not fractional:           # the stereo matcher's centres are whole numbers
        cx, cy = np.floor(cx), np.floor(cy)
    return atlas[0], xy[0], atlas[1], cx.astype(np.float32), cy.astype(np.float32)


@pytest.mark.parametrize("seed,h,w,n,fractional", [(0, 200, 160, 300, False), (1, 64, 96, 150, True),
                                                   (2, 32, 32, 40, True)])
def test_stereo_sad_reference_matches_jax(seed, h, w, n, fractional):
    """Within 1e-3 absolute + 1e-5 relative (float32 sums of 121 terms in
    another order; a SAD of this noisy atlas is ~3000, where one float32
    step is 2.4e-4), and the same best slide."""
    args = _sad_inputs(seed, h, w, n, fractional)
    want = _jax_sad(*args)
    got = tsad.stereo_sad(*(T(a) for a in args))
    assert got.shape == (n, 11) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-3)
    np.testing.assert_array_equal(got.numpy().argmin(1), want.argmin(1))


def _emulate_sad_kernel(atlas_l, xy_l, atlas_r, cx, cy):
    """csrc/stereo_sad.cu's first design in numpy float32
    (tests/torch_kernel_emulation.py): windows addressed through the
    clamped tile origins, the blend term by term, each lane summing
    elements lane, lane + 32, ... and a butterfly over the 32 lanes."""
    return emulation.sad_todays_order(atlas_l, xy_l, atlas_r, cx, cy)


@pytest.mark.parametrize("fractional", [False, True])
def test_sad_kernel_arithmetic_emulated_matches_plain_version(fractional):
    """|sad - plain| <= 1e-5 plain + 1e-2 and equal argmin: the tolerance
    the card's comparison uses."""
    args = _sad_inputs(7, 80, 120, 80, fractional)
    emu = _emulate_sad_kernel(*args)
    ref = tsad.stereo_sad_reference(*(T(a) for a in args)).numpy()
    assert (np.abs(emu - ref) <= 1e-5 * ref + 1e-2).all()
    np.testing.assert_array_equal(emu.argmin(1), ref.argmin(1))


# ---------------------------------------------------------------------------
# The current designs: the row reuse of orb_describe.cu and the reduce-scatter
# of stereo_sad.cu, emulated and compiled for the host.

def _reuse_rows(big, small, shift):
    """Rows i of `big` equal, element for element, to row i + shift of `small`."""
    return [i for i in range(32) if 0 <= i + shift < 32 and np.array_equal(big[i], small[i + shift])]


def test_shift_blur_row_reuse_identity():
    """Am's row i is A0's row i - 1 and Ap's row i is A0's row i + 1,
    element for element, on exactly the ranges orb_describe.cu reads off
    A0's products (and on no row just outside them); the taps each matrix
    leaves out are zero in every row; A0's interior rows hold one band on
    exactly the kernel's range."""
    Am, A0, Ap = describe._shift_blur_mats()
    kc = emulation.kernel_constants("orb_describe")
    am, ap = _reuse_rows(Am, A0, -1), _reuse_rows(Ap, A0, 1)
    assert am == list(range(kc["kAmReuseFirst"], kc["kAmReuseLast"] + 1)) == list(range(4, 29))
    assert ap == list(range(kc["kApReuseFirst"], kc["kApReuseLast"] + 1)) == list(range(3, 28))
    for big, lo, hi, shift in ((Am, 4, 28, -1), (Ap, 3, 27, 1)):
        assert not np.array_equal(big[lo - 1], A0[lo - 1 + shift]) and not np.array_equal(big[hi + 1], A0[hi + 1 + shift])
    bands = describe.shift_blur_bands()
    for m, first in enumerate((kc["kAmTap0"], kc["kA0Tap0"], kc["kApTap0"])):
        used = np.zeros(describe.BAND_TAPS, bool)
        used[first:first + kc["kUsed"]] = True
        assert not bands[m][:, ~used].any() and bands[m][:, used].any(0).all()
    assert 32 - len(am) == 7 and 32 - len(ap) == 7
    # A0's interior rows hold one band, bit for bit (the kernel keeps it in
    # registers), and no row just outside holds it.
    lo, hi = kc["kA0InteriorFirst"], kc["kA0InteriorLast"]
    same = [i for i in range(32) if np.array_equal(bands[1, i], bands[1, lo])]
    assert same == list(range(lo, hi + 1)) == list(range(3, 29))


def _border_cases(seed, b, h, w, n):
    """Keypoints with border, clamped and out-of-range ones, offsets of
    exactly +-0.5 on both axes among random ones."""
    xy, delta = _keypoints(seed, b, h, w, n)
    delta[:, 4:8] = [[0.5, 0.5], [-0.5, -0.5], [0.5, 0.0], [0.0, -0.5]]
    return xy, delta


@pytest.mark.parametrize("seed,h,w,n", [(21, 96, 128, 48), (22, 40, 40, 24)])
def test_describe_new_order_emulated_is_todays_bit_for_bit(seed, h, w, n):
    """A0's products with Am's and Ap's interior rows read off them and
    seven taps each give today's quantised tiles, angles and descriptors
    bit for bit."""
    atlas = _atlas(seed, 2, h, w)
    xy, delta = _border_cases(seed + 1, 2, h, w, n)
    q0, a0, d0 = emulation.describe_todays_order(atlas, xy, delta, with_q=True)
    q1, a1, d1 = emulation.describe_new_order(atlas, xy, delta, with_q=True)
    np.testing.assert_array_equal(q1, q0)
    np.testing.assert_array_equal(a1.view(np.uint32), a0.view(np.uint32))
    np.testing.assert_array_equal(d1, d0)
    a, d = _emulate_describe_kernel(atlas, xy, delta)
    np.testing.assert_array_equal(a.view(np.uint32), a0.view(np.uint32))
    np.testing.assert_array_equal(d, d0)


@pytest.mark.parametrize("fractional", [False, True])
def test_sad_new_order_emulated_is_todays_bit_for_bit(fractional):
    """The eleven slides reduced together by the reduce-scatter give
    today's one-butterfly-per-slide sums bit for bit, at whole and
    fractional centres, border and clamped windows among them."""
    args = _sad_inputs(23, 64, 96, 60, fractional)
    got = emulation.sad_new_order(*args)
    np.testing.assert_array_equal(got.view(np.uint32), _emulate_sad_kernel(*args).view(np.uint32))


_HOST_SHIM = r"""
#include <barrier>
#include <cmath>
#include <cstring>
#include <math.h>
#include <memory>
#include <thread>
#include <vector>
#define ORB_DESCRIBE_HOST 1
#define STEREO_SAD_HOST 1
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
using std::max;
using std::min;
struct Dim3 { unsigned x = 0, y = 0, z = 0; };
struct float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
thread_local Dim3 threadIdx, blockIdx, gridDim;
// A warp: its barrier and two exchange buffers, used in turn (a thread
// writes one only after all have passed the barrier that follows their
// read of it).
struct HostWarp {
  std::barrier<> bar{32};
  alignas(8) unsigned char ex[2][32 * 8];
};
// A CTA: its own shared memory (filled with NaN bytes: nothing may read
// what it did not write), its barrier and its warps.
struct HostCta {
  HostCta(int bytes, int threads) : smem(bytes, 0xff), block(threads), warps(threads / 32) {}
  std::vector<unsigned char> smem;
  std::barrier<> block;
  std::vector<HostWarp> warps;
};
thread_local HostCta* t_cta = nullptr;
thread_local int t_phase = 0;
inline void __syncthreads() { t_cta->block.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { t_cta->warps[threadIdx.x >> 5].bar.arrive_and_wait(); }
inline unsigned char* shared_base() { return t_cta->smem.data(); }
// The asynchronous copy as a plain copy, and its wait as nothing.
inline void copy_async(float* dst, const float* src) { *dst = *src; }
inline void commit_copies() {}
inline void wait_all_but_newest() {}
template <class T> unsigned char* host_post(T v) {
  HostWarp& w = t_cta->warps[threadIdx.x >> 5];
  unsigned char* ex = w.ex[t_phase];
  t_phase ^= 1;
  std::memcpy(ex + 8 * (threadIdx.x & 31), &v, sizeof(T));
  w.bar.arrive_and_wait();
  return ex;
}
template <class T> T host_exchange(T v, int src_lane) {
  const unsigned char* ex = host_post(v);
  T r;
  std::memcpy(&r, ex + 8 * src_lane, sizeof(T));
  return r;
}
template <class T> T __shfl_sync(unsigned, T v, int lane) { return host_exchange(v, lane & 31); }
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) { return host_exchange(v, (threadIdx.x & 31) ^ mask); }
inline unsigned __ballot_sync(unsigned, int pred) {
  const unsigned char* ex = host_post(pred ? 1 : 0);
  unsigned r = 0;
  for (int l = 0; l < 32; ++l) {
    int v;
    std::memcpy(&v, ex + 8 * l, sizeof(int));
    if (v) r |= 1u << l;
  }
  return r;
}
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
inline int __float2int_rn(float a) { return static_cast<int>(std::nearbyint(a)); }
inline float __int2float_rn(int a) { return static_cast<float>(a); }
inline float __int_as_float(int a) { float f; std::memcpy(&f, &a, 4); return f; }
inline int __float_as_int(float a) { int i; std::memcpy(&i, &a, 4); return i; }
"""

# `ctas` CTAs of the source's block size, each CUDA thread a host thread.
_HOST_LAUNCH = {
    "orb_describe": r"""
extern "C" void host_launch(const float* atlas, int b, int h, int w, const int* xy, const float* delta, int n,
                            const float* band, const short* rot, float inv_bin, float* angle, unsigned char* desc,
                            int ctas) {
  std::vector<std::unique_ptr<HostCta>> cta;
  for (int c = 0; c < ctas; ++c) cta.push_back(std::make_unique<HostCta>(kSharedBytes, kThreads));
  std::vector<std::thread> threads;
  for (int c = 0; c < ctas; ++c) {
    for (int i = 0; i < kThreads; ++i) {
      threads.emplace_back([&, c, i] {
        t_cta = cta[c].get();
        threadIdx.x = i;
        blockIdx.x = c;
        gridDim.x = ctas;
        orb_describe_kernel(atlas, h, w, xy, delta, n, b * n, band, rot, inv_bin, angle,
                            reinterpret_cast<unsigned*>(desc));
      });
    }
  }
  for (auto& th : threads) th.join();
}
""",
    "stereo_sad": r"""
extern "C" void host_launch(const float* atlas_l, const int* xy_l, const float* atlas_r, const float* cx,
                            const float* cy, int h, int w, int n, int total, float* sad, int ctas) {
  std::vector<std::unique_ptr<HostCta>> cta;
  for (int c = 0; c < ctas; ++c) cta.push_back(std::make_unique<HostCta>(kWarps * (kRaw + kStrip) * 4, 32 * kWarps));
  std::vector<std::thread> threads;
  for (int c = 0; c < ctas; ++c) {
    for (int i = 0; i < 32 * kWarps; ++i) {
      threads.emplace_back([&, c, i] {
        t_cta = cta[c].get();
        threadIdx.x = i;
        blockIdx.x = c;
        gridDim.x = ctas;
        stereo_sad_kernel(atlas_l, xy_l, atlas_r, cx, cy, h, w, n, total, sad);
      });
    }
  }
  for (auto& th : threads) th.join();
}
""",
}


def _host_build(tmp_path_factory, name, flags=()):
    """csrc/<name>.cu compiled for the host by g++ (its kernel and device
    functions as written; the shuffles, barriers, shared memory and the
    asynchronous copy replaced by the shim's, the launcher by a host one)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ (C++20) to compile the kernel source for the host")
    src = (_build.CSRC / f"{name}.cu").read_text()
    d = tmp_path_factory.mktemp(f"{name}_host")
    (d / "host.cpp").write_text(_HOST_SHIM + src[: src.index("}  // namespace")] + "}  // namespace\n"
                                + _HOST_LAUNCH[name])
    built = subprocess.run([cxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-strict-aliasing", "-pthread",
                            "-shared", "-fPIC", *flags, "-o", str(d / "libhost.so"), str(d / "host.cpp")],
                           capture_output=True, text=True, timeout=300)
    assert built.returncode == 0, built.stderr[-3000:]
    lib = ctypes.CDLL(str(d / "libhost.so"))
    lib.host_launch.restype = None
    return lib


@pytest.fixture(scope="module")
def host_describe(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "orb_describe")
    lib.host_launch.argtypes = [*describe._ARGTYPES, ctypes.c_int]
    return lib


@pytest.fixture(scope="module")
def host_sad(tmp_path_factory):
    lib = _host_build(tmp_path_factory, "stereo_sad")
    lib.host_launch.argtypes = [*tsad._ARGTYPES, ctypes.c_int]
    return lib


def _libm_atan2f():
    """The C library's atan2f (the host compile's), batched over numpy arrays."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).atan2f
    fn.argtypes, fn.restype = [ctypes.c_float, ctypes.c_float], ctypes.c_float
    return lambda y, x: np.array([fn(float(a), float(b)) for a, b in zip(y, x)], np.float32)


@pytest.mark.parametrize("n", [32, 7])
def test_describe_source_on_host_threads_is_the_emulations_bits(host_describe, n):
    """csrc/orb_describe.cu over 2 persistent CTAs on 2 x n keypoints of
    two images (64: each warp walks more than one keypoint, the tile
    stages in turn; 14: most warps have none): the emulation's angles
    (with the same atan2f) and descriptors bit for bit, and a rerun the
    same bits."""
    atlas = _atlas(31, 2, 72, 90)
    xy, delta = (np.ascontiguousarray(a[:, :n]) for a in _border_cases(32, 2, 72, 90, max(n, 12)))
    bands, rot = (t.contiguous() for t in describe._kernel_tables_on(torch.device("cpu")))

    def run():
        angle, desc = torch.full((2 * n,), float("nan")), torch.zeros((2 * n, 32), dtype=torch.uint8)
        A, X, D = T(atlas), T(xy), T(delta)
        host_describe.host_launch(A.data_ptr(), 2, 72, 90, X.data_ptr(), D.data_ptr(), n, bands.data_ptr(),
                                  rot.data_ptr(), describe._INV_BIN, angle.data_ptr(), desc.data_ptr(), 2)
        return angle.numpy(), desc.numpy()

    angle, desc = run()
    want_a, want_d = emulation.describe_new_order(atlas, xy, delta, atan2=_libm_atan2f())
    np.testing.assert_array_equal(desc, want_d)
    np.testing.assert_array_equal(angle.view(np.uint32), want_a.view(np.uint32))
    again = run()
    np.testing.assert_array_equal(again[0].view(np.uint32), angle.view(np.uint32))
    np.testing.assert_array_equal(again[1], desc)


@pytest.mark.parametrize("fractional", [False, True])
def test_sad_source_on_host_threads_is_the_emulations_bits(host_sad, fractional):
    """csrc/stereo_sad.cu over 2 CTAs (a stride loop of 8 warps) on 64
    keypoints: the emulation's sums bit for bit, at whole and fractional
    centres."""
    args = _sad_inputs(33, 64, 96, 64, fractional)
    al, xl, ar, cx, cy = (T(a) for a in args)
    sad = torch.full((64, 11), float("nan"))
    host_sad.host_launch(al.data_ptr(), xl.data_ptr(), ar.data_ptr(), cx.data_ptr(), cy.data_ptr(), 64, 96, 64, 64,
                         sad.data_ptr(), 2)
    np.testing.assert_array_equal(sad.numpy().view(np.uint32), emulation.sad_new_order(*args).view(np.uint32))


def test_cpu_tensors_take_plain_versions_without_counting():
    atlas = T(_atlas(8, 2, 64, 64))
    xy, delta = (T(a) for a in _keypoints(18, 2, 64, 64, 20))
    before = (describe.launches, tsad.launches, patches.launches)
    a, d = describe.describe_keypoints(atlas, xy, delta)
    sad = tsad.stereo_sad(atlas[0], xy[0], atlas[1], torch.full((20,), 30.0), torch.full((20,), 31.0))
    assert a.shape == (40,) and d.shape == (40, 32) and sad.shape == (20, 11)
    assert (describe.launches, tsad.launches, patches.launches) == before


def test_describe_rejects_bad_inputs():
    atlas = torch.zeros((2, 40, 48))
    xy = torch.zeros((2, 5, 2), dtype=torch.int32)
    delta = torch.zeros((2, 5, 2))
    describe.describe_keypoints(atlas, xy, delta)
    with pytest.raises(TypeError):
        describe.describe_keypoints(atlas.double(), xy, delta)
    with pytest.raises(TypeError):
        describe.describe_keypoints(atlas, xy.long(), delta)
    with pytest.raises(TypeError):
        describe.describe_keypoints(atlas, xy, delta.double())
    with pytest.raises(ValueError):
        describe.describe_keypoints(torch.zeros((2, 20, 48)), xy, delta)          # smaller than a tile
    with pytest.raises(ValueError):
        describe.describe_keypoints(torch.zeros((2, 40, 96))[:, :, ::2], xy, delta)  # not contiguous
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas[0], xy, delta)                          # no batch axis
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas, xy, delta[:, :4])                      # delta / keypoint mismatch
    with pytest.raises(ValueError):
        describe.describe_keypoints(atlas, xy, delta.to("meta"))                  # device mix


def test_stereo_sad_rejects_bad_inputs():
    al, ar = torch.zeros((40, 48)), torch.zeros((40, 48))
    xy = torch.zeros((5, 2), dtype=torch.int32)
    cx, cy = torch.zeros(5), torch.zeros(5)
    tsad.stereo_sad(al, xy, ar, cx, cy)
    with pytest.raises(TypeError):
        tsad.stereo_sad(al.double(), xy, ar, cx, cy)
    with pytest.raises(TypeError):
        tsad.stereo_sad(al, xy.long(), ar, cx, cy)
    with pytest.raises(TypeError):
        tsad.stereo_sad(al, xy, ar, cx.double(), cy)
    with pytest.raises(ValueError):
        tsad.stereo_sad(torch.zeros((20, 48)), xy, torch.zeros((20, 48)), cx, cy)  # smaller than a tile
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, torch.zeros((40, 50)), cx, cy)                     # atlas shapes differ
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, ar, torch.zeros(10)[::2], cy)                      # not contiguous
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, ar, cx[:4], cy)                                    # centre count
    with pytest.raises(ValueError):
        tsad.stereo_sad(al, xy, ar.to("meta"), cx, cy)                             # device mix


def test_stereo_path_makes_no_tile_tensor():
    """extract_orb_stereo hands the stereo matcher atlases and integer
    keypoints: nothing it returns has a 32x32 tile axis."""
    from orb_line_slam_tpu_torch.config import OrbConfig
    from orb_line_slam_tpu_torch.frontend.orb_extractor import extract_orb_stereo

    rng = np.random.default_rng(9)
    l, r = (T(rng.integers(0, 255, (96, 160)).astype(np.uint8)) for _ in range(2))
    cfg = OrbConfig(n_features=200, n_levels=2)
    featL, atlasL, axyL, deltaL, featR, atlasR, offs = extract_orb_stereo(l, r, cfg)
    assert atlasL.shape == atlasR.shape and atlasL.dim() == 2
    assert axyL.shape == (200, 2) and axyL.dtype == torch.int32 and deltaL.shape == (200, 2)
    for t in (*featL, *featR, axyL, deltaL, offs):
        assert tuple(t.shape[-2:]) != (32, 32)


def _fake_nvcc(tmp_path, body):
    path = tmp_path / "nvcc"
    path.write_text("#!/bin/sh\n" + body)
    path.chmod(path.stat().st_mode | stat.S_IXUSR)
    return str(path)


def test_loader_raises_with_the_compilers_output(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, "echo 'error: no such thing' >&2\nexit 2\n")
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    with pytest.raises(RuntimeError, match="no such thing"):
        _build.build(("stereo_sad",))
    assert not (tmp_path / "build" / "libstereo_sad.so").exists()


def test_loader_builds_every_source_once(tmp_path, monkeypatch):
    """One compiler process per source; a library newer than its source is
    not rebuilt."""
    log = tmp_path / "calls.log"
    script = f'echo "$@" >> {log}\nwhile [ "$1" != "-o" ]; do shift; done\n: > "$2"\n'
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    nvcc = _fake_nvcc(tmp_path, script)
    monkeypatch.setattr(_build, "_nvcc", lambda: nvcc)
    _build.build()
    for name in _build.SOURCES:
        assert _build.library_path(name).exists() and (_build.CSRC / f"{name}.cu").exists()
    calls = log.read_text().splitlines()
    assert len(calls) == len(_build.SOURCES) == 5
    assert all("arch=compute_90a,code=sm_90a" in c for c in calls)
    _build.build()
    assert len(log.read_text().splitlines()) == 5
    assert not [f for f in os.listdir(tmp_path / "build") if f.endswith(".tmp")]
