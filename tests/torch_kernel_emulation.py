"""numpy emulations of the front end's two CUDA kernels, step by step in
float32, for the CPU tests and the card tests (imports numpy and the
port, never jax, so that the card's machine can load it).

Each kernel has two: the order of operations of its first design
(``describe_todays_order``, ``sad_todays_order``: three 9-tap banded
products per output and axis; one butterfly per slide) and of the
current one (``describe_new_order``, ``sad_new_order``: A0's products
with Am's and Ap's interior rows read off them, seven taps each; the
eleven slides reduced together by a reduce-scatter).  The two orders
give the same bits; the tests hold them, the host compile of the
sources and the card's kernels to each other.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

from orb_line_slam_tpu_torch.ops import brief as tbrief, describe

CSRC = Path(describe.__file__).resolve().parents[1] / "csrc"


def kernel_constants(name: str) -> dict[str, int]:
    """The integer ``constexpr`` constants of csrc/<name>.cu that are
    given as a literal."""
    src = (CSRC / f"{name}.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (-?\d+);", src)}


def fma32(a, b, c) -> np.ndarray:
    """float32 a * b + c rounded once, as fmaf: the product is exact in
    float64, the sum is rounded to odd in float64 (two-sum for its error,
    then the odd neighbour where it was inexact), and rounding that to
    float32 is then correct (53 >= 24 + 2 bits)."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = np.asarray(p + c)
    t = s - p
    e = (p - (s - t)) + (c - t)
    fix = (e != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(fix, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _tiles(atlas, xy, n_per_image):
    """[K, 32, 32] clamped tiles, as the kernels address them."""
    h, w = atlas.shape[1:]
    flat = xy.reshape(-1, 2)
    out = np.empty((len(flat), 32, 32), np.float32)
    for k, (x, y) in enumerate(flat):
        x0, y0 = min(max(int(x) - 15, 0), w - 32), min(max(int(y) - 15, 0), h - 32)
        out[k] = atlas[k // n_per_image, y0:y0 + 32, x0:x0 + 32]
    return out


def _weights(d):
    f32 = np.float32
    d = d.astype(f32)
    return np.maximum(-d, f32(0)), f32(1) - np.abs(d), np.maximum(d, f32(0))


def _chain(coef, src, i, first, taps):
    """Row i of a banded product, batched over keypoints: coefficient
    coef[o] (a float32 per tap) times src[:, j] (j = i - 4 + first + o,
    taps in the tile only), fused multiply-adds in ascending j from 0."""
    acc = np.zeros(src.shape[:1] + src.shape[2:], np.float32)
    for o in range(taps):
        j = i - 4 + first + o
        if 0 <= j < 32:
            acc = fma32(coef[o], src[:, j], acc)
    return acc


def _todays_pass(src, wts):
    """One pass of the first design over src [K, 32 (j), 32]: the three
    9-tap products of each row i, weighted and summed term by term."""
    bands = describe.shift_blur_bands()
    wm, w0, wp = (x[:, None] for x in wts)
    out = np.empty_like(src)
    for i in range(32):
        am, a0, ap = (_chain(bands[m, i], src, i, 0, 9) for m in range(3))
        out[:, i] = (wm * am + w0 * a0) + wp * ap
    return out


def _new_pass(src, wts):
    """One pass of the current design: A0's 32 products by A0's used taps
    (its interior rows by the band of its first interior row), Am's and
    Ap's interior rows read off them (the ranges are the kernel source's
    constants), their edge rows by their own used taps."""
    kc = kernel_constants("orb_describe")
    bands = describe.shift_blur_bands()
    used = kc["kUsed"]
    wm, w0, wp = (x[:, None] for x in wts)
    interior = bands[1, kc["kA0InteriorFirst"], kc["kA0Tap0"]:]
    p0 = [_chain(interior if kc["kA0InteriorFirst"] <= i <= kc["kA0InteriorLast"] else bands[1, i, kc["kA0Tap0"]:],
                 src, i, kc["kA0Tap0"], used) for i in range(32)]
    out = np.empty_like(src)
    for i in range(32):
        if kc["kAmReuseFirst"] <= i <= kc["kAmReuseLast"]:
            am = p0[i - 1]
        else:
            am = _chain(bands[0, i, kc["kAmTap0"]:], src, i, kc["kAmTap0"], used)
        if kc["kApReuseFirst"] <= i <= kc["kApReuseLast"]:
            ap = p0[i + 1]
        else:
            ap = _chain(bands[2, i, kc["kApTap0"]:], src, i, kc["kApTap0"], used)
        out[:, i] = (wm * am + w0 * p0[i]) + wp * ap
    return out


def _describe(atlas, xy, delta, blur_pass, atan2):
    """(q int32 [K, 32, 32], angles float32 [K], desc uint8 [K, 32])."""
    f32 = np.float32
    n = xy.shape[1]
    tiles = _tiles(atlas, xy, n)
    d = delta.reshape(-1, 2)
    ty = blur_pass(tiles, _weights(d[:, 1]))                          # rows: out[k, i, c]
    tb = blur_pass(ty.transpose(0, 2, 1), _weights(d[:, 0])).transpose(0, 2, 1)
    q = np.rint(tb * f32(16)).astype(np.int32)
    vv, uu = np.mgrid[0:32, 0:32] - 15
    disk = (uu * uu + vv * vv <= 225) & (uu <= 15) & (vv <= 15)
    qd = np.where(disk, q, 0).astype(np.int64)
    f10 = (qd * uu).sum((1, 2)).astype(f32)
    f01 = (qd * vv).sum((1, 2)).astype(f32)
    f00 = qd.sum((1, 2)).astype(f32)
    offset = np.sqrt(f10 * f10 + f01 * f01) / np.maximum(f00, f32(1e-6))
    angles = np.where(offset >= f32(0.5), np.asarray(atan2(f01, f10), f32), f32(0)).astype(f32)
    bins = np.rint(angles * f32(describe._INV_BIN)).astype(np.int64) % 30
    rot = tbrief._rotated_flat_indices()
    flat = q.reshape(len(q), -1)
    test = np.take_along_axis(flat, rot[bins, 256:], 1) > np.take_along_axis(flat, rot[bins, :256], 1)
    words = (test.reshape(-1, 8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(2)
    desc = words.astype("<u4").view(np.uint8).reshape(len(q), 32)
    return q, angles, desc


def describe_todays_order(atlas, xy, delta, atan2=np.arctan2, with_q=False):
    """csrc/orb_describe.cu's first design in numpy float32: three banded
    products per output in ascending column order with fused
    multiply-adds, the weighted sums rounded term by term, integer
    moments, the angle bin by the reciprocal product, and bits packed as
    little-endian 32-bit ballot words.  ``atan2`` maps float32 (y, x) to
    the angle (the card's own where bits are compared with the card)."""
    q, angles, desc = _describe(atlas, xy, delta, _todays_pass, atan2)
    return (q, angles, desc) if with_q else (angles, desc)


def describe_new_order(atlas, xy, delta, atan2=np.arctan2, with_q=False):
    """csrc/orb_describe.cu's current order: A0's products, the reuse
    ranges, the edge rows' own bands, seven taps each."""
    q, angles, desc = _describe(atlas, xy, delta, _new_pass, atan2)
    return (q, angles, desc) if with_q else (angles, desc)


def _sad_terms(atlas_l, xy_l, atlas_r, cx, cy):
    """Per keypoint the [11, 121] terms |L - (R - R_centre)| of the eleven
    slides, rounded as the kernel rounds them."""
    f32 = np.float32
    h, w = atlas_l.shape
    out = []
    for k in range(len(cx)):
        x0 = min(max(int(xy_l[k, 0]) - 15, 0), w - 32) + 10
        y0 = min(max(int(xy_l[k, 1]) - 15, 0), h - 32) + 10
        left = atlas_l[y0:y0 + 11, x0:x0 + 11]
        left = (left - left[5, 5]).reshape(-1)
        xi, yi = np.floor(cx[k]), np.floor(cy[k])
        fx, fy = f32(cx[k] - xi), f32(cy[k] - yi)
        gx, gy = f32(1) - fx, f32(1) - fy
        x0 = min(max(int(xi) - 15, 0), w - 32) + 5
        y0 = min(max(int(yi) - 15, 0), h - 32) + 10
        src = atlas_r[y0:y0 + 12, x0:x0 + 22]
        strip = (gy * gx) * src[:-1, :-1]
        strip = strip + (gy * fx) * src[:-1, 1:]
        strip = strip + (fy * gx) * src[1:, :-1]
        strip = strip + (fy * fx) * src[1:, 1:]
        out.append(np.stack([np.abs(left - (strip[:, s:s + 11] - strip[5, s + 5]).reshape(-1)) for s in range(11)]))
    return out


def _lane_partials(terms):
    """[11, 32]: lane l's sum of elements l, l + 32, ... in ascending order."""
    lanes = np.zeros((11, 32), np.float32)
    for e in range(121):
        lanes[:, e % 32] = lanes[:, e % 32] + terms[:, e]
    return lanes


def sad_todays_order(atlas_l, xy_l, atlas_r, cx, cy):
    """csrc/stereo_sad.cu's first design in numpy float32: windows
    addressed through the clamped tile origins, the blend term by term,
    each lane summing elements lane, lane + 32, ... and a butterfly over
    the 32 lanes per slide, read on lane 0."""
    out = np.zeros((len(cx), 11), np.float32)
    for k, terms in enumerate(_sad_terms(atlas_l, xy_l, atlas_r, cx, cy)):
        lanes = _lane_partials(terms)
        for m in (16, 8, 4, 2, 1):
            lanes = lanes + lanes[:, np.arange(32) ^ m]
        out[k] = lanes[:, 0]
    return out


def sad_new_order(atlas_l, xy_l, atlas_r, cx, cy):
    """The current order: the same lane partials, the 11 slides padded to
    16 slots and reduced together, each lane keeping the upper half of
    its slots at distance m = 16, 8, 4, 2 where its m bit is set and
    adding its partner's copy, then one xor-1 exchange; slide s read from
    the lane that holds it."""
    out = np.zeros((len(cx), 11), np.float32)
    lane = np.arange(32)
    for k, terms in enumerate(_sad_terms(atlas_l, xy_l, atlas_r, cx, cy)):
        held = np.zeros((32, 16), np.float32)               # held[l, j]: lane l's slot j
        held[:, :11] = _lane_partials(terms).T
        half = 8
        for m in (16, 8, 4, 2):
            upper = (lane & m) != 0
            keep = np.where(upper[:, None], held[:, half:2 * half], held[:, :half])
            send = np.where(upper[:, None], held[:, :half], held[:, half:2 * half])
            held = keep + send[lane ^ m]
            half //= 2
        total = held[:, 0] + held[lane ^ 1, 0]
        slot = ((lane >> 4) & 1) << 3 | ((lane >> 3) & 1) << 2 | ((lane >> 2) & 1) << 1 | ((lane >> 1) & 1)
        for s in range(11):
            out[k, s] = total[np.flatnonzero(slot == s)[0]]
    return out
