# Frozen copy of orb_line_slam_tpu_torch/data/synthetic.py at commit d30c4f7,
# with a local camera type; the frames of a sequence are rendered clean in a
# forked pool (``render_frames``, after chip_smoke.py::render_jobs at the
# same commit) and the sensor noise, drawn as the original draws it but
# from a seed the caller gives, added after (``noisy_copies``).
"""Synthetic stereo scene renderer: point and line landmarks seen along a
known trajectory, so a replayed sequence has ground-truth poses.

Rendering is host-side numpy.  Each 3D landmark carries a fixed random
textured billboard so that ORB descriptors are distinctive and stable
across views; line landmarks are drawn with OpenCV's ``cv2.line(...,
thickness 2, LINE_8)`` rasteriser written out in numpy.
"""

from __future__ import annotations

import concurrent.futures
import multiprocessing
import os
from typing import NamedTuple

import numpy as np


class Camera(NamedTuple):
    """Pinhole stereo camera: intrinsics (px), bf = baseline * fx, size."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float
    width: int
    height: int

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


class SyntheticScene:
    def __init__(
        self,
        cam: Camera,
        n_points: int = 400,
        n_lines: int = 0,
        extent=((-8.0, 8.0), (-4.0, 4.0), (2.0, 40.0)),
        seed: int = 0,
        clear_radius: float = 0.0,
        ground: tuple | None = None,
    ):
        rng = np.random.default_rng(seed)
        self.cam = cam
        lo = np.array([e[0] for e in extent])
        hi = np.array([e[1] for e in extent])
        self.points = rng.uniform(lo, hi, size=(n_points, 3)).astype(np.float64)
        if clear_radius > 0.0:
            # Keep a free corridor around the z axis (the camera path):
            # push landmarks inside the tube radially outward, as a real
            # street/corridor has free space along the trajectory.
            xy = self.points[:, :2]
            r = np.linalg.norm(xy, axis=1)
            inside = r < clear_radius
            scale = (clear_radius + rng.uniform(0, 2.0, inside.sum())) / np.maximum(
                r[inside], 1e-6
            )
            xy[inside] *= scale[:, None]
        if ground is not None:
            # Road-surface landmarks (KITTI-like): a fraction of points
            # lies on a textured ground plane y ≈ y0 below the camera,
            # supplying the close features the keyframe policy's
            # tracked-close counters assume (+y is down in camera frame).
            y0, frac = ground
            n_g = int(n_points * frac)
            g = rng.uniform(lo, hi, size=(n_g, 3))
            g[:, 1] = y0 + rng.normal(0.0, 0.05, n_g)
            self.points[:n_g] = g
        # Distinctive textured billboard per landmark with a fixed
        # PHYSICAL size: the projected patch scales with depth, so
        # appearance is geometrically consistent under camera motion
        # (ORB's scale pyramid handles the zoom, as with real texture).
        # Fractal (multi-octave) textures: structure at all scales, so
        # appearance stays correlated at any viewing distance — per-texel
        # white noise would decorrelate under sub-pixel resampling.
        patches = np.zeros((n_points, 64, 64), np.float32)
        for g, amp in ((4, 1.0), (8, 0.6), (16, 0.4), (32, 0.25)):
            grids = rng.uniform(-1, 1, size=(n_points, g, g)).astype(np.float32)
            patches += amp * _resize_linear(grids, 64)
        pmin = patches.min(axis=(1, 2), keepdims=True)
        pmax = patches.max(axis=(1, 2), keepdims=True)
        self.patches = (255 * (patches - pmin) / (pmax - pmin + 1e-6)).astype(np.uint8)
        self.world_size = rng.uniform(0.35, 0.9, size=n_points)
        # Mipmap chain per patch (area-filtered) so minified billboards
        # don't alias frame-to-frame (warpAffine has no area filter).
        self.mips = [self.patches] + [
            _resize_area(self.patches, lvl_size) for lvl_size in (32, 16, 8, 4)
        ]
        self.lines = None
        if n_lines:
            starts = rng.uniform(lo, hi, size=(n_lines, 3))
            dirs = rng.normal(size=(n_lines, 3))
            dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
            lengths = rng.uniform(1.0, 4.0, size=(n_lines, 1))
            self.lines = np.stack([starts, starts + dirs * lengths], axis=1)
        self.bg = 110

    def render(self, R_cw: np.ndarray, t_cw: np.ndarray) -> np.ndarray:
        """Render the left view for camera pose Tcw."""
        return self._render_view(R_cw, t_cw, baseline_shift=0.0)

    def render_stereo(self, R_cw: np.ndarray, t_cw: np.ndarray):
        left = self._render_view(R_cw, t_cw, 0.0)
        right = self._render_view(R_cw, t_cw, self.cam.baseline)
        return left, right

    def render_rgbd(self, R_cw: np.ndarray, t_cw: np.ndarray):
        """Left view + registered depth map in meters (0 = no return),
        as a TUM-style RGB-D sensor would deliver."""
        depth = np.zeros((self.cam.height, self.cam.width), np.float32)
        img = self._render_view(R_cw, t_cw, 0.0, depth_out=depth)
        return img, depth

    def _render_view(self, R_cw, t_cw, baseline_shift, depth_out=None):
        cam = self.cam
        h, w = cam.height, cam.width
        # Flat background: any texture here would be fixed in SCREEN
        # space (not world space) and would corrupt descriptors of
        # features whose sampling pattern overlaps it.
        img = np.full((h, w), self.bg, dtype=np.uint8)

        xc = (R_cw @ self.points.T).T + t_cw
        xc = xc - np.array([baseline_shift, 0.0, 0.0])  # right cam offset
        z = xc[:, 2]
        u = cam.fx * xc[:, 0] / np.where(z > 0.1, z, 1.0) + cam.cx
        v = cam.fy * xc[:, 1] / np.where(z > 0.1, z, 1.0) + cam.cy
        vis = z > 0.5
        order = np.argsort(-z)  # far first so near landmarks overdraw
        for i in order:
            if not vis[i]:
                continue
            s = cam.fx * self.world_size[i] / z[i]  # projected size in px
            if s < 3.0 or s > 600.0:
                continue
            half = s / 2.0
            x0 = int(np.floor(u[i] - half)) - 1
            y0 = int(np.floor(v[i] - half)) - 1
            size = int(np.ceil(s)) + 3
            # Clip the ROI to the image (partially-visible billboards
            # must render their visible part, not vanish).
            cx0, cy0 = max(x0, 0), max(y0, 0)
            cx1, cy1 = min(x0 + size, w), min(y0 + size, h)
            if cx1 - cx0 < 2 or cy1 - cy0 < 2:
                continue
            # Pick the smallest mip level that is >= the projected size.
            mip = self.mips[0]
            for m in self.mips:
                if m.shape[1] >= s:
                    mip = m
                else:
                    break
            patch = mip[i]
            scale = s / patch.shape[1]
            M = np.array(
                [
                    [scale, 0.0, u[i] - half - cx0],
                    [0.0, scale, v[i] - half - cy0],
                ]
            )
            warped = _warp_scale_linear(
                patch.astype(np.float32), M, (cx1 - cx0, cy1 - cy0)
            )
            mask = warped >= 0
            roi = img[cy0:cy1, cx0:cx1]
            roi[mask] = warped[mask].astype(np.uint8)
            if depth_out is not None:
                # Billboards are fronto-parallel: constant depth across
                # the patch footprint.
                droi = depth_out[cy0:cy1, cx0:cx1]
                droi[mask] = z[i]

        if self.lines is not None:
            for seg in self.lines:
                pc = (R_cw @ seg.T).T + t_cw - np.array([baseline_shift, 0.0, 0.0])
                # Clip against the z=1 near plane (shorten, don't skip —
                # and never project near-zero depths, which would paint
                # streaks across the whole frame).
                z0, z1 = pc[0, 2], pc[1, 2]
                if z0 < 1.0 and z1 < 1.0:
                    continue
                pc = pc.copy()
                if z0 < 1.0:
                    a = (1.0 - z0) / (z1 - z0)
                    pc[0] = pc[0] + a * (pc[1] - pc[0])
                elif z1 < 1.0:
                    a = (1.0 - z1) / (z0 - z1)
                    pc[1] = pc[1] + a * (pc[0] - pc[1])
                p0 = (cam.fx * pc[0, 0] / pc[0, 2] + cam.cx, cam.fy * pc[0, 1] / pc[0, 2] + cam.cy)
                p1 = (cam.fx * pc[1, 0] / pc[1, 2] + cam.cx, cam.fy * pc[1, 1] / pc[1, 2] + cam.cy)
                draw_line(img, (int(round(p0[0])), int(round(p0[1]))),
                          (int(round(p1[0])), int(round(p1[1]))), 30)

        return img


def _resize_linear(imgs: np.ndarray, n: int) -> np.ndarray:
    """[B, g, g] float32 -> [B, n, n]: cv2.resize INTER_LINEAR (half-pixel
    centres, replicated border)."""
    g = imgs.shape[1]
    x = np.clip((np.arange(n) + 0.5) * g / n - 0.5, 0.0, g - 1)
    i0 = np.floor(x).astype(np.int64)
    i1 = np.minimum(i0 + 1, g - 1)
    f = (x - i0).astype(np.float32)
    rows = imgs[:, i0] * (1 - f)[None, :, None] + imgs[:, i1] * f[None, :, None]
    return rows[:, :, i0] * (1 - f) + rows[:, :, i1] * f


def _resize_area(imgs: np.ndarray, n: int) -> np.ndarray:
    """[B, s, s] uint8 -> [B, n, n] uint8 block mean (cv2 INTER_AREA at
    an integer factor)."""
    b, s = imgs.shape[0], imgs.shape[1]
    k = s // n
    m = imgs.reshape(b, n, k, n, k).astype(np.float32).mean(axis=(2, 4))
    return np.round(m).astype(np.uint8)


def _warp_scale_linear(patch: np.ndarray, M: np.ndarray, size) -> np.ndarray:
    """cv2.warpAffine(INTER_LINEAR, BORDER_CONSTANT=-1) for a scale +
    translation M: dst(x, y) = src((x - M02) / M00, (y - M12) / M11),
    with cv2's 1/32-pixel quantization of the bilinear weights."""
    w, h = size
    ph, pw = patch.shape
    pad = np.full((ph + 2, pw + 2), -1.0, np.float32)
    pad[1:-1, 1:-1] = patch

    def taps(n_dst, scale, off, n_src):
        q = np.round((np.arange(n_dst) - off) / scale * 32.0).astype(np.int64)
        i = q >> 5
        f = ((q & 31) / 32.0).astype(np.float32)
        i0 = np.clip(i + 1, 0, n_src + 1)
        i1 = np.clip(i + 2, 0, n_src + 1)
        return i0, i1, f

    x0, x1, fx = taps(w, M[0, 0], M[0, 2], pw)
    y0, y1, fy = taps(h, M[1, 1], M[1, 2], ph)
    rows = pad[y0] * (1 - fy)[:, None] + pad[y1] * fy[:, None]
    return rows[:, x0] * (1 - fx) + rows[:, x1] * fx


_SHIFT = 16                 # OpenCV's XY_SHIFT: 16.16 fixed point
_ONE = 1 << _SHIFT
_HALF = _ONE >> 1


def _tdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _put(img, xs, ys, val):
    h, w = img.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[ok], xs[ok]] = val


def _line2(img, p, q, val):
    """OpenCV's ``Line2``: a 16.16 fixed-point DDA from the left (or top)
    end, plus the rounded far end."""
    (x1, y1), (x2, y2) = p, q
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            x1, x2, y1, y2, dy = x2, x1, y2, y1, -dy
        k = np.arange(((x2 - x1) >> _SHIFT) + 1, dtype=np.int64)
        xs = ((x1 + _HALF) >> _SHIFT) + k
        ys = (y1 + _HALF + k * _tdiv(dy << _SHIFT, abs(x2 - x1) | 1)) >> _SHIFT
    else:
        if dy < 0:
            x1, x2, y1, y2, dx = x2, x1, y2, y1, -dx
        k = np.arange(((y2 - y1) >> _SHIFT) + 1, dtype=np.int64)
        ys = ((y1 + _HALF) >> _SHIFT) + k
        xs = (x1 + _HALF + k * _tdiv(dx << _SHIFT, abs(y2 - y1) | 1)) >> _SHIFT
    _put(img, np.append(xs, (x2 + _HALF) >> _SHIFT), np.append(ys, (y2 + _HALF) >> _SHIFT), val)


def _fill_convex(img, v, val):
    """OpenCV's ``FillConvexPoly`` (non-antialiased, 16.16 vertices v):
    edges drawn with ``Line2``, then rows filled between the two edge
    chains walked from the top vertex with integer slopes."""
    h, w = img.shape
    n = len(v)
    for i in range(n):
        _line2(img, v[i - 1], v[i], val)
    ys = [p[1] for p in v]
    xs = [p[0] for p in v]
    ymin = (min(ys) + _HALF) >> _SHIFT
    ymax = min((max(ys) + _HALF) >> _SHIFT, h - 1)
    if ((max(xs) + _HALF) >> _SHIFT) < 0 or ymax < 0 or ((min(xs) + _HALF) >> _SHIFT) >= w or ymin >= h:
        return
    imin = int(np.argmin(ys))
    edge = [[imin, 1, -_ONE, 0, ymin], [imin, n - 1, -_ONE, 0, ymin]]   # idx, di, x, dx, ye
    edges = n
    y = ymin
    rows, lo, hi = [], [], []
    while y <= ymax:
        for e in edge:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + _HALF) >> _SHIFT
                if ty > y:
                    e[2], e[3], e[4], e[0] = v[idx0][0], _tdiv((v[idx][0] - v[idx0][0]) * 2 + (ty - y), 2 * (ty - y)), ty, idx
                    break
                idx0, idx = idx, (idx + e[1]) % n
        if edges < 0:
            break
        # Rows up to the next vertex: x advances by the integer slopes.
        y_next = min(edge[0][4], edge[1][4], ymax + 1)
        k = np.arange(max(y_next - y, 1), dtype=np.int64)
        xa, xb = edge[0][2] + k * edge[0][3], edge[1][2] + k * edge[1][3]
        rows.append(y + k)
        lo.append((np.minimum(xa, xb) + _HALF) >> _SHIFT)
        hi.append((np.maximum(xa, xb) + _HALF) >> _SHIFT)
        edge[0][2] += len(k) * edge[0][3]
        edge[1][2] += len(k) * edge[1][3]
        y += len(k)
    if not rows:
        return
    r, a, b = np.concatenate(rows), np.concatenate(lo), np.concatenate(hi)
    keep = (r >= 0) & (r < h) & (b >= 0) & (a < w)
    r, a, b = r[keep], np.clip(a[keep], 0, w - 1), np.clip(b[keep], 0, w - 1)
    run = b - a + 1
    start = np.repeat(np.cumsum(run) - run, run)
    img[np.repeat(r, run), np.repeat(a, run) + np.arange(run.sum()) - start] = val


def draw_line(img: np.ndarray, p0, p1, val):
    """``cv2.line(img, p0, p1, val, 2, cv2.LINE_8)`` on a uint8 [H, W]
    image, for integer endpoints: OpenCV's ``ThickLine`` with thickness
    2, a quad one pixel either side of the segment plus a filled circle
    of radius 1 (a plus) on each end."""
    a = (int(p0[0]) << _SHIFT, int(p0[1]) << _SHIFT)
    b = (int(p1[0]) << _SHIFT, int(p1[1]) << _SHIFT)
    dx = (a[0] - b[0]) / _ONE
    dy = (b[1] - a[1]) / _ONE
    r2 = dx * dx + dy * dy
    if r2 > np.finfo(np.float64).eps:
        r = _ONE / np.sqrt(r2)
        ox, oy = int(np.rint(dy * r)), int(np.rint(dx * r))
        _fill_convex(img, [(a[0] + ox, a[1] + oy), (a[0] - ox, a[1] - oy),
                           (b[0] - ox, b[1] - oy), (b[0] + ox, b[1] + oy)], val)
    for x, y in (p0, p1):
        _put(img, np.array([x - 1, x, x + 1, x, x]), np.array([y, y, y, y - 1, y + 1]), val)


def circular_trajectory(n_frames: int, radius: float = 0.0, step: float = 0.3):
    """Forward motion with slight yaw — a KITTI-like segment.

    Returns list of (R_cw, t_cw) world-to-camera poses; camera looks +z.
    """
    poses = []
    for i in range(n_frames):
        yaw = 0.002 * i
        Rwc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        twc = np.array([radius * np.sin(yaw), 0.0, step * i])
        R_cw = Rwc.T
        t_cw = -Rwc.T @ twc
        poses.append((R_cw, t_cw))
    return poses


def extend_scene(scene: SyntheticScene, more: SyntheticScene) -> SyntheticScene:
    """``scene`` with the point landmarks of ``more`` added (the same
    texture pipeline, another seed): a longer pass keeps its landmark
    density past the first scene's far edge."""
    scene.points = np.concatenate([scene.points, more.points])
    scene.world_size = np.concatenate([scene.world_size, more.world_size])
    scene.patches = np.concatenate([scene.patches, more.patches])
    scene.mips = [np.concatenate([a, b]) for a, b in zip(scene.mips, more.mips)]
    return scene


# Frames a render worker takes at a time.
RENDER_CHUNK = 10


def _render_chunk(scene, poses):
    """Stereo pairs of ``poses`` in order."""
    return [scene.render_stereo(R, t) for R, t in poses]


def _noise_chunk(pairs, sigma, noise_seed, first_call):
    """``pairs`` with Gaussian sensor noise (sigma in gray levels) added, a
    field of its own per image: the draws are numbered from ``first_call``
    (two a pair) in the stream of ``noise_seed``.  Independent noise per
    image degrades frame-to-frame matching as a real sensor does."""
    out = []
    for k, pair in enumerate(pairs):
        noisy = []
        for j, img in enumerate(pair):
            nrng = np.random.default_rng((noise_seed, first_call + 2 * k + j))
            noisy.append(np.clip(img.astype(np.float32) + nrng.normal(0.0, sigma, img.shape), 0, 255).astype(np.uint8))
        out.append(tuple(noisy))
    return out


def _pool_map(fn, jobs, processes):
    """[fn(*job) for job in jobs], on forked workers where there are several."""
    n_proc = processes or len(os.sched_getaffinity(0))
    if n_proc <= 1 or len(jobs) == 1:
        return [fn(*job) for job in jobs]
    context = multiprocessing.get_context("fork")
    with concurrent.futures.ProcessPoolExecutor(min(n_proc, len(jobs)), mp_context=context) as pool:
        return [f.result() for f in [pool.submit(fn, *job) for job in jobs]]


def noisy_copies(pairs, sigma: float, noise_seeds, processes: int | None = None):
    """One copy of the clean stereo ``pairs`` per noise seed, with that
    seed's sensor noise."""
    jobs = [(pairs[f0:f0 + RENDER_CHUNK], sigma, int(s), 2 * f0)
            for s in noise_seeds for f0 in range(0, len(pairs), RENDER_CHUNK)]
    done = _pool_map(_noise_chunk, jobs, processes)
    per = -(-len(pairs) // RENDER_CHUNK)
    return [[pair for part in done[i * per:(i + 1) * per] for pair in part] for i in range(len(noise_seeds))]


def render_frames(scene: SyntheticScene, poses, processes: int | None = None):
    """Clean stereo pairs (left, right uint8 [H, W]) of ``poses``.  The renderer is a Python loop
    over landmarks, so chunks of RENDER_CHUNK frames go to forked workers,
    one per CPU this process may use: call it before anything touches the
    card and before any thread starts."""
    chunks = [(scene, poses[f0:f0 + RENDER_CHUNK]) for f0 in range(0, len(poses), RENDER_CHUNK)]
    return [pair for part in _pool_map(_render_chunk, chunks, processes) for pair in part]
