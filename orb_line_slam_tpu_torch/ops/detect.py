"""ORB keypoint detection on every level of a (batched) image pyramid.

``detect_keypoints`` computes, per level, the FAST-9 score, the 3x3 NMS,
the interior mask, the per-cell top-k, the level's top-N and the
parabola's sub-pixel offsets, and concatenates the levels: port of
``orb_line_slam_tpu/frontend/orb_extractor.py`` ``_detect_level``
(50-89) over the levels as ``extract_orb_stereo`` (279-356) runs it.  It
dispatches on the device of its input: CPU tensors take the plain
composition ``fast_score_map`` -> ``nms3x3`` -> interior mask ->
``select_topk_grid`` -> parabola (``detect_reference``, a level at a
time); CUDA tensors launch the kernel in ``csrc/orb_detect.cu``, which
reads the pyramid atlas once and covers every level and image in
``LAUNCHES_PER_CALL`` launches, or raise.  ``launches`` counts kernel
launches.

Kernel against plain version: every operation of the plain version is
exact or one IEEE operation, and the kernel takes them in its order, so
the two are equal element for element.  The kernel's per-level values
come in through ``level_table``, passed by value: nothing is uploaded.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..config import OrbConfig
from . import _build
from .fast import fast_score_map, nms3x3
from .topk_grid import select_topk_grid

LAUNCHES_PER_CALL = 2
MAX_LEVELS = 16      # csrc/orb_detect.cu kMaxLevels
MAX_SORT = 16384     # kMaxSort: candidate slots of one level
CELL = 32            # kCell
# The words of csrc/orb_detect.cu's struct Levels, in order: the header,
# then MAX_LEVELS words per level field (scale and min_score float32).
_HEADER = ("n_levels", "total_cells", "total_cand", "n_out", "margin", "min_score")
_FIELDS = ("row_off", "h", "w", "wc", "first_cell", "n_cells", "k", "cand_start", "quota", "col_start",
           "sort_len", "scale")
_ARGTYPES = (
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
)

# Kernel launches since import (or since the caller last reset it).
launches = 0


def k_per_cell(h: int, w: int, quota: int, cfg: OrbConfig) -> int:
    n_cells = max(1, (h // cfg.cell_size) * (w // cfg.cell_size))
    return max(1, min(16, (3 * quota) // n_cells + 1))


def detect_level(img: torch.Tensor, quota: int, cfg: OrbConfig):
    """FAST + NMS + grid top-K on one level ([..., h, w]); returns (xy
    int32, delta float32 in [-0.5, 0.5] from a parabola over the raw
    score per axis, resp, valid)."""
    raw = fast_score_map(img)
    score = nms3x3(raw)
    h, w = img.shape[-2], img.shape[-1]
    m = cfg.edge_margin
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    interior = (ys >= m) & (ys < h - m) & (xs >= m) & (xs < w - m)
    score = torch.where(interior, score, torch.zeros((), device=img.device))

    xy, resp, valid = select_topk_grid(score, cfg.cell_size, k_per_cell(h, w, quota, cfg), quota, cfg.min_th_fast)
    x, y = xy[..., 0].long(), xy[..., 1].long()
    flat = raw.reshape(*raw.shape[:-2], h * w)

    def at(dy, dx):
        idx = torch.clamp(y + dy, 0, h - 1) * w + torch.clamp(x + dx, 0, w - 1)
        return torch.gather(flat, -1, idx)

    sc = at(0, 0)
    dl, dr = at(0, -1), at(0, 1)
    du, dd = at(-1, 0), at(1, 0)
    denx = 2.0 * sc - dl - dr
    deny = 2.0 * sc - du - dd
    zero = torch.zeros_like(sc)
    dx = torch.where(denx > 1e-6, 0.5 * (dr - dl) / denx, zero)
    dy = torch.where(deny > 1e-6, 0.5 * (dd - du) / deny, zero)
    delta = torch.clamp(torch.stack([dx, dy], dim=-1), -0.5, 0.5)
    return xy, delta, resp, valid


def level_offsets(shapes) -> list[int]:
    """Each level's first row in the atlas (``pyramid_atlas``)."""
    offs, y = [], 0
    for h, _ in shapes:
        offs.append(y)
        y += h
    return offs


def detect_reference(levels, cfg: OrbConfig):
    """Plain torch version, a level at a time: (xy float32 level-0
    coordinates [..., N, 2], atlas xy int32 [..., N, 2], resp [..., N],
    octave int32 [..., N], valid [..., N], delta float32 [..., N, 2])."""
    offs = level_offsets([tuple(l.shape[-2:]) for l in levels])
    all_xy, all_axy, all_d, all_resp, all_oct, all_valid = [], [], [], [], [], []
    for lvl, quota in enumerate(cfg.level_quotas):
        xy, delta, resp, valid = detect_level(levels[lvl], quota, cfg)
        all_xy.append((xy.to(torch.float32) + delta) * cfg.level_scales[lvl])
        shift = torch.tensor([0, offs[lvl]], dtype=torch.int32, device=xy.device)
        all_axy.append(xy + shift)
        all_d.append(delta)
        all_resp.append(resp)
        all_oct.append(torch.full(xy.shape[:-1], lvl, dtype=torch.int32, device=xy.device))
        all_valid.append(valid)
    return (
        torch.cat(all_xy, dim=-2), torch.cat(all_axy, dim=-2), torch.cat(all_resp, dim=-1),
        torch.cat(all_oct, dim=-1), torch.cat(all_valid, dim=-1), torch.cat(all_d, dim=-2),
    )


def level_table(shapes, cfg: OrbConfig) -> dict:
    """The kernel's per-level values for levels of (h, w) ``shapes``: header
    scalars and per-level lists, keyed as ``_HEADER`` and ``_FIELDS``."""
    cell = cfg.cell_size
    t = {f: [] for f in _FIELDS}
    cells = cand = col = 0
    for (h, w), row_off, quota, scale in zip(shapes, level_offsets(shapes), cfg.level_quotas, cfg.level_scales):
        hc, wc = -(-h // cell), -(-w // cell)
        k = k_per_cell(h, w, quota, cfg)
        level = dict(row_off=row_off, h=h, w=w, wc=wc, first_cell=cells, n_cells=hc * wc, k=k, cand_start=cand,
                     quota=quota, col_start=col, sort_len=1 << max(0, hc * wc * k - 1).bit_length(),
                     scale=np.float32(scale))
        for f in _FIELDS:
            t[f].append(level[f])
        cells += hc * wc
        cand += hc * wc * k
        col += quota
    t.update(n_levels=len(shapes), total_cells=cells, total_cand=cand, n_out=col, margin=cfg.edge_margin,
             min_score=np.float32(cfg.min_th_fast))
    return t


def pack_table(t: dict) -> np.ndarray:
    """``level_table``'s values as the words of csrc/orb_detect.cu's struct
    Levels (int32, float32 fields by their bits)."""
    words = np.zeros(len(_HEADER) + MAX_LEVELS * len(_FIELDS), np.int32)
    floats = words.view(np.float32)
    for i, f in enumerate(_HEADER):
        (floats if f == "min_score" else words)[i] = t[f]
    for j, f in enumerate(_FIELDS):
        at = len(_HEADER) + j * MAX_LEVELS
        (floats if f == "scale" else words)[at : at + len(t[f])] = t[f]
    return words


def _check_table(t: dict, cfg: OrbConfig) -> None:
    if cfg.cell_size != CELL:
        raise ValueError(f"the detection kernel takes {CELL}-px cells, not {cfg.cell_size}")
    if not cfg.min_th_fast >= 0:
        raise ValueError(f"the detection kernel takes min_th_fast >= 0, not {cfg.min_th_fast}")
    if not 0 < t["n_levels"] <= MAX_LEVELS:
        raise ValueError(f"the detection kernel takes 1 to {MAX_LEVELS} levels, not {t['n_levels']}")
    if max(t["sort_len"]) > MAX_SORT:
        raise ValueError(f"a level has {max(t['sort_len'])} candidate slots to sort; the kernel holds {MAX_SORT}")
    if max(max(t["h"]), max(t["w"])) >= 1 << 15:
        raise ValueError("a level of 32,768 px or more does not fit the kernel's packed coordinates")


@functools.lru_cache(maxsize=64)
def _kernel_table(shapes: tuple, cfg: OrbConfig) -> tuple[dict, np.ndarray]:
    """The checked table of levels of (h, w) ``shapes`` and its words, made
    once per shape and config."""
    t = level_table(shapes, cfg)
    _check_table(t, cfg)
    return t, pack_table(t)


def detect_cuda(atlas: torch.Tensor, shapes, cfg: OrbConfig):
    """Launch the kernel on the current stream (no synchronisation) over a
    float32 [B, H, W] atlas of levels of (h, w) ``shapes``; outputs with a
    leading [B]."""
    global launches
    t, words = _kernel_table(tuple(map(tuple, shapes)), cfg)
    b, n, dev = atlas.shape[0], t["n_out"], atlas.device
    xy = torch.empty((b, n, 2), dtype=torch.float32, device=dev)
    axy = torch.empty((b, n, 2), dtype=torch.int32, device=dev)
    resp = torch.empty((b, n), dtype=torch.float32, device=dev)
    octave = torch.empty((b, n), dtype=torch.int32, device=dev)
    valid = torch.empty((b, n), dtype=torch.bool, device=dev)
    delta = torch.empty((b, n, 2), dtype=torch.float32, device=dev)
    if b * n == 0:       # nothing to write: no launch
        return xy, axy, resp, octave, valid, delta
    cand = torch.empty((b, t["total_cand"], 4), dtype=torch.float32, device=dev)
    fn = _build.kernel("orb_detect", _ARGTYPES)
    _build.launch(fn, "orb_detect", dev, atlas.data_ptr(), b, atlas.shape[1], atlas.shape[2],
                  words.ctypes.data, cand.data_ptr(), xy.data_ptr(), axy.data_ptr(), resp.data_ptr(),
                  octave.data_ptr(), valid.data_ptr(), delta.data_ptr())
    launches += LAUNCHES_PER_CALL
    return xy, axy, resp, octave, valid, delta


def detect_keypoints(levels, atlas: torch.Tensor, cfg: OrbConfig):
    """Keypoints of pyramid ``levels`` (float32 [..., h_l, w_l], at most one
    leading batch dim) whose ``pyramid_atlas`` is ``atlas``, concatenated
    over levels: (xy, axy, resp, octave, valid, delta) as
    ``detect_reference`` returns them.  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if len(levels) != len(cfg.level_quotas):
        raise ValueError(f"{len(levels)} levels for a config of {len(cfg.level_quotas)}")
    if atlas.device != levels[0].device:
        raise ValueError(f"atlas on {atlas.device}, levels on {levels[0].device}")
    if atlas.device.type == "cpu":
        return detect_reference(levels, cfg)
    if atlas.device.type != "cuda":
        raise ValueError(f"no detection kernel for device {atlas.device}")
    if atlas.dtype != torch.float32 or not atlas.is_contiguous() or atlas.dim() not in (2, 3):
        raise ValueError(f"want a contiguous float32 [B, H, W] or [H, W] atlas, got {atlas.dtype} "
                         f"{tuple(atlas.shape)}")
    shapes = [tuple(l.shape[-2:]) for l in levels]
    if atlas.shape[-2] != sum(h for h, _ in shapes) or atlas.shape[-1] != max(w for _, w in shapes):
        raise ValueError(f"atlas {tuple(atlas.shape)} is not the atlas of levels {shapes}")
    if atlas.dim() == 2:
        return tuple(o[0] for o in detect_cuda(atlas[None], shapes, cfg))
    return detect_cuda(atlas, shapes, cfg)
