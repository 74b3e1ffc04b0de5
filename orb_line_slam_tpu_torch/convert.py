"""Carry configuration, frames and map state from the JAX package.

The system has no weights: its state is configuration, frames, line
features, the tracking step's outputs and the map; a Frame, LineFeatures
or TrackOut may carry a leading batch axis (the JAX package's batched
multi-sequence pytrees).  These pure functions take numpy input (or a
JAX-package config, read by attribute, so nothing here imports jax) and
build the port's objects, so that tests can start both packages from
identical state.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from .config import (
    CameraIntrinsics, LineConfig, MapConfig, OrbConfig, SlamConfig, TrackingConfig,
)
from .frontend.frame import Frame
from .frontend.line_extractor import LineFeatures
from .loop.vocabulary import Vocabulary
from .pipeline.track_step import TrackOut
from .slam_map.map_store import MapStore


def config_from_fields(camera: dict, orb: dict | None = None, lines: dict | None = None,
                       tracking: dict | None = None, map: dict | None = None,
                       **top) -> SlamConfig:
    """SlamConfig from plain field dicts (missing groups take defaults)."""
    return SlamConfig(
        camera=CameraIntrinsics(**camera),
        orb=OrbConfig(**(orb or {})),
        lines=LineConfig(**(lines or {})),
        tracking=TrackingConfig(**(tracking or {})),
        map=MapConfig(**(map or {})),
        **top,
    )


def config_from_jax(cfg) -> SlamConfig:
    """The port's SlamConfig with the field values of a JAX-package
    SlamConfig (read by attribute; no jax import)."""
    fields = lambda obj, cls: {f.name: getattr(obj, f.name) for f in dataclasses.fields(cls)}  # noqa: E731
    top = {f: getattr(cfg, f) for f in ("fps", "rgb", "depth_map_factor", "rectify")}
    return config_from_fields(
        camera=dict(cfg.camera._asdict()),
        orb=fields(cfg.orb, OrbConfig), lines=fields(cfg.lines, LineConfig),
        tracking=fields(cfg.tracking, TrackingConfig), map=fields(cfg.map, MapConfig),
        **top,
    )


def _tuple_from_numpy(cls, d, device):
    get = (lambda k: d[k]) if isinstance(d, dict) else (lambda k: getattr(d, k))
    return cls(*(torch.from_numpy(np.array(get(k))).to(device) for k in cls._fields))


def frame_from_numpy(d, device) -> Frame:
    """Frame on `device` from a dict (or any object with the fields as
    attributes) of numpy arrays in the JAX Frame's layout and dtypes."""
    return _tuple_from_numpy(Frame, d, device)


def line_features_from_numpy(d, device) -> LineFeatures:
    """LineFeatures on `device` from a dict or object of numpy arrays in
    the JAX LineFeatures' layout and dtypes (e.g. ``jax.device_get`` of
    one)."""
    return _tuple_from_numpy(LineFeatures, d, device)


def track_out_from_numpy(d, device) -> TrackOut:
    """TrackOut on `device` from a dict or object of numpy arrays in the
    JAX TrackOut's layout (``jax.device_get`` of one, or of a batch of B
    with a leading [B] on every leaf).  The JAX step returns its scalars
    in ``packed`` (R, t, ok, n_inliers, used_motion, stage1_ok, n_stage1,
    tracked_close, untracked_close); it has no line-inlier count, so
    ``n_line_inliers`` reads -1."""
    get = (lambda k: d[k]) if isinstance(d, dict) else (lambda k: getattr(d, k))
    packed = np.asarray(get("packed"), np.float32)
    t = lambda a: torch.from_numpy(np.array(a)).to(device)  # noqa: E731
    i32 = lambda j: t(np.rint(packed[..., j]).astype(np.int32))  # noqa: E731
    flag = lambda j: t(packed[..., j] > 0.5)  # noqa: E731
    direct = {k: t(get(k)) for k in ("R", "t", "Rv", "tv", "ok", "assoc_gid", "inliers", "found_acc", "vis_acc",
                                     "ln_found_acc", "ln_vis_acc", "ln_match_idx", "ln_match_mask")}
    return TrackOut(**direct, n_inliers=i32(13), used_motion=flag(14), stage1_ok=flag(15), n_stage1=i32(16),
                    tracked_close=i32(17), untracked_close=i32(18),
                    n_line_inliers=t(np.full(packed.shape[:-1], -1, np.int32)))


def map_store_from_numpy(store) -> MapStore:
    """A port MapStore holding a deep copy of another store's arrays
    (the JAX package's MapStore is numpy too)."""
    out = MapStore.__new__(MapStore)
    state = {k: v for k, v in vars(store).items() if k not in ("lock", "on_kf_culled", "cfg")}
    out.__dict__.update(copy.deepcopy(state))
    out.cfg = MapConfig(**{f.name: getattr(store.cfg, f.name) for f in dataclasses.fields(MapConfig)})
    out.lock = type(store.lock)() if hasattr(store, "lock") else None
    out.on_kf_culled = []
    return out


def vocabulary_from_numpy(children, node_desc=None, word_id=None, word_weight=None,
                          k=None, depth=None) -> Vocabulary:
    """A port Vocabulary over copies of the given tree arrays, or of the
    arrays of a vocabulary object passed as the only argument (the JAX
    package's Vocabulary has the same attributes), so that both packages
    can run with one tree."""
    if node_desc is None:
        v = children
        children, node_desc, word_id, word_weight, k, depth = (
            v.children, v.node_desc, v.word_id, v.word_weight, v.k, v.depth)
    return Vocabulary(np.array(children), np.array(node_desc), np.array(word_id),
                      np.array(word_weight), int(k), int(depth))
