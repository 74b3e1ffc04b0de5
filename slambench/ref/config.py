# Frozen copy of orb_line_slam_tpu_torch/config.py at commit d30c4f7 (the benchmark's plain reference).
"""Typed configuration of the frozen reference: camera, ORB, line, tracking
and map settings, as the program's ``config.py`` declares them."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np


class CameraIntrinsics(NamedTuple):
    """Static per-sequence camera parameters (host-side constants)."""

    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx (stereo); 0 for monocular
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 0
    height: int = 0

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    cell_size: int = 32
    edge_margin: int = 19

    @property
    def level_scales(self) -> tuple[float, ...]:
        return tuple(self.scale_factor**i for i in range(self.n_levels))

    @property
    def level_quotas(self) -> tuple[int, ...]:
        """Per-level feature budget; geometric decay as ORBextractor's
        nDesiredFeaturesPerScale (sums exactly to n_features)."""
        inv = 1.0 / self.scale_factor
        n0 = self.n_features * (1.0 - inv) / (1.0 - inv**self.n_levels)
        quotas = [int(round(n0 * inv**i)) for i in range(self.n_levels)]
        quotas[0] += self.n_features - sum(quotas)
        return tuple(quotas)


@dataclasses.dataclass(frozen=True)
class LineConfig:
    enabled: bool = True
    n_lines: int = 128
    min_length_frac: float = 0.03  # min segment length as fraction of image diag
    n_bands: int = 9
    band_width: int = 7


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    th_depth: float = 35.0  # close/far stereo point threshold, x baseline
    max_frames_between_kf: int = 30  # ~1s at 30fps; reset from fps at load
    min_frames_between_kf: int = 0
    motion_search_radius: float = 15.0
    local_map_search_radius: float = 3.0
    min_inliers_ok: int = 30
    min_inliers_reloc: int = 50


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Capacity bounds for the SoA map store (static shapes)."""

    max_keyframes: int = 512
    max_points: int = 65536
    max_lines: int = 4096
    max_obs_per_kf: int = 2048  # = points per frame budget
    local_window: int = 16  # free KFs in local BA
    local_points: int = 8192  # landmark budget in local BA


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraIntrinsics = CameraIntrinsics(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157, bf=386.1448,
        width=1241, height=376,
    )
    orb: OrbConfig = OrbConfig()
    lines: LineConfig = LineConfig()
    tracking: TrackingConfig = TrackingConfig()
    map: MapConfig = MapConfig()
    fps: float = 10.0
    rgb: bool = False
    # TUM-style uint16 depth PNG scale (depth_m = raw / factor).
    depth_map_factor: float = 5000.0
    # EuRoC-style rectification (None for pre-rectified datasets).
    rectify: Optional[dict] = None
