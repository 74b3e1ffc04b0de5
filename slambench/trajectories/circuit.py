# Frozen copy of loop_circuit_trajectory from
# orb_line_slam_tpu_torch/data/synthetic.py at commit a64471c: the closed
# circuit of chip_smoke.py's loop slice (170 frames, radius 8 m, 1.12
# laps: LOOP_FRAMES, LOOP_RADIUS, LOOP_LAPS).
"""``circuit``: a closed circuit in the x-z plane, ``radius_m`` metres, the
camera yawing with the tangent over ``laps`` laps; past one lap the last
frames revisit the first, so a loop can close from pixels."""

import numpy as np


def poses(n_frames: int, spec: dict):
    radius, laps = float(spec["radius_m"]), float(spec["laps"])
    out = []
    total = 2.0 * np.pi * laps
    for i in range(n_frames):
        yaw = total * i / max(n_frames - 1, 1)
        Rwc = np.array(
            [
                [np.cos(yaw), 0, np.sin(yaw)],
                [0, 1, 0],
                [-np.sin(yaw), 0, np.cos(yaw)],
            ]
        )
        # The camera starts at the origin facing +z and orbits the circle
        # centred at (radius, 0, 0), heading along the tangent.
        twc = np.array([radius * (1.0 - np.cos(yaw)), 0.0, radius * np.sin(yaw)])
        out.append((Rwc.T, -Rwc.T @ twc))
    return out
