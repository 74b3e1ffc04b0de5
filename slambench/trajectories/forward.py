"""``forward``: a KITTI-like forward drive with a slight yaw, ``step_m``
metres a frame (``render.circular_trajectory``)."""

from slambench import render


def poses(n_frames: int, spec: dict):
    return render.circular_trajectory(n_frames, step=spec["step_m"])
