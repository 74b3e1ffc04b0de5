"""Trajectory kinds by name: a configuration's ``trajectory.kind`` names
``<kind>.py``, whose ``poses(n_frames, spec)`` gives the world-to-camera
poses (R_cw, t_cw) of the rendered sequence."""
