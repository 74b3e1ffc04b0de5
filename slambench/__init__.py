"""The benchmark of orb_line_slam_tpu_torch on a CUDA card: ``run.py`` runs one
cell once; cells, configurations, traffic mixes and metric readers are
files found by name (``cells/``, ``configs/``, ``traffic/``, ``metrics/``);
``ref/`` is the plain reference that decides ``correct``."""
