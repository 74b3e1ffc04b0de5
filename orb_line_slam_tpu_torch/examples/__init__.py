"""Example drivers of the port, one per reference main (Examples/*/*.cc):
``python -m orb_line_slam_tpu_torch.examples.stereo_kitti SETTINGS SEQ``.
They read the YAML settings in ``examples/configs/``."""
