# Frozen copy of orb_line_slam_tpu_torch/backend/robust.py at commit d30c4f7 (the benchmark's plain reference).
"""Robust kernels and chi2 thresholds shared by the optimizers.

Port of ``orb_line_slam_tpu/backend/robust.py`` (g2o Huber deltas
sqrt(5.991) mono / sqrt(7.815) stereo, and the chi2 outlier gates).
"""

from __future__ import annotations

import math

import torch

CHI2_MONO = 5.991    # 95% quantile, 2 DoF
CHI2_STEREO = 7.815  # 95% quantile, 3 DoF


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel: 1 inside delta, delta/|e| outside."""
    e = torch.sqrt(torch.clamp(chi2, min=1e-12))
    return torch.where(chi2 <= delta2, torch.ones_like(e), math.sqrt(delta2) / e)
