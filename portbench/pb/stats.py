"""Latency statistics: a linear-interpolated quantile of raw samples, as
``repro_torch.obs.metrics.quantile`` computes it (copied here, so the
yardstick stays the benchmark's)."""
from __future__ import annotations

import numpy as np


def quantile(samples, q: float) -> float:
    arr = np.asarray(samples, dtype=np.float64)
    if arr.size == 0:
        raise ValueError("no samples")
    return float(np.quantile(arr, q, method="linear"))
