"""Host-side running averages: the counterpart of paddle_tpu/average.py
(reference python/paddle/fluid/average.py).  Neither the Program nor the
device is touched."""

from __future__ import annotations

import numpy as np

__all__ = ["WeightedAverage"]


class WeightedAverage:
    """Accumulate (value, weight) pairs; eval() = sum(v*w) / sum(w)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.numerator = 0.0
        self.denominator = 0.0

    def add(self, value, weight):
        value = np.asarray(value, dtype=np.float64).reshape(-1)
        if value.size != 1:
            raise ValueError(
                f"WeightedAverage.add expects a scalar value, got shape "
                f"{value.shape}")
        w = float(weight)
        self.numerator += float(value[0]) * w
        self.denominator += w

    def eval(self):
        if self.denominator == 0.0:
            raise ValueError(
                "There is no data in WeightedAverage; call add() first.")
        return self.numerator / self.denominator
