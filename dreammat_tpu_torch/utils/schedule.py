"""Step-scheduled scalar hyperparameters.

A scalar config value is a plain number, or a list
``[start_step, start_value, end_value, end_step]`` (3-element lists get
``start_step=0`` prepended), linearly interpolated over the global step and
clamped. PyTorch runs eagerly, so the JAX package's host ``C`` and traced
``C_jax`` (``dreammat_tpu/utils/schedule.py``) are one plain function here.
"""

from __future__ import annotations

from typing import Any


def _canon(value) -> list:
    value = list(value)
    if len(value) == 3:
        value = [0] + value
    if len(value) != 4:
        raise ValueError(f"scheduled scalar must have 3 or 4 entries, got {value}")
    return value


def C(value: Any, step: int) -> float:
    """Evaluate a (possibly scheduled) scalar at integer ``step``."""
    if isinstance(value, (int, float)):
        return float(value)
    start_step, start_value, end_value, end_step = _canon(value)
    frac = (step - start_step) / float(end_step - start_step)
    frac = min(max(frac, 0.0), 1.0)
    return float(start_value + (end_value - start_value) * frac)
