"""Shared numeric-value predicates (a copy of the JAX package's
``utils/numeric.py``)."""

from __future__ import annotations

import math
from typing import Any, Optional


def finite_number(value: Any) -> Optional[float]:
    """``value`` as a float when it is a usable score, else None.

    Usable = a real number that is not a bool and is finite: trainables may
    report None/strings during warmup, NaN from diverged steps, or +/-inf
    from overflowed losses — none of which may rank, display as "best", or
    enter a searcher's mean (the one definition shared by ProgressReporter,
    TensorBoard-adjacent guards, and the Repeater)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    v = float(value)
    return v if math.isfinite(v) else None
