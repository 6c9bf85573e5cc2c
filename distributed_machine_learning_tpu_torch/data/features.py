"""Wearable-sensor feature names and the label column.

Port of the name lists of ``distributed_machine_learning_tpu/data/
features.py``: the canonical feature names (``features``, generated from
the rolling-window grid), the reference data files' names
(``reference_features``) and ``LABEL_COLUMN``.  A servable bundle's
manifest records one of the two lists as its input-column contract
(``serve/export.py::_feature_block``).  The pandas frame builders are not
ported yet (ROADMAP.md A5).
"""

from __future__ import annotations

from typing import List

ROLLING_WINDOWS_MIN = (15, 30, 60, 120, 240, 480, 720, 1440)


def _rolling(base: str, stats=("mean", "std")) -> List[str]:
    return [f"{base}_{stat}_{w}min" for w in ROLLING_WINDOWS_MIN for stat in stats]


def sensor_features(base: str) -> List[str]:
    """Raw reading + rolling mean/std at each window for one sensor channel."""
    return [base] + _rolling(base)


SENSOR_CHANNELS = ("heart_rate", "sleep", "intensity", "steps")

# sin/cos encodings of time-of-day / day-of-week / day-of-month / month.
temporal_features: List[str] = [
    f"{unit}_{fn}"
    for unit in ("minute_of_day", "day_of_week", "day_of_month", "month")
    for fn in ("sin", "cos")
]

# features_1 = raw sensor channels + temporal; features = everything.
features_1: List[str] = [
    sensor_features(ch)[0] for ch in SENSOR_CHANNELS
] + temporal_features

features: List[str] = [
    name for ch in SENSOR_CHANNELS for name in sensor_features(ch)
] + temporal_features

LABEL_COLUMN = "Historic Glucose mg/dL"

# The reference data files' names: CamelCase bases, a 9-entry window grid,
# and a window suffix without "min" for heart rate only.
REFERENCE_WINDOWS_MIN = (15, 30, 60, 90, 180, 240, 360, 720, 1440)

# canonical channel -> (reference raw column, window-suffix style)
_REFERENCE_CHANNELS = {
    "heart_rate": ("HeartRate", ""),
    "sleep": ("Sleep", "min"),
    "intensity": ("Intensity", "min"),
    "steps": ("Steps", "min"),
}

reference_temporal_features: List[str] = [
    "MinuteOfDay_Sin", "MinuteOfDay_Cos", "DayOfWeek_Sin", "DayOfWeek_Cos",
    "Is_Weekend",
]


def reference_rolling_features(channel: str) -> List[str]:
    """The reference's rolling mean/std column names for one channel."""
    raw, suffix = _REFERENCE_CHANNELS[channel]
    return [
        f"{raw}_{w}{suffix}_{stat}"
        for w in REFERENCE_WINDOWS_MIN
        for stat in ("Mean", "Std")
    ]


# The raw channels and temporal columns first, then the four rolling
# blocks (not interleaved per channel): column order is the contract.
reference_features_1: List[str] = [
    _REFERENCE_CHANNELS[ch][0] for ch in SENSOR_CHANNELS
] + reference_temporal_features

reference_features: List[str] = reference_features_1 + [
    col for ch in SENSOR_CHANNELS for col in reference_rolling_features(ch)
]
