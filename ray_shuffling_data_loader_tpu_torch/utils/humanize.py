"""Human-readable formatting helpers (own copy of the JAX package's
``utils/humanize.py``)."""

from __future__ import annotations

_BIG_NUM_SUFFIXES = [
    (1e12, "T"),
    (1e9, "B"),
    (1e6, "M"),
    (1e3, "K"),
]

_SIZE_UNITS = ["B", "KiB", "MiB", "GiB", "TiB", "PiB"]


def human_readable_big_num(num: float) -> str:
    """1_500_000 -> '1.5M'; small numbers are returned unadorned."""
    for threshold, suffix in _BIG_NUM_SUFFIXES:
        if abs(num) >= threshold:
            value = num / threshold
            if value == int(value):
                return f"{int(value)}{suffix}"
            return f"{value:.1f}{suffix}"
    if num == int(num):
        return str(int(num))
    return f"{num:.1f}"


def human_readable_size(num_bytes: float) -> str:
    """1536 -> '1.5 KiB'."""
    size = float(num_bytes)
    for unit in _SIZE_UNITS:
        if abs(size) < 1024.0 or unit == _SIZE_UNITS[-1]:
            return f"{size:.1f} {unit}"
        size /= 1024.0
    return f"{size:.1f} PiB"
