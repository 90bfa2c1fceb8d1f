"""Shared benchmark helpers of the port (the parts of
``benchmarks/common.py`` that its benchmarks use)."""

from __future__ import annotations

from typing import List

ROWS: List[str] = []


def emit(name: str, us_per_call: float, derived: str = "") -> None:
    row = f"{name},{us_per_call:.3f},{derived}"
    ROWS.append(row)
    print(row, flush=True)
