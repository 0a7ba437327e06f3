"""What one run measured, handed to the per-layer readers and printed."""

from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Result:
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    # host-clock seconds of the benchmark's own spans in the window
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    # counts and lengths of the window (steps, images, requests, seconds)
    window: Dict[str, float] = dataclasses.field(default_factory=dict)
    traces: Dict[str, object] = dataclasses.field(default_factory=dict)
    # (name, value, limit) of every number the comparison checks
    checks: List[Tuple[str, float, float]] = dataclasses.field(
        default_factory=list)
    setup: Dict[str, float] = dataclasses.field(default_factory=dict)
    notes: List[str] = dataclasses.field(default_factory=list)
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
    busy_s: Optional[float] = None
    window_s: Optional[float] = None
    breakdown: Optional[dict] = None

    def span(self, name: str, seconds: float) -> None:
        self.spans.setdefault(name, []).append(seconds)

    def note(self, line: str) -> None:
        self.notes.append(line)

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(v <= lim for _, v, lim in
                                          self.checks)


def quartiles(values: List[float]) -> List[float]:
    if len(values) < 2:
        return list(values) * 3 if values else []
    return statistics.quantiles(values, n=4)
