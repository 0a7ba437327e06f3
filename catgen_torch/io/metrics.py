"""Structured metrics: JSONL event log + stdout confusion summaries.

A copy of ``catgen/io/metrics.py`` (standard library only): one JSON event
per line, plus the human-readable epoch confusion summary on stdout.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None, echo: bool = True):
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a", buffering=1)
        else:
            self._fh = None

    def log(self, event: str, **fields: Any) -> Dict[str, Any]:
        rec = {"ts": time.time(), "event": event, **fields}
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            shown = {k: (round(v, 5) if isinstance(v, float) else v)
                     for k, v in fields.items()}
            print(f"[{event}] " + " ".join(f"{k}={v}" for k, v in shown.items()))
        return rec

    def close(self):
        if self._fh:
            self._fh.close()
            self._fh = None


def confusion_summary(tp: int, tn: int, fp: int, fn: int) -> str:
    """Pretty confusion print in the spirit of optim.ConfusionMatrix
    (adversarial.lua:286-289). Classes: real (positive) vs fake."""
    total = max(tp + tn + fp + fn, 1)
    acc = (tp + tn) / total
    lines = [
        "Confusion of D (rows = prediction, cols = truth):",
        f"            real   fake",
        f"  pred real {tp:6d} {fp:6d}",
        f"  pred fake {fn:6d} {tn:6d}",
        f"  accuracy: {acc:.4f} ({tp + tn}/{total})",
    ]
    return "\n".join(lines)
