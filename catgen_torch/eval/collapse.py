"""GAN-collapse detection, numpy only: a copy of ``catgen/eval/collapse.py``
(``sat_fraction``, ``per_pixel_std``, ``CollapseConfig``,
``CollapseDetector`` and ``scan_metrics``).

The training harness logs two statistics with each visualization (the
samples' share of pixels at the rails and their mean across-batch
per-pixel std) and, with ``--collapseDetect``, feeds them to a
``CollapseDetector`` with each epoch's ``acc_d`` and ``loss_g`` and D's
two sanity probes. The detector fires when a signal persists:

  signal            healthy               collapsed
  ----------------  --------------------  -----------------------------
  acc_d / loss_g    0.75-0.86 / bounded   acc_d -> 1.0 AND loss_g pinned
                                          at -log(eps) ~ 16 (d_runaway)
  sanity probes     pattern low, real     both pinned low, or both high
                    high                  with acc_d at coin-flip
  pixel saturation  0.002-0.07            0.48 (blob collapse)
  per-pixel std     0.12-0.20             ~0 (flat or black collapse)
  nn_l2_ratio       1.18-1.25             1.6-5.1 (far from the data)
  loss_g            finite                NaN or inf: fires at once

Every other signal must persist for consecutive observations past a
warmup epoch, because early training visits degenerate-looking states.
``scan_metrics`` classifies a finished or partial run offline from its
``train_metrics.jsonl`` (gzip too). The thresholds are catgen's, which
it calibrated on its own archived runs.
"""

from __future__ import annotations

import dataclasses
import gzip
import json
import math
from typing import Any, Dict, List, Optional

import numpy as np


def sat_fraction(images: np.ndarray, tol: float = 0.04) -> float:
    """Fraction of pixel values at the rails ([0,1] images)."""
    x = np.asarray(images, np.float32)
    return float(((x < tol) | (x > 1.0 - tol)).mean())


def per_pixel_std(images: np.ndarray) -> float:
    """Mean across-batch std per pixel (the quality report's diversity
    statistic)."""
    return float(np.mean(np.std(np.asarray(images, np.float32), axis=0)))


@dataclasses.dataclass
class CollapseConfig:
    min_epoch: int = 60        # ignore everything before this epoch
    k_epochs: int = 15         # consecutive epoch-level hits to fire
    k_viz: int = 3             # consecutive viz-level hits to fire
    acc_hi: float = 0.98       # D runaway: acc_d >= acc_hi ...
    loss_g_hi: float = 8.0     # ... AND loss_g >= loss_g_hi (healthy
                               # transients peak ~4; collapsed pins ~14-16)
    probe_pin: float = 0.98    # both probes > pin or both < 1-pin
    acc_lo: float = 0.6        # pinned-HIGH corroboration: only a death
                               # signal when acc_d has also fallen to
                               # coin-flip (D calls everything "real");
                               # healthy pinned-HIGH runs in the round-4
                               # 4k sweep sat at acc_d 0.84-0.95
    sat_threshold: float = 0.25
    std_floor: float = 0.03    # flat/black collapse
    # blob-collapse detector: generated samples stay FAR from the training
    # manifold. nn_l2_ratio = mean NN-L2(samples -> corpus) / corpus
    # leave-one-out self-NN mean. Round-3 sweep calibration (display-space
    # RGB, 1024-image corpus, self-NN 4.47): healthy runs sit at 1.18-1.25
    # across epochs 100-500; blob/degenerate regimes measure 1.6-5.1
    # (ma0.9_s*/ma1.01_s* grids), the one ambiguous early sample 1.30.
    # Probes/saturation/std all missed this regime for 100+ epochs.
    nn_ratio_hi: float = 1.45
    nn_min_epoch: int = 120    # early training is legitimately far


class CollapseDetector:
    """Streaming detector: feed per-epoch and per-viz observations; check
    ``verdict`` (None while healthy, else a reason string)."""

    def __init__(self, config: Optional[CollapseConfig] = None):
        self.cfg = config or CollapseConfig()
        self._runs = {"d_runaway": 0, "probe_pinned": 0,
                      "saturated": 0, "flat": 0, "far_from_data": 0,
                      "nan": 0}
        self.verdict: Optional[str] = None
        self.fired_epoch: Optional[int] = None
        self.history: List[Dict[str, Any]] = []
        self._last_acc_d: Optional[float] = None

    def _hit(self, name: str, hit: bool, k: int, epoch: int):
        self._runs[name] = self._runs[name] + 1 if hit else 0
        if self._runs[name] >= k and self.verdict is None:
            self.verdict = name
            self.fired_epoch = epoch

    def observe_epoch(self, epoch: int, acc_d: float, loss_g: float):
        self._last_acc_d = acc_d
        # Non-finite loss is unambiguous death at ANY epoch (NaN poisons
        # both optimizers' moments; nothing recovers). Fire immediately:
        # every NaN comparison below is False, so without this rule a NaN
        # run streams forever.
        self._hit("nan", not math.isfinite(loss_g), 1, epoch)
        if epoch < self.cfg.min_epoch:
            return
        hit = acc_d >= self.cfg.acc_hi and loss_g >= self.cfg.loss_g_hi
        self._hit("d_runaway", hit, self.cfg.k_epochs, epoch)

    def observe_viz(self, epoch: int, probe_pattern: float,
                    probe_real: float, sample_sat: float,
                    sample_std: float,
                    nn_ratio: Optional[float] = None):
        self.history.append({"epoch": epoch, "probe_pattern": probe_pattern,
                             "probe_real": probe_real,
                             "sample_sat": sample_sat,
                             "sample_std": sample_std,
                             "nn_ratio": nn_ratio})
        if epoch < self.cfg.min_epoch:
            return
        p = self.cfg.probe_pin
        # Pinned LOW — D rates even real images as fake — is unambiguous
        # death (every genuine collapse observed in rounds 2-4 shows it).
        pinned_low = probe_pattern < 1 - p and probe_real < 1 - p
        # Pinned HIGH — D rates the off-manifold sanity pattern as real —
        # killed two HEALTHY 4k-corpus runs in round 4 (acc_d 0.84-0.95,
        # nn 1.2-1.4): D can fail the pattern probe while still separating
        # reals from fakes. Count HIGH only when epoch-level acc_d has also
        # degenerated to ~coin-flip (the real death signature: probes HIGH
        # + acc_d 0.50 + loss_g ~0, D classifying everything as real).
        acc_dead = (self._last_acc_d is not None
                    and self._last_acc_d <= self.cfg.acc_lo)
        pinned_high = probe_pattern > p and probe_real > p and acc_dead
        self._hit("probe_pinned", pinned_low or pinned_high,
                  self.cfg.k_viz, epoch)
        self._hit("saturated", sample_sat > self.cfg.sat_threshold,
                  self.cfg.k_viz, epoch)
        self._hit("flat", sample_std < self.cfg.std_floor,
                  self.cfg.k_viz, epoch)
        if nn_ratio is not None and epoch >= self.cfg.nn_min_epoch:
            self._hit("far_from_data", nn_ratio > self.cfg.nn_ratio_hi,
                      self.cfg.k_viz, epoch)

    def report(self) -> Dict[str, Any]:
        return {"collapsed": self.verdict is not None,
                "reason": self.verdict, "fired_epoch": self.fired_epoch,
                "config": dataclasses.asdict(self.cfg)}


def scan_metrics(jsonl_path: str,
                 config: Optional[CollapseConfig] = None) -> Dict[str, Any]:
    """Offline classification of a finished/partial run from its
    train_metrics.jsonl (the sweep table path). Viz events need the
    ``sample_sat``/``sample_std`` fields (logged from round 3 on); older
    trails still get the epoch-level and probe signals. ``.gz`` paths are
    read transparently (archived trajectories, tests/data/trajectories)."""
    det = CollapseDetector(config)
    opener = gzip.open if str(jsonl_path).endswith(".gz") else open
    with opener(jsonl_path, "rt") as f:
        for line in f:
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("event") == "epoch":
                det.observe_epoch(ev["epoch"], ev.get("acc_d", 0.0),
                                  ev.get("loss_g", 0.0))
            elif ev.get("event") == "viz":
                det.observe_viz(ev["epoch"],
                                ev.get("d_probe_pattern", 0.5),
                                ev.get("d_probe_real", 0.5),
                                ev.get("sample_sat", 0.0),
                                ev.get("sample_std", 0.15),
                                ev.get("nn_l2_ratio"))
    return det.report()
