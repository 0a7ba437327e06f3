"""Quality evaluation of a trained G/D pair: the counterpart of
``catgen/eval/quality.py``.

``quality_report`` computes, on the device the models and the corpus are
on:

  * the D-score statistics and histogram of ``n_samples`` generated
    images, and the same for a real sample of the corpus;
  * the L2 distance of every generated image to its nearest corpus image
    (one matmul, ``sample/sampler.py``), with the share under
    ``copy_threshold`` (a memorization alarm);
  * diversity: the mean pairwise L2 distance over a random subset and the
    mean per-pixel std across the batch (a mode-collapse alarm: a
    collapsed G gives ~0 for both);
  * V's rating of all samples and of D's best and worst 50, given a V.

catgen draws its noise, the real sample's indices and the subset's
permutation with ``jax.random`` from ``PRNGKey(seed)``; here they come
from a CPU ``torch.Generator`` seeded by ``seed``, in that order, unless
the caller hands them in (``noise``, ``real_indices``, ``permutation``).

``PCTS``, ``_dist_stats`` and ``summarize`` are numpy only, copied from
catgen's module. The report holds plain floats and lists (JSON).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from catgen_torch.data import color as colorlib
from catgen_torch.sample.sampler import (dist2_matrix, generate_batched,
                                         nearest_neighbours, rank_by_d)
from catgen_torch.train import gan, v_trainer

PCTS = (5, 25, 50, 75, 95)


def _dist_stats(x: np.ndarray, hist_range=None,
                bins: int = 20) -> Dict[str, Any]:
    """mean/std/min/max/percentiles + histogram of a 1-D sample."""
    x = np.asarray(x, np.float64)
    lo, hi = hist_range if hist_range else (float(x.min()), float(x.max()))
    counts, edges = np.histogram(x, bins=bins, range=(lo, hi))
    return {
        "n": int(x.size),
        "mean": float(x.mean()), "std": float(x.std()),
        "min": float(x.min()), "max": float(x.max()),
        "percentiles": {str(p): float(np.percentile(x, p)) for p in PCTS},
        "histogram": {"counts": counts.tolist(),
                      "edges": [float(e) for e in edges]},
    }


def _pairwise_mean_l2(x: torch.Tensor) -> torch.Tensor:
    """The sum of sqrt(d2) over the whole (n, n) distance matrix over
    n (n - 1), as catgen computes it: the diagonal (zero up to f32
    cancellation) is summed, not excluded."""
    n = x.shape[0]
    return torch.sqrt(dist2_matrix(x, x)).sum() / (n * (n - 1))


def quality_report(g: nn.Module, d: nn.Module, corpus: torch.Tensor, *,
                   noise_dim: int = 100, n_samples: int = 1024,
                   seed: int = 42, v: Optional[nn.Module] = None,
                   copy_threshold: float = 1.0,
                   diversity_subset: int = 256,
                   normalized_inputs: bool = False,
                   noise: Optional[torch.Tensor] = None,
                   real_indices: Optional[torch.Tensor] = None,
                   permutation: Optional[torch.Tensor] = None
                   ) -> Dict[str, Any]:
    """The quality statistics of G and D (and V, if given).

    ``corpus``: (M, H, W, C) training images in [0, 1] on the models'
    device, also for a ``--normalize`` run (G's samples are sigmoid
    outputs in [0, 1], so the nearest-neighbour statistics need both sides
    there). ``normalized_inputs``: D was trained on reals in [-1, 1]; the
    corpus is remapped for D's real-score pass alone."""
    device = corpus.device
    generator = torch.Generator().manual_seed(seed)
    if noise is None:
        noise = gan.uniform_noise(generator, n_samples, noise_dim)
    n_real = min(n_samples, corpus.shape[0])
    if real_indices is None:
        real_indices = torch.randint(0, corpus.shape[0], (n_real,),
                                     generator=generator)
    if permutation is None:
        permutation = torch.randperm(n_samples, generator=generator)
    noise = noise.to(device)
    images = generate_batched(g, noise)
    order, scores = rank_by_d(d, images)
    scores_np = scores.double().cpu().numpy()

    d_reals = corpus[real_indices.to(device)]
    if normalized_inputs:
        d_reals = colorlib.normalize(d_reals)
    real_scores = rank_by_d(d, d_reals)[1].double().cpu().numpy()

    _, nn_dist = nearest_neighbours(images, corpus)
    nn_np = nn_dist.double().cpu().numpy()

    with torch.inference_mode():
        sub = images[permutation.to(device)[:diversity_subset]]
        pairwise = float(_pairwise_mean_l2(sub))
        per_pixel_std = float(images.float().std(dim=0, correction=0).mean())

    report: Dict[str, Any] = {
        "n_samples": int(n_samples),
        "corpus_size": int(corpus.shape[0]),
        "image_shape": [int(s) for s in images.shape[1:]],
        "d_scores_generated": _dist_stats(scores_np, hist_range=(0.0, 1.0)),
        "d_scores_real": _dist_stats(real_scores, hist_range=(0.0, 1.0)),
        "d_fooled_fraction": float((scores_np > 0.5).mean()),
        "nn_l2": _dist_stats(nn_np),
        "nn_copy_fraction": float((nn_np < copy_threshold).mean()),
        "diversity": {
            "mean_pairwise_l2": pairwise,
            "mean_per_pixel_std": per_pixel_std,
        },
        "finite": bool(torch.isfinite(images).all()),
    }

    if v is not None:
        top = min(50, n_samples)
        report["v_rating"] = {
            "all": float(v_trainer.rate_with_v(v, images)),
            "best50_by_d": float(v_trainer.rate_with_v(
                v, images[order[:top]])),
            "worst50_by_d": float(v_trainer.rate_with_v(
                v, images[order[-top:]])),
        }
    return report


def summarize(report: Dict[str, Any]) -> str:
    """One-screen human summary of a quality report."""
    dg, dr = report["d_scores_generated"], report["d_scores_real"]
    nn = report["nn_l2"]
    div = report["diversity"]
    lines = [
        f"samples: {report['n_samples']}  corpus: {report['corpus_size']}",
        f"D(generated): mean {dg['mean']:.4f}  std {dg['std']:.4f}  "
        f"p50 {dg['percentiles']['50']:.4f}",
        f"D(real):      mean {dr['mean']:.4f}  std {dr['std']:.4f}  "
        f"p50 {dr['percentiles']['50']:.4f}",
        f"D fooled fraction (score>0.5): {report['d_fooled_fraction']:.3f}",
        f"NN 2-norm: mean {nn['mean']:.3f}  p5 {nn['percentiles']['5']:.3f}  "
        f"p95 {nn['percentiles']['95']:.3f}  "
        f"copy-fraction {report['nn_copy_fraction']:.4f}",
        f"diversity: pairwise L2 {div['mean_pairwise_l2']:.3f}  "
        f"per-pixel std {div['mean_per_pixel_std']:.4f}",
    ]
    if "v_rating" in report:
        v = report["v_rating"]
        lines.append(f"V rating: all {v['all']:.4f}  "
                     f"best50 {v['best50_by_d']:.4f}  "
                     f"worst50 {v['worst50_by_d']:.4f}")
    return "\n".join(lines)
