"""Sampler: batch generation, D-ranking, nearest-neighbour search. The
counterpart of ``catgen/sample/sampler.py``.

  * generate ``count`` images through G, in batches;
  * rank them with D, keep best / worst / random sets;
  * find the nearest training image of each of the best 16 by L2, as one
    (16, D) x (D, N) matmul and an argmin.

Everything runs under ``torch.inference_mode()`` on the device the models
and the corpus are on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from catgen_torch.train import gan


def generate_batched(g: nn.Module, noise: torch.Tensor,
                     batch_size: int = 256) -> torch.Tensor:
    """G forward in chunks of ``batch_size``."""
    outs = [gan.generate(g, noise[i:i + batch_size])
            for i in range(0, noise.shape[0], batch_size)]
    return torch.cat(outs, dim=0)


def rank_by_d(d: nn.Module, images: torch.Tensor,
              batch_size: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (order, scores): ``order`` indexes images best-first (the
    highest D score, most real, first; ties keep their order)."""
    scores = torch.cat([gan.discriminate(d, images[i:i + batch_size])
                        for i in range(0, images.shape[0], batch_size)])
    order = torch.argsort(-scores, stable=True)
    return order, scores


def dist2_matrix(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Squared-L2 distance matrix as one matmul:
    ||a-b||^2 = ||a||^2 + ||b||^2 - 2 a.b, f32, clamped at 0."""
    q = queries.reshape(queries.shape[0], -1).float()
    c = corpus.reshape(corpus.shape[0], -1).float()
    q2 = (q * q).sum(dim=1, keepdim=True)
    c2 = (c * c).sum(dim=1)[None, :]
    return torch.clamp(q2 + c2 - 2.0 * torch.matmul(q, c.T), min=0.0)


def nearest_neighbours(queries: torch.Tensor, corpus: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each query image, the index and L2 distance of its closest
    corpus image."""
    with torch.inference_mode():
        d2 = dist2_matrix(queries, corpus)
        idx = torch.argmin(d2, dim=1)
        dist = torch.sqrt(torch.gather(d2, 1, idx[:, None])[:, 0])
    return idx, dist


def nn_l2_mean(queries: torch.Tensor, corpus: torch.Tensor) -> torch.Tensor:
    """Mean L2 distance of each query to its nearest corpus image."""
    return torch.sqrt(dist2_matrix(queries, corpus).min(dim=1).values).mean()


def self_nn_mean(images: torch.Tensor, families=None) -> torch.Tensor:
    """Mean leave-one-out nearest-neighbour distance of a set to itself,
    the normalizer of the harness's ``nn_l2_ratio``. ``families``
    (integer array (N,)) excludes same-family pairs too: on an offline-
    augmented corpus each crop's nearest neighbour is one of its own warp
    variants."""
    d2 = dist2_matrix(images, images)
    if families is not None:
        fam = torch.as_tensor(families, device=d2.device)
        same = fam[:, None] == fam[None, :]
    else:
        same = torch.eye(images.shape[0], dtype=torch.bool,
                         device=d2.device)
    d2 = torch.where(same, torch.full_like(d2, float("inf")), d2)
    return torch.sqrt(d2.min(dim=1).values).mean()


def sample_and_rank(g: nn.Module, d: nn.Module, generator: torch.Generator,
                    noise_dim: int = 100, count: int = 1024, top: int = 64,
                    device: Optional[torch.device] = None) -> dict:
    """The full sample run: returns a dict with 'images', 'scores',
    'order', 'best', 'worst', 'random'. Noise and the random pick are drawn
    from ``generator``; the models run on ``device``."""
    noise = gan.uniform_noise(generator, count, noise_dim, device)
    images = generate_batched(g, noise)
    order, scores = rank_by_d(d, images)
    rand_idx = torch.randperm(count, generator=generator,
                              device=generator.device)[:top]
    return {
        "images": images, "scores": scores, "order": order,
        "best": images[order[:top]], "worst": images[order[-top:]],
        "random": images[rand_idx.to(images.device)],
    }


def neighbours_of_best(result: dict, corpus: torch.Tensor,
                       n_best: int = 16) -> dict:
    """NN search of the best ``n_best`` images against the corpus.
    Returns pairs for the grid writer."""
    queries = result["best"][:n_best]
    idx, dist = nearest_neighbours(queries, corpus)
    return {"queries": queries, "matches": corpus[idx],
            "indices": idx, "distances": dist}


def interleave_pairs(queries: torch.Tensor,
                     matches: torch.Tensor) -> torch.Tensor:
    """(N,H,W,C) + (N,H,W,C) -> (2N,H,W,C), query and match alternating."""
    n = queries.shape[0]
    out = torch.stack([queries, matches], dim=1)
    return out.reshape((2 * n,) + tuple(queries.shape[1:]))
