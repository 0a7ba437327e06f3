"""The comparisons that decide ``correct``.

Training: both sides report, for the first three steps of one training
run from the same weights, reals and draws, (a) each step's D and G
losses (the program's twice: from one full-length epoch call and from
the calls of one step and two that go on into the window), (b) each
leaf's norm of the first gradient as the optimizer got it (Adam's first
moment after one step over 1 - beta1) and (c) each leaf's norm of its
change after three steps. The numbers:

  * ``loss``: the largest gap of a step's loss, over the reference's loss
    or 1, whichever is larger (a loss near 0 is compared absolutely);
  * ``grad1_d_median`` and ``grad1_d_worst``: the median and the largest
    over D's leaves of the gap between the two norms of (b), each over
    the reference's norm of that leaf or of the model's median leaf,
    whichever is larger: D's first gradient, from the initial weights;
  * ``grad1_g_median`` and ``grad1_g_worst``: the same over G's leaves.
    G's first gradient comes after D's first Adam step, which moves each
    element by +-lr by the sign of its gradient, so that D's elements
    whose gradient lies near round-off move either way on the two sides;
  * ``change3_median`` and ``change3_worst``: the median and the largest
    over the leaves of the same gap of (c), among the leaves whose
    reference gradient is at least a thousandth of the model's median
    leaf's (the others move under Adam by round-off alone).

The worst leaves after an Adam step are PReLU slopes and biases, single
sums over many products: their gaps are f32 round-off carried through
that step, as large between the reference in f32 and in float64 as
between the program and the reference (PERF.md gives the readings and the
limits each number holds).

Sampling: of a sample of requests drawn from the seed, every generated
image against the reference generator (``img``), every D score against
the reference discriminator's on the same image (``score``), how far the
reference's score of the program's j-th pick lies from the reference's
j-th best score (``rank``), and how far the program's nearest neighbour
and its distance lie from the true nearest in float64 (``nn``).
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Tuple

import torch

GRAD_FLOOR = 1e-3          # of the median leaf's reference gradient norm
LOSS_FLOOR = 1.0           # a loss below 1 is compared absolutely

Side = Tuple  # (losses, first-gradient norms, change norms[, losses])


def _by_model(norms: Dict[str, float]) -> Dict[str, List[str]]:
    out: Dict[str, List[str]] = {}
    for k in norms:
        out.setdefault(k.split("/", 1)[0], []).append(k)
    return out


def _gap(p: float, r: float, floor: float) -> float:
    """|p - r| over max(r, floor); 0 where both are exactly 0 (a leaf that
    neither side moved), infinite where only the program's is not."""
    den = max(r, floor)
    if den > 0:
        return abs(p - r) / den
    return 0.0 if p == r else float("inf")


def train_numbers(prog: Side, ref: Side) -> Tuple[Dict[str, float],
                                                  Dict[str, object]]:
    """Numbers of the program's side ``prog`` against the reference's
    ``ref``; each side is (losses, first-gradient norms, change norms),
    norms keyed ``"<g|d>/<leaf>"``, and the program's may add the losses
    of its full-length epoch call. Also returns, for the record, the
    worst leaf of each and the first step's loss alone."""
    lp, gp, cp = prog[:3]
    lr, gr, cr = ref[:3]
    gaps = [abs(a - b) / max(abs(b), LOSS_FLOOR)
            for side in (lp,) + tuple(prog[3:]) for a, b in zip(side, lr)]
    worst: Dict[str, object] = {"loss": gaps.index(max(gaps))}
    if len(prog) > 3:
        worst["epoch_loss_gap"] = max(gaps[len(lp):])
    numbers = {"loss": max(gaps)}
    change_gaps = {}
    for model, keys in sorted(_by_model(gr).items()):
        gmed = statistics.median(gr[k] for k in keys)
        grad_gaps = {k: _gap(gp[k], gr[k], gmed) for k in keys}
        numbers[f"grad1_{model}_median"] = statistics.median(
            grad_gaps.values())
        numbers[f"grad1_{model}_worst"] = max(grad_gaps.values())
        worst[f"grad1_{model}"] = max(grad_gaps, key=grad_gaps.get)
        moved = [k for k in keys if gr[k] >= GRAD_FLOOR * gmed and gr[k]]
        if moved:
            cmed = statistics.median(cr[k] for k in moved)
            for k in moved:
                change_gaps[k] = _gap(cp[k], cr[k], cmed)
    numbers["change3_median"] = (statistics.median(change_gaps.values())
                                 if change_gaps else 0.0)
    numbers["change3_worst"] = max(change_gaps.values(), default=0.0)
    worst["change3"] = (max(change_gaps, key=change_gaps.get)
                        if change_gaps else None)
    worst["loss1_gap"] = max(gaps[:2])
    return numbers, worst


def leaf_norms(tensors: Dict[str, torch.Tensor], prefix: str,
               scale: float = 1.0) -> Dict[str, float]:
    """Each tensor's L2 norm in float64, keyed ``prefix/<name>``."""
    if not tensors:
        return {}
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].double())
                         for k in names]).tolist()
    return {f"{prefix}/{k}": v * scale for k, v in zip(names, norms)}


def nn_truth(queries: torch.Tensor, corpus: torch.Tensor,
             block: int = 8192) -> torch.Tensor:
    """(Q, N) squared L2 distances in float64, the corpus in blocks."""
    q = queries.reshape(queries.shape[0], -1).double()
    out = []
    for i in range(0, corpus.shape[0], block):
        c = corpus[i:i + block].reshape(min(block, corpus.shape[0] - i),
                                        -1).double()
        out.append((q * q).sum(1)[:, None] + (c * c).sum(1)[None, :]
                   - 2.0 * q @ c.T)
    return torch.cat(out, 1).clamp_min(0.0)


def sample_numbers(images, scores, picks, nn_idx, nn_dist, ref_images,
                   ref_scores, corpus) -> Dict[str, float]:
    """One request's numbers. ``images`` (count, H, W, C), ``scores``
    (count,) and the ``picks`` (the best n, best first) are the program's;
    ``nn_idx`` and ``nn_dist`` its nearest neighbours of the picked
    images; ``ref_images`` the reference generator's images of the same
    noise and ``ref_scores`` the reference discriminator's scores of the
    program's images."""
    img = (images.double() - ref_images.double()).abs().max().item()
    score = (scores.double() - ref_scores.double()).abs().max().item()
    n = picks.shape[0]
    best = torch.topk(ref_scores.double(), n).values
    rank = (ref_scores.double()[picks] - best).abs().max().item()
    d2 = nn_truth(images[picks], corpus)
    nearest = d2.min(1).values.sqrt()
    chosen = d2.gather(1, nn_idx.long()[:, None])[:, 0].sqrt()
    miss = ((chosen - nearest) / nearest.clamp_min(1e-30)).max().item()
    dist = ((nn_dist.double() - chosen).abs()
            / chosen.clamp_min(1e-30)).max().item()
    return {"img": img, "score": score, "rank": rank, "nn": max(miss, dist)}
