"""The port's quality evaluation (catgen_torch/eval/quality.py,
cli/eval_quality.py) and checkpoint inspector (cli/show_ckpt.py) against
catgen's on the CPU.

``quality_report`` runs on the flagship pair and a V with catgen's
perturbed weights carried over, given catgen's own draws (reproduced here
with ``jax.random`` exactly as catgen's ``quality_report`` draws them:
the noise from ``PRNGKey(seed)``, the real indices from its
``fold_in(..., 1)``, the diversity permutation from its
``fold_in(..., 2)``). Tolerances, f32 on both sides: D scores within
1e-5 absolute; nearest-neighbour distances within 1e-5 relative (they
are ~16, square roots of ||a||^2 + ||b||^2 - 2 a.b from one f32 matmul
over 3072 values, whose terms are ~1000: their cancellation leaves
~1e-5 absolute between two summation orders); the pairwise L2 mean and the
per-pixel std within 1e-4 relative (sums of 32 x 32 and 64 x 3072 terms
in another order); histogram counts equal; V's ratings within 1e-5.

catgen's tests/test_eval.py cases are mirrored on the port (a G that
replays the corpus shows copy fraction 1, a collapsed G zero diversity,
the pairwise mean of one pair, the CLI's JSON on a fixture), and
``show_ckpt`` prints catgen's output byte for byte for a checkpoint
written by either package.
"""

import contextlib
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from catgen import models as cmodels
from catgen.cli import show_ckpt as cshow
from catgen.eval import quality as cquality
from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen_torch import models as tmodels
from catgen_torch.cli import eval_quality as eval_cli
from catgen_torch.cli import show_ckpt as tshow
from catgen_torch.cli import train as train_cli
from catgen_torch.eval import quality as tquality
from catgen_torch.io.convert import catgen_to_state_dict
from catgen_torch.nn import layers as tl
from catgen_torch.core.module import Sequential as TSequential
from catgen_torch.train import harness as tharness

from torch_port_helpers import (IMG, NOISE_DIM, catgen_pair, np_tree,
                                perturb, port_pair)

N_SAMPLES, SUBSET, SEED = 64, 32, 3


def catgen_draws(seed, n_samples, noise_dim, corpus_size):
    """catgen's quality_report draws: noise, real indices, permutation."""
    rng = jax.random.PRNGKey(seed)
    noise = cgan.uniform_noise(rng, n_samples, noise_dim)
    ridx = jax.random.randint(jax.random.fold_in(rng, 1),
                              (min(n_samples, corpus_size),), 0, corpus_size)
    perm = jax.random.permutation(jax.random.fold_in(rng, 2), n_samples)
    return {"noise": torch.tensor(np.asarray(noise)),
            "real_indices": torch.tensor(np.asarray(ridx)).long(),
            "permutation": torch.tensor(np.asarray(perm)).long()}


@pytest.fixture(scope="module")
def reports():
    """catgen's and the port's report on the same weights, corpus and
    draws, with D trained on [0, 1] and on [-1, 1] reals."""
    g, d, gv, dv = catgen_pair(seed=5)
    tg, td = port_pair(gv, dv)
    cv = cmodels.create_V(IMG)
    vv = np_tree(cv.init(jax.random.PRNGKey(6), (1,) + IMG))
    perturb(vv, np.random.RandomState(6))
    tv = tmodels.create_V(IMG)
    tv.load_state_dict(catgen_to_state_dict(vv["params"], vv["state"]),
                       strict=True)
    corpus = np.random.RandomState(7).rand(96, *IMG).astype(np.float32)
    out = {}
    for normalized in (False, True):
        want = cquality.quality_report(
            g, d, gv, dv, jnp.asarray(corpus), noise_dim=NOISE_DIM,
            n_samples=N_SAMPLES, seed=SEED, v=cv, v_vars=vv,
            diversity_subset=SUBSET, normalized_inputs=normalized)
        got = tquality.quality_report(
            tg, td, torch.tensor(corpus), noise_dim=NOISE_DIM,
            n_samples=N_SAMPLES, seed=SEED, v=tv, diversity_subset=SUBSET,
            normalized_inputs=normalized,
            **catgen_draws(SEED, N_SAMPLES, NOISE_DIM, len(corpus)))
        out[normalized] = (got, want)
    return out


def _stats_close(got, want, atol, rtol=0.0):
    assert got["n"] == want["n"]
    for k in ("mean", "std", "min", "max"):
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=atol,
                                   err_msg=k)
    for p, v in want["percentiles"].items():
        np.testing.assert_allclose(got["percentiles"][p], v, rtol=rtol,
                                   atol=atol, err_msg=p)
    assert got["histogram"]["counts"] == want["histogram"]["counts"]
    np.testing.assert_allclose(got["histogram"]["edges"],
                               want["histogram"]["edges"], rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("normalized", [False, True])
def test_report_matches_catgen(reports, normalized):
    got, want = reports[normalized]
    assert set(got) == set(want)
    for k in ("n_samples", "corpus_size", "image_shape", "finite"):
        assert got[k] == want[k], k
    for k in ("d_scores_generated", "d_scores_real"):
        _stats_close(got[k], want[k], atol=1e-5)
    _stats_close(got["nn_l2"], want["nn_l2"], atol=0.0, rtol=1e-5)
    for k in ("d_fooled_fraction", "nn_copy_fraction"):
        assert got[k] == want[k], k
    for k, v in want["diversity"].items():
        np.testing.assert_allclose(got["diversity"][k], v, rtol=1e-4,
                                   err_msg=k)
    for k, v in want["v_rating"].items():
        np.testing.assert_allclose(got["v_rating"][k], v, rtol=0, atol=1e-5,
                                   err_msg=k)
    # the scores spread, so the comparison holds something
    assert want["d_scores_generated"]["std"] > 1e-4
    assert want["nn_l2"]["std"] > 1e-3
    assert got["finite"] is True
    json.dumps(got)


def test_real_scores_see_normalized_reals(reports):
    """With ``normalized_inputs`` only D's real-score pass changes."""
    plain, normalized = reports[False][0], reports[True][0]
    assert plain["d_scores_real"] != normalized["d_scores_real"]
    for k in ("d_scores_generated", "nn_l2", "diversity", "v_rating"):
        assert plain[k] == normalized[k], k


def test_summary_matches_catgen(reports):
    got, want = reports[False]
    assert tquality.summarize(got).splitlines()[0] == \
        cquality.summarize(want).splitlines()[0]
    assert len(tquality.summarize(got).splitlines()) == len(
        cquality.summarize(want).splitlines()) == 7


def test_port_draws_its_own_from_the_seed():
    """Without explicit draws the report is a function of the seed."""
    g, d = _tiny()
    corpus = torch.rand(32, *TINY)
    a, b, c = (tquality.quality_report(g, d, corpus, noise_dim=TINY_NOISE,
                                       n_samples=16, seed=s,
                                       diversity_subset=8)
               for s in (1, 1, 2))
    assert a == b and a != c


# ---------------------------------------------------------------------------
# catgen's tests/test_eval.py, on the port
# ---------------------------------------------------------------------------

TINY = (8, 8, 1)
TINY_NOISE = 8


def _tiny():
    h, w, c = TINY
    g = TSequential([tl.Dense(TINY_NOISE, 16), tl.PReLU(),
                     tl.Dense(16, h * w * c), tl.Sigmoid(),
                     tl.Reshape(TINY)], name="g")
    d = TSequential([tl.Flatten(), tl.Dense(h * w * c, 16), tl.PReLU(),
                     tl.Dense(16, 1), tl.Sigmoid()], name="d")
    gen = torch.Generator().manual_seed(0)
    for m in (g, d):
        for p in m.parameters():
            with torch.no_grad():
                p.uniform_(-0.5, 0.5, generator=gen)
    return g, d


class _Constant(nn.Module):
    """A G whose output ignores the noise: ``make(x)``."""

    def __init__(self, make):
        super().__init__()
        self.make = make

    def forward(self, x):
        return self.make(x)


def test_report_structure_and_sanity():
    g, d = _tiny()
    corpus = torch.rand(32, *TINY, generator=torch.Generator().manual_seed(1))
    rep = tquality.quality_report(g, d, corpus, noise_dim=TINY_NOISE,
                                  n_samples=64, diversity_subset=32)
    assert rep["n_samples"] == 64 and rep["corpus_size"] == 32
    for key in ("d_scores_generated", "d_scores_real"):
        s = rep[key]
        assert 0.0 <= s["mean"] <= 1.0
        assert sum(s["histogram"]["counts"]) == s["n"]
        assert s["percentiles"]["5"] <= s["percentiles"]["95"]
    assert rep["d_scores_real"]["n"] == 32      # min(n_samples, corpus)
    assert rep["nn_l2"]["n"] == 64 and rep["nn_l2"]["mean"] >= 0
    assert 0.0 <= rep["nn_copy_fraction"] < 0.5
    assert rep["diversity"]["mean_pairwise_l2"] > 0
    assert rep["finite"] is True
    json.dumps(rep)
    assert "D(generated)" in tquality.summarize(rep)


def test_copy_fraction_detects_memorization():
    """A G that replays corpus images shows copy fraction 1 and NN
    distance ~0: the square root of the f32 cancellation in ||a||^2 +
    ||b||^2 - 2 a.b, ~1e-3 at 64 values in [0, 1] in either package
    (catgen's dist2_matrix gives 6e-4 on these images, the port 1.1e-3),
    against the 1.0 of the copy threshold."""
    _, d = _tiny()
    corpus = torch.rand(32, *TINY, generator=torch.Generator().manual_seed(2))
    replay = _Constant(lambda x: corpus[torch.arange(x.shape[0])
                                        % corpus.shape[0]])
    rep = tquality.quality_report(replay, d, corpus, noise_dim=TINY_NOISE,
                                  n_samples=16, diversity_subset=8)
    assert rep["nn_copy_fraction"] == 1.0
    assert rep["nn_l2"]["mean"] < 1e-2


def test_collapse_shows_zero_diversity():
    """Mode collapse: a constant G output gives pairwise L2 and per-pixel
    std ~0."""
    _, d = _tiny()
    corpus = torch.rand(32, *TINY, generator=torch.Generator().manual_seed(3))
    flat = _Constant(lambda x: torch.full((x.shape[0],) + TINY, 0.5))
    rep = tquality.quality_report(flat, d, corpus, noise_dim=TINY_NOISE,
                                  n_samples=32, diversity_subset=16)
    assert rep["diversity"]["mean_pairwise_l2"] < 1e-5
    assert rep["diversity"]["mean_per_pixel_std"] < 1e-5


def test_pairwise_mean_l2_sums_the_whole_matrix():
    """catgen's formula: the sum of sqrt(d2) over every pair, the diagonal
    included, over n (n - 1). One pair at distance 5 gives 5; the
    diagonal's cancellation noise is summed as catgen sums it, and its
    square roots (~sqrt(eps) x ||x||, each package its own) keep the two
    within 1e-4 relative, as in the report."""
    x = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
    assert abs(float(tquality._pairwise_mean_l2(x)) - 5.0) < 1e-5
    y = np.random.RandomState(4).rand(9, 3, 4, 2).astype(np.float32) * 50
    np.testing.assert_allclose(
        float(tquality._pairwise_mean_l2(torch.tensor(y))),
        float(cquality._pairwise_mean_l2(jnp.asarray(y))), rtol=1e-4)


def test_cli_eval_quality(tmp_path):
    """One epoch of training on the fixture, then the eval CLI rebuilds the
    models from the checkpoint's metadata and writes its JSON."""
    save = str(tmp_path / "logs")
    train_cli.main(["--device", "cpu", "--fixture", "16", "--epochs", "1",
                    "--batchSize", "8", "--N_epoch", "32", "--save", save])
    rep = eval_cli.main(["--device", "cpu", "--save", save, "--samples",
                         "32"])
    assert rep["epoch"] >= 1 and "v_rating" not in rep
    with open(tmp_path / "logs" / "quality_report.json") as f:
        loaded = json.load(f)
    assert loaded["n_samples"] == 32 and loaded["corpus_size"] == 16
    assert loaded["checkpoint"] == os.path.join(save, "adversarial.ckpt")
    assert loaded == json.loads(json.dumps(rep))


# ---------------------------------------------------------------------------
# show_ckpt
# ---------------------------------------------------------------------------


def _stdout(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("writer", ["catgen", "port"])
@pytest.mark.parametrize("full", [False, True])
def test_show_ckpt_prints_catgens_output(tmp_path, writer, full):
    path = str(tmp_path / "v.ckpt")
    v = cmodels.create_V((16, 16, 3))
    vv = np_tree(v.init(jax.random.PRNGKey(0), (1, 16, 16, 3)))
    if writer == "catgen":
        cckpt.save(path, vv, {"epoch": 4, "note": "catgen"})
    else:
        tv = tmodels.create_V((16, 16, 3))
        tv.load_state_dict(catgen_to_state_dict(vv["params"], vv["state"]))
        tharness.save_variables(tv, path, {"epoch": 4, "note": "port"})
    argv = [path] + (["--full"] if full else [])
    got, want = _stdout(tshow.main, argv), _stdout(cshow.main, argv)
    assert got == want
    assert "TOTAL" in got and '"epoch": 4' in got
