"""The sampling slice end to end on the CPU: the same noise through
catgen's generate_batched -> rank_by_d -> nearest_neighbours and through
the port's, with the flagship pair at full width and one set of weights;
then the port's CLI on a checkpoint that catgen wrote.

The noise comes from the port's own uniform_noise with a torch.Generator
of seed SEED, which is what the port's CLI draws for --seed SEED, so the
CLI's images can be held against catgen's too.

Tolerances: images and scores atol 1e-5 (f32 on both sides, summation
order only); NN distances rtol 1e-4 (the one-matmul expansion
|a|^2 + |b|^2 - 2ab cancels); NN indices equal wherever the nearest and
the second-nearest distance differ by more than that tolerance.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.data.loader import ImageDataset as CImageDataset
from catgen.io import checkpoint as cckpt
from catgen.sample import sampler as csampler
from catgen.train import gan as cgan
from catgen.train.harness import HarnessConfig
from catgen_torch.cli import sample as tcli
from catgen_torch.data.fixture import write_fixture_dataset
from catgen_torch.data.loader import ImageDataset as TImageDataset
from catgen_torch.sample import sampler as tsampler
from catgen_torch.train import gan as tgan

from torch_port_helpers import IMG, NOISE_DIM, catgen_pair, port_pair

SEED = 5
COUNT = 8
BATCH = 4
N_CORPUS = 24
ATOL = 1e-5
NN_RTOL = 1e-4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    save = tmp_path_factory.mktemp("slice")
    g, d, gv, dv = catgen_pair(seed=7)
    state = cgan.ckpt_template(g, d, cgan.GanConfig(), jax.random.PRNGKey(0),
                               IMG)
    state = state._replace(g_params=gv["params"], g_state=gv["state"],
                           d_params=dv["params"], d_state=dv["state"])
    cckpt.save(str(save / "adversarial.ckpt"), state,
               {"config": dataclasses.asdict(HarnessConfig())})
    fixture = str(save / "fixture")
    write_fixture_dataset(fixture, n=N_CORPUS)
    noise = tgan.uniform_noise(torch.Generator().manual_seed(SEED), COUNT,
                               NOISE_DIM).numpy()
    images = csampler.generate_batched(g, gv, jnp.asarray(noise),
                                       batch_size=BATCH)
    order, scores = csampler.rank_by_d(d, dv, images, batch_size=BATCH)
    corpus = CImageDataset([fixture], decoder="pil").load_images(0, N_CORPUS)
    idx, dist = csampler.nearest_neighbours(images[order], corpus)
    tg, td = port_pair(gv, dv)
    return {"save": str(save), "fixture": fixture, "noise": noise,
            "images": np.asarray(images), "order": np.asarray(order),
            "scores": np.asarray(scores), "corpus": np.asarray(corpus),
            "idx": np.asarray(idx), "dist": np.asarray(dist),
            "tg": tg, "td": td}


def _assert_scores_order(scores, order, want_scores, want_order):
    np.testing.assert_allclose(scores, want_scores, rtol=0, atol=ATOL)
    gaps = np.diff(np.sort(want_scores))
    assert gaps.min() > 2 * ATOL, "scores too close for a defined order"
    np.testing.assert_array_equal(order, want_order)


def _assert_neighbours(idx, dist, queries, corpus, want_idx, want_dist):
    np.testing.assert_allclose(dist, want_dist, rtol=NN_RTOL)
    d = np.sqrt(((queries.reshape(len(queries), 1, -1)
                  - corpus.reshape(1, len(corpus), -1)) ** 2).sum(-1))
    two = np.sort(d, axis=1)[:, :2]
    clear = (two[:, 1] - two[:, 0]) > NN_RTOL * two[:, 1]
    assert clear.any()
    np.testing.assert_array_equal(idx[clear], want_idx[clear])


def test_generate_batched_matches_catgen(run):
    got = tsampler.generate_batched(
        run["tg"], torch.tensor(run["noise"]), batch_size=BATCH).numpy()
    np.testing.assert_allclose(got, run["images"], rtol=0, atol=ATOL)


def test_rank_by_d_matches_catgen(run):
    order, scores = tsampler.rank_by_d(
        run["td"], torch.tensor(run["images"]), batch_size=BATCH)
    _assert_scores_order(scores.numpy(), order.numpy(), run["scores"],
                         run["order"])


def test_corpus_matches_catgen(run):
    got = TImageDataset([run["fixture"]]).load_images(0, N_CORPUS).numpy()
    np.testing.assert_allclose(got, run["corpus"], rtol=0, atol=1e-6)


def test_nearest_neighbours_match_catgen(run):
    queries = run["images"][run["order"]]
    idx, dist = tsampler.nearest_neighbours(torch.tensor(queries),
                                            torch.tensor(run["corpus"]))
    _assert_neighbours(idx.numpy(), dist.numpy(), queries, run["corpus"],
                       run["idx"], run["dist"])


def test_sample_cli_on_a_catgen_checkpoint(run):
    runs = tcli.main(["--device", "cpu", "--save", run["save"],
                      "--count", str(COUNT), "--neighbours",
                      "--seed", str(SEED)])
    assert len(runs) == 1
    result = runs[0]
    np.testing.assert_allclose(result["images"].numpy(), run["images"],
                               rtol=0, atol=ATOL)
    _assert_scores_order(result["scores"].numpy(), result["order"].numpy(),
                         run["scores"], run["order"])
    nb = result["neighbours"]
    _assert_neighbours(nb["indices"].numpy(), nb["distances"].numpy(),
                       nb["queries"].numpy(), run["corpus"], run["idx"],
                       run["dist"])
    out = os.path.join(run["save"], "samples")
    for name in ("real64", "random256", f"random{COUNT}", "best64",
                 "worst64", "neighbours"):
        assert os.path.getsize(os.path.join(out, f"run0_{name}.png")) > 0


def test_sample_cli_refuses_a_missing_card(run, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        tcli.main(["--save", run["save"], "--count", "4"])
