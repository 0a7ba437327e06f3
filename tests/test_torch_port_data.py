"""The training slice's data and bookkeeping pieces against catgen's: the
[-1, 1] remap, train-time augmentation with catgen's draws handed in, the
per-epoch batches and family ids of the loader, the nearest-neighbour
statistics of the visualization, and the copied collapse statistics and
metrics logger. f32; tolerances stated per test."""

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catgen.data import color as ccolor
from catgen.data import ops as cops
from catgen.data.fixture import write_fixture_dataset
from catgen.data.loader import ImageDataset as CDataset
from catgen.eval import collapse as ccollapse
from catgen.io import metrics as cmetrics
from catgen.sample import sampler as csampler
from catgen_torch.data import color as tcolor
from catgen_torch.data import ops as tops
from catgen_torch.data.loader import ImageDataset as TDataset
from catgen_torch.eval import collapse as tcollapse
from catgen_torch.io import metrics as tmetrics
from catgen_torch.sample import sampler as tsampler

from torch_port_helpers import ReplayDraws, record_jax_draws


def test_normalize_round_trip_matches_catgen():
    x = np.random.RandomState(0).uniform(-0.2, 1.2, (2, 4, 4, 3)).astype(
        np.float32)
    for c_fn, t_fn in ((ccolor.normalize, tcolor.normalize),
                       (ccolor.denormalize, tcolor.denormalize)):
        np.testing.assert_array_equal(t_fn(torch.tensor(x)).numpy(),
                                      np.asarray(c_fn(jnp.asarray(x))))


@pytest.mark.parametrize("hw", [(32, 32), (16, 24)])
def test_augment_batch_matches_catgen(hw):
    # catgen's draws replayed; its CPU warp is the XLA sampler, the port's
    # the plain sampler: f32, atol 1e-5 (the grids' einsums round alike)
    x = np.random.RandomState(1).rand(3, *hw, 3).astype(np.float32)
    with record_jax_draws() as draws:
        want = np.asarray(cops.augment_batch(jax.random.PRNGKey(2),
                                             jnp.asarray(x)))
    assert [k for k, _ in draws] == ["uniform"] * 4 + ["bernoulli",
                                                       "uniform", "normal"]
    replay = ReplayDraws(draws)
    got = tops.augment_batch(replay, torch.tensor(x)).numpy()
    assert not replay.records
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    write_fixture_dataset(str(root), n=12)
    return str(root)


@pytest.mark.parametrize("normalize", [False, True])
def test_epoch_batches_are_catgens(corpus, normalize):
    # the same numpy stream and the same PIL decode: the same reals
    c = CDataset([corpus], seed=3, decoder="pil", normalize=normalize)
    t = TDataset([corpus], seed=3, normalize=normalize)
    want = np.asarray(c.epoch_batches(10, 2, d_iterations=2))
    got = t.epoch_batches(10, 2, d_iterations=2)
    assert got.shape == want.shape == (5, 4, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(t.family_ids(0, 12), c.family_ids(0, 12))


def test_family_ids_group_augmented_crops(tmp_path):
    from PIL import Image

    for name in ("7_0", "7_1", "9_0", "cat"):
        Image.new("RGB", (64, 64)).save(tmp_path / f"{name}.jpg")
    ids = TDataset([str(tmp_path)]).family_ids(0, 4)
    assert ids[0] == ids[1] == 7 and ids[2] == 9 and ids[3] < 0


def test_nn_statistics_match_catgen():
    rng = np.random.RandomState(4)
    q = rng.rand(5, 8, 8, 3).astype(np.float32)
    c = rng.rand(9, 8, 8, 3).astype(np.float32)
    fam = np.array([1, 1, 2, 3, 3, 3, 4, 5, 6])
    np.testing.assert_allclose(
        float(tsampler.nn_l2_mean(torch.tensor(q), torch.tensor(c))),
        float(csampler.nn_l2_mean(jnp.asarray(q), jnp.asarray(c))),
        rtol=1e-5)
    for families in (None, fam):
        np.testing.assert_allclose(
            float(tsampler.self_nn_mean(torch.tensor(c), families)),
            float(csampler.self_nn_mean(jnp.asarray(c), families)),
            rtol=1e-5)


def test_copied_statistics_and_logger_match_catgen(tmp_path):
    x = np.random.RandomState(5).rand(6, 4, 4, 3).astype(np.float32)
    assert tcollapse.sat_fraction(x) == ccollapse.sat_fraction(x)
    assert tcollapse.per_pixel_std(x) == ccollapse.per_pixel_std(x)
    assert tmetrics.confusion_summary(3, 4, 1, 2) == \
        cmetrics.confusion_summary(3, 4, 1, 2)
    outs = []
    for mod in (cmetrics, tmetrics):
        path = tmp_path / f"{mod.__name__}.jsonl"
        buf = io.StringIO()
        with redirect_stdout(buf):
            log = mod.MetricsLogger(str(path))
            rec = log.log("epoch", loss_d=0.123456789, epoch=2)
            log.close()
        line = json.loads(path.read_text())
        assert line["ts"] == rec["ts"]
        del line["ts"]
        outs.append((line, buf.getvalue()))
    assert outs[0] == outs[1]
