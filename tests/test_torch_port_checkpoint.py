"""The port's checkpoint reader and writer against catgen's format: catgen
writes an adversarial checkpoint of the flagship pair, the port reads it,
and what the port writes back has catgen's keys and values."""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen.train.harness import HarnessConfig
from catgen_torch.cli.sample import ModelConfig, load_gan
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.io.convert import gan_to_leaves

from torch_port_helpers import IMG, catgen_pair

MODEL_ATTRS = ("g_params", "g_state", "d_params", "d_state")
Models = collections.namedtuple("Models", MODEL_ATTRS)


@pytest.fixture(scope="module")
def written(tmp_path_factory):
    g, d, gv, dv = catgen_pair(seed=3)
    state = cgan.ckpt_template(g, d, cgan.GanConfig(), jax.random.PRNGKey(0),
                               IMG)
    state = state._replace(g_params=gv["params"], g_state=gv["state"],
                           d_params=dv["params"], d_state=dv["state"])
    path = str(tmp_path_factory.mktemp("ckpt") / "adversarial.ckpt")
    meta = {"epoch": 7, "config": dataclasses.asdict(
        HarnessConfig(g_model="g32up_c", d_model="d32_st3"))}
    cckpt.save(path, state, meta)
    leaves = cckpt._flatten(state)
    return path, state, leaves


def test_port_writes_back_catgen_keys_and_values(written):
    path, _, leaves = written
    g, d, config = load_gan(path, torch.device("cpu"))
    assert config == ModelConfig(g_model="g32up_c", d_model="d32_st3")
    back = gan_to_leaves(g, d)
    want = {k: v for k, v in leaves.items()
            if tckpt.attr_of(k) in MODEL_ATTRS}
    assert set(back) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_port_written_checkpoint_loads_in_catgen(written, tmp_path):
    path, state, leaves = written
    g, d, _ = load_gan(path, torch.device("cpu"))
    out = str(tmp_path / "port.ckpt")
    tckpt.save(out, gan_to_leaves(g, d), tckpt.load_meta(path))
    template = Models(state.g_params, state.g_state, state.d_params,
                      state.d_state)
    restored, meta = cckpt.load(out, template)
    assert meta["config"]["g_model"] == "g32up_c"
    assert meta["format_version"] == cckpt.FORMAT_VERSION
    for k, v in cckpt._flatten(restored).items():
        np.testing.assert_array_equal(v, leaves[k], err_msg=k)


def test_optimizer_leaves_are_not_read(written):
    path, _, leaves = written
    assert any(k.startswith(".d_opt") for k in leaves)
    got, meta = tckpt.load(path, ("d_params",))
    assert got and all(k.startswith(".d_params[") for k in got)
    assert meta["epoch"] == 7


def test_key_spelling_round_trips(written):
    _, _, leaves = written
    for k in leaves:
        if tckpt.attr_of(k) in MODEL_ATTRS:
            assert tckpt.key(*tckpt.parse_key(k)) == k
    assert tckpt.attr_of(".g_opt.step") == "g_opt"
    for bad in ("g_params/00_Dense/kernel", ".g_opt.step"):
        with pytest.raises(ValueError):
            tckpt.parse_key(bad)


def test_legacy_archive_raises(tmp_path):
    path = str(tmp_path / "legacy.ckpt")
    cckpt.save(path, {"d_params": {"00_SpatialTransformer": {
        "head": {"bias": np.zeros(1, np.float32)}}}}, {"epoch": 1})
    with pytest.raises(ValueError, match="round-3"):
        tckpt.load(path, MODEL_ATTRS)


def test_save_keeps_the_previous_file(tmp_path):
    path = str(tmp_path / "a.ckpt")
    leaf = ".g_params['00_Dense']['bias']"
    tckpt.save(path, {leaf: np.zeros(2, np.float32)}, {"epoch": 1})
    tckpt.save(path, {leaf: np.ones(2, np.float32)}, {"epoch": 2})
    assert tckpt.load_meta(path + ".old")["epoch"] == 1
    got, meta = tckpt.load(path, ("g_params",))
    assert meta["epoch"] == 2 and got[leaf].tolist() == [1.0, 1.0]
