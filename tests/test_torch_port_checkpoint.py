"""The port's checkpoint reader and writer against catgen's format: catgen
writes an adversarial checkpoint of the flagship pair, the port reads it,
and what the port writes back has catgen's keys and values; the same for
a whole train state, both ways, leaf for leaf."""

import collections
import dataclasses

import jax
import numpy as np
import pytest
import torch

from catgen.io import checkpoint as cckpt
from catgen.train import gan as cgan
from catgen.train.harness import HarnessConfig
from catgen_torch import models as tmodels
from catgen_torch.cli.sample import ModelConfig, load_gan
from catgen_torch.io import checkpoint as tckpt
from catgen_torch.io.convert import (gan_to_leaves, train_state_from_leaves,
                                     train_state_to_leaves)
from catgen_torch.train import gan as tgan

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
    assert tckpt.parse_key(".g_opt.step") == ("g_opt.step", ())
    assert tckpt.parse_key(".d_opt.m['00_A']['kernel']") == (
        "d_opt.m", ("00_A", "kernel"))
    for bad in ("g_params/00_Dense/kernel", ".g_opt.[0]", "g_opt.step"):
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


# -- the whole train state (models, both optimizers, the gate) -------------


def _catgen_train_state(seed):
    """catgen's checkpoint template of the flagship pair with every leaf
    filled from a seeded stream (ints for counters)."""
    g, d, _, _ = catgen_pair(seed=seed)
    template = cgan.ckpt_template(g, d, cgan.GanConfig(),
                                  jax.random.PRNGKey(0), IMG)
    rng = np.random.RandomState(seed)

    def fill(x):
        x = np.asarray(x)
        if np.issubdtype(x.dtype, np.integer):
            return rng.randint(1, 50, x.shape).astype(x.dtype)
        return rng.randn(*x.shape).astype(x.dtype)

    return template, jax.tree_util.tree_map(fill, template)


def _port_train_state():
    g = tmodels.create_G_decoder_upsampling32c(IMG, 100)
    d = tmodels.create_D32_st3(IMG)
    return tgan.init_state(g, d, tgan.GanConfig())


def test_train_state_catgen_to_port_to_catgen(tmp_path):
    template, state = _catgen_train_state(seed=4)
    first = str(tmp_path / "catgen.ckpt")
    cckpt.save(first, state, {"epoch": 3})
    port = _port_train_state()
    leaves, _ = tckpt.load_like(first, train_state_to_leaves(port))
    train_state_from_leaves(port, leaves)
    assert port.epoch == int(state.epoch) and port.step == int(state.step)
    back = str(tmp_path / "port.ckpt")
    tckpt.save(back, train_state_to_leaves(port), {"epoch": port.epoch})
    restored, _ = cckpt.load(back, template)
    want = cckpt._flatten(state)
    got = cckpt._flatten(restored)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k


def test_train_state_port_to_catgen_to_port(tmp_path):
    port = _port_train_state()
    rng = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for t in list(port.g.state_dict().values()) + list(
                port.d.state_dict().values()):
            t.copy_(torch.randn(t.shape, generator=rng))
    for opt in (port.g_opt, port.d_opt):
        for k in opt.m:
            opt.m[k].copy_(torch.randn(opt.m[k].shape, generator=rng))
            opt.v[k].copy_(torch.rand(opt.v[k].shape, generator=rng))
        opt.step.fill_(7)
    port.acc_buffer.copy_(torch.rand(port.acc_buffer.shape, generator=rng))
    port.acc_count, port.acc_index, port.step, port.epoch = 20, 3, 70, 4
    written = train_state_to_leaves(port)
    first = str(tmp_path / "port.ckpt")
    tckpt.save(first, written, {"epoch": port.epoch})
    template, _ = _catgen_train_state(seed=6)
    restored, _ = cckpt.load(first, template)
    second = str(tmp_path / "catgen.ckpt")
    cckpt.save(second, restored, {"epoch": 4})
    again = _port_train_state()
    leaves, _ = tckpt.load_like(second, train_state_to_leaves(again))
    train_state_from_leaves(again, leaves)
    back = train_state_to_leaves(again)
    assert set(back) == set(written) == set(cckpt._flatten(template))
    for k in written:
        np.testing.assert_array_equal(back[k], written[k], err_msg=k)


def test_lenient_leaves_reinitialize(tmp_path):
    # a gate window of another size re-initializes the gate (catgen's
    # resume); a missing optimizer leaf raises unless it is lenient too
    port = _port_train_state()
    leaves = train_state_to_leaves(port)
    leaves[".acc_buffer"] = np.ones(7, np.float32)
    del leaves[".d_opt.step"]
    path = str(tmp_path / "a.ckpt")
    tckpt.save(path, leaves, {"epoch": 1})
    template = train_state_to_leaves(port)
    with pytest.raises(KeyError, match="d_opt.step"):
        tckpt.load_like(path, template, ("acc_buffer",))
    with pytest.warns(UserWarning, match="re-initialized 2"):
        got, meta = tckpt.load_like(path, template,
                                    ("acc_buffer", "d_opt"))
    assert set(meta["_reinitialized"]) == {".d_opt.step", ".acc_buffer"}
    assert got[".acc_buffer"].shape == (20,)
