"""Shared set-up of the PyTorch port's parity tests (test_torch_port_*.py):
the flagship pair built on both sides with the same weights.

Weights start from catgen's init and are then perturbed with seeded numpy
noise, so that the comparison exercises what zero-initialised heads and
fresh BatchNorm statistics would hide:
  * every conv and dense kernel is scaled by ``WEIGHT_GAIN``: at the
    heuristic init each layer shrinks its activations, and G's images and
    D's scores come out flat (D's scores equal to ~1e-7);
  * the spatial-transformer heads get noisy kernels and biases, so the
    grids are not the identity and the sampler reads between pixels and
    past the edges;
  * BatchNorm running means and variances get noise.
"""

from __future__ import annotations

import jax
import numpy as np
import torch

from catgen import models as cmodels
from catgen_torch import models as tmodels
from catgen_torch.io.convert import catgen_to_state_dict

IMG = (32, 32, 3)
NOISE_DIM = 100
WEIGHT_GAIN = 4.0


def np_tree(tree):
    """A jax tree as writable numpy copies."""
    return jax.tree_util.tree_map(lambda x: np.array(x), tree)


def perturb(variables, rng: np.random.RandomState) -> None:
    """Perturbs a catgen variables tree (numpy leaves) in place."""

    def walk(params, state, path):
        for k, v in params.items():
            if not isinstance(v, dict):
                continue
            st = state.get(k, {}) if isinstance(state, dict) else {}
            if k.startswith("head"):
                v["kernel"] = rng.normal(0.0, 0.05, v["kernel"].shape
                                         ).astype(np.float32)
                v["bias"] = (v["bias"] + rng.normal(0.0, 0.2, v["bias"].shape)
                             ).astype(np.float32)
                continue
            if "kernel" in v:
                v["kernel"] = (v["kernel"] * WEIGHT_GAIN).astype(np.float32)
            if "mean" in st:
                st["mean"] = rng.normal(0.0, 0.1, st["mean"].shape
                                        ).astype(np.float32)
                st["var"] = rng.uniform(0.5, 2.0, st["var"].shape
                                        ).astype(np.float32)
            walk(v, st, path + (k,))

    walk(variables["params"], variables["state"], ())


def catgen_pair(seed: int = 0):
    """catgen's G32up-c and D32_st3 with perturbed weights:
    (G, D, g_vars, d_vars), variables as numpy trees."""
    g = cmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    d = cmodels.create_D32_st3(IMG)
    gv = np_tree(g.init(jax.random.PRNGKey(seed), (1, NOISE_DIM)))
    dv = np_tree(d.init(jax.random.PRNGKey(seed + 1), (1,) + IMG))
    rng = np.random.RandomState(seed)
    perturb(gv, rng)
    perturb(dv, rng)
    return g, d, gv, dv


def port_pair(gv, dv):
    """The port's G32up-c and D32_st3 holding catgen's weights, in eval."""
    g = tmodels.create_G_decoder_upsampling32c(IMG, NOISE_DIM)
    d = tmodels.create_D32_st3(IMG)
    g.load_state_dict(catgen_to_state_dict(gv["params"], gv["state"]),
                      strict=True)
    d.load_state_dict(catgen_to_state_dict(dv["params"], dv["state"]),
                      strict=True)
    return g.eval(), d.eval()
