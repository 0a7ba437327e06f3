"""catgen parameter trees <-> port ``state_dict``s.

catgen keeps a model's weights as two nested dicts, ``params`` and
``state`` (BatchNorm's running ``mean`` and ``var``), whose paths are the
module paths (``{'05_FusedSTBranches': {'loc0': {'01_Conv': {...}}}}``). The
port's ``state_dict`` keys spell the same paths joined by dots. Leaf names
map as follows:

  * ``kernel`` <-> ``weight``, with the layout converted: conv kernels
    HWIO <-> OIHW, dense kernels (in, out) <-> (out, in);
  * every other leaf (``bias``, BatchNorm's ``scale``, ``mean``, ``var``,
    PReLU's ``alpha``) keeps its name and layout; ``mean`` and ``var`` are
    catgen ``state``, the rest ``params``.

A model's variables alone, as catgen saves V and the pretrained G
(``{"params": ..., "state": ...}``), map to dict-rooted keys
(``variables_to_leaves``, ``variables_from_leaves``).

A whole train state (``catgen_torch.train.gan.TrainState``) maps onto
catgen's ``TrainState`` leaves: G's and D's weights as above; each
optimizer field that holds one tensor per parameter (adam's ``m``, ``v``,
adagrad's ``accum``, sgd's ``momentum_buf``, rmsprop's ``ms``) as a tree
shaped like ``params`` under ``.g_opt.<field>`` / ``.d_opt.<field>``, with
the same layout conversion; step counters, the gate's ``acc_buffer``,
``acc_count``, ``acc_index``, ``step`` and ``epoch`` as int32 / f32
arrays of catgen's shapes.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from catgen_torch.io.checkpoint import (dict_leaves_to_tree,
                                        dict_tree_to_leaves, key,
                                        leaves_to_tree, tree_to_leaves)

STATE_LEAVES = ("mean", "var")


def _walk(tree: Dict[str, Any], path=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def kernel_to_weight(kernel: np.ndarray) -> np.ndarray:
    if kernel.ndim == 4:                      # HWIO -> OIHW
        return kernel.transpose(3, 2, 0, 1)
    if kernel.ndim == 2:                      # (in, out) -> (out, in)
        return kernel.T
    raise ValueError(f"kernel of rank {kernel.ndim}: expected 2 or 4")


def weight_to_kernel(weight: np.ndarray) -> np.ndarray:
    if weight.ndim == 4:                      # OIHW -> HWIO
        return weight.transpose(2, 3, 1, 0)
    if weight.ndim == 2:
        return weight.T
    raise ValueError(f"weight of rank {weight.ndim}: expected 2 or 4")


def catgen_to_state_dict(params: Dict[str, Any],
                         state: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """catgen ``params`` and ``state`` trees (numpy leaves) -> a port
    ``state_dict`` (CPU tensors)."""
    sd = {}
    for tree in (params, state):
        for path, leaf in _walk(tree):
            arr = np.asarray(leaf)
            name = path[-1]
            if name == "kernel":
                name, arr = "weight", kernel_to_weight(arr)
            sd[".".join(path[:-1] + (name,))] = torch.tensor(arr)
    return sd


def gan_to_leaves(g: torch.nn.Module,
                  d: torch.nn.Module) -> Dict[str, np.ndarray]:
    """G's and D's weights as catgen checkpoint leaves
    (``.g_params[...]``, ``.g_state[...]``, ``.d_params[...]``, ...)."""
    leaves = {}
    for prefix, module in (("g", g), ("d", d)):
        params, state = state_dict_to_catgen(module.state_dict())
        leaves.update(tree_to_leaves(f"{prefix}_params", params))
        leaves.update(tree_to_leaves(f"{prefix}_state", state))
    return leaves


def gan_from_leaves(g: torch.nn.Module, d: torch.nn.Module,
                    leaves: Dict[str, np.ndarray]) -> None:
    """Loads catgen checkpoint leaves into G and D (strict: every port
    weight must be in the checkpoint and nothing else under G or D)."""
    for prefix, module in (("g", g), ("d", d)):
        sd = catgen_to_state_dict(leaves_to_tree(f"{prefix}_params", leaves),
                                  leaves_to_tree(f"{prefix}_state", leaves))
        module.load_state_dict(sd, strict=True)


def variables_to_leaves(module: torch.nn.Module) -> Dict[str, np.ndarray]:
    """The module's weights as the leaves of catgen's ``{"params": ...,
    "state": ...}`` checkpoint (``['params'][...]``, ``['state'][...]``)."""
    params, state = state_dict_to_catgen(module.state_dict())
    tree = {"params": params}
    if state:
        tree["state"] = state
    return dict_tree_to_leaves(tree)


def variables_from_leaves(module: torch.nn.Module,
                          leaves: Dict[str, np.ndarray]) -> None:
    """Loads ``{"params", "state"}`` checkpoint leaves into the module, in
    place (strict: every port weight must be there and nothing else)."""
    tree = dict_leaves_to_tree(leaves)
    sd = catgen_to_state_dict(tree.get("params", {}), tree.get("state", {}))
    module.load_state_dict(sd, strict=True)


def state_dict_to_catgen(sd: Dict[str, torch.Tensor]
                         ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A port ``state_dict`` -> catgen (``params``, ``state``) trees of
    numpy arrays. Modules without leaves do not appear."""
    params: Dict[str, Any] = {}
    state: Dict[str, Any] = {}
    for k, t in sd.items():
        path = k.split(".")
        arr = t.detach().cpu().numpy()
        name = path[-1]
        if name == "weight":
            name, arr = "kernel", weight_to_kernel(arr)
        node = state if name in STATE_LEAVES else params
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[name] = np.ascontiguousarray(arr)
    return params, state


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def train_state_to_leaves(state) -> Dict[str, np.ndarray]:
    """A port train state -> catgen ``TrainState`` checkpoint leaves."""
    leaves = gan_to_leaves(state.g, state.d)
    for attr, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for field, value in zip(opt._fields, opt):
            name = f"{attr}.{field}"
            if isinstance(value, dict):
                tree = state_dict_to_catgen(value)[0]
                leaves.update(tree_to_leaves(name, tree))
            else:
                leaves[key(name, ())] = _host(value).astype(np.int32)
    leaves[key("acc_buffer", ())] = _host(state.acc_buffer).astype(
        np.float32)
    for name in ("acc_count", "acc_index", "step", "epoch"):
        leaves[key(name, ())] = np.asarray(getattr(state, name), np.int32)
    return leaves


def train_state_from_leaves(state, leaves: Dict[str, np.ndarray]) -> None:
    """Loads catgen ``TrainState`` leaves into the port train state ``state``
    in place (its modules and tensors keep their devices). Every leaf the
    state has must be present with its shape; others are ignored."""
    gan_from_leaves(state.g, state.d, leaves)
    for attr in ("g_opt", "d_opt"):
        opt = getattr(state, attr)
        fields = []
        for field, value in zip(opt._fields, opt):
            name = f"{attr}.{field}"
            if isinstance(value, dict):
                sd = catgen_to_state_dict(leaves_to_tree(name, leaves), {})
                if set(sd) != set(value):
                    raise KeyError(f"{name}: checkpoint leaves "
                                   f"{sorted(set(sd) ^ set(value))} do not "
                                   f"match the parameters")
                fields.append({k: sd[k].to(value[k]) for k in value})
            else:
                fields.append(torch.as_tensor(
                    leaves[key(name, ())]).to(value))
        setattr(state, attr, type(opt)(*fields))
    state.acc_buffer = torch.as_tensor(
        leaves[key("acc_buffer", ())]).to(state.acc_buffer)
    for name in ("acc_count", "acc_index", "step", "epoch"):
        setattr(state, name, int(leaves[key(name, ())]))
