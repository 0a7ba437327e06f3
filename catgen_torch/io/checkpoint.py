"""Reader and writer of catgen's checkpoint format, numpy only.

A catgen checkpoint (``catgen/io/checkpoint.py``) is an ``.npz`` of pytree
leaves keyed by their tree paths as ``jax.tree_util.keystr`` spells them,
for example ``.d_params['05_FusedSTBranches']['loc0']['01_Conv']['kernel']``
or, inside a train state's optimizer, ``.d_opt.m['06_Dense']['kernel']``
and ``.d_opt.step``, plus a JSON metadata blob stored as uint8 under
``__meta__``. A model's variables alone (the V checkpoint, the pretrained
G) are a dict at the root, so their keys start with the dict key:
``['params']['00_Conv']['kernel']``, ``['state']['01_BatchNorm']['mean']``.
This module reads and writes that format without jax: keys are parsed
and spelled by ``parse_key`` and ``key`` (``dict_key`` for dict roots). Saving is atomic and
keeps the predecessor as ``<file>.old``, as catgen's does. ``load_like``
is catgen's ``load`` against a template, lenient leaves included.
"""

from __future__ import annotations

import io
import json
import os
import re
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np

FORMAT_VERSION = 2

_ATTR = re.compile(r"^\.(\w+)")
_KEY = re.compile(r"^\.(\w+(?:\.\w+)*)((?:\['[^']*'\])*)$")
_SEGMENT = re.compile(r"\['([^']*)'\]")


def key(attr: str, path: Tuple[str, ...]) -> str:
    """``key('g_params', ('03_UpsampleConv', 'kernel'))`` ->
    ``".g_params['03_UpsampleConv']['kernel']"``; ``attr`` may name a
    field of a field (``'g_opt.m'``)."""
    return "." + attr + "".join(f"['{p}']" for p in path)


def dict_key(path: Tuple[str, ...]) -> str:
    """``dict_key(('params', '00_Conv', 'kernel'))`` ->
    ``"['params']['00_Conv']['kernel']"``: the key of a leaf under a dict
    root."""
    return "".join(f"['{p}']" for p in path)


def dict_tree_to_leaves(tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested dict of arrays, rooted at a dict -> {key: array}."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[dict_key(path)] = np.asarray(node)

    walk(tree, ())
    return out


def dict_leaves_to_tree(leaves: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """Inverse of ``dict_tree_to_leaves``; raises ValueError on a key that
    is not a chain of dict keys."""
    tree: Dict[str, Any] = {}
    for k, v in leaves.items():
        path = tuple(_SEGMENT.findall(k))
        if not path or dict_key(path) != k:
            raise ValueError(f"not a dict-rooted checkpoint key: {k!r}")
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def attr_of(k: str) -> str:
    """The top-level field of a key: ``.d_opt.mu[...]`` -> ``d_opt``."""
    m = _ATTR.match(k)
    if m is None:
        raise ValueError(f"not a catgen checkpoint key: {k!r}")
    return m.group(1)


def parse_key(k: str) -> Tuple[str, Tuple[str, ...]]:
    """Inverse of ``key`` (fields, then dict keys only); raises ValueError
    on any other spelling."""
    m = _KEY.match(k)
    if m is None:
        raise ValueError(f"not a catgen checkpoint key: {k!r}")
    return m.group(1), tuple(_SEGMENT.findall(m.group(2)))


def tree_to_leaves(attr: str, tree: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {key: array}, keys under ``.attr``."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out[key(attr, path)] = np.asarray(node)

    walk(tree, ())
    return out


def leaves_to_tree(attr: str, leaves: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """{key: array} -> nested dict of the leaves under ``.attr``."""
    tree: Dict[str, Any] = {}
    for k, v in leaves.items():
        a, path = parse_key(k)
        if a != attr:
            continue
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return tree


def save(path: str, leaves: Dict[str, np.ndarray],
         meta: Optional[Dict[str, Any]] = None) -> None:
    """Atomically writes leaves + metadata; keeps the previous file as
    ``.old``."""
    meta = dict(meta or {})
    meta.setdefault("format_version", FORMAT_VERSION)
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8), **leaves)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(buf.getvalue())
    if os.path.exists(path):
        os.replace(path, path + ".old")
    os.replace(tmp, path)


def load_meta(path: str) -> Dict[str, Any]:
    with np.load(path) as z:
        return json.loads(bytes(z["__meta__"]).decode())


def _refuse_legacy(path: str, z) -> None:
    if any("00_SpatialTransformer" in k for k in z.files):
        raise ValueError(
            f"checkpoint {path} predates catgen's round-3 D layout (it has "
            f"'00_SpatialTransformer' keys); load and re-save it with "
            f"catgen, whose loader migrates the old keys")


def load(path: str, attrs: Tuple[str, ...]
         ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Returns ({key: array} for the keys under ``attrs``, meta). Leaves
    under other attributes, such as the optimizer states ``.g_opt`` and
    ``.d_opt`` and the gate buffer, are not read.

    Raises ValueError on an archive written before catgen's round-3 D
    restructure (an ``00_SpatialTransformer`` key): catgen migrates those
    keys on load (``catgen.io.checkpoint.load``); re-save such a
    checkpoint with catgen first."""
    with np.load(path) as z:
        _refuse_legacy(path, z)
        meta = json.loads(bytes(z["__meta__"]).decode())
        leaves = {}
        for k in z.files:
            if k == "__meta__":
                continue
            if attr_of(k) in attrs:
                leaves[k] = z[k]
    return leaves, meta


def load_like(path: str, template: Dict[str, np.ndarray],
              lenient: Tuple[str, ...] = ()
              ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """catgen's ``load(path, template, lenient)`` over leaves: returns the
    file's value of every key of ``template`` and the metadata. A key
    missing from the file, or of another shape, raises KeyError or
    ValueError, unless it contains one of the ``lenient`` substrings: then
    the template's value is kept (with a warning, and the key listed under
    ``meta['_reinitialized']``). Keys the template lacks are not read."""
    with np.load(path) as z:
        _refuse_legacy(path, z)
        meta = json.loads(bytes(z["__meta__"]).decode())
        out, reinit = {}, []
        for k, want in template.items():
            ok = k in z.files and tuple(z[k].shape) == tuple(want.shape)
            if ok:
                out[k] = z[k]
            elif any(s in k for s in lenient):
                out[k] = want
                reinit.append(k)
            elif k not in z.files:
                raise KeyError(f"checkpoint {path} missing leaf {k}")
            else:
                raise ValueError(f"checkpoint leaf {k} shape {z[k].shape} "
                                 f"!= template {want.shape}")
    if reinit:
        warnings.warn(f"checkpoint {path}: re-initialized {len(reinit)} "
                      f"lenient leaves from the template: {reinit[:4]}...")
        meta["_reinitialized"] = reinit
    return out, meta


def adversarial_filename() -> str:
    return "adversarial.ckpt"


def v_filename(channels: int, height: int, width: int) -> str:
    """The V checkpoint's name (train_v.lua's v_CxHxW)."""
    return f"v_{channels}x{height}x{width}.ckpt"


def g_pretrained_filename(channels: int, height: int, width: int,
                          noise_dim: int) -> str:
    """The pretrained G's name (pretrain_g.lua's g_pretrained_CxHxW_nd<N>)."""
    return f"g_pretrained_{channels}x{height}x{width}_nd{noise_dim}.ckpt"
