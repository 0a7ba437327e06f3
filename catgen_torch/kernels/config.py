"""Selection of the kernel routes: the counterpart of the upsample, sampler
and ST-conv selectors of ``catgen/kernels/config.py``.

The same environment variables, with the same names and values, pick the
same route in both packages:

    CATGEN_UPSAMPLE_IMPL=auto|collapsed|pallas|naive   (default auto)
    CATGEN_FUSED_LADDER=1|0                            (default 1)
    CATGEN_UPSAMPLE_BWD=collapsed|pallas|hybrid|naive  (default collapsed)
    CATGEN_LADDER_BWD=xla_vjp|xla|pallas               (default xla_vjp)
    CATGEN_SAMPLER_IMPL=auto|xla|mxu                   (default auto)
    CATGEN_SAMPLER_KERNEL=v1|v2|v3|v4                  (default v4)
    CATGEN_ST_CONV=auto|fused|split                    (default auto)

In the port the words keep catgen's meaning with PyTorch in place of XLA:

  * ``collapsed``: the four collapsed parity convolutions on cuDNN
    (``kernels/upsample_conv.py::upsample2_conv``); ``auto`` resolves to it,
    as catgen's does;
  * ``naive``: nearest-2x upsample, then the k x k conv (the reference);
  * ``pallas``: the hand-written CUDA kernels of
    ``kernels/fused_upsample_conv.py`` (``csrc/upsample_conv.cu`` and
    ``csrc/upsample_conv_bwd.cu``); on CPU tensors their plain versions;
  * ``fused_ladder`` (with ``pallas``): G's ``[UpsampleConv, BatchNorm,
    PReLU]`` stages run as boundary-fused blocks (``nn/fused.py``);
  * ``upsample_bwd``, the per-layer backward: ``pallas`` is the dX and dCK
    kernels, ``hybrid`` the dX kernel with autograd's dW and db;
    ``collapsed``/``naive`` autograd through that formulation;
  * ``ladder_bwd``, the ladder block's backward: ``pallas`` is the fused
    block-backward kernels; ``xla`` and ``xla_vjp`` both mean autograd
    through the plain block (catgen's hand-written ``xla`` variant works
    around XLA relayouts that PyTorch does not make);
  * ``sampler_impl``, the spatial transformers' sampler: ``mxu`` is the
    kernel generation named by ``sampler_kernel`` (``v4``: the coordinate
    rows kernel of ``kernels/bilinear.py``; ``v1``-``v3``: the grid-layout
    kernel of ``kernels/bilinear_grid.py`` under catgen's three names);
    ``xla`` is catgen's gather formulation on ``(N, Ho, Wo, 2)``
    coordinates, which on a CUDA tensor is the grid-layout kernel too.
    ``auto`` resolves to ``mxu``, as catgen's does on its accelerator;
  * ``st_conv_impl``, D's ``[input ST -> conv3x3 -> PReLU]`` prefix:
    ``fused`` is the kernel of ``kernels/st_conv.py``, ``split`` the three
    layers in turn; ``auto`` resolves to ``split``, as catgen's does.

Selection is process-global. Set it before a run, through the environment
or the setters; ``using`` sets and restores around a block.
"""

from __future__ import annotations

import contextlib
import os

from catgen_torch.kernels import bilinear_grid

_UPSAMPLE_IMPLS = ("auto", "collapsed", "pallas", "naive")
_UPSAMPLE_BWDS = ("collapsed", "pallas", "hybrid", "naive")
_LADDER_BWDS = ("xla_vjp", "xla", "pallas")
_SAMPLER_IMPLS = ("auto", "xla", "mxu")
_SAMPLER_KERNELS = ("v1", "v2", "v3", "v4")
_ST_CONV_IMPLS = ("auto", "fused", "split")


def _check(name: str, value, allowed) -> None:
    if value not in allowed:
        raise ValueError(
            f"{name}={value!r} is not a valid choice; pick one of {allowed}")


def _env_choice(var: str, default: str, allowed) -> str:
    """Env-sourced selector with validation: a typo fails loudly at import
    instead of falling through to some default implementation."""
    v = os.environ.get(var, default)
    _check(var, v, allowed)
    return v


upsample_impl = _env_choice("CATGEN_UPSAMPLE_IMPL", "auto", _UPSAMPLE_IMPLS)
fused_ladder = os.environ.get("CATGEN_FUSED_LADDER", "1") == "1"
upsample_bwd = _env_choice("CATGEN_UPSAMPLE_BWD", "collapsed", _UPSAMPLE_BWDS)
ladder_bwd = _env_choice("CATGEN_LADDER_BWD", "xla_vjp", _LADDER_BWDS)
sampler_impl = _env_choice("CATGEN_SAMPLER_IMPL", "auto", _SAMPLER_IMPLS)
sampler_kernel = _env_choice("CATGEN_SAMPLER_KERNEL", "v4", _SAMPLER_KERNELS)
st_conv_impl = _env_choice("CATGEN_ST_CONV", "auto", _ST_CONV_IMPLS)


def resolve_upsample_impl() -> str:
    """'auto' -> the collapsed parity convolutions, as in catgen. Whether
    the kernels should be the default on Hopper is for a measured change
    to decide."""
    if upsample_impl != "auto":
        return upsample_impl
    return "collapsed"


def resolve_sampler_impl() -> str:
    """'auto' -> the kernels (``mxu``), what catgen picks on its
    accelerator and what the card runs."""
    if sampler_impl != "auto":
        return sampler_impl
    return "mxu"


def resolve_st_conv_impl() -> str:
    """'auto' -> the split prefix, as in catgen."""
    if st_conv_impl != "auto":
        return st_conv_impl
    return "split"


def get_mxu_sampler():
    """The grid-layout sampler under the name of the generation that
    ``sampler_kernel`` picks (v1-v3; v4 samples coordinate rows, see
    ``nn/spatial_transformer.py``)."""
    return {"v1": bilinear_grid.bilinear_sample_mxu,
            "v2": bilinear_grid.bilinear_sample_sep,
            "v3": bilinear_grid.bilinear_sample_batched}[sampler_kernel]


def set_upsample_impl(name: str) -> None:
    global upsample_impl
    _check("upsample_impl", name, _UPSAMPLE_IMPLS)
    upsample_impl = name


def set_fused_ladder(on: bool) -> None:
    global fused_ladder
    fused_ladder = bool(on)


def set_upsample_bwd(name: str) -> None:
    global upsample_bwd
    _check("upsample_bwd", name, _UPSAMPLE_BWDS)
    upsample_bwd = name


def set_ladder_bwd(name: str) -> None:
    global ladder_bwd
    _check("ladder_bwd", name, _LADDER_BWDS)
    ladder_bwd = name


def set_sampler_impl(name: str) -> None:
    global sampler_impl
    _check("sampler_impl", name, _SAMPLER_IMPLS)
    sampler_impl = name


def set_sampler_kernel(name: str) -> None:
    global sampler_kernel
    _check("sampler_kernel", name, _SAMPLER_KERNELS)
    sampler_kernel = name


def set_st_conv_impl(name: str) -> None:
    global st_conv_impl
    _check("st_conv_impl", name, _ST_CONV_IMPLS)
    st_conv_impl = name


_SETTERS = {"upsample_impl": set_upsample_impl,
            "fused_ladder": set_fused_ladder,
            "upsample_bwd": set_upsample_bwd,
            "ladder_bwd": set_ladder_bwd,
            "sampler_impl": set_sampler_impl,
            "sampler_kernel": set_sampler_kernel,
            "st_conv_impl": set_st_conv_impl}


@contextlib.contextmanager
def using(**choices):
    """Sets the named selectors for the block and restores them after:
    ``with using(upsample_impl="pallas", ladder_bwd="pallas"): ...``."""
    unknown = set(choices) - set(_SETTERS)
    if unknown:
        raise KeyError(f"unknown selectors {sorted(unknown)}; known: "
                       f"{sorted(_SETTERS)}")
    saved = {k: globals()[k] for k in choices}
    try:
        for k, v in choices.items():
            _SETTERS[k](v)
        yield
    finally:
        for k, v in saved.items():
            globals()[k] = v
