"""Spatial transformer: affine parameter head -> grid -> bilinear sampling.
The counterpart of ``catgen/nn/spatial_transformer.py``.

Conventions (catgen's, which follow torch-stn, not ``F.affine_grid``):
  * normalized coords in [-1, 1], align-corners, in (y, x) order;
  * the affine matrix maps *output* coords to *input* sampling coords
    (inverse warping): ``row0 = [cos*s, -sin*s, tx]`` acts on (gy, gx, 1);
  * restricted parameters, in order: [angle] if rotation, [scale] if
    scaling, [tx, ty] if translation; the head starts at the identity;
  * sampling clamps to the border.

The transformers sample through the kernels that catgen's selectors pick
(``kernels/config.py``, ``CATGEN_SAMPLER_IMPL`` and
``CATGEN_SAMPLER_KERNEL``), as catgen's do: under ``mxu`` with ``v4`` (the
default) ``kernels/bilinear.py`` at coordinate rows; otherwise an
``(N, Ho, Wo, 2)`` grid through ``kernels/bilinear_grid.py``, under the
name of the v1-v3 generation (``mxu``) or as ``bilinear_sample``
(``xla``). D's prefix takes ``kernels/st_conv.py`` under
``CATGEN_ST_CONV=fused``. Each is its Hopper kernel on CUDA tensors and its
plain version on CPU tensors.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from catgen_torch.core.module import Sequential
from catgen_torch.kernels import config
from catgen_torch.kernels.bilinear import (affine_grid_rows,
                                           bilinear_sample_rows)
from catgen_torch.kernels.bilinear_grid import bilinear_sample_grid
from catgen_torch.kernels.st_conv import st_conv_prelu
from catgen_torch.nn.layers import (AvgPool, Conv, Dense, Flatten, LeakyReLU,
                                    linear, to_nchw, to_nhwc, weak)

# joint localization passes run (``FusedSTBranches._joint_loc_features``):
# one per D*_st3 forward under CATGEN_JOINT_LOC on
JOINT_LOC_PASSES = 0

Flags = Tuple[bool, bool, bool]   # (rotation, scaling, translation)


# ---------------------------------------------------------------------------
# functional pieces
# ---------------------------------------------------------------------------


def affine_matrix(params: torch.Tensor, allow_rotation: bool,
                  allow_scaling: bool,
                  allow_translation: bool) -> torch.Tensor:
    """(B, P) restricted parameters -> (B, 2, 3) affine matrices. With no
    component allowed, params are the full 6-dof matrix row-major."""
    b = params.shape[0]
    if not (allow_rotation or allow_scaling or allow_translation):
        return params.reshape(b, 2, 3)
    zeros = params.new_zeros((b,))
    i = 0
    angle = zeros
    if allow_rotation:
        angle = params[:, i]
        i += 1
    scale = params.new_ones((b,))
    if allow_scaling:
        scale = params[:, i]
        i += 1
    tx = ty = zeros
    if allow_translation:
        tx, ty = params[:, i], params[:, i + 1]
    cos = torch.cos(angle) * scale
    sin = torch.sin(angle) * scale
    row0 = torch.stack([cos, -sin, tx], dim=-1)
    row1 = torch.stack([sin, cos, ty], dim=-1)
    return torch.stack([row0, row1], dim=1)


def affine_grid(theta: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, 2, 3) affine matrices -> (B, H, W, 2) normalized (y, x) coords,
    contiguous (the layout the grid sampler kernel reads)."""
    rows = affine_grid_rows(theta, height, width)
    return rows.permute(0, 2, 1).reshape(theta.shape[0], height, width,
                                         2).contiguous()


def bilinear_sample(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Samples NHWC ``img`` at normalized (y, x) ``coords`` (B, Ho, Wo, 2):
    border-clamped bilinear gathers and lerps (catgen's ``xla`` sampler);
    the grid-layout kernel on CUDA tensors."""
    return bilinear_sample_grid(img, coords)


def warp_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """``image.warp``-style warping (catgen's ``warp_flow``): ``flow``
    (N, H, W, 2) holds per-output-pixel source offsets in pixels (dy, dx),
    normalized by (h-1) and (w-1) as catgen does and sampled through
    ``bilinear_sample`` (the grid kernel on CUDA tensors). The V
    subsystem's warp generator uses it."""
    n, h, w, _ = img.shape
    gy = torch.arange(h, dtype=img.dtype, device=img.device)[None, :, None]
    gx = torch.arange(w, dtype=img.dtype, device=img.device)[None, None, :]
    ny = 2.0 * (gy + flow[..., 0]) / max(h - 1, 1) - 1.0
    nx = 2.0 * (gx + flow[..., 1]) / max(w - 1, 1) - 1.0
    return bilinear_sample(img.contiguous(), torch.stack([ny, nx], dim=-1))


def sample_affine(x: torch.Tensor, thetas) -> torch.Tensor:
    """Samples ``x`` (N, H, W, C) at the affine grids of the (N, 2, 3)
    ``thetas``, stacked along the rows: (N, len(thetas)*H, W, C), on
    the sampler the selectors pick (catgen's ``SpatialTransformer`` and
    ``FusedSTBranches`` routing). The grids are made in f32 from the f32
    thetas and rounded to x's dtype before sampling, as catgen's are: in
    bf16 a 32-pixel axis is sampled on a grid of 1/8 pixel near its far
    edge."""
    h, w = x.shape[1:3]
    x = x.contiguous()

    def stack(grids, dim):
        return (grids[0] if len(grids) == 1 else torch.cat(grids, dim)).to(
            x.dtype)

    impl = config.resolve_sampler_impl()
    if impl == "mxu" and config.sampler_kernel == "v4":
        rows = stack([affine_grid_rows(t, h, w) for t in thetas], 2)
        return bilinear_sample_rows(x, rows, (len(thetas) * h, w))
    grid = stack([affine_grid(t, h, w) for t in thetas], 1)
    sampler = config.get_mxu_sampler() if impl == "mxu" else bilinear_sample
    return sampler(x, grid)


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class AffineParamHead(nn.Module):
    """Final localization layer: zero weights, identity bias."""

    def __init__(self, in_features: int, allow_rotation: bool,
                 allow_scaling: bool, allow_translation: bool):
        super().__init__()
        bias = []
        if allow_rotation:
            bias.append(0.0)
        if allow_scaling:
            bias.append(1.0)
        if allow_translation:
            bias.extend([0.0, 0.0])
        if not bias:
            bias = [1.0, 0.0, 0.0, 0.0, 1.0, 0.0]
        self.init_bias = tuple(bias)
        self.n_params = len(bias)
        self.weight = nn.Parameter(torch.zeros(self.n_params, in_features))
        self.bias = nn.Parameter(torch.tensor(self.init_bias))

    def reset_parameters_(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.bias.copy_(torch.tensor(self.init_bias))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, self.bias)


def _localization_net(in_channels: int, height: int,
                      width: int) -> Sequential:
    """avgpool2 -> conv16 -> LeakyReLU -> conv16 -> LeakyReLU -> avgpool2
    -> flatten -> dense64 -> LeakyReLU."""
    return Sequential([
        AvgPool(2),
        Conv(in_channels, 16, (3, 3)),
        LeakyReLU(),
        Conv(16, 16, (3, 3)),
        LeakyReLU(),
        AvgPool(2),
        Flatten(),
        Dense(16 * (height // 4) * (width // 4), 64),
        LeakyReLU(),
    ], name="loc")


class SpatialTransformer(nn.Module):
    """Localization net -> affine params -> grid -> bilinear resample of
    the input, at the input's size. Children ``loc`` and ``head``."""

    def __init__(self, image: Tuple[int, int, int], allow_rotation: bool,
                 allow_scaling: bool, allow_translation: bool):
        super().__init__()
        h, w, c = image
        self.flags: Flags = (allow_rotation, allow_scaling, allow_translation)
        self.loc = _localization_net(c, h, w)
        self.head = AffineParamHead(64, *self.flags)

    def theta(self, x: torch.Tensor) -> torch.Tensor:
        """(N, 2, 3) affine matrices of the input ``x``."""
        return affine_matrix(self.head(self.loc(x)).float(), *self.flags)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return sample_affine(x, [self.theta(x)])


class FusedSTBranches(nn.Module):
    """D*_st3's 4-way branch block: three spatial-transformer branches and
    one plain conv branch on the same feature map, concatenated along
    channels (tails 0..n-1, then plain).

    The branches' grids are stacked along the rows, (N, n*H, W) pixels
    (coordinate rows (N, 2, n*H*W) for v4, a grid (N, n*H, W, 2) for the
    others), so the sampler runs once; its output is split by rows, H per
    branch. Children ``loc{i}``, ``head{i}``, ``tail{i}`` and
    ``plain``.

    The branches' localization nets share the input. Under
    ``CATGEN_JOINT_LOC`` on (the default, as catgen's) they run in one pass,
    ``_joint_loc_features``: one conv on the first convs' weights
    concatenated along the outputs, one grouped conv (``groups`` = the
    number of branches) on the second convs', the pools and activations
    once at n x 16 channels, then each branch's channel slice through its
    own Dense. Parameters stay per branch, so the ``state_dict`` keys do
    not change, and gradients reach each branch's leaves through the
    concatenations. With the selector off the nets run one branch at a
    time, as separate ``Sequential``s."""

    def __init__(self, tails: Sequence[nn.Module], plain: nn.Module,
                 image: Tuple[int, int, int],
                 flags: Flags = (True, True, True)):
        super().__init__()
        if not tails:
            raise ValueError("FusedSTBranches needs at least one tail")
        h, w, c = image
        self.flags: Flags = tuple(flags)
        self.n_tails = len(tails)
        for i, tail in enumerate(tails):
            self.add_module(f"loc{i}", _localization_net(c, h, w))
            self.add_module(f"head{i}", AffineParamHead(64, *self.flags))
            self.add_module(f"tail{i}", tail)
        self.plain = plain
        try:
            self._layout = self._loc_layout()
        except NotImplementedError as e:     # raised by the joint pass
            self._layout = e

    def _loc_layout(self):
        """The joint pass's structure, derived once from the localization
        ``Sequential``s (``_localization_net``) rather than hard-coded:
        their child names of the two convs and the Dense, and the slope.
        Any other layer pattern raises, so an edit of the nets fails in the
        joint pass instead of diverging from the per-branch path."""
        expected = (AvgPool, Conv, LeakyReLU, Conv, LeakyReLU, AvgPool,
                    Flatten, Dense, LeakyReLU)
        for i in range(self.n_tails):
            children = list(getattr(self, f"loc{i}").named_children())
            classes = tuple(type(m) for _, m in children)
            if classes != expected:
                raise NotImplementedError(
                    f"the joint localization pass expects the layer "
                    f"pattern {[c.__name__ for c in expected]}, got "
                    f"{[c.__name__ for c in classes]} in loc{i}; set "
                    f"CATGEN_JOINT_LOC=0 or update _joint_loc_features")
            pool1, conv1, act1, conv2, act2, pool2 = (
                m for _, m in children[:6])
            if not pool1.window == pool2.window == 2:
                raise NotImplementedError(
                    "the joint localization pass assumes 2x2/2 pools")
            if not (act1.negative_slope == act2.negative_slope
                    == children[8][1].negative_slope):
                raise NotImplementedError(
                    "the joint localization pass assumes one slope")
            if not (conv1.kernel_size == conv2.kernel_size == (3, 3)
                    and conv1.padding == conv2.padding == (1, 1)):
                raise NotImplementedError(
                    "the joint localization pass assumes 'same' 3x3 convs")
        names = {k: children[j][0]
                 for k, j in (("conv1", 1), ("conv2", 3), ("dense", 7))}
        return names, act1.negative_slope

    def _joint_loc_features(self, x: torch.Tensor):
        """Every branch's localization features, (N, 64) each, in one
        pass. In bf16 it rounds where catgen's joint pass rounds: each
        pool is a sum of four in x's dtype, row by row, then x 0.25; the
        slope is rounded to x's dtype; the kernels and biases are cast to
        x's dtype and each bias is added after its conv or product."""
        global JOINT_LOC_PASSES
        if isinstance(self._layout, NotImplementedError):
            raise self._layout
        JOINT_LOC_PASSES += 1
        names, neg_slope = self._layout
        slope = weak(neg_slope, x.dtype)
        locs = [getattr(self, f"loc{i}") for i in range(self.n_tails)]

        def pool2(v):
            oh, ow = v.shape[1] // 2, v.shape[2] // 2
            v = v[:, :2 * oh, :2 * ow]
            s = v[:, 0::2, 0::2] + v[:, 0::2, 1::2]
            return ((s + v[:, 1::2, 0::2]) + v[:, 1::2, 1::2]) * 0.25

        def leaky(v):
            return torch.where(v >= 0, v, slope * v)

        def conv(v, name, groups=1):
            convs = [getattr(loc, name) for loc in locs]
            weight = torch.cat([c.weight for c in convs]).to(v.dtype)
            bias = torch.cat([c.bias for c in convs]).to(v.dtype)
            y = F.conv2d(to_nchw(v), weight, padding=1, groups=groups)
            return to_nhwc(y) + bias

        hc = leaky(conv(pool2(x), names["conv1"]))
        hc = leaky(conv(hc, names["conv2"], groups=self.n_tails))
        hc = pool2(hc)                                # (N, h/4, w/4, n*16)
        c_per = hc.shape[-1] // self.n_tails
        feats = []
        for i, loc in enumerate(locs):
            flat = hc[..., i * c_per:(i + 1) * c_per].reshape(x.shape[0], -1)
            dense = getattr(loc, names["dense"])
            feats.append(leaky(linear(flat, dense.weight, dense.bias)))
        return feats

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.shape[1]
        if config.joint_loc:
            feats = self._joint_loc_features(x)
        else:
            feats = [getattr(self, f"loc{i}")(x)
                     for i in range(self.n_tails)]
        thetas = [affine_matrix(getattr(self, f"head{i}")(feats[i]).float(),
                                *self.flags) for i in range(self.n_tails)]
        sampled = sample_affine(x, thetas)
        outs = [getattr(self, f"tail{i}")(sampled[:, i * h:(i + 1) * h])
                for i in range(self.n_tails)]
        outs.append(self.plain(x))
        return torch.cat(outs, dim=-1)


class FusedSTConvPReLU(nn.Module):
    """D's input prefix [SpatialTransformer -> Conv -> PReLU], children
    ``st``, ``conv`` and ``act`` (a ``PReLU``). Under ``CATGEN_ST_CONV=
    fused`` it runs as one kernel (``kernels/st_conv.py``) where catgen's
    ``_can_fuse`` allows (a 3x3 'same' conv, an image larger than 2x2);
    otherwise, and by default, as the three layers in turn."""

    def __init__(self, st: SpatialTransformer, conv: nn.Module,
                 act: nn.Module):
        super().__init__()
        self.st, self.conv, self.act = st, conv, act

    def _can_fuse(self, x: torch.Tensor) -> bool:
        # the port's Conv is always stride 1 with a bias
        return (self.conv.kernel_size == (3, 3)
                and self.conv.padding == (1, 1)
                and x.shape[1] > 2 and x.shape[2] > 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if config.resolve_st_conv_impl() == "fused" and self._can_fuse(x):
            # the f32 kernel, bias and slope in any compute dtype, as
            # catgen's: for a bf16 image the kernel rounds the weights
            return st_conv_prelu(x.contiguous(), self.st.theta(x),
                                 self.conv.weight.permute(2, 3, 1, 0),
                                 self.conv.bias, self.act.alpha)
        return self.act(self.conv(self.st(x)))
