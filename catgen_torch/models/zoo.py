"""Model zoo: the counterparts of ``catgen/models/zoo.py`` that the
sampling path runs, G32up-c and D32_st3.

Layer order, widths and child names are catgen's, so a catgen checkpoint
loads through ``catgen_torch.io.convert``. Unlike catgen's modules, which
learn their input widths at init, PyTorch layers are built with them, so
each constructor states its widths.

Image shapes are (H, W, C); G input is (N, noise_dim); D input (N, H, W, C).
The other models of catgen's registries are ROADMAP Queue A item 10.
"""

from __future__ import annotations

from typing import Tuple

from catgen_torch.core.module import Sequential
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.nn.fused import FusedDecoderSequential
from catgen_torch.nn.layers import (AvgPool, BatchNorm, Conv, Dense, Dropout,
                                    Flatten, MaxPool, PReLU, Reshape,
                                    Sigmoid, SpatialDropout)
from catgen_torch.nn.spatial_transformer import (FusedSTBranches,
                                                 FusedSTConvPReLU,
                                                 SpatialTransformer)

ImageShape = Tuple[int, int, int]  # (H, W, C)


def create_G_decoder_upsampling32c(image: ImageShape,
                                   noise_dim: int) -> FusedDecoderSequential:
    """'G32up-c', the default 32px G: 4x4x512 seed projection (no BN), three
    upsample-conv stages 512 -> 256 -> 128, 3x3 output conv, sigmoid."""
    h, w, c = image
    if (h, w) != (32, 32):
        raise ValueError(f"G32up-c makes 32x32 images, not {h}x{w}")
    return FusedDecoderSequential([
        Dense(noise_dim, 512 * 4 * 4), PReLU(), Reshape((4, 4, 512)),
        UpsampleConv(512, 512, (3, 3)), BatchNorm(512), PReLU(),
        UpsampleConv(512, 256, (3, 3)), BatchNorm(256), PReLU(),
        UpsampleConv(256, 128, (5, 5)), BatchNorm(128), PReLU(),
        Conv(128, c, (3, 3)), Sigmoid(),
    ], name="G32up_c")


def create_G(image: ImageShape, noise_dim: int) -> FusedDecoderSequential:
    """Default G: upsampling32c (the 16px G16up is not ported yet)."""
    if image[0] == 16:
        raise NotImplementedError(
            "G16up (the 16px default G) is not ported yet: ROADMAP Queue A "
            "item 10")
    return create_G_decoder_upsampling32c(image, noise_dim)


def _st_branch_tail() -> Sequential:
    """A D32_st3 transformer-branch tail, after its ST: conv64 -> PReLU ->
    maxpool -> SpatialDropout(0.2) -> conv64 -> PReLU."""
    return Sequential([
        Conv(64, 64, (3, 3)), PReLU(), MaxPool(2), SpatialDropout(0.2),
        Conv(64, 64, (3, 3)), PReLU(),
    ], name="st_tail")


def create_D32_st3(image: ImageShape) -> Sequential:
    """The default D: rotation-only ST on the input, conv stem, then a
    4-way branch concat (3 spatial-transformer branches + 1 conv branch),
    dense head."""
    h, w, c = image
    branch4 = Sequential([
        Conv(64, 128, (5, 5)), PReLU(), MaxPool(2), SpatialDropout(0.2),
        Conv(128, 128, (7, 7)), PReLU(),
    ], name="conv_branch")
    n_feat = (h // 4) * (w // 4) * (3 * 64 + 128)
    return Sequential([
        FusedSTConvPReLU(SpatialTransformer(image, True, False, False),
                         Conv(c, 64, (3, 3)), PReLU()),
        Conv(64, 64, (3, 3)), PReLU(),
        AvgPool(2), SpatialDropout(0.2),
        FusedSTBranches([_st_branch_tail(), _st_branch_tail(),
                         _st_branch_tail()], branch4, (h // 2, w // 2, 64)),
        SpatialDropout(0.5),
        Flatten(),
        Dense(n_feat, 256), PReLU(), Dropout(0.5),
        Dense(256, 1), Sigmoid(),
    ], name="D32_st3")


def create_D(image: ImageShape) -> Sequential:
    """Default D: D32_st3 at every scale."""
    return create_D32_st3(image)


class _Registry(dict):
    """catgen's model registry, holding only what is ported so far."""

    def __init__(self, kind: str, entries):
        super().__init__(entries)
        self.kind = kind

    def __missing__(self, key):
        raise NotImplementedError(
            f"{self.kind} model {key!r} is not ported yet (ported: "
            f"{sorted(self)}): ROADMAP Queue A item 10")


G_REGISTRY = _Registry("G", {
    "g32up_c": create_G_decoder_upsampling32c,
    "default": create_G,
})

D_REGISTRY = _Registry("D", {
    "d32_st3": create_D32_st3,
    "default": create_D,
})
