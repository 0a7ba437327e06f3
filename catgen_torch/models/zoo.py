"""Model zoo: the counterparts of ``catgen/models/zoo.py`` that the ported
paths run: G32up-c and D32_st3, the V validators V16 and V32, and the
32px G autoencoder (encoder + G32up-c) of the pretrainer. The 64px
pyramid stage (G64_stack, the refine stage, D64) is in ``refine.py``;
``catgen_torch.models`` registers it here.

Layer order, widths and child names are catgen's, so a catgen checkpoint
loads through ``catgen_torch.io.convert``. Unlike catgen's modules, which
learn their input widths at init, PyTorch layers are built with them, so
each constructor states its widths.

Image shapes are (H, W, C); G input is (N, noise_dim); D and V input
(N, H, W, C).
The other models of catgen's registries are ROADMAP Queue A item 10.
"""

from __future__ import annotations

from typing import Tuple

from catgen_torch.core.module import Sequential
from catgen_torch.kernels.upsample_conv import UpsampleConv
from catgen_torch.nn.fused import FusedDecoderSequential
from catgen_torch.nn.layers import (AvgPool, BatchNorm, Conv, Dense, Dropout,
                                    Flatten, LeakyReLU, MaxPool, PReLU,
                                    Reshape, Sigmoid, Softmax,
                                    SpatialDropout)
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


def create_G_encoder32(image: ImageShape, noise_dim: int) -> Sequential:
    """'G_enc32', the pretrainer's encoder: four conv-BN-LeakyReLU stages
    (16, 16, 32, 32 channels, the first three max-pooled), dense 1024 with
    BN, dense to the noise."""
    h, w, c = image
    return Sequential([
        Conv(c, 16, (3, 3)), BatchNorm(16), LeakyReLU(), MaxPool(2),
        Conv(16, 16, (3, 3)), BatchNorm(16), LeakyReLU(), MaxPool(2),
        Conv(16, 32, (3, 3)), BatchNorm(32), LeakyReLU(), MaxPool(2),
        Conv(32, 32, (3, 3)), BatchNorm(32), LeakyReLU(),
        Flatten(),
        Dense((h // 8) * (w // 8) * 32, 1024), BatchNorm(1024), LeakyReLU(),
        Dense(1024, noise_dim),
    ], name="G_enc32")


def create_G_autoencoder(image: ImageShape, noise_dim: int) -> Sequential:
    """Encoder + decoder, the pretrainer's model. Child 1, the decoder, is
    ``create_G``'s G32up-c (so the kernel routes apply to it) and is
    exported as a standalone G."""
    if image[0] == 16:
        raise NotImplementedError(
            "the 16px autoencoder (G_enc16 + G16up) is not ported yet: "
            "ROADMAP Queue A item 10")
    return Sequential([create_G_encoder32(image, noise_dim),
                       create_G(image, noise_dim)], name="G_autoencoder")


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


def create_V16(image: ImageShape) -> Sequential:
    """V16: two conv pairs (128, 256) with pools and spatial dropouts, two
    dense 1024 layers with BN and dropout, a 2-way softmax (fake, real)."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), LeakyReLU(),
        Conv(128, 128, (3, 3)), BatchNorm(128), LeakyReLU(),
        MaxPool(2), SpatialDropout(0.2),
        Conv(128, 256, (3, 3)), LeakyReLU(),
        Conv(256, 256, (3, 3)), BatchNorm(256), LeakyReLU(),
        MaxPool(2), SpatialDropout(0.5),
        Flatten(),
        Dense((h // 4) * (w // 4) * 256, 1024), BatchNorm(1024),
        LeakyReLU(), Dropout(0.5),
        Dense(1024, 1024), BatchNorm(1024), LeakyReLU(), Dropout(0.5),
        Dense(1024, 2), Softmax(),
    ], name="V16")


def create_V32(image: ImageShape) -> Sequential:
    """V32, the default V at 32px: V16's layers with a pool after the
    first conv and an elementwise dropout after the second pool."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), LeakyReLU(), MaxPool(2),
        Conv(128, 128, (3, 3)), BatchNorm(128), LeakyReLU(), MaxPool(2),
        Dropout(0.5),
        Conv(128, 256, (3, 3)), LeakyReLU(),
        Conv(256, 256, (3, 3)), BatchNorm(256), LeakyReLU(), MaxPool(2),
        SpatialDropout(0.5),
        Flatten(),
        Dense((h // 8) * (w // 8) * 256, 1024), BatchNorm(1024),
        LeakyReLU(), Dropout(0.5),
        Dense(1024, 1024), BatchNorm(1024), LeakyReLU(), Dropout(0.5),
        Dense(1024, 2), Softmax(),
    ], name="V32")


def create_V(image: ImageShape) -> Sequential:
    """Default V: V16 at 16px, V32 otherwise."""
    if image[0] == 16:
        return create_V16(image)
    return create_V32(image)


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

V_REGISTRY = _Registry("V", {
    "v16": create_V16,
    "v32": create_V32,
    "default": create_V,
})
