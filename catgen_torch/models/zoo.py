"""Model zoo: the counterparts of every model of ``catgen/models/zoo.py``:
the generators (the MLP decoder, G16up, G32up, G32up-b, G32up-c), the
pretrainer's encoders and autoencoders, the discriminators (D16, D16b,
D32, D32b-e, D16_st3, D32_st3) and the V validators V16 and V32. The
64px pyramid stage (G64_stack, the refine stage, D64) is in
``refine.py``; ``catgen_torch.models`` registers it here.

Layer order, widths and child names are catgen's, so a catgen checkpoint
loads through ``catgen_torch.io.convert``. Unlike catgen's modules, which
learn their input widths at init, PyTorch layers are built with them, so
each constructor states its widths.

Each ``Flatten -> Dense`` width comes from the image shape (catgen's
pools floor, as ``MaxPool`` and ``AvgPool`` do here), so every model
builds at any scale where catgen's does.

Image shapes are (H, W, C); G input is (N, noise_dim); D and V input
(N, H, W, C). Every constructor takes catgen's ``axis_name``
(``dist.mesh.DATA_AXIS`` under data parallelism), which each of its
BatchNorms takes: their batch statistics are then synced over the ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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


def _check_size(name: str, image: ImageShape, size: int) -> None:
    if tuple(image[:2]) != (size, size):
        raise ValueError(f"{name} makes {size}x{size} images, not "
                         f"{image[0]}x{image[1]}")


# ---------------------------------------------------------------------------
# G decoders (the generators)
# ---------------------------------------------------------------------------


def create_G_decoder(image: ImageShape, noise_dim: int,
                     axis_name: Optional[str] = None) -> Sequential:
    """'mlp': dense 1024 -> PReLU -> dense to the image -> sigmoid."""
    h, w, c = image
    return Sequential([
        Dense(noise_dim, 1024), PReLU(),
        Dense(1024, h * w * c), Sigmoid(),
        Reshape((h, w, c)),
    ], name="G_mlp")


def create_G_decoder_upsampling16(
        image: ImageShape, noise_dim: int,
        axis_name: Optional[str] = None) -> FusedDecoderSequential:
    """'G16up', the default 16px G: a 4x4x128 seed (PReLU after the
    reshape), two k5 upsample-conv stages 256 -> 128, 3x3 output conv."""
    _check_size("G16up", image, 16)
    c = image[2]
    return FusedDecoderSequential([
        Dense(noise_dim, 128 * 4 * 4), Reshape((4, 4, 128)), PReLU(),
        UpsampleConv(128, 256, (5, 5)), BatchNorm(256, axis_name), PReLU(),
        UpsampleConv(256, 128, (5, 5)), BatchNorm(128, axis_name), PReLU(),
        Conv(128, c, (3, 3)), Sigmoid(),
    ], name="G16up")


def create_G_decoder_upsampling32(
        image: ImageShape, noise_dim: int,
        axis_name: Optional[str] = None) -> FusedDecoderSequential:
    """'G32up': G16up's layers from an 8x8x128 seed, to 32x32."""
    _check_size("G32up", image, 32)
    c = image[2]
    return FusedDecoderSequential([
        Dense(noise_dim, 128 * 8 * 8), Reshape((8, 8, 128)), PReLU(),
        UpsampleConv(128, 256, (5, 5)), BatchNorm(256, axis_name), PReLU(),
        UpsampleConv(256, 128, (5, 5)), BatchNorm(128, axis_name), PReLU(),
        Conv(128, c, (3, 3)), Sigmoid(),
    ], name="G32up")


def create_G_decoder_upsampling32b(
        image: ImageShape, noise_dim: int,
        axis_name: Optional[str] = None) -> FusedDecoderSequential:
    """'G32up-b': G32up-c with a BatchNorm on the seed projection and a 5x5
    output conv."""
    _check_size("G32up-b", image, 32)
    c = image[2]
    return FusedDecoderSequential([
        Dense(noise_dim, 512 * 4 * 4), BatchNorm(512 * 4 * 4, axis_name),
        PReLU(),
        Reshape((4, 4, 512)),
        UpsampleConv(512, 512, (3, 3)), BatchNorm(512, axis_name), PReLU(),
        UpsampleConv(512, 256, (3, 3)), BatchNorm(256, axis_name), PReLU(),
        UpsampleConv(256, 128, (5, 5)), BatchNorm(128, axis_name), PReLU(),
        Conv(128, c, (5, 5)), Sigmoid(),
    ], name="G32up_b")


def create_G_decoder_upsampling32c(
        image: ImageShape, noise_dim: int,
        axis_name: Optional[str] = None) -> FusedDecoderSequential:
    """'G32up-c', the default 32px G: 4x4x512 seed projection (no BN), three
    upsample-conv stages 512 -> 256 -> 128, 3x3 output conv, sigmoid."""
    _check_size("G32up-c", image, 32)
    c = image[2]
    return FusedDecoderSequential([
        Dense(noise_dim, 512 * 4 * 4), PReLU(), Reshape((4, 4, 512)),
        UpsampleConv(512, 512, (3, 3)), BatchNorm(512, axis_name), PReLU(),
        UpsampleConv(512, 256, (3, 3)), BatchNorm(256, axis_name), PReLU(),
        UpsampleConv(256, 128, (5, 5)), BatchNorm(128, axis_name), PReLU(),
        Conv(128, c, (3, 3)), Sigmoid(),
    ], name="G32up_c")


def create_G(image: ImageShape, noise_dim: int,
             axis_name: Optional[str] = None) -> FusedDecoderSequential:
    """Default G: G16up at 16px, G32up-c otherwise."""
    if image[0] == 16:
        return create_G_decoder_upsampling16(image, noise_dim, axis_name)
    return create_G_decoder_upsampling32c(image, noise_dim, axis_name)


# ---------------------------------------------------------------------------
# G encoders + autoencoder (the pretrainer's model)
# ---------------------------------------------------------------------------


def create_G_encoder16(image: ImageShape, noise_dim: int,
                       axis_name: Optional[str] = None) -> Sequential:
    """'G_enc16': two conv-BN-LeakyReLU pairs of 32, a max pool, two of 64
    with a max pool between them, dense 512 with BN, dense to the noise.
    The flatten is 4x4x64 at 16px (two pools; catgen corrects the
    reference's size)."""
    h, w, c = image
    return Sequential([
        Conv(c, 32, (3, 3)), BatchNorm(32, axis_name), LeakyReLU(),
        Conv(32, 32, (3, 3)), BatchNorm(32, axis_name), LeakyReLU(),
        MaxPool(2),
        Conv(32, 64, (3, 3)), BatchNorm(64, axis_name), LeakyReLU(),
        MaxPool(2),
        Conv(64, 64, (3, 3)), BatchNorm(64, axis_name), LeakyReLU(),
        Flatten(),
        Dense((h // 4) * (w // 4) * 64, 512), BatchNorm(512, axis_name),
        LeakyReLU(),
        Dense(512, noise_dim),
    ], name="G_enc16")


def create_G_encoder32(image: ImageShape, noise_dim: int,
                       axis_name: Optional[str] = None) -> Sequential:
    """'G_enc32', the pretrainer's encoder: four conv-BN-LeakyReLU stages
    (16, 16, 32, 32 channels, the first three max-pooled), dense 1024 with
    BN, dense to the noise."""
    h, w, c = image
    return Sequential([
        Conv(c, 16, (3, 3)), BatchNorm(16, axis_name), LeakyReLU(), MaxPool(2),
        Conv(16, 16, (3, 3)), BatchNorm(16, axis_name),
        LeakyReLU(), MaxPool(2),
        Conv(16, 32, (3, 3)), BatchNorm(32, axis_name),
        LeakyReLU(), MaxPool(2),
        Conv(32, 32, (3, 3)), BatchNorm(32, axis_name), LeakyReLU(),
        Flatten(),
        Dense((h // 8) * (w // 8) * 32, 1024), BatchNorm(1024, axis_name),
        LeakyReLU(),
        Dense(1024, noise_dim),
    ], name="G_enc32")


def create_G_autoencoder(image: ImageShape, noise_dim: int,
                         axis_name: Optional[str] = None) -> Sequential:
    """Encoder + decoder, the pretrainer's model: G_enc16 + G16up at 16px,
    G_enc32 + G32up-c otherwise. Child 1, the decoder, is ``create_G``'s
    (so the kernel routes apply to it) and is exported as a standalone
    G."""
    if image[0] == 16:
        enc = create_G_encoder16(image, noise_dim, axis_name)
    else:
        enc = create_G_encoder32(image, noise_dim, axis_name)
    return Sequential([enc, create_G(image, noise_dim, axis_name)],
                      name="G_autoencoder")


# ---------------------------------------------------------------------------
# D variants
# ---------------------------------------------------------------------------


def _head(n_feat: int, widths: Sequence[int]) -> list:
    """Flatten -> [Dense -> PReLU -> Dropout(0.5)] per width -> Dense(1)
    -> Sigmoid: the dense head of the conv Ds."""
    layers = [Flatten()]
    for width in widths:
        layers += [Dense(n_feat, width), PReLU(), Dropout(0.5)]
        n_feat = width
    return layers + [Dense(n_feat, 1), Sigmoid()]


def create_D16(image: ImageShape,
               axis_name: Optional[str] = None) -> Sequential:
    """'D16': conv 128, 128 (pool), 256, 1024 (pool), spatial dropout, two
    dense 1024 layers."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), PReLU(),
        Conv(128, 128, (3, 3)), PReLU(), MaxPool(2),
        Conv(128, 256, (3, 3)), PReLU(),
        Conv(256, 1024, (3, 3)), PReLU(), MaxPool(2),
        SpatialDropout(0.5),
        *_head((h // 4) * (w // 4) * 1024, (1024, 1024)),
    ], name="D16")


def create_D16b(image: ImageShape,
                axis_name: Optional[str] = None) -> Sequential:
    """'D16b': conv 64, 64 (pool), 128, 128 (pool), each followed by a
    spatial dropout, two dense 1024 layers."""
    h, w, c = image
    return Sequential([
        Conv(c, 64, (3, 3)), PReLU(), SpatialDropout(0.2),
        Conv(64, 64, (3, 3)), PReLU(), MaxPool(2), SpatialDropout(0.2),
        Conv(64, 128, (3, 3)), PReLU(), SpatialDropout(0.2),
        Conv(128, 128, (3, 3)), PReLU(), MaxPool(2), SpatialDropout(0.5),
        *_head((h // 4) * (w // 4) * 128, (1024, 1024)),
    ], name="D16b")


def create_D32(image: ImageShape,
               axis_name: Optional[str] = None) -> Sequential:
    """'D32': conv 64 (avg pool), 128 (max pool, dropout), two 5x5 convs
    of 256 (max pool), spatial dropout, two dense 1024 layers."""
    h, w, c = image
    return Sequential([
        Conv(c, 64, (3, 3)), PReLU(), AvgPool(2),
        Conv(64, 128, (3, 3)), PReLU(), MaxPool(2), Dropout(0.5),
        Conv(128, 256, (5, 5)), PReLU(),
        Conv(256, 256, (5, 5)), PReLU(), MaxPool(2), SpatialDropout(0.5),
        *_head((h // 8) * (w // 8) * 256, (1024, 1024)),
    ], name="D32")


def create_D32b(image: ImageShape,
                axis_name: Optional[str] = None) -> Sequential:
    """'D32b': D32 at 128 channels first, 5x5 convs of 256 and 512 (max
    pool) and a third of 512, two dense 1024 layers."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), PReLU(), AvgPool(2),
        Conv(128, 128, (3, 3)), PReLU(), MaxPool(2), Dropout(0.5),
        Conv(128, 256, (5, 5)), PReLU(),
        Conv(256, 512, (5, 5)), PReLU(), MaxPool(2),
        Conv(512, 512, (5, 5)), PReLU(), SpatialDropout(0.5),
        *_head((h // 8) * (w // 8) * 512, (1024, 1024)),
    ], name="D32b")


def create_D32c(image: ImageShape,
                axis_name: Optional[str] = None) -> Sequential:
    """'D32c': D32b's layout with 5x5 convs of 256, two dense 512
    layers."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), PReLU(), AvgPool(2),
        Conv(128, 128, (3, 3)), PReLU(), MaxPool(2), Dropout(0.5),
        Conv(128, 256, (5, 5)), PReLU(),
        Conv(256, 256, (5, 5)), PReLU(), MaxPool(2),
        Conv(256, 256, (5, 5)), PReLU(), SpatialDropout(0.5),
        *_head((h // 8) * (w // 8) * 256, (512, 512)),
    ], name="D32c")


def create_D32d(image: ImageShape,
                axis_name: Optional[str] = None) -> Sequential:
    """'D32d': 3x3 convs of 128, 128, 256, 256 with three average pools,
    two dense 512 layers."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), PReLU(), AvgPool(2),
        Conv(128, 128, (3, 3)), PReLU(), AvgPool(2),
        Conv(128, 256, (3, 3)), PReLU(),
        Conv(256, 256, (3, 3)), PReLU(), AvgPool(2), SpatialDropout(0.5),
        *_head((h // 8) * (w // 8) * 256, (512, 512)),
    ], name="D32d")


def create_D32e(image: ImageShape,
                axis_name: Optional[str] = None) -> Sequential:
    """'D32e': D32d's convs, each followed by a spatial dropout, dense 1024
    and 512."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(128, 128, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(128, 256, (3, 3)), PReLU(), SpatialDropout(0.2), AvgPool(2),
        Conv(256, 256, (3, 3)), PReLU(), SpatialDropout(0.5),
        *_head((h // 8) * (w // 8) * 256, (1024, 512)),
    ], name="D32e")


def _st_branch_tail() -> Sequential:
    """A D32_st3 transformer-branch tail, after its ST: conv64 -> PReLU ->
    maxpool -> SpatialDropout(0.2) -> conv64 -> PReLU."""
    return Sequential([
        Conv(64, 64, (3, 3)), PReLU(), MaxPool(2), SpatialDropout(0.2),
        Conv(64, 64, (3, 3)), PReLU(),
    ], name="st_tail")


def _st_prefix(image: ImageShape) -> FusedSTConvPReLU:
    """D*_st3's input prefix: a rotation-only ST -> conv64 -> PReLU."""
    return FusedSTConvPReLU(SpatialTransformer(image, True, False, False),
                            Conv(image[2], 64, (3, 3)), PReLU())


def create_D32_st3(image: ImageShape,
                   axis_name: Optional[str] = None) -> Sequential:
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
        _st_prefix(image),
        Conv(64, 64, (3, 3)), PReLU(),
        AvgPool(2), SpatialDropout(0.2),
        FusedSTBranches([_st_branch_tail(), _st_branch_tail(),
                         _st_branch_tail()], branch4, (h // 2, w // 2, 64)),
        SpatialDropout(0.5),
        Flatten(),
        Dense(n_feat, 256), PReLU(), Dropout(0.5),
        Dense(256, 1), Sigmoid(),
    ], name="D32_st3")


def _st_branch16_tail() -> Sequential:
    """A D16_st3 transformer-branch tail: two conv64 -> PReLU, no pool."""
    return Sequential([
        Conv(64, 64, (3, 3)), PReLU(),
        Conv(64, 64, (3, 3)), PReLU(),
    ], name="st_tail")


def create_D16_st3(image: ImageShape,
                   axis_name: Optional[str] = None) -> Sequential:
    """'D16_st3': D32_st3 without its pools, so the branches see the
    input's (h, w) at 64 channels."""
    h, w, c = image
    branch4 = Sequential([
        Conv(64, 128, (5, 5)), PReLU(),
        Conv(128, 128, (7, 7)), PReLU(),
    ], name="conv_branch")
    return Sequential([
        _st_prefix(image),
        Conv(64, 64, (3, 3)), PReLU(),
        FusedSTBranches([_st_branch16_tail(), _st_branch16_tail(),
                         _st_branch16_tail()], branch4, (h, w, 64)),
        SpatialDropout(0.5),
        Flatten(),
        Dense(h * w * (3 * 64 + 128), 256), PReLU(), Dropout(0.5),
        Dense(256, 1), Sigmoid(),
    ], name="D16_st3")


def create_D(image: ImageShape, axis_name: Optional[str] = None) -> Sequential:
    """Default D: D32_st3 at every scale."""
    return create_D32_st3(image, axis_name)


def create_V16(image: ImageShape,
               axis_name: Optional[str] = None) -> Sequential:
    """V16: two conv pairs (128, 256) with pools and spatial dropouts, two
    dense 1024 layers with BN and dropout, a 2-way softmax (fake, real)."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), LeakyReLU(),
        Conv(128, 128, (3, 3)), BatchNorm(128, axis_name), LeakyReLU(),
        MaxPool(2), SpatialDropout(0.2),
        Conv(128, 256, (3, 3)), LeakyReLU(),
        Conv(256, 256, (3, 3)), BatchNorm(256, axis_name), LeakyReLU(),
        MaxPool(2), SpatialDropout(0.5),
        Flatten(),
        Dense((h // 4) * (w // 4) * 256, 1024), BatchNorm(1024, axis_name),
        LeakyReLU(), Dropout(0.5),
        Dense(1024, 1024), BatchNorm(1024, axis_name),
        LeakyReLU(), Dropout(0.5),
        Dense(1024, 2), Softmax(),
    ], name="V16")


def create_V32(image: ImageShape,
               axis_name: Optional[str] = None) -> Sequential:
    """V32, the default V at 32px: V16's layers with a pool after the
    first conv and an elementwise dropout after the second pool."""
    h, w, c = image
    return Sequential([
        Conv(c, 128, (3, 3)), LeakyReLU(), MaxPool(2),
        Conv(128, 128, (3, 3)), BatchNorm(128, axis_name),
        LeakyReLU(), MaxPool(2),
        Dropout(0.5),
        Conv(128, 256, (3, 3)), LeakyReLU(),
        Conv(256, 256, (3, 3)), BatchNorm(256, axis_name),
        LeakyReLU(), MaxPool(2),
        SpatialDropout(0.5),
        Flatten(),
        Dense((h // 8) * (w // 8) * 256, 1024), BatchNorm(1024, axis_name),
        LeakyReLU(), Dropout(0.5),
        Dense(1024, 1024), BatchNorm(1024, axis_name),
        LeakyReLU(), Dropout(0.5),
        Dense(1024, 2), Softmax(),
    ], name="V32")


def create_V(image: ImageShape, axis_name: Optional[str] = None) -> Sequential:
    """Default V: V16 at 16px, V32 otherwise."""
    if image[0] == 16:
        return create_V16(image, axis_name)
    return create_V32(image, axis_name)


# ---------------------------------------------------------------------------
# registries (catgen's keys; an unknown key raises KeyError)
# ---------------------------------------------------------------------------

G_REGISTRY = {
    "mlp": create_G_decoder,
    "g16up": create_G_decoder_upsampling16,
    "g32up": create_G_decoder_upsampling32,
    "g32up_b": create_G_decoder_upsampling32b,
    "g32up_c": create_G_decoder_upsampling32c,
    "default": create_G,
}

D_REGISTRY = {
    "d16": create_D16,
    "d16b": create_D16b,
    "d32": create_D32,
    "d32b": create_D32b,
    "d32c": create_D32c,
    "d32d": create_D32d,
    "d32e": create_D32e,
    "d16_st3": create_D16_st3,
    "d32_st3": create_D32_st3,
    "default": create_D,
}

V_REGISTRY = {
    "v16": create_V16,
    "v32": create_V32,
    "default": create_V,
}
