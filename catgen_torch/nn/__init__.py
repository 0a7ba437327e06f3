from catgen_torch.nn.layers import (  # noqa: F401
    AvgPool,
    BatchNorm,
    Conv,
    Dense,
    Dropout,
    Flatten,
    LeakyReLU,
    MaxPool,
    PReLU,
    Reshape,
    Sigmoid,
    Softmax,
    SpatialDropout,
    SubPixelConv,
    Tanh,
    UnPooling,
    UpsampleNearest,
)
from catgen_torch.nn.spatial_transformer import (  # noqa: F401
    SpatialTransformer,
    affine_grid,
    affine_matrix,
    bilinear_sample,
    warp_flow,
)
from catgen_torch.core.module import Sequential  # noqa: F401


def __getattr__(name):
    # catgen's nn exports UpsampleConv too; its module imports nn.layers,
    # so it is loaded on first use rather than with this package
    if name == "UpsampleConv":
        from catgen_torch.kernels.upsample_conv import UpsampleConv
        return UpsampleConv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
