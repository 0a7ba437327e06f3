from catgen_torch.models.refine import (  # noqa: F401
    RefineStage,
    create_D64,
    create_G64_stack,
    create_G_refine64,
)
from catgen_torch.models.zoo import (  # noqa: F401
    D_REGISTRY,
    G_REGISTRY,
    V_REGISTRY,
    create_D,
    create_D32_st3,
    create_G,
    create_G_autoencoder,
    create_G_decoder_upsampling32c,
    create_G_encoder32,
    create_V,
    create_V16,
    create_V32,
)

# the 64px pyramid stage's entries, registered here as catgen registers them
G_REGISTRY["g64_stack"] = create_G64_stack
G_REGISTRY["refine64"] = create_G_refine64
D_REGISTRY["d64"] = create_D64
