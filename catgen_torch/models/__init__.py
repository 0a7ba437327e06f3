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
