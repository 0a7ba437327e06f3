"""catgen_torch: the PyTorch and CUDA port of catgen for NVIDIA Hopper.

A second package beside ``catgen`` (the JAX reference). Its layout mirrors
``catgen/`` module for module; it imports torch, numpy and the standard
library, never jax and never ``catgen``. Public functions keep catgen's
NHWC layout, and ``Sequential`` children keep catgen's ``{i:02d}_{Name}``
names, so a port ``state_dict`` maps one-to-one onto a catgen checkpoint
(``catgen_torch.io.convert``).
"""
