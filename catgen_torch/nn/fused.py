"""G decoder ladder: the counterpart of ``catgen/nn/fused.py``.

catgen's ``FusedDecoderSequential`` runs ``[UpsampleConv, BatchNorm,
PReLU]`` groups as boundary-fused Pallas stages only when the upsample
implementation is ``pallas``; on its default path it is a plain
``Sequential``. The port has no upsample-conv kernel yet (ROADMAP Queue B,
items 3-6), so here it is that plain ``Sequential``: same children, same
names, same parameters.
"""

from __future__ import annotations

from catgen_torch.core.module import Sequential


class FusedDecoderSequential(Sequential):
    """A ``Sequential`` whose upsample-conv stages will fuse once the
    Hopper ladder kernel exists."""
