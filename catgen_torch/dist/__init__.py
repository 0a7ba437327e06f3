"""Data parallelism over ``torch.distributed``: the counterpart of
``catgen/dist/``. ``mesh`` holds the process group and its collectives,
``dp`` the data-parallel steps and epochs, ``launch`` starts the local
ranks of ``--devices N``."""
