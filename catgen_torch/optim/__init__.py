from catgen_torch.optim.optimizers import (AdagradState, AdamState,
                                          Optimizer, RmspropState, SgdState,
                                          adagrad, adam, apply_updates,
                                          clamp_and_penalize, make, rmsprop,
                                          select, sgd)

__all__ = ["AdagradState", "AdamState", "Optimizer", "RmspropState",
           "SgdState", "adagrad", "adam", "apply_updates",
           "clamp_and_penalize", "make", "rmsprop", "select", "sgd"]
