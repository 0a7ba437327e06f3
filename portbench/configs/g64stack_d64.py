"""Plain reference of g64stack_d64: G64_stack (G32up-c and the refine
stage) against D64 at 64x64x3 (``portbench/reference/models.py``), and its
operations for the counts."""

from portbench.reference import models as M
from portbench.reference.nn import Weights


def g_forward(weights, noise, train):
    return M.g64stack(Weights(weights), noise, train)


def d_forward(weights, images, draws=None):
    return M.d64(Weights(weights), images, draws)


def g_ops(n):
    return M.g64stack_ops(n)


def d_ops(n):
    return M.d64_ops(n)


def train_sampler_calls(batch):
    """The samplings of one step: the reals' augmentation only (D64 has no
    transformer)."""
    return M.augment_sampler_calls(batch // 2, 64)
