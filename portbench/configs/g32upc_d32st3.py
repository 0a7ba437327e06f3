"""Plain reference of g32upc_d32st3: G32up-c against D32_st3 at 32x32x3
(``portbench/reference/models.py``), and its operations for the counts."""

from portbench.reference import models as M
from portbench.reference.nn import Weights


def g_forward(weights, noise, train):
    return M.g32upc(Weights(weights), noise, train)


def d_forward(weights, images, draws=None):
    return M.d32st3(Weights(weights), images, draws)


def g_ops(n):
    return M.g32upc_ops(n)


def d_ops(n):
    return M.d32st3_ops(n)


def train_sampler_calls(batch):
    """The samplings of one step: the reals' augmentation, D on the D
    phase's batch (its input needs no gradient) and on the G phase's."""
    return M.merge_calls(M.augment_sampler_calls(batch // 2, 32),
                         M.d32st3_sampler_calls(batch),
                         M.d32st3_sampler_calls(batch, input_grad=True))
