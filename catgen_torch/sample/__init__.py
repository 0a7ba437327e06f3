from catgen_torch.sample.sampler import (  # noqa: F401
    dist2_matrix,
    generate_batched,
    interleave_pairs,
    nearest_neighbours,
    neighbours_of_best,
    nn_l2_mean,
    rank_by_d,
    sample_and_rank,
    self_nn_mean,
)
