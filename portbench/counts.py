"""The yardstick of every roofline and ``mfu``: one function per operation
that counts the least work it needs, and the peaks that work is held to.

Operations (multiply-adds, MACs) are counted as the mathematics needs them,
whatever implements them:

  * a 'same' k x k convolution: every output pixel, output channel, input
    channel and tap;
  * a nearest-2x upsample followed by a k x k 'same' convolution: only the
    distinct taps that the upsampling leaves, 2 x 2 for k = 3 and 3 x 3
    for k = 5 (each output parity reads a (k+1)/2 x (k+1)/2 window of the
    input), so that a collapsed formulation is not counted twice;
  * a dense layer: in x out per row;
  * the nearest-neighbour search: one multiply-add per query, corpus image
    and value (the corpus norms could be kept, so they are not counted).

Bytes are each input read once and each output written once, in the
step's element size. Peaks are the published dense rates of one NVIDIA
H100 SXM. f32 work with TF32 off is held to the TF32 tensor-core rate,
495 TFLOP/s, not to the 67 TFLOP/s of the CUDA cores: 3xTF32 kernels and
Winograd-style convolutions stay f32-accurate and pass 67, and no
f32-accurate implementation passes 495.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional

# FLOP/s of the peak a step's precision is held to; HBM bytes/s
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12
ELEMENT_BYTES = {"float32": 4, "bfloat16": 2}


def distinct_taps(k: int) -> int:
    """Taps per axis that a nearest-2x upsample leaves of a k-wide window."""
    if k % 2 != 1:
        raise ValueError(f"odd kernel sizes only, got {k}")
    return (k + 1) // 2


@dataclasses.dataclass(frozen=True)
class Op:
    """One operation of a model at a batch: its forward MACs, the bytes its
    forward reads and writes, whether it holds parameters (a backward
    then computes their gradient) and whether it reads only the model's
    own input (its input gradient is then needed only where that input
    needs one)."""
    name: str
    kind: str
    macs: int
    bytes: int
    params: bool = True
    on_input: bool = False


def conv(name: str, n: int, h: int, w: int, cin: int, cout: int, k: int,
         eb: int = 4, on_input: bool = False) -> Op:
    """'same' k x k convolution (stride 1) with bias, (n, h, w, cin) ->
    (n, h, w, cout)."""
    macs = n * h * w * cout * cin * k * k
    nbytes = eb * (n * h * w * cin + cout * cin * k * k + cout
                   + n * h * w * cout)
    return Op(name, "conv", macs, nbytes, True, on_input)


def upconv(name: str, n: int, h: int, w: int, cin: int, cout: int, k: int,
           eb: int = 4, on_input: bool = False) -> Op:
    """Nearest-2x upsample of (n, h, w, cin), then a 'same' k x k
    convolution with bias to (n, 2h, 2w, cout): the distinct taps only."""
    t = distinct_taps(k)
    macs = n * (2 * h) * (2 * w) * cout * cin * t * t
    nbytes = eb * (n * h * w * cin + cout * cin * k * k + cout
                   + n * 4 * h * w * cout)
    return Op(name, "upconv", macs, nbytes, True, on_input)


def dense(name: str, n: int, fin: int, fout: int, eb: int = 4,
          on_input: bool = False) -> Op:
    macs = n * fin * fout
    nbytes = eb * (n * fin + fin * fout + fout + n * fout)
    return Op(name, "dense", macs, nbytes, True, on_input)


def sampler_forward_bytes(n: int, h: int, w: int, c: int, p: int,
                          eb: int = 4) -> int:
    """Bilinear sampling of (n, h, w, c) at p coordinate pairs an image:
    image and coordinates read, (n, p, c) written."""
    return eb * (n * h * w * c + n * 2 * p + n * p * c)


def sampler_dcoords_bytes(n: int, h: int, w: int, c: int, p: int,
                          eb: int = 4) -> int:
    """The coordinates' gradient: image, coordinates and the output's
    gradient read, (n, 2, p) written."""
    return eb * (n * h * w * c + n * 2 * p + n * p * c + n * 2 * p)


def sampler_dimg_bytes(n: int, h: int, w: int, c: int, p: int,
                       eb: int = 4) -> int:
    """The image's gradient: coordinates and the output's gradient read,
    (n, h, w, c) written."""
    return eb * (n * 2 * p + n * p * c + n * h * w * c)


def nn_search(n_queries: int, n_corpus: int, dim: int,
              eb: int = 4) -> Op:
    """Squared L2 distances of n_queries images to every corpus image and
    the argmin: the corpus and queries read once, an index and a distance
    written per query."""
    macs = n_queries * n_corpus * dim
    nbytes = eb * (n_corpus * dim + n_queries * dim) + 12 * n_queries
    return Op("nn_search", "nn", macs, nbytes, False, True)


def least_seconds(macs: int, nbytes: int, dtype: str = "float32") -> float:
    """The least time the card could take: operations at the peak of the
    precision or bytes at HBM's rate, whichever is longer."""
    return max(2.0 * macs / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)


def forward_macs(ops: Iterable[Op]) -> int:
    return sum(op.macs for op in ops)


def backward_macs(ops: Iterable[Op], weights: bool = True,
                  input_grad: bool = False) -> int:
    """MACs of a backward pass: each parameter gradient (``weights``) as
    many as the forward, and each input gradient as many as the forward,
    except for operations on the model's input where the input needs no
    gradient (``input_grad`` False)."""
    total = 0
    for op in ops:
        if weights and op.params:
            total += op.macs
        if input_grad or not op.on_input:
            total += op.macs
    return total


def gan_step_macs(g_ops_half: List[Op], g_ops_full: List[Op],
                  d_ops_full: List[Op]) -> int:
    """One GAN step (one D and one G iteration): the D phase runs G forward
    on B/2 noise rows without gradients and D forward and backward on B
    rows (reals and fakes need no input gradient); the G phase runs G
    forward on B rows, D forward on them, D's input gradients (its own
    parameters frozen) and G's backward (the noise needs none)."""
    d_phase = (forward_macs(g_ops_half) + forward_macs(d_ops_full)
               + backward_macs(d_ops_full))
    g_phase = (forward_macs(g_ops_full) + forward_macs(d_ops_full)
               + backward_macs(d_ops_full, weights=False, input_grad=True)
               + backward_macs(g_ops_full))
    return d_phase + g_phase


def share_percent(bound_s: float, measured_s: Optional[float]
                  ) -> Optional[float]:
    """``bound_s / measured_s`` in percent; None where nothing was
    measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
