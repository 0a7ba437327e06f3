"""Plain forward passes of catgen's models, each with its table of
operations for ``portbench/counts.py``. Weights are looked up by the
program's ``state_dict`` names, which the benchmark's weight maker uses
for the tensors it hands to both sides. D functions return logits (the
final sigmoid peeled) and draw dropout masks, in the order the forward
reaches them, only when ``draws`` is given (training mode).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from portbench import counts as C
from portbench.reference import nn as R

# ---------------------------------------------------------------------------
# G32up-c: dense 100 -> 4x4x512, PReLU, three (upsample, conv, BN, PReLU)
# stages 512 -> 512 (k3), 512 -> 256 (k3), 256 -> 128 (k5), conv 3x3 to the
# image, sigmoid
# ---------------------------------------------------------------------------

G32UPC_STAGES = ((3, 512, 512, 3), (6, 512, 256, 3), (9, 256, 128, 5))


def g32upc(w: R.Weights, z: torch.Tensor, train: bool) -> torch.Tensor:
    x = R.prelu(R.dense(z, w, "00_Dense."), w("01_PReLU.alpha"))
    x = x.reshape(-1, 4, 4, 512)
    for i, _, _, _ in G32UPC_STAGES:
        x = R.conv(R.upsample2(x), w, f"{i:02d}_UpsampleConv.")
        x = R.batchnorm(x, w, f"{i + 1:02d}_BatchNorm.", train)
        x = R.prelu(x, w(f"{i + 2:02d}_PReLU.alpha"))
    return torch.sigmoid(R.conv(x, w, "12_Conv."))


def g32upc_ops(n: int, channels: int = 3) -> List[C.Op]:
    ops = [C.dense("seed", n, 100, 512 * 16, on_input=True)]
    h = 4
    for i, cin, cout, k in G32UPC_STAGES:
        ops.append(C.upconv(f"stage{len(ops)}", n, h, h, cin, cout, k))
        h *= 2
    ops.append(C.conv("out", n, 32, 32, 128, channels, 3))
    return ops


# ---------------------------------------------------------------------------
# D32_st3: rotation-only transformer on the input, conv64 + PReLU; conv64,
# PReLU, avgpool, spatial dropout 0.2; three transformer branches (angle,
# scale, translation; tails conv64, PReLU, maxpool, spatial dropout 0.2,
# conv64, PReLU) beside a conv branch (conv128 5x5, PReLU, maxpool, spatial
# dropout 0.2, conv128 7x7, PReLU), concatenated; spatial dropout 0.5,
# dense 256, PReLU, dropout 0.5, dense 1
# ---------------------------------------------------------------------------


def _transform(x: torch.Tensor, w: R.Weights, loc: str, head: str,
               flags) -> torch.Tensor:
    feats = R.localization(x, w.sub(loc))
    params = R.dense(feats, w, head)
    return R.affine_theta(params, *flags)


def d32st3(w: R.Weights, x: torch.Tensor, draws=None) -> torch.Tensor:
    train = draws is not None
    n, h, wd, _ = x.shape
    p = w.sub("00_FusedSTConvPReLU.")
    theta = _transform(x, p, "st.loc.", "st.head.", (True, False, False))
    y = R.sample(x, R.grid_points(theta, h, wd))
    y = R.prelu(R.conv(y, p, "conv."), p("act.alpha"))
    y = R.prelu(R.conv(y, w, "01_Conv."), w("02_PReLU.alpha"))
    y = R.avgpool2(y)
    if train:
        y = R.dropout(y, draws, 0.2, spatial=True)
    b = w.sub("05_FusedSTBranches.")
    hh, ww = y.shape[1:3]
    sampled = [R.sample(y, R.grid_points(
        _transform(y, b, f"loc{i}.", f"head{i}.", (True, True, True)),
        hh, ww)) for i in range(3)]
    outs = []
    for i in range(3):
        t = b.sub(f"tail{i}.")
        v = R.prelu(R.conv(sampled[i], t, "00_Conv."), t("01_PReLU.alpha"))
        v = R.maxpool2(v)
        if train:
            v = R.dropout(v, draws, 0.2, spatial=True)
        outs.append(R.prelu(R.conv(v, t, "04_Conv."), t("05_PReLU.alpha")))
    t = b.sub("plain.")
    v = R.maxpool2(R.prelu(R.conv(y, t, "00_Conv."), t("01_PReLU.alpha")))
    if train:
        v = R.dropout(v, draws, 0.2, spatial=True)
    outs.append(R.prelu(R.conv(v, t, "04_Conv."), t("05_PReLU.alpha")))
    y = torch.cat(outs, -1)
    if train:
        y = R.dropout(y, draws, 0.5, spatial=True)
    y = R.prelu(R.dense(R.flatten(y), w, "08_Dense."), w("09_PReLU.alpha"))
    if train:
        y = R.dropout(y, draws, 0.5)
    return R.dense(y, w, "11_Dense.")


def _localization_ops(name: str, n: int, h: int, c: int,
                      n_params: int, on_input: bool) -> List[C.Op]:
    q = h // 2
    return [C.conv(f"{name}.conv1", n, q, q, c, 16, 3, on_input=on_input),
            C.conv(f"{name}.conv2", n, q, q, 16, 16, 3),
            C.dense(f"{name}.dense", n, 16 * (h // 4) * (h // 4), 64),
            C.dense(f"{name}.head", n, 64, n_params)]


def d32st3_ops(n: int, channels: int = 3) -> List[C.Op]:
    ops = _localization_ops("prefix.loc", n, 32, channels, 1, True)
    ops += [C.conv("prefix.conv", n, 32, 32, channels, 64, 3),
            C.conv("stem", n, 32, 32, 64, 64, 3)]
    for i in range(3):
        ops += _localization_ops(f"loc{i}", n, 16, 64, 4, False)
        ops += [C.conv(f"tail{i}.conv1", n, 16, 16, 64, 64, 3),
                C.conv(f"tail{i}.conv2", n, 8, 8, 64, 64, 3)]
    ops += [C.conv("plain.conv1", n, 16, 16, 64, 128, 5),
            C.conv("plain.conv2", n, 8, 8, 128, 128, 7),
            C.dense("head1", n, 8 * 8 * 320, 256),
            C.dense("head2", n, 256, 1)]
    return ops


def d32st3_sampler_calls(n: int, channels: int = 3,
                         input_grad: bool = False) -> dict:
    """The bilinear samplings of one D32_st3 forward and backward on n
    images: (n, h, w, c, points) each; the input transformer's image
    gradient only where D's input needs one."""
    prefix = (n, 32, 32, channels, 32 * 32)
    branches = (n, 16, 16, 64, 3 * 16 * 16)
    return {"forward": [prefix, branches],
            "dcoords": [prefix, branches],
            "dimg": ([prefix] if input_grad else []) + [branches]}


# ---------------------------------------------------------------------------
# G64_stack: G32up-c, then the refine stage: base = bilinear 2x resize;
# trunk conv64, PReLU, upsample + conv64 k5, BN, PReLU, conv32, PReLU; head
# conv over [trunk; base] to the image; clip(base + 0.5 tanh(head), 0, 1)
# ---------------------------------------------------------------------------


def refine(w: R.Weights, x: torch.Tensor, train: bool) -> torch.Tensor:
    n, h, wd, _ = x.shape
    base = R.resize_bilinear(x, 2 * h, 2 * wd)
    t = w.sub("trunk.")
    f = R.prelu(R.conv(x, t, "00_Conv."), t("01_PReLU.alpha"))
    f = R.conv(R.upsample2(f), t, "02_UpsampleConv.")
    f = R.prelu(R.batchnorm(f, t, "03_BatchNorm.", train),
                t("04_PReLU.alpha"))
    f = R.prelu(R.conv(f, t, "05_Conv."), t("06_PReLU.alpha"))
    residual = R.conv(torch.cat([f, base], -1), w, "head.")
    return torch.clamp(base + 0.5 * torch.tanh(residual), 0.0, 1.0)


def g64stack(w: R.Weights, z: torch.Tensor, train: bool) -> torch.Tensor:
    return refine(w.sub("01_RefineStage."),
                  g32upc(w.sub("00_G32up_c."), z, train), train)


def refine_ops(n: int, channels: int = 3, width: int = 64) -> List[C.Op]:
    return [C.conv("refine.conv1", n, 32, 32, channels, width, 3),
            C.upconv("refine.upconv", n, 32, 32, width, width, 5),
            C.conv("refine.conv2", n, 64, 64, width, width // 2, 3),
            C.conv("refine.head", n, 64, 64, width // 2 + channels,
                   channels, 3)]


def g64stack_ops(n: int, channels: int = 3) -> List[C.Op]:
    return g32upc_ops(n, channels) + refine_ops(n, channels)


# ---------------------------------------------------------------------------
# D64: conv 64, 128, 128, 256 (each PReLU, spatial dropout 0.2, avgpool),
# conv 256, PReLU, spatial dropout 0.5; dense 1024, 512 (PReLU, dropout
# 0.5), dense 1
# ---------------------------------------------------------------------------

D64_CONVS = ((0, 64), (4, 128), (8, 128), (12, 256), (16, 256))


def d64(w: R.Weights, x: torch.Tensor, draws=None) -> torch.Tensor:
    train = draws is not None
    for j, (i, _) in enumerate(D64_CONVS):
        x = R.prelu(R.conv(x, w, f"{i:02d}_Conv."), w(f"{i + 1:02d}_PReLU.alpha"))
        last = j == len(D64_CONVS) - 1
        if train:
            x = R.dropout(x, draws, 0.5 if last else 0.2, spatial=True)
        if not last:
            x = R.avgpool2(x)
    x = R.flatten(x)
    for i in (20, 23):
        x = R.prelu(R.dense(x, w, f"{i:02d}_Dense."),
                    w(f"{i + 1:02d}_PReLU.alpha"))
        if train:
            x = R.dropout(x, draws, 0.5)
    return R.dense(x, w, "26_Dense.")


def d64_ops(n: int, channels: int = 3) -> List[C.Op]:
    ops, h, cin = [], 64, channels
    for j, (_, cout) in enumerate(D64_CONVS):
        ops.append(C.conv(f"conv{j}", n, h, h, cin, cout, 3,
                          on_input=j == 0))
        cin = cout
        if j < len(D64_CONVS) - 1:
            h //= 2
    return ops + [C.dense("dense1", n, 4 * 4 * 256, 1024),
                  C.dense("dense2", n, 1024, 512),
                  C.dense("dense3", n, 512, 1)]


def augment_sampler_calls(n: int, size: int, channels: int = 3) -> dict:
    """The augmentation's one forward sampling of the n real images."""
    return {"forward": [(n, size, size, channels, size * size)],
            "dcoords": [], "dimg": []}


def merge_calls(*calls: Optional[dict]) -> dict:
    out = {"forward": [], "dcoords": [], "dimg": []}
    for c in calls:
        for k in out:
            out[k] += (c or {}).get(k, [])
    return out
