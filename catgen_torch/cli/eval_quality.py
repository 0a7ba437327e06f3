"""Quality evaluation CLI: the counterpart of ``catgen/cli/eval_quality.py``.

Computes the quality statistics of a trained adversarial checkpoint (the
D-score distributions, the nearest-neighbour L2 distribution, diversity
and, with a V checkpoint in ``--save``, V's ratings;
``catgen_torch.eval.quality``) and writes ``<save>/quality_report.json``:

    python -m catgen_torch.cli.eval_quality --save logs --device cuda
    python -m catgen_torch.cli.eval_quality --save logs \\
        --network logs/adversarial.ckpt --samples 1024

The checkpoint's metadata rebuilds G and D (``cli.sample.load_gan``), so
no model flag is needed; the corpus is loaded at the checkpoint's scale
and colorspace, always in [0, 1]. catgen's ``--platform`` becomes
``--device``.
"""

from __future__ import annotations

import argparse
import json
import os

from catgen_torch import models
from catgen_torch.cli.common import (add_common_args, add_dataset_args,
                                     build_dataset, refuse_data_parallel,
                                     resolve_device)
from catgen_torch.cli.sample import load_gan
from catgen_torch.eval.quality import quality_report, summarize
from catgen_torch.io import checkpoint as ckpt
from catgen_torch.train.harness import load_variables


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    add_common_args(p)
    add_dataset_args(p)
    p.add_argument("--network", default="",
                   help="checkpoint to evaluate (default "
                        "<save>/adversarial.ckpt)")
    p.add_argument("--samples", type=int, default=1024,
                   help="generated sample count (sample.lua uses 1024)")
    p.add_argument("--out", default="",
                   help="report path (default <save>/quality_report.json)")
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    refuse_data_parallel(args, "cli.eval_quality")
    device = resolve_device(args.device)
    path = args.network or os.path.join(args.save,
                                        ckpt.adversarial_filename())
    meta = ckpt.load_meta(path)
    hc = meta.get("config", {})
    g, d, config = load_gan(path, device)

    # the corpus at the checkpoint's scale and colorspace, always in [0, 1]
    # (G's samples are); a D trained with --normalize saw its reals in
    # [-1, 1], which quality_report gives it for its real-score pass
    args.scale, args.colorSpace = config.scale, config.colorspace
    args.normalize = False
    dataset = build_dataset(args, device)
    corpus = dataset.load_images(0, len(dataset))

    v = None
    h, w, c = config.image_shape
    v_path = os.path.join(args.save, ckpt.v_filename(c, h, w))
    if os.path.exists(v_path):
        v = models.V_REGISTRY[hc.get("v_model", "default")](
            config.image_shape)
        load_variables(v, v_path)
        v = v.to(device)

    report = quality_report(g, d, corpus, noise_dim=config.noise_dim,
                            n_samples=args.samples, seed=args.seed, v=v,
                            normalized_inputs=bool(hc.get("normalize",
                                                          False)))
    report["checkpoint"] = path
    report["epoch"] = int(meta.get("epoch", -1))

    out = args.out or os.path.join(args.save, "quality_report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[eval_quality] epoch {report['epoch']} -> {out}")
    print(summarize(report))
    return report


if __name__ == "__main__":
    main()
