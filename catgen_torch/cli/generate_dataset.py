"""Offline dataset generation CLI: the counterpart of
``catgen/cli/generate_dataset.py`` (the reference's ``python
generate_dataset.py``). Normalizes and augments a keypoint-annotated
cat corpus (``CAT_00`` .. ``CAT_06`` of JPEGs with ``.cat`` keypoint
files) into 64x64 face crops, on the host (numpy and PIL):

    python -m catgen_torch.cli.generate_dataset --path /data/10k_cats \
        --out /data/catgen --workers 8
"""

from __future__ import annotations

import argparse
import time

from catgen_torch.data.offline import generate_dataset, scan_corpus, \
    write_debug_draws


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--path", required=True,
                   help="dataset root containing CAT_00..CAT_06")
    p.add_argument("--out", default=".", help="output root")
    p.add_argument("--padding", type=int, default=30)
    p.add_argument("--augmentations", type=int, default=9)
    p.add_argument("--scale", type=int, default=64)
    p.add_argument("--workers", type=int, default=0,
                   help="process pool size (0 = single process)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--debug-draw", type=int, default=0, metavar="N",
                   help="before generating, write keypoint/rect overlay "
                        "PNGs + augmentation contact sheets for the first "
                        "N corpus images to <out>/debug_draw (the "
                        "reference's matplotlib visualizers, "
                        "dataset.py:313-372, ImageAugmenter.py:647-738)")
    args = p.parse_args(argv)
    if args.debug_draw:
        import os

        dbg = os.path.join(args.out, "debug_draw")
        paths = scan_corpus(args.path)[:args.debug_draw]
        for i, path in enumerate(paths):
            written = write_debug_draws(path, i, dbg, args.padding,
                                        args.augmentations, args.seed)
            print(f"[debug-draw] {path} -> {len(written)} PNGs in {dbg}")
    t0 = time.time()
    n_images, n_written = generate_dataset(
        args.path, args.out, args.padding, args.augmentations, args.scale,
        args.workers, args.seed)
    dt = time.time() - t0
    print(f"processed {n_images} images -> {n_written} files "
          f"in {dt:.1f}s ({n_images / max(dt, 1e-9):.1f} img/s)")


if __name__ == "__main__":
    main()
