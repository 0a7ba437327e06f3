"""Checkpoint inspector, numpy only: a copy of ``catgen/cli/show_ckpt.py``
(``th show_model_content.lua``). Prints the metadata and per-subtree
array summaries of any catgen-format checkpoint, written by either
package.

    python -m catgen_torch.cli.show_ckpt logs/adversarial.ckpt
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path")
    p.add_argument("--full", action="store_true",
                   help="print every leaf (default: summary by subtree)")
    args = p.parse_args(argv)

    with np.load(args.path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        print("meta:", json.dumps(meta, indent=2))
        groups = {}
        for key in z.files:
            if key == "__meta__":
                continue
            arr = z[key]
            if args.full:
                print(f"{key}: shape={arr.shape} dtype={arr.dtype} "
                      f"mean={arr.mean():.5f} std={arr.std():.5f}")
            # keys look like ".g_params['00_Dense']['kernel']" or
            # "['params']['01_Conv']['bias']"
            top = key.lstrip(".[' ").split("[")[0].split("'")[0] or \
                key.split("'")[1]
            n, s = groups.get(top, (0, 0))
            groups[top] = (n + 1, s + arr.size)
        print(f"{'subtree':30s} {'leaves':>8s} {'params':>12s}")
        for top, (n, s) in sorted(groups.items()):
            print(f"{top:30s} {n:8d} {s:12d}")
        total = sum(s for _, s in groups.values())
        print(f"{'TOTAL':30s} {'':8s} {total:12d}")


if __name__ == "__main__":
    main()
