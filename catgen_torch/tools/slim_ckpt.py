"""A checkpoint without its optimizer states, for archived runs: the
counterpart of catgen's ``tools/slim_ckpt.py``.

A full ``adversarial.ckpt`` carries both Adam moment sets (about three
times the parameters' bytes). Sampling, D's ranking, ``eval_quality`` and a
``--rebuildOptstate`` resume need only the models, so this strips the
optimizer leaves (``.g_opt``, ``.d_opt``, ``.opt``) and writes the rest in
catgen's format with ``"slim": true`` in the metadata:

    python -m catgen_torch.tools.slim_ckpt run/adversarial.ckpt \\
        out/adversarial_slim.ckpt

Unlike catgen's, a key is stripped only when it is one of the prefixes or
continues it with ``[`` or ``.`` (``.g_opt_note`` stays), and the output
is written to ``<dst>.tmp`` and moved into place, so a failed write leaves
``dst`` as it was.
"""

from __future__ import annotations

import io
import json
import os
import sys

import numpy as np

STRIP_PREFIXES = (".g_opt", ".d_opt", ".opt")


def is_optimizer_key(key: str) -> bool:
    """Whether ``key`` lies under one of ``STRIP_PREFIXES``."""
    return any(key == p or (key.startswith(p) and key[len(p)] in "[.")
               for p in STRIP_PREFIXES)


def slim(src: str, dst: str) -> dict:
    with np.load(src) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        keep = {k: z[k] for k in z.files
                if k != "__meta__" and not is_optimizer_key(k)}
        dropped = len(z.files) - 1 - len(keep)
    meta["slim"] = True
    buf = io.BytesIO()
    np.savez(buf, __meta__=np.frombuffer(
        json.dumps(meta).encode(), dtype=np.uint8), **keep)
    os.makedirs(os.path.dirname(os.path.abspath(dst)), exist_ok=True)
    tmp = dst + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(buf.getvalue())
        os.replace(tmp, dst)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"kept": len(keep), "dropped": dropped,
            "bytes": os.path.getsize(dst)}


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit("usage: python -m catgen_torch.tools.slim_ckpt "
                         "SRC DST")
    src, dst = argv
    r = slim(src, dst)
    print(f"[slim_ckpt] {src} -> {dst}: kept {r['kept']} leaves, "
          f"dropped {r['dropped']} optimizer leaves, "
          f"{r['bytes'] / 1e6:.1f} MB")


if __name__ == "__main__":
    main()
