"""The run tools of the port: the counterparts of catgen's ``tools/``
scripts that work on runs, each run as ``python -m catgen_torch.tools.<name>``:

  * ``slim_ckpt``: a checkpoint without its optimizer states;
  * ``rescue``: resume a collapsed run from its last healthy checkpoint;
  * ``seed_sweep``: the full workflow over seeds and D gates, a table;
  * ``report``: one self-contained HTML report of a run (``--watch``);
  * ``audit_table``: the collapse A/B table of several sweeps;
  * ``longrun.sh``, ``collect_longrun_artifacts.sh``: the reference recipe
    on the fixture corpus, and the artifact set of such a run.

They read and write what the port's CLIs write, in catgen's formats, and
start the port's CLIs (``catgen_torch.cli.*``), never catgen's.
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List

# the directory that holds the ``catgen_torch`` package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def module_cmd(mod: str, *args) -> List[str]:
    """``python -m mod args...`` with this interpreter."""
    return [sys.executable, "-m", mod] + [str(a) for a in args]


def child_env() -> Dict[str, str]:
    """The environment of a child CLI: this one, with the port's root first
    on ``PYTHONPATH``, so ``-m catgen_torch...`` resolves from any working
    directory."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH", "")) if p)
    return env
