"""Verbosity-gated printing and run logging (a copy of
hydragnn_tpu/utils/print_utils.py for a single process: rank 0).

Levels: 0 silent; 1-2 rank 0; 3-4 every rank (``[rank 0]`` prefix).
``setup_log`` logs to ``<logs_dir>/<run>/run.log`` and to stdout.
"""

from __future__ import annotations

import logging
import os
import sys

_MAX_VERBOSITY_LEVELS = 5
_LOGGER = "hydragnn_torch"


def print_distributed(verbosity_level: int, *args, **kwargs):
    assert 0 <= verbosity_level < _MAX_VERBOSITY_LEVELS, "unknown verbosity"
    if verbosity_level in (1, 2):
        print(*args, **kwargs)
    elif verbosity_level in (3, 4):
        print("[rank 0]", *args, **kwargs)


def setup_log(log_name: str, logs_dir: str = "./logs/") -> None:
    """File+console logging with a rank prefix."""
    d = os.path.join(logs_dir, log_name)
    os.makedirs(d, exist_ok=True)
    fmt = logging.Formatter("%(levelname)s (rank 0): %(message)s")
    root = logging.getLogger(_LOGGER)
    root.setLevel(logging.INFO)
    for h in list(root.handlers):
        h.close()
    root.handlers.clear()
    fh = logging.FileHandler(os.path.join(d, "run.log"))
    fh.setFormatter(fmt)
    root.addHandler(fh)
    sh = logging.StreamHandler(sys.stdout)
    sh.setFormatter(fmt)
    root.addHandler(sh)
