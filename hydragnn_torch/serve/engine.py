"""Inference-only checkpoint state (``load_inference_state`` and
``InferenceState`` of hydragnn_tpu/serve/engine.py), plus the writer the
port needs to make such a checkpoint without JAX.

The checkpoint is the JAX run's own single-file pickle
(``logs/<log_name>/<log_name>.pk``: ``step``, ``params``, ``batch_stats``
as numpy flax trees, and ``opt_state``).  ``opt_state`` holds optax
classes that cannot be unpickled without optax, so the reader maps every
``optax``/``jax``/``flax`` class to an inert placeholder and keeps only
``step``, ``params`` and ``batch_stats``.  :func:`save_inference_checkpoint`
writes those three keys in the same format, which the JAX package's
``load_inference_state`` reads too.  Only checkpoints this program (or the
JAX package) wrote should be loaded: unpickling can run code.
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import pickle
from typing import Any

import numpy as np

from hydragnn_torch.config.config import get_log_name_config
from hydragnn_torch.resilience.ckpt_io import atomic_write_pickle

_FOREIGN = ("optax", "jax", "jaxlib", "flax", "chex")


class _Inert:
    """Stand-in for a class of a framework the port does not import."""

    def __new__(cls, *args, **kwargs):
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _CheckpointUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] in _FOREIGN:
            return _Inert
        return super().find_class(module, name)


def read_checkpoint(fname: str) -> dict:
    """``{step, params, batch_stats}`` of a run checkpoint."""
    with open(fname, "rb") as f:
        payload = _CheckpointUnpickler(io.BytesIO(f.read())).load()
    return {k: payload[k] for k in ("step", "params", "batch_stats")}


@dataclasses.dataclass
class InferenceState:
    """Eval-only slice of a train state: no optimizer state."""

    step: Any
    params: Any
    batch_stats: Any


def load_inference_state(config, logs_dir: str = "./logs/") -> InferenceState:
    """Load a run's checkpoint (``config`` is a dict or a path to one)."""
    if isinstance(config, str):
        with open(config) as f:
            config = json.load(f)
    log_name = get_log_name_config(config)
    payload = read_checkpoint(os.path.join(logs_dir, log_name,
                                           f"{log_name}.pk"))
    return InferenceState(step=int(np.asarray(payload["step"])),
                          params=payload["params"],
                          batch_stats=payload["batch_stats"] or {})


def save_inference_checkpoint(module, log_name: str, path: str = "./logs/",
                              step: int = 0) -> str:
    """Write ``module``'s weights and BatchNorm running statistics as
    ``{step, params, batch_stats}`` to
    ``<path>/<log_name>/<log_name>.pk``, atomically."""
    from hydragnn_torch.utils.weights import (
        flax_batch_stats_from_module,
        flax_params_from_module,
    )

    fname = os.path.join(path, log_name, f"{log_name}.pk")
    atomic_write_pickle(fname, {
        "step": np.asarray(step, np.int32),
        "params": flax_params_from_module(module),
        "batch_stats": flax_batch_stats_from_module(module),
    })
    return fname
