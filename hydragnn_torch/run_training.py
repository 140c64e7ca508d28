"""JSON-config-driven training entry point (port of
hydragnn_tpu/run_training.py).

Accepts a config file path or dict, then: data loading and splitting ->
config finalization -> run log and saved config -> model -> optimizer ->
train/validate/test loop (plateau LR, early stop, best checkpoint) ->
final checkpoint.  Single process; ``device=None`` means the card, and
without one the call raises unless ``device="cpu"`` is passed.

``Architecture.aggregation_backend`` pins the aggregation backend for
the duration of the run, unless the user set ``HYDRAGNN_AGGR_BACKEND``
(the reference's scoped export).  Under ``fused`` every marked batch runs
forward and backward through the hand-written kernels.  Resuming a run
(``Training.continue``) and the TensorBoard writer are not ported yet.
"""

from __future__ import annotations

import functools
import json
import os

from hydragnn_torch.config.config import get_log_name_config, save_config
from hydragnn_torch.data.load_data import dataset_loading_and_splitting
from hydragnn_torch.models.base import ModelConfig
from hydragnn_torch.models.create import create_model
from hydragnn_torch.ops.aggregate import KNOWN_BACKENDS
from hydragnn_torch.train.optimizer import select_optimizer
from hydragnn_torch.train.trainer import (
    create_train_state,
    refuse_unported,
    save_state,
    train_validate_test,
)
from hydragnn_torch.utils.device import resolve_device
from hydragnn_torch.utils.print_utils import setup_log


@functools.singledispatch
def run_training(config, **kwargs):
    raise TypeError("Input must be filename string or configuration dictionary.")


@run_training.register
def _(config_file: str, **kwargs):
    with open(config_file, "r") as f:
        config = json.load(f)
    return run_training(config, **kwargs)


@run_training.register
def _(config: dict, logs_dir: str = "./logs/", seed: int = 0, device=None):
    dev = resolve_device(device)
    os.environ.setdefault("SERIALIZED_DATA_PATH", os.getcwd())
    backend = (config.get("NeuralNetwork", {}).get("Architecture", {})
               .get("aggregation_backend"))
    if backend and str(backend) not in KNOWN_BACKENDS:
        raise ValueError(
            f"Architecture.aggregation_backend {backend!r} is not one of "
            f"{KNOWN_BACKENDS}")
    # scoped: the config's choice holds for this run only, and a user-set
    # HYDRAGNN_AGGR_BACKEND is never touched
    exported = bool(backend) and "HYDRAGNN_AGGR_BACKEND" not in os.environ
    if exported:
        os.environ["HYDRAGNN_AGGR_BACKEND"] = str(backend)
    try:
        return _run_training_dict(config, logs_dir, seed, dev)
    finally:
        if exported:
            os.environ.pop("HYDRAGNN_AGGR_BACKEND", None)


def _run_training_dict(config: dict, logs_dir: str, seed: int, dev):
    verbosity = config.get("Verbosity", {}).get("level", 0)
    training = config["NeuralNetwork"]["Training"]
    if training.get("continue", 0):
        raise NotImplementedError(
            "Training.continue (resuming a run) is not ported yet — "
            "ROADMAP queue A7")
    refuse_unported(training, config.get("Telemetry"),
                    defaults_written=False)
    train_loader, val_loader, test_loader, config = \
        dataset_loading_and_splitting(config, seed=seed)

    log_name = get_log_name_config(config)
    setup_log(log_name, logs_dir)
    save_config(config, log_name, logs_dir)

    cfg = ModelConfig.from_config(config["NeuralNetwork"])
    model = create_model(cfg, seed=seed).to(dev)
    training = config["NeuralNetwork"]["Training"]
    opt_spec = select_optimizer(training["Optimizer"],
                                zero_stage=int(training.get("zero_stage", 0)
                                               or 0))
    state = create_train_state(model, opt_spec)
    state, history = train_validate_test(
        model, cfg, state, opt_spec, train_loader, val_loader, test_loader,
        config["NeuralNetwork"], log_name, verbosity, logs_dir=logs_dir,
        device=dev, telemetry_config=config.get("Telemetry"))
    save_state(state, log_name, logs_dir)
    return state, history, config
