"""Training loop and evaluation (port of hydragnn_tpu/train/trainer.py).

The reference jit-compiles one train step (forward, weighted multi-task
loss, backward, optax update) and drives epochs from the host with a
plateau LR scheduler, early stopping and a best-validation checkpoint.
The port runs the same step eagerly on the device: the weights live in
the module, the optimizer state in :class:`TrainState`, and the update is
the optax-semantics transformation of train/optimizer.py.  Under
``HYDRAGNN_AGGR_BACKEND=fused`` forward and backward go through the
hand-written kernels (ops/fused_mp.py, ops/scf_mp.py).

``ReduceLROnPlateau``, ``EarlyStopping`` and ``CheckpointTracker`` are
copies of the reference's (not ``torch.optim.lr_scheduler``): no cooldown,
no eps, the reference's own bad-epoch counting.

What the reference's loop offers and this slice does not port raises
``NotImplementedError`` when it is asked for (:func:`refuse_unported`):
the force self-consistency term, more than one step per dispatch, the
device-resident dataset, telemetry and tracing, non-finite guards,
preemption, ZeRO, graph sharding, elastic resume, periodic full-state
checkpoints and training dtype policies other than f32.  The defaults of
the reference's own automatic pipeline (scan chunking, residency) are
not applied: the port runs one step per batch.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hydragnn_torch.graph.batch import GraphBatch
from hydragnn_torch.models.base import Base, ModelConfig, multihead_loss
from hydragnn_torch.train.optimizer import (
    OptimizerSpec,
    OptState,
    frozen_mask,
    get_learning_rate,
    set_learning_rate,
)
from hydragnn_torch.utils.env import env_flag


@dataclasses.dataclass
class TrainState:
    """Step count, the module (which holds the weights) and the optimizer
    state — the reference's ``TrainState`` with ``params`` kept in the
    module."""

    step: int
    model: Base
    opt_state: OptState


def _params(model: Base) -> Tuple[List[str], List[torch.Tensor]]:
    named = list(model.named_parameters())
    return [n for n, _ in named], [p for _, p in named]


def create_train_state(model: Base, opt_spec: OptimizerSpec) -> TrainState:
    """Module (already on its device) + fresh optimizer state + step 0."""
    return TrainState(step=0, model=model,
                      opt_state=opt_spec.tx.init(_params(model)[1]))


def _force_head_indices(output_names: Optional[Sequence[str]]
                        ) -> Tuple[int, int]:
    """(energy_head, forces_head) or (-1, -1), by name as the reference."""
    if not output_names:
        return -1, -1
    e = [i for i, n in enumerate(output_names) if n == "total_energy"]
    f = [i for i, n in enumerate(output_names) if n == "atomic_forces"]
    assert len(e) <= 1, "multiple outputs are called total_energy"
    assert len(f) <= 1, "multiple outputs are called atomic_forces"
    if e and f:
        return e[0], f[0]
    return -1, -1


# the reference draws a step's dropout bits from fold_in(PRNGKey(0xD0),
# step); the port seeds a generator on the batch's device from the same
# two numbers (its bits are its own: no generator here gives threefry's)
DROPOUT_KEY = 0xD0


def dropout_seed(step: int) -> int:
    """The seed of a train step's attention-dropout bits."""
    return (DROPOUT_KEY << 32) | int(step)


def _loss_and_metrics(model: Base, cfg: ModelConfig, g: GraphBatch,
                      seed: Optional[int] = None):
    """Forward + weighted loss; returns (loss, (per_head, outputs)).
    ``seed``: the train step's dropout seed (None in eval)."""
    outputs = model(g, dropout_seed=seed)
    total, per_head = multihead_loss(cfg, outputs, g)
    return total, (per_head, outputs)


def make_train_step(
    model: Base,
    cfg: ModelConfig,
    opt_spec: OptimizerSpec,
    output_names: Optional[Sequence[str]] = None,
) -> Callable[[TrainState, GraphBatch], Tuple[TrainState, Dict[str, Any]]]:
    """One optimizer step per batch: forward in training mode (BatchNorm
    uses the batch statistics and updates its running ones, once per
    step; GAT's attention dropout draws its bits from the step's
    :func:`dropout_seed`), weighted loss, backward, update (encoder updates zeroed under
    ``freeze_conv_layers``), applied in place to the module's parameters.
    Metrics stay on the device."""
    if _force_head_indices(output_names) != (-1, -1):
        raise NotImplementedError(
            "the energy-gradient force self-consistency term (total_energy "
            "+ atomic_forces heads) needs a double backward through the "
            "kernels and is not ported yet")
    names, params = _params(model)
    mask = frozen_mask(names, cfg.freeze_conv)

    def train_step(state: TrainState, g: GraphBatch):
        model.train()
        loss, (per_head, _) = _loss_and_metrics(
            model, cfg, g, dropout_seed(state.step))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if d is None else d
                 for p, d in zip(params, grads)]
        updates, new_opt = opt_spec.tx.update(grads, state.opt_state, params)
        if mask is not None:
            updates = [torch.zeros_like(u) if m else u
                       for u, m in zip(updates, mask)]
        with torch.no_grad():
            torch._foreach_add_(params, updates)
        metrics = {"loss": loss.detach(), "num_graphs": g.n_real_graphs}
        metrics.update({f"task_{i}": t.detach()
                        for i, t in enumerate(per_head)})
        return TrainState(state.step + 1, model, new_opt), metrics

    return train_step


def make_eval_step(model: Base, cfg: ModelConfig
                   ) -> Callable[[GraphBatch], Dict[str, Any]]:
    """Forward + loss in eval mode: BatchNorm normalises with its running
    statistics and updates nothing."""

    def eval_step(g: GraphBatch):
        model.eval()
        loss, (per_head, outputs) = _loss_and_metrics(model, cfg, g)
        return {
            "loss": loss,
            "num_graphs": g.n_real_graphs,
            "per_head": per_head,
            "outputs": outputs,
        }

    return eval_step


# ---------------------------------------------------------------------------
# Host-side control objects (copies of the reference's)
# ---------------------------------------------------------------------------


class ReduceLROnPlateau:
    """min-mode plateau scheduler (factor 0.5, patience 5, min_lr 1e-5)."""

    def __init__(self, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-5, threshold: float = 1e-4):
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0

    def step(self, metric: float, lr: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            return max(lr * self.factor, self.min_lr)
        return lr


class EarlyStopping:
    """Patience on validation loss."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.count = 0
        self.min_loss = float("inf")
        self.early_stop = False

    def __call__(self, val_loss: float) -> bool:
        if val_loss < self.min_loss:
            self.min_loss = val_loss
            self.count = 0
        elif val_loss > self.min_loss + self.min_delta:
            self.count += 1
            if self.count >= self.patience:
                self.early_stop = True
        return self.early_stop


class CheckpointTracker:
    """Best-metric checkpointing with warmup: saves when the metric beats
    the best so far, once ``warmup`` calls have passed."""

    def __init__(self, name: str, warmup: int = 0, path: str = "./logs/"):
        self.name = name
        self.warmup = warmup
        self.path = path
        self.count = 0
        self.best = float("inf")

    def __call__(self, state: TrainState, metric: float) -> bool:
        self.count += 1
        if self.count < self.warmup or metric >= self.best:
            return False
        self.best = metric
        save_state(state, self.name, self.path)
        return True


def save_state(state: TrainState, log_name: str,
               path: str = "./logs/") -> str:
    """Single-file checkpoint ``<path>/<log_name>/<log_name>.pk`` with the
    reference's keys, written atomically.  ``params``/``batch_stats`` are
    numpy trees in the flax layout (``batch_stats`` the BatchNorm running
    statistics, ``{"encoder_bn_0": {"mean", "var"}, ...}``), so both packages' ``run_prediction``
    read it; ``opt_state`` is the port's own (a dict of numpy moments and
    hyperparameters, :meth:`OptState.state_dict`), not optax's."""
    from hydragnn_torch.resilience.ckpt_io import atomic_write_pickle
    from hydragnn_torch.utils.weights import (
        flax_batch_stats_from_module,
        flax_params_from_module,
    )

    fname = os.path.join(path, log_name, f"{log_name}.pk")
    atomic_write_pickle(fname, {
        "step": np.asarray(state.step, np.int32),
        "params": flax_params_from_module(state.model),
        "batch_stats": flax_batch_stats_from_module(state.model),
        "opt_state": state.opt_state.state_dict(),
    })
    return fname


def load_state(state: TrainState, log_name: str,
               path: str = "./logs/") -> TrainState:
    """Restore a checkpoint this package wrote into ``state``'s module."""
    from hydragnn_torch.serve.engine import read_checkpoint
    from hydragnn_torch.utils.weights import load_flax_params

    fname = os.path.join(path, log_name, f"{log_name}.pk")
    with open(fname, "rb") as f:
        opt = pickle.load(f).get("opt_state")
    if not (isinstance(opt, dict) and "count" in opt):
        raise ValueError(
            f"{fname} holds no optimizer state of this package (a JAX "
            "checkpoint's optax state cannot be resumed by the port)")
    payload = read_checkpoint(fname)
    load_flax_params(state.model, payload["params"], payload["batch_stats"])
    dev = next(state.model.parameters()).device
    return TrainState(int(np.asarray(payload["step"])), state.model,
                      OptState.from_state_dict(opt, dev))


# ---------------------------------------------------------------------------
# Epoch loop
# ---------------------------------------------------------------------------


def refuse_unported(training: Dict[str, Any],
                    telemetry: Optional[Dict[str, Any]] = None,
                    defaults_written: bool = True) -> None:
    """Raise ``NotImplementedError`` for any knob of the reference's loop
    that this slice does not port and that the config or the environment
    turns on — never ignore one quietly.  ``defaults_written``: the
    section went through ``finalize``, which writes the reference's
    defaults (preemption on)."""
    t = training or {}
    tel = telemetry or {}
    asks = []
    if int(os.getenv("HYDRAGNN_STEPS_PER_DISPATCH", "1") or 1) > 1:
        asks.append("HYDRAGNN_STEPS_PER_DISPATCH > 1 (several steps per "
                    "dispatch)")
    if env_flag("HYDRAGNN_RESIDENT_DATASET"):
        asks.append("HYDRAGNN_RESIDENT_DATASET (device-resident dataset)")
    if env_flag("HYDRAGNN_DEVICE_PREFETCH"):
        asks.append("HYDRAGNN_DEVICE_PREFETCH")
    if (bool(int(tel.get("enable", 0) or 0)) or bool(int(tel.get("trace", 0)
                                                      or 0))
            or env_flag("HYDRAGNN_TELEMETRY") or env_flag("HYDRAGNN_TRACE")
            or env_flag("HYDRAGNN_COMMS_PROBE")):
        asks.append("telemetry / tracing (Telemetry.enable, .trace, "
                    "HYDRAGNN_TELEMETRY, HYDRAGNN_TRACE)")
    if bool(int(t.get("nonfinite_guard", 0) or 0)) or env_flag(
            "HYDRAGNN_NONFINITE_GUARD"):
        asks.append("non-finite guards")
    # preemption is on by default in the reference (``finalize`` writes
    # ``preemption: 1``), so only an explicit request counts here: the env
    # knob, or the raw config key (checked by run_training before finalize)
    if env_flag("HYDRAGNN_PREEMPT") or bool(int(t.get("preemption", 0) or 0)
                                          and not defaults_written):
        asks.append("preemption handling (a SIGTERM ends the run without a "
                    "resume bundle)")
    if int(t.get("zero_stage", 0) or 0) > 0 or bool(
            (t.get("Optimizer") or {}).get("use_zero_redundancy")) or (
            os.getenv("HYDRAGNN_ZERO", "0") or "0") not in ("0",):
        asks.append("ZeRO sharding")
    gs = os.getenv("HYDRAGNN_GRAPH_SHARD") or t.get("graph_shard", "off")
    if str(gs or "off") != "off":
        asks.append("graph sharding")
    if os.getenv("HYDRAGNN_ELASTIC_RESUME") or os.getenv(
            "HYDRAGNN_CHAOS_ELASTIC") or t.get("Chaos"):
        asks.append("elastic resume / chaos injection")
    if int(t.get("full_state_checkpoint", 0) or 0):
        asks.append("periodic full-state (orbax) checkpoints")
    td = (os.getenv("HYDRAGNN_TRAIN_DTYPE", "").strip().lower()
          or str(t.get("train_dtype_policy", "f32") or "f32"))
    if td != "f32":
        asks.append(f"train_dtype_policy {td!r} (bf16 waits for ROADMAP A5)")
    if asks:
        raise NotImplementedError(
            "not ported to hydragnn_torch yet: " + "; ".join(asks))


def _run_epoch(step_fn, state, loader, train: bool, device):
    """One pass over ``loader``; returns (state, accumulator) with the
    accumulator ``(sum loss*graphs, sum task*graphs, graphs)`` as device
    tensors (None for an empty loader) — no host sync per batch.
    ``HYDRAGNN_MAX_NUM_BATCH`` caps the batches of every pass (train, val
    and test alike, as in the reference)."""
    total = tasks = n = None
    nbatch = int(os.getenv("HYDRAGNN_MAX_NUM_BATCH", "0")) or None
    for ibatch, g in enumerate(loader):
        if nbatch is not None and ibatch + 1 > nbatch:
            break
        g = g.to(device)
        if train:
            state, metrics = step_fn(state, g)
            n_tasks = sum(1 for k in metrics if k.startswith("task_"))
            per_head = [metrics[f"task_{i}"] for i in range(n_tasks)]
        else:
            metrics = step_fn(g)
            per_head = metrics["per_head"]
        ng = metrics["num_graphs"]
        loss_w = metrics["loss"] * ng
        ph = (torch.stack(per_head) * ng if per_head
              else torch.zeros(0, device=device))
        if total is None:
            total, tasks, n = loss_w, ph, ng
        else:
            total, tasks, n = total + loss_w, tasks + ph, n + ng
    return state, (None if total is None else (total, tasks, n))


def _epoch_metrics(acc):
    """Finalize an accumulator to (loss, tasks) on the host."""
    if acc is None:
        return 0.0, np.zeros(0)
    total, tasks, n = acc
    n = max(float(n), 1.0)
    return float(total) / n, tasks.detach().cpu().numpy() / n


def train_validate_test(
    model: Base,
    cfg: ModelConfig,
    state: TrainState,
    opt_spec: OptimizerSpec,
    train_loader,
    val_loader,
    test_loader,
    config_nn: Dict[str, Any],
    log_name: str,
    verbosity: int = 0,
    logs_dir: str = "./logs/",
    device=None,
    telemetry_config: Optional[Dict[str, Any]] = None,
) -> Tuple[TrainState, Dict[str, Any]]:
    """Epoch loop with plateau LR scheduling, early stopping and
    best-validation checkpointing (the reference's core): per epoch
    ``set_epoch``, train, validate, test, ``scheduler.step(val)``,
    checkpoint(val) with warmup, optional early stop."""
    from hydragnn_torch.utils.print_utils import print_distributed

    training = config_nn["Training"]
    refuse_unported(training, telemetry_config)
    num_epoch = int(training["num_epoch"])
    output_names = config_nn["Variables_of_interest"].get("output_names")
    if device is None:
        device = next(model.parameters()).device
    train_step = make_train_step(model, cfg, opt_spec, output_names)
    eval_step = make_eval_step(model, cfg)

    scheduler = ReduceLROnPlateau()
    earlystopper = None
    if training.get("EarlyStopping"):
        earlystopper = EarlyStopping(patience=training.get("patience", 10))
    checkpointer = None
    if training.get("Checkpoint"):
        checkpointer = CheckpointTracker(
            log_name, warmup=training.get("checkpoint_warmup", 0),
            path=logs_dir)

    history: Dict[str, Any] = {
        "train": [], "val": [], "test": [], "lr": [], "epoch_time": [],
        "pipeline": {"steps_per_dispatch": 1, "resident": False,
                     "zero_stage": 0, "graph_shard": "off",
                     "train_dtype": "f32", "train_dtype_requested": "f32",
                     "auto_selected": False}}
    lr = get_learning_rate(state.opt_state)

    for epoch in range(num_epoch):
        t0 = time.time()
        train_loader.set_epoch(epoch)
        state, train_acc = _run_epoch(train_step, state, train_loader, True,
                                      device)
        valtest = bool(int(os.getenv("HYDRAGNN_VALTEST", "1")))
        val_acc = test_acc = None
        if valtest:
            model.eval()
            with torch.no_grad():
                _, val_acc = _run_epoch(eval_step, state, val_loader, False,
                                        device)
                _, test_acc = _run_epoch(eval_step, state, test_loader,
                                         False, device)
        train_loss, train_tasks = _epoch_metrics(train_acc)
        if valtest:
            val_loss, _ = _epoch_metrics(val_acc)
            test_loss, _ = _epoch_metrics(test_acc)
        else:
            val_loss = test_loss = train_loss

        new_lr = scheduler.step(val_loss, lr)
        if new_lr != lr:
            lr = new_lr
            state = dataclasses.replace(
                state, opt_state=set_learning_rate(state.opt_state, lr))

        history["train"].append(train_loss)
        history["val"].append(val_loss)
        history["test"].append(test_loss)
        history["lr"].append(lr)
        history["epoch_time"].append(time.time() - t0)

        print_distributed(
            verbosity,
            f"Epoch: {epoch:4d}, train loss: {train_loss:.8f}, "
            f"val loss: {val_loss:.8f}, test loss: {test_loss:.8f}, "
            f"lr: {lr:.2e}  ({time.time() - t0:.2f}s)",
        )

        if checkpointer is not None:
            checkpointer(state, val_loss)
        if earlystopper is not None and earlystopper(val_loss):
            print_distributed(verbosity, f"Early stopping at epoch {epoch}")
            break
    return state, history


def test(
    eval_step,
    loader,
    num_heads: int,
    *,
    output_types: Sequence[str],
    device: torch.device,
) -> Tuple[float, np.ndarray, List[np.ndarray], List[np.ndarray]]:
    """Full-dataset evaluation on ``device`` returning (error, per-task
    error, true, pred) per head with padding stripped."""
    if int(os.getenv("HYDRAGNN_DUMP_TESTDATA", "0")):
        raise NotImplementedError(
            "HYDRAGNN_DUMP_TESTDATA is not ported yet")
    total = 0.0
    n = 0.0
    tasks = np.zeros(num_heads)
    true_values: List[List[np.ndarray]] = [[] for _ in range(num_heads)]
    pred_values: List[List[np.ndarray]] = [[] for _ in range(num_heads)]
    for g in loader:
        m = eval_step(g.to(device))
        ng = float(m["num_graphs"])
        total += float(m["loss"]) * ng
        tasks += np.asarray([float(t) for t in m["per_head"]]) * ng
        n += ng
        gm = g.graph_mask.numpy() > 0
        nm = g.node_mask.numpy() > 0
        for ih in range(num_heads):
            out = m["outputs"][ih].cpu().numpy()
            lab = g.labels[ih].numpy()
            mask = gm if output_types[ih] == "graph" else nm
            true_values[ih].append(lab[mask])
            pred_values[ih].append(out[mask][:, : lab.shape[-1]])
    n = max(n, 1.0)
    true_cat = [np.concatenate(v, axis=0) for v in true_values]
    pred_cat = [np.concatenate(v, axis=0) for v in pred_values]
    return total / n, tasks / n, true_cat, pred_cat
