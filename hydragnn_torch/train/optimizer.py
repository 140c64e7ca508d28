"""Optimizer factory (port of hydragnn_tpu/train/optimizer.py).

The reference maps the config's optimizer names onto optax, wrapped in
``optax.inject_hyperparams`` so the learning rate lives in the optimizer
state and the host-side plateau scheduler can rewrite it between steps.
The port keeps optax's semantics and defaults — not ``torch.optim``'s —
so a run reproduces the reference's trajectory:

- ``AdamW``: ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0,
  bias-corrected moments), then ``+ weight_decay * p`` with optax's
  default weight decay 1e-4 (``torch.optim.AdamW`` defaults to 1e-2 and
  decays the weights before the Adam step), then ``* -lr``;
- ``Adam``: the same without the decay;
- ``SGD``: ``* -lr`` (optax's default: no momentum).

Every hyperparameter is a float32 value, as ``inject_hyperparams`` stores
it, and each update is the same sequence of float32 operations.  The
updates are returned, not applied: the trainer zeroes the encoder's under
``freeze_conv_layers`` (decay included) and adds them to the parameters.

The other names of the reference (Adadelta, Adagrad, Adamax, RMSprop,
FusedLAMB, LAMB) raise ``NotImplementedError`` until they are ported
(ROADMAP queue A3).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]

_UNPORTED = ("Adadelta", "Adagrad", "Adamax", "RMSprop", "FusedLAMB", "LAMB")


def _f32(v: float) -> float:
    """``v`` rounded to float32, as ``inject_hyperparams`` stores it."""
    return float(np.float32(v))


@dataclasses.dataclass
class OptState:
    """``count`` (optax's int32 step count of the Adam moments), the
    first and second moments (one tensor per parameter; empty for SGD)
    and the injected hyperparameters, learning rate included."""

    count: int
    mu: Tensors
    nu: Tensors
    hyperparams: Dict[str, float]

    def state_dict(self) -> Dict[str, Any]:
        """Numpy copy for a checkpoint (the port's own layout)."""
        return {"count": self.count,
                "mu": [t.detach().cpu().numpy() for t in self.mu],
                "nu": [t.detach().cpu().numpy() for t in self.nu],
                "hyperparams": dict(self.hyperparams)}

    @staticmethod
    def from_state_dict(sd: Dict[str, Any], device) -> "OptState":
        def back(arrs):
            return [torch.as_tensor(np.asarray(a)).to(device) for a in arrs]

        return OptState(int(sd["count"]), back(sd["mu"]), back(sd["nu"]),
                        {k: float(v) for k, v in sd["hyperparams"].items()})


class GradientTransformation:
    """An optax-like transformation over a list of float32 tensors:
    ``init(params) -> state`` and ``update(grads, state, params) ->
    (updates, new_state)``; nothing is modified in place."""

    def __init__(self, name: str, learning_rate: float):
        self.name = name
        self.hyper = {"learning_rate": _f32(learning_rate)}
        if name in ("Adam", "AdamW"):
            self.hyper.update(b1=_f32(0.9), b2=_f32(0.999), eps=_f32(1e-8),
                              eps_root=_f32(0.0))
        if name == "AdamW":
            self.hyper["weight_decay"] = _f32(1e-4)

    def init(self, params: Sequence[torch.Tensor]) -> OptState:
        moments = self.name != "SGD"
        return OptState(
            count=0,
            mu=[torch.zeros_like(p) for p in params] if moments else [],
            nu=[torch.zeros_like(p) for p in params] if moments else [],
            hyperparams=dict(self.hyper))

    def update(self, grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]) -> Tuple[Tensors, OptState]:
        hp = state.hyperparams
        neg_lr = _f32(-hp["learning_rate"])
        if self.name == "SGD":
            return torch._foreach_mul(list(grads), neg_lr), state
        one = np.float32(1.0)
        b1, b2 = np.float32(hp["b1"]), np.float32(hp["b2"])
        grads = list(grads)
        # mu = (1 - b1) * g + b1 * mu ; nu = (1 - b2) * g^2 + b2 * nu
        mu = torch._foreach_add(torch._foreach_mul(grads, float(one - b1)),
                                torch._foreach_mul(state.mu, float(b1)))
        g2 = torch._foreach_mul(grads, grads)
        nu = torch._foreach_add(torch._foreach_mul(g2, float(one - b2)),
                                torch._foreach_mul(state.nu, float(b2)))
        count = min(state.count + 1, 2**31 - 1)
        c = np.float32(count)
        bc1 = float(one - np.power(b1, c, dtype=np.float32))
        bc2 = float(one - np.power(b2, c, dtype=np.float32))
        mu_hat = torch._foreach_div(mu, bc1)
        nu_hat = torch._foreach_div(nu, bc2)
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_add(nu_hat, hp["eps_root"])),
            hp["eps"])
        upd = torch._foreach_div(mu_hat, den)
        if self.name == "AdamW":
            upd = torch._foreach_add(
                upd, torch._foreach_mul(list(params), hp["weight_decay"]))
        upd = torch._foreach_mul(upd, neg_lr)
        return upd, OptState(count, mu, nu, dict(hp))


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    tx: GradientTransformation


def select_optimizer(opt_config: Dict[str, Any],
                     zero_stage: int = 0) -> OptimizerSpec:
    """Build from the ``Training.Optimizer`` config section."""
    opt_type = opt_config.get("type", "AdamW")
    lr = float(opt_config.get("learning_rate", 1e-3))
    if opt_type in _UNPORTED:
        raise NotImplementedError(
            f"optimizer {opt_type!r} is not ported yet (ROADMAP queue A3); "
            "the port has AdamW, Adam and SGD")
    if opt_type not in ("SGD", "Adam", "AdamW"):
        raise NameError(
            f"The string {opt_type} does not name a valid optimizer")
    if opt_config.get("use_zero_redundancy", False) or int(zero_stage) > 0:
        raise NotImplementedError(
            "ZeRO sharding (use_zero_redundancy / zero_stage) is not ported "
            "yet — ROADMAP queue A8")
    return OptimizerSpec(tx=GradientTransformation(opt_type, lr))


def set_learning_rate(opt_state: OptState, lr: float) -> OptState:
    """The state with its injected learning rate rewritten (float32)."""
    hp = dict(opt_state.hyperparams)
    hp["learning_rate"] = _f32(lr)
    return dataclasses.replace(opt_state, hyperparams=hp)


def get_learning_rate(opt_state: OptState) -> float:
    return float(opt_state.hyperparams["learning_rate"])


def frozen_mask(names: Sequence[str], frozen: bool) -> Optional[List[bool]]:
    """Which updates ``freeze_conv_layers`` zeroes: the encoder's convs
    and BatchNorms (``graph_convs.*``, ``feature_layers.*``: the
    reference's ``encoder_*``), decay included."""
    if not frozen:
        return None
    return [n.startswith(("graph_convs.", "feature_layers.")) for n in names]
