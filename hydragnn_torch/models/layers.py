"""Shared neural building blocks: activations, losses, dense layers, MLPs.

Port of hydragnn_tpu/models/layers.py.  Dense layers keep the reference's
initializer kinds (torch-default, xavier-uniform, lecun-normal, scaled
fan-avg uniform), drawn from an explicit ``torch.Generator`` so a model is
reproducible from a seed.  :class:`MaskedBatchNorm` is the feature layer of
every architecture but SchNet and EGNN.
"""

from __future__ import annotations

import math
import os
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def activation_module(name: str) -> nn.Module:
    """Activation by config name (parameter-free modules)."""
    mods = {
        "relu": nn.ReLU,
        "selu": nn.SELU,
        "elu": nn.ELU,
        "lrelu_01": lambda: nn.LeakyReLU(0.1),
        "lrelu_025": lambda: nn.LeakyReLU(0.25),
        "lrelu_05": lambda: nn.LeakyReLU(0.5),
    }
    if name == "prelu":
        raise NotImplementedError(
            "activation 'prelu' (a learnable slope) is not ported yet")
    if name not in mods:
        raise ValueError(f"Unknown activation function: {name}")
    return mods[name]()


def loss_function(name: str) -> Callable[[torch.Tensor, torch.Tensor,
                                          torch.Tensor], torch.Tensor]:
    """Masked, mean-reduced loss ``(pred, target, mask) -> scalar``; the
    mean runs over valid rows only."""

    def _masked_mean(err, mask):
        m = mask.reshape(mask.shape + (1,) * (err.ndim - mask.ndim))
        denom = torch.clamp(m.sum() * err.shape[-1], min=1.0)
        return (err * m).sum() / denom

    if name == "mse":
        return lambda p, t, m: _masked_mean((p - t) ** 2, m)
    if name == "mae":
        return lambda p, t, m: _masked_mean(torch.abs(p - t), m)
    if name == "smooth_l1":

        def _sl1(p, t, m):
            d = torch.abs(p - t)
            return _masked_mean(torch.where(d < 1.0, 0.5 * d * d, d - 0.5), m)

        return _sl1
    if name == "rmse":
        return lambda p, t, m: torch.sqrt(_masked_mean((p - t) ** 2, m) + 1e-16)
    raise ValueError(f"Unknown loss function: {name}")


def shifted_softplus(x):
    """softplus(x) - log(2): SchNet's activation."""
    return F.softplus(x) - math.log(2.0)


class ShiftedSoftplus(nn.Module):
    def forward(self, x):
        return shifted_softplus(x)


# initializer kinds of the reference's dense layers
TORCH_DEFAULT = "torch"             # nn.Linear's own (TDense in the reference)
XAVIER_UNIFORM = "xavier_uniform"
LECUN_NORMAL = "lecun_normal"       # flax's default kernel init, zero bias


def _uniform(t, bound, gen):
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=gen)


def init_dense(lin: nn.Linear, kind: str, gen: Optional[torch.Generator],
               scale: float = 1.0, fan_in: Optional[int] = None) -> None:
    """Initialise ``lin`` in place with the reference's initializer kind.
    ``scale`` is the variance scale of the fan-avg uniform kind; ``fan_in``
    overrides the layer's own (a slice of a stacked weight bank)."""
    fan_out = lin.weight.shape[0]
    if fan_in is None:
        fan_in = lin.weight.shape[1]
    if kind == TORCH_DEFAULT:
        bound = 1.0 / math.sqrt(fan_in)
        _uniform(lin.weight, bound, gen)
        if lin.bias is not None:
            _uniform(lin.bias, bound, gen)
        return
    if kind == XAVIER_UNIFORM:
        _uniform(lin.weight, math.sqrt(6.0 / (fan_in + fan_out)), gen)
    elif kind == LECUN_NORMAL:
        # truncated normal at +-2 std, std corrected for the truncation
        std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
    elif kind == "fan_avg_uniform":
        _uniform(lin.weight, math.sqrt(3.0 * scale / ((fan_in + fan_out) / 2)),
                 gen)
    else:
        raise ValueError(f"unknown initializer kind {kind!r}")
    if lin.bias is not None:
        with torch.no_grad():
            lin.bias.zero_()


def dense(in_dim: int, out_dim: int, kind: str,
          gen: Optional[torch.Generator], bias: bool = True,
          scale: float = 1.0, fan_in: Optional[int] = None) -> nn.Linear:
    lin = nn.Linear(in_dim, out_dim, bias=bias)
    init_dense(lin, kind, gen, scale, fan_in)
    return lin


def dense_leaves(name: str, lin: nn.Linear):
    """flax leaves of one dense layer, for utils/weights.py:
    ``{(name, "kernel"): (weight, transpose), (name, "bias"): ...}``."""
    out = {(name, "kernel"): (lin.weight, True)}
    if lin.bias is not None:
        out[(name, "bias")] = (lin.bias, False)
    return out


def mlp(in_dim: int, features: Sequence[int], activation: str,
        gen: Optional[torch.Generator],
        final_activation: bool = False) -> nn.Sequential:
    """Dense stack with torch-default init: the j-th Linear sits at slot
    ``2j`` and activations at odd slots — the reference checkpoint layout
    (``graph_shared.{2j}``, ``heads_NN.{k}.{2j}``)."""
    layers = []
    d = in_dim
    for i, f in enumerate(features):
        layers.append(dense(d, f, TORCH_DEFAULT, gen))
        if i < len(features) - 1 or final_activation:
            layers.append(activation_module(activation))
        d = f
    return nn.Sequential(*layers)


def edge_geometry(pos, src, dst):
    """Normalized difference vector and squared distance per edge (eps
    inside the sqrt keeps padding self-edges finite)."""
    return diff_geometry(pos[src] - pos[dst])


def diff_geometry(diff):
    """:func:`edge_geometry` from the edges' ``pos[src] - pos[dst]``."""
    radial = torch.sum(diff * diff, dim=-1, keepdim=True)
    diff = diff / (torch.sqrt(radial + 1e-12) + 1.0)
    return diff, radial


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid (masked) rows with running statistics.

    PyG ``BatchNorm`` (momentum 0.1 in torch's convention, eps 1e-5) made
    exact under padded batches: padded rows contribute nothing to the batch
    statistics.  In training mode the batch mean and biased variance
    normalise and the running statistics take the unbiased variance; in
    eval mode the running statistics normalise and nothing is updated.
    The masked sums are plain ``sum`` reductions, deterministic on the
    card.  ``HYDRAGNN_BN_MOMENTUM`` overrides the momentum.  Halo-sharded
    batches (statistics summed across shards) wait for the parallel slice.

    The state sits under ``module`` with ``BatchNorm1d``'s names, the
    reference checkpoint layout (``feature_layers.{i}.module.weight``,
    ``...running_mean``); ``scale``/``bias``/``mean``/``var`` are the same
    tensors under the flax leaf names.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.module = nn.Module()
        self.module.weight = nn.Parameter(torch.ones(features))
        self.module.bias = nn.Parameter(torch.zeros(features))
        self.module.register_buffer("running_mean", torch.zeros(features))
        self.module.register_buffer("running_var", torch.ones(features))

    @property
    def scale(self):
        return self.module.weight

    @property
    def bias(self):
        return self.module.bias

    @property
    def mean(self):
        return self.module.running_mean

    @property
    def var(self):
        return self.module.running_var

    def forward(self, x, mask):
        if not self.training:
            mean, var = self.mean, self.var
        else:
            momentum = float(
                os.environ.get("HYDRAGNN_BN_MOMENTUM") or self.momentum)
            m = mask.to(x.dtype)[:, None]
            count = torch.clamp(m.sum(), min=1.0)
            mean = (x * m).sum(dim=0) / count
            var = (((x - mean) ** 2) * m).sum(dim=0) / count
            with torch.no_grad():
                # torch tracks the unbiased variance in the running stats
                unbiased = var * count / torch.clamp(count - 1.0, min=1.0)
                self.mean.mul_(1.0 - momentum).add_(momentum * mean)
                self.var.mul_(1.0 - momentum).add_(momentum * unbiased)
        return (self.scale * (x - mean) * torch.rsqrt(var + self.eps)
                + self.bias)
