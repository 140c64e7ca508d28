"""Carry weights between the flax tree of the JAX reference and the port.

The port names its parameters with the reference HydraGNN checkpoint keys
(``graph_convs.{i}.nn.0``, ``lin1``, ``lin2``, ``graph_shared.{2j}``,
``heads_NN.{k}.{2j}``, ...), so ``tools/port_weights.port_state_dict``
maps ``module.state_dict()`` onto the flax tree.  This module does the
same mapping without JAX, both ways:

- :func:`load_flax_params`: flax-tree numpy arrays -> the port's module
  (flax ``kernel [in, out]`` becomes torch ``weight [out, in]``), with the
  ``batch_stats`` tree into the BatchNorm buffers;
- :func:`flax_params_from_module` and :func:`flax_batch_stats_from_module`:
  the inverse.

Every leaf is accounted for: a flax leaf the module has no parameter for,
or a module parameter the tree does not fill, raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

Path = Tuple[str, ...]


def _linears(seq: nn.Sequential) -> List[nn.Linear]:
    return [m for m in seq if isinstance(m, nn.Linear)]


def _batch_norms(module):
    """flax scope name -> MaskedBatchNorm, for every BatchNorm of the
    module."""
    from hydragnn_torch.models.base import NodeConvHead

    out = {}
    for i, bn in enumerate(module.feature_layers or ()):
        out[f"encoder_bn_{i}"] = bn
    for j, bn in enumerate(module.batch_norms_node_hidden or ()):
        out[f"node_conv_hidden_bn_{j}"] = bn
    for k, head in enumerate(module.heads_NN):
        if isinstance(head, NodeConvHead):
            out[f"head_{k}_out_bn"] = head.bn
    return out


def _leaf_map(module) -> Dict[Path, Tuple[Any, bool]]:
    """flax ``params`` leaf path -> (torch tensor, transpose?).

    For a stacked bank (per-node heads, MFC's per-degree weights) the
    first item is the list of tensors stacked along a new leading axis."""
    from hydragnn_torch.models.base import NodeConvHead, NodeMLPHead

    out: Dict[Path, Tuple[Any, bool]] = {}

    def linear(path: Path, lin: nn.Linear):
        out[path + ("kernel",)] = (lin.weight, True)
        if lin.bias is not None:
            out[path + ("bias",)] = (lin.bias, False)

    def conv(scope: str, c: nn.Module):
        for path, leaf in c.flax_leaves().items():
            out[(scope,) + path] = leaf

    for i, c in enumerate(module.graph_convs):
        conv(f"encoder_conv_{i}", c)
    for j, c in enumerate(module.convs_node_hidden or ()):
        conv(f"node_conv_hidden_{j}", c)
    for scope, bn in _batch_norms(module).items():
        out[(scope, "scale")] = (bn.scale, False)
        out[(scope, "bias")] = (bn.bias, False)
    if module.graph_shared is not None:
        for j, lin in enumerate(_linears(module.graph_shared)):
            linear(("graph_shared", f"dense_{j}"), lin)
    for k, head in enumerate(module.heads_NN):
        if isinstance(head, NodeConvHead):
            conv(f"head_{k}_out_conv", head.conv)
        elif isinstance(head, NodeMLPHead):
            if not head.per_node:
                for j, lin in enumerate(_linears(head.mlp[0])):
                    linear((f"head_{k}", "MLP_0", f"dense_{j}"), lin)
            else:
                n_lin = len(_linears(head.mlp[0]))
                for j in range(n_lin):
                    banks = [_linears(m)[j] for m in head.mlp]
                    out[(f"head_{k}", f"w_{j}")] = (
                        [b.weight for b in banks], True)
                    out[(f"head_{k}", f"b_{j}")] = (
                        [b.bias for b in banks], False)
        else:
            for j, lin in enumerate(_linears(head)):
                linear((f"head_{k}", f"dense_{j}"), lin)
    return out


def _stats_map(module) -> Dict[Path, Tuple[Any, bool]]:
    """flax ``batch_stats`` leaf path -> (running-statistics buffer,
    False)."""
    out: Dict[Path, Tuple[Any, bool]] = {}
    for scope, bn in _batch_norms(module).items():
        out[(scope, "mean")] = (bn.mean, False)
        out[(scope, "var")] = (bn.var, False)
    return out


def _flatten(tree: Mapping, prefix: Path = ()) -> Dict[Path, np.ndarray]:
    flat = {}
    for k, v in tree.items():
        p = prefix + (str(k),)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, p))
        else:
            flat[p] = np.asarray(v)
    return flat


def _fill(want: Dict[Path, Tuple[Any, bool]], tree: Mapping,
          what: str) -> None:
    got = _flatten(tree)
    if set(want) != set(got):
        missing = sorted("/".join(p) for p in set(want) - set(got))
        extra = sorted("/".join(p) for p in set(got) - set(want))
        raise KeyError(f"flax {what} tree does not match the module: "
                       f"missing {missing}, unmapped {extra}")
    with torch.no_grad():
        for path, (t, transpose) in want.items():
            a = got[path]
            banked = isinstance(t, list)
            targets = t if banked else [t]
            arrays = list(a) if banked else [a]
            if len(arrays) != len(targets):
                raise ValueError(f"{'/'.join(path)}: {len(arrays)} banks for "
                                 f"{len(targets)} slots")
            for dst, src in zip(targets, arrays):
                src = np.array(src, dtype=np.float32)  # a writable copy
                if transpose:
                    src = src.T
                if src.ndim == 0:  # a flax scalar (GIN's eps)
                    src = src.reshape(dst.shape)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(
                        f"{'/'.join(path)}: shape {src.shape} vs module "
                        f"{tuple(dst.shape)}")
                dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))


def load_flax_params(module: nn.Module, params: Mapping,
                     batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Copy a flax ``params`` tree (numpy leaves) into ``module`` in place,
    and ``batch_stats`` into its BatchNorm buffers.  ``batch_stats=None``
    leaves the buffers as they are; a mapping must name exactly the
    module's BatchNorms (an empty one for a module without any)."""
    _fill(_leaf_map(module), params, "params")
    if batch_stats is not None:
        _fill(_stats_map(module), batch_stats, "batch_stats")
    return module


def _tree(leaves: Dict[Path, Tuple[Any, bool]], like: Dict[Path, tuple]
          ) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, (t, transpose) in leaves.items():
        def arr(x):
            a = x.detach().cpu().numpy().astype(np.float32)
            return a.T if transpose else a

        leaf = np.stack([arr(b) for b in t]) if isinstance(t, list) else arr(t)
        if path in like:
            leaf = leaf.reshape(like[path])
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(leaf, order="C")  # keeps a 0-d leaf 0-d
    return tree


def flax_params_from_module(module: nn.Module) -> Dict[str, Any]:
    """The module's parameters as a flax ``params`` tree of numpy arrays
    (GIN's ``eps`` as the scalar the flax tree holds)."""
    leaves = _leaf_map(module)
    scalars = {p: () for p in leaves if p[-1] == "eps"}
    return _tree(leaves, scalars)


def flax_batch_stats_from_module(module: nn.Module) -> Dict[str, Any]:
    """The module's BatchNorm running statistics as a flax ``batch_stats``
    tree (``{"encoder_bn_0": {"mean", "var"}, ...}``; empty without
    BatchNorm)."""
    return _tree(_stats_map(module), {})
