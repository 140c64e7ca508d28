"""Model factory (port of hydragnn_tpu/models/create.py).

SchNet, GIN, SAGE, MFC and PNA are ported; CGCNN, EGNN, GAT and DimeNet
raise until their slices land (ROADMAP queue A4).  Parameters are initialised from an
explicit ``torch.Generator`` seeded with ``seed``.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from hydragnn_torch.models.base import Base, ModelConfig
from hydragnn_torch.models.gin import GINStack
from hydragnn_torch.models.mfc import MFCStack
from hydragnn_torch.models.pna import PNAStack
from hydragnn_torch.models.sage import SAGEStack
from hydragnn_torch.models.schnet import SCFStack

_STACKS = {"SAGE": SAGEStack, "GIN": GINStack, "MFC": MFCStack,
           "PNA": PNAStack, "SchNet": SCFStack}

# the reference's architecture list (models/create.py ALL_ARCHS)
ALL_ARCHS = ("SAGE", "GIN", "GAT", "MFC", "PNA", "CGCNN", "SchNet",
             "DimeNet", "EGNN")


def create_model(cfg: ModelConfig, seed: int = 0) -> Base:
    """Build and initialise the module on the CPU (move it with ``.to``)."""
    if cfg.model_type not in ALL_ARCHS:
        raise ValueError(f"Unknown model_type: {cfg.model_type}")
    if cfg.model_type not in _STACKS:
        raise NotImplementedError(
            f"model_type {cfg.model_type!r} is not ported yet (ROADMAP "
            f"queue A4); the port has {', '.join(_STACKS)}")
    if cfg.model_type == "PNA" and cfg.pna_avg_deg_log is None:
        raise ValueError("PNA requires degree input.")
    if cfg.model_type == "MFC" and cfg.max_degree is None:
        raise ValueError("MFC requires max_neighbours input.")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            "mixed precision (compute_dtype bfloat16) is not ported yet — "
            "ROADMAP queue A5")
    gen = torch.Generator().manual_seed(seed)
    model = _STACKS[cfg.model_type](cfg, gen)
    if cfg.initial_bias is not None:
        # output-layer bias of every graph head (reference set_initial_bias)
        for head, head_type in zip(model.heads_NN, cfg.output_type):
            if head_type == "graph":
                last = [m for m in head if isinstance(m, nn.Linear)][-1]
                with torch.no_grad():
                    last.bias.fill_(float(cfg.initial_bias))
    return model
