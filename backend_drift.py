"""How far two correct float32 training runs drift apart, on the CPU.

    python3 backend_drift.py [ARCH ...] [--graphs N] [--batch B] \\
        [--epochs K] [--seed S]

It stands beside ``chip_smoke.py``, whose configurations it borrows, and
needs no GPU.  Each architecture (default: SchNet, GIN, SAGE, MFC, PNA,
EGNN, GAT, CGCNN, DimeNet) is trained twice from one seeded init on the
synthetic BCC set of ``chip_smoke.py`` at its widths (hidden 64, 4 conv
layers, AdamW 1e-3; EGNN at md17's, ``chip_smoke.egnn_md17_config``; GAT
at the arch sweep's, 6 heads and dropout 0, ``chip_smoke.gat_config``;
CGCNN at input = hidden = 64 on the set with its 63 extra node-feature
columns, ``chip_smoke.cgcnn_config``; DimeNet at the arch sweep's widths
on the dimenet cell's set of smaller cells, ``chip_smoke.dimenet_config``;
on request, DimeNet_wide at DimeNet++'s QM9 widths with int_emb_size 128
on the same set, ``chip_smoke.dimenet_wide_config``), once under
``HYDRAGNN_AGGR_BACKEND=fused`` (the plain versions of the kernels:
sorted-segment sums) and once under ``scatter`` (``index_add_``).  Both are
the same function; they differ in the order of a few float32 sums.  Prints
one JSON line per architecture with the per-epoch train and validation
losses of both runs and their relative differences.

What it shows: SchNet's two runs stay together, those of the BatchNorm
architectures part within a few epochs.  The weights in front of a
BatchNorm are scale-invariant, so their gradients are small differences of
large sums, and Adam turns every gradient, however small, into a step of
the learning rate's size; the eval losses, taken with young running
statistics, part soonest.  This is why ``chip_smoke.py`` holds the card to
the CPU in lockstep for these architectures and compares no free runs.
EGNN has no BatchNorm; its line decides which of the two checks it gets.
GAT's fused path sums each head's logit in another order than its composed
path, and has BatchNorm.  CGCNN has BatchNorm after each conv; its fused
path adds each edge's products in another order than its composed path.
DimeNet has no BatchNorm and only smooth activations (SiLU); its fused path
(the factored triplet op and the row-MLP tail; at DimeNet_wide's widths the
builder-backed triplet op) sums each edge's triplets in another order than
its composed path.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("archs", nargs="*",
                    default=["SchNet", "GIN", "SAGE", "MFC", "PNA", "EGNN",
                             "GAT", "CGCNN", "DimeNet"])
    ap.add_argument("--graphs", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from chip_smoke import (
        CGCNN_DATA,
        cgcnn_config,
        dimenet_config,
        dimenet_wide_config,
        egnn_md17_config,
        flagship_config,
        gat_config,
        write_cgcnn_data,
        write_dimenet_data,
    )

    import hydragnn_torch
    from hydragnn_torch.data.synthetic import deterministic_graph_data

    kept = os.environ.get("HYDRAGNN_AGGR_BACKEND")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="backend_drift_") as work:
        os.chdir(work)
        os.environ["SERIALIZED_DATA_PATH"] = work
        try:
            deterministic_graph_data(
                "dataset/chip_smoke", number_configurations=args.graphs,
                unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
                unit_cell_z_range=(1, 3), seed=args.seed)
            if "CGCNN" in args.archs:
                write_cgcnn_data("dataset/chip_smoke", CGCNN_DATA, args.seed,
                                 count=args.graphs)
            if {"DimeNet", "DimeNet_wide"} & set(args.archs):
                write_dimenet_data(args.seed, count=args.graphs)
            for arch in args.archs:
                hist = {}
                for backend in ("fused", "scatter"):
                    os.environ["HYDRAGNN_AGGR_BACKEND"] = backend
                    if arch == "EGNN":
                        cfg = egnn_md17_config(epochs=args.epochs)
                    elif arch == "GAT":
                        cfg = gat_config(epochs=args.epochs)
                    elif arch == "CGCNN":
                        cfg = cgcnn_config(epochs=args.epochs)
                    elif arch == "DimeNet":
                        cfg = dimenet_config(epochs=args.epochs)
                    elif arch == "DimeNet_wide":
                        cfg = dimenet_wide_config(epochs=args.epochs)
                    else:
                        cfg = flagship_config(perc_train=0.5,
                                              epochs=args.epochs,
                                              model_type=arch)
                    cfg["NeuralNetwork"]["Training"]["batch_size"] = args.batch
                    _, hist[backend], _ = hydragnn_torch.run_training(
                        copy.deepcopy(cfg),
                        logs_dir=os.path.join(work, arch, backend),
                        seed=args.seed, device="cpu")
                row = {"arch": arch, "graphs": args.graphs,
                       "batch": args.batch, "device": "cpu"}
                for k in ("train", "val"):
                    a, b = hist["fused"][k], hist["scatter"][k]
                    row[f"{k}_fused"], row[f"{k}_scatter"] = a, b
                    row[f"{k}_rel_diff"] = [
                        abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b)]
                print(json.dumps(row), flush=True)
        finally:
            os.chdir(cwd)
            os.environ.pop("SERIALIZED_DATA_PATH", None)
            if kept is None:
                os.environ.pop("HYDRAGNN_AGGR_BACKEND", None)
            else:
                os.environ["HYDRAGNN_AGGR_BACKEND"] = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
