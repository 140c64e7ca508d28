"""How far two correct float32 training runs drift apart, on the CPU.

    python3 backend_drift.py [ARCH ...] [--graphs N] [--batch B] \\
        [--epochs K] [--seed S]

It stands beside ``chip_smoke.py``, whose configuration it borrows, and
needs no GPU.  Each architecture (default: SchNet, GIN, SAGE, MFC, PNA) is
trained twice from one seeded init on the synthetic BCC
set of ``chip_smoke.py`` at its widths (hidden 64, 4 conv layers, AdamW
1e-3), once under ``HYDRAGNN_AGGR_BACKEND=fused`` (the plain versions of the
kernels: sorted-segment sums) and once under ``scatter`` (``index_add_``).
Both are the same function; they differ in the order of a few float32
sums.  Prints one JSON line per architecture with the per-epoch train and
validation losses of both runs and their relative differences.

What it shows: SchNet's two runs stay together, those of the BatchNorm
architectures part within a few epochs.  The weights in front of a
BatchNorm are scale-invariant, so their gradients are small differences of
large sums, and Adam turns every gradient, however small, into a step of
the learning rate's size; the eval losses, taken with young running
statistics, part soonest.  This is why ``chip_smoke.py`` holds the card to
the CPU in lockstep for these architectures and compares no free runs.
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
                    default=["SchNet", "GIN", "SAGE", "MFC", "PNA"])
    ap.add_argument("--graphs", type=int, default=1500)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from chip_smoke import flagship_config

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
            for arch in args.archs:
                hist = {}
                for backend in ("fused", "scatter"):
                    os.environ["HYDRAGNN_AGGR_BACKEND"] = backend
                    cfg = flagship_config(perc_train=0.5, epochs=args.epochs,
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
