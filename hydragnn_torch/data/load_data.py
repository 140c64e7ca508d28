"""Top-level data orchestration: raw files -> split GraphSample loaders.

Port of the in-memory path of hydragnn_tpu/data/load_data.py (single
process): parse + normalize the raw files, pickle them, split, transform,
finalize the config from dataset statistics, and build the three padded
loaders.  The streaming data plane raises until it is ported.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Tuple

from hydragnn_torch.config.config import (
    DatasetStats,
    finalize,
    head_specs_from_config,
    label_slices_from_config,
    normalize_output_config,
)
from hydragnn_torch.config.defaults import stream_requested
from hydragnn_torch.data.dataloader import GraphDataLoader, create_dataloaders
from hydragnn_torch.data.raw import RAW_FORMATS, RawSample
from hydragnn_torch.data.splitting import split_dataset
from hydragnn_torch.data.transform import transform_raw_samples


def serialized_dir(config: Dict[str, Any]) -> str:
    base = os.environ.get("SERIALIZED_DATA_PATH", os.getcwd())
    return os.path.join(base, "serialized_dataset")


def transform_raw_data_to_serialized(config: Dict[str, Any]) -> None:
    """Parse + normalize raw files and pickle them."""
    fmt = config["Dataset"]["format"]
    loader_cls = RAW_FORMATS.get(fmt)
    if loader_cls is None:
        raise ValueError(f"Unknown raw dataset format: {fmt}")
    loader = loader_cls(config)
    loader.load_raw_data()
    loader.save_serialized(serialized_dir(config))


def load_serialized_splits(
    config: Dict[str, Any]
) -> Tuple[List[RawSample], List[RawSample], List[RawSample]]:
    """Load pickled RawSamples and produce train/val/test record lists."""
    ds = config["Dataset"]
    name = ds["name"]
    sdir = serialized_dir(config)
    paths = ds["path"]

    def _read(label: str) -> List[RawSample]:
        suffix = "" if label == "total" else f"_{label}"
        with open(os.path.join(sdir, f"{name}{suffix}.pkl"), "rb") as f:
            pickle.load(f)  # node min/max header
            pickle.load(f)  # graph min/max header
            return pickle.load(f)

    if "total" in paths:
        total = _read("total")
        perc_train = config["NeuralNetwork"]["Training"]["perc_train"]
        return split_dataset(
            total,
            perc_train,
            ds.get("compositional_stratified_splitting", False),
        )
    return _read("train"), _read("validate"), _read("test")


def dataset_loading_and_splitting(
    config: Dict[str, Any],
    seed: int = 0,
) -> Tuple[GraphDataLoader, GraphDataLoader, GraphDataLoader, Dict[str, Any]]:
    """Raw -> serialized -> transformed -> three padded loaders, plus the
    finalized config."""
    if stream_requested(config.get("Dataset", {})):
        raise NotImplementedError(
            "the streaming data plane (Dataset.stream / HYDRAGNN_STREAM) is "
            "not ported yet — ROADMAP queue A6")

    transform_raw_data_to_serialized(config)
    train_r, val_r, test_r = load_serialized_splits(config)
    # one transform call over the concatenated splits: length edge features
    # then share a single normalization constant
    tf_stats: Dict[str, Any] = {}
    allsets = transform_raw_samples(
        train_r + val_r + test_r, config, stats=tf_stats)
    n_tr, n_va = len(train_r), len(val_r)
    trainset = allsets[:n_tr]
    valset = allsets[n_tr:n_tr + n_va]
    testset = allsets[n_tr + n_va:]
    if tf_stats.get("edge_build_max_neighbours"):
        config.setdefault("Serving", {})["edge_build_max_neighbours"] = (
            tf_stats["edge_build_max_neighbours"])
    if tf_stats.get("edge_length_norm"):
        config.setdefault("Serving", {})["edge_length_norm"] = (
            tf_stats["edge_length_norm"])

    need_deg = config["NeuralNetwork"]["Architecture"]["model_type"] == "PNA"
    stats = DatasetStats.from_samples(
        trainset + valset + testset, need_deg=need_deg)
    config = finalize(config, stats)
    config = normalize_output_config(config)

    head_specs = head_specs_from_config(config)
    gslices, nslices = label_slices_from_config(config)
    batch_size = int(config["NeuralNetwork"]["Training"]["batch_size"])
    # DimeNet reads a padded triplet table per batch, sized from the
    # worst sample, and one fused-triplet gate decided from the dataset's
    # largest graph, so every batch of the run carries the same extras
    post_collate = None
    if config["NeuralNetwork"]["Architecture"]["model_type"] == "DimeNet":
        from hydragnn_torch.models.dimenet import (
            DnTriGate,
            add_dimenet_extras,
            count_triplets,
        )

        max_per_sample = 1
        for s in trainset + valset + testset:
            if s.num_edges:
                max_per_sample = max(
                    max_per_sample, count_triplets(s.edge_index, s.num_nodes))
        max_triplets = -(-(batch_size * max_per_sample + 1) // 8) * 8
        tri_gate = DnTriGate(max_edges_per_graph=stats.max_edges)

        def post_collate(b):
            return add_dimenet_extras(b, max_triplets, tri_gate=tri_gate)

    train_l, val_l, test_l = create_dataloaders(
        trainset,
        valset,
        testset,
        batch_size,
        head_specs,
        graph_feature_slices=gslices,
        node_feature_slices=nslices,
        seed=seed,
        post_collate=post_collate,
    )
    return train_l, val_l, test_l, config
