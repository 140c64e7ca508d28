"""The PyTorch port's prediction slice end to end, against the JAX package.

- ``run_prediction``: a JAX-written checkpoint (``create_train_state`` +
  ``save_state``, the real format with ``opt_state``) evaluated by the JAX
  ``run_prediction`` and by the port's ``run_prediction(device="cpu")``
  under both aggregation backends; error and predictions agree to 1e-4.
- the port's own checkpoint reads back in the JAX package;
- ``finalize`` writes the same dict in both packages;
- the port runs on the card by default and never imports JAX: a
  subprocess imports both entry points (``run_prediction``,
  ``run_training``) and every port module and finds neither ``jax`` nor
  ``hydragnn_tpu`` in ``sys.modules``, and no port source imports them.
"""

import ast
import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)


def _config(name):
    with open(os.path.join(REPO, "tests", "inputs", "ci.json")) as f:
        config = json.load(f)
    ds = config["Dataset"]
    ds["name"] = name
    ds["path"] = {"total": f"dataset/{name}"}
    ds["compositional_stratified_splitting"] = False
    arch = config["NeuralNetwork"]["Architecture"]
    arch.update(model_type="SchNet", hidden_dim=8, num_conv_layers=2,
                num_gaussians=12, num_filters=16, radius=2.0,
                max_neighbours=20)
    config["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] = True
    config["NeuralNetwork"]["Training"]["batch_size"] = 16
    return config


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """Dataset + a checkpoint written by the JAX trainer's own save_state."""
    from ci_data import generate_cached
    from hydragnn_tpu.config.config import get_log_name_config
    from hydragnn_tpu.data.load_data import dataset_loading_and_splitting
    from hydragnn_tpu.models.base import ModelConfig
    from hydragnn_tpu.models.create import create_model
    from hydragnn_tpu.train.optimizer import select_optimizer
    from hydragnn_tpu.train.trainer import create_train_state, save_state

    config = _config("torch_port_pred")
    generate_cached("torch_port_pred", "dataset/torch_port_pred", 120)
    logs = str(tmp_path_factory.mktemp("torch_port_logs"))
    train_l, _, _, fcfg = dataset_loading_and_splitting(copy.deepcopy(config))
    model = create_model(ModelConfig.from_config(fcfg["NeuralNetwork"]))
    opt = select_optimizer(fcfg["NeuralNetwork"]["Training"]["Optimizer"])
    state = create_train_state(model, next(iter(train_l)), opt)
    save_state(state, get_log_name_config(fcfg), logs)
    return config, logs, state


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_run_prediction_matches_jax(jax_checkpoint, backend, monkeypatch):
    import hydragnn_tpu
    import hydragnn_torch
    from hydragnn_torch.ops import fused_mp

    config, logs, _ = jax_checkpoint
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    want = hydragnn_tpu.run_prediction(copy.deepcopy(config), logs_dir=logs)
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    fused_mp.reset_launches()
    got = hydragnn_torch.run_prediction(copy.deepcopy(config),
                                        logs_dir=logs, device="cpu")
    assert all(v == 0 for v in fused_mp.LAUNCHES.values())  # CPU: plain
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), **TOL)
    for t, j in zip(got[2], want[2]):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)
    for t, j in zip(got[3], want[3]):
        assert t.shape == np.asarray(j).shape
        np.testing.assert_allclose(t, np.asarray(j), **TOL)


def test_port_checkpoint_reads_back_in_jax(jax_checkpoint, tmp_path):
    import jax
    from hydragnn_tpu.serve.engine import load_inference_state as j_load
    from hydragnn_torch.config.config import get_log_name_config
    from hydragnn_torch.models.base import ModelConfig
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.serve.engine import (
        load_inference_state,
        save_inference_checkpoint,
    )
    from hydragnn_torch.utils.weights import load_flax_params

    config, logs, jstate = jax_checkpoint
    # the port reads the JAX checkpoint (opt_state and all) ...
    st = load_inference_state(config, logs)
    for a, b in zip(jax.tree.leaves(st.params),
                    jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # ... and writes one the JAX package reads
    from hydragnn_torch.data.load_data import dataset_loading_and_splitting

    _, _, _, fcfg = dataset_loading_and_splitting(copy.deepcopy(config))
    model = create_model(ModelConfig.from_config(fcfg), seed=3)
    save_inference_checkpoint(model, get_log_name_config(config),
                              str(tmp_path), step=7)
    back = j_load(config, str(tmp_path))
    assert int(back.step) == 7
    again = create_model(ModelConfig.from_config(fcfg), seed=4)
    load_flax_params(again, back.params, back.batch_stats)
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


@pytest.mark.parametrize("model_type", ["SchNet", "PNA"])
def test_finalize_writes_the_same_dict(model_type):
    from hydragnn_tpu.config import config as jcfg
    from hydragnn_tpu.graph.batch import GraphSample as JSample
    from hydragnn_torch.config import config as tcfg

    rng = np.random.RandomState(0)
    samples = []
    for n in (4, 6, 5):
        ei = np.stack([rng.randint(0, n, 9), rng.randint(0, n, 9)])
        samples.append(JSample(x=rng.rand(n, 1), pos=rng.rand(n, 3),
                               edge_index=ei))
    config = _config("finalize_parity")
    config["NeuralNetwork"]["Architecture"]["model_type"] = model_type
    config["NeuralNetwork"]["Architecture"]["equivariance"] = (
        model_type == "SchNet")
    config["NeuralNetwork"]["Architecture"]["edge_features"] = ["length"]
    need_deg = model_type == "PNA"
    js = jcfg.DatasetStats.from_samples(samples, need_deg=need_deg)
    ts = tcfg.DatasetStats.from_samples(samples, need_deg=need_deg)
    want = jcfg.finalize(copy.deepcopy(config), js)
    got = tcfg.finalize(copy.deepcopy(config), ts)
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    assert tcfg.get_log_name_config(got) == jcfg.get_log_name_config(want)
    assert tcfg.head_specs_from_config(got)[0].dim == \
        jcfg.head_specs_from_config(want)[0].dim
    assert tcfg.label_slices_from_config(got) == \
        jcfg.label_slices_from_config(want)


def test_no_cuda_means_raise_not_cpu():
    from hydragnn_torch.utils.device import resolve_device

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


def _port_modules():
    root = os.path.join(REPO, "hydragnn_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                path = os.path.join(dirpath, fn)
                mod = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
                yield path, mod.removesuffix(".__init__")


def test_port_imports_neither_jax_nor_the_reference():
    mods = sorted(m for _, m in _port_modules())
    probe = (
        "import sys, importlib\n"
        "import hydragnn_torch\n"
        "from hydragnn_torch.run_prediction import run_prediction\n"
        "from hydragnn_torch.run_training import run_training\n"
        "from hydragnn_torch import run_training as _rt\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',"
        " 'hydragnn_tpu'))\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", probe], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    # and no port source imports them (not even lazily)
    for path, _ in _port_modules():
        tree = ast.parse(open(path, encoding="utf-8").read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "optax", "hydragnn_tpu"), (
                    f"{path} imports {name}")
