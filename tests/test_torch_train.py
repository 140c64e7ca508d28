"""The PyTorch port's training slice against the JAX package, on the CPU.

- optimizers: AdamW, Adam and SGD (optax semantics and defaults, the
  learning rate in the optimizer state) over several steps on the same
  gradients as ``optax`` through the reference's ``select_optimizer``,
  with a learning-rate rewrite midway, to 1e-6; ``freeze_conv_layers``
  zeroes the same updates; unported optimizers raise;
- the train loader shuffles into the reference's order, batch by batch,
  epoch by epoch;
- ``train_validate_test`` from one init (the JAX ``create_train_state``
  params carried into the port): per-epoch losses within 1e-4 relative
  (float32 sums in another order, amplified by Adam's normalisation over
  a few hundred steps), identical learning-rate, early-stop and
  checkpoint decisions;
- ``run_training`` end to end (``device="cpu"``, ``fused``): its
  checkpoint is read by the port's and by the reference's
  ``run_prediction``, whose predictions agree to 1e-4;
- knobs of the reference's loop that the port does not have raise.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-4)
LOSS_RTOL = 1e-4


def _config(name, epochs=6, lr=1e-3, batch=16):
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
    tr = config["NeuralNetwork"]["Training"]
    tr.update(num_epoch=epochs, batch_size=batch, EarlyStopping=True,
              patience=2, Checkpoint=True, checkpoint_warmup=1)
    tr["Optimizer"] = {"type": "AdamW", "learning_rate": lr}
    return config


# --- optimizers -------------------------------------------------------------


@pytest.mark.parametrize("name", ["AdamW", "Adam", "SGD"])
def test_optimizer_matches_optax(name):
    import optax

    from hydragnn_tpu.train import optimizer as jopt
    from hydragnn_torch.train import optimizer as topt

    rng = np.random.RandomState(0)
    shapes = {"a": (5, 3), "b": (3,), "c": (2, 2, 2)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    cfg = {"type": name, "learning_rate": 3e-3}
    jspec = jopt.select_optimizer(cfg)
    tspec = topt.select_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jspec.tx.init(jp)
    keys = sorted(shapes)
    tp = [torch.from_numpy(params[k].copy()) for k in keys]
    ts = tspec.tx.init(tp)
    assert topt.get_learning_rate(ts) == jopt.get_learning_rate(js)
    for step in range(6):
        if step == 3:  # the plateau scheduler's rewrite
            js = jopt.set_learning_rate(js, 1.5e-3)
            ts = topt.set_learning_rate(ts, 1.5e-3)
            assert topt.get_learning_rate(ts) == jopt.get_learning_rate(js)
        grads = {k: (rng.randn(*s) * 10 ** rng.uniform(-3, 1)).astype(
            np.float32) for k, s in shapes.items()}
        upd, js = jspec.tx.update({k: jnp.asarray(v) for k, v in
                                   grads.items()}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tu, ts = tspec.tx.update([torch.from_numpy(grads[k]) for k in keys],
                                 ts, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for k, p in zip(keys, tp):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} step {step} {k}")


def test_optimizer_defaults_and_refusals():
    from hydragnn_torch.train import optimizer as topt

    hp = topt.select_optimizer({"type": "AdamW"}).tx.hyper
    assert hp["weight_decay"] == pytest.approx(1e-4)  # optax, not torch
    assert hp["learning_rate"] == pytest.approx(1e-3)
    for name in ("RMSprop", "LAMB", "Adagrad"):
        with pytest.raises(NotImplementedError, match="A3"):
            topt.select_optimizer({"type": name})
    with pytest.raises(NameError):
        topt.select_optimizer({"type": "Nope"})


def test_freeze_conv_layers_zeroes_the_same_updates():
    from hydragnn_tpu.models.base import encoder_freeze_mask
    from hydragnn_torch.train.optimizer import frozen_mask

    upd = {"encoder_conv_0": {"lin1": {"kernel": jnp.ones(3)}},
           "graph_shared": {"dense_0": {"kernel": jnp.ones(3)}},
           "head_0": {"dense_0": {"bias": jnp.ones(1)}}}
    out = encoder_freeze_mask(upd, True)
    want = [float(jnp.sum(out[k][a][b])) == 0.0
            for k, a, b in (("encoder_conv_0", "lin1", "kernel"),
                            ("graph_shared", "dense_0", "kernel"),
                            ("head_0", "dense_0", "bias"))]
    got = frozen_mask(["graph_convs.0.lin1.weight", "graph_shared.0.weight",
                       "heads_NN.0.0.bias"], True)
    assert got == want == [True, False, False]
    assert frozen_mask(["graph_convs.0.lin1.weight"], False) is None


# --- loader order -----------------------------------------------------------


def test_train_loader_order_matches_jax():
    from hydragnn_tpu.data.dataloader import GraphDataLoader as JLoader
    from hydragnn_tpu.graph import batch as jb
    from hydragnn_torch.data.dataloader import GraphDataLoader as TLoader
    from hydragnn_torch.graph import batch as tb

    rng = np.random.RandomState(3)
    raw = []
    for i in range(37):
        n = int(rng.randint(3, 9))
        raw.append(dict(x=np.full((n, 1), i, np.float32),
                        pos=rng.rand(n, 3).astype(np.float32),
                        edge_index=np.zeros((2, 0), np.int32),
                        graph_y=np.array([i], np.float32)))
    jl = JLoader([jb.GraphSample(**r) for r in raw],
                 [jb.HeadSpec("y", "graph", 1)], 8, shuffle=True, seed=5)
    tl = TLoader([tb.GraphSample(**r) for r in raw],
                 [tb.HeadSpec("y", "graph", 1)], 8, shuffle=True, seed=5)
    orders = []
    for epoch in range(2):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        jbs, tbs = list(jl), list(tl)
        assert len(jbs) == len(tbs) == 5
        seq = []
        for a, b in zip(jbs, tbs):
            np.testing.assert_array_equal(b.labels[0].numpy(),
                                          np.asarray(a.labels[0]))
            np.testing.assert_array_equal(b.x.numpy(), np.asarray(a.x))
            seq += list(b.labels[0].numpy()[b.graph_mask.numpy() > 0, 0])
        assert sorted(seq) == list(range(37))
        orders.append(seq)
    assert orders[0] != orders[1]  # reshuffled per epoch


# --- the training loop from one init ---------------------------------------


def _record_checkpoints(monkeypatch, module, log):
    orig = module.CheckpointTracker.__call__

    def wrapped(self, state, metric):
        saved = orig(self, state, metric)
        log.append(bool(saved))
        return saved

    monkeypatch.setattr(module.CheckpointTracker, "__call__", wrapped)


@pytest.mark.parametrize("backend", ["scatter", "fused"])
def test_train_validate_test_tracks_jax(backend, monkeypatch, tmp_path):
    """Same init, same batches: the reference (scatter, one device, one
    jitted step per batch) and the port (``backend``; under fused its
    autograd Functions with the plain kernel versions) give the same
    per-epoch losses and decisions."""
    from ci_data import generate_cached
    from hydragnn_tpu.config.config import get_log_name_config
    from hydragnn_tpu.data.load_data import (
        dataset_loading_and_splitting as j_load)
    from hydragnn_tpu.models.base import ModelConfig as JCfg
    from hydragnn_tpu.models.create import create_model as j_model
    from hydragnn_tpu.train import trainer as jtr
    from hydragnn_tpu.train.optimizer import select_optimizer as j_opt
    from hydragnn_torch.data.load_data import (
        dataset_loading_and_splitting as t_load)
    from hydragnn_torch.models.base import ModelConfig as TCfg
    from hydragnn_torch.models.create import create_model as t_model
    from hydragnn_torch.train import trainer as ttr
    from hydragnn_torch.train.optimizer import select_optimizer as t_opt
    from hydragnn_torch.utils.weights import load_flax_params

    monkeypatch.setenv("HYDRAGNN_AUTO_PIPELINE", "0")
    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", "scatter")
    # one device: the test session's 8 virtual CPU devices would make the
    # reference split each batch into per-device micro-batches
    monkeypatch.setattr(jax, "local_devices",
                        lambda *a, **k: jax.devices()[:1])
    name = "torch_port_train"
    generate_cached(name, f"dataset/{name}", 120)
    config = _config(name, epochs=7, lr=2e-2)
    jl = j_load(copy.deepcopy(config))
    jtrain, jval, jtest, jcfg = jl
    log_name = get_log_name_config(jcfg)
    jm = j_model(JCfg.from_config(jcfg["NeuralNetwork"]))
    jspec = j_opt(jcfg["NeuralNetwork"]["Training"]["Optimizer"])
    jstate = jtr.create_train_state(jm, next(iter(jtrain)), jspec)
    params0 = jax.tree.map(np.asarray, jstate.params)
    # plateau patience 1 instead of 5, in both packages, so that a short
    # run reaches a learning-rate decision
    for mod in (jtr, ttr):
        monkeypatch.setattr(mod.ReduceLROnPlateau.__init__, "__defaults__",
                            (0.5, 1, 1e-5, 1e-4))
    jsaves, tsaves = [], []
    _record_checkpoints(monkeypatch, jtr, jsaves)
    _record_checkpoints(monkeypatch, ttr, tsaves)
    _, jh = jtr.train_validate_test(
        jm, JCfg.from_config(jcfg["NeuralNetwork"]), jstate, jspec, jtrain,
        jval, jtest, jcfg["NeuralNetwork"], log_name,
        logs_dir=str(tmp_path / "jax"), use_mesh_dp=False)

    monkeypatch.setenv("HYDRAGNN_AGGR_BACKEND", backend)
    ttrain, tval, ttest, tcfg = t_load(copy.deepcopy(config))
    cfg = TCfg.from_config(tcfg["NeuralNetwork"])
    model = t_model(cfg)
    load_flax_params(model, params0)
    tspec = t_opt(tcfg["NeuralNetwork"]["Training"]["Optimizer"])
    state = ttr.create_train_state(model, tspec)
    state, th = ttr.train_validate_test(
        model, cfg, state, tspec, ttrain, tval, ttest,
        tcfg["NeuralNetwork"], log_name, logs_dir=str(tmp_path / "torch"),
        device=torch.device("cpu"))
    assert ("edge_perm_sender" in next(iter(ttrain)).extras) == (
        backend == "fused")

    for k in ("train", "val", "test"):
        np.testing.assert_allclose(th[k], jh[k], rtol=LOSS_RTOL, err_msg=k)
    assert th["lr"] == jh["lr"]
    assert len(th["train"]) == len(jh["train"])
    assert tsaves == jsaves
    # the run exercises each decision: a learning-rate cut, an early stop
    # before the last epoch, at least one checkpoint skipped and one saved
    assert len(set(th["lr"])) > 1
    assert len(th["train"]) < 7 and True in tsaves and False in tsaves
    assert state.step == len(th["train"]) * len(ttrain)


def test_run_training_checkpoint_reads_in_both_packages(monkeypatch,
                                                         tmp_path):
    import hydragnn_tpu
    import hydragnn_torch
    from ci_data import generate_cached

    name = "torch_port_runtrain"
    generate_cached(name, f"dataset/{name}", 96)
    config = _config(name, epochs=2)
    config["NeuralNetwork"]["Variables_of_interest"]["denormalize_output"] \
        = True
    config["NeuralNetwork"]["Architecture"]["aggregation_backend"] = "fused"
    monkeypatch.delenv("HYDRAGNN_AGGR_BACKEND", raising=False)
    logs = str(tmp_path)
    state, hist, fcfg = hydragnn_torch.run_training(
        copy.deepcopy(config), logs_dir=logs, device="cpu")
    assert "HYDRAGNN_AGGR_BACKEND" not in os.environ  # scoped export
    assert len(hist["train"]) == 2 and all(np.isfinite(hist["train"]))
    assert state.step > 0 and hist["pipeline"]["steps_per_dispatch"] == 1
    from hydragnn_torch.config.config import get_log_name_config

    run = os.path.join(logs, get_log_name_config(fcfg))
    assert os.path.exists(os.path.join(run, "config.json"))
    assert os.path.exists(os.path.join(run, "run.log"))
    got = hydragnn_torch.run_prediction(copy.deepcopy(config),
                                        logs_dir=logs, device="cpu")
    want = hydragnn_tpu.run_prediction(copy.deepcopy(config), logs_dir=logs)
    np.testing.assert_allclose(got[0], want[0], **TOL)
    for t, j in zip(got[3], want[3]):
        np.testing.assert_allclose(t, np.asarray(j), **TOL)
    # and the port restores its own optimizer state
    from hydragnn_torch.train.trainer import load_state

    back = load_state(state, get_log_name_config(fcfg), logs)
    assert back.step == state.step
    assert back.opt_state.count == state.opt_state.count


@pytest.mark.parametrize("env,training", [
    ({"HYDRAGNN_STEPS_PER_DISPATCH": "4"}, {}),
    ({"HYDRAGNN_RESIDENT_DATASET": "1"}, {}),
    ({"HYDRAGNN_TELEMETRY": "1"}, {}),
    ({"HYDRAGNN_TRAIN_DTYPE": "bf16"}, {}),
    ({}, {"nonfinite_guard": 1}),
    ({}, {"preemption": 1}),
    ({}, {"zero_stage": 1}),
    ({}, {"continue": 1}),
], ids=["steps", "resident", "telemetry", "bf16", "guard", "preempt",
        "zero", "continue"])
def test_unported_knobs_raise(env, training, monkeypatch, tmp_path):
    import hydragnn_torch

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    config = _config("torch_port_runtrain", epochs=1)
    config["NeuralNetwork"]["Training"].update(training)
    with pytest.raises(NotImplementedError):
        hydragnn_torch.run_training(config, logs_dir=str(tmp_path),
                                    device="cpu")


def test_force_heads_raise():
    from hydragnn_torch.train.trainer import make_train_step

    with pytest.raises(NotImplementedError, match="force"):
        make_train_step(None, None, None,
                        output_names=["total_energy", "atomic_forces"])
