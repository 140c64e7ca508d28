#!/usr/bin/env python3
"""Drive the PyTorch port (hydragnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA device, ``nvcc``
and PyTorch built for CUDA.  Phases, each of which fails the run:

1. device: require CUDA, print the card's name and power limit, keep
   float32 matmuls in full precision;
2. build: compile the port's CUDA kernels from csrc/ with nvcc (sm_90a),
   one nvcc per source, all started together;
3. kernels: on the first batch of the main path (512 flagship-size graphs,
   masked tail edges, empty segments), hold each kernel to its plain
   PyTorch version and time kernel, plain version and library call (CUDA
   events, median of 50 runs after warm-up, L2 flushed before each run,
   no host gap inside a timed run): the gather-multiply forward (F=64),
   its no-``w`` mode and the pool (max |kernel - plain| / max |plain| <=
   1e-5), the dx pass of both backwards through the ops' autograd backward
   against autograd through the plain versions (dx, and dw on real edges,
   1e-5), and the three scf kernels of the wide
   SchNet (F=256, G=50: forward, pass P, pass S) through their autograd
   Function against autograd through the composed plain version (1e-5;
   1e-4 for the weight grads, sums over ~1e5 edges in another order);
4. flagship prediction: a seeded SchNet checkpoint at the flagship widths
   (hidden 64, 4 convs, 50 gaussians, 64 filters, radius 1.8,
   max_neighbours 20, graph head (2, 64, 2, (64, 64)), batch 512) through
   ``hydragnn_torch.run_prediction`` on the card under
   ``HYDRAGNN_AGGR_BACKEND=fused``: exactly 4 gather-multiply and 1 pool
   launch per batch, finite outputs, agreement with the CPU run to 1e-4;
5. flagship training: ``hydragnn_torch.run_training`` on the card (AdamW
   lr 1e-3, 3 epochs over a 3000-graph train split): exactly 4
   gather-multiply, 4 dx and 1 pool launch per train step and 4 + 1 per
   eval batch (train and eval passes counted apart in the card run), every
   dispatch site fused, a finite falling loss, per-epoch
   losses within 1e-4 relative of the same run on the CPU, two card runs
   of the first three steps with bit-identical parameters, graphs/s of a
   steady train epoch and the device's idle share in a profiled one; then
   ``run_prediction`` on the checkpoint the run wrote, card vs CPU;
6. wide training: the same at hidden = num_filters = 256 (the fused edge
   pipeline), capped at 2 batches per pass (``HYDRAGNN_MAX_NUM_BATCH``) so
   the CPU run stays short: 4 scf forward, 4 pass P and 4 pass S launches
   per train step, no gather-multiply launch.

Prints JSON lines with the seconds of each phase; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, it exits non-zero before printing any result.
"""

import argparse
import copy
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# rate outside the tensor cores — the basis of every bound_ms below
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# torch.cuda._sleep spins for clock cycles; the H100's SM clock is at most
# ~1.98 GHz, so this rate never sleeps shorter than intended
SLEEP_CYCLES_PER_S = 2.0e9

REL_TOL_KERNEL = 1e-5
# the scf weight grads are sums over every edge of the batch (~1e5 float32
# products) in another order than the plain version's GEMMs
REL_TOL_WGRAD = 1e-4
REL_TOL_PATH = 1e-4
# per-epoch losses, card vs CPU, after a few dozen AdamW steps
REL_TOL_LOSS = 1e-4
N_CONFIGURATIONS = 6000   # perc_train 0.1 -> 2700 test graphs, 6 batches
BATCH = 512
FEATURES = 64
WIDE = 256
GAUSSIANS = 50
TRAIN_EPOCHS = 3
WIDE_EPOCHS = 2
WIDE_CAP = 2              # batches per pass of the wide run_training
REPEAT_STEPS = 3


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(obj):
    print(json.dumps(obj), flush=True)


def smi_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def flagship_config(width=64, perc_train=0.1, epochs=1):
    return {
        "Verbosity": {"level": 0},
        "Dataset": {
            "name": "chip_smoke",
            "format": "unit_test",
            "compositional_stratified_splitting": False,
            "rotational_invariance": False,
            "path": {"total": "dataset/chip_smoke"},
            "node_features": {"name": ["x", "x2", "x3"], "dim": [1, 1, 1],
                              "column_index": [0, 6, 7]},
            "graph_features": {"name": ["sum_x_x2_x3"], "dim": [1],
                               "column_index": [0]},
        },
        "NeuralNetwork": {
            "Architecture": {
                "model_type": "SchNet",
                "radius": 1.8,
                "max_neighbours": 20,
                "num_gaussians": 50,
                "num_filters": width,
                "hidden_dim": width,
                "num_conv_layers": 4,
                "periodic_boundary_conditions": False,
                "output_heads": {"graph": {
                    "num_sharedlayers": 2, "dim_sharedlayers": width,
                    "num_headlayers": 2, "dim_headlayers": [width, width]}},
                "task_weights": [1.0],
            },
            "Variables_of_interest": {
                "input_node_features": [0],
                "output_names": ["sum_x_x2_x3"],
                "output_index": [0],
                "type": ["graph"],
                "denormalize_output": False,
            },
            "Training": {
                "num_epoch": epochs,
                "perc_train": perc_train,
                "EarlyStopping": True,
                "Checkpoint": True,
                "batch_size": BATCH,
                "loss_function_type": "mse",
                "Optimizer": {"type": "AdamW", "learning_rate": 1e-3},
            },
        },
        "Visualization": {"create_plots": False},
    }


def time_ms(torch, fn, flush=None, reps=50, warmup=5):
    """Median device milliseconds of ``fn`` over ``reps`` runs, each between
    its own CUDA events; with ``flush`` (a buffer larger than the L2 cache)
    the cache is overwritten before each run.  All runs are enqueued behind
    a device-side sleep that outlasts the host's enqueueing, so no host
    launch gap falls inside a timed interval."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        if flush is not None:
            flush.zero_()
        fn()
    torch.cuda.synchronize()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda._sleep(int(2 * reps * host_s * SLEEP_CYCLES_PER_S))
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def forward_profile(torch, model, g, reps=3, top=8):
    """Device time per forward pass by kernel (torch.profiler, CUPTI):
    the kernels' total and the ``top`` largest, in ms per forward."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            model(g)
        torch.cuda.synchronize()
    # kernel rows carry device time and no host time of their own
    rows = [r for r in prof.key_averages()
            if r.self_device_time_total > 0 and r.self_cpu_time_total == 0]
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    total = sum(r.self_device_time_total for r in rows) / 1e3 / reps
    return {
        "kernel_ms_per_forward": total,
        "kernel_launches_per_forward": sum(r.count for r in rows) / reps,
        "top": [{"kernel": r.key[:90],
                 "ms_per_forward": r.self_device_time_total / 1e3 / reps,
                 "calls_per_forward": r.count / reps} for r in rows[:top]],
    }


def bound(nbytes, flops):
    """The least time for the work: bytes over the HBM rate or float32
    operations over the peak, whichever is larger (ms, and which)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / F32_FLOPS_PER_S * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def rel_err(torch, got, want):
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    return err, err / max(scale, 1e-30)


def kernel_phase(torch, g, seed):
    """Each kernel against its plain version at the main path's shapes."""
    from hydragnn_torch.ops import fused_mp as fm
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    n, e, n_graphs = g.num_nodes, g.num_edges, g.num_graphs
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, FEATURES, device=dev, generator=gen)
    mask = g.edge_mask
    w = torch.randn(e, FEATURES, device=dev, generator=gen) * mask[:, None]
    send, recv = g.senders, g.receivers
    perm = g.extras["edge_perm_sender"]
    xn = x * g.node_mask[:, None]
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)  # > L2
    e_valid = int(mask.sum())
    f = FEATURES
    results, notes = [], {}

    # -- gather_mul_segment_sum: CFConv aggregation, once per conv layer
    k = fm.gather_mul_segment_sum(x, w, send, recv, perm, edge_valid=mask)
    torch.cuda.synchronize()
    p = fm.gather_mul_segment_sum_plain(x, w, send, recv, edge_valid=mask)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(torch, k, p)
    check(rel_e <= REL_TOL_KERNEL,
          f"gather_mul_segment_sum disagrees with its plain version: {rel_e}")
    row_ptr = segment_offsets(recv, n, mask)
    # inputs read once (x, the valid rows of w, valid senders, receivers and
    # edge_valid for the schedule), output written once; 2 flops per
    # valid edge and feature
    b_ms, b_by = bound(
        4 * (n * f + e_valid * f + e_valid + 2 * e + n * f),
        2 * e_valid * f)
    results.append({
        "name": "gather_mul_segment_sum", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": abs_e, "max_rel_err": rel_e,
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, w, None, send, row_ptr), flush),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, w, None, send, row_ptr)),
        "wrapper_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum(
            x, w, send, recv, perm, edge_valid=mask), flush),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            x, w, send, recv, edge_valid=mask), flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
    })

    # -- no-w mode of the same kernel (gather_segment_sum; GIN/MFC-style)
    k = fm.gather_segment_sum(x, send, recv, perm, mask)
    torch.cuda.synchronize()
    p = fm.gather_mul_segment_sum_plain(x, None, send, recv, edge_valid=mask,
                                        mask=mask)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(torch, k, p)
    check(rel_e <= REL_TOL_KERNEL,
          f"gather_segment_sum disagrees with its plain version: {rel_e}")
    notes["gather_segment_sum"] = {
        "max_abs_err": abs_e, "max_rel_err": rel_e,
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, None, mask, send, row_ptr, op="gather_segment_sum"), flush),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            x, None, send, recv, edge_valid=mask, mask=mask), flush)}

    # -- the dx pass of both backwards (K1), held through the code the main
    #    path runs: the ops' backward (autograd Function) against autograd
    #    through the plain versions, dw on real edges; then the kernel timed
    #    alone on the sender-sorted arrays that backward builds
    ct = torch.randn(n, f, device=dev, generator=gen)
    real = mask != 0

    def grads(fn, inputs):
        ts = [t.detach().clone().requires_grad_(True) for t in inputs]
        fn(*ts).backward(ct)
        torch.cuda.synchronize()
        return [t.grad for t in ts]

    fm.reset_launches()
    gk = grads(lambda x_, w_: fm.gather_mul_segment_sum(
        x_, w_, send, recv, perm, edge_valid=mask), (x, w))
    gp = grads(lambda x_, w_: fm.gather_mul_segment_sum_plain(
        x_, w_, send, recv, edge_valid=mask), (x, w))
    (sk,) = grads(lambda x_: fm.gather_segment_sum(
        x_, send, recv, perm, mask), (x,))
    (sp,) = grads(lambda x_: fm.gather_mul_segment_sum_plain(
        x_, None, send, recv, edge_valid=mask, mask=mask), (x,))
    check(fm.LAUNCHES["gather_mul_segment_sum_dx"] == 1
          and fm.LAUNCHES["gather_segment_sum_dx"] == 1,
          f"the backward did not launch the dx kernel: {fm.LAUNCHES}")
    dx_err = rel_err(torch, gk[0], gp[0])
    dw_err = rel_err(torch, gk[1][real], gp[1][real])
    sdx_err = rel_err(torch, sk, sp)
    for what, (_, rel_e) in (("gather_mul_segment_sum dx", dx_err),
                             ("gather_mul_segment_sum dw", dw_err),
                             ("gather_segment_sum dx", sdx_err)):
        check(rel_e <= REL_TOL_KERNEL,
              f"{what} disagrees with autograd through the plain version: "
              f"{rel_e}")
    notes["gather_mul_segment_sum_dw"] = {"max_abs_err": dw_err[0],
                                          "max_rel_err": dw_err[1]}
    p_ = perm.long()
    w_s, m_s = w[p_].contiguous(), mask[p_].contiguous()
    send_s, recv_s = recv[p_].contiguous(), send[p_].contiguous()
    ptr_s = segment_offsets(recv_s, n, m_s)
    b_ms, b_by = bound(
        4 * (n * f + e_valid * f + e_valid + 2 * e + n * f),
        2 * e_valid * f)
    results.append({
        "name": "gather_mul_segment_sum_dx", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": dx_err[0], "max_rel_err": dx_err[1],
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, w_s, None, send_s, ptr_s, op="gather_mul_segment_sum_dx"),
            flush),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, w_s, None, send_s, ptr_s, op="gather_mul_segment_sum_dx")),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            ct, w_s, send_s, recv_s, edge_valid=m_s), flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
    })
    notes["gather_segment_sum_dx"] = {
        "max_abs_err": sdx_err[0], "max_rel_err": sdx_err[1],
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, None, m_s, send_s, ptr_s, op="gather_segment_sum_dx"), flush),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            ct, None, send_s, recv_s, edge_valid=m_s, mask=m_s), flush)}
    notes["gather_segment_sum"]["bound_ms"], \
        notes["gather_segment_sum"]["bound_by"] = bound(
            4 * (n * f + e_valid + 2 * e + n * f), 2 * e_valid * f)

    # -- segment_sum_dense over edge rows: masked tail, empty segments
    k = fm.segment_sum_dense(w, recv, n, valid=mask)
    torch.cuda.synchronize()
    p = fm.segment_sum_dense_plain(w, recv, n, valid=mask)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(torch, k, p)
    check(rel_e <= REL_TOL_KERNEL,
          f"segment_sum_dense (edges) disagrees with its plain version: "
          f"{rel_e}")
    empty = int((segment_offsets(recv, n, mask).diff() == 0).sum())
    notes["segment_sum_dense_edges"] = {
        "max_abs_err": abs_e, "max_rel_err": rel_e, "empty_segments": empty}

    # -- segment_sum_dense as the mean pool: [N, F] over node_gid -> [G, F]
    gid = g.node_gid
    k = fm.segment_sum_dense(xn, gid, n_graphs)
    torch.cuda.synchronize()
    p = fm.segment_sum_dense_plain(xn, gid, n_graphs)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(torch, k, p)
    check(rel_e <= REL_TOL_KERNEL,
          f"segment_sum_dense (pool) disagrees with its plain version: "
          f"{rel_e}")
    pool_ptr = segment_offsets(gid, n_graphs)
    lengths = torch.bincount(gid.long(), minlength=n_graphs)
    lib = torch.segment_reduce(xn, "sum", lengths=lengths, axis=0)
    torch.cuda.synchronize()
    check(rel_err(torch, lib, p)[1] <= REL_TOL_KERNEL,
          "torch.segment_reduce disagrees with the plain segment sum")
    b_ms, b_by = bound(4 * (n * f + n + n_graphs * f), n * f)
    results.append({
        "name": "segment_sum_dense", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:340",
        "max_abs_err": abs_e, "max_rel_err": rel_e,
        "ms": time_ms(torch, lambda: fm.launch_segment_sum_dense(
            xn, pool_ptr, n_graphs), flush),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_segment_sum_dense(
            xn, pool_ptr, n_graphs)),
        "wrapper_ms": time_ms(torch, lambda: fm.segment_sum_dense(
            xn, gid, n_graphs), flush),
        "plain_ms": time_ms(torch, lambda: fm.segment_sum_dense_plain(
            xn, gid, n_graphs), flush),
        "library_ms": time_ms(torch, lambda: torch.segment_reduce(
            xn, "sum", lengths=lengths, axis=0), flush),
        "bound_ms": b_ms, "bound_by": b_by,
        "shape": {"N": n, "G": n_graphs, "F": f},
    })
    return results, notes


def scf_phase(torch, g, seed):
    """The three scf kernels of the wide SchNet against the composed plain
    version under autograd, at the first batch's geometry (F=256, G=50,
    radius 1.8), and each kernel timed alone as the main path launches it
    (pass P without drbf/dcm: energy-only training asks for neither)."""
    from hydragnn_torch.models.schnet import gaussian_smearing
    from hydragnn_torch.ops import scf_mp as sm
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    f, gd, radius = WIDE, GAUSSIANS, 1.8
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    perm = g.extras["edge_perm_sender"]
    em = mask.to(torch.int32)
    d = g.pos[send.long()] - g.pos[recv.long()]
    dist = torch.sqrt((d * d).sum(-1) + 1e-12)
    rbf = gaussian_smearing(dist, radius, gd).contiguous()
    cut = 0.5 * (torch.cos(dist * math.pi / radius) + 1.0)
    cm = (torch.where(dist <= radius, cut, torch.zeros_like(cut))
          * mask).contiguous()
    # weights at the scale of the model's init (lecun normal)
    ins = [torch.randn(n, f, device=dev, generator=gen), rbf, cm,
           torch.randn(gd, f, device=dev, generator=gen) / math.sqrt(gd),
           torch.randn(f, device=dev, generator=gen) * 0.1,
           torch.randn(f, f, device=dev, generator=gen) / math.sqrt(f),
           torch.randn(f, device=dev, generator=gen) * 0.1]
    ct = torch.randn(n, f, device=dev, generator=gen)
    names = ("h", "rbf", "cm", "w0", "b0", "w1", "b1")

    def grads(fn):
        ts = [t.detach().clone().requires_grad_(True) for t in ins]
        out = fn(*ts)
        out.backward(ct)
        torch.cuda.synchronize()
        return out.detach(), [t.grad for t in ts]

    sm.reset_launches()
    out_k, gk = grads(lambda *a: sm.scf_edge_pipeline(
        a[0], a[1], a[2], em, *a[3:], send, recv, perm))
    check(sm.LAUNCHES == {"scf_edge_pipeline": 1,
                          "scf_edge_pipeline_pass_p": 1,
                          "scf_edge_pipeline_pass_s": 1},
          f"scf launches {sm.LAUNCHES}")
    out_p, gp = grads(lambda *a: sm.scf_edge_pipeline_plain(
        a[0], a[1], a[2], em, *a[3:], send, recv))
    real = mask != 0
    errs = {"out": rel_err(torch, out_k, out_p)}
    for name, a, c in zip(names, gk, gp):
        if name in ("rbf", "cm"):
            check(bool((a[~real] == 0).all()),
                  f"scf d{name} is not zero on masked edges")
            a, c = a[real], c[real]
        errs["d" + name] = rel_err(torch, a, c)
    for name, (abs_e, rel_e) in errs.items():
        tol = REL_TOL_WGRAD if name in ("dw0", "db0", "dw1", "db1") \
            else REL_TOL_KERNEL
        check(rel_e <= tol, f"scf {name} disagrees with the plain version "
              f"under autograd: {rel_e} > {tol}")

    e_valid = int(real.sum())
    h, _, _, w0, b0, w1, b1 = ins
    ptr_r = segment_offsets(recv, n, em)
    p_ = perm.long()
    ptr_s = segment_offsets(send[p_], n, em[p_])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    wbytes = 4 * (gd * f + f * f + 2 * f)
    geo = 4 * e_valid * (gd + 1 + 2)   # rbf rows, cm, two ids
    fwd_flops = 2 * e_valid * (gd * f + f * f)
    launches = {
        "scf_edge_pipeline": (
            lambda: sm.launch_scf_filter_gather(
                h, rbf, cm, w0, b0, w1, b1, send, recv, None, ptr_r,
                "scf_edge_pipeline"),
            lambda: sm.scf_edge_pipeline_plain(
                h, rbf, cm, em, w0, b0, w1, b1, send, recv),
            bound(4 * 2 * n * f + geo + wbytes, fwd_flops),
            "hydragnn_tpu/ops/fused_block.py:495", ("out",)),
        "scf_edge_pipeline_pass_p": (
            lambda: sm.launch_scf_pass_p(
                h, ct, rbf, cm, w0, b0, w1, b1, send, recv, ptr_r, False),
            lambda: sm.scf_pass_p_plain(
                h, ct, rbf, cm, em, w0, b0, w1, b1, send, recv),
            bound(4 * 2 * n * f + geo + 3 * wbytes,
                  2 * e_valid * (2 * gd * f + 3 * f * f)),
            "hydragnn_tpu/ops/fused_block.py:561",
            ("dw0", "db0", "dw1", "db1", "drbf", "dcm")),
        "scf_edge_pipeline_pass_s": (
            lambda: sm.launch_scf_filter_gather(
                ct, rbf, cm, w0, b0, w1, b1, recv, send, perm, ptr_s,
                "scf_edge_pipeline_pass_s"),
            lambda: sm.scf_edge_pipeline_plain(
                ct, rbf, cm, em, w0, b0, w1, b1, recv, send),
            bound(4 * 2 * n * f + geo + 4 * e_valid + wbytes, fwd_flops),
            "hydragnn_tpu/ops/fused_block.py:599", ("dh",)),
    }
    results = []
    for name, (kern, plain, (b_ms, b_by), replaces, outs) in launches.items():
        worst = max(outs, key=lambda o: errs[o][1])
        results.append({
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/scf_mp.cu", "replaces": replaces,
            "max_abs_err": errs[worst][0], "max_rel_err": errs[worst][1],
            "ms": time_ms(torch, kern, flush),
            "warm_l2_ms": time_ms(torch, kern),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f, "G": gd},
        })
    return results, {k: {"max_abs_err": a, "max_rel_err": r}
                     for k, (a, r) in errs.items()}


def expect(launches, want, what):
    for k, v in want.items():
        check(launches.get(k, 0) == v,
              f"{what}: {k} launched {launches.get(k, 0)} times, "
              f"expected {v}")


def train_phase(torch, hydragnn_torch, config, logs, seed, cap=None):
    """``run_training`` on the card and on the CPU (plain versions) for the
    same config.  In the card run every pass over a loader is wrapped so
    that its batches and kernel launches are tallied apart, train passes
    from eval passes.  Returns (card result, CPU result, launches of the
    card run, that tally, dispatch tally, card seconds, CPU seconds)."""
    from hydragnn_torch.ops import fused_mp, scf_mp
    from hydragnn_torch.telemetry import pipeline
    from hydragnn_torch.train import trainer

    def counts():
        return {**fused_mp.LAUNCHES, **scf_mp.LAUNCHES}

    split = {"train": {"batches": 0, "launches": {}},
             "eval": {"batches": 0, "launches": {}}}
    run_epoch = trainer._run_epoch

    def tallied(step_fn, state, loader, train, device):
        part = split["train" if train else "eval"]

        def step(*a):
            part["batches"] += 1
            return step_fn(*a)

        before = counts()
        out = run_epoch(step, state, loader, train, device)
        for k, v in counts().items():
            part["launches"][k] = part["launches"].get(k, 0) + v - before[k]
        return out

    if cap is not None:
        os.environ["HYDRAGNN_MAX_NUM_BATCH"] = str(cap)
    try:
        fused_mp.reset_launches()
        scf_mp.reset_launches()
        before = pipeline.dispatch_snapshot()
        trainer._run_epoch = tallied
        try:
            t0 = time.perf_counter()
            card = hydragnn_torch.run_training(
                copy.deepcopy(config), logs_dir=os.path.join(logs, "cuda"),
                seed=seed, device="cuda")
            torch.cuda.synchronize()
            wall_card = time.perf_counter() - t0
        finally:
            trainer._run_epoch = run_epoch
        launches = counts()
        dispatch = pipeline.dispatch_delta(before,
                                           pipeline.dispatch_snapshot())
        t0 = time.perf_counter()
        cpu = hydragnn_torch.run_training(
            copy.deepcopy(config), logs_dir=os.path.join(logs, "cpu"),
            seed=seed, device="cpu")
        wall_cpu = time.perf_counter() - t0
    finally:
        os.environ.pop("HYDRAGNN_MAX_NUM_BATCH", None)
    return card, cpu, launches, split, dispatch, wall_card, wall_cpu


def check_training(name, card, cpu, launches, split, dispatch, loaders, cap,
                   wide):
    """The card run's launches, train passes and eval passes apart, against
    what the path must launch per batch, and its losses against the CPU's.
    Returns (train steps, eval batches, per-step and per-eval-batch
    launches, loss agreement)."""
    from hydragnn_torch.telemetry import pipeline

    _, hist, _ = card
    _, hist_cpu, _ = cpu
    steps, evals = split["train"]["batches"], split["eval"]["batches"]
    epochs = len(hist["train"])
    lens = [len(l) if cap is None else min(cap, len(l)) for l in loaders]
    check((steps, evals) == (epochs * lens[0], epochs * (lens[1] + lens[2])),
          f"{name}: {steps} train steps and {evals} eval batches over "
          f"{epochs} epochs of loaders {lens}")
    if wide:
        per_step = {"scf_edge_pipeline": 4, "scf_edge_pipeline_pass_p": 4,
                    "scf_edge_pipeline_pass_s": 4,
                    "gather_mul_segment_sum": 0,
                    "gather_mul_segment_sum_dx": 0, "segment_sum_dense": 1}
        per_eval = {"scf_edge_pipeline": 4, "scf_edge_pipeline_pass_p": 0,
                    "scf_edge_pipeline_pass_s": 0,
                    "gather_mul_segment_sum": 0,
                    "gather_mul_segment_sum_dx": 0, "segment_sum_dense": 1}
    else:
        per_step = {"gather_mul_segment_sum": 4,
                    "gather_mul_segment_sum_dx": 4, "segment_sum_dense": 1,
                    "scf_edge_pipeline": 0}
        per_eval = {"gather_mul_segment_sum": 4,
                    "gather_mul_segment_sum_dx": 0, "segment_sum_dense": 1,
                    "scf_edge_pipeline": 0}
    expect(split["train"]["launches"],
           {k: v * steps for k, v in per_step.items()}, f"{name} (train)")
    expect(split["eval"]["launches"],
           {k: v * evals for k, v in per_eval.items()}, f"{name} (eval)")
    for k, v in launches.items():
        check(v == split["train"]["launches"].get(k, 0)
              + split["eval"]["launches"].get(k, 0),
              f"{name}: {k} launched outside a train or eval pass")
    measured = {k: {"per_train_step": split["train"]["launches"][k] / steps,
                    "per_eval_batch": split["eval"]["launches"][k] / evals}
                for k in launches}
    check(pipeline.dispatch_summary(dispatch) == "fused",
          f"{name}: a dispatch site left the kernels: {dispatch}")
    losses = hist["train"]
    check(all(math.isfinite(v) for v in losses + hist["val"]),
          f"{name}: non-finite loss {losses}")
    check(losses[-1] < losses[0], f"{name}: the loss did not fall {losses}")
    rel = {}
    for k in ("train", "val", "test"):
        a, b = hist[k], hist_cpu[k]
        check(len(a) == len(b), f"{name}: {len(a)} vs {len(b)} epochs")
        rel[k] = max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))
        check(rel[k] <= REL_TOL_LOSS,
              f"{name}: card and CPU {k} losses differ by {rel[k]}")
    check(hist["lr"] == hist_cpu["lr"], f"{name}: lr decisions differ")
    return steps, evals, measured, rel


def repeat_bits(torch, cfg, batches, seed, dev):
    """Two card runs of the first REPEAT_STEPS steps from one seeded init:
    every parameter bit-identical."""
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    runs = []
    for _ in range(2):
        model = create_model(cfg, seed=seed).to(dev)
        spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
        state = create_train_state(model, spec)
        step = make_train_step(model, cfg, spec)
        for gb in batches:
            state, _ = step(state, gb)
        torch.cuda.synchronize()
        runs.append([p.detach().clone() for p in model.parameters()])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, "two card runs of the first steps gave different bits")
    return len(runs[0])


def steady_epoch(torch, cfg, loader, seed, dev):
    """Train graphs/s of a steady epoch on the card (epoch 0 warms up,
    epoch 1 is timed, host clock ending in a synchronize, batches collated
    on the fly as in run_training) and the device's idle share: epoch 2
    under torch.profiler, one minus its kernel time over its own wall (the
    profiler's host cost is inside that wall, so the share is an upper
    bound; its wall is printed beside the unprofiled one)."""
    from torch.profiler import ProfilerActivity, profile

    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import (
        _run_epoch,
        create_train_state,
        make_train_step,
    )

    model = create_model(cfg, seed=seed).to(dev)
    spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
    state = create_train_state(model, spec)
    step = make_train_step(model, cfg, spec)
    loader.set_epoch(0)
    state, acc = _run_epoch(step, state, loader, True, dev)
    float(acc[2])
    loader.set_epoch(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, acc = _run_epoch(step, state, loader, True, dev)
    graphs = float(acc[2])
    wall = time.perf_counter() - t0
    loader.set_epoch(2)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, acc = _run_epoch(step, state, loader, True, dev)
        float(acc[2])
        wall_prof = time.perf_counter() - t0
    rows = [r for r in prof.key_averages()
            if r.self_device_time_total > 0 and r.self_cpu_time_total == 0]
    kernel_s = sum(r.self_device_time_total for r in rows) / 1e6
    rows.sort(key=lambda r: r.self_device_time_total, reverse=True)
    return {"graphs": graphs, "wall_s": wall, "graphs_per_s": graphs / wall,
            "steps": len(loader), "profiled_wall_s": wall_prof,
            "kernel_s_profiled_epoch": kernel_s,
            "device_idle_share": 1.0 - kernel_s / wall_prof,
            "top_kernels": [{"kernel": r.key[:90],
                             "ms_per_epoch": r.self_device_time_total / 1e3,
                             "calls": r.count} for r in rows[:8]]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # -- 1. device
    check(torch.cuda.is_available(), "no CUDA device is available")
    sys.path.insert(0, ROOT)
    import hydragnn_torch
    from hydragnn_torch.config.config import get_log_name_config
    from hydragnn_torch.data.load_data import dataset_loading_and_splitting
    from hydragnn_torch.data.synthetic import deterministic_graph_data
    from hydragnn_torch.kernels.build import build_all
    from hydragnn_torch.models.base import ModelConfig
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.ops import fused_mp
    from hydragnn_torch.serve.engine import save_inference_checkpoint
    from hydragnn_torch.telemetry import pipeline
    from hydragnn_torch.utils.device import resolve_device

    dev = resolve_device(None)  # also turns TF32 off
    smi = smi_line()
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    # -- 2. build
    t0 = time.perf_counter()
    libs = build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.basename(p) for p in libs]})

    # the bench's backend for the card: the kernels on the path
    os.environ["HYDRAGNN_AGGR_BACKEND"] = "fused"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_", dir=ROOT) as work:
        os.chdir(work)
        os.environ["SERIALIZED_DATA_PATH"] = work
        logs = os.path.join(work, "logs")
        config = flagship_config()
        train_cfg = flagship_config(perc_train=0.5, epochs=TRAIN_EPOCHS)
        wide_cfg = flagship_config(WIDE, perc_train=0.5, epochs=WIDE_EPOCHS)

        # -- data + seeded checkpoint (set-up)
        t0 = time.perf_counter()
        # BCC cells of 8-36 atoms (mean ~19, QM9-scale molecules)
        deterministic_graph_data(
            "dataset/chip_smoke", number_configurations=N_CONFIGURATIONS,
            unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
            unit_cell_z_range=(1, 3), seed=args.seed)
        t_load = time.perf_counter()
        _, _, test_loader, fcfg = dataset_loading_and_splitting(
            copy.deepcopy(config), seed=args.seed)
        load_s = time.perf_counter() - t_load
        n_batches = len(test_loader)
        check(n_batches >= 2, f"need >= 2 test batches, got {n_batches}")
        model = create_model(ModelConfig.from_config(fcfg), seed=args.seed)
        save_inference_checkpoint(model, get_log_name_config(fcfg), logs)
        first = next(iter(test_loader))
        check("edge_perm_sender" in first.extras,
              "the collated batch carries no kernel marker")
        n_test = len(test_loader.samples)
        loaders = dataset_loading_and_splitting(
            copy.deepcopy(train_cfg), seed=args.seed)
        train_loader = loaders[0]
        train_loader.set_epoch(0)
        first_train = next(iter(train_loader)).to(dev)
        n_train = len(train_loader.samples)
        emit({"phase": "setup", "seconds": time.perf_counter() - t0,
              "data_loading_s": load_s,
              "test_batches": n_batches, "test_graphs": n_test,
              "train_batches": len(train_loader), "train_graphs": n_train,
              "val_batches": len(loaders[1]),
              "test_batches_train_split": len(loaders[2]),
              "first_train_batch": {
                  "nodes": first_train.num_nodes,
                  "edges": first_train.num_edges,
                  "real_edges": int(first_train.edge_mask.sum())}})

        # -- 3. kernels against their plain versions, at the first train
        #       batch of the main path
        t0 = time.perf_counter()
        kernels, notes = kernel_phase(torch, first_train, args.seed)
        scf_kernels, scf_notes = scf_phase(torch, first_train, args.seed)
        kernels += scf_kernels
        emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0,
              **notes, "scf": scf_notes})

        # -- 4. flagship prediction, on the card
        t_phase = time.perf_counter()
        fused_mp.reset_launches()
        before = pipeline.dispatch_snapshot()
        t0 = time.perf_counter()
        err_gpu, _, true_gpu, pred_gpu = hydragnn_torch.run_prediction(
            copy.deepcopy(config), logs_dir=logs, seed=args.seed,
            device="cuda")
        torch.cuda.synchronize()
        wall_gpu = time.perf_counter() - t0
        launches = dict(fused_mp.LAUNCHES)
        dispatch = pipeline.dispatch_delta(before,
                                           pipeline.dispatch_snapshot())
        expect(launches, {"gather_mul_segment_sum": 4 * n_batches,
                          "gather_mul_segment_sum_dx": 0,
                          "segment_sum_dense": n_batches}, "prediction")
        check(pipeline.dispatch_summary(dispatch) == "fused",
              f"a dispatch site left the kernels: {dispatch}")
        pred = pred_gpu[0]
        check(pred.shape == (n_test, 1), f"prediction shape {pred.shape}")
        check(bool(all(math.isfinite(v) for v in pred.ravel()))
              and math.isfinite(err_gpu), "non-finite outputs on the card")

        # the same call again: the first one paid CUDA library start-up
        t0 = time.perf_counter()
        hydragnn_torch.run_prediction(copy.deepcopy(config), logs_dir=logs,
                                      seed=args.seed, device="cuda")
        torch.cuda.synchronize()
        wall_gpu_warm = time.perf_counter() - t0

        t0 = time.perf_counter()
        err_cpu, _, true_cpu, pred_cpu = hydragnn_torch.run_prediction(
            copy.deepcopy(config), logs_dir=logs, seed=args.seed,
            device="cpu")
        wall_cpu = time.perf_counter() - t0
        check((true_gpu[0] == true_cpu[0]).all(), "labels differ")
        scale = float(abs(pred_cpu[0]).max())
        pred_rel = float(abs(pred - pred_cpu[0]).max()) / max(scale, 1e-30)
        err_rel = abs(err_gpu - err_cpu) / max(abs(err_cpu), 1e-30)
        check(pred_rel <= REL_TOL_PATH and err_rel <= REL_TOL_PATH,
              f"card and CPU disagree: predictions {pred_rel}, error "
              f"{err_rel}")

        # one forward pass over the first test batch (the seeded module
        # that wrote the checkpoint): device time (CUDA events behind a
        # sleep) and host time until it is done (launches + sync)
        model = model.to(dev).eval()
        with torch.inference_mode():
            gb = first.to(dev)
            forward_ms = time_ms(torch, lambda: model(gb), reps=20)
            host = []
            for _ in range(20):
                t0 = time.perf_counter()
                model(gb)
                torch.cuda.synchronize()
                host.append((time.perf_counter() - t0) * 1e3)
            forward_host_ms = statistics.median(host)
            profile_rows = forward_profile(torch, model, gb)
        emit({"phase": "prediction", "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_prediction",
              "backend": "fused", "test_batches": n_batches,
              "test_graphs": n_test, "error": err_gpu, "error_cpu": err_cpu,
              "pred_max_rel_err_vs_cpu": pred_rel,
              "error_rel_vs_cpu": err_rel,
              "wall_s_cuda": wall_gpu, "wall_s_cuda_again": wall_gpu_warm,
              "wall_s_cpu": wall_cpu, "data_loading_s": load_s,
              "forward_device_ms_first_batch": forward_ms,
              "forward_host_ms_first_batch": forward_host_ms,
              "forward_profile_first_batch": profile_rows,
              "launches": launches, "dispatch": dispatch})

        # -- 5. flagship training, on the card and on the CPU
        t_phase = time.perf_counter()
        tlogs = os.path.join(logs, "flagship")
        card, cpu, flag_launches, flag_split, dispatch, wall_card, \
            wall_cpu = train_phase(torch, hydragnn_torch, train_cfg, tlogs,
                                   args.seed)
        steps, evals, flag_per, loss_rel = check_training(
            "flagship training", card, cpu, flag_launches, flag_split,
            dispatch, loaders, None, wide=False)
        tcfg = ModelConfig.from_config(card[2])
        train_loader.set_epoch(0)
        first3 = [b.to(dev) for _, b in zip(range(REPEAT_STEPS),
                                            train_loader)]
        n_params = repeat_bits(torch, tcfg, first3, args.seed, dev)
        steady = steady_epoch(torch, tcfg, train_loader, args.seed, dev)
        # run_prediction on the checkpoint the card run wrote
        cdir = os.path.join(tlogs, "cuda")
        p_gpu = hydragnn_torch.run_prediction(
            copy.deepcopy(train_cfg), logs_dir=cdir, seed=args.seed,
            device="cuda")
        p_cpu = hydragnn_torch.run_prediction(
            copy.deepcopy(train_cfg), logs_dir=cdir, seed=args.seed,
            device="cpu")
        scale = float(abs(p_cpu[3][0]).max())
        own_rel = float(abs(p_gpu[3][0] - p_cpu[3][0]).max()) / max(
            scale, 1e-30)
        check(own_rel <= REL_TOL_PATH and bool(
            (abs(p_gpu[3][0]) < float("inf")).all()),
            f"prediction from the trained checkpoint: card vs CPU {own_rel}")
        hist = card[1]
        emit({"phase": "flagship_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "fused",
              "epochs": len(hist["train"]), "train_steps": steps,
              "eval_batches": evals, "train_loss": hist["train"],
              "val_loss": hist["val"], "test_loss": hist["test"],
              "train_loss_cpu": cpu[1]["train"], "lr": hist["lr"],
              "loss_max_rel_err_vs_cpu": loss_rel,
              "wall_s_cuda": wall_card, "wall_s_cpu": wall_cpu,
              "epoch_time_s_cuda": hist["epoch_time"],
              "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                       "parameters": n_params},
              "steady_train_epoch_cuda": steady,
              "prediction_from_own_checkpoint": {
                  "error_cuda": p_gpu[0], "error_cpu": p_cpu[0],
                  "pred_max_rel_err_vs_cpu": own_rel,
                  "graphs": int(p_gpu[3][0].shape[0])},
              "launches": flag_launches, "launches_split": flag_split,
              "dispatch": dispatch})

        # -- 6. wide training (the fused edge pipeline), capped
        t_phase = time.perf_counter()
        wlogs = os.path.join(logs, "wide")
        card, cpu, wide_launches, wide_split, dispatch, wall_card, \
            wall_cpu = train_phase(torch, hydragnn_torch, wide_cfg, wlogs,
                                   args.seed, cap=WIDE_CAP)
        wsteps, wevals, wide_per, wloss_rel = check_training(
            "wide training", card, cpu, wide_launches, wide_split,
            dispatch, loaders, WIDE_CAP, wide=True)
        wcfg = ModelConfig.from_config(card[2])
        n_wparams = repeat_bits(torch, wcfg, first3, args.seed, dev)
        wsteady = steady_epoch(torch, wcfg, train_loader, args.seed, dev)
        hist = card[1]
        emit({"phase": "wide_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "fused",
              "hidden_dim": WIDE, "num_filters": WIDE,
              "batches_per_pass": WIDE_CAP,
              "epochs": len(hist["train"]), "train_steps": wsteps,
              "eval_batches": wevals, "train_loss": hist["train"],
              "val_loss": hist["val"], "train_loss_cpu": cpu[1]["train"],
              "loss_max_rel_err_vs_cpu": wloss_rel,
              "wall_s_cuda": wall_card, "wall_s_cpu": wall_cpu,
              "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                       "parameters": n_wparams},
              "steady_train_epoch_cuda": wsteady,
              "launches": wide_launches, "launches_split": wide_split,
              "dispatch": dispatch})
        os.chdir(ROOT)

    # launches of the main path's card runs, split between train steps and
    # eval batches as counted in those runs
    for k in kernels:
        if k["name"].startswith("scf_"):
            n_launch, per = wide_launches[k["name"]], wide_per[k["name"]]
            k["path"] = "wide training"
        else:
            n_launch, per = flag_launches[k["name"]], flag_per[k["name"]]
            k["path"] = "flagship training"
        k["launches"] = n_launch
        k["launches_per_train_step"] = per["per_train_step"]
        k["launches_per_eval_batch"] = per["per_eval_batch"]
        check(n_launch > 0, f"{k['name']} was not launched on its path")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
