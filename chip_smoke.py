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
   1e-4 for the weight grads, sums over ~1e5 edges in another order), and
   the two poly kernels (scatter mode with all moments at F=64 and F=256,
   gather mode with sum+cnt and with all moments at F=64: sums 1e-5,
   max/min and count exactly equal; through their autograd Functions
   against autograd through the plain versions on data with ties);
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
   per train step, no gather-multiply launch;
7. PNA training at the arch-sweep widths (hidden 64, 4 convs, the same
   graph head, radius 1.8, max_neighbours 20, batch 512, the degree
   histogram from ``finalize``), 3 epochs, with the checks of phase 5 (the
   repeat runs bit-identical in every BatchNorm buffer too): 4 poly-scatter
   and 11 sorted-segment-sum launches per train step (1 pool, 4 tie
   counts, 6 gather backwards), 4 + 1 per eval batch.  Two correct float32
   runs of a BatchNorm architecture drift apart under Adam (see the note
   at REL_TOL_LOCKSTEP_LOSS), so no free CPU run is made and the checks
   of phase 5 against one fall away: the card is held to the CPU in
   lockstep over the first three train batches (the card model takes the
   CPU model's weights and statistics before each step, and loss (1e-5),
   updated BatchNorm statistics (1e-4) and every gradient (1e-4 of the
   model's largest entry) must agree, and every parameter's gradient must
   lie within 1e-4 of its own largest entry of a float64 CPU gradient, or
   within five times the worst that the CPU's own float32 gradient does
   on any parameter) and through ``run_prediction`` on the run's
   checkpoint, card vs CPU, 1e-4;
8. GIN, SAGE and MFC training at the same widths, 2 epochs capped at 2
   batches per pass: 4 no-``w`` gather (GIN) or 4 poly-gather (SAGE, MFC)
   launches and 3 no-``w`` dx launches per train step, 1 pool; the same
   lockstep and checkpoint-prediction checks.

Prints JSON lines with the seconds of each phase (and, where float32
itself decided a lockstep allowance, the per-parameter records behind
it); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, it exits non-zero before printing any result.
"""

import argparse
import copy
import dataclasses
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
# per-epoch losses, card vs CPU, after a few dozen AdamW steps (SchNet)
REL_TOL_LOSS = 1e-4
# The BatchNorm architectures (PNA, GIN, SAGE, MFC).  Two correct float32
# runs of them drift apart under Adam: the weights in front of a BatchNorm
# are scale-invariant, so their gradients are small differences of large
# sums, and Adam turns each gradient, however small, into a step of the
# learning rate's size.  Two CPU runs that differ only in the order of a
# segment sum (backend fused vs scatter) part by 1e-3..1e-2 in the train
# loss within three epochs, and by tens of percent in the eval losses while
# the running statistics are still young (backend_drift.py shows it).  A
# free CPU run therefore decides nothing about these paths and is not
# made: they are held to the CPU in lockstep (same weights and statistics
# before every step: loss, gradients, updated statistics) and through
# run_prediction on the checkpoint the card run wrote.
REL_TOL_LOCKSTEP_LOSS = 1e-5
REL_TOL_LOCKSTEP_STATS = 1e-4
# Gradients in lockstep (see ``lockstep``): of the model's largest entry
# against the CPU's float32 gradient, and of each parameter's own largest
# entry against the float64 gradient, unless the CPU's float32 gradient is
# itself further from it on some parameter: then LOCKSTEP_GRAD_SLACK times
# the CPU's worst.  A parameter whose float64 gradient is below ZERO_GRAD
# of the model's largest entry has a true gradient of zero.
REL_TOL_LOCKSTEP_GRAD = 1e-4
LOCKSTEP_GRAD_SLACK = 5.0
ZERO_GRAD = 1e-9
N_CONFIGURATIONS = 6000   # perc_train 0.1 -> 2700 test graphs, 6 batches
BATCH = 512
FEATURES = 64
WIDE = 256
GAUSSIANS = 50
TRAIN_EPOCHS = 3
WIDE_EPOCHS = 2
WIDE_CAP = 2              # batches per pass of the wide run_training
ARCH_EPOCHS = 2           # GIN, SAGE, MFC: capped like the wide run
ARCH_CAP = 2

# kernel launches per train step and per eval batch of each path (4 conv
# layers; the first layer's input needs no gradient, so its dx launch and
# PNA's first two gather backwards do not happen); counters not named are 0
PATH_LAUNCHES = {
    "flagship": ({"gather_mul_segment_sum": 4,
                  "gather_mul_segment_sum_dx": 4, "segment_sum_dense": 1},
                 {"gather_mul_segment_sum": 4, "segment_sum_dense": 1}),
    "wide": ({"scf_edge_pipeline": 4, "scf_edge_pipeline_pass_p": 4,
              "scf_edge_pipeline_pass_s": 4, "segment_sum_dense": 1},
             {"scf_edge_pipeline": 4, "segment_sum_dense": 1}),
    # per step: 1 pool + 4 tie counts + 2 gather backwards in 3 layers
    "PNA": ({"segment_poly_dense": 4, "segment_sum_dense": 11},
            {"segment_poly_dense": 4, "segment_sum_dense": 1}),
    "GIN": ({"gather_segment_sum": 4, "gather_segment_sum_dx": 3,
             "segment_sum_dense": 1},
            {"gather_segment_sum": 4, "segment_sum_dense": 1}),
    "SAGE": ({"gather_poly_segment": 4, "gather_segment_sum_dx": 3,
              "segment_sum_dense": 1},
             {"gather_poly_segment": 4, "segment_sum_dense": 1}),
}
PATH_LAUNCHES["MFC"] = PATH_LAUNCHES["SAGE"]
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


def flagship_config(width=64, perc_train=0.1, epochs=1,
                    model_type="SchNet"):
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
                "model_type": model_type,
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


def time_ms(torch, fn, flush=None, reps=50, warmup=5, lead=False):
    """Median device milliseconds of ``fn`` over ``reps`` runs, each between
    its own CUDA events; with ``flush`` (a buffer larger than the L2 cache)
    the cache is overwritten before each run.  All runs are enqueued behind
    a device-side sleep meant to outlast the host's enqueueing, so that no
    host launch gap falls inside a timed interval.  ``lead`` (for a bare
    kernel launch, which must not wait for the device) makes that certain:
    an event behind the sleep must still be pending when the last run has
    been enqueued, else the runs are made again behind a sleep four times
    as long, and the call fails if the host never stays ahead."""
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
    # 5x: on a shared host the enqueueing can run several times slower than
    # the three runs above did
    cycles = int(5 * reps * host_s * SLEEP_CYCLES_PER_S)
    for _ in range(3 if lead else 1):
        torch.cuda._sleep(cycles)
        gate = torch.cuda.Event()
        gate.record()
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
        led = not gate.query()
        torch.cuda.synchronize()
        if led:
            break
        cycles *= 4
    check(led or not lead, "time_ms: the device caught up with the host "
          "while the timed runs were being enqueued")
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
    # what the timed launch reads, once each (x, the real rows of w, the
    # real senders, row_ptr), and its output written once; 2 flops per
    # real edge and feature
    b_ms, b_by = bound(
        4 * (n * f + e_valid * f + e_valid + n + 1 + n * f),
        2 * e_valid * f)
    results.append({
        "name": "gather_mul_segment_sum", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": abs_e, "max_rel_err": rel_e,
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, w, None, send, row_ptr), flush, lead=True),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, w, None, send, row_ptr), lead=True),
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
    # x, the real senders and mask values, row_ptr, the output
    nw_ms, nw_by = bound(4 * (n * f + 2 * e_valid + n + 1 + n * f),
                         2 * e_valid * f)
    # the one PyTorch call for this function: a CSR sparse product, the
    # mask as its values (masked edges sort last and stay out)
    csr = torch.sparse_csr_tensor(
        row_ptr.long(), send[:e_valid].long(), mask[:e_valid], size=(n, n))
    check(rel_err(torch, csr @ x, p)[1] <= REL_TOL_KERNEL,
          "the CSR product disagrees with the plain gather_segment_sum")
    results.append({
        "name": "gather_segment_sum", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": abs_e, "max_rel_err": rel_e,
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, None, mask, send, row_ptr, op="gather_segment_sum"), flush,
            lead=True),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_gather_mul(
            x, None, mask, send, row_ptr, op="gather_segment_sum"),
            lead=True),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            x, None, send, recv, edge_valid=mask, mask=mask), flush),
        "library_ms": time_ms(torch, lambda: csr @ x, flush),
        "bound_ms": nw_ms, "bound_by": nw_by,
        "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
    })

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
    check(bool((m_s[:e_valid] != 0).all()),
          "masked edges do not sort last in the sender order")
    csr_s = torch.sparse_csr_tensor(
        ptr_s.long(), send_s[:e_valid].long(), m_s[:e_valid], size=(n, n))
    check(rel_err(torch, csr_s @ ct, sp)[1] <= REL_TOL_KERNEL,
          "the CSR product disagrees with the plain gather_segment_sum dx")
    results.append({
        "name": "gather_mul_segment_sum_dx", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": dx_err[0], "max_rel_err": dx_err[1],
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, w_s, None, send_s, ptr_s, op="gather_mul_segment_sum_dx"),
            flush, lead=True),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, w_s, None, send_s, ptr_s, op="gather_mul_segment_sum_dx"),
            lead=True),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            ct, w_s, send_s, recv_s, edge_valid=m_s), flush),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
    })
    results.append({
        "name": "gather_segment_sum_dx", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": sdx_err[0], "max_rel_err": sdx_err[1],
        "ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, None, m_s, send_s, ptr_s, op="gather_segment_sum_dx"), flush,
            lead=True),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_gather_mul(
            ct, None, m_s, send_s, ptr_s, op="gather_segment_sum_dx"),
            lead=True),
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            ct, None, send_s, recv_s, edge_valid=m_s, mask=m_s), flush),
        "library_ms": time_ms(torch, lambda: csr_s @ ct, flush),
        "bound_ms": nw_ms, "bound_by": nw_by,
        "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
    })

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
    b_ms, b_by = bound(4 * (n * f + n_graphs + 1 + n_graphs * f), n * f)
    results.append({
        "name": "segment_sum_dense", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:340",
        "max_abs_err": abs_e, "max_rel_err": rel_e,
        "ms": time_ms(torch, lambda: fm.launch_segment_sum_dense(
            xn, pool_ptr, n_graphs), flush, lead=True),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_segment_sum_dense(
            xn, pool_ptr, n_graphs), lead=True),
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
            "ms": time_ms(torch, kern, flush, lead=True),
            "warm_l2_ms": time_ms(torch, kern, lead=True),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f, "G": gd},
        })
    return results, {k: {"max_abs_err": a, "max_rel_err": r}
                     for k, (a, r) in errs.items()}


def poly_phase(torch, g, seed):
    """The two poly kernels against their plain versions at the first train
    batch: scatter mode with all moments at F = 64 (PNA's messages) and
    F = 256, gather mode with sum + cnt (SAGE, MFC) and with all moments at
    F = 64.  Forward: sums within 1e-5, max/min and the count exactly
    equal.  Backward: the autograd Functions against autograd through the
    plain versions, on data with ties (a coarse grid), masked rows exactly
    zero.  Each kernel timed alone on its precomputed schedule; the library
    call is the one that gives the sum moment (``torch.segment_reduce``
    over the real rows; a CSR sparse product for the gather)."""
    from hydragnn_torch.ops import fused_mp as fm
    from hydragnn_torch.ops import poly_mp as pm
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(seed + 2)
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    perm = g.extras["edge_perm_sender"]
    real = mask != 0
    e_valid = int(real.sum())
    check(bool(real[:e_valid].all()), "masked edges do not sort last")
    row_ptr = segment_offsets(recv, n, mask)
    lengths = row_ptr.diff().long()
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    every = ("sum", "sq", "mxmn", "cnt")

    def grid(rows, f):
        # a coarse grid: deliberate ties within a segment
        return (torch.randn(rows, f, device=dev, generator=gen) * 2
                ).round() / 2

    def hold(name, k, p, moments):
        errs = {}
        for m, a, c in zip(moments, k, p):
            if m in ("mxmn", "cnt"):
                check(torch.equal(a, c), f"{name}: {m} differs from the "
                      "plain version")
                errs[m] = (0.0, 0.0)
            else:
                errs[m] = rel_err(torch, a, c)
                check(errs[m][1] <= REL_TOL_KERNEL, f"{name}: {m} disagrees "
                      f"with its plain version: {errs[m][1]}")
        return errs

    def grads(fn, t, cts, moments):
        t = t.detach().clone().requires_grad_(True)
        total = 0.0
        for m, o, c in zip(moments, fn(t), cts):
            if m == "cnt":
                continue
            if m == "mxmn":  # the callers' zero-clean of empty segments
                o = torch.where(o <= -5e8, torch.zeros_like(o), o)
            total = total + (o * c).sum()
        total.backward()
        torch.cuda.synchronize()
        return t.grad

    def bytes_out(moments, f):
        return 4 * sum({"sum": n * f, "sq": n * f, "mxmn": 2 * n * f,
                        "cnt": n}[m] for m in moments)

    def flops(moments, f):
        return e_valid * f * sum({"sum": 1, "sq": 2, "mxmn": 3,
                                  "cnt": 0}[m] for m in moments)

    rows, notes = [], {}
    cases = (("scatter", 64, every), ("scatter", 256, every),
             ("gather", 64, ("sum", "cnt")), ("gather", 64, every))
    for mode, f, moments in cases:
        name = f"{mode}_F{f}_{'_'.join(moments)}"
        cts = [torch.randn(n, 2 * f if m == "mxmn" else f, device=dev,
                           generator=gen) for m in moments]
        pm.reset_launches()
        fm.reset_launches()
        if mode == "scatter":
            src = grid(e, f)   # not premasked: the schedule skips the tail
            op = "segment_poly_dense"
            kern = lambda t: pm.segment_poly_dense(t, recv, n, moments,
                                                   valid=mask)
            plain = lambda t: pm.segment_poly_dense_plain(t, recv, n,
                                                          moments, valid=mask)
            launch = lambda: pm.launch_poly_segment(src, None, None, row_ptr,
                                                    n, moments, op)
            lib = lambda: torch.segment_reduce(src[:e_valid], "sum",
                                               lengths=lengths, axis=0)
            nbytes = 4 * (e_valid * f + n + 1) + bytes_out(moments, f)
        else:
            src = grid(n, f)
            op = "gather_poly_segment"
            kern = lambda t: pm.gather_poly_segment(t, send, recv, perm,
                                                    moments, mask=mask)
            plain = lambda t: pm.gather_poly_segment_plain(t, send, recv,
                                                           moments, mask=mask)
            launch = lambda: pm.launch_poly_segment(src, send, mask, row_ptr,
                                                    n, moments, op)
            csr = torch.sparse_csr_tensor(
                row_ptr.long(), send[:e_valid].long(), mask[:e_valid],
                size=(n, n))
            lib = lambda: csr @ src
            nbytes = (4 * (n * f + 2 * e_valid + n + 1)
                      + bytes_out(moments, f))
        with torch.no_grad():
            k, p = kern(src), plain(src)
            torch.cuda.synchronize()
            errs = hold(name, k, p, moments)
            lib_err = rel_err(torch, lib(), p[0])
            check(lib_err[1] <= REL_TOL_KERNEL,
                  f"{name}: the library call disagrees with the plain sum")
        gk, gp = grads(kern, src, cts, moments), grads(plain, src, cts,
                                                       moments)
        g_err = rel_err(torch, gk, gp)
        check(g_err[1] <= REL_TOL_KERNEL, f"{name}: the backward disagrees "
              f"with autograd through the plain version: {g_err[1]}")
        if mode == "scatter":
            check(bool((gk[~real] == 0).all()),
                  f"{name}: a masked row has a gradient")
        want = {op: 2}    # the forward check and the backward's forward
        check({k_: v for k_, v in pm.LAUNCHES.items() if v} == want,
              f"{name}: poly launches {pm.LAUNCHES}")
        worst = max(errs.values(), key=lambda v: v[1])
        b_ms, b_by = bound(nbytes, flops(moments, f))
        row = {
            "name": op, "route": "cuda",
            "source": "hydragnn_torch/csrc/poly_mp.cu",
            "replaces": ("hydragnn_tpu/ops/poly_mp.py:278"
                         if mode == "scatter"
                         else "hydragnn_tpu/ops/poly_mp.py:342"),
            "moments": list(moments),
            "max_abs_err": worst[0], "max_rel_err": worst[1],
            "backward_max_rel_err": g_err[1],
            "backward_launches": {k_: v for k_, v in fm.LAUNCHES.items()
                                  if v},
            "ms": time_ms(torch, launch, flush, lead=True),
            "warm_l2_ms": time_ms(torch, launch, lead=True),
            "wrapper_ms": time_ms(torch, lambda: kern(src), flush),
            "plain_ms": time_ms(torch, lambda: plain(src), flush),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
        }
        # the main path's shapes go into the kernels line: PNA's messages
        # (all moments, F = 64) and SAGE's/MFC's sum + cnt at F = 64
        if (mode, f, moments) in (("scatter", 64, every),
                                  ("gather", 64, ("sum", "cnt"))):
            rows.append(row)
        else:
            notes[name] = row
    return rows, notes


def expect(launches, want, what):
    """Every counter equals what the path must launch (0 where unnamed)."""
    for k in sorted(set(launches) | set(want)):
        check(launches.get(k, 0) == want.get(k, 0),
              f"{what}: {k} launched {launches.get(k, 0)} times, "
              f"expected {want.get(k, 0)}")


def train_phase(torch, hydragnn_torch, config, logs, seed, cap=None,
                cpu_run=True):
    """``run_training`` on the card and, with ``cpu_run``, on the CPU (plain
    versions) for the same config.  In the card run every pass over a
    loader is wrapped so that its batches and kernel launches are tallied
    apart, train passes from eval passes.  Returns (card result, CPU result
    or None, launches of the card run, that tally, dispatch tally, card
    seconds, CPU seconds or None)."""
    from hydragnn_torch.ops import fused_mp, poly_mp, scf_mp
    from hydragnn_torch.telemetry import pipeline
    from hydragnn_torch.train import trainer

    def counts():
        return {**fused_mp.LAUNCHES, **scf_mp.LAUNCHES, **poly_mp.LAUNCHES}

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
        poly_mp.reset_launches()
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
        cpu = wall_cpu = None
        if cpu_run:
            t0 = time.perf_counter()
            cpu = hydragnn_torch.run_training(
                copy.deepcopy(config), logs_dir=os.path.join(logs, "cpu"),
                seed=seed, device="cpu")
            wall_cpu = time.perf_counter() - t0
    finally:
        os.environ.pop("HYDRAGNN_MAX_NUM_BATCH", None)
    return card, cpu, launches, split, dispatch, wall_card, wall_cpu


def check_training(name, card, cpu, launches, split, dispatch, loaders, cap,
                   path):
    """The card run's launches, train passes and eval passes apart, against
    what the path must launch per batch, a finite falling loss, and, where
    there is a CPU run (``cpu`` is not None), its per-epoch losses and
    learning-rate decisions against the CPU's.  Returns (train steps, eval
    batches, per-step and per-eval-batch launches, loss agreement or
    None)."""
    from hydragnn_torch.telemetry import pipeline

    _, hist, _ = card
    steps, evals = split["train"]["batches"], split["eval"]["batches"]
    epochs = len(hist["train"])
    lens = [len(l) if cap is None else min(cap, len(l)) for l in loaders]
    check((steps, evals) == (epochs * lens[0], epochs * (lens[1] + lens[2])),
          f"{name}: {steps} train steps and {evals} eval batches over "
          f"{epochs} epochs of loaders {lens}")
    per_step, per_eval = PATH_LAUNCHES[path]
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
    if cpu is None:
        return steps, evals, measured, None
    _, hist_cpu, _ = cpu
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
    every parameter and every buffer (BatchNorm running statistics)
    bit-identical.  Returns the number of tensors compared."""
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
        runs.append([p.detach().clone() for p in model.parameters()]
                    + [b.detach().clone() for b in model.buffers()])
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    check(same, "two card runs of the first steps gave different bits")
    return len(runs[0])


def as_double(g):
    """The batch with its floating-point tensors in float64."""
    def up(t):
        return t.double() if t is not None and t.is_floating_point() else t

    return dataclasses.replace(
        g, x=up(g.x), pos=up(g.pos), edge_attr=up(g.edge_attr),
        node_mask=up(g.node_mask), edge_mask=up(g.edge_mask),
        graph_mask=up(g.graph_mask), labels=tuple(up(t) for t in g.labels),
        cell=up(g.cell))


def grade_leaves(what, leaves):
    """Hold each parameter's card gradient on its own scale (the rule is
    in ``lockstep``).  ``leaves``: one record per step and parameter with
    ``top`` (the largest float64 gradient entry), ``top_all`` (the
    model's), ``e_cpu`` and ``e_card`` (the largest deviation of the CPU's
    and the card's float32 gradient from the float64 one)."""
    live = [r for r in leaves if r["top"] > ZERO_GRAD * r["top_all"]]
    zero = {r["name"] for r in leaves} - {r["name"] for r in live}
    for r in leaves:
        if r["name"] in zero:
            check(r["e_card"] <= REL_TOL_LOCKSTEP_GRAD * 1e-2 * r["top_all"],
                  f"{what}: the gradient of {r['name']} is zero and the "
                  f"card's is {r['e_card']}")
    cpu = max(r["e_cpu"] / r["top"] for r in live)
    allowed = max(REL_TOL_LOCKSTEP_GRAD, LOCKSTEP_GRAD_SLACK * cpu)
    if allowed > REL_TOL_LOCKSTEP_GRAD:
        # float32 decided the allowance: show on which parameters, and
        # how far the card is from the CPU on each
        for r in live:
            emit({"lockstep_leaf": what, **r})
    worst = max(live, key=lambda r: r["e_card"] / r["top"])
    card = worst["e_card"] / worst["top"]
    check(card <= allowed,
          f"{what}: the gradient of {worst['name']} is {card} of its "
          f"largest entry from the float64 gradient, allowed {allowed}")
    return {"zero_gradient_parameters": len(zero),
            "cpu_vs_float64_over_own_largest": cpu,
            "card_vs_float64_over_own_largest": card,
            "card_vs_float64_allowed": allowed,
            "grad_over_allowed": card / allowed,
            "grad_leaf": worst["name"]}


def lockstep(torch, cfg, batches, seed, dev):
    """The card (kernels) against the CPU (plain versions) step by step:
    before each step the card model takes the CPU model's parameters and
    BatchNorm buffers, both run forward and backward in training mode on
    the same batch, then the CPU model takes one AdamW step.  Held at each
    step: the loss, every BatchNorm statistic the forward updated, and
    every parameter's gradient on its own scale.

    The yardstick of a gradient is a third run: the same weights in
    float64 on the CPU through the composed ``scatter`` path, which shares
    no code with the kernels or their plain versions.  Every parameter's
    card gradient must lie within REL_TOL_LOCKSTEP_GRAD of that
    parameter's own largest float64 gradient entry.  Where float32 itself
    cannot do that (a max aggregator or a ReLU switches at a rounding
    error, and every parameter upstream of the switch moves by about 1e-3
    of its scale; a weight in front of a BatchNorm is scale-invariant and
    its gradient a small difference of large sums), the CPU's own float32
    gradient shows it, and the allowance becomes LOCKSTEP_GRAD_SLACK times
    the CPU's worst such deviation over all parameters and steps: a
    parameter that is wrong on the card by its own size is refused, however
    small it is beside the others.  A parameter whose float64 gradient is
    zero (a bias in front of a BatchNorm; below ZERO_GRAD of the model's
    largest entry) must have a card gradient of rounding size.  The
    model-wide check (every deviation from the CPU's float32 gradient
    within REL_TOL_LOCKSTEP_GRAD of the model's largest entry) stays.
    Returns the largest deviations seen."""
    from hydragnn_torch.models.base import multihead_loss
    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import (
        create_train_state,
        make_train_step,
    )

    cpu_model = create_model(cfg, seed=seed)
    card_model = create_model(cfg, seed=seed).to(dev)
    ref_model = create_model(cfg, seed=seed).double()
    spec = select_optimizer({"type": "AdamW", "learning_rate": 1e-3})
    state = create_train_state(cpu_model, spec)
    step = make_train_step(cpu_model, cfg, spec)
    names = [k for k, _ in cpu_model.named_parameters()]

    def loss_grads_stats(model, g):
        kept = [b.clone() for b in model.buffers()]
        model.train()
        loss, _ = multihead_loss(cfg, model(g), g)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        stats = [b.detach().cpu().clone() for b in model.buffers()]
        with torch.no_grad():
            for b, k in zip(model.buffers(), kept):
                b.copy_(k)
        return float(loss.detach()), [d.cpu() for d in grads], stats

    what = f"{cfg.model_type} in lockstep"
    worst = {"loss": 0.0, "grad_over_largest": 0.0, "stats": 0.0}
    leaves = []
    for i, g in enumerate(batches):
        weights = cpu_model.state_dict()
        card_model.load_state_dict(weights)
        ref_model.load_state_dict(weights)
        lc, gc, sc = loss_grads_stats(cpu_model, g)
        lg, gg, sg = loss_grads_stats(card_model, g.to(dev))
        os.environ["HYDRAGNN_AGGR_BACKEND"] = "scatter"
        try:
            _, gr, _ = loss_grads_stats(ref_model, as_double(g))
        finally:
            os.environ["HYDRAGNN_AGGR_BACKEND"] = "fused"
        worst["loss"] = max(worst["loss"], abs(lg - lc) / abs(lc))
        top_all = max(float(r.abs().max()) for r in gr)
        for name, c, k, r in zip(names, gc, gg, gr):
            worst["grad_over_largest"] = max(
                worst["grad_over_largest"],
                float((c - k).abs().max()) / top_all)
            leaves.append({
                "step": i, "name": name, "top_all": top_all,
                "top": float(r.abs().max()),
                "e_cpu": float((c.double() - r).abs().max()),
                "e_card": float((k.double() - r).abs().max())})
        for a, b in zip(sc, sg):
            worst["stats"] = max(worst["stats"], float(
                ((a - b).abs() / (a.abs() + 0.1)).max()))
        state, _ = step(state, g)
    check(worst["loss"] <= REL_TOL_LOCKSTEP_LOSS,
          f"{what}: card and CPU losses differ by {worst['loss']}")
    check(worst["grad_over_largest"] <= REL_TOL_LOCKSTEP_GRAD,
          f"{what}: gradients differ by {worst['grad_over_largest']} of "
          "the largest entry")
    check(worst["stats"] <= REL_TOL_LOCKSTEP_STATS,
          f"{what}: BatchNorm statistics differ by {worst['stats']}")
    return {"steps": len(batches), "parameters": len(names), **worst,
            **grade_leaves(what, leaves)}


def own_checkpoint_prediction(torch, hydragnn_torch, config, logs_dir, seed,
                              name):
    """``run_prediction`` on the checkpoint a card run wrote, on the card
    and on the CPU: finite and equal to REL_TOL_PATH of the largest."""
    p_gpu = hydragnn_torch.run_prediction(
        copy.deepcopy(config), logs_dir=logs_dir, seed=seed, device="cuda")
    p_cpu = hydragnn_torch.run_prediction(
        copy.deepcopy(config), logs_dir=logs_dir, seed=seed, device="cpu")
    scale = float(abs(p_cpu[3][0]).max())
    rel = float(abs(p_gpu[3][0] - p_cpu[3][0]).max()) / max(scale, 1e-30)
    check(rel <= REL_TOL_PATH and bool(
        (abs(p_gpu[3][0]) < float("inf")).all()),
        f"{name}: prediction from the trained checkpoint, card vs CPU {rel}")
    return {"error_cuda": p_gpu[0], "error_cpu": p_cpu[0],
            "pred_max_rel_err_vs_cpu": rel,
            "graphs": int(p_gpu[3][0].shape[0])}


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
        poly_kernels, poly_notes = poly_phase(torch, first_train, args.seed)
        kernels += scf_kernels + poly_kernels
        emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0,
              **notes, "scf": scf_notes, "poly": poly_notes})

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
            dispatch, loaders, None, "flagship")
        tcfg = ModelConfig.from_config(card[2])
        train_loader.set_epoch(0)
        first3 = [b.to(dev) for _, b in zip(range(REPEAT_STEPS),
                                            train_loader)]
        n_params = repeat_bits(torch, tcfg, first3, args.seed, dev)
        steady = steady_epoch(torch, tcfg, train_loader, args.seed, dev)
        own = own_checkpoint_prediction(
            torch, hydragnn_torch, train_cfg, os.path.join(tlogs, "cuda"),
            args.seed, "flagship")
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
              "prediction_from_own_checkpoint": own,
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
            dispatch, loaders, WIDE_CAP, "wide")
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

        # -- 7. PNA training at the arch-sweep widths, in full
        t_phase = time.perf_counter()
        pna_cfg = flagship_config(perc_train=0.5, epochs=TRAIN_EPOCHS,
                                  model_type="PNA")
        plogs = os.path.join(logs, "pna")
        card, _, pna_launches, pna_split, dispatch, wall_card, _ = \
            train_phase(torch, hydragnn_torch, pna_cfg, plogs, args.seed,
                        cpu_run=False)
        psteps, pevals, pna_per, _ = check_training(
            "PNA training", card, None, pna_launches, pna_split, dispatch,
            loaders, None, "PNA")
        pcfg = ModelConfig.from_config(card[2])
        check(pcfg.pna_avg_deg_log is not None and pcfg.max_neighbours
              == len(card[2]["NeuralNetwork"]["Architecture"]["pna_deg"]) - 1,
              "finalize wrote no degree histogram")
        n_pparams = repeat_bits(torch, pcfg, first3, args.seed, dev)
        psteady = steady_epoch(torch, pcfg, train_loader, args.seed, dev)
        train_loader.set_epoch(0)
        first3_cpu = [b for _, b in zip(range(REPEAT_STEPS), train_loader)]
        plock = lockstep(torch, pcfg, first3_cpu, args.seed, dev)
        own = own_checkpoint_prediction(
            torch, hydragnn_torch, pna_cfg, os.path.join(plogs, "cuda"),
            args.seed, "PNA")
        hist = card[1]
        emit({"phase": "pna_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "fused",
              "hidden_dim": FEATURES,
              "pna_deg": card[2]["NeuralNetwork"]["Architecture"]["pna_deg"],
              "epochs": len(hist["train"]), "train_steps": psteps,
              "eval_batches": pevals, "train_loss": hist["train"],
              "val_loss": hist["val"], "test_loss": hist["test"],
              "lr": hist["lr"], "wall_s_cuda": wall_card,
              "epoch_time_s_cuda": hist["epoch_time"],
              "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                       "parameters_and_buffers": n_pparams},
              "steady_train_epoch_cuda": psteady,
              "lockstep_vs_cpu": plock,
              "prediction_from_own_checkpoint": own,
              "launches": pna_launches, "launches_split": pna_split,
              "dispatch": dispatch})

        # -- 8. GIN, SAGE and MFC training at the same widths, capped
        arch_launches, arch_per = {}, {}
        for arch in ("GIN", "SAGE", "MFC"):
            t_phase = time.perf_counter()
            acfg = flagship_config(perc_train=0.5, epochs=ARCH_EPOCHS,
                                   model_type=arch)
            card, _, arch_launches[arch], asplit, dispatch, wall_card, _ = \
                train_phase(torch, hydragnn_torch, acfg,
                            os.path.join(logs, arch.lower()), args.seed,
                            cap=ARCH_CAP, cpu_run=False)
            asteps, aevals, arch_per[arch], _ = check_training(
                f"{arch} training", card, None, arch_launches[arch], asplit,
                dispatch, loaders, ARCH_CAP, arch)
            alock = lockstep(torch, ModelConfig.from_config(card[2]),
                             first3_cpu, args.seed, dev)
            own = own_checkpoint_prediction(
                torch, hydragnn_torch, acfg,
                os.path.join(logs, arch.lower(), "cuda"), args.seed, arch)
            hist = card[1]
            emit({"phase": f"{arch.lower()}_training",
                  "seconds": time.perf_counter() - t_phase,
                  "entry": "hydragnn_torch.run_training", "backend": "fused",
                  "hidden_dim": FEATURES, "batches_per_pass": ARCH_CAP,
                  "epochs": len(hist["train"]), "train_steps": asteps,
                  "eval_batches": aevals, "train_loss": hist["train"],
                  "val_loss": hist["val"], "lockstep_vs_cpu": alock,
                  "prediction_from_own_checkpoint": own,
                  "wall_s_cuda": wall_card,
                  "launches": arch_launches[arch], "launches_split": asplit,
                  "dispatch": dispatch})
        os.chdir(ROOT)

    # launches of the main path's card runs, split between train steps and
    # eval batches as counted in those runs
    paths = {"segment_poly_dense": ("PNA", pna_launches, pna_per),
             "gather_poly_segment": ("SAGE", arch_launches["SAGE"],
                                     arch_per["SAGE"]),
             "gather_segment_sum": ("GIN", arch_launches["GIN"],
                                    arch_per["GIN"]),
             "gather_segment_sum_dx": ("GIN", arch_launches["GIN"],
                                       arch_per["GIN"])}
    for k in kernels:
        if k["name"].startswith("scf_"):
            path, n_by, per_by = "wide", wide_launches, wide_per
        else:
            path, n_by, per_by = paths.get(
                k["name"], ("flagship", flag_launches, flag_per))
        n_launch, per = n_by[k["name"]], per_by[k["name"]]
        k["path"] = f"{path} training"
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
