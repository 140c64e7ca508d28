#!/usr/bin/env python3
"""Drive the PyTorch port (hydragnn_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout on a machine with a CUDA device, ``nvcc``
and PyTorch built for CUDA.  Phases, each of which fails the run:

1. device: require CUDA, print the card's name and power limit, keep
   float32 matmuls in full precision;
2. build: compile the port's CUDA kernels from csrc/ with nvcc (sm_90a),
   one nvcc per source, all started together; then the registers,
   stack, spills and static shared memory (ptxas) of the redesigned
   kernels (the two pass-P kernels on the tensor cores, scf and cgcnn
   with its node table; the row_mlp forward's and backward's two routes;
   the dn_tri backward; the builder forward's and pass P's routes 1;
   egcl's three routes 1; the scf filter-gather kernel's and the dn_tri
   forward's routes 1; GAT pass R's and pass S's two routes; the
   gather-multiply's forward and fused backward, routes 1)
   beside the kernels that share their sources, and the dynamic shared
   memory of the pass-P kernels and the two new routes 1 at the main
   path's widths;
3. kernels: on the first batch of the main path (512 flagship-size graphs,
   masked tail edges, empty segments), hold each kernel to its plain
   PyTorch version and time kernel, plain version and library call (CUDA
   events, median of 50 runs after warm-up, L2 flushed before each run,
   no host gap inside a timed run): the gather-multiply forward (F=64)
   and its no-``w`` mode on both routes (route 1 held to route 2's bits
   and bit-identical twice) and the pool (max |kernel - plain| / max
   |plain| <= 1e-5), the backward of both through the ops' autograd
   backward (route 1's fused launch) against autograd through the plain
   versions (dx, and dw on real edges, 1e-5; dw bit-equal to x[senders] *
   g[receivers] on real edges and zero on masked ones), the fused launch
   against route 2 (the first design's dx pass on the sender-sorted w[p]:
   dx bit for bit) and the whole backward through the Function on each
   route, and the three scf kernels of the wide
   SchNet (F=256, G=50: forward, pass P, pass S) through their autograd
   Function against autograd through the composed plain version (1e-5;
   1e-4 for the weight grads, sums over ~1e5 edges in another order;
   pass P, here and in cgcnn below, runs its products on the tensor cores
   in 3xTF32, and its row carries two bounds: ``bound_ms`` at the 3xTF32
   rate of 495 / 3 TFLOP/s, ``bound_ms_cuda_cores`` at 67; the forward
   and pass S take their route 1 on the tensor cores too, the card's
   route the plan's, each as the path launches it within a float64 run's
   bound and bit-identical twice, the first design (route 2) held to the
   plain version and timed beside it), and the two
   poly kernels (scatter mode with all moments at F=64 and F=256,
   gather mode with sum+cnt and with all moments at F=64: sums 1e-5,
   max/min and count exactly equal; through their autograd Functions
   against autograd through the plain versions on data with ties), and
   the three egcl kernels (forward, pass P, pass S) at the first
   egnn_md17 train batch in the three instantiations its path launches
   (F = H = 48 equivariant, the last layer's block with no coordinate
   gate, layer 0's F = 1 block with no dx and no dgeo) through their
   autograd Function against autograd through the composed plain version
   (1e-5; 1e-4 for the weight grads; dgeo exactly zero on masked edges;
   the forward and pass P take their routes 1 on the tensor cores in all
   three, the card's routes the plan's, and are timed in all three, with
   two bounds; the forward alone on both routes 1e-5, route 1
   bit-identical twice, its first design timed beside it),
   and the three GAT kernels (forward, pass R, pass S) at the first
   train batch at H*F = 384 and 768, with ones and with dropout bits,
   through their autograd Function against autograd through the plain
   forward (1e-5; 1e-4 for d att; m equal; rows without a real edge
   (-1e9, 0, 0) and zero gradients; pass S's route the plan's, route 1
   alone at each case 1e-5, bit-identical twice and zero on rows that
   send no real edge, its first design (route 2) held and timed beside
   it; pass R's likewise, d att at 1e-4, dxr zero on rows without a real
   incoming edge), and the three cgcnn kernels
   (forward, pass P, pass S) at the first cgcnn train batch at F = D = 64
   (the path's), F = 24, A = 5, D = 16 and F = D = 256 through their
   autograd Function against autograd through the composed plain version
   (1e-5; 1e-4 for the weight grads; d edge_attr exactly zero on masked
   edges; the forward, a node table and then a warp per receiver row, a
   second run bit-identical; pass S alone on pass P's node table
   (gathered sums per sender row, then one row product in 3xTF32) 1e-5,
   within a float64 run's bound and bit-identical twice), and the pallas
   backend's two segment sums
   (unsorted ids with an out-of-range tail; sorted receivers, pre-masked)
   and their VJPs (1e-5),
   timed beside ``index_add_`` and ``torch.segment_reduce``, and the four
   DimeNet kernels at the first dimenet train batch (its own triplet table
   and spherical basis): the triplet op forward and backward and the
   row-MLP chain forward and backward through their autograd Functions
   against autograd through the composed plain versions (1e-5; 1e-4 for
   the weight grads; d cbf exactly zero on masked triplets), the triplet
   forward's route the plan's (route 1 on the tensor cores), as the path
   launches it within a float64 run's bound and bit-identical twice, its
   first design held to the plain version and timed beside it, and the
   row-MLP forward's route likewise (route 1 on the tensor cores, a
   float64 run's bound, bit-identical twice, the first design held and
   timed beside it), the
   triplet backward also launched as the path launches it (d x2 and the
   weights) and with all four outputs, every output against the plain
   version and both launches timed, and the
   builder's three kernels (forward, pass S, pass P) at the same batch's
   triplet table and full spherical basis at dimenet_wide's widths (S*R =
   42, B = 8, D = 128), at (70, 8, 64) and at the limits (126, 128, 128),
   with a longer masked tail and all masked (1e-5; 1e-4 for dk1, dk2;
   d sbf exactly zero on masked triplets; the forward's route at each
   width, the card's the plan's, route 1 at the path's), and with sbf
   without a gradient as in training (pass S's route 1: d x_kj 1e-5 and
   within a float64 run's bound, a second run bit-identical; pass S's
   routes the plan's), and pass P alone at the path's widths (route 1,
   dk1 and dk2 in registers on the forward's ring: 1e-4 and within a
   float64 run's bound, bit-identical twice, zero when all is masked; the
   first design held at 1e-4 and timed beside it; the routes at each
   width the plan's); then a double
   backward through ``gather_mul_segment_sum`` and ``gather_segment_sum``
   on the card against the CPU (1e-5), and the refusal of a double
   backward by the scf, egcl, GAT, cgcnn, dn_tri, dn_tri_builder and
   row_mlp Functions;
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
   lie within 1e-4 of its own largest entry of a float64 CPU gradient
   through the composed path (the batch without its sender permutation), or
   within five times the worst that the CPU's own float32 gradient does
   on any parameter) and through ``run_prediction`` on the run's
   checkpoint, card vs CPU, 1e-4;
8. GIN, SAGE and MFC training at the same widths, 2 epochs capped at 2
   batches per pass: 4 no-``w`` gather (GIN) or 4 poly-gather (SAGE, MFC)
   launches and 3 no-``w`` dx launches per train step, 1 pool; the same
   lockstep and checkpoint-prediction checks;
9. EGNN training: egnn_md17 (the architecture of examples/md17, hidden
   48, 4 convs, 3 epochs) and egnn_oc22 (that of
   examples/open_catalyst_2022, hidden 32, 2 convs, capped as phase 8),
   with output names that ask for no force term: 4 egcl forwards, 4 pass
   P, 3 pass S, 1 pool and 6 segment sums (the sorted-segment backward of
   layers 1-3's two position gathers) per md17 train step (2, 2, 1, 1, 2
   for oc22), every egcl dispatch fused; the lockstep, repeat and
   checkpoint-prediction checks of phase 7;
10. GAT training at the arch sweep's widths (hidden 64, 6 heads, slope
   0.05, 4 convs, dropout 0: H*F = 384), 3 epochs, and at hidden 256 with
   dropout 0.25 (H*F = 1536: two head groups of 768, the only phase whose
   training draws dropout bits through the kernels), capped as phase 8:
   4 forward, 4 pass R and 4 pass S launches and 1 pool per train step (8,
   8, 8, 1 at hidden 256), every gat_attn dispatch fused; the lockstep
   (the dropout bits drawn on the CPU for both sides; hidden 256 on
   batches of 32 graphs) and repeat checks of phase 7, and at hidden 64
   its checkpoint-prediction check;
11. CGCNN training at the arch sweep's widths (input = hidden = 64: the
   set's node feature and 63 seeded columns this script writes, 4 convs,
   radius 1.8, max_neighbours 20, no edge features), 3 epochs: 4 forward,
   4 pass P and 3 pass S launches and 1 pool per train step, every cgcnn
   dispatch fused; the lockstep, repeat, steady-epoch and
   checkpoint-prediction checks of phase 7;
12. the flagship SchNet under ``HYDRAGNN_AGGR_BACKEND=pallas``, capped as
   phase 6, on the card and on the CPU: 5 ``segment_sum_pallas`` launches
   per train step and per eval batch (4 convs and the pool), no other
   kernel, losses within 1e-4 relative of the CPU's;
13. DimeNet training at the arch sweep's widths (hidden 64, 4 convs,
   num_radial 6, num_spherical 7, basis_emb 8, int_emb = out_emb = 64,
   one residual layer before the skip and two after) on its own set of
   smaller BCC cells (``write_dimenet_data``: graphs of at most ~190
   edges, so the loader's gate opens the factored-basis kernel), 3
   epochs: 4 triplet forwards and backwards, 4 row-MLP forwards and
   backwards and 5 sorted segment sums (4 output blocks, the pool) per
   train step, 4 + 4 + 5 per eval batch, every dn_tri and dn_row_mlp
   dispatch fused; repeats bit-identical, a steady epoch, prediction from
   the run's checkpoint card vs CPU; and, as DimeNet's two CPU backends
   stay together (``backend_drift.py DimeNet``), card and CPU free runs of
   2 epochs capped as phase 6, losses within 1e-4 relative;
14. dimenet_wide: DimeNet++'s published QM9 widths (hidden 128, out_emb
   256, basis_emb 8, S = 7, R = 6, 4 blocks, one residual layer before the
   skip and two after) with int_emb_size 128, past the factored kernel's
   gate, on the dimenet cell's set, 3 epochs: 4 builder forwards, 4 pass
   S, 4 pass P and 5 sorted segment sums per train step, 4 + 5 per eval
   batch, every interaction on the builder (``dn_tri_builder:fused``, no
   dn_tri or dn_row_mlp tally); repeats bit-identical, a steady epoch,
   prediction from the run's checkpoint card vs CPU; one train step with
   ``HYDRAGNN_DIMENET_REMAT=1`` against one without (loss and every
   gradient 1e-6 of the largest entry, and both steps' peak device
   memory); as two float32 runs of this cell part within an epoch
   (``backend_drift.py DimeNet_wide``), the lockstep of phase 7 over
   three batches of 64 graphs (the float64 yardstick on the composed
   path: the batch without its ``dn_tri_ok`` marker).

Each dataset is loaded once per configuration (``memoize_dataset_loading``:
the card and CPU runs of a configuration read the same data).  Prints JSON
lines with the seconds of each phase and of the whole run (and, where
float32 itself decided a lockstep allowance, the per-parameter records
behind it); the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device, or without the
package beside it, it exits non-zero before printing any result.
"""

import argparse
import contextlib
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
# float32 work on the tensor cores in 3xTF32: three TF32 products (495
# TFLOP/s dense) per float32 product — the bound of the kernels that run
# their products there (scf and cgcnn pass P)
TF32X3_FLOPS_PER_S = 495e12 / 3
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
EGNN_EPOCHS = 3           # egnn_md17, in full; egnn_oc22 as GIN (capped)
GAT_WIDE = 256            # gat_h256: H*F = 1536, two head groups of 768
# graphs per batch of gat_h256's lockstep: at hidden 256 the CPU's float32
# and float64 steps on a 512-graph batch cost ~1 TFLOP each (lin_l, lin_r
# at 1536 lanes) and keep [E, 1536] float64 tensors of ~1.7 GB; at 128
# graphs three steps took 282 s and 26 GB on an 8-core CPU
GAT_WIDE_LOCKSTEP_BATCH = 64
GAT_SLOPE = 0.05
# the cgcnn cell: 63 seeded node-feature columns beside the set's own give
# CGConv its width of 64, on the whole synthetic set (perc_train 0.5: 3000
# train graphs, six steps of at most 512)
CGCNN_EXTRA_COLUMNS = FEATURES - 1
CGCNN_DATA = "dataset/chip_smoke_cgcnn"
CGCNN_LIMIT = 256         # the cgcnn kernels' F and D limit
# the dimenet cell's set: BCC cells of 2-3 x 2-3 x 1 unit cells (8-18
# atoms, QM9-scale), so that at radius 1.8 every graph has at most 257
# edges, spans at most two 128-edge blocks, and the loader's gate opens
# the factored-basis triplet kernel (DnTriGate); the main set's cells of up
# to 36 atoms (up to ~640 edges) would keep it shut
DIMENET_DATA = "dataset/chip_smoke_dimenet"
# the DimeNet card run against the CPU: free runs, capped as the wide cell
# (backend_drift.py DimeNet decides free runs over lockstep; PERF.md)
DIMENET_CAP = 2
# graphs per batch of dimenet_wide's lockstep: two float32 runs of that
# cell part by 6e-4 in one epoch (backend_drift.py DimeNet_wide), so it is
# held to the CPU in lockstep, whose float32 and float64 CPU steps on a
# 512-graph batch would form [T, 128] float64 tensors of 1 GB (T ~ 1e6)
DIMENET_WIDE_LOCKSTEP_BATCH = 64
# the dimenet_builder_phase's widths (S*R, B, D) besides the path's own:
# num_radial 10, and the builder's limits (num_radial 18: S*R = 126)
BUILDER_WIDTHS = ((70, 8, 64), (126, 128, 128))
# loss and every gradient of one dimenet_wide train step with
# HYDRAGNN_DIMENET_REMAT against one without, of the largest entry
REL_TOL_REMAT = 1e-6
# no real edge's ReLU input within this of zero in the egcl kernel checks
# (egcl_off_kinks): ~20x the float32 rounding of a 97-term dot product
KINK_MARGIN = 2e-6

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
# EGNN: one egcl forward and one pass P per conv layer, pass S where the
# layer's input needs a gradient (not layer 0: x is data), one pool
# EGNN: the pool, and in training the sorted-segment backward of the
# positions' two gathers at every layer after the first (whose positions
# moved in the layer before)
PATH_LAUNCHES["egnn_md17"] = (
    {"egcl_block": 4, "egcl_block_pass_p": 4, "egcl_block_pass_s": 3,
     "segment_sum_dense": 7},
    {"egcl_block": 4, "segment_sum_dense": 1})
PATH_LAUNCHES["egnn_oc22"] = (
    {"egcl_block": 2, "egcl_block_pass_p": 2, "egcl_block_pass_s": 1,
     "segment_sum_dense": 3},
    {"egcl_block": 2, "segment_sum_dense": 1})
# GAT: one attention forward, pass R and pass S per conv layer and head
# group (layer 0's xl and xr need gradients for lin_l and lin_r), one pool
PATH_LAUNCHES["gat"] = (
    {"gat_edge_attention": 4, "gat_edge_attention_pass_r": 4,
     "gat_edge_attention_pass_s": 4, "segment_sum_dense": 1},
    {"gat_edge_attention": 4, "segment_sum_dense": 1})
PATH_LAUNCHES["gat_h256"] = (
    {"gat_edge_attention": 8, "gat_edge_attention_pass_r": 8,
     "gat_edge_attention_pass_s": 8, "segment_sum_dense": 1},
    {"gat_edge_attention": 8, "segment_sum_dense": 1})
# CGCNN: one gated-sum forward and one pass P per conv layer, pass S where
# the layer's input needs a gradient (not layer 0: x is data), one pool
PATH_LAUNCHES["cgcnn"] = (
    {"cgcnn_block": 4, "cgcnn_block_pass_p": 4, "cgcnn_block_pass_s": 3,
     "segment_sum_dense": 1},
    {"cgcnn_block": 4, "segment_sum_dense": 1})
# DimeNet: one triplet forward and backward and one row-MLP forward and
# backward per conv layer (layer 0's inputs need gradients: lin_kj, lin_ji
# feed them), one sorted segment sum per output block and the pool, and in
# a train step two more per conv layer: the backward of the embedding's
# gathers h[dst], h[src]
PATH_LAUNCHES["dimenet"] = (
    {"dimenet_triplet_mp": 4, "dimenet_triplet_mp_bwd": 4,
     "dimenet_post_mlp": 4, "dimenet_post_mlp_bwd": 4,
     "segment_sum_dense": 13},
    {"dimenet_triplet_mp": 4, "dimenet_post_mlp": 4, "segment_sum_dense": 5})
# dimenet_wide: one builder forward, pass S and pass P per conv layer, the
# composed tail (no row-MLP kernel), the same segment sums
PATH_LAUNCHES["dimenet_wide"] = (
    {"dimenet_tri_builder": 4, "dimenet_tri_builder_bwd_s": 4,
     "dimenet_tri_builder_bwd_p": 4, "segment_sum_dense": 13},
    {"dimenet_tri_builder": 4, "segment_sum_dense": 5})
# the flagship SchNet under HYDRAGNN_AGGR_BACKEND=pallas: no marker, so
# each conv's aggregation and the pool take segment_sum, that is the pallas
# segment sum (its backward is a gather: no launch)
PATH_LAUNCHES["pallas"] = ({"segment_sum_pallas": 5},
                           {"segment_sum_pallas": 5})
# kernels with no caller on any path (the reference has none either)
OFF_PATH = ("segment_sum_sorted",)
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


def egnn_md17_config(epochs=EGNN_EPOCHS, perc_train=0.5):
    """md17's EGNN (examples/md17/md17.json:23-45: hidden 48, 4 convs,
    equivariant, radius 2.2, max_neighbours 12, graph head (2, 48, 2, [48,
    48]), node head mlp [48, 48], task weights [1, 10]; AdamW 1e-3, mse) on
    the synthetic BCC set at batch 512.  Its two outputs keep their types
    (graph, node) under other names than total_energy / atomic_forces, so
    the energy-gradient force term (a double backward, not ported) is not
    asked for; the node head regresses the node feature x2."""
    cfg = flagship_config(perc_train=perc_train, epochs=epochs,
                          model_type="EGNN")
    nn_ = cfg["NeuralNetwork"]
    arch = nn_["Architecture"]
    for k in ("num_gaussians", "num_filters"):
        del arch[k]
    arch.update({
        "radius": 2.2, "max_neighbours": 12, "equivariance": True,
        "hidden_dim": 48, "num_conv_layers": 4,
        "output_heads": {
            "graph": {"num_sharedlayers": 2, "dim_sharedlayers": 48,
                      "num_headlayers": 2, "dim_headlayers": [48, 48]},
            "node": {"num_headlayers": 2, "dim_headlayers": [48, 48],
                     "type": "mlp"}},
        "task_weights": [1.0, 10.0]})
    nn_["Variables_of_interest"].update({
        "output_index": [0, 1], "type": ["graph", "node"],
        "output_names": ["graph_energy", "node_x2"]})
    return cfg


def egnn_oc22_config(epochs=ARCH_EPOCHS, perc_train=0.5):
    """The architecture and training sections of
    examples/open_catalyst_2022/open_catalyst_2022_energy.json (EGNN,
    hidden 32, 2 convs, equivariant, radius 4.0, max_neighbours 20, graph
    head (2, 32, 2, [32, 16]); AdamW 1e-3, mae) on the synthetic BCC set at
    batch 512."""
    cfg = flagship_config(perc_train=perc_train, epochs=epochs,
                          model_type="EGNN")
    nn_ = cfg["NeuralNetwork"]
    nn_["Architecture"].update({
        "radius": 4.0, "max_neighbours": 20, "num_gaussians": 50,
        "envelope_exponent": 5, "int_emb_size": 32, "basis_emb_size": 8,
        "out_emb_size": 32, "num_after_skip": 1, "num_before_skip": 1,
        "num_radial": 5, "num_spherical": 3, "num_filters": 32,
        "hidden_dim": 32, "num_conv_layers": 2,
        "output_heads": {"graph": {
            "num_sharedlayers": 2, "dim_sharedlayers": 32,
            "num_headlayers": 2, "dim_headlayers": [32, 16]}},
        "task_weights": [1.0], "equivariance": True})
    nn_["Training"]["loss_function_type"] = "mae"
    return cfg


def gat_config(width=FEATURES, dropout=0.0, epochs=TRAIN_EPOCHS,
               perc_train=0.5):
    """The arch sweep's GAT (bench.py:199-230: hidden ``width``, 6 heads,
    negative slope 0.05, 4 convs, radius 1.8, max_neighbours 20, graph head
    (2, width, 2, (width, width))) on the synthetic BCC set at batch 512,
    AdamW 1e-3, with attention dropout ``dropout`` (0.0: the recipe of the
    reference's own warning at hidden * heads >= 256)."""
    cfg = flagship_config(width, perc_train=perc_train, epochs=epochs,
                          model_type="GAT")
    arch = cfg["NeuralNetwork"]["Architecture"]
    for k in ("num_gaussians", "num_filters"):
        del arch[k]
    arch["dropout"] = dropout
    return cfg


def egcl_off_kinks(torch, equivariant, ins, send, recv, em,
                   margin=KINK_MARGIN):
    """The egcl op inputs ``[x, geo, w0, b0, w1, b1(, wc0, bc0, wc1)]`` with
    the biases b0, b1 (and bc0) moved, column by column, until no real
    edge's ReLU input lies within ``margin`` of zero (float64, on the
    float32 values).  At such an edge two correct float32 computations that
    sum in another order can take the two branches of the ReLU, and that
    edge's whole gradient term appears in one and not in the other: the
    kernels are held to their plain versions on inputs where the branch is
    decided.  Returns (the new inputs, the number of bias entries moved)."""
    ok = em != 0
    s, r = send[ok].long(), recv[ok].long()
    x, geo, w0 = (t.double() for t in ins[:3])
    f = x.shape[1]
    moved = 0

    def clear(pre, bias):
        nonlocal moved
        b = bias.double()
        for _ in range(200):
            near = ((pre + b).abs() < margin).any(0)
            if not bool(near.any()):
                return b.to(bias.dtype), torch.relu(pre + b)
            moved += int(near.sum())
            b = torch.where(near, b + 3 * margin, b).float().double()
        raise RuntimeError("egcl_off_kinks: a bias column stays on a kink")

    out = list(ins)
    pre = x[s] @ w0[:f] + x[r] @ w0[f:2 * f] + geo[ok][:, 3:] @ w0[2 * f:]
    out[3], a = clear(pre, ins[3])
    out[5], m = clear(a @ ins[4].double(), ins[5])
    if equivariant:
        out[7], _ = clear(m @ ins[6].double(), ins[7])
    return out, moved


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


def bound(nbytes, flops, peak=F32_FLOPS_PER_S):
    """The least time for the work: bytes over the HBM rate or float32
    operations over the peak of the units that do them (the CUDA cores
    unless named), whichever is larger (ms, and which)."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_f = flops / peak * 1e3
    return max(t_b, t_f), ("bytes" if t_b >= t_f else "operations")


def tensor_core_bounds(nbytes, flops):
    """A tensor-core kernel's bound (3xTF32) and, beside it, the bound of
    the same work on the CUDA cores: (ms, by, cuda-core ms)."""
    b_ms, b_by = bound(nbytes, flops, TF32X3_FLOPS_PER_S)
    return b_ms, b_by, bound(nbytes, flops)[0]


def pass_p_build_report():
    """The registers, stack, spills and static shared memory (ptxas) of
    the redesigned kernels (scf and cgcnn pass P, the row_mlp forward's
    and backward's two routes, the dn_tri backward, the scf filter-gather
    kernel's and the dn_tri forward's routes 1, the builder's, cgcnn pass
    S, the GAT forward's, pass R's and pass S's routes 1, egcl's three
    routes 1, the builder's pass P's route 1 and the gather-multiply's
    forward and fused backward, routes 1) and, beside them, of the
    kernels that share their sources (cgcnn's forward; the first designs
    of the three GAT kernels and of egcl's; both first designs of the
    filter-gather kernel and the dn_tri forward; the gather-multiply's
    first design); and the
    dynamic shared memory of one block of scf pass P, cgcnn pass P, the
    scf filter-gather route 1 and the dn_tri forward's route 1 at the
    main path's widths (the kernels' own layouts).  Fails when a source's
    report is missing."""
    from hydragnn_torch.kernels.build import load_library, ptxas_log
    from hydragnn_torch.ops import scf_mp

    keys = {"scf_mp": ("pass_p_kernel", "scf_fg_tc_kernel",
                       "scf_filter_gather_kernel"),
            "cgcnn_mp": ("pass_p_kernel", "node_table_kernel",
                         "cgcnn_fwd_kernel", "pass_s_sums_kernel",
                         "row_product_kernel"),
            # the forward, passes R and S: the routes 1 and the first
            # design's instantiations
            "gat_mp": ("gat_fwd_kernel", "gat_pass_r_kernel",
                       "gat_pass_s_kernel", "gat_kernelILi0E",
                       "gat_kernelILi1E", "gat_kernelILi2E"),
            "row_mlp": ("row_mlp_fwd_tc_kernel", "row_mlp_fwd_kernel",
                        "row_mlp_bwd_tc_kernel", "row_mlp_bwd_kernel"),
            "dn_tri": ("dn_tri_fwd_kernel", "dn_tri_bwd_kernel",
                       "fwd_tc_kernel"),
            "dn_tri_builder": ("fwd_tc_kernel", "wgrad_tc_kernel",
                               "tri_rows_kernel", "tri_wgrad_kernel"),
            "egcl_mp": ("pass_p_tc_kernel", "pass_s_tc_kernel",
                        "fwd_tc_kernel", "egcl_kernel"),
            # the gather-multiply's routes 1 (forward, fused backward) and
            # its first design
            "fused_mp": ("gm_fwd_kernel", "gm_bwd_kernel",
                         "gather_mul_segment_sum_kernel")}
    kernels = []
    for src, names in keys.items():
        rep = ptxas_report(ptxas_log(src), names)
        check(bool(rep) and all("registers" in k for k in rep),
              f"ptxas: no register report for {src}.cu's kernels")
        kernels += rep
    cg = load_library("cgcnn_mp")
    scf = load_library("scf_mp")
    width = scf_mp.pass_p_plan(WIDE, GAUSSIANS, 1, 1).width
    wp = cg.hg_cgcnn_pass_p_width(FEATURES, FEATURES, 0)
    # the arch sweep's DimeNet: S*R = 42, D = int_emb_size 64
    return {"phase": "ptxas", "kernels": kernels,
            "dynamic_smem_bytes": {
                f"scf_pass_p (F={WIDE}, G={GAUSSIANS}, W={width})":
                    scf.hg_scf_pass_p_smem(WIDE, GAUSSIANS, width),
                f"scf_fg_tc (F={WIDE}, G={GAUSSIANS})":
                    scf.hg_scf_fwd_smem(WIDE, GAUSSIANS),
                f"cgcnn_pass_p (F=D={FEATURES}, wp={wp})":
                    cg.hg_cgcnn_pass_p_smem(FEATURES, 0, wp),
                "dn_tri fwd_tc (S*R=42, D=64)":
                    load_library("dn_tri").hg_dn_tri_fwd_smem(42, 64)}}


def ptxas_report(log, keys):
    """Registers, stack, spills and static shared memory of each kernel in
    an ``nvcc -Xptxas -v`` log whose (mangled) name holds one of ``keys``."""
    import re

    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = None
            if any(k in m.group(1) for k in keys):
                cur = {"kernel": m.group(1)}
                out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(m.group(1)) if m else 0
    return out


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

    def bits(a, b):
        a, b = (t if isinstance(t, tuple) else (t,) for t in (a, b))
        return len(a) == len(b) and all(
            (u is None and v is None) or torch.equal(u, v)
            for u, v in zip(a, b))

    def hold_routes(name, launch, plain, same=bits):
        """Route 1 (``launch(1)``) within REL_TOL_KERNEL of ``plain`` and
        bit-identical twice, route 2's bits (``same``), both timed cold
        and warm."""
        r1, r1b, r2 = launch(1)(), launch(1)(), launch(2)()
        torch.cuda.synchronize()
        check(bits(r1, r1b), f"{name} route 1: two runs differ")
        check(same(r1, r2), f"{name}: route 1 and route 2 differ")
        first = r1[0] if isinstance(r1, tuple) else r1
        want = plain[0] if isinstance(plain, tuple) else plain
        rel_e = rel_err(torch, first, want)[1]
        check(rel_e <= REL_TOL_KERNEL,
              f"{name} route 1 disagrees with its plain version: {rel_e}")
        return {"kernel_route": 1,
                "ms": time_ms(torch, launch(1), flush, lead=True),
                "warm_l2_ms": time_ms(torch, launch(1), lead=True),
                "route2_ms": time_ms(torch, launch(2), flush, lead=True),
                "route2_warm_l2_ms": time_ms(torch, launch(2), lead=True)}

    # -- gather_mul_segment_sum: CFConv aggregation, once per conv layer
    k = fm.gather_mul_segment_sum(x, w, send, recv, perm, edge_valid=mask)
    torch.cuda.synchronize()
    p = fm.gather_mul_segment_sum_plain(x, w, send, recv, edge_valid=mask)
    torch.cuda.synchronize()
    abs_e, rel_e = rel_err(torch, k, p)
    check(rel_e <= REL_TOL_KERNEL,
          f"gather_mul_segment_sum disagrees with its plain version: {rel_e}")
    row_ptr = segment_offsets(recv, n, mask)
    check(fm.fwd_route(f) == 1, f"the gather-multiply's route at F={f}")
    routes = hold_routes("gather_mul_segment_sum", lambda r: lambda: (
        fm.launch_gather_mul(x, w, None, send, row_ptr, route=r)), p)
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
        "max_abs_err": abs_e, "max_rel_err": rel_e, **routes,
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
    routes = hold_routes("gather_segment_sum", lambda r: lambda: (
        fm.launch_gather_mul(x, None, mask, send, row_ptr,
                             op="gather_segment_sum", route=r)), p)
    results.append({
        "name": "gather_segment_sum", "route": "cuda",
        "source": "hydragnn_torch/csrc/fused_mp.cu",
        "replaces": "hydragnn_tpu/ops/fused_mp.py:171",
        "max_abs_err": abs_e, "max_rel_err": rel_e, **routes,
        "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
            x, None, send, recv, edge_valid=mask, mask=mask), flush),
        "library_ms": time_ms(torch, lambda: csr @ x, flush),
        "bound_ms": nw_ms, "bound_by": nw_by,
        "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f},
    })

    # -- the backward of both (K1), held through the code the main path
    #    runs: the ops' backward (autograd Function, grad mode off: route
    #    1's fused launch) against autograd through the plain versions, dw
    #    bit-equal to x[senders] * g[receivers] on real edges and zero on
    #    masked ones; then the fused launch alone (dx and dw; dx in the
    #    no-w mode) against route 2 (the first design's dx pass on the
    #    sender-sorted w[p] the composition builds), and the whole backward
    #    through the Function with each route
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
    check(torch.equal(gk[1][real], (x[send.long()] * ct[recv.long()])[real])
          and bool((gk[1][~real] == 0).all()),
          "dw is not x[senders] * g[receivers] on real edges and zero on "
          "masked ones")
    notes["gather_mul_segment_sum_dw"] = {
        "max_abs_err": dw_err[0], "max_rel_err": dw_err[1],
        "bit_equal_on_real_edges": True, "zero_on_masked_edges": True}
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

    def same_dx(a, b):
        return torch.equal(a if torch.is_tensor(a) else a[0],
                           b if torch.is_tensor(b) else b[0])

    def bwd_launch(has_w):
        op = "gather_mul_segment_sum_dx" if has_w else "gather_segment_sum_dx"

        def launch(r):
            if r == 1:
                return lambda: fm.launch_gather_mul_bwd(
                    ct, x, w if has_w else None, None if has_w else mask,
                    perm, recv, ptr_s, op=op)
            return lambda: fm.launch_gather_mul(
                ct, w_s if has_w else None, None if has_w else m_s, send_s,
                ptr_s, op=op, route=2)
        return launch

    def whole_backward(has_w, r):
        """The backward as the path runs it, from g to (dx, dw), through
        the op's Function with grad mode off, on route ``r``."""
        xs = x.detach().clone().requires_grad_(True)
        if has_w:
            ws = w.detach().clone().requires_grad_(True)
            out = fm._GatherMulSegmentSum.apply(
                xs, ws, send, recv, perm, mask, "gather_mul_segment_sum", r)
            leaves = (xs, ws)
        else:
            out = fm._GatherSegmentSum.apply(xs, send, recv, perm, mask,
                                             "gather_segment_sum", r)
            leaves = (xs,)
        return time_ms(torch, lambda: torch.autograd.grad(
            out, leaves, ct, retain_graph=True), flush)

    # the fused launch reads g and x, the real rows of w (or mask values),
    # p and recv on real positions and row_ptr, and writes dx and dw
    # (3 flops a real edge and column: dx's fma, dw's product); the no-w
    # mode reads g, p, recv and mask on real positions and writes dx
    fb_ms, fb_by = bound(
        4 * (2 * n * f + e_valid * f + 2 * e_valid + n + 1 + n * f
             + e * f), 3 * e_valid * f)
    nb_ms, nb_by = bound(4 * (n * f + 3 * e_valid + n + 1 + n * f),
                         2 * e_valid * f)
    for has_w, (err, b_ms_, b_by_) in ((True, (dx_err, fb_ms, fb_by)),
                                       (False, (sdx_err, nb_ms, nb_by))):
        name = ("gather_mul_segment_sum_dx" if has_w
                else "gather_segment_sum_dx")
        routes = hold_routes(name, bwd_launch(has_w), gp[0] if has_w else sp,
                             same_dx)
        row = {
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/fused_mp.cu",
            "replaces": ("hydragnn_tpu/ops/fused_mp.py:235" if has_w
                         else "hydragnn_tpu/ops/fused_mp.py:270"),
            "max_abs_err": err[0], "max_rel_err": err[1], **routes,
            "backward_ms": whole_backward(has_w, 1),
            "route2_backward_ms": whole_backward(has_w, 2),
            "plain_ms": time_ms(torch, lambda: fm.gather_mul_segment_sum_plain(
                ct, w_s if has_w else None, send_s, recv_s, edge_valid=m_s,
                mask=None if has_w else m_s), flush),
            "bound_ms": b_ms_, "bound_by": b_by_,
            "library_ms": None if has_w else time_ms(
                torch, lambda: csr_s @ ct, flush),
            "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f}}
        if has_w:
            # route 2's launch alone: the first design's bound (w[p] read)
            row["route2_bound_ms"] = b_ms
        results.append(row)

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
        "ms": time_ms(torch, lambda: fm.launch_segment_sum_rows(
            xn, pool_ptr, n_graphs), flush, lead=True),
        "warm_l2_ms": time_ms(torch, lambda: fm.launch_segment_sum_rows(
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


def scf_composed64(torch, x, rbf, cm, em, w0, b0, w1, b1, gidx, rowid):
    """The composed edge pipeline in float64 (x gathered at ``gidx``,
    summed at ``rowid``): the yardstick of the filter-gather kernel."""
    x, rbf, cm, w0, b0, w1, b1 = (t.double()
                                  for t in (x, rbf, cm, w0, b0, w1, b1))
    a = torch.nn.functional.softplus(rbf @ w0 + b0) - math.log(2.0)
    msgs = x[gidx.long()] * ((a @ w1 + b1) * cm[:, None])
    msgs = torch.where((em != 0)[:, None], msgs, torch.zeros_like(msgs))
    return torch.zeros_like(x).index_add(0, rowid.long(), msgs)


def scf_weight_bytes(torch, ptr, f, g, n_blocks):
    """Bytes of W0 and W1 that the filter-gather kernel reads from L2 in
    one launch over the CSR ``ptr``: (route 1, route 2).  Route 1 reads W0
    and W1 whole once per 64-edge tile of each block's share
    (``row_shares`` over ``n_blocks`` blocks, one a SM); route 2 (the
    first design, 32-edge tiles at F <= 256) once per 32-edge tile of each
    16-row block."""
    from hydragnn_torch.ops import scf_mp as sm
    from hydragnn_torch.ops.aggregate import row_shares

    p = ptr.long().cpu()
    per_tile = 4 * (g + f) * f
    b = row_shares(ptr, n_blocks)
    m = sm.SCF_TC_TILE
    tiles1 = int(((p[b[1:]] - p[b[:-1]] + m - 1) // m).sum())
    n = p.numel() - 1
    blk = torch.arange(0, n + 16, 16).clamp(max=n)
    tiles2 = int(((p[blk[1:]] - p[blk[:-1]] + 31) // 32).sum())
    return tiles1 * per_tile, tiles2 * per_tile


def scf_phase(torch, g, seed):
    """The three scf kernels of the wide SchNet against the composed plain
    version under autograd, at the first batch's geometry (F=256, G=50,
    radius 1.8); then the filter-gather kernel's route (the card's
    against the plan's, route 1 at the path's widths), its forward and
    pass S as the path launches them against a float64 run of the
    composed op (within twice the float32 plain version's error, or 1e-6
    of the largest entry), a second launch bit-identical, and the first
    design (route 2) at the same inputs held to the plain version; and
    each kernel timed alone as the main path launches it (pass P without
    drbf/dcm: energy-only training asks for neither), the forward and
    pass S also on route 2 (``route2_ms``)."""
    from hydragnn_torch.kernels.build import load_library
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
    route = load_library("scf_mp").hg_scf_fwd_route(f, gd)
    check(route == sm.fwd_route(f, gd) == 1,
          f"scf forward (F={f}, G={gd}): route {route} on the card, "
          f"{sm.fwd_route(f, gd)} planned, the path's route is 1")
    # the forward (x = h) and pass S (x = the cotangent, gathered at the
    # receivers, summed at the senders) as the path launches them
    fg_args = {"scf_edge_pipeline": (h, send, recv, None, ptr_r),
               "scf_edge_pipeline_pass_s": (ct, recv, send, perm, ptr_s)}

    def fg(op, route_=0):
        x_, gi, ri, pm, ptr = fg_args[op]
        return sm.launch_scf_filter_gather(x_, rbf, cm, w0, b0, w1, b1, gi,
                                           ri, pm, ptr, op, route=route_)

    yard = {}
    with torch.no_grad():
        for op, name in (("scf_edge_pipeline", "out"),
                         ("scf_edge_pipeline_pass_s", "dh")):
            x_, gi, ri = fg_args[op][:3]
            k1, again, k2 = fg(op), fg(op), fg(op, 2)
            torch.cuda.synchronize()
            check(torch.equal(k1, again), f"scf {name}: a second launch "
                  "differs")
            p32 = sm.scf_edge_pipeline_plain(x_, rbf, cm, em, w0, b0, w1, b1,
                                             gi, ri)
            p64 = scf_composed64(torch, x_, rbf, cm, em, w0, b0, w1, b1, gi,
                                 ri)
            e32 = float((p32.double() - p64).abs().max())
            e_k = float((k1.double() - p64).abs().max())
            allowed = max(2 * e32, 1e-6 * float(p64.abs().max()))
            check(e_k <= allowed, f"scf {name} (route 1): {e_k} from the "
                  f"float64 run, over {allowed}")
            errs[name + "_route2"] = rel_err(torch, k2, p32)
            check(errs[name + "_route2"][1] <= REL_TOL_KERNEL,
                  f"scf {name} (route 2): {errs[name + '_route2'][1]} from "
                  "the plain version")
            yard[name] = {"vs_float64": e_k, "plain_float32_vs_float64": e32,
                          "float64_allowed": allowed}
            del p32, p64
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    wbytes = 4 * (gd * f + f * f + 2 * f)
    geo = 4 * e_valid * (gd + 1 + 2)   # rbf rows, cm, two ids
    fwd_flops = 2 * e_valid * (gd * f + f * f)
    launches = {
        # route 1 runs its products on the tensor cores (3xTF32)
        "scf_edge_pipeline": (
            lambda: fg("scf_edge_pipeline"),
            lambda: sm.scf_edge_pipeline_plain(
                h, rbf, cm, em, w0, b0, w1, b1, send, recv),
            tensor_core_bounds(4 * 2 * n * f + geo + wbytes, fwd_flops),
            "hydragnn_tpu/ops/fused_block.py:495", ("out",)),
        # as the path launches it (no drbf, dcm): t0, then u = dfilt . W1^T,
        # dW1 and dW0 per edge; f2 = a . W1 + b1 feeds only dcm
        "scf_edge_pipeline_pass_p": (
            lambda: sm.launch_scf_pass_p(
                h, ct, rbf, cm, w0, b0, w1, b1, send, recv, ptr_r, False),
            lambda: sm.scf_pass_p_plain(
                h, ct, rbf, cm, em, w0, b0, w1, b1, send, recv),
            tensor_core_bounds(4 * 2 * n * f + geo + 3 * wbytes,
                               2 * e_valid * (2 * gd * f + 2 * f * f)),
            "hydragnn_tpu/ops/fused_block.py:561",
            ("dw0", "db0", "dw1", "db1", "drbf", "dcm")),
        "scf_edge_pipeline_pass_s": (
            lambda: fg("scf_edge_pipeline_pass_s"),
            lambda: sm.scf_edge_pipeline_plain(
                ct, rbf, cm, em, w0, b0, w1, b1, recv, send),
            tensor_core_bounds(4 * 2 * n * f + geo + 4 * e_valid + wbytes,
                               fwd_flops),
            "hydragnn_tpu/ops/fused_block.py:599", ("dh",)),
    }
    results = []
    for name, (kern, plain, bnd, replaces, outs) in launches.items():
        worst = max(outs, key=lambda o: errs[o][1])
        results.append({
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/scf_mp.cu", "replaces": replaces,
            "max_abs_err": errs[worst][0], "max_rel_err": errs[worst][1],
            "ms": time_ms(torch, kern, flush, lead=True),
            "warm_l2_ms": time_ms(torch, kern, lead=True),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": {"N": n, "E": e, "E_valid": e_valid, "F": f, "G": gd},
        })
        if len(bnd) == 3:
            results[-1]["bound_ms_cuda_cores"] = bnd[2]
        if name in fg_args:
            w1b, w2b = scf_weight_bytes(
                torch, fg_args[name][4], f, gd,
                torch.cuda.get_device_properties(dev).multi_processor_count)
            results[-1].update(
                forward_route=route, weight_l2_bytes=w1b,
                route2_weight_l2_bytes=w2b,
                route2_ms=time_ms(torch, lambda: fg(name, 2), flush,
                                  lead=True))
    notes = {k: {"max_abs_err": a, "max_rel_err": r}
             for k, (a, r) in errs.items()}
    notes["forward_route"] = route
    notes["route1_vs_float64"] = yard
    return results, notes


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


def egcl_flops(f, h, gp, equivariant, edges, nodes, dx=True, dgeo=True):
    """Floating-point operations (a multiply-add is two) that the three egcl
    kernels' functions need on ``edges`` real edges and ``nodes`` real
    nodes: (forward, pass P, pass S).  The products with x factor to the
    nodes (x[s] @ W0s = (x @ W0s)[s]; dW0s = x^T (the dt0 summed per
    sender); dx_s = (the dt0 summed per sender) @ W0s^T), so they count
    once per node; the rest of the chain is per edge: the geometry rows of
    t0, W1 and, in the equivariant block, Wc0 and wc1; back to dt0 through
    W1^T and Wc0^T; pass P's per-edge weight grads (dW1, dW0g, dWc0, dwc1)
    and dgeo's radial and edge_attr lanes.  Pass P without ``dx`` or
    ``dgeo`` (layer 0) leaves out dx_s or those lanes."""
    fwd_e = 2 * gp * h + 2 * h * h
    back_e = 2 * h * h
    wgrad_e = 2 * h * h + 2 * gp * h
    if equivariant:
        fwd_e += 2 * h * h + 2 * h
        back_e += 2 * h * h
        wgrad_e += 2 * h * h + 2 * h
    fwd_n = 2 * 2 * f * h  # x @ W0s, x @ W0r
    fwd = edges * fwd_e + nodes * fwd_n
    # pass P: + dW0s, dW0r and dx_s at the nodes; pass S: + dx_r
    pass_p = (edges * (fwd_e + back_e + wgrad_e + 2 * gp * h * dgeo)
              + nodes * (fwd_n + (2 + dx) * 2 * f * h))
    pass_s = edges * (fwd_e + back_e) + nodes * (fwd_n + 2 * f * h)
    return fwd, pass_p, pass_s


def egcl_phase(torch, g, seed):
    """The three egcl kernels at the first egnn_md17 train batch, on the
    batch's own geometry, in the three instantiations md17's main path
    launches: layers 1-2 (F = H = 48, equivariant, x and geo want
    gradients), layer 3 (F = H = 48, no coordinate gate) and layer 0 (F = 1,
    equivariant, pass P with no dx and no dgeo, no pass S).  Each through
    its autograd Function against autograd through the composed plain
    version: forward 1e-5, dx and dgeo 1e-5, the edge-summed weight grads
    1e-4 of their largest entry; dgeo exactly zero on masked edges.  Pass S
    alone at layers 1-2 and layer 3: its route the plan's, route 1 (pass
    P's tensor-core chain in receiver order) and route 2 (the first
    design) within 1e-5 of the plain version's largest entry, route 1
    bit-identical twice and zero on rows without a real incoming edge.
    The forward alone at layers 1-2, layer 3 and layer 0: its route the
    plan's, route 1 (the front of pass P's chain in sender order, a warp
    per share of the sender rows) and route 2 (the first design) within
    1e-5 of the plain version's largest entry (agg and psum), route 1
    bit-identical twice and zero on rows without a real outgoing edge.
    Then each kernel timed alone as layers 1-2 launch it (pass P with dx
    and dgeo, and its reduction), beside its plain version; every kernel
    also as layer 3 and, except pass S, layer 0 launch it; the first
    designs of the forward and pass S beside their routes 1
    (``route2_ms``); the forward's bound at 3xTF32 with the CUDA-core
    bound beside it."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.models.layers import edge_geometry
    from hydragnn_torch.ops import egcl_mp as em_
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    h = 48
    gen = torch.Generator(device=dev).manual_seed(seed + 3)
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    perm = g.extras["edge_perm_sender"]
    em = mask.to(torch.int32)
    real = mask != 0
    diff, radial = edge_geometry(g.pos, send, recv)
    geo = torch.cat([diff, radial], 1).contiguous()
    gp = geo.shape[1] - 3
    ca = torch.randn(n, h, device=dev, generator=gen)
    cp = torch.randn(n, 3, device=dev, generator=gen)
    names = ("x", "geo", "w0", "b0", "w1", "b1", "wc0", "bc0", "wc1")

    def lecun(rows, cols):
        return torch.randn(rows, cols, device=dev, generator=gen) / rows ** 0.5

    def bias():
        return torch.randn(h, device=dev, generator=gen) * 0.1

    def hold(equivariant, f, data_grads):
        """One instantiation held to its plain version; returns its
        inputs, the errors by output and the bias entries moved."""
        ins = [torch.randn(n, f, device=dev, generator=gen), geo,
               lecun(2 * f + gp, h), bias(), lecun(h, h), bias()]
        if equivariant:
            ins += [lecun(h, h), bias(),
                    torch.randn(h, 1, device=dev, generator=gen) * 0.5]
        ins, moved = egcl_off_kinks(torch, equivariant, ins, send, recv,
                                    mask)
        what = f"egcl (equivariant={equivariant}, F={f})"

        def run(fn):
            ts = [t.detach().clone().requires_grad_(i >= 2 or data_grads)
                  for i, t in enumerate(ins)]
            full = ts + [None] * (9 - len(ts))
            agg, psum = fn(equivariant, full[0], full[1], em, *full[2:],
                           send, recv)
            loss = (agg * ca).sum()
            if equivariant:
                loss = loss + (psum * cp).sum()
            loss.backward()
            torch.cuda.synchronize()
            return ((agg.detach(), None if psum is None else psum.detach()),
                    [t.grad for t in ts])

        em_.reset_launches()
        k_out, k_grads = run(lambda *a: em_.egcl_block(*a, perm))
        check(em_.LAUNCHES == {"egcl_block": 1, "egcl_block_pass_p": 1,
                               "egcl_block_pass_s": int(data_grads)},
              f"{what} launches {em_.LAUNCHES}")
        p_out, p_grads = run(em_.egcl_block_reference)
        errs = {"agg": rel_err(torch, k_out[0], p_out[0])}
        if equivariant:
            errs["psum"] = rel_err(torch, k_out[1], p_out[1])
        for name, a, c in zip(names, k_grads, p_grads):
            if name in ("x", "geo") and not data_grads:
                check(a is None, f"{what}: d{name} was computed")
                continue
            if name == "geo":
                check(bool((a[~real] == 0).all()),
                      f"{what}: dgeo is not zero on masked edges")
                a, c = a[real], c[real]
            errs["d" + name] = rel_err(torch, a, c)
        for name, (_, rel_e) in errs.items():
            tol = REL_TOL_KERNEL if name in ("agg", "psum", "dx", "dgeo") \
                else REL_TOL_WGRAD
            check(rel_e <= tol, f"{what}: {name} disagrees with the plain "
                  f"version under autograd: {rel_e} > {tol}")
        return ins, errs, moved

    def worst_of(errs):
        k = max(errs, key=lambda o: errs[o][1])
        return {"worst": k, "max_abs_err": errs[k][0],
                "max_rel_err": errs[k][1]}

    f = 48
    ins, errs, moved = hold(True, f, True)
    ins_last, errs_last, moved_last = hold(False, f, True)
    ins_l0, errs_l0, moved_l0 = hold(True, 1, False)
    ptr_r = segment_offsets(recv, n, em)
    nodes = torch.arange(n, device=dev)
    no_in = ~torch.isin(nodes, recv[real])
    lib = load_library("egcl_mp")

    def pass_s_launch(equivariant, ins_, route):
        ws_ = em_.kernel_weights(equivariant, *(ins_[2:] + [None] * (
            9 - len(ins_))), f, h, dev)
        return lambda: em_.launch_egcl(
            "egcl_block_pass_s", equivariant, ins_[0], geo, ws_, send, recv,
            None, ptr_r, ca, cp if equivariant else None, route=route)

    def hold_pass_s(equivariant, ins_):
        """Pass S alone: both routes against the plain version, route 1
        twice."""
        what = f"egcl pass S (equivariant={equivariant}, F={f})"
        got = lib.hg_egcl_pass_s_route(f, h, gp, int(equivariant))
        check(got == em_.pass_s_route(f, h, gp, equivariant) == 1,
              f"{what}: route {got} on the card, the plan's and the path's "
              "is 1")
        full = ins_ + [None] * (9 - len(ins_))
        with torch.no_grad():
            runs = [pass_s_launch(equivariant, ins_, r)() for r in (1, 1, 2)]
            plain = em_.egcl_pass_s_plain(
                equivariant, ins_[0], geo, em, *full[2:], send, recv, ca,
                cp if equivariant else None)
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]),
              f"{what}: route 1 differs on a second run")
        check(bool((runs[0][no_in] == 0).all()),
              f"{what}: route 1 wrote a row without a real incoming edge")
        out = {}
        for route, k in ((1, runs[0]), (2, runs[2])):
            err = rel_err(torch, k, plain)
            check(err[1] <= REL_TOL_KERNEL, f"{what}: route {route} "
                  f"disagrees with its plain version: {err[1]}")
            out[f"route{route}"] = {"max_abs_err": err[0],
                                    "max_rel_err": err[1]}
        return out

    pass_s_errs = {"layers_1_2": hold_pass_s(True, ins),
                   "layer_3": hold_pass_s(False, ins_last)}
    ptr_s = segment_offsets(send[perm.long()], n, em[perm.long()])
    no_out = ~torch.isin(nodes, send[real])

    def fwd_launch(equivariant, f_, ins_, route):
        ws_ = em_.kernel_weights(equivariant, *(ins_[2:] + [None] * (
            9 - len(ins_))), f_, h, dev)
        return lambda: em_.launch_egcl(
            "egcl_block", equivariant, ins_[0], geo, ws_, send, recv, perm,
            ptr_s, route=route)

    def hold_fwd(equivariant, f_, ins_):
        """The forward alone: both routes against the plain version,
        route 1 twice."""
        what = f"egcl forward (equivariant={equivariant}, F={f_})"
        got = lib.hg_egcl_fwd_route(f_, h, gp, int(equivariant))
        check(got == em_.fwd_route(f_, h, gp, equivariant) == 1,
              f"{what}: route {got} on the card, the plan's and the path's "
              "is 1")
        full = ins_ + [None] * (9 - len(ins_))
        with torch.no_grad():
            runs = [fwd_launch(equivariant, f_, ins_, r)() for r in (1, 1, 2)]
            plain = em_.egcl_block_reference(
                equivariant, ins_[0], geo, em, *full[2:], send, recv)
        torch.cuda.synchronize()
        outs = ("agg", "psum") if equivariant else ("agg",)
        for i, name in enumerate(outs):
            check(torch.equal(runs[0][i], runs[1][i]),
                  f"{what}: route 1's {name} differs on a second run")
            check(bool((runs[0][i][no_out] == 0).all()),
                  f"{what}: route 1 wrote {name} on a row without a real "
                  "outgoing edge")
        out = {}
        for route, k in ((1, runs[0]), (2, runs[2])):
            errs_ = {name: rel_err(torch, k[i], plain[i])
                     for i, name in enumerate(outs)}
            for name, (_, rel_e) in errs_.items():
                check(rel_e <= REL_TOL_KERNEL, f"{what}: route {route}'s "
                      f"{name} disagrees with its plain version: {rel_e}")
            out[f"route{route}"] = worst_of(errs_)
        return out

    fwd_errs = {"layers_1_2": hold_fwd(True, f, ins),
                "layer_3": hold_fwd(False, f, ins_last),
                "layer_0": hold_fwd(True, 1, ins_l0)}

    e_valid = int(real.sum())
    n_valid = int((g.node_mask != 0).sum())
    x = ins[0]
    ws = em_.kernel_weights(True, *ins[2:], f, h, dev)
    plain_args = (True, x, geo, em, *ins[2:], send, recv, ca, cp)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def fwd_bound(equivariant, f_, ins_):
        """The forward's bounds as its route 1 runs it: at 3xTF32, and on
        the CUDA cores beside it.  Read once: x, the real edges' geo rows
        and ids (perm, send, recv), row_ptr, the weights; written once: agg
        (and psum)."""
        ws_ = em_.kernel_weights(equivariant, *(ins_[2:] + [None] * (
            9 - len(ins_))), f_, h, dev)
        inb = (4 * (n * f_ + e_valid * (3 + gp) + 3 * e_valid + n + 1)
               + 4 * sum(t_.numel() for t_ in ws_ if t_ is not None))
        outb = 4 * n * (h + (3 if equivariant else 0))
        fl = egcl_flops(f_, h, gp, equivariant, e_valid, n_valid)[0]
        return tensor_core_bounds(inb + outb, fl)

    def pass_p(equivariant, f_, ins_, data_grads):
        """Pass P as one instantiation launches it (layer 0: no dx, no
        dgeo): the launch, its bounds (route 1 on the tensor cores: at
        3xTF32, and on the CUDA cores beside it) and its route."""
        ws_ = em_.kernel_weights(equivariant, *(ins_[2:] + [None] * (
            9 - len(ins_))), f_, h, dev)
        wb = 4 * sum(t_.numel() for t_ in ws_ if t_ is not None)
        inb = (4 * (n * f_ + e_valid * (3 + gp) + 3 * e_valid + n + 1) + wb
               + 4 * n * (h + (3 if equivariant else 0)))
        outb = wb + data_grads * 4 * (n * f_ + e_valid * (3 + gp))
        fl = egcl_flops(f_, h, gp, equivariant, e_valid, n_valid,
                        dx=data_grads, dgeo=data_grads)[1]
        route = em_.pass_p_route(f_, h, gp, equivariant)
        bnd = (tensor_core_bounds if route == 1 else bound)(inb + outb, fl)

        def kern():
            return em_.launch_egcl(
                "egcl_block_pass_p", equivariant, ins_[0], geo, ws_, send,
                recv, perm, ptr_s, ca, cp if equivariant else None,
                want_dx=data_grads, want_geo=data_grads)
        return kern, bnd, route

    for eq_, f_ in ((True, f), (False, f), (True, 1)):
        got = lib.hg_egcl_pass_p_route(f_, h, gp, int(eq_))
        check(got == em_.pass_p_route(f_, h, gp, eq_) == 1,
              f"egcl pass P (F={f_}, H={h}, equivariant={eq_}): route "
              f"{got} on the card, {em_.pass_p_route(f_, h, gp, eq_)} "
              "planned, the path's route is 1")
    p_kern, p_bnd, p_route = pass_p(True, f, ins, True)

    def pass_s_bound(equivariant, ins_):
        """Pass S's bounds as its route 1 runs it: at 3xTF32, and on the
        CUDA cores beside it.  Read once: x, the real edges' geo rows and
        ids (send, recv), row_ptr, the weights, the cotangents dagg (and
        dpsum); written once: dx."""
        ws_ = em_.kernel_weights(equivariant, *(ins_[2:] + [None] * (
            9 - len(ins_))), f, h, dev)
        inb = (4 * (n * f + e_valid * (3 + gp) + 2 * e_valid + n + 1)
               + 4 * sum(t_.numel() for t_ in ws_ if t_ is not None)
               + 4 * n * (h + (3 if equivariant else 0)))
        fl = egcl_flops(f, h, gp, equivariant, e_valid, n_valid)[2]
        return tensor_core_bounds(inb + 4 * n * f, fl)
    launches = {
        "egcl_block": (
            fwd_launch(True, f, ins, 0),
            lambda: em_.egcl_block_reference(True, x, geo, em, *ins[2:],
                                             send, recv),
            fwd_bound(True, f, ins),
            "hydragnn_tpu/ops/fused_block.py:495", ("agg", "psum")),
        "egcl_block_pass_p": (
            p_kern, lambda: em_.egcl_pass_p_plain(*plain_args), p_bnd,
            "hydragnn_tpu/ops/fused_block.py:561",
            ("dw0", "db0", "dw1", "db1", "dwc0", "dbc0", "dwc1", "dgeo")),
        "egcl_block_pass_s": (
            pass_s_launch(True, ins, 0),
            lambda: em_.egcl_pass_s_plain(*plain_args),
            pass_s_bound(True, ins),
            "hydragnn_tpu/ops/fused_block.py:599", ("dx",)),
    }
    results = []
    for name, (kern, plain, bnd, replaces, outs) in launches.items():
        worst = max(outs, key=lambda o: errs[o][1])
        results.append({
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/egcl_mp.cu", "replaces": replaces,
            "max_abs_err": errs[worst][0], "max_rel_err": errs[worst][1],
            "ms": time_ms(torch, kern, flush, lead=True),
            "warm_l2_ms": time_ms(torch, kern, lead=True),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": {"N": n, "N_valid": n_valid, "E": e,
                      "E_valid": e_valid, "F": f, "H": h,
                      "geo": 3 + gp, "equivariant": True},
        })
        if len(bnd) == 3:
            results[-1]["bound_ms_cuda_cores"] = bnd[2]
        if name == "egcl_block":
            # route 1 and the first design at every instantiation the path
            # launches: layers 1-2 (this row's ms) twice a train step,
            # layer 3 and layer 0 once
            results[-1]["fwd_route"] = em_.fwd_route(f, h, gp, True)
            results[-1]["route2_ms"] = time_ms(
                torch, fwd_launch(True, f, ins, 2), flush, lead=True)
            by = {"layers_1_2": {"ms": results[-1]["ms"],
                                 "route2_ms": results[-1]["route2_ms"]}}
            for tag, (eq_, f_, ins_) in (("layer_3", (False, f, ins_last)),
                                         ("layer_0", (True, 1, ins_l0))):
                by[tag] = {
                    "ms": time_ms(torch, fwd_launch(eq_, f_, ins_, 0),
                                  flush, lead=True),
                    "route2_ms": time_ms(torch, fwd_launch(eq_, f_, ins_, 2),
                                         flush, lead=True)}
            for tag, (eq_, f_, ins_) in (("layers_1_2", (True, f, ins)),
                                         ("layer_3", (False, f, ins_last)),
                                         ("layer_0", (True, 1, ins_l0))):
                b_ = fwd_bound(eq_, f_, ins_)
                by[tag].update(bound_ms=b_[0], bound_by=b_[1],
                               bound_ms_cuda_cores=b_[2])
            results[-1]["by_instantiation"] = by
            results[-1]["ms_per_train_step"] = (
                2 * by["layers_1_2"]["ms"] + by["layer_3"]["ms"]
                + by["layer_0"]["ms"])
        if name == "egcl_block_pass_p":
            # every instantiation the path launches, each once a train
            # step: layers 1-2 (this row's ms), layer 3, layer 0
            by = {"layers_1_2": (results[-1]["ms"], p_bnd, p_route)}
            for tag, (eq_, f_, ins_, dg) in (
                    ("layer_3", (False, f, ins_last, True)),
                    ("layer_0", (True, 1, ins_l0, False))):
                k_, b_, r_ = pass_p(eq_, f_, ins_, dg)
                by[tag] = (time_ms(torch, k_, flush, lead=True), b_, r_)
            results[-1]["pass_p_route"] = p_route
            results[-1]["by_instantiation"] = {
                tag: {"ms": ms_, "bound_ms": b_[0], "bound_by": b_[1],
                      "bound_ms_cuda_cores": b_[2] if len(b_) == 3
                      else b_[0], "pass_p_route": r_}
                for tag, (ms_, b_, r_) in by.items()}
            results[-1]["ms_per_train_step"] = (
                2 * by["layers_1_2"][0] + by["layer_3"][0]
                + by["layer_0"][0])
        if name == "egcl_block_pass_s":
            # route 1 and the first design, at layers 1-2 (this row's ms)
            # and layer 3, each once a train step
            results[-1]["pass_s_route"] = em_.pass_s_route(f, h, gp, True)
            results[-1]["route2_ms"] = time_ms(
                torch, pass_s_launch(True, ins, 2), flush, lead=True)
            b3 = pass_s_bound(False, ins_last)
            results[-1]["by_instantiation"] = {
                "layers_1_2": {
                    "ms": results[-1]["ms"],
                    "route2_ms": results[-1]["route2_ms"],
                    "bound_ms": bnd[0], "bound_by": bnd[1],
                    "bound_ms_cuda_cores": bnd[2]},
                "layer_3": {
                    "ms": time_ms(torch, pass_s_launch(False, ins_last, 0),
                                  flush, lead=True),
                    "route2_ms": time_ms(
                        torch, pass_s_launch(False, ins_last, 2), flush,
                        lead=True),
                    "bound_ms": b3[0], "bound_by": b3[1],
                    "bound_ms_cuda_cores": b3[2]}}
    notes = {k: {"max_abs_err": a, "max_rel_err": r}
             for k, (a, r) in errs.items()}
    notes["last_layer_F48"] = worst_of(errs_last)
    notes["layer0_F1"] = worst_of(errs_l0)
    notes["pass_s_routes"] = pass_s_errs
    notes["fwd_routes"] = fwd_errs
    notes["bias_entries_moved_off_kinks"] = moved + moved_last + moved_l0
    return results, notes


@contextlib.contextmanager
def cpu_dropout_bits():
    """GAT's attention-dropout bits drawn on the CPU from the step's seeded
    generator and moved to the batch's device: a generator on the card
    draws other bits than one on the CPU from the same seed, so the card
    and the CPU drop the same edges only this way.  For lockstep."""
    import torch

    from hydragnn_torch.models.gat import GATv2Conv

    draw = GATv2Conv._dropout_bits

    def on_cpu(self, e_count, n, device, dtype):
        b_edge, b_self = draw(self, e_count, n, torch.device("cpu"), dtype)
        if b_edge is None:
            return None, None
        return b_edge.to(device), b_self.to(device)

    GATv2Conv._dropout_bits = on_cpu
    try:
        yield
    finally:
        GATv2Conv._dropout_bits = draw


def gat_flops(hf, h, edges):
    """Floating-point operations that the three GAT kernels' functions need
    on ``edges`` real edges at ``hf`` = H*F lanes and ``h`` heads:
    (forward, pass R, pass S).  Per edge and lane, the forward adds xl and
    xr, takes the leaky ReLU, multiplies by att and adds into the logit,
    then multiplies and adds into acc (6); each backward pass recomputes
    the first four, adds ga * xl into q (2), forms dz (2) and adds it (1),
    and pass R adds z_act * de into d att (2), pass S p b ga[dst] (2).  Per
    edge and head about five (the max, the exponentials, de)."""
    return (edges * (6 * hf + 5 * h), edges * (11 * hf + 5 * h),
            edges * (11 * hf + 5 * h))


def gat_phase(torch, g, seed):
    """The three GAT kernels at the first train batch of the gat cell, on
    its own edges, at H*F = 384 (6 heads of 64, the gat cell) and 768 (3
    heads of 256, one head group of gat_h256), each with ones for the
    dropout bits and with real bits (keep 0.75, scaled by 1/keep).  Each
    through the op's autograd Function against autograd through the plain
    forward: acc, d, dxl and dxr 1e-5 of their largest entry, d att 1e-4
    (a sum over every edge of the batch in another order), m equal; rows
    without a real incoming edge read m = -1e9, d = 0 and zero dxr, rows
    without any real edge zero dxl.  The forward alone in each case: its
    route and group U the plan's, route 1 (lane-order logits of U edges in
    flight, one rescale a group) and route 2 (the first design) with m
    equal to the plain version's and acc, d within 1e-5, route 1
    bit-identical twice and (-1e9, 0, 0) on rows without a real incoming
    edge.  Pass S alone in each case: its route
    the plan's, route 1 (head sums across lanes, edges in flight) and
    route 2 (the first design) 1e-5 of the plain version's largest entry,
    route 1 bit-identical twice and zero on rows that send no real edge.
    Pass R alone in each case likewise: its route the plan's, route 1
    (head sums across lanes, edges in flight, d att partials in registers)
    and route 2 within 1e-5 (dxr) and 1e-4 (d att) of the plain version's
    largest entry, route 1 bit-identical twice and dxr zero on rows without
    a real incoming edge.  Then each kernel timed alone in each of the four
    cases, beside its plain version and its bound, the first designs of
    the three beside them (``route2_ms``); the gat cell's case (H*F = 384,
    no bits) makes the kernels line."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import gat_mp as gm
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    perm = g.extras["edge_perm_sender"]
    real = mask != 0
    nodes = torch.arange(n, device=dev)
    no_in = ~torch.isin(nodes, recv[real])
    no_out = ~torch.isin(nodes, send[real])
    no_edge = no_in & no_out
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    ptr_s = segment_offsets(send[perm.long()], n, mask[perm.long()])
    ptr_r = segment_offsets(recv, n, mask)
    lib = load_library("gat_mp")

    def hold_fwd(ins, what):
        """The forward alone: both routes against the plain version (m
        equal), route 1 twice."""
        xl, xr, att, b, _, _ = ins
        h, f = att.shape
        check(lib.hg_gat_fwd_route(h * f, f) == gm.fwd_route(h * f, f) == 1
              and lib.hg_gat_fwd_group(h * f, f) == gm.fwd_group(h * f, f),
              f"{what}: the forward's route or group on the card is not "
              "the plan's route 1")
        with torch.no_grad():
            plain = gm.gat_edge_attention_reference(
                xl, xr, att, send, recv, mask, b, GAT_SLOPE)
            runs = [gm.launch_gat("gat_edge_attention", xl, xr, att, send,
                                  recv, None, ptr_r, b, GAT_SLOPE, route=r)
                    for r in (1, 1, 2)]
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(runs[0], runs[1])),
              f"{what}: the forward (route 1) differs on a second run")
        acc1, m1, d1 = runs[0]
        check(bool((m1[no_in] == -1e9).all()) and bool((d1[no_in] == 0).all())
              and bool((acc1[no_in] == 0).all()),
              f"{what}: the forward (route 1) on a row without a real "
              "incoming edge is not (-1e9, 0, 0)")
        out = {"group": gm.fwd_group(h * f, f)}
        for route, got in ((1, runs[0]), (2, runs[2])):
            check(torch.equal(got[1], plain[1]), f"{what}: the forward "
                  f"(route {route}) has another m than the plain version")
            for name, k, pl in (("acc", got[0], plain[0]),
                                ("d", got[2], plain[2])):
                err = rel_err(torch, k, pl)
                check(err[1] <= REL_TOL_KERNEL, f"{what}: the forward (route "
                      f"{route}) {name} disagrees with its plain version: "
                      f"{err[1]}")
                out[f"route{route}_{name}"] = {"max_abs_err": err[0],
                                               "max_rel_err": err[1]}
        return out

    def hold_pass_s(ins, what):
        """Pass S alone on the forward's m: both routes against the plain
        version, route 1 twice."""
        xl, xr, att, b, ca, cd = ins
        h, f = att.shape
        check(lib.hg_gat_pass_s_route(h * f, f) == gm.pass_s_route(h * f, f)
              == 1, f"{what}: pass S's route on the card is not the "
              "plan's route 1")
        with torch.no_grad():
            _, m, _ = gm.gat_edge_attention_reference(
                xl, xr, att, send, recv, mask, b, GAT_SLOPE)
            runs = [gm.launch_gat("gat_edge_attention_pass_s", xl, xr, att,
                                  send, recv, perm, ptr_s, b, GAT_SLOPE, m,
                                  ca, cd, route=r) for r in (1, 1, 2)]
            plain = gm.gat_pass_s_plain(xl, xr, att, send, recv, mask, b, m,
                                        ca, cd, GAT_SLOPE)
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]),
              f"{what}: pass S (route 1) differs on a second run")
        check(bool((runs[0][no_out] == 0).all()),
              f"{what}: pass S (route 1) wrote a row that sends no real edge")
        out = {}
        for route, got in ((1, runs[0]), (2, runs[2])):
            err = rel_err(torch, got, plain)
            check(err[1] <= REL_TOL_KERNEL, f"{what}: pass S (route {route}) "
                  f"disagrees with its plain version: {err[1]}")
            out[f"route{route}"] = {"max_abs_err": err[0],
                                    "max_rel_err": err[1]}
        return out

    def hold_pass_r(ins, what):
        """Pass R alone on the forward's m: both routes against the plain
        version, route 1 twice."""
        xl, xr, att, b, ca, cd = ins
        h, f = att.shape
        check(lib.hg_gat_pass_r_route(h * f, f) == gm.pass_r_route(h * f, f)
              == 1, f"{what}: pass R's route on the card is not the "
              "plan's route 1")
        with torch.no_grad():
            _, m, _ = gm.gat_edge_attention_reference(
                xl, xr, att, send, recv, mask, b, GAT_SLOPE)
            runs = [gm.launch_gat("gat_edge_attention_pass_r", xl, xr, att,
                                  send, recv, None, ptr_r, b, GAT_SLOPE, m,
                                  ca, cd, route=r) for r in (1, 1, 2)]
            plain = gm.gat_pass_r_plain(xl, xr, att, send, recv, mask, b, m,
                                        ca, cd, GAT_SLOPE)
        torch.cuda.synchronize()
        check(all(torch.equal(a, c) for a, c in zip(runs[0], runs[1])),
              f"{what}: pass R (route 1) differs on a second run")
        check(bool((runs[0][0][no_in] == 0).all()),
              f"{what}: pass R (route 1) wrote a row without a real "
              "incoming edge")
        out = {}
        for route, got in ((1, runs[0]), (2, runs[2])):
            for name, k, pl, tol in zip(("dxr", "datt"), got, plain,
                                        (REL_TOL_KERNEL, REL_TOL_WGRAD)):
                err = rel_err(torch, k, pl)
                check(err[1] <= tol, f"{what}: pass R (route {route}) "
                      f"{name} disagrees with its plain version: {err[1]}")
                out[f"route{route}_{name}"] = {"max_abs_err": err[0],
                                               "max_rel_err": err[1]}
        return out

    def inputs(h, f, bits):
        xl = torch.randn(n, h * f, device=dev, generator=gen)
        xr = torch.randn(n, h * f, device=dev, generator=gen)
        att = torch.randn(h, f, device=dev, generator=gen) / f ** 0.5
        b = None
        if bits:
            b = (torch.rand(e, h, device=dev, generator=gen)
                 < 0.75).float() / 0.75
        ca = torch.randn(n, h * f, device=dev, generator=gen)
        cd = torch.randn(n, h, device=dev, generator=gen)
        return xl, xr, att, b, ca, cd

    def hold(h, f, bits):
        xl, xr, att, b, ca, cd = ins = inputs(h, f, bits)
        what = f"gat (H={h}, F={f}, bits={bits})"

        def run(fn):
            ts = [t.detach().clone().requires_grad_(True)
                  for t in (xl, xr, att)]
            acc, m, d = fn(*ts)
            ((acc * ca).sum() + (d * cd).sum()).backward()
            torch.cuda.synchronize()
            return (acc.detach(), m, d.detach()), [t.grad for t in ts]

        gm.reset_launches()
        (acc, m, d), grads = run(lambda a, c, w: gm.gat_edge_attention(
            a, c, w, send, recv, perm, mask, b, GAT_SLOPE, f))
        check(gm.LAUNCHES == {"gat_edge_attention": 1,
                              "gat_edge_attention_pass_r": 1,
                              "gat_edge_attention_pass_s": 1},
              f"{what} launches {gm.LAUNCHES}")
        (acc_p, m_p, d_p), grads_p = run(
            lambda a, c, w: gm.gat_edge_attention_reference(
                a, c, w, send, recv, mask, b, GAT_SLOPE))
        check(torch.equal(m, m_p), f"{what}: m differs from the plain "
              "version's")
        check(bool((m[no_in] == -1e9).all()) and bool((d[no_in] == 0).all())
              and bool((acc[no_in] == 0).all()),
              f"{what}: a row without a real edge is not (-1e9, 0, 0)")
        check(bool((grads[1][no_in] == 0).all())
              and bool((grads[0][no_edge] == 0).all()),
              f"{what}: a row without a real edge has a gradient")
        errs = {"acc": rel_err(torch, acc, acc_p), "d": rel_err(torch, d, d_p)}
        for name, a, c in zip(("dxl", "dxr", "datt"), grads, grads_p):
            errs[name] = rel_err(torch, a, c)
        for name, (_, rel_e) in errs.items():
            tol = REL_TOL_WGRAD if name == "datt" else REL_TOL_KERNEL
            check(rel_e <= tol, f"{what}: {name} disagrees with the plain "
                  f"version under autograd: {rel_e} > {tol}")
        errs["fwd"] = hold_fwd(ins, what)
        errs["pass_s"] = hold_pass_s(ins, what)
        errs["pass_r"] = hold_pass_r(ins, what)
        return ins, errs

    cases = {}
    for h, f in ((6, 64), (3, 256)):
        for bits in (False, True):
            cases[(h * f, bits)] = hold(h, f, bits)

    e_valid = int(real.sum())
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def launches(ins):
        xl, xr, att, b, ca, cd = ins
        h, f = att.shape
        hf = h * f
        _, m, _ = gm.launch_gat("gat_edge_attention", xl, xr, att, send,
                                recv, None, ptr_r, b, GAT_SLOPE)
        plain = (xl, xr, att, send, recv, mask, b, m, ca, cd, GAT_SLOPE)
        fwd_fl, r_fl, s_fl = gat_flops(hf, h, e_valid)
        # read once: node rows, att, the real edges' ids (and bits),
        # row_ptr; written once: the outputs
        rows, heads = 4 * n * hf, 4 * n * h
        common = 4 * hf + 4 * e_valid + 4 * (n + 1) + (
            0 if b is None else 4 * e_valid * h)
        return {
            "gat_edge_attention": (
                lambda: gm.launch_gat("gat_edge_attention", xl, xr, att,
                                      send, recv, None, ptr_r, b,
                                      GAT_SLOPE),
                lambda: gm.gat_edge_attention_reference(
                    xl, xr, att, send, recv, mask, b, GAT_SLOPE),
                bound(common + 3 * rows + 2 * heads, fwd_fl),
                "hydragnn_tpu/ops/gat_mp.py:259", ("acc", "d")),
            "gat_edge_attention_pass_r": (
                lambda: gm.launch_gat("gat_edge_attention_pass_r", xl, xr,
                                      att, send, recv, None, ptr_r, b,
                                      GAT_SLOPE, m, ca, cd),
                lambda: gm.gat_pass_r_plain(*plain),
                bound(common + 4 * rows + 2 * heads + 4 * hf, r_fl),
                "hydragnn_tpu/ops/gat_mp.py:543", ("dxr", "datt")),
            "gat_edge_attention_pass_s": (
                lambda: gm.launch_gat("gat_edge_attention_pass_s", xl, xr,
                                      att, send, recv, perm, ptr_s, b,
                                      GAT_SLOPE, m, ca, cd),
                lambda: gm.gat_pass_s_plain(*plain),
                bound(common + 4 * e_valid + 4 * rows + 2 * heads, s_fl),
                "hydragnn_tpu/ops/gat_mp.py:594", ("dxl",)),
        }

    def route2(ins, op):
        """The first design of the forward, pass R or pass S (``op``) at
        these inputs."""
        xl, xr, att, b, ca, cd = ins
        if op == "gat_edge_attention":
            return lambda: gm.launch_gat(op, xl, xr, att, send, recv, None,
                                         ptr_r, b, GAT_SLOPE, route=2)
        _, m, _ = gm.launch_gat("gat_edge_attention", xl, xr, att, send,
                                recv, None, ptr_r, b, GAT_SLOPE)
        s_ = op == "gat_edge_attention_pass_s"
        return lambda: gm.launch_gat(op, xl, xr, att, send, recv,
                                     perm if s_ else None,
                                     ptr_s if s_ else ptr_r, b, GAT_SLOPE, m,
                                     ca, cd, route=2)

    results = []
    ins, errs = cases[(384, False)]
    for name, (kern, plain, (b_ms, b_by), replaces, outs) in launches(
            ins).items():
        worst = max(outs, key=lambda o: errs[o][1])
        results.append({
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/gat_mp.cu", "replaces": replaces,
            "max_abs_err": errs[worst][0], "max_rel_err": errs[worst][1],
            "ms": time_ms(torch, kern, flush, lead=True),
            "warm_l2_ms": time_ms(torch, kern, lead=True),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
            "shape": {"N": n, "E": e, "E_valid": e_valid, "H": 6, "F": 64,
                      "bits": False}})
        results[-1]["kernel_route"] = gm.lane_route(384, 64)
        results[-1]["route2_ms"] = time_ms(torch, route2(ins, name), flush,
                                           lead=True)
        if name == "gat_edge_attention":
            results[-1]["fwd_group"] = gm.fwd_group(384, 64)
    notes = {"rows_without_real_in_edge": int(no_in.sum()),
             "rows_without_real_out_edge": int(no_out.sum())}
    for (hf, bits), (case_ins, case_errs) in cases.items():
        timed = results if (hf, bits) == (384, False) else [
            {"name": name, "ms": time_ms(torch, kern, flush, lead=True),
             "plain_ms": time_ms(torch, plain, flush, reps=10),
             "bound_ms": b_ms, "bound_by": b_by}
            for name, (kern, plain, (b_ms, b_by), _, _) in launches(
                case_ins).items()]
        if (hf, bits) != (384, False):
            for t_ in timed:
                t_["route2_ms"] = time_ms(torch, route2(case_ins, t_["name"]),
                                          flush, lead=True)
        case_errs = dict(case_errs)
        fwd = case_errs.pop("fwd")
        pass_s = case_errs.pop("pass_s")
        pass_r = case_errs.pop("pass_r")
        notes[f"HF{hf}_{'bits' if bits else 'ones'}"] = {
            "errors": {k: {"max_abs_err": a, "max_rel_err": r}
                       for k, (a, r) in case_errs.items()},
            "fwd_routes": fwd,
            "pass_s_routes": pass_s,
            "pass_r_routes": pass_r,
            "timing": {t["name"]: {k: t[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "route2_ms")
                if k in t} for t in timed}}
    return results, notes


def cgcnn_config(epochs=TRAIN_EPOCHS, perc_train=0.5):
    """The arch sweep's CGCNN (bench.py:160-215: input = hidden = 64, 4
    convs, radius 1.8, max_neighbours 20, graph head (2, 64, 2, (64, 64)),
    no edge features) on the synthetic BCC set at batch 512, AdamW 1e-3.
    CGConv keeps the input width, so the 64 input columns are the set's
    node feature and CGCNN_EXTRA_COLUMNS seeded per-node columns that
    ``write_cgcnn_data`` adds, each a node feature of width 1 selected by
    ``input_node_features``."""
    cfg = flagship_config(perc_train=perc_train, epochs=epochs,
                          model_type="CGCNN")
    ds = cfg["Dataset"]
    ds["name"] = "chip_smoke_cgcnn"
    ds["path"] = {"total": CGCNN_DATA}
    extra = [f"c{i}" for i in range(CGCNN_EXTRA_COLUMNS)]
    ds["node_features"] = {
        "name": ["x", "x2", "x3"] + extra,
        "dim": [1] * (3 + len(extra)),
        "column_index": [0, 6, 7] + list(range(8, 8 + len(extra)))}
    nn_ = cfg["NeuralNetwork"]
    for k in ("num_gaussians", "num_filters"):
        del nn_["Architecture"][k]
    nn_["Variables_of_interest"]["input_node_features"] = (
        [0] + list(range(3, 3 + len(extra))))
    return cfg


def dimenet_config(epochs=TRAIN_EPOCHS, perc_train=0.5):
    """The arch sweep's DimeNet (bench.py:199-223: hidden 64, 4 convs,
    num_radial 6, num_spherical 7, basis_emb_size 8, int_emb_size 64,
    out_emb_size 64, one residual layer before the skip, two after,
    envelope exponent 5, radius 1.8, max_neighbours 20, graph head (2, 64,
    2, (64, 64))) on the dimenet cell's set (``write_dimenet_data``) at
    batch 512, AdamW 1e-3."""
    cfg = flagship_config(perc_train=perc_train, epochs=epochs,
                          model_type="DimeNet")
    ds = cfg["Dataset"]
    ds["name"] = "chip_smoke_dimenet"
    ds["path"] = {"total": DIMENET_DATA}
    arch = cfg["NeuralNetwork"]["Architecture"]
    for k in ("num_gaussians", "num_filters"):
        del arch[k]
    arch.update({"num_radial": 6, "num_spherical": 7, "basis_emb_size": 8,
                 "int_emb_size": 64, "out_emb_size": 64,
                 "num_before_skip": 1, "num_after_skip": 2,
                 "envelope_exponent": 5})
    return cfg


def dimenet_wide_config(epochs=TRAIN_EPOCHS, perc_train=0.5):
    """DimeNet++'s published QM9 widths (Gasteiger et al. 2020; PyG's
    ``DimeNetPlusPlus.from_qm9_pretrained``: hidden 128, out_emb_size 256,
    basis_emb_size 8, num_spherical 7, num_radial 6, 4 blocks, one residual
    layer before the skip and two after, envelope exponent 5) with
    int_emb_size doubled from 64 to 128, the builder's limit
    (TRI_EMB_LIMIT): past the factored kernel's gate, so every interaction
    takes the builder-backed triplet op.  The dimenet cell's set, graph
    head, radius, batch and optimizer."""
    cfg = dimenet_config(epochs=epochs, perc_train=perc_train)
    cfg["NeuralNetwork"]["Architecture"].update(
        {"hidden_dim": 128, "out_emb_size": 256, "int_emb_size": 128})
    return cfg


def write_dimenet_data(seed, count=None):
    """The dimenet cell's LSMS files: ``count`` (default N_CONFIGURATIONS)
    BCC cells of 2-3 x 2-3 x 1 unit cells from the port's generator."""
    from hydragnn_torch.data.synthetic import deterministic_graph_data

    deterministic_graph_data(
        DIMENET_DATA,
        number_configurations=N_CONFIGURATIONS if count is None else count,
        unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
        unit_cell_z_range=(1, 2), seed=seed)


def write_cgcnn_data(src, dst, seed, count=None):
    """The CGCNN cell's LSMS files: the first ``count`` (default
    N_CONFIGURATIONS, the whole set) files of ``src`` (the synthetic BCC set) with
    CGCNN_EXTRA_COLUMNS seeded uniform columns appended to every node row
    (the loader reads node features by column)."""
    import numpy as np

    rng = np.random.RandomState(seed + 11)
    os.makedirs(dst, exist_ok=True)
    for i in range(N_CONFIGURATIONS if count is None else count):
        name = f"output{i}.txt"
        with open(os.path.join(src, name), encoding="utf-8") as f:
            lines = f.read().splitlines()
        rows = [l for l in lines[1:] if l.strip()]
        cols = rng.rand(len(rows), CGCNN_EXTRA_COLUMNS)
        out = [lines[0]] + [
            r + "\t" + "\t".join(f"{v:.6f}" for v in c)
            for r, c in zip(rows, cols)]
        with open(os.path.join(dst, name), "w", encoding="utf-8") as f:
            f.write("\n".join(out) + "\n")


def cgcnn_flops(f, d, a, edges, nodes):
    """Floating-point operations (a multiply-add is two; sigmoid, softplus
    and their derivatives not counted) that the three cgcnn kernels'
    functions need on ``edges`` real edges and ``nodes`` real nodes:
    (forward, pass P, pass S).  The products with x factor to the nodes
    (x[r] @ Wfr = (x @ Wfr)[r], four such blocks; dWfr = x^T (the dtf
    summed per receiver); dx_r = (the dtf summed per receiver) @ Wfr^T),
    so they count once per node; per edge: the edge-attribute products,
    the sums that join the parts of tf and ts, sigmoid * softplus and the
    row sum, and in the backward dtf, dts, the edge-attribute weight
    gradients and d edge_attr.  Pass S reads pass P's node table (the
    backward hands it over), so its count holds the per-edge work and the
    row product ``[sum dtf | sum dts] @ [Wfs | Wss]^T`` per node, not the
    table's products."""
    fwd_e = 2 * 2 * a * d + 4 * d + 2 * d
    back_e = 6 * d
    fwd_n = 4 * 2 * f * d
    fwd = edges * fwd_e + nodes * fwd_n
    # pass P: + the x weight grads (4 blocks) and dx_r (2 blocks) at the
    # nodes; per edge + dWfg, dWsg, dbf, dbs and d edge_attr
    pass_p = (edges * (fwd_e + back_e + 2 * 2 * a * d + 2 * d + 2 * 2 * a * d)
              + nodes * (fwd_n + 4 * 2 * f * d + 2 * 2 * f * d))
    pass_s = edges * (fwd_e + back_e) + nodes * 2 * 2 * f * d
    return fwd, pass_p, pass_s


def cgcnn_phase(torch, g, seed):
    """The three cgcnn kernels at the first train batch of the cgcnn cell,
    on its own edges, in three instantiations: the path's own (F = D = 64,
    no edge attributes), F = 24, A = 5, D = 16 (the widths of
    tests/test_fused_block.py:641, which catch transposed blocks) and F =
    D = 256 (the limit: weights read from L2).  Each through the op's
    autograd Function against autograd through the composed plain
    version: forward, dx and d edge_attr 1e-5 of their largest entry, the
    edge-summed weight and bias grads 1e-4; d edge_attr exactly zero on
    masked edges.  Pass S alone in each, on pass P's node table: 1e-5 of
    the plain version's largest entry, within a float64 run's bound and
    bit-identical twice.  Then each kernel timed alone as the path
    launches it (F = D = 64; pass S on the table pass P wrote), beside its
    plain version and its bound."""
    from hydragnn_torch.ops import cgcnn_mp as cg
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    gen = torch.Generator(device=dev).manual_seed(seed + 5)
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    perm = g.extras["edge_perm_sender"]
    em = mask.to(torch.int32)
    real = mask != 0
    names = ("x", "edge_attr", "kf", "bf", "ks", "bs")
    p_ = perm.long()
    ptr_r = segment_offsets(recv, n, em)
    ptr_s = segment_offsets(send[p_], n, em[p_])

    def pass_s_table(f, a, ins, ct):
        """The kernel weights and the node table a pass-P launch writes,
        as the backward hands it to pass S."""
        d = ins[2].shape[1]
        ws = cg.kernel_weights(*ins[2:], f, a, dev)
        table = torch.empty((n, 4 * d), device=dev)
        with torch.no_grad():
            cg.launch_cgcnn("cgcnn_block_pass_p", ins[0], ins[1], ws, send,
                            recv, None, ptr_r, ct, want_dx=False,
                            table=table)
        return ws, table

    def hold_pass_s(f, a, ins, ct, what):
        """Pass S alone, twice, against the plain version (1e-5) and a
        float64 run of it."""
        ws, table = pass_s_table(f, a, ins, ct)
        with torch.no_grad():
            runs = [cg.launch_cgcnn("cgcnn_block_pass_s", ins[0], ins[1], ws,
                                    send, recv, perm, ptr_s, ct, table=table)
                    for _ in range(2)]
            p32 = cg.cgcnn_pass_s_plain(ins[0], ins[1], em, *ins[2:], send,
                                        recv, ct)
            p64 = cg.cgcnn_pass_s_plain(
                *(None if t is None else t.double() for t in ins[:2]), em,
                *(t.double() for t in ins[2:]), send, recv, ct.double())
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]),
              f"{what}: pass S differs on a second run")
        err = rel_err(torch, runs[0], p32)
        check(err[1] <= REL_TOL_KERNEL, f"{what}: pass S disagrees with its "
              f"plain version: {err[1]}")
        e32 = float((p32.double() - p64).abs().max())
        e_k = float((runs[0].double() - p64).abs().max())
        allowed = max(2 * e32, 1e-6 * float(p64.abs().max()))
        check(e_k <= allowed, f"{what}: pass S is {e_k} from the float64 "
              f"run, over {allowed}")
        return {"max_abs_err": err[0], "max_rel_err": err[1],
                "vs_float64": e_k, "plain_float32_vs_float64": e32,
                "float64_allowed": allowed}

    def inputs(f, a, d):
        def w(rows):
            # [in, out] as the model passes it: Linear.weight.t(), a view
            return (torch.randn(d, rows, device=dev, generator=gen)
                    / rows ** 0.5).t()

        return [torch.randn(n, f, device=dev, generator=gen),
                (torch.randn(e, a, device=dev, generator=gen) * 0.5
                 if a else None),
                w(2 * f + a), torch.randn(d, device=dev, generator=gen) * 0.1,
                w(2 * f + a), torch.randn(d, device=dev, generator=gen) * 0.1]

    def hold(f, a, d):
        ins = inputs(f, a, d)
        ct = torch.randn(n, d, device=dev, generator=gen)
        what = f"cgcnn (F={f}, A={a}, D={d})"

        def run(fn):
            ts = [None if t is None else t.detach().clone().requires_grad_(
                True) for t in ins]
            out = fn(ts[0], ts[1], em, *ts[2:], send, recv)
            (out * ct).sum().backward()
            torch.cuda.synchronize()
            return out.detach(), [None if t is None else t.grad for t in ts]

        cg.reset_launches()
        k_out, k_grads = run(lambda *a_: cg.cgcnn_gated_block(*a_, perm))
        check(cg.LAUNCHES == {"cgcnn_block": 1, "cgcnn_block_pass_p": 1,
                              "cgcnn_block_pass_s": 1},
              f"{what} launches {cg.LAUNCHES}")
        p_out, p_grads = run(cg.cgcnn_block_reference)
        errs = {"out": rel_err(torch, k_out, p_out)}
        for name, k_, p_ in zip(names, k_grads, p_grads):
            if k_ is None:
                continue
            if name == "edge_attr":
                check(bool((k_[~real] == 0).all()),
                      f"{what}: d edge_attr is not zero on masked edges")
                k_, p_ = k_[real], p_[real]
            errs["d" + name] = rel_err(torch, k_, p_)
        for name, (_, rel_e) in errs.items():
            tol = REL_TOL_KERNEL if name in ("out", "dx", "dedge_attr") \
                else REL_TOL_WGRAD
            check(rel_e <= tol, f"{what}: {name} disagrees with the plain "
                  f"version under autograd: {rel_e} > {tol}")
        pass_s_notes[f"F{f}_A{a}_D{d}"] = hold_pass_s(f, a, ins, ct, what)
        return ins, ct, errs

    def worst_of(errs):
        k = max(errs, key=lambda o: errs[o][1])
        return {"worst": k, "max_abs_err": errs[k][0],
                "max_rel_err": errs[k][1]}

    f = d = FEATURES
    pass_s_notes = {}
    ins, ct, errs = hold(f, 0, d)
    _, _, errs_small = hold(24, 5, 16)
    _, _, errs_wide = hold(CGCNN_LIMIT, 0, CGCNN_LIMIT)

    e_valid = int(real.sum())
    n_valid = int((g.node_mask != 0).sum())
    x = ins[0]
    ws, table = pass_s_table(f, 0, ins, ct)
    plain_args = (x, None, em, *ins[2:], send, recv, ct)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    with torch.no_grad():
        once = [cg.launch_cgcnn("cgcnn_block", x, None, ws, send, recv, None,
                                ptr_r) for _ in range(2)]
    check(torch.equal(*once), "cgcnn forward: a second run differs")
    fwd_fl, p_fl, s_fl = cgcnn_flops(f, d, 0, e_valid, n_valid)
    wbytes = 4 * sum(t.numel() for t in ws if t is not None)
    # read once: x, the real edges' ids (send, recv), row_ptr, the
    # weights; the backward also the cotangent [N, D]
    edge_in = 4 * (n * f + 2 * e_valid + n + 1) + wbytes
    # pass S reads the node table, the cotangent, the real edges' ids
    # (perm, recv), row_ptr, the biases, Wfs and Wss, and writes dx
    s_in = 4 * (n * 4 * d + n * d + 2 * e_valid + n + 1 + 2 * d
                + 2 * f * d)
    launches = {
        "cgcnn_block": (
            lambda: cg.launch_cgcnn("cgcnn_block", x, None, ws, send, recv,
                                    None, ptr_r),
            lambda: cg.cgcnn_block_reference(x, None, em, *ins[2:], send,
                                             recv),
            # the node table's products on the tensor cores (3xTF32)
            tensor_core_bounds(edge_in + 4 * n * d, fwd_fl),
            "hydragnn_tpu/ops/fused_block.py:495", ("out",)),
        "cgcnn_block_pass_p": (
            lambda: cg.launch_cgcnn("cgcnn_block_pass_p", x, None, ws, send,
                                    recv, None, ptr_r, ct, want_dx=True),
            lambda: cg.cgcnn_pass_p_plain(*plain_args),
            tensor_core_bounds(edge_in + 4 * n * d + 4 * n * f + wbytes,
                               p_fl),
            "hydragnn_tpu/ops/fused_block.py:561",
            ("dkf", "dbf", "dks", "dbs")),
        "cgcnn_block_pass_s": (
            lambda: cg.launch_cgcnn("cgcnn_block_pass_s", x, None, ws, send,
                                    recv, perm, ptr_s, ct, table=table),
            lambda: cg.cgcnn_pass_s_plain(*plain_args),
            # the row product on the tensor cores (3xTF32)
            tensor_core_bounds(s_in + 4 * n * f, s_fl),
            "hydragnn_tpu/ops/fused_block.py:599", ("dx",)),
    }
    results = []
    for name, (kern, plain, bnd, replaces, outs) in launches.items():
        worst = max(outs, key=lambda o: errs[o][1])
        results.append({
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/cgcnn_mp.cu", "replaces": replaces,
            "max_abs_err": errs[worst][0], "max_rel_err": errs[worst][1],
            "ms": time_ms(torch, kern, flush, lead=True),
            "warm_l2_ms": time_ms(torch, kern, lead=True),
            "plain_ms": time_ms(torch, plain, flush),
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "shape": {"N": n, "N_valid": n_valid, "E": e,
                      "E_valid": e_valid, "F": f, "D": d, "A": 0},
        })
        if len(bnd) == 3:
            results[-1]["bound_ms_cuda_cores"] = bnd[2]
    notes = {k: {"max_abs_err": a, "max_rel_err": r}
             for k, (a, r) in errs.items()}
    notes["F24_A5_D16"] = worst_of(errs_small)
    notes[f"F{CGCNN_LIMIT}"] = worst_of(errs_wide)
    notes["pass_s"] = pass_s_notes
    return results, notes


def dimenet_flops(s, r, b, d, din, h, n_before, n_after, triplets, rows):
    """Floating-point operations (a multiply-add is two; silu and its
    derivative not counted) that the DimeNet kernels' functions need: the
    triplet op forward on ``triplets`` real triplets, the row-MLP chain
    forward and backward on ``rows`` rows.  Per triplet the forward forms
    sbf (S*R products), emb1 and emb2 and adds x2 * emb2.  Per row the
    chain's L dense layers, the residual adds; the backward three times the
    products (recompute, the input gradient, the weight gradient).  The
    triplet backward: ``dimenet_tri_bwd_flops``."""
    sr = s * r
    prod = 2 * sr * b + 2 * b * d
    tri_f = triplets * (sr + prod + 2 * d)
    layers = 2 + 2 * (n_before + n_after)
    mm = 2 * (din * h + (layers - 1) * h * h)
    adds = h * (2 + n_before + n_after)
    return tri_f, rows * (mm + adds), rows * (3 * mm + 2 * adds)


def dimenet_tri_bwd_flops(s, r, b, d, triplets, rows, want):
    """Operations of the triplet backward for the outputs ``want`` (d
    radial, d x2, d cbf, the weights) on ``triplets`` real triplets whose
    ``rows`` distinct kj rows hold them: (the factored work of
    csrc/dn_tri.cu, the unfactored per-triplet work of the first design).
    Factored: per triplet G += cbf * g (2 S D), and d_cbf = g . (x2 * Q)
    when asked (2 S D); per row P (2 S R B), Q (2 S B D), d_x2 (2 S D), U
    (S D), Hk (2 S D B), dW2 (2 S B D), dW1 (2 S R B), and when asked
    x2 * Q for d_cbf (S D) and d_radial (2 S R B).  Unfactored, per
    triplet: sbf, emb1, emb2, d_emb2 and the d_x2 term, d_emb1, d_sbf,
    both weight gradients, d_cbf and the d_radial term."""
    sr = s * r
    per_t = 2 * s * d * (2 if want[2] else 1)
    per_row = (2 * sr * b + 2 * s * b * d + 2 * s * d + s * d
               + 2 * s * d * b + 2 * s * b * d + 2 * sr * b
               + (s * d if want[2] else 0) + (2 * sr * b if want[0] else 0))
    prod = 2 * sr * b + 2 * b * d
    old = triplets * (sr + prod + 2 * d + prod + prod + 4 * sr + d + sr)
    return triplets * per_t + rows * per_row, old


def dimenet_phase(torch, g, seed, cfg):
    """The four DimeNet kernels at the first train batch of the dimenet
    cell, at its widths: the triplet op (forward, backward) on the batch's
    own triplet table and spherical basis, and the row-MLP chain (forward,
    backward) on its edge rows.  Each through the op's autograd Function
    against autograd through the composed plain version: outputs and the
    per-edge and per-triplet gradients 1e-5 of their largest entry, the
    weight and bias grads (sums over ~5e5 triplets or ~1e5 rows in another
    order) 1e-4; d cbf exactly zero on masked triplets.  Then the triplet
    backward launched alone as the path launches it (d x2 and the
    weights: radial and cbf come from pos) and with all four outputs, each
    output against the plain version; then each kernel timed alone as the
    path launches it, the triplet backward also with all four outputs,
    beside its plain version and its bound (the row_mlp backward's route
    1 and the triplet forward's at the 3xTF32 rate, the CUDA-core bound
    beside them).  The triplet forward's route is the card's and the
    plan's (route 1 at the path's widths); as the path launches it, its
    output lies within twice the float32 plain version's error of a
    float64 run (or 1e-6 of the largest entry), a second launch is
    bit-identical, and the first design (route 2) is held to the plain
    version and timed beside it (``route2_ms``).  The row_mlp forward
    likewise: its route the card's and the plan's (route 1 on the tensor
    cores at the path's widths), as the path launches it within twice the
    float32 plain version's error of a float64 run (or 1e-6 of the largest
    entry) and bit-identical on a second launch, its first design held to
    the plain version and timed beside it (``route2_ms``); its row carries
    the 3xTF32 bound and the CUDA-core bound beside it."""
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.models.dimenet import (
        distances_and_angles,
        spherical_basis_factors,
    )
    from hydragnn_torch.ops import dn_tri as dt
    from hydragnn_torch.ops import row_mlp as rm
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    ex = g.extras
    e = g.num_edges
    s, r = cfg.num_spherical, cfg.num_radial
    b, d, h = cfg.basis_emb_size, cfg.int_emb_size, cfg.hidden_dim
    nb, na = cfg.num_before_skip, cfg.num_after_skip
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    kj, ji, perm = ex["dn_idx_kj"], ex["dn_idx_ji"], ex["dn_perm_kj"]
    tm = ex["dn_triplet_mask"].to(torch.int32)
    t = kj.shape[0]
    with torch.no_grad():
        dist, angle = distances_and_angles(g.pos, g, cfg.radius)
        radial, cbf = spherical_basis_factors(
            dist / cfg.radius, angle, s, r, cfg.envelope_exponent)
    radial, cbf = radial.contiguous(), cbf.contiguous()

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    tri_ins = [radial, rnd(e, d), cbf, rnd(s * r, b, scale=(s * r) ** -0.5),
               rnd(b, d, scale=b ** -0.5)]
    ct = rnd(e, d)
    real = tm != 0
    errs = {}

    def run(fn, ins):
        ts = [x.detach().clone().requires_grad_(True) for x in ins]
        out = fn(*ts)
        (out * ct).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), [x.grad for x in ts]

    def hold(name, got, want, tol):
        errs[name] = rel_err(torch, got, want)
        check(errs[name][1] <= tol, f"dimenet: {name} disagrees with the "
              f"plain version under autograd: {errs[name][1]} > {tol}")

    dt.reset_launches()
    k_out, k_grads = run(lambda *a: dt.dimenet_triplet_mp(
        *a, kj, ji, tm, perm, r), tri_ins)
    check({k: v for k, v in dt.LAUNCHES.items() if v}
          == {"dimenet_triplet_mp": 1, "dimenet_triplet_mp_bwd": 1},
          f"dn_tri launches {dt.LAUNCHES}")
    p_out, p_grads = run(lambda *a: dt.dimenet_triplet_reference(
        *a, kj, ji, tm, r), tri_ins)
    check(bool((k_grads[2][~real] == 0).all()),
          "dimenet: d cbf is not zero on masked triplets")
    hold("tri_out", k_out, p_out, REL_TOL_KERNEL)
    for name, kg, pg in zip(("radial", "x2", "cbf", "w1", "w2"), k_grads,
                            p_grads):
        hold("tri_d" + name, kg, pg,
             REL_TOL_KERNEL if name in ("radial", "x2", "cbf")
             else REL_TOL_WGRAD)

    wb = [rnd(d, h, scale=d ** -0.5), None]
    for _ in range(2 * (nb + na) + 1):
        wb += [rnd(h, h, scale=h ** -0.5), rnd(h, scale=0.1)]
    row_ins = [rnd(e, d), rnd(e, h), rnd(e, h)]
    ct_h = rnd(e, h)

    def run_rows(fn):
        ti = [x.detach().clone().requires_grad_(True) for x in row_ins]
        tw = [None if w is None else w.detach().clone().requires_grad_(True)
              for w in wb]
        out = fn(*ti, nb, na, *tw)
        (out * ct_h).sum().backward()
        torch.cuda.synchronize()
        return out.detach(), [x.grad for x in ti], [
            w.grad for w in tw if w is not None]

    rm.reset_launches()
    k_out, k_in, k_w = run_rows(rm.dimenet_post_mlp)
    check(rm.LAUNCHES == {"dimenet_post_mlp": 1, "dimenet_post_mlp_bwd": 1},
          f"row_mlp launches {rm.LAUNCHES}")
    p_out, p_in, p_w = run_rows(rm.dimenet_post_mlp_reference)
    hold("row_out", k_out, p_out, REL_TOL_KERNEL)
    for name, kg, pg in zip(("tri", "x_ji", "x_edge"), k_in, p_in):
        hold("row_d" + name, kg, pg, REL_TOL_KERNEL)
    worst_w = max(rel_err(torch, kg, pg)[1] for kg, pg in zip(k_w, p_w))
    check(worst_w <= REL_TOL_WGRAD,
          f"dimenet: a row-MLP weight grad disagrees: {worst_w}")
    errs["row_dwb"] = max((rel_err(torch, kg, pg) for kg, pg in
                           zip(k_w, p_w)), key=lambda v: v[1])

    # each kernel alone on its precomputed schedule, as the path launches it
    e_real = int((g.edge_mask != 0).sum())
    t_real = int(real.sum())
    n_real = int((g.node_mask != 0).sum())
    kj_rows = int(torch.unique(kj[real]).numel())
    p_ = perm.long()
    ptr_ji = segment_offsets(ji, e, tm)
    ptr_kj = segment_offsets(kj[p_], e, tm[p_])
    x2, w1, w2 = tri_ins[1], tri_ins[3], tri_ins[4]
    w_p, b_p = rm.pack_weights(wb, d, h, dev)
    tri, xji, xe = row_ins

    # the triplet backward as the path launches it (radial and cbf come
    # from pos, which needs no gradient: d x2 and the weights) and with all
    # four outputs, each output against the plain version
    plain_b = dt.dimenet_triplet_bwd_plain(radial, x2, cbf, w1, w2, kj, ji,
                                           tm, ct, r)
    tri_bwd_want = {"path": (False, True, False, True), "all": (True,) * 4}

    def tri_bwd(want):
        return dt.launch_dn_tri("dimenet_triplet_mp_bwd", radial, x2, cbf, w1,
                                w2, kj, ji, perm, ptr_kj, r, ct, want=want)

    with torch.no_grad():
        for tag, want in tri_bwd_want.items():
            got = tri_bwd(want)
            torch.cuda.synchronize()
            for o, name in enumerate(("dradial", "dx2", "dcbf", "dw1",
                                      "dw2")):
                if not want[min(o, 3)]:
                    check(got[o] is None, f"dimenet: the triplet backward "
                          f"({tag}) formed {name} unasked")
                    continue
                hold(f"tri_{tag}_{name}", got[o], plain_b[o],
                     REL_TOL_WGRAD if o > 2 else REL_TOL_KERNEL)
            if want[2]:
                check(bool((got[2][~real] == 0).all()), "dimenet: the "
                      "triplet backward's d cbf is not zero on masked "
                      "triplets")
    # the triplet forward's route, its float64 yardstick and repeat, and
    # its first design at the path's inputs
    fwd_route = load_library("dn_tri").hg_dn_tri_fwd_route(s, s * r, b, d)
    check(fwd_route == dt.fwd_route(s, s * r, b, d) == 1,
          f"dn_tri forward at {(s, s * r, b, d)}: route {fwd_route} on the "
          f"card, {dt.fwd_route(s, s * r, b, d)} planned, the path's route "
          "is 1")

    def tri_fwd(route_=0):
        return dt.launch_dn_tri("dimenet_triplet_mp", radial, x2, cbf, w1,
                                w2, kj, ji, None, ptr_ji, r, route=route_)

    with torch.no_grad():
        k1, again, k2 = tri_fwd(), tri_fwd(), tri_fwd(2)
        torch.cuda.synchronize()
        check(torch.equal(k1, again), "dimenet: a second launch of the "
              "triplet forward differs")
        p32 = dt.dimenet_triplet_reference(radial, x2, cbf, w1, w2, kj, ji,
                                           tm, r)
        p64 = dt.dimenet_triplet_reference(
            radial.double(), x2.double(), cbf.double(), w1.double(),
            w2.double(), kj, ji, tm, r)
        e32 = float((p32.double() - p64).abs().max())
        e_k = float((k1.double() - p64).abs().max())
        allowed = max(2 * e32, 1e-6 * float(p64.abs().max()))
        check(e_k <= allowed, f"dimenet: the triplet forward (route 1) is "
              f"{e_k} from the float64 run, over {allowed}")
        hold("tri_out_route2", k2, p32, REL_TOL_KERNEL)
        tri_yard = {"vs_float64": e_k, "plain_float32_vs_float64": e32,
                    "float64_allowed": allowed}
        del p32, p64
    # the row_mlp forward's route, its float64 yardstick and repeat, and
    # its first design at the path's inputs
    row_fwd_route = load_library("row_mlp").hg_row_mlp_fwd_route(d, h, nb, na)
    check(row_fwd_route == rm.fwd_route(d, h, nb, na) == 1,
          f"row_mlp forward at {(d, h, nb, na)}: route {row_fwd_route} on "
          f"the card, {rm.fwd_route(d, h, nb, na)} planned, the path's route "
          "is 1")

    def row_fwd(route_=0):
        return rm.launch_row_mlp("dimenet_post_mlp", tri, xji, xe, w_p, b_p,
                                 nb, na, route=route_)

    with torch.no_grad():
        k1, again, k2 = row_fwd(), row_fwd(), row_fwd(2)
        torch.cuda.synchronize()
        check(torch.equal(k1, again), "dimenet: a second launch of the "
              "row_mlp forward differs")
        p32 = rm.dimenet_post_mlp_reference(tri, xji, xe, nb, na, *wb)
        p64 = rm.dimenet_post_mlp_reference(
            tri.double(), xji.double(), xe.double(), nb, na,
            *[None if w is None else w.double() for w in wb])
        e32 = float((p32.double() - p64).abs().max())
        e_k = float((k1.double() - p64).abs().max())
        allowed = max(2 * e32, 1e-6 * float(p64.abs().max()))
        check(e_k <= allowed, f"dimenet: the row_mlp forward (route 1) is "
              f"{e_k} from the float64 run, over {allowed}")
        hold("row_out_route1", k1, p32, REL_TOL_KERNEL)
        hold("row_out_route2", k2, p32, REL_TOL_KERNEL)
        row_yard = {"vs_float64": e_k, "plain_float32_vs_float64": e32,
                    "float64_allowed": allowed}
        del p32, p64
    route = rm.bwd_route(d, h, nb, na)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    tri_f, row_f, row_b = dimenet_flops(s, r, b, d, d, h, nb, na, t_real, e)
    tri_b = {tag: dimenet_tri_bwd_flops(s, r, b, d, t_real, kj_rows, want)
             for tag, want in tri_bwd_want.items()}
    wt = 4 * (s * r * b + b * d)
    # read once: the real edges' radial and x2 rows, the real triplets'
    # cbf rows and ids, row_ptr, the weights; written once: the outputs
    tri_in = 4 * (e_real * (s * r + d) + t_real * (s + 2) + e + 1) + wt
    # the backward also reads perm and the cotangent rows; it writes d x2
    # and the weight gradients, and with all outputs d radial and d cbf
    tri_b_bytes = {
        "path": tri_in + 4 * (t_real + e_real * d) + 4 * e * d + wt,
        "all": tri_in + 4 * (t_real + e_real * d)
        + 4 * (e * (s * r + d) + t * s) + wt}
    row_w = 4 * (w_p.numel() + b_p.numel())
    tri_b_outs = {tag: tuple(f"tri_{tag}_{n}" for o, n in enumerate(
        ("dradial", "dx2", "dcbf", "dw1", "dw2")) if want[min(o, 3)])
        for tag, want in tri_bwd_want.items()}
    timed = {
        # route 1 runs its products on the tensor cores (3xTF32)
        "dimenet_triplet_mp": (
            tri_fwd,
            lambda: dt.dimenet_triplet_reference(radial, x2, cbf, w1, w2,
                                                 kj, ji, tm, r),
            tensor_core_bounds(tri_in + 4 * e * d, tri_f),
            "hydragnn_tpu/ops/dn_tri.py:285", "dn_tri", ("tri_out",)),
        "dimenet_triplet_mp_bwd": (
            lambda: tri_bwd(tri_bwd_want["path"]),
            lambda: dt.dimenet_triplet_bwd_plain(radial, x2, cbf, w1, w2, kj,
                                                 ji, tm, ct, r),
            bound(tri_b_bytes["path"], tri_b["path"][0]),
            "hydragnn_tpu/ops/dn_tri.py:358", "dn_tri", tri_b_outs["path"]),
        "dimenet_triplet_mp_bwd:all_outputs": (
            lambda: tri_bwd(tri_bwd_want["all"]),
            lambda: dt.dimenet_triplet_bwd_plain(radial, x2, cbf, w1, w2, kj,
                                                 ji, tm, ct, r),
            bound(tri_b_bytes["all"], tri_b["all"][0]),
            "hydragnn_tpu/ops/dn_tri.py:358", "dn_tri", tri_b_outs["all"]),
        # route 1 runs its products on the tensor cores (3xTF32)
        "dimenet_post_mlp": (
            row_fwd,
            lambda: rm.dimenet_post_mlp_reference(tri, xji, xe, nb, na,
                                                  *wb),
            tensor_core_bounds(4 * e * (d + 2 * h) + row_w + 4 * e * h,
                               row_f),
            "hydragnn_tpu/ops/row_mlp.py:184", "row_mlp", ("row_out",)),
        "dimenet_post_mlp_bwd": (
            lambda: rm.launch_row_mlp("dimenet_post_mlp_bwd", tri, xji, xe,
                                      w_p, b_p, nb, na, ct_h),
            lambda: rm.dimenet_post_mlp_bwd_plain(tri, xji, xe, ct_h, nb, na,
                                                  *wb),
            # route 1 runs its products on the tensor cores (3xTF32)
            (tensor_core_bounds if route == 1 else bound)(
                4 * e * (d + 3 * h) + 2 * row_w + 4 * e * (d + 2 * h),
                row_b),
            "hydragnn_tpu/ops/row_mlp.py:228", "row_mlp",
            ("row_dtri", "row_dx_ji", "row_dx_edge", "row_dwb")),
    }
    results = []
    with torch.no_grad():
        for name, (kern, plain, bnd, replaces, src, outs) in timed.items():
            worst = max(outs, key=lambda o: errs[o][1])
            results.append({
                "name": name, "route": "cuda",
                "source": f"hydragnn_torch/csrc/{src}.cu",
                "replaces": replaces,
                "max_abs_err": errs[worst][0], "max_rel_err": errs[worst][1],
                "ms": time_ms(torch, kern, flush, lead=True),
                "warm_l2_ms": time_ms(torch, kern, lead=True),
                "plain_ms": time_ms(torch, plain, flush),
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                "shape": {"N_valid": n_real, "E": e, "E_valid": e_real,
                          "T": t, "T_valid": t_real, "kj_rows": kj_rows,
                          "S": s, "R": r, "B": b, "D": d, "H": h,
                          "n_before": nb, "n_after": na},
            })
            if len(bnd) == 3:
                results[-1]["bound_ms_cuda_cores"] = bnd[2]
            if name.startswith("dimenet_triplet_mp_bwd"):
                tag = "all" if name.endswith("all_outputs") else "path"
                results[-1].update(
                    counter="dimenet_triplet_mp_bwd",
                    outputs=["d_radial", "d_x2", "d_cbf", "weights"]
                    if tag == "all" else ["d_x2", "weights"],
                    flops=tri_b[tag][0], flops_unfactored=tri_b[tag][1])
            if name == "dimenet_post_mlp_bwd":
                results[-1]["backward_route"] = route
            if name == "dimenet_post_mlp":
                results[-1]["forward_route"] = row_fwd_route
                results[-1]["route2_ms"] = time_ms(
                    torch, lambda: row_fwd(2), flush, lead=True)
            if name == "dimenet_triplet_mp":
                results[-1]["forward_route"] = fwd_route
                results[-1]["route2_ms"] = time_ms(
                    torch, lambda: tri_fwd(2), flush, lead=True)
    notes = {k: {"max_abs_err": a, "max_rel_err": r_}
             for k, (a, r_) in errs.items()}
    notes["row_mlp_bwd_route"] = route
    notes["tri_forward_route"] = fwd_route
    notes["tri_route1_vs_float64"] = tri_yard
    notes["row_mlp_fwd_route"] = row_fwd_route
    notes["row_mlp_fwd_route1_vs_float64"] = row_yard
    return results, notes


def dimenet_builder_flops(sr, b, d, triplets):
    """Floating-point operations (a multiply-add is two) that the builder's
    three kernels need on ``triplets`` real triplets, as the path launches
    them: (forward, pass S without d_sbf, pass P).  Per triplet the forward
    forms emb1 = sbf.K1 and emb2 = emb1.K2 and adds x_kj * emb2; pass S
    recomputes them and adds g * emb2; pass P forms emb1, d_emb2 = g *
    x_kj, d_emb1 = d_emb2.K2^T and both weight gradients."""
    prod = 2 * sr * b + 2 * b * d
    fwd = triplets * (prod + 2 * d)
    return fwd, fwd, triplets * (2 * prod + d)


def dimenet_builder_phase(torch, g, seed, cfg):
    """The builder's three kernels (forward, pass S, pass P) at the first
    train batch of the dimenet_wide cell, on its own triplet table and
    spherical basis: at the path's widths (S*R = 42, B = 8, D = 128), at
    (70, 8, 64) (num_radial 10) and at the limits (126, 128, 128: num_radial
    18), each through the op's autograd Function against autograd through
    the composed plain version: out, d x_kj and d sbf 1e-5 of their largest
    entry, dk1 and dk2 1e-4; d sbf exactly zero on masked triplets; then at
    the path's widths with the last third of the real triplets masked as
    well (parked on the last edge, as add_dimenet_extras parks padding) and
    with every triplet masked (every output and gradient exactly zero);
    then at the path's widths with sbf without a gradient, as in training
    (pass S's route 1): d x_kj 1e-5 and within the float64 bound (twice
    the float32 plain version's error, or 1e-6 of the largest entry), a
    second run bit-identical.  Pass P alone at the path's widths: its route
    at every width the plan's, route 1 (the forward's ring, each warp on its
    own share of the ji rows, dk1 and dk2 in registers) and route 2 (the
    first design) within 1e-4 of the plain version's largest entry, route 1
    also within the float64 bound, bit-identical twice and exactly zero
    with every triplet masked.  Then each kernel timed alone as the path
    launches it (pass S without d sbf), beside its plain version and its
    bound, pass P's first design beside its route 1 (``route2_ms``)."""
    from hydragnn_torch.models.dimenet import (
        distances_and_angles,
        spherical_basis,
    )
    from hydragnn_torch.kernels.build import load_library
    from hydragnn_torch.ops import dn_tri as dt
    from hydragnn_torch.ops.aggregate import segment_offsets

    dev = g.x.device
    ex = g.extras
    e = g.num_edges
    s = cfg.num_spherical
    gen = torch.Generator(device=dev).manual_seed(seed + 17)
    kj, ji, perm = ex["dn_idx_kj"], ex["dn_idx_ji"], ex["dn_perm_kj"]
    tm = ex["dn_triplet_mask"].to(torch.int32)
    real = tm != 0
    t_real = int(real.sum())
    with torch.no_grad():
        dist, angle = distances_and_angles(g.pos, g, cfg.radius)

    def basis(r):
        with torch.no_grad():
            return spherical_basis(
                dist / cfg.radius, angle, kj, s, r, cfg.envelope_exponent,
                perm_kj=perm, triplet_mask=ex["dn_triplet_mask"]
            ).contiguous()

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    def inputs(sbf, b, d):
        sr = sbf.shape[1]
        return [rnd(e, d), sbf, rnd(sr, b, scale=sr ** -0.5),
                rnd(b, d, scale=b ** -0.5)], rnd(e, d)

    def run(fn, ins, ct, tmask, ids, sbf_grad=True):
        ts = [x.detach().clone().requires_grad_(sbf_grad or i != 1)
              for i, x in enumerate(ins)]
        out = fn(ts[0], ts[1], tmask, ts[2], ts[3], *ids)
        (out * ct.to(out.dtype)).sum().backward()
        torch.cuda.synchronize()
        return [out.detach()] + [x.grad for x in ts]

    def hold(what, ins, ct, tmask=tm, ids=(kj, ji, perm), sbf_grad=True):
        dt.reset_launches()
        k = run(dt.dimenet_tri_builder, ins, ct, tmask, ids, sbf_grad)
        check({n: v for n, v in dt.LAUNCHES.items() if v}
              == {"dimenet_tri_builder": 1, "dimenet_tri_builder_bwd_s": 1,
                  "dimenet_tri_builder_bwd_p": 1},
              f"{what}: launches {dt.LAUNCHES}")
        p = run(dt.dimenet_tri_builder_reference, ins, ct, tmask, ids[:2],
                sbf_grad)
        check(not sbf_grad or bool((k[2][tmask == 0] == 0).all()),
              f"{what}: d sbf is not zero on masked triplets")
        errs = {}
        for name, k_, p_ in zip(("out", "dx_kj", "dsbf", "dk1", "dk2"), k,
                                p):
            if p_ is None:
                continue
            check(float(p_.abs().max()) > 0, f"{what}: the plain {name} is "
                  "zero: the comparison would hold nothing")
            errs[name] = rel_err(torch, k_, p_)
            tol = REL_TOL_WGRAD if name in ("dk1", "dk2") else REL_TOL_KERNEL
            check(errs[name][1] <= tol, f"{what}: {name} disagrees with the "
                  f"plain version under autograd: {errs[name][1]} > {tol}")
        return errs, k, p

    def worst_of(errs):
        k_ = max(errs, key=lambda o: errs[o][1])
        return {"worst": k_, "max_abs_err": errs[k_][0],
                "max_rel_err": errs[k_][1]}

    r, b, d = cfg.num_radial, cfg.basis_emb_size, cfg.int_emb_size
    sbf = basis(r)
    sr = sbf.shape[1]
    # the forward's route at each width held here, the card's against the
    # plan's (the path's widths take route 1)
    lib = load_library("dn_tri_builder")
    routes = {}
    for w in ((sr, b, d),) + BUILDER_WIDTHS:
        routes[w] = lib.hg_dn_tri_builder_fwd_route(*w)
        check(routes[w] == dt.builder_fwd_route(*w),
              f"dn_tri_builder forward at {w}: route {routes[w]} on the "
              f"card, {dt.builder_fwd_route(*w)} planned")
    check(routes[(sr, b, d)] == 1,
          f"the path's widths {(sr, b, d)} left the forward's route 1")
    # pass S's route: 1 without d sbf (the path's), 2 with it
    s_routes = {w: lib.hg_dn_tri_builder_bwd_s_route(sr, b, d, w)
                for w in (0, 1)}
    check(s_routes == {w: dt.builder_bwd_s_route(sr, b, d, w)
                       for w in (0, 1)} == {0: 1, 1: 2},
          f"dn_tri_builder pass S at {(sr, b, d)}: routes {s_routes} on the "
          "card (without d sbf, with it), (1, 2) planned")
    # pass P's route at each width, the card's against the plan's (the
    # path's widths take route 1)
    p_routes = {}
    for w in ((sr, b, d),) + BUILDER_WIDTHS:
        p_routes[w] = lib.hg_dn_tri_builder_bwd_p_route(*w)
        check(p_routes[w] == dt.builder_bwd_p_route(*w),
              f"dn_tri_builder pass P at {w}: route {p_routes[w]} on the "
              f"card, {dt.builder_bwd_p_route(*w)} planned")
    check(p_routes[(sr, b, d)] == 1,
          f"the path's widths {(sr, b, d)} left pass P's route 1")
    ins, ct = inputs(sbf, b, d)
    errs, _, _ = hold(f"dn_tri_builder ({sr}, {b}, {d})", ins, ct)
    notes = {k_: {"max_abs_err": a, "max_rel_err": r_}
             for k_, (a, r_) in errs.items()}
    for w_sr, w_b, w_d in BUILDER_WIDTHS:
        w_ins, w_ct = inputs(basis(w_sr // s), w_b, w_d)
        w_errs, _, _ = hold(f"dn_tri_builder ({w_sr}, {w_b}, {w_d})",
                            w_ins, w_ct)
        notes[f"SR{w_sr}_B{w_b}_D{w_d}"] = worst_of(w_errs)
    # a longer masked tail, parked on the last edge, and all masked
    tail = tm.clone()
    tail[t_real - t_real // 3:] = 0
    kj2, ji2 = kj.clone(), ji.clone()
    kj2[tail == 0] = e - 1
    ji2[tail == 0] = e - 1
    perm2 = torch.argsort(kj2, stable=True).to(torch.int32)
    t_errs, _, _ = hold("dn_tri_builder (masked tail)", ins, ct, tail,
                        (kj2, ji2, perm2))
    notes["masked_tail"] = worst_of(t_errs)
    # sbf without a gradient, as in training: pass S's route 1
    what = f"dn_tri_builder ({sr}, {b}, {d}, sbf without a gradient)"
    s_errs, k_s, p_s = hold(what, ins, ct, sbf_grad=False)
    again = run(dt.dimenet_tri_builder, ins, ct, tm, (kj, ji, perm), False)
    check(all(x is None and y is None or torch.equal(x, y)
              for x, y in zip(k_s, again)), f"{what}: a second run differs")
    p64 = run(dt.dimenet_tri_builder_reference, [x.double() for x in ins],
              ct, tm, (kj, ji), False)[1]
    e32 = float((p_s[1].double() - p64).abs().max())
    e_k = float((k_s[1].double() - p64).abs().max())
    allowed = max(2 * e32, 1e-6 * float(p64.abs().max()))
    check(e_k <= allowed, f"{what}: d x_kj {e_k} from the float64 run, "
          f"over {allowed}")
    notes["pass_s_route1"] = {
        **worst_of(s_errs), "dx_kj_vs_float64": e_k,
        "plain_float32_vs_float64": e32, "float64_allowed": allowed}
    dead = torch.zeros_like(tm)
    dt.reset_launches()
    k = run(dt.dimenet_tri_builder, ins, ct, dead, (kj, ji, perm))
    check(all(float(x.abs().max()) == 0 for x in k),
          "dn_tri_builder (all masked): an output or gradient is not zero")
    notes["all_masked"] = "zero"

    e_real = int((g.edge_mask != 0).sum())
    p_ = perm.long()
    ptr_ji = segment_offsets(ji, e, tm)
    ptr_kj = segment_offsets(kj[p_], e, tm[p_])
    x, _, k1, k2 = ins

    def pass_p_launch(route, mask=tm):
        ptr = ptr_ji if mask is tm else segment_offsets(ji, e, mask)
        return lambda: dt.launch_dn_tri_builder(
            "dimenet_tri_builder_bwd_p", x, sbf, k1, k2, kj, ji, None, ptr,
            ct, route=route)

    # pass P alone at the path's widths: both routes against the plain
    # version (1e-4), route 1 also within the float64 bound (twice the
    # float32 plain version's error, or 1e-6 of the largest entry) and
    # bit-identical twice; every triplet masked, exact zeros
    what = f"dn_tri_builder pass P ({sr}, {b}, {d})"
    with torch.no_grad():
        runs = [pass_p_launch(r)() for r in (1, 1, 2)]
        dead = pass_p_launch(1, torch.zeros_like(tm))()
        plain = dt.dimenet_tri_builder_pass_p_plain(x, sbf, tm, k1, k2, kj,
                                                    ji, ct)
        p64 = dt.dimenet_tri_builder_pass_p_plain(
            x.double(), sbf.double(), tm, k1.double(), k2.double(), kj, ji,
            ct.double())
    torch.cuda.synchronize()
    p_notes = {}
    for i, name in enumerate(("dk1", "dk2")):
        check(torch.equal(runs[0][i], runs[1][i]),
              f"{what}: route 1's {name} differs on a second run")
        check(float(dead[i].abs().max()) == 0,
              f"{what}: route 1's {name} is not zero with every triplet "
              "masked")
        e32 = float((plain[i].double() - p64[i]).abs().max())
        allowed = max(2 * e32, 1e-6 * float(p64[i].abs().max()))
        for route, k_ in ((1, runs[0]), (2, runs[2])):
            err = rel_err(torch, k_[i], plain[i])
            check(err[1] <= REL_TOL_WGRAD, f"{what}: route {route}'s {name} "
                  f"disagrees with its plain version: {err[1]}")
            e64 = float((k_[i].double() - p64[i]).abs().max())
            if route == 1:
                check(e64 <= allowed, f"{what}: route 1's {name} {e64} from "
                      f"the float64 run, over {allowed}")
            p_notes[f"{name}_route{route}"] = {
                "max_abs_err": err[0], "max_rel_err": err[1],
                "vs_float64": e64}
        p_notes[f"{name}_plain_float32_vs_float64"] = e32
        p_notes[f"{name}_float64_allowed"] = allowed
    notes["pass_p_routes"] = p_notes

    # each kernel alone on its precomputed schedule, as the path launches it
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    fwd_fl, s_fl, p_fl = dimenet_builder_flops(sr, b, d, t_real)
    wt = 4 * (sr * b + b * d)
    # read once: the real triplets' sbf rows and ids, x_kj, row_ptr, the
    # weights; the backward also the cotangent [E, D] (pass S: perm)
    tri_in = 4 * (t_real * (sr + 2) + e * d + e + 1) + wt
    plain_args = (x, sbf, tm, k1, k2, kj, ji, ct)
    timed = {
        "dimenet_tri_builder": (
            lambda: dt.launch_dn_tri_builder(
                "dimenet_tri_builder", x, sbf, k1, k2, kj, ji, None, ptr_ji),
            lambda: dt.dimenet_tri_builder_reference(x, sbf, tm, k1, k2, kj,
                                                     ji),
            # route 1 runs its products on the tensor cores (3xTF32)
            (tensor_core_bounds if routes[(sr, b, d)] == 1 else bound)(
                tri_in + 4 * e * d, fwd_fl),
            "hydragnn_tpu/ops/fused_block.py:495", ("out",)),
        "dimenet_tri_builder_bwd_s": (
            lambda: dt.launch_dn_tri_builder(
                "dimenet_tri_builder_bwd_s", x, sbf, k1, k2, kj, ji, perm,
                ptr_kj, ct, want=(True, False)),
            lambda: dt.dimenet_tri_builder_pass_s_plain(*plain_args,
                                                        want_sbf=False),
            # route 1 on the tensor cores; without d sbf the function reads
            # no x_kj: the sbf rows, ids, row_ptr, weights, perm and the
            # cotangent, and writes d x_kj
            (tensor_core_bounds if s_routes[0] == 1 else bound)(
                tri_in - 4 * e * d + 4 * (t_real + e * d) + 4 * e * d,
                s_fl),
            "hydragnn_tpu/ops/fused_block.py:599", ("dx_kj",)),
        "dimenet_tri_builder_bwd_p": (
            pass_p_launch(0),
            lambda: dt.dimenet_tri_builder_pass_p_plain(*plain_args),
            # route 1 on the tensor cores
            (tensor_core_bounds if p_routes[(sr, b, d)] == 1 else bound)(
                tri_in + 4 * e * d + wt, p_fl),
            "hydragnn_tpu/ops/fused_block.py:561", ("dk1", "dk2")),
    }
    results = []
    with torch.no_grad():
        for name, (kern, plain, bnd, replaces, outs) in timed.items():
            # each row's error is that of the path's launch: pass S's of
            # its route 1 (sbf without a gradient)
            src = s_errs if name == "dimenet_tri_builder_bwd_s" else errs
            worst = max(outs, key=lambda o: src[o][1])
            results.append({
                "name": name, "route": "cuda",
                "source": "hydragnn_torch/csrc/dn_tri_builder.cu",
                "replaces": replaces,
                "max_abs_err": src[worst][0], "max_rel_err": src[worst][1],
                "ms": time_ms(torch, kern, flush, lead=True),
                "warm_l2_ms": time_ms(torch, kern, lead=True),
                "plain_ms": time_ms(torch, plain, flush),
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
                "shape": {"E": e, "E_valid": e_real,
                          "T": int(kj.shape[0]), "T_valid": t_real,
                          "SR": sr, "B": b, "D": d},
            })
            if len(bnd) == 3:
                results[-1]["bound_ms_cuda_cores"] = bnd[2]
            if name == "dimenet_tri_builder":
                results[-1]["forward_route"] = routes[(sr, b, d)]
            if name == "dimenet_tri_builder_bwd_s":
                results[-1]["bwd_s_route"] = s_routes[0]
            if name == "dimenet_tri_builder_bwd_p":
                results[-1]["bwd_p_route"] = p_routes[(sr, b, d)]
                results[-1]["route2_ms"] = time_ms(
                    torch, pass_p_launch(2), flush, lead=True)
    notes["forward_routes"] = {f"SR{k[0]}_B{k[1]}_D{k[2]}": v
                               for k, v in routes.items()}
    notes["pass_p_routes_by_width"] = {f"SR{k[0]}_B{k[1]}_D{k[2]}": v
                                       for k, v in p_routes.items()}
    return results, notes


def dimenet_small_batches(loader, batch, count):
    """The first ``count`` batches of ``batch`` graphs of ``loader``'s
    samples, each with its triplet table sized for that batch (the
    loader's own is sized for its batch) and the same gate, so the
    ``dn_tri_ok`` marker is the loader's."""
    from hydragnn_torch.data.dataloader import GraphDataLoader
    from hydragnn_torch.models.dimenet import (
        DnTriGate,
        add_dimenet_extras,
        count_triplets,
    )

    samples = loader.samples
    per = max(count_triplets(s_.edge_index, s_.num_nodes)
              for s_ in samples if s_.num_edges)
    max_triplets = -(-(batch * per + 1) // 8) * 8
    gate = DnTriGate(max_edges_per_graph=max(s_.num_edges for s_ in samples))
    small = GraphDataLoader(
        samples, loader.head_specs, batch,
        graph_feature_slices=loader.graph_feature_slices,
        node_feature_slices=loader.node_feature_slices,
        post_collate=lambda b: add_dimenet_extras(b, max_triplets,
                                                  tri_gate=gate))
    return [b for _, b in zip(range(count), small)]


def remat_check(torch, cfg, g, seed, dev):
    """One dimenet_wide train step (forward, loss, backward) with
    HYDRAGNN_DIMENET_REMAT=1 against one without, from one seeded init on
    the same batch: the loss and every gradient within REL_TOL_REMAT of
    the largest entry, whether they are bit-identical, and the peak device
    memory of each step (``torch.cuda.max_memory_allocated`` after
    ``reset_peak_memory_stats``, and above what was allocated before the
    step)."""
    from hydragnn_torch.models.base import multihead_loss
    from hydragnn_torch.models.create import create_model

    res = {}
    for remat in (False, True):
        if remat:
            os.environ["HYDRAGNN_DIMENET_REMAT"] = "1"
        try:
            model = create_model(cfg, seed=seed).to(dev)
        finally:
            os.environ.pop("HYDRAGNN_DIMENET_REMAT", None)
        check(all(c.remat is remat for c in model.graph_convs),
              "HYDRAGNN_DIMENET_REMAT was not read at model build")
        model.train()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = multihead_loss(cfg, model(g), g)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        torch.cuda.synchronize()
        res[remat] = (loss.detach(), grads,
                      torch.cuda.max_memory_allocated(), base)
        del model, loss, grads
    (l0, g0, m0, b0), (l1, g1, m1, b1) = res[False], res[True]
    top = max(float(x.abs().max()) for x in g0)
    grad_err = max(float((a - c).abs().max()) for a, c in zip(g0, g1)) / top
    loss_err = float((l0 - l1).abs() / l0.abs())
    check(loss_err <= REL_TOL_REMAT and grad_err <= REL_TOL_REMAT,
          f"HYDRAGNN_DIMENET_REMAT: loss {loss_err}, gradients {grad_err} "
          "from the step without it")
    return {"loss_rel_err": loss_err, "grad_err_over_largest": grad_err,
            "bit_identical": bool(torch.equal(l0, l1) and all(
                torch.equal(a, c) for a, c in zip(g0, g1))),
            "peak_bytes": m0, "peak_bytes_remat": m1,
            "step_peak_above_base_bytes": m0 - b0,
            "step_peak_above_base_bytes_remat": m1 - b1}


def segment_sum_phase(torch, g, seed):
    """The two kernels of the ``pallas`` aggregation backend at the first
    train batch: ``segment_sum_pallas`` on SchNet's edge messages (x[s] *
    w, F = 64) over unsorted ids (the senders) whose masked tail lies out
    of range, and ``segment_sum_sorted`` on the messages over the
    receivers with the padded tail pre-masked (its cap: the batch's largest
    real in-degree).  Each against its plain
    version (1e-5 of the largest entry) and, through autograd, its VJP
    (a gather, zero where the forward dropped the row) against autograd
    through the plain version.  Then each kernel timed alone on its
    precomputed schedule (the unsorted one's stable sort is the wrapper's,
    timed with it as ``wrapper_ms``), beside the library call:
    ``Tensor.index_add_`` (atomics) and ``torch.segment_reduce``."""
    from hydragnn_torch.ops import aggregate as ag
    from hydragnn_torch.ops import fused_mp as fm

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    f = FEATURES
    gen = torch.Generator(device=dev).manual_seed(seed + 6)
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    real = mask != 0
    x = torch.randn(n, f, device=dev, generator=gen)
    w = torch.randn(e, f, device=dev, generator=gen)
    msgs = (x[send.long()] * w).contiguous()
    # unsorted ids, the masked tail out of range (n, n + 1, n + 2)
    ids = torch.where(real, send, n + torch.arange(
        e, device=dev, dtype=torch.int32) % 3)
    premasked = (msgs * mask[:, None]).contiguous()
    # the sorted function's cap: the largest real in-degree of the batch
    cap = int(torch.bincount(recv[real].long(), minlength=n).max())
    ct = torch.randn(n, f, device=dev, generator=gen)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    results, notes = [], {}
    cases = (("segment_sum_pallas", ag.segment_sum_pallas, msgs, ids,
              "hydragnn_tpu/ops/aggregate.py:157"),
             ("segment_sum_sorted",
              lambda d_, i_, s_: ag.segment_sum_sorted(d_, i_, s_, cap),
              premasked, recv, "hydragnn_tpu/ops/aggregate.py:244"))
    for name, fn, data, seg, replaces in cases:
        def run(op):
            t = data.detach().clone().requires_grad_(True)
            out = op(t, seg, n)
            (out * ct).sum().backward()
            torch.cuda.synchronize()
            return out.detach(), t.grad

        ag.reset_launches()
        k_out, k_grad = run(fn)
        check(ag.LAUNCHES[name] == 1 and sum(ag.LAUNCHES.values()) == 1,
              f"{name} launches {ag.LAUNCHES}")
        p_out, p_grad = run(fm.segment_sum_dense_plain)
        fwd_err = rel_err(torch, k_out, p_out)
        vjp_err = rel_err(torch, k_grad, p_grad)
        check(fwd_err[1] <= REL_TOL_KERNEL and vjp_err[1] <= REL_TOL_KERNEL,
              f"{name} disagrees with its plain version: forward "
              f"{fwd_err[1]}, VJP {vjp_err[1]}")
        ok = (seg >= 0) & (seg < n)
        check(bool((k_grad[~ok] == 0).all()),
              f"{name}: the VJP is not zero on dropped rows")
        # the rows the function sums: in range (and, sorted, within the cap)
        rows_in = (int(ok.sum()) if name == "segment_sum_pallas" else int(
            torch.bincount(seg.long(), minlength=n).clamp(max=cap).sum()))
        if name == "segment_sum_pallas":
            perm, ptr = ag.sort_schedule(seg, n)
            # the one PyTorch call for the same sums: index_add_ over the
            # in-range rows (atomics; the rows and ids selected beforehand)
            lib_data = data[ok].contiguous()
            lib_ids = seg[ok].long()
            lib = lambda: torch.zeros(n, f, device=dev).index_add_(
                0, lib_ids, lib_data)
            wrapper = lambda: ag.segment_sum_pallas(data, seg, n)
        else:
            perm, ptr = None, ag.segment_offsets(seg, n)
            lengths = torch.bincount(seg.long(), minlength=n)
            lib = lambda: torch.segment_reduce(data, "sum", lengths=lengths,
                                               axis=0)
            wrapper = lambda: ag.segment_sum_sorted(data, seg, n, cap)
        check(rel_err(torch, lib(), p_out)[1] <= REL_TOL_KERNEL,
              f"the library call disagrees with the plain {name}")
        max_rows = cap if name == "segment_sum_sorted" else 2**31 - 1
        kern = lambda: fm.launch_segment_sum_rows(
            data, ptr, n, op=name, perm=perm, max_rows=max_rows,
            launches=ag.LAUNCHES)
        # read once: the summed rows, every id, the output written once
        b_ms, b_by = bound(4 * (rows_in * f + e + n * f), rows_in * f)
        results.append({
            "name": name, "route": "cuda",
            "source": "hydragnn_torch/csrc/fused_mp.cu",
            "replaces": replaces,
            "max_abs_err": fwd_err[0], "max_rel_err": fwd_err[1],
            "ms": time_ms(torch, kern, flush, lead=True),
            "warm_l2_ms": time_ms(torch, kern, lead=True),
            "wrapper_ms": time_ms(torch, wrapper, flush),
            "plain_ms": time_ms(torch, lambda: fm.segment_sum_dense_plain(
                data, seg, n), flush),
            "library_ms": time_ms(torch, lib, flush),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": {"N": n, "E": e, "rows_summed": rows_in, "F": f},
        })
        notes[name] = {"vjp_max_abs_err": vjp_err[0],
                       "vjp_max_rel_err": vjp_err[1]}
    return results, notes


def double_backward_phase(torch, g, seed):
    """C1 on the card: a double backward (``create_graph=True``, then a
    backward through the first gradients) through ``gather_mul_segment_sum``
    and ``gather_segment_sum`` under ``fused`` at the first train batch,
    against the same on the CPU (plain versions): every first and second
    derivative within 1e-5 of its largest entry.  And the Functions whose
    backward runs non-differentiable kernels (``scf_edge_pipeline``,
    ``egcl_block``, ``gat_edge_attention``, ``cgcnn_gated_block``) raise
    under a double backward on the card, and so do ``dimenet_triplet_mp``,
    ``dimenet_tri_builder`` and ``dimenet_post_mlp``."""
    import numpy as np

    from hydragnn_torch.ops import cgcnn_mp as cg
    from hydragnn_torch.ops import dn_tri as dt
    from hydragnn_torch.ops import egcl_mp as ec
    from hydragnn_torch.ops import fused_mp as fm
    from hydragnn_torch.ops import gat_mp as gm
    from hydragnn_torch.ops import row_mlp as rm
    from hydragnn_torch.ops import scf_mp as sm

    dev = g.x.device
    n, e = g.num_nodes, g.num_edges
    f = FEATURES
    rng = np.random.RandomState(seed + 7)
    send, recv, mask = g.senders, g.receivers, g.edge_mask
    perm = g.extras["edge_perm_sender"]
    em = mask.to(torch.int32)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((rng.randn(*shape) * scale).astype(
            np.float32))

    x0, w0 = arr(n, f), arr(e, f) * mask.cpu()[:, None]
    c1, c2x, c2w = arr(n, f), arr(n, f), arr(e, f) * mask.cpu()[:, None]

    def second(op, device):
        d = torch.device(device)
        s, r, p, m = (t.to(d) for t in (send, recv, perm, mask))
        xs = x0.to(d).requires_grad_(True)
        if op == "gather_mul_segment_sum":
            ws = w0.to(d).requires_grad_(True)
            out = fm.gather_mul_segment_sum(xs, ws, s, r, p, edge_valid=m)
            leaves, cs = (xs, ws), (c2x.to(d), c2w.to(d))
        else:
            out = fm.gather_segment_sum(xs, s, r, p, m)
            leaves, cs = (xs,), (c2x.to(d),)
        first = torch.autograd.grad((out.square() * c1.to(d)).sum(), leaves,
                                    create_graph=True)
        inner = sum((a * c).sum() for a, c in zip(first, cs))
        sec = torch.autograd.grad(inner, leaves)
        return [t.detach().cpu() for t in tuple(first) + tuple(sec)]

    notes = {}
    for op in ("gather_mul_segment_sum", "gather_segment_sum"):
        fm.reset_launches()
        card = second(op, "cuda")
        torch.cuda.synchronize()
        launched = dict(fm.LAUNCHES)
        check(launched[f"{op}_dx"] >= 2,
              f"{op}: the double backward launched {launched}")
        cpu = second(op, "cpu")
        worst = max(rel_err(torch, a, b)[1] for a, b in zip(card, cpu))
        check(worst <= REL_TOL_KERNEL,
              f"{op}: double backward, card vs CPU {worst}")
        check(float(card[-1].abs().max()) > 0,
              f"{op}: the second derivative is zero")
        notes[op] = {"max_rel_err_vs_cpu": worst, "launches": launched}

    def t(*shape, scale=0.3):
        return (arr(*shape, scale=scale)).to(dev)

    h = 48
    # a one-triplet-per-edge table over n rows and the chain's 8 layers
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    chain = [t(f, f), None] + [p_ for _ in range(7) for p_ in (t(f, f), t(f))]
    raising = {
        "scf_edge_pipeline": lambda x_: sm.scf_edge_pipeline(
            x_, t(e, GAUSSIANS), mask, em, t(GAUSSIANS, WIDE), t(WIDE),
            t(WIDE, WIDE), t(WIDE), send, recv, perm),
        "egcl_block": lambda x_: ec.egcl_block(
            False, x_, torch.cat([t(e, 3, scale=0.2), t(e, 1).abs()], 1),
            em, t(2 * f + 1, h), t(h), t(h, h), t(h), None, None, None,
            send, recv, perm)[0],
        "gat_edge_attention": lambda x_: gm.gat_edge_attention(
            x_, t(n, f), t(1, f), send, recv, perm, mask, None, GAT_SLOPE,
            f)[0],
        "cgcnn_gated_block": lambda x_: cg.cgcnn_gated_block(
            x_, None, em, t(2 * f, f), t(f), t(2 * f, f), t(f), send, recv,
            perm),
        "dimenet_triplet_mp": lambda x_: dt.dimenet_triplet_mp(
            t(n, 42).abs(), x_, t(n, 7), t(42, 8), t(8, f), ids, ids,
            torch.ones_like(ids), ids, 6),
        "dimenet_tri_builder": lambda x_: dt.dimenet_tri_builder(
            x_, t(n, 42), torch.ones_like(ids), t(42, 8), t(8, f), ids, ids,
            ids),
        "dimenet_post_mlp": lambda x_: rm.dimenet_post_mlp(
            x_, t(n, f), t(n, f), 1, 2, *chain),
    }
    for name, fn in raising.items():
        xs = t(n, WIDE if name == "scf_edge_pipeline" else f
               ).requires_grad_(True)
        out = fn(xs)
        try:
            torch.autograd.grad(out.square().sum(), (xs,),
                                create_graph=True)
        except RuntimeError as err:
            check("not differentiable twice" in str(err),
                  f"{name}: unexpected error {err}")
            notes[name] = "raises"
        else:
            check(False, f"{name}: a double backward did not raise")
    return notes


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
    from hydragnn_torch.ops import (
        aggregate,
        cgcnn_mp,
        dn_tri,
        egcl_mp,
        fused_mp,
        gat_mp,
        poly_mp,
        row_mlp,
        scf_mp,
    )
    from hydragnn_torch.telemetry import pipeline
    from hydragnn_torch.train import trainer

    mods = (fused_mp, scf_mp, poly_mp, egcl_mp, gat_mp, cgcnn_mp, aggregate,
            dn_tri, row_mlp)

    def counts():
        return {k: v for m in mods for k, v in m.LAUNCHES.items()}

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
        for m in mods:
            m.reset_launches()
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
                   path, backend="fused"):
    """The card run's launches, train passes and eval passes apart, against
    what the path must launch per batch, every dispatch site on the
    backend's side (``fused``; ``scatter`` for the pallas backend, whose
    kernel sits behind the plain dispatch), a finite falling loss, and, where
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
    side = "fused" if backend == "fused" else "scatter"
    check(pipeline.dispatch_summary(dispatch) == side,
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
    """The batch with its floating-point tensors in float64 and without the
    sender permutation and DimeNet's triplet marker: a model that picks a
    fused block from those markers (EGNN's EGCL, SchNet's edge pipeline,
    DimeNet's triplet ops) takes its composed path."""
    def up(t):
        return t.double() if t is not None and t.is_floating_point() else t

    return dataclasses.replace(
        g, x=up(g.x), pos=up(g.pos), edge_attr=up(g.edge_attr),
        node_mask=up(g.node_mask), edge_mask=up(g.edge_mask),
        graph_mask=up(g.graph_mask), labels=tuple(up(t) for t in g.labels),
        cell=up(g.cell),
        extras={k: v for k, v in g.extras.items()
                if k not in ("edge_perm_sender", "dn_tri_ok")})


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
    float64 on the CPU through the composed ``scatter`` path, on the batch
    without its sender permutation (``as_double``), which shares no code
    with the kernels or their plain versions.  Every parameter's
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

    def loss_grads_stats(model, g, i):
        kept = [b.clone() for b in model.buffers()]
        model.train()
        loss, _ = multihead_loss(cfg, model(g, dropout_seed=i), g)
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
        lc, gc, sc = loss_grads_stats(cpu_model, g, i)
        lg, gg, sg = loss_grads_stats(card_model, g.to(dev), i)
        os.environ["HYDRAGNN_AGGR_BACKEND"] = "scatter"
        try:
            _, gr, _ = loss_grads_stats(ref_model, as_double(g), i)
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
    # torch's gather kernels (indexing by a tensor of ids), by name
    gathers = {r.key[:90]: {"calls": r.count,
                            "ms_per_epoch": r.self_device_time_total / 1e3}
               for r in rows if "gather" in r.key and "hg_" not in r.key
               and "gm_" not in r.key and "gather_mul" not in r.key}
    return {"graphs": graphs, "wall_s": wall, "graphs_per_s": graphs / wall,
            "steps": len(loader), "profiled_wall_s": wall_prof,
            "kernel_s_profiled_epoch": kernel_s,
            "device_idle_share": 1.0 - kernel_s / wall_prof,
            "top_kernels": [{"kernel": r.key[:90],
                             "ms_per_epoch": r.self_device_time_total / 1e3,
                             "calls": r.count} for r in rows[:8]],
            "torch_gather_kernels": gathers}


def memoize_dataset_loading():
    """Load each dataset once per configuration: every ``run_training`` and
    ``run_prediction`` call, on the card and on the CPU, and the script's
    own loaders read the same data through
    ``dataset_loading_and_splitting``, whose raw parse, serialization,
    radius graphs and ``finalize`` give the same result for the same
    configuration, seed and ``HYDRAGNN_*`` environment.  Each call gets its
    own loaders (shallow copies: the same samples, their own epoch) and
    its own copy of the finalized configuration."""
    import importlib

    mods = [importlib.import_module(f"hydragnn_torch.{m}") for m in (
        "data.load_data", "run_training", "run_prediction")]
    load = mods[0].dataset_loading_and_splitting
    cache = {}

    def cached(config, seed=0):
        env = sorted((k, v) for k, v in os.environ.items()
                     if k.startswith("HYDRAGNN_")
                     or k == "SERIALIZED_DATA_PATH")
        key = json.dumps([config, seed, env], sort_keys=True, default=str)
        if key not in cache:
            cache[key] = load(copy.deepcopy(config), seed=seed)
        *loaders, cfg = cache[key]
        return (*[copy.copy(x) for x in loaders], copy.deepcopy(cfg))

    for m in mods:
        m.dataset_loading_and_splitting = cached


def main():
    t_start = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    # -- 1. device
    check(torch.cuda.is_available(), "no CUDA device is available")
    sys.path.insert(0, ROOT)
    import hydragnn_torch
    from hydragnn_torch.config.config import get_log_name_config
    from hydragnn_torch.data.dataloader import GraphDataLoader
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
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "cpu_threads": torch.get_num_threads(),
          "cpu_count": os.cpu_count()})
    memoize_dataset_loading()
    from hydragnn_torch.data.load_data import dataset_loading_and_splitting

    # -- 2. build
    t0 = time.perf_counter()
    libs = build_all(verbose=True)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": [os.path.basename(p) for p in libs]})
    emit(pass_p_build_report())

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
        md17_cfg, oc22_cfg = egnn_md17_config(), egnn_oc22_config()
        md17_loaders = dataset_loading_and_splitting(
            copy.deepcopy(md17_cfg), seed=args.seed)
        oc22_loaders = dataset_loading_and_splitting(
            copy.deepcopy(oc22_cfg), seed=args.seed)
        md17_loaders[0].set_epoch(0)
        first_md17 = next(iter(md17_loaders[0])).to(dev)
        cgcnn_cfg = cgcnn_config()
        write_cgcnn_data("dataset/chip_smoke", CGCNN_DATA, args.seed)
        cgcnn_loaders = dataset_loading_and_splitting(
            copy.deepcopy(cgcnn_cfg), seed=args.seed)
        cgcnn_loaders[0].set_epoch(0)
        first_cgcnn = next(iter(cgcnn_loaders[0])).to(dev)
        check(first_cgcnn.x.shape[1] == FEATURES,
              f"the cgcnn batch has {first_cgcnn.x.shape[1]} node features")
        dn_cfg = dimenet_config()
        write_dimenet_data(args.seed)
        dn_loaders = dataset_loading_and_splitting(
            copy.deepcopy(dn_cfg), seed=args.seed)
        dn_loaders[0].set_epoch(0)
        first_dn = next(iter(dn_loaders[0])).to(dev)
        check("dn_tri_ok" in first_dn.extras,
              "the dimenet set's first batch carries no dn_tri_ok marker: "
              "neither the factored-basis kernel nor the builder would run")
        dn_model_cfg = ModelConfig.from_config(dn_loaders[3])
        # dimenet_wide trains on the dimenet cell's set, split and batches
        dnw_cfg = dimenet_wide_config()
        dnw_model_cfg = dataclasses.replace(
            dn_model_cfg, hidden_dim=128, out_emb_size=256, int_emb_size=128)
        dn_real = first_dn.edge_mask != 0
        emit({"phase": "setup", "seconds": time.perf_counter() - t0,
              "data_loading_s": load_s,
              "test_batches": n_batches, "test_graphs": n_test,
              "train_batches": len(train_loader), "train_graphs": n_train,
              "val_batches": len(loaders[1]),
              "test_batches_train_split": len(loaders[2]),
              "first_train_batch": {
                  "nodes": first_train.num_nodes,
                  "edges": first_train.num_edges,
                  "real_edges": int(first_train.edge_mask.sum())},
              "first_egnn_md17_train_batch": {
                  "nodes": first_md17.num_nodes,
                  "edges": first_md17.num_edges,
                  "real_edges": int(first_md17.edge_mask.sum())},
              "first_cgcnn_train_batch": {
                  "nodes": first_cgcnn.num_nodes,
                  "edges": first_cgcnn.num_edges,
                  "real_edges": int(first_cgcnn.edge_mask.sum()),
                  "node_features": first_cgcnn.x.shape[1]},
              "dimenet_set": {
                  "train_batches": len(dn_loaders[0]),
                  "train_graphs": len(dn_loaders[0].samples),
                  "max_edges_per_graph": max(
                      s_.num_edges for s_ in dn_loaders[0].samples)},
              "first_dimenet_train_batch": {
                  "nodes": first_dn.num_nodes,
                  "real_nodes": int(first_dn.node_mask.sum()),
                  "edges": first_dn.num_edges,
                  "real_edges": int(dn_real.sum()),
                  "triplets": int(first_dn.extras["dn_idx_kj"].shape[0]),
                  "real_triplets": int(
                      first_dn.extras["dn_triplet_mask"].sum())}})

        # -- 3. kernels against their plain versions, at the first train
        #       batch of the main path
        t0 = time.perf_counter()
        kernels, notes = kernel_phase(torch, first_train, args.seed)
        scf_kernels, scf_notes = scf_phase(torch, first_train, args.seed)
        poly_kernels, poly_notes = poly_phase(torch, first_train, args.seed)
        egcl_kernels, egcl_notes = egcl_phase(torch, first_md17, args.seed)
        # the gat cell's split and batches are the flagship training's
        gat_kernels, gat_notes = gat_phase(torch, first_train, args.seed)
        cgcnn_kernels, cgcnn_notes = cgcnn_phase(torch, first_cgcnn,
                                                 args.seed)
        seg_kernels, seg_notes = segment_sum_phase(torch, first_train,
                                                   args.seed)
        dn_kernels, dn_notes = dimenet_phase(torch, first_dn, args.seed,
                                             dn_model_cfg)
        dnw_kernels, dnw_notes = dimenet_builder_phase(
            torch, first_dn, args.seed, dnw_model_cfg)
        kernels += (scf_kernels + poly_kernels + egcl_kernels + gat_kernels
                    + cgcnn_kernels + seg_kernels + dn_kernels + dnw_kernels)
        emit({"phase": "kernel_checks", "seconds": time.perf_counter() - t0,
              **notes, "scf": scf_notes, "poly": poly_notes,
              "egcl": egcl_notes, "gat": gat_notes, "cgcnn": cgcnn_notes,
              "segment_sum": seg_notes, "dimenet": dn_notes,
              "dimenet_builder": dnw_notes})

        # -- 3b. a double backward through the linear Functions, card vs
        #        CPU, and the refusal of the others
        t0 = time.perf_counter()
        c1_notes = double_backward_phase(torch, first_train, args.seed)
        emit({"phase": "double_backward",
              "seconds": time.perf_counter() - t0, **c1_notes})

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

        # -- 9. EGNN: md17's architecture in full, oc22's capped
        egnn = {}
        for name, ecfg, eloaders, cap in (
                ("egnn_md17", md17_cfg, md17_loaders, None),
                ("egnn_oc22", oc22_cfg, oc22_loaders, ARCH_CAP)):
            t_phase = time.perf_counter()
            elogs = os.path.join(logs, name)
            card, _, e_launches, esplit, dispatch, wall_card, _ = \
                train_phase(torch, hydragnn_torch, ecfg, elogs, args.seed,
                            cap=cap, cpu_run=False)
            esteps, eevals, e_per, _ = check_training(
                f"{name} training", card, None, e_launches, esplit,
                dispatch, eloaders, cap, name)
            ecfg_m = ModelConfig.from_config(card[2])
            eloaders[0].set_epoch(0)
            e3_cpu = [b for _, b in zip(range(REPEAT_STEPS), eloaders[0])]
            n_eparams = repeat_bits(torch, ecfg_m,
                                    [b.to(dev) for b in e3_cpu], args.seed,
                                    dev)
            esteady = (steady_epoch(torch, ecfg_m, eloaders[0], args.seed,
                                    dev) if cap is None else None)
            elock = lockstep(torch, ecfg_m, e3_cpu, args.seed, dev)
            own = own_checkpoint_prediction(
                torch, hydragnn_torch, ecfg, os.path.join(elogs, "cuda"),
                args.seed, name)
            hist = card[1]
            egnn[name] = (e_launches, e_per)
            arch_ = card[2]["NeuralNetwork"]["Architecture"]
            emit({"phase": f"{name}_training",
                  "seconds": time.perf_counter() - t_phase,
                  "entry": "hydragnn_torch.run_training", "backend": "fused",
                  "hidden_dim": arch_["hidden_dim"],
                  "num_conv_layers": arch_["num_conv_layers"],
                  "radius": arch_["radius"],
                  "max_neighbours": arch_["max_neighbours"],
                  "output_names": card[2]["NeuralNetwork"][
                      "Variables_of_interest"]["output_names"],
                  "force_term": False, "batches_per_pass": cap,
                  "epochs": len(hist["train"]), "train_steps": esteps,
                  "eval_batches": eevals, "train_loss": hist["train"],
                  "val_loss": hist["val"], "test_loss": hist["test"],
                  "lr": hist["lr"], "wall_s_cuda": wall_card,
                  "epoch_time_s_cuda": hist["epoch_time"],
                  "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                           "parameters": n_eparams},
                  "steady_train_epoch_cuda": esteady,
                  "lockstep_vs_cpu": elock,
                  "prediction_from_own_checkpoint": own,
                  "launches": e_launches, "launches_split": esplit,
                  "dispatch": dispatch})

        # -- 10. GAT: the arch sweep's widths in full, hidden 256 capped
        #        (the tiled path, with dropout bits); the same split as
        #        the flagship training
        gat = {}
        for name, gcfg, cap in (
                ("gat", gat_config(), None),
                ("gat_h256", gat_config(GAT_WIDE, dropout=0.25,
                                        epochs=WIDE_EPOCHS), WIDE_CAP)):
            t_phase = time.perf_counter()
            glogs = os.path.join(logs, name)
            card, _, g_launches, gsplit, dispatch, wall_card, _ = \
                train_phase(torch, hydragnn_torch, gcfg, glogs, args.seed,
                            cap=cap, cpu_run=False)
            gsteps, gevals, g_per, _ = check_training(
                f"{name} training", card, None, g_launches, gsplit,
                dispatch, loaders, cap, name)
            check(dispatch.get("gat_attn:fused", 0) > 0
                  and "gat_attn:scatter" not in dispatch,
                  f"{name}: a gat_attn dispatch left the kernels: {dispatch}")
            gcfg_m = ModelConfig.from_config(card[2])
            n_gparams = repeat_bits(torch, gcfg_m, first3, args.seed, dev)
            gsteady = (steady_epoch(torch, gcfg_m, train_loader, args.seed,
                                    dev) if cap is None else None)
            lock_batches = first3_cpu
            if cap is not None:
                small = GraphDataLoader(
                    train_loader.samples, train_loader.head_specs,
                    GAT_WIDE_LOCKSTEP_BATCH,
                    graph_feature_slices=train_loader.graph_feature_slices,
                    node_feature_slices=train_loader.node_feature_slices)
                lock_batches = [b for _, b in zip(range(REPEAT_STEPS),
                                                  small)]
            t0 = time.perf_counter()
            with cpu_dropout_bits():
                glock = lockstep(torch, gcfg_m, lock_batches, args.seed,
                                 dev)
            lock_s = time.perf_counter() - t0
            # prediction from the checkpoint: the gat cell (a CPU
            # run_prediction at hidden 256 would cost minutes)
            t0 = time.perf_counter()
            own = (own_checkpoint_prediction(
                torch, hydragnn_torch, gcfg, os.path.join(glogs, "cuda"),
                args.seed, name) if cap is None else None)
            own_s = time.perf_counter() - t0
            hist = card[1]
            gat[name] = (g_launches, g_per)
            emit({"phase": f"{name}_training",
                  "seconds": time.perf_counter() - t_phase,
                  "entry": "hydragnn_torch.run_training", "backend": "fused",
                  "hidden_dim": gcfg_m.hidden_dim,
                  "heads": gcfg_m.gat_heads, "dropout": gcfg_m.dropout,
                  "batches_per_pass": cap,
                  "epochs": len(hist["train"]), "train_steps": gsteps,
                  "eval_batches": gevals, "train_loss": hist["train"],
                  "val_loss": hist["val"], "test_loss": hist["test"],
                  "lr": hist["lr"], "wall_s_cuda": wall_card,
                  "epoch_time_s_cuda": hist["epoch_time"],
                  "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                           "parameters_and_buffers":
                                               n_gparams},
                  "steady_train_epoch_cuda": gsteady,
                  "lockstep_batch_graphs": (BATCH if cap is None
                                            else GAT_WIDE_LOCKSTEP_BATCH),
                  "lockstep_vs_cpu": glock, "lockstep_s": lock_s,
                  "prediction_from_own_checkpoint": own,
                  "prediction_s": own_s,
                  "launches": g_launches, "launches_split": gsplit,
                  "dispatch": dispatch})

        # -- 11. CGCNN at the arch sweep's widths (input = hidden = 64), in
        #        full
        t_phase = time.perf_counter()
        clogs = os.path.join(logs, "cgcnn")
        card, _, c_launches, csplit, dispatch, wall_card, _ = train_phase(
            torch, hydragnn_torch, cgcnn_cfg, clogs, args.seed,
            cpu_run=False)
        csteps, cevals, c_per, _ = check_training(
            "cgcnn training", card, None, c_launches, csplit, dispatch,
            cgcnn_loaders, None, "cgcnn")
        check(dispatch.get("cgcnn:fused", 0) > 0
              and "cgcnn:scatter" not in dispatch,
              f"cgcnn: a cgcnn dispatch left the kernels: {dispatch}")
        ccfg = ModelConfig.from_config(card[2])
        check(ccfg.input_dim == ccfg.hidden_dim == FEATURES,
              f"cgcnn widths {ccfg.input_dim}, {ccfg.hidden_dim}")
        cgcnn_loaders[0].set_epoch(0)
        c3_cpu = [b for _, b in zip(range(REPEAT_STEPS), cgcnn_loaders[0])]
        n_cparams = repeat_bits(torch, ccfg, [b.to(dev) for b in c3_cpu],
                                args.seed, dev)
        csteady = steady_epoch(torch, ccfg, cgcnn_loaders[0], args.seed,
                               dev)
        t0 = time.perf_counter()
        clock = lockstep(torch, ccfg, c3_cpu, args.seed, dev)
        clock_s = time.perf_counter() - t0
        cown = own_checkpoint_prediction(
            torch, hydragnn_torch, cgcnn_cfg, os.path.join(clogs, "cuda"),
            args.seed, "cgcnn")
        hist = card[1]
        emit({"phase": "cgcnn_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "fused",
              "input_dim": ccfg.input_dim, "hidden_dim": ccfg.hidden_dim,
              "epochs": len(hist["train"]), "train_steps": csteps,
              "eval_batches": cevals, "train_loss": hist["train"],
              "val_loss": hist["val"], "test_loss": hist["test"],
              "lr": hist["lr"], "wall_s_cuda": wall_card,
              "epoch_time_s_cuda": hist["epoch_time"],
              "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                       "parameters_and_buffers": n_cparams},
              "steady_train_epoch_cuda": csteady,
              "lockstep_vs_cpu": clock, "lockstep_s": clock_s,
              "prediction_from_own_checkpoint": cown,
              "launches": c_launches, "launches_split": csplit,
              "dispatch": dispatch})

        # -- 12. the flagship SchNet under the pallas aggregation backend,
        #        capped as the wide run, on the card and on the CPU
        t_phase = time.perf_counter()
        pallas_cfg = flagship_config(perc_train=0.5, epochs=WIDE_EPOCHS)
        os.environ["HYDRAGNN_AGGR_BACKEND"] = "pallas"
        try:
            card, cpu, s_launches, ssplit, dispatch, wall_card, wall_cpu = \
                train_phase(torch, hydragnn_torch, pallas_cfg,
                            os.path.join(logs, "pallas"), args.seed,
                            cap=WIDE_CAP)
        finally:
            os.environ["HYDRAGNN_AGGR_BACKEND"] = "fused"
        ssteps, sevals, s_per, sloss_rel = check_training(
            "pallas training", card, cpu, s_launches, ssplit, dispatch,
            loaders, WIDE_CAP, "pallas", backend="pallas")
        hist = card[1]
        emit({"phase": "pallas_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "pallas",
              "batches_per_pass": WIDE_CAP,
              "epochs": len(hist["train"]), "train_steps": ssteps,
              "eval_batches": sevals, "train_loss": hist["train"],
              "val_loss": hist["val"], "train_loss_cpu": cpu[1]["train"],
              "loss_max_rel_err_vs_cpu": sloss_rel,
              "wall_s_cuda": wall_card, "wall_s_cpu": wall_cpu,
              "launches": s_launches, "launches_split": ssplit,
              "dispatch": dispatch})

        # -- 13. DimeNet at the arch sweep's widths, in full on the card;
        #        card against CPU in free runs, capped
        t_phase = time.perf_counter()
        dlogs = os.path.join(logs, "dimenet")
        card, _, dn_launches, dsplit, dispatch, wall_card, _ = train_phase(
            torch, hydragnn_torch, dn_cfg, dlogs, args.seed, cpu_run=False)
        dsteps, devals, dn_per, _ = check_training(
            "dimenet training", card, None, dn_launches, dsplit, dispatch,
            dn_loaders, None, "dimenet")
        for op in ("dn_tri", "dn_row_mlp"):
            check(dispatch.get(f"{op}:fused", 0) > 0
                  and f"{op}:scatter" not in dispatch,
                  f"dimenet: a {op} dispatch left the kernels: {dispatch}")
        dcfg = ModelConfig.from_config(card[2])
        dn_loaders[0].set_epoch(0)
        d3 = [b.to(dev) for _, b in zip(range(REPEAT_STEPS), dn_loaders[0])]
        n_dparams = repeat_bits(torch, dcfg, d3, args.seed, dev)
        dsteady = steady_epoch(torch, dcfg, dn_loaders[0], args.seed, dev)
        t0 = time.perf_counter()
        vcard, vcpu, v_launches, vsplit, vdispatch, _, wall_vcpu = \
            train_phase(torch, hydragnn_torch,
                        dimenet_config(epochs=WIDE_EPOCHS),
                        os.path.join(logs, "dimenet_vs_cpu"), args.seed,
                        cap=DIMENET_CAP)
        _, _, _, dloss_rel = check_training(
            "dimenet vs CPU", vcard, vcpu, v_launches, vsplit, vdispatch,
            dn_loaders, DIMENET_CAP, "dimenet")
        vs_cpu_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        down = own_checkpoint_prediction(
            torch, hydragnn_torch, dn_cfg, os.path.join(dlogs, "cuda"),
            args.seed, "dimenet")
        down_s = time.perf_counter() - t0
        hist = card[1]
        emit({"phase": "dimenet_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "fused",
              "hidden_dim": dcfg.hidden_dim, "num_radial": dcfg.num_radial,
              "num_spherical": dcfg.num_spherical,
              "int_emb_size": dcfg.int_emb_size,
              "epochs": len(hist["train"]), "train_steps": dsteps,
              "eval_batches": devals, "train_loss": hist["train"],
              "val_loss": hist["val"], "test_loss": hist["test"],
              "lr": hist["lr"], "wall_s_cuda": wall_card,
              "epoch_time_s_cuda": hist["epoch_time"],
              "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                       "parameters": n_dparams},
              "steady_train_epoch_cuda": dsteady,
              "vs_cpu": {"batches_per_pass": DIMENET_CAP,
                         "epochs": len(vcard[1]["train"]),
                         "train_loss": vcard[1]["train"],
                         "train_loss_cpu": vcpu[1]["train"],
                         "loss_max_rel_err_vs_cpu": dloss_rel,
                         "wall_s_cpu": wall_vcpu, "seconds": vs_cpu_s},
              "prediction_from_own_checkpoint": down,
              "prediction_s": down_s,
              "launches": dn_launches, "launches_split": dsplit,
              "dispatch": dispatch})

        # -- 14. DimeNet at DimeNet++'s QM9 widths with int_emb_size 128
        #        (the builder branch), in full on the card; the REMAT step;
        #        card against CPU in free runs, capped
        t_phase = time.perf_counter()
        wlogs = os.path.join(logs, "dimenet_wide")
        card, _, w_launches, wsplit, dispatch, wall_card, _ = train_phase(
            torch, hydragnn_torch, dnw_cfg, wlogs, args.seed, cpu_run=False)
        wsteps, wevals, w_per, _ = check_training(
            "dimenet_wide training", card, None, w_launches, wsplit,
            dispatch, dn_loaders, None, "dimenet_wide")
        check(dispatch.get("dn_tri_builder:fused", 0)
              == 4 * (wsteps + wevals) and not any(
                  k.startswith(("dn_tri:", "dn_row_mlp:")) for k in dispatch),
              f"dimenet_wide: an interaction left the builder: {dispatch}")
        wcfg = ModelConfig.from_config(card[2])
        check((wcfg.hidden_dim, wcfg.int_emb_size, wcfg.out_emb_size)
              == (128, 128, 256), f"dimenet_wide widths {wcfg}")
        dn_loaders[0].set_epoch(0)
        w3 = [b.to(dev) for _, b in zip(range(REPEAT_STEPS), dn_loaders[0])]
        n_wparams = repeat_bits(torch, wcfg, w3, args.seed, dev)
        wsteady = steady_epoch(torch, wcfg, dn_loaders[0], args.seed, dev)
        t0 = time.perf_counter()
        remat = remat_check(torch, wcfg, first_dn, args.seed, dev)
        remat_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        w_lock_batches = dimenet_small_batches(
            dn_loaders[0], DIMENET_WIDE_LOCKSTEP_BATCH, REPEAT_STEPS)
        check(all("dn_tri_ok" in b.extras for b in w_lock_batches),
              "dimenet_wide: a lockstep batch carries no dn_tri_ok marker")
        wlock = lockstep(torch, wcfg, w_lock_batches, args.seed, dev)
        wlock_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        wown = own_checkpoint_prediction(
            torch, hydragnn_torch, dnw_cfg, os.path.join(wlogs, "cuda"),
            args.seed, "dimenet_wide")
        wown_s = time.perf_counter() - t0
        hist = card[1]
        emit({"phase": "dimenet_wide_training",
              "seconds": time.perf_counter() - t_phase,
              "entry": "hydragnn_torch.run_training", "backend": "fused",
              "hidden_dim": wcfg.hidden_dim, "num_radial": wcfg.num_radial,
              "num_spherical": wcfg.num_spherical,
              "basis_emb_size": wcfg.basis_emb_size,
              "int_emb_size": wcfg.int_emb_size,
              "out_emb_size": wcfg.out_emb_size,
              "epochs": len(hist["train"]), "train_steps": wsteps,
              "eval_batches": wevals, "train_loss": hist["train"],
              "val_loss": hist["val"], "test_loss": hist["test"],
              "lr": hist["lr"], "wall_s_cuda": wall_card,
              "epoch_time_s_cuda": hist["epoch_time"],
              "bit_identical_repeat": {"steps": REPEAT_STEPS,
                                       "parameters": n_wparams},
              "steady_train_epoch_cuda": wsteady,
              "remat": remat, "remat_s": remat_s,
              "lockstep_batch": DIMENET_WIDE_LOCKSTEP_BATCH,
              "lockstep_vs_cpu": wlock, "lockstep_s": wlock_s,
              "prediction_from_own_checkpoint": wown,
              "prediction_s": wown_s,
              "launches": w_launches, "launches_split": wsplit,
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
        elif k["name"].startswith("egcl_"):
            path, (n_by, per_by) = "egnn_md17", egnn["egnn_md17"]
        elif k["name"].startswith("gat_"):
            path, (n_by, per_by) = "gat", gat["gat"]
        elif k["name"].startswith("cgcnn_"):
            path, n_by, per_by = "cgcnn", c_launches, c_per
        elif k["name"].startswith("dimenet_tri_builder"):
            path, n_by, per_by = "dimenet_wide", w_launches, w_per
        elif k["name"].startswith("dimenet_"):
            path, n_by, per_by = "dimenet", dn_launches, dn_per
        elif k["name"] in ("segment_sum_pallas",) + OFF_PATH:
            path, n_by, per_by = "pallas", s_launches, s_per
        else:
            path, n_by, per_by = paths.get(
                k["name"], ("flagship", flag_launches, flag_per))
        counter = k.get("counter", k["name"])
        n_launch, per = n_by[counter], per_by[counter]
        k["path"] = f"{path} training"
        k["launches"] = n_launch
        k["launches_per_train_step"] = per["per_train_step"]
        k["launches_per_eval_batch"] = per["per_eval_batch"]
        if k["name"] in OFF_PATH:
            # no caller on any path; its CUDA kernel is the one the pallas
            # path launches through segment_sum_pallas
            k["path"] = None
            check(n_launch == 0, f"{k['name']} was launched on a path")
            continue
        check(n_launch > 0, f"{k['name']} was not launched on its path")
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
