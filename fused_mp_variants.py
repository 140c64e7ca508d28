"""Where the gather-multiply kernel's time goes, on the card; and the
alternatives to the poly scatter's and the CSR segment sum's routes 1.

    python3 fused_mp_variants.py [--seed S] [--which gm|rows|path|staged|all]

Run from the root of a checkout on a machine with a CUDA device and
``nvcc``.  It stands beside ``chip_smoke.py``, whose timer (``time_ms``:
median of 50 launches, each between its own CUDA events, behind a device
sleep) it borrows, and builds edited copies of ``csrc/fused_mp.cu`` with
``nvcc`` into ``hydragnn_torch/kernels/_build/variants/`` (gitignored),
each a small change to route 1 of the forward or the fused backward:

- ``empty``: the forward returns at once (the launch and timing floor);
  ``ret_search`` after the share search, ``ret_ids`` after the first
  batch of sender ids;
- ``no_x``, ``no_w``, ``no_store``: the forward without its x gathers,
  its w stream or its row stores;
- ``w_with_ids``: w rows loaded whether or not the sender is in range
  (so they can issue beside the ids);
- ``u4``, ``u16``: 4 or 16 edges' rows in flight a warp (8 in the
  source); ``u16_no_w``: 16 in the no-``w`` mode only;
- ``min3``: at least 3 blocks a SM (``__launch_bounds__``);
  ``min6_no_w``: at least 6 a SM in the no-``w`` mode;
- ``equal_rows``: each warp an equal number of rows, no search;
  ``share_range``: the shares by ``passp::share_range`` and two loads of
  their offsets, the search before ``gm::share_rows``;
- ``l2_bulk``, ``l2_lines``: each share's w rows prefetched into L2 (one
  bulk prefetch, or one prefetch a 128-byte line).

Each copy is held to the source's bits and timed cold (L2 flushed by a
64 MB memset, as chip_smoke does) on a synthetic batch of the flagship's
size (512 graphs of 8-29 nodes, 6-20 in-edges a node, a masked tail),
F = 64: the forward and the fused backward, in both modes, with route 2's
forward beside them.  Then the source's routes after three flushes: the
memset (L2 left dirty, so the timed launch writes its lines back), a
read of 64 MB (L2 left clean) and none (warm).  Prints the card's name
and power limit, the variants' registers and spills, and one JSON line
of medians per case.

``--which rows`` (also part of ``all``) times edited copies of
``csrc/poly_mp.cu`` and of the segment sum in ``csrc/fused_mp.cu`` on
chip_smoke.py's first flagship train batch (its synthetic set, made in a
temporary directory), cold, beside the sources' routes 1 and 2, then the
sources' routes after the other two flushes.  The poly scatter (all
moments, F = 64 and 256; each copy held to route 2's bits): ``empty``
and ``ret_search`` (route 1's launch alone; its share search alone),
``r2_ldcs`` (route 2 with streaming loads in scatter mode).  The segment
sum (the pool, the edge rows over the receivers at F = 64, PNA's tie
counts at F = 128; held to the source within 1e-5 of the largest
entry): ``ss_ldg`` (route 1 with plain loads in place of the streaming
ones), ``ss_empty`` (its launch alone).

``--which path`` (also part of ``all``) trains PNA on the flagship's set
and the dimenet cell's DimeNet (chip_smoke.py's configurations) and
times the poly scatter and the segment sum a launch in profiled epochs
on each route, and the poly scatter with ``r2_ldcs``'s library in place
of the source's.

``--which staged`` (also part of ``all``) holds and times the two
kernels that stage their inputs in shared memory, on chip_smoke.py's
first flagship train batch at F = 64: the unsorted segment sum
(``launch_unsorted_sum``) over three id orders (the senders with the
masked tail out of range, as chip_smoke times it; the receivers with the
padded tail on node N-1, as the ``pallas`` path gives them; a shuffle of
those), its route 1 at its own block count, at the least it takes
(each block owns at most 128 segments), halfway between and at twice
its own, its route 2 (the stable sort and the CSR kernel), the CSR
kernel alone on the sort's schedule and ``index_add_``; and the poly
gather's two routes (``("sum", "cnt")`` and all moments at F = 64, all
moments at F = 128).  Each route 1 is first held to its checks' bits.
Then edited copies of each, timed between the source's runs (held to
the source's bits unless they stop early): ``us_empty``, ``us_ret_span``
and ``us_ret_prefix`` (the unsorted sum's launch alone, and stopped
after its span pass or its prefix), ``us_u8`` (8 rows in flight a warp
in place of 16), ``us_loads1`` (one load of 32 ids at a time in the
counting and placing walks, in place of 8); ``pg_empty`` and
``pg_ret_stage`` (the poly gather's launch alone, and stopped once x's
window is staged), ``pg_ret_codes`` and ``pg_ret_wait`` (stopped once
its edges' read codes are staged, and once the window has landed too,
each kept observable), ``pg_nowalk`` (no edge walked), ``pg_nostore``
(the sum's rows not stored), ``pg_noread`` (no read of the window),
``pg_nocode`` (a constant read code), ``pg_onecol`` (one column's sum
of the four a lane), ``pg_nowin`` (no window: every
sender row read from global memory), ``pg_w40`` (a 40 KB window in place
of 96 KB), ``pg_warps16`` (16 warps a block in place of 32);
``us_u32`` (32 rows in flight).  Prints each kernel's SASS size.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np

import chip_smoke as cs
from hydragnn_torch.kernels import build

SRC = Path(build.CSRC / "fused_mp.cu").read_text()
OUT = build.BUILD_DIR / "variants"

FWD_HEAD = "  if (rb >= re) return;\n"
FWD_SEARCH = """  share_rows(row_ptr, n_rows, blockIdx.x * kWarps + threadIdx.x / kWarp,
             gridDim.x * kWarps, rb, re, p0, p1);"""
BWD_SEARCH = "  share_rows(row_ptr, n_rows, part, n_parts, rb, re, p0, p1);"
X_LOAD = "xv[u] = ldg2(x + static_cast<size_t>(s) * f + col);"
W_LOAD = "wv[u] = ldg2(w + static_cast<size_t>(base + i + u) * f + col);"
PUT = "if (on) st2(out + static_cast<size_t>(r) * f + col, acc);"
W_PRED = """          if (ok[u] && on) {
            """ + X_LOAD + """
            if (MODE == kMulW)
              """ + W_LOAD + """
          }"""
BOUNDS = "__launch_bounds__(kWarp * kWarps)\ngm_"
L2_BULK = """
  if (MODE == kMulW && (threadIdx.x & 31) == 0 && p1 > p0) {
    const unsigned long long a = reinterpret_cast<unsigned long long>(
        w + static_cast<size_t>(p0) * f) & ~15ull;
    const unsigned long long b = reinterpret_cast<unsigned long long>(
        w + static_cast<size_t>(p1) * f);
    const unsigned size = static_cast<unsigned>((b - a + 15) & ~15ull);
    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
                 :: "l"(a), "r"(size) : "memory");
  }"""
L2_LINES = """
  if (MODE == kMulW && p1 > p0) {
    const char* a = reinterpret_cast<const char*>(
        w + static_cast<size_t>(p0) * f);
    const long long bytes = static_cast<long long>(p1 - p0) * f * 4;
    for (long long o = (threadIdx.x & 31) * 128; o < bytes; o += 32 * 128)
      asm volatile("prefetch.global.L2 [%0];" :: "l"(a + o));
  }"""


def _u_no_w(src, u):
    """``u`` edges in flight in the no-w mode only: every use of kU in the
    two kernels becomes a constant of the mode."""
    head, tail = src.split("constexpr int kU = 8;", 1)
    tail = re.sub(r"\bkU\b", f"(MODE == kMulW ? kU : {u})", tail)
    return head + "constexpr int kU = 8;" + tail


def variants():
    """name -> edited source (each holds one substitution set)."""
    equal_fwd = """  { const long long pt = blockIdx.x * kWarps + threadIdx.x / kWarp;
    const long long np = gridDim.x * kWarps;
    rb = static_cast<int>(n_rows * pt / np);
    re = static_cast<int>(n_rows * (pt + 1) / np);
    p0 = __ldg(row_ptr + rb); p1 = __ldg(row_ptr + re); }"""
    equal_bwd = """  { rb = static_cast<int>(static_cast<long long>(n_rows) * part / n_parts);
    re = static_cast<int>(static_cast<long long>(n_rows) * (part + 1) / n_parts);
    p0 = __ldg(row_ptr + rb); p1 = __ldg(row_ptr + re); }"""
    old_fwd = """  passp::share_range(row_ptr, n_rows, blockIdx.x * kWarps + threadIdx.x / kWarp,
                     gridDim.x * kWarps, rb, re);
  p0 = __ldg(row_ptr + rb); p1 = __ldg(row_ptr + re);"""
    old_bwd = """  passp::share_range(row_ptr, n_rows, part, n_parts, rb, re);
  p0 = __ldg(row_ptr + rb); p1 = __ldg(row_ptr + re);"""
    empty_at = ("  const int lane = threadIdx.x & 31;\n  int rb, re, p0, p1;\n"
                "  share_rows(row_ptr, n_rows, blockIdx.x")
    subs = {
        "empty": [(empty_at, "  if (n_rows > 0) return;\n" + empty_at)],
        "ret_search": [(FWD_HEAD, "  if (rb > re || p0 > p1) out[0] = 1.f;"
                                  "\n  return;\n")],
        "ret_ids": [(FWD_HEAD, FWD_HEAD + """  {
    const int sx = p0 + (threadIdx.x & 31) < p1
        ? __ldg(senders + p0 + (threadIdx.x & 31)) : -1;
    if (sx == -7) out[0] = 1.f;
    return;
  }
""")],
        "no_x": [(X_LOAD, "xv[u] = make_float2(1.f, 1.f);")],
        "no_w": [(W_LOAD, "wv[u] = make_float2(1.f, 1.f);")],
        "no_store": [(PUT, "if (on && acc.x == 12345.f) "
                           "st2(out + static_cast<size_t>(r) * f + col, acc);")],
        "w_with_ids": [(W_PRED, """          if (ok[u] && on) """ + X_LOAD + """
          if (MODE == kMulW && i + u < cnt && on) """ + W_LOAD)],
        "u4": [("constexpr int kU = 8;", "constexpr int kU = 4;")],
        "u16": [("constexpr int kU = 8;", "constexpr int kU = 16;")],
        "min3": [(BOUNDS, "__launch_bounds__(kWarp * kWarps, 3)\ngm_")],
        "min6_no_w": [(BOUNDS, "__launch_bounds__(kWarp * kWarps, "
                               "MODE == kMask ? 6 : 1)\ngm_")],
        "equal_rows": [(FWD_SEARCH, equal_fwd), (BWD_SEARCH, equal_bwd)],
        "share_range": [(FWD_SEARCH, old_fwd), (BWD_SEARCH, old_bwd)],
        "l2_bulk": [(FWD_HEAD, FWD_HEAD + L2_BULK[1:] + "\n")],
        "l2_lines": [(FWD_HEAD, FWD_HEAD + L2_LINES[1:] + "\n")],
    }
    out = {"source": SRC, "u16_no_w": _u_no_w(SRC, 16)}
    for name, pairs in subs.items():
        s = SRC
        for a, b in pairs:
            if a not in s:
                raise RuntimeError(f"variant {name}: the source changed "
                                   f"({a.splitlines()[0]!r} not found)")
            s = s.replace(a, b)
        out[name] = s
    return out


def build_variants(sources):
    """One nvcc per variant, all started together; the loaded libraries
    and each kernel's registers and spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, s in sources.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(s)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-o", str(OUT / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{log}")
        regs[name] = {r["kernel"].split("gm_")[-1][:20]: (
            r["registers"], r["spill_stores"])
            for r in cs.ptxas_report(log, ("gm_fwd", "gm_bwd"))}
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        for fn, argtypes in build.SIGNATURES["fused_mp"].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def synthetic_batch(seed):
    """Collate-shaped ids of 512 graphs of 8-29 nodes, each node 6-20
    in-edges from other nodes of its graph, receivers sorted, a masked
    tail of 5000 edges parked on a padding node, the sender argsort."""
    rng = np.random.RandomState(seed)
    send, recv, off = [], [], 0
    for _ in range(512):
        size = int(rng.randint(8, 30))
        for i in range(size):
            d = min(size - 1, int(rng.randint(6, 21)))
            src = rng.choice([j for j in range(size) if j != i], d,
                             replace=False)
            send.append(src + off)
            recv.append(np.full(d, i + off))
        off += size
    n = off + 1
    send, recv = np.concatenate(send), np.concatenate(recv)
    e = len(send) + 5000
    s = np.full(e, n - 1, np.int32)
    r = np.full(e, n - 1, np.int32)
    s[:len(send)], r[:len(send)] = send, recv
    m = np.zeros(e, np.float32)
    m[:len(send)] = 1.0
    return n, s, r, m, np.argsort(s, kind="stable").astype(np.int32)


class ReadFlush:
    """A stand-in for ``time_ms``'s flush buffer whose ``zero_`` reads
    64 MB instead of writing it, leaving L2 clean."""

    def __init__(self, torch, dev):
        self.buf = torch.ones(16 << 20, device=dev)
        self.sink = torch.empty((), device=dev)
        self.torch = torch

    def zero_(self):
        self.torch.sum(self.buf, dim=0, out=self.sink)


POLY_SRC = Path(build.CSRC / "poly_mp.cu").read_text()
SS_BOUNDS = "  const int q0 = __ldg(row_ptr + sb), q1 = __ldg(row_ptr + se);\n"


# variants that compute nothing whole: timed, not held to the bits
PARTIAL = ("empty", "ret_search", "ss_empty")
# variants of route 2 (the others edit route 1)
ON_ROUTE2 = ("r2_ldcs",)


def row_variants():
    """(poly_mp sources, fused_mp sources): name -> edited source."""
    search = ("  walk::share_rows(row_ptr, n_rows, blockIdx.x * kWarps + "
              "threadIdx.x / kWarp,\n                   gridDim.x * kWarps, "
              "rb, re, p0, p1);\n")
    poly = {"source": POLY_SRC}
    for name, (a, b) in {
            "empty": (search, "  if (n_rows > 0) return;\n" + search),
            "ret_search": (search, search + "  if (rb > re || p0 > p1) "
                           "o_cnt[0] = 1.f;\n  return;\n"),
            "r2_ldcs": ("(MODE == kGather ? __fmul_rn(r[c], m) : r[c])",
                        "(MODE == kGather ? __fmul_rn(r[c], m)\n"
                        "                                : __ldcs(r + c))"),
    }.items():
        if a not in POLY_SRC:
            raise RuntimeError(f"variant {name}: the source changed ({a!r})")
        poly[name] = POLY_SRC.replace(a, b)
    segs = {"source": SRC}
    for name, (a, b) in {
            "ss_ldg": ("v[u][j] = walk::ldcs2(data",
                       "v[u][j] = walk::ldg2(data"),
            "ss_empty": (SS_BOUNDS, SS_BOUNDS + "  if (n_seg > 0) return;\n"),
    }.items():
        if a not in SRC:
            raise RuntimeError(f"variant {name}: the source changed ({a!r})")
        segs[name] = SRC.replace(a, b)
    return poly, segs


def build_sources(kind, sources, kernel_keys):
    """One nvcc per source of ``csrc/<kind>.cu``'s variants, all started
    together: the loaded libraries and each kernel's registers and
    spills."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, s in sources.items():
        cu = OUT / f"{kind}_{name}.cu"
        cu.write_text(s)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-I",
             str(build.CSRC), "-o", str(OUT / f"lib{kind}_{name}.so"),
             str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, regs = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc {kind} {name} failed:\n{log}")
        regs[name] = [(r["kernel"][:60], r["registers"], r["spill_stores"])
                      for r in cs.ptxas_report(log, kernel_keys)]
        lib = ctypes.CDLL(str(OUT / f"lib{kind}_{name}.so"))
        for fn, argtypes in build.SIGNATURES[kind].items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs, regs


def flagship_batch(seed):
    """chip_smoke.py's first train batch of the flagship (its synthetic
    BCC set and loader, made in a temporary directory), on the CPU."""
    import copy
    import os
    import tempfile

    from hydragnn_torch.data.load_data import dataset_loading_and_splitting
    from hydragnn_torch.data.synthetic import deterministic_graph_data

    here = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_",
                                     dir=cs.ROOT) as work:
        os.chdir(work)
        os.environ["SERIALIZED_DATA_PATH"] = work
        try:
            deterministic_graph_data(
                "dataset/chip_smoke",
                number_configurations=cs.N_CONFIGURATIONS,
                unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
                unit_cell_z_range=(1, 3), seed=seed)
            loader = dataset_loading_and_splitting(copy.deepcopy(
                cs.flagship_config(perc_train=0.5,
                                   epochs=cs.TRAIN_EPOCHS)), seed=seed)[0]
            loader.set_epoch(0)
            return next(iter(loader))
        finally:
            os.chdir(here)


def rows_main(torch, dev, seed, flush):
    """The poly scatter's and the segment sum's variants (``--which
    rows``)."""
    from hydragnn_torch.ops.aggregate import segment_offsets

    poly_src, seg_src = row_variants()
    plibs, pregs = build_sources("poly_mp", poly_src, ("poly_scatter",))
    slibs, sregs = build_sources("fused_mp", seg_src, ("seg_sum_kernel",))
    print(json.dumps({"registers_spills": {"poly_mp": pregs,
                                           "fused_mp": sregs}}), flush=True)
    g = flagship_batch(seed)
    n, n_graphs = g.num_nodes, g.num_graphs
    r = g.receivers.numpy()
    gen = torch.Generator(device=dev).manual_seed(seed)
    recv, mask = g.receivers.to(dev), g.edge_mask.to(dev)
    gid = g.node_gid.to(dev)
    ptr = segment_offsets(recv, n, mask)
    pool_ptr = segment_offsets(gid, n_graphs)
    st = torch.cuda.current_stream().cuda_stream
    times = {}

    def rec(key, fn, fl=flush):
        times.setdefault(key, []).append(cs.time_ms(torch, fn, fl,
                                                    lead=True))

    # the sources' routes after a read of 64 MB (L2 left clean) and warm
    others = (("read", ReadFlush(torch, dev)), ("warm", None))

    # the poly scatter, all moments, route 1 of each source and route 2
    for f in (64, 256):
        data = (torch.randn(len(r), f, device=dev, generator=gen) * 2
                ).round() / 2
        outs = [torch.empty(len(ptr) - 1, w_, device=dev)
                for w_ in (f, f, 2 * f)] + [torch.empty(len(ptr) - 1,
                                                        device=dev)]

        def call(lib, route, data=data, outs=outs, f=f):
            return lambda: lib.hg_poly_segment_f32(
                data.data_ptr(), None, None, ptr.data_ptr(),
                *[o.data_ptr() for o in outs], n, len(r), f, 0, route, 0,
                st)

        call(plibs["source"], 2)()
        torch.cuda.synchronize()
        want = [o.clone() for o in outs]
        for _ in range(2):
            for name, lib in plibs.items():
                route = 2 if name in ON_ROUTE2 else 1
                call(lib, route)()
                torch.cuda.synchronize()
                cs.check(name in PARTIAL or all(
                    torch.equal(a, b) for a, b in zip(outs, want)),
                    f"poly variant {name} is not route 2's bits")
                rec(f"poly_F{f}/{name}", call(lib, route))
            rec(f"poly_F{f}/route2", call(plibs["source"], 2))
            for fl_name, fl in others:
                for route in (1, 2):
                    rec(f"poly_F{f}/route{route}/{fl_name}",
                        call(plibs["source"], route), fl)
    # the segment sum at three shapes
    x = torch.randn(len(gid), 64, device=dev, generator=gen)
    w = torch.randn(len(r), 64, device=dev, generator=gen) * mask[:, None]
    ties = (torch.rand(len(r), 128, device=dev, generator=gen) < 0.1
            ).float()
    for shape, data, rp in (("pool", x, pool_ptr), ("edges", w, ptr),
                            ("pna_ties", ties, ptr)):
        out = torch.empty(len(rp) - 1, data.shape[1], device=dev)

        def call(lib, route, data=data, rp=rp, out=out):
            return lambda: lib.hg_segment_sum_rows_f32(
                data.data_ptr(), None, rp.data_ptr(), out.data_ptr(),
                data.shape[0], len(rp) - 1, data.shape[1], 2**31 - 1, route,
                0, st)

        call(slibs["source"], 1)()
        torch.cuda.synchronize()
        want = out.clone()
        for _ in range(2):
            for name, lib in slibs.items():
                route = 2 if name in ON_ROUTE2 else 1
                call(lib, route)()
                torch.cuda.synchronize()
                err = float((out - want).abs().max()) / float(
                    want.abs().max())
                cs.check(name in PARTIAL or err <= 1e-5,
                         f"segment-sum variant {name}: {err}")
                rec(f"seg_{shape}/{name}", call(lib, route))
            rec(f"seg_{shape}/route2", call(slibs["source"], 2))
            for fl_name, fl in others:
                for route in (1, 2):
                    rec(f"seg_{shape}/route{route}/{fl_name}",
                        call(slibs["source"], route), fl)
    print(json.dumps({"row_variants_ms": {
        k: statistics.median(v) for k, v in times.items()},
        "N": n, "E": len(r), "E_valid": int(g.edge_mask.sum()),
        "G": n_graphs}), flush=True)


def staged_variants():
    """(poly_mp sources, fused_mp sources) of ``--which staged``: name ->
    edited source.  Names in ``PARTIAL_STAGED`` stop early and are timed,
    not held to the bits."""
    us_zero = ("  for (int i = threadIdx.x; i < kSegs * kWarps; i += kThreads)"
               " base[i] = 0;\n")
    us_parts = "  // the warps' equal parts of [lo, hi]: where each counts"
    us_zeros = ("  // the block's empty segments: zeros (the walks write the "
                "others)\n  for (int t = wid;")
    pg_top = "  const int nr = r1 - r0;  // <= kRows\n"
    pg_staged = "  window_wait(&bar);\n  __syncthreads();\n"
    pg_cnt = ("  if (o_cnt != nullptr)\n    for (int r = threadIdx.x; r < nr; "
              "r += kThreads)\n")
    # stop, but keep what was staged observable (a store that never runs)
    pg_codes_seen = ("  if (n_rows > 0) {\n    if (code_s[threadIdx.x].x == "
                     "0x7fffffff) o_cnt[0] = 0.f;\n    return;\n  }\n")
    pg_window_seen = ("  if (n_rows > 0) {\n    if (code_s[threadIdx.x].x == "
                      "0x7fffffff || xs[threadIdx.x].x == 1.2345e-30f)\n"
                      "      o_cnt[0] = 0.f;\n    return;\n  }\n")
    ret = "  if (n_rows > 0) return;\n"
    poly = {"source": POLY_SRC}
    for name, (a, b) in {
            "pg_empty": (pg_top, pg_top + ret),
            "pg_ret_stage": (pg_staged, pg_staged + ret),
            "pg_nowin": ("constexpr int kXBytes = 96 * 1024;",
                         "constexpr int kXBytes = 0;"),
            "pg_w40": ("constexpr int kXBytes = 96 * 1024;",
                       "constexpr int kXBytes = 40 * 1024;"),
            "pg_ret_codes": (pg_cnt, pg_codes_seen + pg_cnt),
            "pg_ret_wait": (pg_staged, pg_staged + pg_window_seen),
            "pg_nostore": ("      if (M & kSum) *reinterpret_cast<float4*>("
                           "o_sum",
                           "      if ((M & kSum) && s.x == 1.2345e-30f) "
                           "*reinterpret_cast<float4*>(o_sum"),
            "pg_noread": ("cm.x >= 0 ? xs[cm.x + (col >> 2)]",
                          "cm.x >= 0 ? make_float4(__int_as_float(cm.x), 0.f,"
                          " 0.f, 0.f)"),
            "pg_nowalk": ("  const int ea = rp_s[ra], eb = rp_s[rb];",
                          "  const int ea = rp_s[ra], eb = ea;"),
            "pg_nocode": ("    return k < kEdgeCap ? code_s[k]\n",
                          "    return k < kEdgeCap ? make_int2(0, 0x3f800000)"
                          "\n"),
            "pg_onecol": ("        s.y += v.y;\n        s.z += v.z;\n"
                          "        s.w += v.w;\n", ""),
            "pg_warps16": ("constexpr int kWarps = 32;                // "
                           "warps a block",
                           "constexpr int kWarps = 16;"),
    }.items():
        if a not in POLY_SRC:
            raise RuntimeError(f"variant {name}: the source changed ({a!r})")
        poly[name] = POLY_SRC.replace(a, b)
    segs = {"source": SRC}
    ret = "  if (n_seg > 0) return;\n"
    for name, (a, b) in {
            "us_empty": (us_zero, ret + us_zero),
            "us_ret_span": (us_parts, ret + us_parts),
            "us_ret_prefix": (us_zeros, ret + us_zeros),
            "us_u8": ("constexpr int kRowsInFlight = 16; ",
                      "constexpr int kRowsInFlight = 8;  "),
            "us_loads1": ("constexpr int kIdLoads = 8; ",
                          "constexpr int kIdLoads = 1; "),
            "us_u32": ("constexpr int kRowsInFlight = 16; ",
                       "constexpr int kRowsInFlight = 32; "),
    }.items():
        if SRC.count(a) != 1:
            raise RuntimeError(f"variant {name}: the source changed ({a!r})")
        segs[name] = SRC.replace(a, b)
    return poly, segs


def sass_sizes(lib, keys):
    """Instructions of each kernel in ``lib`` whose name holds one of
    ``keys`` (``cuobjdump -sass``), by mangled name."""
    from torch.utils.cpp_extension import CUDA_HOME

    out = subprocess.run(
        [os.path.join(CUDA_HOME, "bin", "cuobjdump"), "-sass", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True).stdout
    sizes, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = m.group(1) if any(k in m.group(1) for k in keys) else None
            if cur:
                sizes[cur[-60:]] = 0
        elif cur and re.match(r"\s+/\*[0-9a-f]{4,}\*/", line):
            sizes[cur[-60:]] += 1
    return sizes


PARTIAL_STAGED = ("pg_empty", "pg_ret_stage", "pg_ret_codes", "pg_ret_wait",
                  "pg_nostore", "pg_noread", "pg_nowalk", "pg_nocode",
                  "pg_onecol", "us_empty", "us_ret_span", "us_ret_prefix")


def staged_main(torch, dev, seed, flush):
    """The unsorted segment sum's and the poly gather's routes
    (``--which staged``) on the flagship's first train batch, F = 64:
    each route 1 held to its checks' bits, then timed cold (memset flush)
    and warm beside route 2, in the order 1 2 2 1."""
    from hydragnn_torch.ops import aggregate as ag
    from hydragnn_torch.ops import fused_mp as fm
    from hydragnn_torch.ops import poly_mp as pm

    poly_src, seg_src = staged_variants()
    plibs, pregs = build_sources("poly_mp", poly_src, ("poly_gather_kernel",))
    slibs, sregs = build_sources("fused_mp", seg_src, ("us_sum_kernel",))
    print(json.dumps({"registers_spills": {"poly_mp": pregs,
                                           "fused_mp": sregs}}), flush=True)
    print(json.dumps({"sass_instructions": {
        kind: sass_sizes(OUT / f"lib{kind}_source.so", keys)
        for kind, keys in (("poly_mp", ("poly_gather_kernel",
                                        "poly_segment_kernel")),
                           ("fused_mp", ("us_sum_kernel",
                                         "seg_sum_kernel")))}}),
          flush=True)
    st = torch.cuda.current_stream().cuda_stream
    g = flagship_batch(seed)
    n, e, f = g.num_nodes, g.num_edges, 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    send, recv = g.senders.to(dev), g.receivers.to(dev)
    mask = g.edge_mask.to(dev)
    real = mask != 0
    times, shapes = {}, {}

    def rec(key, fn, fl=flush, lead=True):
        times.setdefault(key, []).append(cs.time_ms(torch, fn, fl,
                                                    lead=lead))

    # the unsorted sum over three id orders: chip_smoke's timed row (the
    # senders, the masked tail out of range), the path's own (the
    # receivers, the padded tail on node N-1) and a shuffle of those
    data = torch.randn(e, f, device=dev, generator=gen)
    order = torch.randperm(e, device=dev, generator=gen)
    for name, ids in (
            ("senders", torch.where(real, send, n + torch.arange(
                e, device=dev, dtype=torch.int32) % 3)),
            ("receivers", recv), ("shuffled", recv[order].contiguous())):
        perm, ptr = ag.sort_schedule(ids, n)
        nb = fm.unsorted_sum_blocks(e, n, f)
        r1, p_dbg, rp_dbg = fm.launch_unsorted_sum(data, ids, n,
                                                   debug=True)
        csr = fm.launch_segment_sum_rows(data, ptr, n, perm=perm, route=1,
                                         n_blocks=nb)
        torch.cuda.synchronize()
        q = int(ptr[-1])
        cs.check(torch.equal(rp_dbg, ptr) and torch.equal(p_dbg[:q],
                                                          perm[:q]),
                 f"unsorted sum {name}: the schedule is not the sort's")
        cs.check(torch.equal(r1, csr), f"unsorted sum {name}: route 1 is "
                 "not the CSR kernel's bits at its block count")
        ok = (ids >= 0) & (ids < n)
        lib_data, lib_ids = data[ok].contiguous(), ids[ok].long()
        cases = {
            "route1": lambda ids=ids: fm.launch_unsorted_sum(data, ids, n),
            "route2": lambda ids=ids: fm.launch_unsorted_sum(data, ids, n,
                                                             route=2),
            "csr_kernel": lambda perm=perm, ptr=ptr: (
                fm.launch_segment_sum_rows(data, ptr, n, perm=perm)),
            "index_add": lambda a=lib_data, b=lib_ids: torch.zeros(
                n, f, device=dev).index_add_(0, b, a)}
        # fewer blocks read the ids fewer times, more fill the card twice
        least = -(-n // ag.UNSORTED_SEGS_PER_BLOCK)
        for blocks in sorted({least, max(least, (nb + least) // 2),
                              2 * nb} - {nb}):
            cases[f"route1_blocks{blocks}"] = (
                lambda ids=ids, blocks=blocks: fm.launch_unsorted_sum(
                    data, ids, n, n_blocks=blocks))
        # route 2 and index_add_ are several launches each: the host's
        # enqueueing may fall inside their timed intervals
        several = ("route2", "index_add")
        for key in list(cases) + list(cases)[::-1]:
            rec(f"us_{name}/{key}", cases[key], lead=key not in several)
        for key in ("route1", "route2"):
            rec(f"us_{name}/{key}/warm", cases[key], None,
                lead=key not in several)
        shapes[f"us_{name}"] = {"rows_summed": q, "blocks": nb}
        # the edited copies, each between the source's runs
        out = torch.empty(n, f, device=dev)
        for var, lib in list(slibs.items()) + [("source", slibs["source"])]:
            call = (lambda lib=lib, ids=ids: lib.hg_unsorted_sum_f32(
                data.data_ptr(), ids.data_ptr(), out.data_ptr(), None, None,
                e, n, f, 0, st))
            call()
            torch.cuda.synchronize()
            cs.check(var in PARTIAL_STAGED or torch.equal(out, r1),
                     f"unsorted sum {name}: variant {var} changed the bits")
            rec(f"us_{name}/variant/{var}", call)
    # the poly gather: SAGE's sum + cnt and all moments at F = 64, and
    # all moments at F = 128
    ptr = ag.segment_offsets(recv, n, mask)
    for fw, moments in ((64, ("sum", "cnt")), (64, pm.MOMENT_ORDER),
                        (128, pm.MOMENT_ORDER)):
        x = (torch.randn(n, fw, device=dev, generator=gen) * 2).round() / 2
        launch = {r: (lambda r=r, x=x, moments=moments:
                      pm.launch_poly_segment(x, send, mask, ptr, n, moments,
                                             "gather_poly_segment", route=r))
                  for r in (1, 2)}
        a, b = launch[1](), launch[2]()
        torch.cuda.synchronize()
        key = f"pg_F{fw}_{'_'.join(moments)}"
        cs.check(all(torch.equal(u, v) for u, v in zip(a, b)),
                 f"{key}: route 1 is not route 2's bits")
        for r in (1, 2, 2, 1):
            rec(f"{key}/route{r}", launch[r])
        for r in (1, 2):
            rec(f"{key}/route{r}/warm", launch[r], None)
        outs = [torch.empty(n, w_, device=dev) for w_ in (fw, fw, 2 * fw)]
        outs.append(torch.empty(n, device=dev))
        want = dict(zip(pm.MOMENT_ORDER, outs))
        ptrs = [want[m].data_ptr() if m in moments else None
                for m in pm.MOMENT_ORDER]
        for var, lib in list(plibs.items()) + [("source", plibs["source"])]:
            call = (lambda lib=lib, x=x, ptrs=ptrs, fw=fw: (
                lib.hg_poly_segment_f32(
                    x.data_ptr(), send.data_ptr(), mask.data_ptr(),
                    ptr.data_ptr(), *ptrs, n, n, fw, 1, 1, 0, st)))
            call()
            torch.cuda.synchronize()
            cs.check(var in PARTIAL_STAGED or all(
                torch.equal(want[m], u) for m, u in zip(moments, a)),
                f"{key}: variant {var} changed the bits")
            rec(f"{key}/variant/{var}", call)
    print(json.dumps({"staged_ms": {
        k: statistics.median(v) for k, v in times.items()},
        "N": n, "E": e, "E_valid": int(real.sum()), "shapes": shapes}),
        flush=True)


def path_cells(seed, work):
    """PNA on chip_smoke.py's flagship set and its dimenet cell, in the
    directory ``work``: name -> (model config, train loader)."""
    import copy
    import os

    from hydragnn_torch.data.load_data import dataset_loading_and_splitting
    from hydragnn_torch.data.synthetic import deterministic_graph_data
    from hydragnn_torch.models.base import ModelConfig

    os.chdir(work)
    os.environ["SERIALIZED_DATA_PATH"] = work
    os.environ["HYDRAGNN_AGGR_BACKEND"] = "fused"
    deterministic_graph_data(
        "dataset/chip_smoke", number_configurations=cs.N_CONFIGURATIONS,
        unit_cell_x_range=(2, 4), unit_cell_y_range=(2, 4),
        unit_cell_z_range=(1, 3), seed=seed)
    cs.write_dimenet_data(seed)
    cells = {}
    for name, cfg in (
            ("pna", cs.flagship_config(perc_train=0.5, epochs=cs.TRAIN_EPOCHS,
                                       model_type="PNA")),
            ("dimenet", cs.dimenet_config()),
            ("dimenet_wide", cs.dimenet_wide_config())):
        loaders = dataset_loading_and_splitting(copy.deepcopy(cfg), seed=seed)
        cells[name] = (ModelConfig.from_config(loaders[3]), loaders[0])
    return cells


def path_main(torch, dev, seed):
    """The poly scatter's and the segment sum's time a launch in profiled
    train epochs of PNA and DimeNet (``--which path``): each kernel
    library swapped for an edited copy, or route 2 forced on the path's
    launches (chip_smoke.first_design_on_path), in the order A B C C B A
    over the same epoch's batches."""
    import tempfile

    from hydragnn_torch.models.create import create_model
    from hydragnn_torch.train.optimizer import select_optimizer
    from hydragnn_torch.train.trainer import (
        _run_epoch,
        create_train_state,
        make_train_step,
    )

    poly_src, seg_src = row_variants()
    plibs, _ = build_sources("poly_mp", {k: poly_src[k] for k in (
        "source", "r2_ldcs")}, ("poly_",))
    slib = build_sources("fused_mp", {"source": seg_src["source"]},
                         ("seg_sum_kernel",))[0]["source"]
    build.load_library("fused_mp")   # every library built and loaded
    # (kernel, case) -> (library name, library, route 2 forced)
    cases = {
        ("segment_poly_dense", "route1"): ("poly_mp", plibs["source"], False),
        ("segment_poly_dense", "route2"): ("poly_mp", plibs["source"], True),
        ("segment_poly_dense", "r2_ldcs"): ("poly_mp", plibs["r2_ldcs"],
                                            True),
        ("segment_sum_dense", "route1"): ("fused_mp", slib, False),
        ("segment_sum_dense", "route2"): ("fused_mp", slib, True),
    }
    here = os.getcwd()
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_variants_",
                                     dir=cs.ROOT) as work:
        try:
            cells = path_cells(seed, work)
            for cell, (cfg, loader) in cells.items():
                model = create_model(cfg, seed=seed).to(dev)
                spec = select_optimizer({"type": "AdamW",
                                         "learning_rate": 1e-3})
                state = create_train_state(model, spec)
                step = make_train_step(model, cfg, spec)
                for epoch in (0, 1):
                    loader.set_epoch(epoch)
                    state, acc = _run_epoch(step, state, loader, True, dev)
                    float(acc[2])
                keys = [k for k in cases
                        if cell == "pna" or k[0] == "segment_sum_dense"]
                for key in keys + keys[::-1]:
                    kernel, _ = key
                    lib_name, lib, forced = cases[key]
                    own = build._loaded[lib_name]
                    build._loaded[lib_name] = lib
                    try:
                        with (cs.first_design_on_path(kernel) if forced
                              else contextlib.nullcontext()):
                            state, rows, _ = cs.profiled_epoch(
                                torch, step, state, loader, dev, 2)
                    finally:
                        build._loaded[lib_name] = own
                    got = cs.routed_kernels(rows, kernel)
                    rec = out.setdefault(f"{cell}/{kernel}/{key[1]}", {})
                    rec.setdefault("ms_per_epoch", []).append(
                        sum(v["ms_per_epoch"] for v in got.values()))
                    for name, v in got.items():
                        rec.setdefault(name, []).append(v["us_per_launch"])
        finally:
            os.chdir(here)
    print(json.dumps({"path_ms_per_epoch_and_us_per_launch": {
        k: {c: statistics.median(v) for c, v in rec.items()}
        for k, rec in out.items()}}), flush=True)


def main():
    import torch

    from hydragnn_torch.ops import fused_mp as fm
    from hydragnn_torch.ops.aggregate import segment_offsets

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--which", choices=("gm", "rows", "path", "staged",
                                        "all"),
                    default="all")
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
    if args.which in ("rows", "all"):
        rows_main(torch, dev, args.seed,
                  torch.empty(64 << 20, dtype=torch.uint8, device=dev))
    if args.which in ("path", "all"):
        path_main(torch, dev, args.seed)
    if args.which in ("staged", "all"):
        staged_main(torch, dev, args.seed,
                    torch.empty(64 << 20, dtype=torch.uint8, device=dev))
    if args.which in ("rows", "path", "staged"):
        return
    libs, regs = build_variants(variants())
    print(json.dumps({"registers_spills": regs}), flush=True)

    n, s, r, m, p = synthetic_batch(args.seed)
    f = 64
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(n, f, device=dev, generator=gen)
    ct = torch.randn(n, f, device=dev, generator=gen)
    send, recv = torch.from_numpy(s).to(dev), torch.from_numpy(r).to(dev)
    mask, perm = torch.from_numpy(m).to(dev), torch.from_numpy(p).to(dev)
    w = torch.randn(len(s), f, device=dev, generator=gen) * mask[:, None]
    ptr = segment_offsets(recv, n, mask)
    ptr_s = segment_offsets(send[perm.long()], n, mask[perm.long()])
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    out = torch.empty(n, f, device=dev)
    dx = torch.empty(n, f, device=dev)
    dw = torch.empty(len(s), f, device=dev)

    def fwd(lib, has_w):
        return lambda: lib.hg_gather_mul_segment_sum_f32(
            x.data_ptr(), w.data_ptr() if has_w else None,
            None if has_w else mask.data_ptr(), send.data_ptr(),
            ptr.data_ptr(), out.data_ptr(), n, n, f, int(has_w), 1, st)

    def bwd(lib, has_w):
        return lambda: lib.hg_gather_mul_bwd_f32(
            ct.data_ptr(), x.data_ptr(), w.data_ptr() if has_w else None,
            None if has_w else mask.data_ptr(), perm.data_ptr(),
            recv.data_ptr(), ptr_s.data_ptr(), dx.data_ptr(),
            dw.data_ptr() if has_w else None, n, n, len(s), f, int(has_w),
            st)

    want = {}
    for has_w in (True, False):
        fwd(libs["source"], has_w)()
        bwd(libs["source"], has_w)()
        torch.cuda.synchronize()
        want[has_w] = (out.clone(), dx.clone(), dw.clone() if has_w else None)
    times = {}
    # the source, each variant, the source again; twice
    order = list(libs) + ["source"]
    for _ in range(2):
        for name in order:
            lib = libs[name]
            for has_w in (True, False):
                tag = "w" if has_w else "no_w"
                fwd(lib, has_w)()
                bwd(lib, has_w)()
                torch.cuda.synchronize()
                if name not in ("empty", "ret_search", "ret_ids", "no_x",
                                "no_w", "no_store"):
                    o, d, dwant = want[has_w]
                    cs.check(torch.equal(out, o) and torch.equal(dx, d)
                             and (dwant is None or torch.equal(dw, dwant)),
                             f"variant {name} changed the bits")
                rec = times.setdefault(name, {})
                rec.setdefault(f"fwd_{tag}", []).append(
                    cs.time_ms(torch, fwd(lib, has_w), flush, lead=True))
                rec.setdefault(f"bwd_{tag}", []).append(
                    cs.time_ms(torch, bwd(lib, has_w), flush, lead=True))
                if has_w:
                    rec.setdefault("fwd_w_warm", []).append(
                        cs.time_ms(torch, fwd(lib, has_w), lead=True))
        for has_w in (True, False):
            times.setdefault("route2", {}).setdefault(
                f"fwd_{'w' if has_w else 'no_w'}", []).append(cs.time_ms(
                    torch, lambda: fm.launch_gather_mul(
                        x, w if has_w else None, None if has_w else mask,
                        send, ptr, route=2), flush, lead=True))
    print(json.dumps({"variants_ms": {
        k: {c: statistics.median(v) for c, v in rec.items()}
        for k, rec in times.items()}}), flush=True)

    # the source's routes after each flush
    w_s, recv_s = w[perm.long()].contiguous(), recv[perm.long()].contiguous()
    cases = {
        "fwd_route1": lambda: fm.launch_gather_mul(x, w, None, send, ptr,
                                                   route=1),
        "fwd_route2": lambda: fm.launch_gather_mul(x, w, None, send, ptr,
                                                   route=2),
        "bwd_fused": lambda: fm.launch_gather_mul_bwd(ct, x, w, None, perm,
                                                      recv, ptr_s),
        "bwd_route2_dx": lambda: fm.launch_gather_mul(ct, w_s, None, recv_s,
                                                      ptr_s, route=2),
    }
    flushes = {"memset": flush, "read": ReadFlush(torch, dev), "warm": None}
    by_flush = {}
    for _ in range(2):
        for fl_name, fl in flushes.items():
            for name, fn in cases.items():
                by_flush.setdefault(f"{name}/{fl_name}", []).append(
                    cs.time_ms(torch, fn, fl, lead=True))
    print(json.dumps({"flush_ms": {k: statistics.median(v)
                                   for k, v in by_flush.items()},
                      "N": n, "E": len(s), "E_valid": int(m.sum()),
                      "F": f}), flush=True)


if __name__ == "__main__":
    main()
