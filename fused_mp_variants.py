"""Where the gather-multiply kernel's time goes, on the card.

    python3 fused_mp_variants.py [--seed S]

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
"""

from __future__ import annotations

import argparse
import ctypes
import json
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


def main():
    import torch

    from hydragnn_torch.ops import fused_mp as fm
    from hydragnn_torch.ops.aggregate import segment_offsets

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    cs.check(torch.cuda.is_available(), "no CUDA device")
    dev = torch.device("cuda")
    print(cs.smi_line(), flush=True)
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
