"""Build and load the port's CUDA kernels (nvcc -> shared library -> ctypes).

Each ``csrc/*.cu`` source has a plain C interface and compiles on its own
with ``nvcc`` for ``sm_90a`` into ``kernels/_build/`` (listed in
.gitignore), on first use and only from the sources in the checkout.  The
library file name carries a hash of the source and flags, so an edited
source rebuilds and a stale library is never loaded.  :func:`build_all`
starts one ``nvcc`` per source, all at once, and waits for them.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "kernels" / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# source name -> {C function: argtypes}; every pointer and the stream are
# c_void_p (ctypes would otherwise pass them as 32-bit ints), a float is
# c_float, every C function returns its launch's cudaError_t
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "fused_mp": {
        # x, w, mask, senders, row_ptr, out, n_rows, n_src, f, has_w, route,
        # stream
        "hg_gather_mul_segment_sum_f32": (_P,) * 6 + (_I,) * 5 + (_P,),
        # g, x, w, mask, perm, receivers, row_ptr, dx, dw, n_rows, n_src,
        # n_edges, f, has_w, stream
        "hg_gather_mul_bwd_f32": (_P,) * 9 + (_I,) * 5 + (_P,),
        # f
        "hg_gather_mul_route": (_I,),
        # data, perm, row_ptr, out, n_seg, f, max_rows, stream
        "hg_segment_sum_rows_f32": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
    "scf_mp": {
        # x, rbf, cm, gidx, rowid, perm, row_ptr, w0, b0, w1, b1, out,
        # n_rows, f, g, route, stream
        "hg_scf_filter_gather_f32": (_P,) * 12 + (_I,) * 4 + (_P,),
        # f, g
        "hg_scf_fwd_route": (_I,) * 2,
        "hg_scf_fwd_smem": (_I,) * 2,
        # h, gout, rbf, cm, send, recv, row_ptr, w0, b0, w1, b1, partial,
        # wgrad, drbf_part, dcm_part, drbf, dcm, n_rows, n_edges, f, g,
        # width, n_parts, stream
        "hg_scf_pass_p_f32": (_P,) * 17 + (_I,) * 6 + (_P,),
        # f, g, width
        "hg_scf_pass_p_smem": (_I,) * 3,
    },
    "egcl_mp": {
        # mode, equivariant, x, geo, send, recv, perm, row_ptr, w0s, w0r,
        # w0g, b0, w1, b1, wc0, bc0, wc1, gagg, gpsum, out, psum, partial,
        # wgrad, dgeo, n_rows, f, h, gp, n_parts, route, stream
        "hg_egcl_f32": (_I, _I) + (_P,) * 22 + (_I,) * 6 + (_P,),
        # f, h, gp, equivariant
        "hg_egcl_wgrad_size": (_I,) * 4,
        "hg_egcl_pass_p_route": (_I,) * 4,
        "hg_egcl_pass_s_route": (_I,) * 4,
        "hg_egcl_fwd_route": (_I,) * 4,
    },
    "gat_mp": {
        # mode, xl, xr, att, send, recv, perm, row_ptr, b, m, ga, gd, out,
        # m_out, d_out, partial, datt, n_rows, hf, f, slope, n_parts, route,
        # stream
        "hg_gat_f32": (_I,) + (_P,) * 16 + (_I, _I, _I, _F, _I, _I, _P),
        # hf, f
        "hg_gat_fwd_route": (_I,) * 2,
        "hg_gat_fwd_group": (_I,) * 2,
        "hg_gat_pass_s_route": (_I,) * 2,
        "hg_gat_pass_r_route": (_I,) * 2,
    },
    "cgcnn_mp": {
        # x, ea, send, row_ptr, wfr, wfs, wfg, bf, wsr, wss, wsg, bs,
        # table, out, n_rows, f, d, a, stream
        "hg_cgcnn_fwd_f32": (_P,) * 14 + (_I,) * 4 + (_P,),
        # ea, recv, perm, row_ptr, wfs, wfg, bf, wss, wsg, bs, gout, table,
        # sums, out, n_rows, f, d, a, stream
        "hg_cgcnn_pass_s_f32": (_P,) * 14 + (_I,) * 4 + (_P,),
        # x, ea, send, recv, row_ptr, wfr, wfs, wfg, bf, wsr, wss, wsg, bs,
        # gout, table, partial, wgrad, dx_part, dea_part, dx, dea, n_rows,
        # n_edges, f, d, a, wp, n_parts, stream
        "hg_cgcnn_pass_p_f32": (_P,) * 21 + (_I,) * 7 + (_P,),
        # f, a, wp
        "hg_cgcnn_pass_p_smem": (_I,) * 3,
        # f, d, a
        "hg_cgcnn_pass_p_width": (_I,) * 3,
    },
    "dn_tri": {
        # mode, radial, x2, cbf, w1, w2, kj, ji, perm, row_ptr, gout, out,
        # d_radial, d_x2, d_cbf, partial, wgrad, n_rows, s, r, b, d,
        # n_parts, route, stream
        "hg_dn_tri_f32": (_I,) + (_P,) * 16 + (_I,) * 7 + (_P,),
        # sr, b, d
        "hg_dn_tri_wgrad_size": (_I,) * 3,
        # s, sr, b, d
        "hg_dn_tri_fwd_route": (_I,) * 4,
        # sr, d
        "hg_dn_tri_fwd_smem": (_I,) * 2,
    },
    "dn_tri_builder": {
        # mode, x, sbf, w1, w2, kj, ji, perm, row_ptr, gout, out, d_sbf,
        # partial, wgrad, n_rows, sr, b, d, n_parts, route, stream
        "hg_dn_tri_builder_f32": (_I,) + (_P,) * 13 + (_I,) * 6 + (_P,),
        # sr, b, d
        "hg_dn_tri_builder_wgrad_size": (_I,) * 3,
        "hg_dn_tri_builder_fwd_route": (_I,) * 3,
        "hg_dn_tri_builder_bwd_p_route": (_I,) * 3,
        # sr, b, d, want_sbf
        "hg_dn_tri_builder_bwd_s_route": (_I,) * 4,
    },
    "row_mlp": {
        # mode, tri, xji, xe, w, bias, gout, out, dtri, dxji, dxe, partial,
        # wgrad, n_rows, din, h, nb, na, n_parts, route, stream
        "hg_row_mlp_f32": (_I,) + (_P,) * 12 + (_I,) * 7 + (_P,),
        # din, h, nb, na
        "hg_row_mlp_wgrad_size": (_I,) * 4,
        "hg_row_mlp_bwd_route": (_I,) * 4,
        "hg_row_mlp_fwd_route": (_I,) * 4,
    },
    "poly_mp": {
        # src, senders, mask, row_ptr, o_sum, o_sq, o_mxmn, o_cnt,
        # n_rows, n_src, f, gather, stream
        "hg_poly_segment_f32": (_P,) * 8 + (_I,) * 4 + (_P,),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# source name -> the compiler's output of its last verbose build
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError(
            "CUDA toolkit not found (no nvcc): the port's kernels are built "
            "from source with nvcc on the machine that has the card")
    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}")
    return nvcc


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    # the shared headers count too: an edited header rebuilds every source
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def _start_build(name: str, verbose: bool
                 ) -> Optional[Tuple[subprocess.Popen, Path, Path]]:
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(verbose: bool = False) -> List[Path]:
    """Compile every source that has no current library yet — one nvcc
    per source, started together — and return the library paths.  Raises
    with the compiler's output when a build fails; ``verbose`` prints
    it (with ptxas register and spill counts) when it succeeds."""
    with _lock:
        started = {n: _start_build(n, verbose) for n in SIGNATURES}
        failed = []
        for name, job in started.items():
            if job is None:
                continue
            proc, tmp, out = job
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc {name}.cu failed:\n{log}")
                continue
            os.replace(tmp, out)
            if verbose and log.strip():
                BUILD_LOGS[name] = log
                print(f"[nvcc {name}.cu]\n{log.strip()}")
        if failed:
            raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in SIGNATURES]


def ptxas_log(name: str) -> str:
    """The compiler's verbose output (ptxas registers, spills, shared
    memory) for ``csrc/<name>.cu``: that of its build in this process, or,
    when its library was already built, that of a compile of its own
    whose output is thrown away."""
    with _lock:
        log = BUILD_LOGS.get(name)
    if log is not None:
        return log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"ptxas_{name}.tmp{os.getpid()}.so"
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    finally:
        tmp.unlink(missing_ok=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc {name}.cu failed:\n{proc.stdout}")
    with _lock:
        BUILD_LOGS[name] = proc.stdout
    return proc.stdout


def load_library(name: str) -> ctypes.CDLL:
    """The named kernel library, built on first use."""
    with _lock:
        lib = _loaded.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = ctypes.CDLL(str(library_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    with _lock:
        _loaded[name] = lib
    return lib
