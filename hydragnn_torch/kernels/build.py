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

# source name -> {C function: argtypes}; every pointer and the stream are
# c_void_p (ctypes would otherwise pass them as 32-bit ints), every C
# function returns its launch's cudaError_t
SIGNATURES: Dict[str, Dict[str, Tuple]] = {
    "fused_mp": {
        # x, w, mask, senders, row_ptr, out, n_rows, n_src, f, has_w, stream
        "hg_gather_mul_segment_sum_f32":
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # data, row_ptr, out, n_seg, f, stream
        "hg_segment_sum_dense_f32": (_P, _P, _P, _I, _I, _P),
    },
    "scf_mp": {
        # x, rbf, cm, gidx, rowid, perm, row_ptr, w0, b0, w1, b1, out,
        # n_rows, f, g, stream
        "hg_scf_filter_gather_f32": (_P,) * 12 + (_I,) * 3 + (_P,),
        # h, gout, rbf, cm, send, recv, row_ptr, w0, b0, w1, w1t, b1,
        # partial, wgrad, drbf, dcm, n_rows, f, g, n_parts, stream
        "hg_scf_pass_p_f32": (_P,) * 16 + (_I,) * 4 + (_P,),
    },
    "poly_mp": {
        # src, senders, mask, row_ptr, o_sum, o_sq, o_mxmn, o_cnt,
        # n_rows, n_src, f, gather, stream
        "hg_poly_segment_f32": (_P,) * 8 + (_I,) * 4 + (_P,),
    },
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


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
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
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
                print(f"[nvcc {name}.cu]\n{log.strip()}")
        if failed:
            raise RuntimeError("\n".join(failed))
    return [library_path(n) for n in SIGNATURES]


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
