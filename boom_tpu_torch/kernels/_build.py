"""Build and bind the hand-written CUDA kernels (``boom_tpu_torch/csrc``).

The sources are compiled with ``nvcc`` into a shared library with a plain
C interface and loaded with ``ctypes``. Nothing here runs at import: the
first launch on a CUDA tensor calls :func:`library`, which builds the
library from the checkout's sources into ``build/boom_tpu_torch/`` (named
by a hash of the sources and flags, so an edit rebuilds) and loads it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "parallel_scan.cu",)
BUILD_DIR = _PKG.parent / "build" / "boom_tpu_torch"
# --split-compile=0: optimise the 36 instantiations on all host cores
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0")

# (combine, dtype tag, D) of every C entry in parallel_scan.cu
SCAN_OPS = ("filter", "smooth", "affine")
SCAN_DTYPES = ("f32", "f64")
SCAN_DIMS = tuple(range(1, 7))
# the shortest tile of any instantiation (TileShape in parallel_scan.cu):
# a scan of T steps needs at most ceil(T / SCAN_MIN_TILE) tile totals a row
SCAN_MIN_TILE = 128


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME/bin); the CUDA "
                       "kernels of boom_tpu_torch cannot be built")


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libboom_scan_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless the hashed library exists; returns it.
    The compiler's report (``-Xptxas -v``: registers, spills) is kept in
    ``nvcc.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (BUILD_DIR / "nvcc.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry's C signature."""
    lib = ctypes.CDLL(str(build()))
    for op in SCAN_OPS:
        for tag in SCAN_DTYPES:
            for d in SCAN_DIMS:
                fn = getattr(lib, f"boom_scan_{op}_{tag}_d{d}")
                # in, out, totals, totals_len, batch, t_len, reverse,
                # stream
                fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_longlong,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p]
                fn.restype = ctypes.c_int
    return lib
