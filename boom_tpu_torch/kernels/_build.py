"""Build and bind the hand-written CUDA kernels (``boom_tpu_torch/csrc``).

Each source is compiled with ``nvcc`` into a shared library of its own with
a plain C interface and loaded with ``ctypes``. Nothing here runs at import:
the first launch on a CUDA tensor calls :func:`library`, which builds the
library from the checkout's source into ``build/boom_tpu_torch/`` (named by
a hash of the source and flags, so an edit rebuilds) and loads it.
:func:`build` starts one ``nvcc`` for every source at once.
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
SOURCES = {"parallel_scan": _PKG / "csrc" / "parallel_scan.cu",
           "kalman_seq": _PKG / "csrc" / "kalman_seq.cu",
           "ssvs_sweep": _PKG / "csrc" / "ssvs_sweep.cu",
           "kalman_wide": _PKG / "csrc" / "kalman_wide.cu",
           "hmm": _PKG / "csrc" / "hmm.cu"}
BUILD_DIR = _PKG.parent / "build" / "boom_tpu_torch"
# --split-compile=0: optimise the instantiations on all host cores
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

# the C entries of kalman_seq.cu: (dtype tags, state dims) of each kernel
# (K1 "loglik", K2 "smoother"; "loglik_tv", "smoother_tv": their forms for
# a time-varying system)
KALMAN_ENTRIES = {"loglik": (("f32", "f64"), tuple(range(1, 7))),
                  "smoother": (("f64",), tuple(range(1, 7))),
                  "loglik_tv": (("f32", "f64"), tuple(range(1, 7))),
                  "smoother_tv": (("f64",), tuple(range(1, 7)))}
# the C entries of ssvs_sweep.cu (kernel (a)): one a dtype
SSVS_DTYPES = ("f32", "f64")
# kalman_wide.cu: K2w (float64, one entry for every d in WIDE_DIMS, and one
# each for its time-varying forms: dense T, a T a chain or the calendar's
# T_t, and T's non-zeros), K3
# (one entry a dtype, every d in DPATH_DIMS), K1w (one entry a dtype, every
# d in WIDE_DIMS) and the loglik's jets J1 and J2 (one float64 entry, every
# d in JET_DIMS, at most JET_MAX_DIRECTIONS directions: kMaxDirections)
WIDE_DIMS = tuple(range(7, 17))
DPATH_DTYPES = ("f32", "f64")
DPATH_DIMS = tuple(range(1, 17))
LOGLIK_WIDE_DTYPES = ("f32", "f64")
JET_DIMS = tuple(range(1, 17))
JET_MAX_DIRECTIONS = 16
# hmm.cu (H1, the forward filter; H2, the backward sampler): one entry a
# dtype each, S in HMM_STATES chosen at run time
HMM_DTYPES = ("f32", "f64")
HMM_STATES = tuple(range(1, 17))

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of each entry family (pointers, then ints, then stream)
_ARGTYPES = {
    # in, out, totals, totals_len, batch, t_len, reverse, stream
    "scan": [_P, _P, _P, _L, _I, _I, _I, _P],
    # z, tm, rqr, h, a0, p0, y, obs, ll, vout, fout, batch, t_len,
    # n_series, threads, stream
    "loglik": [_P] * 11 + [_I] * 4 + [_P],
    # ... as "loglik", then d and the shared bits before threads
    "loglik_wide": [_P] * 11 + [_I] * 6 + [_P],
    # z, tm, rqr, h, a0, p0, y, obs, dh, dm, ll, grad, hess, batch, t_len,
    # n_series, d, n_dirs, order, threads, stream
    "jet": [_P] * 13 + [_I] * 7 + [_P],
    # z, tm, rqr, h, p0, alpha1, w, eps, y, obs, scratch, out, batch,
    # t_len, threads, stream
    "smoother": [_P] * 12 + [_I, _I, _I, _P],
    # s0, omega, mean, log_odds, consts, logq, log1mq, qprobs, mask_in,
    # perm, flip_u, jump_u, jump_acc, mask_out, border, chains, p,
    # n_flips, max_size, threads, stream
    "ssvs_sweep": [_P] * 15 + [_I] * 5 + [_P],
    # the smoother's pointers, batch, t_len, d, threads, stream
    "smoother_wide": [_P] * 12 + [_I] * 4 + [_P],
    # a time-varying system's (no z; zt, hs, u and u_stride added):
    # tm, rqr, h, a0, p0, y, obs, zt, hs, u, ll, vout, fout, batch, t_len,
    # n_series, shared, u_stride, stream
    "loglik_tv": [_P] * 13 + [_I] * 4 + [_L, _P],
    # tm, rqr, h, p0, alpha1, w, eps, y, obs, zt, hs, u, scratch, out,
    # batch, t_len, u_stride, threads, stream
    "smoother_tv": [_P] * 14 + [_I, _I, _L, _I, _P],
    # K1w's: as "loglik_tv" with the calendar's step choices (sel) after
    # u and d after n_series
    "loglik_wide_tv": [_P] * 14 + [_I] * 5 + [_L, _P],
    # K2w's dense form: as "smoother_tv" with sel after u, then the shared
    # bit and d after u_stride
    "smoother_wide_tv": [_P] * 15 + [_I, _I, _L, _I, _I, _I, _P],
    # K2w's structured form: as K2w's without tm, then T's non-zeros
    # (rowptr, cols, vals: host arrays) after out
    "smoother_wide_nz": [_P] * 16 + [_I, _I, _L, _I, _I, _P],
    # tm, w, out, batch, groups, t_len, d, threads, stream
    "dpath": [_P] * 3 + [_I] * 5 + [_P],
    # log_lik, log_trans, log_init, alphas, loglike, chains, t_len, s, stream
    "hmm_forward": [_P] * 5 + [_I] * 3 + [_P],
    # alphas, log_trans, y, path_u, z, n, sum, sumsq, counts, first, chains,
    # t_len, s, stream
    "hmm_backward": [_P] * 10 + [_I] * 3 + [_P],
    # backward (0: H1, 1: H2), f64, s, chains
    "hmm_lanes": [_I] * 4,
    # lanes (0: chosen from C)
    "hmm_set_lanes": [_I],
}


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


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libboom_{name}_{digest.hexdigest()[:16]}.so"


def log_path(name: str) -> Path:
    """The compiler's report (``-Xptxas -v``: registers, spills) of a
    source's last build."""
    return BUILD_DIR / f"nvcc_{name}.log"


def build(names=None) -> dict:
    """Compile every named source (default: all) whose hashed library does
    not exist, all ``nvcc`` processes at once; returns {name: library}."""
    names = tuple(SOURCES) if names is None else tuple(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        running[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    failed = []
    for name, (tmp, proc) in running.items():
        report, _ = proc.communicate()
        log_path(name).write_text(report)
        if proc.returncode != 0:
            # the errors first: a failed build's warnings can fill the tail
            errors = [ln for ln in report.splitlines() if "error" in ln]
            failed.append(f"{name} ({proc.returncode}):\n"
                          + "\n".join(errors[:40]) + f"\n{report[-2000:]}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {name: library_path(name) for name in names}


def _declare(lib, family, entry):
    fn = getattr(lib, entry)
    fn.argtypes = _ARGTYPES[family]
    fn.restype = ctypes.c_int


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """Build if needed, load, and declare every entry's C signature."""
    lib = ctypes.CDLL(str(build((name,))[name]))
    if name == "parallel_scan":
        for op in SCAN_OPS:
            for tag in SCAN_DTYPES:
                for d in SCAN_DIMS:
                    _declare(lib, "scan", f"boom_scan_{op}_{tag}_d{d}")
    elif name == "ssvs_sweep":
        for tag in SSVS_DTYPES:
            _declare(lib, "ssvs_sweep", f"boom_ssvs_sweep_{tag}")
    elif name == "hmm":
        for tag in HMM_DTYPES:
            _declare(lib, "hmm_forward", f"boom_hmm_forward_{tag}")
            _declare(lib, "hmm_backward", f"boom_hmm_backward_{tag}")
        _declare(lib, "hmm_lanes", "boom_hmm_lanes")
        _declare(lib, "hmm_set_lanes", "boom_hmm_set_lanes")
    elif name == "kalman_wide":
        _declare(lib, "smoother_wide", "boom_kalman_smoother_wide_f64")
        _declare(lib, "smoother_wide_tv", "boom_kalman_smoother_wide_tv_f64")
        _declare(lib, "smoother_wide_nz", "boom_kalman_smoother_wide_nz_f64")
        for tag in DPATH_DTYPES:
            _declare(lib, "dpath", f"boom_dpath_{tag}")
        for tag in LOGLIK_WIDE_DTYPES:
            _declare(lib, "loglik_wide", f"boom_kalman_loglik_wide_{tag}")
            _declare(lib, "loglik_wide_tv",
                     f"boom_kalman_loglik_wide_tv_{tag}")
        _declare(lib, "jet", "boom_kalman_jet_f64")
    else:
        for kind, (tags, dims) in KALMAN_ENTRIES.items():
            for tag in tags:
                for d in dims:
                    _declare(lib, kind, f"boom_kalman_{kind}_{tag}_d{d}")
    return lib
