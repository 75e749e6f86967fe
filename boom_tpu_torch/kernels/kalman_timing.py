"""Times of the sequential Kalman kernels on the card (K1, the loglik; K2,
the fused simulation smoother; csrc/kalman_seq.cu; K2w, the smoother for
7 <= d <= 16, and K3, the ASIS D-path; csrc/kalman_wide.cu), beside their
bounds and their plain versions, at the shapes of the bsts_llt workload
(K1, K2, J1, J2) and of the bsts_reg workload (K2w, K3; K3 also at the
bsts_llt D-path's shape, beside kernel (c)'s affine scan of the same
D-paths, their route before K3 took every d).

    python3 boom_tpu_torch/kernels/kalman_timing.py                # JSON
    python3 boom_tpu_torch/kernels/kalman_timing.py --compare DIR  # both

Prints the card, the build time (all sources at once), per kernel the
device time (K2w's also by pass, from the profiler), the plain
version's time, the bound and what sets it, the times at other block sizes
and batches, the ``nvcc -Xptxas -v`` registers and spills of every
instantiation, and the instructions of K1's, J1's and J2's step loops
(``cuobjdump -sass``). ``--compare DIR`` runs the same script of the
checkout DIR (another commit of this repository, unpacked with ``git
archive``; its kernels build under DIR) and of this tree in turns (DIR,
this, this, DIR), each in its own process on the same card, prints the
times side by side and the time of ``nvcc`` on each tree's
``kalman_wide.cu`` alone, and with ``--json PATH`` writes every number of
the four runs to PATH.
``chip_smoke.py`` takes its shapes, inputs and bounds from here. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from boom_tpu_torch.kernels.scan_timing import (  # noqa: E402
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    call_ms,
    card_line,
    median_ms,
    ptxas_entries,
    random_system,
)

# the bsts_llt workload (bench.py:170-177): 4096 chains, T=500, d=2, the
# TIM move scoring 16 candidates + the current point a chain
LLT_CHAINS, LLT_T, LLT_D, TIM_POINTS = 4096, 500, 2, 17
# name: (dtype, batch, d, T); "loglik" (K1) scores the TIM points of every
# chain (float32, the run's dtype), "smoother" (K2) imputes every chain
# (float64, bsts.SMOOTHER_DTYPE), "loglik_grad" (J1) and "loglik_hess" (J2)
# are one evaluation of the TIM proposal's mode search (float64, one
# series)
SHAPES = {"loglik": ("float32", LLT_CHAINS * TIM_POINTS, LLT_D, LLT_T),
          "smoother": ("float64", LLT_CHAINS, LLT_D, LLT_T),
          "loglik_grad": ("float64", 1, LLT_D, LLT_T),
          "loglik_hess": ("float64", 1, LLT_D, LLT_T)}
# the bsts_reg workload (chip_smoke.py phase 6): 4096 chains, T=500, a
# local linear trend and a 7-season cycle (d = 8, three ASIS groups)
REG_CHAINS, REG_T, REG_D, REG_GROUPS = 4096, 500, 8, 3
# name: (dtype, batch, d, T, groups); K2w imputes every chain (float64), at
# d = 8 and at d = 13 (a trend and a 12-season cycle); K3 runs the D-paths
# of every chain's groups in the run's dtype (float32), at the bsts_reg
# shape and at the bsts_llt one (d = 2, two groups), where kernel (c)'s
# affine scan ran them before (timed beside it, ``scan_ms``)
WIDE_SHAPES = {
    "smoother_wide": ("float64", REG_CHAINS, REG_D, REG_T, 0),
    "smoother_wide_d13": ("float64", REG_CHAINS, 13, REG_T, 0),
    "dpath": ("float32", REG_CHAINS, REG_D, REG_T, REG_GROUPS),
    "dpath_llt": ("float32", LLT_CHAINS, LLT_D, LLT_T, 2)}

# K1's block sizes (0: the grid laid out from the card's SM count); K2's
# block is one warp by design
BLOCK_SIZES = {"loglik": (0, 128, 256)}
# batches at which each kernel is also timed: K2 from one warp to one warp
# on each SM (the per-thread work is the same; the bytes grow 128x), K1 from
# a quarter to the full TIM batch
SCALING = {"loglik": (LLT_CHAINS * TIM_POINTS // 16,
                      LLT_CHAINS * TIM_POINTS // 4),
           "smoother": (32, 512)}


def filter_step_flops(d):
    """Floating-point operations of one filter step as the kernels compute
    it (v, P z, f, K, a', T P, L, (T P) L' + RQR, the symmetrization of the
    upper triangle)."""
    return 4 * d ** 3 + 8 * d ** 2 + 3 * d


def loglik_flops(batch, d, t_len):
    return batch * t_len * (filter_step_flops(d) + 7)  # + the log density


def smoother_flops(batch, d, t_len):
    """The forward pass (filter on y - y+ and the simulation), the backward
    r pass and the forward state pass (alpha+ counted once)."""
    step = (filter_step_flops(d) + 2 * d * d + 2 * d + 1
            + 4 * d * d + d + 1 + 4 * d * d)
    return batch * t_len * step


def _jet_step_ops(d):
    """Jet operations of one filter step and log density: {kind: count}."""
    upper = d * (d - 1) // 2
    return {"scale": 2 * d + 4 * d * d + d ** 3 + upper + 1,
            "add": ((d - 1) + 1 + d * (d - 1) + (d - 1) + 1 + d * (d - 1)
                    + d * (d - 1) + d + d * d * (d - 1) + d * d
                    + d * d * (d - 1) + d * d + upper + 3),
            "mul": d + d ** 3 + 1, "div": d + 1, "log": 1}


def jet_step_flops(d):
    """Floating-point operations of one step of the loglik with its
    gradient and Hessian (J2's function): the filter step and the log
    density with every scalar a jet of value, gradient [N] and upper
    Hessian [H] over N = 1 + d(d+1)/2 parameters, counted per jet operation
    as a one-thread jet computes it (the work of the function, whatever
    implements it)."""
    n = 1 + d * (d + 1) // 2
    hh = n * (n + 1) // 2
    cost = {"add": 1 + n + hh,  # jet +- jet, constant +- jet
            "scale": 1 + n + hh,  # constant * jet
            "mul": 1 + 3 * n + 7 * hh,  # jet * jet
            "div": 1 + 3 * n + 7 * hh,  # jet / jet
            "log": 1 + n + 3 * hh}
    return sum(cost[k] * v for k, v in _jet_step_ops(d).items())


def dual_step_flops(d):
    """The same for the loglik with its gradient alone (J1's function):
    first-order jets of value and gradient [N]."""
    n = 1 + d * (d + 1) // 2
    cost = {"add": 1 + n, "scale": 1 + n, "mul": 1 + 3 * n,
            "div": 1 + 3 * n, "log": 1 + n}
    return sum(cost[k] * v for k, v in _jet_step_ops(d).items())


def bound_ms(name, dtype, batch, d, t_len):
    """The least time the card could take: each input read once and each
    output written once over the memory rate, or the operations over the
    float rate, whichever is larger. Returns (ms, "bytes" | "operations").
    K1 reads a system a series and the shared y, writes one loglik a
    series (J1 also a gradient, J2 a gradient and Hessian); K2 (and K2w:
    ``name`` "smoother") reads a system, alpha_1, w [T-1, d] and eps [T] a
    chain and writes the draw [T, d] (its scratch is not counted); K3
    ("dpath", ``batch`` the chains x groups) reads w [T-1, d] and writes
    D [T, d] a series (T, d x d a chain, is counted in the caller's
    ``dpath_bound_ms``)."""
    item = 8 if dtype == "float64" else 4
    system = 3 * d * d + 2 * d + 1  # z, T, RQR, h, a0 or alpha1, P0
    if name == "loglik":
        n_bytes = (batch * (system + 1) + t_len) * item
        flops = loglik_flops(batch, d, t_len)
    elif name in ("loglik_grad", "loglik_hess"):
        n_par = 1 + d * (d + 1) // 2
        hess = name == "loglik_hess"
        n_bytes = (batch * (system + 1 + n_par + hess * n_par * n_par)
                   + t_len) * item
        flops = batch * t_len * (jet_step_flops(d) if hess
                                 else dual_step_flops(d))
    elif name == "smoother":
        n_bytes = (batch * (system + (t_len - 1) * d + t_len + t_len * d)
                   + t_len) * item
        flops = smoother_flops(batch, d, t_len)
    elif name.startswith("dpath"):
        # K3 (``batch`` = chains x groups series of one chain's T): the
        # chain's T once, w [T-1, d] in, D [T, d] out a series; d^2
        # multiply-adds a step and series
        n_bytes = batch * ((t_len - 1) * d + t_len * d) * item
        flops = batch * (t_len - 1) * 2 * d * d
    else:
        raise ValueError(f"no bound for {name!r}")
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def system(rng, batch, d, dtype, device="cuda"):
    """``batch`` stable systems on ``device`` (the card): 64 random ones,
    repeated."""
    import torch

    from boom_tpu_torch.statespace.kalman import SsmParams

    base = random_system(rng, min(batch, 64), d, getattr(torch, dtype),
                         device=device)
    reps = -(-batch // base.z.shape[0])
    return SsmParams(*(f.repeat_interleave(reps, dim=0)[:batch].contiguous()
                       for f in base))


def kalman_cases(rng, name, dtype, batch, d, t_len):
    """(kernel call, plain call, wrapper call) for one kernel on inputs of
    its shape. The kernel call launches the kernel on prepared operands;
    the plain call is the plain PyTorch function of the same inputs (for
    J1 and J2: autograd of the plain loglik, ``loglik_jets_plain``); the
    wrapper call is the public function on the card, with the operands'
    preparation (none for J1 and J2, which autograd reaches)."""
    import torch

    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    tdt = getattr(torch, dtype)
    params = system(rng, batch, d, dtype)
    y = torch.tensor(rng.normal(size=t_len).cumsum(), dtype=tdt,
                     device="cuda")
    fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
              params.a0, params.p0, y, None)
    if name == "loglik":
        return (lambda: kk.launch_loglik(*fields),
                lambda: kalman.kalman_loglik(params, y),
                lambda: kk.kalman_loglik(params, y))
    if name in ("loglik_grad", "loglik_hess"):
        order = kk.LOGLIK_KINDS.index(name)
        return (lambda: kk.launch_loglik(*fields, order=order),
                lambda: kk.loglik_jets_plain(*fields, order=order), None)
    normals = [torch.tensor(rng.normal(size=s), dtype=tdt, device="cuda")
               for s in ((batch, d), (batch, t_len - 1, d),
                         (batch, t_len))]
    operands = kk.smoother_operands(params, y, *normals)
    return (lambda: kk.launch_smoother(*operands),
            lambda: kalman.simulation_smoother(params, y, *normals),
            lambda: kk.simulation_smoother(params, y, *normals))


def dpath_bound_ms(dtype, chains, groups, d, t_len):
    """K3's bound (:func:`bound_ms` over chains x groups series) with each
    chain's T [d, d] read once more."""
    item = 8 if dtype == "float64" else 4
    ms, by = bound_ms("dpath", dtype, chains * groups, d, t_len)
    extra = 1e3 * chains * d * d * item / HBM_BYTES_PER_S
    return (ms + extra, by) if by == "bytes" else (ms, by)


def wide_cases(rng, name, dtype, batch, d, t_len, groups):
    """(kernel call, plain call, wrapper call, scan call or None) for K2w
    or K3 on inputs of its shape, as :func:`kalman_cases`; for K3 at
    d <= 6 the scan call is kernel (c)'s affine scan of the same D-paths
    (``bsts.asis_redraw``'s route there before K3 took every d)."""
    import torch

    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk

    tdt = getattr(torch, dtype)
    params = system(rng, batch, d, dtype)
    if name.startswith("smoother_wide"):
        # a series a chain, as bsts with a regression gives K2w
        y = torch.tensor(rng.normal(size=(batch, t_len)).cumsum(-1),
                         dtype=tdt, device="cuda")
        normals = [torch.tensor(rng.normal(size=s), dtype=tdt, device="cuda")
                   for s in ((batch, d), (batch, t_len - 1, d),
                             (batch, t_len))]
        operands = kk.smoother_operands(params, y, *normals)
        return (lambda: kk.launch_smoother(*operands),
                lambda: kalman.simulation_smoother(params, y, *normals),
                lambda: kk.simulation_smoother(params, y, *normals), None)
    t_mat = params.t_mat.contiguous()
    w = torch.tensor(rng.normal(size=(batch, groups, t_len - 1, d)),
                     dtype=tdt, device="cuda")
    a_elems = t_mat[:, None, None].expand(batch, groups, t_len - 1, d, d)
    a_flat = a_elems.reshape(batch * groups, t_len - 1, d, d)
    w_flat = w.reshape(batch * groups, t_len - 1, d)
    scan = (lambda: sk.affine_prefix(a_flat, w_flat)) if d <= 6 else None
    return (lambda: kk.launch_dpath(t_mat, w),
            lambda: kalman.dpath(t_mat, w),
            lambda: kk.dpath(t_mat, w), scan)


_WIDE_PASS = re.compile(r"smoother_wide_kernel<\d+, (\d)>")


def wide_pass_ms(kern, calls=10, tries=3):
    """K2w's device ms a call by pass ({"pass1": ms, ...}): the mean of
    the profiler's records of each of its three launches. The profiler
    can lose records in a process that has profiled before, so the mean
    is over the records it kept, and a pass it kept none of is profiled
    again."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kern()
    torch.cuda.synchronize()
    out = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                kern()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            m = _WIDE_PASS.search(ev.key)
            us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0.0))
            if m and ev.count and us > 0:
                out.setdefault(f"pass{m.group(1)}", us / ev.count / 1e3)
        if len(out) == 3:
            break
    return out


def time_wide(rng, plain=True):
    """{kernel: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    shape, scan_ms, pass_ms}} at WIDE_SHAPES (scan_ms: kernel (c)'s affine
    scan of the same D-paths, where d <= 6; pass_ms: K2w's passes)."""
    out = {}
    for name, (dtype, batch, d, t_len, groups) in WIDE_SHAPES.items():
        kern, ref, wrapper, scan = wide_cases(rng, name, dtype, batch, d,
                                              t_len, groups)
        row = {"shape": [dtype, batch, d, t_len] + ([groups] if groups
                                                     else []),
               "ms": median_ms(kern), "call_ms": call_ms(kern),
               "wrapper_ms": median_ms(wrapper),
               "plain_ms": median_ms(ref, reps=3, per=1) if plain else None,
               "scan_ms": median_ms(scan) if scan is not None else None}
        if groups:
            row["bound_ms"], row["bound_by"] = dpath_bound_ms(
                dtype, batch, groups, d, t_len)
        else:
            row["bound_ms"], row["bound_by"] = bound_ms("smoother", dtype,
                                                        batch, d, t_len)
            row["pass_ms"] = wide_pass_ms(kern)
        out[name] = row
    return out


def time_kalman(rng, plain=True):
    """{kernel: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    shape, block_ms, scaling_ms}} at SHAPES: device times of the kernel (at
    the wrapper's block size, at the others of BLOCK_SIZES, and at the
    smaller batches of SCALING), of the whole wrapper and of the plain
    version."""
    from boom_tpu_torch.statespace import kalman_kernel as kk

    out = {}
    for name, (dtype, batch, d, t_len) in SHAPES.items():
        kern, ref, wrapper = kalman_cases(rng, name, dtype, batch, d, t_len)
        row = {"shape": [dtype, batch, d, t_len], "ms": median_ms(kern),
               "call_ms": call_ms(kern),
               "wrapper_ms": median_ms(wrapper) if wrapper else None,
               "plain_ms": median_ms(ref, reps=3, per=1) if plain else None}
        row["bound_ms"], row["bound_by"] = bound_ms(name, dtype, batch, d,
                                                    t_len)
        if name in BLOCK_SIZES:
            chosen = kk.LOGLIK_THREADS
            row["block_ms"] = {}
            for threads in BLOCK_SIZES[name]:
                kk.LOGLIK_THREADS = threads
                try:
                    row["block_ms"][threads or "auto"] = median_ms(kern)
                finally:
                    kk.LOGLIK_THREADS = chosen
        if name in SCALING:
            row["scaling_ms"] = {
                b: median_ms(kalman_cases(rng, name, dtype, b, d, t_len)[0])
                for b in SCALING[name]}
        out[name] = row
    return out


_KERNEL_NAME = re.compile(r"(loglik_kernel|jet_kernel|smoother_kernel)"
                          r"I(?:([fd]))?Li(\d)E(?:Li(\d+)E)?(?:Lb([01])E)?")


def _instantiation(mangled):
    """"<kernel> <type> d<D>[ dense]" of a mangled kalman_seq.cu kernel
    name (K1's, J1's and J2's instantiations without a mask end in
    " dense"), or None."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return None
    kernel, ty, d, order, masked = m.groups()
    kind = {"loglik_kernel": "loglik", "smoother_kernel": "smoother",
            "jet_kernel": f"loglik_{'grad' if order == '1' else 'hess'}"
            }[kernel]
    key = f"{kind} {'f32' if ty == 'f' else 'f64'} d{d}"
    return key + " dense" if masked == "0" else key


_WIDE_NAME = re.compile(r"(smoother_wide_kernel|dpath_kernel)I(?:([fd]))?"
                        r"Li(\d+)ELi(\d+)E")


def wide_nvcc_report(log_text):
    """{"smoother_wide f64 d<D> pass<P>" | "dpath <type> d<D> chunk<B>":
    {"registers", "spill_bytes", "stack_bytes"}} for every instantiation
    of K2w (each of its three passes) and K3 (each chunk length, bytes a
    lane) in kalman_wide.cu's ``nvcc -Xptxas -v`` log."""
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        m = _WIDE_NAME.search(name)
        if not m:
            continue
        kernel, ty, d, extra = m.groups()
        if kernel == "smoother_wide_kernel":
            key = f"smoother_wide f64 d{int(d):02d} pass{extra}"
        else:
            key = (f"dpath {'f32' if ty == 'f' else 'f64'} d{int(d):02d} "
                   f"chunk{extra}")
        report[key] = {"registers": nregs, "spill_bytes": spill,
                       "stack_bytes": stack}
    return dict(sorted(report.items()))


def nvcc_report(log_text):
    """{instantiation: {"registers", "spill_bytes", "stack_bytes"}} for
    every kernel of kalman_seq.cu in an ``nvcc -Xptxas -v`` log."""
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        key = _instantiation(name)
        if key is not None:
            report[key] = {"registers": nregs, "spill_bytes": spill,
                           "stack_bytes": stack}
    return dict(sorted(report.items()))


_SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_]*)[^;]*;")
_FLOAT_OPS = ("DFMA", "DMUL", "DADD", "FFMA", "FMUL", "FADD")


def sass_step_ops(sass_text):
    """{instantiation: {"instructions", "float_ops"}} of the step loop of
    K1, J1 and J2 in a ``cuobjdump -sass`` listing of kalman_seq.cu: of
    the loops (a branch back to an earlier address), the one with the most
    float arithmetic (D/F FMA, MUL, ADD), the shortest if several tie (the
    chunk loop holds the step loop)."""
    report = {}
    for block in sass_text.split("Function : ")[1:]:
        key = _instantiation(block.split(None, 1)[0])
        if key is None or key.startswith("smoother"):
            continue
        ins = [(int(a, 16), op, line) for line in block.splitlines()
               for a, op in _SASS_LINE.findall(line)]
        at = {addr: i for i, (addr, _op, _line) in enumerate(ins)}
        best = None
        for i, (addr, op, line) in enumerate(ins):
            m = re.search(r"BRA\s+0x([0-9a-f]+)", line)
            if op != "BRA" or not m or int(m.group(1), 16) not in at:
                continue
            start = at[int(m.group(1), 16)]
            if start >= i:
                continue
            n_float = sum(o in _FLOAT_OPS for _a, o, _l in ins[start:i + 1])
            cand = (n_float, -(i - start + 1))
            best = cand if best is None or cand > best else best
        if best is not None:
            report[key] = {"instructions": -best[1], "float_ops": best[0]}
    return dict(sorted(report.items()))


def run():
    """Build this tree's kernels and time them; returns a JSON-able dict."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kalman_timing: needs a CUDA card")
    from boom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    rng = np.random.default_rng(20261016)
    out = {"card": card_line(), "build_s": time.perf_counter() - t0,
           "kernels": {**time_kalman(rng), **time_wide(rng)}}
    log = _build.log_path("kalman_seq")
    out["nvcc"] = nvcc_report(log.read_text()) if log.exists() else {}
    log = _build.log_path("kalman_wide")
    if log.exists():
        out["nvcc"].update(wide_nvcc_report(log.read_text()))
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    out["sass"] = {}
    if cuobjdump.exists():
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.library_path("kalman_seq"))],
                              capture_output=True, text=True, timeout=300)
        out["sass"] = sass_step_ops(sass.stdout)
    return out


def nvcc_seconds(tree, name="kalman_wide"):
    """Wall seconds of ``nvcc`` (this tree's flags) on ``tree``'s source
    ``name`` alone, into a temporary directory."""
    import tempfile

    from boom_tpu_torch.kernels import _build

    src = tree / "boom_tpu_torch" / "csrc" / f"{name}.cu"
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                        str(Path(tmp) / "lib.so"), str(src)], check=True,
                       capture_output=True, timeout=1200)
        return time.perf_counter() - t0


def compare(parent, here, json_path=None):
    """Runs parent, here, here, parent, each tree's own script in a fresh
    process, and prints the kernels' times side by side, then times
    ``nvcc`` on each tree's ``kalman_wide.cu`` alone."""
    runs = []
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        script = tree / "boom_tpu_torch" / "kernels" / "kalman_timing.py"
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise SystemExit(f"kalman_timing in {tree} failed:\n"
                             f"{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(runs[0][1]["card"])
    # a kernel of one tree only (a renamed or new one) shows "-" in the
    # other's columns
    names = dict.fromkeys([*runs[1][1]["kernels"], *runs[0][1]["kernels"]])
    for name in names:
        def seq(key, name=name):
            return " / ".join(f"{r['kernels'][name][key]:.4f}"
                              if name in r["kernels"] else "-"
                              for _, r in runs)
        cur = runs[1][1]["kernels"].get(name) or runs[0][1]["kernels"][name]
        print(f"{name} {cur['shape']}: kernel (P C C P) {seq('ms')} ms, "
              f"host-clock call {seq('call_ms')} ms, bound "
              f"{cur['bound_ms']:.5f} ms ({cur['bound_by']})")
        for lab, r in (runs[0], runs[1]):
            row = r["kernels"].get(name, {})
            extra = {k: row[k] for k in ("block_ms", "scaling_ms",
                                         "pass_ms", "plain_ms", "wrapper_ms")
                     if row.get(k) is not None}
            print(f"  {lab}: {json.dumps(extra)}")
    print("build_s: " + ", ".join(f"{lab} {r['build_s']:.1f}"
                                  for lab, r in runs))
    alone = {lab: nvcc_seconds(tree) for lab, tree in (("parent", parent),
                                                       ("change", here))}
    print("nvcc kalman_wide.cu alone: " + ", ".join(
        f"{lab} {v:.1f} s" for lab, v in alone.items()))
    for lab, r in (runs[0], runs[1]):
        for inst, rep in r["nvcc"].items():
            print(f"nvcc {lab} {inst}: {rep['registers']} registers, "
                  f"{rep['spill_bytes']} bytes spill stores, "
                  f"{rep['stack_bytes']} bytes stack")
        for inst, rep in r.get("sass", {}).items():
            print(f"sass {lab} {inst}: step loop {rep['instructions']} "
                  f"instructions, {rep['float_ops']} float arithmetic")
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(
            {"runs": [{"label": lab, **r} for lab, r in runs],
             "nvcc_kalman_wide_alone_s": alone}, indent=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", type=Path,
                    help="checkout to time in turns with this one")
    ap.add_argument("--json", type=Path,
                    help="with --compare: file for every number of the runs")
    args = ap.parse_args()
    if args.compare:
        here = Path(__file__).resolve().parents[2]
        compare(args.compare.resolve(), here, args.json)
    else:
        print(json.dumps(run()))


if __name__ == "__main__":
    main()
