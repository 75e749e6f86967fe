"""Times of the sequential Kalman kernels on the card (K1, the loglik; K2,
the fused simulation smoother; csrc/kalman_seq.cu), beside their bounds and
their plain versions, at the shapes of the bsts_llt workload.

    python3 boom_tpu_torch/kernels/kalman_timing.py    # one JSON line

Prints the card, the build time, per kernel the device time, the plain
version's time, the bound and what sets it, the times at other block sizes,
and the ``nvcc -Xptxas -v`` registers and spills of every instantiation.
``chip_smoke.py`` takes its shapes, inputs and bounds from here. Needs a
CUDA card.
"""

from __future__ import annotations

import json
import re
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
# name: (dtype, batch, d, T); "loglik" scores the TIM points of every chain
# (float32, the run's dtype), "smoother" imputes every chain (float64,
# bsts.SMOOTHER_DTYPE), "loglik_tangent" is one evaluation of the TIM
# proposal's mode search (float64, one series)
SHAPES = {"loglik": ("float32", LLT_CHAINS * TIM_POINTS, LLT_D, LLT_T),
          "smoother": ("float64", LLT_CHAINS, LLT_D, LLT_T),
          "loglik_tangent": ("float64", 1, LLT_D, LLT_T)}
BLOCK_SIZES = {"loglik": (64, 128, 256), "smoother": (32, 64, 128)}
# batches at which each kernel is also timed: K2 from one warp to one warp
# on each SM (the per-thread work is the same; the bytes grow 128x), K1 from
# a quarter to the full TIM batch
SCALING = {"loglik": (LLT_CHAINS * TIM_POINTS // 16,
                      LLT_CHAINS * TIM_POINTS // 4),
           "smoother": (32, 512)}


def filter_step_flops(d):
    """Floating-point operations of one filter step as the kernels compute
    it (v, P z, f, K, a', T P, L, (T P) L' + RQR, the symmetrization)."""
    return 4 * d ** 3 + 9 * d ** 2 + 4 * d


def loglik_flops(batch, d, t_len):
    return batch * t_len * (filter_step_flops(d) + 7)  # + the log density


def smoother_flops(batch, d, t_len):
    """The forward pass (filter on y - y+ and the simulation), the backward
    r pass and the forward state pass."""
    step = (filter_step_flops(d) + 2 * d * d + 2 * d + 1
            + 4 * d * d + d + 1 + 4 * d * d)
    return batch * t_len * step


def bound_ms(name, dtype, batch, d, t_len):
    """The least time the card could take: each input read once and each
    output written once over the memory rate, or the operations over the
    float rate, whichever is larger. Returns (ms, "bytes" | "operations").
    K1 reads a system a series and the shared y, writes one loglik a
    series; K2 reads a system, alpha_1, w [T-1, d] and eps [T] a chain and
    writes the draw [T, d] (its scratch is not counted)."""
    item = 8 if dtype == "float64" else 4
    system = 3 * d * d + 2 * d + 1  # z, T, RQR, h, a0 or alpha1, P0
    if name == "loglik":
        n_bytes = (batch * (system + 1) + t_len) * item
        flops = loglik_flops(batch, d, t_len)
    elif name == "smoother":
        n_bytes = (batch * (system + (t_len - 1) * d + t_len + t_len * d)
                   + t_len) * item
        flops = smoother_flops(batch, d, t_len)
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
    the derivative kernel: autograd's gradient and Hessian of the plain
    loglik in the log variances); the wrapper call is the public function
    on the card, with the operands' preparation."""
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
        return (lambda: kk.launch_loglik(*fields, tangent=False),
                lambda: kalman.kalman_loglik(params, y),
                lambda: kk.kalman_loglik(params, y))
    if name == "loglik_tangent":
        def plain():
            def f(u):
                q = torch.diag_embed(torch.exp(u[:d]))[None]
                return kalman.kalman_loglik(
                    params._replace(q_mat=q, h=torch.exp(u[d:])), y)[0]
            u0 = torch.zeros(d + 1, dtype=tdt, device="cuda")
            return (torch.autograd.functional.jacobian(f, u0),
                    torch.autograd.functional.hessian(f, u0))
        return (lambda: kk.launch_loglik(*fields, tangent=True), plain,
                None)
    normals = [torch.tensor(rng.normal(size=s), dtype=tdt, device="cuda")
               for s in ((batch, d), (batch, t_len - 1, d),
                         (batch, t_len))]
    operands = kk.smoother_operands(params, y, *normals)
    return (lambda: kk.launch_smoother(*operands),
            lambda: kalman.simulation_smoother(params, y, *normals),
            lambda: kk.simulation_smoother(params, y, *normals))


def time_kalman(rng, plain=True):
    """{kernel: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    shape, block_ms, scaling_ms}} at SHAPES: device times of the kernel (at
    the wrapper's block size, at the others of BLOCK_SIZES, and at the
    smaller batches of SCALING), of the whole wrapper and of the plain
    version."""
    from boom_tpu_torch.statespace import kalman_kernel as kk

    consts = {"loglik": "LOGLIK_THREADS", "smoother": "SMOOTHER_THREADS",
              "loglik_tangent": "LOGLIK_THREADS"}
    out = {}
    for name, (dtype, batch, d, t_len) in SHAPES.items():
        kern, ref, wrapper = kalman_cases(rng, name, dtype, batch, d, t_len)
        row = {"shape": [dtype, batch, d, t_len], "ms": median_ms(kern),
               "call_ms": call_ms(kern),
               "wrapper_ms": median_ms(wrapper) if wrapper else None,
               "plain_ms": median_ms(ref, reps=3, per=1) if plain else None}
        if name in BLOCK_SIZES:
            row["bound_ms"], row["bound_by"] = bound_ms(name, dtype, batch,
                                                        d, t_len)
            chosen = getattr(kk, consts[name])
            row["block_ms"] = {}
            for threads in BLOCK_SIZES[name]:
                setattr(kk, consts[name], threads)
                try:
                    row["block_ms"][threads] = median_ms(kern)
                finally:
                    setattr(kk, consts[name], chosen)
            row["scaling_ms"] = {
                b: median_ms(kalman_cases(rng, name, dtype, b, d, t_len)[0])
                for b in SCALING[name]}
        out[name] = row
    return out


def nvcc_report(log_text):
    """{instantiation: {"registers", "spill_bytes", "stack_bytes"}} for
    every kernel of kalman_seq.cu in an ``nvcc -Xptxas -v`` log."""
    pat = re.compile(r"(loglik_kernel|smoother_kernel)I([fd])Li(\d)E"
                     r"(?:Li(\d+)E)?")
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        m = pat.search(name)
        if not m:
            continue
        kernel, ty, d, n_par = m.groups()
        kind = kernel.split("_")[0]
        if kind == "loglik" and n_par not in (None, "0"):
            kind = "loglik_tangent"
        key = f"{kind} {'f64' if ty == 'd' else 'f32'} d{d}"
        report[key] = {"registers": nregs, "spill_bytes": spill,
                       "stack_bytes": stack}
    return dict(sorted(report.items()))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kalman_timing: needs a CUDA card")
    from boom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    out = {"card": card_line(), "build_s": time.perf_counter() - t0,
           "kernels": time_kalman(np.random.default_rng(20261016))}
    log = _build.log_path("kalman_seq")
    out["nvcc"] = nvcc_report(log.read_text()) if log.exists() else {}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
