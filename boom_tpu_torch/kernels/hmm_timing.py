"""Times of the HMM kernels H1 (the forward filter) and H2 (the backward
sampler with the path's statistics), ``csrc/hmm.cu``, on the card, beside
their bounds and their plain versions' times.

    python3 boom_tpu_torch/kernels/hmm_timing.py    # one JSON line

Shapes (``SHAPES``): ``chip_smoke.py`` phase 9's (4,096 chains, T = 1,200,
S = 2, float32), the same at S = 4 and 8, and one warp of 32 chains at S =
2: a lane a chain, so one warp's time is the T-step dependent chain of the
code with nothing else on the card, the floor of this layout. The bound is
``bound_ms``: each input read once and each output written once at the
memory rate, or the operations at the float rate, whichever is larger
(the memory rate at every shape here). ``chain_floor_ms`` is the T-step
latency chain a lane must walk whatever the layout, estimated from assumed
latencies (``STEP_LATENCY_CYCLES``). ``chip_smoke.py`` phase 2f takes its
inputs, bounds and times from here. Needs a CUDA card.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from boom_tpu_torch.kernels.scan_timing import (  # noqa: E402
    HBM_BYTES_PER_S,
    PEAK_FLOPS,
    card_line,
    median_ms,
    ptxas_entries,
)

# name: (dtype, chains, T, S)
SHAPES = {"phase9": ("float32", 4096, 1200, 2),
          "s4": ("float32", 4096, 1200, 4),
          "s8": ("float32", 4096, 1200, 8),
          "one_warp": ("float32", 32, 1200, 2)}
# an H1 step's dependent chain at S = 2, by assumed latencies (cycles): the
# predict's and the normaliser's log-sum-exps, each an accurate exp (~40)
# and log (~40) with ~6 dependent adds, compares and selects of ~4 each
STEP_LATENCY_CYCLES = 2 * (40 + 40 + 6 * 4)
# an H100 SXM's boost clock
CLOCK_HZ = 1.98e9


def problem(rng, c, t_len, s, dtype="float64", device="cuda"):
    """An H1 / H2 problem drawn on ``device`` from a generator seeded by
    the numpy ``rng``: log_lik [C, T, S] (-2 N(0, 1)^2), log_trans
    [C, S, S] and log_init [C, S] (log Dirichlet(1) rows: normalised
    exponentials), y [T] and the Gumbel uniforms path_u [C, T, S] in
    [tiny, 1)."""
    import torch

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))

    def draw(fn, *shape):
        return fn(shape, generator=gen, dtype=dt, device=device)

    def log_dirichlet(*shape):
        e = -torch.log1p(-draw(torch.rand, *shape))  # Exp(1)
        return torch.log(e / e.sum(-1, keepdim=True))

    return {"log_lik": -2.0 * draw(torch.randn, c, t_len, s) ** 2,
            "log_trans": log_dirichlet(c, s, s),
            "log_init": log_dirichlet(c, s),
            "y": draw(torch.randn, t_len),
            "path_u": draw(torch.rand, c, t_len, s).clamp_min(
                torch.finfo(dt).tiny)}


def bound_ms(name, dtype, c, t_len, s):
    """(ms, "bytes" | "operations"): H1 reads log_lik, log_trans and
    log_init and writes the alphas and loglike; H2 reads the alphas, the
    uniforms, log_trans and y and writes z (int32), n, sum, sum of squares,
    the counts and the first state. Operations a step a chain, an exp or a
    log one each: H1 S (4 S + 2) + 4 S + 2, H2 S (log, log, add, sub,
    compare) + 3 accumulations."""
    item = 8 if dtype == "float64" else 4
    if name == "hmm_forward":
        n_bytes = item * (2 * c * t_len * s + c * s * s + c * s + c)
        ops = c * t_len * (s * (4 * s + 2) + 4 * s + 2)
    else:
        n_bytes = (item * (2 * c * t_len * s + c * s * s + t_len
                           + 4 * c * s + c * s * s) + 4 * c * t_len)
        ops = c * t_len * (5 * s + 3)
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = ops / PEAK_FLOPS[dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def chain_floor_ms(t_len):
    """H1's T-step latency chain (``STEP_LATENCY_CYCLES`` a step)."""
    return 1e3 * t_len * STEP_LATENCY_CYCLES / CLOCK_HZ


def cases(rng, dtype, c, t_len, s):
    """{name: (kernel, plain)} thunks of H1 and H2 on one problem (H2 on
    the plain filter's alphas)."""
    from boom_tpu_torch.models import hmm, hmm_kernel

    p = problem(rng, c, t_len, s, dtype)
    la, _ = hmm.forward_filter(p["log_lik"], p["log_trans"], p["log_init"])
    return {
        "hmm_forward": (
            lambda: hmm_kernel.launch_forward(p["log_lik"], p["log_trans"],
                                              p["log_init"]),
            lambda: hmm.forward_filter(p["log_lik"], p["log_trans"],
                                       p["log_init"])),
        "hmm_backward": (
            lambda: hmm_kernel.launch_backward(la, p["log_trans"],
                                               p["path_u"], p["y"]),
            lambda: hmm.backward_sample_stats(la, p["log_trans"],
                                              p["path_u"], p["y"]))}


def time_hmm(rng, shapes=SHAPES, plain_at=("phase9",)):
    """{shape: {kernel: {ms, plain_ms (None where not timed), bound_ms,
    bound_by}}}, device spans; ``chain_floor_ms`` beside H1's."""
    out = {}
    for shape, (dtype, c, t_len, s) in shapes.items():
        per = {}
        for name, (kern, plain) in cases(rng, dtype, c, t_len, s).items():
            bound, by = bound_ms(name, dtype, c, t_len, s)
            per[name] = {"ms": median_ms(kern),
                         "plain_ms": (median_ms(plain, reps=3, per=1)
                                      if shape in plain_at else None),
                         "bound_ms": bound, "bound_by": by,
                         "shape": f"{dtype} C={c} T={t_len} S={s}"}
        per["hmm_forward"]["chain_floor_ms"] = chain_floor_ms(t_len)
        out[shape] = per
    return out


def nvcc_report(log_text):
    """{"forward f32 S2": {"registers", "spill_bytes", "stack_bytes"}, ...}
    for every H1 / H2 instantiation in an ``nvcc -Xptxas -v`` log."""
    pat = re.compile(r"(forward|backward)_kernelI([fd])Li(\d+)E")
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        m = pat.search(name)
        if m:
            kernel, ty, s = m.groups()
            report[f"{kernel} {'f64' if ty == 'd' else 'f32'} S{s}"] = {
                "registers": nregs, "spill_bytes": spill,
                "stack_bytes": stack}
    return report


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hmm_timing: needs a CUDA card")
    from boom_tpu_torch.kernels import _build

    _build.library("hmm")
    out = {"card": card_line(),
           "times": time_hmm(np.random.default_rng(20261022)),
           "nvcc": nvcc_report(_build.log_path("hmm").read_text())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
