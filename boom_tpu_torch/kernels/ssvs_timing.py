"""Times of kernel (a), the SSVS indicator sweep (csrc/ssvs_sweep.cu), on the
card, beside its bound and its plain version, at the shape of the
spike_slab workload (the bench's data, n=2000, p=50, 1024 chains), without
and with the mode jump, and of its per-chain entry (a border of S0 a
chain) at the shape of the bsts_reg workload (4096 chains, p=20).

    python3 boom_tpu_torch/kernels/ssvs_timing.py                  # JSON
    python3 boom_tpu_torch/kernels/ssvs_timing.py --compare DIR... # turns
    python3 boom_tpu_torch/kernels/ssvs_timing.py --split          # parts

Prints the card, the build time, per dtype the kernel's device time (ten
calls queued behind a spin of the card, median of 20:
``scan_timing.median_ms``), the plain version's, the bound and what sets
it, the rank-1 passes the inputs need, and the ``nvcc -Xptxas -v``
registers and spills of every instantiation. ``--compare DIR...`` runs the
same script of each checkout DIR (another commit or variant of this
repository, unpacked with ``git archive``) and of this tree in turns (the
DIRs in order, this, this, the DIRs in reverse), each in its own process
on the same card; a shape a tree lacks shows "-". ``--split`` times the
kernel with parts of its work taken away by its inputs (``split_ms``: the
staging, k rank-1 passes, p decisions none of which is taken), alone and
at 1024 chains. ``chip_smoke.py`` takes its inputs, shapes and bounds from
here. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
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
)

# the spike_slab workload (bench.py:133-146)
BENCH_CHAINS, BENCH_P = 1024, 50
# name: (dtype, chains, mode jump); the bench runs float32 without the
# jump, float64 and the jump (the library's default) are for comparison
SHAPES = {"ssvs_sweep_f32": ("float32", BENCH_CHAINS, False),
          "ssvs_sweep_f64": ("float64", BENCH_CHAINS, False),
          "ssvs_sweep_f32_jump": ("float32", BENCH_CHAINS, True),
          "ssvs_sweep_f64_jump": ("float64", BENCH_CHAINS, True)}
# the bsts_reg workload (chip_smoke.py phase 6): kernel (a)'s per-chain
# entry, float32, 4096 chains, p = 20, T = 500, no mode jump
REG_CHAINS, REG_P, REG_T = 4096, 20, 500
BORDER_SHAPES = {"ssvs_sweep_border": ("float32", REG_CHAINS, REG_P)}
# scalar operations of one flip's decision (the deltas, the log model
# probability, the log sigmoid), counted as flops
FLIP_SCALAR_FLOPS = 30
# block sizes (threads a chain) at which the kernel is also timed
BLOCK_SIZES = (64, 128, 256)


def problem(rng, c, p, dtype="float64", n=200, max_size=None,
            mode_jump=False, device="cuda"):
    """A spike-and-slab model on a random regression (x [n, p] normal, the
    first min(p, 4) coefficients nonzero), initial masks [c, p] and one
    sweep's noise on ``device``: (model, mask, noise, qprobs or None)."""
    import torch

    from boom_tpu_torch.models.glm import regression as reg

    tdt = getattr(torch, dtype)
    x = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:min(p, 4)] = rng.choice([-1.5, 1.5], size=min(p, 4))
    y = x @ beta + rng.normal(size=n)
    model = reg.SpikeSlabRegression.from_data(
        torch.tensor(x, dtype=tdt, device=device),
        torch.tensor(y, dtype=tdt, device=device),
        expected_model_size=min(3.0, p), max_size=max_size,
        mode_jump=mode_jump)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 30)))
    mask = model.init_state(model.draw_init_noise(gen, c))["gamma"]
    noise = model.draw_noise(gen, c)
    qprobs = (reg.screening_proposal_probs(model.suf, model.prior)
              if mode_jump else None)
    return model, mask, noise, qprobs


def problem_per_chain(rng, c, p, dtype="float64", n=200, device="cuda"):
    """Per-chain statistics as bsts makes them: one design x [n, p] (the
    first min(p, 4) coefficients nonzero), a response a chain, RegSuf with
    X'y [c, p] and y'y [c] beside the shared X'X, the prior from the first
    response, masks [c, p] and one sweep's flip noise on ``device``: (suf,
    prior, mask, noise)."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.models.glm import regression as reg

    tdt = getattr(torch, dtype)
    x = rng.normal(size=(n, p))
    beta = np.zeros(p)
    beta[:min(p, 4)] = rng.choice([-1.5, 1.5], size=min(p, 4))
    ys = x @ beta + rng.normal(size=(c, n)) * rng.uniform(0.5, 2.0, (c, 1))
    xt = torch.tensor(x, dtype=tdt, device=device)
    yt = torch.tensor(ys, dtype=tdt, device=device)
    suf = reg.RegSuf(xtx=xt.T @ xt, xty=yt @ xt, yty=(yt * yt).sum(-1),
                     n=torch.tensor(float(n), dtype=tdt, device=device))
    prior = reg.SpikeSlabPrior.from_data(xt, yt[0],
                                         expected_model_size=min(3.0, p))
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 30)))
    spec = {"gamma_u": ((p,), "uniform"), "perm": ((p,), "permutation"),
            "flip_u": ((p,), "uniform")}
    drawn = prng.draw(gen, spec, c, tdt)
    mask = drawn.pop("gamma_u") < 0.3
    return suf, prior, mask, drawn


def bsts_reg_problem(dtype="float32", chains=REG_CHAINS, seed=0):
    """Kernel (a)'s inputs at the bsts_reg shape: the committed data's
    predictors x [500, 20], each chain's residual y - Z alpha approximated
    by the series less a random walk of its own (the trend the state
    takes out), the prior of the fit (``BstsModel.fit``'s), masks and one
    sweep's flip noise: (suf, prior, mask, noise)."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.models.glm import regression as reg

    tdt = getattr(torch, dtype)
    x_all, y = data.bsts_reg_xy()
    x = torch.tensor(x_all[:REG_T], dtype=tdt, device="cuda")
    y = torch.tensor(y, dtype=tdt, device="cuda")
    gen = prng.generator(seed, "cuda")
    walk = torch.randn(chains, REG_T, generator=gen, device="cuda",
                       dtype=tdt).cumsum(-1) * 0.3
    resid = y - y.mean() - walk
    suf = reg.RegSuf(xtx=x.T @ x, xty=resid @ x,
                     yty=(resid * resid).sum(-1),
                     n=torch.tensor(float(REG_T), dtype=tdt, device="cuda"))
    prior = reg.SpikeSlabPrior.from_data(x, y, expected_model_size=1.0,
                                         prior_information_weight=1.0)
    p = x.shape[1]
    spec = {"gamma_u": ((p,), "uniform"), "perm": ((p,), "permutation"),
            "flip_u": ((p,), "uniform")}
    drawn = prng.draw(gen, spec, chains, tdt)
    mask = drawn.pop("gamma_u") < torch.clamp_min(
        torch.sigmoid(prior.log_inclusion_odds), 2.0 / p)
    return suf, prior, mask, drawn


def border_cases(suf, prior, mask, noise):
    """(kernel call, plain call, wrapper call) of the per-chain entry."""
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    p = mask.shape[-1]
    ops = sk.sweep_operands(suf, prior)
    return (lambda: sk.launch_sweep(noise, suf, prior, mask, p, None, ops),
            lambda: rs.draw_indicators_swept(noise, suf, prior, mask),
            lambda: sk.draw_indicators_swept(noise, suf, prior, mask,
                                             operands=ops))


def time_border(plain=True):
    """{name: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    passes_mean, shape}} of the per-chain entry at BORDER_SHAPES."""
    out = {}
    for name, (dtype, chains, p) in BORDER_SHAPES.items():
        suf, prior, mask, noise = bsts_reg_problem(dtype, chains)
        kern, ref, wrapper = border_cases(suf, prior, mask, noise)
        new = kern()
        passes = passes_needed(mask, new)
        row = {"shape": [dtype, chains, p, "per-chain border"],
               "ms": median_ms(kern), "call_ms": call_ms(kern),
               "wrapper_ms": median_ms(wrapper),
               "plain_ms": median_ms(ref, reps=3, per=1) if plain else None,
               "passes_mean": float(passes.double().mean())}
        row["bound_ms"], row["bound_by"] = bound_ms(dtype, p, p, passes,
                                                    border=True)
        out[name] = row
    return out


def bench_problem(dtype, chains=BENCH_CHAINS, seed=0, warm=3,
                  mode_jump=False):
    """The bench workload's model on the committed data (expected model
    size 10; the mode jump off, as the bench runs, unless ``mode_jump``),
    masks after ``warm`` sweeps from the initial state (near the
    posterior: the shape of the run's inputs) and one sweep's noise:
    (model, mask, noise)."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.models.glm import regression as reg

    tdt = getattr(torch, dtype)
    x, y = (torch.tensor(a, dtype=tdt, device="cuda")
            for a in data.spike_slab_xy())
    model = reg.SpikeSlabRegression.from_data(
        x, y, expected_model_size=10.0, mode_jump=mode_jump)
    gen = prng.generator(seed, "cuda")
    state = model.init_state(model.draw_init_noise(gen, chains))
    kern = model.kernel()
    for _ in range(warm):
        state = kern(model.draw_noise(gen, chains), state)
    return model, state["gamma"], model.draw_noise(gen, chains)


def passes_needed(mask_in, mask_out, walk=0, jumped=None):
    """Rank-1 passes [C] these inputs need at least: the build sweeps each
    included coordinate, the mode-jump walk makes ``walk`` [C] (its steps,
    taken or not), and each flip taken (a coordinate flips at most once a
    sweep) is one more, counted from the mask after the jump ``jumped``
    (default: ``mask_in``)."""
    start = mask_in if jumped is None else jumped
    return mask_in.sum(-1) + walk + (start != mask_out).sum(-1)


def jump_walk(model, mask, noise, qprobs):
    """The mode-jump walk's passes [C] and the mask after the jump (from
    the plain version's record), for :func:`passes_needed`."""
    from boom_tpu_torch.models.glm import regression_sweep as rs

    n_diff = ((noise["jump_u"] < qprobs) != mask).sum(-1)
    budget = min(rs.MODE_JUMP_BUDGET, mask.shape[-1])
    walk = n_diff * ((n_diff > 0) & (n_diff <= budget))
    record = []
    rs.draw_indicators_swept(noise, model.suf, model.prior, mask,
                             qprobs=qprobs, record=record)
    return walk, record[0][1]


def bound_ms(dtype, p, n_flips, passes, jump=False, border=False):
    """The least time the card could take for one sweep: the bytes (S0 and
    Omega once, each chain's mask in and out, its permutation and flip
    uniforms, with the jump its proposal and acceptance uniforms, with
    ``border`` its row of S0 [p+1]) over the memory rate, or the operations
    (``passes``, the rank-1 passes of S and Omega these inputs need,
    2 ((p+1)^2 + p^2) flops each, and each flip's scalar decision) over the
    float rate, whichever is larger. Returns (ms, "bytes" |
    "operations")."""
    item = 8 if dtype == "float64" else 4
    chains = int(passes.shape[0])
    per_chain = 2 * p + 8 * p + item * p + (item * (p + 1) if jump else 0)
    per_chain += item * (p + 1) if border else 0
    n_bytes = ((p + 1) ** 2 + p * p) * item + chains * per_chain
    flops = (int(passes.sum()) * 2 * ((p + 1) ** 2 + p * p)
             + chains * n_flips * FLIP_SCALAR_FLOPS)
    by_bytes = n_bytes / HBM_BYTES_PER_S
    by_ops = flops / PEAK_FLOPS[dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


def gated_work_ms(dtype, chains, p):
    """The reference's gated work at this shape (2p rank-1 passes a chain,
    whether their gate is on or not) over the float rate: what a kernel
    that makes every pass would need."""
    flops = chains * 2 * p * 2 * ((p + 1) ** 2 + p * p)
    return 1e3 * flops / PEAK_FLOPS[dtype]


def model_qprobs(model):
    """The mode jump's proposal of the model (None without the jump)."""
    from boom_tpu_torch.models.glm import regression as reg

    return (reg.screening_proposal_probs(model.suf, model.prior)
            if model.mode_jump else None)


def ssvs_cases(model, mask, noise):
    """(kernel call, plain call, wrapper call) of one sweep's indicator
    draw: the launch on prepared operands, the plain version on the same
    inputs, the public wrapper (with the model's mode jump, if any)."""
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    qprobs = model_qprobs(model)
    n_flips = rs.flip_count(mask.shape[-1], None, qprobs)
    ops = sk.sweep_operands(model.suf, model.prior, qprobs)
    return (lambda: sk.launch_sweep(noise, model.suf, model.prior, mask,
                                    n_flips, qprobs, ops),
            lambda: rs.draw_indicators_swept(noise, model.suf, model.prior,
                                             mask, qprobs=qprobs),
            lambda: sk.draw_indicators_swept(noise, model.suf, model.prior,
                                             mask, qprobs=qprobs))


def time_ssvs(plain=True):
    """{name: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    gated_work_ms, passes_mean, shape, block_ms}} at SHAPES, on the bench's
    data (block_ms: the kernel at each of BLOCK_SIZES)."""
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    out = {}
    for name, (dtype, chains, jump) in SHAPES.items():
        model, mask, noise = bench_problem(dtype, chains, mode_jump=jump)
        kern, ref, wrapper = ssvs_cases(model, mask, noise)
        new = kern()
        p = mask.shape[-1]
        qprobs = model_qprobs(model)
        walk, jumped = (jump_walk(model, mask, noise, qprobs) if jump
                        else (0, None))
        passes = passes_needed(mask, new, walk, jumped)
        row = {"shape": [dtype, chains, p, "jump" if jump else "no jump"],
               "ms": median_ms(kern),
               "call_ms": call_ms(kern), "wrapper_ms": median_ms(wrapper),
               "plain_ms": median_ms(ref, reps=3, per=1) if plain else None,
               "passes_mean": float(passes.double().mean()),
               "gated_work_ms": gated_work_ms(dtype, chains, p)}
        row["bound_ms"], row["bound_by"] = bound_ms(
            dtype, p, rs.flip_count(p, None, qprobs), passes, jump)
        chosen = sk.THREADS
        row["block_ms"] = {}
        for threads in BLOCK_SIZES:
            sk.THREADS = threads
            try:
                row["block_ms"][threads] = median_ms(kern)
            finally:
                sk.THREADS = chosen
        out[name] = row
    return out


# --split: chains at which the kernel is timed (one chain alone, the
# bench's 1024) and included coordinates of the build-only launches
SPLIT_CHAINS = (1, 1024)
SPLIT_BUILD = (0, 10, 20, 40)


def split_ms(dtype="float32"):
    """Where kernel (a)'s time goes at the bench shape, from launches on
    the bench's model with parts of the work set by the inputs: {part:
    {chains: ms}} for SPLIT_CHAINS chains. "build_k": the first k
    coordinates included and no flip (the staging and k rank-1 passes);
    "decide": no coordinate included and every flip's uniform 1, so that
    no flip is taken (the staging and p decisions); "sweep": the bench's
    masks and noise."""
    import torch

    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    model, mask, noise = bench_problem(dtype)
    p = mask.shape[-1]
    ops = sk.sweep_operands(model.suf, model.prior)
    never = {**noise, "flip_u": torch.ones_like(noise["flip_u"])}

    def launch(m, nz, n_flips, chains):
        nz = {k: v[:chains] for k, v in nz.items()}
        m = m[:chains].contiguous()
        return median_ms(lambda: sk.launch_sweep(nz, model.suf, model.prior,
                                                 m, n_flips, None, ops))

    out = {}
    for k in SPLIT_BUILD:
        first = torch.zeros_like(mask)
        first[:, :k] = True
        out[f"build_{k}"] = {c: launch(first, noise, 0, c)
                             for c in SPLIT_CHAINS}
    out["decide"] = {c: launch(torch.zeros_like(mask), never,
                               rs.flip_count(p), c) for c in SPLIT_CHAINS}
    out["sweep"] = {c: launch(mask, noise, rs.flip_count(p), c)
                    for c in SPLIT_CHAINS}
    return out


def nvcc_report(log_text):
    """{instantiation: {"registers", "spill_bytes", "stack_bytes"}} of
    ssvs_sweep.cu's kernels in an ``nvcc -Xptxas -v`` log."""
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        if "ssvs_sweep_kernel" not in name:
            continue
        ty = "f32" if "ssvs_sweep_kernelIf" in name else "f64"
        jump = "jump" if "Lb1E" in name else "no jump"
        report[f"ssvs_sweep {ty} {jump}"] = {
            "registers": nregs, "spill_bytes": spill, "stack_bytes": stack}
    return dict(sorted(report.items()))


def _need_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ssvs_timing: needs a CUDA card")


def run():
    """Build this tree's kernels and time kernel (a); a JSON-able dict."""
    _need_card()
    from boom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build(("ssvs_sweep",))
    out = {"card": card_line(), "build_s": time.perf_counter() - t0,
           "kernels": {**time_ssvs(), **time_border()}}
    log = _build.log_path("ssvs_sweep")
    out["nvcc"] = nvcc_report(log.read_text()) if log.exists() else {}
    return out


def compare(others, here):
    """Runs the trees ``others`` in order, here, here, ``others`` in
    reverse, each tree's own script in a fresh process, and prints the
    kernel's times side by side."""
    order = ([(t.name, t) for t in others] + [("change", here)] * 2
             + [(t.name, t) for t in reversed(others)])
    runs = []
    for label, tree in order:
        script = tree / "boom_tpu_torch" / "kernels" / "ssvs_timing.py"
        proc = subprocess.run([sys.executable, str(script)],
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise SystemExit(f"ssvs_timing in {tree} failed:\n"
                             f"{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(runs[0][1]["card"])
    print("order: " + " / ".join(label for label, _ in runs))
    here_at = len(others)
    for name in runs[here_at][1]["kernels"]:
        seq = " / ".join(f"{r['kernels'][name]['ms']:.4f}"
                         if name in r["kernels"] else "-" for _, r in runs)
        cur = runs[here_at][1]["kernels"][name]
        print(f"{name} {cur['shape']}: kernel {seq} ms, bound "
              f"{cur['bound_ms']:.5f} ms ({cur['bound_by']}), plain "
              f"{cur['plain_ms']:.2f} ms")
        for lab, r in runs[:here_at + 1]:
            print(f"  {lab} blocks: "
                  f"{json.dumps(r['kernels'].get(name, {}).get('block_ms'))}")
    for lab, r in runs[:here_at + 1]:
        print(f"{lab} nvcc: {json.dumps(r.get('nvcc'))}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", type=Path, nargs="+",
                    help="checkouts to time in turns with this one")
    ap.add_argument("--split", action="store_true",
                    help="where the kernel's time goes (split_ms)")
    args = ap.parse_args()
    if args.split:
        _need_card()
        print(json.dumps({"card": card_line(),
                          **{dtype: split_ms(dtype)
                             for dtype in ("float32", "float64")}}))
    elif args.compare:
        compare([t.resolve() for t in args.compare],
                Path(__file__).resolve().parents[2])
    else:
        print(json.dumps(run()))


if __name__ == "__main__":
    main()
