"""Times of the HMM kernels H1 (the forward filter) and H2 (the backward
sampler with the path's statistics), ``csrc/hmm.cu``, on the card, beside
their bounds and their plain versions' times.

    python3 boom_tpu_torch/kernels/hmm_timing.py                # one JSON line
    python3 boom_tpu_torch/kernels/hmm_timing.py --compare DIR  # both trees

Shapes (``SHAPES``): ``chip_smoke.py`` phase 9's (4,096 chains, T = 1,200,
S = 2, float32), the same at S = 4 and 8, one warp of 32 chains at S = 2,
and few chains on a long series (8 chains, T = 4,096, S = 2). The bound is
``bound_ms``: each input read once and each output written once at the
memory rate, or the operations at the float rate, whichever is larger
(the memory rate at every shape here). ``floor_ms`` is the dependent chain
a lane walks in the split layout (``csrc/hmm.cu``: L lanes a chain, lane k
owning ceil(T / L) steps): ceil(T / L) steps of each pass plus log2 L
shuffle levels, estimated from assumed latencies (``STEP_CYCLES``,
``LEVEL_CYCLES``); L is the kernel's own choice (``hmm_kernel.lanes``).
``by_lanes`` times phase 9's shape at S = 2 and 4-8 at every L the
instantiation allows (``hmm_kernel.forced_lanes``), beside the chosen one.
``--split`` shows where the time of phase 9's shape goes: variants of
``csrc/hmm.cu`` with one part taken out (``SPLIT_VARIANTS``, text patches
of the source, S = 2 alone, built into the git-ignored
``build/boom_tpu_torch/hmm_split/``), each timed beside the whole.

``--compare DIR`` runs this script on the package of the checkout DIR
(another commit of this repository, unpacked with ``git archive``; its
kernels build under DIR) and on this tree's in turns (DIR, this, this,
DIR), each in its own process on the same card, so that both trees take
the same inputs at the same shapes (``--tree DIR`` is one such run), and
prints the times side by side; ``--json PATH`` writes every number of the
four runs to PATH. ``chip_smoke.py`` phase 2f takes its inputs, bounds and
times from here. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

if __package__ in (None, ""):
    # the package timed: this checkout's, or with --tree DIR the checkout
    # DIR's (``compare`` times another commit's kernels with this script)
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--tree") + 1])
                           .resolve() if "--tree" in sys.argv[:-1]
                           else Path(__file__).resolve().parents[2]))

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
          "one_warp": ("float32", 32, 1200, 2),
          "few_chains": ("float32", 8, 4096, 2)}
# the shapes timed at every L (phase 9's at S = 2 and 4-8: where the split
# layout's S x S transfer stops paying)
LANE_SHAPES = {"phase9": SHAPES["phase9"],
               **{f"s{s}": ("float32", 4096, 1200, s) for s in range(4, 9)}}
# a step of a lane's dependent chain by assumed latencies (cycles), (pass
# 1, the walk). H1: one log-sum-exp a step in either pass, the normaliser
# beside it: an exp and a log through the MUFU (~22 each) and ~7 dependent
# adds, compares and selects of ~4. H2: pass 1 composes the maps (a
# shift and a mask a state, in parallel over the states, then the or:
# ~4 dependent operations of ~4), the walk looks one entry up (a shift and
# a mask); with L = 1 its walk recomputes the argmax at z_{t+1} (a column
# select of log_trans, an add, a subtract and S compares: ~6 of ~4 at S =
# 2).
STEP_CYCLES = {"hmm_forward": (72, 72), "hmm_backward": (16, 8)}
WALK_ALONE_CYCLES = {"hmm_forward": 72, "hmm_backward": 24}
# a shuffle level of the scans: a shuffle (~30) and the combine's chain
# (H1: one log-sum-exp; H2: a composition)
LEVEL_CYCLES = {"hmm_forward": 30 + 72, "hmm_backward": 30 + 16}
# an H100 SXM's boost clock
CLOCK_HZ = 1.98e9
# --split: (kernels it applies to, [(text of csrc/hmm.cu, its stand-in)]);
# a variant's results are wrong, only its time is read
_NO_COPY = ("if (e < n * W) copy_async(buf + r * P + e, row + e);",
            "if (e < n * W && t_len < 0) copy_async(buf + r * P + e, "
            "row + e);")
SPLIT_VARIANTS = {
    "without the input copies": (("hmm_forward", "hmm_backward"),
                                 [_NO_COPY]),
    "without the output write-back": (
        ("hmm_forward", "hmm_backward"),
        [("if (e < n * W) row[e] = buf[r * P + e];",
          "if (e < n * W && t_len < 0) row[e] = buf[r * P + e];")]),
    "H1 without the transfer and scan": (
        ("hmm_forward",),
        [("  if constexpr (L > 1) {\n    {\n",
          "  if constexpr (L < 0) {\n    {\n")]),
    "H2 without the walk": (
        ("hmm_backward",),
        [("    // 3. the walk through the maps\n    pass(",
          "    // 3. the walk through the maps\n    if (t_len > 0) return;\n"
          "    pass(")]),
    "H2 without the Gumbel logs": (
        ("hmm_backward",),
        [("g[i] = log(-log(u_row[i]));", "g[i] = u_row[i];")]),
}


def problem(rng, c, t_len, s, dtype="float64", device="cuda", deep=False):
    """An H1 / H2 problem drawn on ``device`` from a generator seeded by
    the numpy ``rng``: log_lik [C, T, S] (-2 N(0, 1)^2), log_trans
    [C, S, S] and log_init [C, S] (log Dirichlet(1) rows: normalised
    exponentials), y [T] and the Gumbel uniforms path_u [C, T, S] in
    [tiny, 1). ``deep``: every odd state's log likelihood 200 lower over
    the middle half of the steps, so that its log alphas fall far below
    -87, where float32's exp underflows."""
    import torch

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=device).manual_seed(
        int(rng.integers(1 << 62)))

    def draw(fn, *shape):
        return fn(shape, generator=gen, dtype=dt, device=device)

    def log_dirichlet(*shape):
        e = -torch.log1p(-draw(torch.rand, *shape))  # Exp(1)
        return torch.log(e / e.sum(-1, keepdim=True))

    log_lik = -2.0 * draw(torch.randn, c, t_len, s) ** 2
    if deep:
        log_lik[:, t_len // 4:(3 * t_len) // 4, 1::2] -= 200.0
    return {"log_lik": log_lik,
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


def floor_ms(name, t_len, lanes):
    """The dependent chain a lane of H1 or H2 walks at L = ``lanes``:
    ceil(T / L) steps of each pass and log2 L shuffle levels (L = 1: T
    steps of the walk alone)."""
    if lanes == 1:
        cycles = t_len * WALK_ALONE_CYCLES[name]
    else:
        cycles = (math.ceil(t_len / lanes) * sum(STEP_CYCLES[name])
                  + int(math.log2(lanes)) * LEVEL_CYCLES[name])
    return 1e3 * cycles / CLOCK_HZ


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


def _lanes(name, dtype, s, c):
    """L of this tree's kernel (1 for a tree without the split layout)."""
    import torch

    from boom_tpu_torch.models import hmm_kernel

    if not hasattr(hmm_kernel, "lanes"):
        return 1
    return hmm_kernel.lanes(name, getattr(torch, dtype), s, c)


def time_hmm(rng, shapes=SHAPES, plain_at=("phase9",)):
    """{shape: {kernel: {ms, plain_ms (None where not timed), bound_ms,
    bound_by, lanes, floor_ms}}}, device spans."""
    out = {}
    for shape, (dtype, c, t_len, s) in shapes.items():
        per = {}
        for name, (kern, plain) in cases(rng, dtype, c, t_len, s).items():
            bound, by = bound_ms(name, dtype, c, t_len, s)
            lanes = _lanes(name, dtype, s, c)
            per[name] = {"ms": median_ms(kern),
                         "plain_ms": (median_ms(plain, reps=3, per=1)
                                      if shape in plain_at else None),
                         "bound_ms": bound, "bound_by": by, "lanes": lanes,
                         "floor_ms": floor_ms(name, t_len, lanes),
                         "shape": f"{dtype} C={c} T={t_len} S={s}"}
        out[shape] = per
    return out


def time_by_lanes(rng, shapes=LANE_SHAPES):
    """{shape: {kernel: {L: ms}}} at every L the instantiation allows."""
    from boom_tpu_torch.models import hmm_kernel

    out = {}
    for shape, (dtype, c, t_len, s) in shapes.items():
        per = {}
        for name, (kern, _plain) in cases(rng, dtype, c, t_len, s).items():
            per[name] = {}
            for lanes in (1, 2, 4, 8, 16, 32):
                with hmm_kernel.forced_lanes(lanes):
                    if _lanes(name, dtype, s, c) != lanes:
                        continue
                    per[name][lanes] = median_ms(kern)
        out[shape] = per
    return out


def nvcc_report(log_text):
    """{"forward f32 S2 L8": {"registers", "spill_bytes", "stack_bytes"},
    ...} for every H1 / H2 instantiation in an ``nvcc -Xptxas -v`` log (no
    L: a tree with a lane a chain)."""
    pat = re.compile(r"(forward|backward)_kernelI([fd])Li(\d+)E(?:Li(\d+)E)?")
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        m = pat.search(name)
        if m:
            kernel, ty, s, lanes = m.groups()
            key = f"{kernel} {'f64' if ty == 'd' else 'f32'} S{s}"
            report[key + (f" L{lanes}" if lanes else "")] = {
                "registers": nregs, "spill_bytes": spill,
                "stack_bytes": stack}
    return report


def run(lane_sweep=True):
    """Build this tree's H1 and H2 and time them; a JSON-able dict."""
    import time

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("hmm_timing: needs a CUDA card")
    from boom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library("hmm")
    out = {"card": card_line(), "build_s": time.perf_counter() - t0,
           "times": time_hmm(np.random.default_rng(20261022)),
           "nvcc": nvcc_report(_build.log_path("hmm").read_text())}
    if lane_sweep:
        out["by_lanes"] = time_by_lanes(np.random.default_rng(20261023))
    return out


def split(shape="phase9"):
    """{variant: {kernel: ms}} at ``shape`` (S = 2): the whole kernels
    ("whole") and each of SPLIT_VARIANTS, built from patched copies of this
    tree's csrc/hmm.cu, every variant's library loaded in place of the
    build's."""
    import ctypes

    import torch

    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.models import hmm_kernel

    dtype, c, t_len, s = SHAPES[shape]
    src = _build.SOURCES["hmm"].read_text()
    src, n = re.subn(r"#define BOOM_HMM_CASES\(X\) \\\n.*\n.*\n",
                     f"#define BOOM_HMM_CASES(X) X({s})\n", src)
    assert n == 1, "csrc/hmm.cu: BOOM_HMM_CASES not found"
    out_dir = _build.BUILD_DIR / "hmm_split"
    out_dir.mkdir(parents=True, exist_ok=True)
    variants = {"whole": (("hmm_forward", "hmm_backward"), [])}
    variants.update(SPLIT_VARIANTS)
    procs = {}
    for i, (name, (_kernels, patches)) in enumerate(variants.items()):
        text = src
        for old, new in patches:
            assert old in text, f"{name}: {old!r} not in csrc/hmm.cu"
            text = text.replace(old, new)
        cu = out_dir / f"variant{i}.cu"
        cu.write_text(text)
        procs[name] = (cu.with_suffix(".so"), subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the variant {name}:\n"
                             f"{report[-3000:]}")
        libs[name] = lib
    library = _build.library
    out = {}
    try:
        for name, (kernels, _patches) in variants.items():
            lib = ctypes.CDLL(str(libs[name]))
            for tag in _build.HMM_DTYPES:
                _build._declare(lib, "hmm_forward", f"boom_hmm_forward_{tag}")
                _build._declare(lib, "hmm_backward",
                                f"boom_hmm_backward_{tag}")
            _build._declare(lib, "hmm_lanes", "boom_hmm_lanes")
            _build._declare(lib, "hmm_set_lanes", "boom_hmm_set_lanes")
            _build.library = lambda _name, lib=lib: lib
            rng = np.random.default_rng(20261024)
            out[name] = {k: median_ms(kern) for k, (kern, _plain)
                         in cases(rng, dtype, c, t_len, s).items()
                         if k in kernels}
            out[name]["lanes"] = hmm_kernel.lanes(
                "hmm_forward", getattr(torch, dtype), s, c)
    finally:
        _build.library = library
    return out


def compare(parent, here, json_path=None):
    """Runs parent, here, here, parent: this script in a fresh process on
    each tree's package (its kernels, built under it, its wrappers and its
    plain versions; these shapes, inputs and bounds), and prints the
    kernels' times side by side."""
    runs = []
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--tree", str(tree), "--no-lane-sweep"],
                              capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise SystemExit(f"hmm_timing in {tree} failed:\n"
                             f"{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(runs[0][1]["card"])
    for shape in SHAPES:
        for name in ("hmm_forward", "hmm_backward"):
            rows = [r["times"][shape][name] for _, r in runs]
            cur = rows[1]
            print(f"{name} {shape} {cur['shape']}: kernel (P C C P) "
                  + " / ".join(f"{r['ms']:.4f}" for r in rows)
                  + f" ms, bound {cur['bound_ms']:.5f} ms ({cur['bound_by']}),"
                  f" L {rows[0]['lanes']} -> {cur['lanes']} (floor "
                  f"{cur['floor_ms']:.4f} ms)")
    print("build_s: " + ", ".join(f"{lab} {r['build_s']:.1f}"
                                  for lab, r in runs))
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(
            {"runs": [{"label": lab, **r} for lab, r in runs]}, indent=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--compare", type=Path,
                    help="checkout to time in turns with this one")
    ap.add_argument("--json", type=Path,
                    help="with --compare: file for every number of the runs")
    ap.add_argument("--tree", type=Path,
                    help="time the package of this checkout instead")
    ap.add_argument("--no-lane-sweep", action="store_true",
                    help="skip the times at every L")
    ap.add_argument("--split", action="store_true",
                    help="time variants without one part each")
    args = ap.parse_args()
    if args.split:
        print(json.dumps({"card": card_line(), "split": split()}))
    elif args.compare:
        here = Path(__file__).resolve().parents[2]
        compare(args.compare.resolve(), here, args.json)
    else:
        print(json.dumps(run(lane_sweep=not args.no_lane_sweep)))


if __name__ == "__main__":
    main()
