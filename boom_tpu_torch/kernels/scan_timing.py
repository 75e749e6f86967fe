"""Times of the parallel-in-time scan kernels on the card, beside their
bounds, at the shapes the bsts fit gives them.

    python3 boom_tpu_torch/kernels/scan_timing.py                # this tree
    python3 boom_tpu_torch/kernels/scan_timing.py --tree DIR     # DIR's port
    python3 boom_tpu_torch/kernels/scan_timing.py --compare DIR  # both

``--tree DIR`` imports ``boom_tpu_torch`` from the checkout DIR (another
commit of this repository, unpacked with ``git archive``), builds its
kernels there and prints one JSON line of times. ``--compare DIR`` runs DIR
and this tree in turns (DIR, this, this, DIR), each in its own process on
the same card, prints the times side by side with each tree's
``nvcc -Xptxas -v`` registers and spills, and with ``--json PATH`` writes
every number of the four runs to PATH. It uses only functions that the port
has had since its first slice, so any of its commits can be DIR.

``chip_smoke.py`` takes its shapes, inputs and bounds from here. Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import functools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# H100 SXM (NVIDIA's data sheet, dense, at the 700 W limit): device memory
# rate, and the float rates outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}

# name: (dtype, batch rows, state dim, T, combines, time the plain version)
SHAPES = {
    # the fit's simulation smoother: 8 chains, float64 (bsts.SMOOTHER_DTYPE)
    "fit": ("float64", 8, 2, 4096, ("filter", "smooth", "affine"), True),
    # the ASIS D-path: 8 chains x 2 groups, float32, T-1 steps
    "dpath": ("float32", 16, 2, 4095, ("filter", "smooth", "affine"), True),
    "filter_d6": ("float64", 8, 6, 4096, ("filter",), True),
    "long": ("float64", 8, 2, 65537, ("filter", "smooth", "affine"), False),
}


def n_components(name, d):
    return 3 * d * d + 2 * d if name == "filter" else d * d + d


def combine_flops(name, d):
    """Floating-point operations of one combine as the kernel computes it
    (two solves and seven d x d products for the filter; one product and
    one matrix-vector product for the others)."""
    if name == "filter":
        return 22 * d ** 3 + 12 * d ** 2
    return 2 * d ** 3 + 2 * d ** 2


def bound_ms(name, dtype, batch, d, t_len):
    """The least time the card could take: each element read once and
    written once over the memory rate, or T-1 combines a row over the
    float rate, whichever is larger. Returns (ms, "bytes" | "operations")."""
    itemsize = 8 if dtype == "float64" else 4
    by_bytes = 2 * batch * n_components(name, d) * t_len * itemsize \
        / HBM_BYTES_PER_S
    by_ops = batch * (t_len - 1) * combine_flops(name, d) / PEAK_FLOPS[dtype]
    return (1e3 * max(by_bytes, by_ops),
            "bytes" if by_bytes >= by_ops else "operations")


@functools.cache
def _spin_cycles_per_ms():
    """The card's clock as ``torch.cuda._sleep`` counts it."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(10 ** 7)
    end.record()
    end.synchronize()
    return 10 ** 7 / start.elapsed_time(end)


def call_ms(fn):
    """Host-clock time of one call that ends in a synchronize: what a caller
    waits for it on an idle card, launch overhead included."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def median_ms(fn, reps=20, per=10):
    """Device time of one call of ``fn``: the median over ``reps`` of the
    CUDA-event span around ``per`` calls, divided by ``per``. Each span
    starts behind a spin of the card long enough for the host to enqueue
    all ``per`` calls first, so that it holds the device's work and not the
    host's launch overhead (a call whose host side is slower than its
    device side still shows its host time)."""
    import torch

    fn()
    host = min(call_ms(fn), 100.0)
    spin = int(2 * per * host * _spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def random_system(rng, c, d, dtype, q=None, device="cuda"):
    """C random stable static systems (spectral radius < 1) on ``device``
    (the card); q (default d) state errors."""
    import torch

    from boom_tpu_torch.statespace.kalman import SsmParams

    q = d if q is None else q

    def one():
        qm, _ = np.linalg.qr(rng.normal(size=(d, d)))
        t_mat = qm @ np.diag(rng.uniform(0.5, 0.97, d)) @ qm.T
        lq = 0.3 * rng.normal(size=(q, q))
        mp = rng.normal(size=(d, d))
        return dict(z=rng.normal(size=d), t_mat=t_mat, r_mat=np.eye(d, q),
                    q_mat=lq @ lq.T + 0.1 * np.eye(q),
                    h=np.asarray(rng.uniform(0.3, 1.0)),
                    a0=rng.normal(size=d), p0=mp @ mp.T + np.eye(d))

    systems = [one() for _ in range(c)]
    return SsmParams(**{
        k: torch.tensor(np.stack([s[k] for s in systems]), dtype=dtype,
                        device=device) for k in systems[0]})


def scan_cases(rng, dtype, batch, d, t_len):
    """Per combine: (kernel call, plain call) on the elements the smoother
    would give the scan at this shape; the smooth scan runs in reverse."""
    import torch

    from boom_tpu_torch.statespace import parallel_kalman as pk
    from boom_tpu_torch.statespace import scan_kernel as sk

    tdt = getattr(torch, dtype)
    params = random_system(rng, batch, d, tdt)
    y = torch.tensor(rng.normal(size=(batch, t_len)), dtype=tdt,
                     device="cuda")
    el = pk._filter_elements(params, y)
    fm, fp = sk.filter_moments(params, y)
    e_all, g_all = pk._smooth_elements(params, fm, fp)
    normals = [torch.tensor(rng.normal(size=s), dtype=tdt, device="cuda")
               for s in ((batch, d), (batch, t_len - 1, d))]
    a_el, b_el = pk._simulate_elements(params, t_len, *normals)
    stk_f = sk._stack((el.a, el.c, el.j), (el.b, el.eta))
    stk_s = sk._stack((e_all,), (g_all,))
    stk_a = sk._stack((a_el,), (b_el,))
    return {
        "filter": (lambda: sk.inclusive_scan("filter", d, stk_f),
                   lambda: pk.hillis_steele(pk._combine_filter, tuple(el))),
        "smooth": (lambda: sk.inclusive_scan("smooth", d, stk_s,
                                             reverse=True),
                   lambda: pk.hillis_steele(pk._combine_smooth,
                                            (e_all, g_all), reverse=True)),
        "affine": (lambda: sk.inclusive_scan("affine", d, stk_a),
                   lambda: pk.hillis_steele(pk._combine_affine,
                                            (a_el, b_el))),
    }


def time_scans(rng):
    """{shape: {combine: {ms, plain_ms, call_ms, bound_ms, bound_by}}} over
    SHAPES: device times of the kernel and the plain version, and the host
    time of one kernel call."""
    out = {}
    for shape, (dtype, batch, d, t_len, names, plain) in SHAPES.items():
        cases = scan_cases(rng, dtype, batch, d, t_len)
        out[shape] = {}
        for name in names:
            kern, ref = cases[name]
            bms, by = bound_ms(name, dtype, batch, d, t_len)
            out[shape][name] = {
                "ms": median_ms(kern),
                "plain_ms": median_ms(ref, per=1) if plain else None,
                "call_ms": call_ms(kern), "bound_ms": bms, "bound_by": by}
    return out


def device_ms_per_call(fn, calls=5):
    """Device kernel time per call of ``fn`` from ``torch.profiler`` (the
    sum of its kernels' times), and its five longest kernels in us."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def dev_us(ev):
        return getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0.0))

    events = [e for e in prof.key_averages() if dev_us(e) > 0]
    top = sorted(events, key=dev_us, reverse=True)[:5]
    return (sum(map(dev_us, events)) / calls / 1e3,
            [[e.key[:60], dev_us(e) / calls] for e in top])


def time_impute_and_sweep(rng, sweeps=20):
    """At the fit's shape (8 chains, T=4096, local linear trend): the
    simulation smoother (float64) and its elements of the state recurrence
    alone (host-clock call, profiled device time), three ways of forming
    the state innovations, and one Gibbs sweep (float32 run), in ms."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.statespace import parallel_kalman as pk
    from boom_tpu_torch.statespace import scan_kernel as sk
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import LocalLinearTrend

    c, d, t_len = 8, 2, 4096
    params = random_system(rng, c, d, torch.float64)
    cuda = dict(dtype=torch.float64, device="cuda")
    y = torch.tensor(np.cumsum(rng.normal(size=(c, t_len)), axis=1), **cuda)
    normals = [torch.tensor(rng.normal(size=s), **cuda)
               for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
    out = {}
    for key, fn in (
            ("impute", lambda: sk.simulation_smoother(params, y, *normals)),
            ("simulate_elements",
             lambda: pk._simulate_elements(params, t_len, *normals[:2]))):
        dev_ms, top = device_ms_per_call(fn)
        out[f"{key}_call_ms"] = statistics.median(
            call_ms(fn) for _ in range(10))
        out[f"{key}_device_ms"] = dev_ms
        out[f"{key}_top_kernels"] = top
    # the state innovations w = R chol(Q) eta_z three ways, device spans:
    # two products (the earlier form), one by the folded R chol(Q), and an
    # elementwise product and sum
    q_chol = torch.linalg.cholesky(params.q_mat)
    r_mat, eta_z = params.r_mat, normals[1]
    out["w_ms"] = {
        "two_products": median_ms(
            lambda: eta_z @ q_chol.transpose(-1, -2)
            @ r_mat.transpose(-1, -2)),
        "folded_product": median_ms(
            lambda: eta_z @ (r_mat @ q_chol).transpose(-1, -2)),
        "elementwise": median_ms(
            lambda: ((r_mat @ q_chol)[:, None] * eta_z[:, :, None, :])
            .sum(-1)),
    }
    series = torch.tensor(np.cumsum(np.cumsum(0.02 * rng.normal(size=t_len))
                                    + 0.3 * rng.normal(size=t_len)),
                          dtype=torch.float32, device="cuda")
    model = Bsts(y=series, blocks=[LocalLinearTrend.default(series)],
                 parallel_smoother="pallas", chains_hint=c)
    gen = prng.generator(0, "cuda")
    state = model.init_state(model.draw_init_noise(gen, c))
    kern = model.kernel()
    times = []
    for _ in range(sweeps + 2):
        noise = model.draw_noise(gen, c)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = kern(noise, state)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    out["sweep_ms"] = statistics.median(times[2:])
    return out


def ptxas_entries(log_text):
    """{mangled kernel name: (registers, stack bytes, spill store bytes)}
    for every kernel entry in an ``nvcc -Xptxas -v`` log."""
    props, regs, entry = {}, {}, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores",
                      line)
        if m and entry:
            props[entry] = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            regs[entry] = int(m.group(1))
    return {name: (nregs, *props.get(name, (0, 0)))
            for name, nregs in regs.items()}


def nvcc_report(log_text):
    """{instantiation: {"registers": n, "spill_bytes": n, "stack_bytes": n}}
    for every scan kernel entry in an ``nvcc -Xptxas -v`` log."""
    pat = re.compile(r"(tile_totals|scan_totals|tile_rescan|scan_kernel)"
                     r"I([fd])NS\d*_\d+(Filter|Smooth|Affine)OpI[fd]Li(\d)E")
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        m = pat.search(name)
        if not m:
            continue
        kernel, ty, op, d = m.groups()
        key = (f"{kernel} {op.lower()} "
               f"{'f64' if ty == 'd' else 'f32'} d{d}")
        report[key] = {"registers": nregs, "spill_bytes": spill,
                       "stack_bytes": stack}
    return dict(sorted(report.items()))


def card_line():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def run_tree(tree):
    """Build DIR's kernels and time them; returns a JSON-able dict."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("scan_timing: needs a CUDA card")
    sys.path.insert(0, str(Path(tree).resolve()))
    from boom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()  # every source of DIR's port (older ports have one)
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(20261016)
    out = {"tree": str(tree), "card": card_line(), "build_s": build_s,
           "scans": time_scans(rng), **time_impute_and_sweep(rng)}
    log = (_build.log_path("parallel_scan") if hasattr(_build, "log_path")
           else _build.BUILD_DIR / "nvcc.log")
    out["nvcc"] = nvcc_report(log.read_text()) if log.exists() else {}
    return out


def compare(parent, here, json_path=None):
    """Runs parent, here, here, parent, each in a fresh process."""
    runs = []
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        proc = subprocess.run(
            [sys.executable, __file__, "--tree", str(tree)],
            capture_output=True, text=True, timeout=1500)
        if proc.returncode != 0:
            raise SystemExit(f"scan_timing --tree {tree} failed:\n"
                             f"{proc.stderr[-4000:]}")
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
    print(runs[0][1]["card"])
    for shape, per in runs[1][1]["scans"].items():
        for name, cur in per.items():
            old = [r["scans"][shape][name]["ms"] for lab, r in runs
                   if lab == "parent"]
            new = [r["scans"][shape][name]["ms"] for lab, r in runs
                   if lab == "change"]
            calls = [r["scans"][shape][name]["call_ms"] for _, r in runs]
            plain = cur["plain_ms"]
            print(f"{shape:10s} {name:7s} parent "
                  + " / ".join(f"{v:.4f}" for v in old) + " ms, change "
                  + " / ".join(f"{v:.4f}" for v in new)
                  + f" ms, bound {cur['bound_ms']:.5f} ms "
                  f"({cur['bound_by']})"
                  + (f", plain {plain:.3f} ms" if plain else "")
                  + "; host-clock call (P C C P) "
                  + " / ".join(f"{v:.4f}" for v in calls) + " ms")
    for key in ("impute_call_ms", "impute_device_ms",
                "simulate_elements_call_ms", "simulate_elements_device_ms",
                "sweep_ms"):
        print(f"{key}: " + ", ".join(f"{lab} {r[key]:.4f}"
                                     for lab, r in runs))
    for lab, r in (runs[0], runs[1]):
        for key in ("impute_top_kernels", "simulate_elements_top_kernels"):
            print(f"{key} {lab}: " + "; ".join(
                f"{name} {us:.1f} us" for name, us in r[key]))
    print("w_ms (change): " + ", ".join(
        f"{k} {v:.4f}" for k, v in runs[1][1]["w_ms"].items()))
    print("build_s: " + ", ".join(f"{lab} {r['build_s']:.1f}"
                                  for lab, r in runs))
    for lab, r in (runs[0], runs[1]):
        for inst, rep in r["nvcc"].items():
            print(f"nvcc {lab} {inst}: {rep['registers']} registers, "
                  f"{rep['spill_bytes']} bytes spill stores, "
                  f"{rep['stack_bytes']} bytes stack")
    if json_path is not None:
        json_path.parent.mkdir(parents=True, exist_ok=True)
        json_path.write_text(json.dumps(
            [{"label": lab, **r} for lab, r in runs], indent=1))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", type=Path,
                    help="checkout whose boom_tpu_torch to time")
    ap.add_argument("--compare", type=Path,
                    help="checkout to time in turns with this one")
    ap.add_argument("--json", type=Path,
                    help="with --compare: file for every number of the runs")
    args = ap.parse_args()
    here = Path(__file__).resolve().parents[2]
    if args.compare:
        compare(args.compare.resolve(), here, args.json)
    else:
        print(json.dumps(run_tree(args.tree or here)))


if __name__ == "__main__":
    main()
