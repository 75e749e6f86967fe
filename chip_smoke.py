#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (boom_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases:
  0. environment: the card's name and power limit, nvcc, torch;
  1. build the hand-written CUDA scans from ``boom_tpu_torch/csrc``;
  2. each scan kernel against its plain PyTorch version on the card, for
     8 chains at d in {1, 2, 3, 6} and T below, at and above a tile, over
     several tiles, ragged, up to 4096 (``T_CHECK``), plus T=65537 at d=2,
     in float64 (normwise relative error <= 1e-9) and float32 (<= 1e-4);
     ten repeated launches of each at the fit's shape, bit-identical; then
     kernel and plain times, beside the bound, at the shapes of
     ``boom_tpu_torch/kernels/scan_timing.py`` (the fit's, the ASIS
     D-path's, the float64 filter at d=6, and the long series);
  3. one Gibbs sweep of a small local-linear-trend model through the
     kernels (float64, on the card) against the same sweep through the
     plain scans on the CPU, with the same random numbers; then the
     port's main path: a local-linear-trend bsts fit of a T=4096 series
     with 8 chains through ``BstsModel().fit`` on its default device (the
     card), which must run through the kernels, give finite draws, and
     land the variances' posterior medians within a factor 2 of the JAX
     reference's on the same series.

Prints a JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``. Exits nonzero (and prints no result)
when CUDA is unavailable, when the port's package is missing beside this
script, or when any check fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent

# fit configuration of phase 3 (the reference's bsts(y, niter) regime: one
# long series and a handful of chains)
T_FIT, CHAINS, NITER, BURN = 4096, 8, 200, 100
TRUE_VARIANCES = {"sigsq_obs": 0.5 ** 2, "sigma_level_sq": 0.3 ** 2,
                  "sigma_slope_sq": 0.02 ** 2}
# Posterior medians the JAX reference (boom_tpu's Bsts with the default
# priors, parallel_smoother=True, float64 on the CPU) reaches on the same
# series: 8 chains, 1500 sweeps of burn-in, 300 draws. They are not the
# simulated variances: the default observation prior (sigma_guess = sd(y) / 2
# = 400 at sample_size 0.01) adds 0.01 * 400^2 = 1600 to a residual sum of
# squares of about 1024, so sigsq_obs sits near 0.77 and the level variance
# absorbs less than its truth.
REFERENCE_MEDIANS = {"sigsq_obs": 0.7653, "sigma_level_sq": 0.01593,
                     "sigma_slope_sq": 0.003513}
MEDIAN_FACTOR = 2.0
SCAN_TOL = {"float64": 1e-9, "float32": 1e-4}
# scan lengths of the kernel checks: a tile is 256 steps for small elements
# and 128 for large ones (parallel_scan.cu, TileShape), so one below, at and
# above each, several tiles with a ragged last one, and the fit's T
T_CHECK = (2, 33, 127, 128, 129, 255, 256, 257, 1000, 4093, 4096)
T_LONG = 65537
# one float64 sweep, kernels on the card vs plain scans on the CPU: both
# sides differ by rounding only (the scans' association order)
SWEEP_TOL = 1e-8
KERNEL_SOURCE = "boom_tpu_torch/csrc/parallel_scan.cu"
# each combine's call of the one Pallas scan kernel (pallas_call at :241)
REPLACES = {"filter": "boom_tpu/statespace/pallas_scan.py:273",
            "smooth": "boom_tpu/statespace/pallas_scan.py:287",
            "affine": "boom_tpu/statespace/pallas_scan.py:305"}


class SmokeFailure(Exception):
    pass


def check(ok, msg):
    if not ok:
        raise SmokeFailure(msg)


def phase0_environment():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA card")
    if not (REPO / "boom_tpu_torch" / "__init__.py").is_file():
        raise SystemExit("chip_smoke: boom_tpu_torch/ is not beside this "
                         "script; run it from a checkout of the repository")
    sys.path.insert(0, str(REPO))
    from boom_tpu_torch.kernels import _build, scan_timing

    card = scan_timing.card_line()
    print(card)

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60, check=True)
    print("nvcc:", nvcc.stdout.strip().splitlines()[-1])
    print("torch:", torch.__version__, "cuda:", torch.version.cuda,
          "allow_tf32:", torch.backends.cuda.matmul.allow_tf32)
    check(not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must stay full precision")
    return card


def phase1_build():
    from boom_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    _build.library()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s ({_build.library_path().name})")
    return secs


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-300))


def _scans_vs_plain(rng, dtype, c, d, t_len):
    """Each scan through the kernel and its plain version on the same
    inputs: {combine: (normwise relative error, max abs error)}."""
    import torch

    from boom_tpu_torch.kernels import scan_timing as st
    from boom_tpu_torch.statespace import parallel_kalman as pk
    from boom_tpu_torch.statespace import scan_kernel as sk

    params = st.random_system(rng, c, d, dtype)
    y = torch.tensor(rng.normal(size=(c, t_len)), dtype=dtype, device="cuda")
    fm, fp = pk.parallel_filter_moments(params, y)
    fm_k, fp_k = sk.filter_moments(params, y)
    sm = pk.parallel_smooth_means(params, fm, fp)
    sm_k = sk.smooth_means(params, fm, fp)
    normals = [torch.tensor(rng.normal(size=s), dtype=dtype, device="cuda")
               for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
    al, _ = pk.parallel_simulate(params, t_len, *normals)
    al_k, _ = sk.simulate(params, t_len, *normals)
    torch.cuda.synchronize()
    return {
        "filter": (max(_rel(fm_k, fm), _rel(fp_k, fp)),
                   max(float((fm_k - fm).abs().max()),
                       float((fp_k - fp).abs().max()))),
        "smooth": (_rel(sm_k, sm), float((sm_k - sm).abs().max())),
        "affine": (_rel(al_k, al), float((al_k - al).abs().max()))}


def _deterministic(rng, reps=10):
    """Ten launches of each scan at the fit's shape give bit-identical
    outputs (the fit's "same seed, same draws" rests on it)."""
    import torch

    from boom_tpu_torch.kernels import scan_timing as st

    cases = st.scan_cases(rng, "float64", CHAINS, 2, T_FIT)
    same = {}
    for k, (kern, _plain) in cases.items():
        first = kern()
        same[k] = all(torch.equal(first, kern()) for _ in range(reps - 1))
    torch.cuda.synchronize()
    return same


def phase2_kernels_vs_plain():
    """Every scan kernel against its plain version at T below, at and above
    a tile (128 or 256 steps), over several tiles, ragged, and one long
    series; then determinism and the times of scan_timing.SHAPES. Returns
    the fit shape's numbers per combine."""
    import torch

    from boom_tpu_torch.kernels import scan_timing as st

    rng = np.random.default_rng(20261016)
    c = CHAINS
    worst = {}
    at_fit = {}
    bad = []
    cases = [(d, t) for d in (1, 2, 3, 6) for t in T_CHECK]
    cases.append((2, T_LONG))
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        for d, t_len in cases:
            res = _scans_vs_plain(rng, dtype, c, d, t_len)
            print(f"scan {tag} d={d} T={t_len}: " + ", ".join(
                f"{k} rel {v:.2e} abs {a:.2e}" for k, (v, a) in res.items()))
            for k, (v, a) in res.items():
                key = (k, tag)
                worst[key] = max(worst.get(key, 0.0), v)
                if not (np.isfinite(v) and v <= SCAN_TOL[tag]):
                    bad.append(f"{k} {tag} d={d} T={t_len}: {v:.3e}")
                if tag == "float64" and d == 2 and t_len == T_FIT:
                    at_fit[k] = {"max_abs_err": a}
    for (k, tag), v in sorted(worst.items()):
        print(f"worst {k} {tag}: {v:.3e} (tolerance {SCAN_TOL[tag]:g})")
    check(not bad, "scan kernel disagrees with its plain version: "
          + "; ".join(bad))

    same = _deterministic(rng)
    print("ten repeated launches at the fit's shape bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"repeated launches differ: {same}")

    # device times of each scan alone, kernel and plain (scan_timing)
    for shape, per in st.time_scans(rng).items():
        dtype, batch, d, t_len = st.SHAPES[shape][:4]
        for k, r in per.items():
            plain = (f"{r['plain_ms']:.4f} ms" if r["plain_ms"] is not None
                     else "not timed")
            print(f"time {shape} {k} {dtype} B={batch} d={d} T={t_len}: "
                  f"kernel {r['ms']:.4f} ms, plain {plain}, bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); one call "
                  f"on the host clock {r['call_ms']:.4f} ms")
            if shape == "fit":
                at_fit[k].update({key: r[key] for key in (
                    "ms", "plain_ms", "bound_ms", "bound_by")})
    return at_fit


def _llt_series(t_len, seed=4207):
    """Local-linear-trend data as bench.py:173-175 makes them (slope sd
    0.02, level sd 0.3, observation sd 0.5), drawn with numpy."""
    rng = np.random.default_rng(seed)
    slope = np.cumsum(0.02 * rng.normal(size=t_len))
    level = np.cumsum(slope + 0.3 * rng.normal(size=t_len)) + 5.0
    return level + 0.5 * rng.normal(size=t_len)


def phase3_sweep_vs_plain():
    """One sweep (init included) of a T=600 local-linear-trend model
    through the kernels against the plain scans on the CPU, in float64 with
    the same noise. Returns the largest relative difference."""
    import torch

    from boom_tpu_torch import rng
    from boom_tpu_torch.inference.driver import tree_map
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import LocalLinearTrend

    y = torch.tensor(_llt_series(600, seed=7), dtype=torch.float64)

    def sweep(device, mode, init_noise, noise):
        yy = y.to(device)
        model = Bsts(y=yy, blocks=[LocalLinearTrend.default(yy)],
                     parallel_smoother=mode)
        moved = [tree_map(lambda t: t.to(device), n)
                 for n in (init_noise, noise)]
        state = model.kernel()(moved[1], model.init_state(moved[0]))
        return tree_map(lambda t: t.cpu(), state)

    plain_model = Bsts(y=y, blocks=[LocalLinearTrend.default(y)])
    gen = rng.generator(3)
    init_noise = plain_model.draw_init_noise(gen, CHAINS)
    noise = plain_model.draw_noise(gen, CHAINS)
    on_card = sweep("cuda", "pallas", init_noise, noise)
    plain = sweep("cpu", True, init_noise, noise)
    errs = []
    tree_map(lambda a, b: errs.append(_rel(a, b)), on_card, plain)
    worst = max(errs)
    print(f"sweep float64 T=600 C={CHAINS}: kernels on the card vs plain on "
          f"the CPU, worst relative difference {worst:.3e} "
          f"(tolerance {SWEEP_TOL:g})")
    check(np.isfinite(worst) and worst <= SWEEP_TOL,
          f"sweep through the kernels disagrees: {worst:.3e}")
    return worst


def phase3_fit(card):
    import torch

    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.statespace import scan_kernel as sk

    y = _llt_series(T_FIT)
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = BstsModel().add_local_linear_trend().fit(
        y, niter=NITER, burn=BURN, num_chains=CHAINS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    print(f"fit: T={T_FIT} chains={CHAINS} burn={BURN} niter={NITER} "
          f"in {elapsed:.2f} s; kernel launches {launches}")
    check(model._model.y.device.type == "cuda"
          and model._model.y.dtype == torch.float32,
          f"the fit ran on {model._model.y.device} in {model._model.y.dtype},"
          " not on the card in float32")
    check(model._model._smoother() is sk.simulation_smoother,
          "'auto' did not pick the CUDA scan smoother")
    for k, n in launches.items():
        check(n >= BURN + NITER,
              f"{k} scan launched {n} times < {BURN + NITER} sweeps")

    draws = model.draws
    trend = draws["blocks"]["trend"]
    series = {"sigsq_obs": draws["sigsq_obs"],
              "sigma_level_sq": trend["sigma_level_sq"],
              "sigma_slope_sq": trend["sigma_slope_sq"]}
    check(all(bool(torch.isfinite(v).all())
              for v in (*series.values(), draws["alpha"])),
          "non-finite draws")
    check(tuple(draws["alpha"].shape) == (CHAINS, NITER, T_FIT, 2),
          f"alpha draws have shape {tuple(draws['alpha'].shape)}")
    stacked = torch.stack([v.double() for v in series.values()], dim=-1)
    rhat = diagnostics.potential_scale_reduction(stacked).cpu().numpy()
    ess = diagnostics.effective_sample_size(stacked).cpu().numpy()
    med = {k: float(v.double().median()) for k, v in series.items()}
    for i, k in enumerate(series):
        print(f"{k}: median {med[k]:.5g} (reference "
              f"{REFERENCE_MEDIANS[k]}, simulated {TRUE_VARIANCES[k]}) "
              f"rhat {rhat[i]:.4f} ess {ess[i]:.1f}")
    sweeps = BURN + NITER
    print(f"fit rate [{card}]: {sweeps / elapsed:.2f} sweeps/s, "
          f"min-ESS/s {float(ess.min()) / elapsed:.2f}")
    for k, ref in REFERENCE_MEDIANS.items():
        check(ref / MEDIAN_FACTOR <= med[k] <= ref * MEDIAN_FACTOR,
              f"posterior median of {k} {med[k]:.4g} is not within a "
              f"factor {MEDIAN_FACTOR:g} of the reference's {ref} "
              f"(simulated value {TRUE_VARIANCES[k]})")
    return launches


def main():
    card = phase0_environment()
    import torch

    try:
        phase1_build()
        at_fit = phase2_kernels_vs_plain()
        phase3_sweep_vs_plain()
        launches = phase3_fit(card)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    # library_ms: no single PyTorch call computes a prefix scan whose
    # combine is a non-commutative matrix operation
    kernels = [{"name": f"parallel_scan_{k}", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES[k],
                "launches": launches[k], **at_fit[k], "library_ms": None}
               for k in launches]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
