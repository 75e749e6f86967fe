#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (boom_tpu_torch) on one GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases:
  0. environment: the card's name and power limit, nvcc, torch;
  1. build the hand-written CUDA kernels from ``boom_tpu_torch/csrc``, one
     ``nvcc`` a source, all at once;
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
     reference's on the same series;
  2b. the sequential Kalman kernels (K1, the loglik; K2, the fused
     simulation smoother; ``csrc/kalman_seq.cu``) against their plain
     versions on the card: d in {1, 2, 3, 6}, T in {2, 31, 32, 33, 67,
     500, 4096} (K2 stages 32 steps at a time: one below, at, one above a
     chunk, a ragged last one), 33 and 4095 chains (a last warp partly
     empty), masked and dense, float64 (<= 1e-9) and float32 (K1, <= 1e-4),
     K1 at the bsts_llt width (69,632 series); J1 and J2 (the loglik's
     gradient, and its gradient and Hessian) against autograd of the plain
     loop, directly and through ``torch.autograd`` (<= 1e-9); ten launches
     of each at the bsts_llt shape, bit-identical; then their times beside
     bounds and plain times (``boom_tpu_torch/kernels/kalman_timing.py``);
  4. the reference's bsts_llt workload at full width (bench.py:170-200) on
     the bench's own series (``boom_tpu_torch/data``, drawn by the
     reference from ``jax.random.key(4207)``):
     ``Bsts`` + ``LocalLinearTrend`` with the TIM marginal move, T=500,
     4096 chains, 300 burn-in + 250 draws, float32 (smoother in float64),
     through ``run_mcmc`` with the bench's 5-statistic monitor. It must run
     through K1, K2, J1 and J2, give finite draws, pass split R-hat < 1.02,
     reach half the reference's min-ESS, and land the variances' posterior
     medians within 10 % of the JAX reference's; it prints sweeps/s,
     min-ESS/s, the proposal build's wall time and each phase's share of a
     sweep;
  2c. kernel (a), the SSVS indicator sweep (``csrc/ssvs_sweep.cu``), against
     its plain version (``regression_sweep.draw_indicators_swept``) on the
     card with the same noise: p in {1, 31, 32, 33, 37, 50, 64}, 1, 33
     and 1024 chains, mode jump off and on, max_size unset and set,
     float64 (masks identical on every chain) and float32 (identical on
     at least 99.5 % of chains, every difference at a near-tie of the
     plain version, |log u - log threshold| < 1e-3 at the first flip where
     they part), several noise draws, and the bench's own model at 1024
     chains; ten launches at the bench's shape bit-identical; then its
     times beside the bound, without and with the mode jump
     (``boom_tpu_torch/kernels/ssvs_timing.py``);
  5. the reference's spike_slab workload (bench.py:129-157) on the bench's
     own data (``boom_tpu_torch/data``): ``SpikeSlabRegression`` with
     expected model size 10 and no mode jump, n=2000, p=50, 1024 chains, 50
     burn-in + 200 draws, float32, through ``run_mcmc`` with the bench's
     monitor (beta[:8], sigsq). It must run through kernel (a), give finite
     draws, pass split R-hat < 1.02, reach half the reference's min-ESS,
     land the monitored posterior medians within 1 % of the JAX reference's
     and include columns 0-7 with probability >= 0.99; it prints sweeps/s,
     min-ESS/s and each phase's share of a sweep.

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

# phase 2b: the sequential kernels and the XLA scans of the reference they
# replace (kalman.py's lax.scan of kalman_loglik; the fused smoother's
# forward scan, with _smoother_passes' two scans at :322 and :349; J1 and
# J2, the loglik's derivatives, replace jax.value_and_grad of that scan in
# numopt.bfgs and jax.hessian in numopt.newton_raphson and bsts.py:661)
KALMAN_SOURCE = "boom_tpu_torch/csrc/kalman_seq.cu"
KALMAN_KERNELS = {"loglik": ("kalman_loglik",
                             "boom_tpu/statespace/kalman.py:282"),
                  "loglik_grad": ("kalman_loglik_grad",
                                  "boom_tpu/numopt.py:43"),
                  "loglik_hess": ("kalman_loglik_hess",
                                  "boom_tpu/numopt.py:101"),
                  "smoother": ("kalman_simulation_smoother",
                               "boom_tpu/statespace/kalman.py:476")}
# K2 stages 32 steps at a time (kalman_kernel.SMOOTHER_CHUNK): one below,
# at and one above a chunk, a ragged last chunk, the bsts_llt T and 4096;
# masked at MASKED_T; chain counts that leave the last warp partly empty
KALMAN_T_CHECK = (2, 31, 32, 33, 67, 500, 4096)
KALMAN_MASKED_T = (33, 67, 500)
KALMAN_CHAIN_CHECK = (33, 4095)
# derivative check: normwise relative error of J1's and J2's gradient and
# Hessian against autograd of the plain loop (float64)
DERIV_TOL = 1e-9

# phase 4: the reference's bsts_llt workload (bench.py:170-200)
LLT_T, LLT_CHAINS, LLT_BURN, LLT_DRAWS, LLT_SEED = 500, 4096, 300, 250, 0
RHAT_GATE = 1.02  # bench.py:111
# min-ESS of the reference's run at this configuration (BENCH_r05.json,
# 4096 chains x 250 draws); the port must reach half of it
REFERENCE_MIN_ESS_LLT = 642_116
# Posterior medians of the JAX reference (boom_tpu's Bsts, the same model,
# parallel_smoother "auto", float64 on the CPU) on the bench's series
# (boom_tpu_torch.data.bsts_llt_series): 64 chains, 500 sweeps of burn-in,
# 2000 draws, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_tim.py bench \
#         64 500 2000 2026
REFERENCE_MEDIANS_LLT = {"sigsq_obs": 0.2824546700855368,
                         "sigma_level_sq": 0.07093161360753383,
                         "sigma_slope_sq": 0.00027548090601574034}
LLT_MEDIAN_TOL = 0.10

# phase 2c: kernel (a), the SSVS indicator sweep, and the XLA scans of the
# reference it replaces (regression_sweep.py: build_sweep_state :84, the
# mode-jump walk :178, the flip scan of draw_indicators_swept :241)
SSVS_SOURCE = "boom_tpu_torch/csrc/ssvs_sweep.cu"
SSVS_REPLACES = "boom_tpu/models/glm/regression_sweep.py:241"
# 31, 32, 33: the edges of warp 0's 32 decisions a round and of a warp's
# row of the rank-1 update
SSVS_P = (1, 31, 32, 33, 37, 50, 64)
SSVS_CHAINS = (1, 33, 1024)
SSVS_MAX_SIZE = 3
SSVS_DRAWS = 2
# float32: share of chains whose masks must equal the plain version's, and
# the margin |log u - log threshold| of the plain version's decision below
# which a difference counts as a near-tie
SSVS_F32_AGREE = 0.995
SSVS_TIE = 1e-3

# phase 5: the reference's spike_slab workload (bench.py:129-157)
SPIKE_N, SPIKE_P, SPIKE_NONZERO = 2000, 50, 8
SPIKE_CHAINS, SPIKE_BURN, SPIKE_DRAWS, SPIKE_SEED = 1024, 50, 200, 0
# min-ESS of the reference's run at this configuration (BENCH_r05.json,
# 1024 chains x 200 draws); the port must reach half of it
REFERENCE_MIN_ESS_SPIKE = 203_091
# Posterior medians of beta[:8] and sigsq from the JAX reference's
# workload on the committed data (x64 off, as the bench runs): 64 chains,
# 50 burn-in + 200 draws, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_spike_slab.py \
#         bench
# (the reference's inclusion probabilities of columns 0-7 are 1.0)
REFERENCE_MEDIANS_SPIKE = (
    -1.9911940097808838, 1.974985122680664, -2.011040210723877,
    2.014585018157959, -2.0018205642700195, -1.9634230136871338,
    -2.0008912086486816, 1.9793345928192139, 1.011297345161438)
SPIKE_MEDIAN_TOL = 0.01
SPIKE_MIN_INCLUSION = 0.99


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
    libs = _build.build()
    secs = time.perf_counter() - t0
    print(f"build: {secs:.1f} s (" + ", ".join(p.name for p in libs.values())
          + ")")
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
    gen = rng.generator(3, "cpu")
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


def _kalman_vs_plain(rng, dtype, c, d, t_len, masked):
    """K1 (and K2 in float64) and the plain versions on the same inputs:
    {kernel: (normwise relative error, max abs error)}."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    tag = str(dtype).split(".")[-1]
    params = kt.system(rng, c, d, tag)
    y = torch.tensor(rng.normal(size=t_len).cumsum(), dtype=dtype,
                     device="cuda")
    obs = (torch.tensor(rng.uniform(size=t_len) > 0.2, device="cuda")
           if masked else None)
    out = {}
    ll_k, ll = kk.kalman_loglik(params, y, obs), kalman.kalman_loglik(
        params, y, obs)
    out["loglik"] = (_rel(ll_k, ll), float((ll_k - ll).abs().max()))
    if dtype == torch.float64:
        normals = [torch.tensor(rng.normal(size=s), dtype=dtype,
                                device="cuda")
                   for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
        a_k = kk.simulation_smoother(params, y, *normals, observed=obs)
        a = kalman.simulation_smoother(params, y, *normals, observed=obs)
        out["smoother"] = (_rel(a_k, a), float((a_k - a).abs().max()))
    torch.cuda.synchronize()
    return out


def _derivatives_vs_plain(rng):
    """J1 and J2 against autograd of the plain loop: directly, in the
    kernels' parameters at the mode search's shape (B=1, T=500, d=2,
    float64), masked and dense, and through ``torch.autograd`` in the log
    variances at d in {1, 2}, as the TIM mode search asks for them (a
    gradient launches J1, a Hessian J1 and J2). Returns ({check: normwise
    relative error}, {kernel: max abs error at the mode search's shape})."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    errs, max_abs = {}, {}
    for masked in (False, True):
        params = kt.system(rng, 1, 2, "float64")
        y = torch.tensor(rng.normal(size=LLT_T).cumsum(),
                         dtype=torch.float64, device="cuda")
        obs = (torch.tensor(rng.uniform(size=LLT_T) > 0.2, device="cuda")
               if masked else None)
        fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
                  params.a0, params.p0, y, obs)
        for order, kind in ((1, "loglik_grad"), (2, "loglik_hess")):
            got = kk.launch_loglik(*fields, order=order)
            want = kk.loglik_jets_plain(*fields, order=order)
            errs[f"{kind} masked={masked}"] = max(
                _rel(a, b) for a, b in zip(got, want))
            if not masked:
                max_abs[kind] = float((got[-1] - want[-1]).abs().max())
    for d in (1, 2):
        params = kt.system(rng, 1, d, "float64")
        y = torch.tensor(rng.normal(size=LLT_T).cumsum(),
                         dtype=torch.float64, device="cuda")

        def lp(fn, u, params=params, d=d, y=y):
            return fn(params._replace(q_mat=torch.diag_embed(
                torch.exp(u[:d]))[None], h=torch.exp(u[d:])), y)[0]

        u0 = torch.linspace(-1.0, 0.2, d + 1, dtype=torch.float64,
                            device="cuda")
        res = []
        for fn in (kk.kalman_loglik, kalman.kalman_loglik):
            before = dict(kk.LAUNCHES)
            u = u0.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(lp(fn, u), u)
            after_grad = dict(kk.LAUNCHES)
            hess = torch.autograd.functional.hessian(
                lambda x, fn=fn: lp(fn, x), u0)
            res.append((g, hess))
            if fn is kk.kalman_loglik:
                launched = [{k: b[k] - a[k] for k in kk.LOGLIK_KINDS}
                            for a, b in ((before, after_grad),
                                         (after_grad, kk.LAUNCHES))]
                check(launched == [
                    {"loglik": 0, "loglik_grad": 1, "loglik_hess": 0},
                    {"loglik": 0, "loglik_grad": 1, "loglik_hess": 1}],
                    f"a gradient and a Hessian launched {launched}, not "
                    "J1, then J1 and J2")
        errs[f"autograd gradient d={d}"] = _rel(res[0][0], res[1][0])
        errs[f"autograd Hessian d={d}"] = _rel(res[0][1], res[1][1])
    return errs, max_abs


def phase2b_kalman_vs_plain():
    """K1 and K2 against their plain versions over KALMAN_T_CHECK and at
    the bsts_llt width; the derivative kernel; determinism; times. Returns
    the bsts_llt shape's numbers per kernel."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt

    rng = np.random.default_rng(20261017)
    bad, worst, at_llt = [], {}, {}
    dtypes = (torch.float64, torch.float32)
    cases = [(dt, d, t, 8, t in KALMAN_MASKED_T) for dt in dtypes
             for d in (1, 2, 3, 6) for t in KALMAN_T_CHECK]
    cases += [(dt, d, 67, c, masked) for dt in dtypes for d in (1, 2, 3, 6)
              for c in KALMAN_CHAIN_CHECK for masked in (False, True)]
    for dtype, d, t_len, c, masked in cases:
        res = _kalman_vs_plain(rng, dtype, c, d, t_len, masked)
        tag = str(dtype).split(".")[-1]
        print(f"kalman {tag} d={d} T={t_len} C={c} masked={masked}: "
              + ", ".join(f"{k} rel {v:.2e} abs {a:.2e}"
                          for k, (v, a) in res.items()))
        for k, (v, _a) in res.items():
            worst[(k, tag)] = max(worst.get((k, tag), 0.0), v)
            if not (np.isfinite(v) and v <= SCAN_TOL[tag]):
                bad.append(f"{k} {tag} d={d} T={t_len} C={c}: {v:.3e}")
    # the main path's widths: K1 over every chain's TIM points, K2 over
    # every chain
    for name, (tag, batch, d, t_len) in kt.SHAPES.items():
        if name not in ("loglik", "smoother"):
            continue
        res = _kalman_vs_plain(rng, getattr(torch, tag), batch, d, t_len,
                               False)[name]
        print(f"kalman {name} {tag} B={batch} d={d} T={t_len} (bsts_llt): "
              f"rel {res[0]:.2e} abs {res[1]:.2e}")
        at_llt[name] = {"max_abs_err": res[1]}
        worst[(name, tag)] = max(worst.get((name, tag), 0.0), res[0])
        if not (np.isfinite(res[0]) and res[0] <= SCAN_TOL[tag]):
            bad.append(f"{name} {tag} at the bsts_llt width: {res[0]:.3e}")
    for (k, tag), v in sorted(worst.items()):
        print(f"worst {k} {tag}: {v:.3e} (tolerance {SCAN_TOL[tag]:g})")
    check(not bad, "kalman kernel disagrees with its plain version: "
          + "; ".join(bad))

    errs, max_abs = _derivatives_vs_plain(rng)
    print(f"J1, J2 vs autograd of the plain loop (B=1, T={LLT_T}, f64): "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
          + f" (tolerance {DERIV_TOL:g})")
    bad = [f"{k}: {v:.3e}" for k, v in errs.items()
           if not (np.isfinite(v) and v <= DERIV_TOL)]
    check(not bad, "loglik derivatives disagree: " + "; ".join(bad))
    for kind, err in max_abs.items():
        at_llt[kind] = {"max_abs_err": err}

    same = {}
    for name, (tag, batch, d, t_len) in kt.SHAPES.items():
        kern = kt.kalman_cases(rng, name, tag, batch, d, t_len)[0]
        first = kern()
        first = first if isinstance(first, tuple) else (first,)
        same[name] = True
        for _ in range(9):
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            same[name] &= all(torch.equal(a, b)
                              for a, b in zip(first, again))
    torch.cuda.synchronize()
    print("ten repeated launches at the bsts_llt shapes bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"repeated launches differ: {same}")

    for name, r in kt.time_kalman(rng).items():
        plain = (f"{r['plain_ms']:.4f} ms" if r["plain_ms"] is not None
                 else "not timed")
        bound = f"bound {r['bound_ms']:.6f} ms ({r['bound_by']}), "
        blocks = ", ".join(f"{t} threads {ms:.4f} ms"
                           for t, ms in r.get("block_ms", {}).items())
        blocks += "".join(f"; at B={b} {ms:.4f} ms"
                          for b, ms in r.get("scaling_ms", {}).items())
        wrap = (f"whole wrapper {r['wrapper_ms']:.4f} ms, "
                if r["wrapper_ms"] is not None else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"{wrap}plain {plain}, {bound}one call on the host clock "
              f"{r['call_ms']:.4f} ms" + (f"; blocks: {blocks}"
                                          if blocks else ""))
        if name in at_llt:
            at_llt[name].update({k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")})
    from boom_tpu_torch.kernels import _build

    log = _build.log_path("kalman_seq")
    if log.exists():
        for inst, rep in kt.nvcc_report(log.read_text()).items():
            print(f"nvcc {inst}: {rep['registers']} registers, "
                  f"{rep['spill_bytes']} bytes spill stores, "
                  f"{rep['stack_bytes']} bytes stack")
    return at_llt


def _llt_extract(state):
    """The bench's monitor (bench.py:189-194): the three variances, the
    level at T/2 and the one-step forecast mean."""
    alpha = state["alpha"]
    trend = state["blocks"]["trend"]
    return {"so": state["sigsq_obs"], "lvl": trend["sigma_level_sq"],
            "slp": trend["sigma_slope_sq"], "mid": alpha[:, LLT_T // 2, 0],
            "fcast": alpha[:, -1, 0] + alpha[:, -1, 1]}


def _phase_profile(model, state, gen, chains, prefix, phase_names,
                   sweeps=5, top=0):
    """Host time of each sweep phase (its profiler range
    "<prefix>.<phase>") and the device's kernel time over a few sweeps
    under ``torch.profiler``: ({phase: ms a sweep}, wall ms a sweep, device
    kernel ms a sweep). With ``top``, prints the operators with the most
    host time of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    kern = model.kernel()
    noises = [model.draw_noise(gen, chains) for _ in range(sweeps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for noise in noises:
            state = kern(noise, state)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / sweeps
    events = prof.key_averages()
    if top:
        ops = sorted((e for e in events if not e.key.startswith(f"{prefix}.")),
                     key=lambda e: e.self_cpu_time_total, reverse=True)[:top]
        print(f"{prefix} operators with the most host time of their own: "
              + ", ".join(f"{e.key} {e.self_cpu_time_total / sweeps / 1e3:.2f}"
                          f" ms ({e.count // sweeps} calls)" for e in ops)
              + " a sweep")
    phases = {}
    for name in phase_names:
        hits = [e for e in events if e.key == f"{prefix}.{name}"]
        phases[name] = (sum(e.cpu_time_total for e in hits) / sweeps / 1e3
                        if hits else 0.0)
    # kernels only: the named ranges also appear as device-side
    # annotations spanning their kernels
    device = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                 if str(e.device_type).endswith("CUDA")
                 and not e.key.startswith(f"{prefix}.")) / sweeps / 1e3
    return phases, wall, device


def _print_profile(label, phases, wall, device):
    total = sum(phases.values()) or 1.0
    print(f"{label} sweep profile (5 sweeps under torch.profiler): wall "
          f"{wall:.2f} ms a sweep, device kernels {device:.2f} ms "
          f"(busy {100 * device / wall:.1f} %); host time of each phase: "
          + ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f} %)"
                      for k, v in phases.items()))


def phase4_bsts_llt(card):
    """The reference's bsts_llt workload at full width through Bsts and
    run_mcmc; returns the kernels' launch counts of that run."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import LocalLinearTrend

    y = torch.tensor(data.bsts_llt_series(), device="cuda")
    check(y.shape == (LLT_T,) and y.dtype == torch.float32,
          f"the bench series is {tuple(y.shape)} {y.dtype}")
    for counts in (kk.LAUNCHES, sk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y)],
                 marginal_sigma_slice=True, marginal_move="tim")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mode, chol = model._tim_prop
    print(f"bsts_llt TIM proposal built in {build_s:.2f} s "
          f"({kk.LAUNCHES['loglik']} K1, {kk.LAUNCHES['loglik_grad']} J1, "
          f"{kk.LAUNCHES['loglik_hess']} J2 launches): mode "
          f"{mode.tolist()}, chol diagonal {chol.diag().tolist()}")
    check(model._smoother() is kk.simulation_smoother,
          "the bsts_llt model did not pick the sequential CUDA smoother")
    gen = prng.generator(LLT_SEED, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   LLT_DRAWS, generator=gen, num_chains=LLT_CHAINS,
                   burn=LLT_BURN, extract=_llt_extract)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = {**{f"kalman_{k}": v for k, v in kk.LAUNCHES.items()},
                **{f"scan_{k}": v for k, v in sk.LAUNCHES.items()}}
    sweeps = LLT_BURN + LLT_DRAWS
    print(f"bsts_llt: T={LLT_T} chains={LLT_CHAINS} burn={LLT_BURN} "
          f"draws={LLT_DRAWS} in {elapsed:.2f} s; launches {launches}")
    check(kk.LAUNCHES["loglik"] >= sweeps and kk.LAUNCHES["smoother"]
          >= sweeps and kk.LAUNCHES["loglik_grad"] >= 1
          and kk.LAUNCHES["loglik_hess"] >= 1
          and sk.LAUNCHES["affine"] >= sweeps,
          f"the bsts_llt run did not go through the kernels: {launches}")

    d = res.draws
    check(all(bool(torch.isfinite(v).all()) for v in d.values()),
          "non-finite bsts_llt draws")
    monitored = torch.stack([d["so"], torch.sqrt(d["lvl"]),
                             torch.sqrt(d["slp"]), d["mid"], d["fcast"]],
                            dim=-1).double()
    rhat = diagnostics.potential_scale_reduction(monitored).cpu().numpy()
    ess = diagnostics.effective_sample_size(monitored).cpu().numpy()
    names = ("sigsq_obs", "sqrt sigma_level_sq", "sqrt sigma_slope_sq",
             "level at T/2", "forecast")
    for i, name in enumerate(names):
        print(f"bsts_llt {name}: rhat {rhat[i]:.4f} ess {ess[i]:.1f}")
    min_ess = float(ess.min())
    ratio = min_ess / REFERENCE_MIN_ESS_LLT
    print(f"bsts_llt rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, "
          f"min-ESS {min_ess:.1f} (ratio to the reference's "
          f"{REFERENCE_MIN_ESS_LLT}: {ratio:.4f}), min-ESS/s "
          f"{min_ess / elapsed:.1f}, max R-hat {float(rhat.max()):.4f}")
    med = {"sigsq_obs": d["so"], "sigma_level_sq": d["lvl"],
           "sigma_slope_sq": d["slp"]}
    med = {k: float(v.double().median()) for k, v in med.items()}
    for k, ref in REFERENCE_MEDIANS_LLT.items():
        print(f"bsts_llt {k}: median {med[k]:.6g} (reference {ref:.6g}, "
              f"ratio {med[k] / ref:.4f})")

    from boom_tpu_torch.statespace.bsts import SWEEP_PHASES

    _print_profile("bsts_llt", *_phase_profile(
        model, res.final_state, gen, LLT_CHAINS, "bsts", SWEEP_PHASES))

    check(float(rhat.max()) < RHAT_GATE,
          f"bsts_llt max R-hat {float(rhat.max()):.4f} >= {RHAT_GATE}")
    check(ratio >= 0.5, f"bsts_llt min-ESS {min_ess:.1f} is below half the "
          f"reference's {REFERENCE_MIN_ESS_LLT}")
    for k, ref in REFERENCE_MEDIANS_LLT.items():
        check(abs(med[k] / ref - 1.0) <= LLT_MEDIAN_TOL,
              f"bsts_llt median of {k} {med[k]:.4g} is not within "
              f"{LLT_MEDIAN_TOL:.0%} of the reference's {ref:.4g}")
    return launches


def _first_parting_margin(model, mask, noise, qprobs, want, got):
    """For chains whose kernel mask ``got`` differs from the plain one
    ``want``: the plain version's decision margin |log u - log threshold|
    at the first step (the jump, then each flip) after which the kernel's
    mask and the plain version's part, found by launching the kernel with
    0, 1, ... flips. Returns [margins]."""
    import torch

    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    idx = torch.nonzero((got != want).any(-1))[:, 0]
    sub = {k: v[idx] for k, v in noise.items()}
    record = []
    rs.draw_indicators_swept(sub, model.suf, model.prior, mask[idx],
                             qprobs=qprobs, record=record)
    jump = qprobs is not None
    margins = [None] * len(idx)
    for step in range(len(record)):
        n_flips = step if jump else step + 1
        k_mask = sk.launch_sweep(sub, model.suf, model.prior, mask[idx],
                                 n_flips, qprobs)
        parted = (k_mask != record[step][1]).any(-1)
        for i in torch.nonzero(parted)[:, 0].tolist():
            if margins[i] is None:
                margins[i] = float(record[step][0][i].abs())
    return [m if m is not None else float("inf") for m in margins]


def _ssvs_case(rng, dtype, c, p, jump, max_size):
    """One comparison of kernel (a) with the plain sweep: (chains differing,
    their near-tie margins)."""
    from boom_tpu_torch.kernels import ssvs_timing as sst
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    model, mask, noise, qprobs = sst.problem(
        rng, c, p, dtype, max_size=max_size, mode_jump=jump)
    want = rs.draw_indicators_swept(noise, model.suf, model.prior, mask,
                                    qprobs=qprobs)
    got = sk.draw_indicators_swept(noise, model.suf, model.prior, mask,
                                   qprobs=qprobs)
    diff = (got != want).any(-1)
    n_diff = int(diff.sum())
    margins = (_first_parting_margin(model, mask, noise, qprobs, want, got)
               if n_diff else [])
    return n_diff, margins


def phase2c_ssvs_vs_plain():
    """Kernel (a) against its plain version; determinism; times. Returns the
    bench shape's numbers."""
    import torch

    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.kernels import ssvs_timing as sst
    from boom_tpu_torch.models.glm import regression_sweep as rs

    rng = np.random.default_rng(20261018)
    bad, total, n_diff_f32, worst_margin = [], {}, 0, 0.0
    for dtype in ("float64", "float32"):
        for p in SSVS_P:
            for c in SSVS_CHAINS:
                for jump in (False, True):
                    for max_size in (None, SSVS_MAX_SIZE):
                        for _ in range(SSVS_DRAWS):
                            n_diff, margins = _ssvs_case(
                                rng, dtype, c, p, jump, max_size)
                            total[dtype] = total.get(dtype, 0) + c
                            case = (f"{dtype} p={p} C={c} jump={jump} "
                                    f"max_size={max_size}")
                            if dtype == "float64" and n_diff:
                                bad.append(f"{case}: {n_diff} chains differ")
                            if dtype == "float32":
                                n_diff_f32 += n_diff
                                for m in margins:
                                    worst_margin = max(worst_margin, m)
                                    if not m < SSVS_TIE:
                                        bad.append(f"{case}: a difference "
                                                   f"at margin {m:.3e}")
    # the bench's own model and masks, both dtypes
    at_bench = {}
    for dtype in ("float64", "float32"):
        model, mask, noise = sst.bench_problem(dtype)
        want = rs.draw_indicators_swept(noise, model.suf, model.prior, mask)
        kern = sst.ssvs_cases(model, mask, noise)[0]
        got = kern()
        n_diff = int((got != want).any(-1).sum())
        total[dtype] += mask.shape[0]
        err = float((got.float() - want.float()).abs().max())
        print(f"ssvs bench {dtype} C={mask.shape[0]} p={mask.shape[1]}: "
              f"{n_diff} chains differ from the plain version")
        if dtype == "float64" and n_diff:
            bad.append(f"bench float64: {n_diff} chains differ")
        if dtype == "float32":
            n_diff_f32 += n_diff
            if n_diff:
                for m in _first_parting_margin(model, mask, noise, None,
                                               want, got):
                    worst_margin = max(worst_margin, m)
                    if not m < SSVS_TIE:
                        bad.append(f"bench float32: a difference at margin "
                                   f"{m:.3e}")
            at_bench["max_abs_err"] = err
            same = all(torch.equal(got, kern()) for _ in range(9))
            print(f"ten launches of kernel (a) at the bench shape "
                  f"bit-identical: {same}")
            check(same, "repeated launches of kernel (a) differ")
    agree = 1.0 - n_diff_f32 / total["float32"]
    print(f"ssvs float64: {total['float64']} chains, all masks identical "
          f"unless listed below; float32: {n_diff_f32} of "
          f"{total['float32']} chains differ (agreement {agree:.5f}, gate "
          f">= {SSVS_F32_AGREE}), worst near-tie margin {worst_margin:.3e} "
          f"(gate < {SSVS_TIE:g})")
    check(not bad, "kernel (a) disagrees with its plain version: "
          + "; ".join(bad[:20]))
    check(agree >= SSVS_F32_AGREE,
          f"float32 masks agree on {agree:.4f} of chains")
    for name, r in sst.time_ssvs().items():
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, whole "
              f"wrapper {r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} "
              f"ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}; "
              f"{r['passes_mean']:.2f} rank-1 passes a chain needed; the "
              f"reference's gated work {r['gated_work_ms']:.5f} ms); one "
              f"call on the host clock {r['call_ms']:.4f} ms; blocks: "
              + ", ".join(f"{t} threads {ms:.4f} ms"
                          for t, ms in r["block_ms"].items()))
        if name == "ssvs_sweep_f32":
            at_bench.update({k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")})
    log = _build.log_path("ssvs_sweep")
    if log.exists():
        for inst, rep in sst.nvcc_report(log.read_text()).items():
            print(f"nvcc {inst}: {rep['registers']} registers, "
                  f"{rep['spill_bytes']} bytes spill stores, "
                  f"{rep['stack_bytes']} bytes stack")
    return at_bench


def phase5_spike_slab(card):
    """The reference's spike_slab workload at full size through
    SpikeSlabRegression and run_mcmc; returns kernel (a)'s launches in that
    run."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.models.glm import SpikeSlabRegression
    from boom_tpu_torch.models.glm import ssvs_kernel as sk
    from boom_tpu_torch.models.glm.regression import SWEEP_PHASES

    x, y = (torch.tensor(a, device="cuda") for a in data.spike_slab_xy())
    check(x.shape == (SPIKE_N, SPIKE_P) and x.dtype == torch.float32,
          f"the bench data are {tuple(x.shape)} {x.dtype}")
    model = SpikeSlabRegression.from_data(x, y, expected_model_size=10.0,
                                          mode_jump=False)
    check(model.method == "sweep", "the model does not take the SWEEP path")
    sk.LAUNCHES["ssvs_sweep"] = 0
    gen = prng.generator(SPIKE_SEED, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   SPIKE_DRAWS, generator=gen, num_chains=SPIKE_CHAINS,
                   burn=SPIKE_BURN,
                   extract=lambda s: {"beta": s["beta"][:, :SPIKE_NONZERO],
                                      "sigsq": s["sigsq"],
                                      "gamma": s["gamma"]})
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = sk.LAUNCHES["ssvs_sweep"]
    sweeps = SPIKE_BURN + SPIKE_DRAWS
    print(f"spike_slab: n={SPIKE_N} p={SPIKE_P} chains={SPIKE_CHAINS} "
          f"burn={SPIKE_BURN} draws={SPIKE_DRAWS} in {elapsed:.2f} s; kernel "
          f"(a) launches {launches}")
    check(launches >= sweeps,
          f"the spike_slab run launched kernel (a) {launches} times < "
          f"{sweeps} sweeps")
    d = res.draws
    check(all(bool(torch.isfinite(v.float()).all()) for v in d.values()),
          "non-finite spike_slab draws")
    monitored = torch.cat([d["beta"], d["sigsq"][..., None]],
                          dim=-1).double()
    check(tuple(monitored.shape) == (SPIKE_CHAINS, SPIKE_DRAWS,
                                     SPIKE_NONZERO + 1),
          f"monitored draws have shape {tuple(monitored.shape)}")
    rhat = diagnostics.potential_scale_reduction(monitored).cpu().numpy()
    ess = diagnostics.effective_sample_size(monitored).cpu().numpy()
    med = monitored.reshape(-1, SPIKE_NONZERO + 1).median(0).values
    med = med.cpu().numpy()
    inclusion = d["gamma"].double().mean((0, 1)).cpu().numpy()
    names = [f"beta[{j}]" for j in range(SPIKE_NONZERO)] + ["sigsq"]
    for i, name in enumerate(names):
        print(f"spike_slab {name}: median {med[i]:.6g} (reference "
              f"{REFERENCE_MEDIANS_SPIKE[i]:.6g}, ratio "
              f"{med[i] / REFERENCE_MEDIANS_SPIKE[i]:.5f}) rhat "
              f"{rhat[i]:.4f} ess {ess[i]:.1f}")
    print("spike_slab inclusion probabilities: "
          + ", ".join(f"{v:.4f}" for v in inclusion))
    min_ess = float(ess.min())
    ratio = min_ess / REFERENCE_MIN_ESS_SPIKE
    print(f"spike_slab rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, "
          f"min-ESS {min_ess:.1f} (ratio to the reference's "
          f"{REFERENCE_MIN_ESS_SPIKE}: {ratio:.4f}), min-ESS/s "
          f"{min_ess / elapsed:.1f}, max R-hat {float(rhat.max()):.4f}")
    _print_profile("spike_slab", *_phase_profile(
        model, res.final_state, gen, SPIKE_CHAINS, "ssvs", SWEEP_PHASES, top=8))

    check(float(rhat.max()) < RHAT_GATE,
          f"spike_slab max R-hat {float(rhat.max()):.4f} >= {RHAT_GATE}")
    check(ratio >= 0.5, f"spike_slab min-ESS {min_ess:.1f} is below half the "
          f"reference's {REFERENCE_MIN_ESS_SPIKE}")
    for i, name in enumerate(names):
        ref = REFERENCE_MEDIANS_SPIKE[i]
        check(abs(med[i] / ref - 1.0) <= SPIKE_MEDIAN_TOL,
              f"spike_slab median of {name} {med[i]:.5g} is not within "
              f"{SPIKE_MEDIAN_TOL:.0%} of the reference's {ref:.5g}")
    check(bool((inclusion[:SPIKE_NONZERO] >= SPIKE_MIN_INCLUSION).all()),
          f"inclusion probabilities of columns 0-{SPIKE_NONZERO - 1} "
          f"{inclusion[:SPIKE_NONZERO].tolist()} below "
          f"{SPIKE_MIN_INCLUSION}")
    return launches


def main():
    card = phase0_environment()
    import torch

    try:
        phase1_build()
        at_fit = phase2_kernels_vs_plain()
        at_llt = phase2b_kalman_vs_plain()
        phase3_sweep_vs_plain()
        launches = phase3_fit(card)
        llt_launches = phase4_bsts_llt(card)
        at_ssvs = phase2c_ssvs_vs_plain()
        ssvs_launches = phase5_spike_slab(card)
    except SmokeFailure as exc:
        print(f"chip_smoke FAILED: {exc}", file=sys.stderr)
        return 1
    # library_ms: no single PyTorch call computes a prefix scan whose
    # combine is a non-commutative matrix operation, nor a Kalman recursion
    kernels = [{"name": f"parallel_scan_{k}", "route": "cuda",
                "source": KERNEL_SOURCE, "replaces": REPLACES[k],
                "launches": launches[k], **at_fit[k], "library_ms": None}
               for k in launches]
    for k, (name, replaces) in KALMAN_KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": KALMAN_SOURCE, "replaces": replaces,
                        "launches": llt_launches[f"kalman_{k}"],
                        **at_llt[k], "library_ms": None})
    # library_ms: no PyTorch call computes a Gibbs sweep over indicators
    kernels.append({"name": "ssvs_sweep", "route": "cuda",
                    "source": SSVS_SOURCE, "replaces": SSVS_REPLACES,
                    "launches": ssvs_launches, **at_ssvs,
                    "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
