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
     card), which must run through the scans (its smoother) and K3 (its
     ASIS D-paths), give finite draws, and
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
     through K1, K2, J1, J2 and K3 (the ASIS D-paths), give finite draws,
     pass split R-hat < 1.02, reach half the reference's min-ESS, and land the variances' posterior
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
     min-ESS/s and each phase's share of a sweep;
  2d. the kernels of the bsts_reg path against their plain versions on the
     card: K2w (the simulation smoother for 7 <= d <= 16,
     ``csrc/kalman_wide.cu``) at d in {7, 8, 9, 13, 16}, T in {31, 32, 33,
     500}, 33, 4095 and 4097 chains (<= 1e-9), K3 (the ASIS D-path of
     every d) at d in {1, 2, 3, 7, 8, 13, 16}, G in {1, 2, 3}, 33, 4096
     and 4097 chains, T=500, and at the fit's D-paths (8 chains, d=2, G=2,
     T=4096) (float64 <= 1e-9, float32 <= 1e-4), and
     kernel (a)'s per-chain entry (a border of S0 a chain) at p in {20, 33,
     50}, 33 and 4096 chains (float64 masks identical, float32 >= 99.5 %
     identical with near-ties only); ten launches of each at the bsts_reg
     shapes bit-identical; their times beside bounds and plain times
     (``kalman_timing.py``, ``ssvs_timing.py``), registers and spills;
  6. the bsts_reg configuration (BASELINE config #5, the README's quick
     start) at full width on the committed data (``boom_tpu_torch/data/
     bsts_reg.npz``): first the front end on its default device (the card)
     through ``BstsModel().add_local_linear_trend().add_seasonal(7)
     .fit(y, predictors=x)`` and every method of the fit, briefly; one
     float64 sweep of 33 chains on the card against the CPU's on the same
     noise; then ``Bsts`` with a local linear trend, a 7-season cycle
     (d = 8) and a spike-and-slab regression of p = 20, T = 500, 4096
     chains, 300 burn-in + 250 draws, float32 (smoother in float64),
     through ``run_mcmc`` and ``BstsModel.predict(horizon=30,
     future_predictors=x[500:])`` from 200 draws. It must run through K2w,
     K3 and kernel (a)'s per-chain entry, give finite draws, pass split
     R-hat < 1.02 on beta[0:4] and, on the four variances, R-hat - 1 at
     most 1.10 times the reference's own at the same run length
     (REFERENCE_RHAT_REG) + 0.01, reach half
     the reference's min-ESS per draw, land the variances' medians within
     10 % and beta[0:4]'s within 2 % of the reference's, include columns
     0-3 with probability >= 0.99, and forecast within half the reference's
     forecast sd of its median at each of the 30 steps; it prints
     sweeps/s, min-ESS/s, each phase's share of a sweep and the device's
     busy share.

    python3 chip_smoke.py --gate-check

builds the kernels and runs only phase 6's main run: sound from two more
seeds, then with each of ``REG_FAULTS`` planted in memory (the ASIS pass
skipped, a wrong seasonal T, the level variance frozen, kernel (a) given
one chain's statistics for all), and prints each run's readings and the
gates it fails: what phase 6's gates can see.

Prints a JSON line of per-kernel results and, last, the device line
``{"ok": true, "device": {...}}``. Exits nonzero (and prints no result)
when CUDA is unavailable, when the port's package is missing beside this
script, or when any check fails.
"""

from __future__ import annotations

import contextlib
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


# phase 2d: K2w, K3 and kernel (a)'s per-chain entry, the reference's XLA
# scans they replace (K2w: the fused smoother's scan and _smoother_passes'
# two at d > 6; K3: asis_redraw's D-path lax.scan; kernel (a)'s per-chain
# entry: the SWEEP path of bsts' regression draw under vmap)
WIDE_SOURCE = "boom_tpu_torch/csrc/kalman_wide.cu"
WIDE_KERNELS = {"smoother_wide": ("kalman_simulation_smoother_wide",
                                  "boom_tpu/statespace/kalman.py:476"),
                "dpath": ("asis_dpath", "boom_tpu/statespace/bsts.py:1082")}
# K2w: d 7, 8 (four chains a warp), 9, 13, 16 (two); T about the chunk
# edges; 33 chains (a partial block), 4095 and 4097 (a ragged last pack).
# K3: d 1, 2, 3 (32, 16 and 8 series a warp) to 16 at T = LLT_T; 33
# chains and 4096, 4097 (the short chunks of a full card); and the fit's
# D-paths (phase 3: 8 chains x 2 groups, d = 2, T = T_FIT, many long
# chunks a series)
WIDE_D_CHECK = (7, 8, 9, 13, 16)
WIDE_T_CHECK = (31, 32, 33, 500)
WIDE_CHAIN_CHECK = (33, 4095, 4097)
DPATH_D_CHECK = (1, 2, 3, 7, 8, 13, 16)
DPATH_G_CHECK = (1, 2, 3)
DPATH_CHAIN_CHECK = (33, 4096, 4097)
DPATH_FIT_CASE = (CHAINS, 2, 2, T_FIT)  # chains, d, groups, T
BORDER_P_CHECK = (20, 33, 50)
BORDER_CHAIN_CHECK = (33, 4096)

# phase 6: bsts_reg, BASELINE config #5 (BASELINE.md:32; README.md:40-44)
REG_T, REG_P, REG_HORIZON = 500, 20, 30
REG_CHAINS, REG_BURN, REG_DRAWS, REG_SEED = 4096, 300, 250, 0
REG_FORECAST_DRAWS = 200
REG_SWEEP_CHAINS = 33
REG_MONITOR = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq",
               "sigma_seasonal_sq", "beta[0]", "beta[1]", "beta[2]",
               "beta[3]")
# The JAX reference's run on the committed data (x64 off, as the bench
# runs): 64 chains, 500 burn-in + 2000 draws, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_reg.py \
#         bench 64 500 2000 2026
REFERENCE_MEDIANS_REG = {
    "sigsq_obs": 0.3552930951118469, "sigma_level_sq": 0.0056000081822276115,
    "sigma_slope_sq": 0.0001308427017647773,
    "sigma_seasonal_sq": 0.0019495957531034946,
    "beta[0]": 3.0178589820861816, "beta[1]": -2.0128607749938965,
    "beta[2]": 1.4407904148101807, "beta[3]": 0.9968891143798828}
REFERENCE_MIN_ESS_PER_DRAW_REG = 0.006821736849527832
REFERENCE_FORECAST_MEDIAN_REG = (
    -62.5980339050293, -58.61228942871094, -60.14018249511719,
    -60.13082504272461, -67.90896606445312, -58.72581481933594,
    -66.874755859375, -65.05384063720703, -63.49400329589844,
    -61.678993225097656, -68.87454223632812, -64.82650756835938,
    -64.33843231201172, -63.99015808105469, -73.91768646240234,
    -67.31756591796875, -66.91307067871094, -61.61737060546875,
    -73.06929016113281, -65.45597839355469, -68.3524169921875,
    -69.45564270019531, -58.59198760986328, -71.50546264648438,
    -70.0760726928711, -73.66845703125, -74.600341796875, -73.59306335449219,
    -76.43486785888672, -67.3539810180664)
REFERENCE_FORECAST_SD_REG = (
    0.6791679263114929, 0.713959276676178, 0.6960288882255554,
    0.8467196822166443, 0.7776634693145752, 0.7945913076400757,
    0.8424422740936279, 0.9043722152709961, 0.9787407517433167,
    0.9796078205108643, 0.9466345310211182, 0.9433966279029846,
    1.0416755676269531, 1.0465636253356934, 1.0396223068237305,
    1.1606380939483643, 1.2282204627990723, 1.1850286722183228,
    1.3270279169082642, 1.4231960773468018, 1.4499027729034424,
    1.4140335321426392, 1.5332988500595093, 1.649139404296875,
    1.6279475688934326, 1.7510836124420166, 1.823449969291687,
    1.8342525959014893, 1.8131062984466553, 1.9720864295959473)
# Split R-hat of the reference at this run length (300 burn-in + 250
# draws, 1024 chains, x64 off), REG_MONITOR's order, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_reg.py \
#         bench 1024 300 250 7
# The level and slope variances mix slowly in the reference's own sampler
# (ESS per draw ~0.007-0.008): their R-hat at 250 draws is far above 1.02,
# so the port's gate on the variances is the reference's own R-hat here
REFERENCE_RHAT_REG = (1.033916377831742, 1.4894978317194372,
                      1.4379444480299992, 1.0702209304820018,
                      1.0019848446602277, 1.0019373305918495,
                      1.0016245705207818, 1.0018420056521857)
# the port's R-hat - 1 at most REG_RHAT_FACTOR times the reference's, plus
# REG_RHAT_SLACK (both estimates carry the noise of a finite run). Sound
# runs from seeds 0, 1 and 2 read at most 1.0348 / 1.5147 / 1.4474 /
# 1.0716 against these limits of 1.0473 / 1.5484 / 1.4917 / 1.0872;
# ``--gate-check`` reads 1.7526 on the level variance with the ASIS pass
# skipped
REG_RHAT_FACTOR, REG_RHAT_SLACK = 1.10, 0.01
REG_VARIANCE_TOL, REG_BETA_TOL = 0.10, 0.02
REG_MIN_INCLUSION = 0.99
REG_FORECAST_SDS = 0.5
# ``--gate-check``: phase 6's main run, sound from REG_SEED + each of
# GATE_CHECK_SEEDS, and from REG_SEED with each fault planted in memory
GATE_CHECK_SEEDS = (1, 2)
REG_FAULTS = {
    "asis_off": "the ASIS pass skipped",
    "seasonal_t": "the seasonal's T leaves the oldest effect out of the sum",
    "level_frozen": "the level variance never redrawn, by Gibbs or by ASIS",
    "shared_border": "kernel (a) reads chain 0's border of S0 for every "
                     "chain"}


# the keys of every row of the kernels line
KERNEL_KEYS = {"name", "route", "source", "replaces", "launches",
               "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
               "library_ms"}


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
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk

    y = _llt_series(T_FIT)
    for k in sk.LAUNCHES:
        sk.LAUNCHES[k] = 0
    for k in kk.LAUNCHES:
        kk.LAUNCHES[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = BstsModel().add_local_linear_trend().fit(
        y, niter=NITER, burn=BURN, num_chains=CHAINS)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    print(f"fit: T={T_FIT} chains={CHAINS} burn={BURN} niter={NITER} "
          f"in {elapsed:.2f} s; kernel launches {launches}, K3 (the ASIS "
          f"D-paths) {kk.LAUNCHES['dpath']}")
    check(model._model.y.device.type == "cuda"
          and model._model.y.dtype == torch.float32,
          f"the fit ran on {model._model.y.device} in {model._model.y.dtype},"
          " not on the card in float32")
    check(model._model._smoother() is sk.simulation_smoother,
          "'auto' did not pick the CUDA scan smoother")
    for k, n in launches.items():
        check(n >= BURN + NITER,
              f"{k} scan launched {n} times < {BURN + NITER} sweeps")
    check(kk.LAUNCHES["dpath"] >= BURN + NITER,
          f"K3 launched {kk.LAUNCHES['dpath']} times < {BURN + NITER} sweeps")

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
    # kernels only: the named ranges (a bsts sweep's regression holds the
    # "ssvs." ones) also appear as device-side annotations spanning their
    # kernels
    device = sum(getattr(e, "self_device_time_total", 0.0) for e in events
                 if str(e.device_type).endswith("CUDA")
                 and not e.key.startswith(("bsts.", "ssvs."))) / sweeps / 1e3
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
          and kk.LAUNCHES["dpath"] >= sweeps,
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


def _first_parting_margin(suf, prior, mask, noise, qprobs, want, got):
    """For chains whose kernel mask ``got`` differs from the plain one
    ``want``: the plain version's decision margin |log u - log threshold|
    at the first step (the jump, then each flip) after which the kernel's
    mask and the plain version's part, found by launching the kernel with
    0, 1, ... flips, on the statistics ``suf`` (one response, or one a
    chain: kernel (a)'s per-chain entry). Returns [margins]."""
    import torch

    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    idx = torch.nonzero((got != want).any(-1))[:, 0]
    sub = {k: v[idx] for k, v in noise.items()}
    if suf.xty.dim() == 2:
        suf = suf._replace(xty=suf.xty[idx], yty=suf.yty[idx])
    record = []
    rs.draw_indicators_swept(sub, suf, prior, mask[idx], qprobs=qprobs,
                             record=record)
    jump = qprobs is not None
    margins = [None] * len(idx)
    for step in range(len(record)):
        n_flips = step if jump else step + 1
        k_mask = sk.launch_sweep(sub, suf, prior, mask[idx], n_flips, qprobs)
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
    margins = (_first_parting_margin(model.suf, model.prior, mask, noise,
                                     qprobs, want, got)
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
                for m in _first_parting_margin(model.suf, model.prior, mask,
                                               noise, None, want, got):
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


def _wide_vs_plain(rng, c, d, t_len, masked, per_chain):
    """K2w and the plain smoother on the same inputs: (normwise relative
    error, max abs error)."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    f64 = torch.float64
    params = kt.system(rng, c, d, "float64")
    shape = (c, t_len) if per_chain else (t_len,)
    y = torch.tensor(rng.normal(size=shape).cumsum(-1), dtype=f64,
                     device="cuda")
    obs = (torch.tensor(rng.uniform(size=t_len) > 0.2, device="cuda")
           if masked else None)
    normals = [torch.tensor(rng.normal(size=s), dtype=f64, device="cuda")
               for s in ((c, d), (c, t_len - 1, d), (c, t_len))]
    got = kk.simulation_smoother(params, y, *normals, observed=obs)
    want = kalman.simulation_smoother(params, y, *normals, observed=obs)
    torch.cuda.synchronize()
    return _rel(got, want), float((got - want).abs().max())


def _dpath_vs_plain(rng, c, d, groups, t_len, dtype):
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    t_mat = kt.system(rng, c, d, dtype).t_mat.contiguous()
    w = torch.tensor(rng.normal(size=(c, groups, t_len - 1, d)),
                     dtype=getattr(torch, dtype), device="cuda")
    got, want = kk.dpath(t_mat, w), kalman.dpath(t_mat, w)
    torch.cuda.synchronize()
    return _rel(got, want), float((got - want).abs().max())


def _border_case(rng, dtype, c, p):
    """Kernel (a)'s per-chain entry against the plain sweep: (chains
    differing, their near-tie margins)."""
    from boom_tpu_torch.kernels import ssvs_timing as sst
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm import ssvs_kernel as sk

    suf, prior, mask, noise = sst.problem_per_chain(rng, c, p, dtype)
    want = rs.draw_indicators_swept(noise, suf, prior, mask)
    got = sk.draw_indicators_swept(noise, suf, prior, mask)
    n_diff = int((got != want).any(-1).sum())
    margins = (_first_parting_margin(suf, prior, mask, noise, None, want, got)
               if n_diff else [])
    return n_diff, margins


def phase2d_wide_vs_plain():
    """K2w, K3 and kernel (a)'s per-chain entry against their plain
    versions; determinism; times. Returns the bsts_reg shapes' numbers."""
    import torch

    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.kernels import ssvs_timing as sst

    rng = np.random.default_rng(20261019)
    bad, worst = [], {}
    for d in WIDE_D_CHECK:
        for t_len in WIDE_T_CHECK:
            for c in WIDE_CHAIN_CHECK:
                # one series or a series a chain (phase 6's route, y = 0
                # with eps - y_c) at both chain counts and at T = 500
                masked = t_len in (33, 500)
                per_chain = c == 33 or t_len in (32, 500)
                rel, err = _wide_vs_plain(rng, c, d, t_len, masked,
                                          per_chain)
                print(f"smoother_wide d={d} T={t_len} C={c} masked={masked} "
                      f"per_chain={per_chain}: rel {rel:.2e} abs {err:.2e}")
                worst["smoother_wide"] = max(worst.get("smoother_wide", 0.0),
                                             rel)
                if not (np.isfinite(rel) and rel <= SCAN_TOL["float64"]):
                    bad.append(f"smoother_wide d={d} T={t_len} C={c}: "
                               f"{rel:.3e}")
    for dtype in ("float64", "float32"):
        for d in DPATH_D_CHECK:
            for g in DPATH_G_CHECK:
                for c in DPATH_CHAIN_CHECK:
                    rel, err = _dpath_vs_plain(rng, c, d, g, LLT_T, dtype)
                    key = f"dpath {dtype}"
                    worst[key] = max(worst.get(key, 0.0), rel)
                    if not (np.isfinite(rel) and rel <= SCAN_TOL[dtype]):
                        bad.append(f"dpath {dtype} d={d} G={g} C={c}: "
                                   f"{rel:.3e}")
        c, d, g, t_len = DPATH_FIT_CASE
        rel, err = _dpath_vs_plain(rng, c, d, g, t_len, dtype)
        print(f"dpath {dtype} at the fit's shape (C={c} d={d} G={g} "
              f"T={t_len}): rel {rel:.2e} abs {err:.2e}")
        key = f"dpath {dtype}"
        worst[key] = max(worst.get(key, 0.0), rel)
        if not (np.isfinite(rel) and rel <= SCAN_TOL[dtype]):
            bad.append(f"dpath {dtype} d={d} G={g} C={c} T={t_len}: "
                       f"{rel:.3e}")
    for k, v in sorted(worst.items()):
        print(f"worst {k}: {v:.3e}")
    n_f32 = total_f32 = 0
    worst_margin = 0.0
    for dtype in ("float64", "float32"):
        for p in BORDER_P_CHECK:
            for c in BORDER_CHAIN_CHECK:
                n_diff, margins = _border_case(rng, dtype, c, p)
                print(f"ssvs_sweep_border {dtype} p={p} C={c}: {n_diff} "
                      "chains differ from the plain version")
                if dtype == "float64" and n_diff:
                    bad.append(f"border float64 p={p} C={c}: {n_diff} "
                               "chains differ")
                if dtype == "float32":
                    n_f32 += n_diff
                    total_f32 += c
                    for m in margins:
                        worst_margin = max(worst_margin, m)
                        if not m < SSVS_TIE:
                            bad.append(f"border float32 p={p} C={c}: a "
                                       f"difference at margin {m:.3e}")
    agree = 1.0 - n_f32 / total_f32
    print(f"ssvs_sweep_border float32: {n_f32} of {total_f32} chains differ "
          f"(agreement {agree:.5f}, gate >= {SSVS_F32_AGREE}), worst "
          f"near-tie margin {worst_margin:.3e}")
    check(not bad, "a kernel of the bsts_reg path disagrees with its plain "
          "version: " + "; ".join(bad[:20]))
    check(agree >= SSVS_F32_AGREE,
          f"float32 border masks agree on {agree:.4f} of chains")

    # the bsts_reg shapes: error, ten launches bit-identical
    at_reg, same = {}, {}
    for name in WIDE_KERNELS:
        kern, ref, _wrapper, _scan = kt.wide_cases(rng, name,
                                                   *kt.WIDE_SHAPES[name])
        first, want = kern(), ref()
        at_reg[name] = {"max_abs_err": float((first - want).abs().max())}
        same[name] = all(torch.equal(first, kern()) for _ in range(9))
    suf, prior, mask, noise = sst.bsts_reg_problem("float32")
    kern, ref, _wrapper = sst.border_cases(suf, prior, mask, noise)
    first, want = kern(), ref()
    at_reg["ssvs_sweep_border"] = {
        "max_abs_err": float((first.float() - want.float()).abs().max())}
    same["ssvs_sweep_border"] = all(torch.equal(first, kern())
                                    for _ in range(9))
    torch.cuda.synchronize()
    print("bsts_reg shapes: max abs error " + ", ".join(
        f"{k} {v['max_abs_err']:.3e}" for k, v in at_reg.items())
        + "; ten launches bit-identical: "
        + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"repeated launches differ: {same}")

    for name, r in {**kt.time_wide(rng), **sst.time_border()}.items():
        plain = (f"{r['plain_ms']:.4f} ms" if r["plain_ms"] is not None
                 else "not timed")
        scan = (f", kernel (c)'s affine scan {r['scan_ms']:.4f} ms"
                if r.get("scan_ms") is not None else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, whole "
              f"wrapper {r['wrapper_ms']:.4f} ms, plain {plain}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}){scan}; one call on "
              f"the host clock {r['call_ms']:.4f} ms")
        if r.get("pass_ms"):
            print(f"time {name} by pass (profiler, device ms a call): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in sorted(r["pass_ms"].items())))
        if name in at_reg:
            at_reg[name].update({k: r[k] for k in ("ms", "plain_ms",
                                                   "bound_ms", "bound_by")})
    for source, report in (("kalman_wide", kt.wide_nvcc_report),
                           ("ssvs_sweep", sst.nvcc_report)):
        log = _build.log_path(source)
        if log.exists():
            for inst, rep in report(log.read_text()).items():
                print(f"nvcc {inst}: {rep['registers']} registers, "
                      f"{rep['spill_bytes']} bytes spill stores, "
                      f"{rep['stack_bytes']} bytes stack")
    return at_reg


def _reg_model(x, y, chains, **kw):
    """bsts_reg's model: what ``BstsModel().add_local_linear_trend()
    .add_seasonal(nseasons=7).fit(y, predictors=x)`` builds (``kw``: more
    of ``Bsts``'s fields)."""
    from boom_tpu_torch.models.glm.regression import SpikeSlabPrior
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import (
        LocalLinearTrend,
        Seasonal,
    )

    return Bsts(y=y, blocks=[LocalLinearTrend.default(y),
                             Seasonal.default(y, nseasons=7)],
                predictors=x,
                reg_prior=SpikeSlabPrior.from_data(
                    x, y, expected_model_size=1.0,
                    prior_information_weight=1.0),
                chains_hint=chains, **kw)


def _reg_front_end(x_all, y):
    """The README's quick start on the card (the default device): fit, then
    every method of the fit; returns the seconds it took."""
    import torch

    from boom_tpu_torch.api import BstsModel

    t0 = time.perf_counter()
    fit = BstsModel().add_local_linear_trend().add_seasonal(nseasons=7)
    fit.fit(y, predictors=x_all[:REG_T], niter=20, burn=10, num_chains=64,
            seed=1)
    fcast = fit.predict(horizon=REG_HORIZON,
                        future_predictors=x_all[REG_T:], max_draws=50)
    contrib = fit.state_contribution_draws()
    errs = fit.prediction_errors()["in.sample"]
    coefs, summ = fit.coefficients(), fit.summary()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(fit._model.y.device.type == "cuda"
          and fit.draws["alpha"].device.type == "cuda",
          "BstsModel.fit did not run on the card by default")
    check(tuple(fcast.shape) == (50, REG_HORIZON)
          and bool(torch.isfinite(fcast).all()), "front-end forecast")
    check(set(contrib) == {"trend", "seasonal_7", "regression"}
          and all(tuple(v.shape) == (64 * 20, REG_T)
                  for v in contrib.values()), "state contributions")
    check(tuple(errs.shape) == (50, REG_T)
          and bool(torch.isfinite(errs).all()), "prediction errors")
    check(len(coefs) == REG_P and "coefficients" in summ,
          "coefficients / summary")
    print(f"bsts_reg front end on the card: fit (64 chains, 10 + 20 sweeps), "
          f"predict, state_contribution_draws, prediction_errors, "
          f"coefficients and summary in {secs:.2f} s; observation sd "
          f"{summ['observation_sd']['mean']:.4f}, beta[0:4] means "
          + ", ".join(f"{r['mean']:.3f}" for r in coefs[:4]))
    return secs


def _reg_sweep_vs_cpu(x_all, y_np):
    """One float64 sweep (init included) of REG_SWEEP_CHAINS chains on the
    card against the CPU's on the same noise: (chains whose masks agree,
    worst relative difference over them, near-tie margins of the rest)."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference.driver import tree_map
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.models.glm.regression import RegSuf

    c = REG_SWEEP_CHAINS
    f64 = torch.float64
    out, models, inits = {}, {}, {}
    gen = prng.generator(3, "cpu")
    for device in ("cpu", "cuda"):
        x = torch.tensor(x_all[:REG_T], dtype=f64, device=device)
        y = torch.tensor(y_np, dtype=f64, device=device)
        models[device] = _reg_model(x, y, c)
        if device == "cpu":
            init_noise = models[device].draw_init_noise(gen, c)
            noise = models[device].draw_noise(gen, c)
        moved = [tree_map(lambda t, dev=device: t.to(dev), n)
                 for n in (init_noise, noise)]
        inits[device] = models[device].init_state(moved[0])
        state = models[device].kernel()(moved[1], inits[device])
        out[device] = tree_map(lambda t: t.cpu(), state)
    agree = (out["cuda"]["gamma"] == out["cpu"]["gamma"]).all(-1)
    errs = []
    tree_map(lambda a, b: errs.append(_rel(a[agree].double(),
                                           b[agree].double())),
             out["cuda"], out["cpu"])
    margins = []
    if not bool(agree.all()):
        # the plain version's decisions of the differing chains, on the
        # CPU's statistics: the smallest margin |log u - log threshold|
        model, state = models["cpu"], inits["cpu"]
        z = model.ssm_params(state).z
        y_reg = model.y - (state["alpha"] * z[:, None]).sum(-1)
        xx = model.predictors
        suf = RegSuf(xtx=xx.T @ xx, xty=y_reg @ xx,
                     yty=(y_reg * y_reg).sum(-1),
                     n=torch.tensor(float(REG_T), dtype=f64))
        idx = torch.nonzero(~agree)[:, 0]
        record = []
        rs.draw_indicators_swept(
            {k: v[idx] for k, v in noise["reg"].items()},
            suf._replace(xty=suf.xty[idx], yty=suf.yty[idx]),
            model.reg_prior, state["gamma"][idx], record=record)
        margins = torch.stack([r[0].abs() for r in record]).min(0)
        margins = margins.values.tolist()
    return int(agree.sum()), max(errs), margins


def _reg_extract(state):
    """bsts_reg's monitor, the regression and the last row of the state
    (what ``BstsModel.predict`` reads)."""
    return {"sigsq_obs": state["sigsq_obs"],
            "blocks": {name: dict(v) for name, v in state["blocks"].items()},
            "beta": state["beta"], "gamma": state["gamma"],
            "alpha": state["alpha"][:, -1:]}


def _reg_run(model, seed, x_all):
    """One bsts_reg run: REG_CHAINS chains x (REG_BURN + REG_DRAWS) sweeps
    of ``model`` from ``seed`` through ``run_mcmc``, then the forecast of
    REG_FORECAST_DRAWS draws; returns what the gates read."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.models.glm import ssvs_kernel as ssk
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk

    for counts in (kk.LAUNCHES, sk.LAUNCHES, ssk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    gen = prng.generator(seed, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   REG_DRAWS, generator=gen, num_chains=REG_CHAINS,
                   burn=REG_BURN, extract=_reg_extract)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {"smoother_wide": kk.LAUNCHES["smoother_wide"],
                "dpath": kk.LAUNCHES["dpath"],
                "ssvs_sweep_border": ssk.LAUNCHES["ssvs_sweep_border"]}
    others = {k: v for k, v in {**kk.LAUNCHES, **sk.LAUNCHES,
                                **ssk.LAUNCHES}.items()
              if k not in launches and v}

    d = res.draws
    tr, se = d["blocks"]["trend"], d["blocks"]["seasonal_7"]
    finite = all(bool(torch.isfinite(v.float()).all())
                 for v in (d["sigsq_obs"], d["beta"], d["alpha"],
                           *tr.values(), *se.values()))
    mon = torch.cat([torch.stack([d["sigsq_obs"], tr["sigma_level_sq"],
                                  tr["sigma_slope_sq"],
                                  se["sigma_seasonal_sq"]], dim=-1),
                     d["beta"][..., :4]], dim=-1).double()
    ess = diagnostics.effective_sample_size(mon).cpu().numpy()

    t1 = time.perf_counter()
    fcast = BstsModel(_model=model, _result=res).predict(
        horizon=REG_HORIZON, future_predictors=x_all[REG_T:],
        max_draws=REG_FORECAST_DRAWS)
    torch.cuda.synchronize()
    f_med = fcast.double().median(0).values.cpu().numpy()
    return {
        "res": res, "gen": gen, "elapsed": elapsed, "launches": launches,
        "others": others, "finite": finite,
        "rhat": diagnostics.potential_scale_reduction(mon).cpu().numpy(),
        "ess": ess, "per_draw": ess / (REG_CHAINS * REG_DRAWS),
        "med": mon.reshape(-1, len(REG_MONITOR)).median(0).values
        .cpu().numpy(),
        "inclusion": d["gamma"].double().mean((0, 1)).cpu().numpy(),
        "fcast_shape": tuple(fcast.shape),
        "fcast_finite": bool(torch.isfinite(fcast).all()),
        "fcast_s": time.perf_counter() - t1,
        "gap": np.abs(f_med - np.asarray(REFERENCE_FORECAST_MEDIAN_REG))
        / np.asarray(REFERENCE_FORECAST_SD_REG)}


def _print_reg(label, r):
    for i, name in enumerate(REG_MONITOR):
        ref = REFERENCE_MEDIANS_REG[name]
        print(f"{label} {name}: median {r['med'][i]:.6g} (reference "
              f"{ref:.6g}, ratio {r['med'][i] / ref:.4f}) rhat "
              f"{r['rhat'][i]:.4f} (reference's at this length "
              f"{REFERENCE_RHAT_REG[i]:.4f}) ess per draw "
              f"{r['per_draw'][i]:.5f}")
    print(f"{label} inclusion probabilities: "
          + ", ".join(f"{v:.4f}" for v in r["inclusion"]))
    gap = r["gap"]
    print(f"{label} forecast {list(r['fcast_shape'])} in {r['fcast_s']:.2f} "
          f"s: |median - reference's| / reference's sd at steps 1, 10, 30: "
          f"{gap[0]:.3f}, {gap[9]:.3f}, {gap[-1]:.3f}; worst "
          f"{float(gap.max()):.3f} (gate {REG_FORECAST_SDS})")


def _reg_gates(r):
    """Phase 6's gates on a run's readings: [(gate, passed, message)]."""
    gates = [("finite", r["finite"], "non-finite bsts_reg draws")]
    rhat, med = r["rhat"], r["med"]
    for i, name in enumerate(REG_MONITOR):
        if name.startswith("beta"):
            gates.append((f"rhat {name}", rhat[i] < RHAT_GATE,
                          f"bsts_reg R-hat of {name} {rhat[i]:.4f} >= "
                          f"{RHAT_GATE}"))
        else:
            limit = (1.0 + REG_RHAT_FACTOR * (REFERENCE_RHAT_REG[i] - 1.0)
                     + REG_RHAT_SLACK)
            gates.append((f"rhat {name}", rhat[i] <= limit,
                          f"bsts_reg R-hat of {name} {rhat[i]:.4f} > "
                          f"{limit:.4f} (the reference's at this length "
                          f"{REFERENCE_RHAT_REG[i]:.4f})"))
        tol = REG_BETA_TOL if name.startswith("beta") else REG_VARIANCE_TOL
        ref = REFERENCE_MEDIANS_REG[name]
        gates.append((f"median {name}", abs(med[i] / ref - 1.0) <= tol,
                      f"bsts_reg median of {name} {med[i]:.5g} is not "
                      f"within {tol:.0%} of the reference's {ref:.5g}"))
    min_per_draw = float(r["per_draw"].min())
    gates += [
        ("ess", min_per_draw >= 0.5 * REFERENCE_MIN_ESS_PER_DRAW_REG,
         f"bsts_reg min-ESS per draw {min_per_draw:.5f} is below half the "
         f"reference's {REFERENCE_MIN_ESS_PER_DRAW_REG:.5f}"),
        ("inclusion", bool((r["inclusion"][:4] >= REG_MIN_INCLUSION).all()),
         f"inclusion probabilities of columns 0-3 "
         f"{r['inclusion'][:4].tolist()}"),
        ("forecast shape",
         r["fcast_shape"] == (REG_FORECAST_DRAWS, REG_HORIZON)
         and r["fcast_finite"],
         f"the forecast is {r['fcast_shape']} or not finite"),
        ("forecast", float(r["gap"].max()) <= REG_FORECAST_SDS,
         f"the forecast's median is {float(r['gap'].max()):.3f} reference "
         "sds from the reference's")]
    return gates


def _reg_data():
    """The committed bsts_reg data: (x [530, 20] and y [500] as numpy, x
    [500, 20] and y on the card, float32)."""
    import torch

    from boom_tpu_torch import data

    x_all, y_np = data.bsts_reg_xy()
    check(x_all.shape == (REG_T + REG_HORIZON, REG_P)
          and y_np.shape == (REG_T,), "the bsts_reg data's shapes")
    x = torch.tensor(x_all[:REG_T], device="cuda")
    y = torch.tensor(y_np, device="cuda")
    check(x.dtype == torch.float32 and y.dtype == torch.float32,
          f"the bsts_reg data are {x.dtype}")
    return x_all, y_np, x, y


def phase6_bsts_reg(card):
    """BASELINE config #5 at full width; returns the new kernels' launch
    counts of the main run."""
    from boom_tpu_torch.statespace.bsts import SWEEP_PHASES

    x_all, y_np, x, y = _reg_data()
    _reg_front_end(x_all, y_np)

    n_agree, worst, margins = _reg_sweep_vs_cpu(x_all, y_np)
    print(f"bsts_reg float64 sweep C={REG_SWEEP_CHAINS}: card vs CPU masks "
          f"agree on {n_agree} chains, worst relative difference there "
          f"{worst:.3e} (tolerance {SWEEP_TOL:g}); the others' smallest "
          f"decision margins {margins}")
    check(np.isfinite(worst) and worst <= SWEEP_TOL,
          f"the bsts_reg sweep on the card disagrees: {worst:.3e}")
    check(n_agree >= REG_SWEEP_CHAINS - 1
          and all(m < SSVS_TIE for m in margins),
          f"the bsts_reg masks agree on {n_agree} chains, margins {margins}")

    model = _reg_model(x, y, REG_CHAINS)
    check(model.state_dim == 8 and model.num_predictors == REG_P,
          f"d = {model.state_dim}, p = {model.num_predictors}")
    r = _reg_run(model, REG_SEED, x_all)
    launches, elapsed = r["launches"], r["elapsed"]
    sweeps = REG_BURN + REG_DRAWS
    print(f"bsts_reg: T={REG_T} d=8 p={REG_P} chains={REG_CHAINS} "
          f"burn={REG_BURN} draws={REG_DRAWS} in {elapsed:.2f} s; launches "
          f"{launches}, other kernels {r['others']}")
    check(launches["smoother_wide"] >= sweeps + 1
          and launches["dpath"] >= sweeps
          and launches["ssvs_sweep_border"] >= sweeps,
          f"the bsts_reg run did not go through its kernels: {launches}")
    _print_reg("bsts_reg", r)
    print(f"bsts_reg rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, "
          f"min-ESS {float(r['ess'].min()):.1f} "
          f"({float(r['per_draw'].min()):.5f} a draw, the reference's "
          f"{REFERENCE_MIN_ESS_PER_DRAW_REG:.5f}), min-ESS/s "
          f"{float(r['ess'].min()) / elapsed:.2f}, max R-hat "
          f"{float(r['rhat'].max()):.4f}")

    _print_profile(f"bsts_reg [{card}]", *_phase_profile(
        model, r["res"].final_state, r["gen"], REG_CHAINS, "bsts",
        SWEEP_PHASES))
    for _gate, ok, msg in _reg_gates(r):
        check(ok, msg)
    return launches


@contextlib.contextmanager
def _planted(fault):
    """Plant one of REG_FAULTS in the port for the duration of a run, by
    replacing a method or function in memory (no file changes); yields the
    model's keyword arguments."""
    from boom_tpu_torch.models.glm import regression_sweep as rs
    from boom_tpu_torch.statespace.state_models import (
        LocalLinearTrend,
        Seasonal,
    )

    patches, kw = [], {}
    if fault == "asis_off":
        kw["asis"] = False
    elif fault == "seasonal_t":
        orig_t = Seasonal._t

        def short_t(self, device, dtype):
            t_mat = orig_t(self, device, dtype).clone()
            t_mat[0, -1] = 0.0
            return t_mat
        patches.append((Seasonal, "_t", short_t))
    elif fault == "level_frozen":
        orig_draw = LocalLinearTrend.draw_params
        orig_groups = LocalLinearTrend.asis_groups

        def draw_kept(self, noise, params, path):
            return {**orig_draw(self, noise, params, path),
                    "sigma_level_sq": params["sigma_level_sq"]}
        patches += [(LocalLinearTrend, "draw_params", draw_kept),
                    (LocalLinearTrend, "asis_groups",
                     lambda self: [g for g in orig_groups(self)
                                   if g[0] != "sigma_level_sq"])]
    elif fault == "shared_border":
        orig_border = rs.border

        def chain0_border(suf, prior):
            edge = orig_border(suf, prior)
            return edge if edge.dim() == 1 else edge[:1].expand_as(edge)
        patches.append((rs, "border", chain0_border))
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        yield kw
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)


def gate_check(card):
    """Phase 6's main run, sound from two more seeds and with each of
    REG_FAULTS planted: each run's readings and the gates it fails. A
    measurement of what the gates can see; prints a JSON line of the
    readings and returns 0 when every run completed."""
    x_all, _y_np, x, y = _reg_data()
    runs = [(f"sound seed {REG_SEED + k}", REG_SEED + k, None)
            for k in GATE_CHECK_SEEDS]
    runs += [(f"fault {f}", REG_SEED, f) for f in REG_FAULTS]
    out = {}
    for label, seed, fault in runs:
        with _planted(fault) as kw:
            model = _reg_model(x, y, REG_CHAINS, **kw)
            r = _reg_run(model, seed, x_all)
        failed = [g for g, ok, _msg in _reg_gates(r) if not ok]
        print(f"gate check [{card}] {label}"
              + (f" ({REG_FAULTS[fault]})" if fault else "")
              + f": {REG_BURN + REG_DRAWS} sweeps in {r['elapsed']:.2f} s")
        _print_reg(f"gate check {label}", r)
        print(f"gate check {label}: fails {failed or 'no gate'}")
        out[label] = {
            "rhat": [float(v) for v in r["rhat"]],
            "median_ratio": [float(r["med"][i] / REFERENCE_MEDIANS_REG[n])
                             for i, n in enumerate(REG_MONITOR)],
            "min_ess_per_draw": float(r["per_draw"].min()),
            "inclusion_0_3": [float(v) for v in r["inclusion"][:4]],
            "forecast_worst_sds": float(r["gap"].max()),
            "failed": failed}
    print(json.dumps({"gate_check": out, "card": card}))
    return 0


def main():
    card = phase0_environment()
    import torch

    if sys.argv[1:] == ["--gate-check"]:
        try:
            phase1_build()
            return gate_check(card)
        except SmokeFailure as exc:
            print(f"chip_smoke --gate-check FAILED: {exc}", file=sys.stderr)
            return 1
    try:
        phase1_build()
        at_fit = phase2_kernels_vs_plain()
        at_llt = phase2b_kalman_vs_plain()
        phase3_sweep_vs_plain()
        launches = phase3_fit(card)
        llt_launches = phase4_bsts_llt(card)
        at_ssvs = phase2c_ssvs_vs_plain()
        ssvs_launches = phase5_spike_slab(card)
        at_reg = phase2d_wide_vs_plain()
        reg_launches = phase6_bsts_reg(card)
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
    for k, (name, replaces) in WIDE_KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": WIDE_SOURCE, "replaces": replaces,
                        "launches": reg_launches[k], **at_reg[k],
                        "library_ms": None})
    kernels.append({"name": "ssvs_sweep_border", "route": "cuda",
                    "source": SSVS_SOURCE, "replaces": SSVS_REPLACES,
                    "launches": reg_launches["ssvs_sweep_border"],
                    **at_reg["ssvs_sweep_border"], "library_ms": None})
    lacking = {k["name"]: sorted(KERNEL_KEYS - set(k)) for k in kernels
               if KERNEL_KEYS - set(k)}
    if lacking:
        print(f"chip_smoke FAILED: kernel rows lack keys: {lacking}",
              file=sys.stderr)
        return 1
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
