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
     500, 1025} (K2 stages 32 steps at a time: one below, at, one above a
     chunk, a ragged last one), 33 and 4095 chains (a last warp partly
     empty), masked and dense, float64 (<= 1e-9) and float32 (K1, <= 1e-4),
     K1 at the bsts_llt width (69,632 series); K1 with a series a chain
     (d in {1, 2, 3, 6}, 33 and 4095 chains x 17 systems) and K1w (the
     loglik for 7 <= d <= 16, ``csrc/kalman_wide.cu``: d in {7, 8, 9, 13,
     16}, T in {2, 31, 32, 33, 67}, 33, 4095 and 4097 series, one shared
     series and a series a system, masked and dense, a T a system and T
     and z one of every system (expanded, as Bsts builds them: the same
     bits as materialised), and at phase 7's width, 4096 chains x 17
     points on their chains' series, in both layouts), each with its
     innovations v and f, float64 (<= 1e-9) and float32 (<= 1e-4); J1 and
     J2 (the loglik's gradient, and its gradient and Hessian, along K
     directions, ``csrc/kalman_wide.cu``) at d in {1, 2, 3, 6, 8, 13, 16}
     and K = 3 and 16 (the most), T = 64, against autograd of the plain
     loop, directly and through ``torch.autograd.functional.hessian``
     (<= 1e-9), and at phase 7's and phase 4's shapes (T = 500);
     ten launches of each at the bsts_llt and phase 7 shapes,
     bit-identical; then their times beside bounds and plain times
     (``boom_tpu_torch/kernels/kalman_timing.py``; J1's and J2's with
     their latency floor, ``kalman_timing.jet_floor_ms``),
     registers and spills;
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
     67}, 33, 4095 and 4097 chains (<= 1e-9), and at phase 6's shapes (T =
     500, d = 8 and 13), K3 (the ASIS D-path of
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
     chains, 100 burn-in + 100 draws (300 + 250 until phase 8 came, 200
     + 200 until phases 10a and 10b),
     float32 (smoother in float64), through ``run_mcmc`` and
     ``BstsModel.predict(horizon=30,
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
     busy share;
  7. config #5 with the TIM marginal move (``marginal_sigma_slice=True,
     marginal_move="tim"``, 16 trials) on phase 6's data at its width and
     length (4096 chains, 100 + 100 sweeps, float32, smoother in float64):
     the proposal's mode search through J1 and J2 at d = 8, then the run
     through K1w (the move's 17 points a chain on the chain's y - X beta),
     K2w, K3 and kernel (a)'s per-chain entry; gated by finite draws, R-hat
     < 1.02 on beta[0:4], on each variance R-hat - 1 at most 1.10 times the
     reference's own run with the move at this length + 0.01, half its
     min-ESS per draw and medians within 10 % (variances) and 2 %
     (beta[0:4]) of its; then ``log_lik`` and ``prediction_errors(
     cutpoints=[400])`` of 200 draws (a refit of y[:400] and the holdout
     filter), log_lik and the in-sample errors within 1e-4 of their plain
     versions on the card. It prints sweeps/s, min-ESS/s, the proposal
     build's wall time, each phase's share of a sweep, the device's busy
     share, whether the move lifts the level and slope variances' R-hat
     from phase 6's, and its own time;
  2e. the time-varying forms of K1, K1w, K2 and K2w (z_t shared by the
     systems, h_t = h h_scale_t, Q_t = (q_t q_t') o Q with q_t a system,
     one for all or none; a mask) against their plain versions on the
     card: d in {1, 2, 6, 7, 13, 16}, T in {33, 67}, 33 systems on 11
     series and 257 on one, K1 / K1w with their innovations in float64
     (<= 1e-9) and float32 (<= 1e-4), K2 / K2w in float64; K2w in its
     dense form (a T a system) and, at d 7, 13 and 16 and on 4097 chains
     at d = 13, in its structured form (one T for all: bsts' pattern, a
     random one with an empty and a full row, a dense one), each case
     taking its form's launch key; at phase 8's shapes
     (``kalman_timing.TV_SHAPES``: K2w in both forms), ten launches
     there bit-identical; their times beside bounds (over T's non-zeros
     and dense) and plain times, registers and spills;
  8. bsts_tv: a daily series on a grid of 500 days with gaps and
     duplicated days (``boom_tpu_torch/data/bsts_tv.npz``), fit with its
     timestamps through ``BstsModel().add_student_local_linear_trend()
     .add_seasonal(7).add_dynamic_regression(x_dyn)
     .add_random_walk_holiday(active, 3).fit(y, predictors=x,
     timestamps=ts)`` (d = 13, p = 20) on the card: the front end briefly;
     one float64 sweep of 33 chains against the CPU's (<= 1e-8); then
     4096 chains x (200 + 200) sweeps, float32 (smoother float64), through
     K2w's structured time-varying form (all 401 smoother launches, or the
     phase fails), K3 and kernel (a)'s per-chain entry, gated
     against the reference's own run (tests/test_torch_bsts_tv.py bench
     1024 200 200 7): each monitored parameter's R-hat - 1 at most 1.10
     times the reference's + 0.01, medians within 10 % (variances, nu) and
     2 % (beta[0:4]), half its min-ESS per draw, columns 0-3 included with
     probability >= 0.99; ``predict(horizon=30)`` of 200 draws with the
     future predictors and holiday days within half the reference's sd of
     its median; ``log_lik`` and ``prediction_errors(cutpoints=[400])`` of
     200 draws through K1w's time-varying form, within 1e-4 of the plain
     filter; then a d = 4 model (a Student trend and the dynamic
     regression, 64 chains x (20 + 20)) through K2's and K1's. It prints
     sweeps/s, min-ESS/s, each phase's share of a sweep and the device's
     busy share.
  2f. H1 and H2, the HMM's forward filter and backward sampler
     (``csrc/hmm.cu``), against their plain versions on the card: S in
     {1, 2, 3, 4, 7, 8, 16}, T in {1, 2, 33, 1200}, 1, 33 and 4097 chains,
     float64 and float32: H1 within a normwise 1e-9 / 1e-4 (with and
     without its alphas), H2's paths identical in float64 and on >= 99.5 %
     of chains in float32 (near-ties only), its statistics those of its own
     path (1e-12 / 1e-5); around the kernels' split of a chain's T steps
     over L lanes (``hmm_kernel.lanes``: L = 32 at 1 and 33 chains, 8 at
     4097), T just below, at and above a multiple of L and T < L; a
     problem whose log alphas fall below -87 (float32's exp underflows
     there); ten launches bit-identical at phase 9's shape and at few
     chains on a long series (8 chains, T = 4,096, L = 32); times beside
     bounds, the lanes' chains' floors and the plain versions'
     (``kernels/hmm_timing.py``);
  9. BASELINE configs #4, #3 and #1 (``BASELINE.md:29-33``) on their
     committed data (``boom_tpu_torch/data``), each held to the reference's
     own run at its length (``tests/test_torch_{hmm,mixtures,
     beta_binomial}.py bench``): ``GaussianHmm`` (S = 2, T = 1,200), 4096
     chains x (200 + 200) through H1 and H2 (one of each a sweep, or the
     phase fails); ``FiniteMixture(3).fit`` (n = 1,500) on the card, 4096
     chains x (200 + 200); ``BetaBinomialModel`` (200 groups), 1024 chains
     x (250 + 250). Medians within 10 % of the reference's, R-hat - 1 at
     most 1.10 times its + 0.01 and half its min-ESS per draw (for the HMM
     and the mixture over the chains that stayed in the main mode, and
     the share of those within 4 binomial sds of the reference's), the
     truth in the draws' central 98 % intervals (HMM, mixture), the
     Beta-Binomial's
     posterior moments against 2-d quadrature with the reference test's
     bounds and R-hat < 1.02; one float64 sweep of 33 chains of each
     against the CPU's (<= 1e-8); the HMM's ``log_lik`` of 200 draws
     through H1 within 1e-4 of the plain filter; ``components()`` near the
     truth and ``cluster_probs()``' rows summing to 1. It prints sweeps/s,
     min-ESS/s and the device's busy share.
  2g. the calendar's T_t (two matrices, a step's choice: the monthly
     cycle's) in K2w's dense time-varying form and K1w's
     (``csrc/kalman_wide.cu``) against their plain versions on the card:
     K2w at d in {11, 13, 14, 16}, 33, 4095 and 4097 chains, two matrices
     a chain and two for all, T about its chunks (31, 32, 33, 67) and the
     phase's 730, a month boundary at step 0 and at T - 2, masked and
     dense, float64 (<= 1e-9); K1w at d in {11, 14, 16}, float64 and
     float32 (<= 1e-4), with and without the innovations, T 33, 67 and
     730, a mask; each launch taking its calendar key; at phase 10a's
     shapes ten launches bit-identical and times beside bounds and plain;
     K1w with a T a system at phase 10b's TIM batch, against its plain
     version and timed;
 10a. bsts_monthly (``boom_tpu_torch/data/bsts_monthly.npz``: two years of
     days): ``BstsModel().add_semilocal_linear_trend()
     .add_monthly_annual_cycle(first_date)`` (d = 14) through the front
     end on the card; one float64 sweep of 33 chains against the CPU's
     (<= 1e-8); 4096 chains x (200 + 200) sweeps, every smoother launch
     in K2w's dense form with the calendar, K3 every sweep, gated against
     the reference's run (``tests/test_torch_monthly.py bench``: medians
     within 10 %, R-hat - 1 at most 1.10 times its + 0.01, half its min-ESS
     a draw); ``predict(horizon=30)`` against the reference's forecast;
     ``log_lik`` and the one-step errors of 200 draws through K1w's
     calendar form within 1e-4 of the plain filter;
 10b. bsts_ar_trig (``data/bsts_ar_trig.npz``: ten years of weeks):
     ``BstsModel().add_static_intercept().add_ar(lags=2)
     .add_trig(period=52.18, nfreq=2)`` with ``marginal_sigma_slice=True,
     marginal_move="tim"`` (d = 7, the AR state's T a chain's): the
     proposal through J1 and J2, one float64 sweep of 33 chains against
     the CPU's (<= 1e-8, the card's proposal on both), 4096 chains x
     (200 + 200) sweeps through the static K2w with a T a chain, K3 and
     K1w with a T a system (each chain's 17 TIM points), gated against
     the reference's run (``tests/test_torch_state_blocks.py bench``) as
     10a; ``log_lik`` and the one-step errors of 200 draws.

Every phase prints its time (``phase N took X s``), and the whole run its
own.

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
T_START = time.perf_counter()

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
# sweeps under torch.profiler for a phase's breakdown (5 before phases 10a
# and 10b came: the trace of a bsts sweep, ~9,000 launches, takes ~5 s of
# the host a sweep to gather, 160 s of a run in all)
PROFILE_SWEEPS = 2
KERNEL_SOURCE = "boom_tpu_torch/csrc/parallel_scan.cu"
# each combine's call of the one Pallas scan kernel (pallas_call at :241)
REPLACES = {"filter": "boom_tpu/statespace/pallas_scan.py:273",
            "smooth": "boom_tpu/statespace/pallas_scan.py:287",
            "affine": "boom_tpu/statespace/pallas_scan.py:305"}

# phase 2b: the sequential kernels and the XLA scans of the reference they
# replace (kalman.py's lax.scan of kalman_loglik; the fused smoother's
# forward scan, with _smoother_passes' two scans at :322 and :349); K1's
# row reads phase 4's launches
KALMAN_SOURCE = "boom_tpu_torch/csrc/kalman_seq.cu"
KALMAN_KERNELS = {"loglik": ("kalman_loglik",
                             "boom_tpu/statespace/kalman.py:282"),
                  "smoother": ("kalman_simulation_smoother",
                               "boom_tpu/statespace/kalman.py:476")}
# K1w, the loglik at 7 <= d <= 16, and J1 and J2, the loglik's derivatives
# along K directions (they replace jax.value_and_grad of the loglik's scan
# in numopt.bfgs and jax.hessian in numopt.newton_raphson and bsts.py:661),
# in kalman_wide.cu; their rows read phase 7's launches and its shapes
TIM_KERNELS = {"loglik_wide": ("kalman_loglik_wide",
                               "boom_tpu/statespace/kalman.py:282"),
               "loglik_grad": ("kalman_loglik_grad",
                               "boom_tpu/numopt.py:43"),
               "loglik_hess": ("kalman_loglik_hess",
                               "boom_tpu/numopt.py:101")}
# K1 with a series a group of systems: d, and chains of TIM points (each
# chain's points on its own series); K1w: d, T about the warps and a
# longer one (67: 500 until phase 8 came; phase 7's width runs T = 500),
# series counts of a partial block and ragged last ones (each also dense
# and masked, shared and a series a system)
PER_CHAIN_D_CHECK = (1, 2, 3, 6)
PER_CHAIN_CHAINS = (33, 4095)
LOGLIK_WIDE_D_CHECK = (7, 8, 9, 13, 16)
LOGLIK_WIDE_T_CHECK = (2, 31, 32, 33, 67)
LOGLIK_WIDE_SERIES = (33, 4095, 4097)
# the jets along directions: d, and K at TIM's 3 and at the most; T of
# the checks (autograd of the plain loop over 500 steps, a backward pass
# a direction, would take ~100 s of the script) but for phase 7's and
# phase 4's shapes, which stay at T = 500 (cut from 150 to 64 with the
# other off-path T of phases 2b and 2d when phase 8 came: its time)
JET_D_CHECK = (1, 2, 3, 6, 8, 13, 16)
JET_T = 64
# K2 stages 32 steps at a time (kalman_kernel.SMOOTHER_CHUNK): one below,
# at and one above a chunk, a ragged last chunk, the bsts_llt T and a long
# ragged one (1025: 4096 until phase 8 came; no main path runs K1 or K2
# at the fit's T, which the scans serve); masked at MASKED_T; chain counts
# that leave the last warp partly empty
KALMAN_T_CHECK = (2, 31, 32, 33, 67, 500, 1025)
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
# edges and a longer one (67: 500 until phase 8 came; the main path's T =
# 500 is checked at phase 6's shapes); 33 chains (a partial block), 4095
# and 4097 (a ragged last pack).
# K3: d 1, 2, 3 (32, 16 and 8 series a warp) to 16 at T = LLT_T; 33
# chains and 4096, 4097 (the short chunks of a full card); and the fit's
# D-paths (phase 3: 8 chains x 2 groups, d = 2, T = T_FIT, many long
# chunks a series)
WIDE_D_CHECK = (7, 8, 9, 13, 16)
WIDE_T_CHECK = (31, 32, 33, 67)
WIDE_CHAIN_CHECK = (33, 4095, 4097)
DPATH_D_CHECK = (1, 2, 3, 7, 8, 13, 16)
DPATH_G_CHECK = (1, 2, 3)
DPATH_CHAIN_CHECK = (33, 4096, 4097)
DPATH_FIT_CASE = (CHAINS, 2, 2, T_FIT)  # chains, d, groups, T
BORDER_P_CHECK = (20, 33, 50)
BORDER_CHAIN_CHECK = (33, 4096)

# phase 6: bsts_reg, BASELINE config #5 (BASELINE.md:32; README.md:40-44)
REG_T, REG_P, REG_HORIZON = 500, 20, 30
# 100 + 100 sweeps (200 + 200 before phases 10a and 10b came, 300 + 250
# before phase 8: each cut to pay for the new phases' time, the
# references remade at the new length)
REG_CHAINS, REG_BURN, REG_DRAWS, REG_SEED = 4096, 100, 100, 0
REG_FORECAST_DRAWS = 200
REG_SWEEP_CHAINS = 33
REG_MONITOR = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq",
               "sigma_seasonal_sq", "beta[0]", "beta[1]", "beta[2]",
               "beta[3]")
# The JAX reference's run on the committed data (x64 off, as the bench
# runs) at phase 6's length: 1024 chains, 100 burn-in + 100 draws, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_reg.py \
#         bench 1024 100 100 7
# (148 s on 8 CPU cores; remade at each cut of phase 6's length: before
# phase 8 came, the medians, min-ESS and forecast came from a 64-chain,
# 500 + 2000 run of the same script, and phase 6 ran 300 + 250 sweeps)
REFERENCE_MEDIANS_REG = {
    "sigsq_obs": 0.3531602919101715,
    "sigma_level_sq": 0.005960899405181408,
    "sigma_slope_sq": 0.00019297635299153626,
    "sigma_seasonal_sq": 0.0019394648261368275,
    "beta[0]": 3.0176608562469482,
    "beta[1]": -2.01236629486084,
    "beta[2]": 1.4408519268035889,
    "beta[3]": 0.9972443580627441}
REFERENCE_MIN_ESS_PER_DRAW_REG = 0.01420139254668054
REFERENCE_FORECAST_MEDIAN_REG = (
    -62.50745391845703, -58.808265686035156, -60.28821563720703,
    -60.121490478515625, -67.96714782714844, -58.901649475097656,
    -66.80693817138672, -65.08326721191406, -63.735164642333984,
    -61.737464904785156, -69.082763671875, -64.8313217163086,
    -64.38792419433594, -63.83995056152344, -73.95658874511719,
    -67.64079284667969, -67.03776550292969, -61.601905822753906,
    -73.24053955078125, -65.67137145996094, -68.57899475097656,
    -69.34652709960938, -59.08729553222656, -71.63925170898438,
    -70.27378845214844, -74.01016235351562, -75.03581237792969,
    -73.78312683105469, -76.77568817138672, -67.80296325683594)
REFERENCE_FORECAST_SD_REG = (
    0.7195358276367188, 0.741791307926178, 0.7688488960266113,
    0.7479841113090515, 0.8164856433868408, 0.8042434453964233,
    0.8394821882247925, 0.9401535987854004, 0.9868109226226807,
    0.9845094084739685, 1.0560020208358765, 1.0166609287261963,
    1.0865552425384521, 1.1959089040756226, 1.1953082084655762,
    1.2601832151412964, 1.409246802330017, 1.3953691720962524,
    1.5134830474853516, 1.5042085647583008, 1.431753396987915,
    1.7365992069244385, 1.601025938987732, 1.7681423425674438,
    1.7785327434539795, 1.8384673595428467, 1.9685429334640503,
    2.034256935119629, 2.2478833198547363, 2.163076400756836)
# Split R-hat of the reference at this run length (100 burn-in + 100
# draws, 1024 chains, x64 off), REG_MONITOR's order, from the same run.
# The level and slope variances mix slowly in the reference's own sampler
# (ESS per draw ~0.014): their R-hat at 100 draws is far above 1.02, so
# the port's gate on the variances is the reference's own R-hat here
REFERENCE_RHAT_REG = (
    1.0494069876934873, 1.895183931123383, 1.760766274867759,
    1.1787057443868298, 1.0044087242913886, 1.0037816341405836,
    1.0042901796421535, 1.0043923477282015)
# the port's R-hat - 1 at most REG_RHAT_FACTOR times the reference's, plus
# REG_RHAT_SLACK (both estimates carry the noise of a finite run). At
# 300 + 250 sweeps sound runs from seeds 0, 1 and 2 read at most
# 1.0348 / 1.5147 / 1.4474 / 1.0716 against limits of 1.0473 / 1.5484 /
# 1.4917 / 1.0872, and ``--gate-check`` read 1.7526 on the level variance
# with the ASIS pass skipped
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


# phase 7: config #5 with the TIM move (marginal_sigma_slice=True,
# marginal_move="tim", 16 trials), phase 6's data, width and length
TIM_REG_TRIALS = 16
TIM_REG_SEED = 0
TIM_REG_DRAWS = 200  # draws of log_lik and the prediction errors
TIM_REG_CUTPOINT = 400
# the refit's draws (``holdout_prediction_errors``' default, the
# reference's): at most this many rows of holdout errors
TIM_REG_REFIT_DRAWS = 100
TIM_REG_TOL = 1e-4  # log_lik and the errors against their plain versions
# The JAX reference's run with the move on the committed data (x64 off, as
# the bench runs), 1024 chains, 100 burn-in + 100 draws (phase 7's
# length), REG_MONITOR's order, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_tim_reg.py \
#         bench 1024 100 100 7
# (377 s on 8 CPU cores). The move lifts the recorded level and slope
# variances' R-hat from the reference's 1.8952 / 1.7608 without it
# (REFERENCE_RHAT_REG) to 1.0886 / 1.0704; the observation variance's and
# beta's trajectories are those of the run without it (the move's draws
# are redrawn by the next sweep's variance step, and it takes noise of its
# own), so their R-hat is the same
REFERENCE_MEDIANS_TIM_REG = {
    "sigsq_obs": 0.3531602919101715,
    "sigma_level_sq": 0.005171357421204448,
    "sigma_slope_sq": 0.00015460689610335976,
    "sigma_seasonal_sq": 0.001939769135788083,
    "beta[0]": 3.0176608562469482,
    "beta[1]": -2.01236629486084,
    "beta[2]": 1.4408519864082336,
    "beta[3]": 0.9972443878650665}
REFERENCE_RHAT_TIM_REG = (
    1.0494069876934873, 1.0886365356700771, 1.0704201343531516,
    1.0193171542798647, 1.0044087242913886, 1.0037816341405836,
    1.0042901796421535, 1.0043923477282015)
REFERENCE_MIN_ESS_PER_DRAW_TIM_REG = 0.06681189934631662

# phase 2e: the time-varying forms of K1, K1w, K2 and K2w (z_t, h_t =
# h h_scale_t, Q_t = (q_t q_t') o Q), the reference's XLA scans they
# replace (kalman_loglik's lax.scan, which takes zs, hs and rqrs of a
# time-varying system; simulation_smoother's time-varying path, simulate
# then smooth_states on y - y+); their rows read phase 8's launches (K2w,
# K1w: the bsts_tv run and its log_lik; K2, K1: the d = 4 model's)
TV_KERNELS = {
    "smoother_wide_tv": ("kalman_simulation_smoother_wide_tv", WIDE_SOURCE,
                         "boom_tpu/statespace/kalman.py:432"),
    "smoother_wide_tv_dense": ("kalman_simulation_smoother_wide_tv_dense",
                               WIDE_SOURCE,
                               "boom_tpu/statespace/kalman.py:432"),
    "loglik_wide_tv": ("kalman_loglik_wide_tv", WIDE_SOURCE,
                       "boom_tpu/statespace/kalman.py:282"),
    "smoother_tv": ("kalman_simulation_smoother_tv", KALMAN_SOURCE,
                    "boom_tpu/statespace/kalman.py:432"),
    "loglik_tv": ("kalman_loglik_tv", KALMAN_SOURCE,
                  "boom_tpu/statespace/kalman.py:282")}
# d of the checks (K1 and K2 at 1, 2, 6; K1w and K2w at 7, 13, 16), T, a
# q_t a system, one for all or none; 33 systems on 11 series and 257 on
# one (a ragged last block); each with a T a system, and at K1w's and
# K2w's d in both dtypes (the smoother in float64) also with one T for
# all of bsts' pattern, a random pattern (an empty row and a full one)
# and a dense one (the structured forms over T's non-zeros:
# ``kalman_timing.T_KINDS``), at K1's with bsts' T for all (its one row),
# and 4097 chains at d = 13 (a ragged last block of K2w's) with bsts' T
# and with a T a chain
TV_D_CHECK = (1, 2, 6, 7, 13, 16)
TV_T_CHECK = (33, 67)
TV_Q_CHECK = ("chain", "shared", None)
TV_SHARED_T = ("bsts", "sparse", "dense")
TV_RAGGED = (4097, 13, 33)  # chains, d, T

# phase 8: bsts_tv, a daily series on a grid of 500 days with gaps and
# duplicated days (``boom_tpu_torch/data/bsts_tv.npz``): a Student trend, a
# 7-day cycle, a 2-column dynamic regression and a 3-day random-walk
# holiday (d = 13), a spike-and-slab regression of p = 20, fit with its
# timestamps
TV_CHAINS, TV_BURN, TV_DRAWS, TV_SEED = 4096, 200, 200, 0
TV_FORECAST_DRAWS = 200
TV_CUTPOINT = 400
TV_SWEEP_CHAINS = 33
# the d = 4 model (a Student trend and the dynamic regression) that runs
# K1's and K2's time-varying forms: chains, burn-in, draws
TV_SMALL = (64, 20, 20)
TV_MONITOR = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq", "nu_level",
              "nu_slope", "sigma_seasonal_sq", "sigma_dynreg_sq[0]",
              "sigma_dynreg_sq[1]", "sigma_holiday_sq", "beta[0]",
              "beta[1]", "beta[2]", "beta[3]")
# The JAX reference's run on the committed data (x64 off, as the bench
# runs; its ASIS redraw given the filter's observation variances, a fault
# of the reference corrected: ROADMAP.md, sec. 3), 1024 chains, 200
# burn-in + 200 draws (phase 8's length), TV_MONITOR's order, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_tv.py \
#         bench 1024 200 200 7
# (about 12 minutes on 8 CPU cores). Its level and slope variances, nu and
# the dynamic regression's variances mix slowly at this length (R-hat
# 1.63-1.89, ESS per draw ~0.007), so phase 8 holds each R-hat - 1 to
# REG_RHAT_FACTOR times the reference's + REG_RHAT_SLACK, as phase 6
REFERENCE_MEDIANS_TV = {
    "sigsq_obs": 0.3007541745901108,
    "sigma_level_sq": 0.010432387236505747,
    "sigma_slope_sq": 0.00020652662351494655,
    "nu_level": 12.198681354522705,
    "nu_slope": 13.083141326904297,
    "sigma_seasonal_sq": 0.00016765972395660356,
    "sigma_dynreg_sq[0]": 0.0005435570201370865,
    "sigma_dynreg_sq[1]": 0.00039738582563586533,
    "sigma_holiday_sq": 0.041085587814450264,
    "beta[0]": 3.001819372177124,
    "beta[1]": -2.030407667160034,
    "beta[2]": 1.4802201986312866,
    "beta[3]": 0.9655955731868744}
REFERENCE_RHAT_TV = (
    1.0436637172303511, 1.8346827036922466, 1.6298962434654125,
    1.8900867005571838, 1.8663537776105579, 1.024266948606765,
    1.8374670313787824, 1.8256653510690748, 1.1027888093928464,
    1.003408002202693, 1.0034715777735792, 1.008828404435497,
    1.002602357493974)
REFERENCE_MIN_ESS_PER_DRAW_TV = 0.0071020904862332665
REFERENCE_FORECAST_MEDIAN_TV = (
    -37.16552734375, -43.72484588623047, -45.822906494140625,
    -46.096866607666016, -51.41563415527344, -41.0736083984375,
    -38.182464599609375, -48.7662239074707, -36.05126190185547,
    -41.711219787597656, -42.572391510009766, -41.84668731689453,
    -36.26859664916992, -39.099700927734375, -38.877685546875,
    -48.041099548339844, -49.62646484375, -44.79119110107422,
    -41.39777374267578, -49.39680862426758, -39.146522521972656,
    -42.72175598144531, -48.21085739135742, -41.9118537902832,
    -45.504913330078125, -38.004844665527344, -36.95187759399414,
    -44.007232666015625, -56.85428237915039, -45.217376708984375)
REFERENCE_FORECAST_SD_TV = (
    0.6361469626426697, 0.9117140769958496, 0.9689147472381592,
    1.023921012878418, 0.8181862831115723, 0.8909514546394348,
    0.9196645617485046, 0.9831339120864868, 1.029069423675537,
    1.1874287128448486, 1.1277897357940674, 1.2560088634490967,
    1.3649027347564697, 1.345676064491272, 1.3720375299453735,
    1.5790433883666992, 1.67475163936615, 1.7740757465362549,
    1.7809972763061523, 1.8930866718292236, 1.9362565279006958,
    2.0857560634613037, 2.12402081489563, 2.3930115699768066,
    2.353912830352783, 2.429535388946533, 2.528822422027588,
    2.5958359241485596, 2.7273616790771484, 2.789325475692749)
# log_lik and the errors of TV_FORECAST_DRAWS draws against their plain
# versions on the card (float32: the normwise 1e-4 of the kernels' gate)
TV_TOL = 1e-4

# phase 2f: H1 and H2, csrc/hmm.cu, and the reference's XLA scans they
# replace; their rows read phase 9's launches and its shape
HMM_SOURCE = "boom_tpu_torch/csrc/hmm.cu"
HMM_KERNELS = {"hmm_forward": ("hmm_forward_filter",
                               "boom_tpu/models/hmm.py:52"),
               "hmm_backward": ("hmm_backward_sample",
                                "boom_tpu/models/hmm.py:72")}
HMM_S_CHECK = (1, 2, 3, 4, 7, 8, 16)
HMM_T_CHECK = (1, 2, 33, 1200)
HMM_CHAIN_CHECK = (1, 33, 4097)
# T around the split of a chain's steps over its L lanes: L - 1 (T < L),
# L, L + 1 and 2 L + 1 (just above a multiple), where not in HMM_T_CHECK
HMM_EDGE_T = (-1, 0, 1, None)
# the problems whose odd states' log alphas fall far below -87 (S, chains;
# T = 1200): float32's exp underflows there, log space does not
HMM_DEEP_CHECK = ((2, 33), (3, 4097))
# H2's float32 paths: the share of chains that must agree, and the
# largest logit margin (relative) at which two may choose differently
HMM_AGREE, HMM_TIE = 0.995, 1e-5
# H2's statistics against those of its own path
HMM_STATS_TOL = {"float64": 1e-12, "float32": 1e-5}

# phase 9: BASELINE configs #4 (GaussianHmm), #3 (FiniteMixture) and #1
# (BetaBinomialModel) on their committed data, float32 on the card
BASE_CHAINS, BASE_BURN, BASE_DRAWS, BASE_SEED = 4096, 200, 200, 7
# 250 + 250 sweeps (500 + 500 before phases 10a and 10b came)
BB_CHAINS, BB_BURN, BB_DRAWS = 1024, 250, 250
BASE_SWEEP_CHAINS = 33
HMM_LOGLIK_DRAWS = 200
BASE_MEDIAN_TOL = 0.10
BB_RHAT_GATE = 1.02
# the truth in the draws' central BASE_CONFIDENCE intervals (the reference
# tests' check_mcmc_matrix, boom_tpu/testing.py:34)
BASE_CONFIDENCE = 0.98
# the reference's runs at these lengths, 1024 chains from
# jax.random.key(7), x64 off, as their bench entries print them:
# PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_hmm.py bench 1024
# 200 200 7 (and test_torch_mixtures.py the same; test_torch_beta_binomial.py
# bench 1024 250 250 7). The monitors' order is the tests' MONITOR (states
# and components sorted by mu in every draw). A few chains of the HMM's and
# the mixture's runs enter a degenerate mode (two components on one
# cluster) and keep it or leave it late, which alone puts R-hat over all
# chains near 3 (8.5 for the mixture's middle mean) and makes it a reading
# of how many chains did so: their R-hat and min-ESS gates read the chains
# that stayed in the main mode (``mixtures.main_mode``), and the share of
# chains that did is held to the reference's within BASE_SHARE_SIGMAS
# binomial sds
HMM_MONITOR = ("mu0", "mu1", "sd0", "sd1", "p00", "p11")
REFERENCE_HMM = {
    'chains': 1024,
    'burn': 200,
    'draws': 200,
    'seed': 7,
    'medians': [-1.475430965423584, 1.834120512008667, 0.7884320020675659,
                0.5951301455497742, 0.9235700368881226, 0.8931198120117188],
    'rhat': [3.012906551361084, 3.218822956085205, 2.981130599975586,
             3.075474739074707, 2.680893898010254, 2.614750862121582],
    'min_ess_per_draw': 0.005589270032942295,
    'main_share': 0.970703125,
    'main_rhat': [1.0003772974014282, 1.0002646446228027, 1.000856637954712,
                  1.001111626625061, 1.0001171827316284, 0.9998492002487183],
    'main_min_ess_per_draw': 0.8782951615945674,
}
MIX_MONITOR = ("mu0", "mu1", "mu2", "sd0", "sd1", "sd2", "w0", "w1", "w2")
REFERENCE_MIX = {
    'chains': 1024,
    'burn': 200,
    'draws': 200,
    'seed': 7,
    'medians': [-2.98004150390625, 0.4654783606529236, 3.908781051635742,
                0.7133865356445312, 0.5381610989570618, 0.97624671459198,
                0.3550760746002197, 0.39605677127838135, 0.24792152643203735],
    'rhat': [1.0855118036270142, 8.522127151489258, 1.0537809133529663,
             1.1882597208023071, 1.1647484302520752, 1.5955734252929688,
             4.1927289962768555, 3.218186616897583, 4.874109745025635],
    'min_ess_per_draw': 0.005097101908177137,
    'main_share': 0.955078125,
    'main_rhat': [1.0003005266189575, 1.002277135848999, 1.0044912099838257,
                  1.0015027523040771, 1.0072314739227295, 1.0080455541610718,
                  0.9999221563339233, 1.0011411905288696, 1.001192569732666],
    'main_min_ess_per_draw': 0.41631801987474437,
}
BB_MONITOR = ("prob", "size")
REFERENCE_BB = {
    'chains': 1024,
    'burn': 250,
    'draws': 250,
    'seed': 7,
    'medians': [0.2942754328250885, 14.963851928710938],
    'rhat': [1.0000883340835571, 1.0001869201660156],
    'min_ess_per_draw': 0.9640631079673767,
}
BASE_SHARE_SIGMAS = 4.0
# components(): each mean and sd within this of the truth, each weight
# within MIX_WEIGHT_TOL
# (components() averages every chain's draws, the degenerate mode's too)
MIX_COMPONENT_TOL, MIX_WEIGHT_TOL = 0.3, 0.05

# phase 2g: the calendar's T_t in K2w's dense time-varying form and in
# K1w's (kalman_wide.cu); their rows read phase 10a's launches, and K1w's
# with a T a system phase 10b's
CALENDAR_KERNELS = {
    "smoother_wide_tv_calendar": ("kalman_simulation_smoother_wide_tv_"
                                  "calendar",
                                  "boom_tpu/statespace/kalman.py:432"),
    "loglik_wide_tv_calendar": ("kalman_loglik_wide_tv_calendar",
                                "boom_tpu/statespace/kalman.py:282")}
CHAIN_T_KERNEL = ("kalman_loglik_wide_chain_t",
                  "boom_tpu/statespace/kalman.py:282")
CAL_D_CHECK = (11, 13, 14, 16)
CAL_CHAIN_CHECK = (33, 4095, 4097)
CAL_T_CHECK = (31, 32, 33, 67)
CAL_LOGLIK_D = (11, 14, 16)
CAL_LOGLIK_T = (33, 67)
# the phase's own T (730 days) at d = 14: K2w at 33 and 4097 chains, K1w
# at phase 10a's 200 draws
CAL_LONG = (14, 730, (33, 4097), 200)

# phase 10a: bsts_monthly, a daily series of two years from 2022-01-01
# (``boom_tpu_torch/data/bsts_monthly.npz``): a semilocal trend (T a
# chain's: phi) and the monthly cycle (T_t at the month boundaries), d = 14
MONTHLY_CHAINS, MONTHLY_BURN, MONTHLY_DRAWS, MONTHLY_SEED = 4096, 200, 200, 0
MONTHLY_SWEEP_CHAINS = 33
MONTHLY_HORIZON, MONTHLY_FORECAST_DRAWS = 30, 200
MONTHLY_MONITOR = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq", "phi",
                   "sigma_monthly_sq")
# The JAX reference's run on the committed data (x64 off, as the bench
# runs), 1024 chains, 200 burn-in + 200 draws, MONTHLY_MONITOR's order,
# and its 30-day forecast (200 thinned draws), from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_monthly.py \
#         bench 1024 200 200 7
# (21.6 minutes on 8 CPU cores). The semilocal trend's variances and phi
# mix slowly at this length (R-hat 1.54-2.76, ESS per draw 0.006-0.009),
# so phase 10a holds each R-hat - 1 to REG_RHAT_FACTOR times the
# reference's + REG_RHAT_SLACK, as phases 6 and 8
REFERENCE_MEDIANS_MONTHLY = {
    "sigsq_obs": 0.08254590630531311,
    "sigma_level_sq": 0.00016404691996285692,
    "sigma_slope_sq": 0.00020187622430967167,
    "phi": -0.46924279630184174,
    "sigma_monthly_sq": 0.0002539601409807801}
REFERENCE_RHAT_MONTHLY = (
    1.0093688345702496, 1.5447145058211385, 1.6335915954196842,
    2.7603490579612413, 1.1695296823383143)
REFERENCE_MIN_ESS_PER_DRAW_MONTHLY = 0.005819261663167369
REFERENCE_FORECAST_MEDIAN_MONTHLY = (
    3.7103981971740723, 3.5804238319396973, 3.5989089012145996,
    3.690261125564575, 3.652127504348755, 3.6727945804595947,
    3.66520619392395, 3.5913124084472656, 3.5909600257873535,
    3.630378484725952, 3.6410093307495117, 3.686866283416748,
    3.672891616821289, 3.657731056213379, 3.629455804824829,
    3.643362522125244, 3.686868667602539, 3.678114652633667,
    3.6548542976379395, 3.698366165161133, 3.6553852558135986,
    3.655183792114258, 3.625905990600586, 3.6755833625793457,
    3.668858528137207, 3.683976888656616, 3.629359722137451,
    3.6804542541503906, 3.6819987297058105, 3.682187557220459)
REFERENCE_FORECAST_SD_MONTHLY = (
    0.30177831649780273, 0.3452497720718384, 0.3010002374649048,
    0.31531521677970886, 0.3373246192932129, 0.3223913908004761,
    0.3303515315055847, 0.3549390733242035, 0.3340877890586853,
    0.3469032347202301, 0.3552541732788086, 0.34870216250419617,
    0.34028077125549316, 0.34739628434181213, 0.30692481994628906,
    0.3138098120689392, 0.33268895745277405, 0.3495287001132965,
    0.35693562030792236, 0.34858444333076477, 0.31571608781814575,
    0.37133461236953735, 0.3344414532184601, 0.35421913862228394,
    0.34700271487236023, 0.3492008447647095, 0.34851494431495667,
    0.3570426404476166, 0.35921499133110046, 0.3428371250629425)
# log_lik and the errors of the forecast's draws against their plain
# versions on the card (float32: the kernels' gate)
MONTHLY_TOL = 1e-4

# phase 10b: bsts_ar_trig, a weekly series of ten years
# (``data/bsts_ar_trig.npz``): a static intercept, an AR(2) (T a chain's:
# phi) and a trigonometric cycle of period 52.18 with two harmonics, d =
# 7, with the TIM move
AR_TRIG_CHAINS, AR_TRIG_BURN, AR_TRIG_DRAWS, AR_TRIG_SEED = 4096, 200, 200, 0
AR_TRIG_SWEEP_CHAINS = 33
AR_TRIG_LL_DRAWS = 200
AR_TRIG_MONITOR = ("sigsq_obs", "phi[0]", "phi[1]", "sigma_ar_sq",
                   "sigma_trig_sq")
# The JAX reference's run (x64 off), 1024 chains, 200 + 200, AR_TRIG_MONITOR's
# order, from
#     PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_state_blocks.py \
#         bench 1024 200 200 7
# (21 minutes on 8 CPU cores), with the TIM proposal the port builds: its
# mode search at the port's template phi, in float64. The reference's own
# template phi is a random draw the port cannot make, and at this length
# the chains mix too slowly (R-hat 2.1-3.7) for the medians to forget the
# proposal; so phase 10b holds each R-hat - 1 to REG_RHAT_FACTOR times the
# reference's + REG_RHAT_SLACK, as phases 6, 8 and 10a
REFERENCE_MEDIANS_AR_TRIG = {
    "sigsq_obs": 0.1405971571803093,
    "phi[0]": 0.6947050094604492,
    "phi[1]": 0.03421629220247269,
    "sigma_ar_sq": 0.17555248737335205,
    "sigma_trig_sq": 7.452513818861917e-05}
REFERENCE_RHAT_AR_TRIG = (
    2.2454157878222105, 3.0988750275272636,
    2.087694334229707, 2.4382910037305114, 3.6788259802691767)
REFERENCE_MIN_ESS_PER_DRAW_AR_TRIG = 0.0054379255948780155

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


def _loglik_rows_vs_plain(rng, dtype, b, series, d, t_len, masked,
                          shared=False):
    """K1 or K1w with its innovations against the plain filter on the card,
    ``b`` systems on ``series`` rows of y (1: one shared series): (worst
    normwise relative error of ll, v and f, max abs error of ll, and with
    ``shared`` whether K1w gave the same bits for T and z one of every
    system expanded over the systems, as Bsts builds them, and
    materialised; else None)."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    params = kt.system(rng, b, d, str(dtype).split(".")[-1])
    if shared:
        params = params._replace(t_mat=params.t_mat[:1].expand(b, d, d),
                                 z=params.z[:1].expand(b, d))
    shape = (series, t_len) if series > 1 else (t_len,)
    y = torch.tensor(rng.normal(size=shape).cumsum(-1), dtype=dtype,
                     device="cuda")
    obs = (torch.tensor(rng.uniform(size=t_len) > 0.2, device="cuda")
           if masked else None)
    got = kk.launch_loglik(params.h, params.rqr, params.z, params.t_mat,
                           params.a0, params.p0, y, obs, innovations=True)
    want = kalman.kalman_loglik(params, y, obs, innovations=True)
    same = None
    if shared:
        flat = kk.launch_loglik(params.h, params.rqr,
                                params.z.contiguous(),
                                params.t_mat.contiguous(), params.a0,
                                params.p0, y, obs, innovations=True)
        same = all(torch.equal(a, w) for a, w in zip(got, flat))
    torch.cuda.synchronize()
    return (max(_rel(a, w) for a, w in zip(got, want)),
            float((got[0] - want[0]).abs().max()), same)


def _loglik_rows_checks(rng):
    """K1 with a series a chain (d in PER_CHAIN_D_CHECK, PER_CHAIN_CHAINS
    chains x TIM_POINTS systems) and K1w (LOGLIK_WIDE_D_CHECK x
    LOGLIK_WIDE_T_CHECK at 33 series, and LOGLIK_WIDE_SERIES), shared and
    a series a system, masked and dense, both dtypes: [failures]."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt

    cases = [(d, c * kt.TIM_POINTS, c, 67, c == 33, False)
             for d in PER_CHAIN_D_CHECK for c in PER_CHAIN_CHAINS]
    cases += [(d, 33, 33 if t_len in (32, 500) else 1, t_len,
               t_len in (31, 33), False)
              for d in LOGLIK_WIDE_D_CHECK for t_len in LOGLIK_WIDE_T_CHECK]
    # K1w's ragged batches with a T a system, and with T and z one of every
    # system (the broadcast layout Bsts gives it)
    cases += [(d, c, c if c == 4095 else 1, 33, c == 4097, shared)
              for d in LOGLIK_WIDE_D_CHECK for c in LOGLIK_WIDE_SERIES[1:]
              for shared in (False, True)]
    bad, worst = [], {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        for d, b, series, t_len, masked, shared in cases:
            err, _abs, same = _loglik_rows_vs_plain(
                rng, dtype, b, series, d, t_len, masked, shared)
            kind = "K1w" if d >= 7 else "K1"
            key = (kind, tag)
            worst[key] = max(worst.get(key, 0.0), err)
            if not (np.isfinite(err) and err <= SCAN_TOL[tag]):
                bad.append(f"{kind} {tag} d={d} B={b} S={series} "
                           f"T={t_len} masked={masked} shared={shared}: "
                           f"{err:.3e}")
            if same is False:
                bad.append(f"{kind} {tag} d={d} B={b}: T and z expanded "
                           f"and materialised give other bits")
    for (kind, tag), v in sorted(worst.items()):
        print(f"{kind} (a series a group of systems, innovations) {tag}: "
              f"worst ll/v/f relative error {v:.3e} over "
              f"{len(cases)} cases (tolerance {SCAN_TOL[tag]:g})")
    return bad


def _jets_vs_plain(rng):
    """J1 and J2 along K directions against autograd of the plain loop on
    the card: directly at d in JET_D_CHECK, K = 3 (T = JET_T, masked and
    dense, one shared series and a series a system) and K at the most
    (T = 64), and through ``torch.autograd`` of ``loglik_along`` in log
    variances at K = 3 (a gradient launches J1, a Hessian J1 and J2).
    Also directly at the main paths' shapes (d = 8, T = REG_T and d = 2,
    T = LLT_T; K = 3, one series). Returns ({check: normwise relative
    error}, {kernel: max abs error at phase 7's shape})."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.kernels.host_rehearsal import directions
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    errs, max_abs = {}, {}

    def direct(d, k, b, series, t_len, masked):
        params = kt.system(rng, b, d, "float64")
        shape = (series, t_len) if series > 1 else (t_len,)
        y = torch.tensor(rng.normal(size=shape).cumsum(-1),
                         dtype=torch.float64, device="cuda")
        obs = (torch.tensor(rng.uniform(size=t_len) > 0.2, device="cuda")
               if masked else None)
        dirs = [x.to("cuda") for x in directions(rng, k, d)]
        fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
                  params.a0, params.p0, y, obs, *dirs)
        out = {}
        for order in (1, 2):
            got = kk.launch_jets(*fields, order=order)
            want = kalman.loglik_jets(*fields, order)
            out[kk.JET_KINDS[order]] = (
                max(_rel(a, w) for a, w in zip(got, want)),
                float((got[-1] - want[-1]).abs().max()))
        return out

    for d in JET_D_CHECK:
        for k, b, series, t_len, masked in (
                (kt.TIM_GROUPS, 3, 1, JET_T, False),
                (kt.TIM_GROUPS, 3, 3, JET_T, True),
                (kk.JET_MAX_DIRECTIONS, 1, 1, 64, True)):
            for kind, (err, _abs) in direct(d, k, b, series, t_len,
                                            masked).items():
                errs[f"{kind} d={d} K={k} S={series} masked={masked}"] = err
        params = kt.system(rng, 1, d, "float64")
        y = torch.tensor(rng.normal(size=JET_T).cumsum(),
                         dtype=torch.float64, device="cuda")
        dh, dm = (x.to("cuda") for x in directions(rng, kt.TIM_GROUPS, d))
        h0, q0 = 0.5 * params.h, 0.5 * params.rqr

        def lp(fn, u):
            return fn(torch.exp(u)[None], h0, q0, dh, dm, params.z,
                      params.t_mat, params.a0, params.p0, y)[0]

        u0 = torch.linspace(-1.0, 0.2, kt.TIM_GROUPS, dtype=torch.float64,
                            device="cuda")
        res = []
        for fn in (kk.loglik_along, kalman.loglik_along):
            before = dict(kk.LAUNCHES)
            u = u0.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(lp(fn, u), u)
            after_grad = dict(kk.LAUNCHES)
            hess = torch.autograd.functional.hessian(
                lambda x, fn=fn: lp(fn, x), u0)
            res.append((g, hess))
            if fn is kk.loglik_along:
                kinds = ("loglik", "loglik_wide", *kk.JET_KINDS.values())
                launched = [{k: b[k] - a[k] for k in kinds}
                            for a, b in ((before, after_grad),
                                         (after_grad, kk.LAUNCHES))]
                check(launched == [
                    {"loglik": 0, "loglik_wide": 0, "loglik_grad": 1,
                     "loglik_hess": 0},
                    {"loglik": 0, "loglik_wide": 0, "loglik_grad": 1,
                     "loglik_hess": 1}],
                    f"a gradient and a Hessian launched {launched}, not "
                    "J1, then J1 and J2")
        errs[f"autograd gradient d={d}"] = _rel(res[0][0], res[1][0])
        errs[f"autograd Hessian d={d}"] = _rel(res[0][1], res[1][1])
    # the main paths' shapes, B = 1: phase 7's proposal build (d = 8) and
    # phase 4's (bsts_llt, d = 2), K = 3, T = 500
    for d, t_len, path in ((8, REG_T, "phase 7"), (2, LLT_T, "phase 4")):
        for kind, (err, err_abs) in direct(d, kt.TIM_GROUPS, 1, 1, t_len,
                                           False).items():
            errs[f"{kind} d={d} K={kt.TIM_GROUPS} T={t_len} ({path})"] = err
            if d == 8:
                max_abs[kind] = err_abs
    return errs, max_abs


def phase2b_kalman_vs_plain():
    """K1 and K2 against their plain versions over KALMAN_T_CHECK and at
    the bsts_llt width; K1 with a series a chain and K1w with their
    innovations; J1 and J2 along directions; determinism; times. Returns
    the rows' numbers per kernel (K1, K2 at the bsts_llt shapes; K1w, J1,
    J2 at phase 7's)."""
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

    bad = _loglik_rows_checks(rng)
    check(not bad, "K1 / K1w with a series a group disagree with the plain "
          "filter: " + "; ".join(bad))
    # phase 7's main path width: K1w over 4096 chains x 17 points, each
    # chain's points on its own series: a T a system, and T and z one of
    # every system as Bsts builds them (the main path's layout; the same
    # bits as the systems materialised)
    tag, batch, d, t_len, series = kt.TIM_REG_SHAPES["loglik_wide"]
    for shared in (False, True):
        err, err_abs, same = _loglik_rows_vs_plain(
            rng, getattr(torch, tag), batch, series, d, t_len, False, shared)
        print(f"K1w {tag} B={batch} S={series} d={d} T={t_len} (phase 7, "
              f"{'T and z shared' if shared else 'a T a system'}): "
              f"rel {err:.2e} abs {err_abs:.2e}"
              + (f", expanded and materialised bit-identical {same}"
                 if shared else ""))
        check(np.isfinite(err) and err <= SCAN_TOL[tag] and same is not False,
              f"K1w at phase 7's width (shared={shared}): {err:.3e}, "
              f"bit-identical {same}")
    at_llt["loglik_wide"] = {"max_abs_err": err_abs}

    errs, max_abs = _jets_vs_plain(rng)
    print("J1, J2 along directions vs autograd of the plain loop (f64): "
          + ", ".join(f"{k} rel {v:.2e}" for k, v in errs.items())
          + f" (tolerance {DERIV_TOL:g})")
    bad = [f"{k}: {v:.3e}" for k, v in errs.items()
           if not (np.isfinite(v) and v <= DERIV_TOL)]
    check(not bad, "loglik derivatives disagree: " + "; ".join(bad))
    for kind, err in max_abs.items():
        at_llt[kind] = {"max_abs_err": err}

    same = {}
    shapes = {**{k: (*v, 1) for k, v in kt.SHAPES.items()},
              **kt.TIM_REG_SHAPES}
    for name, (tag, batch, d, t_len, series) in shapes.items():
        kern = kt.kalman_cases(rng, name, tag, batch, d, t_len, series)[0]
        first = kern()
        first = first if isinstance(first, tuple) else (first,)
        same[name] = True
        for _ in range(9):
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            same[name] &= all(torch.equal(a, b)
                              for a, b in zip(first, again))
    torch.cuda.synchronize()
    print("ten repeated launches at the bsts_llt and phase 7 shapes "
          "bit-identical: "
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
        floor = (f"latency floor {r['floor_ms']:.4f} ms, "
                 if "floor_ms" in r else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, "
              f"{wrap}plain {plain}, {bound}{floor}one call on the host "
              f"clock {r['call_ms']:.4f} ms" + (f"; blocks: {blocks}"
                                                if blocks else ""))
        # the rows: K1, K2 at the bsts_llt shapes; K1w, J1, J2 at phase 7's
        row = {"loglik_grad_wide": "loglik_grad",
               "loglik_hess_wide": "loglik_hess"}.get(name, name)
        if row in at_llt and name not in ("loglik_grad", "loglik_hess"):
            at_llt[row].update({k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by")})
    from boom_tpu_torch.kernels import _build

    reports = {}
    for source, read in (("kalman_seq", kt.nvcc_report),
                         ("kalman_wide", kt.wide_nvcc_report)):
        log = _build.log_path(source)
        if log.exists():
            reports.update(read(log.read_text()))
    for inst, rep in reports.items():
        if inst.startswith(("loglik", "smoother ")):
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
                   sweeps=None, top=0):
    """Host time of each sweep phase (its profiler range
    "<prefix>.<phase>") and the device's kernel time over a few sweeps
    under ``torch.profiler``: ({phase: ms a sweep}, wall ms a sweep, device
    kernel ms a sweep). With ``top``, prints the operators with the most
    host time of their own."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sweeps = PROFILE_SWEEPS if sweeps is None else sweeps
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
    print(f"{label} sweep profile ({PROFILE_SWEEPS} sweeps under "
          f"torch.profiler): wall "
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
    # drawn on the card (numpy's draw of 4097 x 3 x 499 x 16 normals took
    # seconds a case)
    gen = torch.Generator(device="cuda").manual_seed(
        int(rng.integers(1 << 62)))
    w = torch.randn((c, groups, t_len - 1, d), generator=gen,
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
    return launches, r["rhat"]


def phase7_bsts_reg_tim(card, rhat_without):
    """Config #5 with the TIM move at full width: the proposal built
    through J1 and J2, then REG_CHAINS chains x (REG_BURN + REG_DRAWS)
    sweeps through K1w (the move's points), K2w, K3 and kernel (a)'s
    per-chain entry, gated against the reference's run with the move;
    then log_lik and the in-sample and holdout prediction errors of
    TIM_REG_DRAWS draws. ``rhat_without``: phase 6's R-hat (the same model
    without the move). Returns the kernels' launch counts of the main
    path (the build and the run)."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.models.glm import ssvs_kernel as ssk
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk
    from boom_tpu_torch.statespace.bsts import SWEEP_PHASES

    t_phase = time.perf_counter()
    x_all, _y_np, x, y = _reg_data()
    for counts in (kk.LAUNCHES, sk.LAUNCHES, ssk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = _reg_model(x, y, REG_CHAINS, marginal_sigma_slice=True,
                       marginal_move="tim",
                       marginal_tim_trials=TIM_REG_TRIALS)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    mode, chol = model._tim_prop
    print(f"bsts_reg TIM proposal built in {build_s:.2f} s "
          f"({kk.LAUNCHES['loglik_grad']} J1, {kk.LAUNCHES['loglik_hess']} "
          f"J2 launches): mode {mode.tolist()}, chol diagonal "
          f"{chol.diag().tolist()}")
    check(len(model._sigma_groups()) == 3
          and kk.LAUNCHES["loglik_grad"] >= 1
          and kk.LAUNCHES["loglik_hess"] >= 1,
          f"the proposal did not go through the jets: {kk.LAUNCHES}")
    gen = prng.generator(TIM_REG_SEED, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   REG_DRAWS, generator=gen, num_chains=REG_CHAINS,
                   burn=REG_BURN, extract=_reg_extract)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = {"loglik_wide": kk.LAUNCHES["loglik_wide"],
                "loglik_grad": kk.LAUNCHES["loglik_grad"],
                "loglik_hess": kk.LAUNCHES["loglik_hess"],
                "smoother_wide": kk.LAUNCHES["smoother_wide"],
                "dpath": kk.LAUNCHES["dpath"],
                "ssvs_sweep_border": ssk.LAUNCHES["ssvs_sweep_border"]}
    others = {k: v for k, v in {**kk.LAUNCHES, **sk.LAUNCHES,
                                **ssk.LAUNCHES}.items()
              if k not in launches and v}
    sweeps = REG_BURN + REG_DRAWS
    print(f"bsts_reg TIM: T={REG_T} d=8 p={REG_P} chains={REG_CHAINS} "
          f"burn={REG_BURN} draws={REG_DRAWS} trials={TIM_REG_TRIALS} in "
          f"{elapsed:.2f} s; launches {launches}, other kernels {others}")
    check(launches["loglik_wide"] >= sweeps
          and launches["smoother_wide"] >= sweeps + 1
          and launches["dpath"] >= sweeps
          and launches["ssvs_sweep_border"] >= sweeps,
          f"the bsts_reg TIM run did not go through its kernels: {launches}")

    d = res.draws
    tr, se = d["blocks"]["trend"], d["blocks"]["seasonal_7"]
    finite = all(bool(torch.isfinite(v.float()).all())
                 for v in (d["sigsq_obs"], d["beta"], d["alpha"],
                           *tr.values(), *se.values()))
    check(finite, "non-finite bsts_reg TIM draws")
    mon = torch.cat([torch.stack([d["sigsq_obs"], tr["sigma_level_sq"],
                                  tr["sigma_slope_sq"],
                                  se["sigma_seasonal_sq"]], dim=-1),
                     d["beta"][..., :4]], dim=-1).double()
    ess = diagnostics.effective_sample_size(mon).cpu().numpy()
    rhat = diagnostics.potential_scale_reduction(mon).cpu().numpy()
    per_draw = ess / (REG_CHAINS * REG_DRAWS)
    med = mon.reshape(-1, len(REG_MONITOR)).median(0).values.cpu().numpy()
    gates = []
    for i, name in enumerate(REG_MONITOR):
        ref = REFERENCE_MEDIANS_TIM_REG[name]
        print(f"bsts_reg TIM {name}: median {med[i]:.6g} (reference "
              f"{ref:.6g}, ratio {med[i] / ref:.4f}) rhat {rhat[i]:.4f} "
              f"(reference's {REFERENCE_RHAT_TIM_REG[i]:.4f}; phase 6, "
              f"without the move, {rhat_without[i]:.4f}) ess per draw "
              f"{per_draw[i]:.5f}")
        if name.startswith("beta"):
            gates.append((rhat[i] < RHAT_GATE,
                          f"bsts_reg TIM R-hat of {name} {rhat[i]:.4f} >= "
                          f"{RHAT_GATE}"))
        else:
            limit = (1.0 + REG_RHAT_FACTOR
                     * (REFERENCE_RHAT_TIM_REG[i] - 1.0) + REG_RHAT_SLACK)
            gates.append((rhat[i] <= limit,
                          f"bsts_reg TIM R-hat of {name} {rhat[i]:.4f} > "
                          f"{limit:.4f} (the reference's "
                          f"{REFERENCE_RHAT_TIM_REG[i]:.4f})"))
        tol = REG_BETA_TOL if name.startswith("beta") else REG_VARIANCE_TOL
        gates.append((abs(med[i] / ref - 1.0) <= tol,
                      f"bsts_reg TIM median of {name} {med[i]:.5g} is not "
                      f"within {tol:.0%} of the reference's {ref:.5g}"))
    min_per_draw = float(per_draw.min())
    gates.append((min_per_draw >= 0.5 * REFERENCE_MIN_ESS_PER_DRAW_TIM_REG,
                  f"bsts_reg TIM min-ESS per draw {min_per_draw:.5f} is "
                  f"below half the reference's "
                  f"{REFERENCE_MIN_ESS_PER_DRAW_TIM_REG:.5f}"))
    lifted = all(rhat[i] < rhat_without[i] for i in (1, 2))
    print(f"bsts_reg TIM rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, "
          f"min-ESS {float(ess.min()):.1f} ({min_per_draw:.5f} a draw, the "
          f"reference's {REFERENCE_MIN_ESS_PER_DRAW_TIM_REG:.5f}), min-ESS/s "
          f"{float(ess.min()) / elapsed:.2f}, proposal build "
          f"{build_s:.2f} s")
    print(f"bsts_reg TIM finding: the move "
          f"{'lifts' if lifted else 'does not lift'} the level and slope "
          f"variances' R-hat: {rhat[1]:.4f} / {rhat[2]:.4f} with it, "
          f"{rhat_without[1]:.4f} / {rhat_without[2]:.4f} without it "
          "(phase 6)")
    _print_profile(f"bsts_reg TIM [{card}]", *_phase_profile(
        model, res.final_state, gen, REG_CHAINS, "bsts", SWEEP_PHASES))

    # log_lik and the errors of TIM_REG_DRAWS draws, against their plain
    # versions on the card
    fit = BstsModel(_model=model, _result=res)
    t2 = time.perf_counter()
    sub = fit._subsampled_states(0, TIM_REG_DRAWS)
    before = dict(kk.LAUNCHES)
    ll = model.log_lik(sub)
    errs = fit.prediction_errors(cutpoints=[TIM_REG_CUTPOINT],
                                 max_draws=TIM_REG_DRAWS)
    torch.cuda.synchronize()
    pe_s = time.perf_counter() - t2
    ran = {k: kk.LAUNCHES[k] - before[k] for k in ("loglik_wide",
                                                    "loglik_grad")}
    want = kalman.kalman_loglik(model.ssm_params(sub),
                                model.adjusted_series(sub),
                                innovations=True)
    ll_err = _rel(ll.double(), want[0].double())
    pe_err = _rel(errs["in.sample"].double(),
                  (want[1] / torch.sqrt(want[2])).double())
    held = errs[str(TIM_REG_CUTPOINT)]
    hold = held[:, TIM_REG_CUTPOINT:].double()
    print(f"bsts_reg TIM log_lik and prediction_errors(cutpoints="
          f"[{TIM_REG_CUTPOINT}]) of {TIM_REG_DRAWS} draws in {pe_s:.2f} s "
          f"(launches {ran}): log_lik rel {ll_err:.2e}, in-sample errors rel "
          f"{pe_err:.2e} (tolerance {TIM_REG_TOL:g}); holdout "
          f"{tuple(held.shape)}, past the cutpoint mean "
          f"{float(hold.mean()):.4f} sd {float(hold.std()):.4f}")
    gates += [
        (np.isfinite(ll_err) and ll_err <= TIM_REG_TOL,
         f"log_lik is {ll_err:.3e} off its plain version"),
        (np.isfinite(pe_err) and pe_err <= TIM_REG_TOL,
         f"the in-sample errors are {pe_err:.3e} off their plain version"),
        (ran["loglik_wide"] >= 2 and ran["loglik_grad"] >= 1,
         f"log_lik and the errors did not run through K1w, J1: {ran}"),
        (tuple(held.shape) == (min(TIM_REG_DRAWS, TIM_REG_REFIT_DRAWS),
                               REG_T)
         and bool(torch.isfinite(held).all()),
         f"the holdout errors are {tuple(held.shape)} or not finite")]
    print(f"phase 7 took {time.perf_counter() - t_phase:.1f} s")
    for ok, msg in gates:
        check(ok, msg)
    return launches


def _tv_vs_plain(rng, dtype, d, t_len, q_mode, b, series, t_kind="chain"):
    """The time-varying forms of K1 / K1w (with the innovations) and, in
    float64, K2 / K2w against their plain versions on one time-varying
    system (``kalman_timing.time_varying_system`` with its T of
    ``t_kind``), masked: ({kernel: (rel, abs)}); K2w's key is its form's
    (a T a system: "smoother_wide_tv_dense")."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    tag = str(dtype).split(".")[-1]
    params = kt.time_varying_system(rng, b, d, t_len, tag, q_mode,
                                    t_kind=t_kind)
    y = torch.tensor(rng.normal(size=(series, t_len)).cumsum(-1),
                     dtype=dtype, device="cuda")
    obs = torch.tensor(rng.uniform(size=t_len) > 0.2, device="cuda")
    wide = d in (7, 8, 9, 10, 11, 12, 13, 14, 15, 16)
    out = {}
    key = "loglik_wide_tv" if wide else "loglik_tv"
    before = kk.LAUNCHES[key]
    got = kk.launch_loglik_tv(params, y, obs, innovations=True)
    want = kalman.kalman_loglik(params, y, obs, innovations=True)
    check(kk.LAUNCHES[key] == before + 1,
          f"d={d} T={t_kind}: the loglik did not take {key}")
    out[key] = (max(_rel(g, w) for g, w in zip(got, want)),
                max(float((g - w).abs().max()) for g, w in zip(got, want)))
    if dtype == torch.float64:
        q = params.q_mat.shape[-1]
        normals = [torch.tensor(rng.normal(size=sh), dtype=dtype,
                                device="cuda")
                   for sh in ((b, d), (b, t_len - 1, q), (b, t_len))]
        y1 = y[0] if series != b else y
        before = dict(kk.LAUNCHES)
        got = kk.simulation_smoother(params, y1, *normals, observed=obs)
        want = kalman.simulation_smoother(params, y1, *normals,
                                          observed=obs)
        key = ("smoother_tv" if not wide else "smoother_wide_tv_dense"
               if t_kind == "chain" else "smoother_wide_tv")
        check(kk.LAUNCHES[key] == before[key] + 1,
              f"d={d} T={t_kind}: the smoother did not take {key}")
        out[key] = (_rel(got, want), float((got - want).abs().max()))
    return out


def phase2e_tv_vs_plain():
    """K1, K1w, K2 and K2w in their time-varying forms against their plain
    versions (d in TV_D_CHECK, T in TV_T_CHECK, q_t a system, one for all
    or none, a mask, float64 and float32), at phase 8's shapes
    (``kalman_timing.TV_SHAPES``), ten launches bit-identical there, and
    their times beside bounds and plain times. Returns the rows' numbers."""
    import torch

    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.kernels import kalman_timing as kt

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20261020)
    bad, worst = [], {}
    cases = [(dtype, d, t_len, q_mode, b, series, "chain")
             for dtype in (torch.float64, torch.float32)
             for d in TV_D_CHECK for t_len in TV_T_CHECK
             for q_mode in TV_Q_CHECK for b, series in ((33, 11), (257, 1))]
    cases += [(dtype, d, t_len, q_mode, b, series, t_kind)
              for dtype in (torch.float64, torch.float32)
              for d in TV_D_CHECK
              for t_kind in (TV_SHARED_T if d >= 7 else ("bsts",))
              for t_len in TV_T_CHECK for q_mode in TV_Q_CHECK
              for b, series in ((33, 11), (257, 1))]
    chains, d_r, t_r = TV_RAGGED
    cases += [(torch.float64, d_r, t_r, "chain", chains, 1, t_kind)
              for t_kind in ("bsts", "chain")]
    for dtype, d, t_len, q_mode, b, series, t_kind in cases:
        tag = str(dtype).split(".")[-1]
        res = _tv_vs_plain(rng, dtype, d, t_len, q_mode, b, series, t_kind)
        for k, (rel, _abs) in res.items():
            worst[(k, tag)] = max(worst.get((k, tag), 0.0), rel)
            if not (np.isfinite(rel) and rel <= SCAN_TOL[tag]):
                bad.append(f"{k} {tag} d={d} T={t_len} q={q_mode} B={b} "
                           f"T's kind {t_kind}: {rel:.3e}")
    for (k, tag), v in sorted(worst.items()):
        print(f"worst {k} {tag} over d {TV_D_CHECK}, T {TV_T_CHECK}, q_t "
              f"{TV_Q_CHECK}, T's kinds (chain,) + {TV_SHARED_T} at d >= 7 "
              f"and (chain, bsts) below, {TV_RAGGED[0]} chains at d = "
              f"{TV_RAGGED[1]}: {v:.3e} (tolerance {SCAN_TOL[tag]:g})")
    check(not bad, "a time-varying kernel disagrees with its plain version: "
          + "; ".join(bad[:20]))

    at_tv, same = {}, {}
    for name, (tag, batch, d, t_len, series, t_kind) in kt.TV_SHAPES.items():
        kern, ref, _wrapper = kt.tv_cases(rng, name, tag, batch, d, t_len,
                                          series, t_kind=t_kind)
        first, want = kern(), ref()
        first = first if isinstance(first, tuple) else (first,)
        want = want if isinstance(want, tuple) else (want,)
        rel = max(_rel(g.double(), w.double()) for g, w in zip(first, want))
        at_tv[name] = {"max_abs_err": max(float((g - w).abs().max())
                                          for g, w in zip(first, want))}
        print(f"{name} {tag} B={batch} d={d} T={t_len} S={series} T's kind "
              f"{t_kind} (phase 8's shape): rel {rel:.2e} abs "
              f"{at_tv[name]['max_abs_err']:.2e}")
        check(np.isfinite(rel) and rel <= SCAN_TOL[tag],
              f"{name} at phase 8's shape: {rel:.3e}")
        same[name] = True
        for _ in range(9):
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            same[name] &= all(torch.equal(a, b) for a, b in zip(first,
                                                                  again))
    torch.cuda.synchronize()
    print("ten repeated launches at phase 8's shapes bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"repeated launches differ: {same}")

    for name, r in kt.time_tv(rng).items():
        plain = ("not timed" if r["plain_ms"] is None
                 else f"{r['plain_ms']:.4f} ms")
        floor = (f", latency floor {r['floor_ms']:.4f} ms"
                 if "floor_ms" in r else "")
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, whole "
              f"wrapper {r['wrapper_ms']:.4f} ms, plain {plain}, bound "
              f"{r['bound_ms']:.6f} ms ({r['bound_by']}; every entry of T "
              f"counted {r['bound_dense_ms']:.6f} ms){floor}; one call on "
              f"the host clock {r['call_ms']:.4f} ms")
        if r.get("pass_ms"):
            print(f"time {name} by pass (profiler, device ms a call): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in sorted(r["pass_ms"].items())))
        if name in at_tv:
            at_tv[name].update({k: r[k] for k in ("ms", "plain_ms",
                                                  "bound_ms", "bound_by")})
    for source, read in (("kalman_seq", kt.nvcc_report),
                         ("kalman_wide", kt.wide_nvcc_report)):
        log = _build.log_path(source)
        if log.exists():
            for inst, rep in read(log.read_text()).items():
                if " tv" in inst or inst.startswith("loglik_tv"):
                    print(f"nvcc {inst}: {rep['registers']} registers, "
                          f"{rep['spill_bytes']} bytes spill stores, "
                          f"{rep['stack_bytes']} bytes stack")
    print(f"phase 2e took {time.perf_counter() - t_phase:.1f} s")
    return at_tv


def _tv_builder(raw, small=False):
    """bsts_tv's model as a user builds it: ``BstsModel()
    .add_student_local_linear_trend().add_seasonal(7)
    .add_dynamic_regression(x_dyn).add_random_walk_holiday(active, 3)``
    (``small``: the Student trend and the dynamic regression, d = 4)."""
    from boom_tpu_torch import data
    from boom_tpu_torch.api import BstsModel

    g = data.BSTS_TV_GRID
    model = BstsModel().add_student_local_linear_trend()
    if not small:
        model = model.add_seasonal(7)
    model = model.add_dynamic_regression(raw["x_dyn"][:g])
    if not small:
        model = model.add_random_walk_holiday(raw["active"][:g],
                                              data.BSTS_TV_WINDOW)
    return model


def _tv_future_z(raw):
    """The forecast's rows of the time-varying blocks: the dynamic
    regression's future predictors, the holiday's one-hot future days."""
    from boom_tpu_torch import data

    g = data.BSTS_TV_GRID
    act = raw["active"][g:]
    return {"dynamic_regression": raw["x_dyn"][g:],
            "holiday": np.where((act >= 0)[:, None],
                                np.eye(data.BSTS_TV_WINDOW)[
                                    np.maximum(act, 0)], 0.0)}


def _tv_extract(state):
    """bsts_tv's draws: the variances, nu and the Student weights (the
    forecast and log_lik read them), the regression and the last row of
    the state."""
    return {"sigsq_obs": state["sigsq_obs"],
            "blocks": {name: dict(v) for name, v in state["blocks"].items()},
            "beta": state["beta"], "gamma": state["gamma"],
            "alpha": state["alpha"][:, -1:]}


def _tv_sweep_vs_cpu(raw):
    """One float64 sweep (init included) of TV_SWEEP_CHAINS chains of
    bsts_tv's model on the card against the CPU's on the same noise:
    (chains whose masks agree, worst relative difference over them)."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference.driver import tree_map

    c = TV_SWEEP_CHAINS
    out, models = {}, {}
    gen = prng.generator(3, "cpu")
    for device in ("cpu", "cuda"):
        fit = _tv_builder(raw).fit(
            raw["y"], predictors=raw["x"], timestamps=raw["timestamps"],
            niter=1, burn=0, num_chains=1, seed=0, device=device,
            dtype=torch.float64)
        models[device] = fit._model
        if device == "cpu":
            init_noise = models[device].draw_init_noise(gen, c)
            noise = models[device].draw_noise(gen, c)
        moved = [tree_map(lambda t, dev=device: t.to(dev), n)
                 for n in (init_noise, noise)]
        state = models[device].init_state(moved[0])
        state = models[device].kernel()(moved[1], state)
        out[device] = tree_map(lambda t: t.cpu(), state)
    agree = (out["cuda"]["gamma"] == out["cpu"]["gamma"]).all(-1)
    errs = []
    tree_map(lambda a, b: errs.append(_rel(a[agree].double(),
                                           b[agree].double())),
             out["cuda"], out["cpu"])
    return int(agree.sum()), max(errs)


def _tv_small_path(raw):
    """The d = 4 model (a Student trend and the dynamic regression) on the
    card through the front end: TV_SMALL chains and sweeps, then log_lik
    and the in-sample errors of its draws; it runs K2's and K1's
    time-varying forms. Returns (launches, log_lik and errors' relative
    difference from the plain filter)."""
    import torch

    from boom_tpu_torch.statespace import bsts as pbsts
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    chains, burn, draws = TV_SMALL
    for k in kk.LAUNCHES:
        kk.LAUNCHES[k] = 0
    fit = _tv_builder(raw, small=True).fit(
        raw["y"], predictors=raw["x"], timestamps=raw["timestamps"],
        niter=draws, burn=burn, num_chains=chains, seed=2)
    model = fit._model
    sub = fit._subsampled_states(0, TV_FORECAST_DRAWS)
    ll = model.log_lik(sub)
    errs = pbsts.one_step_prediction_errors(model, sub)
    torch.cuda.synchronize()
    launches = dict(kk.LAUNCHES)
    check(model.state_dim == 4, f"the small model's d = {model.state_dim}")
    want = kalman.kalman_loglik(model.ssm_params(sub),
                                model.adjusted_series(sub), model.observed,
                                innovations=True)
    err = max(_rel(ll.double(), want[0].double()),
              _rel(errs.double(), (want[1] / torch.sqrt(want[2])).double()))
    return launches, err


def phase8_bsts_tv(card):
    """bsts_tv at full width on its committed data, fit with its
    timestamps through the front end: a Student trend, a 7-day cycle, the
    dynamic regression and the holiday (d = 13) with a spike-and-slab
    regression (p = 20); one float64 sweep of 33 chains against the
    CPU's; TV_CHAINS chains x (TV_BURN + TV_DRAWS) sweeps through K2w's
    time-varying form, K3 and kernel (a)'s per-chain entry, gated against
    the reference's run; the forecast with the future predictors and
    holiday days; log_lik and prediction_errors(cutpoints=[TV_CUTPOINT])
    of TV_FORECAST_DRAWS draws through K1w's time-varying form; then the
    d = 4 model through K2's and K1's. Returns the kernels' launch
    counts of the main paths."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.inference import diagnostics
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.models.glm import ssvs_kernel as ssk
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk
    from boom_tpu_torch.statespace.bsts import SWEEP_PHASES

    t_phase = time.perf_counter()
    raw = data.bsts_tv()
    g = data.BSTS_TV_GRID

    # the front end on its default device (the card), briefly
    t0 = time.perf_counter()
    fit = _tv_builder(raw).fit(raw["y"], predictors=raw["x"],
                               timestamps=raw["timestamps"], niter=10,
                               burn=5, num_chains=64, seed=1)
    model = fit._model
    fcast = fit.predict(horizon=data.BSTS_TV_HORIZON,
                        future_z=_tv_future_z(raw),
                        future_predictors=raw["x_future"], max_draws=50)
    torch.cuda.synchronize()
    gaps = int((~model.observed).sum())
    dup = int((model.obs_weights > 1).sum())
    print(f"bsts_tv front end on the card: fit (64 chains, 5 + 10 sweeps) "
          f"and predict in {time.perf_counter() - t0:.2f} s; grid T={g}, "
          f"{raw['y'].shape[0]} observations, {gaps} gaps, {dup} days "
          f"observed twice, d={model.state_dim}, p={model.num_predictors}")
    check(model.y.device.type == "cuda" and model.time_varying
          and model.state_dim == 13 and model.t_len == g and gaps > 0
          and dup > 0, "the bsts_tv front end did not build its model on "
          "the card")
    check(tuple(fcast.shape) == (50, data.BSTS_TV_HORIZON)
          and bool(torch.isfinite(fcast).all()), "front-end forecast")

    n_agree, worst = _tv_sweep_vs_cpu(raw)
    print(f"bsts_tv float64 sweep C={TV_SWEEP_CHAINS}: card vs CPU masks "
          f"agree on {n_agree} chains, worst relative difference there "
          f"{worst:.3e} (tolerance {SWEEP_TOL:g})")
    check(np.isfinite(worst) and worst <= SWEEP_TOL,
          f"the bsts_tv sweep on the card disagrees: {worst:.3e}")
    check(n_agree >= TV_SWEEP_CHAINS - 1,
          f"the bsts_tv masks agree on {n_agree} chains")

    for counts in (kk.LAUNCHES, sk.LAUNCHES, ssk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    gen = prng.generator(TV_SEED, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda gn, c: model.init_state(model.draw_init_noise(gn,
                                                                        c)),
                   TV_DRAWS, generator=gen, num_chains=TV_CHAINS,
                   burn=TV_BURN, extract=_tv_extract)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = {"smoother_wide_tv": kk.LAUNCHES["smoother_wide_tv"],
                "smoother_wide_tv_dense":
                    kk.LAUNCHES["smoother_wide_tv_dense"],
                "dpath": kk.LAUNCHES["dpath"],
                "ssvs_sweep_border": ssk.LAUNCHES["ssvs_sweep_border"]}
    others = {k: v for k, v in {**kk.LAUNCHES, **sk.LAUNCHES,
                                **ssk.LAUNCHES}.items()
              if k not in launches and v}
    sweeps = TV_BURN + TV_DRAWS
    print(f"bsts_tv: T={g} d=13 p={model.num_predictors} chains={TV_CHAINS} "
          f"burn={TV_BURN} draws={TV_DRAWS} in {elapsed:.2f} s; launches "
          f"{launches}, other kernels {others}")
    print(f"bsts_tv: {launches['smoother_wide_tv']} of the run's "
          f"{sweeps + 1} smoother launches over T's non-zeros (K2w's "
          f"structured form), {launches['smoother_wide_tv_dense']} in its "
          f"dense form")
    check(launches["smoother_wide_tv"] == sweeps + 1
          and launches["smoother_wide_tv_dense"] == 0
          and launches["dpath"] >= sweeps
          and launches["ssvs_sweep_border"] >= sweeps and not others,
          f"the bsts_tv run did not go through its kernels (each of its "
          f"{sweeps + 1} smoother launches in K2w's structured form): "
          f"{launches}, {others}")

    d = res.draws
    b = d["blocks"]
    tr = b["student_trend"]
    cols = [d["sigsq_obs"], tr["sigma_level_sq"], tr["sigma_slope_sq"],
            tr["nu_level"], tr["nu_slope"],
            b["seasonal_7"]["sigma_seasonal_sq"],
            b["dynamic_regression"]["sigma_dynreg_sq"][..., 0],
            b["dynamic_regression"]["sigma_dynreg_sq"][..., 1],
            b["holiday"]["sigma_holiday_sq"]]
    mon = torch.cat([torch.stack(cols, dim=-1), d["beta"][..., :4]],
                    dim=-1).double()
    finite = bool(torch.isfinite(mon).all()) and all(
        bool(torch.isfinite(v.float()).all())
        for v in (d["alpha"], tr["w_level"], tr["w_slope"]))
    check(finite, "non-finite bsts_tv draws")
    ess = diagnostics.effective_sample_size(mon).cpu().numpy()
    rhat = diagnostics.potential_scale_reduction(mon).cpu().numpy()
    per_draw = ess / (TV_CHAINS * TV_DRAWS)
    med = mon.reshape(-1, len(TV_MONITOR)).median(0).values.cpu().numpy()
    inclusion = d["gamma"].double().mean((0, 1)).cpu().numpy()
    gates = []
    for i, name in enumerate(TV_MONITOR):
        ref = REFERENCE_MEDIANS_TV[name]
        limit = (1.0 + REG_RHAT_FACTOR * (REFERENCE_RHAT_TV[i] - 1.0)
                 + REG_RHAT_SLACK)
        print(f"bsts_tv {name}: median {med[i]:.6g} (reference {ref:.6g}, "
              f"ratio {med[i] / ref:.4f}) rhat {rhat[i]:.4f} (reference's "
              f"{REFERENCE_RHAT_TV[i]:.4f}, limit {limit:.4f}) ess per draw "
              f"{per_draw[i]:.5f}")
        gates.append((rhat[i] <= limit,
                       f"bsts_tv R-hat of {name} {rhat[i]:.4f} > {limit:.4f} "
                       f"(the reference's {REFERENCE_RHAT_TV[i]:.4f})"))
        tol = REG_BETA_TOL if name.startswith("beta") else REG_VARIANCE_TOL
        gates.append((abs(med[i] / ref - 1.0) <= tol,
                      f"bsts_tv median of {name} {med[i]:.5g} is not within "
                      f"{tol:.0%} of the reference's {ref:.5g}"))
    min_per_draw = float(per_draw.min())
    gates.append((min_per_draw >= 0.5 * REFERENCE_MIN_ESS_PER_DRAW_TV,
                  f"bsts_tv min-ESS per draw {min_per_draw:.5f} is below half "
                  f"the reference's {REFERENCE_MIN_ESS_PER_DRAW_TV:.5f}"))
    gates.append((bool((inclusion[:4] >= REG_MIN_INCLUSION).all()),
                  f"bsts_tv inclusion of columns 0-3 {inclusion[:4].tolist()}"))
    print("bsts_tv inclusion probabilities: "
          + ", ".join(f"{v:.4f}" for v in inclusion))
    print(f"bsts_tv rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, min-ESS "
          f"{float(ess.min()):.1f} ({min_per_draw:.5f} a draw, the "
          f"reference's {REFERENCE_MIN_ESS_PER_DRAW_TV:.5f}), min-ESS/s "
          f"{float(ess.min()) / elapsed:.2f}, max R-hat "
          f"{float(rhat.max()):.4f}")
    _print_profile(f"bsts_tv [{card}]", *_phase_profile(
        model, res.final_state, gen, TV_CHAINS, "bsts", SWEEP_PHASES))

    # the forecast, log_lik and the errors of TV_FORECAST_DRAWS draws
    fit = BstsModel(_model=model, _result=res)
    t2 = time.perf_counter()
    fcast = fit.predict(horizon=data.BSTS_TV_HORIZON,
                        future_z=_tv_future_z(raw),
                        future_predictors=raw["x_future"],
                        max_draws=TV_FORECAST_DRAWS)
    f_med = fcast.double().median(0).values.cpu().numpy()
    gap = (np.abs(f_med - np.asarray(REFERENCE_FORECAST_MEDIAN_TV))
           / np.asarray(REFERENCE_FORECAST_SD_TV))
    print(f"bsts_tv forecast {list(fcast.shape)}: |median - reference's| / "
          f"reference's sd at steps 1, 10, 30: {gap[0]:.3f}, {gap[9]:.3f}, "
          f"{gap[-1]:.3f}; worst {float(gap.max()):.3f} (gate "
          f"{REG_FORECAST_SDS})")
    gates += [(tuple(fcast.shape) == (TV_FORECAST_DRAWS,
                                      data.BSTS_TV_HORIZON)
               and bool(torch.isfinite(fcast).all()),
               f"the bsts_tv forecast is {tuple(fcast.shape)} or not finite"),
              (float(gap.max()) <= REG_FORECAST_SDS,
               f"the bsts_tv forecast's median is {float(gap.max()):.3f} "
               "reference sds from the reference's")]
    sub = fit._subsampled_states(0, TV_FORECAST_DRAWS)
    before = dict(kk.LAUNCHES)
    ll = model.log_lik(sub)
    errs = fit.prediction_errors(cutpoints=[TV_CUTPOINT],
                                 max_draws=TV_FORECAST_DRAWS)
    torch.cuda.synchronize()
    pe_s = time.perf_counter() - t2
    ran = {k: kk.LAUNCHES[k] - before[k] for k in ("loglik_wide_tv",
                                                    "smoother_wide_tv")}
    launches["loglik_wide_tv"] = ran["loglik_wide_tv"]
    want = kalman.kalman_loglik(model.ssm_params(sub),
                                model.adjusted_series(sub), model.observed,
                                innovations=True)
    ll_err = _rel(ll.double(), want[0].double())
    pe_err = _rel(errs["in.sample"].double(),
                  (want[1] / torch.sqrt(want[2])).double())
    held = errs[str(TV_CUTPOINT)]
    hold = held[:, TV_CUTPOINT:][:, model.observed[TV_CUTPOINT:]].double()
    print(f"bsts_tv forecast, log_lik and prediction_errors(cutpoints="
          f"[{TV_CUTPOINT}]) of {TV_FORECAST_DRAWS} draws in {pe_s:.2f} s "
          f"(launches {ran}): log_lik rel {ll_err:.2e}, in-sample errors "
          f"rel {pe_err:.2e} (tolerance {TV_TOL:g}); holdout "
          f"{tuple(held.shape)}, past the cutpoint (observed days) mean "
          f"{float(hold.mean()):.4f} sd {float(hold.std()):.4f}")
    gates += [
        (np.isfinite(ll_err) and ll_err <= TV_TOL,
         f"bsts_tv log_lik is {ll_err:.3e} off its plain version"),
        (np.isfinite(pe_err) and pe_err <= TV_TOL,
         f"bsts_tv's in-sample errors are {pe_err:.3e} off their plain "
         "version"),
        (ran["loglik_wide_tv"] >= 3,
         f"log_lik and the errors did not run through K1w's time-varying "
         f"form: {ran}"),
        (tuple(held.shape)[1] == g and bool(torch.isfinite(held).all())
         and bool((held[:, ~model.observed] == 0).all()),
         f"the bsts_tv holdout errors are {tuple(held.shape)}, not finite "
         "or not 0 at the gaps")]

    small, small_err = _tv_small_path(raw)
    print(f"bsts_tv d=4 (a Student trend and the dynamic regression, "
          f"{TV_SMALL[0]} chains x ({TV_SMALL[1]} + {TV_SMALL[2]}) sweeps, "
          f"log_lik and errors): launches "
          f"{ {k: v for k, v in small.items() if v} }, log_lik and errors "
          f"rel {small_err:.2e}")
    launches["smoother_tv"] = small["smoother_tv"]
    launches["loglik_tv"] = small["loglik_tv"]
    gates += [(small["smoother_tv"] >= sum(TV_SMALL[1:])
               and small["loglik_tv"] >= 2,
               f"the d = 4 model did not run K2's and K1's time-varying "
               f"forms: {small}"),
              (np.isfinite(small_err) and small_err <= TV_TOL,
               f"the d = 4 model's log_lik and errors are {small_err:.3e} "
               "off the plain filter")]
    print(f"phase 8 took {time.perf_counter() - t_phase:.1f} s")
    for ok, msg in gates:
        check(ok, msg)
    return launches


def _hmm_vs_plain(rng, dtype, c, t_len, s, deep=False):
    """H1 (with and without its alphas) and H2 against their plain
    versions on one problem (``hmm_timing.problem``, ``deep`` passed on):
    (H1's normwise relative error, the chains whose H2 path differs, the
    largest margin at a chain's last differing step, H2's statistics' worst
    relative error against those of its own path, the smallest log alpha
    of the plain filter)."""
    import torch

    from boom_tpu_torch.kernels.hmm_timing import problem
    from boom_tpu_torch.models import hmm
    from boom_tpu_torch.models import hmm_kernel as hk

    p = problem(rng, c, t_len, s, dtype, deep=deep)
    args = (p["log_lik"], p["log_trans"], p["log_init"])
    la, ll = hk.launch_forward(*args)
    want_la, want_ll = hmm.forward_filter(*args)
    _, alone = hk.launch_forward(*args, want_alphas=False)
    check(torch.equal(alone, ll), f"H1 without its alphas gives another "
          f"loglike ({dtype} C={c} T={t_len} S={s})")
    rel = max(_rel(la.double(), want_la.double()),
              _rel(ll.double(), want_ll.double()))
    z, suf, counts, first = hk.launch_backward(want_la, p["log_trans"],
                                               p["path_u"], p["y"])
    want_z = hmm.backward_sample(want_la, p["log_trans"], p["path_u"])
    own_suf, own_counts, own_first = hmm.path_stats(z, p["y"].double(), s)
    stats = max(_rel(g.double(), w) for g, w in zip(
        (*suf, counts, first), (*own_suf, own_counts, own_first)))
    differ = (z != want_z).any(-1)
    margin = 0.0
    for ci in torch.nonzero(differ).flatten().tolist():
        # the last step at which the two paths differ (they are drawn
        # backward, so the steps after it agree): the two states' logits
        # there, in float64
        t = int(torch.nonzero(z[ci] != want_z[ci]).max())
        logits = (want_la[ci, t].double()
                  - torch.log(-torch.log(p["path_u"][ci, t].double())))
        if t < t_len - 1:
            logits = logits + p["log_trans"][ci, :, int(z[ci, t + 1])].double()
        a, b = logits[int(z[ci, t])], logits[int(want_z[ci, t])]
        margin = max(margin, float((a - b).abs()
                                   / max(1.0, float(b.abs()))))
    return rel, int(differ.sum()), margin, stats, float(want_la.min())


def _hmm_cases():
    """(dtype, S, T, chains, deep) of phase 2f: HMM_S_CHECK x HMM_T_CHECK x
    HMM_CHAIN_CHECK, the T of HMM_EDGE_T around the lanes a chain that H1
    and H2 take there, and HMM_DEEP_CHECK."""
    import torch

    from boom_tpu_torch.models import hmm_kernel as hk

    out = []
    for dtype in ("float64", "float32"):
        for s in HMM_S_CHECK:
            for c in HMM_CHAIN_CHECK:
                t_lens = list(HMM_T_CHECK)
                for name in HMM_KERNELS:
                    lanes = hk.lanes(name, getattr(torch, dtype), s, c)
                    for d in HMM_EDGE_T:
                        t = 2 * lanes + 1 if d is None else lanes + d
                        if t >= 1 and t not in t_lens:
                            t_lens.append(t)
                out += [(dtype, s, t, c, False) for t in sorted(t_lens)]
        out += [(dtype, s, 1200, c, True) for s, c in HMM_DEEP_CHECK]
    return out


def phase2f_hmm_vs_plain():
    """H1 and H2 against their plain versions (``_hmm_cases``), ten
    launches bit-identical at phase 9's shape and at few chains, and their
    times beside bounds, floors and the plain versions'
    (``kernels/hmm_timing.py``). Returns the rows' numbers."""
    import torch

    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.kernels import hmm_timing as ht

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20261022)
    bad, worst = [], {}
    chains = {"float64": 0, "float32": 0}
    differ = {"float64": 0, "float32": 0}
    margin = 0.0
    cases = _hmm_cases()
    for dtype, s, t_len, c, deep in cases:
        rel, n_diff, m, stats, lowest = _hmm_vs_plain(rng, dtype, c, t_len,
                                                      s, deep)
        case = f"{dtype} S={s} T={t_len} C={c}" + (" deep" if deep else "")
        worst[dtype] = max(worst.get(dtype, 0.0), rel)
        worst[f"{dtype} stats"] = max(worst.get(f"{dtype} stats", 0.0),
                                      stats)
        chains[dtype] += c
        differ[dtype] += n_diff
        margin = max(margin, m)
        if deep:
            print(f"hmm {case}: the plain filter's lowest log alpha "
                  f"{lowest:.1f}; H1 {rel:.3e}, H2 paths differing "
                  f"{n_diff}")
            if not lowest < -87.0:
                bad.append(f"{case}: its log alphas stay above -87")
        if not (np.isfinite(rel) and rel <= SCAN_TOL[dtype]):
            bad.append(f"H1 {case}: {rel:.3e}")
        if not stats <= HMM_STATS_TOL[dtype]:
            bad.append(f"H2's statistics {case}: {stats:.3e}")
        if dtype == "float64" and n_diff:
            bad.append(f"H2 {case}: {n_diff} paths differ")
    for dtype in ("float64", "float32"):
        agree = 1.0 - differ[dtype] / chains[dtype]
        stats = worst[f"{dtype} stats"]
        t_seen = sorted({t for d, _s, t, _c, _d in cases if d == dtype})
        print(f"hmm {dtype} over S {HMM_S_CHECK}, T {t_seen}, chains "
              f"{HMM_CHAIN_CHECK} and {len(HMM_DEEP_CHECK)} deep problems"
              f" ({sum(d == dtype for d, *_ in cases)} problems): H1 worst "
              f"{worst[dtype]:.3e} (tolerance "
              f"{SCAN_TOL[dtype]:g}); H2 paths differ on {differ[dtype]} "
              f"of {chains[dtype]} chains (agreement {agree:.5f}); "
              f"statistics against their own path's {stats:.3e} "
              f"(tolerance {HMM_STATS_TOL[dtype]:g})")
        if dtype == "float32" and agree < HMM_AGREE:
            bad.append(f"H2 float32 paths agree on {agree:.5f} of chains")
    print(f"hmm float32: the largest logit margin where two paths part "
          f"{margin:.3e} (near-ties only: gate < {HMM_TIE:g})")
    if margin >= HMM_TIE:
        bad.append(f"H2 float32 paths part at a margin of {margin:.3e}")
    check(not bad, "an HMM kernel disagrees with its plain version: "
          + "; ".join(bad[:20]))

    at_hmm, same = {}, {}
    for shape in ("phase9", "few_chains"):
        tag, c, t_len, s = ht.SHAPES[shape]
        for name, (kern, plain) in ht.cases(rng, tag, c, t_len, s).items():
            first, want = kern(), plain()
            if name == "hmm_forward":
                got_t, want_t = first, want
            else:
                got_t, want_t = (first[0],), (want[0],)
            err = max(float((g.double() - w.double()).abs().max())
                      for g, w in zip(got_t, want_t))
            if shape == "phase9":
                at_hmm[name] = {"max_abs_err": err}
            flat = [t for o in first for t in (o if isinstance(o, tuple)
                                              else (o,))]
            same[f"{name} {shape}"] = True
            for _ in range(9):
                again = kern()
                again = [t for o in again
                         for t in (o if isinstance(o, tuple) else (o,))]
                same[f"{name} {shape}"] &= all(
                    torch.equal(a, b) for a, b in zip(flat, again))
            print(f"{name} {tag} C={c} T={t_len} S={s} ({shape}): max abs "
                  f"error against the plain version {err:.3e}"
                  + (" (H2: of the paths)" if name == "hmm_backward"
                     else ""))
    torch.cuda.synchronize()
    print("ten repeated launches bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"repeated launches differ: {same}")

    for shape, per in ht.time_hmm(rng).items():
        for name, r in per.items():
            plain = (f"{r['plain_ms']:.3f} ms" if r["plain_ms"] is not None
                     else "not timed")
            print(f"time {name} {shape} {r['shape']}: kernel {r['ms']:.4f} "
                  f"ms, plain {plain}, bound {r['bound_ms']:.5f} ms "
                  f"({r['bound_by']}); L {r['lanes']}, a lane's chain's "
                  f"estimated floor {r['floor_ms']:.4f} ms")
            if shape == "phase9":
                at_hmm[name].update({k: r[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by")})
    log = _build.log_path("hmm")
    if log.exists():
        for inst, rep in sorted(ht.nvcc_report(log.read_text()).items()):
            print(f"nvcc {inst}: {rep['registers']} registers, "
                  f"{rep['spill_bytes']} bytes spill stores, "
                  f"{rep['stack_bytes']} bytes stack")
    print(f"phase 2f took {time.perf_counter() - t_phase:.1f} s")
    return at_hmm


def _covers(draws, truth):
    """The reference tests' check_mcmc_matrix (boom_tpu/testing.py:34) in
    numpy: each column's central BASE_CONFIDENCE interval covers its true
    value, a few misses allowed for several columns."""
    a = np.asarray(draws).reshape(-1, len(truth))
    alpha = 1.0 - BASE_CONFIDENCE
    lo = np.quantile(a, alpha / 2, axis=0)
    hi = np.quantile(a, 1 - alpha / 2, axis=0)
    covered = (lo <= truth) & (truth <= hi)
    se = np.sqrt(BASE_CONFIDENCE * (1 - BASE_CONFIDENCE) / len(truth))
    return (bool(covered.mean() >= BASE_CONFIDENCE - 2.5 * se - 1e-9)
            or bool(covered.all()))


def _sweep_vs_cpu(make, chains=BASE_SWEEP_CHAINS, seed=0):
    """One float64 sweep of ``chains`` chains of the model ``make(device)``
    on the card against the same on the CPU, from the CPU's start and
    noise: the worst normwise relative difference of the new state."""
    import torch

    cpu, card = make("cpu"), make("cuda")
    gen = torch.Generator().manual_seed(seed)
    st = cpu.init_state(cpu.draw_init_noise(gen, chains))
    noise = cpu.draw_noise(gen, chains)

    def to_card(tree):
        if isinstance(tree, dict):
            return {k: to_card(v) for k, v in tree.items()}
        return tree.cuda()

    want = cpu.kernel()(noise, st)
    got = card.kernel()(to_card(noise), to_card(st))
    return max(_rel(got[k].cpu(), want[k]) for k in want)


def _base_gates(label, mon, names, ref, draws, main=None):
    """Phase 9's gates against the reference's run ``ref`` on the monitored
    draws mon [C, N, k]: the medians over every chain; R-hat and min-ESS
    over the chains of the main mode (``main``, a [C] mask, where ``ref``
    has the main mode's numbers; else over every chain), and the share of
    chains in it. Returns (gates, R-hat, ESS of the gated chains)."""
    import torch

    from boom_tpu_torch.inference import diagnostics

    med = np.median(mon.reshape(-1, len(names)), 0)
    gated, ref_rhat, ref_per_draw = mon, ref["rhat"], ref["min_ess_per_draw"]
    gates = []
    if main is not None and "main_share" in ref:
        share, want = float(main.mean()), ref["main_share"]
        sd = np.sqrt(want * (1 - want) / ref["chains"]
                     + share * (1 - share) / mon.shape[0])
        limit = BASE_SHARE_SIGMAS * sd + 1.0 / ref["chains"]
        print(f"{label}: {int(main.sum())} of {mon.shape[0]} chains in the "
              f"main mode ({share:.4f}; the reference's {want:.4f}, gate "
              f"|difference| <= {limit:.4f})")
        gates.append((abs(share - want) <= limit,
                      f"{label}: the share of chains in the main mode "
                      f"{share:.4f} is not within {limit:.4f} of the "
                      f"reference's {want:.4f}"))
        gated, ref_rhat = mon[main], ref["main_rhat"]
        ref_per_draw = ref["main_min_ess_per_draw"]
    gated_t = torch.as_tensor(gated)
    rhat = diagnostics.potential_scale_reduction(gated_t).numpy()
    ess = diagnostics.effective_sample_size(gated_t).numpy()
    per_draw = ess / (gated.shape[0] * draws)
    all_rhat = diagnostics.potential_scale_reduction(
        torch.as_tensor(mon)).numpy()
    for i, name in enumerate(names):
        ref_med = ref["medians"][i]
        limit = (1.0 + REG_RHAT_FACTOR * (ref_rhat[i] - 1.0)
                 + REG_RHAT_SLACK)
        print(f"{label} {name}: median {med[i]:.6g} (reference {ref_med:.6g}"
              f", ratio {med[i] / ref_med:.4f}) rhat {rhat[i]:.4f} "
              f"(reference's {ref_rhat[i]:.4f}, limit {limit:.4f}; every "
              f"chain's {all_rhat[i]:.4f}, the reference's "
              f"{ref['rhat'][i]:.4f}) ess per draw {per_draw[i]:.5f}")
        gates.append((rhat[i] <= limit, f"{label} R-hat of {name} "
                      f"{rhat[i]:.4f} > {limit:.4f}"))
        gates.append((abs(med[i] / ref_med - 1.0) <= BASE_MEDIAN_TOL,
                      f"{label} median of {name} {med[i]:.5g} is not within "
                      f"{BASE_MEDIAN_TOL:.0%} of the reference's "
                      f"{ref_med:.5g}"))
    gates.append((float(per_draw.min()) >= 0.5 * ref_per_draw,
                  f"{label} min-ESS per draw {float(per_draw.min()):.5f} is "
                  f"below half the reference's {ref_per_draw:.5f}"))
    return gates, rhat, ess, per_draw


def _base_rate(label, card, sweeps, elapsed, ess, rhat, per_draw):
    print(f"{label} rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, min-ESS "
          f"{float(ess.min()):.1f} ({float(per_draw.min()):.5f} a draw), "
          f"min-ESS/s {float(ess.min()) / elapsed:.2f}, max R-hat "
          f"{float(rhat.max()):.4f} (the gated chains)")


def _phase9_hmm(card, gates):
    """Config #4: GaussianHmm on hmm.npz; returns H1's and H2's launches."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.models import hmm, mixtures
    from boom_tpu_torch.models import hmm_kernel as hk

    raw = data.hmm()
    truth = data.HMM_TRUTH

    def make(device, dtype=torch.float64):
        return hmm.GaussianHmm(y=torch.tensor(raw["y"], dtype=dtype,
                                              device=device), num_states=2)

    worst = _sweep_vs_cpu(make)
    print(f"hmm float64 sweep C={BASE_SWEEP_CHAINS}: card vs CPU, worst "
          f"relative difference {worst:.3e} (tolerance {SWEEP_TOL:g})")
    gates.append((np.isfinite(worst) and worst <= SWEEP_TOL,
                  f"the hmm sweep on the card disagrees: {worst:.3e}"))

    model = make("cuda", torch.float32)
    for k in hk.LAUNCHES:
        hk.LAUNCHES[k] = 0
    gen = prng.generator(BASE_SEED, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   BASE_DRAWS, generator=gen, num_chains=BASE_CHAINS,
                   burn=BASE_BURN)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = dict(hk.LAUNCHES)
    sweeps = BASE_BURN + BASE_DRAWS
    print(f"hmm: T={model.y.shape[0]} S=2 chains={BASE_CHAINS} "
          f"burn={BASE_BURN} draws={BASE_DRAWS} in {elapsed:.2f} s; "
          f"launches {launches}")
    gates.append((launches == {"hmm_forward": sweeps,
                               "hmm_backward": sweeps},
                  f"the hmm run did not launch H1 and H2 once a sweep: "
                  f"{launches}"))
    d = res.draws
    mu, sigsq, trans = (d[k].double().cpu().numpy()
                        for k in ("mu", "sigsq", "trans"))
    check(all(np.isfinite(a).all() for a in (mu, sigsq, trans)),
          "non-finite hmm draws")
    order = np.argsort(mu, axis=-1)
    take = np.take_along_axis
    diag = take(np.diagonal(trans, axis1=-2, axis2=-1), order, -1)
    mon = np.concatenate([take(mu, order, -1),
                          np.sqrt(take(sigsq, order, -1)), diag], -1)
    main = mixtures.main_mode(mu).numpy()
    g, rhat, ess, per_draw = _base_gates("hmm", mon, HMM_MONITOR,
                                         REFERENCE_HMM, BASE_DRAWS, main)
    gates += g
    want_diag = [truth["trans"][0][0], truth["trans"][1][1]]
    for what, cols, want in (("mu", slice(0, 2), truth["mu"]),
                             ("sd", slice(2, 4), truth["sd"]),
                             ("the transition diagonal", slice(4, 6),
                              want_diag)):
        ok = _covers(mon[..., cols], np.asarray(want))
        print(f"hmm truth {what} {want} inside the draws' central "
              f"{BASE_CONFIDENCE:.0%} intervals: {ok}")
        gates.append((ok, f"the hmm draws' {BASE_CONFIDENCE:.0%} intervals "
                      f"miss the true {what}"))
    _base_rate("hmm", card, sweeps, elapsed, ess, rhat, per_draw)
    _print_profile(f"hmm [{card}]", *_phase_profile(
        model, res.final_state, gen, BASE_CHAINS, "hmm", ()))

    # log_lik of HMM_LOGLIK_DRAWS draws through H1, against the plain filter
    sub = {k: v[:HMM_LOGLIK_DRAWS, -1] for k, v in d.items()}
    before = hk.LAUNCHES["hmm_forward"]
    ll = model.log_lik(sub)
    _, want = hmm.forward_filter(model.emission_loglik(sub),
                                 torch.log(sub["trans"]),
                                 torch.log(sub["init"]))
    ll_err = _rel(ll.double(), want.double())
    print(f"hmm log_lik of {HMM_LOGLIK_DRAWS} draws through H1: rel "
          f"{ll_err:.2e} against the plain filter (tolerance {TV_TOL:g})")
    gates.append((hk.LAUNCHES["hmm_forward"] == before + 1
                  and np.isfinite(ll_err) and ll_err <= TV_TOL,
                  f"the hmm log_lik is {ll_err:.3e} off its plain version or "
                  "did not run through H1"))
    return launches


def _phase9_mixture(card, gates):
    """Config #3: FiniteMixture(3).fit on mixture.npz on the card."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.frontends import FiniteMixture
    from boom_tpu_torch.models import mixtures

    raw = data.mixture()
    truth = data.MIXTURE_TRUTH

    def make(device):
        return mixtures.GaussianMixtureModel(
            y=torch.tensor(raw["y"], device=device), num_components=3)

    worst = _sweep_vs_cpu(make)
    print(f"mixture float64 sweep C={BASE_SWEEP_CHAINS}: card vs CPU, worst "
          f"relative difference {worst:.3e} (tolerance {SWEEP_TOL:g})")
    gates.append((np.isfinite(worst) and worst <= SWEEP_TOL,
                  f"the mixture sweep on the card disagrees: {worst:.3e}"))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = FiniteMixture(num_components=3).fit(
        raw["y"], niter=BASE_DRAWS, num_chains=BASE_CHAINS, burn=BASE_BURN,
        seed=BASE_SEED)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    model = fit._model
    check(model.y.device.type == "cuda" and model.y.dtype == torch.float32,
          "FiniteMixture.fit did not run on the card in float32")
    sweeps = BASE_BURN + BASE_DRAWS
    print(f"mixture: n={model.y.shape[0]} K=3 chains={BASE_CHAINS} "
          f"burn={BASE_BURN} draws={BASE_DRAWS} through FiniteMixture.fit "
          f"in {elapsed:.2f} s")
    mu, sigsq, w = (fit.draws[k].double().cpu().numpy()
                    for k in ("mu", "sigsq", "weights"))
    check(all(np.isfinite(a).all() for a in (mu, sigsq, w)),
          "non-finite mixture draws")
    order = np.argsort(mu, axis=-1)
    take = np.take_along_axis
    mon = np.concatenate([take(mu, order, -1),
                          np.sqrt(take(sigsq, order, -1)),
                          take(w, order, -1)], -1)
    g, rhat, ess, per_draw = _base_gates("mixture", mon, MIX_MONITOR,
                                         REFERENCE_MIX, BASE_DRAWS,
                                         mixtures.main_mode(mu).numpy())
    gates += g
    for what, cols, want in (("mu", slice(0, 3), truth["mu"]),
                             ("sd", slice(3, 6), truth["sd"]),
                             ("weights", slice(6, 9), truth["weights"])):
        ok = _covers(mon[..., cols], np.asarray(want))
        print(f"mixture truth {what} {want} inside the draws' central "
              f"{BASE_CONFIDENCE:.0%} intervals: {ok}")
        gates.append((ok, f"the mixture draws' {BASE_CONFIDENCE:.0%} "
                      f"intervals miss the true {what}"))
    comps = fit.components()
    print("mixture components(): " + "; ".join(
        f"mean {c['mean']:.4f} sd {c['sd']:.4f} weight {c['weight']:.4f}"
        for c in comps))
    near = all(abs(c["mean"] - m) <= MIX_COMPONENT_TOL
               and abs(c["sd"] - sd) <= MIX_COMPONENT_TOL
               and abs(c["weight"] - wt) <= MIX_WEIGHT_TOL
               for c, m, sd, wt in zip(comps, truth["mu"], truth["sd"],
                                       truth["weights"]))
    gates.append((near, f"components() are not near the truth: {comps}"))
    probs = fit.cluster_probs()
    row_err = float(np.abs(probs.sum(1) - 1.0).max())
    print(f"mixture cluster_probs() {probs.shape}: rows sum to 1 within "
          f"{row_err:.2e}")
    gates.append((probs.shape == (model.y.shape[0], 3) and row_err <= 1e-5,
                  f"cluster_probs() is {probs.shape}, rows off 1 by "
                  f"{row_err:.2e}"))
    _base_rate("mixture", card, sweeps, elapsed, ess, rhat, per_draw)
    _print_profile(f"mixture [{card}]", *_phase_profile(
        model, fit._result.final_state, prng.generator(1, "cuda"),
        BASE_CHAINS, "mixture", ()))


def _phase9_beta_binomial(card, gates):
    """Config #1: BetaBinomialModel on beta_binomial.npz."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.models.beta_binomial import BetaBinomialModel

    raw = data.beta_binomial()

    def make(device, dtype=torch.float64):
        return BetaBinomialModel(
            trials=torch.tensor(raw["n"], dtype=dtype, device=device),
            successes=torch.tensor(raw["y"], dtype=dtype, device=device))

    worst = _sweep_vs_cpu(make)
    print(f"beta_binomial float64 sweep C={BASE_SWEEP_CHAINS}: card vs CPU, "
          f"worst relative difference {worst:.3e} (tolerance "
          f"{SWEEP_TOL:g})")
    gates.append((np.isfinite(worst) and worst <= SWEEP_TOL,
                  f"the beta_binomial sweep on the card disagrees: "
                  f"{worst:.3e}"))

    model = make("cuda", torch.float32)
    gen = prng.generator(BASE_SEED, "cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   BB_DRAWS, generator=gen, num_chains=BB_CHAINS,
                   burn=BB_BURN)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    sweeps = BB_BURN + BB_DRAWS
    print(f"beta_binomial: {raw['n'].shape[0]} groups, chains={BB_CHAINS} "
          f"burn={BB_BURN} draws={BB_DRAWS} in {elapsed:.2f} s")
    mon = np.stack([res.draws["prob"].double().cpu().numpy(),
                    res.draws["size"].double().cpu().numpy()], -1)
    check(np.isfinite(mon).all(), "non-finite beta_binomial draws")
    g, rhat, ess, per_draw = _base_gates("beta_binomial", mon, BB_MONITOR,
                                         REFERENCE_BB, BB_DRAWS)
    gates += g
    gates.append((float(rhat.max()) < BB_RHAT_GATE,
                  f"beta_binomial R-hat {float(rhat.max()):.4f} >= "
                  f"{BB_RHAT_GATE}"))
    # the reference test's quadrature (tests/test_beta_binomial_e2e.py:
    # 46-72): the posterior on a dense grid, float64 on the host
    cpu = make("cpu")
    probs = np.linspace(0.15, 0.55, 201)
    log_sizes = np.linspace(np.log(3.0), np.log(200.0), 201)
    pg, lg = np.meshgrid(probs, log_sizes, indexing="ij")
    lp = cpu.log_post(torch.tensor(pg.ravel()),
                      torch.tensor(np.exp(lg.ravel()))).numpy()
    lp = lp.reshape(pg.shape) + lg
    wq = np.exp(lp - lp.max())
    wq /= wq.sum()
    want_p, want_s = (wq * pg).sum(), (wq * np.exp(lg)).sum()
    sd_p = np.sqrt((wq * (pg - want_p) ** 2).sum())
    sd_s = np.sqrt((wq * (np.exp(lg) - want_s) ** 2).sum())
    prob, size = mon[..., 0].ravel(), mon[..., 1].ravel()
    print(f"beta_binomial against quadrature: prob mean {prob.mean():.5f} "
          f"(quadrature {want_p:.5f}, bound {4 * sd_p / np.sqrt(200):.5f}) "
          f"sd {prob.std():.5f} ({sd_p:.5f}); size mean {size.mean():.4f} "
          f"({want_s:.4f}, bound {4 * sd_s / np.sqrt(200):.4f}) sd "
          f"{size.std():.4f} ({sd_s:.4f})")
    gates += [
        (abs(prob.mean() - want_p) < 4 * sd_p / np.sqrt(200.0),
         "the beta_binomial prob mean is off the quadrature's"),
        (abs(size.mean() - want_s) < 4 * sd_s / np.sqrt(200.0),
         "the beta_binomial size mean is off the quadrature's"),
        (abs(prob.std() / sd_p - 1.0) < 0.15,
         "the beta_binomial prob sd is off the quadrature's"),
        (abs(size.std() / sd_s - 1.0) < 0.25,
         "the beta_binomial size sd is off the quadrature's")]
    _base_rate("beta_binomial", card, sweeps, elapsed, ess, rhat,
               per_draw)
    _print_profile(f"beta_binomial [{card}]", *_phase_profile(
        model, res.final_state, gen, BB_CHAINS, "beta_binomial", ()))


def phase9_baseline(card):
    """BASELINE configs #4, #3 and #1 on their committed data, each held to
    the reference's own run; returns H1's and H2's launches of the HMM
    run."""
    t_phase = time.perf_counter()
    gates = []
    launches = _phase9_hmm(card, gates)
    _phase9_mixture(card, gates)
    _phase9_beta_binomial(card, gates)
    print(f"phase 9 took {time.perf_counter() - t_phase:.1f} s")
    for ok, msg in gates:
        check(ok, msg)
    return launches


def _calendar_vs_plain(rng, dtype, d, b, t_len, kind, masked, smoother):
    """K1w's calendar form (with and without the innovations) and, with
    ``smoother``, K2w's dense form with the calendar against their plain
    versions on one :func:`kalman_timing.calendar_system`: ({kernel: rel}),
    each launch checked to take its calendar key."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    tag = str(dtype).split(".")[-1]
    params = kt.calendar_system(rng, b, d, t_len, tag, kind)
    y = torch.tensor(rng.normal(size=t_len).cumsum(), dtype=dtype,
                     device="cuda")
    obs = (torch.tensor(rng.uniform(size=t_len) > 0.1, device="cuda")
           if masked else None)
    out = {}
    before = dict(kk.LAUNCHES)
    if not smoother:
        got = kk.launch_loglik_tv(params, y, obs, innovations=True)
        ll = kk.launch_loglik_tv(params, y, obs)
        want = kalman.kalman_loglik(params, y, obs, innovations=True)
        out["loglik_wide_tv_calendar"] = max(
            [_rel(g.double(), w.double()) for g, w in zip(got, want)]
            + [_rel(ll.double(), want[0].double())])
        ran = {"loglik_wide_tv_calendar": 2}
    else:
        q = params.q_mat.shape[-1]
        normals = [torch.tensor(rng.normal(size=sh), dtype=dtype,
                                device="cuda")
                   for sh in ((b, d), (b, t_len - 1, q), (b, t_len))]
        got = kk.simulation_smoother(params, y, *normals, observed=obs)
        want = kalman.simulation_smoother(params, y, *normals, observed=obs)
        out["smoother_wide_tv_calendar"] = _rel(got, want)
        ran = {"smoother_wide_tv_calendar": 1}
    moved = {k: kk.LAUNCHES[k] - before[k] for k in kk.LAUNCHES
             if kk.LAUNCHES[k] != before[k]}
    check(moved == ran, f"d={d} B={b} T={t_len} {kind}: launches {moved}, "
          f"not {ran}")
    return out


def phase2g_calendar_vs_plain():
    """The calendar's T_t in K2w's dense time-varying form and K1w's
    against their plain versions (CAL_* cases), at phase 10a's shapes ten
    launches bit-identical, and their times beside bounds and plain
    times; K1w with a T a system at phase 10b's TIM batch. Returns the
    rows' numbers."""
    import torch

    from boom_tpu_torch.kernels import kalman_timing as kt

    t_phase = time.perf_counter()
    rng = np.random.default_rng(20261019)
    kinds = kt.CALENDAR_KINDS
    cases = [(torch.float64, d, b, CAL_T_CHECK[(i + j + k) % 4], kind,
              (i + j + k) % 2 == 0, True)
             for i, d in enumerate(CAL_D_CHECK)
             for j, b in enumerate(CAL_CHAIN_CHECK)
             for k, kind in enumerate(kinds)]
    d_long, t_long, long_chains, long_draws = CAL_LONG
    cases += [(torch.float64, d_long, b, t_long, kind, True, True)
              for b in long_chains for kind in kinds]
    cases += [(dtype, d, 33, t_len, kind, (i + k) % 2 == 1, False)
              for dtype in (torch.float64, torch.float32)
              for i, d in enumerate(CAL_LOGLIK_D)
              for t_len in CAL_LOGLIK_T for k, kind in enumerate(kinds)]
    cases += [(dtype, d_long, long_draws, t_long, kind, True, False)
              for dtype in (torch.float64, torch.float32) for kind in kinds]
    bad, worst = [], {}
    for dtype, d, b, t_len, kind, masked, smoother in cases:
        tag = str(dtype).split(".")[-1]
        for k, rel in _calendar_vs_plain(rng, dtype, d, b, t_len, kind,
                                         masked, smoother).items():
            worst[(k, tag)] = max(worst.get((k, tag), 0.0), rel)
            if not (np.isfinite(rel) and rel <= SCAN_TOL[tag]):
                bad.append(f"{k} {tag} d={d} B={b} T={t_len} {kind}: "
                           f"{rel:.3e}")
    for (k, tag), v in sorted(worst.items()):
        print(f"worst {k} {tag} over {len(cases)} cases (d {CAL_D_CHECK}, "
              f"chains {CAL_CHAIN_CHECK}, T {CAL_T_CHECK} and {t_long}, "
              f"two matrices a chain and for all): {v:.3e} (tolerance "
              f"{SCAN_TOL[tag]:g})")
    check(not bad, "a calendar kernel disagrees with its plain version: "
          + "; ".join(bad[:20]))

    at_cal, same = {}, {}
    for name, (tag, batch, d, t_len, series, t_kind) in \
            kt.CALENDAR_SHAPES.items():
        kern, ref, _wrapper = kt.tv_cases(rng, name, tag, batch, d, t_len,
                                          series, t_kind=t_kind)
        first, want = kern(), ref()
        first = first if isinstance(first, tuple) else (first,)
        want = want if isinstance(want, tuple) else (want,)
        rel = max(_rel(g.double(), w.double()) for g, w in zip(first, want))
        at_cal[name] = {"max_abs_err": max(float((g - w).abs().max())
                                           for g, w in zip(first, want))}
        print(f"{name} {tag} B={batch} d={d} T={t_len} (phase 10a's shape):"
              f" rel {rel:.2e} abs {at_cal[name]['max_abs_err']:.2e}")
        check(np.isfinite(rel) and rel <= SCAN_TOL[tag],
              f"{name} at phase 10a's shape: {rel:.3e}")
        same[name] = True
        for _ in range(9):
            again = kern()
            again = again if isinstance(again, tuple) else (again,)
            same[name] &= all(torch.equal(a, b) for a, b in zip(first,
                                                                  again))
    torch.cuda.synchronize()
    print("ten repeated launches at phase 10a's shapes bit-identical: "
          + ", ".join(f"{k} {v}" for k, v in same.items()))
    check(all(same.values()), f"repeated launches differ: {same}")
    for name, r in kt.time_tv(rng, shapes=kt.CALENDAR_SHAPES).items():
        print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, whole "
              f"wrapper {r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f}"
              f" ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']}); one "
              f"call on the host clock {r['call_ms']:.4f} ms")
        if r.get("pass_ms"):
            print(f"time {name} by pass (profiler, device ms a call): "
                  + ", ".join(f"{k} {v:.4f}"
                              for k, v in sorted(r["pass_ms"].items())))
        at_cal[name].update({k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                               "bound_by")})

    # K1w with a T a system at phase 10b's TIM batch
    (name, (tag, batch, d, t_len, series)), = kt.AR_TRIG_SHAPES.items()
    kern, ref, _wrapper = kt.kalman_cases(rng, name, tag, batch, d, t_len,
                                          series)
    got, want = kern(), ref()
    rel = _rel(got.double(), want.double())
    print(f"{name} {tag} B={batch} d={d} T={t_len} (phase 10b's TIM batch, "
          f"a T a system): rel {rel:.2e}")
    check(np.isfinite(rel) and rel <= SCAN_TOL[tag],
          f"K1w with a T a system at phase 10b's shape: {rel:.3e}")
    r = kt.time_kalman(rng, shapes=kt.AR_TRIG_SHAPES)[name]
    print(f"time {name} {r['shape']}: kernel {r['ms']:.4f} ms, whole "
          f"wrapper {r['wrapper_ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
          f"bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
    at_cal["loglik_wide_chain_t"] = {
        "max_abs_err": float((got - want).abs().max()),
        **{k: r[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}
    print(f"phase 2g took {time.perf_counter() - t_phase:.1f} s")
    return at_cal


def _monthly_builder():
    from boom_tpu_torch import data
    from boom_tpu_torch.api import BstsModel

    return (BstsModel().add_semilocal_linear_trend()
            .add_monthly_annual_cycle(first_date=data.BSTS_MONTHLY_FIRST))


def _ar_trig_builder():
    from boom_tpu_torch import data
    from boom_tpu_torch.api import BstsModel

    return (BstsModel().add_static_intercept().add_ar(lags=2)
            .add_trig(period=data.BSTS_AR_TRIG_PERIOD, nfreq=2))


def _sweep_vs_cpu_of(make, chains):
    """One float64 sweep (init included) of ``chains`` chains of the model
    ``make(device)`` builds, on the card against the CPU's on the same
    noise: the worst relative difference over the state's leaves."""
    import torch

    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.inference.driver import tree_map

    out = {}
    gen = prng.generator(3, "cpu")
    for device in ("cpu", "cuda"):
        model = make(device)
        if device == "cpu":
            init_noise = model.draw_init_noise(gen, chains)
            noise = model.draw_noise(gen, chains)
        moved = [tree_map(lambda t, dev=device: t.to(dev), n)
                 for n in (init_noise, noise)]
        state = model.kernel()(moved[1], model.init_state(moved[0]))
        out[device] = tree_map(lambda t: t.cpu(), state)
    errs = []
    tree_map(lambda a, b: errs.append(_rel(a.double(), b.double())),
             out["cuda"], out["cpu"])
    return max(errs)


def _gates_against(label, mon, names, medians, rhats, min_per_draw, draws,
                   chains):
    """R-hat - 1 at most REG_RHAT_FACTOR times the reference's +
    REG_RHAT_SLACK, medians within REG_VARIANCE_TOL, half the reference's
    min-ESS a draw; prints each parameter's readings. Returns (gates, ess,
    rhat, the port's min-ESS a draw)."""
    from boom_tpu_torch.inference import diagnostics

    ess = diagnostics.effective_sample_size(mon).cpu().numpy()
    rhat = diagnostics.potential_scale_reduction(mon).cpu().numpy()
    per_draw = ess / (chains * draws)
    med = mon.reshape(-1, len(names)).median(0).values.cpu().numpy()
    gates = []
    for i, name in enumerate(names):
        ref = medians[name]
        limit = 1.0 + REG_RHAT_FACTOR * (rhats[i] - 1.0) + REG_RHAT_SLACK
        print(f"{label} {name}: median {med[i]:.6g} (reference {ref:.6g}, "
              f"ratio {med[i] / ref:.4f}) rhat {rhat[i]:.4f} (reference's "
              f"{rhats[i]:.4f}, limit {limit:.4f}) ess per draw "
              f"{per_draw[i]:.5f}")
        gates.append((rhat[i] <= limit,
                      f"{label} R-hat of {name} {rhat[i]:.4f} > {limit:.4f} "
                      f"(the reference's {rhats[i]:.4f})"))
        gates.append((abs(med[i] / ref - 1.0) <= REG_VARIANCE_TOL,
                      f"{label} median of {name} {med[i]:.5g} is not within "
                      f"{REG_VARIANCE_TOL:.0%} of the reference's {ref:.5g}"))
    port = float(per_draw.min())
    gates.append((port >= 0.5 * min_per_draw,
                  f"{label} min-ESS per draw {port:.5f} is below half the "
                  f"reference's {min_per_draw:.5f}"))
    return gates, ess, rhat, port


def _ll_and_errors(model, sub, ll_key, tol, label):
    """log_lik and the in-sample one-step errors of the draws ``sub``
    through the card's kernels against the plain filter on the card:
    (gates, launches of ``ll_key``)."""
    import torch

    from boom_tpu_torch.statespace import bsts as pbsts
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    before = kk.LAUNCHES[ll_key]
    ll = model.log_lik(sub)
    errs = pbsts.one_step_prediction_errors(model, sub)
    torch.cuda.synchronize()
    ran = kk.LAUNCHES[ll_key] - before
    want = kalman.kalman_loglik(model.ssm_params(sub),
                                model.adjusted_series(sub), model.observed,
                                innovations=True)
    ll_err = _rel(ll.double(), want[0].double())
    pe_err = _rel(errs.double(), (want[1] / torch.sqrt(want[2])).double())
    print(f"{label} log_lik and one-step errors of {ll.shape[0]} draws "
          f"({ran} launches of {ll_key}): log_lik rel {ll_err:.2e}, errors "
          f"rel {pe_err:.2e} (tolerance {tol:g})")
    return [(np.isfinite(ll_err) and ll_err <= tol,
             f"{label} log_lik is {ll_err:.3e} off its plain version"),
            (np.isfinite(pe_err) and pe_err <= tol,
             f"{label}'s errors are {pe_err:.3e} off their plain version"),
            (ran >= 2, f"{label}'s log_lik and errors did not run through "
             f"{ll_key}: {ran}")], ran


def _monthly_extract(state):
    return {"sigsq_obs": state["sigsq_obs"],
            "blocks": {name: dict(v) for name, v in state["blocks"].items()},
            "alpha": state["alpha"][:, -1:]}


def phase10a_bsts_monthly(card):
    """bsts_monthly at full width through the front end: the semilocal
    trend and the monthly cycle (d = 14, T = 730); one float64 sweep of 33
    chains against the CPU's; MONTHLY_CHAINS chains x (MONTHLY_BURN +
    MONTHLY_DRAWS) sweeps through K2w's dense form with the calendar and K3,
    gated against the reference's run; the forecast; log_lik and the
    errors of 200 draws through K1w's calendar form. Returns the kernels'
    launch counts of the main path."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk
    from boom_tpu_torch.statespace.bsts import SWEEP_PHASES, Bsts

    t_phase = time.perf_counter()
    y_np = data.bsts_monthly()["y"]
    t0 = time.perf_counter()
    fit = _monthly_builder().fit(y_np, niter=10, burn=5, num_chains=64,
                                 seed=1)
    model = fit._model
    fcast = fit.predict(horizon=MONTHLY_HORIZON, max_draws=50)
    torch.cuda.synchronize()
    print(f"bsts_monthly front end on the card: fit (64 chains, 5 + 10 "
          f"sweeps) and predict in {time.perf_counter() - t0:.2f} s; "
          f"T={model.t_len} d={model.state_dim}, month boundaries "
          f"{int(model._calendar[2].sum())}")
    check(model.y.device.type == "cuda" and model.state_dim == 14
          and model.time_varying and model._chain_t
          and model.t_len == data.BSTS_MONTHLY_DAYS,
          "the bsts_monthly front end did not build its model on the card")
    check(tuple(fcast.shape) == (50, MONTHLY_HORIZON)
          and bool(torch.isfinite(fcast).all()), "front-end forecast")

    def make(device):
        y = torch.tensor(y_np, dtype=torch.float64, device=device)
        return Bsts(y=y, blocks=_monthly_builder()._build_blocks(y),
                    chains_hint=MONTHLY_SWEEP_CHAINS)

    worst = _sweep_vs_cpu_of(make, MONTHLY_SWEEP_CHAINS)
    print(f"bsts_monthly float64 sweep C={MONTHLY_SWEEP_CHAINS}: card vs "
          f"CPU worst relative difference {worst:.3e} (tolerance "
          f"{SWEEP_TOL:g})")
    check(np.isfinite(worst) and worst <= SWEEP_TOL,
          f"the bsts_monthly sweep on the card disagrees: {worst:.3e}")

    for counts in (kk.LAUNCHES, sk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    gen = prng.generator(MONTHLY_SEED, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda gn, c: model.init_state(model.draw_init_noise(gn,
                                                                        c)),
                   MONTHLY_DRAWS, generator=gen, num_chains=MONTHLY_CHAINS,
                   burn=MONTHLY_BURN, extract=_monthly_extract)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = {"smoother_wide_tv_calendar":
                kk.LAUNCHES["smoother_wide_tv_calendar"],
                "dpath": kk.LAUNCHES["dpath"]}
    others = {k: v for k, v in {**kk.LAUNCHES, **sk.LAUNCHES}.items()
              if k not in launches and v}
    sweeps = MONTHLY_BURN + MONTHLY_DRAWS
    print(f"bsts_monthly: T={model.t_len} d=14 chains={MONTHLY_CHAINS} "
          f"burn={MONTHLY_BURN} draws={MONTHLY_DRAWS} in {elapsed:.2f} s; "
          f"launches {launches}, other kernels {others}")
    check(launches["smoother_wide_tv_calendar"] == sweeps + 1
          and launches["dpath"] >= sweeps and not others,
          f"the bsts_monthly run did not go through its kernels (each of "
          f"its {sweeps + 1} smoother launches in K2w's dense form with the "
          f"calendar): {launches}, {others}")

    d = res.draws
    tr = d["blocks"]["semilocal_trend"]
    mon = torch.stack([d["sigsq_obs"], tr["sigma_level_sq"],
                       tr["sigma_slope_sq"], tr["phi"],
                       d["blocks"]["monthly"]["sigma_monthly_sq"]],
                      dim=-1).double()
    check(bool(torch.isfinite(mon).all())
          and bool(torch.isfinite(d["alpha"]).all()),
          "non-finite bsts_monthly draws")
    gates, ess, rhat, per_draw = _gates_against(
        "bsts_monthly", mon, MONTHLY_MONITOR, REFERENCE_MEDIANS_MONTHLY,
        REFERENCE_RHAT_MONTHLY, REFERENCE_MIN_ESS_PER_DRAW_MONTHLY,
        MONTHLY_DRAWS, MONTHLY_CHAINS)
    print(f"bsts_monthly rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, "
          f"min-ESS {float(ess.min()):.1f} ({per_draw:.5f} a draw, the "
          f"reference's {REFERENCE_MIN_ESS_PER_DRAW_MONTHLY:.5f}), "
          f"min-ESS/s {float(ess.min()) / elapsed:.2f}, max R-hat "
          f"{float(rhat.max()):.4f}")
    _print_profile(f"bsts_monthly [{card}]", *_phase_profile(
        model, res.final_state, gen, MONTHLY_CHAINS, "bsts", SWEEP_PHASES))

    fit = BstsModel(_model=model, _result=res)
    fcast = fit.predict(horizon=MONTHLY_HORIZON,
                        max_draws=MONTHLY_FORECAST_DRAWS)
    f_med = fcast.double().median(0).values.cpu().numpy()
    gap = (np.abs(f_med - np.asarray(REFERENCE_FORECAST_MEDIAN_MONTHLY))
           / np.asarray(REFERENCE_FORECAST_SD_MONTHLY))
    print(f"bsts_monthly forecast {list(fcast.shape)}: |median - "
          f"reference's| / reference's sd at days 1, 10, 30: {gap[0]:.3f}, "
          f"{gap[9]:.3f}, {gap[-1]:.3f}; worst {float(gap.max()):.3f} (gate "
          f"{REG_FORECAST_SDS})")
    gates += [(tuple(fcast.shape) == (MONTHLY_FORECAST_DRAWS,
                                      MONTHLY_HORIZON)
               and bool(torch.isfinite(fcast).all()),
               f"the bsts_monthly forecast is {tuple(fcast.shape)} or not "
               "finite"),
              (float(gap.max()) <= REG_FORECAST_SDS,
               f"the bsts_monthly forecast's median is "
               f"{float(gap.max()):.3f} reference sds from the reference's")]
    sub = fit._subsampled_states(0, MONTHLY_FORECAST_DRAWS)
    g, ran = _ll_and_errors(model, sub, "loglik_wide_tv_calendar",
                            MONTHLY_TOL, "bsts_monthly")
    gates += g
    launches["loglik_wide_tv_calendar"] = ran
    print(f"phase 10a took {time.perf_counter() - t_phase:.1f} s")
    for ok, msg in gates:
        check(ok, msg)
    return launches


def _ar_trig_extract(state):
    return {"sigsq_obs": state["sigsq_obs"],
            "blocks": {name: dict(v) for name, v in state["blocks"].items()},
            "alpha": state["alpha"][:, -1:]}


def phase10b_bsts_ar_trig(card):
    """bsts_ar_trig at full width with the TIM move: the intercept, the
    AR(2) (T a chain's) and the two-harmonic cycle (d = 7, T = 520); the
    proposal through J1 and J2; one float64 sweep of 33 chains against the
    CPU's (the card's proposal on both); AR_TRIG_CHAINS chains x
    (AR_TRIG_BURN + AR_TRIG_DRAWS) sweeps through the static K2w with a T a
    chain, K3 and K1w with a T a system, gated against the reference's run;
    log_lik and the errors of 200 draws. Returns the kernels' launch
    counts of the main path (the proposal's build and the run)."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.api import BstsModel
    from boom_tpu_torch.inference.driver import run_mcmc
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace import scan_kernel as sk
    from boom_tpu_torch.statespace.bsts import SWEEP_PHASES, Bsts

    t_phase = time.perf_counter()
    y_np = data.bsts_ar_trig()["y"]
    for counts in (kk.LAUNCHES, sk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fit = _ar_trig_builder().fit(y_np, niter=10, burn=5, num_chains=64,
                                 seed=1, marginal_sigma_slice=True,
                                 marginal_move="tim")
    torch.cuda.synchronize()
    model = fit._model
    mode, chol = model._tim_prop
    jets = {k: kk.LAUNCHES[k] for k in ("loglik_grad", "loglik_hess")}
    print(f"bsts_ar_trig front end on the card: the TIM proposal and a fit "
          f"(64 chains, 5 + 10 sweeps) in {time.perf_counter() - t0:.2f} s "
          f"({jets['loglik_grad']} J1, {jets['loglik_hess']} J2 launches); "
          f"mode {mode.tolist()}, chol diagonal {chol.diag().tolist()}")
    check(model.y.device.type == "cuda" and model.state_dim == 7
          and model._chain_t and not model.time_varying
          and len(model._sigma_groups()) == 3
          and jets["loglik_grad"] >= 1 and jets["loglik_hess"] >= 1,
          f"the bsts_ar_trig front end did not build its model and proposal "
          f"on the card: {jets}")

    def make(device):
        y = torch.tensor(y_np, dtype=torch.float64, device=device)
        m = Bsts(y=y, blocks=_ar_trig_builder()._build_blocks(y),
                 chains_hint=AR_TRIG_SWEEP_CHAINS)
        # the move with the card's proposal on both devices (a CPU build
        # would stop at another point of the mode search)
        object.__setattr__(m, "marginal_sigma_slice", True)
        object.__setattr__(m, "_tim_prop", tuple(
            t.to(device=device, dtype=torch.float64) for t in (mode, chol)))
        return m

    worst = _sweep_vs_cpu_of(make, AR_TRIG_SWEEP_CHAINS)
    print(f"bsts_ar_trig float64 sweep with the TIM move "
          f"C={AR_TRIG_SWEEP_CHAINS}: card vs CPU worst relative difference "
          f"{worst:.3e} (tolerance {SWEEP_TOL:g})")
    check(np.isfinite(worst) and worst <= SWEEP_TOL,
          f"the bsts_ar_trig sweep on the card disagrees: {worst:.3e}")

    for counts in (kk.LAUNCHES, sk.LAUNCHES):
        for k in counts:
            counts[k] = 0
    gen = prng.generator(AR_TRIG_SEED, "cuda")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda gn, c: model.init_state(model.draw_init_noise(gn,
                                                                        c)),
                   AR_TRIG_DRAWS, generator=gen, num_chains=AR_TRIG_CHAINS,
                   burn=AR_TRIG_BURN, extract=_ar_trig_extract)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t1
    launches = {k: kk.LAUNCHES[k] for k in ("smoother_wide", "dpath",
                                            "loglik_wide")}
    others = {k: v for k, v in {**kk.LAUNCHES, **sk.LAUNCHES}.items()
              if k not in launches and v}
    sweeps = AR_TRIG_BURN + AR_TRIG_DRAWS
    print(f"bsts_ar_trig: T={model.t_len} d=7 chains={AR_TRIG_CHAINS} "
          f"burn={AR_TRIG_BURN} draws={AR_TRIG_DRAWS} in {elapsed:.2f} s; "
          f"launches {launches}, other kernels {others}")
    check(launches["smoother_wide"] == sweeps + 1
          and launches["dpath"] >= sweeps
          and launches["loglik_wide"] >= sweeps and not others,
          f"the bsts_ar_trig run did not go through its kernels: "
          f"{launches}, {others}")
    launches.update(jets)

    d = res.draws
    ar, trig = d["blocks"]["ar2"], d["blocks"]["trig"]
    mon = torch.stack([d["sigsq_obs"], ar["phi"][..., 0], ar["phi"][..., 1],
                       ar["sigma_ar_sq"], trig["sigma_trig_sq"]],
                      dim=-1).double()
    check(bool(torch.isfinite(mon).all())
          and bool(torch.isfinite(d["alpha"]).all()),
          "non-finite bsts_ar_trig draws")
    gates, ess, rhat, per_draw = _gates_against(
        "bsts_ar_trig", mon, AR_TRIG_MONITOR, REFERENCE_MEDIANS_AR_TRIG,
        REFERENCE_RHAT_AR_TRIG, REFERENCE_MIN_ESS_PER_DRAW_AR_TRIG,
        AR_TRIG_DRAWS, AR_TRIG_CHAINS)
    print(f"bsts_ar_trig rate [{card}]: {sweeps / elapsed:.3f} sweeps/s, "
          f"min-ESS {float(ess.min()):.1f} ({per_draw:.5f} a draw, the "
          f"reference's {REFERENCE_MIN_ESS_PER_DRAW_AR_TRIG:.5f}), "
          f"min-ESS/s {float(ess.min()) / elapsed:.2f}, max R-hat "
          f"{float(rhat.max()):.4f}")
    _print_profile(f"bsts_ar_trig [{card}]", *_phase_profile(
        model, res.final_state, gen, AR_TRIG_CHAINS, "bsts", SWEEP_PHASES))
    fit = BstsModel(_model=model, _result=res)
    g, _ran = _ll_and_errors(model, fit._subsampled_states(
        0, AR_TRIG_LL_DRAWS), "loglik_wide", MONTHLY_TOL, "bsts_ar_trig")
    gates += g
    print(f"phase 10b took {time.perf_counter() - t_phase:.1f} s")
    for ok, msg in gates:
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


def _timed(label, fn, *args):
    """fn(*args), then ``phase <label> took X s``."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"phase {label} took {time.perf_counter() - t0:.1f} s")
    return out


def main():
    card = _timed("0", phase0_environment)
    import torch

    if sys.argv[1:] == ["--gate-check"]:
        try:
            phase1_build()
            return gate_check(card)
        except SmokeFailure as exc:
            print(f"chip_smoke --gate-check FAILED: {exc}", file=sys.stderr)
            return 1
    try:
        _timed("1", phase1_build)
        at_fit = _timed("2", phase2_kernels_vs_plain)
        at_llt = _timed("2b", phase2b_kalman_vs_plain)
        _timed("3 (the sweep against the CPU's)", phase3_sweep_vs_plain)
        launches = _timed("3 (the fit)", phase3_fit, card)
        llt_launches = _timed("4", phase4_bsts_llt, card)
        at_ssvs = _timed("2c", phase2c_ssvs_vs_plain)
        ssvs_launches = _timed("5", phase5_spike_slab, card)
        at_reg = _timed("2d", phase2d_wide_vs_plain)
        reg_launches, reg_rhat = _timed("6", phase6_bsts_reg, card)
        # phases 7, 2e and 8 print their own times, before their gates
        tim_launches = phase7_bsts_reg_tim(card, reg_rhat)
        at_tv = phase2e_tv_vs_plain()
        tv_launches = phase8_bsts_tv(card)
        at_hmm = phase2f_hmm_vs_plain()
        hmm_launches = phase9_baseline(card)
        # phases 2g, 10a and 10b print their own times, before their gates
        at_cal = phase2g_calendar_vs_plain()
        monthly_launches = phase10a_bsts_monthly(card)
        ar_trig_launches = phase10b_bsts_ar_trig(card)
        print(f"chip_smoke took {time.perf_counter() - T_START:.1f} s")
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
    for k, (name, replaces) in TIM_KERNELS.items():
        kernels.append({"name": name, "route": "cuda",
                        "source": WIDE_SOURCE, "replaces": replaces,
                        "launches": tim_launches[k], **at_llt[k],
                        "library_ms": None})
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
    for k, (name, source, replaces) in TV_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": tv_launches[k],
                        **at_tv[k], "library_ms": None})
    # library_ms: no PyTorch call computes an HMM recursion
    for k, (name, replaces) in HMM_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": HMM_SOURCE,
                        "replaces": replaces, "launches": hmm_launches[k],
                        **at_hmm[k], "library_ms": None})
    for k, (name, replaces) in CALENDAR_KERNELS.items():
        kernels.append({"name": name, "route": "cuda", "source": WIDE_SOURCE,
                        "replaces": replaces,
                        "launches": monthly_launches[k], **at_cal[k],
                        "library_ms": None})
    kernels.append({"name": CHAIN_T_KERNEL[0], "route": "cuda",
                    "source": WIDE_SOURCE, "replaces": CHAIN_T_KERNEL[1],
                    "launches": ar_trig_launches["loglik_wide"],
                    **at_cal["loglik_wide_chain_t"], "library_ms": None})
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
