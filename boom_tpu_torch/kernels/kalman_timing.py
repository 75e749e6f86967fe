"""Times of the sequential Kalman kernels on the card (K1, the loglik; K2,
the fused simulation smoother; csrc/kalman_seq.cu; K1w, the loglik for
7 <= d <= 16, J1 and J2, its derivatives along K directions, K2w, the
smoother for 7 <= d <= 16, and K3, the ASIS D-path; csrc/kalman_wide.cu),
beside their bounds and their plain versions, at the shapes of the
bsts_llt workload (K1, K2, J1, J2), of the bsts_reg workload (K2w, K3; K3
also at the bsts_llt D-path's shape, beside kernel (c)'s affine scan of
the same D-paths, their route before K3 took every d) and of bsts_reg
with the TIM move (K1 with a series a chain, K1w, J1 and J2 at d = 8; K1w
also at d = 13 and 16, in float64, and with a T a system).

    python3 boom_tpu_torch/kernels/kalman_timing.py                # JSON
    python3 boom_tpu_torch/kernels/kalman_timing.py --compare DIR  # both

Prints the card, the build time (all sources at once), per kernel the
device time (K2w's also by pass, from the profiler), the plain
version's time, the bound and what sets it, the times at other block sizes
and batches, the ``nvcc -Xptxas -v`` registers and spills of every
instantiation, and the instructions of K1's step loops (``cuobjdump
-sass``). ``--compare DIR`` runs this script on the package of the
checkout DIR (another commit of this repository, unpacked with ``git
archive``; its kernels build under DIR) and on this tree's in turns (DIR,
this, this, DIR; ``--rounds N``: N times over), each in its own process
on the same card, so that both trees take the same inputs at the same
shapes (``--tree DIR`` is one such run; ``--only NAMES`` times those
shapes alone), prints the times side by side, whether K1w's group
kernels compiled to the same instructions in both trees, and the time of
``nvcc`` on each tree's ``kalman_wide.cu`` alone, and with ``--json
PATH`` writes every number of the runs to PATH.
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
    # the package timed: this checkout's, or with --tree DIR the checkout
    # DIR's (``compare`` times another commit's kernels with this script)
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--tree") + 1])
                           .resolve() if "--tree" in sys.argv[:-1]
                           else Path(__file__).resolve().parents[2]))

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
# the marginal move's variances: the level, slope and observation
# variances of bsts_llt; the level, slope and seasonal ones of bsts_reg
# (its observation variance is the regression's)
TIM_GROUPS = 3
# name: (dtype, batch, d, T); "loglik" (K1) scores the TIM points of every
# chain (float32, the run's dtype), "smoother" (K2) imputes every chain
# (float64, bsts.SMOOTHER_DTYPE), "loglik_grad" (J1) and "loglik_hess" (J2)
# are one evaluation of the TIM proposal's mode search (float64, one
# series, TIM_GROUPS directions)
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

# bsts_reg with the TIM move (chip_smoke.py phase 7): name: (dtype, batch,
# d, T, series); K1 with a series a chain at the bsts_llt width (a trend
# and a regression: each chain's 17 points on its own y - X beta), K1w
# over phase 7's TIM points, J1 and J2 in its mode search (one series)
TIM_REG_SHAPES = {
    "loglik_per_chain": ("float32", LLT_CHAINS * TIM_POINTS, LLT_D, LLT_T,
                         LLT_CHAINS),
    "loglik_wide": ("float32", REG_CHAINS * TIM_POINTS, REG_D, REG_T,
                    REG_CHAINS),
    "loglik_grad_wide": ("float64", 1, REG_D, REG_T, 1),
    "loglik_hess_wide": ("float64", 1, REG_D, REG_T, 1)}
# K1w at phase 7's batch in its other layouts and dims, timed by this
# script alone (the plain version not timed): d = 13 (a trend and a
# monthly cycle), d = 8 with a T a system (the layout before Bsts kept T
# one matrix), and where K1w takes the group kernel: float64 at d = 8,
# float32 at d = 16
K1W_SHAPES = {
    "loglik_wide_d13": ("float32", REG_CHAINS * TIM_POINTS, 13, REG_T,
                        REG_CHAINS),
    "loglik_wide_own_t": ("float32", REG_CHAINS * TIM_POINTS, REG_D, REG_T,
                          REG_CHAINS),
    "loglik_wide_f64": ("float64", REG_CHAINS * TIM_POINTS, REG_D, REG_T,
                        REG_CHAINS),
    "loglik_wide_d16": ("float32", REG_CHAINS * TIM_POINTS, 16, REG_T,
                        REG_CHAINS)}
# the time-varying forms (z_t, h_t, Q_t with a q_t a chain: the Student
# trend's weights) at chip_smoke.py phase 8's shapes: name: (dtype, batch,
# d, T, series, T's kind: T_KINDS); K2w imputes every chain of bsts_tv (d
# = 13, a series a chain: y - X beta) over phase 8's T ("bsts", its
# structured form) and, at the same shape, with a T a chain (its dense
# form); K1w scores log_lik's 200 draws (each on its own series) over
# phase 8's T, as Bsts passes it, and with a T a draw, and over 4,096
# systems (the width a TIM move on a time-varying system would launch);
# K2 and K1 at the same widths at d = 4 (a Student trend and a 2-column
# dynamic regression: one T for all, as Bsts passes it)
TV_CHAINS, TV_T, TV_D, TV_DRAWS = 4096, 500, 13, 200
TV_SHAPES = {
    "smoother_wide_tv": ("float64", TV_CHAINS, TV_D, TV_T, TV_CHAINS,
                         "bsts"),
    "smoother_wide_tv_dense": ("float64", TV_CHAINS, TV_D, TV_T, TV_CHAINS,
                               "chain"),
    "loglik_wide_tv": ("float32", TV_DRAWS, TV_D, TV_T, TV_DRAWS, "bsts"),
    "loglik_wide_tv_own_t": ("float32", TV_DRAWS, TV_D, TV_T, TV_DRAWS,
                             "chain"),
    "loglik_wide_tv_wide": ("float32", TV_CHAINS, TV_D, TV_T, TV_CHAINS,
                            "bsts"),
    "smoother_tv": ("float64", TV_CHAINS, 4, TV_T, TV_CHAINS, "chain"),
    "loglik_tv": ("float32", TV_DRAWS, 4, TV_T, TV_DRAWS, "bsts")}
# the calendar's T_t (two matrices a chain, a step's choice: the monthly
# cycle's) at chip_smoke.py phase 10a's shapes: K2w's dense form imputes
# every chain of bsts_monthly (a semilocal trend's T a chain and the
# monthly cycle, d = 14, two years of days), K1w's form scores log_lik's
# 200 draws
MONTHLY_CHAINS, MONTHLY_T, MONTHLY_D = 4096, 730, 14
CALENDAR_SHAPES = {
    "smoother_wide_tv_calendar": ("float64", MONTHLY_CHAINS, MONTHLY_D,
                                  MONTHLY_T, 1, "calendar"),
    "loglik_wide_tv_calendar": ("float32", TV_DRAWS, MONTHLY_D, MONTHLY_T,
                                1, "calendar")}
# K1w with a T a system and one z for all at chip_smoke.py phase 10b's
# TIM batch (an intercept, an AR(2) whose T is each chain's and a
# two-harmonic cycle: d = 7, 520 weeks, 4096 chains x 17 points)
AR_TRIG_CHAINS, AR_TRIG_T, AR_TRIG_D = 4096, 520, 7
AR_TRIG_SHAPES = {
    "loglik_wide_chain_t": ("float32", AR_TRIG_CHAINS * TIM_POINTS,
                            AR_TRIG_D, AR_TRIG_T, 1)}
# the static K2 at K2's time-varying shape (d = 4, a series a chain; no
# mask), timed by this script alone (the plain version not timed) as
# that form's yardstick: (dtype, batch, d, T, series)
K2_TV_YARDSTICK = {"smoother_d4": ("float64", TV_CHAINS, 4, TV_T,
                                   TV_CHAINS)}
# the shapes whose systems share one T and one z, expanded over the batch
# as Bsts.ssm_params builds them (phase 7's K1w; K1w then reads them as
# broadcasts)
SHARED_SYSTEM = ("loglik_wide", "loglik_wide_d13", "loglik_wide_f64",
                 "loglik_wide_d16")
# the shapes whose systems share z alone (each has its own T)
SHARED_Z = ("loglik_wide_chain_t",)

# K1's block sizes (0: the grid laid out from the card's SM count); K2's
# block is one warp by design
BLOCK_SIZES = {"loglik": (0, 128, 256)}
# batches at which each kernel is also timed: K2 from one warp to one warp
# on each SM (the per-thread work is the same; the bytes grow 128x), K1 from
# a quarter to the full TIM batch
SCALING = {"loglik": (LLT_CHAINS * TIM_POINTS // 16,
                      LLT_CHAINS * TIM_POINTS // 4),
           "smoother": (32, 512)}


def _t_products(d, rows):
    """Operations of T's products a step: (T M [d, d] or M T', the upper
    triangle of (T M) T', T x [d]) over T's non-zeros ``rows`` (a count a
    row: each product's terms are T's non-zeros, a sum of n terms n - 1
    additions), or over every entry (``rows`` None, the dense count). The
    triangle takes whichever of its rows or columns is cheaper: entry (i,
    j) of T V is row i of T on column j of V."""
    rows = (d,) * d if rows is None else tuple(rows)
    nnz = sum(rows)
    vec = sum(2 * n - 1 for n in rows if n)  # T x
    upper = min(sum((d - i) * (2 * n - 1) for i, n in enumerate(rows) if n),
                sum((i + 1) * (2 * n - 1) for i, n in enumerate(rows) if n))
    return {"square": d * vec, "upper": upper, "vector": vec, "nnz": nnz}


def filter_step_flops(d, rows=None):
    """Floating-point operations of one filter step, the least the function
    needs (a multiply-add two): the symmetric Riccati step on the upper
    triangle, as K1w's thread kernel computes it. z'a and v; P z and f =
    z'P z + h; 1 / f, K = P z / f and a + K v; the rank-1 update of P's
    upper triangle; T P (d^3 multiply-adds); the upper triangle of
    (T P) T' and R Q R' added to it; T a. The dense step that the plain
    version and the group kernels compute, (T P) L' + R Q R' and its
    symmetrisation, is 4 d^3 + 8 d^2 + 3 d. ``rows``: T's non-zeros a row
    (a T shared by every chain, K2w's structured form), T's products over
    them alone (:func:`_t_products`); None counts every entry of T (the
    dense-symmetric count)."""
    upper = d * (d + 1) // 2
    tp = _t_products(d, rows)
    return ((2 * d - 1) + 1  # z'a, v
            + d * (2 * d - 1) + 2 * d  # P z, f
            + 1 + d + 2 * d  # 1 / f, K, a + K v
            + 2 * upper  # P - K (P z)'
            + tp["square"]  # T P
            + tp["upper"] + upper  # (T P) T' + R Q R'
            + tp["vector"])  # T a


def loglik_flops(batch, d, t_len, rows=None):
    """+ the log density a step; ``rows`` as :func:`filter_step_flops`."""
    return batch * t_len * (filter_step_flops(d, rows) + 7)


def smoother_flops(batch, d, t_len, rows=None):
    """The forward pass (filter on y - y+ and the simulation), the backward
    r pass and the forward state pass (alpha+ counted once). With ``rows``
    (T's non-zeros a row, :func:`filter_step_flops`) T's products run over
    them: the simulation's T alpha+, pass 2's L' r as T' r - z (K . r) and
    pass 3's T alpha-hat; R Q R' r stays dense."""
    if rows is None:
        step = (filter_step_flops(d) + 2 * d * d + 2 * d + 1
                + 4 * d * d + d + 1 + 4 * d * d)
    else:
        vec = _t_products(d, rows)["vector"]
        step = (filter_step_flops(d, rows) + vec + 3 * d + 1  # alpha+
                + vec + 5 * d  # pass 2
                + vec + 2 * d * d)  # pass 3
    return batch * t_len * step


def _jet_step_ops(d):
    """Jet operations of one filter step and log density: {kind: count}."""
    upper = d * (d - 1) // 2
    return {"scale": 2 * d + 4 * d * d + d ** 3 + upper + 1,
            "add": ((d - 1) + 1 + d * (d - 1) + (d - 1) + 1 + d * (d - 1)
                    + d * (d - 1) + d + d * d * (d - 1) + d * d
                    + d * d * (d - 1) + d * d + upper + 3),
            "mul": d + d ** 3 + 1, "div": d + 1, "log": 1}


def jet_step_flops(d, k):
    """Floating-point operations of one step of the loglik with its
    gradient and Hessian (J2's function): the filter step and the log
    density with every scalar a jet of value, gradient [k] and upper
    Hessian [k(k+1)/2] over k directions, counted per jet operation as a
    one-thread jet computes it (the work of the function, whatever
    implements it)."""
    hh = k * (k + 1) // 2
    cost = {"add": 1 + k + hh,  # jet +- jet, constant +- jet
            "scale": 1 + k + hh,  # constant * jet
            "mul": 1 + 3 * k + 7 * hh,  # jet * jet
            "div": 1 + 3 * k + 7 * hh,  # jet / jet
            "log": 1 + k + 3 * hh}
    return sum(cost[op] * n for op, n in _jet_step_ops(d).items())


def dual_step_flops(d, k):
    """The same for the loglik with its gradient alone (J1's function):
    first-order jets of value and gradient [k]."""
    cost = {"add": 1 + k, "scale": 1 + k, "mul": 1 + 3 * k,
            "div": 1 + 3 * k, "log": 1 + k}
    return sum(cost[op] * n for op, n in _jet_step_ops(d).items())


# a unit's dependent chain by assumed latencies (cycles) of an H100 SM: a
# float64 add, multiply or fma; a shared-memory load; a __syncwarp() with the
# stores before it; the correctly rounded float64 reciprocal (__drcp_rn:
# MUFU.RCP64H, two Newton steps and their fix-up)
JET_LATENCY = {"fp64": 8, "lds": 30, "sync": 20, "rcp": 60}
# the levels that a product of two tangents adds to a chain: a dual
# number's derivative x.a y.v + x.v y.a (a multiply, then an fma), a
# hyper-dual's second derivative (four terms)
TANGENT_LEVELS = {1: 2, 2: 4}
# an H100 SXM's boost clock
CLOCK_HZ = 1.98e9
# the same for the loglik's forms in float32 (an add, multiply or fma; the
# correctly rounded reciprocal, __frcp_rn)
LOGLIK_LATENCY = {"fp32": 4, "rcp32": 24}


def jet_floor_ms(d, k, order, t_len=LLT_T):
    """The latency floor of J1 (``order`` 1) or J2 (2) at state dimension d
    along k directions over T steps: a unit's dependent chain a step by
    JET_LATENCY, times T. The units (k or k (k + 1) / 2 a series) run side
    by side, so k does not lengthen it. A step's chain runs its sums as two
    partial sums (ceil(d / 2) + 1 levels each: P z, then z'P z after a
    barrier and a shared-memory load), the reciprocal (and its derivative
    part: one tangent product), and P' = T W - (T P z)(T P z)' / f + R Q
    R', two tangent products, a subtraction and an addition, all behind
    three barriers and two loads of the step's vectors."""
    lat, tl = JET_LATENCY, TANGENT_LEVELS[order]
    dot = -(-d // 2) + 1
    levels = dot + (dot + 1) + tl + 2 * tl + 2
    cycles = (lat["fp64"] * levels + lat["rcp"] + 2 * lat["lds"]
              + 3 * lat["sync"])
    return 1e3 * t_len * cycles / CLOCK_HZ


def loglik_floor_ms(d, t_len, dtype, layout):
    """The latency floor of the loglik's time-varying forms at state
    dimension d over T steps: a system's dependent chain a step by
    JET_LATENCY and LOGLIK_LATENCY, times T (the systems run side by side).
    ``layout`` "warp" (K1w's form, a warp a system): a job of phase 1 (two
    partial sums, ceil(d / 2) + 1 levels) behind a load, a barrier; T P z
    and z'P z the same, a barrier; f = z'P z + h_t, 1 / f, then P' = (T W -
    (T P z)(T P z)' / f) + R Q_t R' (three levels) behind a load, a
    barrier. "thread" (K1's, a thread a system, T P T' beside the chain):
    P z (d levels), f (d + 1), 1 / f, and P' = (T P T' - (T P z)(T P z)' /
    f) + R Q_t R' (three)."""
    f64 = dtype == "float64"
    fp = JET_LATENCY["fp64"] if f64 else LOGLIK_LATENCY["fp32"]
    rcp = JET_LATENCY["rcp"] if f64 else LOGLIK_LATENCY["rcp32"]
    lds, sync = JET_LATENCY["lds"], JET_LATENCY["sync"]
    if layout == "warp":
        dot = -(-d // 2) + 1
        cycles = (fp * (dot + (dot + 1) + 3) + rcp + 3 * lds + 3 * sync)
    elif layout == "thread":
        cycles = fp * (2 * d + 4) + rcp
    else:
        raise ValueError(f"no floor for layout {layout!r}")
    return 1e3 * t_len * cycles / CLOCK_HZ


def tv_step_flops(d):
    """The operations a time-varying system adds to a filter step: R Q_t R'
    = (u_t u_t') o R Q R' on the upper triangle (two products an entry)
    and h_t = h s_t."""
    return d * (d + 1) + 1


def bound_ms(name, dtype, batch, d, t_len, series=1, k=TIM_GROUPS,
             tv_rows=0, rows=None, q=None, calendar=False):
    """The least time the card could take: each input read once and each
    output written once over the memory rate, or the operations over the
    float rate, whichever is larger. Returns (ms, "bytes" | "operations").
    K1 and K1w ("loglik") read a system a series and ``series`` rows of y,
    write one loglik a series; J1 and J2 ("loglik_grad", "loglik_hess")
    also read ``k`` directions and write a gradient [k] (J1) and a Hessian
    [k, k] (J2); K2 (and K2w:
    ``name`` "smoother") reads a system, alpha_1, eta [T-1, q] and eps [T]
    a chain (the normals it takes; q, the state errors, ``q`` or d) and
    writes the draw [T, d] (its scratch is not counted); K3
    ("dpath", ``batch`` the chains x groups) reads w [T-1, d] and writes
    D [T, d] a series (T, d x d a chain, is counted in the caller's
    ``dpath_bound_ms``). ``tv_rows`` > 0: a time-varying system (K1 and K2
    "loglik" and "smoother", and their wide forms) that also reads z_t [T,
    d], h_scale [T] and ``tv_rows`` rows of q_t [T, q] (the batch's, or
    one for all), and forms R Q_t R' and h_t a step (:func:`tv_step_flops`;
    twice in the smoother: its forward and its state pass). ``rows``: T's
    non-zeros a row where every system shares T (the structured forms of
    the smoother and of the time-varying loglik), the operations over them
    (:func:`smoother_flops`, :func:`loglik_flops`); T itself is then read
    once, not a system. ``calendar``: the calendar's T_t, a second T a
    system and a step's choice (a byte a step) read too."""
    item = 8 if dtype == "float64" else 4
    q = d if q is None else q
    system = 3 * d * d + 2 * d + 1  # z, T, RQR, h, a0 or alpha1, P0
    tv_bytes = (t_len * d + t_len + tv_rows * t_len * q) * item \
        if tv_rows else 0
    shared_t = 0 if rows is None else (batch - 1) * d * d
    if calendar:
        tv_bytes += batch * d * d * item + t_len
    if name == "loglik":
        n_bytes = (batch * (system + 1) - shared_t
                   + series * t_len) * item + tv_bytes
        flops = loglik_flops(batch, d, t_len, rows)
        if tv_rows:
            flops += batch * t_len * tv_step_flops(d)
    elif name in ("loglik_grad", "loglik_hess"):
        hess = name == "loglik_hess"
        n_bytes = (batch * (system + 1 + k + hess * k * k) + k * (1 + d * d)
                   + series * t_len) * item
        flops = batch * t_len * (jet_step_flops(d, k) if hess
                                 else dual_step_flops(d, k))
    elif name == "smoother":
        n_bytes = (batch * (system + (t_len - 1) * q + t_len + t_len * d)
                   - shared_t + series * t_len) * item + tv_bytes
        flops = smoother_flops(batch, d, t_len, rows)
        if tv_rows:
            flops += 2 * batch * t_len * tv_step_flops(d)
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
    return SsmParams(*(None if f is None else
                       f.repeat_interleave(reps, dim=0)[:batch].contiguous()
                       for f in base))


def bsts_transition(d):
    """(T [d, d], R [d, q]) of bsts blocks at state dimension d: a local
    linear trend ([[1, 1], [0, 1]], both rows' errors; a local level at d =
    1), a seasonal cycle of min(6, d - 2) rows (a row of -1s, then a
    shift; the top row's error) and an identity for the rest (a dynamic
    regression's and a holiday's, every row's error); at d = 13 phase 8's
    T (its Student trend, 7-day cycle, two regression columns and 3-day
    holiday: 19 non-zeros) and R (q = 8)."""
    t_mat = np.zeros((d, d))
    trend = min(2, d)
    t_mat[:trend, :trend] = np.triu(np.ones((trend, trend)))
    rows = list(range(trend))
    s = min(6, d - trend)
    if s > 0:
        t_mat[trend, trend:trend + s] = -1.0
        for k in range(1, s):
            t_mat[trend + k, trend + k - 1] = 1.0
        rows.append(trend)
    for k in range(trend + max(s, 0), d):
        t_mat[k, k] = 1.0
        rows.append(k)
    return t_mat, np.eye(d)[:, rows]


def shared_transition(rng, d, kind):
    """A T [d, d] for every system: "bsts" (:func:`bsts_transition`),
    "sparse" (a random pattern of about a quarter of the entries, row 1
    empty and row d - 2 full, from d = 2) or "dense", the random ones
    scaled to a spectral radius of 0.97 at most."""
    if kind == "bsts":
        return bsts_transition(d)[0]
    t_mat = rng.normal(size=(d, d))
    if kind == "sparse":
        t_mat *= rng.uniform(size=(d, d)) < 0.25
        if d >= 2:
            t_mat[1] = 0.0
            t_mat[d - 2] = rng.normal(size=d)
    radius = max(abs(np.linalg.eigvals(t_mat)).max(), 1e-3)
    return t_mat * min(1.0, 0.97 / radius)


# K2w's time-varying systems: T a chain (its dense form), or one T for all
# (its structured form) with bsts' pattern, a random one or a dense one
T_KINDS = ("chain", "bsts", "sparse", "dense")
# the calendar's T_t (:func:`calendar_system`): two matrices a chain, or two
# for every chain
CALENDAR_KINDS = ("calendar", "calendar_shared")


def calendar_choice(t_len):
    """[T] int64: 1 on the steps t -> t + 1 that enter a new month of a
    daily series from 2022-01-01 (the monthly cycle's rotation), and on
    steps 0 and T - 2 (the edges of the recursions), else 0."""
    import datetime

    first = datetime.date(2022, 1, 1)
    choice = np.asarray([(first + datetime.timedelta(days=t + 1)).day == 1
                         for t in range(t_len)], dtype=np.int64)
    choice[0] = 1
    choice[max(t_len - 2, 0)] = 1
    return choice


def calendar_system(rng, batch, d, t_len, dtype, t_kind="calendar",
                    q_mode="chain", device="cuda"):
    """A :func:`time_varying_system` (its T a system) with the calendar's
    T_t: t_mats [B, 2, d, d], the system's T and a random stable matrix,
    the second one a system ("calendar") or one for all, expanded
    ("calendar_shared", where T is one for all too), and t_choice
    (:func:`calendar_choice`)."""
    import torch

    tdt = getattr(torch, dtype)
    params = time_varying_system(rng, batch, d, t_len, dtype, q_mode,
                                 device=device)
    if t_kind == "calendar_shared":
        one = torch.tensor(np.stack([shared_transition(rng, d, "dense")
                                     for _ in range(2)]), dtype=tdt,
                           device=device)
        params = params._replace(t_mat=one[0][None].expand(batch, d, d))
        mats = one[None].expand(batch, 2, d, d)
    else:
        other = torch.tensor(np.stack([shared_transition(rng, d, "dense")
                                       for _ in range(min(batch, 64))]),
                             dtype=tdt, device=device)
        other = other.repeat(-(-batch // other.shape[0]), 1, 1)[:batch]
        mats = torch.stack([params.t_mat, other], dim=1)
    return params._replace(t_mats=mats, t_choice=torch.as_tensor(
        calendar_choice(t_len), device=device))


def state_errors(d, t_kind):
    """q, the state errors of a :func:`time_varying_system` at d: bsts' R's
    columns for a "bsts" T, else max(1, d - 1)."""
    return bsts_transition(d)[1].shape[1] if t_kind == "bsts" \
        else max(1, d - 1)


def time_varying_system(rng, batch, d, t_len, dtype, q_mode="chain",
                        device="cuda", t_kind="chain"):
    """``batch`` stable systems (64 random ones, repeated) made
    time-varying as bsts' blocks make them: z_t [T, d] one for every system
    (expanded), h_scale [T] in [0.3, 1.5), and q_scale of the q = max(1, d
    - 1) state errors (R the first q rows of the identity, a selection
    whose last row is zero) in [0.5, 2): one a system ("chain", [B, T, q]),
    one for all ("shared", [T, q] expanded) or none (None). ``t_kind``
    (T_KINDS): T a system, or one T expanded over the systems as
    Bsts.ssm_params gives it (:func:`shared_transition`; "bsts" also takes
    bsts' R and its q)."""
    import torch

    from boom_tpu_torch.statespace.kalman import SsmParams

    tdt = getattr(torch, dtype)
    r_bsts = bsts_transition(d)[1] if t_kind == "bsts" else None
    q = state_errors(d, t_kind)
    base = random_system(rng, min(batch, 64), d, tdt, q=q, device=device)
    reps = -(-batch // base.z.shape[0])
    params = SsmParams(*(None if f is None else
                         f.repeat_interleave(reps, dim=0)[:batch].contiguous()
                         for f in base))
    if t_kind != "chain":
        one = torch.tensor(shared_transition(rng, d, t_kind), dtype=tdt,
                           device=device)
        params = params._replace(t_mat=one[None].expand(batch, d, d))
    if r_bsts is not None:
        params = params._replace(r_mat=torch.tensor(
            r_bsts, dtype=tdt, device=device)[None].expand(batch, d, q))

    def rand(lo, hi, shape):
        return torch.tensor(rng.uniform(lo, hi, size=shape), dtype=tdt,
                            device=device)

    zt = torch.tensor(rng.normal(size=(t_len, d)), dtype=tdt, device=device)
    q_scale = {None: None, "shared": rand(0.5, 2.0, (1, t_len, q)).expand(
        batch, t_len, q), "chain": rand(0.5, 2.0, (batch, t_len, q))}[q_mode]
    return params._replace(z=zt[None].expand(batch, t_len, d),
                           h_scale=rand(0.3, 1.5, (t_len,)), q_scale=q_scale)


def kalman_cases(rng, name, dtype, batch, d, t_len, series=1):
    """(kernel call, plain call, wrapper call) for one kernel on inputs of
    its shape. The kernel call launches the kernel on prepared operands;
    the plain call is the plain PyTorch function of the same inputs (for
    J1 and J2: autograd of the plain loglik, ``kalman.loglik_jets``, along
    TIM_GROUPS random directions); the wrapper call is the public function
    on the card, with the operands' preparation (none for J1 and J2, which
    autograd reaches). ``series``: the loglik's rows of y (a series a
    group of batch / series systems). The systems of a shape in
    SHARED_SYSTEM share T and z, expanded over the batch."""
    import torch

    from boom_tpu_torch.kernels.host_rehearsal import directions
    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    tdt = getattr(torch, dtype)
    params = system(rng, batch, d, dtype)
    if name in SHARED_SYSTEM:
        params = params._replace(t_mat=params.t_mat[:1].expand(batch, d, d),
                                 z=params.z[:1].expand(batch, d))
    if name in SHARED_Z:
        params = params._replace(z=params.z[:1].expand(batch, d))
    shape = (series, t_len) if series > 1 else (t_len,)
    y = torch.tensor(rng.normal(size=shape).cumsum(-1), dtype=tdt,
                     device="cuda")
    fields = (params.h, params.rqr.contiguous(), params.z, params.t_mat,
              params.a0, params.p0, y, None)
    if name.startswith("loglik_grad") or name.startswith("loglik_hess"):
        order = 2 if name.startswith("loglik_hess") else 1
        dirs = tuple(x.to("cuda") for x in directions(rng, TIM_GROUPS, d))
        return (lambda: kk.launch_jets(*fields, *dirs, order=order),
                lambda: kalman.loglik_jets(*fields, *dirs, order), None)
    if name.startswith("loglik"):
        return (lambda: kk.launch_loglik(*fields),
                lambda: kalman.kalman_loglik(params, y),
                lambda: kk.kalman_loglik(params, y))
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


_WIDE_PASS = re.compile(r"smoother_wide(?:_nz)?_kernel<\d+, (\d)"
                        r"(?:, (?:false|true))?>")


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


def transition_rows(d, t_kind):
    """T's non-zeros a row of a shared T of kind ``t_kind`` that the bound
    counts (bsts': :func:`bsts_transition`), or None (every entry)."""
    if t_kind != "bsts":
        return None
    return tuple(int(n) for n in (bsts_transition(d)[0] != 0).sum(1))


def _no_host_read(kk, fn):
    """``fn`` with R taken as the 0/1 selection it is (kalman_kernel
    ._is_selection, a read of the host a call, answered without one, as
    where a model's pattern vouches for its R): a timed call that never
    waits on the host, in either tree of a comparison."""
    def call():
        saved = kk._is_selection
        kk._is_selection = lambda r: True
        try:
            return fn()
        finally:
            kk._is_selection = saved
    return call


def tv_cases(rng, name, dtype, batch, d, t_len, series, q_mode="chain",
             t_kind="chain"):
    """(kernel call, plain call, wrapper call) of a time-varying form (K1 or
    K1w with the innovations: "loglik_tv", "loglik_wide_tv"; K2 or K2w:
    "smoother_tv", "smoother_wide_tv") on a :func:`time_varying_system` of
    its shape and ``t_kind``, a mask of ~5 % gaps and ``series`` series
    (the smoothers' a chain's through eps, as bsts with a regression gives
    them). The loglik's kernel call takes a shared T's pattern, found once
    here, as Bsts passes its own (where the tree's wrapper takes one), and
    reads nothing of the host (:func:`_no_host_read`)."""
    import inspect

    import torch

    from boom_tpu_torch.statespace import kalman
    from boom_tpu_torch.statespace import kalman_kernel as kk

    tdt = getattr(torch, dtype)
    if t_kind in CALENDAR_KINDS:
        params = calendar_system(rng, batch, d, t_len, dtype, t_kind, q_mode)
    else:
        params = time_varying_system(rng, batch, d, t_len, dtype, q_mode,
                                     t_kind=t_kind)
    shape = (series, t_len) if series > 1 else (t_len,)
    y = torch.tensor(rng.normal(size=shape).cumsum(-1), dtype=tdt,
                     device="cuda")
    obs = torch.tensor(rng.uniform(size=t_len) > 0.05, device="cuda")
    if name.startswith("loglik"):
        kw = {}
        if (t_kind not in ("chain",) + CALENDAR_KINDS and "pattern" in
                inspect.signature(kk.launch_loglik_tv).parameters):
            kw["pattern"] = kk.TransitionPattern(params.t_mat[0],
                                                 params.r_mat[0])
        return (_no_host_read(kk, lambda: kk.launch_loglik_tv(
                    params, y, obs, innovations=True, **kw)),
                lambda: kalman.kalman_loglik(params, y, obs,
                                             innovations=True),
                lambda: kk.innovations(params, y, obs))
    q = params.q_mat.shape[-1]
    normals = [torch.tensor(rng.normal(size=s), dtype=tdt, device="cuda")
               for s in ((batch, d), (batch, t_len - 1, q),
                         (batch, t_len))]
    operands = kk.smoother_operands(params, y, *normals, observed=obs)
    return (lambda: kk.launch_smoother(*operands),
            lambda: kalman.simulation_smoother(params, y, *normals,
                                               observed=obs),
            lambda: kk.simulation_smoother(params, y, *normals,
                                           observed=obs))


def time_tv(rng, plain=True, shapes=None):
    """{kernel: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    bound_dense_ms, floor_ms, shape, pass_ms}} of the time-varying forms at
    TV_SHAPES (or ``shapes``); bound_dense_ms: the bound with every entry
    of T counted (the dense-symmetric step), beside the one over T's
    non-zeros; floor_ms: the loglik's latency floor
    (:func:`loglik_floor_ms`: K1w's warp, K1's thread); pass_ms: K2w's
    passes."""
    out = {}
    for name, (dtype, batch, d, t_len, series, t_kind) in (
            TV_SHAPES if shapes is None else shapes).items():
        kern, ref, wrapper = tv_cases(rng, name, dtype, batch, d, t_len,
                                      series, t_kind=t_kind)
        row = {"shape": [dtype, batch, d, t_len, series, t_kind],
               "ms": median_ms(kern), "call_ms": call_ms(kern),
               "wrapper_ms": median_ms(wrapper),
               "plain_ms": median_ms(ref, reps=3, per=1) if plain else None}
        if name.startswith("loglik"):
            row["floor_ms"] = loglik_floor_ms(
                d, t_len, dtype, "warp" if d >= 7 else "thread")
        kind = "loglik" if name.startswith("loglik") else "smoother"
        q = state_errors(d, t_kind)
        cal = t_kind in CALENDAR_KINDS
        row["bound_ms"], row["bound_by"] = bound_ms(
            kind, dtype, batch, d, t_len, series, tv_rows=batch,
            rows=transition_rows(d, t_kind), q=q, calendar=cal)
        row["bound_dense_ms"] = bound_ms(kind, dtype, batch, d, t_len,
                                         series, tv_rows=batch, q=q,
                                         calendar=cal)[0]
        if name.startswith("smoother_wide"):
            row["pass_ms"] = wide_pass_ms(kern)
        out[name] = row
    return out


def _bound_name(name):
    """bound_ms's name of a shape's kernel (loglik_wide -> loglik, ...)."""
    for kind in ("loglik_grad", "loglik_hess", "loglik", "smoother"):
        if name.startswith(kind):
            return kind
    return name


def time_kalman(rng, plain=True, shapes=None):
    """{kernel: {ms, wrapper_ms, plain_ms, call_ms, bound_ms, bound_by,
    shape, block_ms, scaling_ms}} at SHAPES and TIM_REG_SHAPES (or
    ``shapes``): device times of the kernel (at the wrapper's block size,
    at the others of BLOCK_SIZES, and at the smaller batches of SCALING),
    of the whole wrapper and of the plain version."""
    from boom_tpu_torch.statespace import kalman_kernel as kk

    if shapes is None:
        shapes = {**{k: (*v, 1) for k, v in SHAPES.items()},
                  **TIM_REG_SHAPES}
    out = {}
    for name, (dtype, batch, d, t_len, series) in shapes.items():
        kern, ref, wrapper = kalman_cases(rng, name, dtype, batch, d, t_len,
                                          series)
        # the jets' plain version (autograd of the plain loop, seconds a
        # call) is timed by one call on the host clock: it is no yardstick
        if not plain:
            plain_ms = None
        elif wrapper is None:
            plain_ms = call_ms(ref)
        else:
            plain_ms = median_ms(ref, reps=3, per=1)
        row = {"shape": [dtype, batch, d, t_len]
               + ([series] if series > 1 else []),
               "ms": median_ms(kern), "call_ms": call_ms(kern),
               "wrapper_ms": median_ms(wrapper) if wrapper else None,
               "plain_ms": plain_ms}
        row["bound_ms"], row["bound_by"] = bound_ms(
            _bound_name(name), dtype, batch, d, t_len, series)
        if _bound_name(name) in ("loglik_grad", "loglik_hess"):
            order = 2 if name.startswith("loglik_hess") else 1
            row["floor_ms"] = jet_floor_ms(d, TIM_GROUPS, order, t_len)
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


_KERNEL_NAME = re.compile(r"(loglik_kernel|loglik_tv_kernel|smoother_kernel)"
                          r"I(?:([fd]))?Li(\d)E(?:Lb([01])E)?(?:Lb([01])E)?")


def _instantiation(mangled):
    """"<kernel> <type> d<D>[ dense][ per-series]" of a mangled
    kalman_seq.cu kernel name (K1's instantiations without a mask end in
    " dense", those reading a series a group of systems in " per-series";
    the time-varying forms are "loglik_tv <type> d<D>" and "smoother f64
    d<D> tv"), or None."""
    m = _KERNEL_NAME.search(mangled)
    if not m:
        return None
    kernel, ty, d, first, shared = m.groups()
    kind = {"loglik_kernel": "loglik", "loglik_tv_kernel": "loglik_tv",
            "smoother_kernel": "smoother"}[kernel]
    key = f"{kind} {'f32' if ty == 'f' else 'f64'} d{d}"
    if kind == "smoother":
        return key + " tv" if first == "1" else key
    key += " dense" if first == "0" else ""
    return key + " per-series" if shared == "0" else key


_WIDE_NAME = re.compile(r"(smoother_wide_kernel|smoother_wide_nz_kernel|"
                        r"dpath_kernel)I(?:([fd]))?Li(\d+)ELi(\d+)E"
                        r"(?:Lb([01])E)?")
# K1w's group kernel <T, D, tv>; before it lost the jets' paths <T, S, D,
# order, tv>, S a Tangent in J1 and J2
_GROUP_NAME = re.compile(r"wide_loglik_kernelI([fd])(?:[fd]|N\w*?TangentI[fd]"
                         r"Li\dEEE)?Li(\d+)E(?:Li(\d)E)?(?:Lb([01])E)?")
_THREAD_NAME = re.compile(r"loglik_thread_kernelILi(\d+)ELb([01])E")
# K1w's time-varying form, a warp a system <T, D>
_TV_WARP_NAME = re.compile(r"loglik_tv_warp_kernelI([fd])Li(\d+)E")
_JET_NAME = re.compile(r"jet_warp_kernelILi(\d+)ELi([12])E")
_JET_NAMES = {"1": "loglik_grad", "2": "loglik_hess"}


def _wide_key(name):
    """The report's key of a mangled kalman_wide.cu kernel name, or None."""
    w = _TV_WARP_NAME.search(name)
    if w:
        ty, d = w.groups()
        return f"loglik_wide {'f32' if ty == 'f' else 'f64'} d{int(d):02d} tv"
    t = _THREAD_NAME.search(name)
    if t:
        d, shared = t.groups()
        return (f"loglik_wide f32 d{int(d):02d} thread "
                f"{'shared-T' if shared == '1' else 'own-T'}")
    g = _GROUP_NAME.search(name)
    if g:  # K1w's group kernel (and, in trees before the jets' own, J1, J2)
        ty, d, order, tv = g.groups()
        if order not in (None, "0"):
            return f"{_JET_NAMES[order]} f64 d{int(d):02d}"
        return (f"loglik_wide {'f32' if ty == 'f' else 'f64'} d{int(d):02d}"
                + (" tv" if tv == "1" else ""))
    j = _JET_NAME.search(name)
    if j:
        d, order = j.groups()
        return f"{_JET_NAMES[order]} f64 d{int(d):02d}"
    m = _WIDE_NAME.search(name)
    if not m:
        return None
    kernel, ty, d, extra, tv = m.groups()
    if kernel == "smoother_wide_nz_kernel":
        return f"smoother_wide f64 d{int(d):02d} pass{extra} tv nz"
    if kernel == "smoother_wide_kernel":
        return (f"smoother_wide f64 d{int(d):02d} pass{extra}"
                + (" tv" if tv == "1" else ""))
    return f"dpath {'f32' if ty == 'f' else 'f64'} d{int(d):02d} chunk{extra}"


def wide_nvcc_report(log_text):
    """{"smoother_wide f64 d<D> pass<P>" | "dpath <type> d<D> chunk<B>" |
    "loglik_wide <type> d<D>" | "loglik_wide f32 d<D> thread
    shared-T|own-T" | "loglik_grad f64 d<D>" | "loglik_hess f64 d<D>":
    {"registers", "spill_bytes", "stack_bytes"}} for every instantiation
    of K2w (each of its three passes), K3 (each chunk length, bytes a
    lane), K1w (its group kernel, and its thread kernel in either layout
    of T), J1 and J2 in kalman_wide.cu's ``nvcc -Xptxas -v`` log; the
    time-varying forms of K2w and K1w end in " tv", K2w's structured one
    (over T's non-zeros) in " tv nz"."""
    report = {}
    for name, (nregs, stack, spill) in ptxas_entries(log_text).items():
        key = _wide_key(name)
        if key is not None:
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
    K1 in a ``cuobjdump -sass`` listing of kalman_seq.cu: of
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


_SASS_INSTRUCTION = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;")
_SASS_PARAM = re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]")


def sass_digests(sass_text, prefix="loglik_wide"):
    """{key: {"instructions": n, "sha1": digest}} for the kernels of a
    ``cuobjdump -sass`` listing of kalman_wide.cu whose report key
    (:func:`wide_nvcc_report`'s) starts with ``prefix``: each instruction
    as listed (opcode, registers, predicates, branch targets), with every
    constant-bank offset of bank 0 (where the kernel's parameters sit)
    read as one, so two builds whose kernels differ only in their list of
    parameters give the same digest."""
    import hashlib

    funcs, key = {}, None
    for line in sass_text.splitlines():
        if "Function :" in line:
            key = _wide_key(line.split("Function :", 1)[1].strip())
            key = key if key and key.startswith(prefix) else None
            if key is not None:
                funcs[key] = []
            continue
        m = _SASS_INSTRUCTION.search(line)
        if key is not None and m:
            funcs[key].append(_SASS_PARAM.sub("c[0x0][P]", m.group(1)))
    return {k: {"instructions": len(v), "sha1": hashlib.sha1(
        "\n".join(v).encode()).hexdigest()} for k, v in sorted(funcs.items())}


def proposal_walls(reps=3):
    """{"phase4" | "phase7": {"s": [wall seconds of each build], "launches":
    {J1, J2: count of one build}}}: the TIM proposal built on the card as
    chip_smoke.py's phases 4 (bsts_llt on the bench's series) and 7
    (bsts_reg with the move, on its committed data) build it, ``reps``
    times each, on the host clock around the model's construction."""
    import torch

    from boom_tpu_torch import data
    from boom_tpu_torch.models.glm.regression import SpikeSlabPrior
    from boom_tpu_torch.statespace import kalman_kernel as kk
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import (
        LocalLinearTrend,
        Seasonal,
    )

    y_llt = torch.tensor(data.bsts_llt_series(), device="cuda")
    x_all, y_np = data.bsts_reg_xy()
    x = torch.tensor(x_all[:REG_T], device="cuda")
    y = torch.tensor(y_np, device="cuda")
    builds = {
        "phase4": lambda: Bsts(y=y_llt,
                               blocks=[LocalLinearTrend.default(y_llt)],
                               marginal_sigma_slice=True,
                               marginal_move="tim"),
        "phase7": lambda: Bsts(
            y=y, blocks=[LocalLinearTrend.default(y),
                         Seasonal.default(y, nseasons=7)],
            predictors=x, reg_prior=SpikeSlabPrior.from_data(
                x, y, expected_model_size=1.0, prior_information_weight=1.0),
            chains_hint=REG_CHAINS, marginal_sigma_slice=True,
            marginal_move="tim")}
    out = {}
    for name, build in builds.items():
        walls = []
        for _ in range(reps):
            before = dict(kk.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            build()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out[name] = {"s": walls, "launches": {
            k: kk.LAUNCHES[k] - before[k] for k in kk.JET_KINDS.values()}}
    return out


def run(only=None):
    """Build this tree's kernels and time them (``only``: the shapes of
    these names, and "proposal" for :func:`proposal_walls`); returns a
    JSON-able dict."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kalman_timing: needs a CUDA card")
    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.statespace import kalman_kernel as kk

    def pick(shapes):
        return {k: v for k, v in shapes.items()
                if only is None or k in only}

    t0 = time.perf_counter()
    _build.build()
    rng = np.random.default_rng(20261016)
    kernels = {**time_kalman(rng, shapes=pick(
                   {**{k: (*v, 1) for k, v in SHAPES.items()},
                    **TIM_REG_SHAPES})),
               **time_kalman(rng, plain=False, shapes=pick(K1W_SHAPES))}
    if only is None:
        kernels.update(time_wide(rng))
    if hasattr(kk, "launch_loglik_tv"):  # a tree with the time-varying forms
        kernels.update(time_tv(rng, plain=False, shapes=pick(TV_SHAPES)))
        kernels.update(time_kalman(rng, plain=False,
                                   shapes=pick(K2_TV_YARDSTICK)))
    out = {"card": card_line(), "build_s": time.perf_counter() - t0,
           "kernels": kernels}
    if only is not None and "proposal" in only:
        out["proposal"] = proposal_walls()
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
        sass = subprocess.run([str(cuobjdump), "-sass",
                               str(_build.library_path("kalman_wide"))],
                              capture_output=True, text=True, timeout=300)
        out["sass_digest"] = sass_digests(sass.stdout)
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


def compare(parent, here, json_path=None, only=None, rounds=1):
    """Runs parent, here, here, parent (``rounds`` times): this script in a
    fresh process on each tree's package (its kernels, built under it, its
    wrappers and its plain versions; these shapes, inputs and bounds;
    ``only``: as :func:`run` takes it), and prints the kernels' times side
    by side (and the proposal builds' walls), whether K1w's group kernels
    compiled to the same instructions in both trees
    (:func:`sass_digests`), then times ``nvcc`` on each tree's
    ``kalman_wide.cu`` alone."""
    runs = []
    extra = [] if only is None else ["--only", ",".join(only)]
    for label, tree in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)) * rounds:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--tree", str(tree), *extra],
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
        floor = (f", floor {cur['floor_ms']:.4f} ms"
                 if "floor_ms" in cur else "")
        print(f"{name} {cur['shape']}: kernel (P C C P x {rounds}) "
              f"{seq('ms')} ms, "
              f"host-clock call {seq('call_ms')} ms, bound "
              f"{cur['bound_ms']:.5f} ms ({cur['bound_by']}){floor}")
        for lab, r in (runs[0], runs[1]):
            row = r["kernels"].get(name, {})
            extra = {k: row[k] for k in ("block_ms", "scaling_ms",
                                         "pass_ms", "plain_ms", "wrapper_ms")
                     if row.get(k) is not None}
            print(f"  {lab}: {json.dumps(extra)}")
    for build in runs[0][1].get("proposal", {}):
        print(f"proposal {build}: " + " / ".join(
            f"{lab} {', '.join(f'{w:.3f}' for w in r['proposal'][build]['s'])}"
            f" s ({r['proposal'][build]['launches']})" for lab, r in runs))
    digests = [r.get("sass_digest", {}) for _, r in runs[:2]]
    for inst in sorted(set(digests[0]) | set(digests[1])):
        p, c = (dg.get(inst) for dg in digests)
        same = "the same" if p == c else "differ"
        print(f"sass {inst}: parent {p and p['instructions']}, change "
              f"{c and c['instructions']} instructions, {same}")
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
    ap.add_argument("--tree", type=Path,
                    help="time the package of this checkout instead")
    ap.add_argument("--only",
                    help="comma-separated shape names to time (and "
                         "'proposal': the TIM proposal builds' walls)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="with --compare: parent, this, this, parent so "
                         "many times")
    args = ap.parse_args()
    only = None if args.only is None else args.only.split(",")
    if args.compare:
        here = Path(__file__).resolve().parents[2]
        compare(args.compare.resolve(), here, args.json, only, args.rounds)
    else:
        print(json.dumps(run(only)))


if __name__ == "__main__":
    main()
