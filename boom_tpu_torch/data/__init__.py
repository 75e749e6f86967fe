"""Data the port's checks run on, committed so that nothing of the port
needs JAX to make them (numpy only).

- ``bsts_llt_y.txt``: the series of the reference's bsts_llt bench
  workload, y [500] in float32, drawn by ``bench.py:171-175`` from
  ``jax.random.key(4207)``; one ``float.hex`` a line, so that it reads back
  exactly. ``tests/test_torch_bench_series.py`` remakes it with JAX and
  compares, and writes it when run as a script.
- ``spike_slab_xy.npz``: the design x [2000, 50] and response y [2000],
  float32, of the reference's spike_slab bench workload, drawn by
  ``bench.py:133-138`` (``SpikeSlabRegression.simulate`` on the first half
  of ``jax.random.split(jax.random.key(20260817))``, x64 off).
  ``tests/test_torch_spike_slab_data.py`` remakes them with JAX and
  compares, and writes the file when run as a script.
- ``bsts_reg.npz``: the bsts_reg configuration's predictors x [530, 20]
  and series y [500], float32, drawn with JAX (x64 off) from
  ``jax.random.key(2026)``: x iid N(0, 1); a local linear trend (level
  innovation sd 0.1, slope innovation sd 0.01); a 7-season dummy seasonal
  (initial pattern sd 1, innovation sd 0.05); beta = (3, -2, 1.5, 1,
  0 x 16); y = trend + seasonal + x[:500] beta + N(0, 0.5^2). Rows 0-499
  of x are the fit's, rows 500-529 the forecast's future predictors.
  ``tests/test_torch_bsts_reg_data.py`` remakes them with JAX and
  compares, and writes the file when run as a script.
- ``bsts_tv.npz``: the bsts_tv configuration's data, made with numpy
  alone by :func:`make_bsts_tv` (``tests/test_torch_bsts_tv_data.py``
  remakes it and compares, and writes the file when run as a script): a
  daily series on a grid of 500 days, with about 5 % of the days dropped
  and about 2 % observed twice (``timestamps`` [n] in days, ``y`` [n],
  float32); its signal is a local linear trend with Student-t (3 df)
  innovations (level sd 0.1, slope sd 0.01), a 7-day dummy seasonal, two
  dynamic regressors ``x_dyn`` [530, 2] whose coefficients are random
  walks (sd 0.02), a 3-day holiday window recurring every ~60 days
  (``active`` [530]: the day of the window, -1 outside it; each day's
  effect a random walk, sd 0.2, that moves when the day recurs) and 20
  static predictors ``x`` [n, 20] (a duplicated day repeats its row) with
  beta = (3, -2, 1.5, 1, 0 x 16), plus N(0, 0.5^2) noise. Rows 500-529 of
  ``x_dyn`` and ``active``, and ``x_future`` [30, 20], are the forecast's.
- ``bsts_monthly.npz``: the bsts_monthly configuration's daily series y
  [730] (float32) from ``BSTS_MONTHLY_FIRST`` (2022-01-01), made with
  numpy alone by :func:`make_bsts_monthly` as the reference's own recipe
  (``tests/test_monthly_annual_cycle.py:75-90``): its twelve month effects
  (centred), a slow level (innovation sd 0.02) and N(0, 0.3^2) noise, with
  a slope that reverts to 0.002 (phi 0.9, innovation sd 0.001) added to
  the level, so that a semilocal trend has something to find.
- ``bsts_ar_trig.npz``: the bsts_ar_trig configuration's weekly series y
  [520] (float32), made with numpy alone by :func:`make_bsts_ar_trig`: a
  constant mean 10, an AR(2) with phi = (0.6, 0.2) (innovation sd 0.5),
  an annual cycle of period 52.18 weeks with two harmonics and N(0,
  0.3^2) noise. ``tests/test_torch_bsts_monthly_data.py`` remakes both and
  compares, and writes them when run as a script.
- ``hmm.npz``, ``mixture.npz``, ``beta_binomial.npz``: the data of
  BASELINE configs #4, #3 and #1, drawn with JAX (x64 on, float64) by the
  reference's own simulators from the keys and truths of its tests, and
  remade and compared by ``tests/test_torch_baseline_data.py`` (which writes
  them when run as a script). ``hmm.npz``: y [1200] and the true path z
  [1200] of ``GaussianHmm.simulate(jax.random.key(0), 1200, [[0.92, 0.08],
  [0.12, 0.88]], [-1.5, 1.8], [0.8, 0.6])`` (``HMM_TRUTH``;
  ``tests/test_hmm.py::test_hmm_gibbs_recovers_truth``). ``mixture.npz``: y
  [1500] and z of ``GaussianMixtureModel.simulate(jax.random.key(0), 1500,
  [0.35, 0.4, 0.25], [-3.0, 0.5, 4.0], [0.7, 0.5, 1.0])``
  (``MIXTURE_TRUTH``; ``tests/test_mixtures.py:13-19``).
  ``beta_binomial.npz``: trials n and successes y [200] of
  ``BetaBinomialModel.simulate(k, 200, 25, 6.0, 14.0)``, k the first key of
  ``jax.random.split(jax.random.key(42))`` (``BETA_BINOMIAL_TRUTH``;
  ``tests/test_beta_binomial_e2e.py:21-26``).
"""

from __future__ import annotations

import datetime
from pathlib import Path

import numpy as np

BSTS_LLT_Y = Path(__file__).resolve().parent / "bsts_llt_y.txt"
SPIKE_SLAB_XY = Path(__file__).resolve().parent / "spike_slab_xy.npz"
BSTS_REG_XY = Path(__file__).resolve().parent / "bsts_reg.npz"
BSTS_TV = Path(__file__).resolve().parent / "bsts_tv.npz"
# bsts_tv: the grid's days, the forecast's, the static predictors, the
# holiday window's days and the seed of make_bsts_tv
BSTS_TV_GRID, BSTS_TV_HORIZON, BSTS_TV_P, BSTS_TV_WINDOW = 500, 30, 20, 3
BSTS_TV_SEED = 2027
BSTS_MONTHLY = Path(__file__).resolve().parent / "bsts_monthly.npz"
BSTS_MONTHLY_FIRST = datetime.date(2022, 1, 1)
BSTS_MONTHLY_DAYS, BSTS_MONTHLY_SEED = 730, 2028
# the reference's month effects (tests/test_monthly_annual_cycle.py:81-82)
MONTH_EFFECTS = (3.0, -2.0, 1.5, 0.5, -1.0, 2.0, -0.5, 0.0, 1.0, -2.5, 0.8,
                 -2.8)
BSTS_AR_TRIG = Path(__file__).resolve().parent / "bsts_ar_trig.npz"
BSTS_AR_TRIG_WEEKS, BSTS_AR_TRIG_PERIOD, BSTS_AR_TRIG_SEED = 520, 52.18, 2029
BSTS_AR_TRIG_PHI = (0.6, 0.2)
HMM = Path(__file__).resolve().parent / "hmm.npz"
MIXTURE = Path(__file__).resolve().parent / "mixture.npz"
BETA_BINOMIAL = Path(__file__).resolve().parent / "beta_binomial.npz"
# the truths the three files were drawn from
HMM_TRUTH = {"trans": [[0.92, 0.08], [0.12, 0.88]], "mu": [-1.5, 1.8],
             "sd": [0.8, 0.6]}
MIXTURE_TRUTH = {"weights": [0.35, 0.4, 0.25], "mu": [-3.0, 0.5, 4.0],
                 "sd": [0.7, 0.5, 1.0]}
BETA_BINOMIAL_TRUTH = {"groups": 200, "trials": 25, "a": 6.0, "b": 14.0}


def bsts_llt_series() -> np.ndarray:
    """The bsts_llt bench series, y [500] float32."""
    return np.array([float.fromhex(s) for s in BSTS_LLT_Y.read_text().split()],
                    dtype=np.float32)


def spike_slab_xy() -> tuple[np.ndarray, np.ndarray]:
    """The spike_slab bench data: x [2000, 50], y [2000], float32."""
    with np.load(SPIKE_SLAB_XY, allow_pickle=False) as f:
        return f["x"], f["y"]


def bsts_reg_xy() -> tuple[np.ndarray, np.ndarray]:
    """The bsts_reg data: x [530, 20] (rows 500-529 the future
    predictors), y [500], float32."""
    with np.load(BSTS_REG_XY, allow_pickle=False) as f:
        return f["x"], f["y"]


def make_bsts_tv(seed=BSTS_TV_SEED) -> dict:
    """The bsts_tv data from a numpy seed (see the module's docstring)."""
    rng = np.random.default_rng(seed)
    t_all = BSTS_TV_GRID + BSTS_TV_HORIZON
    slope = np.cumsum(0.01 * rng.standard_t(3, t_all))
    level = np.cumsum(slope + 0.1 * rng.standard_t(3, t_all))
    pattern = rng.normal(size=7)
    season = (pattern - pattern.mean())[np.arange(t_all) % 7]
    x_dyn = rng.normal(size=(t_all, 2))
    coef = np.array([1.0, -0.5]) + np.cumsum(
        0.02 * rng.normal(size=(t_all, 2)), axis=0)
    active = np.full(t_all, -1, np.int64)
    effect = np.array([2.0, 3.0, 1.0])
    holiday = np.zeros(t_all)
    for start in range(20, t_all - BSTS_TV_WINDOW, 60):
        start += int(rng.integers(-3, 4))
        for j in range(BSTS_TV_WINDOW):
            effect[j] += 0.2 * rng.normal()
            active[start + j] = j
            holiday[start + j] = effect[j]
    x = rng.normal(size=(t_all, BSTS_TV_P))
    beta = np.zeros(BSTS_TV_P)
    beta[:4] = (3.0, -2.0, 1.5, 1.0)
    signal = level + season + (x_dyn * coef).sum(1) + holiday + x @ beta
    days = np.arange(BSTS_TV_GRID)
    keep = rng.random(BSTS_TV_GRID) >= 0.05
    keep[[0, -1]] = True
    twice = keep & (rng.random(BSTS_TV_GRID) < 0.02)
    obs = np.repeat(days, keep.astype(np.int64) + twice)
    y = signal[obs] + 0.5 * rng.normal(size=obs.shape[0])
    f32 = np.float32
    return {"timestamps": obs.astype(np.int64), "y": y.astype(f32),
            "x": x[obs].astype(f32),
            "x_future": x[BSTS_TV_GRID:].astype(f32),
            "x_dyn": x_dyn.astype(f32), "active": active}


def bsts_tv() -> dict:
    """The committed bsts_tv data (:func:`make_bsts_tv`'s keys)."""
    with np.load(BSTS_TV, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def make_bsts_monthly(seed=BSTS_MONTHLY_SEED) -> dict:
    """The bsts_monthly data from a numpy seed (the module's docstring)."""
    rng = np.random.default_rng(seed)
    t_len = BSTS_MONTHLY_DAYS
    effect = np.asarray(MONTH_EFFECTS)
    effect = effect - effect.mean()
    months = np.asarray([(BSTS_MONTHLY_FIRST + datetime.timedelta(days=t))
                         .month - 1 for t in range(t_len)])
    slope = np.zeros(t_len)
    for t in range(1, t_len):
        slope[t] = (0.002 + 0.9 * (slope[t - 1] - 0.002)
                    + 0.001 * rng.normal())
    level = np.cumsum(slope + 0.02 * rng.normal(size=t_len))
    y = level + effect[months] + 0.3 * rng.normal(size=t_len)
    return {"y": y.astype(np.float32), "months": months.astype(np.int64)}


def bsts_monthly() -> dict:
    """The committed bsts_monthly data (:func:`make_bsts_monthly`'s keys)."""
    return _npz(BSTS_MONTHLY)


def make_bsts_ar_trig(seed=BSTS_AR_TRIG_SEED) -> dict:
    """The bsts_ar_trig data from a numpy seed (the module's docstring)."""
    rng = np.random.default_rng(seed)
    t_len = BSTS_AR_TRIG_WEEKS
    phi1, phi2 = BSTS_AR_TRIG_PHI
    ar = np.zeros(t_len + 2)
    for t in range(2, t_len + 2):
        ar[t] = phi1 * ar[t - 1] + phi2 * ar[t - 2] + 0.5 * rng.normal()
    lam = 2.0 * np.pi * np.arange(t_len) / BSTS_AR_TRIG_PERIOD
    cycle = (2.0 * np.cos(lam) + 1.0 * np.sin(lam) + 0.6 * np.cos(2 * lam)
             - 0.4 * np.sin(2 * lam))
    y = 10.0 + ar[2:] + cycle + 0.3 * rng.normal(size=t_len)
    return {"y": y.astype(np.float32)}


def bsts_ar_trig() -> dict:
    """The committed bsts_ar_trig data (:func:`make_bsts_ar_trig`'s keys)."""
    return _npz(BSTS_AR_TRIG)


def _npz(path) -> dict:
    with np.load(path, allow_pickle=False) as f:
        return {k: f[k] for k in f.files}


def hmm() -> dict:
    """Config #4's data: y [1200] float64, the true path z [1200]."""
    return _npz(HMM)


def mixture() -> dict:
    """Config #3's data: y [1500] float64, the true labels z [1500]."""
    return _npz(MIXTURE)


def beta_binomial() -> dict:
    """Config #1's data: trials n and successes y [200], float64."""
    return _npz(BETA_BINOMIAL)
