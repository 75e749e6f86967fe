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
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BSTS_LLT_Y = Path(__file__).resolve().parent / "bsts_llt_y.txt"
SPIKE_SLAB_XY = Path(__file__).resolve().parent / "spike_slab_xy.npz"
BSTS_REG_XY = Path(__file__).resolve().parent / "bsts_reg.npz"


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
