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
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BSTS_LLT_Y = Path(__file__).resolve().parent / "bsts_llt_y.txt"
SPIKE_SLAB_XY = Path(__file__).resolve().parent / "spike_slab_xy.npz"


def bsts_llt_series() -> np.ndarray:
    """The bsts_llt bench series, y [500] float32."""
    return np.array([float.fromhex(s) for s in BSTS_LLT_Y.read_text().split()],
                    dtype=np.float32)


def spike_slab_xy() -> tuple[np.ndarray, np.ndarray]:
    """The spike_slab bench data: x [2000, 50], y [2000], float32."""
    with np.load(SPIKE_SLAB_XY, allow_pickle=False) as f:
        return f["x"], f["y"]
