"""Data the port's checks run on, committed so that nothing of the port
needs JAX to make them (numpy only).

- ``bsts_llt_y.txt``: the series of the reference's bsts_llt bench
  workload, y [500] in float32, drawn by ``bench.py:171-175`` from
  ``jax.random.key(4207)``; one ``float.hex`` a line, so that it reads back
  exactly. ``tests/test_torch_bench_series.py`` remakes it with JAX and
  compares, and writes it when run as a script.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

BSTS_LLT_Y = Path(__file__).resolve().parent / "bsts_llt_y.txt"


def bsts_llt_series() -> np.ndarray:
    """The bsts_llt bench series, y [500] float32."""
    return np.array([float.fromhex(s) for s in BSTS_LLT_Y.read_text().split()],
                    dtype=np.float32)
