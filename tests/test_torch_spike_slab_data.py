"""The committed spike_slab data (``boom_tpu_torch/data/spike_slab_xy.npz``)
are the reference bench's own: remade here with JAX on the CPU by
``bench.py:133-138``'s recipe, with x64 off as the bench runs, and compared
exactly (float32).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_spike_slab_data.py

writes the file.
"""

import jax
import numpy as np

from boom_tpu.models.glm import SpikeSlabRegression
from boom_tpu_torch import data

N, P, NONZERO = 2000, 50, 8


def bench_xy():
    """x [2000, 50], y [2000] float32 as bench.py:133-138 draws them."""
    with jax.enable_x64(False):
        key = jax.random.key(20260817)
        k_sim, _k_run = jax.random.split(key)
        x, y, _ = SpikeSlabRegression.simulate(k_sim, N, P, NONZERO,
                                               sigma=1.0)
        return np.asarray(x), np.asarray(y)


def test_committed_data_are_the_bench_data():
    want_x, want_y = bench_xy()
    got_x, got_y = data.spike_slab_xy()
    assert want_x.dtype == np.float32 and got_x.dtype == np.float32
    assert got_y.dtype == np.float32
    assert got_x.shape == (N, P) and got_y.shape == (N,)
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_y, want_y)


if __name__ == "__main__":
    x, y = bench_xy()
    np.savez(data.SPIKE_SLAB_XY, x=x, y=y)
    print(f"wrote {data.SPIKE_SLAB_XY}")
