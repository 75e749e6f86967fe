"""The committed bsts_llt series (``boom_tpu_torch/data/bsts_llt_y.txt``)
is the reference bench's own: remade here with JAX on the CPU by
``bench.py:171-175``'s recipe and compared exactly, in float32 (the bench
does not enable x64, so its draws and sums are float32).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bench_series.py

writes the file.
"""

import jax
import jax.numpy as jnp
import numpy as np

from boom_tpu_torch import data

T_LEN = 500


def bench_series(t_len=T_LEN):
    """y [t_len] float32 as bench.py:171-175 draws it (eagerly, as there)."""
    key = jax.random.key(4207)
    k1, k2, k3, _k_run = jax.random.split(key, 4)
    f32 = jnp.float32
    slope = jnp.cumsum(0.02 * jax.random.normal(k3, (t_len,), dtype=f32))
    level = jnp.cumsum(slope + 0.3 * jax.random.normal(k1, (t_len,),
                                                       dtype=f32)) + 5.0
    y = level + 0.5 * jax.random.normal(k2, (t_len,), dtype=f32)
    return np.asarray(y)


def test_committed_series_is_the_bench_series():
    want = bench_series()
    got = data.bsts_llt_series()
    assert want.dtype == np.float32 and got.dtype == np.float32
    assert got.shape == (T_LEN,)
    np.testing.assert_array_equal(got, want)


def test_series_file_round_trips():
    """One float.hex a line: reading and writing again gives the file."""
    text = data.BSTS_LLT_Y.read_text()
    assert _format(data.bsts_llt_series()) == text


def _format(y):
    return "".join(float(v).hex() + "\n" for v in y)


if __name__ == "__main__":
    data.BSTS_LLT_Y.write_text(_format(bench_series()))
    print(f"wrote {data.BSTS_LLT_Y}")
