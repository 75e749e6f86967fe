"""The committed bsts_reg data (``boom_tpu_torch/data/bsts_reg.npz``) are
remade here with JAX on the CPU, x64 off, and compared exactly (float32).

The recipe (``boom_tpu_torch/data/__init__.py`` states it too): from
``jax.random.key(2026)``, x [530, 20] iid N(0, 1); a local linear trend with
level innovation sd 0.1 and slope innovation sd 0.01; a 7-season dummy
seasonal with initial pattern sd 1 and innovation sd 0.05; beta = (3, -2,
1.5, 1, 0 x 16); y = trend + seasonal + x[:500] beta + N(0, 0.5^2).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_reg_data.py

writes the file.
"""

import jax
import jax.numpy as jnp
import numpy as np

from boom_tpu_torch import data

T_FIT, HORIZON, P, NSEASONS = 500, 30, 20, 7
BETA = (3.0, -2.0, 1.5, 1.0) + (0.0,) * (P - 4)


def bsts_reg_xy():
    """x [530, 20], y [500] float32 by the recipe above."""
    with jax.enable_x64(False):
        k_x, k_lvl, k_slp, k_s0, k_seas, k_eps = jax.random.split(
            jax.random.key(2026), 6)
        x = jax.random.normal(k_x, (T_FIT + HORIZON, P))
        slope = jnp.cumsum(0.01 * jax.random.normal(k_slp, (T_FIT,)))
        level = jnp.cumsum(slope + 0.1 * jax.random.normal(k_lvl, (T_FIT,)))
        s0 = jax.random.normal(k_s0, (NSEASONS - 1,))
        w = 0.05 * jax.random.normal(k_seas, (T_FIT,))

        def season(prev, w_t):
            # the dummy seasonal: s_t = -(s_{t-1} + ... + s_{t-6}) + w_t
            s_t = -jnp.sum(prev) + w_t
            return jnp.concatenate([s_t[None], prev[:-1]]), s_t

        _, seasonal = jax.lax.scan(season, s0, w)
        beta = jnp.asarray(BETA, jnp.float32)
        y = (level + seasonal + x[:T_FIT] @ beta
             + 0.5 * jax.random.normal(k_eps, (T_FIT,)))
        return np.asarray(x), np.asarray(y)


def test_committed_data_are_the_recipe():
    want_x, want_y = bsts_reg_xy()
    got_x, got_y = data.bsts_reg_xy()
    assert got_x.dtype == np.float32 and got_y.dtype == np.float32
    assert got_x.shape == (T_FIT + HORIZON, P) and got_y.shape == (T_FIT,)
    np.testing.assert_array_equal(got_x, want_x)
    np.testing.assert_array_equal(got_y, want_y)


if __name__ == "__main__":
    x, y = bsts_reg_xy()
    np.savez(data.BSTS_REG_XY, x=x, y=y)
    print(f"wrote {data.BSTS_REG_XY}")
