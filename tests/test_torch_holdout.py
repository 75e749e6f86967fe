"""The reference's own statistical checks of the one-step and holdout
prediction errors (tests/test_cat_hmm_holdout.py:58-100,
tests/test_serialize_diag.py:81) through the port on the CPU, on the
reference tests' own data (drawn from their keys with JAX), at their run
lengths, with their assertions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from boom_tpu_torch import rng as prng
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.inference import driver
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace.bsts import Bsts
from boom_tpu_torch.statespace.state_models import LocalLevel

torch.set_num_threads(1)


def _fit(model, seed, draws, burn, chains=2):
    return driver.run_mcmc(
        model.kernel(), model.draw_noise,
        lambda g, c: model.init_state(model.draw_init_noise(g, c)), draws,
        generator=prng.generator(seed, "cpu"), num_chains=chains, burn=burn)


def test_compare_bsts_models_prefers_the_trend():
    """tests/test_cat_hmm_holdout.py::test_compare_bsts_models: a local
    level fit of trending data accumulates larger one-step errors than a
    local linear trend."""
    from boom_tpu_torch.statespace.state_models import LocalLinearTrend

    k1, k2 = jax.random.split(jax.random.key(0))
    t_len = 250
    slope_path = jnp.cumsum(0.02 * jax.random.normal(k1, (t_len,))) + 0.5
    y = torch.tensor(np.asarray(jnp.cumsum(slope_path) + 0.5
                                * jax.random.normal(k2, (t_len,))))
    m_ll = Bsts(y=y, blocks=[LocalLevel.default(y)])
    m_llt = Bsts(y=y, blocks=[LocalLinearTrend.default(y)])
    cum = pbsts.compare_bsts_models(
        {"local_level": (m_ll, _fit(m_ll, 1, 80, 80)),
         "llt": (m_llt, _fit(m_llt, 2, 80, 80))}, max_draws=20)
    assert float(cum["local_level"][-1]) > float(cum["llt"][-1])


def test_holdout_errors_are_one_step():
    """tests/test_cat_hmm_holdout.py::test_holdout_errors_are_one_step: the
    holdout filter assimilates each held-out observation, so for a
    well-specified model the standardized holdout errors stay ~N(0, 1) and
    do not grow with the horizon."""
    k1, k2 = jax.random.split(jax.random.key(0))
    t_len, cut = 400, 300
    lvl = jnp.cumsum(0.25 * jax.random.normal(k1, (t_len,)))
    y = torch.tensor(np.asarray(lvl + 0.6 * jax.random.normal(k2,
                                                                (t_len,))))
    model = Bsts(y=y, blocks=[LocalLevel.default(y)])
    errs = pbsts.holdout_prediction_errors(
        model, prng.generator(3, "cpu"), cut, num_draws=80, num_chains=2,
        burn=80, max_draws=20)
    assert errs.shape == (20, t_len)
    hold = errs[:, cut:].numpy()
    assert abs(hold.mean()) < 0.25, hold.mean()
    assert 0.75 < hold.std() < 1.35, hold.std()
    early = np.abs(hold[:, :50]).mean()
    late = np.abs(hold[:, 50:]).mean()
    assert late < 1.5 * early, (early, late)


def test_bsts_prediction_errors_holdout():
    """tests/test_serialize_diag.py::test_bsts_prediction_errors_holdout
    through BstsModel on the CPU: in-sample and cutpoint entries."""
    k1, k2 = jax.random.split(jax.random.key(3))
    t_len = 120
    trend = jnp.cumsum(0.05 * jax.random.normal(k1, (t_len,)))
    y = np.asarray(trend + 0.3 * jax.random.normal(k2, (t_len,)))
    fit = BstsModel().add_local_level().fit(y, niter=150, num_chains=2,
                                            burn=100, device="cpu")
    errs = fit.prediction_errors(cutpoints=[90], max_draws=8)
    assert set(errs) == {"in.sample", "90"}
    for v in errs.values():
        assert v.shape[-1] == 120
        assert bool(torch.isfinite(v).all())
