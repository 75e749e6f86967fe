"""The port's distributions, slice sampler and MCMC diagnostics against the
JAX reference, on the same inputs.

Random numbers: the reference draws its uniforms from keys inside each
sampler; the port takes them as tensors. Each test rebuilds those uniforms
from the very keys the reference splits, in the reference's order, so both
sides compute on the same numbers (float64, CPU).

Tolerance of the gamma CDF and what inverts it: PyTorch's regularized
incomplete gamma (``torch.special.gammainc``) is accurate to about 1e-9
relative for shapes above ~20 (7.9e-10 against scipy at shapes up to 2000,
where JAX's is within 4e-12), so those comparisons hold to rtol 2e-9; the
inverse-CDF draws, whose Newton polish divides that error by x f(x), to
1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from boom_tpu.dists import continuous as jcont
from boom_tpu.dists.truncated import trun_gamma_lower_fast as j_trun_gamma
from boom_tpu.inference import diagnostics as jdiag
from boom_tpu.inference.kernels.slice import slice_step as j_slice_step
from boom_tpu.statespace.state_models import SdPrior as JaxSdPrior
from boom_tpu_torch import dists
from boom_tpu_torch.dists.truncated import trun_gamma_lower_fast
from boom_tpu_torch.inference import diagnostics
from boom_tpu_torch.inference.kernels.slice import slice_step
from boom_tpu_torch.statespace.state_models import SdPrior

torch.set_num_threads(1)

TINY = np.finfo(np.float64).tiny


def _t(x):
    return torch.tensor(np.asarray(x))


def _gamma_args(n=64, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.3, 2000.0, n)
    b = rng.uniform(0.05, 50.0, n)
    lo = np.where(rng.uniform(size=n) < 0.5, 0.0,
                  rng.uniform(0.2, 3.0, n) * a / b)
    return a, b, lo


def test_gamma_cdf_logpdf_match_reference():
    a, b, _ = _gamma_args()
    x = np.concatenate([np.random.default_rng(1).gamma(a, 1.0 / b)[:-2],
                        [0.0, -1.0]])
    np.testing.assert_allclose(
        dists.gamma.cdf(_t(x), _t(a), _t(b)).numpy(),
        np.asarray(jcont.gamma.cdf(x, a, b)), rtol=2e-9, atol=1e-300)
    # the log density sums terms of order 1e4 that cancel to order 1, so
    # it agrees to rounding of those terms: atol 1e-10
    np.testing.assert_allclose(
        dists.gamma.logpdf(_t(x), _t(a), _t(b)).numpy(),
        np.asarray(jcont.gamma.logpdf(x, a, b)), rtol=1e-12, atol=1e-10)


@pytest.mark.parametrize("newton_iters", [6, 8])
def test_trun_gamma_lower_fast_matches_reference(newton_iters):
    a, b, lo = _gamma_args(seed=newton_iters)
    key = jax.random.key(newton_iters)
    ref = j_trun_gamma(key, a, b, lo, newton_iters=newton_iters)
    u = jax.random.uniform(key, a.shape, jnp.float64, minval=TINY)
    out = trun_gamma_lower_fast(_t(u), _t(a), _t(b), _t(lo),
                                newton_iters=newton_iters)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9)
    assert bool((out >= _t(lo)).all())


def test_sd_prior_draw_variance_matches_reference():
    """The finite-upper-limit draw (every prior on the bsts path) against
    the reference given the same uniform; the unbounded draw, which the
    reference makes from jax.random.gamma, against scipy's quantile."""
    prior = SdPrior(sigma_guess=0.3, sample_size=0.01, upper_limit=2.0)
    jprior = JaxSdPrior(sigma_guess=0.3, sample_size=0.01, upper_limit=2.0)
    sum_sq = np.random.default_rng(2).uniform(1.0, 200.0, 16)
    keys = jax.random.split(jax.random.key(3), 16)
    ref = jax.vmap(lambda k, s: jprior.draw_variance(k, 99, s))(keys, sum_sq)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), jnp.float64,
                                              minval=TINY))(keys)
    out = prior.draw_variance(_t(u), 99, _t(sum_sq))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9)

    free = SdPrior(sigma_guess=0.3, sample_size=0.01)
    df = 0.01 + 99
    ss = 0.01 * 0.3 ** 2 + sum_sq
    expect = 1.0 / scipy.stats.gamma.ppf(np.asarray(u), 0.5 * df,
                                         scale=2.0 / ss)
    np.testing.assert_allclose(
        free.draw_variance(_t(u), 99, _t(sum_sq)).numpy(), expect,
        rtol=1e-9)


def _slice_uniforms(key, shape, shrink_iters):
    """The uniforms the reference's slice_step draws from ``key``."""
    k_h, k_u, _k_lr, k_shrink = jax.random.split(key, 4)
    h_u = jax.random.uniform(k_h, shape, jnp.float64, minval=TINY)
    u_u = jax.random.uniform(k_u, shape, jnp.float64)
    shrink = jnp.stack([jax.random.uniform(k, shape, jnp.float64)
                        for k in jax.random.split(k_shrink, shrink_iters)],
                       axis=-1)
    return _t(h_u), _t(u_u), _t(shrink)


@pytest.mark.parametrize("bounded", [False, True])
def test_slice_step_matches_reference(bounded):
    rng = np.random.default_rng(4)
    mu = rng.normal(size=32)
    x0 = mu + rng.normal(size=32)
    lower, upper = (-0.5, 1.5) if bounded else (-np.inf, np.inf)
    x0 = np.clip(x0, -0.4, 1.4) if bounded else x0
    opts = dict(expand_iters=5, shrink_iters=10)
    key = jax.random.key(5)
    ref = j_slice_step(key, jnp.asarray(x0),
                       lambda x: -0.5 * (x - mu) ** 2 / 0.7, 0.8,
                       lower=lower, upper=upper, **opts)
    h_u, u_u, shrink = _slice_uniforms(key, x0.shape, 10)
    mu_t = _t(mu)
    out = slice_step(_t(x0), lambda x: -0.5 * (x - mu_t) ** 2 / 0.7, 0.8,
                     h_u, u_u, shrink, expand_iters=5, lower=lower,
                     upper=upper)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-12)
    assert not np.allclose(out.numpy(), x0)


def _draws(shape, seed=6):
    """AR(1) draws with chain offsets, [chains, draws, ...]."""
    rng = np.random.default_rng(seed)
    e = rng.normal(size=shape)
    x = np.empty(shape)
    x[:, 0] = e[:, 0]
    for t in range(1, shape[1]):
        x[:, t] = 0.7 * x[:, t - 1] + e[:, t]
    return x + 0.2 * np.arange(shape[0]).reshape(-1, *[1] * (len(shape) - 1))


@pytest.mark.parametrize("shape", [(4, 101), (3, 80, 2)])
def test_rhat_and_ess_match_reference(shape):
    x = _draws(shape)
    np.testing.assert_allclose(
        diagnostics.split_chains(_t(x)).numpy(),
        np.asarray(jdiag.split_chains(jnp.asarray(x))))
    np.testing.assert_allclose(
        diagnostics.potential_scale_reduction(_t(x)).numpy(),
        np.asarray(jdiag.potential_scale_reduction(x)), rtol=1e-10)
    np.testing.assert_allclose(
        diagnostics.effective_sample_size(_t(x)).numpy(),
        np.asarray(jdiag.effective_sample_size(x)), rtol=1e-10)


def test_summary_matches_reference():
    x = _draws((4, 60, 3), seed=8)
    ref = jdiag.summary(x)
    out = diagnostics.summary(_t(x))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=1e-10, err_msg=k)


# -- the distributions of BASELINE configs #1, #3 and #4 --------------------

GAMMA_SHAPES = (0.5, 0.7, 1.0, 1.5, 3.0, 10.0, 50.0, 200.0, 1200.0)
# from 1e-150: below it shape 0.5's quantile, (u Gamma(1.5))^2, leaves the
# float64 range (the sampler then returns its rounding, 0)
GAMMA_LEVELS = (1e-150, 1e-30, 1e-8, 1e-3, 0.1, 0.5, 0.9, 1 - 1e-3,
                1 - 1e-8, 1 - 2.0 ** -52)


@pytest.mark.parametrize("a", GAMMA_SHAPES)
def test_gamma_sample_inverts_the_cdf(a):
    """The inverse CDF at shapes 0.5-1,200 and levels from 1e-150 to 1 -
    2^-52 in float64 (the CDF's own accuracy: ~1e-14 relative below shape
    ~20, ~1e-9 above), and at float32 levels (tiny to 1 - 2^-24) within
    float32's rounding of the draw."""
    u = np.asarray(GAMMA_LEVELS)
    x = dists.gamma.sample(_t(u), a).numpy()
    lower = u <= 0.5
    got = np.where(lower, scipy.special.gammainc(a, x),
                   scipy.special.gammaincc(a, x))
    want = np.where(lower, u, 1.0 - u)
    rtol = 1e-12 if a < 20 else 5e-9
    np.testing.assert_allclose(got, want, rtol=rtol)
    # the rate divides the unit-rate draw
    np.testing.assert_allclose(dists.gamma.sample(_t(u), a, 4.0).numpy(),
                               x / 4.0, rtol=1e-15)
    u32 = np.asarray([np.finfo(np.float32).tiny, 1e-20, 1e-6, 0.01, 0.3,
                      0.5, 0.8, 0.999, 1 - 2.0 ** -24], np.float32)
    a32 = torch.tensor(a, dtype=torch.float32)
    x32 = dists.gamma.sample(torch.tensor(u32), a32)
    assert x32.dtype == torch.float32
    want32 = scipy.special.gammaincinv(float(a32), u32.astype(np.float64))
    np.testing.assert_allclose(x32.numpy(), want32, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)


def test_gamma_sample_matches_reference_draws():
    """u = F(g) at the reference's jax.random.gamma draws maps back to
    g (shapes 0.5-1,200, the Dirichlet and variance draws' range)."""
    a = np.concatenate([[0.5, 0.5, 1.0, 1.0], np.geomspace(0.6, 1200.0, 60)])
    g = jax.random.gamma(jax.random.key(3), jnp.asarray(a), a.shape,
                         jnp.float64)
    u = jax.scipy.special.gammainc(jnp.asarray(a), g)
    np.testing.assert_allclose(dists.gamma.sample(_t(u), _t(a)).numpy(),
                               np.asarray(g), rtol=1e-9)


def test_baseline_densities_match_reference():
    from boom_tpu.dists import discrete as jdisc
    from boom_tpu.dists import multivariate as jmv

    rng = np.random.default_rng(7)
    x = rng.normal(size=20)
    mean, sd = rng.normal(size=20), rng.uniform(0.1, 3.0, 20)
    np.testing.assert_allclose(
        dists.normal.logpdf(_t(x), _t(mean), _t(sd)).numpy(),
        np.asarray(jcont.normal.logpdf(x, mean, sd)), rtol=1e-14)
    p = np.concatenate([rng.uniform(size=18), [0.0, 1.0]])
    a, b = rng.uniform(0.3, 30.0, 20), rng.uniform(0.3, 30.0, 20)
    np.testing.assert_allclose(
        dists.beta.logpdf(_t(p), _t(a), _t(b)).numpy(),
        np.asarray(jcont.beta.logpdf(p, a, b)), rtol=1e-12)
    n = rng.integers(1, 60, 20).astype(float)
    k = np.concatenate([np.floor(rng.uniform(size=17) * n[:17]),
                        [n[17] + 1, -1.0, 2.5]])
    np.testing.assert_allclose(
        dists.beta_binomial.logpmf(_t(k), _t(n), _t(a), _t(b)).numpy(),
        np.asarray(jdisc.beta_binomial.logpmf(k, n, a, b)), rtol=1e-12)
    alpha = rng.uniform(0.5, 20.0, (5, 4))
    w = rng.dirichlet(np.ones(4), 5)
    np.testing.assert_allclose(
        dists.dirichlet.logpdf(_t(w), _t(alpha)).numpy(),
        np.asarray(jmv.dirichlet.logpdf(w, alpha)), rtol=1e-12)


def test_beta_and_dirichlet_samples():
    """Beta(a, b) as two gammas and the Dirichlet as normalised gammas:
    their means at 20,000 draws, and the Dirichlet's rows sum to 1."""
    gen = torch.Generator().manual_seed(4)
    u = torch.rand((2, 20_000), generator=gen, dtype=torch.float64)
    x = dists.beta.sample(u[0], u[1], 2.0, 5.0)
    assert abs(float(x.mean()) - 2.0 / 7.0) < 4 * np.sqrt(
        10.0 / (49 * 8) / 20_000)
    alpha = torch.tensor([0.5, 1.0, 7.0], dtype=torch.float64)
    w = dists.dirichlet.sample(torch.rand((20_000, 3), generator=gen,
                                          dtype=torch.float64), alpha)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-14)
    np.testing.assert_allclose(w.mean(0).numpy(), (alpha / 8.5).numpy(),
                               atol=0.01)


def test_gamma_sample_many_is_each_sample():
    """sample_many's lanes side by side give each pair's own draws."""
    gen = torch.Generator().manual_seed(5)
    pairs = [(torch.rand((4, 2), generator=gen, dtype=torch.float64),
              torch.tensor([0.5, 30.0], dtype=torch.float64)),
             (torch.rand((4, 3, 3), generator=gen, dtype=torch.float64),
              1.0 + 600.0 * torch.rand((4, 3, 3), generator=gen,
                                       dtype=torch.float64))]
    for got, (u, a) in zip(dists.gamma.sample_many(*pairs), pairs):
        assert got.shape == u.shape
        assert torch.equal(got, dists.gamma.sample(u, a))
