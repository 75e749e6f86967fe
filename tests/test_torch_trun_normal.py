"""The truncated normal (``dists.trun_normal``) and the multivariate
normal's draw from its natural parameters (``dists.mvn.sample_suf``) in the
port against the JAX reference (float64, CPU).

- On the reference's own uniforms and normals (rebuilt from its keys) both
  draw the same values, to rounding (rtol 1e-12): the truncated normal in
  its body (the inverse CDF on the ndtr scale) and in Robert's tail
  rejection (an interval past 4 sds, on either side), the semilocal
  trend's (-0.999, 0.999) with its mean outside the interval.
- ``logpdf`` and ``mean_sd`` agree to 1e-12.
- On the port's own random numbers the draws match the reference's in
  distribution (``boom_tpu.testing.distributions_match``: a two-sample KS
  test, p > 1e-3) and in their moments.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu import dists as jd
from boom_tpu.testing import distributions_match
from boom_tpu_torch import dists as pd
from boom_tpu_torch.dists.truncated import TAIL_TRIPS

torch.set_num_threads(1)

F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
N = 20_000
# (mean, sd, lo, hi): a central interval, one side, the deep upper and
# lower tails (Robert's rejection), the semilocal trend's phi interval
# with its mean inside, past it and far below it
CASES = [(1.0, 2.0, -1.0, 4.0), (-0.7, 1.0, 0.0, np.inf),
         (0.0, 1.0, 8.0, np.inf), (0.0, 1.0, -np.inf, -8.0),
         (0.3, 0.2, -0.999, 0.999), (1.05, 0.01, -0.999, 0.999),
         (-3.0, 0.3, -0.999, 0.999)]


def _uniforms(key, shape):
    """The reference's uniforms of ``trun_normal.sample(key, ..., shape)``:
    the body's [shape], then the tail's [shape, TAIL_TRIPS] twice."""
    k_body, k_tail = jax.random.split(key)
    trips = jax.vmap(jax.random.split)(jax.random.split(k_tail, TAIL_TRIPS))

    def u(k):
        return jax.random.uniform(k, shape, F64, minval=TINY)

    return (np.asarray(u(k_body)),
            np.moveaxis(np.asarray(jax.vmap(u)(trips[:, 0])), 0, -1),
            np.moveaxis(np.asarray(jax.vmap(u)(trips[:, 1])), 0, -1))


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_trun_normal_draws_the_reference_values(case):
    mean, sd, lo, hi = case
    key = jax.random.key(31)
    want = np.asarray(jd.trun_normal.sample(key, mean, sd, lo=lo, hi=hi,
                                            shape=(N,)))
    u, u1, u2 = (torch.tensor(a) for a in _uniforms(key, (N,)))
    got = pd.trun_normal.sample(u, u1, u2, torch.full((N,), mean,
                                                      dtype=torch.float64),
                                sd, lo, hi).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got >= lo).all() and (got <= hi).all()


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_trun_normal_logpdf_and_moments_match_reference(case):
    mean, sd, lo, hi = case
    a = max(lo, mean - 6 * sd) if np.isfinite(lo) else mean - 6 * sd
    b = min(hi, mean + 6 * sd) if np.isfinite(hi) else mean + 6 * sd
    x = np.linspace(a - 0.1, b + 0.1, 101)
    want = np.asarray(jd.trun_normal.logpdf(jnp.asarray(x), mean, sd, lo, hi))
    got = pd.trun_normal.logpdf(torch.tensor(x), mean, sd, lo, hi).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-12, atol=1e-12)
    m, s = pd.trun_normal.mean_sd(torch.tensor(mean, dtype=torch.float64),
                                  sd, lo, hi)
    wm, ws = jd.trun_normal.mean_sd(mean, sd, lo, hi)
    np.testing.assert_allclose([float(m), float(s)], [float(wm), float(ws)],
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("case", CASES, ids=[str(c) for c in CASES])
def test_trun_normal_matches_reference_in_distribution(case):
    """The port's draws on its own uniforms against the reference's on its
    key: the two-sample KS test and the moments (mean_sd)."""
    mean, sd, lo, hi = case
    want = np.asarray(jd.trun_normal.sample(jax.random.key(32), mean, sd,
                                            lo=lo, hi=hi, shape=(N,)))
    gen = torch.Generator().manual_seed(33)
    u = [torch.rand(shape, generator=gen, dtype=torch.float64)
         .clamp_min(TINY) for shape in ((N,), (N, TAIL_TRIPS),
                                        (N, TAIL_TRIPS))]
    got = pd.trun_normal.sample(*u, mean, sd, lo, hi).numpy()
    assert distributions_match(got, want)
    m, s = (float(v) for v in pd.trun_normal.mean_sd(
        torch.tensor(mean, dtype=torch.float64), sd, lo, hi))
    assert abs(got.mean() - m) < 5 * s / np.sqrt(N)
    assert abs(got.std() / s - 1.0) < 0.05


def _precision(rng, p):
    a = rng.normal(size=(p, p))
    return a @ a.T + p * np.eye(p), rng.normal(size=p)


@pytest.mark.parametrize("p", [1, 2, 5])
def test_mvn_sample_suf_draws_the_reference_values(p):
    """N(prec^-1 b, prec^-1) at the reference's normals; with the
    precision or its Cholesky factor; batched over draws."""
    rng = np.random.default_rng(p)
    prec, b = _precision(rng, p)
    keys = jax.random.split(jax.random.key(34), 64)
    want = np.asarray(jax.vmap(lambda k: jd.mvn.sample_suf(
        k, jnp.asarray(b), jnp.asarray(prec)))(keys))
    z = torch.tensor(np.asarray(jax.vmap(lambda k: jax.random.normal(
        k, (p,), F64))(keys)))
    got = pd.mvn.sample_suf(z, torch.tensor(b), torch.tensor(prec))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    chol = torch.linalg.cholesky(torch.tensor(prec))
    again = pd.mvn.sample_suf(z, torch.tensor(b)[None], prec_chol=chol[None])
    np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=1e-15)


def test_mvn_sample_suf_matches_reference_in_distribution():
    """Each coordinate's draws against the reference's (KS), and the
    draws' mean and covariance against prec^-1 b and prec^-1."""
    rng = np.random.default_rng(9)
    prec, b = _precision(rng, 3)
    want = np.asarray(jd.mvn.sample_suf(jax.random.key(35), jnp.asarray(b),
                                        jnp.asarray(prec), shape=(N,)))
    z = torch.randn(N, 3, generator=torch.Generator().manual_seed(36),
                    dtype=torch.float64)
    got = pd.mvn.sample_suf(z, torch.tensor(b), torch.tensor(prec)).numpy()
    for j in range(3):
        assert distributions_match(got[:, j], want[:, j])
    cov = np.linalg.inv(prec)
    np.testing.assert_allclose(got.mean(0), cov @ b,
                               atol=5 * np.sqrt(cov.diagonal().max() / N))
    np.testing.assert_allclose(np.cov(got.T), cov, atol=0.05 * cov.max())
