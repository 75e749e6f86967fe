"""The port's Beta-Binomial model (``boom_tpu_torch/models/
beta_binomial.py``, BASELINE config #1) against the JAX reference on the
CPU in float64: the log posterior on a grid, the start and one sweep on the
reference's key tree, and the reference's own quadrature check
(``tests/test_beta_binomial_e2e.py``) at its data, chains and run length.

Noise: ``kernel()`` is ``compose(prob, size)``, which splits its key in 2;
each ``slice_step`` splits its key in 4 (height, offset, unused, shrink)
and the shrink key in 32. The start's Beta(2, 2) is ``jax.random.beta``,
two log-gammas of the halves of its key, rebuilt as u = F(g) of each.

Tolerances: the log posterior 1e-10 (the same operations, ``beta_binomial
.logpmf``'s data terms made once); the sweep 1e-9.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_beta_binomial.py \\
        bench 1024 500 500 7

prints the reference's R-hat, medians and ESS of ``chip_smoke.py`` phase
9's Beta-Binomial run on the committed data (``REFERENCE_*_BB``).
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

from boom_tpu.models import BetaBinomialModel as JaxBetaBinomial
from boom_tpu_torch import convert, data, rng
from boom_tpu_torch.inference.driver import run_mcmc
from boom_tpu_torch.models.beta_binomial import BetaBinomialModel

torch.set_num_threads(1)

F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
TRUE_A, TRUE_B = 6.0, 14.0


def _t(x):
    return torch.tensor(np.asarray(x))


def _models(num_groups=60, trials=10):
    """The reference test's data (its key 42's first half) and models."""
    k_sim, _ = jax.random.split(jax.random.key(42))
    n, y = JaxBetaBinomial.simulate(k_sim, num_groups, trials, TRUE_A,
                                    TRUE_B)
    jmodel = JaxBetaBinomial(trials=n, successes=y)
    return jmodel, convert.beta_binomial_from_jax(jmodel, device="cpu")


def test_log_post_matches_reference_on_a_grid():
    jmodel, model = _models()
    probs = np.linspace(0.02, 0.98, 37)
    sizes = np.exp(np.linspace(np.log(0.5), np.log(400.0), 41))
    pg, sg = (a.ravel() for a in np.meshgrid(probs, sizes, indexing="ij"))
    want = jax.jit(jmodel.log_post)(jnp.asarray(pg), jnp.asarray(sg))
    np.testing.assert_allclose(model.log_post(_t(pg), _t(sg)).numpy(),
                               np.asarray(want), rtol=1e-10)
    np.testing.assert_allclose(model.log_lik(_t(pg), _t(sg)).numpy(),
                               np.asarray(jax.jit(jmodel.log_lik)(
                                   jnp.asarray(pg), jnp.asarray(sg))),
                               rtol=1e-10)


def slice_noise(key):
    k_h, k_u, _k_lr, k_shrink = jax.random.split(key, 4)
    return {"h_u": jax.random.uniform(k_h, (), F64, minval=TINY),
            "u_u": jax.random.uniform(k_u, (), F64),
            "shrink_u": jax.vmap(lambda k: jax.random.uniform(k, (), F64))(
                jax.random.split(k_shrink, 32))}


def init_noise(key):
    k1, k2 = jax.random.split(key)
    ka, kb = jax.random.split(k1)
    two = jnp.asarray(2.0, F64)
    g = [jnp.exp(jax.random.loggamma(k, two, (), F64)) for k in (ka, kb)]
    return {"prob_u": jax.scipy.special.gammainc(two, jnp.stack(g)),
            "size_u": jax.scipy.special.gammainc(
                two, jax.random.gamma(k2, two, (), F64))}


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.tensor(np.stack([np.asarray(t) for t in trees]))


def test_init_and_sweep_match_reference():
    jmodel, model = _models()
    keys = jax.random.split(jax.random.key(5), 6)
    jstates = [jax.jit(jmodel.init_state)(k) for k in keys]
    st = model.init_state(_stack([jax.jit(init_noise)(k) for k in keys]))
    for name in ("prob", "size"):
        np.testing.assert_allclose(
            st[name].numpy(), np.stack([np.asarray(j[name])
                                        for j in jstates]), rtol=1e-9)
    sweep_keys = jax.random.split(jax.random.key(6), 6)
    jkern = jax.jit(jmodel.kernel())
    want = [jkern(k, j) for k, j in zip(sweep_keys, jstates)]
    noise = []
    for k in sweep_keys:
        k0, k1 = jax.random.split(k, 2)
        noise.append({"0": slice_noise(k0), "1": slice_noise(k1)})
    got = model.kernel()(_stack(noise), _stack(jstates))
    for name in ("prob", "size"):
        np.testing.assert_allclose(
            got[name].numpy(), np.stack([np.asarray(w[name])
                                         for w in want]), rtol=1e-9)


def _fit(model, chains, burn, draws, seed):
    return run_mcmc(model.kernel(), model.draw_noise,
                    lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                    num_draws=draws, generator=rng.generator(seed, "cpu"),
                    num_chains=chains, burn=burn)


def quadrature_moments(model_log_post):
    """The reference test's dense-grid posterior moments of prob and size
    (tests/test_beta_binomial_e2e.py:53-65), from a log posterior of numpy
    arrays."""
    probs = np.linspace(0.15, 0.55, 201)
    log_sizes = np.linspace(np.log(3.0), np.log(200.0), 201)
    pg, lg = np.meshgrid(probs, log_sizes, indexing="ij")
    lp = model_log_post(pg.ravel(), np.exp(lg.ravel())).reshape(pg.shape) + lg
    w = np.exp(lp - lp.max())
    w /= w.sum()
    mean_p = (w * pg).sum()
    mean_s = (w * np.exp(lg)).sum()
    return (mean_p, mean_s, np.sqrt((w * (pg - mean_p) ** 2).sum()),
            np.sqrt((w * (np.exp(lg) - mean_s) ** 2).sum()))


def test_matches_quadrature():
    """The reference's check: 4 chains, 500 + 4000 sweeps on its 60 groups
    of 10 trials; the posterior moments within its bounds of the 2-d
    quadrature."""
    _jmodel, model = _models(num_groups=60, trials=10)
    res = _fit(model, 4, 500, 4000, 42)
    prob = res.draws["prob"].numpy().ravel()
    size = res.draws["size"].numpy().ravel()
    want_p, want_s, sd_p, sd_s = quadrature_moments(
        lambda p, s: model.log_post(_t(p), _t(s)).numpy())
    assert abs(prob.mean() - want_p) < 4 * sd_p / np.sqrt(200.0)
    assert abs(size.mean() - want_s) < 4 * sd_s / np.sqrt(200.0)
    assert abs(prob.std() / sd_p - 1.0) < 0.15
    assert abs(size.std() / sd_s - 1.0) < 0.25


def test_simulate_draws_the_beta_binomial():
    """y / n of 4000 groups of 25 trials at (6, 14): mean 0.3, variance
    p (1 - p) (1 + (n - 1) / (a + b + 1)) / n."""
    gen = torch.Generator().manual_seed(3)
    u = torch.rand((3, 4000), generator=gen, dtype=torch.float64)
    n, y = BetaBinomialModel.simulate(u[0], u[1], torch.rand(
        (4000, 25), generator=gen, dtype=torch.float64), 25, TRUE_A, TRUE_B)
    assert torch.equal(n, torch.full((4000,), 25.0, dtype=torch.float64))
    r = (y / n).numpy()
    var = 0.3 * 0.7 * (1 + 24 / 21.0) / 25
    assert abs(r.mean() - 0.3) < 4 * np.sqrt(var / 4000)
    assert abs(r.var() / var - 1.0) < 0.1


def test_committed_data_run_in_the_port():
    d = data.beta_binomial()
    model = BetaBinomialModel(trials=_t(d["n"]), successes=_t(d["y"]))
    res = _fit(model, 2, 5, 5, 0)
    assert torch.isfinite(res.draws["prob"]).all()
    assert res.draws["size"].shape == (2, 5)


def bench(chains=1024, burn=500, draws=500, seed=7):
    """The reference's run on the committed data (x64 off): medians, R-hat
    and min-ESS a draw of prob and size (one JSON line)."""
    from boom_tpu.inference import diagnostics as jdiag
    from boom_tpu.inference import run_mcmc as jrun

    d = data.beta_binomial()
    model = JaxBetaBinomial(trials=jnp.asarray(d["n"]),
                            successes=jnp.asarray(d["y"]))
    res = jrun(jax.random.key(seed), model.kernel(), model.init_state,
               num_draws=draws, num_chains=chains, burn=burn)
    mon = np.stack([np.asarray(res.draws["prob"]),
                    np.asarray(res.draws["size"])], -1)
    rhat = np.asarray(jdiag.potential_scale_reduction(jnp.asarray(mon)))
    ess = np.asarray(jdiag.effective_sample_size(jnp.asarray(mon)))
    print(json.dumps({
        "chains": chains, "burn": burn, "draws": draws, "seed": seed,
        "medians": np.median(mon.reshape(-1, 2), 0).tolist(),
        "rhat": rhat.tolist(),
        "min_ess_per_draw": float(ess.min() / (chains * draws))}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["bench"]:
        jax.config.update("jax_enable_x64", False)
        bench(*(int(a) for a in sys.argv[2:6]))
