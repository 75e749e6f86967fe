"""The port's Gaussian mixture (``boom_tpu_torch/models/mixtures.py``,
BASELINE config #3) and its ``FiniteMixture`` front end against the JAX
reference on the CPU in float64: the responsibilities and ``log_lik``, the
start and one data-augmentation sweep on the reference's key tree, the
simulator, the relabelling functions, and the reference's own checks
(``tests/test_mixtures.py``: the recovery of its three components at its
chains and run length, and the log likelihood's rise from a start).

Noise: ``kernel()`` splits its key in 3 (indicators, components, weights);
the indicators are ``jax.random.categorical``, Gumbel uniforms [n, K];
the component draw splits its key in 2 (the variance's gamma, the mean's
normal); the gamma draws are rebuilt as u = F(g) at the reference's g.

Tolerances: densities 1e-10; one sweep 1e-9.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_mixtures.py \\
        bench 1024 200 200 7

prints the reference's numbers of ``chip_smoke.py`` phase 9's mixture run
on the committed data (``REFERENCE_*_MIX``): over all chains, and the
share of chains in the main mode (``mixtures.main_mode``) with their R-hat
and min-ESS.
"""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu import testing
from boom_tpu.models import mixtures as jmix
from boom_tpu_torch import convert, data
from boom_tpu_torch.frontends import FiniteMixture
from boom_tpu_torch.models import mixtures

torch.set_num_threads(1)

F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
TRUE_W = [0.35, 0.4, 0.25]
TRUE_MU = [-3.0, 0.5, 4.0]
TRUE_SD = [0.7, 0.5, 1.0]


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=1e-300)


def gamma_u(key, alpha):
    alpha = jnp.asarray(alpha, F64)
    g = jax.random.gamma(key, alpha, alpha.shape, F64)
    return jax.scipy.special.gammainc(alpha, g)


def _models(n=300):
    y, _ = jmix.GaussianMixtureModel.simulate(jax.random.key(0), n, TRUE_W,
                                              TRUE_MU, TRUE_SD)
    jmodel = jmix.GaussianMixtureModel(y=y, num_components=3)
    return jmodel, convert.mixture_from_jax(jmodel, device="cpu")


def _stack(trees):
    return {k: torch.tensor(np.stack([np.asarray(t[k]) for t in trees]))
            for k in trees[0]}


def sweep_noise(jmodel, key, state):
    """The port's noise of the reference's kernel()(key, state)."""
    k = jmodel.num_components
    kz, kc, kw = jax.random.split(key, 3)
    z_u = jax.random.uniform(kz, (jmodel.y.shape[0], k), F64, minval=TINY)
    z = jax.random.categorical(kz, jmodel.responsibilities(state), axis=-1)
    counts = jax.nn.one_hot(z, k, dtype=F64).sum(0)
    k1, k2 = jax.random.split(kc)
    return {"z_u": z_u,
            "sig_u": gamma_u(k1, 0.5 * (jmodel.sigma_df + counts)),
            "mu_z": jax.random.normal(k2, (k,), F64),
            "w_u": gamma_u(kw, jmodel._weight_prior_vec() + counts)}


def test_responsibilities_and_log_lik_match_reference():
    jmodel, model = _models()
    keys = jax.random.split(jax.random.key(1), 4)
    jstates = [jax.jit(jmodel.init_state)(k) for k in keys]
    st = _stack(jstates)
    _close(model.responsibilities(st),
           np.stack([np.asarray(jmodel.responsibilities(j))
                     for j in jstates]))
    _close(model.log_lik(st),
           np.stack([np.asarray(jmodel.log_lik(j)) for j in jstates]))


def test_init_and_sweep_match_reference():
    jmodel, model = _models()
    keys = jax.random.split(jax.random.key(2), 5)
    jstates = [jax.jit(jmodel.init_state)(k) for k in keys]
    init_noise = []
    for key in keys:
        k1, k2, _k3 = jax.random.split(key, 3)
        init_noise.append({"q_u": jax.random.uniform(k1, (3,), F64),
                           "w_u": gamma_u(k2, jnp.ones(3))})
    st = model.init_state(_stack(init_noise))
    for name in ("mu", "sigsq", "weights"):
        _close(st[name], np.stack([np.asarray(j[name]) for j in jstates]),
               1e-9)
    sweep_keys = jax.random.split(jax.random.key(3), 5)
    jkern = jax.jit(jmodel.kernel())
    want = [jkern(k, j) for k, j in zip(sweep_keys, jstates)]
    jnoise = jax.jit(lambda k, j: sweep_noise(jmodel, k, j))
    noise = _stack([jnoise(k, j) for k, j in zip(sweep_keys, jstates)])
    got = model.kernel()(noise, _stack(jstates))
    for name in ("mu", "sigsq", "weights"):
        _close(got[name], np.stack([np.asarray(w[name]) for w in want]), 1e-9)


def test_conjugate_draws_match_reference():
    """GaussianSuf and the three Gaussian conjugate draws of
    models/conjugate.py on the reference's keys (an empty component
    among them: the variance's gamma shape 1/2)."""
    from boom_tpu.models import conjugate as jconj

    from boom_tpu_torch.models import conjugate

    rng = np.random.default_rng(6)
    y = rng.normal(size=(4, 30))
    w = (rng.uniform(size=(4, 30)) < 0.5).astype(float)
    w[0] = 0.0
    jsuf = jconj.GaussianSuf.from_data(jnp.asarray(y), jnp.asarray(w))
    suf = conjugate.GaussianSuf.from_data(_t(y), _t(w))
    for got, want in zip(suf, jsuf):
        _close(got, want)
    _close(conjugate.GaussianSuf.from_data(_t(y)).sumsq,
           jconj.GaussianSuf.from_data(jnp.asarray(y)).sumsq)
    _close(suf.centered_sumsq(), jsuf.centered_sumsq())
    key = jax.random.key(5)
    k1, k2 = jax.random.split(key)
    mu, sigsq = jconj.gaussian_mean_var_draw(key, jsuf, 0.5, 0.01, 1.0, 2.0)
    got = conjugate.gaussian_mean_var_draw(
        _t(gamma_u(k1, 0.5 * (1.0 + jsuf.n))),
        _t(jax.random.normal(k2, (4,), F64)), suf, 0.5, 0.01, 1.0, 2.0)
    _close(got[0], mu, 1e-9)
    _close(got[1], sigsq, 1e-9)
    want = jconj.gaussian_mean_draw(key, jsuf, sigsq, 0.5, 0.01)
    _close(conjugate.gaussian_mean_draw(_t(jax.random.normal(key, (4,), F64)),
                                        suf, _t(sigsq), 0.5, 0.01), want)
    want = jconj.gaussian_var_draw(key, jsuf, mu, 1.0, 2.0)
    _close(conjugate.gaussian_var_draw(
        _t(gamma_u(key, 0.5 * (1.0 + jsuf.n))), suf, _t(mu), 1.0, 2.0),
        want, 1e-9)


def test_simulate_matches_reference():
    key = jax.random.key(9)
    jy, jz = jmix.GaussianMixtureModel.simulate(key, 200, TRUE_W, TRUE_MU,
                                                TRUE_SD)
    kz, ky = jax.random.split(key)
    y, z = mixtures.GaussianMixtureModel.simulate(
        _t(jax.random.uniform(kz, (200, 3), F64, minval=TINY)),
        _t(jax.random.normal(ky, (200,), F64)), TRUE_W, TRUE_MU, TRUE_SD)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    _close(y, jy)


def test_relabelling_matches_reference():
    rng = np.random.default_rng(4)
    mu = rng.normal(size=(3, 7, 3))
    other = rng.normal(size=(3, 7, 3))
    got = mixtures.relabel_sorted(_t(mu), _t(other))
    want = jmix.relabel_sorted(jnp.asarray(mu), jnp.asarray(other))
    for g, w in zip(got, want):
        _close(g, w)
    # identify_permutation on label-switched assignment draws
    truth = rng.integers(0, 3, size=40)
    perms = np.stack([rng.permutation(3) for _ in range(12)])
    z = np.take_along_axis(perms[:, None, :], truth[None, :, None],
                           axis=2)[..., 0]
    flip = rng.uniform(size=z.shape) < 0.1
    z = np.where(flip, rng.integers(0, 3, size=z.shape), z)
    got = mixtures.identify_permutation(z, 3)
    np.testing.assert_array_equal(got, jmix.identify_permutation(z, 3))
    draws = rng.normal(size=(12, 2, 3))
    for g, w in zip(mixtures.relabel_by_permutation(got, z, draws),
                    jmix.relabel_by_permutation(got, z, draws)):
        np.testing.assert_array_equal(g, w)
    relab = mixtures.relabel_by_permutation(got, z)[0]
    assert (relab == relab[0]).mean() > 0.8


def test_mixture_recovers_components():
    """The reference's check at its data, chains and run length (4 chains,
    500 + 1500 sweeps), through FiniteMixture."""
    y = data.mixture()["y"]
    fit = FiniteMixture(num_components=3).fit(y, niter=1500, num_chains=4,
                                              burn=500, seed=11,
                                              device="cpu")
    mu, sigsq, w = mixtures.relabel_sorted(fit.draws["mu"],
                                           fit.draws["sigsq"],
                                           fit.draws["weights"])
    mu = mu.numpy().reshape(-1, 3)
    sd = np.sqrt(sigsq.numpy().reshape(-1, 3))
    w = w.numpy().reshape(-1, 3)
    assert testing.check_mcmc_matrix(mu, TRUE_MU, confidence=0.98)
    assert testing.check_mcmc_matrix(sd, TRUE_SD, confidence=0.98)
    assert testing.check_mcmc_matrix(w, TRUE_W, confidence=0.98)
    comps = fit.components()
    np.testing.assert_allclose([c["mean"] for c in comps], TRUE_MU, atol=0.2)
    probs = fit.cluster_probs()
    assert probs.shape == (1500, 3)
    np.testing.assert_allclose(probs.sum(1), 1.0, rtol=1e-12)
    assert fit.cluster_probs(y[:10]).shape == (10, 3)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fit.save("unused")


def test_mixture_loglik_increases_from_random():
    """The reference's check: two chains, 200 + 200 sweeps, the last
    draw's log likelihood above the start's."""
    y, _ = jmix.GaussianMixtureModel.simulate(jax.random.key(0), 500,
                                              [0.5, 0.5], [-2.0, 2.0],
                                              [1.0, 1.0])
    fit = FiniteMixture(num_components=2).fit(np.asarray(y), niter=200,
                                              num_chains=2, burn=200, seed=1,
                                              device="cpu")
    model = fit._model
    gen = torch.Generator().manual_seed(0)
    start = model.init_state(model.draw_init_noise(gen, 1))
    final = {k: v[:1, -1] for k, v in fit.draws.items()}
    assert float(model.log_lik(final)[0]) > float(model.log_lik(start)[0])


def test_gamma_sample_refuses_small_shapes():
    from boom_tpu_torch.dists import gamma

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        gamma.sample(torch.tensor([0.5]), torch.tensor([0.3]))


MONITOR = ("mu0", "mu1", "mu2", "sd0", "sd1", "sd2", "w0", "w1", "w2")


def relabelled(mu, sigsq, weights):
    """[C, N, 9]: mu, sd and the weights sorted by mu in every draw."""
    order = np.argsort(mu, axis=-1)
    take = np.take_along_axis
    return np.concatenate([take(mu, order, -1),
                           np.sqrt(take(sigsq, order, -1)),
                           take(weights, order, -1)], axis=-1)


def bench(chains=1024, burn=200, draws=200, seed=7):
    """The reference's run on the committed data (x64 off): medians, R-hat
    and min-ESS a draw of the relabelled mu, sd and weights."""
    from boom_tpu.inference import diagnostics as jdiag
    from boom_tpu.inference import run_mcmc

    model = jmix.GaussianMixtureModel(y=jnp.asarray(data.mixture()["y"]),
                                      num_components=3)
    res = run_mcmc(jax.random.key(seed), model.kernel(), model.init_state,
                   num_draws=draws, num_chains=chains, burn=burn)
    mon = relabelled(np.asarray(res.draws["mu"]),
                     np.asarray(res.draws["sigsq"]),
                     np.asarray(res.draws["weights"]))
    rhat = np.asarray(jdiag.potential_scale_reduction(jnp.asarray(mon)))
    ess = np.asarray(jdiag.effective_sample_size(jnp.asarray(mon)))
    main = mixtures.main_mode(np.asarray(res.draws["mu"])).numpy()
    main_mon = jnp.asarray(mon[main])
    main_ess = np.asarray(jdiag.effective_sample_size(main_mon))
    print(json.dumps({
        "chains": chains, "burn": burn, "draws": draws, "seed": seed,
        "monitor": MONITOR,
        "medians": np.median(mon.reshape(-1, mon.shape[-1]), 0).tolist(),
        "rhat": rhat.tolist(),
        "min_ess_per_draw": float(ess.min() / (chains * draws)),
        "main_share": float(main.mean()),
        "main_rhat": np.asarray(
            jdiag.potential_scale_reduction(main_mon)).tolist(),
        "main_min_ess_per_draw": float(main_ess.min()
                                       / (main.sum() * draws))}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["bench"]:
        jax.config.update("jax_enable_x64", False)
        bench(*(int(a) for a in sys.argv[2:6]))
