"""The port's HMM (``boom_tpu_torch/models/hmm.py``, ``hmm_parallel.py``)
against the JAX reference on the CPU in float64: the forward filter, the
backward sampler on the reference's own uniforms, the smoothed marginals,
the transition counts, the associative-scan filter, one ``GaussianHmm``
sweep and its start on the reference's key tree, the simulator, and the
reference's own brute-force checks (``tests/test_hmm.py``). The recovery
check runs through the host-compiled H1 and H2 in
``tests/test_torch_hmm_kernels.py`` (the plain versions loop over T in
Python).

The port takes its noise as tensors; each test rebuilds it from the
reference's keys in the reference's order: ``kernel()`` splits its key in
4 (path, components, transitions, initial state); ``backward_sample`` its
path key in 2, the last row's Gumbel uniforms from the first and row t's
from the t-th of T - 1 keys split from the second; the gamma draws of the
variances and of the Dirichlets are rebuilt as u = F(g), the gamma CDF at
the reference's own draw g, which the port's inverse CDF maps back to g.

Tolerances: the filters, marginals and log densities 1e-10 (the same
arithmetic, summed in another order); paths identical; one sweep 1e-9
(PyTorch's incomplete gamma is accurate to ~1e-9 relative at shapes above
~20, which the inverse CDF divides by x f(x)).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_hmm.py bench \\
        1024 200 200 7

prints the reference's numbers of ``chip_smoke.py`` phase 9's HMM run on
the committed data (``boom_tpu_torch/data/hmm.npz``): 1024 chains, 200
burn-in + 200 draws from ``jax.random.key(7)``, the draws relabelled by
mu (``REFERENCE_*_HMM``): over all chains, and the share of chains in the
main mode (``mixtures.main_mode``) with their R-hat and min-ESS.
"""

import itertools
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.models import hmm as jhmm
from boom_tpu.models import hmm_parallel as jhp
from boom_tpu_torch import convert, data
from boom_tpu_torch.models import hmm, hmm_parallel, mixtures

torch.set_num_threads(1)

F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
RTOL = 1e-10
SWEEP_RTOL = 1e-9


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, rtol=RTOL, atol=1e-300):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=rtol, atol=atol)


def _problem(rng, c, t_len, s):
    ll = -2.0 * rng.normal(size=(c, t_len, s)) ** 2
    lt = np.log(rng.dirichlet(np.ones(s), size=(c, s)))
    li = np.log(rng.dirichlet(np.ones(s), size=c))
    return ll, lt, li


def _ref_forward(ll, lt, li):
    return jax.jit(jax.vmap(jhmm.forward_filter))(
        jnp.asarray(ll), jnp.asarray(lt), jnp.asarray(li))


def path_uniforms(key, t_len, s):
    """The Gumbel uniforms [T, S] of the reference's backward_sample(key)."""
    k_last, k_scan = jax.random.split(key)
    last = jax.random.uniform(k_last, (s,), F64, minval=TINY)
    keys = jax.random.split(k_scan, t_len - 1)
    rows = jax.vmap(lambda k: jax.random.uniform(k, (s,), F64,
                                                 minval=TINY))(keys)
    return jnp.concatenate([rows, last[None]])


def gamma_u(key, alpha):
    """u = F(g) at the reference's own jax.random.gamma(key, alpha)."""
    alpha = jnp.asarray(alpha, F64)
    g = jax.random.gamma(key, alpha, alpha.shape, F64)
    return jax.scipy.special.gammainc(alpha, g)


@pytest.mark.parametrize("s, t_len", [(1, 5), (2, 1), (2, 40), (3, 33),
                                      (8, 17)])
def test_forward_filter_matches_reference(s, t_len):
    ll, lt, li = _problem(np.random.default_rng(s + t_len), 5, t_len, s)
    la, loglike = hmm.forward_filter(_t(ll), _t(lt), _t(li))
    jla, jll = _ref_forward(ll, lt, li)
    _close(la, jla)
    _close(loglike, jll)
    none, alone = hmm.forward_filter(_t(ll), _t(lt), _t(li),
                                     want_alphas=False)
    assert none is None and torch.equal(alone, loglike)


def test_parallel_forward_filter_matches_reference():
    """The associative scan against the reference's at its own test's
    shape (T = 900, S = 4), and against the sequential filter."""
    ll, lt, li = _problem(np.random.default_rng(3), 3, 900, 4)
    la, loglike = hmm_parallel.parallel_forward_filter(_t(ll), _t(lt), _t(li))
    jla, jll = jax.jit(jax.vmap(jhp.parallel_forward_filter))(
        jnp.asarray(ll), jnp.asarray(lt), jnp.asarray(li))
    _close(la, jla, atol=1e-10)
    _close(loglike, jll)
    sla, sll = hmm.forward_filter(_t(ll), _t(lt), _t(li))
    assert float((la - sla).abs().max()) < 1e-9
    _close(loglike, sll.numpy(), rtol=1e-8)


@pytest.mark.parametrize("s, t_len", [(1, 4), (2, 1), (2, 40), (3, 33)])
def test_backward_sample_matches_reference(s, t_len):
    rng = np.random.default_rng(10 + s)
    ll, lt, li = _problem(rng, 6, t_len, s)
    jla, _ = _ref_forward(ll, lt, li)
    keys = jax.random.split(jax.random.key(s), 6)
    jz = jax.vmap(jhmm.backward_sample)(keys, jla, jnp.asarray(lt))
    u = jax.vmap(lambda k: path_uniforms(k, t_len, s))(keys)
    z = hmm.backward_sample(_t(jla), _t(lt), _t(u))
    assert z.dtype == torch.int32
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    z2, suf, counts, first = hmm.backward_sample_stats(
        _t(jla), _t(lt), _t(u), torch.linspace(-1.0, 2.0, t_len,
                                                dtype=torch.float64))
    assert torch.equal(z2, z)
    _close(counts, jax.vmap(lambda p: jhmm.transition_counts(p, s))(jz))
    _close(first, jax.nn.one_hot(jz[:, 0], s))
    assert torch.equal(suf.n.sum(1), torch.full((6,), float(t_len),
                                                dtype=torch.float64))


def test_smoothed_marginals_and_counts_match_reference():
    ll, lt, li = _problem(np.random.default_rng(5), 4, 50, 3)
    post, loglike = hmm.smoothed_marginals(_t(ll), _t(lt), _t(li))
    jpost, jll = jax.vmap(jhmm.smoothed_marginals)(
        jnp.asarray(ll), jnp.asarray(lt), jnp.asarray(li))
    _close(post, jpost, atol=1e-15)
    _close(loglike, jll)
    z = np.random.default_rng(6).integers(0, 3, size=(4, 50))
    _close(hmm.transition_counts(_t(z), 3),
           jax.vmap(lambda p: jhmm.transition_counts(p, 3))(jnp.asarray(z)))


# -- the reference's own checks (tests/test_hmm.py) -------------------------


def _tiny_hmm():
    trans = np.asarray([[0.8, 0.2], [0.3, 0.7]])
    init = np.asarray([0.6, 0.4])
    ll = np.random.default_rng(0).normal(size=(6, 2))
    return trans, init, ll


def _paths(trans, init, ll):
    t_len, s = ll.shape
    for path in itertools.product(range(s), repeat=t_len):
        lp = np.log(init[path[0]]) + ll[0, path[0]]
        for t in range(1, t_len):
            lp += np.log(trans[path[t - 1], path[t]]) + ll[t, path[t]]
        yield path, lp


def test_forward_filter_matches_brute_force():
    trans, init, ll = _tiny_hmm()
    _, loglike = hmm.forward_filter(_t(ll)[None], _t(np.log(trans))[None],
                                    _t(np.log(init))[None])
    want = -np.inf
    for _path, lp in _paths(trans, init, ll):
        want = np.logaddexp(want, lp)
    np.testing.assert_allclose(float(loglike[0]), want, rtol=1e-10)


def _brute_marginals(trans, init, ll):
    marg = np.zeros(ll.shape)
    for path, lp in _paths(trans, init, ll):
        for t, s in enumerate(path):
            marg[t, s] += np.exp(lp)
    return marg / marg.sum(1, keepdims=True)


def test_smoothed_marginals_match_brute_force():
    trans, init, ll = _tiny_hmm()
    post, _ = hmm.smoothed_marginals(_t(ll)[None], _t(np.log(trans))[None],
                                     _t(np.log(init))[None])
    np.testing.assert_allclose(post[0].numpy(),
                               _brute_marginals(trans, init, ll), rtol=1e-8)


def test_backward_sample_matches_marginals():
    """40,000 backward draws (chains) against the smoothed marginals, the
    reference's atol."""
    trans, init, ll = _tiny_hmm()
    c = 40_000
    la, _ = hmm.forward_filter(_t(ll)[None], _t(np.log(trans))[None],
                               _t(np.log(init))[None])
    gen = torch.Generator().manual_seed(0)
    u = torch.rand((c, 6, 2), generator=gen, dtype=torch.float64).clamp_min(
        TINY)
    z = hmm.backward_sample(la.expand(c, -1, -1),
                            _t(np.log(trans))[None].expand(c, -1, -1), u)
    freq = torch.nn.functional.one_hot(z.long(), 2).double().mean(0)
    np.testing.assert_allclose(freq.numpy(),
                               _brute_marginals(trans, init, ll), atol=0.01)


def test_transition_counts():
    z = torch.tensor([0, 0, 1, 1, 0, 2])
    want = np.zeros((3, 3))
    for a, b in zip([0, 0, 1, 1, 0], [0, 1, 1, 0, 2]):
        want[a, b] += 1
    np.testing.assert_allclose(hmm.transition_counts(z, 3).numpy(), want)


# -- GaussianHmm -------------------------------------------------------------


def _models(t_len=60, parallel=False):
    y, _ = jhmm.GaussianHmm.simulate(jax.random.key(1), t_len,
                                     [[0.9, 0.1], [0.15, 0.85]], [-1.0, 1.5],
                                     [0.7, 0.5])
    jmodel = jhmm.GaussianHmm(y=y, num_states=2, parallel_filter=parallel)
    return jmodel, convert.hmm_from_jax(jmodel, device="cpu")


def sweep_noise(jmodel, key, state):
    """The port's noise of the reference's kernel()(key, state), with its
    uniforms of the gamma draws rebuilt at the reference's own path."""
    s, t_len = jmodel.num_states, jmodel.y.shape[0]
    kz, kc, kt, ki = jax.random.split(key, 4)
    la, _ = jhmm.forward_filter(jmodel.emission_loglik(state),
                                jnp.log(state["trans"]),
                                jnp.log(state["init"]))
    z = jhmm.backward_sample(kz, la, jnp.log(state["trans"]))
    onehot = jax.nn.one_hot(z, s, dtype=F64)
    k1, k2 = jax.random.split(kc)
    return {"path_u": path_uniforms(kz, t_len, s),
            "sig_u": gamma_u(k1, 0.5 * (jmodel.sigma_df + onehot.sum(0))),
            "mu_z": jax.random.normal(k2, (s,), F64),
            "trans_u": gamma_u(kt, jmodel.trans_prior
                               + onehot[:-1].T @ onehot[1:]),
            "init_u": gamma_u(ki, jmodel.init_prior + onehot[0])}


def _stack(trees):
    return {k: torch.tensor(np.stack([np.asarray(t[k]) for t in trees]))
            for k in trees[0]}


@pytest.mark.parametrize("parallel", [False, True])
def test_gaussian_hmm_init_and_sweep_match_reference(parallel):
    jmodel, model = _models(parallel=parallel)
    keys = jax.random.split(jax.random.key(2), 5)
    jstates = [jax.jit(jmodel.init_state)(k) for k in keys]
    # the start: the reference's quantile uniforms and Dirichlet(5) rows
    init_noise = []
    for k in keys:
        k1, k2, _k3 = jax.random.split(k, 3)
        init_noise.append({"q_u": jax.random.uniform(k1, (2,), F64),
                           "trans_u": gamma_u(k2, jnp.full((2, 2), 5.0))})
    st = model.init_state(_stack(init_noise))
    for name in ("mu", "sigsq", "trans", "init"):
        _close(st[name], np.stack([np.asarray(j[name]) for j in jstates]),
               rtol=SWEEP_RTOL)
    # one sweep from the reference's starts on its keys
    sweep_keys = jax.random.split(jax.random.key(3), 5)
    jkern = jax.jit(jmodel.kernel())
    want = [jkern(k, j) for k, j in zip(sweep_keys, jstates)]
    jnoise = jax.jit(lambda k, j: sweep_noise(jmodel, k, j))
    noise = _stack([jnoise(k, j) for k, j in zip(sweep_keys, jstates)])
    got = model.kernel()(noise, _stack(jstates))
    for name in ("mu", "sigsq", "trans", "init"):
        _close(got[name], np.stack([np.asarray(w[name]) for w in want]),
               rtol=SWEEP_RTOL)
    # functions of the draws: held at the sweep's tolerance
    _close(model.log_lik(got),
           np.stack([np.asarray(jmodel.log_lik(w)) for w in want]),
           rtol=SWEEP_RTOL)
    _close(model.emission_loglik(got),
           np.stack([np.asarray(jmodel.emission_loglik(w)) for w in want]),
           rtol=SWEEP_RTOL)


def test_simulate_matches_reference():
    key = jax.random.key(8)
    trans, means, sds = [[0.7, 0.3], [0.2, 0.8]], [-1.0, 2.0], [0.5, 1.0]
    jy, jz = jhmm.GaussianHmm.simulate(key, 40, trans, means, sds)
    kz0, kz, ky = jax.random.split(key, 3)
    z0_u = jax.random.uniform(kz0, (2,), F64, minval=TINY)
    z_u = jax.vmap(lambda k: jax.random.uniform(k, (2,), F64, minval=TINY))(
        jax.random.split(kz, 39))
    y, z = hmm.GaussianHmm.simulate(_t(z0_u), _t(z_u),
                                    _t(jax.random.normal(ky, (40,), F64)),
                                    trans, means, sds)
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))
    _close(y, jy)


def test_gaussian_hmm_parallel_filter_option():
    """The reference's check of GaussianHmm(parallel_filter=True): 60
    sweeps from its data find both means."""
    key = jax.random.key(4)
    zt = (jnp.cumsum(jax.random.bernoulli(key, 0.05, (300,)).astype(
        jnp.int32)) % 2)
    y = jnp.where(zt == 0, -1.5, 1.5) + 0.5 * jax.random.normal(
        jax.random.fold_in(key, 1), (300,))
    model = hmm.GaussianHmm(y=_t(y), num_states=2, parallel_filter=True)
    gen = torch.Generator().manual_seed(5)
    st = model.init_state(model.draw_init_noise(gen, 1))
    kern = model.kernel()
    for _ in range(60):
        st = kern(model.draw_noise(gen, 1), st)
    mu = np.sort(st["mu"][0].numpy())
    assert abs(mu[0] + 1.5) < 0.5 and abs(mu[1] - 1.5) < 0.5, mu


def test_gaussian_hmm_refuses_too_many_states_on_the_kernel_path():
    from boom_tpu_torch.models import hmm_kernel

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        hmm_kernel._states(17)


# -- bench: the reference's numbers of chip_smoke.py phase 9 ---------------


def bench(chains=1024, burn=200, draws=200, seed=7):
    """The reference's HMM run on the committed data: medians, R-hat and
    min-ESS a draw of mu, sd and the transition diagonal, relabelled by
    mu (one JSON line)."""
    from boom_tpu.inference import diagnostics as jdiag
    from boom_tpu.inference import run_mcmc

    y = jnp.asarray(data.hmm()["y"])
    model = jhmm.GaussianHmm(y=y, num_states=2)
    res = run_mcmc(jax.random.key(seed), model.kernel(), model.init_state,
                   num_draws=draws, num_chains=chains, burn=burn)
    mon = relabelled(np.asarray(res.draws["mu"]),
                     np.asarray(res.draws["sigsq"]),
                     np.asarray(res.draws["trans"]))
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


MONITOR = ("mu0", "mu1", "sd0", "sd1", "p00", "p11")


def relabelled(mu, sigsq, trans):
    """[C, N, 6]: mu, sd and the transition diagonal with the states
    ordered by mu in every draw (numpy)."""
    order = np.argsort(mu, axis=-1)
    take = np.take_along_axis
    mu_s = take(mu, order, -1)
    sd_s = np.sqrt(take(sigsq, order, -1))
    diag = np.diagonal(trans, axis1=-2, axis2=-1)
    return np.concatenate([mu_s, sd_s, take(diag, order, -1)], axis=-1)


if __name__ == "__main__":
    if sys.argv[1:2] == ["bench"]:
        jax.config.update("jax_enable_x64", False)
        bench(*(int(a) for a in sys.argv[2:6]))
