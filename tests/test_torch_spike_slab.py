"""The port's spike-and-slab regression (``boom_tpu_torch/models/glm``)
against the JAX reference, on the CPU in float64: the prior and the
sufficient statistics, the log model probability, the SWEEP path's flip
scan and mode-jump walk, one whole sweep on the reference's own key tree,
the Cholesky oracle, the ``max_size`` cap and ``LmSpike``.

The port takes its noise as tensors; each test rebuilds it from the
reference's keys, split in the reference's order (``kernel()`` splits its
key in 4, ``draw_indicators_swept`` its second key in 3, a key a flip), so
both sides draw with the same numbers.

Tolerances:
- prior, sufficient statistics, log model probabilities: rtol 1e-12 (the
  same arithmetic; the libraries' Cholesky factors and solves round
  differently);
- masks: identical (the decisions compare the same uniforms with
  thresholds that agree to ~1e-13);
- beta and sigma^2 of a sweep: rtol 1e-7 (the reference draws sigma^2's
  precision from ``jax.random.gamma``, rebuilt here as the uniform F(g)
  that the port's inverse CDF maps back to g; PyTorch's incomplete gamma
  is accurate to ~1e-9).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_spike_slab.py bench

prints the reference's posterior medians and inclusion probabilities of
the spike_slab bench workload on the committed data
(``boom_tpu_torch/data``), x64 off as the bench runs, 64 chains, 50 + 200
sweeps: ``chip_smoke.py`` holds the port to them
(``REFERENCE_MEDIANS_SPIKE``).
"""

import importlib
import itertools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.models.glm import regression as jreg
from boom_tpu_torch import rng as prng
from boom_tpu_torch.convert import (
    reg_suf_from_numpy,
    spike_slab_prior_from_numpy,
)
from boom_tpu_torch.dists import scaled_inv_chisq
from boom_tpu_torch.models.glm import regression as reg
from boom_tpu_torch.models.glm import regression_sweep as rs

jrs = importlib.import_module("boom_tpu.models.glm.regression_sweep")

torch.set_num_threads(1)

RTOL = 1e-12
DRAW_RTOL = 1e-7
F64 = jnp.float64


def _close(port, ref, rtol=RTOL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(port), ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-300))


def _data(n, p, nonzero=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p))
    x[:, 0] = 1.0
    beta = np.zeros(p)
    nonzero = min(nonzero, p)
    beta[:nonzero] = rng.choice([-1.5, 1.5], size=nonzero)
    return x, x @ beta + rng.normal(size=n)


def _models(n=150, p=8, seed=0, **kw):
    """(reference model, port model) on the same data and prior."""
    x, y = _data(n, p, seed=seed)
    mode_jump = kw.pop("mode_jump", True)
    method = kw.pop("method", "sweep")
    jmodel = jreg.SpikeSlabRegression.from_data(
        jnp.asarray(x), jnp.asarray(y), method=method, mode_jump=mode_jump,
        **kw)
    model = reg.SpikeSlabRegression(
        suf=reg_suf_from_numpy(jmodel.suf, device="cpu"),
        prior=spike_slab_prior_from_numpy(jmodel.prior, device="cpu"),
        max_flips=jmodel.max_flips, method=method, mode_jump=mode_jump)
    return jmodel, model


def _masks(rng, c, p, prob=0.4):
    return rng.uniform(size=(c, p)) < prob


# -- the prior and the sufficient statistics ------------------------------


@pytest.mark.parametrize("kw", [
    {}, {"expected_model_size": 3.0, "max_size": 4,
         "sigma_upper_limit": 2.5},
    {"prior_inclusion_probabilities": np.linspace(0.1, 0.9, 7),
     "optional_coefficient_estimate": np.linspace(-1, 1, 7)}])
def test_prior_and_suf_match_reference(kw):
    x, y = _data(120, 7)
    jprior = jreg.SpikeSlabPrior.from_data(jnp.asarray(x), jnp.asarray(y),
                                           **kw)
    prior = reg.SpikeSlabPrior.from_data(torch.tensor(x), torch.tensor(y),
                                         **kw)
    for name in ("mean", "unscaled_precision", "log_inclusion_odds",
                 "log_inclusion_norm", "sigma_df", "prior_ss"):
        _close(getattr(prior, name), getattr(jprior, name))
    assert prior.max_size == jprior.max_size
    assert prior.sigma_upper_limit == jprior.sigma_upper_limit
    jsuf = jreg.RegSuf.from_data(jnp.asarray(x), jnp.asarray(y))
    suf = reg.RegSuf.from_data(torch.tensor(x), torch.tensor(y))
    for name in reg.RegSuf._fields:
        _close(getattr(suf, name), getattr(jsuf, name))
    _close(suf.combine(suf).xtx, jsuf.combine(jsuf).xtx)
    masks = _masks(np.random.default_rng(1), 6, 7)
    _close(prior.spike_logp(torch.tensor(masks)),
           jprior.spike_logp(jnp.asarray(masks)))
    qp = reg.screening_proposal_probs(suf, prior)
    _close(qp, jreg.screening_proposal_probs(jsuf, jprior))


def test_log_model_prob_every_mask_against_reference_and_sweep_state():
    jmodel, model = _models(p=6)
    masks = np.array(list(itertools.product([False, True], repeat=6)))
    ref = jax.vmap(lambda m: jreg.log_model_prob(jmodel.suf, jmodel.prior,
                                                 m))(jnp.asarray(masks))
    tm = torch.tensor(masks)
    _close(reg.log_model_prob(model.suf, model.prior, tm), ref)
    df = model.suf.n + model.prior.sigma_df
    st = rs.build_sweep_state(model.suf, model.prior, tm)
    # the SWEEP state's log model probability differs from the Cholesky
    # one by a constant (the normalisation both sides drop)
    via_sweep = rs._log_model_prob(st, df).numpy()
    diff = via_sweep - np.asarray(ref)
    np.testing.assert_allclose(diff, diff[0], atol=1e-9)
    # and the reference's SWEEP state gives the same numbers
    jst = jax.vmap(lambda m: jrs.build_sweep_state(jmodel.suf, jmodel.prior,
                                                   m))(jnp.asarray(masks))
    _close(st.s, jst.s)
    _close(st.o, jst.o)
    _close(st.logdet_a, jst.logdet_a)
    _close(via_sweep, jax.vmap(lambda s: jrs._log_model_prob(s, df.item()))(
        jst))


def test_reg_post_params_and_draws_match_reference():
    jmodel, model = _models(p=7)
    rng = np.random.default_rng(2)
    masks = _masks(rng, 5, 7)
    post = reg.reg_post_params(model.suf, model.prior, torch.tensor(masks))
    jpost = jax.vmap(lambda m: jreg.reg_post_params(
        jmodel.suf, jmodel.prior, m))(jnp.asarray(masks))
    for name in ("chol", "beta_tilde", "ss"):
        _close(getattr(post, name), getattr(jpost, name), 1e-11)
    assert int(post.info.abs().sum()) == 0
    keys = jax.random.split(jax.random.key(3), 5)
    sigsq = jax.vmap(lambda k, m: jreg.draw_sigsq(k, jmodel.suf,
                                                  jmodel.prior, m))(
        keys, jnp.asarray(masks))
    a = 0.5 * float(jpost.df[0])
    u = jax.vmap(lambda k: jax.scipy.special.gammainc(
        a, jax.random.gamma(k, a, (), F64)))(keys)
    port_sigsq = reg.draw_sigsq(torch.tensor(np.asarray(u)), model.suf,
                                model.prior, torch.tensor(masks))
    _close(port_sigsq, sigsq, DRAW_RTOL)
    z = jax.vmap(lambda k: jax.random.normal(k, (7,), F64))(keys)
    beta = jax.vmap(lambda k, m, s: jreg.draw_beta(
        k, jmodel.suf, jmodel.prior, m, s))(keys, jnp.asarray(masks), sigsq)
    _close(reg.draw_beta(torch.tensor(np.asarray(z)), model.suf, model.prior,
                         torch.tensor(masks),
                         torch.tensor(np.asarray(sigsq))), beta, 1e-11)


def test_sample_upper_truncated_matches_reference():
    """The reference inverts the chi-square CDF above df s^2 / upper; the
    port the precision's gamma CDF above 1 / upper: the same level u gives
    the same draw."""
    keys = jax.random.split(jax.random.key(4), 16)
    df = 7.5
    sigsq = np.linspace(0.5, 3.0, 16)
    upper = 1.2
    ref = jax.vmap(lambda k, s: jreg.dists.scaled_inv_chisq
                   .sample_upper_truncated(k, df, s, upper))(
        keys, jnp.asarray(sigsq))
    u = jax.vmap(lambda k: jax.random.uniform(k, (), F64))(keys)
    out = scaled_inv_chisq.sample_upper_truncated(
        torch.tensor(np.asarray(u)), df, torch.tensor(sigsq), upper)
    _close(out, ref, DRAW_RTOL)
    assert float(out.max()) <= upper


# -- the SWEEP path --------------------------------------------------------


def _flip_noise(key, p, n_flips):
    """The permutation and flip uniforms of the reference's
    draw_indicators_swept(key, ...) (regression_sweep.py:250, :288)."""
    _k_jump, k_perm, k_scan = jax.random.split(key, 3)
    perm = jax.random.permutation(k_perm, p)
    keys = jax.random.split(k_scan, n_flips)
    u = jax.vmap(lambda k: jax.random.uniform(k, (), F64))(keys)
    flip_u = jnp.concatenate([u, jnp.full((p - n_flips,), 0.5, F64)])
    return perm, flip_u


def _jump_noise(key, p):
    """The proposal and acceptance uniforms of _mode_jump_swept(key)."""
    k_prop, k_acc = jax.random.split(key)
    return (jax.random.uniform(k_prop, (p,), F64),
            jax.random.uniform(k_acc, (), F64))


def _stack(trees):
    return {k: torch.tensor(np.stack([np.asarray(t[k]) for t in trees]))
            for k in trees[0]}


@pytest.mark.parametrize("p", [1, 9])
def test_flip_scan_matches_reference(p):
    """Given the reference's own permutation and uniforms, the port's flip
    scan ends in identical masks."""
    jmodel, model = _models(p=p, seed=p)
    rng = np.random.default_rng(5)
    c = 8
    masks = _masks(rng, c, p)
    keys = jax.random.split(jax.random.key(6), c)
    ref = jax.vmap(lambda k, m: jrs.draw_indicators_swept(
        k, jmodel.suf, jmodel.prior, m))(keys, jnp.asarray(masks))
    noise = _stack([dict(zip(("perm", "flip_u"), _flip_noise(k, p, p)))
                    for k in keys])
    record = []
    out = rs.draw_indicators_swept(noise, model.suf, model.prior,
                                   torch.tensor(masks), record=record)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert len(record) == p
    if p > 1:
        # some flips were taken
        assert bool((out != torch.tensor(masks)).any())


def test_mode_jump_walk_accepts_and_rejects_as_reference():
    jmodel, model = _models(p=10, seed=7)
    rng = np.random.default_rng(8)
    c = 32
    masks = _masks(rng, c, 10, prob=0.2)
    # half the chains start at the true support: their proposals that
    # differ are worse, and rejected
    masks[::2] = np.arange(10) < 3
    df = model.suf.n + model.prior.sigma_df
    qprobs = reg.screening_proposal_probs(model.suf, model.prior)
    jq = jnp.asarray(qprobs.numpy())
    keys = jax.random.split(jax.random.key(9), c)

    def ref_one(k, m):
        st = jrs.build_sweep_state(jmodel.suf, jmodel.prior, m)
        lp = jrs._log_model_prob(st, df.item())
        st2, lp2 = jrs._mode_jump_swept(k, st, lp, jmodel.prior, df.item(),
                                        jq)
        return st2.mask, lp2, st2.s

    ref_mask, ref_lp, ref_s = jax.vmap(ref_one)(keys, jnp.asarray(masks))
    ju, ja = zip(*(_jump_noise(k, 10) for k in keys))
    tm = torch.tensor(masks)
    st = rs.build_sweep_state(model.suf, model.prior, tm)
    lp = rs._log_model_prob(st, df)
    st2, lp2 = rs._mode_jump_swept(torch.tensor(np.stack(ju)),
                                   torch.tensor(np.stack(ja)), st, lp,
                                   model.prior, df, qprobs)
    np.testing.assert_array_equal(st2.mask.numpy(), np.asarray(ref_mask))
    _close(lp2, ref_lp, 1e-10)
    _close(st2.s, ref_s, 1e-10)
    moved = (st2.mask != tm).any(-1)
    proposed = (torch.tensor(np.stack(ju)) < qprobs) != tm
    rejected = proposed.any(-1) & ~moved
    assert bool(moved.any()) and bool(rejected.any())
    # a rejected chain keeps its state exactly
    assert torch.equal(st2.s[~moved], st.s[~moved])


def _sweep_noise(key, model, method):
    """The port's noise of one sweep of the reference's kernel()(key, .)
    (regression.py:324), for one chain."""
    p = model.num_predictors
    k0, k1, k2, k3 = jax.random.split(key, 4)
    qprobs = (reg.screening_proposal_probs(model.suf, model.prior)
              if model.mode_jump else None)
    noise = {}
    if method == "sweep":
        n_flips = rs.flip_count(p, model.max_flips, qprobs)
        noise["perm"], noise["flip_u"] = _flip_noise(k1, p, n_flips)
        if model.mode_jump:
            noise["jump_u"], noise["jump_acc"] = _jump_noise(
                jax.random.split(k1, 3)[0], p)
    else:
        k_perm, k_scan = jax.random.split(k1)
        noise["perm"] = jax.random.permutation(k_perm, p)
        n_flips = p if model.max_flips is None else model.max_flips
        u = jax.vmap(lambda k: jax.random.uniform(k, (), F64))(
            jax.random.split(k_scan, n_flips))
        noise["flip_u"] = jnp.concatenate(
            [u, jnp.full((p - n_flips,), 0.5, F64)])
        if model.mode_jump:
            noise["jump_u"], noise["jump_acc"] = _jump_noise(k0, p)
    return noise, k2, k3


@pytest.mark.parametrize("method,mode_jump,max_flips", [
    ("sweep", False, None), ("sweep", True, None), ("sweep", False, 4),
    ("cholesky", True, None)])
def test_one_sweep_matches_reference_kernel(method, mode_jump, max_flips):
    p, c = 10, 8
    jmodel, model = _models(p=p, seed=11, method=method,
                            mode_jump=mode_jump)
    if max_flips is not None:
        jmodel = jreg.SpikeSlabRegression(jmodel.suf, jmodel.prior,
                                          max_flips, method, mode_jump)
        model = reg.SpikeSlabRegression(model.suf, model.prior, max_flips,
                                        method, mode_jump)
    rng = np.random.default_rng(12)
    masks = _masks(rng, c, p)
    state = {"gamma": jnp.asarray(masks), "beta": jnp.zeros((c, p), F64),
             "sigsq": jnp.ones((c,), F64)}
    keys = jax.random.split(jax.random.key(13), c)
    ref = jax.vmap(jmodel.kernel())(keys, state)
    per = [_sweep_noise(k, model, method) for k in keys]
    noise = _stack([n for n, _k2, _k3 in per])
    # sigma^2's precision: the reference's gamma draw as its CDF level
    a = 0.5 * float(model.suf.n + model.prior.sigma_df)
    noise["sigsq_u"] = torch.tensor(np.array([float(
        jax.scipy.special.gammainc(a, jax.random.gamma(k2, a, (), F64)))
        for _n, k2, _k3 in per]))
    noise["beta_z"] = torch.tensor(np.stack([np.asarray(
        jax.random.normal(k3, (p,), F64)) for _n, _k2, k3 in per]))
    assert set(noise) == set(model.noise_spec())
    kern = model.kernel()
    out = kern(noise, {"gamma": torch.tensor(masks),
                       "beta": torch.zeros(c, p, dtype=torch.float64),
                       "sigsq": torch.ones(c, dtype=torch.float64)})
    kern.finish()
    np.testing.assert_array_equal(out["gamma"].numpy(),
                                  np.asarray(ref["gamma"]))
    _close(out["sigsq"], ref["sigsq"], DRAW_RTOL)
    _close(out["beta"], ref["beta"], DRAW_RTOL)


def test_sweep_matches_cholesky_oracle():
    """The SWEEP path and the Cholesky oracle draw identical masks from the
    same noise (the same target, the same decisions)."""
    _jmodel, model = _models(p=10, seed=14)
    gen = prng.generator(15, "cpu")
    c = 8
    mask = torch.tensor(_masks(np.random.default_rng(16), c, 10))
    for _ in range(3):
        noise = model.draw_noise(gen, c)
        swept = rs.draw_indicators_swept(noise, model.suf, model.prior, mask)
        chol = reg.draw_indicators_sweep(noise, model.suf, model.prior, mask)
        assert torch.equal(swept, chol)
        mask = swept
    qprobs = reg.screening_proposal_probs(model.suf, model.prior)
    noise = model.draw_noise(gen, c)
    st = rs.build_sweep_state(model.suf, model.prior, mask)
    df = model.suf.n + model.prior.sigma_df
    st2, _ = rs._mode_jump_swept(noise["jump_u"], noise["jump_acc"], st,
                                 rs._log_model_prob(st, df), model.prior, df,
                                 qprobs)
    oracle = reg.mode_jump_move(noise, model.suf, model.prior, mask, qprobs)
    assert torch.equal(st2.mask, oracle)


def test_max_size_is_enforced_where_the_reference_exceeds_it():
    """The reference's SWEEP path takes the spike prior once and then adds
    log odds a flip, so it never applies max_size (ROADMAP.md §3): on p=8
    with max_size=1 its masks grow past the cap. The port's never do, and
    agree with the Cholesky oracle, which applies the cap."""
    p, max_size, c = 8, 1, 20
    jmodel, model = _models(p=p, seed=17, mode_jump=False,
                            expected_model_size=3.0, max_size=max_size)
    keys = jax.random.split(jax.random.key(18), c)
    start = np.zeros((c, p), bool)
    ref = jax.vmap(lambda k, m: jrs.draw_indicators_swept(
        k, jmodel.suf, jmodel.prior, m))(keys, jnp.asarray(start))
    assert int(np.asarray(ref).sum(-1).max()) > max_size
    noise = _stack([dict(zip(("perm", "flip_u"), _flip_noise(k, p, p)))
                    for k in keys])
    mask = torch.tensor(start)
    for _ in range(3):
        out = rs.draw_indicators_swept(noise, model.suf, model.prior, mask)
        oracle = reg.draw_indicators_sweep(noise, model.suf, model.prior,
                                           mask)
        assert torch.equal(out, oracle)
        assert int(out.sum(-1).max()) <= max_size
        mask = out
    assert int(mask.sum()) > 0
    # the mode jump rejects proposals past the cap
    qprobs = torch.full((p,), 0.9, dtype=torch.float64)
    gen = prng.generator(19, "cpu")
    jn = model.draw_noise(gen, c)
    jn.update(jump_u=torch.rand(c, p, generator=gen, dtype=torch.float64),
              jump_acc=torch.zeros(c, dtype=torch.float64))
    out = rs.draw_indicators_swept(jn, model.suf, model.prior, mask,
                                   qprobs=qprobs)
    assert int(out.sum(-1).max()) <= max_size
    # and an initial state past the cap is brought inside it
    init = model.init_state({"gamma_u": torch.zeros(c, p,
                                                    dtype=torch.float64)})
    assert int(init["gamma"].sum(-1).max()) == max_size


def test_simulate_draws_a_sparse_problem_from_the_generator():
    gen = prng.generator(24, "cpu")
    x, y, beta = reg.SpikeSlabRegression.simulate(gen, 50, 6, 2, sigma=0.5)
    assert x.shape == (50, 6) and y.shape == (50,)
    assert bool((x[:, 0] == 1.0).all())
    assert beta[:2].abs().tolist() == [2.0, 2.0] and bool((beta[2:] == 0).all())
    again = reg.SpikeSlabRegression.simulate(prng.generator(24, "cpu"), 50, 6,
                                             2, sigma=0.5)
    assert all(torch.equal(a, b) for a, b in zip((x, y, beta), again))


def test_permutation_noise_is_a_permutation():
    gen = prng.generator(20, "cpu")
    perm = prng.draw(gen, {"perm": ((50,), "permutation")}, 64,
                     torch.float32)["perm"]
    assert perm.dtype == torch.int64 and perm.shape == (64, 50)
    assert torch.equal(perm.sort(-1).values,
                       torch.arange(50).expand(64, 50))


def test_lm_spike_fit_on_the_cpu():
    from boom_tpu_torch.api import LmSpike

    x, y = _data(200, 6, nonzero=2, seed=21)
    fit = LmSpike(expected_model_size=2.0).fit(
        x, y, niter=40, num_chains=4, burn=20, seed=3, device="cpu")
    assert fit.draws["beta"].shape == (4, 40, 6)
    rows = fit.coefficients()
    assert [r["inclusion_prob"] > 0.9 for r in rows[:2]] == [True, True]
    summ = fit.summary()
    assert set(summ) == {"coefficients", "residual_sd", "diagnostics"}
    assert np.isfinite(summ["residual_sd"]["mean"])
    pred = fit.predict(x[:5], seed=1)
    assert pred.shape == (160, 5) and bool(torch.isfinite(pred).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        LmSpike(prior=object())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit.plot()


def test_failed_cholesky_raises_at_the_end_of_the_run():
    """A factor that fails is counted on the device and reported once the
    run ends; the run does not carry on silently."""
    from boom_tpu_torch.inference.driver import run_mcmc

    _jmodel, model = _models(p=5, seed=22, mode_jump=False)
    bad = model.prior.unscaled_precision.clone()
    bad[0, 0] = -1e6
    broken = reg.SpikeSlabRegression(
        model.suf, reg.SpikeSlabPrior(**{**model.prior.__dict__,
                                         "unscaled_precision": bad}),
        mode_jump=False)
    with pytest.raises(RuntimeError, match="Cholesky"):
        run_mcmc(broken.kernel(), broken.draw_noise,
                 lambda g, c: {"gamma": torch.ones(c, 5, dtype=torch.bool),
                               "beta": torch.zeros(c, 5,
                                                   dtype=torch.float64),
                               "sigsq": torch.ones(c, dtype=torch.float64)},
                 2, generator=prng.generator(0, "cpu"), num_chains=2)


@pytest.fixture(scope="module")
def host_ssvs_library():
    """ssvs_sweep.cu compiled for the host (``kernels/host_rehearsal.py``),
    once for the module."""
    import shutil

    from boom_tpu_torch.kernels import host_rehearsal

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile kernel (a) for the host")
    return host_rehearsal.build_host_library("ssvs_sweep")


@pytest.fixture
def host_ssvs(monkeypatch, host_ssvs_library):
    """ssvs_kernel's wrapper bound to the host library, launching on CPU
    tensors."""
    from boom_tpu_torch.kernels import _build
    from boom_tpu_torch.models.glm import ssvs_kernel

    lib = host_ssvs_library
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: lib for n in names})
    monkeypatch.setattr(ssvs_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(ssvs_kernel, "_stream", lambda device: 0)
    _build.library.cache_clear()
    yield
    _build.library.cache_clear()


# p 31, 32, 33: at the edges of warp 0's 32 decisions a round and of a
# warp's row of the rank-1 update
@pytest.mark.parametrize("p,jump,max_size", [
    (1, False, None), (1, True, None), (37, False, None), (37, True, None),
    (37, True, 3), (31, False, None), (31, True, None), (32, False, None),
    (32, True, None), (33, False, None), (33, True, None)])
@pytest.mark.usefixtures("host_ssvs")
def test_host_compiled_kernel_a_matches_plain(p, jump, max_size):
    """Kernel (a) compiled from its source for the host (a block's threads
    as host threads, real barriers for the block and for each warp, warp
    shuffles and ballots through them) against the plain sweep, float64,
    33 chains (a block a chain): masks identical, every launch counted."""
    from boom_tpu_torch.kernels.ssvs_timing import problem
    from boom_tpu_torch.models.glm import ssvs_kernel

    rng = np.random.default_rng(23 + p)
    model, mask, noise, qprobs = problem(
        rng, 33, p, "float64", max_size=max_size, mode_jump=jump,
        device="cpu")
    want = rs.draw_indicators_swept(noise, model.suf, model.prior, mask,
                                    qprobs=qprobs)
    before = ssvs_kernel.LAUNCHES["ssvs_sweep"]
    got = ssvs_kernel.draw_indicators_swept(noise, model.suf, model.prior,
                                            mask, qprobs=qprobs)
    assert ssvs_kernel.LAUNCHES["ssvs_sweep"] == before + 1
    assert torch.equal(got, want)
    if p > 1:
        assert bool((got != mask).any())


# seconds a host barrier waits in the test below before the launch ends
UNMET_DEADLINE_S = 2.0


def test_host_barrier_never_met_makes_the_launch_raise(monkeypatch):
    """A barrier that thread 0 reaches and no other thread does (one more
    __syncthreads at the end of kernel (a), compiled for the host) ends
    the host launch with cudaErrorLaunchTimeout, within the deadline, and
    the wrapper raises: a barrier mismatch fails its test instead of
    hanging the suite."""
    import ctypes
    import shutil
    import time

    from boom_tpu_torch.kernels import _build, host_rehearsal
    from boom_tpu_torch.kernels.ssvs_timing import problem
    from boom_tpu_torch.models.glm import ssvs_kernel

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile kernel (a) for the host")
    src = _build.SOURCES["ssvs_sweep"].read_text()
    last = "    mask_out[row0 + i] = mask[i];\n"
    assert src.count(last) == 1
    lib = host_rehearsal.build_host_library(
        "ssvs_sweep_unmet",
        src.replace(last, last + "  if (threadIdx.x == 0) __syncthreads();\n"))
    ctypes.CDLL(str(lib)).boom_host_set_deadline(
        ctypes.c_double(UNMET_DEADLINE_S))
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: lib for n in names})
    monkeypatch.setattr(ssvs_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(ssvs_kernel, "_stream", lambda device: 0)
    _build.library.cache_clear()
    try:
        model, mask, noise, _q = problem(np.random.default_rng(5), 3, 5,
                                         "float64", device="cpu")
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="cudaError 702"):
            ssvs_kernel.draw_indicators_swept(noise, model.suf, model.prior,
                                              mask)
        assert time.perf_counter() - t0 < UNMET_DEADLINE_S + 30.0
    finally:
        _build.library.cache_clear()


def reference_medians(chains=64, burn=50, draws=200, seed=2026):
    """Posterior medians of beta[:8] and sigma^2, and the inclusion
    probabilities, of the JAX reference's spike_slab bench workload
    (bench.py:133-146: expected_model_size 10, no mode jump) on the
    committed data, x64 off as the bench runs."""
    from boom_tpu.inference import run_mcmc
    from boom_tpu_torch import data

    with jax.enable_x64(False):
        x, y = (jnp.asarray(a) for a in data.spike_slab_xy())
        jmodel = jreg.SpikeSlabRegression.from_data(
            x, y, expected_model_size=10.0, mode_jump=False)
        fit = jax.jit(lambda k: run_mcmc(
            k, jmodel.kernel(), jmodel.init_state, draws,
            num_chains=chains, burn=burn, jit=False,
            extract=lambda s: {"beta": s["beta"][:8], "sigsq": s["sigsq"],
                               "gamma": s["gamma"]}).draws)
        d = fit(jax.random.key(seed))
    beta, sigsq = np.asarray(d["beta"]), np.asarray(d["sigsq"])
    medians = [float(np.median(beta[..., j])) for j in range(8)]
    inclusion = np.asarray(d["gamma"]).reshape(-1, x.shape[1]).mean(0)
    return medians + [float(np.median(sigsq))], inclusion.tolist()


if __name__ == "__main__" and sys.argv[1:2] == ["bench"]:
    med, inc = reference_medians(*map(int, sys.argv[2:]))
    print("REFERENCE_MEDIANS_SPIKE =", med)
    print("inclusion probabilities:", inc)
