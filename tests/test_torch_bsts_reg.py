"""The port's bsts with a seasonal block and a spike-and-slab regression
against the JAX reference (float64, CPU).

Each test feeds the reference's function and the port's the same inputs;
the port's ``noise`` mappings are rebuilt from the reference's own keys,
split and folded in the reference's order, so both sides draw with the same
numbers. Tolerance 1e-10 where both compute the same operations, in
another order at most. The variance draws go through an inverse CDF of
the gamma distribution (the regression's sigma^2, and the state variances'
Newton polish), where PyTorch's incomplete gamma is ~1e-10 to 1e-9
relative off (test_torch_dists_diag.py; the variances of one sweep here
come out 1.6e-10 off, beta 5e-10 at its smallest entries): the states
of a whole sweep are held to ``SWEEP_RTOL`` = 1e-9 for that reason.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_bsts_reg.py bench

recomputes the reference numbers of chip_smoke.py's phase 6 (64 chains,
500 + 2000 sweeps on the committed data, x64 off as the bench runs).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.models.glm import regression as jreg
from boom_tpu.models.glm import regression_sweep as jrs
from boom_tpu.models.glm.regression import SpikeSlabPrior as JaxPrior
from boom_tpu.statespace import bsts as jbsts
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu.statespace.state_models import (
    LocalLinearTrend as JaxLocalLinearTrend,
    Seasonal as JaxSeasonal,
)
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.convert import (
    model_from_jax,
    reg_suf_from_numpy,
    spike_slab_prior_from_numpy,
    state_from_numpy,
)
from boom_tpu_torch.models.glm import regression as reg
from boom_tpu_torch.models.glm import regression_sweep as rs
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace import kalman, kalman_kernel, parallel_kalman
from boom_tpu_torch.statespace.bsts import ASIS_SHRINK, ASIS_SLICE_STEPS
from boom_tpu_torch.statespace.state_models import Seasonal, SdPrior

torch.set_num_threads(1)

RTOL = 1e-10
SWEEP_RTOL = 1e-9
F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
CHAINS, T_SMALL, P_SMALL = 4, 60, 5
REG_T, REG_HORIZON, REG_CHAINS = 500, 30, 64


# -- data and models -------------------------------------------------------


def _reg_data(t_len=T_SMALL, p=P_SMALL, nseasons=7, seed=11):
    """A trend, a seasonal pattern and two active predictors of p, drawn
    with numpy: (x [T, p], y [T])."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t_len, p))
    slope = np.cumsum(0.02 * rng.normal(size=t_len))
    level = np.cumsum(slope + 0.3 * rng.normal(size=t_len)) + 5.0
    pattern = rng.normal(size=nseasons)
    season = (pattern - pattern.mean())[np.arange(t_len) % nseasons]
    beta = np.zeros(p)
    beta[:2] = (2.0, -1.5)
    return x, level + season + x @ beta + 0.5 * rng.normal(size=t_len)


def _jax_model(nseasons=7, t_len=T_SMALL, p=P_SMALL, **kw):
    x, y = (jnp.asarray(a) for a in _reg_data(t_len, p, nseasons))
    prior = JaxPrior.from_data(x, y, expected_model_size=2.0,
                               prior_information_weight=1.0)
    return JaxBsts(y=y, blocks=[JaxLocalLinearTrend.default(y),
                                JaxSeasonal.default(y, nseasons=nseasons)],
                   predictors=x, reg_prior=prior, parallel_smoother=False,
                   **kw)


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _assert_states_close(port, ref, rtol):
    ref = _numpy_tree(ref)
    _close(port["sigsq_obs"], ref["sigsq_obs"], rtol, msg="sigsq_obs")
    for name, params in ref["blocks"].items():
        for pname, v in params.items():
            _close(port["blocks"][name][pname], v, rtol, msg=pname)
    np.testing.assert_array_equal(port["gamma"].numpy(), ref["gamma"])
    _close(port["beta"], ref["beta"], rtol, rtol, msg="beta")
    _close(port["alpha"], ref["alpha"], rtol, rtol, msg="alpha")


# -- the reference's random numbers as the port's noise ----------------------


def _uniform(key, minval=None, shape=()):
    if minval is None:
        return jax.random.uniform(key, shape, F64)
    return jax.random.uniform(key, shape, F64, minval=minval)


def _smoother_normals(key, d, q, t_len):
    k0, ka, ke = jax.random.split(key, 3)
    return {"sim_alpha1": jax.random.normal(k0, (d,)),
            "sim_eta": jax.random.normal(ka, (t_len - 1, q)),
            "sim_eps": jax.random.normal(ke, (t_len,))}


def _block_noise(block, key, init):
    """The uniforms a block draws from ``key`` (``init``: init_params'
    U[0, 1), else draw_params' U(tiny, 1))."""
    lo = None if init else TINY
    if isinstance(block, JaxSeasonal):
        return {"seasonal_u": _uniform(key, lo)}
    k1, k2 = jax.random.split(key)
    return {"level_u": _uniform(k1, lo), "slope_u": _uniform(k2, lo)}


def _init_noise(model, key):
    """The numbers the reference's ``init_state`` draws from ``key``."""
    keys = jax.random.split(key, len(model.blocks) + 3)
    q = sum(b.err_dim for b in model.blocks)
    p = model.predictors.shape[1]
    return {"blocks": {b.name: _block_noise(b, k, True)
                       for b, k in zip(model.blocks, keys[3:])},
            "sig_u": _uniform(keys[1]),
            "gamma_u": jax.random.uniform(keys[0], (p,)),
            **_smoother_normals(keys[2], model.state_dim, q, model.t_len)}


def _flip_noise(key, p, n_flips):
    """The permutation and flip uniforms of the reference's
    draw_indicators_swept(key, ...) (regression_sweep.py:250, :288)."""
    _k_jump, k_perm, k_scan = jax.random.split(key, 3)
    perm = jax.random.permutation(k_perm, p)
    u = jax.vmap(_uniform)(jax.random.split(k_scan, n_flips))
    return perm, jnp.concatenate([u, jnp.full((p - n_flips,), 0.5, F64)])


def _sigsq_u(key, df):
    """The reference's scaled-inverse-chi-square draw from ``key`` as its
    CDF level: the uniform the port's inverse-CDF draw takes."""
    a = 0.5 * df
    return jax.scipy.special.gammainc(a, jax.random.gamma(key, a, (), F64))


def _slice_uniforms(k_asis, n_keys):
    """The uniforms of ``n_keys`` ASIS slice steps: step j draws from
    fold_in(k_asis, j), split into (height, offset, unused, shrink)."""
    gks = jax.vmap(lambda j: jax.random.fold_in(k_asis, j))(
        jnp.arange(n_keys))
    parts = jax.vmap(lambda g: jax.random.split(g, 4))(gks)
    shrink = jax.vmap(lambda k: jax.vmap(_uniform)(
        jax.random.split(k, ASIS_SHRINK)))(parts[:, 3])
    return (jax.vmap(lambda k: _uniform(k, TINY))(parts[:, 0]),
            jax.vmap(_uniform)(parts[:, 1]), shrink)


def _asis_noise(key, n_groups, passes=1):
    """{h_u, u_u, shrink_u} of ``passes`` ASIS passes of a sweep: pass i
    draws from fold_in(key, 17 + i)."""
    per = [_slice_uniforms(jax.random.fold_in(key, 17 + i),
                           ASIS_SLICE_STEPS * n_groups)
           for i in range(passes)]
    rounds = (passes, ASIS_SLICE_STEPS, n_groups)
    out = {}
    for j, name in enumerate(("h_u", "u_u", "shrink_u")):
        stacked = jnp.stack([u[j] for u in per])
        out[name] = stacked.reshape(*rounds, *stacked.shape[2:])
    return out


def _sweep_noise(model, key):
    """The numbers one reference sweep with a regression draws from
    ``key``: the 3-way split (state, observation, blocks); the observation
    key's 3-way split (indicators, sigma^2, beta); fold_in(key, 17 + pass)
    for ASIS."""
    k_state, k_obs, k_blocks = jax.random.split(key, 3)
    k1, k2, k3 = jax.random.split(k_obs, 3)
    q = sum(b.err_dim for b in model.blocks)
    p = model.predictors.shape[1]
    n_groups = sum(len(b.asis_groups()) for b in model.blocks)
    n_flips = p if model.reg_max_flips is None else model.reg_max_flips
    perm, flip_u = _flip_noise(k1, p, n_flips)
    df = model.t_len + float(model.reg_prior.sigma_df)
    bkeys = jax.random.split(k_blocks, len(model.blocks))
    noise = {"reg": {"perm": perm, "flip_u": flip_u,
                     "sigsq_u": _sigsq_u(k2, df),
                     "beta_z": jax.random.normal(k3, (p,), F64)},
             "blocks": {b.name: _block_noise(b, k, False)
                        for b, k in zip(model.blocks, bkeys)},
             **_smoother_normals(k_state, model.state_dim, q, model.t_len)}
    for name, u in _asis_noise(key, n_groups, model.asis_passes).items():
        noise[f"asis_{name}"] = u
    return noise


def _port_noise(fn, keys):
    tree = _numpy_tree(jax.jit(jax.vmap(fn))(keys))
    return state_from_numpy(tree, device="cpu")


# -- Seasonal ----------------------------------------------------------------


@pytest.mark.parametrize("nseasons", [2, 4, 7])
def test_seasonal_matches_reference(nseasons):
    x, y = _reg_data(nseasons=nseasons)
    jb = JaxSeasonal.default(jnp.asarray(y), nseasons=nseasons)
    b = Seasonal.default(torch.tensor(y), nseasons=nseasons)
    assert (b.name, b.dim, b.err_dim) == (jb.name, jb.dim, jb.err_dim)
    assert b.initial_sd == pytest.approx(float(jb.initial_sd), rel=1e-14)
    assert b.sigma_prior.sigma_guess == pytest.approx(
        float(jb.sigma_prior.sigma_guess), rel=1e-14)
    var = np.array([0.3, 0.02])
    t_mat, r_mat, q_mat = b.build({"sigma_seasonal_sq": torch.tensor(var)})
    jt, jr, _jq = jb.build({"sigma_seasonal_sq": jnp.asarray(var[0])})
    for c in range(2):
        np.testing.assert_array_equal(t_mat[c].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(r_mat[c].numpy(), np.asarray(jr))
        assert float(q_mat[c, 0, 0]) == var[c]
    np.testing.assert_array_equal(
        b.z("cpu", torch.float64).numpy(), np.asarray(jb.z()))
    a0, p0 = b.init_dist("cpu", torch.float64)
    ja0, jp0 = jb.init_dist()
    _close(a0, ja0, RTOL)
    _close(p0, jp0, RTOL)
    # init_params and draw_params from the reference's keys
    keys = jax.random.split(jax.random.key(5), 3)
    ref_init = jax.vmap(jb.init_params)(keys)
    init = b.init_params({"seasonal_u": torch.tensor(np.asarray(
        jax.vmap(_uniform)(keys)))})
    _close(init["sigma_seasonal_sq"], ref_init["sigma_seasonal_sq"], RTOL)
    rng = np.random.default_rng(3)
    paths = rng.normal(size=(3, 40, nseasons - 1)).cumsum(1)
    ref = jax.vmap(lambda k, a: jb.draw_params(k, None, a))(
        keys, jnp.asarray(paths))
    got = b.draw_params({"seasonal_u": torch.tensor(np.asarray(jax.vmap(
        lambda k: _uniform(k, TINY))(keys)))}, None, torch.tensor(paths))
    _close(got["sigma_seasonal_sq"], ref["sigma_seasonal_sq"], SWEEP_RTOL)
    assert b.asis_groups()[0][0] == jb.asis_groups()[0][0]


# -- one sweep ---------------------------------------------------------------


SWEEP_KEYS = jax.random.split(jax.random.key(13), CHAINS)


@pytest.fixture(scope="module", params=[4, 7])
def reference_sweep(request):
    """A reference model with a regression (d = 5 or 8, p = 5), its
    chains' initial states and the states after one sweep; compiling the
    reference's programs is the costly part, so the tests share them."""
    jmodel = _jax_model(nseasons=request.param)
    keys = jax.random.split(jax.random.key(12), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    swept = jax.jit(jax.vmap(jmodel.kernel()))(SWEEP_KEYS, state0)
    return jmodel, keys, state0, swept


def test_init_state_matches_reference(reference_sweep):
    jmodel, keys, ref, _swept = reference_sweep
    model = model_from_jax(jmodel, device="cpu")
    assert model.state_dim in (5, 8) and model.obs_prior is None
    noise = _port_noise(lambda k: _init_noise(jmodel, k), keys)
    assert set(noise) == set(model.init_noise_spec())
    state = model.init_state(noise)
    assert state["gamma"].dtype == torch.bool
    _assert_states_close(state, ref, RTOL)


def test_sweep_matches_reference(reference_sweep):
    """One whole Gibbs sweep: the regression's indicators, variance and
    coefficients on each chain's y - Z alpha, the block variances, the
    smoother on y - X beta and the ASIS redraw (at d = 8 through the
    sequential D-path)."""
    jmodel, _keys, state0, ref = reference_sweep
    model = model_from_jax(jmodel, device="cpu")
    noise = _port_noise(lambda k: _sweep_noise(jmodel, k), SWEEP_KEYS)
    spec = model.noise_spec()
    assert set(noise) == set(spec) and set(noise["reg"]) == set(spec["reg"])
    kern = model.kernel()
    out = kern(noise, state_from_numpy(_numpy_tree(state0), device="cpu"))
    kern.finish()
    _assert_states_close(out, ref, SWEEP_RTOL)
    # the sweep moved the regression and every variance
    assert not np.allclose(out["beta"].numpy(), np.asarray(state0["beta"]))
    for name, params in out["blocks"].items():
        for pname, v in params.items():
            assert not np.allclose(v.numpy(), np.asarray(
                state0["blocks"][name][pname]))


def test_contributions_loglik_and_prediction_errors_match_reference(
        reference_sweep):
    jmodel, _keys, _state0, ref = reference_sweep
    model = model_from_jax(jmodel, device="cpu")
    state = state_from_numpy(_numpy_tree(ref), device="cpu")
    want = jax.vmap(jmodel.state_contributions)(ref)
    got = model.state_contributions(state)
    assert set(got) == set(want) == {"trend", jmodel.blocks[1].name,
                                     "regression"}
    for k in want:
        _close(got[k], want[k], RTOL, 1e-12, msg=k)
    _close(model.log_lik(state), jax.vmap(jmodel.log_lik)(ref), RTOL)
    for standardize in (True, False):
        _close(pbsts.one_step_prediction_errors(model, state, standardize),
               jbsts.one_step_prediction_errors(jmodel, ref, standardize),
               RTOL, 1e-12)


def test_predict_matches_reference(reference_sweep):
    """The forecast of each draw from the reference's own normals."""
    jmodel, _keys, _state0, ref = reference_sweep
    model = model_from_jax(jmodel, device="cpu")
    horizon = 9
    keys = jax.random.split(jax.random.key(21), CHAINS)
    want = jax.vmap(lambda k, s: jmodel.predict(k, s, horizon))(keys, ref)
    q = sum(b.err_dim for b in jmodel.blocks)

    def normals(key):
        parts = jax.vmap(jax.random.split)(jax.random.split(key, horizon))
        return {"eta": jax.vmap(lambda k: jax.random.normal(
                    k, (q,), F64))(parts[:, 0]),
                "eps": jax.vmap(lambda k: jax.random.normal(
                    k, (), F64))(parts[:, 1])}

    noise = _port_noise(normals, keys)
    assert set(noise) == set(model.predict_noise_spec(horizon))
    got = model.predict(noise, state_from_numpy(_numpy_tree(ref),
                                                device="cpu"), horizon)
    assert got.shape == (CHAINS, horizon)
    _close(got, want, RTOL, 1e-12)
    # a future_z row replaces a block's z, as the reference's
    zero = {"trend": np.zeros((horizon, 2))}
    want = jax.vmap(lambda k, s: jmodel.predict(
        k, s, horizon, future_z={"trend": jnp.asarray(zero["trend"])}))(
        keys, ref)
    _close(model.predict(noise, state_from_numpy(_numpy_tree(ref),
                                                 device="cpu"), horizon,
                         future_z=zero), want, RTOL, 1e-12)


def test_asis_redraw_at_d8_matches_reference():
    """The ASIS redraw of a d = 8 state (trend + 7 seasons), three groups,
    its D-paths through the sequential recurrence (kalman_kernel.dpath's
    plain loop on the CPU), against the reference's."""
    jmodel = _jax_model(nseasons=7)
    model = model_from_jax(jmodel, device="cpu")
    rng = np.random.default_rng(31)
    c, t_len, d = CHAINS, jmodel.t_len, jmodel.state_dim
    assert d == 8
    alpha = rng.normal(size=(c, t_len, d)).cumsum(1) * 0.3
    beta = rng.normal(size=(c, P_SMALL))
    var = {"trend": {"sigma_level_sq": rng.uniform(0.05, 0.2, c),
                     "sigma_slope_sq": rng.uniform(1e-4, 1e-3, c)},
           "seasonal_7": {"sigma_seasonal_sq": rng.uniform(0.01, 0.1, c)}}
    state = {"blocks": var, "sigsq_obs": rng.uniform(0.2, 0.4, c),
             "alpha": alpha, "beta": beta,
             "gamma": np.ones((c, P_SMALL), bool)}
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    keys = jax.random.split(jax.random.key(33), c)

    def ref_one(k, st):
        y_adj = jmodel.y - jmodel.predictors @ st["beta"]
        return jbsts.asis_redraw(k, jmodel.blocks, jmodel.ssm_params(st),
                                 st, y_adj, st["sigsq_obs"])

    want = jax.jit(jax.vmap(ref_one))(keys, jstate)
    noise = _port_noise(lambda k: dict(zip(
        ("h_u", "u_u", "shrink_u"), _slice_uniforms(k, ASIS_SLICE_STEPS * 3))),
        keys)
    noise = {k: v.reshape(CHAINS, ASIS_SLICE_STEPS, 3, *v.shape[2:])
             for k, v in noise.items()}
    pstate = state_from_numpy(state, device="cpu")
    before = dict(kalman_kernel.LAUNCHES)
    got = pbsts.asis_redraw(noise,
                            model.blocks, model.ssm_params(pstate), pstate,
                            model.adjusted_series(pstate),
                            pstate["sigsq_obs"])
    assert kalman_kernel.LAUNCHES == before  # no kernel ran on the CPU
    want = _numpy_tree(want)
    _close(got["alpha"], want["alpha"], RTOL, RTOL)
    for name, params in want["blocks"].items():
        for pname, v in params.items():
            _close(got["blocks"][name][pname], v, RTOL, msg=pname)


@pytest.mark.parametrize("d,groups", [(1, 1), (2, 2), (8, 3), (13, 1)])
def test_dpath_plain_loop_matches_affine_scan(d, groups):
    """K3's plain version, the sequential recurrence, against the parallel
    affine scan over the same elements."""
    rng = np.random.default_rng(d)
    c, t_len = 3, 45
    t_mat = torch.tensor(rng.normal(size=(c, d, d)) / np.sqrt(d))
    w = torch.tensor(rng.normal(size=(c, groups, t_len - 1, d)))
    got = kalman_kernel.dpath(t_mat, w)
    assert got.shape == (c, groups, t_len, d)
    assert bool((got[:, :, 0] == 0).all())
    a = t_mat[:, None, None].expand(c, groups, t_len - 1, d, d)
    want = parallel_kalman.affine_scan(a.reshape(-1, t_len - 1, d, d),
                                       w.reshape(-1, t_len - 1, d))
    _close(got[:, :, 1:].reshape(-1, t_len - 1, d), want, 1e-9, 1e-9)
    torch.testing.assert_close(got, kalman.dpath(t_mat, w), rtol=0, atol=0)


# -- per-chain regression statistics ------------------------------------------


def test_per_chain_statistics_match_reference_under_vmap():
    """RegSuf with X'y [C, p] and y'y [C] beside a shared X'X through the
    SWEEP indicator draw, sigma^2 and beta, against the reference's
    functions vmapped over the chains' statistics."""
    rng = np.random.default_rng(41)
    n, p, c = 80, 7, 6
    x = rng.normal(size=(n, p))
    ys = x[:, :2] @ np.array([1.5, -1.0]) + rng.normal(size=(c, n))
    jx = jnp.asarray(x)
    jprior = JaxPrior.from_data(jx, jnp.asarray(ys[0]),
                                expected_model_size=2.0)
    jsufs = jax.vmap(lambda y: jreg.RegSuf.from_data(jx, y))(
        jnp.asarray(ys))
    prior = spike_slab_prior_from_numpy(jprior, device="cpu")
    suf = reg_suf_from_numpy(
        jreg.RegSuf(xtx=jsufs.xtx[0], xty=jsufs.xty, yty=jsufs.yty,
                    n=jsufs.n[0]), device="cpu")
    assert suf.xty.shape == (c, p) and suf.yty.shape == (c,)
    masks = rng.uniform(size=(c, p)) < 0.5
    keys = jax.random.split(jax.random.key(42), c)
    one_suf = jax.tree_util.tree_map(lambda a: a, jsufs)
    ref_mask = jax.jit(jax.vmap(lambda k, s, m: jrs.draw_indicators_swept(
        k, s, jprior, m)))(keys, one_suf, jnp.asarray(masks))
    perm, flip_u = zip(*(_flip_noise(k, p, p) for k in keys))
    noise = {"perm": torch.tensor(np.stack(perm)),
             "flip_u": torch.tensor(np.stack(flip_u))}
    got = rs.draw_indicators_swept(noise, suf, prior, torch.tensor(masks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_mask))
    # the per-chain S0 is each chain's own
    s0 = rs._augmented(suf, prior)
    for i in range(c):
        _close(s0[i], jrs._augmented(
            jax.tree_util.tree_map(lambda a, i=i: a[i], jsufs), jprior),
            RTOL)
    ref_sigsq = jax.vmap(lambda k, s, m: jreg.draw_sigsq(
        k, s, jprior, m))(keys, one_suf, ref_mask)
    df = float(n + jprior.sigma_df)
    u = torch.tensor(np.asarray(jax.vmap(lambda k: _sigsq_u(k, df))(keys)))
    sigsq = reg.draw_sigsq(u, suf, prior, got)
    _close(sigsq, ref_sigsq, SWEEP_RTOL)
    ref_beta = jax.vmap(lambda k, s, m, v: jreg.draw_beta(
        k, s, jprior, m, v))(keys, one_suf, ref_mask, ref_sigsq)
    z = torch.tensor(np.asarray(jax.vmap(
        lambda k: jax.random.normal(k, (p,), F64))(keys)))
    _close(reg.draw_beta(z, suf, prior, got, torch.tensor(np.asarray(
        ref_sigsq))), ref_beta, RTOL, 1e-12)


# -- the front end -----------------------------------------------------------


# sweeps of the front-end tests below: the reference's tests run 150 + 300,
# which the plain versions on the CPU take ~50 s for; these runs are short
# enough for tier 1 and their assertions hold with room at this length
FIT_BURN, FIT_NITER = 40, 60


def test_bsts_model_builder_on_the_cpu():
    """The reference's test_api.py::test_bsts_model_builder through the
    port's BstsModel on the CPU, with its assertions (FIT_BURN + FIT_NITER
    sweeps)."""
    k1, k2 = jax.random.split(jax.random.key(0))
    t_len = 200
    trend = jnp.cumsum(0.05 * jax.random.normal(k1, (t_len,)))
    season = jnp.tile(jnp.asarray([2.0, -1.0, 0.5, -1.5]), t_len // 4)
    y = np.asarray(trend + season + 0.3 * jax.random.normal(k2, (t_len,)))
    model = BstsModel().add_local_linear_trend().add_seasonal(nseasons=4)
    model.fit(y, niter=FIT_NITER, num_chains=2, burn=FIT_BURN, device="cpu")
    s = model.summary()
    assert "observation_sd" in s and "coefficients" not in s
    assert s["observation_sd"]["mean"] < 1.0
    preds = model.predict(horizon=8, max_draws=50)
    assert preds.shape == (50, 8)
    assert torch.equal(preds, model.predict(horizon=8, max_draws=50))
    assert bool(torch.isfinite(preds).all())
    contrib = model.state_contribution_draws()
    assert "seasonal_4" in contrib
    assert contrib["trend"].shape[-1] == t_len
    errs = model.prediction_errors()["in.sample"]
    assert errs.shape == (50, t_len) and bool(torch.isfinite(errs).all())
    # a cutpoint refits to y[:150] and filters through the holdout
    held = model.prediction_errors(cutpoints=[150], max_draws=8)
    assert set(held) == {"in.sample", "150"}
    assert held["150"].shape == (8, t_len)
    assert bool(torch.isfinite(held["150"]).all())
    with pytest.raises(ValueError, match="regression"):
        model.coefficients()


def test_bsts_model_with_regression_on_the_cpu():
    """The reference's test_api.py::test_bsts_model_with_regression through
    the port's BstsModel on the CPU, with its assertions (FIT_BURN +
    FIT_NITER sweeps)."""
    k1, k2, k3 = jax.random.split(jax.random.key(0), 3)
    t_len = 250
    x = jax.random.normal(k1, (t_len, 3))
    trend = jnp.cumsum(0.05 * jax.random.normal(k2, (t_len,)))
    y = trend + x @ jnp.asarray([2.0, 0.0, 0.0]) + 0.4 * jax.random.normal(
        k3, (t_len,))
    x, y = np.asarray(x), np.asarray(y)
    model = BstsModel().add_local_level()
    model.fit(y, predictors=x, expected_model_size=1.0, niter=FIT_NITER,
              num_chains=2, burn=FIT_BURN, device="cpu")
    coefs = model.coefficients()
    assert coefs[0]["inclusion_prob"] > 0.9, coefs
    assert abs(coefs[0]["mean"] - 2.0) < 0.3
    preds = model.predict(horizon=5, future_predictors=x[:5], max_draws=20)
    assert preds.shape == (20, 5)
    assert model.draws["gamma"].dtype == torch.bool
    assert "coefficients" in model.summary()
    contrib = model.state_contribution_draws(burn=FIT_NITER // 2)
    assert contrib["regression"].shape == (FIT_NITER, t_len)


def test_regression_needs_its_prior_and_refuses_the_marginal_move():
    """A regression needs its prior and X [T, p]; with it the TIM move
    builds its proposal over the state variances alone (the observation
    variance is the regression's), and the marginal moves that are not
    ported (grid here) raise naming ROADMAP.md."""
    x, y = (torch.tensor(a) for a in _reg_data())
    blocks = [Seasonal(nseasons=4, sigma_prior=SdPrior(0.1))]
    with pytest.raises(ValueError, match="reg_prior"):
        pbsts.Bsts(y=y, blocks=blocks, predictors=x)
    prior = reg.SpikeSlabPrior.from_data(x, y)
    with pytest.raises(ValueError, match="predictors must be"):
        pbsts.Bsts(y=y, blocks=blocks, predictors=x[:-1], reg_prior=prior)
    model = pbsts.Bsts(y=y, blocks=blocks, predictors=x, reg_prior=prior,
                       marginal_sigma_slice=True)
    mode, chol = model._tim_prop
    assert mode.shape == (1,) and chol.shape == (1, 1)
    assert model._sigma_groups() == [((blocks[0].name, "sigma_seasonal_sq"),
                                      blocks[0].sigma_prior)]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pbsts.Bsts(y=y, blocks=blocks, predictors=x, reg_prior=prior,
                   marginal_sigma_slice=True, marginal_move="grid")




def reference(chains=REG_CHAINS, burn=500, draws=2000, seed=2026,
              take=200):
    """The JAX reference's bsts_reg run on the committed data, x64 off:
    posterior medians of the variances and beta[:4], inclusion
    probabilities, the monitor's ESS per draw and R-hat, and the forecast's
    medians and sds at each of the 30 steps (``take`` thinned draws)."""
    from boom_tpu.inference import run_mcmc
    from boom_tpu_torch import data
    from boom_tpu_torch.inference import diagnostics

    with jax.enable_x64(False):
        x_all, y_np = data.bsts_reg_xy()
        y = jnp.asarray(y_np)
        x = jnp.asarray(x_all[:REG_T])
        blocks = [JaxLocalLinearTrend.default(y),
                  JaxSeasonal.default(y, nseasons=7)]
        prior = JaxPrior.from_data(x, y, expected_model_size=1.0,
                                   prior_information_weight=1.0)
        jmodel = JaxBsts(y=y, blocks=blocks, predictors=x, reg_prior=prior,
                         chains_hint=chains)

        def extract(s):
            tr, se = s["blocks"]["trend"], s["blocks"]["seasonal_7"]
            return {"sigsq_obs": s["sigsq_obs"],
                    "sigma_level_sq": tr["sigma_level_sq"],
                    "sigma_slope_sq": tr["sigma_slope_sq"],
                    "sigma_seasonal_sq": se["sigma_seasonal_sq"],
                    "beta": s["beta"], "gamma": s["gamma"],
                    "alpha_last": s["alpha"][-1]}

        fit = jax.jit(lambda k: run_mcmc(
            k, jmodel.kernel(), jmodel.init_state, draws, num_chains=chains,
            burn=burn, jit=False, extract=extract).draws)
        d = fit(jax.random.key(seed))
        flat = jax.tree_util.tree_map(
            lambda a: a.reshape((-1,) + a.shape[2:]), d)
        total = chains * draws
        idx = np.linspace(0, total - 1, take).astype(np.int64)
        sub = jax.tree_util.tree_map(lambda a: a[idx], flat)
        x_fut = jnp.asarray(x_all[REG_T:])

        def one(k, st):
            state = {"blocks": {"trend": {
                "sigma_level_sq": st["sigma_level_sq"],
                "sigma_slope_sq": st["sigma_slope_sq"]},
                "seasonal_7": {"sigma_seasonal_sq": st["sigma_seasonal_sq"]}},
                "sigsq_obs": st["sigsq_obs"],
                "alpha": st["alpha_last"][None]}
            return (jmodel.predict(k, state, REG_HORIZON)
                    + x_fut @ st["beta"])

        keys = jax.random.split(jax.random.key(seed), take)
        fcast = np.asarray(jax.jit(jax.vmap(one))(keys, sub))
    d = {k: np.asarray(v) for k, v in d.items()}
    names = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq",
             "sigma_seasonal_sq")
    mon = np.concatenate([np.stack([d[k] for k in names], -1),
                          d["beta"][..., :4]], -1).astype(np.float64)
    ess = diagnostics.effective_sample_size(torch.tensor(mon)).numpy()
    rhat = diagnostics.potential_scale_reduction(torch.tensor(mon)).numpy()
    medians = {k: float(np.median(d[k])) for k in names}
    medians.update({f"beta[{j}]": float(np.median(d["beta"][..., j]))
                    for j in range(4)})
    return {"medians": medians,
            "inclusion": d["gamma"].reshape(-1, x.shape[1]).mean(0).tolist(),
            "ess_per_draw": (ess / total).tolist(),
            "min_ess_per_draw": float(ess.min() / total),
            "rhat": rhat.tolist(),
            "forecast_median": np.median(fcast, 0).tolist(),
            "forecast_sd": fcast.std(0).tolist()}


if __name__ == "__main__" and sys.argv[1:2] == ["bench"]:
    import json

    print(json.dumps(reference(*map(int, sys.argv[2:]))))
