"""The port's time-varying state blocks (``DynamicRegression``,
``RandomWalkHoliday``, ``StudentLocalLinearTrend``) against the JAX
reference's (boom_tpu/statespace/state_models.py:677-925), float64, CPU.

Each block's defaults, z, z_seq, q_scale_seq, build, init_dist,
init_params and draw_params take the same inputs on both sides, the
port's uniforms rebuilt from the reference's keys: 1e-10 where both
compute the same operations, 1e-9 through the variances' inverse CDF
(test_torch_bsts_reg.py's ``SWEEP_RTOL``). The Student trend's latent
weights are a gamma draw, which the reference makes with
``jax.random.gamma`` and the port by inverse CDF: they are held in
distribution (KS, moments), and everything downstream of given weights
(the variances, the slice steps of nu) to rounding. Then the reference's
own recovery checks of these blocks (tests/test_state_models_tv.py) and
its forecast with future predictors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from boom_tpu.statespace import state_models as jsm
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu_torch import rng as prng
from boom_tpu_torch.convert import model_from_jax
from boom_tpu_torch.inference.driver import run_mcmc, tree_map
from boom_tpu_torch.statespace import state_models as sm
from boom_tpu_torch.statespace.bsts import Bsts
from boom_tpu_torch.statespace.state_models import NU_SHRINK

torch.set_num_threads(1)

RTOL = 1e-10
SWEEP_RTOL = 1e-9
F64 = jnp.float64
TINY = np.finfo(np.float64).tiny
C, T_LEN = 3, 50


def _close(got, want, rtol=RTOL, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def _uniform(key, minval=None, shape=()):
    if minval is None:
        return jax.random.uniform(key, shape, F64)
    return jax.random.uniform(key, shape, F64, minval=minval)


def _series(seed=0, t_len=T_LEN):
    rng = np.random.default_rng(seed)
    return rng.normal(size=t_len).cumsum() + 3.0


def _active(t_len=T_LEN, window=3):
    act = -np.ones(t_len, np.int64)
    for s in range(4, t_len - window, 13):
        act[s:s + window] = np.arange(window)
    return act


def _paths(seed, dim, t_len=T_LEN):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(C, t_len, dim)).cumsum(1) * 0.3


def _check_common(b, jb, state_var, var_value):
    """Defaults, z, build and init_dist against the reference's."""
    assert (b.name, b.dim, b.err_dim) == (jb.name, jb.dim, jb.err_dim)
    assert b.initial_sd == pytest.approx(float(jb.initial_sd), rel=1e-14)
    np.testing.assert_array_equal(b.z("cpu", torch.float64).numpy(),
                                  np.asarray(jb.z()))
    t_mat, r_mat, q_mat = b.build({state_var: torch.tensor(var_value)})
    for c in range(C):
        jt, jr, jq = jb.build({state_var: jnp.asarray(var_value[c])})
        np.testing.assert_array_equal(t_mat[c].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(r_mat[c].numpy(), np.asarray(jr))
        _close(q_mat[c], jq, 0.0)
    a0, p0 = b.init_dist("cpu", torch.float64)
    ja0, jp0 = jb.init_dist()
    _close(a0, ja0)
    _close(p0, jp0)


def test_dynamic_regression_matches_reference():
    y = _series(1)
    x = np.random.default_rng(2).normal(size=(T_LEN, 2)) * [1.0, 3.0]
    jb = jsm.DynamicRegression.default(jnp.asarray(y), jnp.asarray(x))
    b = sm.DynamicRegression.default(torch.tensor(y), x)
    assert b.sigma_prior.sigma_guess == pytest.approx(
        float(jb.sigma_prior.sigma_guess), rel=1e-14)
    assert b.sigma_prior.upper_limit == pytest.approx(
        float(jb.sigma_prior.upper_limit), rel=1e-14)
    var = np.array([[0.3, 0.02], [0.1, 0.2], [0.05, 0.5]])
    _check_common(b, jb, "sigma_dynreg_sq", var)
    np.testing.assert_array_equal(b.z_seq("cpu", torch.float64).numpy(),
                                  np.asarray(jb.z_seq(T_LEN)))
    keys = jax.random.split(jax.random.key(5), C)
    ref = jax.vmap(jb.init_params)(keys)
    got = b.init_params({"dynreg_u": torch.tensor(np.asarray(jax.vmap(
        lambda k: _uniform(k, None, (2,)))(keys)))})
    _close(got["sigma_dynreg_sq"], ref["sigma_dynreg_sq"])
    paths = _paths(3, 2)
    ref = jax.vmap(lambda k, a: jb.draw_params(k, None, a))(
        keys, jnp.asarray(paths))
    u = jax.vmap(lambda k: jax.vmap(lambda kk: _uniform(kk, TINY))(
        jax.random.split(k, 2)))(keys)
    got = b.draw_params({"dynreg_u": torch.tensor(np.asarray(u))}, None,
                        torch.tensor(paths))
    _close(got["sigma_dynreg_sq"], ref["sigma_dynreg_sq"], SWEEP_RTOL)
    assert b.asis_groups() == jb.asis_groups() == []
    assert b.sliced(20).predictors.shape == (20, 2)


def test_random_walk_holiday_matches_reference():
    y = _series(4)
    act = _active()
    jb = jsm.RandomWalkHoliday.default(jnp.asarray(y), act, 3)
    b = sm.RandomWalkHoliday.default(torch.tensor(y), act, 3)
    assert b.sigma_prior.sigma_guess == pytest.approx(
        float(jb.sigma_prior.sigma_guess), rel=1e-14)
    var = np.array([0.3, 0.02, 1.5])
    _check_common(b, jb, "sigma_holiday_sq", var)
    np.testing.assert_array_equal(b.z_seq("cpu", torch.float64).numpy(),
                                  np.asarray(jb.z_seq(T_LEN)))
    params = {"sigma_holiday_sq": torch.tensor(var)}
    np.testing.assert_array_equal(
        b.q_scale_seq(params).numpy(),
        np.asarray(jb.q_scale_seq({"sigma_holiday_sq": 1.0}, T_LEN)))
    keys = jax.random.split(jax.random.key(6), C)
    ref = jax.vmap(jb.init_params)(keys)
    got = b.init_params({"holiday_u": torch.tensor(np.asarray(jax.vmap(
        _uniform)(keys)))})
    _close(got["sigma_holiday_sq"], ref["sigma_holiday_sq"])
    paths = _paths(7, 3)
    ref = jax.vmap(lambda k, a: jb.draw_params(k, None, a))(
        keys, jnp.asarray(paths))
    got = b.draw_params({"holiday_u": torch.tensor(np.asarray(jax.vmap(
        lambda k: _uniform(k, TINY))(keys)))}, None, torch.tensor(paths))
    _close(got["sigma_holiday_sq"], ref["sigma_holiday_sq"], SWEEP_RTOL)
    assert b.sliced(20).active.shape == (20,)


def _student(y):
    jb = jsm.StudentLocalLinearTrend.default(jnp.asarray(y))
    b = sm.StudentLocalLinearTrend.default(torch.tensor(y))
    return jb, b


def _student_state(seed):
    rng = np.random.default_rng(seed)
    return {"sigma_level_sq": rng.uniform(0.05, 0.3, C),
            "sigma_slope_sq": rng.uniform(1e-3, 1e-2, C),
            "nu_level": rng.uniform(2.0, 30.0, C),
            "nu_slope": rng.uniform(2.0, 30.0, C),
            "w_level": rng.gamma(3.0, 1.0 / 3.0, (C, T_LEN - 1)),
            "w_slope": rng.gamma(3.0, 1.0 / 3.0, (C, T_LEN - 1))}


def test_student_trend_system_matches_reference():
    y = _series(8)
    jb, b = _student(y)
    assert b.t_len == jb.t_len == T_LEN
    assert b.initial_level_mean == pytest.approx(float(
        jb.initial_level_mean), rel=1e-15)
    np.testing.assert_array_equal(b.z("cpu", torch.float64).numpy(),
                                  np.asarray(jb.z()))
    st = _student_state(9)
    params = {k: torch.tensor(v) for k, v in st.items()}
    t_mat, r_mat, q_mat = b.build(params)
    q_scale = b.q_scale_seq(params)
    assert q_scale.shape == (C, T_LEN, 2)
    for c in range(C):
        one = {k: jnp.asarray(v[c]) for k, v in st.items()}
        jt, jr, jq = jb.build(one)
        np.testing.assert_array_equal(t_mat[c].numpy(), np.asarray(jt))
        np.testing.assert_array_equal(r_mat[c].numpy(), np.asarray(jr))
        _close(q_mat[c], jq, 0.0)
        _close(q_scale[c], jb.q_scale_seq(one, T_LEN))
    a0, p0 = b.init_dist("cpu", torch.float64)
    _close(a0, jb.init_dist()[0])
    _close(p0, jb.init_dist()[1])
    keys = jax.random.split(jax.random.key(10), C)
    ref = jax.vmap(jb.init_params)(keys)
    u = jax.vmap(lambda k: [_uniform(kk) for kk in jax.random.split(k)])(keys)
    got = b.init_params({"level_u": torch.tensor(np.asarray(u[0])),
                         "slope_u": torch.tensor(np.asarray(u[1]))})
    for k, v in ref.items():
        _close(got[k], v, msg=k)
    ext = b.extend_params(params, T_LEN + 7)
    assert ext["w_level"].shape == (C, T_LEN + 6)
    assert bool((ext["w_slope"][:, T_LEN - 1:] == 1).all())


def _slice_noise(key):
    parts = jax.random.split(key, 4)
    return (_uniform(parts[0], TINY), _uniform(parts[1]),
            jax.vmap(_uniform)(jax.random.split(parts[3], NU_SHRINK)))


def test_student_trend_draw_given_the_weights_matches_reference():
    """The variances and the slice steps of nu given the reference's own
    weights (its draw_params' key tree: weights ks[0, 1], variances ks[2,
    3], nu ks[4, 5])."""
    y = _series(11)
    jb, b = _student(y)
    st = _student_state(12)
    paths = _paths(13, 2)
    keys = jax.random.split(jax.random.key(14), C)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    ref = jax.vmap(lambda k, p, a: jb.draw_params(k, p, a))(
        keys, jst, jnp.asarray(paths))

    def noise(key):
        ks = jax.random.split(key, 6)
        out = {"level_u": _uniform(ks[2], TINY),
               "slope_u": _uniform(ks[3], TINY)}
        for part, k in (("level", ks[4]), ("slope", ks[5])):
            h_u, u_u, shrink_u = _slice_noise(k)
            out.update({f"nu_{part}_h_u": h_u, f"nu_{part}_u_u": u_u,
                        f"nu_{part}_shrink_u": shrink_u})
        return out

    nz = {k: torch.tensor(np.asarray(v))
          for k, v in jax.vmap(noise)(keys).items()}
    params = {k: torch.tensor(v) for k, v in st.items()}
    path = torch.tensor(paths)
    got = b.draw_given_weights(nz, params, b.innovations(path),
                               torch.tensor(np.asarray(ref["w_level"])),
                               torch.tensor(np.asarray(ref["w_slope"])))
    for k in ("sigma_level_sq", "sigma_slope_sq", "nu_level", "nu_slope"):
        _close(got[k], ref[k], SWEEP_RTOL, msg=k)
    assert set(b.noise_spec()) == set(nz) | {"w_level_u", "w_slope_u"}


def test_student_weights_match_reference_in_distribution():
    """The weights' draw at the same shape, rate and nu: the port's inverse
    CDF at uniforms against jax.random.gamma (KS at 1e-3, mean and variance
    within 3 standard errors), and the inverse CDF at the CDF levels of the
    reference's draws gives its draws back (rtol 1e-6 over 40,000 draws:
    PyTorch's incomplete gamma is ~1e-10 off the reference's in the bulk,
    ~1e-7 in a far tail)."""
    n = 20000
    nu = torch.tensor([4.0, 40.0], dtype=torch.float64)
    sig = torch.tensor([0.2, 0.05], dtype=torch.float64)
    e = torch.tensor([0.3, 0.01], dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(2, n, generator=gen, dtype=torch.float64).clamp_min(TINY)
    got = sm.StudentLocalLinearTrend.impute_weights(
        u, e[:, None].expand(2, n), sig, nu).numpy()
    a = 0.5 * (nu.numpy() + 1.0)
    b = 0.5 * (nu.numpy() + e.numpy() ** 2 / sig.numpy())
    keys = jax.random.split(jax.random.key(15), 2)
    ref = np.stack([np.asarray(jax.random.gamma(k, a[i], (n,), F64)) / b[i]
                    for i, k in enumerate(keys)])
    for i in range(2):
        assert scipy.stats.ks_2samp(got[i], ref[i]).pvalue > 1e-3
        mean, var = a[i] / b[i], a[i] / b[i] ** 2
        assert abs(got[i].mean() - mean) < 3 * np.sqrt(var / n)
        assert abs(got[i].var() - var) < 3 * var * np.sqrt(2.0 / n) * 3
    levels = jax.scipy.special.gammainc(a[:, None], ref * b[:, None])
    back = sm.StudentLocalLinearTrend.impute_weights(
        torch.tensor(np.asarray(levels)), e[:, None].expand(2, n), sig, nu)
    _close(back, ref, 1e-6)
    assert np.median(np.abs(back.numpy() / ref - 1)) < 1e-11


# -- the reference's own block checks (tests/test_state_models_tv.py) ---------


def _run(model, chains, sweeps, burn, seed):
    return run_mcmc(model.kernel(), model.draw_noise,
                    lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                    sweeps - burn, generator=prng.generator(seed, "cpu"),
                    num_chains=chains, burn=burn).draws


def test_dynamic_regression_tracks_coefficient():
    """The smoothed coefficient path follows a sine within RMSE 0.4
    (reference test_dynamic_regression_tracks_coefficient, 4 chains, 250
    sweeps, 100 burnt)."""
    kx, ke = jax.random.split(jax.random.key(0))
    t_len = 250
    x = np.asarray(jax.random.normal(kx, (t_len, 1))) * 2.0
    beta_path = np.sin(np.arange(t_len) / 40.0) * 2.0
    y = torch.tensor(x[:, 0] * beta_path
                     + 0.3 * np.asarray(jax.random.normal(ke, (t_len,))))
    model = Bsts(y=y, blocks=[sm.DynamicRegression.default(y, x)])
    draws = _run(model, 4, 250, 100, 2)
    est = draws["alpha"][..., 0].mean((0, 1)).numpy()
    assert np.sqrt(np.mean((est - beta_path) ** 2)) < 0.4


def test_random_walk_holiday_effect():
    """A +5 bump on one day a year: the holiday's state on an active day
    is 5 within 1 (reference test_random_walk_holiday_effect, 3 years, 2
    chains, 200 sweeps, 80 burnt)."""
    t_len, period = 365 * 3, 365
    days = np.arange(100, t_len, period)
    active = -np.ones(t_len, np.int64)
    active[days] = 0
    y = 0.5 * np.asarray(jax.random.normal(jax.random.key(0), (t_len,)))
    y[days] += 5.0
    y = torch.tensor(y)
    model = Bsts(y=y, blocks=[sm.LocalLevel.default(y),
                              sm.RandomWalkHoliday.default(y, active, 1)])
    draws = _run(model, 2, 200, 80, 3)
    est = float(draws["alpha"][..., int(days[1]), 1].mean())
    assert abs(est - 5.0) < 1.0, est


def test_student_llt_handles_level_outliers():
    """A level jump of 8: its step's weight is below half a typical one and
    the level follows the jump (reference
    test_student_llt_handles_level_outliers, 2 chains, 250 sweeps, 100
    burnt, no ASIS)."""
    k1, k2 = jax.random.split(jax.random.key(0))
    t_len = 200
    level = np.cumsum(0.1 * np.asarray(jax.random.normal(k1, (t_len,))))
    level = level + np.where(np.arange(t_len) >= 100, 8.0, 0.0)
    y = torch.tensor(level + 0.3 * np.asarray(jax.random.normal(k2,
                                                                (t_len,))))
    model = Bsts(y=y, blocks=[sm.StudentLocalLinearTrend.default(y)],
                 asis=False)
    draws = _run(model, 2, 250, 100, 4)
    w = draws["blocks"]["student_trend"]["w_level"]
    assert float(w[..., 99].mean()) < 0.5 * float(w[..., 50].mean())
    lvl = draws["alpha"][..., 0].mean((0, 1)).numpy()
    assert abs(lvl[150] - level[150]) < 1.5


def test_predict_with_dynamic_regression():
    """30 sweeps, then a 10-step forecast with the future predictors
    (reference test_predict_with_dynamic_regression), against the
    reference's forecast of the same state from the same normals."""
    kx, ke = jax.random.split(jax.random.key(0))
    t_len = 120
    x = np.asarray(jax.random.normal(kx, (t_len + 10, 1)))
    y = 1.5 * x[:t_len, 0] + 0.2 * np.asarray(jax.random.normal(ke, (t_len,)))
    jmodel = JaxBsts(y=jnp.asarray(y), blocks=[jsm.DynamicRegression.default(
        jnp.asarray(y), jnp.asarray(x[:t_len]))])
    model = model_from_jax(jmodel, device="cpu")
    state = tree_map(lambda v: v[:, -1], _run(model, 2, 30, 29, 5))
    keys = jax.random.split(jax.random.key(6), 2)
    fz = {"dynamic_regression": x[t_len:]}
    want = jax.vmap(lambda k, s: jmodel.predict(
        k, s, 10, future_z={"dynamic_regression": jnp.asarray(x[t_len:])}))(
        keys, jax.tree_util.tree_map(lambda v: jnp.asarray(v.numpy()),
                                     state))

    def normals(key):
        parts = jax.vmap(jax.random.split)(jax.random.split(key, 10))
        return {"eta": jax.vmap(lambda k: jax.random.normal(
                    k, (1,), F64))(parts[:, 0]),
                "eps": jax.vmap(lambda k: jax.random.normal(
                    k, (), F64))(parts[:, 1])}

    noise = {k: torch.tensor(np.asarray(v))
             for k, v in jax.vmap(normals)(keys).items()}
    ys = model.predict(noise, state, 10, future_z=fz)
    assert ys.shape == (2, 10) and bool(torch.isfinite(ys).all())
    _close(ys, want, RTOL, 1e-12)
