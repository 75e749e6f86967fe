"""The TIM marginal move of the port's bsts with a regression against the
JAX reference (float64, CPU).

- The proposal: mode rtol 1e-6 and Cholesky factor rtol 1e-4, as
  test_torch_tim.py (the two mode searches differentiate different code,
  autograd against jax, and stop at slightly different points); with a
  regression both tailor it at y - X beta_OLS.
- One sweep with the move on the reference's noise and its proposal:
  ``SWEEP_RTOL`` 1e-9 (test_torch_bsts_reg.py: the variance draws inherit
  PyTorch's ~1e-9 relative error of the incomplete gamma).
- ``log_lik``, the one-step errors and the holdout filter on the same
  states: 1e-10 (the same operations in another order at most).

The kernels on this path compiled for the host are held against their plain
versions in test_torch_tim_reg_kernels.py, and the reference's own
statistical checks of the one-step and holdout errors run through the port
in test_torch_holdout.py: three files, so that the three run side by side.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_tim_reg.py \
        bench 1024 300 250 7

recomputes the reference numbers of chip_smoke.py's phase 7: config #5
(local linear trend, 7-season cycle, spike-and-slab regression of p = 20 on
the committed data) with ``marginal_sigma_slice=True,
marginal_move="tim"``, x64 off as the bench runs, 300 burn-in + 250 draws
(phase 7's run length): the posterior medians, split R-hat and ESS per draw
of the four variances and beta[0:4] (1024 chains: ~15 min on 8 CPU cores).
"""

import copy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu.inference.driver import McmcResult as JaxResult
from boom_tpu.models.glm.regression import SpikeSlabPrior as JaxPrior
from boom_tpu.statespace import bsts as jbsts
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu.statespace.state_models import (
    LocalLinearTrend as JaxLocalLinearTrend,
    Seasonal as JaxSeasonal,
)
from boom_tpu_torch import rng as prng
from boom_tpu_torch.convert import model_from_jax, state_from_numpy
from boom_tpu_torch.inference import driver
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace.bsts import Bsts
from boom_tpu_torch.statespace.state_models import LocalLevel

torch.set_num_threads(1)

RTOL = 1e-10
SWEEP_RTOL = 1e-9
CHAINS, T_SMALL, P_SMALL = 8, 60, 3
REG_T = 500
MONITOR = ("sigsq_obs", "sigma_level_sq", "sigma_slope_sq",
           "sigma_seasonal_sq", "beta[0]", "beta[1]", "beta[2]", "beta[3]")


# -- models and the reference's numbers ---------------------------------------


def _tim_model(nseasons):
    """The reference's bsts with a regression of p = 3 and the TIM move:
    a local linear trend and a ``nseasons`` cycle (d = 8 at 7), or the trend
    alone (``nseasons=None``, d = 2); T = 60, float64."""
    from test_torch_bsts_reg import _reg_data

    x, y = (jnp.asarray(a) for a in _reg_data(T_SMALL, P_SMALL, nseasons or 7))
    prior = JaxPrior.from_data(x, y, expected_model_size=2.0,
                               prior_information_weight=1.0)
    blocks = [JaxLocalLinearTrend.default(y)]
    if nseasons:
        blocks.append(JaxSeasonal.default(y, nseasons=nseasons))
    return JaxBsts(y=y, blocks=blocks, predictors=x, reg_prior=prior,
                   parallel_smoother=False, marginal_sigma_slice=True,
                   marginal_move="tim")


def _sweep_keys():
    return jax.random.split(jax.random.key(23), CHAINS)


@pytest.fixture(scope="module", params=[7, None], ids=["d8", "d2"])
def tim_reference(request):
    """The reference model (its TIM proposal built), its chains' initial
    states and the states after one sweep with the move, and the port's
    model (its own proposal built) and noise of that sweep; the tests share
    them, the reference's programs being the costly part."""
    from test_torch_bsts_reg import _numpy_tree, _sweep_noise
    from test_torch_tim import _tim_noise

    jmodel = _tim_model(request.param)
    keys = jax.random.split(jax.random.key(22), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    swept = _numpy_tree(jax.jit(jax.vmap(jmodel.kernel()))(_sweep_keys(),
                                                            state0))
    model = model_from_jax(jmodel, device="cpu")
    n_groups = len(model._sigma_groups())
    noise = state_from_numpy(_numpy_tree(jax.jit(jax.vmap(lambda k: {
        **_sweep_noise(jmodel, k),
        **_tim_noise(k, model.marginal_tim_trials, model.marginal_tim_df,
                     n_groups)}))(_sweep_keys())), device="cpu")
    return jmodel, model, _numpy_tree(state0), swept, noise


def _close(got, want, rtol, atol=0.0, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=msg)


def test_sigma_groups_leave_the_observation_variance_to_the_regression(
        tim_reference):
    """With a regression the move updates the state variances only
    (reference :481-490); each one's direction of (h, R Q R') is exact."""
    jmodel, model, _state0, _swept, _noise = tim_reference
    assert ([path for path, _ in model._sigma_groups()]
            == [path for path, _ in jmodel._sigma_groups()])
    assert all(path[0] != "sigsq_obs" for path, _ in model._sigma_groups())
    dh, dm = model._variance_directions
    g, d = len(model._sigma_groups()), model.state_dim
    assert dh.shape == (g,) and dm.shape == (g, d, d)
    assert bool((dh == 0).all())
    # R E_g R' of a selector R: a one on the diagonal a group, else zeros
    assert bool((dm.sum((1, 2)) == 1.0).all())
    assert bool((dm == dm.transpose(1, 2)).all())


@pytest.mark.parametrize("fault", ["p0", "quadratic"])
def test_variance_directions_refuse_a_system_outside_their_form(
        monkeypatch, fault):
    """The directions hold only where z, T, a0 and P0 do not depend on a
    variance and h and R Q R' are linear in it: a block whose P0 grows with
    its variance, or whose Q is its variance squared, raises, naming it."""
    y = torch.tensor(np.random.default_rng(0).normal(size=30).cumsum())
    dh, dm = Bsts(y=y, blocks=[LocalLevel.default(y)])._variance_directions
    assert dh.tolist() == [0.0, 1.0] and dm[:, 0, 0].tolist() == [1.0, 0.0]
    build = Bsts.ssm_params

    def faulty(self, state):
        p = build(self, state)
        v = state["blocks"]["local_level"]["sigma_level_sq"]
        if fault == "p0":
            return p._replace(p0=p.p0 * (1.0 + v)[:, None, None])
        return p._replace(q_mat=p.q_mat * v[:, None, None])

    monkeypatch.setattr(Bsts, "ssm_params", faulty)
    model = Bsts(y=y, blocks=[LocalLevel.default(y)])
    with pytest.raises(NotImplementedError,
                       match="'sigma_level_sq' of 'local_level'"):
        model._variance_directions


def test_tim_proposal_matches_reference(tim_reference):
    """The proposal tailored at y - X beta_OLS: mode and Cholesky factor
    against the reference's."""
    jmodel, model, _state0, _swept, _noise = tim_reference
    mode, chol = model._tim_prop
    ref_mode, ref_chol = (np.asarray(p) for p in jmodel._tim_prop)
    assert mode.dtype == torch.float64 and mode.shape == ref_mode.shape
    _close(mode, ref_mode, 1e-6)
    _close(chol, ref_chol, 1e-4, 1e-10)


def test_tim_sweep_matches_reference(tim_reference):
    """One sweep (regression, variance draws, smoother, ASIS, TIM) of 8
    chains on the reference's noise and with its proposal: the same
    accept decisions and the same state, to SWEEP_RTOL."""
    from test_torch_bsts_reg import _assert_states_close

    jmodel, model, state0, swept, noise = tim_reference
    model = copy.copy(model)
    object.__setattr__(model, "_tim_prop", tuple(
        torch.tensor(np.asarray(p)) for p in jmodel._tim_prop))
    spec = model.noise_spec()
    assert set(noise) == set(spec)
    state = state_from_numpy(state0, device="cpu")
    kern = model.kernel()
    out = kern(noise, state)
    kern.finish()
    _assert_states_close(out, swept, SWEEP_RTOL)
    # the move accepted in some chains: their variances left the
    # conditional sweep's values
    before = model.kernel()(noise, state, do_marginal=False)
    name, pname = model._sigma_groups()[0][0]
    moved = ~torch.isclose(out["blocks"][name][pname],
                           before["blocks"][name][pname], rtol=1e-12)
    assert bool(moved.any())


def test_log_lik_with_a_regression_matches_reference(tim_reference):
    """[C] marginal loglik on each chain's own y - X beta."""
    jmodel, model, _state0, swept, _noise = tim_reference
    state = state_from_numpy(swept, device="cpu")
    want = jax.vmap(jmodel.log_lik)(
        jax.tree_util.tree_map(jnp.asarray, swept))
    _close(model.log_lik(state), want, RTOL)


def test_one_step_errors_match_reference(tim_reference):
    jmodel, model, _state0, swept, _noise = tim_reference
    state = state_from_numpy(swept, device="cpu")
    jstate = jax.tree_util.tree_map(jnp.asarray, swept)
    for standardize in (True, False):
        _close(pbsts.one_step_prediction_errors(model, state, standardize),
               jbsts.one_step_prediction_errors(jmodel, jstate, standardize),
               RTOL, 1e-12)


def _fixed_runs(monkeypatch, swept, seen):
    """run_mcmc of the reference and of the port replaced by one returning
    ``swept`` as 2 chains x 4 draws (``seen`` records the refit models'
    T): the holdout filter of both on the same states."""
    def port_run(kernel, draw_noise, init, num_draws, *, generator,
                 num_chains=None, burn=0, **kw):
        seen.append(("port", num_draws, num_chains, burn))
        draws = driver.tree_map(lambda a: a.reshape(2, 4, *a.shape[1:]),
                                state_from_numpy(swept, device="cpu"))
        return driver.McmcResult(draws=draws, final_state=None)

    def ref_run(key, kernel, init_state, num_draws, *, num_chains=None,
                burn=0, **kw):
        seen.append(("reference", num_draws, num_chains, burn))
        draws = jax.tree_util.tree_map(
            lambda a: jnp.asarray(a).reshape(2, 4, *a.shape[1:]), swept)
        return JaxResult(draws=draws, final_state=None)

    import boom_tpu.inference.driver as jdriver

    monkeypatch.setattr(driver, "run_mcmc", port_run)
    monkeypatch.setattr(jdriver, "run_mcmc", ref_run)


def _without_the_move(jmodel, model):
    """The models without the marginal move (a refit's training slice
    would build its proposal, which the fixed runs do not use)."""
    return (jbsts.dataclasses.replace(jmodel, marginal_sigma_slice=False),
            model_from_jax(jmodel, device="cpu", marginal_sigma_slice=False))


def test_holdout_filter_matches_reference(monkeypatch, tim_reference):
    """holdout_prediction_errors past a cutpoint: the training slice (y and
    X cut at the cutpoint) and, on the same refit draws, the filter through
    the whole series."""
    jmodel, model, _state0, swept, _noise = tim_reference
    jmodel, model = _without_the_move(jmodel, model)
    cut = 45
    train, jtrain = (pbsts._training_slice(model, cut),
                     jbsts._training_slice(jmodel, cut))
    assert train.t_len == cut and train.predictors.shape == (cut, P_SMALL)
    _close(train.y, jtrain.y, 0.0)
    _close(train.predictors, jtrain.predictors, 0.0)
    seen = []
    _fixed_runs(monkeypatch, swept, seen)
    got = pbsts.holdout_prediction_errors(
        model, prng.generator(0, "cpu"), cut, num_draws=8, num_chains=2,
        burn=3, max_draws=6)
    want = jbsts.holdout_prediction_errors(
        jmodel, jax.random.key(0), cut, num_draws=8, num_chains=2, burn=3,
        max_draws=6)
    assert seen == [("port", 4, 2, 3), ("reference", 4, 2, 3)]
    assert got.shape == (6, T_SMALL)
    _close(got, want, RTOL, 1e-12)


def test_compare_bsts_models_matches_reference(monkeypatch, tim_reference):
    """Cumulative mean |standardized one-step error| of two models, in
    sample and past a cutpoint (on the same refit draws)."""
    jmodel, model, _state0, swept, _noise = tim_reference
    jmodel, model = _without_the_move(jmodel, model)
    jres = JaxResult(draws=jax.tree_util.tree_map(
        lambda a: jnp.asarray(a).reshape(2, 4, *a.shape[1:]), swept),
        final_state=None)
    res = driver.McmcResult(draws=driver.tree_map(
        lambda a: a.reshape(2, 4, *a.shape[1:]),
        state_from_numpy(swept, device="cpu")), final_state=None)
    got = pbsts.compare_bsts_models({"a": (model, res), "b": (model, res)},
                                    max_draws=5)
    want = jbsts.compare_bsts_models({"a": (jmodel, jres),
                                      "b": (jmodel, jres)}, max_draws=5)
    assert set(got) == {"a", "b"} and got["a"].shape == (T_SMALL,)
    for k in want:
        _close(got[k], want[k], RTOL)
    _fixed_runs(monkeypatch, swept, [])
    got = pbsts.compare_bsts_models({"a": (model, res)}, cutpoint=40,
                                    generator=prng.generator(1, "cpu"),
                                    num_draws=8, burn=2, max_draws=6)
    want = jbsts.compare_bsts_models({"a": (jmodel, jres)}, cutpoint=40,
                                     key=jax.random.key(1), num_draws=8,
                                     burn=2, max_draws=6)
    _close(got["a"], want["a"], RTOL)
    with pytest.raises(ValueError, match="generator"):
        pbsts.compare_bsts_models({"a": (model, res)}, cutpoint=40)


def reference(chains=512, burn=300, draws=250, seed=7):
    """The JAX reference's config #5 with the TIM move on the committed
    data, x64 off: medians, split R-hat and ESS per draw of ``MONITOR``."""
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
                         chains_hint=chains, marginal_sigma_slice=True,
                         marginal_move="tim")

        def extract(s):
            tr, se = s["blocks"]["trend"], s["blocks"]["seasonal_7"]
            return {"sigsq_obs": s["sigsq_obs"],
                    "sigma_level_sq": tr["sigma_level_sq"],
                    "sigma_slope_sq": tr["sigma_slope_sq"],
                    "sigma_seasonal_sq": se["sigma_seasonal_sq"],
                    "beta": s["beta"][:4]}

        fit = jax.jit(lambda k: run_mcmc(
            k, jmodel.kernel(), jmodel.init_state, draws, num_chains=chains,
            burn=burn, jit=False, extract=extract).draws)
        d = {k: np.asarray(v) for k, v in fit(jax.random.key(seed)).items()}
    mon = np.concatenate([np.stack([d[k] for k in MONITOR[:4]], -1),
                          d["beta"]], -1).astype(np.float64)
    ess = diagnostics.effective_sample_size(torch.tensor(mon)).numpy()
    rhat = diagnostics.potential_scale_reduction(torch.tensor(mon)).numpy()
    flat = mon.reshape(-1, len(MONITOR))
    return {"medians": dict(zip(MONITOR, np.median(flat, 0).tolist())),
            "rhat": rhat.tolist(),
            "ess_per_draw": (ess / (chains * draws)).tolist(),
            "min_ess_per_draw": float(ess.min() / (chains * draws)),
            "tim_proposal": [np.asarray(p).tolist()
                             for p in jmodel._tim_prop]}


if __name__ == "__main__" and sys.argv[1:2] == ["bench"]:
    import json
    import time

    t0 = time.time()
    out = reference(*map(int, sys.argv[2:]))
    out["seconds"] = time.time() - t0
    print(json.dumps(out))
