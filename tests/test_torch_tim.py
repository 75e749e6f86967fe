"""The TIM marginal move of the port's bsts against the JAX reference, on
the CPU in float64: the multivariate T and the categorical draw it uses,
the BFGS and Newton mode search, the tailored proposal, and one whole sweep
with the move.

Tolerances:
- ``mvt``, ``categorical``: rtol 1e-10 (the same arithmetic; the reference
  draws its chi-square from ``jax.random.gamma``, rebuilt here as the
  uniform F(g) that the port's inverse CDF maps back to g to ~1e-15);
- the optimizers: rtol 1e-9 on a quadratic and 1e-7 on a Rosenbrock-like
  valley, where rounding decides the line-search steps of both;
- the proposal: mode rtol 1e-6 and Cholesky factor rtol 1e-4: the two mode
  searches differentiate different code (autograd against jax), and the
  Hessian at the mode is sensitive to where each search stopped;
- the sweep: rtol 1e-7, as test_torch_bsts.py (the variance draws inherit
  PyTorch's ~1e-9 relative error of the incomplete gamma).

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/test_torch_tim.py bench

prints the reference's posterior medians of the bsts_llt workload on the
bench's own series (``boom_tpu_torch/data``) that ``chip_smoke.py`` holds
the port to (``REFERENCE_MEDIANS_LLT``); a number in place of ``bench``
takes ``_llt_series`` of that length.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from boom_tpu import numopt as jnumopt
from boom_tpu.dists.multivariate import mvt as jmvt
from boom_tpu.statespace.bsts import Bsts as JaxBsts
from boom_tpu.statespace.state_models import (
    LocalLinearTrend as JaxLocalLinearTrend,
)
from boom_tpu_torch import dists, numopt
from boom_tpu_torch.convert import model_from_jax, state_from_numpy
from boom_tpu_torch.statespace.bsts import Bsts
from boom_tpu_torch.statespace.state_models import LocalLinearTrend

torch.set_num_threads(1)

TINY = np.finfo(np.float64).tiny
F64 = jnp.float64


def _llt_series(t_len, seed=4207):
    """Local-linear-trend data as bench.py:173-175 makes them, drawn with
    numpy (the same recipe as chip_smoke.py's)."""
    rng = np.random.default_rng(seed)
    slope = np.cumsum(0.02 * rng.normal(size=t_len))
    level = np.cumsum(slope + 0.3 * rng.normal(size=t_len)) + 5.0
    return level + 0.5 * rng.normal(size=t_len)


def _close(port, ref, rtol):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(ref)).max())


# -- distributions ------------------------------------------------------------

MODE = np.array([-2.4, -8.6, -1.3])
CHOL = np.array([[0.29, 0.0, 0.0], [-0.19, 0.77, 0.0], [-0.06, -0.001, 0.1]])


def _mvt_noise(key, k, df):
    """The normals and the chi-square uniforms of the reference's
    ``mvt.sample(key, ..., shape=(k,))``: its gamma draw g as F(g)."""
    k1, k2 = jax.random.split(key)
    gam = jax.random.gamma(k2, 0.5 * df, (k,))
    return (np.asarray(jax.random.normal(k1, (k, len(MODE)))),
            np.asarray(jax.scipy.special.gammainc(0.5 * df, gam)))


@pytest.mark.parametrize("df", [3.0, 7.5])
def test_mvt_sample_and_logpdf_match_reference(df):
    key = jax.random.key(int(df * 10))
    ref = jmvt.sample(key, jnp.asarray(MODE), None, df,
                      chol=jnp.asarray(CHOL), shape=(16,))
    z, chi_u = _mvt_noise(key, 16, df)
    out = dists.mvt.sample(torch.tensor(z), torch.tensor(chi_u),
                           torch.tensor(MODE), None, df,
                           chol=torch.tensor(CHOL))
    _close(out, ref, 1e-10)
    ref_lp = jmvt.logpdf(ref, jnp.asarray(MODE), None, df,
                         chol=jnp.asarray(CHOL))
    _close(dists.mvt.logpdf(out, torch.tensor(MODE), None, df,
                            chol=torch.tensor(CHOL)), ref_lp, 1e-10)
    sigma = CHOL @ CHOL.T
    _close(dists.mvt.logpdf(out, torch.tensor(MODE), torch.tensor(sigma),
                            df), ref_lp, 1e-10)


def test_categorical_matches_reference():
    """argmax(logits + Gumbel) given the reference's own Gumbel uniforms,
    with -inf logits (candidates outside the prior's support)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(64, 16)) * 3.0
    logits[rng.uniform(size=logits.shape) < 0.3] = -np.inf
    keys = jax.random.split(jax.random.key(1), 64)
    ref = jax.vmap(lambda k, lg: jax.random.categorical(k, lg))(
        keys, jnp.asarray(logits))
    gumbel_u = jax.vmap(lambda k: jax.random.uniform(
        k, (16,), F64, minval=TINY))(keys)
    out = dists.categorical.sample(torch.tensor(logits),
                                   torch.tensor(np.asarray(gumbel_u)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert np.all(np.isfinite(logits[np.arange(64), out.numpy()]))


# -- numopt ------------------------------------------------------------------

A_MAT = np.array([[3.0, 0.4, 0.1], [0.4, 2.0, -0.3], [0.1, -0.3, 1.5]])
B_VEC = np.array([1.0, -2.0, 0.5])


def _quadratic(lib):
    a, b = lib.asarray(A_MAT), lib.asarray(B_VEC)
    return lambda x: 0.5 * (x - b) @ a @ (x - b) + (x * x * x * x).sum() * 0.01


def _valley(x):
    return (1.0 - x[0]) ** 2 + 5.0 * (x[1] - x[0] ** 2) ** 2


@pytest.mark.parametrize("name", ["bfgs", "newton_raphson"])
@pytest.mark.parametrize("problem", ["quadratic", "valley"])
def test_optimizers_match_reference(name, problem):
    x0 = np.array([0.3, 0.1, -0.2]) if problem == "quadratic" else \
        np.array([-1.2, 1.0])
    fns = ((_quadratic(jnp), _quadratic(torch)) if problem == "quadratic"
           else (_valley, _valley))
    kw = {"max_iters": 120} if name == "bfgs" else {"max_iters": 10}
    ref = getattr(jnumopt, name)(fns[0], jnp.asarray(x0), **kw)
    out = getattr(numopt, name)(fns[1], torch.tensor(x0), **kw)
    rtol = 1e-9 if problem == "quadratic" else 1e-7
    _close(out.x, ref.x, rtol)
    _close(out.value, ref.value, rtol)
    assert out.converged == bool(ref.converged)
    assert out.iterations == int(ref.iterations)


# -- the proposal and the sweep ----------------------------------------------

def _jax_tim_model(t_len, y=None, **kw):
    y = jnp.asarray(_llt_series(t_len) if y is None else y)
    return JaxBsts(y=y, blocks=[JaxLocalLinearTrend.default(y)],
                   marginal_sigma_slice=True, marginal_move="tim", **kw)


def test_tim_proposal_matches_reference():
    jmodel = _jax_tim_model(48, parallel_smoother=True)
    model = model_from_jax(jmodel, device="cpu")
    assert model.marginal_move == "tim" and model.marginal_tim_trials == 16
    mode, chol = model._tim_prop
    ref_mode, ref_chol = jmodel._tim_prop
    _close(mode, ref_mode, 1e-6)
    _close(chol, ref_chol, 1e-4)
    assert mode.dtype == torch.float64


def _tim_noise(key, k, df, n_groups):
    """The numbers the reference's TIM move draws from fold_in(key, 977)."""
    k1, k2, k3 = jax.random.split(jax.random.fold_in(key, 977), 3)
    ka, kb = jax.random.split(k1)
    gam = jax.random.gamma(kb, 0.5 * df, (k,))
    return {"tim_z": jax.random.normal(ka, (k, n_groups)),
            "tim_chi_u": jax.scipy.special.gammainc(0.5 * df, gam),
            "tim_gumbel_u": jax.random.uniform(k2, (k,), F64, minval=TINY),
            "tim_accept_u": jax.random.uniform(k3, (), F64, minval=TINY)}


def test_tim_sweep_matches_reference():
    """One sweep (variance draws, smoother, ASIS, TIM) for 4 chains with
    the reference's noise and its proposal: the same accept decisions and
    the same state."""
    from test_torch_bsts import CHAINS, _numpy_tree, _sweep_noise

    jmodel = _jax_tim_model(64, parallel_smoother=True)
    keys = jax.random.split(jax.random.key(21), CHAINS)
    sweep_keys = jax.random.split(jax.random.key(22), CHAINS)
    state0 = jax.jit(jax.vmap(jmodel.init_state))(keys)
    ref = jax.jit(jax.vmap(jmodel.kernel()))(sweep_keys, state0)

    model = model_from_jax(jmodel, device="cpu", parallel_smoother="pallas")
    object.__setattr__(model, "_tim_prop", tuple(
        torch.tensor(np.asarray(p)) for p in jmodel._tim_prop))
    n_groups = len(model._sigma_groups())
    noise = state_from_numpy(_numpy_tree(jax.jit(jax.vmap(lambda k: {
        **_sweep_noise(jmodel, k),
        **_tim_noise(k, model.marginal_tim_trials, model.marginal_tim_df,
                     n_groups)}))(sweep_keys)), device="cpu")
    state = state_from_numpy(_numpy_tree(state0), device="cpu")
    out = model.kernel()(noise, state)
    ref = _numpy_tree(ref)
    for got, want in ((out["sigsq_obs"], ref["sigsq_obs"]),
                      *((out["blocks"]["trend"][k], ref["blocks"]["trend"][k])
                        for k in ref["blocks"]["trend"])):
        _close(got.numpy(), want, 1e-7)
    _close(out["alpha"].numpy(), ref["alpha"], 1e-7)
    # the move accepted in some chains: their variances left the
    # conditional sweep's values
    before = model.kernel()(noise, state, do_marginal=False)
    moved = ~torch.isclose(out["sigsq_obs"], before["sigsq_obs"],
                           rtol=1e-12)
    assert bool(moved.any())


def test_marginal_slice_period_composes_sweeps():
    """period 2: one conditional sweep, then one with the move; noise for
    both comes in one mapping."""
    y = torch.tensor(_llt_series(40))
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y)],
                 parallel_smoother="pallas", marginal_sigma_slice=True,
                 marginal_slice_period=2)
    spec = model.noise_spec()
    assert set(spec) == {"sub0", "last"}
    assert "tim_z" in spec["last"] and "tim_z" not in spec["sub0"]
    gen = torch.Generator().manual_seed(0)
    state = model.init_state(model.draw_init_noise(gen, 3))
    out = model.kernel()(model.draw_noise(gen, 3), state)
    assert all(bool(torch.isfinite(v).all()) for v in (
        out["sigsq_obs"], out["alpha"],
        *out["blocks"]["trend"].values()))


def test_fit_passes_the_marginal_options_through():
    """BstsModel.fit hands marginal_sigma_slice / marginal_move to Bsts,
    as the reference's fit does."""
    from boom_tpu_torch.api import BstsModel

    fit = BstsModel().add_local_linear_trend().fit(
        _llt_series(40), niter=3, burn=2, num_chains=2, seed=4,
        device="cpu", marginal_sigma_slice=True, marginal_move="tim")
    assert fit._model.marginal_sigma_slice and hasattr(fit._model,
                                                        "_tim_prop")
    assert fit._model._smoother().__module__.endswith("kalman_kernel")
    assert bool(torch.isfinite(fit.draws["sigsq_obs"]).all())
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        BstsModel().add_local_linear_trend().fit(
            _llt_series(40), niter=1, burn=0, num_chains=1, device="cpu",
            marginal_sigma_slice=True, marginal_move="grid")


def reference_medians(series="bench", chains=64, burn=500, draws=2000,
                      seed=2026):
    """Posterior medians of the three variances from the JAX reference's
    bsts_llt configuration (bench.py:170-177: local linear trend, TIM,
    default priors), float64 on the CPU, on the bench's own series
    (``series="bench"``, ``boom_tpu_torch.data.bsts_llt_series``) or on
    ``_llt_series(int(series))``."""
    from boom_tpu.inference import run_mcmc
    from boom_tpu_torch import data

    jax.config.update("jax_enable_x64", True)
    if series == "bench":
        y = data.bsts_llt_series().astype(np.float64)
        jmodel = _jax_tim_model(len(y), y=y)
    else:
        jmodel = _jax_tim_model(int(series))
    fit = jax.jit(lambda k: run_mcmc(
        k, jmodel.kernel(), jmodel.init_state, draws, num_chains=chains,
        burn=burn, jit=False, extract=lambda s: {
            "sigsq_obs": s["sigsq_obs"],
            "sigma_level_sq": s["blocks"]["trend"]["sigma_level_sq"],
            "sigma_slope_sq": s["blocks"]["trend"]["sigma_slope_sq"]}).draws)
    out = fit(jax.random.key(seed))
    return {k: float(np.median(np.asarray(v))) for k, v in out.items()}


if __name__ == "__main__":
    print(reference_medians(*sys.argv[1:2], *map(int, sys.argv[2:])))
