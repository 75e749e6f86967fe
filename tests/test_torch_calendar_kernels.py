"""The calendar's T_t in K1w's and K2w's time-varying forms compiled for
the host (``kernels/host_rehearsal.py``: a block's threads as fibers,
real barriers), in a build directory of their own, against their plain
versions on CPU tensors (``host_rehearsal.check_calendar``): d 11, 13, 14
and 16 (the monthly cycle's 11 and more), two matrices a system or two for
all, a month boundary at step 0 and at T - 2, T about K2w's chunks and
K1w's 32 steps, a mask; K1w with and without the innovations in float64
and float32, K2w in float64; 1e-12 normwise in float64, 1e-5 in float32.
Then a sweep, log_lik and the one-step errors of phase 10a's model (a
semilocal trend and the monthly cycle, d = 14) and a sweep of phase 10b's
(d = 7, a T a chain, the TIM move) through the host-compiled kernels,
against the same on the plain path (the sweeps to 1e-9: the smoother
feeds the variance draws).
"""

import shutil

import numpy as np
import pytest
import torch

from boom_tpu_torch import data
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.kernels import _build, host_rehearsal
from boom_tpu_torch.kernels import kalman_timing as kt
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace import kalman_kernel as kk

torch.set_num_threads(1)

HOST_TOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(scope="module")
def host_library():
    """kalman_wide.cu compiled for the host once for the module, in a
    directory of its own."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return host_rehearsal.build_host_library("kalman_wide",
                                             variant="calendar")


@pytest.fixture
def host_kernels(monkeypatch, host_library):
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: host_library for n in names})
    monkeypatch.setattr(kk, "_on_card", lambda x: True)
    monkeypatch.setattr(kk, "_stream", lambda device: 0)
    _build.library.cache_clear()
    yield
    _build.library.cache_clear()


@pytest.mark.parametrize("case", host_rehearsal.CALENDAR_CASES,
                         ids=lambda c: "d{}-B{}-T{}-{}-masked{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_calendar_kernels_match_plain(case):
    """Each launch takes its calendar key, none other."""
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_calendar(seed=case[0] * 100 + case[2],
                                         cases=[case])
    ran = {k: kk.LAUNCHES[k] - before[k] for k in kk.LAUNCHES
           if kk.LAUNCHES[k] != before[k]}
    assert ran == {"loglik_wide_tv_calendar": 4,
                   "smoother_wide_tv_calendar": 1}
    for name, err in errs.items():
        tol = HOST_TOL["float32" if "float32" in name else "float64"]
        assert err <= tol, (name, err)


@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_calendar_reads_each_step_s_matrix():
    """The calendar matters: the kernels' results move with the step's
    choice (a calendar of the other matrix gives another loglik and draw,
    as the plain version does), and a second launch is bit-identical."""
    rng = np.random.default_rng(5)
    params = kt.calendar_system(rng, 3, 14, 40, "float64", device="cpu")
    y = torch.tensor(rng.normal(size=40).cumsum())
    flipped = params._replace(t_choice=1 - params.t_choice)
    ll, ll_flip = (kk.launch_loglik_tv(p, y, None) for p in (params, flipped))
    assert not torch.allclose(ll, ll_flip)
    torch.testing.assert_close(ll_flip, kalman.kalman_loglik(flipped, y),
                               rtol=1e-12, atol=0.0)
    nz = [torch.tensor(rng.normal(size=s)) for s in ((3, 14), (3, 39, 13),
                                                     (3, 40))]
    first = kk.simulation_smoother(params, y, *nz)
    assert torch.equal(first, kk.simulation_smoother(params, y, *nz))
    assert not torch.allclose(first, kk.simulation_smoother(flipped, y, *nz))
    assert torch.equal(ll, kk.launch_loglik_tv(params, y, None))


def _models():
    y_m = np.asarray(data.bsts_monthly()["y"][:70], np.float64)
    monthly = (BstsModel().add_semilocal_linear_trend()
               .add_monthly_annual_cycle(first_date=data.BSTS_MONTHLY_FIRST)
               .fit(y_m, niter=2, burn=1, num_chains=3, seed=2,
                    device="cpu"))
    y_a = np.asarray(data.bsts_ar_trig()["y"][:70], np.float64)
    ar_trig = (BstsModel().add_static_intercept().add_ar(lags=2)
               .add_trig(period=data.BSTS_AR_TRIG_PERIOD, nfreq=2)
               .fit(y_a, niter=2, burn=1, num_chains=3, seed=2,
                    device="cpu", marginal_sigma_slice=True,
                    marginal_move="tim"))
    return {"monthly": monthly, "ar_trig": ar_trig}


# the kernels each model's sweep, log_lik and errors launch
RUNS = {"monthly": {"smoother_wide_tv_calendar": 1, "dpath": 1,
                    "loglik_wide_tv_calendar": 2},
        "ar_trig": {"smoother_wide": 1, "dpath": 1, "loglik_wide": 3}}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_host_compiled_models_match_plain(name, host_library, monkeypatch):
    """phase 10a's model (T_t: K2w's dense form with the calendar, K3 on
    the static T, K1w's form with the calendar) and phase 10b's (a T a
    chain: the static K2w, K3, K1w with a T a system over each chain's 17
    TIM points)."""
    fit = _models()[name]
    model = fit._model
    state = pbsts.thinned(fit._flat(), 3)
    noise = model.draw_noise(torch.Generator().manual_seed(5), 3)
    want = model.kernel()(noise, state)
    want_ll = model.log_lik(want)
    want_err = pbsts.one_step_prediction_errors(model, want)
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: host_library for n in names})
    monkeypatch.setattr(kk, "_on_card", lambda x: True)
    monkeypatch.setattr(kk, "_stream", lambda device: 0)
    _build.library.cache_clear()
    try:
        before = dict(kk.LAUNCHES)
        got = model.kernel()(noise, state)
        got_ll = model.log_lik(got)
        got_err = pbsts.one_step_prediction_errors(model, got)
    finally:
        _build.library.cache_clear()
    ran = {k: kk.LAUNCHES[k] - before[k] for k in kk.LAUNCHES
           if kk.LAUNCHES[k] != before[k]}
    assert ran == RUNS[name]
    for leaf in ("sigsq_obs", "alpha"):
        np.testing.assert_allclose(got[leaf].numpy(), want[leaf].numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=leaf)
    for bname, params in want["blocks"].items():
        for pname, v in params.items():
            np.testing.assert_allclose(got["blocks"][bname][pname].numpy(),
                                       v.numpy(), rtol=1e-9, atol=1e-12,
                                       err_msg=pname)
    np.testing.assert_allclose(got_ll.numpy(), want_ll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got_err.numpy(), want_err.numpy(),
                               rtol=1e-10, atol=1e-12)
