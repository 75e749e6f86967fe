"""The time-varying forms of K1, K1w, K2 and K2w compiled for the host
(``kernels/host_rehearsal.py``: a block's threads as host threads, real
barriers) against their plain versions on CPU tensors: z_t shared by the
systems, h_t = h h_scale_t, Q_t = (q_t q_t') o Q with q_t a system, shared
or none, a mask, one series or a series a group (a chain); 1e-12
normwise in float64, 1e-5 in float32 (``host_rehearsal.check_time_varying``).
Then a sweep, log_lik and the one-step errors of two small time-varying
bsts models with gaps through them, against the plain path: d = 13 (K2w,
K1w) and d = 4 (K2, K1).
"""

import shutil

import numpy as np
import pytest
import torch

from boom_tpu_torch import data
from boom_tpu_torch.api import BstsModel
from boom_tpu_torch.kernels import _build, host_rehearsal
from boom_tpu_torch.statespace import bsts as pbsts
from boom_tpu_torch.statespace import kalman_kernel as kk

torch.set_num_threads(1)

HOST_TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def host_libraries():
    """kalman_seq.cu and kalman_wide.cu compiled for the host, once for the
    module (in directories of their own)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return {name: host_rehearsal.build_host_library(name, variant="tv")
            for name in ("kalman_seq", "kalman_wide")}


@pytest.fixture
def host_kernels(monkeypatch, host_libraries):
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: host_libraries[n]
                                            for n in names})
    monkeypatch.setattr(kk, "_on_card", lambda x: True)
    monkeypatch.setattr(kk, "_stream", lambda device: 0)
    _build.library.cache_clear()
    yield
    _build.library.cache_clear()


@pytest.mark.parametrize("case", host_rehearsal.TV_CASES,
                         ids=lambda c: "d{}-B{}-S{}-T{}-{}-q{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_time_varying_kernels_match_plain(case):
    """K1 (d <= 6) or K1w with the innovations in float64 and float32, and
    K2 or K2w in float64 where the series is shared or a chain's: one
    launch each of the time-varying kernels, none of the static ones."""
    wide = case[0] >= 7
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_time_varying(seed=sum(case[:4]),
                                             cases=[case])
    loglik = "loglik_wide_tv" if wide else "loglik_tv"
    smoother = "smoother_wide_tv" if wide else "smoother_tv"
    assert kk.LAUNCHES[loglik] == before[loglik] + 2
    smoothed = case[2] in (1, case[1])
    assert kk.LAUNCHES[smoother] == before[smoother] + smoothed
    for kind in ("loglik", "loglik_wide", "smoother", "smoother_wide"):
        assert kk.LAUNCHES[kind] == before[kind]
    for name, err in errs.items():
        tol = HOST_TOL["float32" if "float32" in name else "float64"]
        assert err <= tol, (name, err)


def _tv_fit(small, chains=3):
    """A time-varying bsts on the first 60 days of the committed data, fit
    on the CPU with the plain versions: a Student trend and a 2-column
    dynamic regression (d = 4), or phase 8's blocks (d = 13)."""
    raw = data.bsts_tv()
    keep = raw["timestamps"] < 60
    model = BstsModel().add_student_local_linear_trend()
    if not small:
        model = model.add_seasonal(7)
    model = model.add_dynamic_regression(raw["x_dyn"][:60])
    if not small:
        model = model.add_random_walk_holiday(raw["active"][:60], 3)
    return model.fit(raw["y"][keep], predictors=raw["x"][keep][:, :4],
                     timestamps=raw["timestamps"][keep], niter=2, burn=1,
                     num_chains=chains, seed=2, device="cpu")


@pytest.mark.parametrize("small", [False, True], ids=["d13", "d4"])
def test_host_compiled_tv_bsts_matches_plain(small, host_libraries,
                                             monkeypatch):
    """A sweep (the smoother in its time-varying form, K3 for ASIS),
    log_lik and the one-step errors of a gapped time-varying model through
    the host-compiled kernels, against the same on the plain path (the
    sweep to 1e-9: its smoother feeds the variance draws)."""
    fit = _tv_fit(small)
    model = fit._model
    assert model.time_varying and not bool(model.observed.all())
    state = {k: v for k, v in fit._flat().items()}
    state = pbsts.thinned(state, 3)
    noise = model.draw_noise(torch.Generator().manual_seed(5), 3)
    want = model.kernel()(noise, state)
    want_ll = model.log_lik(want)
    want_err = pbsts.one_step_prediction_errors(model, want)
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: host_libraries[n]
                                            for n in names})
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
    smoother = "smoother_tv" if small else "smoother_wide_tv"
    loglik = "loglik_tv" if small else "loglik_wide_tv"
    assert kk.LAUNCHES[smoother] == before[smoother] + 1
    assert kk.LAUNCHES[loglik] == before[loglik] + 2
    assert kk.LAUNCHES["dpath"] == before["dpath"] + (0 if small else 1)
    for name in ("sigsq_obs", "beta", "alpha"):
        np.testing.assert_allclose(got[name].numpy(), want[name].numpy(),
                                   rtol=1e-9, atol=1e-9, err_msg=name)
    np.testing.assert_allclose(got_ll.numpy(), want_ll.numpy(), rtol=1e-12)
    np.testing.assert_allclose(got_err.numpy(), want_err.numpy(),
                               rtol=1e-10, atol=1e-12)


@pytest.mark.usefixtures("host_kernels")
def test_tv_wrappers_refuse_what_the_kernels_do_not_take():
    """On the card (here the host build) a z a system and a Q_t through
    an R that is no selection raise before anything is launched."""
    from boom_tpu_torch.kernels.kalman_timing import time_varying_system

    rng = np.random.default_rng(3)
    params = time_varying_system(rng, 3, 4, 9, "float64", "chain",
                                 device="cpu")
    y = torch.tensor(rng.normal(size=9))
    before = dict(kk.LAUNCHES)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 7"):
        kk.kalman_loglik(params._replace(z=params.z.contiguous() * torch.tensor(
            [1.0, 2.0, 3.0], dtype=torch.float64)[:, None, None]), y)
    with pytest.raises(NotImplementedError, match="selection"):
        kk.kalman_loglik(params._replace(r_mat=2.0 * params.r_mat), y)
    with pytest.raises(NotImplementedError, match="selection"):
        kk.simulation_smoother(
            params._replace(r_mat=2.0 * params.r_mat), y,
            torch.zeros(3, 4, dtype=torch.float64),
            torch.zeros(3, 8, 3, dtype=torch.float64),
            torch.zeros(3, 9, dtype=torch.float64))
    assert kk.LAUNCHES == before


def test_timing_reports_name_the_time_varying_forms():
    """kalman_timing's ``nvcc -Xptxas -v`` readers give each time-varying
    instantiation a key of its own (" tv", "loglik_tv"), beside the static
    ones' unchanged keys, and the bound counts the streams and R Q_t R'."""
    from boom_tpu_torch.kernels import kalman_timing as kt

    def log(names):
        return "".join(f"""ptxas info    : Compiling entry function '{n}' for 'sm_90a'
ptxas info    : Function properties for {n}
    0 bytes stack frame, {s} bytes spill stores, 0 bytes spill loads
ptxas info    : Used {r} registers, used 1 barriers
""" for n, r, s in names)

    seq = log([("_ZN12_GLOBAL__N_115smoother_kernelILi4ELb0EEEvPKdS2_", 96, 0),
               ("_ZN12_GLOBAL__N_115smoother_kernelILi4ELb1EEEvPKdS2_", 120, 8),
               ("_ZN12_GLOBAL__N_116loglik_tv_kernelIfLi4EEEvPKT_", 80, 0)])
    assert kt.nvcc_report(seq) == {
        "loglik_tv f32 d4": {"registers": 80, "spill_bytes": 0,
                             "stack_bytes": 0},
        "smoother f64 d4": {"registers": 96, "spill_bytes": 0,
                            "stack_bytes": 0},
        "smoother f64 d4 tv": {"registers": 120, "spill_bytes": 8,
                               "stack_bytes": 0}}
    wide = log([
        ("_ZN12_GLOBAL__N_120smoother_wide_kernelILi13ELi1ELb0EEEvPKdS2_",
         128, 0),
        ("_ZN12_GLOBAL__N_120smoother_wide_kernelILi13ELi1ELb1EEEvPKdS2_",
         128, 24),
        ("_ZN12_GLOBAL__N_118wide_loglik_kernelIffLi13ELi0ELb1EEEvPKT_", 90,
         0)])
    assert set(kt.wide_nvcc_report(wide)) == {
        "smoother_wide f64 d13 pass1", "smoother_wide f64 d13 pass1 tv",
        "loglik_wide f32 d13 tv"}
    static = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096)
    tv = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096,
                     tv_rows=4096)
    assert tv[0] > static[0] and kt.tv_step_flops(13) == 183
