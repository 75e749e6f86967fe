"""The time-varying forms of K1, K1w, K2 and K2w compiled for the host
(``kernels/host_rehearsal.py``: a block's threads as host threads, real
barriers) against their plain versions on CPU tensors: z_t shared by the
systems, h_t = h h_scale_t, Q_t = (q_t q_t') o Q with q_t a system, shared
or none, a mask, one series or a series a group (a chain); 1e-12
normwise in float64, 1e-5 in float32 (``host_rehearsal.check_time_varying``).
Then a sweep, log_lik and the one-step errors of two small time-varying
bsts models with gaps through them, against the plain path: d = 13 (K2w,
K1w) and d = 4 (K2, K1). Then K2w's structured form (T's products over
its non-zeros, z_t and h_scale staged once a block), K2's form with its
streams staged a chunk ahead, K1's (a thread a system) and K1w's (a warp
a system), at 1e-12 (float64; K1 and K1w also float32 at 1e-5): T shared
with bsts' pattern, a random pattern (an empty row and a full one) or
dense, and T a chain (K2w's dense form), across the chunks' edges; the
pattern a model's run finds once and its log_lik and errors reuse, and
the refusal of a pattern that disagrees with T.
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

HOST_TOL = {"float64": 1e-12, "float32": 1e-5}

# K2w's structured form and K2's staged form (float64, HOST_TOL)
T_EDGES = (31, 32, 33, 67)
Q_MODES = ("chain", "shared", None)
# K2w at d 7, 8, 13, 16 with each kind of T, the T of a case walking the
# chunks' edges so that every (d, T) and (kind, T) pair is met once
WIDE_CASES = [(d, kind, T_EDGES[(i + j) % 4])
              for i, d in enumerate((7, 8, 13, 16))
              for j, kind in enumerate(kt.T_KINDS)]
# K2 at d 1, 2, 4 (32 steps a chunk) and 6 (16) at every edge
SEQ_CASES = [(d, t_len) for d in (1, 2, 4, 6) for t_len in T_EDGES]
# the time-varying loglik's forms (K1 to d = 6, K1w past it): d, T's kind
# (a T a system, or one T for all: bsts' pattern or a random one with an
# empty row and a full one), T across the 32-step chunks' edges (33, 67),
# q_t a system, one for all or none, masked or not, and a ragged B (33
# systems: one over K1's warp of systems)
LOGLIK_TV_CASES = [(d, kind, (33, 67)[(i + j) % 2], Q_MODES[(i + j) % 3],
                    (i + j) % 2 == 0)
                   for i, d in enumerate((1, 2, 4, 6, 7, 13, 16))
                   for j, kind in enumerate(("chain", "bsts", "sparse"))]


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
    launch each of the time-varying kernels, none of the static ones (K2w
    in its dense form: these systems have a T each)."""
    wide = case[0] >= 7
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_time_varying(seed=sum(case[:4]),
                                             cases=[case])
    loglik = "loglik_wide_tv" if wide else "loglik_tv"
    smoother = "smoother_wide_tv_dense" if wide else "smoother_tv"
    assert kk.LAUNCHES[loglik] == before[loglik] + 2
    smoothed = case[2] in (1, case[1])
    assert kk.LAUNCHES[smoother] == before[smoother] + smoothed
    for kind in ("loglik", "loglik_wide", "smoother", "smoother_wide"):
        assert kk.LAUNCHES[kind] == before[kind]
    for name, err in errs.items():
        tol = HOST_TOL["float32" if "float32" in name else "float64"]
        assert err <= tol, (name, err)


@pytest.mark.parametrize("case", LOGLIK_TV_CASES,
                         ids=lambda c: "d{}-{}-T{}-q{}-masked{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_loglik_tv_forms_match_plain(case):
    """K1's time-varying form (a thread a system, its streams staged a
    chunk ahead, the symmetric step) and K1w's (a warp a system, a step's
    products over its lanes) with their innovations, float64 and float32,
    on 33 systems over 11 series and on 33 systems a series each, against
    ``kalman.kalman_loglik(..., innovations=True)``; each launch takes its
    form's key."""
    d, t_kind, t_len, q_mode, masked = case
    cases = [(d, 33, s, t_len, masked, q_mode) for s in (11, 33)]
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_time_varying(
        seed=d * 100 + t_len, cases=cases, t_kind=t_kind, smoother=False)
    key = "loglik_wide_tv" if d >= 7 else "loglik_tv"
    ran = {k: kk.LAUNCHES[k] - before[k] for k in kk.LAUNCHES
           if kk.LAUNCHES[k] != before[k]}
    assert ran == {key: 4}
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
    instantiation a key of its own (" tv", "loglik_tv"; K2w's structured
    form " tv nz"), beside the static ones' unchanged keys, and the bound
    counts the streams and R Q_t R'."""
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
        ("_ZN12_GLOBAL__N_121loglik_tv_warp_kernelIfLi13EEEvPKT_S3_S3_S3_",
         56, 0),
        ("_ZN12_GLOBAL__N_121loglik_tv_warp_kernelIdLi16EEEvPKT_S3_S3_S3_",
         90, 0),
        ("_ZN12_GLOBAL__N_123smoother_wide_nz_kernelILi13ELi1EEEvNS_3NzTEPKd",
         110, 0),
        ("_ZN12_GLOBAL__N_123smoother_wide_nz_kernelILi7ELi3EEEvNS_3NzTEPKd",
         80, 0)])
    assert set(kt.wide_nvcc_report(wide)) == {
        "smoother_wide f64 d13 pass1", "smoother_wide f64 d13 pass1 tv",
        "loglik_wide f32 d13 tv", "loglik_wide f64 d16 tv",
        "smoother_wide f64 d13 pass1 tv nz",
        "smoother_wide f64 d07 pass3 tv nz"}
    assert kt._WIDE_PASS.search(
        "void (anonymous namespace)::smoother_wide_nz_kernel<13, 2>(NzT, "
        "double const*)").group(1) == "2"
    assert kt._WIDE_PASS.search(
        "void (anonymous namespace)::smoother_wide_kernel<13, 3, true>("
        "double const*)").group(1) == "3"
    static = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096)
    tv = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096,
                     tv_rows=4096)
    assert tv[0] > static[0] and kt.tv_step_flops(13) == 183
    # the static K2 timed beside K2's time-varying form, at its shape
    assert kt._bound_name("smoother_d4") == "smoother"
    assert kt.K2_TV_YARDSTICK["smoother_d4"] == \
        kt.TV_SHAPES["smoother_tv"][:5]


def _smoother_case(rng, d, t_len, t_kind, q_mode, chains=5):
    """(params, y [C, T] a series a chain, normals, mask) of a
    time-varying system with a T of ``t_kind``."""
    params = kt.time_varying_system(rng, chains, d, t_len, "float64", q_mode,
                                    device="cpu", t_kind=t_kind)
    y = torch.tensor(rng.normal(size=(chains, t_len)).cumsum(-1))
    q = params.q_mat.shape[-1]
    normals = [torch.tensor(rng.normal(size=s))
               for s in ((chains, d), (chains, t_len - 1, q),
                         (chains, t_len))]
    obs = torch.tensor(rng.uniform(size=t_len) > 0.3)
    return params, y, normals, obs


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("case", WIDE_CASES,
                         ids=lambda c: "d{}-{}-T{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_structured_smoother_matches_plain(case):
    """K2w with a T for all chains takes its structured form (the pattern
    found from T, as for a caller that gives none), with a T a chain its
    dense form; both agree with the plain smoother."""
    d, t_kind, t_len = case
    rng = np.random.default_rng(d * 100 + t_len)
    q_mode = Q_MODES[(d + t_len) % 3]
    params, y, normals, obs = _smoother_case(rng, d, t_len, t_kind, q_mode)
    before = dict(kk.LAUNCHES)
    got = kk.simulation_smoother(params, y, *normals, observed=obs)
    want = kalman.simulation_smoother(params, y, *normals, observed=obs)
    key = "smoother_wide_tv_dense" if t_kind == "chain" else \
        "smoother_wide_tv"
    ran = {k: kk.LAUNCHES[k] - before[k] for k in kk.LAUNCHES
           if kk.LAUNCHES[k] != before[k]}
    assert ran == {key: 1}
    assert _rel(got, want) <= HOST_TOL["float64"], _rel(got, want)


@pytest.mark.parametrize("case", SEQ_CASES,
                         ids=lambda c: "d{}-T{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_restaged_k2_matches_plain(case):
    """K2's time-varying form, its u_t rows, z_t and h_scale staged a chunk
    ahead (16 steps past d = 4, 32 to it), across the chunks' edges and a
    second, ragged warp of chains."""
    d, t_len = case
    rng = np.random.default_rng(d * 1000 + t_len)
    q_mode = Q_MODES[(d + t_len) % 3]
    t_kind = ("chain", "bsts")[t_len % 2] if d >= 3 else "chain"
    params, y, normals, obs = _smoother_case(rng, d, t_len, t_kind, q_mode,
                                             chains=33 if d == 4 else 5)
    before = kk.LAUNCHES["smoother_tv"]
    got = kk.simulation_smoother(params, y, *normals, observed=obs)
    want = kalman.simulation_smoother(params, y, *normals, observed=obs)
    assert kk.LAUNCHES["smoother_tv"] == before + 1
    assert _rel(got, want) <= HOST_TOL["float64"], _rel(got, want)


def test_host_compiled_run_finds_its_pattern_once(host_kernels,
                                                  monkeypatch):
    """A run of several sweeps of phase 8's blocks finds T's pattern and R's
    selection once (one pattern, one read of R), and every launch of the
    smoother takes the structured form: no launch reads the host."""
    made, reads = [], []
    pattern_init = kk.TransitionPattern.__init__
    is_selection = kk._is_selection

    def counted_init(self, *args, **kw):
        made.append(1)
        pattern_init(self, *args, **kw)

    def counted_read(r):
        reads.append(1)
        return is_selection(r)

    monkeypatch.setattr(kk.TransitionPattern, "__init__", counted_init)
    monkeypatch.setattr(kk, "_is_selection", counted_read)
    raw = data.bsts_tv()
    keep = raw["timestamps"] < 24
    before = dict(kk.LAUNCHES)
    fit = (BstsModel().add_student_local_linear_trend().add_seasonal(7)
           .add_dynamic_regression(raw["x_dyn"][:24])
           .add_random_walk_holiday(raw["active"][:24], 3)
           .fit(raw["y"][keep], timestamps=raw["timestamps"][keep], niter=2,
                burn=1, num_chains=2, seed=3, device="cpu"))
    assert fit._model.state_dim == 13
    assert (len(made), len(reads)) == (1, 1)
    assert kk.LAUNCHES["smoother_wide_tv"] - before["smoother_wide_tv"] == 4
    assert kk.LAUNCHES["smoother_wide_tv_dense"] == \
        before["smoother_wide_tv_dense"]
    pattern = fit._model._transition_pattern
    assert pattern.row_counts() == kt.transition_rows(13, "bsts")
    assert pattern.nnz == 19 and pattern.selection


def test_loglik_and_errors_take_the_models_pattern(host_kernels,
                                                   monkeypatch):
    """log_lik, the in-sample errors and the holdout errors of phase 8's
    blocks hand K1w's form the model's own pattern (its T and R in the
    run's dtype): once the fit found it, no call finds another or reads R
    on the host; the holdout's one pattern and one read are its refit
    model's, for its own smoother."""
    raw = data.bsts_tv()
    keep = raw["timestamps"] < 24
    fit = (BstsModel().add_student_local_linear_trend().add_seasonal(7)
           .add_dynamic_regression(raw["x_dyn"][:24])
           .add_random_walk_holiday(raw["active"][:24], 3)
           .fit(raw["y"][keep], timestamps=raw["timestamps"][keep], niter=2,
                burn=1, num_chains=2, seed=3, device="cpu",
                dtype=torch.float32))
    model, states = fit._model, fit._flat()
    assert model._transition_pattern.nnz == 19
    made, reads, given = [], [], []
    pattern_init = kk.TransitionPattern.__init__
    is_selection = kk._is_selection
    launch = kk.launch_loglik_tv

    def counted_init(self, *args, **kw):
        made.append(1)
        pattern_init(self, *args, **kw)

    def counted_read(r):
        reads.append(1)
        return is_selection(r)

    def spied(params, y, observed, innovations=False, pattern=None):
        given.append(pattern)
        return launch(params, y, observed, innovations, pattern)

    monkeypatch.setattr(kk.TransitionPattern, "__init__", counted_init)
    monkeypatch.setattr(kk, "_is_selection", counted_read)
    monkeypatch.setattr(kk, "launch_loglik_tv", spied)
    before = kk.LAUNCHES["loglik_wide_tv"]
    ll = model.log_lik(states)
    errs = pbsts.one_step_prediction_errors(model, states)
    assert (made, reads) == ([], [])
    held = pbsts.holdout_prediction_errors(
        model, torch.Generator().manual_seed(4), 16, num_draws=2,
        num_chains=1, burn=1, max_draws=2)
    assert (len(made), len(reads)) == (1, 1)
    assert len(given) == 3 and all(p is model._run_pattern for p in given)
    assert given[0].t_mat is model._transition[0]
    assert kk.LAUNCHES["loglik_wide_tv"] == before + 3
    want = kalman.kalman_loglik(model.ssm_params(states),
                                model.adjusted_series(states),
                                model.observed, innovations=True)
    assert _rel(ll.double(), want[0].double()) <= 1e-5
    assert _rel(errs.double(),
                (want[1] / torch.sqrt(want[2])).double()) <= 1e-5
    assert held.shape == (2, model.t_len) and bool(torch.isfinite(held).all())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_impute_gives_the_pattern_to_the_models_own_t_only(monkeypatch,
                                                          dtype):
    """ssm_params expands the model's T and R, built once a model; _impute
    hands the smoother the model's pattern only for those (its T and R in
    float64, the same memory: no read, no other matrix), and a T of the
    same values held elsewhere goes without it. In a float32 run too,
    where the pattern's float64 T is the model's T cast once."""
    seen = []

    def smoother(self):
        def run(params, y, *normals, **kw):
            seen.append((params, kw.get("pattern")))
            return torch.zeros(params.h.shape[0], y.shape[-1],
                               params.t_mat.shape[-1], dtype=torch.float64)
        return run

    raw = data.bsts_tv()
    keep = raw["timestamps"] < 24
    fit = (BstsModel().add_student_local_linear_trend().add_seasonal(7)
           .add_dynamic_regression(raw["x_dyn"][:24])
           .add_random_walk_holiday(raw["active"][:24], 3)
           .fit(raw["y"][keep], timestamps=raw["timestamps"][keep], niter=2,
                burn=1, num_chains=2, seed=3, device="cpu", dtype=dtype))
    model, states = fit._model, fit._flat()
    assert model.y.dtype == dtype
    params = model.ssm_params(states)
    t_own, r_own = model._transition
    assert kk.expands(params.t_mat, t_own) and kk.expands(params.r_mat, r_own)
    c = params.h.shape[0]
    noise = {k: torch.zeros(c, *shape, dtype=model.y.dtype)
             for k, (shape, _kind) in model._smoother_noise_spec().items()}
    monkeypatch.setattr(pbsts.Bsts, "_smoother", smoother)
    model._impute(params, noise)
    model._impute(params._replace(t_mat=params.t_mat.clone()), noise)
    (own, pattern), (other, none) = seen
    assert pattern is model._transition_pattern and none is None
    assert kk.expands(own.t_mat, pattern.t_mat)
    assert kk.expands(own.r_mat, pattern.r_mat)
    assert torch.equal(own.t_mat, other.t_mat.double())
    assert torch.equal(pattern.t_mat, t_own.double())


@pytest.mark.usefixtures("host_kernels")
def test_pattern_that_disagrees_with_t_raises():
    """A pattern checked against another T: the same values pass (compared
    on the host), one entry off raises before anything is launched, on
    the card's path and on the plain one."""
    rng = np.random.default_rng(7)
    params, y, normals, obs = _smoother_case(rng, 8, 9, "bsts", "chain",
                                             chains=3)
    pattern = kk.TransitionPattern(params.t_mat[0].clone(),
                                   params.r_mat[0].clone())
    same = kk.simulation_smoother(params, y, *normals, observed=obs,
                                  pattern=pattern)
    want = kalman.simulation_smoother(params, y, *normals, observed=obs)
    assert _rel(same, want) <= HOST_TOL["float64"]
    off = params.t_mat[0].clone()
    off[3, 5] = 0.25
    wrong = params._replace(t_mat=off.expand(3, 8, 8))
    before = dict(kk.LAUNCHES)
    with pytest.raises(ValueError, match="pattern disagrees with T"):
        kk.simulation_smoother(wrong, y, *normals, observed=obs,
                               pattern=pattern)
    with pytest.raises(ValueError, match="pattern disagrees with T"):
        kk.simulation_smoother(params._replace(
            t_mat=params.t_mat.contiguous() * 1.5), y, *normals,
            observed=obs, pattern=pattern)
    assert kk.LAUNCHES == before


def test_plain_path_checks_the_pattern_too():
    """On a CPU tensor the plain smoother runs, and a pattern that
    disagrees with T raises there as on the card."""
    rng = np.random.default_rng(8)
    params, y, normals, obs = _smoother_case(rng, 7, 6, "sparse", None,
                                             chains=2)
    pattern = kk.TransitionPattern(torch.eye(7, dtype=torch.float64))
    with pytest.raises(ValueError, match="pattern disagrees with T"):
        kk.simulation_smoother(params, y, *normals, observed=obs,
                               pattern=pattern)
    own = kk.TransitionPattern(params.t_mat[0])
    got = kk.simulation_smoother(params, y, *normals, observed=obs,
                                 pattern=own)
    want = kalman.simulation_smoother(params, y, *normals, observed=obs)
    assert torch.equal(got, want)


def test_bound_counts_t_nonzeros():
    """kalman_timing's bound over phase 8's T counts its 19 non-zeros, well
    under the dense-symmetric count, and equals it for a full pattern."""
    rows = kt.transition_rows(13, "bsts")
    assert sum(rows) == 19 and max(rows) == 6
    full = kt.filter_step_flops(13)
    assert kt.filter_step_flops(13, (13,) * 13) == full
    assert kt.filter_step_flops(13, rows) < full / 3
    sparse = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096,
                         tv_rows=4096, rows=rows)
    dense = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096,
                        tv_rows=4096)
    assert sparse[0] < dense[0]
    # the bytes are those the function reads: eta and q_t q wide (phase
    # 8's q = 8), not w and u = R q_t d wide
    q = kt.state_errors(13, "bsts")
    read = kt.bound_ms("smoother", "float64", 4096, 13, 500, 4096,
                       tv_rows=4096, rows=rows, q=q)
    assert q == 8 and read[1] == "bytes" and read[0] < sparse[0]
    item, t_len = 8, 500
    saved = 4096 * ((t_len - 1) * (13 - q) + t_len * (13 - q)) * item
    assert abs((sparse[0] - read[0]) * 1e-3 * kt.HBM_BYTES_PER_S
               - saved) < 1.0
