"""The kernels of the TIM move's path compiled for the host
(``kernels/host_rehearsal.py``: a block's threads as host threads, real
barriers) against their plain versions on CPU tensors: K1 with a series a
group of systems, K1w and their innovations, and J1 and J2 along K
directions: 1e-12 normwise in float64, 1e-5 in float32, against
``kalman.kalman_loglik(..., innovations=True)`` and autograd of the plain
loop (``kalman.loglik_jets``); then the TIM proposal build and one sweep
with the move through them; and the wrappers' refusals past the kernels'
range.
"""

import shutil

import numpy as np
import pytest
import torch

from boom_tpu_torch import rng as prng
from boom_tpu_torch.kernels import _build, host_rehearsal
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace import kalman_kernel as kk
from boom_tpu_torch.statespace.bsts import Bsts

torch.set_num_threads(1)

CHAINS, P_SMALL = 8, 3
HOST_TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def host_libraries():
    """kalman_seq.cu and kalman_wide.cu compiled for the host, once for the
    module (in directories of their own)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return {name: host_rehearsal.build_host_library(name, variant="tim_reg")
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


@pytest.mark.parametrize("case", host_rehearsal.LOGLIK_CASES,
                         ids=lambda c: "d{}-B{}-S{}-T{}-{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_loglik_matches_plain(case):
    """K1 (d <= 6) and K1w with a series a group of systems (shared, one
    a system, two a series; over several of K1w's blocks, the last
    ragged) and their innovations v and f, float64 and float32: one launch
    each, the loglik alone bit-identical to the one with innovations."""
    kind = "loglik_wide" if case[0] >= 7 else "loglik"
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_loglik(seed=sum(case), cases=[case])
    assert kk.LAUNCHES[kind] == before[kind] + 4
    for name, err in errs.items():
        assert err <= HOST_TOL[name.split()[1]], (name, err)


@pytest.mark.parametrize("case", host_rehearsal.LOGLIK_SHARED_CASES,
                         ids=lambda c: "d{}-B{}-S{}-T{}-{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_loglik_shared_system_matches_plain(case):
    """K1w on non-symmetric systems, float64 and float32: T and z one of
    every system, expanded over the systems as Bsts builds them (the
    wrapper passes their one row: the thread kernel's broadcast layout),
    give the bits of the same systems materialised, and these and a T a
    system agree with the plain filter."""
    from boom_tpu_torch.kernels.kalman_timing import system

    d, b = case[:2]
    one = system(np.random.default_rng(0), b, d, "float64", device="cpu")
    expanded = (one.h, one.rqr, one.z[:1].expand(b, d),
                one.t_mat[:1].expand(b, d, d), one.a0, one.p0,
                torch.zeros(5, dtype=torch.float64), None, ("f64",), (d,),
                "K1w")
    p, *_rest, shared = kk._loglik_operands(*expanded, share=True)
    assert shared == kk.SHARED_T | kk.SHARED_Z
    assert p["t_mat"].shape == (1, d, d) and p["z"].shape == (1, d)
    before = kk.LAUNCHES["loglik_wide"]
    errs = host_rehearsal.check_loglik_shared(seed=sum(case), cases=[case])
    assert kk.LAUNCHES["loglik_wide"] == before + 6
    for name, (err, same) in errs.items():
        assert same, f"{name}: expanded and materialised differ"
        assert err <= HOST_TOL[name.split()[2]], (name, err)


def _jet_id(case):
    return "d{}-K{}-B{}-S{}-{}".format(*case) + "".join(
        f"-T{t}" for t in case[5:])


@pytest.mark.parametrize("case", host_rehearsal.JET_CASES, ids=_jet_id)
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_jets_match_plain(case):
    """J1 and J2 along K directions, d 1-16, K 1-16, one shared series and
    a series a system, masked and dense, T across the kernel's chunks of y
    and at the paths' 500, against autograd of the plain loop; a second
    launch bit-identical."""
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_jets(seed=sum(case), cases=[case])
    assert kk.LAUNCHES["loglik_grad"] == before["loglik_grad"] + 2
    assert kk.LAUNCHES["loglik_hess"] == before["loglik_hess"] + 2
    for name, (err, same) in errs.items():
        assert err <= HOST_TOL["float64"], (name, err)
        assert same, f"{name}: a second launch differs"


@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_tim_proposal_and_sweep_match_plain():
    """The TIM proposal build (J1, J2 at d = 8 along the three variances)
    and one sweep with the move (K1w over 8 chains x 17 points, each
    chain's points on its own y - X beta) through the host-compiled
    kernels, against the same through the plain versions. Each part is
    held to what sets it: the proposal's objective, its gradient (J1) and
    its Hessian (J2) at one point, and its Cholesky factor (the Hessian
    eigen-clamped and inflated) at the kernels' own mode, to the kernels'
    1e-12; the two modes to the resolution of numopt's stopping rule
    (:func:`_mode_resolution`), since y - X beta_OLS moves in its last
    bits from run to run (MKL's least squares rounds by its operands'
    alignment) and either search may stop anywhere a comparison of values
    cannot order; the sweep, with the proposal shared, to 1e-10."""
    from test_torch_bsts_reg import _reg_data

    from boom_tpu_torch.models.glm.regression import SpikeSlabPrior
    from boom_tpu_torch.statespace.state_models import (
        LocalLinearTrend,
        Seasonal,
    )

    x, y = (torch.tensor(a) for a in _reg_data(40, P_SMALL, 7))

    def build():
        return Bsts(y=y, blocks=[LocalLinearTrend.default(y),
                                 Seasonal.default(y, nseasons=7)],
                    predictors=x, reg_prior=SpikeSlabPrior.from_data(x, y),
                    parallel_smoother=False, marginal_sigma_slice=True)

    before = dict(kk.LAUNCHES)
    model = build()
    built = {k: kk.LAUNCHES[k] - before[k] for k in kk.LAUNCHES}
    assert built["loglik_grad"] >= 1 and built["loglik_hess"] >= 1
    neg, u0 = model._tim_objective()
    mode = model._tim_prop[0]
    before = dict(kk.LAUNCHES)
    got_at = _value_grad_hess(neg, u0)
    assert (kk.LAUNCHES["loglik_grad"] - before["loglik_grad"],
            kk.LAUNCHES["loglik_hess"] - before["loglik_hess"]) == (2, 1)
    got_factor = model._tim_factor(neg, mode)
    assert kk.LAUNCHES["loglik_hess"] == before["loglik_hess"] + 2
    gen = prng.generator(4, "cpu")
    state = model.init_state(model.draw_init_noise(gen, CHAINS))
    noise = model.draw_noise(gen, CHAINS)
    before = dict(kk.LAUNCHES)
    got = model.kernel()(noise, state)
    assert kk.LAUNCHES["loglik_wide"] == before["loglik_wide"] + 1
    kk._on_card = lambda x: False  # the plain versions (undone after)
    for name, a, b in zip(("value", "gradient", "Hessian"), got_at,
                          _value_grad_hess(neg, u0)):
        err = float((a - b).norm() / b.norm())
        assert err <= HOST_TOL["float64"], (name, err)
    want_factor = model._tim_factor(neg, mode)
    err = float((got_factor - want_factor).norm() / want_factor.norm())
    assert err <= HOST_TOL["float64"], ("factor", err)
    plain = build()
    plain_mode = plain._tim_prop[0]
    err = float((mode - plain_mode).norm() / plain_mode.norm())
    assert err <= _mode_resolution(neg, plain_mode, y.shape[0]), err
    object.__setattr__(plain, "_tim_prop", model._tim_prop)
    want = plain.kernel()(noise, state)
    for k in ("sigsq_obs", "beta", "alpha"):
        err = float((got[k] - want[k]).norm() / want[k].norm())
        assert err <= 1e-10, (k, err)
    for name, params in want["blocks"].items():
        for pname, v in params.items():
            err = float((got["blocks"][name][pname] - v).norm() / v.norm())
            assert err <= 1e-10, (pname, err)


def _value_grad_hess(fn, u):
    """fn(u), its gradient and its Hessian by autograd (a gradient
    launches J1, a Hessian J1 and J2 where fn runs the kernels)."""
    with torch.no_grad():
        value = fn(u)
    x = u.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(fn(x), x)
    return value, grad, torch.autograd.functional.hessian(fn, u)


def _mode_resolution(neg, mode, t_len):
    """The relative distance within which two runs of numopt's search on
    objectives that differ by rounding may stop: newton_raphson ends where
    no step of 1 down to 2^-9 lowers the objective's value. Where its
    rounding is delta, the full step's decrease lambda^2 / 2 (lambda^2 =
    g'H^-1 g, the Newton decrement, and lambda the distance to the minimum
    in the Hessian's norm) is then at most 2 delta, so each mode lies
    within 2 sqrt(delta) of the minimum in that norm, the two within
    4 sqrt(delta / h_min) of each other in the Euclidean one, h_min the
    Hessian's smallest eigenvalue. delta: T eps |f|, a sum of T log
    densities each rounded to a few units of eps |f| / T."""
    value = float(neg(mode))
    hess = torch.autograd.functional.hessian(neg, mode)
    h_min = float(torch.linalg.eigvalsh(0.5 * (hess + hess.T))[0])
    delta = t_len * torch.finfo(mode.dtype).eps * abs(value)
    return 4.0 * (delta / h_min) ** 0.5 / float(mode.norm())


def test_timing_reports_the_jets_and_their_floor():
    """kalman_timing's ``nvcc -Xptxas -v`` reader keys J1's and J2's
    kernels and K1w's group kernel (as it is and as it was, with the jets'
    order among its parameters) by what they compute; its SASS digest reads
    two builds that differ only in their kernels' parameter offsets as one;
    and the jets' latency floor grows with d and with the order at the main
    paths' T (its latencies are assumed ones, stated in JET_LATENCY)."""
    from boom_tpu_torch.kernels import kalman_timing as kt

    names = [("_ZN12_GLOBAL__N_115jet_warp_kernelILi2ELi1EEEvPKdS2_", 134),
             ("_ZN12_GLOBAL__N_115jet_warp_kernelILi8ELi2EEEvPKdS2_", 156),
             ("_ZN12_GLOBAL__N_118wide_loglik_kernelIdLi8ELb0EEEvPKT_", 90),
             ("_ZN12_GLOBAL__N_118wide_loglik_kernelIfLi13ELb1EEEvPKT_", 96),
             ("_ZN12_GLOBAL__N_118wide_loglik_kernelIddLi9ELi0ELb0EEEvPKT_",
              99)]
    log = "".join(f"""ptxas info    : Compiling entry function '{n}' for 'sm_90a'
ptxas info    : Function properties for {n}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used {r} registers, used 1 barriers
""" for n, r in names)
    keys = ["loglik_grad f64 d02", "loglik_hess f64 d08",
            "loglik_wide f64 d08", "loglik_wide f32 d13 tv",
            "loglik_wide f64 d09"]
    assert kt.wide_nvcc_report(log) == {
        k: {"registers": r, "spill_bytes": 0, "stack_bytes": 0}
        for k, (_, r) in zip(keys, names)}

    def listing(name, offset):
        return f"""\t\tFunction : {name}
        /*0000*/                   LDC R1, c[0x0][0x28] ;  /* 0x0a00ff */
        /*0010*/                   LDC.64 R2, c[0x0][{offset}] ;  /* 0x0 */
        /*0020*/                   DFMA R4, R2, R2, R4 ;  /* 0x0 */
"""
    now = kt.sass_digests(listing(names[2][0], "0x210"))
    was = kt.sass_digests(listing(names[4][0].replace("Li9E", "Li8E"),
                                  "0x248"))
    assert now == was and now["loglik_wide f64 d08"]["instructions"] == 3
    assert kt.sass_digests(listing(names[0][0], "0x210")) == {}
    for order in (1, 2):
        floors = [kt.jet_floor_ms(d, 3, order) for d in range(1, 17)]
        assert floors == sorted(floors) and floors[0] > 0
    assert kt.jet_floor_ms(8, 3, 1) < kt.jet_floor_ms(8, 3, 2)
    assert kt.jet_floor_ms(2, 3, 1, 1000) == 2 * kt.jet_floor_ms(2, 3, 1)


def test_ssm_params_keep_the_blocks_t_one_matrix():
    """Bsts.ssm_params keeps T one matrix expanded over the chains (stride
    0: every block's T is one), which K1w takes as its broadcast layout,
    with the values of the block-diagonal materialised; R likewise (the
    blocks' T and R are constants of their specs, built once a model)."""
    from boom_tpu_torch.statespace import bsts as bsts_mod
    from boom_tpu_torch.statespace.state_models import (
        LocalLinearTrend,
        Seasonal,
    )

    y = torch.tensor(np.random.default_rng(3).normal(size=40).cumsum())
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y),
                              Seasonal.default(y, nseasons=7)])
    gen = prng.generator(5, "cpu")
    state = model.init_state(model.draw_init_noise(gen, CHAINS))
    params = model.ssm_params(state)
    assert params.t_mat.shape == (CHAINS, 8, 8)
    assert params.t_mat.stride(0) == 0 and params.z.stride(0) == 0
    assert params.r_mat.stride(0) == 0
    for k, field in enumerate((params.t_mat, params.r_mat)):
        mats = [b.build(state["blocks"][b.name])[k] for b in model.blocks]
        flat = bsts_mod._block_diag([m.contiguous() for m in mats])
        assert flat.stride(0) != 0 and torch.equal(field, flat)


def test_loglik_wrappers_refuse_what_the_kernels_do_not_take():
    """Past the kernels' range the wrappers raise before anything is
    launched: d = 17 (K1w, the jets), more directions than the jets take,
    and a series count that does not divide the systems."""
    from boom_tpu_torch.kernels.kalman_timing import system

    rng = np.random.default_rng(0)
    big = system(rng, 2, 17, "float64", device="cpu")
    y = torch.zeros(10, dtype=torch.float64)
    fields = (big.h, big.rqr, big.z, big.t_mat, big.a0, big.p0, y, None)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.launch_loglik(*fields)
    dirs = host_rehearsal.directions(rng, 2, 17)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.launch_jets(*fields, *dirs, order=1)
    small = system(rng, 3, 2, "float64", device="cpu")
    fields = (small.h, small.rqr, small.z, small.t_mat, small.a0, small.p0,
              y, None)
    many = host_rehearsal.directions(rng, kk.JET_MAX_DIRECTIONS + 1, 2)
    with pytest.raises(NotImplementedError, match="directions"):
        kk.launch_jets(*fields, *many, order=2)
    with pytest.raises(ValueError, match="dividing"):
        kk.launch_loglik(*fields[:6], torch.zeros(2, 10, dtype=torch.float64),
                         None)
    with pytest.raises(ValueError, match="dividing"):
        kalman.kalman_loglik(small, torch.zeros(2, 10, dtype=torch.float64))
    with pytest.raises(TypeError, match="float64"):
        kk.launch_jets(*(f.float() for f in fields[:7]), None,
                       *(d.float() for d in dirs), order=1)
