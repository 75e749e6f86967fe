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


@pytest.mark.parametrize("case", host_rehearsal.JET_CASES,
                         ids=lambda c: "d{}-K{}-B{}-S{}-{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_jets_match_plain(case):
    """J1 and J2 along K directions, d 1-16, K 1-16, one shared series and
    a series a system, masked and dense, against autograd of the plain
    loop."""
    before = dict(kk.LAUNCHES)
    errs = host_rehearsal.check_jets(seed=sum(case), cases=[case])
    assert kk.LAUNCHES["loglik_grad"] == before["loglik_grad"] + 1
    assert kk.LAUNCHES["loglik_hess"] == before["loglik_hess"] + 1
    for name, err in errs.items():
        assert err <= HOST_TOL["float64"], (name, err)


@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_tim_proposal_and_sweep_match_plain():
    """The TIM proposal build (J1, J2 at d = 8 along the three variances)
    and one sweep with the move (K1w over 8 chains x 17 points, each
    chain's points on its own y - X beta) through the host-compiled
    kernels, against the same through the plain versions."""
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
    gen = prng.generator(4, "cpu")
    state = model.init_state(model.draw_init_noise(gen, CHAINS))
    noise = model.draw_noise(gen, CHAINS)
    before = dict(kk.LAUNCHES)
    got = model.kernel()(noise, state)
    assert kk.LAUNCHES["loglik_wide"] == before["loglik_wide"] + 1
    kk._on_card = lambda x: False  # the plain versions (undone after)
    plain = build()
    for a, b in zip(model._tim_prop, plain._tim_prop):
        assert float((a - b).norm() / b.norm()) <= 1e-8
    object.__setattr__(plain, "_tim_prop", model._tim_prop)
    want = plain.kernel()(noise, state)
    for k in ("sigsq_obs", "beta", "alpha"):
        err = float((got[k] - want[k]).norm() / want[k].norm())
        assert err <= 1e-10, (k, err)
    for name, params in want["blocks"].items():
        for pname, v in params.items():
            err = float((got["blocks"][name][pname] - v).norm() / v.norm())
            assert err <= 1e-10, (pname, err)


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
