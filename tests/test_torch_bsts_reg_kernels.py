"""The kernels of the bsts_reg path compiled for the host
(``kernels/host_rehearsal.py``: a block's threads as host threads, real
barriers for the block and each warp, warp shuffles through them) against
their plain versions on CPU tensors: K2w (the simulation smoother for
7 <= d <= 16) and K3 (the ASIS D-path) of ``csrc/kalman_wide.cu``, and
kernel (a)'s per-chain entry (a border of S0 a chain) of
``csrc/ssvs_sweep.cu``; then one whole bsts sweep with a seasonal and a
regression through all three. float64 within 1e-12 normwise (the kernels
reduce across the warp in another order than the plain versions), float32
within 1e-5; masks identical.
"""

import shutil

import numpy as np
import pytest
import torch

from boom_tpu_torch.kernels import _build, host_rehearsal
from boom_tpu_torch.kernels.kalman_timing import system
from boom_tpu_torch.models.glm import ssvs_kernel
from boom_tpu_torch.statespace import kalman
from boom_tpu_torch.statespace import kalman_kernel as kk

torch.set_num_threads(1)

TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def host_libraries():
    """kalman_wide.cu and ssvs_sweep.cu compiled for the host, once for the
    module (in directories of their own: other modules build ssvs_sweep.cu
    at the same time)."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return {name: host_rehearsal.build_host_library(name, variant="bsts_reg")
            for name in ("kalman_wide", "ssvs_sweep")}


@pytest.fixture
def host_kernels(monkeypatch, host_libraries):
    """kalman_kernel's and ssvs_kernel's wrappers bound to the host
    libraries, launching on CPU tensors."""
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: host_libraries[n]
                                            for n in names})
    for mod in (kk, ssvs_kernel):
        monkeypatch.setattr(mod, "_on_card", lambda x: True)
        monkeypatch.setattr(mod, "_stream", lambda device: 0)
    _build.library.cache_clear()
    yield
    _build.library.cache_clear()


@pytest.mark.parametrize("case", host_rehearsal.WIDE_CASES,
                         ids=lambda c: "d{}-C{}-T{}-{}-{}".format(*c))
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_smoother_wide_matches_plain(case):
    """K2w at d 7 and 8 (four chains a warp), 9, 13 and 16 (two): T one
    below, at and above 32 and one step, 1, 3 and 5 chains (a partial pack
    and a partial warp) and 33 (a partial block), masked, and a series a
    chain (bsts with a regression)."""
    before = kk.LAUNCHES["smoother_wide"]
    (err,) = host_rehearsal.check_wide(seed=case[0] + case[2],
                                       wide_cases=[case],
                                       dpath_cases=[]).values()
    assert kk.LAUNCHES["smoother_wide"] == before + 1
    assert err <= TOL["float64"]


def _dpath_id(case):
    d, g, dtype, c = case
    return f"d{d}-G{g}-{dtype}" + ("" if c == 5 else f"-C{c}")


@pytest.mark.parametrize("case", host_rehearsal.DPATH_CASES, ids=_dpath_id)
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_dpath_matches_plain(case):
    """K3 at d 1 (32 series a warp) to 16 (two), one to three groups of 5
    or 7 chains (a ragged last pack), with the long chunks its launcher
    takes when one wave of them holds the grid."""
    before = kk.LAUNCHES["dpath"]
    (err,) = host_rehearsal.check_wide(seed=case[0], wide_cases=[],
                                       dpath_cases=[case]).values()
    assert kk.LAUNCHES["dpath"] == before + 1
    assert err <= TOL[case[2]]


@pytest.mark.parametrize("case", host_rehearsal.DPATH_CASES, ids=_dpath_id)
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_dpath_short_chunks_match_plain(case, host_libraries):
    """The same with the short chunks its launcher takes when the grid
    fills the card (the occupancy query made to report no room for a long
    chunk's block)."""
    host_rehearsal.set_occupancy(host_libraries["kalman_wide"], 0)
    try:
        (err,) = host_rehearsal.check_wide(seed=case[0] + 1, wide_cases=[],
                                           dpath_cases=[case]).values()
    finally:
        host_rehearsal.set_occupancy(host_libraries["kalman_wide"], 1)
    assert err <= TOL[case[2]]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("occupancy", [1, 0], ids=["long", "short"])
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_dpath_at_the_fit_shape_matches_plain(
        dtype, occupancy, host_libraries):
    """K3 at the D-paths of the T = 4096 fit (8 chains x 2 groups, d = 2:
    one warp, many chunks a series; stable systems, so that 4095 steps
    stay finite), with either chunk length."""
    rng = np.random.default_rng(4096)
    tdt = getattr(torch, dtype)
    t_mat = system(rng, 8, 2, dtype, device="cpu").t_mat.contiguous()
    w = torch.tensor(rng.normal(size=(8, 2, 4095, 2)), dtype=tdt)
    host_rehearsal.set_occupancy(host_libraries["kalman_wide"], occupancy)
    try:
        before = kk.LAUNCHES["dpath"]
        got = kk.dpath(t_mat, w)
    finally:
        host_rehearsal.set_occupancy(host_libraries["kalman_wide"], 1)
    assert kk.LAUNCHES["dpath"] == before + 1
    want = kalman.dpath(t_mat, w)
    assert float((got - want).norm() / want.norm()) <= TOL[dtype]


@pytest.mark.parametrize("p", [20, 33])
@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_kernel_a_border_matches_plain(p):
    """Kernel (a)'s per-chain entry, float64, 33 chains: masks identical
    to the plain sweep's on per-chain X'y and y'y."""
    before = dict(ssvs_kernel.LAUNCHES)
    (bad,) = host_rehearsal.check_ssvs_border(
        seed=p, cases=((p, "float64"),)).values()
    assert ssvs_kernel.LAUNCHES["ssvs_sweep_border"] == (
        before["ssvs_sweep_border"] + 2)
    assert ssvs_kernel.LAUNCHES["ssvs_sweep"] == before["ssvs_sweep"]
    assert bad == 0


@pytest.mark.usefixtures("host_kernels")
def test_host_compiled_bsts_reg_sweep_matches_plain():
    """One sweep of bsts with a trend, a 7-season cycle (d = 8) and a
    regression of p = 6, float64, 33 chains, T = 40, through K2w, K3 and
    kernel (a)'s per-chain entry, against the same sweep through the plain
    versions, on the same noise."""
    from boom_tpu_torch import rng as prng
    from boom_tpu_torch.models.glm.regression import SpikeSlabPrior
    from boom_tpu_torch.statespace.bsts import Bsts
    from boom_tpu_torch.statespace.state_models import (
        LocalLinearTrend,
        Seasonal,
    )

    rng = np.random.default_rng(5)
    t_len, p, c = 40, 6, 33
    x = torch.tensor(rng.normal(size=(t_len, p)))
    y = (torch.tensor(rng.normal(size=t_len).cumsum())
         + x[:, 0] * 2.0 - x[:, 1])
    model = Bsts(y=y, blocks=[LocalLinearTrend.default(y),
                              Seasonal.default(y, nseasons=7)],
                 predictors=x, reg_prior=SpikeSlabPrior.from_data(x, y),
                 parallel_smoother=False)
    gen = prng.generator(6, "cpu")
    state = model.init_state(model.draw_init_noise(gen, c))
    noise = model.draw_noise(gen, c)
    before = {**kk.LAUNCHES, **ssvs_kernel.LAUNCHES}
    got = model.kernel()(noise, state)
    launched = {k: v - before[k] for k, v in {**kk.LAUNCHES,
                                              **ssvs_kernel.LAUNCHES}.items()}
    assert launched == {"loglik": 0, "loglik_grad": 0, "loglik_hess": 0,
                        "smoother": 0, "smoother_wide": 1, "dpath": 1,
                        "ssvs_sweep": 0, "ssvs_sweep_border": 1}
    for mod in (kk, ssvs_kernel):
        mod._on_card = lambda x: False  # the plain versions (undone after)
    want = model.kernel()(noise, state)
    assert torch.equal(got["gamma"], want["gamma"])
    for k in ("sigsq_obs", "beta", "alpha"):
        err = float((got[k] - want[k]).norm() / want[k].norm())
        assert err <= 1e-10, (k, err)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """K2w and K3 stop at d = 16; past it the wrappers raise naming
    ROADMAP.md (before anything is launched)."""
    from boom_tpu_torch.kernels.kalman_timing import system

    rng = np.random.default_rng(0)
    params = system(rng, 2, 17, "float64", device="cpu")
    normals = [torch.zeros(s, dtype=torch.float64)
               for s in ((2, 17), (2, 9, 17), (2, 10))]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.smoother_operands(params, torch.zeros(10, dtype=torch.float64),
                             *normals)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        kk.launch_dpath(params.t_mat, torch.zeros(2, 3, 9, 17,
                                                  dtype=torch.float64))
    with pytest.raises(TypeError, match="float32 or float64"):
        kk.launch_dpath(params.t_mat.half(), torch.zeros(
            2, 3, 9, 17, dtype=torch.float16))
