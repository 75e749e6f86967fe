"""H1 and H2 (``csrc/hmm.cu``) compiled for the host by
``kernels/host_rehearsal.py`` into ``build/boom_tpu_torch/host/hmm_tier1/``
(a directory of its own, so that no other test's build shares it) and
bound in place of the ``nvcc`` build, then checked on CPU tensors: against
their plain versions at S 1, 2, 3, 7, 8, 16 with L lanes a chain of 1, 8
and 32 (the kernels' choice, and forced), T around the split of the steps
over the lanes (T < L, T a multiple of L and one either side), T 1, 2, 150
and across the staged chunks' edges, 1, 5, 9 and 33 chains; problems whose
log alphas fall far below -87; the lanes the kernels choose; repeated
launches bit-identical; a few ``GaussianHmm`` sweeps through them against
the plain sweep, and the reference's recovery check
(``tests/test_hmm.py::test_hmm_gibbs_recovers_truth``: its data, truth, 4
chains, 400 + 1200 sweeps, 98 % intervals) through them.

Tolerances: H1 normwise 1e-12 in float64 and 1e-5 in float32 (the same
operations, summed in another order: the split's transfers and scan, the
normaliser subtracted after the next step's log-sum-exp); H2's paths
identical; its statistics within 1e-12 (float64) and 1e-5 (float32: H2
sums in double and rounds once) of those of its own path.
"""

import contextlib
import shutil

import numpy as np
import pytest
import torch

from boom_tpu import testing
from boom_tpu_torch import data, rng
from boom_tpu_torch.inference.driver import run_mcmc
from boom_tpu_torch.kernels import _build
from boom_tpu_torch.kernels import host_rehearsal as hr
from boom_tpu_torch.kernels.hmm_timing import problem
from boom_tpu_torch.models import hmm, hmm_kernel, mixtures

torch.set_num_threads(1)

# H1's normwise tolerance, and H2's statistics'
TOL = {"float64": 1e-12, "float32": 1e-5}


@pytest.fixture(scope="module")
def host_library():
    """hmm.cu compiled for the host, once for the module."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the kernels for the host")
    return hr.build_host_library("hmm", variant="tier1")


@pytest.fixture
def host_kernels(monkeypatch, host_library):
    """hmm_kernel launches the host library on CPU tensors."""
    monkeypatch.setattr(_build, "build",
                        lambda names=None: {n: host_library for n in names})
    monkeypatch.setattr(hmm_kernel, "_on_card", lambda x: True)
    monkeypatch.setattr(hmm_kernel, "_stream", lambda device: 0)
    _build.library.cache_clear()
    yield
    _build.library.cache_clear()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_h1_h2_match_plain(host_kernels, dtype):
    bad = []
    for case, (rel, paths, stats) in hr.check_hmm(dtypes=(dtype,)).items():
        if not (rel <= TOL[dtype] and paths == 0.0 and stats <= TOL[dtype]):
            bad.append(f"{case}: {rel:.2e} {paths} {stats:.2e}")
    assert not bad, bad


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_h1_h2_match_plain_below_float32_exp_range(host_kernels, dtype):
    """Problems whose odd states' log alphas fall to about -200, where
    float32's exp underflows: the kernels stay in log space."""
    cases = [(2, 150, 33, None), (3, 150, 5, 8), (9, 67, 9, None)]
    bad = []
    for case, (rel, paths, stats) in hr.check_hmm(
            dtypes=(dtype,), cases=cases, deep=True).items():
        if not (rel <= TOL[dtype] and paths == 0.0 and stats <= TOL[dtype]):
            bad.append(f"{case}: {rel:.2e} {paths} {stats:.2e}")
    assert not bad, bad


def test_lanes_a_chain_fill_eight_warps_an_sm(host_kernels):
    """L is 32 while C L lanes fit in 8 warps on each of the card's SMs
    (132 on the host, as on an H100), else 8; 1 where the split layout
    does not pay: H1 past S = 7 in float32 and S = 4 in float64, H2 past
    S = 8."""
    f32, f64 = torch.float32, torch.float64
    for c, want in ((1, 32), (8, 32), (32, 32), (33, 32), (1056, 32),
                    (1057, 8), (4096, 8), (4097, 8), (16897, 8),
                    (100000, 8)):
        assert hmm_kernel.lanes("hmm_forward", f32, 2, c) == want, c
        assert hmm_kernel.lanes("hmm_backward", f64, 2, c) == want, c
    assert hmm_kernel.lanes("hmm_forward", f32, 7, 4096) == 8
    assert hmm_kernel.lanes("hmm_forward", f32, 8, 33) == 1
    assert hmm_kernel.lanes("hmm_forward", f64, 4, 33) == 32
    assert hmm_kernel.lanes("hmm_forward", f64, 5, 33) == 1
    assert hmm_kernel.lanes("hmm_backward", f64, 8, 33) == 32
    assert hmm_kernel.lanes("hmm_backward", f32, 9, 33) == 1
    with hmm_kernel.forced_lanes(16):
        assert hmm_kernel.lanes("hmm_forward", f32, 2, 33) == 8
        assert hmm_kernel.lanes("hmm_forward", f32, 16, 33) == 1
    with hmm_kernel.forced_lanes(32):
        assert hmm_kernel.lanes("hmm_backward", f32, 2, 4096) == 32
    assert hmm_kernel.lanes("hmm_forward", f32, 2, 4096) == 8


@pytest.mark.parametrize("lanes, s", [(None, 3), (8, 3), (None, 16)])
def test_repeated_launches_are_bit_identical(host_kernels, lanes, s):
    """Three launches of each on one problem (33 chains, T = 150; L = 32,
    8 and, at S = 16, 1) give the same bits: every reduction across a
    chain's lanes runs in a fixed order."""
    p = problem(np.random.default_rng(3), 33, 150, s, "float32",
                device="cpu")
    args = (p["log_lik"], p["log_trans"], p["log_init"])
    with (hmm_kernel.forced_lanes(lanes) if lanes
          else contextlib.nullcontext()):
        runs = []
        for _ in range(3):
            la, ll = hmm_kernel.launch_forward(*args)
            z, suf, counts, first = hmm_kernel.launch_backward(
                la, p["log_trans"], p["path_u"], p["y"])
            runs.append([la, ll, z, *suf, counts, first])
    for again in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], again))


def test_refuses_more_than_16_states(host_kernels):
    p = problem(np.random.default_rng(0), 2, 3, 17, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        hmm_kernel.launch_forward(p["log_lik"], p["log_trans"],
                                  p["log_init"])


def test_sweeps_through_the_kernels_match_plain(host_kernels):
    """Five sweeps of 33 chains through H1 and H2 (each launched once a
    sweep) against the plain sweep on the same noise."""
    y = torch.tensor(data.hmm()["y"][:150])
    model = hmm.GaussianHmm(y=y, num_states=2)
    gen = torch.Generator().manual_seed(0)
    st = model.init_state(model.draw_init_noise(gen, 33))
    kern = model.kernel()
    for _ in range(5):
        noise = model.draw_noise(gen, 33)
        before = dict(hmm_kernel.LAUNCHES)
        got = kern(noise, st)
        assert {k: hmm_kernel.LAUNCHES[k] - before[k] for k in before} == {
            "hmm_forward": 1, "hmm_backward": 1}
        hmm_kernel._on_card = lambda x: False
        try:
            want = kern(noise, st)
        finally:
            hmm_kernel._on_card = lambda x: True
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-12)
        st = got
    before = hmm_kernel.LAUNCHES["hmm_forward"]
    ll = model.log_lik(st)
    assert hmm_kernel.LAUNCHES["hmm_forward"] == before + 1
    assert ll.shape == (33,) and torch.isfinite(ll).all()


def test_hmm_gibbs_recovers_truth(host_kernels):
    """The reference's check on its own data (``data/hmm.npz``, drawn from
    its key and truth): 4 chains, 400 burn-in + 1200 draws, every mean, sd
    and transition diagonal inside the draws' 98 % intervals, the states
    ordered by mu; every sweep one H1 and one H2 launch."""
    before = dict(hmm_kernel.LAUNCHES)
    truth = data.HMM_TRUTH
    model = hmm.GaussianHmm(y=torch.tensor(data.hmm()["y"]), num_states=2)
    res = run_mcmc(model.kernel(), model.draw_noise,
                   lambda g, c: model.init_state(model.draw_init_noise(g, c)),
                   num_draws=1200, generator=rng.generator(13, "cpu"),
                   num_chains=4, burn=400)
    assert {k: hmm_kernel.LAUNCHES[k] - before[k] for k in before} == {
        "hmm_forward": 1600, "hmm_backward": 1600}
    mu, sigsq = mixtures.relabel_sorted(res.draws["mu"], res.draws["sigsq"])
    mu_flat = mu.numpy().reshape(-1, 2)
    sd_flat = np.sqrt(sigsq.numpy().reshape(-1, 2))
    assert testing.check_mcmc_matrix(mu_flat, truth["mu"], confidence=0.98)
    assert testing.check_mcmc_matrix(sd_flat, truth["sd"], confidence=0.98)
    order = np.argsort(res.draws["mu"].numpy().reshape(-1, 2), axis=-1)
    trans = res.draws["trans"].numpy().reshape(-1, 2, 2)
    rows = np.arange(len(trans))
    diag = np.stack([trans[rows, order[:, 0], order[:, 0]],
                     trans[rows, order[:, 1], order[:, 1]]], axis=1)
    assert testing.check_mcmc_matrix(diag, [0.92, 0.88], confidence=0.98)
