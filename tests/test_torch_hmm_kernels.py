"""H1 and H2 (``csrc/hmm.cu``) compiled for the host by
``kernels/host_rehearsal.py`` into ``build/boom_tpu_torch/host/hmm_tier1/``
(a directory of its own, so that no other test's build shares it) and
bound in place of the ``nvcc`` build, then checked on CPU tensors: against
their plain versions at S 1, 2, 3, 8, 16, T 1, 2, 33 and across the staged
chunks' edges, a few ``GaussianHmm`` sweeps through them against the
plain sweep, and the reference's recovery check (``tests/test_hmm.py::
test_hmm_gibbs_recovers_truth``: its data, truth, 4 chains, 400 + 1200
sweeps, 98 % intervals) through them (~20 s: the plain versions' loops
over T would take minutes).

Tolerances: H1 normwise 1e-12 in float64 and 1e-5 in float32 (the same
operations, summed in another order); H2's paths identical; its
statistics within 1e-12 (float64) and 1e-5 (float32: H2 sums in double and
rounds once) of those of its own path.
"""

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
